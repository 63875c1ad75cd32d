"""Port parity: the flash-attention functions of ``tpu_engine_torch.ops``
against the JAX Pallas kernels (interpret mode) and the JAX plain path.

On CPU tensors the port's kernel wrappers run their plain PyTorch versions,
so these tests hold the arithmetic the CUDA kernels must reproduce to the
JAX kernels' own results. Tolerances are those ``tests/test_flash_attention.py``
holds the Pallas kernel to: fp32 forward 2e-5, fp32 backward 5e-4, bf16
backward atol 0.15 / rtol 0.1."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_engine.ops import _flash_pallas  # noqa: E402
from tpu_engine.ops import flash_attention as jfa  # noqa: E402
from tpu_engine_torch.ops import _flash_cuda  # noqa: E402
from tpu_engine_torch.ops import flash_attention as tfa  # noqa: E402


def _qkv(seed, shape_q, shape_kv):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape_q).astype(np.float32),
            rng.standard_normal(shape_kv).astype(np.float32),
            rng.standard_normal(shape_kv).astype(np.float32))


def _t(x, dtype=torch.float32):
    return torch.tensor(x, dtype=dtype)


@pytest.mark.parametrize("S,D,W", [(64, 16, 0), (128, 64, 0), (128, 16, 32), (64, 64, 32)])
def test_forward_and_lse_match_pallas(S, D, W):
    q, k, v = _qkv(0, (3, S, D), (3, S, D))
    jo, jlse = _flash_pallas._flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        _flash_pallas._pick_block(S), True, W)
    to, tlse = _flash_cuda.flash_fwd(_t(q), _t(k), _t(v), W)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("S,H,KV,D,W", [
    (64, 2, 2, 16, 0), (128, 4, 2, 16, 0), (128, 2, 2, 64, 32), (64, 4, 2, 64, 32),
])
def test_backward_matches_pallas(S, H, KV, D, W):
    q, k, v = _qkv(1, (1, S, H, D), (1, S, KV, D))

    def loss(q, k, v):
        return jnp.sum(_flash_pallas.flash_mha(q, k, v, interpret=True, window=W) ** 2)

    jg = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    (tfa.flash_mha(tq, tk, tv, window=W) ** 2).sum().backward()
    for a, b in zip((tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-4, rtol=5e-4)


def test_backward_bf16_matches_pallas():
    q, k, v = _qkv(2, (1, 128, 2, 64), (1, 128, 2, 64))
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))

    def loss(q, k, v):
        return jnp.sum(_flash_pallas.flash_mha(q, k, v, interpret=True).astype(jnp.float32) ** 2)

    jg = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (_t(x, torch.bfloat16).requires_grad_(True) for x in (q, k, v))
    (tfa.flash_mha(tq, tk, tv).float() ** 2).sum().backward()
    for a, b in zip((tq.grad, tk.grad, tv.grad), jg):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                   atol=0.15, rtol=0.1)


@pytest.mark.parametrize("H,KV,W", [(4, 4, 0), (4, 2, 0), (4, 4, 7)])
def test_plain_mha_matches_jax_xla(H, KV, W):
    q, k, v = _qkv(3, (2, 48, H, 16), (2, 48, KV, 16))
    ref = jfa._xla_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=W)
    out = tfa.mha(_t(q), _t(k), _t(v), force_xla=True, window=W)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-6, rtol=2e-6)


def test_bwd_plain_pieces_agree_with_autograd_of_plain_forward():
    """K2/K3's plain versions are the gradient of K1's plain version."""
    q, k, v = (torch.tensor(x).requires_grad_(True) for x in _qkv(4, (2, 64, 16), (2, 64, 16)))
    o, lse = _flash_cuda.flash_fwd_plain(q, k, v, window=20)
    do = torch.randn(o.shape, generator=torch.Generator().manual_seed(0))
    o.backward(do)
    dq, dk, dv = _flash_cuda.flash_bwd_plain(q.detach(), k.detach(), v.detach(), o.detach(),
                                             lse.detach(), do, window=20)
    for got, want in ((dq, q.grad), (dk, k.grad), (dv, v.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


def test_unsupported_shapes_fall_back_to_plain_path():
    q, k, v = (_t(x) for x in _qkv(5, (1, 100, 2, 16), (1, 100, 2, 16)))
    with pytest.raises(tfa.FlashUnsupported):
        tfa.flash_mha(q, k, v)
    np.testing.assert_allclose(tfa.mha(q, k, v).numpy(),
                               tfa.mha(q, k, v, force_xla=True).numpy(), rtol=1e-6)
    with pytest.raises(tfa.FlashUnsupported):
        tfa.flash_mha(q[:, :64], k[:, :64], v[:, :64], causal=False)


def test_window_validation_and_full_window_is_causal():
    q, k, v = (_t(x) for x in _qkv(6, (1, 64, 2, 16), (1, 64, 2, 16)))
    with pytest.raises(ValueError, match="causal"):
        tfa.mha(q, k, v, causal=False, window=16)
    with pytest.raises(ValueError, match=">= 0"):
        tfa.mha(q, k, v, force_xla=True, window=-1)
    assert torch.equal(tfa.flash_mha(q, k, v, window=64), tfa.flash_mha(q, k, v))


def test_cpu_path_launches_no_kernel_and_other_devices_raise():
    _flash_cuda.reset_launches()
    q, k, v = (_t(x).requires_grad_(True) for x in _qkv(7, (1, 64, 2, 64), (1, 64, 2, 64)))
    tfa.flash_mha(q, k, v).sum().backward()
    assert _flash_cuda.launches == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    meta = torch.empty((2, 64, 64), device="meta")
    with pytest.raises(ValueError, match="meta"):
        _flash_cuda.flash_fwd(meta, meta, meta)


def test_library_path_is_keyed_on_the_sources():
    path = _flash_cuda.library_path()
    assert path.parent == _flash_cuda.BUILD_DIR
    assert path.name.startswith("libtpe_flash_") and path.suffix == ".so"
    assert _flash_cuda.library_path() == path
