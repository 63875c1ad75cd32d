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


@pytest.mark.parametrize("D", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("S,W,causal", [
    (192, 0, True), (192, 37, True), (192, 100, True), (192, 0, False),
    (320, 0, True), (320, 37, True), (320, 100, True), (320, 0, False),
])
def test_forward_matches_pallas_at_hopper_tile_edges(S, W, causal, D):
    """The plain version the card holds the Hopper K1 to, at the edges of
    its 128-row Q tiles and its key tiles (128 keys at D 16 to 128, 80 at
    D 256): S 192 and 320 leave a ragged last Q tile (and, at D 16 to 128,
    a ragged last key tile), and windows 37 and 100 cut through tiles.
    Against the Pallas forward (interpret mode, 64-row blocks) in fp32."""
    q, k, v = _qkv(13, (2, S, D), (2, S, D))
    jo, jlse = _flash_pallas._flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        _flash_pallas._pick_block(S), True, W, causal=causal)
    to, tlse = _flash_cuda.flash_fwd(_t(q), _t(k), _t(v), W, causal)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("D", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("S,W,causal", [
    (192, 0, True), (192, 37, True), (192, 100, True), (192, 0, False),
    (320, 0, True), (320, 37, True), (320, 100, True), (320, 0, False),
])
def test_backward_matches_pallas_at_hopper_tile_edges(S, W, causal, D):
    """The plain versions the card holds the Hopper K2 and K3 to, at the
    edges of their tiles: at D 64 and 128 128-row owned tiles (S 192 and
    320 leave a ragged last one) and 64-row streamed tiles; at D 16 and 32
    K3's 128-key owned tiles and 128-query streamed tiles (ragged at S 192
    and 320 too); at D 256 64-row owned and streamed tiles, and the 32-key
    halves of a streamed tile that K2's two warpgroups score. Windows 37
    and 100 cut through both.
    ``flash_bwd`` under a random (dO, dlse) cotangent against the Pallas
    backward (``_flash_bwd`` in interpret mode, on the Pallas forward's
    residuals) in fp32."""
    q, k, v = _qkv(14, (2, S, D), (2, S, D))
    rng = np.random.default_rng(15)
    do = rng.standard_normal((2, S, D)).astype(np.float32)
    dlse = rng.standard_normal((2, S)).astype(np.float32)
    block = _flash_pallas._pick_block(S)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    jo, jlse = _flash_pallas._flash_fwd(jq, jk, jv, block, True, W, causal=causal)
    jg = _flash_pallas._flash_bwd(block, True, W, (jq, jk, jv, jo, jlse), jnp.asarray(do),
                                  causal, jnp.asarray(dlse))
    to, tlse = _flash_cuda.flash_fwd(_t(q), _t(k), _t(v), W, causal)
    tg = _flash_cuda.flash_bwd(_t(q), _t(k), _t(v), to, tlse, _t(do), W, causal, _t(dlse))
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("W,causal", [(0, True), (37, True), (0, False)])
def test_head_dim_256_matches_pallas(W, causal):
    """gemma's head dim: the plain versions the card holds the D 256 kernels
    to, forward (o, lse) and backward under a random (dO, dlse) cotangent,
    against the Pallas kernels in interpret mode at S 128, in fp32."""
    S, D = 128, 256
    q, k, v = _qkv(16, (2, S, D), (2, S, D))
    rng = np.random.default_rng(17)
    do = rng.standard_normal((2, S, D)).astype(np.float32)
    dlse = rng.standard_normal((2, S)).astype(np.float32)
    block = _flash_pallas._pick_block(S)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    jo, jlse = _flash_pallas._flash_fwd(jq, jk, jv, block, True, W, causal=causal)
    jg = _flash_pallas._flash_bwd(block, True, W, (jq, jk, jv, jo, jlse), jnp.asarray(do),
                                  causal, jnp.asarray(dlse))
    to, tlse = _flash_cuda.flash_fwd(_t(q), _t(k), _t(v), W, causal)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), atol=2e-5, rtol=2e-5)
    tg = _flash_cuda.flash_bwd(_t(q), _t(k), _t(v), to, tlse, _t(do), W, causal, _t(dlse))
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-4, rtol=5e-4)


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
    qb, kb, vb = (x.detach().reshape(2, 64, 64).requires_grad_(True) for x in (q, k, v))
    for causal in (True, False):
        o, lse = _flash_cuda.flash_fwd_lse(qb, kb, vb, causal=causal)
        (o.sum() + lse.sum()).backward()
    assert set(_flash_cuda.launches) == {
        "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
        "flash_fwd_full", "flash_bwd_dq_full", "flash_bwd_dkv_full"}
    assert all(n == 0 for n in _flash_cuda.launches.values()), _flash_cuda.launches
    meta = torch.empty((2, 64, 64), device="meta")
    with pytest.raises(ValueError, match="meta"):
        _flash_cuda.flash_fwd(meta, meta, meta)


def test_launch_errors_raise_with_their_cause():
    """Every nonzero code of a C entry raises; the Hopper K1's tensor-map
    failures (negative codes) name the call that refused."""
    _flash_cuda._check("flash_fwd", 0)
    for code in (-1, -2):
        with pytest.raises(RuntimeError, match="cuTensorMapEncodeTiled"):
            _flash_cuda._check("flash_fwd", code)
    with pytest.raises(RuntimeError, match="cudaError_t 1"):
        _flash_cuda._check("flash_fwd", 1)


def test_library_path_is_keyed_on_the_sources():
    path = _flash_cuda.library_path()
    assert path.parent == _flash_cuda.BUILD_DIR
    assert path.name.startswith("libtpe_flash_") and path.suffix == ".so"
    assert _flash_cuda.library_path() == path
    assert {src.name for src in _flash_cuda.SOURCES} == {
        "flash_attention.cu", "flash_fwd_sm90.cu", "flash_bwd_sm90.cu",
        "flash_bwd_dq_d256_sm90.cu", "flash_bwd_dkv_d256_sm90.cu", "flash_f32_tc.cu"}
    assert {src.name for src in _flash_cuda.HEADERS} == {
        "sm90.cuh", "flash_common.cuh", "tf32_split.cuh"}
    assert all(src.exists() for src in (*_flash_cuda.SOURCES, *_flash_cuda.HEADERS))


# -- the non-causal kernels and the (o, lse) entry of ring attention ---------


@pytest.mark.parametrize("S,D", [(64, 16), (128, 32), (128, 64)])
def test_non_causal_forward_matches_pallas(S, D):
    q, k, v = _qkv(8, (3, S, D), (3, S, D))
    jo, jlse = _flash_pallas._flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        _flash_pallas._pick_block(S), True, 0, causal=False)
    to, tlse = _flash_cuda.flash_fwd(_t(q), _t(k), _t(v), causal=False)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_lse_matches_pallas(causal):
    """(o, lse) and the gradients under a random (dO, dlse) cotangent pair,
    against ``_flash_pallas.flash_fwd_lse`` in interpret mode: the lse
    cotangent enters the backward as Δ′ = rowsum(dO ∘ O) − dlse."""
    q, k, v = _qkv(9, (4, 128, 64), (4, 128, 64))
    rng = np.random.default_rng(10)
    do = rng.standard_normal((4, 128, 64)).astype(np.float32)
    dlse = rng.standard_normal((4, 128)).astype(np.float32)
    block = _flash_pallas._pick_block(128)

    def jfn(q, k, v):
        return _flash_pallas.flash_fwd_lse(q, k, v, block, True, causal)

    (jo, jlse), vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jg = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    to, tlse = _flash_cuda.flash_fwd_lse(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(tlse.detach().numpy(), np.asarray(jlse), atol=2e-5, rtol=2e-5)
    tg = torch.autograd.grad((to, tlse), (tq, tk, tv), (_t(do), _t(dlse)))
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-4, rtol=5e-4)


def test_flash_fwd_lse_treats_a_missing_cotangent_as_zeros():
    """Gradients through o alone and through lse alone each equal autograd
    through the plain forward with the other cotangent zero."""
    q, k, v = (_t(x) for x in _qkv(11, (2, 64, 16), (2, 64, 16)))
    for pick in (0, 1):
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = _flash_cuda.flash_fwd_lse(*xs, causal=False)[pick]
        got = torch.autograd.grad(out.sum(), xs)
        ys = [x.clone().requires_grad_(True) for x in (q, k, v)]
        want = torch.autograd.grad(  # lse does not depend on v: its gradient is 0
            _flash_cuda.flash_fwd_plain(*ys, causal=False)[pick].sum(), ys,
            allow_unused=True, materialize_grads=True)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)


def test_built_head_dims_cover_every_llama_config():
    """Every config of MODEL_CONFIGS, of every arch, has a built head dim
    in bf16 (gemma's 256 included)."""
    from tpu_engine_torch.models.config import MODEL_CONFIGS

    heads = {c.head_dim for c in MODEL_CONFIGS.values()}
    assert 256 in heads
    assert heads <= set(_flash_cuda.SUPPORTED_HEAD_DIMS), heads


def test_unbuilt_head_dim_raises_on_the_card_not_flash_unsupported():
    """The check the wrappers and ``flash_mha`` run: a CUDA device with an
    unbuilt head dim (80) raises ``ValueError``, which ``mha`` does not turn
    into the plain path; the CPU takes any head dim."""
    for d in _flash_cuda.SUPPORTED_HEAD_DIMS:
        _flash_cuda.check_head_dim(d, "cuda")
    with pytest.raises(ValueError, match="head_dim=80") as err:
        _flash_cuda.check_head_dim(80, torch.device("cuda"))
    assert not isinstance(err.value, tfa.FlashUnsupported)
    _flash_cuda.check_head_dim(80, "cpu")
    q = _t(_qkv(12, (1, 64, 2, 80), (1, 64, 2, 80))[0])
    np.testing.assert_allclose(tfa.mha(q, q, q).numpy(),
                               tfa.mha(q, q, q, force_xla=True).numpy(), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("d,bh,by", [(16, 64, "exp"), (32, 64, "exp"), (128, 64, "operations"),
                                     (256, 32, "operations")])
def test_kernel_bounds_count_the_exp_unit(d, bh, by):
    """The card's bound of each kernel is the longest of its tensor-core
    operations, its exps (one per visible pair at 16 a clock per SM) and its
    bytes: the exps bind K1 and K2 below D 64 (causal S 2048 at B·H 64:
    134.3e6 pairs, 0.0347 ms), the products at D 128 and 256."""
    import chip_smoke as cs

    s = 2048
    pairs = bh * s * (s + 1) // 2
    bounds = cs.kernel_bounds(bh, s, d, 0, 2)
    for name in ("flash_fwd", "flash_bwd_dq"):
        assert bounds[name]["exps"] == pairs
        assert bounds[name]["bound_by"] == by
    exp_ms = pairs / cs.PEAK_EXP2 * 1e3
    assert all(b["bound_ms"] >= exp_ms for b in bounds.values())
    if by == "exp":
        assert bounds["flash_fwd"]["bound_ms"] == pytest.approx(exp_ms)
        assert bh != 64 or exp_ms == pytest.approx(0.0347, abs=5e-5)
