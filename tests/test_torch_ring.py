"""Port parity: ring attention (``tpu_engine_torch.parallel.ring_attention``)
and sequence-parallel training against the JAX package, on the CPU.

The port runs every rank of the ring in one process with the in-process
K/V rotation; the JAX side runs its ring under ``shard_map`` on the forced
CPU devices of the root conftest. On CPU tensors the port's kernel wrappers
run their plain versions, and the JAX Pallas kernels run in interpret mode.
Tolerances are ``tests/test_flash_attention.py``'s: fp32 forward 2e-5, fp32
gradients 5e-4."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_engine import train as jtrain  # noqa: E402
from tpu_engine.mesh_runtime import MeshConfig, MeshRuntime, build_mesh  # noqa: E402
from tpu_engine.ops.flash_attention import mha as jmha  # noqa: E402
from tpu_engine.parallel.ring_attention import ring_mha as jring_mha  # noqa: E402
from tpu_engine.sharding import TPUTrainConfig  # noqa: E402
from tpu_engine_torch import train as ttrain  # noqa: E402
from tpu_engine_torch.models import convert  # noqa: E402
from tpu_engine_torch.models.config import MODEL_CONFIGS  # noqa: E402
from tpu_engine_torch.ops import flash_attention as tfa  # noqa: E402
from tpu_engine_torch.parallel import ring_attention as ra  # noqa: E402


def _qkv(seed, B, S, H, KV, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, S, KV, D)).astype(np.float32),
            rng.standard_normal((B, S, KV, D)).astype(np.float32))


def _torch_out_and_grads(fn, q, k, v):
    """fn's output and the gradients of sum(o**2) for q, k, v."""
    xs = [torch.tensor(x).requires_grad_(True) for x in (q, k, v)]
    out = fn(*xs)
    grads = torch.autograd.grad((out ** 2).sum(), xs)
    return out.detach().numpy(), [g.numpy() for g in grads]


def _jax_out_and_grads(fn, q, k, v):
    def loss(q, k, v):
        return jnp.sum(fn(q, k, v) ** 2)

    args = tuple(jnp.asarray(x) for x in (q, k, v))
    return np.asarray(fn(*args)), jax.grad(loss, argnums=(0, 1, 2))(*args)


def _assert_match(got, want, out_tol=2e-5, grad_tol=5e-4):
    np.testing.assert_allclose(got[0], np.asarray(want[0]), atol=out_tol, rtol=out_tol)
    for a, b in zip(got[1], want[1]):
        np.testing.assert_allclose(a, np.asarray(b), atol=grad_tol, rtol=grad_tol)


def _jax_ring(sequence):
    mesh = build_mesh(MeshConfig(sequence=sequence), devices=jax.devices()[:sequence])
    return jax.jit(lambda q, k, v: jring_mha(q, k, v, mesh=mesh))


def test_ring_kernel_path_matches_jax_ring():
    """Local shards of 64 take the flash body on both sides (JAX: the Pallas
    kernels in interpret mode; the port: the kernels' plain versions), with
    GQA rotating compact K/V."""
    q, k, v = _qkv(0, B=2, S=128, H=4, KV=2, D=64)
    assert ra._uses_kernels(64, 64)
    got = _torch_out_and_grads(lambda q, k, v: ra.ring_mha(q, k, v, sequence=2), q, k, v)
    _assert_match(got, _jax_out_and_grads(_jax_ring(2), q, k, v))


def test_ring_of_four_matches_full_attention_and_flash():
    q, k, v = _qkv(1, B=1, S=256, H=4, KV=4, D=16)
    got = _torch_out_and_grads(lambda q, k, v: ra.ring_mha(q, k, v, sequence=4), q, k, v)
    ref = _jax_out_and_grads(lambda q, k, v: jmha(q, k, v, causal=True, force_xla=True), q, k, v)
    _assert_match(got, ref)
    flash = _torch_out_and_grads(tfa.flash_mha, q, k, v)
    _assert_match(got, flash)


def test_ring_dense_body_matches_jax_ring():
    """Local shards of 16 do not tile: both sides take the dense body."""
    q, k, v = _qkv(2, B=2, S=64, H=4, KV=2, D=16)
    assert not ra._uses_kernels(16, 16)
    got = _torch_out_and_grads(lambda q, k, v: ra.ring_mha(q, k, v, sequence=4), q, k, v)
    _assert_match(got, _jax_out_and_grads(_jax_ring(4), q, k, v))


def test_ring_non_causal_matches_plain_attention():
    q, k, v = _qkv(3, B=1, S=256, H=2, KV=1, D=32)
    for seq in (4, 16):  # local shards of 64 (flash body) and 16 (dense body)
        got = _torch_out_and_grads(
            lambda q, k, v: ra.ring_mha(q, k, v, sequence=seq, causal=False), q, k, v)
        ref = _jax_out_and_grads(
            lambda q, k, v: jmha(q, k, v, causal=False, force_xla=True), q, k, v)
        _assert_match(got, ref)


def test_hops_launch_diagonal_causal_past_full_and_skip_future(monkeypatch):
    calls = []
    real = ra.flash_fwd_lse

    def spy(q, k, v, causal):
        calls.append(causal)
        return real(q, k, v, causal=causal)

    monkeypatch.setattr(ra, "flash_fwd_lse", spy)
    q, k, v = (torch.tensor(x) for x in _qkv(4, B=1, S=256, H=2, KV=2, D=16))
    ra.ring_mha(q, k, v, sequence=4)
    assert calls.count(True) == 4 and calls.count(False) == 6, calls


def test_in_process_rotation_delivers_what_ppermute_would():
    shards = [torch.full((1,), float(r)) for r in range(4)]
    for rank in range(4):
        rotate = ra.in_process_rotation(shards, shards, rank)
        held = shards[rank]
        for hop in range(3):
            held, _ = rotate(hop, held, held)
            assert int(held) == (rank - hop - 1) % 4


# -- training ----------------------------------------------------------------

_KW = dict(model_name="gpt-tiny", micro_batch_size=2, gradient_accumulation_steps=1,
           seq_len=256, precision="fp32", learning_rate=1e-3, min_lr=1e-4,
           warmup_steps=2, total_steps=8, weight_decay=0.1, activation_checkpointing=True)


def test_ring_training_matches_jax_single_device():
    """gpt-tiny with a ring of 4 (local shards of 64, the flash body) against
    the JAX single-device program with plain attention, from the same
    weights on the same batches: 4 AdamW steps of loss and grad norm."""
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, 512, (1, 2, 256)).astype(np.int32) for _ in range(4)]
    jcfg = TPUTrainConfig(mesh=MeshConfig(data=1), attention_impl="xla", **_KW)
    jprog = jtrain.build_train_program(jcfg, runtime=MeshRuntime(jcfg.mesh,
                                                                 devices=jax.devices()[:1]))
    jstate = jprog.init(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, jstate["params"])
    jl, jn = [], []
    for b in batches:
        jstate, m = jprog.step(jstate, jax.device_put(jnp.asarray(b), jprog.batch_sharding))
        jl.append(float(m["loss"]))
        jn.append(float(m["grad_norm"]))

    prog = ttrain.build_train_program(ttrain.TrainConfig(sequence=4, **_KW), device="cpu")
    assert prog.model_config.attention_impl == "ring"
    state = prog.init(params=convert.params_from_jax(init, prog.model_config, device="cpu"))
    tl, tn = [], []
    for b in batches:
        state, m = prog.step(state, torch.tensor(b, dtype=torch.long))
        tl.append(float(m["loss"]))
        tn.append(float(m["grad_norm"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    np.testing.assert_allclose(tn, jn, rtol=1e-4)


def test_ring_build_rejects_window_and_ulysses():
    windowed = MODEL_CONFIGS["gpt-tiny"].with_(sliding_window=32)
    with pytest.raises(ValueError, match="sliding_window"):
        ttrain.build_train_program(ttrain.TrainConfig(sequence=4, **_KW), model_cfg=windowed,
                                   device="cpu")
    with pytest.raises(NotImplementedError, match="ulysses"):
        ttrain.build_train_program(ttrain.TrainConfig(sequence=4, attention_impl="ulysses",
                                                      **_KW), device="cpu")
    with pytest.raises(NotImplementedError, match="ulysses"):
        ttrain.build_train_program(ttrain.TrainConfig(attention_impl="ulysses", **_KW),
                                   device="cpu")
    with pytest.raises(ValueError, match="sequence"):
        ttrain.TrainConfig(**{**_KW, "seq_len": 250}, sequence=4)


def test_model_ring_needs_its_size_and_matches_jax_ring_forward():
    """``forward`` with ``attention_impl="ring"`` and no ring size raises
    ``ValueError`` (JAX's ring raises without a mesh), rather than run a
    ring of one; with ``sequence=2`` its logits match JAX's ring forward on
    a two-device CPU mesh (fp32, local shards of 64: the flash body)."""
    from tpu_engine.models import transformer as jtfm
    from tpu_engine_torch.models import transformer as ttfm

    jc = jtfm.MODEL_CONFIGS["gpt-tiny"].with_(attention_impl="ring")
    cfg = MODEL_CONFIGS["gpt-tiny"].with_(attention_impl="ring")
    tree = jax.tree.map(np.asarray, jtfm.init_params(jax.random.PRNGKey(6), jc))
    params = convert.params_from_jax(tree, cfg, device="cpu")
    tokens = np.random.default_rng(6).integers(0, 512, (2, 128)).astype(np.int32)
    tt = torch.tensor(tokens, dtype=torch.long)
    with pytest.raises(ValueError, match="requires a mesh"):
        jtfm.forward(tree, jnp.asarray(tokens), jc, compute_dtype=jnp.float32)
    for call in (ttfm.forward, ttfm.forward_and_aux):
        with pytest.raises(ValueError, match="requires a mesh"):
            call(params, tt, cfg, compute_dtype=torch.float32)
    mesh = build_mesh(MeshConfig(sequence=2), devices=jax.devices()[:2])
    ref = jtfm.forward(tree, jnp.asarray(tokens), jc, compute_dtype=jnp.float32, mesh=mesh)
    out = ttfm.forward(params, tt, cfg, compute_dtype=torch.float32, sequence=2)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)
