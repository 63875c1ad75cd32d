"""Port parity: the PyTorch training slice (``tpu_engine_torch.train``)
against the JAX train program on gpt-tiny, on the CPU.

Both packages start from the same numpy weights and take the same numpy
batches; the JAX side runs ``attention_impl="xla"`` on a one-device mesh and
the port its plain attention path."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_engine import train as jtrain  # noqa: E402
from tpu_engine.mesh_runtime import MeshConfig, MeshRuntime  # noqa: E402
from tpu_engine.models import transformer as jtfm  # noqa: E402
from tpu_engine.sharding import TPUTrainConfig  # noqa: E402
from tpu_engine_torch import train as ttrain  # noqa: E402
from tpu_engine_torch.models import config as tcfg  # noqa: E402
from tpu_engine_torch.models import convert  # noqa: E402
from tpu_engine_torch.models import transformer as ttfm  # noqa: E402


@pytest.mark.parametrize("shape", ["cosine", "linear", "constant", "rsqrt"])
def test_make_schedule_matches_jax(shape):
    kw = dict(lr_schedule=shape, learning_rate=1e-3, min_lr=1e-4,
              warmup_steps=3, total_steps=8)
    jsched = jtrain.make_schedule(TPUTrainConfig(**kw))
    tsched = ttrain.make_schedule(ttrain.TrainConfig(**kw))
    for step in range(10):
        assert tsched(step) == pytest.approx(float(jsched(step)), rel=1e-6, abs=1e-12)


def test_train_config_rejects_unsupported_values():
    with pytest.raises(ValueError, match="precision"):
        ttrain.TrainConfig(precision="fp8")
    with pytest.raises(ValueError, match="attention_impl"):
        ttrain.TrainConfig(attention_impl="paged")
    with pytest.raises(ValueError, match="sequence"):
        ttrain.TrainConfig(seq_len=2048, sequence=3)
    with pytest.raises(ValueError, match="loss_chunk_size"):
        ttrain.TrainConfig(seq_len=32, loss_chunk_size=5)
    # Quantised training is ported (tests/test_torch_quant_train.py); the
    # config's quant fields resolve onto the model config as in JAX, and
    # ragged MoE with the "moe" target raises JAX's ValueError at build.
    with pytest.raises(ValueError, match="ragged MoE"):
        ttrain.build_train_program(ttrain.TrainConfig(model_name="moe-tiny",
                                                      quant_training="int8"), device="cpu",
                                   model_cfg=tcfg.MODEL_CONFIGS["moe-tiny"].with_(
                                       moe_impl="ragged"))
    prog = ttrain.build_train_program(ttrain.TrainConfig(model_name="moe-tiny"), device="cpu",
                                      model_cfg=tcfg.MODEL_CONFIGS["moe-tiny"].with_(
                                          quant_training="int8"))
    assert prog.model_config.quant_training == "none"
    # gpt2, qwen, gemma and MoE are ported (tests/test_torch_archs.py,
    # tests/test_torch_moe.py).
    for name in ("gpt2-tiny", "qwen-tiny", "gemma-tiny", "moe-tiny"):
        prog = ttrain.build_train_program(ttrain.TrainConfig(model_name=name), device="cpu")
        assert prog.model_config.arch == ("llama" if name == "moe-tiny" else name.split("-")[0])


def test_auto_attention_resolves_to_plain_on_cpu():
    prog = ttrain.build_train_program(ttrain.TrainConfig(model_name="gpt-tiny"), device="cpu")
    assert prog.model_config.attention_impl == "xla"
    flash = ttrain.build_train_program(
        ttrain.TrainConfig(model_name="gpt-tiny", attention_impl="flash"), device="cpu")
    assert flash.model_config.attention_impl == "flash"


_COMMON = dict(
    model_name="gpt-tiny", micro_batch_size=2, gradient_accumulation_steps=2,
    seq_len=32, precision="fp32", attention_impl="xla", learning_rate=1e-3,
    min_lr=1e-4, warmup_steps=2, total_steps=8, weight_decay=0.1,
    activation_checkpointing=True,
)
_STEPS = 4


def _batches():
    rng = np.random.default_rng(0)
    out = []
    for _ in range(_STEPS):
        b = rng.integers(0, 512, (2, 2, 32)).astype(np.int32)
        # A few SFT-masked positions, -(t+1), exercise the global denominator.
        b[0, 0, :5] = -b[0, 0, :5] - 1
        out.append(b)
    return out


def _jax_program(kw):
    """The JAX program on a one-device mesh (the single-device step)."""
    cfg = TPUTrainConfig(mesh=MeshConfig(data=1), **kw)
    return jtrain.build_train_program(
        cfg, runtime=MeshRuntime(cfg.mesh, devices=jax.devices()[:1]))


def _run_jax(kw):
    prog = _jax_program(kw)
    state = prog.init(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, state["params"])
    losses, norms = [], []
    for b in _batches():
        state, m = prog.step(state, jax.device_put(jnp.asarray(b), prog.batch_sharding))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return init, losses, norms, jax.tree.map(np.asarray, state["params"])


def _run_torch(kw, init):
    prog = ttrain.build_train_program(ttrain.TrainConfig(**kw), device="cpu")
    state = prog.init(params=convert.params_from_jax(init, prog.model_config, device="cpu"))
    losses, norms = [], []
    for b in _batches():
        state, m = prog.step(state, torch.tensor(b, dtype=torch.long))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, convert.params_to_numpy(state["params"])


# Final-weight bounds. fp32 moments: the two frameworks sum in other
# orders, and Adam divides by sqrt(nu), which turns a last-bit difference in
# a small gradient into a larger relative one; measured max 1.4e-7 after
# four steps at lr 1e-3, held to 1e-6. bf16 first moments: a last-bit fp32
# difference can round the stored moment to the neighbouring bf16 value
# (relative 2^-8), moving that weight by ~lr·2^-8 = 4e-6 a step; measured
# max 3.1e-5, held to 1e-4.
@pytest.mark.parametrize("extra,atol", [
    ({}, 1e-6),
    ({"moment_dtype": "bf16"}, 1e-4),
    ({"loss_chunk_size": 8, "z_loss_coef": 1e-3, "activation_checkpointing": False}, 1e-6),
], ids=["fp32_moments", "bf16_moments", "chunked_loss_zloss"])
def test_train_slice_matches_jax(extra, atol):
    kw = {**_COMMON, **extra}
    init, jl, jn, jp = _run_jax(kw)
    tl, tn, tp = _run_torch(kw, init)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    np.testing.assert_allclose(tn, jn, rtol=1e-4)
    for path, a in jax.tree_util.tree_leaves_with_path(jp):
        b = tp
        for p in path:
            b = b[p.key]
        np.testing.assert_allclose(b, a, atol=atol, rtol=0,
                                   err_msg=".".join(p.key for p in path))


def test_losses_and_sft_masking_match_jax():
    """lm_loss and chunked_lm_loss, with SFT-masked targets and z-loss,
    against the JAX functions on the same numpy logits, hidden states and
    weights (fp32: same arithmetic, other summation orders)."""
    rng = np.random.default_rng(5)
    raw = rng.integers(0, 512, (2, 16)).astype(np.int32)
    raw[0, :4] = -raw[0, :4] - 1
    jclean, jtok = jtrain.decode_masked_tokens(jnp.asarray(raw))
    tclean, ttok = ttrain.decode_masked_tokens(torch.tensor(raw, dtype=torch.long))
    np.testing.assert_array_equal(tclean.numpy(), np.asarray(jclean))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))

    logits = rng.standard_normal((2, 16, 512)).astype(np.float32)
    for z in (0.0, 1e-3):
        want = float(jtrain.lm_loss(jnp.asarray(logits), jtok, z))
        assert float(ttrain.lm_loss(torch.tensor(logits), ttok, z)) == pytest.approx(
            want, rel=1e-6)

    jc = jtfm.MODEL_CONFIGS["gpt-tiny"]
    tree = jax.tree.map(np.asarray, jtfm.init_params(jax.random.PRNGKey(2), jc))
    tc = tcfg.MODEL_CONFIGS["gpt-tiny"]
    params = convert.params_from_jax(tree, tc, device="cpu")
    hidden = rng.standard_normal((2, 16, jc.d_model)).astype(np.float32)
    want = float(jtrain.chunked_lm_loss(tree, jnp.asarray(hidden), jtok, jc, 4, 1e-3))
    with torch.no_grad():
        got = float(ttrain.chunked_lm_loss(params, torch.tensor(hidden), ttok, tc, 4, 1e-3))
        whole = float(ttrain.lm_loss(ttfm.unembed(params, torch.tensor(hidden), tc), ttok, 1e-3))
    assert got == pytest.approx(want, rel=1e-6)
    assert got == pytest.approx(whole, rel=1e-6)


def test_eval_step_matches_jax():
    kw = dict(_COMMON)
    prog = _jax_program(kw)
    state = prog.init(jax.random.PRNGKey(1))
    b = _batches()[0]
    jloss = float(prog.eval_step(state, jax.device_put(jnp.asarray(b), prog.batch_sharding)))
    tprog = ttrain.build_train_program(ttrain.TrainConfig(**kw), device="cpu")
    tstate = tprog.init(params=convert.params_from_jax(
        jax.tree.map(np.asarray, state["params"]), tprog.model_config, device="cpu"))
    tloss = float(tprog.eval_step(tstate, torch.tensor(b, dtype=torch.long)))
    assert tloss == pytest.approx(jloss, rel=1e-5)


def test_synthetic_batch_shape_and_range():
    prog = ttrain.build_train_program(ttrain.TrainConfig(**_COMMON), device="cpu")
    b = prog.synthetic_batch(seed=3)
    assert tuple(b.shape) == prog.global_batch_shape() == (2, 2, 32)
    assert int(b.min()) >= 0 and int(b.max()) < 512
    assert torch.equal(b, prog.synthetic_batch(seed=3))
