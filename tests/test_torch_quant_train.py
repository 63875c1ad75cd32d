"""Port parity: int8 quantised training (``tpu_engine_torch.quant_train``
and the model's ``_train_dot`` hook) against ``tpu_engine.quant_train`` and
JAX's quantised train program, on the CPU. Inputs come from numpy seeds."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_engine import quant_train as jq  # noqa: E402
from tpu_engine import train as jtrain  # noqa: E402
from tpu_engine.mesh_runtime import MeshConfig, MeshRuntime  # noqa: E402
from tpu_engine.sharding import TPUTrainConfig  # noqa: E402
from tpu_engine_torch import quant_train as tq  # noqa: E402
from tpu_engine_torch import train as ttrain  # noqa: E402
from tpu_engine_torch.models import convert  # noqa: E402

# tests/test_quant_train.py's specs: the projections and the MoE products.
SPECS = [
    ("bsi,io->bso", (2, 8, 16), (16, 32)),
    ("ebcd,edf->ebcf", (3, 2, 8, 16), (3, 16, 32)),
    ("ebcf,efd->ebcd", (3, 2, 8, 32), (3, 32, 16)),
]


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("shape,axes", [((8, 33), (0,)), ((8, 33), (1,)),
                                        ((4, 6, 10), (2,)), ((4, 6, 10), (1, 2))])
def test_channel_quantize_equals_jax(shape, axes):
    """Round to nearest (half to even on both sides): codes and scales
    bitwise equal."""
    x = _normal(0, shape, 3.0)
    x.flat[:4] = [0.5, -1.5, 2.5, 0.0]  # ties and a zero in the first channel
    jc, js = jq.channel_quantize(jnp.asarray(x), axes)
    tc, ts = tq.channel_quantize(torch.tensor(x), axes)
    assert tc.dtype == torch.int8 and tuple(ts.shape) == tuple(js.shape)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("spec,lshape,rshape", SPECS)
def test_int8_einsum_forward_equals_jax(spec, lshape, rshape):
    """The same codes summed in int32 and scaled in fp32: held to 1e-6
    relative (equal in practice)."""
    lhs, rhs = _normal(1, lshape), _normal(2, rshape)
    want = np.asarray(jq.int8_einsum(spec, jnp.asarray(lhs), jnp.asarray(rhs)))
    got = tq.int8_einsum(spec, torch.tensor(lhs), torch.tensor(rhs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    assert tq._transpose_specs(spec) == jq._transpose_specs(spec)
    assert tq._contraction_axes(spec) == jq._contraction_axes(spec)


@pytest.mark.parametrize("spec,lshape,rshape", SPECS)
def test_int8_einsum_gradients_track_full_precision(spec, lshape, rshape):
    """The straight-through backward's gradients against the exact fp32
    gradients: cosine above 0.999, JAX's bar."""
    lhs, rhs = _normal(3, lshape), _normal(4, rshape)
    grads = {}
    for name, fn in (("int8", tq.int8_einsum), ("fp32", torch.einsum)):
        a = torch.tensor(lhs, requires_grad=True)
        b = torch.tensor(rhs, requires_grad=True)
        (fn(spec, a, b) ** 2).sum().backward()
        grads[name] = (a.grad.numpy().ravel(), b.grad.numpy().ravel())
    for g, f in zip(grads["int8"], grads["fp32"]):
        assert g @ f / (np.linalg.norm(g) * np.linalg.norm(f)) > 0.999


def test_int_mm_pads_shapes_the_card_refuses():
    """M 5, K 60, N 7 (the card wants M > 16 and K, N multiples of 8):
    zero-code padding leaves the int32 sums exact."""
    rng = np.random.default_rng(5)
    a = torch.tensor(rng.integers(-127, 128, (5, 60)), dtype=torch.int8)
    b = torch.tensor(rng.integers(-127, 128, (7, 60)), dtype=torch.int8)
    tq.reset_launches()
    out = tq.int_mm(a, b)
    assert out.dtype == torch.int32 and tuple(out.shape) == (5, 7)
    np.testing.assert_array_equal(out.numpy(), a.long().numpy() @ b.long().numpy().T)
    assert tq.launches["int_mm"] == 1


def test_stochastic_codes_are_unbiased_neighbours():
    """Each stochastic code is the floor or the ceiling of the scaled value;
    over 300 draws (explicit salts) the mean code lies within 3σ of it."""
    x = torch.tensor(_normal(6, (4, 64)))
    _, scales = tq.channel_quantize(x, (1,))
    y = (x / scales).numpy()
    draws = np.stack([tq.channel_quantize(x, (1,), salt=i)[0].numpy() for i in range(300)])
    assert np.all((draws == np.floor(y)) | (draws == np.ceil(y)))
    frac = y - np.floor(y)
    sigma = np.sqrt(len(draws) * np.sum(frac * (1 - frac))) / draws.size  # of the mean
    assert abs(float(np.mean(draws - y))) <= 3 * sigma
    # JAX's own test: a constant 0.3 dequantises to 0.3 on average.
    c = torch.full((1, 64), 0.3)
    deq = [torch.mul(*tq.channel_quantize(c, (1,), salt=i)).mean() for i in range(300)]
    assert abs(float(torch.stack(deq).mean()) - 0.3) < 0.3 / 127 / 5


def test_rounding_is_keyed_by_the_data():
    """The same operand rounds the same way (a pure function of the data);
    a changed operand draws other noise."""
    x = torch.tensor(_normal(7, (4, 64)))
    c1, _ = tq.channel_quantize(x, (1,), stochastic=True)
    c2, _ = tq.channel_quantize(x.clone(), (1,), stochastic=True)
    assert torch.equal(c1, c2)
    c3, _ = tq.channel_quantize(x * 1.0001, (1,), stochastic=True)
    n3, _ = tq.channel_quantize(x * 1.0001, (1,))
    c4, _ = tq.channel_quantize(x * 1.0002, (1,), stochastic=True)
    assert not torch.equal(c3, c4) and not torch.equal(c3, n3)


_CFG = dict(model_name="gpt-tiny", micro_batch_size=2, seq_len=32, precision="fp32",
            param_dtype="fp32", learning_rate=1e-3, warmup_steps=2, total_steps=100,
            activation_checkpointing=False, attention_impl="xla")


def _jax_program(**kw):
    cfg = TPUTrainConfig(mesh=MeshConfig(data=1), **{**_CFG, **kw})
    return jtrain.build_train_program(cfg, runtime=MeshRuntime(cfg.mesh,
                                                               devices=jax.devices()[:1]))


def _first_losses(**kw):
    """(JAX's, the port's) loss of the same initial weights and batch, and
    the port's losses over four more steps on that batch."""
    jprog = _jax_program(**kw)
    state = jprog.init(jax.random.PRNGKey(0))
    batch = np.asarray(jprog.synthetic_batch(0))
    init = jax.tree.map(np.asarray, state["params"])  # the step donates the state
    _, m = jprog.step(state, jax.device_put(jnp.asarray(batch), jprog.batch_sharding))
    tprog = ttrain.build_train_program(ttrain.TrainConfig(**{**_CFG, **kw}), device="cpu")
    tstate = tprog.init(params=convert.params_from_jax(init, tprog.model_config, device="cpu"))
    tbatch = torch.tensor(batch, dtype=torch.long)
    losses = []
    for _ in range(5):
        tstate, tm = tprog.step(tstate, tbatch)
        losses.append(float(tm["loss"]))
    return float(m["loss"]), losses


@pytest.mark.parametrize("kw", [{}, {"model_name": "moe-tiny", "moe_impl": "dense"}],
                         ids=["gpt-tiny", "moe-tiny"])
def test_first_int8_loss_equals_jax(kw):
    """The first loss of int8 training (gpt-tiny; moe-tiny with dense
    dispatch, its expert products through the hook) equals JAX's within
    1e-6 relative: the forward's codes are JAX's. The port's loss then
    falls."""
    jl, tl = _first_losses(quant_training="int8", **kw)
    assert tl[0] == pytest.approx(jl, rel=1e-6)
    assert tl[-1] < tl[0], tl


def test_int8_training_tracks_full_precision():
    """Nine steps on one repeated batch: int8 within 0.01 of the port's
    own fp32 run at every step and both falling (JAX's bar,
    tests/test_quant_train.py). With checkpointing, ``_int_mm`` runs four
    times per targeted product per microbatch (forward, recompute, and
    the two backward products)."""
    runs = {}
    for quant in ("none", "int8"):
        prog = ttrain.build_train_program(
            ttrain.TrainConfig(**{**_CFG, "quant_training": quant,
                                  "activation_checkpointing": True}), device="cpu")
        state = prog.init()
        batch = prog.synthetic_batch(0)
        tq.reset_launches()
        losses = []
        for _ in range(9):
            state, m = prog.step(state, batch)
            losses.append(float(m["loss"]))
        runs[quant] = (losses, tq.launches["int_mm"])
    (base, n_base), (q, n_q) = runs["none"], runs["int8"]
    assert base[-1] < base[0] and q[-1] < q[0]
    assert all(abs(b - c) <= 0.01 for b, c in zip(base, q)), (base, q)
    assert any(b != c for b, c in zip(base, q))
    products = 2 * 7  # gpt-tiny: 2 layers of q, k, v, o, gate, up, down
    assert (n_base, n_q) == (0, 9 * products * 4)


@pytest.mark.parametrize("kw", [
    dict(quant_training="int8", lora_rank=4),
    dict(quant_training="int8", moe_impl="ragged", model_name="moe-tiny"),
    dict(quant_training="int8", quant_train_targets=()),
    dict(quant_train_targets=("attn", "bogus")),
], ids=["lora", "ragged", "empty", "unknown"])
def test_config_rejections_give_jaxs_message(kw):
    with pytest.raises(ValueError) as want:
        TPUTrainConfig(mesh=MeshConfig(data=1), **{**_CFG, **kw})
    with pytest.raises(ValueError) as got:
        ttrain.TrainConfig(**{**_CFG, **kw})
    assert str(got.value) in str(want.value)  # pydantic wraps JAX's message


def test_training_plan_matches_jax():
    for quant in ("none", "int8"):
        jp = jq.training_plan(TPUTrainConfig(quant_training=quant))
        tp = tq.training_plan(ttrain.TrainConfig(quant_training=quant))
        assert set(tp) == set(jp) and tp["targets"] == jp["targets"]
        assert tp["enabled"] == jp["enabled"] == (quant == "int8")
