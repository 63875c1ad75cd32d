"""Port parity: int8 quantised training on a mesh
(``tpu_engine_torch/quant_train.py``) against JAX's int8 program on the
same mesh of four CPU devices, the port on four ``gloo`` ranks
(``tests/torch_mesh_worker.py``): gpt-tiny on ``data=4`` (stage 0), on
``data=2, fsdp=2, dcn_data=2`` with qwZ and qgZ across the slices
``[0, 0, 1, 1]`` (stage 3), and on ``pipe=2, fsdp=2`` where "auto"
resolves to gpipe; and over ``model=2, data=2``: gpt-tiny, a GQA llama
(gpt-tiny with one kv head, so K and V stay whole and both ranks read it)
and moe-tiny in dense dispatch (one expert pair a rank).

JAX quantises in its GSPMD program, so a product's per-channel scales are
taken over the whole operand: the weight gradient's, which sums over the
tokens, over every rank that holds a part of the microbatch; a product
whose contraction dim ``model`` splits (o and down forward, the other
projections' input gradients), over the model ranks. Under the compressed
collectives its loss runs in a manual region, where each device's scales
are its own. The forward's codes equal JAX's on a rank's operands; the
backward's stochastic rounding is a counter hash where JAX draws threefry
bits, so the losses are held, not the bits.

Bounds: those ``tests/test_torch_quant_train.py`` holds the one-device
int8 step to: the first loss within 1e-6 relative of JAX's (the forward's
codes are JAX's), every later loss within JAX's own bar of 0.01, and the
loss falling."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_mesh_train import _unflatten  # noqa: E402
from tpu_engine import quant_train as jqt  # noqa: E402
from tpu_engine import train as jtrain  # noqa: E402
from tpu_engine.mesh_runtime import MeshConfig, MeshRuntime  # noqa: E402
from tpu_engine.models import transformer as jtfm  # noqa: E402
from tpu_engine.sharding import TPUTrainConfig  # noqa: E402
from tpu_engine_torch.models import convert  # noqa: E402
from torch_mesh_worker import spawn  # noqa: E402

WORLD = 4
STEPS = 3
ROWS, SEQ = 4, 32
_KW = dict(seq_len=SEQ, precision="fp32", param_dtype="fp32", attention_impl="xla",
           learning_rate=1e-3, warmup_steps=2, total_steps=100,
           activation_checkpointing=False, quant_training="int8")
SLICES = [0, 0, 1, 1]
TP = dict(model=2, data=2)
GQA = dict(n_kv_heads=1)
# (case, model, config fields changed, mesh, fields, slices)
CASES = [
    ("data4", "gpt-tiny", {}, dict(data=4), dict(sharding_stage=0, gradient_accumulation_steps=2),
     None),
    ("slices", "gpt-tiny", {}, dict(data=2, fsdp=2, dcn_data=2),
     dict(sharding_stage=3, gradient_accumulation_steps=2, comm_quant_weights=True,
          comm_quant_grads=True, comm_quant_block_size=64), SLICES),
    ("pipe", "gpt-tiny", {}, dict(pipe=2, fsdp=2),
     dict(sharding_stage=3, gradient_accumulation_steps=4, pipeline_schedule="auto"), None),
    ("tp_gpt", "gpt-tiny", {}, TP, dict(gradient_accumulation_steps=2), None),
    ("tp_gqa", "gpt-tiny", GQA, TP, dict(gradient_accumulation_steps=2), None),
    ("tp_moe", "moe-tiny", {}, TP,
     dict(gradient_accumulation_steps=2, moe_impl="dense",
          quant_train_targets=("attn", "mlp", "moe")), None),
]


def _jcfg(model: str, over: dict):
    return jtfm.MODEL_CONFIGS[model].with_(**over) if over else jtfm.MODEL_CONFIGS[model]


def _init(model: str, over: dict) -> dict:
    """JAX's initial weights; moe-tiny's router drawn wider (clear routing
    margins, tests/test_torch_moe.py)."""
    flat = convert._flatten(jax.tree.map(np.asarray, jtfm.init_params(
        jax.random.PRNGKey(0), _jcfg(model, over))))
    if "layers.router.kernel" in flat:
        flat["layers.router.kernel"] = flat["layers.router.kernel"] * 5.0
    return flat


def _micro(mesh: dict) -> int:
    return ROWS // (mesh.get("data", 1) * mesh.get("fsdp", 1))


def _batches(accum: int) -> np.ndarray:
    """One batch each step, as JAX's int8 tests: the loss must fall."""
    one = np.random.default_rng(0).integers(0, 512, (accum, ROWS, SEQ)).astype(np.int32)
    return np.stack([one] * STEPS)


def _jax_losses(model: str, over: dict, mesh: dict, extra: dict, slices,
                flat: dict) -> tuple[np.ndarray, str]:
    cfg = TPUTrainConfig(model_name=model, micro_batch_size=_micro(mesh),
                         mesh=MeshConfig(**mesh), **{**_KW, **extra})
    prog = jtrain.build_train_program(cfg, _jcfg(model, over), runtime=MeshRuntime(
        cfg.mesh, devices=jax.devices()[:WORLD], slice_assignments=slices))
    state = prog.init(jax.random.PRNGKey(0))
    state["params"] = jax.device_put(jax.tree.map(jnp.asarray, _unflatten(flat)),
                                     jax.tree.map(lambda a: a.sharding, state["params"]))
    losses = []
    for b in _batches(extra["gradient_accumulation_steps"]):
        state, m = prog.step(state, jax.device_put(jnp.asarray(b), prog.batch_sharding))
        losses.append(float(m["loss"]))
    return np.array(losses), prog.pipeline_schedule


# The scale cases: gpt-tiny, whose kv heads split over model=2, and with one
# kv head, whose K and V stay whole on both ranks.
SCALE_CASES = {"tp_scales": {}, "tp_scales_gqa": GQA}


def _tp_operands(kv_heads: int) -> dict:
    """Whole operands of the o and down products and the q, k, v kernels
    and input (gpt-tiny's widths, ``kv_heads`` of 16), one channel's
    maximum in the second model rank's block."""
    rng = np.random.default_rng(5)
    ops = {"o_x": rng.standard_normal((2, 8, 64)), "o_w": rng.standard_normal((64, 64)) * 0.1,
           "down_x": rng.standard_normal((2, 8, 128)), "down_w": rng.standard_normal((128, 64)),
           "qkv_h": rng.standard_normal((2, 8, 64)), "q_w": rng.standard_normal((64, 64)) * 0.1,
           "k_w": rng.standard_normal((64, 16 * kv_heads)) * 0.1,
           "v_w": rng.standard_normal((64, 16 * kv_heads)) * 0.1}
    ops["o_x"][1, 3, 50] = 30.0
    ops["down_w"][100, 7] = -9.0
    ops["q_w"][5, 40] = 9.0
    return {k: v.astype(np.float32) for k, v in ops.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_int8")
    x = (np.random.default_rng(4).standard_normal((ROWS, 8, 16)) * 3).astype(np.float32)
    x[2, 5, 3] = 40.0  # one rank's rows hold a channel's maximum
    np.savez(tmp / "x.npz", x=x)
    cases = [dict(name="scales", kind="int8_scales", mesh=dict(data=2, fsdp=2),
                  inputs=str(tmp / "x.npz"))]
    ops = {}
    for name, over in SCALE_CASES.items():
        ops[name] = _tp_operands(over.get("n_kv_heads", 4))
        np.savez(tmp / f"{name}.npz", **ops[name])
        cases.append(dict(name=name, kind="int8_tp_scales", mesh=TP, model_cfg=over,
                          inputs=str(tmp / f"{name}.npz")))
    inits = {}
    for name, model, over, mesh, extra, slices in CASES:
        accum = extra["gradient_accumulation_steps"]
        np.save(tmp / f"batches{accum}.npy", _batches(accum))
        key = model + "".join(f"_{k}{v}" for k, v in over.items())
        if key not in inits:
            inits[key] = _init(model, over)
            np.savez(tmp / f"{key}.npz", **inits[key])
        cases.append(dict(name=name, kind="train", mesh=mesh, slices=slices, model_cfg=over,
                          init=str(tmp / f"{key}.npz"),
                          batches=str(tmp / f"batches{accum}.npy"),
                          cfg={**_KW, "model_name": model, "micro_batch_size": _micro(mesh),
                               **extra}))

    def references():
        return {name: _jax_losses(model, over, mesh, extra, slices,
                                  inits[model + "".join(f"_{k}{v}" for k, v in over.items())])
                for name, model, over, mesh, extra, slices in CASES}

    got, refs = spawn({"cases": cases}, WORLD, tmp, timeout=150, during=references)
    return got, refs, x, ops


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_int8_losses_match_jax_on_the_mesh(runs, name):
    """Every rank's losses: the first within 1e-6 relative of JAX's int8
    program on the same mesh, each later one within 0.01, falling; the
    int8 products ran on every rank; on ``pipe`` both resolve "auto" to
    gpipe."""
    got, refs, *_ = runs
    want, schedule = refs[name]
    for r in range(WORLD):
        out = got[(name, r)]
        losses = out["losses"]
        assert losses[0] == pytest.approx(want[0], rel=1e-6)
        assert np.all(np.abs(losses - want) <= 0.01), (losses, want)
        assert losses[-1] < losses[0]
        assert int(out["int_mm"]) > 0
        if name == "pipe":
            assert str(out["schedule"]) == schedule == "gpipe"


def test_weight_gradient_scales_span_the_token_ranks(runs):
    """The weight gradient's operand scales (absmax over batch and
    sequence) on each rank's rows, reduced over the token ranks, equal
    JAX's over the whole operand; each rank's forward codes and row scales
    equal JAX's of its rows."""
    got, _, x, _ = runs
    _, want = jqt.channel_quantize(jnp.asarray(x), (0, 1))
    for r in range(WORLD):
        out = got[("scales", r)]
        np.testing.assert_array_equal(out["scales"], np.asarray(want))
        rows = x[r:r + 1]  # rank r is (data r // 2, fsdp r % 2): zero.local_rows' row r
        codes, scales = jqt.channel_quantize(jnp.asarray(rows), (2,))
        np.testing.assert_array_equal(out["codes"], np.asarray(codes))
        np.testing.assert_array_equal(out["row_scales"], np.asarray(scales))


def test_row_parallel_forward_scales_span_the_model_ranks(runs):
    """The o and down products on ``model=2``: each rank quantises its
    block of the activation and of the kernel with the scales of the whole
    operand, bitwise JAX's ``channel_quantize`` of it (row scales over
    heads·hd or d_ff, column scales over the same), and the partial
    products summed over ``model`` equal JAX's int8 product of the whole
    operands to fp32 rounding (1e-6 of its largest entry)."""
    got, _, _, ops = runs
    ops = ops["tp_scales"]
    for name in ("o", "down"):
        x, w = jnp.asarray(ops[f"{name}_x"]), jnp.asarray(ops[f"{name}_w"])
        _, sx = jqt.channel_quantize(x, (2,))
        _, sw = jqt.channel_quantize(w, (0,))
        want = np.asarray(jqt.int8_einsum("bsi,io->bso", x, w))
        for r in range(WORLD):
            out = got[("tp_scales", r)]
            np.testing.assert_array_equal(out[f"{name}_x_scales"], np.asarray(sx))
            np.testing.assert_array_equal(out[f"{name}_w_scales"], np.asarray(sw))
            np.testing.assert_allclose(out[f"{name}_y"], want, rtol=0,
                                       atol=1e-6 * np.abs(want).max())


def _model_groups(got: dict, case: str) -> list[list[dict]]:
    """Each data index's ranks of ``case``, in their ``model`` order."""
    outs = [got[(case, r)] for r in range(WORLD)]
    return [sorted((o for o in outs if int(o["data_index"]) == d),
                   key=lambda o: int(o["model_index"])) for d in range(2)]


@pytest.mark.parametrize("case", list(SCALE_CASES))
def test_column_parallel_input_gradient_scales_span_the_model_ranks(runs, case):
    """One backward through ``_qkv`` on ``model=2``. Where ``model`` splits
    a projection's output dim (q; k and v where the kv heads split), each
    rank quantises its block of the cotangent and of the kernel with the
    scales of the whole, bitwise JAX's ``channel_quantize`` of the blocks
    joined over ``model`` (per-token scales over heads·hd, the kernel's
    row scales over the same). Where K and V stay whole (one kv head),
    every rank holds the whole kernel and the partial cotangent of its
    query heads: the port takes the MAX of the partials' absmax, where
    JAX's program takes the absmax of their sum (ROADMAP, "Layouts that
    differ"); held to that rule, bitwise."""
    got = runs[0]
    whole_kv = "n_kv_heads" in SCALE_CASES[case]
    for group in _model_groups(got, case):
        for name in ("q", "k", "v"):
            if name != "q" and whole_kv:
                w = group[0][f"{name}_wb"]
                _, sw = jqt.channel_quantize(jnp.asarray(w), (1,))
                parts = [np.asarray(jqt.channel_quantize(jnp.asarray(o[f"{name}_g"]), (2,))[1])
                         for o in group]
                sg = np.maximum(*parts)
            else:
                g = np.concatenate([o[f"{name}_g"] for o in group], axis=-1)
                w = np.concatenate([o[f"{name}_wb"] for o in group], axis=-1)
                _, sg = jqt.channel_quantize(jnp.asarray(g), (2,))
                _, sw = jqt.channel_quantize(jnp.asarray(w), (1,))
            for o in group:
                np.testing.assert_array_equal(o[f"{name}_g_scales"], np.asarray(sg))
                np.testing.assert_array_equal(o[f"{name}_wb_scales"], np.asarray(sw))
