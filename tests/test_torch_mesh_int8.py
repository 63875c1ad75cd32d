"""Port parity: int8 quantised training on a mesh
(``tpu_engine_torch/quant_train.py``) against JAX's int8 program on the
same mesh of four CPU devices, the port on four ``gloo`` ranks
(``tests/torch_mesh_worker.py``): gpt-tiny on ``data=4`` (stage 0), on
``data=2, fsdp=2, dcn_data=2`` with qwZ and qgZ across the slices
``[0, 0, 1, 1]`` (stage 3), and on ``pipe=2, fsdp=2`` where "auto"
resolves to gpipe.

JAX quantises in its GSPMD program, so a product's per-channel scales are
taken over the whole operand: the weight gradient's, which sums over the
tokens, over every rank that holds a part of the microbatch; under the
compressed collectives its loss runs in a manual region, where each
device's scales are its own. The forward's codes equal JAX's on a rank's
operands; the backward's stochastic rounding is a counter hash where JAX
draws threefry bits, so the losses are held, not the bits.

Bounds: those ``tests/test_torch_quant_train.py`` holds the one-device
int8 step to: the first loss within 1e-6 relative of JAX's (the forward's
codes are JAX's), every later loss within JAX's own bar of 0.01, and the
loss falling."""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_mesh_train import _init  # noqa: E402
from tpu_engine import quant_train as jqt  # noqa: E402
from tpu_engine import train as jtrain  # noqa: E402
from tpu_engine.mesh_runtime import MeshConfig, MeshRuntime  # noqa: E402
from tpu_engine.sharding import TPUTrainConfig  # noqa: E402
from tpu_engine_torch import mesh_runtime as tmr  # noqa: E402
from tpu_engine_torch import train as ttrain  # noqa: E402
from torch_mesh_worker import spawn  # noqa: E402

WORLD = 4
STEPS = 3
ROWS, SEQ = 4, 32
_KW = dict(model_name="gpt-tiny", seq_len=SEQ, precision="fp32", param_dtype="fp32",
           attention_impl="xla", learning_rate=1e-3, warmup_steps=2, total_steps=100,
           activation_checkpointing=False, quant_training="int8")
SLICES = [0, 0, 1, 1]
# (case, mesh, fields, slices)
CASES = [
    ("data4", dict(data=4), dict(sharding_stage=0, gradient_accumulation_steps=2), None),
    ("slices", dict(data=2, fsdp=2, dcn_data=2),
     dict(sharding_stage=3, gradient_accumulation_steps=2, comm_quant_weights=True,
          comm_quant_grads=True, comm_quant_block_size=64), SLICES),
    ("pipe", dict(pipe=2, fsdp=2), dict(sharding_stage=3, gradient_accumulation_steps=4,
                                        pipeline_schedule="auto"), None),
]


def _micro(mesh: dict) -> int:
    return ROWS // (mesh.get("data", 1) * mesh.get("fsdp", 1))


def _batches(accum: int) -> np.ndarray:
    """One batch each step, as JAX's int8 tests: the loss must fall."""
    one = np.random.default_rng(0).integers(0, 512, (accum, ROWS, SEQ)).astype(np.int32)
    return np.stack([one] * STEPS)


def _jax_losses(mesh: dict, extra: dict, slices, flat: dict) -> tuple[np.ndarray, str]:
    cfg = TPUTrainConfig(micro_batch_size=_micro(mesh), mesh=MeshConfig(**mesh),
                         **{**_KW, **extra})
    prog = jtrain.build_train_program(cfg, runtime=MeshRuntime(
        cfg.mesh, devices=jax.devices()[:WORLD], slice_assignments=slices))
    state = prog.init(jax.random.PRNGKey(0))
    tree = {}
    for k, v in flat.items():
        node = tree
        *path, leaf = k.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    state["params"] = jax.device_put(jax.tree.map(jnp.asarray, tree),
                                     jax.tree.map(lambda a: a.sharding, state["params"]))
    losses = []
    for b in _batches(extra["gradient_accumulation_steps"]):
        state, m = prog.step(state, jax.device_put(jnp.asarray(b), prog.batch_sharding))
        losses.append(float(m["loss"]))
    return np.array(losses), prog.pipeline_schedule


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_int8")
    flat = _init("gpt-tiny")
    np.savez(tmp / "init.npz", **flat)
    x = (np.random.default_rng(4).standard_normal((ROWS, 8, 16)) * 3).astype(np.float32)
    x[2, 5, 3] = 40.0  # one rank's rows hold a channel's maximum
    np.savez(tmp / "x.npz", x=x)
    cases = [dict(name="scales", kind="int8_scales", mesh=dict(data=2, fsdp=2),
                  inputs=str(tmp / "x.npz"))]
    for name, mesh, extra, slices in CASES:
        accum = extra["gradient_accumulation_steps"]
        np.save(tmp / f"batches{accum}.npy", _batches(accum))
        cases.append(dict(name=name, kind="train", mesh=mesh, slices=slices,
                          init=str(tmp / "init.npz"), batches=str(tmp / f"batches{accum}.npy"),
                          cfg={**_KW, "micro_batch_size": _micro(mesh), **extra}))

    def references():
        return {name: _jax_losses(mesh, extra, slices, flat)
                for name, mesh, extra, slices in CASES}

    got, refs = spawn({"cases": cases}, WORLD, tmp, timeout=150, during=references)
    return got, refs, x


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_int8_losses_match_jax_on_the_mesh(runs, name):
    """Every rank's losses: the first within 1e-6 relative of JAX's int8
    program on the same mesh, each later one within 0.01, falling; the
    int8 products ran on every rank; on ``pipe`` both resolve "auto" to
    gpipe."""
    got, refs, _ = runs
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
    got, _, x = runs
    _, want = jqt.channel_quantize(jnp.asarray(x), (0, 1))
    for r in range(WORLD):
        out = got[("scales", r)]
        np.testing.assert_array_equal(out["scales"], np.asarray(want))
        rows = x[r:r + 1]  # rank r is (data r // 2, fsdp r % 2): zero.local_rows' row r
        codes, scales = jqt.channel_quantize(jnp.asarray(rows), (2,))
        np.testing.assert_array_equal(out["codes"], np.asarray(codes))
        np.testing.assert_array_equal(out["row_scales"], np.asarray(scales))


def test_int8_with_a_model_axis_is_refused_with_its_cause():
    """On a mesh with ``model > 1`` the row-parallel products contract over
    a split dim, whose scales the port does not reduce yet: it refuses,
    naming that, where JAX's GSPMD program runs."""
    sizes = dict(data=1, fsdp=1, pipe=1, sequence=1, model=2)
    rt = types.SimpleNamespace(device=torch.device("cpu"), axis_sizes=sizes, n_devices=2)
    cfg = ttrain.TrainConfig(mesh=tmr.MeshConfig(model=2), model_name="gpt-tiny", seq_len=32,
                             quant_training="int8")
    with pytest.raises(NotImplementedError, match="model axis splits"):
        ttrain.build_train_program(cfg, device="cpu", runtime=rt)
