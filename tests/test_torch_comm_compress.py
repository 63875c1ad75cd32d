"""Port parity: the ZeRO++ compressed collectives
(``tpu_engine_torch/comm_compress.py``), ``comm.compression_plan``, the
mesh of slices (``dcn_data > 1`` with ``slice_assignments``) and
``grad_allreduce_dtype="bf16"``, against ``tpu_engine/comm_compress.py``
and JAX's program.

One module-scoped spawn of four ``gloo`` ranks (``tests/torch_mesh_worker.py``)
runs gpt-tiny at stage 3 on ``data=2, fsdp=2, dcn_data=2`` with slices
``[0, 0, 1, 1]``, fp32, block 64: uncompressed, qwZ+hpZ, qwZ+hpZ+qgZ, and
bf16 compute with a bf16 gradient reduction. JAX's program runs on four of
the root conftest's CPU devices with the same slices. The port's collective
counters stand in for JAX's HLO byte accounting."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_engine import comm as jcomm  # noqa: E402
from tpu_engine import comm_compress as jcc  # noqa: E402
from tpu_engine import train as jtrain  # noqa: E402
from tpu_engine.mesh_runtime import MeshConfig, MeshRuntime  # noqa: E402
from tpu_engine.sharding import (OffloadDevice, Precision, ShardingStage,  # noqa: E402
                                 TPUTrainConfig)
from tpu_engine_torch import comm as tcomm  # noqa: E402
from tpu_engine_torch import comm_compress as tcc  # noqa: E402
from tpu_engine_torch import mesh_runtime as tmr  # noqa: E402
from tpu_engine_torch import train as ttrain  # noqa: E402
from tpu_engine_torch.models import convert  # noqa: E402
from torch_mesh_worker import spawn  # noqa: E402

WORLD = 4
STEPS = 4
ROWS, SEQ, ACCUM = 4, 32, 2
BLOCK = 64
MESH = dict(data=2, fsdp=2, dcn_data=2)
SLICES = [0, 0, 1, 1]
_KW = dict(gradient_accumulation_steps=ACCUM, seq_len=SEQ, precision="fp32", param_dtype="fp32",
           attention_impl="xla", learning_rate=1e-2, min_lr=1e-3, warmup_steps=2, total_steps=100,
           comm_quant_block_size=BLOCK, sharding_stage=3)
CASES = {
    "fp32": {},
    "qwz_hpz": dict(comm_quant_weights=True, comm_secondary_weights=True),
    "all": dict(comm_quant_weights=True, comm_secondary_weights=True, comm_quant_grads=True),
    "bf16": dict(precision="bf16", grad_allreduce_dtype="bf16"),
}


# ---------------------------------------------------------------------------
# Quantization numerics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("block", [16, 64, 256])
def test_blockwise_quantize_matches_jax(block):
    """Round to nearest: the codes bitwise JAX's, the scales within 1e-6,
    and each element back within half its own block's step."""
    x = (np.random.default_rng(block).standard_normal((4, 3 * block + 7)) * 5.0).astype(np.float32)
    jc, js = jcc.blockwise_quantize(jnp.asarray(x), block)
    tc, ts = tcc.blockwise_quantize(torch.tensor(x), block)
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    y = tcc.blockwise_dequantize(tc, ts, block, last=x.shape[-1]).numpy()
    bound = np.repeat(ts.numpy(), block, axis=-1)[:, :x.shape[-1]]
    assert np.all(np.abs(y - x) <= bound / 2 + 1e-6)
    np.testing.assert_array_equal(
        y, np.asarray(jcc.blockwise_dequantize(jc, js, block, last=x.shape[-1])))


def test_dequantize_gathered_matches_jax():
    """Shards gathered along their last axis keep their own padded block
    grids: the port's re-merge equals JAX's."""
    rng = np.random.default_rng(3)
    shards = [rng.standard_normal((3, 40)).astype(np.float32) for _ in range(2)]
    codes, scales = zip(*(tcc.blockwise_quantize(torch.tensor(s), 16) for s in shards))
    got = tcc._dequantize_gathered(torch.cat(codes, -1), torch.cat(scales, -1), gather_dim=1,
                                   block=16, shard_last=40, global_last=80, dtype=torch.float32)
    jcodes, jscales = zip(*(jcc.blockwise_quantize(jnp.asarray(s), 16) for s in shards))
    want = jcc._dequantize_gathered(jnp.concatenate(jcodes, -1), jnp.concatenate(jscales, -1),
                                    gather_dim=1, block=16, shard_last=40, global_last=80,
                                    dtype=jnp.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_stochastic_rounding_unbiased():
    """JAX's statistics: the mean of 300 stochastic roundings of 0.3 is
    within a fifth of a quantization step of 0.3 (the port's rounding is a
    counter hash salted by an explicit salt here, by the data in the step)."""
    x = torch.full((1, 64), 0.3)
    deqs = [tcc.blockwise_dequantize(*tcc.blockwise_quantize(x, 64, salt=i), 64, last=64)
            for i in range(300)]
    mean = float(torch.stack(deqs).mean())
    step = 0.3 / 127
    assert abs(mean - 0.3) < step / 5, (mean, step)
    codes, _ = tcc.blockwise_quantize(x, 64, stochastic=True)
    assert set(codes.unique().tolist()) <= {127}  # 0.3 is the block's absmax: on the grid


def test_groups_and_volume_factors_equal_jax():
    for data, dcn in ((4, 2), (4, 4), (2, 2), (8, 2)):
        assert tcc.data_slice_groups(data, dcn) == jcc.data_slice_groups(data, dcn)
    with pytest.raises(ValueError, match="divisible"):
        tcc.data_slice_groups(4, 3)
    for shape, dcn in (({"data": 2, "fsdp": 2}, 2), ({"data": 4, "fsdp": 2}, 2),
                       ({"data": 4, "fsdp": 1, "model": 2}, 4)):
        assert tcc.slice_of_partition(shape, dcn) == jcc.slice_of_partition(shape, dcn)
    for block in (8, 64, 256):
        assert tcc.expected_volume_factors(block) == jcc.expected_volume_factors(block)


def _jax_cfg(**kw) -> TPUTrainConfig:
    base = dict(model_name="gpt-tiny", sharding_stage=ShardingStage.FULL_PARTITIONING,
                mesh=MeshConfig(data=4, fsdp=2, dcn_data=2), micro_batch_size=2,
                gradient_accumulation_steps=2, seq_len=32, precision=Precision.FP32,
                param_dtype=Precision.FP32, comm_quant_block_size=64)
    base.update(kw)
    return TPUTrainConfig(**base)


def _port_cfg(**kw) -> ttrain.TrainConfig:
    base = dict(model_name="gpt-tiny", sharding_stage=3,
                mesh=tmr.MeshConfig(data=4, fsdp=2, dcn_data=2), micro_batch_size=2,
                gradient_accumulation_steps=2, seq_len=32, precision="fp32", param_dtype="fp32",
                comm_quant_block_size=64)
    base.update(kw)
    return ttrain.TrainConfig(**base)


@pytest.mark.parametrize("kw", [
    {}, dict(comm_quant_weights=True, comm_quant_grads=True, comm_quant_block_size=256),
    dict(comm_quant_weights=True, comm_secondary_weights=True), dict(comm_quant_grads=True),
])
def test_compression_plan_equals_jax(kw):
    assert tcomm.compression_plan(_port_cfg(**kw)) == jcomm.compression_plan(_jax_cfg(**kw))


def _jax_error(fn) -> str:
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def _port_kw(kw: dict) -> dict:
    out = {}
    for k, v in kw.items():
        if isinstance(v, MeshConfig):
            v = tmr.MeshConfig(**{a: getattr(v, a) for a in ("data", "fsdp", "pipe", "sequence",
                                                            "model", "dcn_data")})
        out[k] = getattr(v, "value", v) if not isinstance(v, ShardingStage) else int(v)
    return out


@pytest.mark.parametrize("kw", [
    dict(comm_secondary_weights=True),
    dict(comm_quant_weights=True, sharding_stage=ShardingStage.GRADIENT_PARTITIONING),
    dict(comm_quant_grads=True, pipeline_schedule="1f1b"),
    dict(comm_quant_weights=True, grad_allreduce_dtype=Precision.BF16),
    dict(comm_quant_weights=True, lora_rank=4),
    dict(comm_quant_weights=True, param_offload=OffloadDevice.HOST),
    dict(comm_quant_weights=True, mesh=MeshConfig(data=2, fsdp=2, model=2)),
    dict(comm_quant_weights=True, attention_impl="flash"),
], ids=["hpz_alone", "stage2", "1f1b", "bf16", "lora", "param_offload", "model", "flash"])
def test_config_rejections_raise_jax_messages(kw):
    """Every rejection of tests/test_comm_compress.py::test_config_rejections
    raises JAX's message in the port's config."""
    base = dict(model_name="gpt-tiny", sharding_stage=ShardingStage.FULL_PARTITIONING,
                mesh=MeshConfig(data=2, fsdp=4), seq_len=32)
    want = _jax_error(lambda: TPUTrainConfig(**{**base, **kw}))
    with pytest.raises(ValueError) as info:
        ttrain.TrainConfig(**_port_kw({**base, **kw}))
    assert str(info.value) in want, (str(info.value), want)


def test_disk_and_moe_rejections_raise_jax_messages(tmp_path):
    disk = dict(comm_quant_weights=True, optimizer_offload=OffloadDevice.DISK,
                optimizer_spill_dir=str(tmp_path))
    want = _jax_error(lambda: _jax_cfg(**disk))
    with pytest.raises(ValueError) as info:
        _port_cfg(**_port_kw(disk))
    assert "disk" in str(info.value) and str(info.value) in want
    moe = dict(model_name="moe-tiny", sharding_stage=ShardingStage.FULL_PARTITIONING,
               seq_len=32, comm_quant_weights=True)
    want = _jax_error(lambda: jtrain.build_train_program(
        TPUTrainConfig(mesh=MeshConfig(data=2, fsdp=4), **moe)))
    with pytest.raises(ValueError) as info:
        ttrain.build_train_program(ttrain.TrainConfig(**_port_kw(moe)), device="cpu")
    assert "MoE" in str(info.value) and str(info.value) == want
    # The block size's bound (JAX's Field(ge=8)).
    with pytest.raises(ValueError, match="comm_quant_block_size"):
        _port_cfg(comm_quant_block_size=4)


def test_slice_assignment_refusals_raise_jax_messages():
    """``rank_array`` holds JAX's ``build_mesh`` checks (the port lays out
    ranks, JAX devices): slices given with ``dcn_data=1``, none given with
    ``dcn_data=2``, unequal slices, a wrong count."""
    from tpu_engine.mesh_runtime import build_mesh as jbuild

    devs = jax.devices()[:4]
    for mesh, slices in ((dict(data=4), [0, 0, 1, 1]), (dict(data=4, dcn_data=2), None),
                         (dict(data=4, dcn_data=2), [0, 0, 0, 1]),
                         (dict(data=4, dcn_data=2), [0, 1, 2, 2]),
                         (dict(data=4, dcn_data=2), [0, 1])):
        want = _jax_error(lambda: jbuild(MeshConfig(**mesh), devs, slices))
        with pytest.raises(ValueError) as info:
            tmr.rank_array(tmr.MeshConfig(**mesh), 4, slices)
        assert str(info.value) == want
    got = tmr.rank_array(tmr.MeshConfig(data=4, dcn_data=2), 4, [1, 0, 1, 0])
    assert got.reshape(-1).tolist() == [1, 3, 0, 2]  # slice 0's ranks first, as JAX's devices


# ---------------------------------------------------------------------------
# Four gloo ranks against JAX's program on four CPU devices
# ---------------------------------------------------------------------------


def _batches() -> np.ndarray:
    """One batch each step, as JAX's test: the loss must fall."""
    rng = np.random.default_rng(0)
    one = rng.integers(0, 512, (ACCUM, ROWS, SEQ)).astype(np.int32)
    return np.stack([one] * STEPS)


def _jax_program(**extra):
    cfg = TPUTrainConfig(model_name="gpt-tiny", micro_batch_size=ROWS // 4,
                         mesh=MeshConfig(**MESH), **{**_KW, **extra})
    prog = jtrain.build_train_program(cfg, runtime=MeshRuntime(
        cfg.mesh, devices=jax.devices()[:WORLD], slice_assignments=SLICES))
    return prog, prog.init(jax.random.PRNGKey(0))


def _jax_losses(prog, state, batches: np.ndarray) -> tuple[np.ndarray, float]:
    """The losses of ``batches`` and the held-out loss of the first after
    them (the workers' order)."""
    losses = []
    for b in batches:
        state, m = prog.step(state, jax.device_put(jnp.asarray(b), prog.batch_sharding))
        losses.append(float(m["loss"]))
    held = prog.eval_step(state, jax.device_put(jnp.asarray(batches[0]), prog.batch_sharding))
    return np.array(losses), float(held)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on the four ranks from the initial weights of JAX's
    qwZ+hpZ program (whose hpZ store is of those weights), and JAX's
    losses of the qwZ+hpZ and bf16 programs, run meanwhile."""
    tmp = tmp_path_factory.mktemp("comm")
    progs = {name: _jax_program(**CASES[name]) for name in ("qwz_hpz", "bf16")}
    flat = convert._flatten(jax.tree.map(np.asarray, progs["qwz_hpz"][1]["params"]))
    bf16 = convert._flatten(jax.tree.map(np.asarray, progs["bf16"][1]["params"]))
    assert all(np.array_equal(bf16[k], v) for k, v in flat.items())
    np.savez(tmp / "init.npz", **flat)
    np.save(tmp / "batches.npy", _batches())
    cases = [dict(name=name, kind="train", mesh=MESH, slices=SLICES,
                  cfg=dict(model_name="gpt-tiny", micro_batch_size=ROWS // 4, **{**_KW, **kw}),
                  init=str(tmp / "init.npz"), batches=str(tmp / "batches.npy"))
             for name, kw in CASES.items()]

    def meanwhile():
        return {name: _jax_losses(prog, state, _batches()) for name, (prog, state) in progs.items()}

    return spawn(dict(cases=cases), WORLD, tmp, timeout=150, during=meanwhile)


def test_qwz_hpz_losses_equal_jax(runs):
    """qwZ+hpZ: the losses of four steps within 1e-5 relative of JAX's
    compressed program on the same slices, on every rank, and the held-out
    loss after them (full width in both)."""
    out, ref = runs
    for r in range(WORLD):
        got = out[("qwz_hpz", r)]["losses"]
        np.testing.assert_allclose(got, ref["qwz_hpz"][0], rtol=1e-5)
        # The held-out loss runs on the full-width weights, as JAX's.
        np.testing.assert_allclose(float(out[("qwz_hpz", r)]["eval"]), ref["qwz_hpz"][1],
                                   rtol=1e-5)
    base = out[("fp32", 0)]["losses"]
    assert not np.array_equal(base, out[("qwz_hpz", 0)]["losses"])  # the gathers did quantize


def test_hpz_store_is_the_quantized_shard(runs):
    """After the last step each rank's hpZ codes are JAX's
    ``blockwise_quantize`` of its own updated shard; only kernel and
    embedding leaves are in the store."""
    out, _ = runs
    for r in range(WORLD):
        got = out[("qwz_hpz", r)]
        keys = [k.split(":", 1)[1] for k in got if k.startswith("hpz_codes:")]
        assert keys and all(k.rsplit(".", 1)[-1] in ("kernel", "embedding") for k in keys)
        assert "final_norm.scale" not in keys
        for k in keys:
            jc, js = jcc.blockwise_quantize(jnp.asarray(got[f"shard:{k}"]), BLOCK)
            assert got[f"hpz_codes:{k}"].dtype == np.int8
            np.testing.assert_array_equal(got[f"hpz_codes:{k}"], np.asarray(jc))
            np.testing.assert_allclose(got[f"hpz_scales:{k}"], np.asarray(js), rtol=1e-6)


def test_qgz_losses_track_fp32(runs):
    """qwZ+hpZ+qgZ (stochastic rounding across the slices) within JAX's own
    0.05 of the uncompressed run at every step, and both train."""
    out, _ = runs
    base, comp = out[("fp32", 0)]["losses"], out[("all", 0)]["losses"]
    assert base[-1] < base[0] and comp[-1] < comp[0]
    assert np.all(np.abs(base - comp) < 0.05), (base, comp)
    for r in range(1, WORLD):  # every rank reports the same loss
        np.testing.assert_array_equal(out[("all", r)]["losses"], comp)


def _stats(out, name, rank=0) -> dict:
    return json.loads(str(out[(name, rank)]["stats"]))


def test_int8_on_the_wire_and_cross_slice_reduction(runs):
    """The counters of the last step (what JAX's HLO test reads): the qwZ
    gathers over ``fsdp`` move int8 (none of the fp32 run's do), the
    cross-slice bytes fall at least 3× with qgZ, and the total falls too."""
    out, _ = runs
    for r in range(WORLD):
        base, comp = _stats(out, "fp32", r), _stats(out, "all", r)
        int8 = [c for c in comp["collectives"] if c["op"] == "all-gather" and c["dtype"] == "int8"]
        assert any(not c["cross_slice"] for c in int8)  # the fsdp gathers
        assert any(c["cross_slice"] for c in int8)      # qgZ's codes across the slices
        assert not any(c["dtype"] == "int8" for c in base["collectives"])
        assert base["cross_slice_bytes"] > 0
        assert base["cross_slice_bytes"] / max(comp["cross_slice_bytes"], 1) >= 3.0, (base, comp)
        assert comp["total_wire_bytes"] < base["total_wire_bytes"]
        qwz = _stats(out, "qwz_hpz", r)
        assert qwz["cross_slice_bytes"] == base["cross_slice_bytes"]  # fp32 across without qgZ


def test_bf16_grad_reduction_matches_jax(runs):
    """``grad_allreduce_dtype="bf16"``: the gradient collectives move bf16,
    and the losses are within the bf16 bound of JAX's program (rtol 3e-2,
    ROADMAP's Tolerances)."""
    out, ref = runs
    stats = _stats(out, "bf16")
    grads = [c for c in stats["collectives"] if c["op"] in ("reduce-scatter", "all-reduce")
             and c["payload_bytes"] > 64]
    assert grads and all(c["dtype"] == "bfloat16" for c in grads), grads
    np.testing.assert_allclose(out[("bf16", 0)]["losses"], ref["bf16"][0], rtol=3e-2)
