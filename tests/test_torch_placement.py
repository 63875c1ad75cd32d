"""The port's placement planner (``tpu_engine_torch/placement.py``) against
JAX's (``tpu_engine/placement.py``).

Both planners get JAX's nominal constants (peak, intra- and cross-node
rates) and each package's own HBM estimator (held equal by
``tests/test_torch_device_plane.py``). Over catalog models × gangs of 1, 2,
4 and 8, with and without the quant and comm-compression variants, and
against a fabricated fleet whose headroom rejects some layouts, they must
rank equal plans: equal labels, meshes, stages, schedules and batch
splits, predicted seconds within 1e-9 relative, equal infeasible and
pruned layouts. ``plan_serving_pool`` is compared with the port's
constants patched to JAX's. One case holds the port's defaults to the
H100 SXM5 data-sheet figures.
"""

from types import SimpleNamespace

import pytest

pytest.importorskip("torch").set_num_threads(1)

from tpu_engine import placement as jplace  # noqa: E402
from tpu_engine.mesh_runtime import MeshConfig as JMesh  # noqa: E402
from tpu_engine.sharding import TPUTrainConfig  # noqa: E402
from tpu_engine_torch import placement as tplace  # noqa: E402
from tpu_engine_torch.mesh_runtime import MeshConfig as TMesh  # noqa: E402
from tpu_engine_torch.train import TrainConfig  # noqa: E402

JAX_CONSTANTS = dict(peak_flops=jplace.NOMINAL_PEAK_FLOPS, ici_bytes_s=jplace.NOMINAL_ICI_BYTES_S,
                     dcn_bytes_s=jplace.NOMINAL_DCN_BYTES_S)

MODELS = {
    "llama-1b": dict(micro_batch_size=4, gradient_accumulation_steps=2, seq_len=2048),
    "llama-7b": dict(micro_batch_size=2, gradient_accumulation_steps=4, seq_len=4096,
                     optimizer_offload="host"),
    "gpt-125m": dict(micro_batch_size=8, gradient_accumulation_steps=1, seq_len=1024,
                     activation_checkpointing=False),
    "moe-8x7b": dict(micro_batch_size=1, gradient_accumulation_steps=8, seq_len=4096,
                     loss_chunk_size=1024),
}


def _configs(model, mesh, **extra):
    kw = {**MODELS[model], **extra}
    return (TPUTrainConfig(model_name=model, mesh=JMesh(**mesh), **kw),
            TrainConfig(model_name=model, mesh=TMesh(**mesh), **kw))


def _fleet(n, free_gb):
    return [SimpleNamespace(index=i, hbm_total_gb=80.0, hbm_free_gb=free_gb - i % 2)
            for i in range(n)]


def _rows(plans):
    return [(p.label, p.mesh, p.gang, p.sharding_stage, p.pipeline_schedule, p.micro_batch_size,
             p.gradient_accumulation_steps, p.quant_training, p.comm_compress, p.feasible,
             p.skip_reason) for p in plans]


def _assert_same(want, got):
    assert _rows(got.plans) == _rows(want.plans)
    assert _rows(got.infeasible) == _rows(want.infeasible)
    assert got.evaluated == want.evaluated
    assert [r["layout"] for r in got.pruned] == [r["layout"] for r in want.pruned]
    for a, b in zip(want.plans + want.infeasible, got.plans + got.infeasible):
        for f in ("predicted_step_time_s", "predicted_compute_s", "predicted_comm_s",
                  "predicted_exposed_comm_s", "predicted_bubble_fraction"):
            assert getattr(b, f) == pytest.approx(getattr(a, f), rel=1e-9, abs=1e-15), f
        assert (b.hbm_estimate is None) == (a.hbm_estimate is None)
        if a.hbm_estimate is not None:
            assert b.hbm_estimate.device_total_gib == pytest.approx(
                a.hbm_estimate.device_total_gib, rel=1e-9)
    want_t, got_t = want.table(top_k=5), got.table(top_k=5)
    assert [r["layout"] for r in got_t] == [r["layout"] for r in want_t]


@pytest.mark.parametrize("variants", [False, True], ids=["plain", "quant+comm"])
@pytest.mark.parametrize("gang", [1, 2, 4, 8])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_plan_ranks_equal(model, gang, variants):
    jcfg, tcfg = _configs(model, {"data": -1})
    kw = dict(consider_quant=variants, consider_comm_compress=variants)
    jp = jplace.PlacementPlanner(**JAX_CONSTANTS, **kw)
    tp = tplace.PlacementPlanner(**JAX_CONSTANTS, **kw)
    free = 30.0 if model in ("llama-7b", "moe-8x7b") else 60.0
    want = jp.plan(jcfg, devices=_fleet(gang, free), reserved={0: 2.0}, gang=gang)
    got = tp.plan(tcfg, devices=_fleet(gang, free), reserved={0: 2.0}, gang=gang)
    _assert_same(want, got)
    assert got.plans or got.infeasible or got.pruned


@pytest.mark.parametrize("model", ["llama-1b", "gpt-125m"])
def test_best_available_search_and_counters(model):
    """No gang pinned: every size up to the fleet, ranked per sample; the
    counters and the chosen plan's bookkeeping agree."""
    jcfg, tcfg = _configs(model, {"data": -1})
    jp = jplace.PlacementPlanner(**JAX_CONSTANTS)
    tp = tplace.PlacementPlanner(**JAX_CONSTANTS)
    want, got = jp.plan(jcfg, n_avail=6), tp.plan(tcfg, n_avail=6)
    _assert_same(want, got)
    jp.note_chosen(want.best)
    tp.note_chosen(got.best)
    for p in (jp, tp):
        p.record_observation(1.0, 1.25)
    js, ts = jp.stats(), tp.stats()
    for k in ("plans_evaluated_total", "plans_pruned_total", "plans_hbm_rejected_total",
              "plans_chosen_total", "last_feasible", "prune_reasons", "observations_total",
              "step_time_abs_rel_error"):
        assert ts[k] == js[k], k
    assert ts["last_chosen_predicted_s"] == pytest.approx(js["last_chosen_predicted_s"], rel=1e-9)


def test_resume_topology_and_grow_target():
    """A saved topology prices the remap and refuses a pipe change; the
    grow target of a shrunk elastic job is the same gang."""
    jcfg, tcfg = _configs("llama-1b", {"data": -1}, elastic_min_devices=2,
                          elastic_max_devices=8)
    jp = jplace.PlacementPlanner(**JAX_CONSTANTS)
    tp = tplace.PlacementPlanner(**JAX_CONSTANTS)
    saved = {"data": 1, "fsdp": 4, "pipe": 1, "sequence": 1, "model": 1}
    _assert_same(jp.plan(jcfg, n_avail=4, gang=4, saved_topology=saved),
                 tp.plan(tcfg, n_avail=4, gang=4, saved_topology=saved))
    for n, free in ((8, 60.0), (6, 60.0), (8, 3.0)):
        assert tp.grow_target(tcfg, _fleet(n, free), {}, 2) == jp.grow_target(
            jcfg, _fleet(n, free), {}, 2)
    one_j, one_t = _configs("llama-1b", {"data": 2, "fsdp": 2})
    a, b = jp.predict(one_j), tp.predict(one_t)
    assert b.gang == a.gang == 4 and b.label == a.label
    assert b.predicted_step_time_s == pytest.approx(a.predicted_step_time_s, rel=1e-9)
    assert tp._candidate_gangs(40) == jp._candidate_gangs(40)
    with pytest.raises(ValueError, match="no_estimate:nope"):
        tp.predict(TrainConfig(model_name="nope"))
    assert tp.plan(TrainConfig(model_name="nope")).skip_reason == "no_estimate:nope"


@pytest.mark.parametrize("role", ["prefill", "decode", "draft"])
@pytest.mark.parametrize("n_devices", [1, 4])
def test_serving_pool_with_jax_constants(role, n_devices, monkeypatch):
    for name in ("NOMINAL_PEAK_FLOPS", "NOMINAL_HBM_BYTES_S"):
        monkeypatch.setattr(tplace, name, getattr(jplace, name))
    kw = dict(hbm_free_gib=16.0, max_len=2048, kv_quant=role == "decode")
    want = jplace.plan_serving_pool("llama-7b", role, n_devices, **kw)
    got = tplace.plan_serving_pool("llama-7b", role, n_devices, **kw)
    assert [p.label for p in got] == [p.label for p in want] and got
    for a, b in zip(want, got):
        assert (b.feasible, b.skip_reason, b.replicas) == (a.feasible, a.skip_reason, a.replicas)
        for f in ("predicted_prefill_s", "predicted_decode_tok_s", "predicted_propose_s"):
            assert getattr(b, f) == pytest.approx(getattr(a, f), rel=1e-9)
    assert tplace.plan_serving_pool("nope", role, n_devices) == []


def test_port_defaults_are_h100_figures():
    """NVIDIA's data sheet of the H100 SXM5 80GB: 989 TFLOP/s dense bf16,
    NVLink 4 at 900 GB/s both ways (450 GB/s one way), a 400 Gb/s NIC a
    GPU across nodes, 3.35 TB/s of HBM3. The roofline derate is JAX's."""
    assert tplace.NOMINAL_PEAK_FLOPS == 989e12
    assert tplace.NOMINAL_ICI_BYTES_S == 4.5e11
    assert tplace.NOMINAL_DCN_BYTES_S == 400e9 / 8
    assert tplace.NOMINAL_HBM_BYTES_S == 3.35e12
    assert tplace.ASSUMED_MFU == jplace.ASSUMED_MFU
    p = tplace.PlacementPlanner()
    assert (p.ici_bytes_s, p.dcn_bytes_s) == (4.5e11, 5e10)
    assert p.peak_flops in (989e12, tplace.NOMINAL_PEAK_FLOPS)
