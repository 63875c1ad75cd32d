"""Port parity: the device-facing modules — ``hbm_estimate``, ``profiler``,
``telemetry`` and ``tpu_manager`` — against their JAX copies, through the
same scripted calls (no JAX compute): the arithmetic and the parsers are
JAX's, so their results are held equal, not close. What reads the card
(``nvidia-smi``, ``torch.cuda``) is held on recorded text and on the CPU
device alone; this machine has no card."""

import json
import threading
import types

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tpu_engine import hbm_estimate as jhbm  # noqa: E402
from tpu_engine import profiler as jprof  # noqa: E402
from tpu_engine import telemetry as jtel  # noqa: E402
from tpu_engine import tpu_manager as jmgr  # noqa: E402
from tpu_engine.mesh_runtime import MeshConfig  # noqa: E402
from tpu_engine.sharding import TPUTrainConfig  # noqa: E402
from tpu_engine_torch import hbm_estimate as thbm  # noqa: E402
from tpu_engine_torch import profiler as tprof  # noqa: E402
from tpu_engine_torch import telemetry as ttel  # noqa: E402
from tpu_engine_torch import tpu_manager as tmgr  # noqa: E402
from tpu_engine_torch.mesh_runtime import MeshConfig as TMeshConfig  # noqa: E402
from tpu_engine_torch.models.config import MODEL_CONFIGS  # noqa: E402
from tpu_engine_torch.train import TrainConfig  # noqa: E402

# (mesh, fields): meshes, stages, placements, optimizers, LoRA, pipelines.
JOB_CASES = [
    (dict(data=1), dict(sharding_stage=0)),
    (dict(data=2, fsdp=4), dict(sharding_stage=3)),
    (dict(data=2, fsdp=2), dict(sharding_stage=2, optimizer_offload="host")),
    (dict(fsdp=4, model=2), dict(sharding_stage=1, param_offload="host",
                                 activation_checkpointing=False)),
    (dict(data=1, sequence=2, model=2), dict(loss_chunk_size=256, precision="fp32")),
    (dict(data=-1, fsdp=2), dict(optimizer="lion", moment_dtype="bf16")),
    (dict(data=1), dict(optimizer="adafactor", param_dtype="bf16")),
    (dict(data=2), dict(lora_rank=8, lora_targets=("q", "v", "o"))),
    (dict(pipe=2, fsdp=2), dict(pipeline_schedule="gpipe", gradient_accumulation_steps=4)),
    (dict(pipe=4), dict(pipeline_schedule="zb", gradient_accumulation_steps=8)),
    (dict(pipe=2, data=2), dict(pipeline_schedule="1f1b", gradient_accumulation_steps=4,
                                micro_batch_size=2)),
]


def _configs(model: str, mesh: dict, fields: dict):
    kw = dict(dict(model_name=model, seq_len=1024, micro_batch_size=4), **fields)
    return (TPUTrainConfig(mesh=MeshConfig(**mesh), **kw),
            TrainConfig(mesh=TMeshConfig(**mesh), **kw))


@pytest.mark.parametrize("case", range(len(JOB_CASES)))
def test_estimate_job_hbm_matches_jax_for_every_model(case):
    mesh, fields = JOB_CASES[case]
    for model in MODEL_CONFIGS:
        jc, tc = _configs(model, mesh, fields)
        for available in (None, 8, 16):
            want = jhbm.estimate_job_hbm(jc, available)
            got = thbm.estimate_job_hbm(tc, available)
            assert got.model_dump() == want.model_dump(), (model, available)
            assert thbm.gang_size(tc, available) == jhbm.gang_size(jc, available)
    assert thbm.estimate_job_hbm(TrainConfig(model_name="no-such-model")) is None


@pytest.mark.parametrize("kw", [
    dict(model_name="llama-1b", max_slots=8, max_len=2048),
    dict(model_name="llama-7b", max_slots=16, max_len=4096, tensor_parallel=2, kv_quant=True),
    dict(model_name="mistral-7b", max_slots=4, max_len=8192, weight_quant="int8",
         prefix_cache_tokens=4096),
    dict(model_name="llama-70b", max_slots=32, max_len=2048, tensor_parallel=8,
         pool_role="prefill", inflight_handoffs=4),
    dict(model_name="qwen3-4b", max_slots=8, max_len=1024, host_prefix_tokens=10_000,
         host_budget_gib=64.0),
    dict(model_name="llama-7b", max_slots=8, max_len=2048, draft_model_name="llama-1b"),
    dict(model_name="gemma-2b", max_slots=4, max_len=512, pool_role="draft"),
])
def test_estimate_serving_hbm_matches_jax(kw):
    want = jhbm.estimate_serving_hbm(**kw)
    assert thbm.estimate_serving_hbm(**kw).model_dump() == want.model_dump()


def test_serving_refusals_match_jax():
    for mod in (jhbm, thbm):
        with pytest.raises(mod.HostBudgetExceeded) as e:
            mod.estimate_serving_hbm("llama-7b", 8, 2048, host_prefix_tokens=10**7,
                                     host_budget_gib=1.0)
        with pytest.raises(mod.SpecHBMOversubscribed) as f:
            mod.estimate_serving_hbm("llama-7b", 8, 2048, draft_model_name="llama-1b",
                                     device_budget_gib=4.0)
        if mod is jhbm:
            want = (e.value.reason, f.value.reason)
    assert (e.value.reason, f.value.reason) == want
    assert thbm.estimate_serving_hbm("no-such-model", 1, 64) is None


@pytest.mark.parametrize("n_eligible", [1, 3, 4, 6, 8, 16])
def test_elastic_shrink_plan_matches_jax(n_eligible):
    for mesh, bounds in ((dict(data=-1, fsdp=2), dict(elastic_min_devices=2)),
                         (dict(data=4, fsdp=2), dict(elastic_min_devices=2,
                                                     elastic_max_devices=6)),
                         (dict(data=2, model=2), dict(elastic_min_devices=4)),
                         (dict(data=2), dict(elastic_resume=False))):
        jc, tc = _configs("llama-7b", mesh, bounds)
        want = jhbm.elastic_shrink_plan(jc, n_eligible)
        got = thbm.elastic_shrink_plan(tc, n_eligible)
        if want is None:
            assert got is None
            continue
        assert vars(got[0]) == want[0].model_dump()
        assert got[1] == want[1] and got[2].model_dump() == want[2].model_dump()


def test_per_device_bytes_reads_the_rank_state():
    """Device and host bytes of a state tree: a host arena's tensors count
    on the host; on a CPU program every other tensor is the device's."""
    from tpu_engine_torch.offload import HostArena

    dev = {"a": torch.zeros(3, 4), "b": {"c": torch.zeros(5, dtype=torch.bfloat16)}}
    host = HostArena({"h": torch.zeros(7, 2)}, False).tensors
    tree = {**dev, "host": host}
    assert thbm.per_device_bytes(tree, host=False, device="cpu") == 3 * 4 * 4 + 5 * 2
    assert thbm.per_device_bytes(tree, host=True, device="cpu") == 7 * 2 * 4


# -- telemetry ----------------------------------------------------------------

def test_metric_string_parsers_match_jax():
    floats = ["0.00", "20.50", "1: 33.25", "bad", " 7 "]
    scores = ["0-0", "1-3", "2: 7", "junk", "3-10"]
    links = ["tray1.chip3.ici0.int: 0", "tray1.chip3.ici1.int: 6", "x", "a.b: 10", "c: 2"]
    assert ttel.parse_float_list(floats) == jtel.parse_float_list(floats)
    assert ttel.parse_indexed_scores(scores) == jtel.parse_indexed_scores(scores)
    assert ttel.parse_link_scores(links) == jtel.parse_link_scores(links)
    parsed = jtel.parse_link_scores(links)
    assert ttel.ici_link_alerts(parsed) == jtel.ici_link_alerts(parsed)
    for vals, n in (([1.0, 2.0, 3.0, 4.0], 2), ([1.0, 2.0, 3.0], 2), ([], 2), ([5.0], 0)):
        assert ttel._per_chip_from_cores(vals, n) == jtel._per_chip_from_cores(vals, n)


# Recorded ``nvidia-smi --query-gpu=<SMI_FIELDS> --format=csv,noheader,nounits``
# lines: an idle card, one under load at its power cap, one in a hardware
# slowdown, one whose sensors are not reported.
SMI_TEXT = """\
0, NVIDIA H100 80GB HBM3, 0, 1, 81559, 31, 69.55, 700.00, 0x0000000000000001
1, NVIDIA H100 80GB HBM3, 98, 70210, 81559, 62, 688.10, 700.00, 0x0000000000000004
2, NVIDIA H100 80GB HBM3, 97, 40000, 81559, 91, 450.00, 700.00, 0x0000000000000048
3, NVIDIA H100 80GB HBM3, [N/A], 12, 81559, [N/A], [N/A], [N/A], [N/A]
"""


def test_nvidia_smi_source_parses_recorded_text():
    src = ttel.NvidiaSmiSource(runner=lambda: SMI_TEXT)
    snap = src.sample(5)
    assert snap.source == "nvidia_smi" and len(snap.per_chip) == 5 and snap.per_chip[4] == {}
    idle, loaded, slow, blind = snap.per_chip[:4]
    assert idle == {"name": "NVIDIA H100 80GB HBM3", "duty_cycle_pct": 0.0,
                    "hbm_used_gb": round(1 / 1024, 3), "hbm_total_gb": round(81559 / 1024, 3),
                    "temperature_c": 31.0, "power_draw_w": 69.55, "power_limit_w": 700.0,
                    "throttle_score": 0, "throttle_reasons": ["gpu_idle"]}
    assert loaded["throttle_score"] == 0 and loaded["throttle_reasons"] == ["sw_power_cap"]
    assert slow["throttle_score"] == 10
    assert slow["throttle_reasons"] == ["hw_slowdown", "hw_thermal"]
    assert blind == {"name": "NVIDIA H100 80GB HBM3", "hbm_used_gb": round(12 / 1024, 3),
                     "hbm_total_gb": round(81559 / 1024, 3)}
    assert ttel.throttle_score(0x20) == 5
    assert ttel.NvidiaSmiSource(runner=lambda: "").sample(2) is None
    assert ttel.NvidiaSmiSource(runner=lambda: 1 / 0).sample(2) is None
    assert ttel.NvidiaSmiSource(binary="no-such-nvidia-smi").sample(2) is None


def test_derived_duty_and_job_attribution_match_jax():
    jd, td = jtel.DerivedDutySource(), ttel.DerivedDutySource()
    for d in (jd, td):
        d.observe(0.08, 0.1)
        d.observe(0.5, 0.25, device_ids=[1, 2])
        d.observe(0.0, 0.0)
    assert td.sample(4).per_chip == jd.sample(4).per_chip
    assert td.staleness()["scopes"] == jd.staleness()["scopes"] == 2
    for mod in (jtel, ttel):
        mod.register_job_devices("job-x", [0, 3], 0, lambda: "running")
        mod.register_job_devices("job-y", [3], 1, lambda: 1 / 0)
    try:
        assert ttel.job_attribution() == jtel.job_attribution()
    finally:
        for mod in (jtel, ttel):
            mod.unregister_job_devices("job-x")
            mod.unregister_job_devices("job-y")


def test_sample_overlay_merges_first_source_wins():
    jsrc = [jtel.DerivedDutySource(), jtel.DerivedDutySource()]
    tsrc = [ttel.NvidiaSmiSource(runner=lambda: SMI_TEXT), ttel.DerivedDutySource()]
    jsrc[0].observe(0.2, 0.4)
    tsrc[1].observe(0.2, 0.4)
    try:
        jtel.set_sources(jsrc[:1])
        ttel.set_sources(tsrc[1:])
        assert ttel.sample_overlay(2).per_chip == jtel.sample_overlay(2).per_chip
        ttel.set_sources(tsrc)
        over = ttel.sample_overlay(2)
        assert over.sources == ["nvidia_smi"] and over.per_chip[0]["duty_cycle_pct"] == 0.0
        ttel.set_sources([])
        assert ttel.sample_overlay(2) is None
    finally:
        jtel.set_sources(None)
        ttel.set_sources(None)


# -- tpu_manager ----------------------------------------------------------------

def _chips():
    base = dict(device_kind="TPU v5e", hbm_total_gb=16.0, hbm_used_gb=4.0, duty_cycle_pct=50.0,
                temperature_c=50.0, power_draw_w=100.0, power_limit_w=192.0)
    return [dict(base, index=0), dict(base, index=1, temperature_c=82.0),
            dict(base, index=2, temperature_c=91.0), dict(base, index=3, hbm_used_gb=15.5),
            dict(base, index=4, duty_cycle_pct=96.0), dict(base, index=5, power_draw_w=180.0),
            dict(base, index=6, throttle_score=3), dict(base, index=7, throttle_score=8),
            dict(base, index=8, hbm_used_gb=float("nan"), duty_cycle_pct=float("inf")),
            dict(base, index=9, hbm_used_gb=1.0, coords=(1, 2, 0), name="spare"),
            {"index": 10}]


def _dump(devs):
    return [d.model_dump(mode="json") for d in devs]


def test_parse_metrics_matches_jax():
    chips = _chips()
    assert _dump(tmgr.TPUManager().parse_metrics(chips)) == \
        _dump(jmgr.TPUManager().parse_metrics(chips))
    raw = json.dumps({"devices": chips[:8]})
    assert _dump(tmgr.TPUManager().parse_metrics_json(raw)) == \
        _dump(jmgr.TPUManager().parse_metrics_json(raw))


def _fleet(status):
    d = status.model_dump(mode="json")
    for k in ("timestamp", "telemetry_staleness"):
        d.pop(k)
    return d


def test_fleet_selection_and_mock_fleet_match_jax():
    chips = _chips()
    tf = tmgr.TPUManager().get_fleet_status(metrics=chips)
    assert _fleet(tf) == _fleet(jmgr.TPUManager().get_fleet_status(metrics=chips))
    for need in (0.0, 10.0, 15.0):
        want = jmgr.TPUManager().select_best_device(min_free_hbm_gb=need, metrics=chips)
        got = tmgr.TPUManager().select_best_device(min_free_hbm_gb=need, metrics=chips)
        assert (got and got.index) == (want and want.index)
    assert _fleet(tmgr.TPUManager.get_mock_fleet()) == _fleet(jmgr.TPUManager.get_mock_fleet())


def test_live_fleet_on_the_cpu_device_and_without_a_card():
    """A job's CPU device is a device the runtime gives no HBM, as JAX's
    CPU devices are; nvidia-smi's readings lay over it (its memory too,
    the runtime having given none); with no card and no devices the live
    path reports what is missing."""
    try:
        ttel.set_sources([ttel.NvidiaSmiSource(runner=lambda: SMI_TEXT)])
        ttel.register_job_devices("job-z", [0], 0, lambda: "running")
        fleet = tmgr.TPUManager(devices=["cpu", "cpu", "cpu"]).get_fleet_status()
    finally:
        ttel.set_sources(None)
        ttel.unregister_job_devices("job-z")
    idle, loaded, slow = fleet.devices
    assert idle.platform == "cpu" and idle.temperature_c == 31.0
    assert idle.hbm_total_gb == round(81559 / 1024, 3) and idle.power_limit_w == 700.0
    assert [j.job_id for j in idle.jobs] == ["job-z"] and not loaded.jobs
    assert idle.health_status == tmgr.TPUHealthStatus.HEALTHY
    assert loaded.health_status == tmgr.TPUHealthStatus.WARNING  # duty 98 %, power 0.98x
    assert slow.health_status == tmgr.TPUHealthStatus.CRITICAL
    assert fleet.telemetry_sources == ["nvidia_smi"] and fleet.available_devices == 1
    if not torch.cuda.is_available():
        none = tmgr.TPUManager().get_fleet_status()
        assert none.total_devices == 0
        assert "no CUDA device visible" in none.fleet_alerts[0]


# -- profiler ---------------------------------------------------------------------

def test_mfu_and_peaks_match_jax():
    for kind in ("TPU v4", "TPU v5 lite", "TPU v5p", "TPU v6 lite", "cpu", "TPU v3"):
        dev = types.SimpleNamespace(device_kind=kind)
        assert tprof.peak_flops_for_kind(kind) == jprof.peak_flops_per_chip(dev)
        want = jprof.mfu(6e9, 2000.0, dev)
        peak = tprof.peak_flops_for_kind(kind)
        assert (None if peak is None else 6e9 * 2000.0 / peak) == want
    assert tprof.peak_flops_for_kind("NVIDIA H100 80GB HBM3") == 989e12
    assert tprof.peak_flops_per_chip(torch.device("cpu")) is None
    if not torch.cuda.is_available():
        assert tprof.peak_flops_per_chip() is None and tprof.mfu(1.0, 1.0) is None
    assert tprof.mfu(1.0, 0.0) is None


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b", "zb"])
def test_pipeline_tick_account_matches_jax(schedule):
    for stages, micro in ((1, 4), (2, 4), (4, 8), (4, 3)):
        assert tprof.pipeline_tick_account(schedule, stages, micro) == \
            jprof.pipeline_tick_account(schedule, stages, micro)


def test_step_profiler_on_a_scripted_clock(monkeypatch):
    """The same phase marks on the same clock: equal summaries (phase
    stats, fractions, tokens/s, the pipelined account)."""
    ticks = iter([0.0, 0.01, 0.05, 0.30, 0.31,    # step 1
                  1.0, 1.02, 1.04, 1.20, 1.22,    # step 2
                  2.0, 2.0, 2.1, 2.2, 2.9] * 2)   # step 3; then the second profiler
    monkeypatch.setattr(jprof.time, "perf_counter", lambda: next(ticks))
    out = []
    for mod in (jprof, tprof):
        acct = mod.pipeline_tick_account("1f1b", 2, 4)
        p = mod.StepProfiler(window=2, tokens_per_step=4096, flops_per_token=1e9,
                             n_devices=2, pipeline_account=acct)
        for _ in range(3):
            p.begin_step()
            p.mark("data")
            p.mark("dispatch")
            p.mark("device")
            p.end_step()
        out.append((p.summary(), p.last_step_phases()))
    assert out[1] == out[0]
    assert out[1][0]["window"] == 2 and out[1][0]["steps_seen"] == 3


def test_trace_session_is_one_at_a_time(tmp_path):
    s = tprof.TraceSession()
    s.start(str(tmp_path / "t"))
    with pytest.raises(tprof.TraceActiveError) as e:
        s.start(str(tmp_path / "u"))
    assert e.value.log_dir == str(tmp_path / "t") and s.status()["active"]
    torch.ones(4) @ torch.ones(4)
    info = s.stop()
    assert info["log_dir"] == str(tmp_path / "t") and not s.status()["active"]
    (trace,) = (tmp_path / "t").glob("trace_*.json")
    assert "traceEvents" in json.loads(trace.read_text())
    with pytest.raises(RuntimeError, match="no active trace"):
        s.stop()


def test_trace_session_keeps_a_card_capture_on_the_main_thread(tmp_path, monkeypatch):
    """Where a card is visible, a capture started off the main thread, or
    timed (its stop on a timer thread), is refused before the profiler is
    touched; on the CPU a thread may start and stop one."""
    s = tprof.TraceSession()
    got = {}

    def on_thread():
        try:
            s.start(str(tmp_path / "t"))
        except RuntimeError as e:
            got["error"] = str(e)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    t = threading.Thread(target=on_thread, name="job-a")
    t.start()
    t.join()
    assert "main thread only" in got["error"] and "'job-a'" in got["error"]
    with pytest.raises(RuntimeError, match="timed trace capture"):
        s.start(str(tmp_path / "t"), duration_s=30.0)
    assert not s.active and not (tmp_path / "t").exists()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = threading.Thread(target=lambda: got.update(info=(s.start(str(tmp_path / "u")),
                                                         s.stop())))
    t.start()
    t.join()
    assert got["info"][1]["log_dir"] == str(tmp_path / "u") and not s.active
