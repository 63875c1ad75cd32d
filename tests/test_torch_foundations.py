"""Port parity: the control plane's JAX-free foundations
(``tpu_engine_torch/{historian,journal,tracing,loss_monitor,preemption,
faults}.py``), copies of the JAX package's modules, against those modules.

Each test runs one scripted sequence of calls through both copies (fake
clocks, seeded ``random``, temporary journal files, deterministic ids) and
compares what they return and export. The only difference allowed is the
exporter name a Chrome trace carries (``tpu_engine_torch.*`` against
``tpu_engine.*``); Prometheus family names are JAX's in both. No JAX
compute runs. The checkpoint manager's wiring to them (JAX's spans and
``faults.get_active()``) is held in ``tests/test_torch_checkpoint.py``."""

import importlib
import itertools
import json
import random

import pytest

pytest.importorskip("torch").set_num_threads(1)

PAIRS = {m: (importlib.import_module(f"tpu_engine.{m}"), importlib.import_module(
    f"tpu_engine_torch.{m}")) for m in ("historian", "journal", "tracing", "loss_monitor",
                                        "preemption", "faults")}


def _same(script, module: str, **kw) -> None:
    """``script(copy, **kw)`` through JAX's module and the port's: equal
    results, exporter names aside."""
    jax_mod, port_mod = PAIRS[module]
    want = json.dumps(script(jax_mod, **kw), sort_keys=True, default=str)
    got = json.dumps(script(port_mod, **kw), sort_keys=True, default=str)
    assert got.replace("tpu_engine_torch.", "tpu_engine.") == want


class _Clock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _ids():
    n = itertools.count()
    return lambda: f"id{next(n):05d}"


def _historian(h):
    clock = _Clock()
    hist = h.MetricHistorian(raw_capacity=64, max_series=8, clock=clock)
    rng = random.Random(3)
    for i in range(400):
        hist.record("step_time_s", 0.5 + rng.random(), ts=1000.0 + 0.5 * i, labels={"job": "a"})
        if i % 3 == 0:
            hist.record("hbm_gb", 40 + rng.random() * 10, ts=1000.0 + 0.5 * i, labels={"host": i % 2})
    clock.t = 1200.0
    hist.tick(1200.0)
    out = {"stats": hist.stats(), "series": hist.series_list(),
           "last": hist.last_n("step_time_s", 5, labels={"job": "a"})}
    for agg in ("avg", "min", "max", "last", "sum", "count", "rate", "p99"):
        out[agg] = hist.query("step_time_s", t0=1100.0, t1=1200.0, agg=agg, labels={"job": "a"})
    out["buckets"] = hist.buckets("hbm_gb", 10.0, labels={"host": 0})
    out["chrome"] = hist.export_chrome_counters()
    out["pct"] = [h.percentile([rng.random() for _ in range(50)], q) for q in (0.5, 0.99)]
    return out


def _incidents(h):
    corr = h.IncidentCorrelator()
    recs = [
        {"type": "event", "kind": "fault", "name": "chip_unhealthy", "ts": 100.0,
         "trace_id": "t1", "id": "e1", "attrs": {"device_index": 2}},
        {"type": "span", "kind": "detect", "name": "detect", "t0": 100.5, "t1": 101.0,
         "trace_id": "t1", "span_id": "s1", "attrs": {}},
        {"type": "event", "kind": "scheduler", "name": "requeue", "ts": 102.0,
         "trace_id": "t1", "id": "e2", "parent": "s1", "attrs": {}},
        {"type": "span", "kind": "resume", "name": "resume", "t0": 110.0, "t1": 111.0,
         "trace_id": "t1", "span_id": "s2", "attrs": {}},
    ]
    n = corr.ingest(records=recs, now=120.0)
    return {"n": n, "incidents": corr.incidents(), "stats": corr.stats(),
            "open": corr.open_refs()}


def test_historian_matches_jax():
    """Writes at fake timestamps, every query aggregate, rollup buckets,
    the Chrome counter export and the stats."""
    _same(_historian, "historian")
    _same(_incidents, "historian")


def _journal(j, path):
    clock = _Clock(50.0)
    j._reset_stats_for_tests()
    jr = j.ControlPlaneJournal(str(path), max_bytes=2048, clock=clock)
    for i in range(40):
        clock.t += 1.0
        jr.append("submit", {"id": i, "model": "llama-1b", "pad": "x" * (i % 7)})
        if i % 9 == 0:
            jr.snapshot({"queue": list(range(i)), "n": i})
    j.note_mttr(3.5)
    j.note_recovery(records_replayed_total=3, restores_total=1)
    return {"read": jr.read(), "stats": jr.stats(), "recovery": j.recovery_stats()}


def test_journal_matches_jax(tmp_path):
    """Appends and snapshots through a rotation, then replay, stats and the
    recovery counters, each copy on its own temporary file."""
    for sub in ("a", "b"):
        (tmp_path / sub).mkdir()
    jax_mod, port_mod = PAIRS["journal"]
    want = _journal(jax_mod, tmp_path / "a" / "journal.jsonl")
    got = _journal(port_mod, tmp_path / "b" / "journal.jsonl")
    got = json.dumps(got, sort_keys=True).replace(str(tmp_path / "b"), str(tmp_path / "a"))
    assert got == json.dumps(want, sort_keys=True)


def _tracing(t, persist=None):
    clock = _Clock(10.0)
    rec = t.FlightRecorder(max_spans=16, max_events=8, clock=clock, id_factory=_ids(),
                           persist_path=persist)
    tid = rec.new_trace_id()
    root = rec.start_span("job", kind="job", trace_id=tid)
    for i in range(24):
        clock.t += 0.25
        with rec.start_span(f"step{i}", kind="step", trace_id=tid, parent=root.span_id) as sp:
            clock.t += 0.5
            sp.annotate(loss=1.0 / (i + 1))
        if i % 5 == 0:
            rec.event("checkpoint", kind="checkpoint_save", trace_id=tid, attrs={"step": i})
        rec.counter("throughput", {"tokens_per_s": 1000.0 + i}, trace_id=tid)
    rec.record_span("checkpoint_restore", kind="checkpoint_restore", trace_id=tid, t0=5.0,
                    attrs={"step": 3})
    root.end()
    hist = importlib.import_module(t.__name__.rsplit(".", 1)[0] + ".historian")
    det = t.StepTimeAnomalyDetector(warmup=4, sustained_k=2,
                                    historian=hist.MetricHistorian(clock=clock))
    anomalies = [det.observe(i, dt, ts=20.0 + i) for i, dt in
                 enumerate([1.0] * 12 + [4.0, 4.0, 1.0])]
    return {"spans": rec.spans(limit=100), "events": rec.events(limit=100),
            "traces": rec.traces(), "attr": rec.attribute(tid, 10.0, 30.0),
            "stats": rec.stats(), "chrome": rec.export_chrome_trace(trace_id=tid),
            "detector": det.summary(), "anomalies": anomalies}


def test_tracing_matches_jax(tmp_path):
    """Spans, events and counters on a fake clock with deterministic ids
    through the bounded rings, the step-time anomaly detector, the Chrome
    trace (exporter name aside) and the persisted JSONL."""
    _same(_tracing, "tracing")
    jax_mod, port_mod = PAIRS["tracing"]
    _tracing(jax_mod, str(tmp_path / "a.jsonl"))
    _tracing(port_mod, str(tmp_path / "b.jsonl"))
    assert (tmp_path / "a.jsonl").read_text() == (tmp_path / "b.jsonl").read_text()


def _loss_monitor(lm):
    mon = lm.LossSpikeMonitor(job_id="job-1", config=lm.MonitorConfig())
    rng = random.Random(5)
    alerts = []
    for step in range(120):
        loss = 4.0 * 0.99 ** step + 0.01 * rng.random()
        if step in (60, 90):
            loss *= 3.0
        if step == 100:
            loss = float("nan")
        alerts += mon.ingest(lm.TrainingMetrics(step=step, loss=loss,
                                                gradient_norm=1.0 + rng.random(),
                                                learning_rate=1e-4, timestamp=float(step)))
    return {"alerts": [a.model_dump(exclude={"timestamp"}) for a in alerts],
            "summary": mon.get_summary(), "curve": mon.get_loss_curve(),
            "critical": mon.has_critical_alert()}


def test_loss_monitor_matches_jax():
    """A seeded loss curve with two spikes and a NaN: the alerts, the
    summary and the curve."""
    _same(_loss_monitor, "loss_monitor")


def _preemption(p):
    fired = []
    w = p.PreemptionWatcher(fired.append, check_interval_s=0.01, metadata_check=lambda: None,
                            max_backoff_s=0.05)
    first = w._poll_once()
    w.simulate_interruption()
    second = w._poll_once()
    w.start()
    w._thread.join(timeout=5.0)
    w.stop()
    return {"first": first, "second": second, "fired": fired, "is_fired": w.fired,
            "failures": w.metadata_failures}


def test_preemption_matches_jax():
    """The watcher driven through its simulation seam (the metadata probe
    replaced by one that learns nothing): the poll results, the one
    callback and the probe-failure count."""
    _same(_preemption, "preemption")


def _faults(f):
    random.seed(11)
    plan = f.FaultPlan.random(seed=7, n_faults=6, max_step=20, n_devices=4)
    inj = f.FaultInjector(plan)
    inj.arm()
    took = []
    for step in range(25):
        inj.observe_step(step)
        took.append([inj.take_save_fault(step), inj.take_restore_fault(step),
                     inj.preempt_due(step), inj.host_slow_penalty_s(step),
                     sorted((k, v.value) for k, v in inj.chip_overlay().items())])
    healed = inj.heal(1)
    f.set_active(inj)
    active = f.get_active() is inj
    f.clear_active()
    d = inj.describe_full()
    for e in d.get("events", []):
        e.pop("timestamp", None)
    return {"plan": plan.model_dump(), "took": took, "healed": healed, "active": active,
            "cleared": f.get_active() is None, "describe": d}


def test_faults_matches_jax():
    """A seeded random plan through the injector's step seams, heal, the
    process-wide slot and the description (event times aside)."""
    _same(_faults, "faults")
