"""The port's goodput ledger (``tpu_engine_torch/goodput.py``) against JAX's
(``tpu_engine/goodput.py``).

The same span timelines are recorded through each package's ``tracing``
``FlightRecorder`` by one script, then decomposed, accounted by a
``GoodputLedger`` and judged by an ``SLOBurnRateAlerter`` of each package.
Categories, ledger totals and alert transitions must be equal. Both
modules are plain Python over their recorders; no JAX computation runs.
"""

import random

import pytest

pytest.importorskip("torch").set_num_threads(1)

from tpu_engine import goodput as jgood  # noqa: E402
from tpu_engine import tracing as jtracing  # noqa: E402
from tpu_engine_torch import goodput as tgood  # noqa: E402
from tpu_engine_torch import tracing as ttracing  # noqa: E402

NOW = 1_000_000.0
PACKAGES = ((jgood, jtracing), (tgood, ttracing))


def _fuzz(seed):
    def script(rec):
        rng = random.Random(seed)
        kinds = ["compile", "checkpoint_save", "checkpoint_restore", "emergency_save",
                 "admission", "fault", "final_save"]
        tid = rec.new_trace_id()
        wall = rng.uniform(50.0, 500.0)
        root = rec.start_span("job:fuzz", kind="job", trace_id=tid, t0=0.0,
                              attrs={"n_chips": rng.choice([None, 4, 8])})
        cursor = rng.uniform(0, wall * 0.1)
        for _ in range(rng.randint(0, 3)):
            a1 = min(wall, cursor + rng.uniform(1.0, wall / 2))
            rec.record_span("attempt", kind="attempt", trace_id=tid, t0=cursor, t1=a1,
                            attrs={"step_s": rng.choice([None, rng.uniform(1.0, wall)])})
            cursor = a1 + rng.uniform(0.0, wall * 0.1)
        for _ in range(rng.randint(0, 12)):
            k = rng.choice(kinds)
            t0 = rng.uniform(-10.0, wall)
            attrs = {}
            if k == "checkpoint_save":
                attrs["blocking"] = rng.choice([True, False])
            if k == "compile":
                attrs["cache_hit"] = rng.choice([True, False])
            if k == "admission":
                attrs.update(gang=rng.choice([2, 4]), configured_gang=4)
            rec.record_span(k, kind=k, trace_id=tid, t0=t0,
                            t1=t0 + rng.uniform(0.0, wall / 3), attrs=attrs)
        for _ in range(rng.randint(0, 4)):
            rec.event("host_slow", kind="fault", trace_id=tid, ts=rng.uniform(0, wall),
                      attrs={"penalty_s": rng.uniform(0, 20.0)})
        for _ in range(rng.randint(0, 2)):
            rec.event("preempt", kind="preempt_drain", trace_id=tid, ts=rng.uniform(0, wall))
            rec.event(rng.choice(["submit", "requeue"]), kind="scheduler", trace_id=tid,
                      ts=rng.uniform(0, wall))
        root.end(t1=wall)
        return tid
    return script


def _preempt_requeue(rec):
    tid = rec.new_trace_id()
    root = rec.start_span("job:p", kind="job", trace_id=tid, t0=0.0)
    rec.event("submit", kind="scheduler", trace_id=tid, ts=0.0)
    rec.record_span("admission", kind="admission", trace_id=tid, t0=1, t1=2)
    rec.record_span("attempt-1", kind="attempt", trace_id=tid, t0=2, t1=40)
    rec.record_span("compile", kind="compile", trace_id=tid, t0=2, t1=9,
                    attrs={"cache_hit": False})
    rec.event("preempt", kind="preempt_drain", trace_id=tid, ts=35.0)
    rec.record_span("emergency_save", kind="emergency_save", trace_id=tid, t0=36, t1=39)
    rec.event("requeue", kind="scheduler", trace_id=tid, ts=40.0)
    rec.record_span("admission", kind="admission", trace_id=tid, t0=58, t1=60)
    rec.record_span("attempt-2", kind="attempt", trace_id=tid, t0=60, t1=100)
    rec.record_span("compile", kind="compile", trace_id=tid, t0=60, t1=62,
                    attrs={"cache_hit": True})
    rec.record_span("checkpoint_restore", kind="checkpoint_restore", trace_id=tid,
                    t0=62, t1=66)
    rec.record_span("final_save", kind="final_save", trace_id=tid, t0=95, t1=100)
    root.end(t1=100.0)
    return tid


def _shrunk(rec):
    tid = rec.new_trace_id()
    root = rec.start_span("job:d", kind="job", trace_id=tid, t0=0.0, attrs={"n_chips": 8})
    rec.record_span("shrink_admit", kind="admission", trace_id=tid, t0=49, t1=50,
                    attrs={"mesh": {"data": 2, "fsdp": 2}})
    root.end(t1=100.0)
    return tid


def _open_root(rec):
    tid = rec.new_trace_id()
    rec.start_span("job:o", kind="job", trace_id=tid, t0=NOW - 30.0)
    rec.record_span("compile", kind="compile", trace_id=tid, t0=NOW - 29.0, t1=NOW - 20.0)
    return tid


SCRIPTS = {**{f"fuzz{s}": _fuzz(s) for s in range(8)}, "preempt_requeue": _preempt_requeue,
           "shrunk": _shrunk, "open_root": _open_root}


def _round(d):
    return {k: round(v, 9) for k, v in d.items()}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_decompose_trace_matches(name):
    """Each package's ``decompose_trace`` over the same timeline: equal
    categories, wall, goodput fraction, compile split and segments."""
    out = []
    for good, tracing in PACKAGES:
        rec = tracing.FlightRecorder(clock=lambda: NOW)
        tid = SCRIPTS[name](rec)
        out.append(good.decompose_trace(rec, tid))
    want, got = out
    assert tgood.CATEGORIES == jgood.CATEGORIES
    assert _round(got["categories"]) == _round(want["categories"])
    assert got["wall_s"] == want["wall_s"]
    assert got["goodput_fraction"] == pytest.approx(want["goodput_fraction"], abs=1e-12)
    assert _round(got["compile_split"]) == _round(want["compile_split"])
    assert [tuple(s) for s in got["segments"]] == [tuple(s) for s in want["segments"]]
    assert abs(sum(got["categories"].values()) - got["wall_s"]) < 1e-6 * max(got["wall_s"], 1)


def test_ledger_totals_and_alerts_match():
    """The incremental ledger (refreshed per scrape, then finalized) and a
    burn-rate alerter fed the same history: equal snapshots, equal alert
    transitions, and the alerts on each recorder's fleet timeline."""
    snaps, states, alerts = [], [], []
    for good, tracing in PACKAGES:
        rec = tracing.FlightRecorder(clock=lambda: NOW)
        led = good.GoodputLedger(clock=lambda: 0.0, bucket_s=60.0, history_buckets=512,
                                 max_tenants=2)
        tids = [(SCRIPTS[n](rec), f"t{i}") for i, n in enumerate(("preempt_requeue", "shrunk",
                                                                   "fuzz3"))]
        for tid, tenant in tids:
            led.track(tid, tenant=tenant, workload="training")
        for now in (20.0, 50.0, 50.0, 120.0, 600.0):
            led.refresh(rec, now=now)
        for tid, _ in tids:
            led.finalize(rec, tid, now=600.0)
        al = good.SLOBurnRateAlerter(led, goodput_target=0.9, short_window_s=120.0,
                                     long_window_s=360.0, warning_burn=1.5, page_burn=3.0,
                                     recorder=rec, clock=lambda: 0.0, p99_slo_ms=100.0)
        seen = ["ok"]
        t = 1000.0
        for frac in [1.0] * 6 + [0.8] * 6 + [0.3] * 6 + [1.0] * 8:
            t += 60.0
            led.note("productive", 60.0 * frac, ts=t)
            if frac < 1.0:
                led.note("queue_wait", 60.0 * (1 - frac), ts=t)
            al.observe_p99(500.0 if frac < 0.5 else 50.0, ts=t)
            out = al.evaluate(now=t)
            seen.append((out["goodput"]["state"], out["serving_p99"]["state"]))
        snap = led.snapshot()
        snaps.append(snap)
        states.append(seen)
        alerts.append([(e["name"], e["trace_id"], e["attrs"]["severity"])
                       for e in rec.events(limit=0) if e["kind"] == "slo_alert"])
    want, got = snaps
    assert _round(got["categories"]) == _round(want["categories"])
    assert got["wall_s"] == pytest.approx(want["wall_s"], abs=1e-9)
    assert got["traces_accounted"] == want["traces_accounted"] == 3
    assert got["invariant_violations"] == want["invariant_violations"] == 0
    assert sorted(got["by_tenant"]) == sorted(want["by_tenant"])
    for t in want["by_tenant"]:
        assert _round(got["by_tenant"][t]) == _round(want["by_tenant"][t])
    assert states[0] == states[1]
    assert ("page", "page") in states[1] and states[1][-1][0] == "ok"
    assert alerts[0] == alerts[1] and alerts[1]
    assert all(tid == tgood.FLEET_TRACE_ID for _, tid, _ in alerts[1])


def test_process_wide_ledger_and_alerter():
    """``get_ledger``/``set_ledger``/``get_alerter``/``set_alerter``: a
    swapped ledger drops the alerter that read the old one."""
    old = tgood.get_ledger()
    try:
        led = tgood.GoodputLedger()
        tgood.set_ledger(led)
        al = tgood.get_alerter()
        assert tgood.get_ledger() is led and al.ledger is led
        assert tgood.get_alerter() is al
        tgood.set_ledger(tgood.GoodputLedger())
        assert tgood.get_alerter() is not al
    finally:
        tgood.set_alerter(None)
        tgood.set_ledger(old)
