"""Port parity: ``tpu_engine_torch.autopilot`` against
``tpu_engine.autopilot``.

Each package's autopilot reads its own package's flight recorder,
historian and incident correlator, all on one virtual clock with counter
ids; the same scripted series (host blame and health, slow steps, the
serving SLO ratio, the precompile queue) must give the same
``DecisionRecord.to_json()`` stream, armed and in dry run, with every rule
consulted and every suppression reason hit. The armed port autopilot then
actuates the port's planes: ``FleetScheduler.quarantine_device``,
``ServingFleet.scale_to`` and a ``PrecompileWorker``'s pump.
"""

import threading

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tpu_engine import autopilot as jap  # noqa: E402
from tpu_engine import historian as jhist  # noqa: E402
from tpu_engine import tracing as jtr  # noqa: E402
from tpu_engine_torch import autopilot as tap  # noqa: E402
from tpu_engine_torch import compile_index as tci  # noqa: E402
from tpu_engine_torch import historian as thist  # noqa: E402
from tpu_engine_torch import scheduler as tsched  # noqa: E402
from tpu_engine_torch import serving_fleet as tfleet  # noqa: E402
from tpu_engine_torch import tracing as ttr  # noqa: E402

PKGS = {"jax": (jap, jhist, jtr), "port": (tap, thist, ttr)}
SERVING = {"fleet": "serving-test"}


class Clock:
    def __init__(self, t):
        self.t = float(t)

    def __call__(self):
        return self.t


def _ids(prefix):
    n = [0]

    def nxt():
        n[0] += 1
        return f"{prefix}-{n[0]:08d}"

    return nxt


class _Queue:
    """A precompile worker's surface: a queue depth the tick records."""

    def __init__(self, depths):
        self.depths, self.pumps = list(depths), 0

    def stats(self):
        return {"queue_depth": self.depths.pop(0) if self.depths else 0}

    def pump(self):
        self.pumps += 1


def _rig(pkg, dry_run, **cfg):
    ap_mod, hist_mod, tr_mod = PKGS[pkg]
    clock = Clock(1000.0)
    rec = tr_mod.FlightRecorder(max_spans=4096, max_events=4096, clock=clock,
                                id_factory=_ids("t"))
    hist = hist_mod.MetricHistorian(clock=clock)
    corr = hist_mod.IncidentCorrelator(clock=clock, merge_window_s=10.0, stale_after_s=1e9)
    acts = []
    conf = dict(trend_window_s=60.0, sustain_consults=3, cooldown_s=40.0,
                max_actions_per_window=3, action_window_s=200.0, fault_blame_threshold=2,
                host_health_floor=0.9, nominal_step_time_s=1.0, serving_labels=SERVING,
                max_decisions=64)
    conf.update(cfg)
    ap = ap_mod.FleetAutopilot(
        ap_mod.AutopilotConfig(**conf), dry_run=dry_run, historian=hist, correlator=corr,
        recorder=rec, precompiler=_Queue([0, 0, 3, 2, 0] + [0] * 40),
        actuators={"drain_host": lambda r: acts.append(("drain", r.action["params"])),
                   "replan_slow_job": lambda r: acts.append(("replan", r.action["params"]))},
        clock=clock, id_factory=_ids("apd"), trace_id="fleet")
    return clock, rec, hist, corr, ap, acts


def _script(pkg, dry_run):
    """Twenty ticks 5 s apart: hosts 3 and 5 blamed (host 5 healthy, so
    never consulted), a slow training step, the serving SLO burning (no
    actuator wired), and a precompile queue: consults that build streaks,
    fire, cool down and exhaust the loop's action budget."""
    clock, rec, hist, corr, ap, acts = _rig(pkg, dry_run)
    stream = []
    for tick in range(20):
        t = clock.t
        if tick < 12:
            for idx, health in ((3, 0.4), (5, 0.95)):
                for i in range(2):
                    rec.event("host_slow", kind="fault", trace_id="fleet", ts=t,
                              attrs={"device_index": idx, "step": tick * 2 + i})
                hist.record("hetero_host_health", health, ts=t, labels={"host": str(idx)})
        if 4 <= tick < 16:
            hist.record("step_time_s", 1.6, ts=t)
        if tick >= 2:
            hist.record("slo_serving_p99_ok", 0.5 if tick < 14 else 1.0, ts=t, labels=SERVING)
            hist.record("slo_serving_p99_ms", 2500.0, ts=t, labels=SERVING)
        stream += [r.to_json() for r in ap.tick(now=t)]
        clock.t += 5.0
    return stream, ap.stats(), acts, ap


def test_decision_stream_equals_jax_armed_and_dry_run():
    got = {(pkg, dry): _script(pkg, dry) for pkg in PKGS for dry in (False, True)}
    port, port_dry, jax_run = got[("port", False)], got[("port", True)], got[("jax", False)]
    assert port[0] == jax_run[0] == port_dry[0] == got[("jax", True)][0]
    stats = {k: v for k, v in port[1].items() if k not in ("armed", "dry_run")}
    assert stats == {k: v for k, v in jax_run[1].items() if k not in ("armed", "dry_run")}
    assert port[2] == jax_run[2] and port_dry[2] == []
    assert port_dry[1]["actuations_total"] == 0
    rules = {r.rule for r in port[3]._records}
    reasons = {r.suppressed_reason for r in port[3]._records}
    assert rules == set(tap.RULES)
    assert set(tap.SUPPRESSION_REASONS) <= reasons
    pumps = port[3].precompiler.pumps
    assert pumps > 0 and port[1]["actuations_total"] == port[1]["fired_total"] == \
        len(port[2]) + pumps
    assert tap.RULES == jap.RULES and tap.SUPPRESSION_REASONS == jap.SUPPRESSION_REASONS
    assert port[3].export_state() == jax_run[3].export_state()
    fresh = _rig("port", True)[4]
    fresh.load_state(port[3].export_state())
    assert fresh.export_state() == port[3].export_state() and fresh.dry_run is False


class _StubEngine:
    slots = 4

    def step(self):
        return 0

    def stats(self):
        return {"slots": self.slots, "active_slots": 0, "prefilling": 0, "queued": 0,
                "tokens_per_sec_recent": 0.0}


class _StubJob:
    """A serving replica's job surface, idle until stopped."""

    def __init__(self, sub):
        from tpu_engine_torch.supervisor import JobStatus

        self.S, self.job_id, self.config = JobStatus, sub.job_id, sub.config
        self.status, self.error, self.current_step = JobStatus.RUNNING, None, 0
        self.watcher = tfleet._ReplicaWatcher()
        self._stop = threading.Event()
        self.engine, self.engine_ready = _StubEngine(), threading.Event()

    is_alive = property(lambda self: not self._stop.is_set())

    def start(self):
        self.engine_ready.set()

    def join(self, timeout=None):
        pass

    def describe(self):
        return {"job_id": self.job_id}


def test_armed_autopilot_actuates_the_port_planes():
    """Armed, with no injected actuators: ``drain_host`` quarantines the
    blamed device on the port's scheduler, ``rescale_serving`` adds a
    replica to the port's ``ServingFleet`` and ``kick_precompile`` pumps
    the port's ``PrecompileWorker``; the tick also polls the scheduler and
    ticks the fleet."""
    clock = Clock(1000.0)
    sched = tsched.FleetScheduler(max_concurrent_jobs=4, poll_interval_s=3600.0,
                                  device="cpu")
    fleet = tfleet.ServingFleet(
        sched, tfleet.ServingReplicaSpec(model_name="gpt-tiny", max_slots=4, max_len=64),
        autoscaler=tfleet.ReplicaAutoscaler(tfleet.AutoscalerConfig(min_replicas=1,
                                                                     max_replicas=3)),
        replica_job_factory=lambda sub, spec: _StubJob(sub))
    ran = []
    worker = tci.PrecompileWorker(tci.CompileCacheIndex(path=None),
                                  compile_fn=lambda task: ran.append(task), clock=clock,
                                  background=False)
    rec = ttr.FlightRecorder(clock=clock, id_factory=_ids("t"))
    hist = thist.MetricHistorian(clock=clock)
    ap = tap.FleetAutopilot(
        tap.AutopilotConfig(sustain_consults=1, rule_sustain={}, serving_labels=SERVING,
                            fault_blame_threshold=1, max_actions_per_window=5),
        dry_run=False, historian=hist, correlator=thist.IncidentCorrelator(clock=clock),
        recorder=rec, scheduler=sched, serving_fleet=fleet, precompiler=worker, clock=clock)
    try:
        fleet.start()
        assert fleet.desired_replicas == 1
        assert worker.request("layout-a", label="grow-back") == "queued"
        rec.event("host_slow", kind="fault", trace_id="fleet", ts=clock.t,
                  attrs={"device_index": 2})
        hist.record("hetero_host_health", 0.3, ts=clock.t, labels={"host": "2"})
        hist.record("slo_serving_p99_ok", 0.2, ts=clock.t, labels=SERVING)
        records = ap.tick(now=clock.t)
        fired = sorted(r.rule for r in records if r.outcome == "fired")
        assert fired == ["drain_host", "kick_precompile", "rescale_serving"]
        assert 2 in sched._hetero_quarantined
        assert sched._hetero_quarantined[2]["source"] == "autopilot"
        live = [x for x in fleet._replicas.values() if x.state not in tsched.TERMINAL_STATES]
        assert fleet.desired_replicas == 2 and len(live) == 2
        assert len(ran) == 1 and worker.stats()["completed_total"] == 1
        assert ap.stats()["actuations_by_rule"]["drain_host"] == 1
        assert not sched.request_replan()  # no training job to replan
    finally:
        fleet.stop()
        sched.shutdown()


def test_process_autopilot_singleton():
    tap.set_autopilot(None)
    first = tap.get_autopilot()
    assert first.dry_run and tap.get_autopilot() is first
    own = tap.FleetAutopilot(dry_run=False)
    tap.set_autopilot(own)
    assert tap.get_autopilot() is own and own.stats()["armed"]
    tap.set_autopilot(None)
