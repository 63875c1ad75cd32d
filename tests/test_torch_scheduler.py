"""The port's fleet scheduler (``tpu_engine_torch/scheduler.py``) against
JAX's (``tpu_engine/scheduler.py``).

Thread-backed stub jobs over fabricated fleets run JAX's scenarios
(``tests/test_scheduler.py``, ``tests/test_journal.py``) through both
schedulers: queue order, quotas, cancel and drain; HBM-gated gang
admission and head-only priority preemption with requeue; elastic shrink
on a degraded fleet and grow-back; the hetero policy and its quarantine;
snapshot and restore through the journal. Every submission's state
sequence (each ``_set_state``, keyed by its seq) and the counters must be
equal. The port's scheduler runs with ``device="cpu"`` (its placements
then map onto CPU devices). Waits poll every 0.01 s with 10 s margins;
no case races a short TTL.

One case runs a real port ``TrainingJob`` (gpt-tiny on the CPU) through
the port's default job factory: a LOW job preempted by a HIGH one
resumes from its emergency save, and its losses equal a plain loop's
bitwise.
"""

import json
import threading
import time
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tpu_engine import hbm_estimate as jhbm  # noqa: E402
from tpu_engine import hetero as jhetero  # noqa: E402
from tpu_engine import journal as jjournal  # noqa: E402
from tpu_engine import scheduler as jsched  # noqa: E402
from tpu_engine import supervisor as jsup  # noqa: E402
from tpu_engine import tpu_manager as jtpu  # noqa: E402
from tpu_engine.mesh_runtime import MeshConfig as JMesh  # noqa: E402
from tpu_engine.sharding import TPUTrainConfig  # noqa: E402
from tpu_engine_torch import hbm_estimate as thbm  # noqa: E402
from tpu_engine_torch import hetero as thetero  # noqa: E402
from tpu_engine_torch import journal as tjournal  # noqa: E402
from tpu_engine_torch import scheduler as tsched  # noqa: E402
from tpu_engine_torch import supervisor as tsup  # noqa: E402
from tpu_engine_torch import tpu_manager as ttpu  # noqa: E402
from tpu_engine_torch.mesh_runtime import MeshConfig as TMesh  # noqa: E402
from tpu_engine_torch.train import TrainConfig  # noqa: E402

JAX = SimpleNamespace(name="jax", sched=jsched, Mesh=JMesh, Cfg=TPUTrainConfig,
                      JobStatus=jsup.JobStatus, Manager=jtpu.TPUManager, hbm=jhbm,
                      hetero=jhetero, journal=jjournal, extra={})
PORT = SimpleNamespace(name="port", sched=tsched, Mesh=TMesh, Cfg=TrainConfig,
                       JobStatus=tsup.JobStatus, Manager=ttpu.TPUManager, hbm=thbm,
                       hetero=thetero, journal=tjournal, extra={"device": "cpu"})
TIMEOUT = 10.0


def wait_until(pred, timeout=TIMEOUT):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


class StubWatcher:
    def __init__(self):
        self.fired = threading.Event()

    def simulate_interruption(self):
        self.fired.set()


class StubJob:
    """A thread that runs until ``finish()``, a stop or a preemption (JAX's
    test stub, over either package's ``JobStatus``)."""

    def __init__(self, sub, status_enum):
        self.S = status_enum
        self.job_id = sub.job_id
        self.config = sub.config
        self.n_devices = len(sub.job_kwargs.get("devices") or [])
        self.status = status_enum.PENDING
        self.error = None
        self.current_step = 0
        self.watcher = StubWatcher()
        self._stop = threading.Event()
        self._done = threading.Event()
        self._final = status_enum.COMPLETED
        self._thread = threading.Thread(target=self._run, daemon=True)

    @property
    def is_alive(self):
        return self._thread.is_alive()

    def start(self):
        self._thread.start()

    def join(self, timeout=None):
        self._thread.join(timeout)

    def describe(self):
        return {"job_id": self.job_id, "status": self.status.value}

    def finish(self, status=None):
        self._final = status or self.S.COMPLETED
        self._done.set()

    def _run(self):
        self.status = self.S.RUNNING
        while not self._done.is_set():
            if self._stop.is_set():
                self.status = self.S.STOPPED
                return
            if self.watcher.fired.is_set():
                self.status = self.S.PREEMPTED
                return
            self._done.wait(0.005)
        self.status = self._final


class Harness:
    """Builds recording schedulers of one package; every state transition
    lands in ``trace[(scheduler, seq)]``."""

    def __init__(self, P, tmp_path):
        self.P, self.tmp = P, tmp_path
        self.trace = {}
        self.made = []

    def cfg(self, mesh=None, **kw):
        base = dict(model_name="gpt-tiny", micro_batch_size=1, seq_len=32, precision="fp32",
                    total_steps=5, activation_checkpointing=False,
                    checkpoint_dir=str(self.tmp / "ckpt"))
        base.update(kw)
        return self.P.Cfg(mesh=self.P.Mesh(**(mesh or {"data": 1, "fsdp": 2})), **base)

    def make(self, pump=True, **kw):
        """A recording scheduler; ``pump=False`` starts no pump thread (the
        test drives ``poll()``, as JAX's journal tests do)."""
        P, trace = self.P, self.trace
        jobs = []
        n = len(self.made)

        class Rec(P.sched.FleetScheduler):
            def _set_state(self, sub, new_state):
                if sub.state != new_state:
                    trace.setdefault((n, sub.seq), []).append(new_state.value)
                super()._set_state(sub, new_state)

        def factory(sub):
            job = StubJob(sub, P.JobStatus)
            jobs.append(job)
            return job

        kw.setdefault("job_factory", factory)
        kw.setdefault("poll_interval_s", 0.01)
        kw.setdefault("grow_back_cooldown_s", 0.0)
        s = Rec(**kw, **P.extra)
        if not pump:
            s._ensure_thread = lambda: None
        s.jobs = jobs
        self.made.append(s)
        return s

    def close(self):
        for s in self.made:
            for j in s.jobs:
                j.finish()
            s.shutdown()

    def chip(self, i, **kw):
        base = dict(index=i, device_kind="NVIDIA H100 80GB HBM3", hbm_total_gb=16.0,
                    hbm_used_gb=4.0, duty_cycle_pct=50.0, temperature_c=50.0)
        base.update(kw)
        return base

    def fleet(self, hot=()):
        """8 chips; those in ``hot`` thermally critical."""
        return self.P.Manager().get_fleet_status(metrics=[
            self.chip(i, temperature_c=91.0) if i in hot else self.chip(i) for i in range(8)])

    def slow_rebalancer(self, **kw):
        trk = self.P.hetero.ThroughputTracker(2)
        for _ in range(40):
            trk.note_host_slow(1, 1.0, 1.0)
        kw.setdefault("sustain_consults", 1)
        kw.setdefault("min_gain", 0.01)
        kw.setdefault("dry_run", False)
        return self.P.hetero.HeteroRebalancer(trk, 8, **kw)


COUNTERS = ("submitted_total", "admitted_total", "preemptions_total", "requeues_total",
            "completed_total", "failed_total", "cancelled_total", "elastic_shrinks_total",
            "grow_backs_total", "queue_depth", "running", "running_shrunk")


def counters(s):
    st = s.stats()
    return {k: st[k] for k in COUNTERS} | {"hetero": {
        k: st["hetero"][k] for k in ("rebalances_total", "shrinks_total",
                                      "shrinks_avoided_total", "rebalance_preferred_total",
                                      "quarantined_devices")}}


def subview(sub):
    return (sub.seq, sub.state.value, sub.attempts, sub.preemptions, sub.admitted_gang,
            sorted(sub.placement), sub.shrunk_mesh and {k: sub.shrunk_mesh[k] for k in
                                                        ("data", "fsdp", "pipe", "model")},
            sub.last_skip_reason)


# -- scenarios: each drives one harness, returns its observations -----------


def queue_order(h):
    s = h.make(max_concurrent_jobs=0)
    S = h.P.sched.JobPriority
    subs = [s.submit(h.cfg(), priority=p) for p in (S.LOW, S.NORMAL, S.HIGH, S.NORMAL,
                                                     S.CRITICAL)]
    order = [s.get(q["submission_id"]).seq for q in s.queue_state()["queued"]]
    return {"order": order, "pos": [s.queue_position(x.submission_id) for x in subs]}


def capacity(h):
    s = h.make(max_concurrent_jobs=2)
    subs = [s.submit(h.cfg()) for _ in range(3)]
    assert wait_until(lambda: len(s.jobs) == 2)
    s.poll()
    mid = [subview(x) for x in subs]
    s.jobs[0].finish()
    assert wait_until(lambda: subs[2].state.value == "running")
    for j in s.jobs:
        j.finish()
    assert wait_until(lambda: all(x.state.value == "completed" for x in subs))
    return {"mid": mid, "end": [subview(x) for x in subs], "counters": counters(s)}


def quota_cancel_drain(h):
    Q = h.P.sched.QuotaExceeded
    s = h.make(max_concurrent_jobs=0, default_quota=2, quotas={"vip": 3})
    out = []
    for who in ("alice", "alice", "alice", "bob", "vip", "vip", "vip", "vip"):
        try:
            s.submit(h.cfg(), submitter=who)
            out.append("ok")
        except Q as e:
            out.append(str(e))
    s2 = h.make(max_concurrent_jobs=1)
    running, queued = s2.submit(h.cfg()), s2.submit(h.cfg())
    assert wait_until(lambda: running.state.value == "running")
    out.append(s2.cancel(queued.submission_id))
    out.append(s2.cancel(running.submission_id))
    assert wait_until(lambda: running.state.value == "cancelled")
    out += [s2.cancel(running.submission_id), s2.cancel("sub_nope")]
    s3 = h.make(max_concurrent_jobs=2)
    s3.drain()
    sub = s3.submit(h.cfg())
    s3.poll()
    out += [sub.state.value, s3.draining]
    s3.resume_admission()
    assert wait_until(lambda: sub.state.value == "running")
    return {"out": out, "counters": [counters(x) for x in (s, s2, s3)]}


def hbm_gang(h):
    mock = h.P.Manager.get_mock_fleet
    s = h.make(max_concurrent_jobs=4, fleet_fn=mock)
    big = s.submit(h.cfg({"data": 2, "fsdp": 4}), priority=h.P.sched.JobPriority.HIGH)
    small = s.submit(h.cfg({"data": 1, "fsdp": 2}))
    assert wait_until(lambda: small.state.value == "running")
    s.poll()
    out = {"big": subview(big), "small": subview(small), "c1": counters(s)}
    gs = h.P.hbm.gang_size

    def est(config, n_avail):
        return h.P.hbm.HBMEstimate(
            model_name=config.model_name, gang_devices=gs(config, n_avail), params_gib=6.0,
            grads_gib=0, opt_gib=0, working_gib=0, activations_gib=0, logits_gib=0,
            device_total_gib=6.0, host_gib=0)

    s2 = h.make(max_concurrent_jobs=4, fleet_fn=mock, estimate_fn=est)
    first = s2.submit(h.cfg({"data": 1, "fsdp": 4}))
    assert wait_until(lambda: first.state.value == "running")
    second = s2.submit(h.cfg({"data": 1, "fsdp": 4}))
    s2.poll()
    out["second"] = subview(second)
    out["reserved"] = s2.stats()["reserved_hbm_gib"]
    s2.jobs[0].finish()
    assert wait_until(lambda: second.state.value == "running")
    out["after"] = (subview(first), subview(second), s2.stats()["reserved_hbm_gib"])
    out["util"] = {k: v for k, v in s2.fleet_hbm_utilization().items() if k != "used_gib"}
    return out


def preempt_requeue(h):
    P = h.P.sched.JobPriority
    s = h.make(max_concurrent_jobs=1)
    low = s.submit(h.cfg(), priority=P.LOW)
    assert wait_until(lambda: low.state.value == "running")
    first = low.job
    later = s.submit(h.cfg(), priority=P.LOW)
    high = s.submit(h.cfg(), priority=P.HIGH)
    assert wait_until(lambda: first.watcher.fired.is_set())
    assert wait_until(lambda: high.state.value == "running")
    mid = {"order": [s.get(q["submission_id"]).seq for q in s.queue_state()["queued"]],
           "low": subview(low), "c": counters(s)}
    s.jobs[-1].finish()
    assert wait_until(lambda: low.state.value == "running")
    fresh = low.job is not first and low.job.job_id == low.job_id
    s.jobs[-1].finish()
    assert wait_until(lambda: low.state.value == "completed")
    assert wait_until(lambda: later.state.value == "running")
    s.jobs[-1].finish()
    assert wait_until(lambda: later.state.value == "completed")
    # Equal priority never preempts; a job with no checkpoint directory is
    # never evicted.
    s2 = h.make(max_concurrent_jobs=1)
    a = s2.submit(h.cfg(checkpoint_dir=None), priority=P.LOW)
    assert wait_until(lambda: a.state.value == "running")
    b = s2.submit(h.cfg(), priority=P.LOW)
    c = s2.submit(h.cfg(), priority=P.CRITICAL)
    for _ in range(5):
        s2.poll()
    return {"mid": mid, "fresh": fresh, "end": [subview(x) for x in (low, later, high)],
            "c": counters(s), "s2": [subview(x) for x in (a, b, c)], "c2": counters(s2)}


def elastic(h):
    holder = {"fleet": h.fleet(hot=(0,))}
    s = h.make(max_concurrent_jobs=1, fleet_fn=lambda: holder["fleet"])
    sub = s.submit(h.cfg({"data": 4, "fsdp": 2}, elastic_min_devices=2))
    rigid = s.submit(h.cfg({"data": 4, "fsdp": 2}))
    assert wait_until(lambda: sub.state.value == "running")
    s.poll()
    shrunk = (subview(sub), subview(rigid), s.jobs[0].n_devices, counters(s))
    assert s.cancel(rigid.submission_id)
    holder["fleet"] = h.fleet()
    assert wait_until(lambda: sub.state.value == "running" and sub.admitted_gang == 8)
    grown = (subview(sub), counters(s))
    s.jobs[-1].finish()
    assert wait_until(lambda: sub.state.value == "completed")
    return {"shrunk": shrunk, "grown": grown, "end": (subview(sub), counters(s),
                                                      s.stats()["reserved_hbm_gib"])}


def hetero(h):
    fleet = h.fleet()
    s = h.make(max_concurrent_jobs=1, fleet_fn=lambda: fleet, poll_interval_s=60.0,
               hetero_cooldown_s=0.0)
    sub = s.submit(h.cfg())
    assert wait_until(lambda: sub.state.value == "running")
    reb = h.slow_rebalancer()
    s.jobs[0]._hetero = reb
    s.poll()
    out = {"consult": reb.consult_pending(), "c1": counters(s)}
    s.poll()
    plan = reb.maybe_rebalance(10)
    s.poll()
    out.update(plan=list(plan.assignment), c2=counters(s), sub=subview(sub))
    # The floor unreachable: shed the slow host, quarantine its chips with
    # their owner; the owner's cancel releases them.
    s2 = h.make(max_concurrent_jobs=1, fleet_fn=lambda: fleet, poll_interval_s=60.0,
                grow_back=False, hetero_cooldown_s=0.0, hetero_goodput_floor=2.0)
    sub2 = s2.submit(h.cfg({"data": 4, "fsdp": 2}))
    assert wait_until(lambda: sub2.state.value == "running")
    job = s2.jobs[0]
    job._hetero = h.slow_rebalancer()
    s2.poll()
    q = sorted(s2._hetero_quarantined)
    owners = {e["owner"] == sub2.submission_id for e in s2._hetero_quarantined.values()}
    assert wait_until(lambda: not job.is_alive)
    s2.poll()
    requeued = subview(sub2)
    s2.cancel(sub2.submission_id)
    s2.poll()
    out.update(quarantined=q, owners=owners, requeued=requeued, c3=counters(s2),
               released=sorted(s2._hetero_quarantined), sub2=subview(sub2))
    # An elastic job re-admits shrunk around the quarantine, and its fresh
    # attempt (no tracker) releases the chips.
    s3 = h.make(max_concurrent_jobs=1, fleet_fn=lambda: fleet, poll_interval_s=60.0,
                grow_back=False, hetero_cooldown_s=0.0, hetero_goodput_floor=2.0)
    sub3 = s3.submit(h.cfg({"data": 4, "fsdp": 2}, elastic_min_devices=2))
    assert wait_until(lambda: sub3.state.value == "running")
    job3 = s3.jobs[0]
    job3._hetero = h.slow_rebalancer()
    s3.poll()
    assert wait_until(lambda: not job3.is_alive)
    s3.poll()
    out.update(sub3=subview(sub3), q3=sorted(s3._hetero_quarantined), c4=counters(s3))
    return out


def journal(h):
    j = h.P.journal.ControlPlaneJournal(str(h.tmp / f"{h.P.name}.jsonl"))
    s1 = h.make(pump=False, max_concurrent_jobs=2, poll_interval_s=60.0)
    s1.attach_journal(j)
    a, b, c = (s1.submit(h.cfg()) for _ in range(3))
    s1.poll()
    job_a = a.job
    s2 = h.make(pump=False, max_concurrent_jobs=2, poll_interval_s=60.0)
    r = s2.restore(j, live_jobs={a.submission_id: job_a}, now=123.0)
    s3 = h.make(pump=False, max_concurrent_jobs=2, poll_interval_s=60.0)
    s3.restore(j, live_jobs={a.submission_id: job_a}, now=123.0)
    same = (json.dumps(s2.snapshot_state(), sort_keys=True)
            == json.dumps(s3.snapshot_state(), sort_keys=True))
    snap = s2.snapshot_state()
    rows = [{k: e[k] for k in ("seq", "state", "attempts", "preemptions", "placement",
                               "admitted_gang", "last_skip_reason", "priority", "submitter",
                               "workload")} for e in snap["submissions"]]
    # A snapshot of the live scheduler, then a restore from it alone.
    j2 = h.P.journal.ControlPlaneJournal(str(h.tmp / f"{h.P.name}2.jsonl"))
    j2.snapshot({"scheduler": s1.snapshot_state()})
    s4 = h.make(pump=False, max_concurrent_jobs=2, poll_interval_s=60.0)
    r4 = s4.restore(j2, live_jobs={}, now=5.0)
    cfgs = [s4.get(x.submission_id).config for x in (a, b, c)]
    return {"r": {k: r[k] for k in ("restored_submissions", "events_replayed", "had_snapshot",
                                    "readopted", "requeued_vanished", "double_grants")},
            "same": same, "rows": rows, "counters": snap["counters"],
            "readopted": s2.get(a.submission_id).job is job_a,
            "r4": {k: r4[k] for k in ("restored_submissions", "had_snapshot", "readopted",
                                      "requeued_vanished")},
            "s4": [subview(s4.get(x.submission_id)) for x in (a, b, c)],
            "cfg": [(x.model_name, x.mesh.fsdp, x.seq_len, x.checkpoint_dir == str(
                h.tmp / "ckpt")) for x in cfgs]}


SCENARIOS = {f.__name__: f for f in (queue_order, capacity, quota_cancel_drain, hbm_gang,
                                     preempt_requeue, elastic, hetero, journal)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(name, tmp_path):
    """JAX's scenario through both schedulers: equal observations, equal
    state sequences for every submission."""
    got = {}
    for P in (JAX, PORT):
        h = Harness(P, tmp_path / P.name)
        (tmp_path / P.name).mkdir()
        try:
            obs = SCENARIOS[name](h)
            trace = {k: list(v) for k, v in h.trace.items()}  # before close() finishes jobs
        finally:
            h.close()
        got[P.name] = (obs, trace)
    want, mine = got["jax"], got["port"]
    assert mine[0] == want[0]
    assert mine[1] == want[1]


def test_default_factory_refuses_a_gang_in_one_process(tmp_path):
    """A real job whose gang is more than one device, in a process that is
    not one rank of a group that large, fails at construction with the
    reason; the scheduler marks it FAILED (the state machine is JAX's)."""
    s = tsched.FleetScheduler(max_concurrent_jobs=1, device="cpu", poll_interval_s=0.01)
    try:
        sub = s.submit(TrainConfig(model_name="gpt-tiny", mesh=TMesh(data=2), seq_len=32))
        assert wait_until(lambda: sub.state.value == "failed")
        assert "one process a rank" in sub.last_skip_reason
        assert sub.last_skip_reason.startswith("job construction failed: ValueError")
        assert s.stats()["failed_total"] == 1
    finally:
        s.shutdown()


def test_real_job_preempted_resumes_bitwise(tmp_path):
    """gpt-tiny on the CPU through the default job factory: LOW runs, HIGH
    arrives after LOW's step 3, the scheduler preempts LOW (one emergency
    save), runs HIGH to completion, requeues LOW, which resumes from its
    emergency step and completes; its losses after the resume equal a
    plain loop restored from that step, bitwise."""
    from tpu_engine_torch import checkpoint as ckm
    from tpu_engine_torch import goodput, tracing
    from tpu_engine_torch.train import build_train_program

    s = tsched.FleetScheduler(max_concurrent_jobs=1, device="cpu", poll_interval_s=0.01,
                              checkpoint_root=str(tmp_path / "root"))
    P = tsched.JobPriority
    base = dict(model_name="gpt-tiny", mesh=TMesh(data=1), micro_batch_size=2, seq_len=32,
                precision="fp32", activation_checkpointing=False, total_steps=10,
                warmup_steps=1, checkpoint_interval_steps=1000, log_every_steps=1,
                attention_impl="xla")
    lcfg = TrainConfig(**base, metrics_log_path=str(tmp_path / "low.jsonl"))

    def batch(step):
        gen = torch.Generator().manual_seed(step)
        return torch.randint(0, 512, (1, 2, 32), generator=gen)

    def slow_batch(step):  # LOW's steps after its third outlast a scheduler pass
        if step >= 3:
            time.sleep(0.25)
        return batch(step)

    try:
        low = s.submit(lcfg, priority=P.LOW, job_kwargs={"max_steps": 8,
                                                         "data_fn": slow_batch})
        assert wait_until(lambda: low.job is not None and low.job.current_step >= 3,
                          timeout=60)
        high = s.submit(TrainConfig(**base), priority=P.HIGH, job_kwargs={"max_steps": 4})
        assert wait_until(lambda: high.state.value == "completed", timeout=60)
        assert wait_until(lambda: low.state.value == "completed", timeout=60)
        st = s.stats()
        assert (st["preemptions_total"], st["requeues_total"], st["completed_total"]) == (1, 1, 2)
        assert low.preemptions == 1 and low.attempts == 2
        resumed = low.job.resumed_from_step
        assert resumed is not None and 3 <= resumed < 8 and low.job.current_step == 8
        with open(tmp_path / "low.jsonl") as f:
            recs = [r for r in map(json.loads, f) if r.get("kind") == "train"]
        after = {r["step"]: r["loss"] for r in recs if r["step"] > resumed}
        prog = build_train_program(low.config, device="cpu")
        mgr = ckm.TrainCheckpointManager(low.config.checkpoint_dir, program=prog)
        got, state = mgr.restore(ckm.abstract_state_like(prog), step=resumed)
        assert got == resumed
        plain = {}
        for i in range(resumed, 8):
            state, m = prog.step(state, batch(i))
            plain[i + 1] = float(m["loss"])
        assert after == plain
        # The goodput ledger's account of both traces sums to their walls.
        rec = tracing.get_recorder()
        for sub in (low, high):
            d = goodput.decompose_trace(rec, sub.trace_id)
            assert abs(sum(d["categories"].values()) - d["wall_s"]) <= 0.01 * d["wall_s"]
            assert d["categories"]["productive"] > 0
        d = goodput.decompose_trace(rec, low.trace_id)["categories"]
        assert d["preempt_drain"] > 0 and d["restore"] > 0 and d["queue_wait"] > 0
    finally:
        s.shutdown()
