"""Port parity: ``tpu_engine_torch.serving_fleet`` against
``tpu_engine.serving_fleet``.

The control objects run the same scripted calls through both packages over
a virtual clock and must agree exactly: ``FleetRouter``'s picks, weights
and counters, ``_PercentileWindow``'s reads, ``ReplicaAutoscaler``'s
decisions and ``last_reason``. ``ServingFleet`` runs over each package's
``FleetScheduler`` with an engine-free stub engine: a CRITICAL training
job evicts a replica checkpoint-free, the submission requeues and is
readmitted, and a request held meanwhile completes. One real tiny replica
per package (gpt-tiny, fp32, JAX's weights through ``params_from_jax``)
serves the same greedy requests token-identically; the port's default
factory builds a replica on the CPU and refuses what JAX cannot be asked
for in one process.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_engine import scheduler as jsched  # noqa: E402
from tpu_engine import serving as jsrv  # noqa: E402
from tpu_engine import serving_fleet as jfleet  # noqa: E402
from tpu_engine import supervisor as jsup  # noqa: E402
from tpu_engine import tpu_manager as jtpu  # noqa: E402
from tpu_engine.mesh_runtime import MeshConfig as JMesh  # noqa: E402
from tpu_engine.models import transformer as jtfm  # noqa: E402
from tpu_engine.sharding import TPUTrainConfig  # noqa: E402
from tpu_engine_torch import scheduler as tsched  # noqa: E402
from tpu_engine_torch import serving as tsrv  # noqa: E402
from tpu_engine_torch import serving_fleet as tfleet  # noqa: E402
from tpu_engine_torch import supervisor as tsup  # noqa: E402
from tpu_engine_torch import tpu_manager as ttpu  # noqa: E402
from tpu_engine_torch.mesh_runtime import MeshConfig as TMesh  # noqa: E402
from tpu_engine_torch.models import config as tcfg  # noqa: E402
from tpu_engine_torch.models import convert  # noqa: E402
from tpu_engine_torch.train import TrainConfig  # noqa: E402

PKGS = {
    "jax": dict(sched=jsched, fleet=jfleet, Status=jsup.JobStatus, Manager=jtpu.TPUManager,
                train=lambda: TPUTrainConfig(model_name="gpt-tiny", mesh=JMesh(data=1),
                                             micro_batch_size=1, seq_len=32), extra={}),
    "port": dict(sched=tsched, fleet=tfleet, Status=tsup.JobStatus, Manager=ttpu.TPUManager,
                 train=lambda: TrainConfig(model_name="gpt-tiny", mesh=TMesh(data=1),
                                           micro_batch_size=1, seq_len=32),
                 extra={"device": "cpu"}),
}


def _wait(pred, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


def _stats(tps, free, slots=8):
    return {"tokens_per_sec": tps, "free_slots": free, "slots": slots}


def _router_script(mod):
    """Every router path: WRR by throughput, a full replica starved, an
    affinity pin that sticks, survives a busy fall-through and is dropped
    with its replica, affinity hits paying their WRR share, the LRU bound."""
    r = mod.FleetRouter(affinity_tokens=4, affinity_max=6)
    log = []
    r.update({"fast": _stats(90.0, 8), "slow": _stats(10.0, 8)})
    log += [r.route() for _ in range(25)]
    r.update({"full": _stats(90.0, 0), "free": _stats(30.0, 8), "slow": _stats(10.0, 3)})
    log += [r.route([i, i]) for i in range(10)]
    r.update({"a": _stats(50.0, 8), "b": _stats(50.0, 8)})
    pinned = r.route([3, 3, 3, 3, 1])
    log.append(pinned)
    other = "b" if pinned == "a" else "a"
    for i in range(4):
        r.update({pinned: _stats(50.0, 0), other: _stats(50.0, 8)})
        log.append(r.route([3, 3, 3, 3, 10 + i]))
        r.update({pinned: _stats(50.0, 8), other: _stats(50.0, 8)})
        log.append(r.route([3, 3, 3, 3, 20 + i]))
    for i in range(12):
        r.update({"a": _stats(50.0 + i, 8 - i % 3), "b": _stats(40.0, 8)})
        log += [r.route([5, 5, 5, 5, i]), r.route([i, 1000 + i, 7, 7])]
        log.append(r.stats())
    r.update({other: _stats(50.0, 8)})
    log += [r.route([3, 3, 3, 3, 99]), r.stats(), dict(r._affinity)]
    r.update({})
    log += [r.route([1, 2]), r.stats()]
    return log


def test_router_equals_jax():
    assert _router_script(tfleet) == _router_script(jfleet)


def test_percentile_window_equals_jax():
    rng = np.random.default_rng(0)
    samples = np.concatenate([rng.lognormal(3.0, 1.5, 700), [0.01, 0.05, 2e7]])
    got, want = tfleet._PercentileWindow(window=256), jfleet._PercentileWindow(window=256)
    reads = []
    for i, v in enumerate(samples):
        got.add(float(v))
        want.add(float(v))
        if i % 37 == 0:
            qs = (0.0, 0.5, 0.9, 0.99, 1.0)
            reads.append((len(got), got.percentiles(qs), len(want), want.percentiles(qs)))
    assert all(g == w and n == m for n, g, m, w in reads)
    assert tfleet._PercentileWindow().percentiles((0.5,)) == [None]


def _scaler(mod, **kw):
    base = dict(min_replicas=1, max_replicas=4, target_queue_per_replica=4.0,
                low_water_queue_per_replica=0.5, p99_slo_ms=1000.0, ttft_slo_ms=300.0,
                window_s=10.0, scale_up_cooldown_s=2.0, scale_down_cooldown_s=30.0)
    base.update(kw)
    return mod.ReplicaAutoscaler(mod.AutoscalerConfig(**base))


def _autoscaler_script(mod):
    """Queue-driven scale-ups to the max, the p99 and TTFT breaches, the
    up-cooldown, a calm window held by the down-cooldown, the scale-down,
    and the min floor, each decision with its reason, on a virtual clock."""
    a = _scaler(mod)
    out, n = [], 1
    for t in range(0, 12):
        n = a.observe(float(t), queue_depth=40.0 if t < 8 else 2.0, p99_ms=None,
                      n_replicas=n)
        out.append((n, a.last_reason))
    for t, p99, ttft in ((12.0, 5000.0, None), (12.5, 5000.0, None), (15.0, 100.0, 900.0),
                         (16.0, 100.0, 100.0)):
        n = a.observe(t, 0.0, p99, max(n - 1, 1), ttft_p99_ms=ttft)
        out.append((n, a.last_reason))
    n = 3
    for t in range(17, 60, 3):
        n = a.observe(float(t), queue_depth=0.0, p99_ms=100.0, n_replicas=n)
        out.append((n, a.last_reason, a.stats()))
    b = _scaler(mod, min_replicas=2, ttft_slo_ms=None)
    out += [(b.observe(0.0, 0.0, None, 1), b.last_reason),
            (b.observe(1.0, 0.0, 50.0, 2, ttft_p99_ms=1e6), b.last_reason, b.stats())]
    return out


def test_autoscaler_equals_jax():
    got, want = _autoscaler_script(tfleet), _autoscaler_script(jfleet)
    assert got == want
    reasons = {step[1].split(":")[0] for step in got}
    assert {"scale up", "scale down", "hold"} <= reasons
    assert any("TTFT SLO" in step[1] for step in got) and any("below min" in s[1] for s in got)


class StubEngine:
    """An engine-free batcher surface: instant decode, one token a step."""

    def __init__(self, spec):
        self.slots = int(spec.max_slots)
        self._reqs, self._seq = {}, 0
        self._lock = threading.Lock()

    def submit(self, prompt, max_new_tokens=64, temperature=0.0):
        with self._lock:
            self._seq += 1
            self._reqs[self._seq] = {"need": int(max_new_tokens), "tokens": []}
            return self._seq

    def step(self):
        with self._lock:
            live = [r for r in self._reqs.values() if len(r["tokens"]) < r["need"]]
            for r in live:
                r["tokens"].append(1)
            return len(live)

    def result(self, rid):
        with self._lock:
            r = self._reqs[rid]
            return {"status": "done" if len(r["tokens"]) >= r["need"] else "running",
                    "tokens": list(r["tokens"])}

    def stats(self):
        with self._lock:
            active = sum(1 for r in self._reqs.values() if len(r["tokens"]) < r["need"])
        return {"slots": self.slots, "active_slots": active, "prefilling": 0, "queued": 0,
                "tokens_per_sec_recent": 100.0}


class _TrainStub:
    """A training job that runs until ``done`` is set, or is preempted."""

    def __init__(self, sub, status):
        self.S, self.job_id, self.config = status, sub.job_id, sub.config
        self.status, self.error, self.current_step = status.PENDING, None, 0
        self.watcher = type("W", (), {"fired": threading.Event(),
                                      "simulate_interruption": lambda w: w.fired.set()})()
        self._stop, self.done = threading.Event(), threading.Event()
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

    def _run(self):
        self.status = self.S.RUNNING
        while not self.done.wait(0.005):
            if self._stop.is_set() or self.watcher.fired.is_set():
                self.status = self.S.STOPPED if self._stop.is_set() else self.S.PREEMPTED
                return
        self.status = self.S.COMPLETED


def _sched(pkg, **kw):
    p = PKGS[pkg]
    jobs = []

    def factory(sub):
        jobs.append(_TrainStub(sub, p["Status"]))
        return jobs[-1]

    s = p["sched"].FleetScheduler(job_factory=factory, poll_interval_s=0.01,
                                  grow_back_cooldown_s=0.0, **{**p["extra"], **kw})
    s.stub_jobs = jobs
    return s


def _spec(pkg, **kw):
    return PKGS[pkg]["fleet"].ServingReplicaSpec(
        **{**dict(model_name="gpt-tiny", max_slots=4, max_len=128), **kw})


def _fleet(pkg, sched, **kw):
    mod = PKGS[pkg]["fleet"]
    kw.setdefault("engine_factory", StubEngine)
    kw.setdefault("autoscaler", mod.ReplicaAutoscaler(
        mod.AutoscalerConfig(min_replicas=1, max_replicas=4)))
    return mod.ServingFleet(sched, kw.pop("spec", None) or _spec(pkg), **kw)


def test_critical_training_evicts_replica_checkpoint_free():
    """Both packages: a CRITICAL training job evicts the replica without a
    checkpoint (the replica requeues, its job is dropped), a request held
    meanwhile stays pending fleet-side, and when training drains the same
    submission is readmitted and serves it."""
    got = {}
    for pkg in PKGS:
        s = _sched(pkg, max_concurrent_jobs=1, fleet_fn=PKGS[pkg]["Manager"].get_mock_fleet)
        fleet = _fleet(pkg, s)
        try:
            fleet.start()
            assert _wait(lambda: len(fleet.running_replicas()) == 1)
            (replica,) = fleet._replicas.values()
            est = replica.estimate.model_dump()
            training = s.submit(PKGS[pkg]["train"](), priority=PKGS[pkg]["sched"].JobPriority.CRITICAL)
            assert _wait(lambda: training.state.value == "running")
            evicted = (replica.state.value, replica.preemptions, replica.job is None,
                       len(fleet.running_replicas()), s.stats()["preemptions_total"],
                       replica.config.checkpoint_dir)
            rid = fleet.submit_request([1, 2, 3], max_new_tokens=4)
            held = fleet.result(rid)["status"]
            s.stub_jobs[-1].done.set()
            assert _wait(lambda: training.state.value == "completed")
            assert _wait(lambda: replica.state.value == "running")
            assert _wait(lambda: fleet.result(rid)["status"] == "done")
            st = s.stats()
            got[pkg] = dict(est=est, evicted=evicted, held=held, attempts=replica.attempts,
                            out=fleet.result(rid)["tokens"],
                            counters={k: st[k] for k in ("preemptions_total", "requeues_total",
                                                         "completed_total")},
                            fleet={k: v for k, v in fleet.status().items()
                                   if k in ("desired_replicas", "running_replicas",
                                            "requests_total", "completed_total",
                                            "tokens_total", "pending_requests")})
        finally:
            fleet.stop()
            s.shutdown()
    assert got["port"] == got["jax"]
    assert got["port"]["evicted"] == ("queued", 1, True, 0, 1, None)
    assert got["port"]["attempts"] == 2 and got["port"]["held"] == "pending"


def test_scale_to_and_snapshot_equal_jax():
    """``scale_to`` submits and cancels replicas toward the clamped count,
    requests spread over them, and ``snapshot_state`` reads the same in
    both packages."""
    got = {}
    for pkg in PKGS:
        s = _sched(pkg, max_concurrent_jobs=4, fleet_fn=PKGS[pkg]["Manager"].get_mock_fleet)
        fleet = _fleet(pkg, s)
        try:
            counts = [fleet.scale_to(3)]
            assert _wait(lambda: len(fleet.running_replicas()) == 3)
            fids = [fleet.submit_request([i, i + 1], max_new_tokens=3) for i in range(6)]
            assert all(_wait(lambda f=f: fleet.result(f)["status"] == "done") for f in fids)
            counts += [fleet.scale_to(9), fleet.scale_to(1)]
            assert _wait(lambda: len(fleet.running_replicas()) == 1)
            snap = fleet.snapshot_state()
            got[pkg] = dict(counts=counts, n_replicas=len(snap.pop("replicas")),
                            requests={f: {k: v for k, v in r.items() if k != "submitted_at"}
                                      for f, r in snap.pop("requests").items()},
                            snap=snap, p99=fleet.status()["p99_latency_ms"] is not None)
        finally:
            fleet.stop()
            s.shutdown()
    assert got["port"] == got["jax"]
    assert got["port"]["counts"] == [3, 4, 1] and got["port"]["snap"]["counters"] == {
        "requests_total": 6, "completed_total": 6, "tokens_total": 18}


def _model():
    jcfg, cfg = jtfm.MODEL_CONFIGS["gpt-tiny"], tcfg.MODEL_CONFIGS["gpt-tiny"]
    jp = jtfm.init_params(jax.random.PRNGKey(11), jcfg, dtype=jnp.float32)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, cfg, jp, tp


def test_real_tiny_replica_serves_jax_streams():
    """One real gpt-tiny replica per package, each on its scheduler's
    replica thread (fp32, JAX's weights): the same greedy requests give the
    same streams, and the replica's teardown leaves no engine behind."""
    jcfg, cfg, jp, tp = _model()
    geom = dict(max_slots=2, max_len=64, prefill_chunk=16, prefill_pad_to=16, chunk_steps=2)
    factories = {
        "jax": lambda spec: jsrv.ContinuousBatcher(jp, jcfg, compute_dtype=jnp.float32, **geom),
        "port": lambda spec: tsrv.ContinuousBatcher(tp, cfg, compute_dtype=torch.float32,
                                                    device="cpu", **geom),
    }
    prompts = [np.random.default_rng(i).integers(1, 512, n).tolist()
               for i, n in enumerate((5, 9, 14))]
    got = {}
    for pkg in PKGS:
        s = _sched(pkg, max_concurrent_jobs=2)
        fleet = _fleet(pkg, s, engine_factory=factories[pkg])
        try:
            fleet.start()
            assert _wait(lambda: len(fleet.running_replicas()) == 1, timeout=60)
            fids = [fleet.submit_request(p, max_new_tokens=7) for p in prompts]
            assert all(_wait(lambda f=f: fleet.result(f)["status"] == "done", timeout=60)
                       for f in fids)
            got[pkg] = [fleet.result(f)["tokens"] for f in fids]
            (sub,) = fleet._replicas.values()
        finally:
            fleet.stop()
            s.shutdown()
        assert _wait(lambda: sub.job is None or not sub.job.is_alive)
        assert sub.job is None or sub.job.engine is None
    assert got["port"] == got["jax"]
    assert all(len(t) == 7 for t in got["port"])


def _serve_one(engine, prompt, n=4):
    rid = engine.submit(prompt, max_new_tokens=n)
    for _ in range(50):
        if engine.result(rid)["status"] == "done":
            break
        engine.step()
    assert engine.result(rid)["status"] == "done"
    return engine.result(rid)["tokens"]


def test_default_factory_builds_on_the_cpu(tmp_path):
    """``build_replica_engine`` builds the port's batcher on ``spec.device``
    from a seeded init (int8 weights when asked) or from an int8 snapshot
    (the same tree serves the same stream), and refuses an unknown model
    with JAX's message and a one-process tensor-parallel replica with the
    port's reason."""
    from tpu_engine_torch import quant
    from tpu_engine_torch.models import transformer as ttfm

    geom = dict(max_slots=2, max_len=64, prefill_chunk=16, device="cpu", compute_dtype="fp32")
    spec = _spec("port", weight_quant="int8", **geom)
    engine = tfleet.build_replica_engine(spec)
    assert engine.device == torch.device("cpu") and engine.max_slots == 2
    assert len(_serve_one(engine, [1, 2, 3])) == 4
    cfg = tcfg.MODEL_CONFIGS["gpt-tiny"]
    tree = quant.quantize_params(ttfm.init_params(cfg, torch.Generator().manual_seed(4), "cpu"))
    quant.save_quantized(tree, str(tmp_path / "snap"), model_config=cfg)
    from_snapshot = tfleet.build_replica_engine(_spec("port", snapshot_dir=str(tmp_path / "snap"),
                                                      **geom))
    direct = tsrv.ContinuousBatcher(tree, cfg, compute_dtype=torch.float32, device="cpu",
                                    max_slots=2, max_len=64, prefill_chunk=16)
    assert _serve_one(from_snapshot, [5, 6, 7, 8]) == _serve_one(direct, [5, 6, 7, 8])
    assert _spec("port", snapshot_dir="x").estimate().model_dump() == \
        _spec("port", weight_quant="int8").estimate().model_dump()
    with pytest.raises(ValueError) as t_err:
        tfleet.build_replica_engine(_spec("port", model_name="nope", device="cpu"))
    with pytest.raises(ValueError) as j_err:
        jfleet.build_replica_engine(_spec("jax", model_name="nope"))
    assert str(t_err.value) == str(j_err.value)
    with pytest.raises(ValueError, match="one process a rank"):
        tfleet.build_replica_engine(_spec("port", tensor_parallel=2, device="cpu"))
    for kw in (dict(), dict(kv_quant=True, max_slots=16, prefix_cache_tokens=256),
               dict(pool_role="prefill", inflight_handoffs=2)):
        assert _spec("port", **kw).estimate().model_dump() == \
            _spec("jax", **kw).estimate().model_dump()
    cfg = _spec("port").placement_config()
    assert (cfg.model_name, cfg.mesh.model, cfg.checkpoint_dir) == ("gpt-tiny", 1, None)
