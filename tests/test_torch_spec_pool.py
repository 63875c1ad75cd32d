"""Port parity: ``tpu_engine_torch.spec_pool`` against
``tpu_engine.spec_pool``.

``SpecSpillController`` reads the same acceptance series from each
package's historian on a virtual clock: its spill and restore decisions
(``DecisionRecord.to_json()``, suppressions included), streaks and state
must be JAX's. ``SpecServingFleet`` runs over each package's scheduler
with engine-free stub engines: a tenant whose draft never matches is
spilled, then served plainly with a canary probe every ``canary_every``
requests, in the same order and counts as JAX's. With real tiny engines
(gpt-tiny verify pool, a 1-layer draft, fp32, JAX's weights through
``params_from_jax``) the emitted stream is the verify pool's own greedy
stream.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_engine import historian as jhist  # noqa: E402
from tpu_engine import scheduler as jsched  # noqa: E402
from tpu_engine import serving_fleet as jfleet  # noqa: E402
from tpu_engine import spec_pool as jsp  # noqa: E402
from tpu_engine import tpu_manager as jtpu  # noqa: E402
from tpu_engine.models import transformer as jtfm  # noqa: E402
from tpu_engine_torch import historian as thist  # noqa: E402
from tpu_engine_torch import scheduler as tsched  # noqa: E402
from tpu_engine_torch import serving as tsrv  # noqa: E402
from tpu_engine_torch import serving_fleet as tfleet  # noqa: E402
from tpu_engine_torch import spec_pool as tsp  # noqa: E402
from tpu_engine_torch import tpu_manager as ttpu  # noqa: E402
from tpu_engine_torch.models import config as tcfg  # noqa: E402
from tpu_engine_torch.models import convert  # noqa: E402

PKGS = {"jax": (jsp, jhist, jsched, jfleet, jtpu.TPUManager, {}),
        "port": (tsp, thist, tsched, tfleet, ttpu.TPUManager, {"device": "cpu"})}
SERIES = "serving.spec.accept_rate"


def _controller_script(pkg):
    """Sustained low α spills (two audited suppressions first); a healthy
    window resets a streak; a window with no samples freezes one; α inside
    the hysteresis band does not restore; a recovery inside the cooldown is
    suppressed, after it restores."""
    sp, hist_mod = PKGS[pkg][:2]
    hist = hist_mod.MetricHistorian()
    ctl = sp.SpecSpillController(hist, sp.SpecSpillConfig(
        accept_floor=0.35, recover_margin=0.15, window_s=10.0, sustain_consults=2,
        cooldown_s=50.0, canary_every=8))

    def feed(tenant, alpha, t0, n=5):
        for i in range(n):
            hist.record(SERIES, alpha, ts=t0 + i, labels={"tenant": tenant})

    out = []
    feed("t", 0.05, 100.0)
    feed("ok", 0.1, 100.0)
    feed("z", 0.1, 100.0, n=2)
    out += [ctl.consult(["t", "ok", "z"], now=110.0)]
    feed("ok", 0.9, 105.0, n=6)
    out += [ctl.consult(["t", "ok"], now=111.0), ctl.status()]
    feed("t", 0.45, 115.0)
    out += [ctl.consult(["t"], now=122.0), ctl.consult(["t"], now=123.0)]
    feed("t", 0.9, 130.0)
    out += [ctl.consult(["t"], now=136.0), ctl.consult(["t"], now=137.0)]
    feed("t", 0.9, 155.0)
    out += [ctl.consult(["t"], now=162.0), ctl.consult(["t", "ok", "z"], now=500.0)]
    out += [[d.to_json() for d in ctl.decisions], ctl.status(), ctl.export_state()]
    return out


def test_spill_controller_equals_jax():
    got, want = _controller_script("port"), _controller_script("jax")
    assert got == want
    records = [__import__("json").loads(s) for s in got[-3]]
    assert {r["suppressed_reason"] for r in records} == {
        None, "trend-not-sustained", "cooldown-active", "no-data"}
    assert [r["action"]["verb"] for r in records if r["outcome"] == "fired"] == [
        "spill", "restore"]
    assert got[2]["streaks"]["ok"] == 0 and got[-2]["streaks"]["z"] == 1
    ctl = tsp.SpecSpillController(thist.MetricHistorian())
    ctl.load_state(got[-1])
    assert ctl.export_state() == got[-1]


class StubEngine:
    """An engine-free batcher surface: the verify pool emits 1s; a draft
    built for a "misdraft" fleet emits 2s (its proposals never match)."""

    def __init__(self, spec, token=1):
        self.slots, self.token = int(spec.max_slots), token
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
                r["tokens"].append(self.token)
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


def _wait(pred, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


def _spec_fleet(pkg, engine_factory, **kw):
    sp, hist_mod, sched_mod, fleet_mod, manager, extra = PKGS[pkg]
    sched = sched_mod.FleetScheduler(max_concurrent_jobs=4, fleet_fn=manager.get_mock_fleet,
                                     poll_interval_s=0.01, grow_back_cooldown_s=0.0, **extra)

    def one():
        return fleet_mod.ReplicaAutoscaler(fleet_mod.AutoscalerConfig(min_replicas=1,
                                                                       max_replicas=1))

    spec = dict(model_name="gpt-tiny", max_len=128)
    fleet = sp.SpecServingFleet(
        sched, fleet_mod.ServingReplicaSpec(max_slots=4, **spec),
        fleet_mod.ServingReplicaSpec(max_slots=2, **spec), verify_autoscaler=one(),
        draft_autoscaler=one(), engine_factory=engine_factory, **kw)
    fleet.start()
    assert _wait(lambda: len(fleet.draft.running_replicas()) == 1
                 and len(fleet.verify.running_replicas()) == 1, timeout=60)
    return sched, fleet


def test_spec_fleet_spill_and_canary_cadence_equal_jax():
    """Tenant "good" (drafts match) keeps speculating; tenant "junk" (α 0)
    is spilled after two consults, then rides plain decode with every
    second request a canary down the draft leg. Streams, legs, flags,
    acceptance and the module counters are JAX's."""
    got = {}
    for pkg in PKGS:
        sp, hist_mod = PKGS[pkg][:2]
        sp._reset_stats_for_tests()
        hist = hist_mod.MetricHistorian()

        def factory(spec):
            return StubEngine(spec, token=2 if spec.pool_role == "draft" else 1)

        sched, fleet = _spec_fleet(pkg, factory, historian=hist, spill_config=sp.SpecSpillConfig(
            accept_floor=0.35, recover_margin=0.15, window_s=60.0, sustain_consults=2,
            cooldown_s=0.0, canary_every=2))
        try:
            outs = [fleet.wait(fleet.submit_request([7, 7], 4, tenant="junk"), timeout=10.0)]
            fleet.tick()
            fleet.tick()
            for i in range(5):
                outs.append(fleet.wait(fleet.submit_request([7, 8 + i], 4, tenant="junk"),
                                       timeout=10.0))
            keys = ("status", "tokens", "speculated", "canary", "redispatches", "tenant")
            st = fleet.status()
            got[pkg] = dict(
                outs=[{k: o[k] for k in keys} for o in outs],
                drafted=[o["draft_replica"] is not None for o in outs],
                spilled=fleet.spill.spilled(), rates=fleet.tenant_accept_rates(),
                status={k: st[k] for k in ("requests_total", "completed_total", "tokens_total",
                                           "draft_legs_total", "plain_legs_total", "tenants")},
                decisions=[(d.rule, d.outcome, d.suppressed_reason) for d in
                           fleet.spill.decisions],
                module=sp.spec_pool_stats())
        finally:
            fleet.stop()
            sched.shutdown()
    assert got["port"] == got["jax"]
    assert [o["canary"] for o in got["port"]["outs"]] == [False, False, True, False, True,
                                                           False]
    assert got["port"]["spilled"] == ["junk"]
    assert all(o["tokens"] == [1] * 4 for o in got["port"]["outs"])


def _tiny(seed, **over):
    jcfg = jtfm.MODEL_CONFIGS["gpt-tiny"].with_(**over)
    cfg = tcfg.MODEL_CONFIGS["gpt-tiny"].with_(**over)
    jp = jtfm.init_params(jax.random.PRNGKey(seed), jcfg, dtype=jnp.float32)
    return jcfg, cfg, jp, convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                                   device="cpu")


def test_emitted_stream_is_the_verify_pools_own():
    """Real port engines: gpt-tiny verifies, a 1-layer model of another
    seed drafts. Each emitted stream is the verify pool's own greedy stream
    (a plain batcher's on the same weights, which
    ``tests/test_torch_serving.py`` holds to JAX's), whatever the draft
    proposed; acceptance lands in the tenant's EMA and the historian."""
    _, cfg, _, tp = _tiny(2)
    _, dcfg, _, dtp = _tiny(9, n_layers=1)
    geom = dict(max_slots=2, max_len=64, prefill_chunk=16, prefill_pad_to=16)

    def factory(spec):
        params, c = (dtp, dcfg) if spec.pool_role == "draft" else (tp, cfg)
        return tsrv.ContinuousBatcher(params, c, compute_dtype=torch.float32, device="cpu",
                                      **geom)

    prompts = [np.random.default_rng(i).integers(1, 512, n).tolist()
               for i, n in enumerate((6, 11))]
    ref = factory(tfleet.ServingReplicaSpec(model_name="gpt-tiny"))
    ids = [ref.submit(p, max_new_tokens=6) for p in prompts]
    for _ in range(100):
        if all(ref.result(i)["status"] == "done" for i in ids):
            break
        ref.step()
    want = [ref.result(i)["tokens"] for i in ids]
    hist = thist.MetricHistorian()
    sched, fleet = _spec_fleet("port", factory, historian=hist)
    try:
        outs = [fleet.wait(fleet.submit_request(p, 6, tenant="own"), timeout=60.0)
                for p in prompts]
    finally:
        fleet.stop()
        sched.shutdown()
    assert [o["tokens"] for o in outs] == want
    assert all(o["speculated"] and o["status"] == "done" for o in outs)
    rate = fleet.tenant_accept_rates()["own"]
    assert rate is not None and 0.0 <= rate <= 1.0
    q = hist.query(SERIES, 0.0, time.time() + 1.0, agg="count", labels={"tenant": "own"})
    assert q["count"] == 2
