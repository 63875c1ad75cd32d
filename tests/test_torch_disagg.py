"""Port parity: the KV handoff wire and plane (``tpu_engine_torch.disagg``,
the batcher's ``hold_kv`` / ``submit_prefilled`` / ``request_handoff`` /
``take_handoff``, reshard's serving half) and ``DisaggServingFleet`` against
``tpu_engine``'s, on the CPU in fp32 with gpt-tiny at 2 kv heads (so that a
payload's lane and head axes differ in length), weights moved by
``params_from_jax``.

The wire is ``[L, T, KV, HD]`` in both packages: payloads are compared
array for array (fp32 within 2e-4; int8 codes within one step, scales
within 1e-5 relative), and each package's payload is decoded by the other's
batcher with token-identical greedy continuations. The fleet's phase
machine runs over both packages' schedulers with one engine-free stub
engine class, whose steps a test can hold at a phase to lose a replica
there.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_engine import disagg as jdis  # noqa: E402
from tpu_engine import prefix_plane as jpp  # noqa: E402
from tpu_engine import reshard as jrs  # noqa: E402
from tpu_engine import scheduler as jsched  # noqa: E402
from tpu_engine import serving as jsrv  # noqa: E402
from tpu_engine import serving_fleet as jfleet  # noqa: E402
from tpu_engine import tpu_manager as jtpu  # noqa: E402
from tpu_engine.models import transformer as jtfm  # noqa: E402
from tpu_engine_torch import disagg as tdis  # noqa: E402
from tpu_engine_torch import prefix_plane as tpp  # noqa: E402
from tpu_engine_torch import reshard as trs  # noqa: E402
from tpu_engine_torch import scheduler as tsched  # noqa: E402
from tpu_engine_torch import serving as tsrv  # noqa: E402
from tpu_engine_torch import serving_fleet as tfleet  # noqa: E402
from tpu_engine_torch import tpu_manager as ttpu  # noqa: E402
from tpu_engine_torch.models import config as tcfg  # noqa: E402
from tpu_engine_torch.models import convert  # noqa: E402

GEOM = dict(max_slots=2, max_len=64, prefill_chunk=16, prefill_pad_to=16)
N_NEW = 6
WIRE_TOL = 2e-4


def _model(seed, **over):
    over.setdefault("n_kv_heads", 2)
    jcfg = jtfm.MODEL_CONFIGS["gpt-tiny"].with_(**over)
    cfg = tcfg.MODEL_CONFIGS["gpt-tiny"].with_(**over)
    jp = jtfm.init_params(jax.random.PRNGKey(seed), jcfg, dtype=jnp.float32)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, cfg, jp, tp


MODEL = _model(7)
PROMPT = np.random.default_rng(3).integers(1, 512, 13).tolist()
PROMPT_B = np.random.default_rng(4).integers(1, 512, 21).tolist()


def _port(model=MODEL, **kw):
    _, cfg, _, tp = model
    return tsrv.ContinuousBatcher(tp, cfg, compute_dtype=torch.float32, device="cpu",
                                  **{**GEOM, **kw})


def _jax(model=MODEL, **kw):
    jcfg, _, jp, _ = model
    return jsrv.ContinuousBatcher(jp, jcfg, compute_dtype=jnp.float32, **{**GEOM, **kw})


def _until_done(srv, rid, steps=60):
    for _ in range(steps):
        if srv.result(rid)["status"] in ("done", "failed"):
            break
        srv.step()
    out = srv.result(rid)
    assert out["status"] == "done", out
    return out["tokens"]


def _prefill(srv, prompt=PROMPT, quantize=False, new=1):
    """A held prefill's payload, extracted through the engine's own plane."""
    rid = srv.submit(prompt, max_new_tokens=new, hold_kv=True)
    _until_done(srv, rid)
    assert srv.held_requests() == [rid] and srv.stats()["held_slots"] == 1
    srv.request_handoff(rid, quantize=quantize)
    srv.step()
    h = srv.take_handoff(rid)
    assert h is not None and srv.stats()["held_slots"] == 0
    return h


def _decode(srv, handoff, n=N_NEW):
    return _until_done(srv, srv.submit_prefilled(handoff, max_new_tokens=n))


@pytest.fixture(scope="module")
def ref():
    """JAX's payloads and streams, computed once: an fp pool's fp32 and
    int8 wires, an int8 pool's codes, each decoded by JAX's own batcher,
    and the plain stream of the whole request."""
    jfp, jq = _jax(), _jax(kv_quant=True)
    out = {"jfp": jfp, "jq": jq}
    out["fp"] = _prefill(jfp)
    out["int8_wire"] = _prefill(jfp, quantize=True)
    out["int8_pool"] = _prefill(jq)
    out["plain"] = _until_done(jfp, jfp.submit(PROMPT, max_new_tokens=N_NEW + 1))
    out["dec_fp"] = _decode(jfp, out["fp"])
    out["dec_q"] = _decode(jq, out["int8_pool"])
    return out


def _port_payload(kind):
    srv = _port(kv_quant=kind == "int8_pool")
    return _prefill(srv, quantize=kind == "int8_wire")


def _same_meta(a, b):
    for f in ("prompt", "emitted", "length", "n_layers", "n_kv_heads", "head_dim", "dtype",
              "quantized"):
        assert getattr(a, f) == getattr(b, f), f


@pytest.mark.parametrize("kind", ["fp", "int8_wire", "int8_pool"])
def test_wire_payload_equals_jax(ref, kind):
    """The port's payload is JAX's: the same metadata, K/V [L, T, KV, HD]
    (fp32 within 2e-4; int8 codes within one step and scales within 1e-5
    relative, [L, T, KV, 1]), and the same wire bytes."""
    got, want = _port_payload(kind), ref[kind]
    _same_meta(got, want)
    assert got.length == len(PROMPT) and got.emitted == ref["plain"][:1]
    L, KV, HD = MODEL[1].n_layers, MODEL[1].n_kv_heads, MODEL[1].head_dim
    assert got.k.shape == want.k.shape == (L, len(PROMPT), KV, HD)
    assert got.wire_bytes() == want.wire_bytes()
    for a, b, sa, sb in ((got.k, want.k, got.k_scale, want.k_scale),
                         (got.v, want.v, got.v_scale, want.v_scale)):
        if kind == "fp":
            assert a.dtype == np.float32 and sa is None
            np.testing.assert_allclose(a, b, rtol=0, atol=WIRE_TOL)
        else:
            assert a.dtype == np.int8 and sa.shape == (L, len(PROMPT), KV, 1)
            assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1
            np.testing.assert_allclose(sa, sb, rtol=1e-5, atol=0)


def test_payloads_cross_packages_token_identical(ref):
    """JAX's payload decoded by the port's batcher and the port's by JAX's
    continue the stream token for token: the fp32 wire into fp pools, the
    int8 pool's codes into int8 pools."""
    want = ref["plain"][1:]
    assert ref["dec_fp"] == want
    assert _decode(_port(), ref["fp"]) == want
    assert _decode(ref["jfp"], _port_payload("fp")) == want
    q = _decode(_port(kv_quant=True), ref["int8_pool"])
    assert q == ref["dec_q"]
    assert _decode(ref["jq"], _port_payload("int8_pool")) == q
    srv = _port()
    assert srv.stats()["handoffs_in"] == 0
    _decode(srv, ref["int8_wire"])
    assert srv.stats()["handoffs_in"] == 1


@pytest.mark.parametrize("wire_q", [False, True], ids=["fp_wire", "int8_wire"])
@pytest.mark.parametrize("pool_q", [False, True], ids=["fp_pool", "int8_pool"])
def test_handoff_to_cache_four_cases(ref, wire_q, pool_q):
    """The ingestion cache of each wire × pool case equals JAX's, with the
    port's [L, 1, KV, M, X] read as JAX's [L, 1, M, KV, X]: bucketed lanes,
    zero padding, the converted codes or values and their scales."""
    h = ref["int8_wire" if wire_q else "fp"]
    kw = dict(kv_quant=pool_q, chunk=16, max_lanes=64)
    got = tdis.handoff_to_cache(h, dtype=torch.float32, device="cpu", **kw)
    want = jdis.handoff_to_cache(h, dtype=jnp.float32, **kw)
    assert got.length == int(want.length) == h.length and got.max_len == 16
    assert got.quantized == pool_q
    for a, b in ((got.k, want.k), (got.v, want.v), (got.k_scale, want.k_scale),
                 (got.v_scale, want.v_scale)):
        if b is None:
            assert a is None
            continue
        np.testing.assert_array_equal(a.permute(0, 1, 3, 2, 4).numpy(), np.asarray(b))


@pytest.mark.parametrize("wire_q", [False, True], ids=["fp_wire", "int8_wire"])
@pytest.mark.parametrize("pool_q", [False, True], ids=["fp_pool", "int8_pool"])
def test_rebucket_equals_jax(ref, wire_q, pool_q):
    """``rebucket_handoff`` (and reshard's counted ``rebucket_for_pool``)
    to an unequal geometry gives JAX's payload; one longer than the lane
    budget raises JAX's message."""
    h = ref["int8_wire" if wire_q else "fp"]
    kw = dict(chunk=8, max_lanes=40, kv_quant=pool_q)
    trs._reset_stats_for_tests()
    got, want = trs.rebucket_for_pool(h, **kw), jdis.rebucket_handoff(h, **kw)
    _same_meta(got, want)
    for a, b in ((got.k, want.k), (got.v, want.v), (got.k_scale, want.k_scale),
                 (got.v_scale, want.v_scale)):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)
    st = trs.reshard_stats()
    assert st["kv_rebuckets_total"] == 1 and st["kv_rebucket_bytes_total"] == got.wire_bytes()
    with pytest.raises(ValueError) as t_err:
        tdis.rebucket_handoff(h, chunk=8, max_lanes=8, kv_quant=pool_q)
    with pytest.raises(ValueError) as j_err:
        jdis.rebucket_handoff(h, chunk=8, max_lanes=8, kv_quant=pool_q)
    assert str(t_err.value) == str(j_err.value)


def test_reshard_serving_half(ref):
    """``migrate_held_requests`` moves two held requests between engines
    (their continuations are the plain streams), ``migrate_prefix`` and
    ``rehydrate_from_host`` move a prefix entry; each package returns the
    same mapping sizes, wire bytes and counters."""
    results = {}
    for name, make, rs, pp in (("jax", _jax, jrs, jpp), ("port", _port, trs, tpp)):
        rs._reset_stats_for_tests()
        src, dst = make(), make()
        ids = [src.submit(p, max_new_tokens=1, hold_kv=True) for p in (PROMPT, PROMPT_B)]
        for rid in ids:
            _until_done(src, rid)
        moved = rs.migrate_held_requests(src, dst, max_new_tokens=4, now_s=0.5)
        streams = [_until_done(dst, d) for d in moved["mapping"].values()]
        rs.note_migrated_completions(len(streams))
        a, b = (make(max_len=64, prefix_cache_tokens=32) for _ in range(2))
        _until_done(a, a.submit(PROMPT_B, max_new_tokens=1))
        prefix = PROMPT_B[:16]
        tier = pp.HostKVTier(budget_bytes=1 << 20)
        tier.put(prefix, a.export_prefix(prefix), now=1.0)
        results[name] = dict(
            mapping=sorted(moved["mapping"]), migrated=moved["migrated"],
            wire_bytes=moved["wire_bytes"], mttr=moved["mttr_s"], streams=streams,
            held_after=src.held_requests(),
            prefix=(rs.migrate_prefix(a, b, prefix), rs.migrate_prefix(a, b, [9, 9, 9]),
                    rs.rehydrate_from_host(tier, prefix, make(prefix_cache_tokens=32), now=2.0),
                    rs.rehydrate_from_host(tier, [5, 6], b, now=2.0)),
            stats={k: v for k, v in rs.reshard_stats().items()
                   if k.startswith(("kv_", "migrations", "held_", "prefix_", "last_migration"))})
    assert results["port"] == results["jax"]
    assert results["port"]["prefix"] == (True, False, True, False)
    assert results["port"]["held_after"] == [] and results["port"]["migrated"] == 2


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the caller compares it
        return e
    return None


def test_guards_match_jax(ref):
    """Every refusal of the handoff plane, in JAX's order, type and words:
    ``hold_kv`` on a ring pool and with a draft, ``submit_prefilled`` on a
    ring pool, with a draft, off the resident invariant, at another
    geometry and past ``max_len``; ``request_handoff`` of an unknown or
    unheld request; a collect after a release; ``install_prefix`` of an
    empty prefix, at another geometry and off the payload's history."""
    import dataclasses

    window = _model(7, sliding_window=12)
    h = ref["fp"]
    cases = [
        ("hold_ring", lambda pkg: pkg(window, max_len=64).submit([1, 2], 1, hold_kv=True)),
        ("hold_draft", lambda pkg: pkg(draft_params=MODEL[3 if pkg is _port else 2],
                                       draft_cfg=MODEL[1 if pkg is _port else 0])
         .submit([1, 2], 1, hold_kv=True)),
        ("prefilled_ring", lambda pkg: pkg(window).submit_prefilled(h)),
        ("prefilled_draft", lambda pkg: pkg(draft_params=MODEL[3 if pkg is _port else 2],
                                            draft_cfg=MODEL[1 if pkg is _port else 0])
         .submit_prefilled(h)),
        ("invariant", lambda pkg: pkg().submit_prefilled(dataclasses.replace(h, length=12))),
        ("geometry", lambda pkg: pkg().submit_prefilled(dataclasses.replace(h, n_kv_heads=4))),
        ("max_len", lambda pkg: pkg().submit_prefilled(h, max_new_tokens=60)),
        ("unknown", lambda pkg: pkg().request_handoff(5)),
        ("not_held", lambda pkg: (lambda s: s.request_handoff(s.submit([1, 2], 1)))(pkg())),
        ("released", lambda pkg: (lambda s: (s.release_held(0), s.step(),
                                             s.request_handoff(0), s.step(),
                                             s.take_handoff(0)))(
            (lambda s: (s.submit([3, 4], 1, hold_kv=True), s.step(), s.step(), s)[-1])(pkg()))),
        ("prefix_empty", lambda pkg: pkg(prefix_cache_tokens=32).install_prefix([], h)),
        ("prefix_geometry", lambda pkg: pkg(prefix_cache_tokens=32).install_prefix(
            PROMPT[:4], dataclasses.replace(h, head_dim=8))),
        ("prefix_history", lambda pkg: pkg(prefix_cache_tokens=32).install_prefix(
            [7] + PROMPT[1:4], h)),
    ]
    for kind, call in cases:
        jerr, terr = _raised(lambda: call(_jax)), _raised(lambda: call(_port))
        assert jerr is not None, kind
        assert type(terr) is type(jerr) and str(terr) == str(jerr), (kind, terr, jerr)
    assert _port().install_prefix(PROMPT[:4], h) is False  # no prefix cache
    assert _port().export_prefix(PROMPT[:4]) is None
    with pytest.raises(TimeoutError, match="not extracted"):
        _port().wait_handoff(3, timeout=0.01)


# ---------------------------------------------------------------------------
# DisaggServingFleet over both packages' schedulers
# ---------------------------------------------------------------------------


class _Handoff:
    """The wire payload's fleet-facing surface."""

    def __init__(self, prompt, emitted):
        self.prompt, self.emitted = list(prompt), list(emitted)
        self.length = len(self.prompt) + len(self.emitted) - 1
        self.quantized = False

    def wire_bytes(self):
        return 64 * self.length


class GatedStubEngine:
    """An engine-free batcher surface for both packages' fleets: tokens
    are a function of the history's length (so a re-prefilled request
    repeats its stream), and a test can hold a role's engines at a phase
    (``HOLD[role]`` cleared): prefill results stay running, extraction
    yields nothing, decode results stay running."""

    HOLD = {"prefill": threading.Event(), "extract": threading.Event(),
            "decode": threading.Event()}

    def __init__(self, spec):
        self.role = spec.pool_role
        self.slots = int(spec.max_slots)
        self._reqs, self._handoffs = {}, {}
        self._seq = 0
        self.handoffs_out = self.handoffs_in = 0
        self._lock = threading.Lock()

    def _add(self, prompt, need, hold_kv, first_at=None):
        self._seq += 1
        self._reqs[self._seq] = {"prompt": list(prompt), "need": int(need), "tokens": [],
                                 "first_at": first_at, "hold_kv": hold_kv}
        return self._seq

    def submit(self, prompt, max_new_tokens=64, temperature=0.0, hold_kv=False):
        with self._lock:
            return self._add(prompt, max_new_tokens, bool(hold_kv))

    def submit_prefilled(self, handoff, max_new_tokens=64, temperature=0.0):
        with self._lock:
            self.handoffs_in += 1
            return self._add(list(handoff.prompt) + list(handoff.emitted), max_new_tokens,
                             False, first_at=time.time())

    def step(self):
        out = 0
        with self._lock:
            for r in self._reqs.values():
                if len(r["tokens"]) < r["need"]:
                    r["tokens"].append(len(r["prompt"]) + len(r["tokens"]))
                    r["first_at"] = r["first_at"] or time.time()
                    out += 1
        return out

    def result(self, rid):
        with self._lock:
            r = self._reqs[rid]
            held = not self.HOLD["prefill" if r["hold_kv"] else "decode"].is_set()
            done = len(r["tokens"]) >= r["need"] and not held
            return {"status": "done" if done else "running", "tokens": list(r["tokens"]),
                    "first_token_at": r["first_at"]}

    def request_handoff(self, rid, quantize=False):
        with self._lock:
            r = self._reqs[rid]
            if not r["hold_kv"]:
                raise ValueError(f"request {rid} was not submitted hold_kv")
            self._handoffs[rid] = _Handoff(r["prompt"], r["tokens"])

    def take_handoff(self, rid):
        with self._lock:
            if not self.HOLD["extract"].is_set():
                return None
            h = self._handoffs.pop(rid, None)
            self.handoffs_out += h is not None
            return h

    def stats(self):
        with self._lock:
            active = sum(1 for r in self._reqs.values() if len(r["tokens"]) < r["need"])
            return {"slots": self.slots, "active_slots": active, "prefilling": 0, "queued": 0,
                    "tokens_per_sec_recent": 100.0, "held_slots": len(self._handoffs),
                    "queued_handoffs": 0, "handoffs_out": self.handoffs_out,
                    "handoffs_in": self.handoffs_in}


class _TrainStub:
    """A training job that never runs (the fleets here submit none)."""

    def __init__(self, sub):
        raise AssertionError("no training job is submitted in these tests")


def _wait(pred, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


PKGS = {
    "jax": (jsched, jfleet, jdis, jtpu.TPUManager, {}),
    "port": (tsched, tfleet, tdis, ttpu.TPUManager, {"device": "cpu"}),
}


def _disagg_fleet(pkg, **kw):
    sched_mod, fleet_mod, dis_mod, manager, extra = PKGS[pkg]
    sched = sched_mod.FleetScheduler(max_concurrent_jobs=4, fleet_fn=manager.get_mock_fleet,
                                     job_factory=_TrainStub, poll_interval_s=0.01,
                                     grow_back_cooldown_s=0.0, **extra)

    def one():
        return fleet_mod.ReplicaAutoscaler(fleet_mod.AutoscalerConfig(
            min_replicas=1, max_replicas=1, scale_down_cooldown_s=1e9))

    spec = dict(model_name="gpt-tiny", max_slots=4, max_len=128)
    fleet = dis_mod.DisaggServingFleet(
        sched, fleet_mod.ServingReplicaSpec(**spec, inflight_handoffs=2),
        fleet_mod.ServingReplicaSpec(**spec), prefill_autoscaler=one(),
        decode_autoscaler=one(), engine_factory=GatedStubEngine, **kw)
    fleet.start()
    assert _wait(lambda: len(fleet.prefill.running_replicas()) == 1
                 and len(fleet.decode.running_replicas()) == 1)
    return sched, fleet


@pytest.fixture
def gates():
    for e in GatedStubEngine.HOLD.values():
        e.set()
    yield GatedStubEngine.HOLD
    for e in GatedStubEngine.HOLD.values():
        e.set()


def _counters(fleet):
    st = fleet.status()
    return {k: st[k] for k in ("requests_total", "completed_total", "failed_total",
                               "tokens_total", "handoffs_total", "handoff_bytes_total",
                               "reprefills_total", "pending_requests", "decoding_requests")}


def _pump_phases(fleet, fids, timeout=10.0):
    """Each request's phases, read after every pump, until all are
    terminal."""
    seen = {f: [fleet._requests[f]["phase"]] for f in fids}
    deadline = time.time() + timeout
    while time.time() < deadline:
        fleet.result(fids[0])  # one pump of every request
        for f in fids:
            if seen[f][-1] != fleet._requests[f]["phase"]:
                seen[f].append(fleet._requests[f]["phase"])
        if all(seen[f][-1] in ("done", "failed") for f in fids):
            return [seen[f] for f in fids]
        time.sleep(0.005)
    raise AssertionError(f"not terminal: {seen}")


def test_disagg_fleet_phase_machine_equals_jax(gates):
    """Three requests and a one-token request through both packages'
    fleets: every request is held at extracting, then the pump that takes
    its payload hands it off and routes it to decode (the handoff phase
    falls through), and the streams, replicas' roles and counters are
    JAX's."""
    got = {}
    for pkg in PKGS:
        sched, fleet = _disagg_fleet(pkg)
        try:
            gates["extract"].clear()  # each request is seen extracting
            fids = [fleet.submit_request([i, i + 1, i + 2], max_new_tokens=5)
                    for i in range(3)]
            assert _wait(lambda: all(fleet.result(f)["phase"] == "extracting" for f in fids))
            gates["extract"].set()
            phases = _pump_phases(fleet, fids)
            outs = [fleet.result(f) for f in fids]
            one = fleet.wait(fleet.submit_request([5, 6, 7], max_new_tokens=1), timeout=10.0)
            got[pkg] = dict(
                phases=phases, tokens=[o["tokens"] for o in outs],
                distinct=[o["prefill_replica"] != o["decode_replica"] for o in outs],
                one=(one["status"], one["tokens"], one["decode_replica"]),
                counters=_counters(fleet))
        finally:
            fleet.stop()
            sched.shutdown()
    assert got["port"] == got["jax"]
    assert got["port"]["phases"] == [["extracting", "decoding", "done"]] * 3
    assert got["port"]["counters"]["handoffs_total"] == 4


@pytest.mark.parametrize("phase,gate,pool", [("prefilling", "prefill", "prefill"),
                                             ("extracting", "extract", "prefill"),
                                             ("decoding", "decode", "decode")])
def test_replica_lost_at_each_phase(gates, phase, gate, pool):
    """A replica preempted (checkpoint-free, the scheduler's verb) while a
    request sits at ``phase`` re-prefills it from scratch on the
    re-admitted replica; both packages finish it with the same stream,
    one re-prefill and the same counters."""
    got = {}
    for pkg in PKGS:
        sched, fleet = _disagg_fleet(pkg)
        try:
            gates[gate].clear()
            fid = fleet.submit_request([4, 5, 6, 7], max_new_tokens=6)
            assert _wait(lambda: fleet.result(fid)["phase"] == phase)
            (sub,) = getattr(fleet, pool)._replicas.values()
            # The other pool's replica fills the one slot left, so the
            # requeued replica waits until the pump has seen it gone (a
            # replica readmitted under the same id between two pumps hides
            # an extraction's loss from the phase machine, in both packages).
            sched.max_concurrent_jobs = 1
            sub.job.watcher.simulate_interruption()
            assert _wait(lambda: fleet.result(fid)["redispatches"] == 1)
            sched.max_concurrent_jobs = 4
            gates[gate].set()
            out = fleet.wait(fid, timeout=10.0)
            assert _wait(lambda: sub.attempts == 2 and sub.state.value == "running")
            got[pkg] = dict(status=out["status"], tokens=out["tokens"],
                            redispatches=out["redispatches"], preemptions=sub.preemptions,
                            counters=_counters(fleet))
        finally:
            fleet.stop()
            sched.shutdown()
    assert got["port"] == got["jax"]
    assert got["port"]["status"] == "done" and got["port"]["redispatches"] == 1
    assert got["port"]["tokens"] == list(range(4, 10))


def test_handoff_plane_under_concurrent_clients():
    """Twelve client threads on a 2-slot prefill server and a 2-slot decode
    server, each served by ``serve_forever`` on its own thread, with a short
    switch interval: every held prefill is extracted exactly once, every
    payload decodes to the stream a plain server gives, and no slot stays
    held."""
    import sys

    prefill, decode = _port(), _port()
    prompts = [np.random.default_rng(40 + i).integers(1, 512, 5 + i).tolist()
               for i in range(12)]
    plain = _port()
    want = [_until_done(plain, plain.submit(p, max_new_tokens=4)) for p in prompts]
    stop, got, errors = threading.Event(), {}, []

    def client(i):
        try:
            rid = prefill.submit(prompts[i], max_new_tokens=1, hold_kv=True)
            first = prefill.wait(rid, timeout=60.0)["tokens"]
            prefill.request_handoff(rid)
            h = prefill.wait_handoff(rid, timeout=60.0)
            got[i] = first + decode.wait(decode.submit_prefilled(h, max_new_tokens=3),
                                         timeout=60.0)["tokens"]
        except Exception as e:  # noqa: BLE001 — reported by the assertion below
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    servers = [threading.Thread(target=s.serve_forever, args=(stop,), kwargs={"idle_sleep": 0.001})
               for s in (prefill, decode)]
    clients = [threading.Thread(target=client, args=(i,)) for i in range(len(prompts))]
    try:
        for t in servers + clients:
            t.start()
        for t in clients:
            t.join(timeout=120.0)
        assert not any(t.is_alive() for t in clients)
    finally:
        sys.setswitchinterval(old)
        stop.set()
        for t in servers:
            t.join(timeout=30.0)
    assert not errors and [got[i] for i in range(len(prompts))] == want
    assert prefill.handoffs_out == decode.handoffs_in == len(prompts)
    assert prefill.held_requests() == [] and not any(t.is_alive() for t in servers)


def test_handoff_plane_on_a_model_mesh(tmp_path):
    """The plane on a mesh of two ``gloo`` ranks (``tests/torch_mesh_worker.py``;
    qwen-tiny's two kv heads split, one a rank), rank 0 calling it:
    extraction gathers the heads whole (fp32 and int8 wires equal the
    one-device batcher's payloads), an inserted payload decodes the
    one-device stream, an exported prefix equals the one-device export, and
    an installed one serves a probe with the one-device first logits."""
    from torch_mesh_worker import spawn

    model = "qwen-tiny"
    flat = convert._flatten(jax.tree.map(np.asarray, jtfm.init_params(
        jax.random.PRNGKey(7), jtfm.MODEL_CONFIGS[model])))
    np.savez(tmp_path / "init.npz", **flat)
    cfg = tcfg.MODEL_CONFIGS[model]
    geom = dict(max_slots=2, max_len=96, prefill_chunk=16, prefill_pad_to=16,
                prefix_cache_tokens=64)

    def one():
        return tsrv.ContinuousBatcher({k: torch.tensor(v) for k, v in flat.items()}, cfg,
                                      compute_dtype=torch.float32, device="cpu", **geom)

    rng = np.random.default_rng(11)
    prompt, given_prompt, long_prompt = (rng.integers(1, 512, n).tolist() for n in (13, 21, 40))
    given = _prefill(one(), given_prompt)
    np.savez(tmp_path / "payload.npz", k=given.k, v=given.v)
    meta = {f: getattr(given, f) for f in ("prompt", "emitted", "length", "n_layers",
                                           "n_kv_heads", "head_dim", "dtype", "quantized")}
    install_key = given_prompt[:16]
    probe = install_key + rng.integers(1, 512, 7).tolist()
    case = {"name": "handoff", "kind": "handoff", "mesh": {"model": 2}, "model": model,
            "init": str(tmp_path / "init.npz"), "batcher": geom, "prompt": prompt,
            "long_prompt": long_prompt, "install_key": install_key, "probe": probe,
            "payload": str(tmp_path / "payload.npz"), "payload_meta": meta}
    got = spawn({"cases": [case]}, 2, tmp_path)
    ref = one()  # the same calls on one device
    wants = [_prefill(ref, prompt, quantize=q) for q in (False, True)]
    decoded = _decode(ref, given)
    _until_done(ref, ref.submit(long_prompt, max_new_tokens=1))
    key = max(ref._prefix_cache._entries, key=len)
    export = ref.export_prefix(list(key))
    installed = ref.install_prefix(install_key, given)
    first = []
    real = ref._first_token
    ref._first_token = lambda logits, req: first.append(logits.numpy().copy()) or real(logits, req)
    _until_done(ref, ref.submit(probe, max_new_tokens=1))
    r0, r1 = got[("handoff", 0)], got[("handoff", 1)]
    kv = cfg.n_kv_heads
    assert int(r0["kv_heads"]) == int(r1["kv_heads"]) == (kv // 2 if kv % 2 == 0 else kv)
    for q, want in enumerate(wants):
        assert r0[f"extract{q}:meta"].tolist() == [want.length, kv] + want.emitted
        if q == 0:
            np.testing.assert_allclose(r0["extract0:k"], want.k, rtol=0, atol=WIRE_TOL)
            np.testing.assert_allclose(r0["extract0:v"], want.v, rtol=0, atol=WIRE_TOL)
        else:
            for a, b in (("k", want.k), ("v", want.v)):
                assert np.abs(r0[f"extract1:{a}"].astype(np.int32) - b.astype(np.int32)).max() <= 1
            np.testing.assert_allclose(r0["extract1:k_scale"], want.k_scale, rtol=1e-5, atol=0)
    assert r0["decoded"].tolist() == decoded
    assert r0["export:key"].tolist() == list(key)
    np.testing.assert_allclose(r0["export:k"], export.k, rtol=0, atol=WIRE_TOL)
    assert bool(r0["installed"]) is installed is True
    np.testing.assert_allclose(r0["probe_first"], first[-1], rtol=0, atol=WIRE_TOL)
    assert int(r0["hits"]) == ref.stats()["prefix_cache"]["hits"] == 1
    assert r0["handoffs"].tolist() == [2, 1] and int(r0["held"]) == int(r1["held"]) == 0
