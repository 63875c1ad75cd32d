"""Port parity: ``tpu_engine_torch.prefix_plane`` against
``tpu_engine.prefix_plane``.

The trie index, the host KV tier (byte ledger, reuse-driven eviction read
back from each package's own historian, the fallback without one),
``PrefixPlane``'s admissions, spills, ``route_hint`` and journal index, the
module counters of ``plane_stats`` and ``FleetRouter`` with a plane
attached run the same scripted calls in both packages on a fixed clock and
must agree exactly. On real tiny engines (gpt-tiny, fp32, JAX's weights
through ``params_from_jax``) a prefix exported from one port replica,
parked in the host tier (int8) and installed into another gives first
logits within 2e-4 of a cold server's, and the same streams as JAX's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_engine import hbm_estimate as jhbm  # noqa: E402
from tpu_engine import historian as jhist  # noqa: E402
from tpu_engine import prefix_plane as jpp  # noqa: E402
from tpu_engine import serving as jsrv  # noqa: E402
from tpu_engine import serving_fleet as jfleet  # noqa: E402
from tpu_engine.models import transformer as jtfm  # noqa: E402
from tpu_engine_torch import hbm_estimate as thbm  # noqa: E402
from tpu_engine_torch import historian as thist  # noqa: E402
from tpu_engine_torch import prefix_plane as tpp  # noqa: E402
from tpu_engine_torch import serving as tsrv  # noqa: E402
from tpu_engine_torch import serving_fleet as tfleet  # noqa: E402
from tpu_engine_torch.models import config as tcfg  # noqa: E402
from tpu_engine_torch.models import convert  # noqa: E402

PKGS = {"jax": (jpp, jhist, jfleet, jhbm), "port": (tpp, thist, tfleet, thbm)}


def _tier_script(pkg):
    pp, hist, _, _ = PKGS[pkg]
    out = []
    t = pp.PrefixTrieIndex()
    for p, h in (([1, 2], "a"), ([1, 2, 3, 4], "b"), ([1, 2, 3, 4], pp.HOST_HOLDER),
                 ([1, 5], "a"), ([9], "c")):
        t.insert(p, h)
    out += [t.longest_holders([1, 2, 3, 4, 5]), t.longest_holders([1, 2, 3], exclude={"a"}),
            t.n_prefixes, t.nodes, sorted(t.prefixes("a"))]
    t.remove([1, 2, 3, 4], "b")
    t.drop_holder("a")
    out += [t.longest_holders([1, 2, 3, 4]), t.n_prefixes, t.nodes]

    now = [0.0]
    tier = pp.HostKVTier(budget_bytes=250, historian=hist.MetricHistorian(),
                         clock=lambda: now[0], reuse_window_s=600.0)
    hot, cold = (1, 2, 3), (4, 5, 6)
    out += [tier.put(hot, nbytes=100, now=0.0), tier.put(cold, nbytes=100, now=1.0)]
    out += [tier.get(hot, now=t) for t in (2.0, 3.0, 4.0)] + [tier.get(cold, now=5.0)]
    out += [tier.put((7, 8, 9), nbytes=100, now=6.0), tier.contains(hot), tier.contains(cold),
            tier.put((1, 2, 3), nbytes=120), tier.put((3, 3), nbytes=251), tier.stats(),
            tier.pop((7, 8, 9)) is None, tier.stats()]

    class Deaf:
        def record(self, *a, **kw):
            raise RuntimeError("down")

        def query(self, *a, **kw):
            raise RuntimeError("down")

    deaf = pp.HostKVTier(budget_bytes=250, historian=Deaf(), clock=lambda: 0.0)
    deaf.put((1,), nbytes=100, now=0.0)
    deaf.put((2,), nbytes=100, now=1.0)
    for p, t_ in (((1,), 2.0), ((1,), 3.0), ((2,), 4.0)):
        deaf.get(p, now=t_)
    out += [deaf.put((3,), nbytes=100, now=5.0), deaf.contains((1,)), deaf.contains((2,)),
            pp.HostKVTier.prefix_label((4, 5, 6))]
    return out


def test_trie_and_host_tier_equal_jax():
    got, want = _tier_script("port"), _tier_script("jax")
    assert got == want
    assert got[-3:-1] == [True, False]  # the re-hit entry survives, the recent one goes


def _plane_script(pkg):
    pp, hist, fleet, _ = PKGS[pkg]
    pp._reset_stats_for_tests()
    h = hist.MetricHistorian()
    spilled = []

    def spill(prefix, rid):
        spilled.append((prefix, rid))
        return 64

    plane = pp.PrefixPlane(prefix_tokens=2, replica_prefix_budget=1, historian=h,
                           clock=lambda: 0.0, spill=spill,
                           host=pp.HostKVTier(budget_bytes=150, historian=h, clock=lambda: 0.0))
    out = []
    for prompt, rid, t in (([1, 1, 9], "r0", 0.0), ([1, 1, 8], "r0", 1.0),
                           ([2, 2, 9], "r0", 2.0), ([1, 1, 7], "r1", 3.0),
                           ([3, 3, 1], "r1", 4.0), ([4, 4], "r2", 5.0), ([4, 4, 2], "r3", 6.0),
                           ([5, 5], "r2", 7.0)):
        obs = plane.observe_admit(prompt, rid, now=t)
        out.append((obs["kind"], obs["prefix"], obs["payload"], obs["evicted"]))
        out.append(plane.route_hint(prompt + [0], {"r0": 4, "r1": 2, "r2": 0, "r3": 1}))
    out += [plane.host_prefix_for([1, 1, 5]), plane.store_host([6, 6], nbytes=100, now=8.0),
            plane.host_prefix_for([6, 6, 1]), plane.stats(), list(spilled)]
    plane.drop_replica("r1")
    state = plane.export_host_index()
    fresh = pp.PrefixPlane(prefix_tokens=2, historian=h, clock=lambda: 0.0)
    out += [plane.stats(), state, fresh.load_host_index(state), fresh.stats(),
            fresh.load_host_index("nope")]

    router = fleet.FleetRouter(affinity_tokens=2, prefix_plane=plane)
    router.update({"r0": {"tokens_per_sec": 10.0, "free_slots": 2, "slots": 4},
                   "r3": {"tokens_per_sec": 50.0, "free_slots": 4, "slots": 4}})
    out += [[router.route(p) for p in ([2, 2, 1], [4, 4, 1], [9, 9], [2, 2, 3], [4, 4])],
            router.stats()]
    router.update({"r3": {"tokens_per_sec": 50.0, "free_slots": 4, "slots": 4}})
    out += [plane.stats()["replicas_tracked"], pp.plane_stats()]
    return out


def test_plane_routing_spill_and_counters_equal_jax():
    got, want = _plane_script("port"), _plane_script("jax")
    assert got == want
    kinds = [step[0] for step in got[:16:2]]
    assert {"cold", "replica", "host"} <= set(kinds)
    assert got[-1]["host_stores_total"] > 0 and got[-1]["rehydrations_total"] > 0


def test_plan_host_tier_sizes_through_the_estimator():
    """The tier is sized through the port's estimator; an oversubscribed
    host budget raises ``HostBudgetExceeded`` with JAX's words."""
    kw = dict(model_name="llama-1b", max_slots=8, max_len=2048)
    tier = tpp.PrefixPlane.plan_host_tier(host_prefix_tokens=4096, host_budget_gib=1.0, **kw)
    assert tier.budget_bytes == 1 << 30
    with pytest.raises(thbm.HostBudgetExceeded) as t_err:
        tpp.PrefixPlane.plan_host_tier(host_prefix_tokens=1 << 20, host_budget_gib=0.5, **kw)
    with pytest.raises(jhbm.HostBudgetExceeded) as j_err:
        jpp.PrefixPlane.plan_host_tier(host_prefix_tokens=1 << 20, host_budget_gib=0.5, **kw)
    assert str(t_err.value) == str(j_err.value)
    with pytest.raises(ValueError, match="unknown model"):
        tpp.PrefixPlane.plan_host_tier("nope", 8, 2048, host_prefix_tokens=1,
                                       host_budget_gib=1.0)


GEOM = dict(max_slots=2, max_len=128, prefill_chunk=16, prefill_pad_to=16)
SYSTEM = np.random.default_rng(7).integers(1, 512, 40).tolist()
TAILS = ([9, 9], [8, 8, 8])


def _model():
    jcfg, cfg = jtfm.MODEL_CONFIGS["gpt-tiny"], tcfg.MODEL_CONFIGS["gpt-tiny"]
    jp = jtfm.init_params(jax.random.PRNGKey(5), jcfg, dtype=jnp.float32)
    return jcfg, cfg, jp, convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                                   device="cpu")


def _drain(srv, prompts, n=4):
    ids = [srv.submit(p, max_new_tokens=n) for p in prompts]
    for _ in range(200):
        if all(srv.result(i)["status"] == "done" for i in ids):
            break
        srv.step()
    return [srv.result(i)["tokens"] for i in ids]


def _first_logits(srv, prompt):
    """The prefill logits row that seeds a request's first token."""
    rows = []
    orig = srv._first_token

    def spy(logits, req):
        rows.append(logits.detach().clone())
        return orig(logits, req)

    srv._first_token = spy
    _drain(srv, [prompt], n=1)
    srv._first_token = orig
    return rows[0]


def test_export_install_prefix_on_real_engines():
    """A prefix exported from one port replica, parked in the host tier
    (quantized on store) and installed into a fresh replica: the payload
    equals JAX's export, the warm replica's first logits on a prompt that
    shares the prefix lie within 2e-4 of a cold replica's (the fp32 wire),
    and the streams equal JAX's, warm and cold."""
    jcfg, cfg, jp, tp = _model()

    def port(**kw):
        return tsrv.ContinuousBatcher(tp, cfg, compute_dtype=torch.float32, device="cpu",
                                      **{**GEOM, **kw})

    src, jsrc = port(prefix_cache_tokens=64), jsrv.ContinuousBatcher(
        jp, jcfg, compute_dtype=jnp.float32, prefix_cache_tokens=64, **GEOM)
    prompts = [SYSTEM + t for t in TAILS]
    ref = _drain(jsrc, prompts)
    assert _drain(src, prompts) == ref
    key = max(src._prefix_cache._entries, key=len)
    assert key in jsrc._prefix_cache._entries and len(key) == 32
    h, jh = src.export_prefix(list(key)), jsrc.export_prefix(list(key))
    assert (h.length, h.prompt, h.emitted, h.dtype) == (jh.length, jh.prompt, jh.emitted,
                                                        jh.dtype)
    np.testing.assert_allclose(h.k, jh.k, rtol=0, atol=2e-4)
    with pytest.raises(ValueError, match="resident invariant"):
        port().submit_prefilled(h)

    tier = tpp.HostKVTier(budget_bytes=1 << 20, historian=thist.MetricHistorian(),
                          clock=lambda: 0.0)
    assert tier.put(key, h) and tier.get(key).quantized
    warm, cold = port(prefix_cache_tokens=64), port(prefix_cache_tokens=64)
    assert warm.install_prefix(list(key), h) and warm.install_prefix(list(key), h)
    probe = SYSTEM + [5, 5, 5, 5]
    got, want = _first_logits(warm, probe), _first_logits(cold, probe)
    assert warm.stats()["prefix_cache"]["hits"] == 1
    assert cold.stats()["prefix_cache"]["hits"] == 0
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-4)
    assert _drain(warm, prompts) == ref
    q = port(prefix_cache_tokens=64, kv_quant=True)
    assert q.install_prefix(list(key), tier.get(key)) and len(_drain(q, prompts[:1])[0]) == 4
    assert port(prefix_cache_tokens=64).export_prefix([1, 2, 3]) is None
