"""Port parity: speculative serving (``decode_verify``, ``speculative_round``
and the ``ContinuousBatcher``'s draft pool) against ``tpu_engine.serving``
on the CPU in fp32, gpt-tiny with the weights moved by ``params_from_jax``.

Streams are held token-identical to JAX's speculative batcher and to the
port's plain greedy batcher, and the acceptance to JAX's round by round:
an off-by-one in the draft's extra step or in the rewind leaves streams
exact but cuts acceptance."""

from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_engine import serving as jsrv  # noqa: E402
from tpu_engine.models import transformer as jtfm  # noqa: E402
from tpu_engine_torch import generate as tgen  # noqa: E402
from tpu_engine_torch import serving as tsrv  # noqa: E402
from tpu_engine_torch.models import config as tcfg  # noqa: E402
from tpu_engine_torch.models import convert  # noqa: E402

jgen = __import__("importlib").import_module("tpu_engine.generate")

GAMMA = 3
SPEC_KEYS = ("spec_rounds", "spec_tokens_accepted", "spec_tokens_proposed", "spec_accept_rate")


def _model(seed: int, **over):
    jcfg = jtfm.MODEL_CONFIGS["gpt-tiny"].with_(**over)
    cfg = tcfg.MODEL_CONFIGS["gpt-tiny"].with_(**over)
    jp = jtfm.init_params(jax.random.PRNGKey(seed), jcfg, dtype=jnp.float32)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, cfg, jp, tp


@pytest.fixture(scope="module")
def target():
    return _model(3)


@pytest.fixture(scope="module")
def weak():
    """A 1-layer draft from another seed: exactness must not need a good draft."""
    return _model(9, name="draft-tiny", n_layers=1)


@pytest.fixture(scope="module")
def close(target):
    """The target's weights plus N(0, 0.003) noise: a draft that is accepted
    to every depth from 1 to gamma + 1."""
    jcfg, cfg, jp, _ = target
    rng = np.random.default_rng(0)
    noisy = jax.tree.map(lambda a: a + 0.003 * rng.standard_normal(a.shape).astype(np.float32),
                         jax.tree.map(np.asarray, jp))
    return jcfg, cfg, jax.tree.map(jnp.asarray, noisy), convert.params_from_jax(noisy, cfg,
                                                                                device="cpu")


def _drafts(target, weak):
    return {"weak": weak, "perfect": target}


def _port(model, draft=None, **kw):
    _, cfg, _, tp = model
    kw.setdefault("prefill_pad_to", 16)
    if draft is not None:
        kw.update(draft_params=draft[3], draft_cfg=draft[1], spec_gamma=GAMMA)
    return tsrv.ContinuousBatcher(tp, cfg, compute_dtype=torch.float32, device="cpu", **kw)


def _jax(model, draft=None, **kw):
    jcfg, _, jp, _ = model
    kw.setdefault("prefill_pad_to", 16)
    if draft is not None:
        kw.update(draft_params=draft[2], draft_cfg=draft[0], spec_gamma=GAMMA)
    return jsrv.ContinuousBatcher(jp, jcfg, compute_dtype=jnp.float32, **kw)


def _drive(srv, plan, max_steps=200):
    """Submit ``plan``'s requests, each ``(at_step, prompt, max_new_tokens)``,
    before the step of that index, and step until all are done. Returns
    their token lists in plan order."""
    ids = [None] * len(plan)
    for n in range(max_steps):
        for i, (at, prompt, m) in enumerate(plan):
            if at == n:
                ids[i] = srv.submit(prompt, max_new_tokens=m)
        if all(r is not None and srv.result(r)["status"] in ("done", "failed") for r in ids):
            break
        srv.step()
    results = [srv.result(r) for r in ids]
    assert all(r["status"] == "done" for r in results), results
    return [r["tokens"] for r in results]


def _prompts(seed, lengths, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).tolist() for n in lengths]


def _pools(model, prompts, M):
    """Both packages' slot pools (fp32, M lanes) with prompt i ingested into
    slot i by a single-row prefill, as the batcher inserts it."""
    jcfg, cfg, jp, tp = model
    jpool = jsrv.init_slot_cache(jcfg, len(prompts), M, jnp.float32)
    tpool = tsrv.init_slot_cache(cfg, len(prompts), M, torch.float32, device="cpu")
    for slot, p in enumerate(prompts):
        c1 = jgen.init_cache(jcfg, 1, len(p), dtype=jnp.float32)
        _, c1 = jgen.forward_with_cache(jp, jnp.asarray([p], jnp.int32), c1, jcfg,
                                        compute_dtype=jnp.float32)
        jpool = jsrv._insert_prefill(jpool, c1, jnp.asarray(slot),
                                     jnp.asarray(len(p), jnp.int32), False)
        t1 = tgen.init_cache(cfg, 1, len(p), dtype=torch.float32, device="cpu")
        _, t1 = tgen.forward_with_cache(tp, torch.tensor([p]), t1, cfg,
                                        compute_dtype=torch.float32)
        tsrv._insert_prefill(tpool, t1, slot, len(p))
    return jpool, tpool


def test_decode_verify_logits_match_jax(target):
    """Chains of 5 tokens on 3 slots, one inactive and one whose chain runs
    past the pool's last lane (JAX drops those writes; the port sends them
    to the last lane with its final value): logits within 2e-4 of JAX's,
    lengths advanced by T on active rows, and the pools equal after."""
    M, T = 40, 5
    prompts = _prompts(1, (7, 38, 12))
    jpool, tpool = _pools(target, prompts, M)
    chain = np.random.default_rng(2).integers(1, 512, (3, T))
    active = np.array([True, True, False])
    jcfg, cfg, jp, tp = target
    jverify = jax.jit(partial(jsrv.decode_verify, cfg=jcfg, compute_dtype=jnp.float32))
    jl, jpool = jverify(jp, jnp.asarray(chain, jnp.int32), jpool, jnp.asarray(active))
    tl, tpool = tsrv.decode_verify(tp, torch.tensor(chain), tpool, torch.tensor(active), cfg,
                                   compute_dtype=torch.float32)
    assert tl.shape == (3, T, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-4, rtol=0)
    assert tpool.lengths.tolist() == np.asarray(jpool.lengths).tolist() == [12, 43, 12]
    for got, want in ((tpool.k, jpool.k), (tpool.v, jpool.v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 1, 3, 2, 4),
                                   atol=2e-5, rtol=0)


def test_speculative_round_matches_jax_round_by_round(target, close):
    """Six rounds from the same target and draft pools, one slot of four
    inactive: each round's target choices and accepted counts equal JAX's,
    and so do both pools' lengths after the rewind."""
    prompts = _prompts(4, (6, 11, 9, 14))
    jpool, tpool = _pools(target, prompts, 64)
    jdraft, tdraft = _pools(close, prompts, 64)
    active = np.array([True, False, True, True])
    toks = np.array([p[-1] for p in prompts])
    jround = jax.jit(partial(jsrv.speculative_round, cfg=target[0], draft_cfg=close[0],
                             gamma=GAMMA, compute_dtype=jnp.float32))
    seen = set()
    for _ in range(6):
        jt, jn, jpool, jdraft = jround(target[2], close[2], jnp.asarray(toks, jnp.int32), jpool,
                                       jdraft, jnp.asarray(active))
        tt, tn, tpool, tdraft = tsrv.speculative_round(
            target[3], close[3], torch.tensor(toks), tpool, tdraft, torch.tensor(active),
            target[1], close[1], GAMMA, compute_dtype=torch.float32)
        jt, jn = np.asarray(jt), np.asarray(jn)
        np.testing.assert_array_equal(tt.numpy()[active], jt[active])
        np.testing.assert_array_equal(tn.numpy()[active], jn[active])
        for jc, tc in ((jpool, tpool), (jdraft, tdraft)):
            assert tc.lengths.tolist() == np.asarray(jc.lengths).tolist()
        seen.update(jn[active].tolist())
        toks = np.where(active, jt[np.arange(4), jn - 1], toks)
    assert seen == set(range(1, GAMMA + 2))  # every depth of acceptance occurs


@pytest.mark.parametrize("draft", ["weak", "perfect"])
def test_batcher_streams_and_acceptance_equal_jax_and_greedy(target, weak, draft):
    """Staggered admission on 2 slots, a third and fourth request reusing
    freed slots, and an eos that falls inside a round: the streams equal
    JAX's speculative batcher's and the port's plain greedy batcher's, and
    the rounds and accepted counts in ``stats()`` equal JAX's."""
    d = _drafts(target, weak)[draft]
    p1, p2, p3, p4 = _prompts(31, (6, 11, 4, 9))
    eos = _drive(_port(target, max_slots=1, max_len=96), [(0, p1, 12)])[0][5]
    plan = [(0, p1, 12), (0, p2, 13), (6, p3, 5), (7, p4, 10)]
    kw = dict(max_slots=2, max_len=96, eos_id=eos)
    spec = _port(target, d, **kw)
    got = _drive(spec, plan)
    jspec = _jax(target, d, **kw)
    assert got == _drive(jspec, plan)
    assert got == _drive(_port(target, **kw), plan)
    assert got[0][-1] == eos and len(got[0]) == 6  # stopped inside a round
    st, jst = spec.stats(), jspec.stats()
    assert st["speculative"] is True and st["active_slots"] == 0
    assert {k: st[k] for k in SPEC_KEYS} == {k: jst[k] for k in SPEC_KEYS}
    assert st["spec_accept_rate"] > (0.9 if draft == "perfect" else 0.0)
    assert spec._draft_cache.lengths.tolist() == [0, 0]


def test_slot_at_capacity_matches_jax(target, weak):
    """A request that fills its slot to ``max_len``: its last chains run past
    the pool's last lane in both pools. Streams, its neighbour's and a
    later request's in the same slot included, and acceptance equal JAX's;
    the full stream equals ``generate``."""
    p1, p2, p3 = _prompts(13, (25, 6, 10))
    plan = [(0, p1, 7), (0, p2, 20), (4, p3, 6)]
    kw = dict(max_slots=2, max_len=32)
    for d in (weak, target):
        spec, jspec = _port(target, d, **kw), _jax(target, d, **kw)
        got = _drive(spec, plan)
        assert got == _drive(jspec, plan)
        assert {k: spec.stats()[k] for k in SPEC_KEYS} == {k: jspec.stats()[k]
                                                          for k in SPEC_KEYS}
    out = tgen.generate(target[3], [p1], target[1], 7, compute_dtype=torch.float32, device="cpu")
    assert got[0] == out[0, len(p1):].tolist()


def test_int8_pool_speculative_equals_plain_int8(target):
    """Speculative rounds on an int8 target pool (the verify write quantises
    T rows at once; stale scale lanes stay masked after the rewind) give the
    plain int8 batcher's streams, as in JAX."""
    prompts = _prompts(8, (5, 3))
    plan = [(0, prompts[0], 8), (0, prompts[1], 8)]
    kw = dict(max_slots=2, max_len=64, kv_quant=True)
    spec = _port(target, target, **kw)
    assert _drive(spec, plan) == _drive(_port(target, chunk_steps=2, **kw), plan)
    assert spec.stats()["spec_accept_rate"] > 0.9


def _raised(fn):
    with pytest.raises(Exception) as info:
        fn()
    return info.value


def _draft_kw(make, draft, **cfg_over):
    """``draft`` as one package's batcher arguments, its config changed by
    ``cfg_over``."""
    jcfg, cfg, jp, tp = draft
    if make is _port:
        return dict(draft_params=tp, draft_cfg=cfg.with_(**cfg_over))
    return dict(draft_params=jp, draft_cfg=jcfg.with_(**cfg_over))


def test_guards_raise_as_jax(target, weak):
    """Every ``SpecGeometryError`` kind, the prefix-cache refusal and the
    submit guards raise JAX's type, message, kind and reason, in JAX's
    order: a speculative server refuses sampling, ``hold_kv`` and
    ``submit_prefilled`` with ``ValueError`` before the port's
    ``NotImplementedError`` for the handoff plane."""
    windowed = _model(5, sliding_window=8)

    def no_cfg(make):
        kw = _draft_kw(make, weak)
        del kw["draft_cfg"]
        return make(target, max_len=64, **kw)

    cases = [
        ("draft_cfg_missing", no_cfg),
        ("draft_vocab_mismatch",
         lambda make: make(target, max_len=64, **_draft_kw(make, weak, vocab_size=64))),
        ("draft_ring_window",
         lambda make: make(windowed, max_len=64, prefill_chunk=16, **_draft_kw(make, weak))),
        ("draft_ring_window",
         lambda make: make(target, max_len=64, **_draft_kw(make, weak, sliding_window=8))),
        ("spec_gamma_invalid",
         lambda make: make(target, max_len=64, spec_gamma=0, **_draft_kw(make, weak))),
        (None, lambda make: make(target, weak, max_len=64, prefix_cache_tokens=64)),
    ]
    for kind, build in cases:
        jerr, terr = _raised(lambda: build(_jax)), _raised(lambda: build(_port))
        assert isinstance(terr, ValueError) and str(terr) == str(jerr), kind
        if kind is None:
            assert type(terr) is type(jerr) is ValueError
        else:
            assert isinstance(terr, tsrv.SpecGeometryError)
            assert terr.kind == jerr.kind == kind and terr.reason == jerr.reason
    jspec, spec = _jax(target, weak, max_len=64), _port(target, weak, max_len=64)
    for call in (lambda s: s.submit([1, 2], max_new_tokens=2, temperature=0.7),
                 lambda s: s.submit([1, 2], max_new_tokens=2, hold_kv=True)):
        jerr, terr = _raised(lambda: call(jspec)), _raised(lambda: call(spec))
        assert type(terr) is type(jerr) is ValueError and str(terr) == str(jerr)
    with pytest.raises(ValueError, match="speculative"):
        spec.submit_prefilled(None)
    with pytest.raises(NotImplementedError):
        _port(target, max_len=64).submit_prefilled(None)
