"""Port parity: ``tpu_engine_torch.serving.ContinuousBatcher`` (slot pool,
chunked decode and prefill, sampling, prefix cache, int8 pool, ring pool)
against ``tpu_engine.serving`` and the port's own ``generate``, on the CPU
in fp32, with the weights moved by ``params_from_jax``."""

import threading
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_engine import serving as jsrv  # noqa: E402
from tpu_engine.models import transformer as jtfm  # noqa: E402
from tpu_engine_torch import generate as tgen  # noqa: E402
from tpu_engine_torch import serving as tsrv  # noqa: E402
from tpu_engine_torch.models import config as tcfg  # noqa: E402
from tpu_engine_torch.models import convert  # noqa: E402

WINDOW = 12


def _model(seed: int, **over):
    jcfg = jtfm.MODEL_CONFIGS["gpt-tiny"].with_(**over)
    cfg = tcfg.MODEL_CONFIGS["gpt-tiny"].with_(**over)
    jp = jtfm.init_params(jax.random.PRNGKey(seed), jcfg, dtype=jnp.float32)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, cfg, jp, tp


@pytest.fixture(scope="module")
def llama():
    return _model(3)


@pytest.fixture(scope="module")
def gqa_window():
    return _model(5, n_kv_heads=2, sliding_window=WINDOW)


def _port(model, **kw):
    _, cfg, _, tp = model
    kw.setdefault("prefill_pad_to", 16)
    return tsrv.ContinuousBatcher(tp, cfg, compute_dtype=torch.float32, device="cpu", **kw)


def _jax(model, **kw):
    jcfg, _, jp, _ = model
    kw.setdefault("prefill_pad_to", 16)
    return jsrv.ContinuousBatcher(jp, jcfg, compute_dtype=jnp.float32, **kw)


def _drive(srv, plan, max_steps=200):
    """Submit ``plan``'s requests, each ``(at_step, prompt, max_new_tokens,
    temperature)``, before the step of that index, and step until all are
    terminal. Returns their token lists in plan order."""
    ids = [None] * len(plan)
    for n in range(max_steps):
        for i, (at, prompt, m, t) in enumerate(plan):
            if at == n:
                ids[i] = srv.submit(prompt, max_new_tokens=m, temperature=t)
        if all(r is not None and srv.result(r)["status"] in ("done", "failed") for r in ids):
            break
        srv.step()
    results = [srv.result(r) for r in ids]
    assert all(r["status"] == "done" for r in results), results
    return [r["tokens"] for r in results]


def _greedy(model, prompt, n, **kw):
    _, cfg, _, tp = model
    out = tgen.generate(tp, [prompt], cfg, n, compute_dtype=torch.float32, device="cpu", **kw)
    return out[0, len(prompt):].tolist()


def _prompts(seed, lengths, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).tolist() for n in lengths]


def test_staggered_requests_token_identical_to_jax(llama):
    """Three requests of different lengths on 2 slots, the third arriving
    mid-flight and taking a freed slot: the same submit/step sequence gives
    the same greedy streams as JAX's batcher, and as ``generate``."""
    p1, p2, p3 = _prompts(0, (7, 13, 3))
    plan = [(0, p1, 6, 0.0), (0, p2, 10, 0.0), (3, p3, 5, 0.0)]
    got = _drive(_port(llama, max_slots=2, max_len=96), plan)
    assert got == _drive(_jax(llama, max_slots=2, max_len=96), plan)
    for (_, p, m, _), toks in zip(plan, got):
        assert toks == _greedy(llama, p, m)


def test_chunk_steps_equal_per_step(llama):
    """Four tokens per dispatch (in-chunk feedback, overshoot trimmed, slot
    reuse after a finish inside a chunk) gives the per-step streams."""
    prompts = _prompts(21, (5, 9, 4, 11))
    plan = [(0, prompts[0], 3, 0.0), (0, prompts[1], 9, 0.0), (1, prompts[2], 6, 0.0),
            (2, prompts[3], 5, 0.0)]
    per_step = _drive(_port(llama, max_slots=2, max_len=96), plan)
    assert _drive(_port(llama, max_slots=2, max_len=96, chunk_steps=4), plan) == per_step
    assert per_step[1] == _greedy(llama, prompts[1], 9)


def test_long_prompt_chunked_prefill_equals_generate(llama):
    """A 90-token prompt ingested 32 tokens per step, interleaved with a
    short request's decode, gives ``generate``'s stream."""
    long_p, short_p = _prompts(5, (90, 4))
    srv = _port(llama, max_slots=2, max_len=192, prefill_chunk=32, chunk_steps=2)
    got = _drive(srv, [(0, short_p, 6, 0.0), (1, long_p, 5, 0.0)])
    assert got == [_greedy(llama, short_p, 6), _greedy(llama, long_p, 5)]


def test_eos_frees_slot_and_slot_reuse_stats(llama):
    """A stream stops at its first eos; one slot serves two requests in
    turn; ``stats`` counts them and shows no slot left busy."""
    ref = _greedy(llama, [1, 2, 3, 4], 8)
    eos = ref[2]
    srv = _port(llama, max_slots=1, max_len=64, eos_id=eos)
    got = _drive(srv, [(0, [1, 2, 3, 4], 8, 0.0), (0, [9, 10], 2, 0.0)])
    assert got[0] == ref[:ref.index(eos) + 1]
    assert got[1] == _greedy(llama, [9, 10], 2)[:len(got[1])]
    st = srv.stats()
    assert st["requests_total"] == 2 and st["tokens_generated"] == len(got[0]) + len(got[1])
    assert st["active_slots"] == st["queued"] == st["prefilling"] == 0


def test_mixed_greedy_and_sampled_rows_share_a_chunk(llama, monkeypatch):
    """A greedy and a sampled request decode in the same dispatches; the
    greedy stream is ``generate``'s and the sampled one repeats for the
    same seed and submission order."""
    calls = []
    real = tsrv.decode_chunk

    def spy(*args, **kw):  # (active rows, whether an active row samples)
        active, temps = args[3], args[4]
        calls.append((int(active.sum()), bool((temps[active] > 0).any())))
        return real(*args, **kw)

    monkeypatch.setattr(tsrv, "decode_chunk", spy)

    def run():
        srv = _port(llama, max_slots=2, max_len=64, chunk_steps=4, seed=7)
        return _drive(srv, [(0, [2, 3, 4], 12, 0.0), (0, [5, 6], 12, 0.8)])

    a = run()
    assert a[0] == _greedy(llama, [2, 3, 4], 12) and len(a[1]) == 12
    assert (2, True) in calls
    assert run() == a


def test_gumbel_noise_is_a_function_of_its_counter():
    """The sampling noise depends on each of (seed, request id, draw count,
    token) and on nothing else (a row's noise is the same in any batch),
    and it is standard Gumbel: mean 0.5772, variance pi**2 / 6."""
    ids, counts = torch.tensor([0, 1, 0, 0]), torch.tensor([0, 0, 1, 0])
    a = tsrv._gumbel_noise(7, ids, counts, 4096)
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[0], a[2])
    assert torch.equal(a[0], a[3]) and not torch.equal(a[0, :2048], a[0, 2048:])
    assert not torch.equal(a[0], tsrv._gumbel_noise(8, ids, counts, 4096)[0])
    assert torch.equal(tsrv._gumbel_noise(7, ids[2:3], counts[2:3], 4096)[0], a[2])
    big = tsrv._gumbel_noise(3, torch.arange(64), torch.zeros(64, dtype=torch.int64), 4096)
    assert abs(float(big.mean()) - 0.5772) < 0.01
    assert abs(float(big.var()) - np.pi ** 2 / 6) < 0.03


def test_gumbel_noise_is_finite_at_a_real_vocabulary():
    """Every 23-bit value the hash leaves gives u strictly inside (0, 1)
    and finite noise; at llama's vocabulary of 32000, a token of negligible
    probability is never drawn. Under seed 0, requests 2206 and 2340 (draw
    0) are rows where a 24-bit u rounds up to 1.0: noise +inf, which wins
    the argmax whatever the logit."""
    h = torch.arange(1 << 23, dtype=torch.int64) << 9
    for low in (0, 0x1FF):
        u = tsrv._uniform(h | low)
        assert float(u.min()) > 0.0 and float(u.max()) < 1.0
        assert torch.isfinite(torch.log(-torch.log(u))).all()
    ids = torch.arange(2200, 2400)
    zeros = torch.zeros_like(ids)
    assert torch.isfinite(tsrv._gumbel_noise(0, ids, zeros, 32000)).all()
    logits = torch.full((len(ids), 32000), -40.0)
    logits[:, 0] = 0.0
    picks = tsrv._pick_tokens(logits, torch.ones(len(ids)), ids, zeros, seed=0)
    assert (picks == 0).all()


def test_sampled_draws_follow_the_softmax():
    """Drawn over 20,000 draw counts, each token's frequency is its
    probability under softmax(logits / temperature), within 0.015."""
    logits = torch.tensor([[1.0, 0.0, -1.0, 2.0, 0.5]]).expand(20_000, 5)
    n = logits.shape[0]
    picks = tsrv._pick_tokens(logits, torch.full((n,), 0.8), torch.full((n,), 5),
                              torch.arange(n), seed=1)
    freq = torch.bincount(picks, minlength=5).float() / n
    np.testing.assert_allclose(freq.numpy(), torch.softmax(logits[0] / 0.8, -1).numpy(),
                               atol=0.015)


def test_sampled_stream_independent_of_batch_composition(llama):
    """A sampled request's stream depends on (seed, request id, its
    prompt), not on the requests beside it."""
    def stream(crowded):
        srv = _port(llama, max_slots=4, max_len=64, chunk_steps=3, seed=11)
        plan = [(0, [7, 8, 9], 6, 0.9)]
        if crowded:
            plan += [(0, [1, 2], 8, 0.0), (0, [3, 4, 5], 4, 0.5)]
        return _drive(srv, plan)[0]

    alone = stream(False)
    assert len(alone) == 6 and stream(True) == alone


def _record_first_logits(srv) -> dict:
    """Record, per request id, the prefill logits that seed its first token."""
    seen, real = {}, srv._first_token

    def first_token(logits, req):
        seen[req.id] = logits.numpy().copy()
        return real(logits, req)

    srv._first_token = first_token
    return seen


def test_prefix_cache_streams_and_hits_match_jax(llama):
    """Prompts sharing a 40-token system prefix, one diverging inside a
    chunk: streams with the prefix cache equal those without it and
    ``generate``'s, and the hits and reused tokens equal JAX's for the same
    submissions."""
    system = _prompts(11, (40,))[0]
    tails = _prompts(12, (5, 9, 3))
    prompts = [system + t for t in tails]
    prompts.append(system[:38] + [(system[38] + 1) % 512, 9, 10, 11])
    plan = [(i, p, 6, 0.0) for i, p in enumerate(prompts)]
    kw = dict(max_slots=2, max_len=128, prefill_chunk=16, chunk_steps=3)
    cold_srv, srv = _port(llama, **kw), _port(llama, prefix_cache_tokens=512, **kw)
    cold_logits, warm_logits = _record_first_logits(cold_srv), _record_first_logits(srv)
    cold = _drive(cold_srv, plan)
    assert _drive(srv, plan) == cold
    for rid, want in cold_logits.items():  # a hit's prefill resumes on pasted K/V
        np.testing.assert_allclose(warm_logits[rid], want, atol=1e-5, rtol=1e-5)
    jax_srv = _jax(llama, prefix_cache_tokens=512, **kw)
    assert _drive(jax_srv, plan) == cold
    st, jst = srv.stats()["prefix_cache"], jax_srv.stats()["prefix_cache"]
    assert st["hits"] >= 3
    for key in ("hits", "misses", "hit_tokens_total", "entries", "tokens"):
        assert st[key] == jst[key], key
    for p, toks in zip(prompts, cold):
        assert toks == _greedy(llama, p, 6)


def test_kv_quant_pool_equals_generate_kv_quant(llama):
    """The int8 pool gives ``generate(kv_quant=True)``'s streams."""
    prompts = _prompts(21, (5, 11, 3))
    srv = _port(llama, max_slots=2, max_len=96, chunk_steps=4, kv_quant=True)
    assert srv._cache.k.dtype == torch.int8 and srv.stats()["kv_quant"] is True
    got = _drive(srv, [(0, p, m, 0.0) for p, m in zip(prompts, (6, 9, 4))])
    for p, m, toks in zip(prompts, (6, 9, 4), got):
        assert toks == _greedy(llama, p, m, kv_quant=True)


def test_sliding_window_ring_pool_equals_generate(gqa_window):
    """A GQA sliding-window model serves from a per-row ring of window +
    prefill_chunk - 1 lanes, over prompts and generations that wrap it, and
    a third request reuses a freed ring slot: ``generate``'s streams."""
    srv = _port(gqa_window, max_slots=2, max_len=128, prefill_chunk=16, chunk_steps=3)
    assert srv._cache.ring and srv._cache.n_lanes == WINDOW + 16 - 1
    p1, p2, p3 = _prompts(9, (40, 7, 30))
    plan = [(0, p1, 20, 0.0), (0, p2, 9, 0.0), (2, p3, 8, 0.0)]
    got = _drive(srv, plan)
    for (_, p, m, _), toks in zip(plan, got):
        assert toks == _greedy(gqa_window, p, m)


def test_serve_forever_on_a_thread(llama):
    """The router's way: ``serve_forever`` on its own thread, ``wait`` and
    ``wait_tokens`` from this one; a clean stop fails what is left."""
    srv = _port(llama, max_slots=2, max_len=64, chunk_steps=2)
    stop = threading.Event()
    t = threading.Thread(target=srv.serve_forever, args=(stop,), daemon=True)
    t.start()
    try:
        rid = srv.submit([11, 12, 13], max_new_tokens=4)
        first = srv.wait_tokens(rid, have=0, timeout=60)
        assert len(first["tokens"]) >= 1
        got = srv.wait(rid, timeout=60)
        assert got["status"] == "done" and got["tokens"] == _greedy(llama, [11, 12, 13], 4)
        assert got["ttft_ms"] >= 0
    finally:
        stop.set()
        t.join(timeout=30)
    assert not t.is_alive()
    with pytest.raises(RuntimeError, match="server stopped"):
        srv.submit([1], max_new_tokens=1)


def test_failed_loop_rejects_new_submits(llama):
    """A step failure marks the in-flight request failed with the error and
    makes later submits raise."""
    srv = _port(llama, max_slots=1, max_len=64)
    rid = srv.submit([1, 2, 3], max_new_tokens=4)
    srv.step = lambda: (_ for _ in ()).throw(RuntimeError("card fell over"))
    t = threading.Thread(target=srv.serve_forever, args=(threading.Event(),), daemon=True)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    got = srv.result(rid)
    assert got["status"] == "failed" and "card fell over" in got["error"]
    with pytest.raises(RuntimeError, match="serving loop failed"):
        srv.submit([4, 5], max_new_tokens=2)


def test_slot_at_capacity_mid_chunk_matches_jax(llama):
    """A request that fills its slot to ``max_len`` finishes inside a
    4-token chunk and runs past the pool's last lane (JAX drops those
    writes; the port masks them): the streams, its neighbour's included,
    and a later request reusing the slot all equal JAX's."""
    p1, p2, p3 = _prompts(13, (25, 6, 10))
    plan = [(0, p1, 7, 0.0), (0, p2, 20, 0.0), (4, p3, 6, 0.0)]
    kw = dict(max_slots=2, max_len=32, chunk_steps=4)
    got = _drive(_port(llama, **kw), plan)
    assert len(got[0]) == 7
    assert got == _drive(_jax(llama, **kw), plan)
    assert got[0] == _greedy(llama, p1, 7)


def test_capacity_and_guards(llama, gqa_window):
    """JAX's ValueError guards, and NotImplementedError for what is not
    ported: a mesh with data=2 (the batcher runs on ranks of ``model``
    alone). Speculative serving is ported: a draft builds on llama, and a
    windowed model is refused with JAX's ``draft_ring_window``. The
    disaggregated-serving plane answers as JAX's does: ``hold_kv`` is
    taken, an unknown request is a ``KeyError``, nothing is held or
    extracted yet, and a server without a prefix cache neither exports nor
    installs one (``tests/test_torch_disagg.py`` holds the plane to JAX's)."""
    _, cfg, _, tp = llama
    srv = _port(llama, max_slots=1, max_len=32)
    with pytest.raises(ValueError, match="max_len"):
        srv.submit(list(range(1, 30)), max_new_tokens=10)
    with pytest.raises(ValueError, match="empty prompt"):
        srv.submit([], max_new_tokens=1)
    with pytest.raises(ValueError, match="sliding-window"):
        _port(gqa_window, max_slots=1, max_len=128, prefill_chunk=16, prefix_cache_tokens=64)
    with pytest.raises(NotImplementedError, match="data"):
        _port(llama, mesh=SimpleNamespace(axis_sizes=dict(data=2, fsdp=1, pipe=1, sequence=1,
                                                          model=1)))
    assert _port(llama, draft_params=tp, draft_cfg=cfg).stats()["speculative"] is True
    _, wcfg, _, wtp = gqa_window
    with pytest.raises(tsrv.SpecGeometryError, match="sliding-window") as info:
        _port(gqa_window, max_len=128, prefill_chunk=16, draft_params=wtp, draft_cfg=wcfg)
    assert info.value.kind == "draft_ring_window"
    held = srv.submit([1, 2], max_new_tokens=1, hold_kv=True)
    assert srv.held_requests() == [] and srv.stats()["held_slots"] == 0
    with pytest.raises(KeyError):
        srv.request_handoff(held + 1)
    assert srv.take_handoff(held) is None and srv.release_held(held) is None
    with pytest.raises(TimeoutError, match="not extracted"):
        srv.wait_handoff(held, timeout=0.01)
    assert srv.export_prefix([1, 2]) is None and srv.install_prefix([1, 2], None) is False
    with pytest.raises(AttributeError):
        srv.submit_prefilled(0)
    ring = tsrv.init_slot_cache(gqa_window[1], 2, 64, prefill_chunk=16, device="cpu")
    assert ring.ring and ring.n_lanes == WINDOW + 16 - 1 and ring.pos.shape == (2, 27)
