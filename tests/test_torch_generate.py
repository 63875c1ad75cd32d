"""Port parity: ``tpu_engine_torch.generate`` (KV cache, int8 cache,
sampling, speculative decoding) against ``tpu_engine.generate`` on the CPU.

Both packages start from the same numpy weights (``params_from_jax``) and
take the same numpy tokens, in fp32. Two models: gpt-tiny (llama arch,
MHA) and a GQA + sliding-window variant (2 kv heads, window 8), whose ring
caches wrap."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_engine.models import transformer as jtfm  # noqa: E402
from tpu_engine_torch import generate as tgen  # noqa: E402
from tpu_engine_torch.models import config as tcfg  # noqa: E402
from tpu_engine_torch.models import convert  # noqa: E402
from tpu_engine_torch.models import transformer as ttfm  # noqa: E402

# ``tpu_engine/__init__.py`` binds the name ``generate`` to the function.
jgen = importlib.import_module("tpu_engine.generate")

F32 = dict(compute_dtype=jnp.float32)
T32 = dict(compute_dtype=torch.float32)
TOL = dict(atol=2e-4, rtol=2e-4)   # tests/test_generate.py:41
WINDOW = 8


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


@pytest.fixture(params=["llama", "gqa_window"])
def model(request):
    return request.getfixturevalue(request.param)


def _tokens(B, S, seed=1):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(np.int32)


def _run_chunks(which, cfg, params, toks, chunks, **cache_kw):
    """Cached forward over ``toks`` chunk by chunk, in the JAX package
    (``which == "jax"``) or the port. Returns (logits per chunk as numpy,
    the final cache)."""
    B, S = toks.shape
    if which == "jax":
        cache = jgen.init_cache(cfg, B, S, dtype=jnp.float32, **cache_kw)
        fwc, arr, kw = jgen.forward_with_cache, jnp.asarray, F32
    else:
        cache = tgen.init_cache(cfg, B, S, dtype=torch.float32, device="cpu", **cache_kw)
        fwc, arr, kw = tgen.forward_with_cache, torch.from_numpy, T32
    out = []
    for t0, t1 in chunks:
        logits, cache = fwc(params, arr(toks[:, t0:t1]), cache, cfg, **kw)
        out.append(np.asarray(logits))
    return out, cache


def test_prefill_and_decode_logits_match_jax_and_forward(model):
    """Prefill of 5 tokens, then teacher-forced one-token decode: every
    position's logits within 2e-4 of JAX's cached forward and of the port's
    own full forward."""
    jcfg, cfg, jp, tp = model
    toks = _tokens(2, 16)
    chunks = [(0, 5)] + [(t, t + 1) for t in range(5, 16)]
    want, jcache = _run_chunks("jax", jcfg, jp, toks, chunks)
    got, tcache = _run_chunks("torch", cfg, tp, toks, chunks)
    full = ttfm.forward(tp, torch.from_numpy(toks), cfg, **T32).detach().numpy()
    for (t0, t1), g, w in zip(chunks, got, want):
        np.testing.assert_allclose(g, w, **TOL, err_msg=f"chunk {t0}:{t1} vs JAX")
        np.testing.assert_allclose(g, full[:, t0:t1], **TOL, err_msg=f"chunk {t0}:{t1} vs forward")
    assert tcache.length == int(jcache.length) == 16
    np.testing.assert_array_equal(tcache.pos.numpy(), np.asarray(jcache.pos))


def test_ring_cache_wrapping_chunks_match_jax(gqa_window):
    """A ring of window + 4 - 1 = 11 lanes fed 4-token chunks that wrap
    mid-chunk, and single tokens between: logits against JAX and the
    windowed full forward, and each lane's stored position against JAX."""
    jcfg, cfg, jp, tp = gqa_window
    toks = _tokens(2, 33, seed=2)
    chunks = [(0, 4), (4, 8), (8, 12), (12, 13), (13, 17), (17, 18), (18, 22), (22, 26),
              (26, 29), (29, 33)]
    want, jcache = _run_chunks("jax", jcfg, jp, toks, chunks, max_chunk=4)
    got, tcache = _run_chunks("torch", cfg, tp, toks, chunks, max_chunk=4)
    assert tcache.ring and tcache.max_len == WINDOW + 4 - 1 == jcache.max_len
    full = ttfm.forward(tp, torch.from_numpy(toks), cfg, **T32).detach().numpy()
    for (t0, t1), g, w in zip(chunks, got, want):
        np.testing.assert_allclose(g, w, **TOL, err_msg=f"chunk {t0}:{t1} vs JAX")
        np.testing.assert_allclose(g, full[:, t0:t1], **TOL, err_msg=f"chunk {t0}:{t1} vs forward")
    np.testing.assert_array_equal(tcache.pos.numpy(), np.asarray(jcache.pos))
    assert tcache.length == int(jcache.length) == 33


def test_quantize_rows_codes_and_scales_match_jax():
    """Codes equal JAX's, ties included (127 · k/2 rows round half to even),
    and scales within 1e-6."""
    rng = np.random.default_rng(4)
    rows = rng.standard_normal((3, 5, 2, 16)).astype(np.float32)
    rows[0, 0, 0] = np.concatenate([[127.0], np.arange(-7, 8) + 0.5])
    rows[0, 0, 1] = 0.0  # the 1e-8 scale floor
    jc, js = jgen._quantize_rows(jnp.asarray(rows))
    tc, ts = tgen._quantize_rows(torch.from_numpy(rows))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=0)
    assert set(tc[0, 0, 0, 1:].tolist()) >= {-6.0, 0.0, 2.0, 8.0}


def test_int8_cache_logits_match_jax(model):
    """The int8 cache through prefill and decode: logits within 2e-4 of
    JAX's int8 path, and within 2 % of max |logit| of the fp32 cache
    (tests/test_generate.py:372)."""
    jcfg, cfg, jp, tp = model
    toks = _tokens(2, 16, seed=3)
    chunks = [(0, 6)] + [(t, t + 1) for t in range(6, 16)]
    want, jcache = _run_chunks("jax", jcfg, jp, toks, chunks, kv_quant=True)
    got, tcache = _run_chunks("torch", cfg, tp, toks, chunks, kv_quant=True)
    fp, _ = _run_chunks("torch", cfg, tp, toks, chunks)
    assert tcache.k.dtype == torch.int8 and tcache.k_scale.shape == (2, 2, cfg.n_kv_heads, 16, 1)
    for g, w, f in zip(got, want, fp):
        np.testing.assert_allclose(g, w, **TOL)
        assert np.abs(g - f).max() < 0.02 * np.abs(f).max()
    np.testing.assert_array_equal(tcache.k.numpy(), np.moveaxis(np.asarray(jcache.k), 2, 3))


@pytest.mark.parametrize("kv_quant", [False, True])
def test_greedy_generate_token_identical_to_jax(model, kv_quant):
    """Greedy ``generate``: tokens identical to JAX's (on the windowed
    model the 8 + 20 tokens wrap a ring cache of 15 lanes)."""
    jcfg, cfg, jp, tp = model
    prompt = _tokens(2, 8, seed=5)
    want = np.asarray(jgen.generate(jp, jnp.asarray(prompt), jcfg, 20, kv_quant=kv_quant, **F32))
    got = tgen.generate(tp, prompt, cfg, 20, kv_quant=kv_quant, device="cpu", **T32)
    assert got.shape == (2, 28)
    np.testing.assert_array_equal(got.numpy(), want)


def test_speculative_generate_equals_greedy(model):
    """Speculative decoding equals greedy decoding (the port's and JAX's),
    with a perfect draft (the target itself: every round accepts all gamma
    proposals, 24 / 5 = 5 rounds, as in JAX) and a draft of other weights."""
    jcfg, cfg, jp, tp = model
    prompt = np.asarray([[3, 1, 4, 1, 5]], np.int32)
    greedy = tgen.generate(tp, prompt, cfg, 24, device="cpu", **T32).numpy()
    np.testing.assert_array_equal(
        greedy, np.asarray(jgen.generate(jp, jnp.asarray(prompt), jcfg, 24, **F32)))
    same, rounds = tgen.speculative_generate(tp, tp, prompt, cfg, cfg, 24, gamma=4,
                                             return_stats=True, device="cpu", **T32)
    np.testing.assert_array_equal(same.numpy(), greedy)
    assert rounds == 5
    draft = _model(9, n_kv_heads=cfg.n_kv_heads, sliding_window=cfg.sliding_window)[3]
    diff = tgen.speculative_generate(tp, draft, prompt, cfg, cfg, 24, gamma=3,
                                     device="cpu", **T32)
    np.testing.assert_array_equal(diff.numpy(), greedy)


@pytest.mark.parametrize("top_k,top_p", [(5, None), (None, 0.9), (7, 0.6), (1, None),
                                         (None, 1e-3)])
def test_filter_masks_match_jax(monkeypatch, top_k, top_p):
    """Temperature, top-k and top-p keep exactly the tokens JAX's
    ``_filtered_sample`` keeps, on random logits (JAX's draw is replaced by
    a read of its mask)."""
    logits = (3 * np.random.default_rng(6).standard_normal((4, 64))).astype(np.float32)
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, lg, axis=-1: lg > jgen._NEG_INF / 2)
    want = np.asarray(jgen._filtered_sample(jnp.asarray(logits), jax.random.PRNGKey(0), 0.7,
                                            top_k, top_p))
    masked = tgen._filter_logits(torch.from_numpy(logits), 0.7, top_k, top_p)
    np.testing.assert_array_equal((masked > tgen._NEG_INF / 2).numpy(), want.astype(bool))


def test_sampling_reproducible_for_a_generator_seed(llama):
    """A sampled stream repeats for the same generator seed and changes with
    it; top-k 1 sampling is greedy."""
    _, cfg, _, tp = llama
    prompt = _tokens(2, 6, seed=7)

    def run(seed, **kw):
        g = torch.Generator().manual_seed(seed)
        return tgen.generate(tp, prompt, cfg, 12, generator=g, temperature=0.9,
                             device="cpu", **T32, **kw).numpy()

    a = run(1)
    np.testing.assert_array_equal(a, run(1))
    assert not np.array_equal(a, run(2))
    np.testing.assert_array_equal(
        run(1, top_k=1), tgen.generate(tp, prompt, cfg, 12, device="cpu", **T32).numpy())
    picks = {int(tgen.sample_token(torch.tensor([[8.0, 4.0, 3.0, 2.0]]),
                                   torch.Generator().manual_seed(s), 1.0, top_p=0.5)[0])
             for s in range(20)}
    assert picks == {0}


def test_guards(llama, gqa_window):
    """A ring chunk larger than the ring allows, speculative batch > 1 and
    gamma < 1 raise ValueError, as in JAX; a config with int8 quantised
    training decodes as JAX's does (its MLP through the int8 product, its
    projections plain); qwen and MoE (which raised before they were
    ported) decode, MoE as forward with ragged dispatch (exact top-k)."""
    _, cfg, _, tp = llama
    _, wcfg, _, wtp = gqa_window
    toks = torch.from_numpy(_tokens(2, 8))
    ring = tgen.init_cache(wcfg, 2, 32, dtype=torch.float32, max_chunk=2, device="cpu")
    with pytest.raises(ValueError, match="cache slots"):
        tgen.forward_with_cache(wtp, toks[:, :4], ring, wcfg, **T32)
    with pytest.raises(ValueError, match="batch size 1"):
        tgen.speculative_generate(tp, tp, toks, cfg, cfg, 4, device="cpu", **T32)
    with pytest.raises(ValueError, match="gamma"):
        tgen.speculative_generate(tp, tp, toks[:1], cfg, cfg, 4, gamma=0, device="cpu", **T32)
    jcfg = llama[0].with_(quant_training="int8")
    want, _ = jgen.forward_with_cache(llama[2], jnp.asarray(toks.numpy()),
                                      jgen.init_cache(jcfg, 2, 8, dtype=jnp.float32), jcfg, **F32)
    got, _ = tgen.forward_with_cache(tp, toks, tgen.init_cache(cfg, 2, 8, dtype=torch.float32,
                                                               device="cpu"),
                                     cfg.with_(quant_training="int8"), **T32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    moe = tcfg.MODEL_CONFIGS["moe-tiny"]
    mp = ttfm.init_params(moe, torch.Generator().manual_seed(0), device="cpu")
    cache = tgen.init_cache(moe, 2, 8, dtype=torch.float32, device="cpu")
    logits, cache = tgen.forward_with_cache(mp, toks, cache, moe, **T32)
    ragged = ttfm.forward(mp, toks, moe.with_(moe_impl="ragged"), **T32)
    np.testing.assert_allclose(logits.numpy(), ragged.detach().numpy(), **TOL)
    qwen = tcfg.MODEL_CONFIGS["qwen-tiny"]
    qp = ttfm.init_params(qwen, torch.Generator().manual_seed(0), device="cpu")
    cache = tgen.init_cache(qwen, 2, 8, dtype=torch.float32, device="cpu")
    logits, cache = tgen.forward_with_cache(qp, toks, cache, qwen, **T32)
    np.testing.assert_allclose(logits.numpy(), ttfm.forward(qp, toks, qwen, **T32).detach().numpy(),
                               **TOL)
