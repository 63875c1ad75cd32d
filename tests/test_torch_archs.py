"""Port parity: the gpt2, qwen and gemma archs of ``tpu_engine_torch``
(forward, gradients, training, generation and serving) against the JAX
package on gpt2-tiny, qwen-tiny and gemma-tiny, on the CPU in fp32.

Both packages start from the same numpy weights (``params_from_jax``). The
norm scales and biases, which JAX initialises to constants, are moved off
them at random so that each one (gemma's offset from 1, gpt2's biases, qwen's
q/k norms) changes the result."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_engine import serving as jsrv  # noqa: E402
from tpu_engine import train as jtrain  # noqa: E402
from tpu_engine.mesh_runtime import MeshConfig, MeshRuntime  # noqa: E402
from tpu_engine.models import transformer as jtfm  # noqa: E402
from tpu_engine.sharding import TPUTrainConfig  # noqa: E402
from tpu_engine_torch import generate as tgen  # noqa: E402
from tpu_engine_torch import serving as tsrv  # noqa: E402
from tpu_engine_torch import train as ttrain  # noqa: E402
from tpu_engine_torch.models import config as tcfg  # noqa: E402
from tpu_engine_torch.models import convert  # noqa: E402
from tpu_engine_torch.models import transformer as ttfm  # noqa: E402

# ``tpu_engine/__init__.py`` binds the name ``generate`` to the function.
jgen = importlib.import_module("tpu_engine.generate")

ARCHS = ["gpt2-tiny", "qwen-tiny", "gemma-tiny"]
F32, T32 = dict(compute_dtype=jnp.float32), dict(compute_dtype=torch.float32)
# fp32 logits: the same arithmetic in other summation orders (the llama
# bound of tests/test_torch_transformer.py); cached logits: the bound of
# tests/test_generate.py:41.
LOGITS_TOL = dict(atol=2e-5, rtol=2e-5)
CACHED_TOL = dict(atol=2e-4, rtol=2e-4)
# gpt2's k bias has an exactly zero gradient: it shifts every key of a head
# by one vector, which shifts all of a query's scores by one constant, and
# softmax ignores that. Both packages compute rounding noise for it (about
# 1e-12 against gradients of 1e-3), so it is held to zero, not to JAX's
# noise; and Adam, which divides by the noise's own size, moves it by noise.
ZERO_GRAD = "layers.k.bias"


def _tree(name: str, seed: int) -> dict:
    """JAX's init for ``name``, with every norm scale and bias moved by
    normal(0, 0.1)."""
    tree = jtfm.init_params(jax.random.PRNGKey(seed), jtfm.MODEL_CONFIGS[name])
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        a = np.asarray(a, np.float32)
        if path[-1].key in ("scale", "bias"):
            a = a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(perturb, tree)


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    name = request.param
    tree = _tree(name, 0)
    cfg = tcfg.MODEL_CONFIGS[name]
    return jtfm.MODEL_CONFIGS[name], cfg, tree, convert.params_from_jax(tree, cfg, device="cpu")


def _tokens(B, S, seed=1, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


# -- parameters ----------------------------------------------------------------


@pytest.mark.parametrize("name", ARCHS)
def test_init_params_match_jax_tree_and_scales(name):
    """The port's init makes JAX's tree, shapes and constant leaves: gpt2's
    biases and position table, qwen's q/k norms, gemma's zero norm scales
    and untied-head-free tree."""
    cfg = tcfg.MODEL_CONFIGS[name]
    params = ttfm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    jtree = jax.eval_shape(lambda k: jtfm.init_params(k, jtfm.MODEL_CONFIGS[name]),
                           jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in convert._flatten(jtree).items()} == {
        k: tuple(v.shape) for k, v in params.items()}
    scale = 0.0 if cfg.arch == "gemma" else 1.0
    assert torch.all(params["final_norm.scale"] == scale)
    assert torch.all(params["layers.mlp_norm.scale"] == scale)
    assert float(params["layers.q.kernel"].detach().std()) == pytest.approx(0.02, rel=0.1)
    assert ("lm_head.kernel" in params) == (cfg.arch == "qwen")
    if cfg.arch == "gpt2":
        assert torch.all(params["layers.fc.bias"] == 0)
        assert float(params["pos_embed.embedding"].detach().std()) == pytest.approx(0.01, rel=0.1)


def test_decay_mask_spares_biases_scales_and_tables():
    cfg = tcfg.MODEL_CONFIGS["gpt2-tiny"]
    params = ttfm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    decay = ttrain.kernel_decay_mask(params)
    assert {k for k, d in decay.items() if d} == {
        f"layers.{n}.kernel" for n in ("q", "k", "v", "o", "fc", "proj")}


# -- forward and gradients -------------------------------------------------------


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_forward_logits_match_jax(arch, impl):
    jc, cfg, tree, params = arch
    tokens = _tokens(2, 64)
    ref = jtfm.forward(tree, jnp.asarray(tokens), jc, **F32)
    out = ttfm.forward(params, torch.tensor(tokens, dtype=torch.long),
                       cfg.with_(attention_impl=impl), remat=impl == "flash", **T32)
    assert out.dtype == torch.float32 and tuple(out.shape) == (2, 64, jc.vocab_size)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **LOGITS_TOL)


def test_bf16_forward_close_to_jax(arch):
    """bf16 compute: both round at the same places (gemma's embedding scale
    rounded to bf16 first); logits of magnitude ~1 agree to bf16 resolution,
    the bound of tests/test_torch_transformer.py."""
    jc, cfg, tree, params = arch
    tokens = _tokens(2, 64, seed=2)
    ref = jtfm.forward(tree, jnp.asarray(tokens), jc, compute_dtype=jnp.bfloat16)
    out = ttfm.forward(params, torch.tensor(tokens, dtype=torch.long), cfg,
                       compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=3e-2, rtol=3e-2)


def test_gradients_match_jax(arch):
    """Every parameter's gradient of the mean squared logit, fp32: the tied
    head's table (gpt2, gemma) sums the gather's and the head's gradients;
    the bound is the fp32 backward bound of tests/test_flash_attention.py
    against the largest gradient."""
    jc, cfg, tree, params = arch
    tokens = _tokens(2, 32, seed=3)

    def loss(p):
        return jnp.mean(jnp.square(jtfm.forward(p, jnp.asarray(tokens), jc, **F32)))

    want = convert._flatten(jax.grad(loss)(jax.tree.map(jnp.asarray, tree)))
    for p in params.values():
        p.grad = None
    ttfm.forward(params, torch.tensor(tokens, dtype=torch.long), cfg,
                 **T32).square().mean().backward()
    assert set(want) == set(params)
    top = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for k, p in params.items():
        w = np.asarray(want[k])
        if k == ZERO_GRAD:  # zero in both, to 1e-6 of the largest gradient
            assert np.abs(w).max() < 1e-6 * top and p.grad.abs().max() < 1e-6 * top
            continue
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=5e-4 * np.abs(w).max(),
                                   err_msg=k)


def test_gpt2_position_table_bounds_the_sequence():
    """gpt2's learned positions: a sequence past ``max_seq_len`` raises in
    forward, generation and the batcher, as in JAX."""
    cfg = tcfg.MODEL_CONFIGS["gpt2-tiny"]
    params = ttfm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="learned position table"):
        ttfm.forward(params, torch.zeros((1, 320), dtype=torch.long), cfg, **T32)
    cache = tgen.init_cache(cfg, 1, 300, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="learned position table"):
        tgen.forward_with_cache(params, torch.zeros((1, 4), dtype=torch.long), cache, cfg, **T32)
    with pytest.raises(ValueError, match="learned position table"):
        tsrv.ContinuousBatcher(params, cfg, max_slots=1, max_len=300, device="cpu", **T32)


# -- training --------------------------------------------------------------------

_STEPS = 4


def _train_kw(name):
    return dict(model_name=name, micro_batch_size=2, gradient_accumulation_steps=2, seq_len=32,
                precision="fp32", attention_impl="xla", learning_rate=1e-3, min_lr=1e-4,
                warmup_steps=2, total_steps=8, weight_decay=0.1, activation_checkpointing=True)


@pytest.mark.parametrize("name", ARCHS)
def test_training_trajectory_matches_jax(name):
    """Four AdamW steps over two microbatches each, from the same weights on
    the same batches: loss and gradient norm within rtol 1e-4 and the final
    weights within 1e-6, the bounds of tests/test_torch_train.py (weight
    decay on kernels only, as JAX's mask). gpt2's k bias (``ZERO_GRAD``)
    moves by Adam-scaled noise alone: held within 1e-5 of its init in both
    packages (measured 7e-7)."""
    kw = _train_kw(name)
    rng = np.random.default_rng(4)
    batches = [rng.integers(0, 512, (2, 2, 32)).astype(np.int32) for _ in range(_STEPS)]
    jcfg = TPUTrainConfig(mesh=MeshConfig(data=1), **kw)
    jprog = jtrain.build_train_program(jcfg, runtime=MeshRuntime(jcfg.mesh,
                                                                 devices=jax.devices()[:1]))
    jstate = jprog.init(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, jstate["params"])
    prog = ttrain.build_train_program(ttrain.TrainConfig(**kw), device="cpu")
    state = prog.init(params=convert.params_from_jax(init, prog.model_config, device="cpu"))
    jl, jn, tl, tn = [], [], [], []
    for b in batches:
        jstate, m = jprog.step(jstate, jax.device_put(jnp.asarray(b), jprog.batch_sharding))
        jl.append(float(m["loss"]))
        jn.append(float(m["grad_norm"]))
        state, m = prog.step(state, torch.tensor(b, dtype=torch.long))
        tl.append(float(m["loss"]))
        tn.append(float(m["grad_norm"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    np.testing.assert_allclose(tn, jn, rtol=1e-4)
    want = convert._flatten(jax.tree.map(np.asarray, jstate["params"]))
    start = convert._flatten(init)
    for k, p in state["params"].items():
        got = p.detach().numpy()
        if k == ZERO_GRAD:
            assert np.abs(got - start[k]).max() < 1e-5 and np.abs(want[k] - start[k]).max() < 1e-5
            continue
        np.testing.assert_allclose(got, want[k], atol=1e-6, rtol=0, err_msg=k)


# -- generation and serving --------------------------------------------------------


def test_cached_logits_match_jax_and_forward(arch):
    """Prefill of 5 tokens, then teacher-forced one-token decode: every
    position's logits against JAX's cached forward and the port's forward
    (gpt2's position rows at the decode offsets)."""
    jc, cfg, tree, params = arch
    toks = _tokens(2, 12, seed=5)
    chunks = [(0, 5)] + [(t, t + 1) for t in range(5, 12)]
    jcache = jgen.init_cache(jc, 2, 12, dtype=jnp.float32)
    tcache = tgen.init_cache(cfg, 2, 12, dtype=torch.float32, device="cpu")
    full = ttfm.forward(params, torch.from_numpy(toks), cfg, **T32).detach().numpy()
    for t0, t1 in chunks:
        want, jcache = jgen.forward_with_cache(tree, jnp.asarray(toks[:, t0:t1]), jcache, jc,
                                               **F32)
        got, tcache = tgen.forward_with_cache(params, torch.from_numpy(toks[:, t0:t1]), tcache,
                                              cfg, **T32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **CACHED_TOL)
        np.testing.assert_allclose(got.numpy(), full[:, t0:t1], **CACHED_TOL)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_greedy_generate_token_identical_to_jax(arch, kv_quant):
    jc, cfg, tree, params = arch
    prompt = _tokens(2, 8, seed=6)
    want = np.asarray(jgen.generate(tree, jnp.asarray(prompt), jc, 16, kv_quant=kv_quant, **F32))
    got = tgen.generate(params, prompt, cfg, 16, kv_quant=kv_quant, device="cpu", **T32)
    np.testing.assert_array_equal(got.numpy(), want)


def _drive(srv, plan, max_steps=200):
    """Submit each ``(at_step, prompt, max_new_tokens)`` of ``plan`` before
    that step and step until every request is done; their token lists."""
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


def test_batcher_plan_token_identical_to_jax(arch):
    """Three greedy requests on 2 slots, the third arriving mid-flight, two
    tokens a dispatch: the same submit/step plan gives JAX's streams."""
    jc, cfg, tree, params = arch
    rng = np.random.default_rng(7)
    p1, p2, p3 = (rng.integers(1, 512, n).tolist() for n in (7, 13, 3))
    plan = [(0, p1, 6), (0, p2, 9), (3, p3, 5)]
    kw = dict(max_slots=2, max_len=64, prefill_pad_to=16, chunk_steps=2)
    got = _drive(tsrv.ContinuousBatcher(params, cfg, device="cpu", **T32, **kw), plan)
    want = _drive(jsrv.ContinuousBatcher(jax.tree.map(jnp.asarray, tree), jc, **F32, **kw),
                  plan)
    assert got == want
