"""Port parity: the Mixture-of-Experts model of ``tpu_engine_torch`` (dense
and ragged dispatch, the aux loss, training, MoE decode and serving)
against the JAX package on moe-tiny (D 16 heads, 4 experts, top 2), on the
CPU in fp32.

Both packages start from the same numpy weights (``params_from_jax``). The
router kernel is drawn at std 0.1 rather than JAX's init 0.02: a router at
init sends every token to its experts by probabilities a few 1e-5 apart,
where an fp32 rounding that differs between the packages flips a choice
(routing is discontinuous, and no tolerance covers a flip). Each test of
routed outputs asserts first that the gap between consecutive router
probabilities among the top k + 1 exceeds ``MARGIN`` on its data, so that a
flip cannot pass for a fault."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

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

jgen = importlib.import_module("tpu_engine.generate")

NAME = "moe-tiny"
F32, T32 = dict(compute_dtype=jnp.float32), dict(compute_dtype=torch.float32)
# The bounds of tests/test_torch_archs.py: fp32 logits, cached logits.
LOGITS_TOL = dict(atol=2e-5, rtol=2e-5)
CACHED_TOL = dict(atol=2e-4, rtol=2e-4)
AUX_RTOL = 1e-5
MARGIN = 1e-4
IMPLS = ["dense", "ragged"]


def _tree(seed: int = 0) -> dict:
    tree = jax.tree.map(np.asarray, jtfm.init_params(jax.random.PRNGKey(seed),
                                                     jtfm.MODEL_CONFIGS[NAME]))
    tree["layers"]["router"]["kernel"] = tree["layers"]["router"]["kernel"] * 5.0
    return tree


@pytest.fixture(scope="module")
def moe():
    tree = _tree()
    cfg = tcfg.MODEL_CONFIGS[NAME]
    return jtfm.MODEL_CONFIGS[NAME], cfg, tree, convert.params_from_jax(tree, cfg, device="cpu")


def _tokens(B, S, seed=1):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(np.int32)


class _Spy:
    """Wraps ``module.name`` and records every call's (args, result)."""

    def __init__(self, monkeypatch, module, name):
        self.calls = []
        real = getattr(module, name)

        def spy(*args, **kwargs):
            out = real(*args, **kwargs)
            self.calls.append((args, out))
            return out

        monkeypatch.setattr(module, name, spy)


def _assert_margins(probs_list, k):
    """Consecutive sorted router probabilities among the top k + 1 are more
    than MARGIN apart for every token of every recorded layer."""
    for probs in probs_list:
        top = torch.sort(probs.detach(), dim=-1, descending=True).values[..., :k + 1]
        gap = float((top[..., :-1] - top[..., 1:]).min())
        assert gap > MARGIN, f"router near-tie {gap:.2e} on this data: a flip is not a fault"


def _port_forward(monkeypatch, params, tokens, cfg, **kw):
    """The port's forward with every layer's router probabilities checked
    against MARGIN."""
    spy = _Spy(monkeypatch, ttfm, "_router_probs")
    logits, aux = ttfm.forward_and_aux(params, torch.from_numpy(tokens).long(), cfg, **kw)
    _assert_margins([out for _, out in spy.calls], cfg.top_k)
    return logits, aux


# -- parameters -----------------------------------------------------------------


def test_init_params_match_jax_tree_and_scales():
    """JAX's tree and shapes (router [L, D, E], gate/up [L, E, D, F], down
    [L, E, F, D]) and its scales: router and gate/up at 0.02, down at
    0.02/sqrt(2L)."""
    cfg = tcfg.MODEL_CONFIGS[NAME]
    params = ttfm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    jtree = jax.eval_shape(lambda k: jtfm.init_params(k, jtfm.MODEL_CONFIGS[NAME]),
                           jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in convert._flatten(jtree).items()} == {
        k: tuple(v.shape) for k, v in params.items()}
    assert tuple(params["layers.gate.kernel"].shape) == (2, 4, 64, 128)
    for key, std in (("router", 0.02), ("gate", 0.02), ("up", 0.02), ("down", 0.01)):
        got = float(params[f"layers.{key}.kernel"].detach().std())
        assert got == pytest.approx(std, rel=0.1), key
    assert ttfm.param_count(cfg) == jtfm.param_count(jtfm.MODEL_CONFIGS[NAME])
    assert ttfm.active_param_count(cfg) == jtfm.active_param_count(jtfm.MODEL_CONFIGS[NAME])


def test_arch_moe_pairs_outside_the_configs_raise():
    """gpt2 with experts keeps raising (JAX builds dense gpt2 parameters for
    it, and its block then looks for a router); qwen and gemma with experts
    have JAX's trees; the HF bridge refuses MoE as JAX does."""
    with pytest.raises(NotImplementedError):
        convert.param_keys(tcfg.MODEL_CONFIGS[NAME].with_(arch="gpt2"))
    for arch in ("qwen", "gemma"):
        jc = jtfm.MODEL_CONFIGS[f"{arch}-tiny"].with_(n_experts=4, top_k=2)
        jtree = jax.eval_shape(lambda k, c=jc: jtfm.init_params(k, c), jax.random.PRNGKey(0))
        cfg = tcfg.MODEL_CONFIGS[f"{arch}-tiny"].with_(n_experts=4, top_k=2)
        assert set(convert.param_keys(cfg)) == set(convert._flatten(jtree))
        with pytest.raises(ValueError, match="MoE"):
            convert.hf_config_from(cfg)
    with pytest.raises(ValueError, match="MoE"):
        convert.hf_config_from(tcfg.MODEL_CONFIGS[NAME])
    with pytest.raises(ValueError, match="MoE"):
        convert.from_hf_llama({}, tcfg.MODEL_CONFIGS[NAME], device="cpu")


# -- forward -------------------------------------------------------------------


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_logits_and_aux_match_jax(moe, impl, monkeypatch):
    jc, cfg, tree, params = moe
    tokens = _tokens(2, 64)
    ref, ref_aux = jtfm.forward_and_aux(tree, jnp.asarray(tokens), jc.with_(moe_impl=impl), **F32)
    out, aux = _port_forward(monkeypatch, params, tokens, cfg.with_(moe_impl=impl), **T32)
    assert tuple(out.shape) == (2, 64, 512) and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **LOGITS_TOL)
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=AUX_RTOL)
    assert 0.5 < float(aux) < 4.0


def _layer_input(params, cfg, tokens):
    """Layer 0's normed MLP input h [B, S, D] and its parameters."""
    lp = {k: t[0] for k, t in ttfm.cast_layer_stack(params, torch.float32).items()}
    x = ttfm.embed_tokens(params, tokens, torch.float32, cfg=cfg)
    pos = torch.arange(tokens.shape[1]).expand(tokens.shape)
    q, k, v = ttfm._qkv(ttfm._norm(x, lp["attn_norm.scale"], None, cfg), lp, cfg, pos)
    x = x + ttfm._layer_proj(ttfm._attention(q, k, v, "xla").reshape(x.shape), lp, "o")
    h = ttfm._norm(x, lp["mlp_norm.scale"], None, cfg).detach()
    return h, lp


def test_dense_kept_masks_match_jax_with_drops(moe, monkeypatch):
    """capacity_factor 0.5 (8 slots an expert for 32 tokens of top 2 of 4):
    tokens drop. JAX's ``_moe_mlp`` and the port's on the same layer input
    give the same combine tensor [B, S, E, C] (read at the final product):
    the same kept (token, expert, slot) triples, first choices placed
    before second choices, and the same renormalised gates."""
    jc, cfg, tree, params = moe
    cfg, jc = cfg.with_(capacity_factor=0.5), jc.with_(capacity_factor=0.5)
    h, lp = _layer_input(params, cfg, torch.from_numpy(_tokens(2, 32, seed=2)).long())
    _assert_margins([ttfm._router_probs(h, lp)], cfg.top_k)
    jlp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["layers"])
    jspy = _Spy(monkeypatch, jnp, "einsum")
    want, want_aux = jtfm._moe_mlp(jnp.asarray(h.numpy()), jlp, jc)
    monkeypatch.undo()
    tspy = _Spy(monkeypatch, torch, "einsum")
    got, got_aux = ttfm._moe_mlp(h, lp, cfg)
    jcomb = np.asarray([a for a, _ in jspy.calls if a[0] == "bsec,ebcd->bsd"][0][1])
    tcomb = [a for a, _ in tspy.calls if a[0] == "bsec,ebcd->bsd"][0][1].detach().numpy()
    C = cfg.expert_capacity(32)
    assert tcomb.shape == jcomb.shape == (2, 32, 4, C) == (2, 32, 4, 8)
    kept = tcomb > 0
    np.testing.assert_array_equal(kept, jcomb > 0)
    assert 0 < kept.sum() < 2 * 32 * 2, "no token dropped: the test needs drops"
    np.testing.assert_allclose(tcomb, jcomb, atol=1e-6)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=AUX_RTOL)


def test_ragged_routes_match_jax(moe, monkeypatch):
    """The ragged path's routed indices and gates (top k of the router
    probabilities) equal JAX's, and so does its output."""
    jc, cfg, tree, params = moe
    h, lp = _layer_input(params, cfg, torch.from_numpy(_tokens(2, 32, seed=3)).long())
    _assert_margins([ttfm._router_probs(h, lp)], cfg.top_k)
    jlp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["layers"])
    jspy = _Spy(monkeypatch, jax.lax, "top_k")
    want, _ = jtfm._moe_mlp_ragged(jnp.asarray(h.numpy()), jlp, jc)
    monkeypatch.undo()
    tspy = _Spy(monkeypatch, torch, "topk")
    got, _ = ttfm._moe_mlp_ragged(h, lp, cfg)
    (jvals, jidx), (tvals, tidx) = jspy.calls[0][1], tspy.calls[0][1]
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tvals.detach().numpy(), np.asarray(jvals), atol=1e-6)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6, rtol=1e-5)


def test_ragged_equals_dense_when_nothing_drops(moe, monkeypatch):
    """capacity_factor E/k gives capacity S: no token can drop, and dense
    dispatch computes ragged's function (logits and aux)."""
    _, cfg, _, params = moe
    tokens = _tokens(2, 48, seed=4)
    dense, dense_aux = _port_forward(monkeypatch, params, tokens,
                                     cfg.with_(capacity_factor=2.0), **T32)
    assert cfg.with_(capacity_factor=2.0).expert_capacity(48) == 48
    ragged, ragged_aux = _port_forward(monkeypatch, params, tokens,
                                       cfg.with_(moe_impl="ragged"), **T32)
    np.testing.assert_allclose(ragged.detach().numpy(), dense.detach().numpy(), **LOGITS_TOL)
    np.testing.assert_allclose(float(ragged_aux), float(dense_aux), rtol=AUX_RTOL)


def test_moe_impl_errors_as_jax():
    """JAX's errors: an unknown moe_impl (ValueError at the forward), a
    moe_impl override on a dense model (ValueError at build). Ragged MoE
    with int8 training of the "moe" group is JAX's ValueError, at the
    forward and at build."""
    jc, cfg = jtfm.MODEL_CONFIGS[NAME], tcfg.MODEL_CONFIGS[NAME]
    toks = _tokens(1, 8)
    with pytest.raises(ValueError, match="moe_impl"):
        jtfm.forward(jtfm.init_params(jax.random.PRNGKey(0), jc), jnp.asarray(toks),
                     jc.with_(moe_impl="sparse"), **F32)
    params = ttfm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="moe_impl"):
        ttfm.forward(params, torch.from_numpy(toks).long(), cfg.with_(moe_impl="sparse"), **T32)
    kw = dict(model_name="gpt-tiny", micro_batch_size=1, seq_len=16, moe_impl="dense")
    with pytest.raises(ValueError, match="dense model"):
        jtrain.build_train_program(TPUTrainConfig(mesh=MeshConfig(data=1), **kw),
                                   runtime=MeshRuntime(MeshConfig(data=1),
                                                       devices=jax.devices()[:1]))
    with pytest.raises(ValueError, match="dense model"):
        ttrain.build_train_program(ttrain.TrainConfig(**kw), device="cpu")
    with pytest.raises(ValueError, match="moe_impl"):
        ttrain.TrainConfig(model_name=NAME, moe_impl="sparse")
    int8 = cfg.with_(moe_impl="ragged", quant_training="int8")
    with pytest.raises(ValueError, match="ragged"):
        jtfm.forward(jtfm.init_params(jax.random.PRNGKey(0), jc), jnp.asarray(toks),
                     jc.with_(moe_impl="ragged", quant_training="int8"), **F32)
    with pytest.raises(ValueError, match="ragged"):
        ttfm.forward(params, torch.from_numpy(toks).long(), int8, **T32)
    with pytest.raises(ValueError, match="ragged"):
        ttrain.build_train_program(ttrain.TrainConfig(model_name=NAME, quant_training="int8"),
                                   model_cfg=cfg.with_(moe_impl="ragged"), device="cpu")


# -- gradients and training ------------------------------------------------------


@pytest.mark.parametrize("impl", IMPLS)
def test_gradients_match_jax(moe, impl, monkeypatch):
    """Every parameter's gradient of mean(logits²) + aux, fp32, against
    ``jax.grad`` (the bound of tests/test_torch_archs.py against the
    largest gradient); every expert's kernels get a nonzero gradient, and
    the router one from both terms."""
    jc, cfg, tree, params = moe
    jc, cfg = jc.with_(moe_impl=impl), cfg.with_(moe_impl=impl)
    tokens = _tokens(2, 32, seed=5)

    def loss(p):
        logits, aux = jtfm.forward_and_aux(p, jnp.asarray(tokens), jc, **F32)
        return jnp.mean(jnp.square(logits)) + aux

    want = convert._flatten(jax.grad(loss)(jax.tree.map(jnp.asarray, tree)))
    for p in params.values():
        p.grad = None
    logits, aux = _port_forward(monkeypatch, params, tokens, cfg, **T32)
    (logits.square().mean() + aux).backward()
    assert set(want) == set(params)
    for k, p in params.items():
        w = np.asarray(want[k])
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=5e-4 * np.abs(w).max(),
                                   err_msg=k)
    for name in ("gate", "up", "down"):
        per_expert = params[f"layers.{name}.kernel"].grad.abs().sum(dim=(0, 2, 3))
        assert bool((per_expert > 0).all()), (name, per_expert)
    for p in params.values():
        p.grad = None


_STEPS = 4


@pytest.mark.parametrize("impl,accum", [("dense", 1), ("dense", 2), ("ragged", 1),
                                        ("ragged", 2)])
def test_training_trajectory_matches_jax(impl, accum):
    """Four AdamW steps from the same weights on the same batches, with the
    aux loss in the objective (weighted 1/accum over microbatches): loss
    and gradient norm within rtol 1e-4, the bound of
    tests/test_torch_archs.py. The held-out loss (no aux) agrees too."""
    kw = dict(model_name=NAME, micro_batch_size=2, gradient_accumulation_steps=accum,
              seq_len=32, precision="fp32", attention_impl="xla", learning_rate=1e-3,
              min_lr=1e-4, warmup_steps=2, total_steps=8, weight_decay=0.1,
              activation_checkpointing=True, moe_impl=impl)
    rng = np.random.default_rng(6)
    batches = [rng.integers(0, 512, (accum, 2, 32)).astype(np.int32) for _ in range(_STEPS)]
    jcfg = TPUTrainConfig(mesh=MeshConfig(data=1), **kw)
    jprog = jtrain.build_train_program(jcfg, runtime=MeshRuntime(jcfg.mesh,
                                                                 devices=jax.devices()[:1]))
    assert jprog.model_config.moe_impl == impl
    init = _tree()
    jstate = jprog.init(jax.random.PRNGKey(0))
    jstate["params"] = jax.device_put(jax.tree.map(jnp.asarray, init),
                                      jax.tree.map(lambda a: a.sharding, jstate["params"]))
    prog = ttrain.build_train_program(ttrain.TrainConfig(**kw), device="cpu")
    assert prog.model_config.moe_impl == impl
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
    held = batches[0]
    want = float(jprog.eval_step(jstate, jax.device_put(jnp.asarray(held),
                                                        jprog.batch_sharding)))
    got = float(prog.eval_step(state, torch.tensor(held, dtype=torch.long)))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    # The training loss is the held-out loss plus router_aux_coef · aux.
    toks = torch.tensor(held[0], dtype=torch.long)
    with torch.no_grad():
        train = prog.loss_fn(state["params"], toks)
        plain = prog.loss_fn(state["params"], toks, include_aux=False)
        _, aux = ttfm.forward_and_aux(state["params"], toks, prog.model_config, **T32)
    np.testing.assert_allclose(float(train - plain), 0.01 * float(aux), rtol=1e-4)


# -- generation and serving ------------------------------------------------------


def test_cached_logits_match_jax_and_forward(moe):
    """Prefill of 5 tokens, then teacher-forced one-token decode through
    MoE decode (every expert, renormalised top-k gates): every position's
    logits against JAX's cached forward and the port's ragged forward
    (exact top-k, as decode)."""
    jc, cfg, tree, params = moe
    toks = _tokens(2, 12, seed=7)
    jcache = jgen.init_cache(jc, 2, 12, dtype=jnp.float32)
    tcache = tgen.init_cache(cfg, 2, 12, dtype=torch.float32, device="cpu")
    full = ttfm.forward(params, torch.from_numpy(toks).long(), cfg.with_(moe_impl="ragged"),
                        **T32).detach().numpy()
    for t0, t1 in [(0, 5)] + [(t, t + 1) for t in range(5, 12)]:
        want, jcache = jgen.forward_with_cache(tree, jnp.asarray(toks[:, t0:t1]), jcache, jc,
                                               **F32)
        got, tcache = tgen.forward_with_cache(params, torch.from_numpy(toks[:, t0:t1]), tcache,
                                              cfg, **T32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **CACHED_TOL)
        np.testing.assert_allclose(got.numpy(), full[:, t0:t1], **CACHED_TOL)


def test_greedy_generate_token_identical_to_jax(moe):
    jc, cfg, tree, params = moe
    prompt = _tokens(2, 8, seed=8)
    want = np.asarray(jgen.generate(tree, jnp.asarray(prompt), jc, 16, **F32))
    got = tgen.generate(params, prompt, cfg, 16, device="cpu", **T32)
    np.testing.assert_array_equal(got.numpy(), want)


def _drive(srv, plan, max_steps=200):
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


def test_batcher_plan_token_identical_to_jax(moe):
    """Three greedy requests on 2 slots, the third arriving mid-flight, two
    tokens a dispatch, with a 2-layer MoE draft beside: the plain batcher's
    and the speculative batcher's streams equal JAX's."""
    jc, cfg, tree, params = moe
    rng = np.random.default_rng(9)
    p1, p2, p3 = (rng.integers(1, 512, n).tolist() for n in (7, 13, 3))
    plan = [(0, p1, 6), (0, p2, 9), (3, p3, 5)]
    kw = dict(max_slots=2, max_len=64, prefill_pad_to=16, chunk_steps=2)
    jtree = jax.tree.map(jnp.asarray, tree)
    got = _drive(tsrv.ContinuousBatcher(params, cfg, device="cpu", **T32, **kw), plan)
    want = _drive(jsrv.ContinuousBatcher(jtree, jc, **F32, **kw), plan)
    assert got == want
    draft = _tree(seed=1)
    spec = dict(kw, spec_gamma=3)
    got = _drive(tsrv.ContinuousBatcher(
        params, cfg, device="cpu", draft_params=convert.params_from_jax(draft, cfg, device="cpu"),
        draft_cfg=cfg, **T32, **spec), plan)
    want = _drive(jsrv.ContinuousBatcher(jtree, jc, draft_params=jax.tree.map(jnp.asarray, draft),
                                         draft_cfg=jc, **F32, **spec), plan)
    assert got == want

