"""Port parity: qwen and gemma with experts (``n_experts=4, top_k=2`` on
qwen-tiny and gemma-tiny) against the JAX package on the CPU in fp32, in
dense and ragged dispatch: logits, the aux loss and every gradient, four
AdamW steps, greedy ``generate`` and a ``ContinuousBatcher`` plan.

The helpers and bounds are ``tests/test_torch_moe.py``'s (router at std
0.1, every routed check guarded by ``MARGIN``); the tests sit in a file of
their own so that a parallel run spreads them over another worker. gemma's
experts are SiLU, as JAX's ``_moe_mlp`` and ``_moe_mlp_ragged`` are for
every arch, while its dense MLP is GeGLU."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_moe import (  # noqa: E402
    AUX_RTOL, F32, IMPLS, LOGITS_TOL, T32, _drive, _port_forward, _Spy, _tokens)
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

jgen = __import__("importlib").import_module("tpu_engine.generate")

NAMES = ["qwen-tiny", "gemma-tiny"]
_STEPS = 4


@functools.lru_cache(maxsize=None)
def _arch_moe(name: str):
    """(JAX config, port config, numpy tree, port params) of ``name`` with 4
    experts, top 2: the router at std 0.1 as in tests/test_torch_moe.py,
    every norm scale moved by normal(0, 0.1) so qwen's q/k norms and
    gemma's offsets from 1 count. Made once a module; a test that takes
    gradients of the params clears them."""
    jc = jtfm.MODEL_CONFIGS[name].with_(n_experts=4, top_k=2)
    cfg = tcfg.MODEL_CONFIGS[name].with_(n_experts=4, top_k=2)
    flat = convert._flatten(jax.tree.map(np.asarray, jtfm.init_params(jax.random.PRNGKey(0),
                                                                      jc)))
    rng = np.random.default_rng(0)
    for k in flat:
        if k.endswith(".scale"):
            flat[k] = (flat[k] + 0.1 * rng.standard_normal(flat[k].shape)).astype(np.float32)
    flat["layers.router.kernel"] = flat["layers.router.kernel"] * 5.0
    tree: dict = {}
    for k, v in flat.items():
        node = tree
        *path, leaf = k.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return jc, cfg, tree, convert.params_from_jax(tree, cfg, device="cpu")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", NAMES)
def test_arch_moe_logits_and_gradients_match_jax(name, impl, monkeypatch):
    """fp32 logits and aux (tests/test_torch_moe.py's bounds) and every
    parameter's gradient of mean(logits²) + aux against ``jax.grad``; the
    experts' activation is SiLU."""
    jc, cfg, tree, params = _arch_moe(name)
    jc, cfg = jc.with_(moe_impl=impl), cfg.with_(moe_impl=impl)
    tokens = _tokens(2, 32, seed=16)

    @jax.jit
    def reference(p):
        def loss(p):
            logits, aux = jtfm.forward_and_aux(p, jnp.asarray(tokens), jc, **F32)
            return jnp.mean(jnp.square(logits)) + aux, (logits, aux)

        (_, (logits, aux)), grads = jax.value_and_grad(loss, has_aux=True)(p)
        return logits, aux, grads

    ref, ref_aux, want = reference(jax.tree.map(jnp.asarray, tree))
    want = convert._flatten(want)
    silu = _Spy(monkeypatch, ttfm.F, "silu")
    for p in params.values():
        p.grad = None
    out, aux = _port_forward(monkeypatch, params, tokens, cfg, **T32)
    assert len(silu.calls) >= cfg.n_layers, "the experts' activation is SiLU"
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **LOGITS_TOL)
    np.testing.assert_allclose(float(aux.detach()), float(ref_aux), rtol=AUX_RTOL)
    (out.square().mean() + aux).backward()
    assert set(want) == set(params)
    for k, p in params.items():
        w = np.asarray(want[k])
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=5e-4 * np.abs(w).max(),
                                   err_msg=k)
        p.grad = None


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", NAMES)
def test_arch_moe_training_matches_jax(name, impl):
    """Four AdamW steps at accumulation 2 from the same weights on the same
    batches: losses and gradient norms within rtol 1e-4 and every final
    weight within 1e-6, the bounds of tests/test_torch_archs.py.

    An element whose gradient stays inside the gradient bound of zero at
    every step (|g| <= 5e-4·max|g| of its leaf, the bound of
    ``test_arch_moe_logits_and_gradients_match_jax``) has an update the
    gradient bound cannot fix: with √v̂ near AdamW's eps, m̂/(√v̂ + eps)
    turns a gradient difference a thousandth of that bound into a 5 %
    different update (qwen-tiny dense: ``embed.embedding[312, 7]``'s
    gradient of 3.4e-8 differs by 1.6e-9, its weight by 1.1e-5 after four
    steps). A zero gradient would leave such an element unmoved, so it is
    held to 1e-6 plus the sum of JAX's own updates lr·|m̂/(√v̂ + eps)| of
    it (:class:`_NearZeroSlack`); every other element to 1e-6."""
    jc, cfg, tree, _ = _arch_moe(name)
    kw = dict(model_name=name, micro_batch_size=2, gradient_accumulation_steps=2,
              seq_len=32, precision="fp32", attention_impl="xla", learning_rate=1e-3,
              min_lr=1e-4, warmup_steps=2, total_steps=8, weight_decay=0.1,
              activation_checkpointing=True, moe_impl=impl)
    rng = np.random.default_rng(12)
    batches = [rng.integers(0, 512, (2, 2, 32)).astype(np.int32) for _ in range(_STEPS)]
    jcfg = TPUTrainConfig(mesh=MeshConfig(data=1), **kw)
    jprog = jtrain.build_train_program(jcfg, model_cfg=jc, runtime=MeshRuntime(
        jcfg.mesh, devices=jax.devices()[:1]))
    jstate = jprog.init(jax.random.PRNGKey(0))
    jstate["params"] = jax.device_put(jax.tree.map(jnp.asarray, tree),
                                      jax.tree.map(lambda a: a.sharding, jstate["params"]))
    prog = ttrain.build_train_program(ttrain.TrainConfig(**kw), model_cfg=cfg, device="cpu")
    state = prog.init(params=convert.params_from_jax(tree, prog.model_config, device="cpu"))
    jl, jn, tl, tn = [], [], [], []
    slack = _NearZeroSlack()
    for b in batches:
        jstate, m = jprog.step(jstate, jax.device_put(jnp.asarray(b), jprog.batch_sharding))
        jl.append(float(m["loss"]))
        jn.append(float(m["grad_norm"]))
        slack.add(jstate["opt_state"], float(m["learning_rate"]))
        state, m = prog.step(state, torch.tensor(b, dtype=torch.long))
        tl.append(float(m["loss"]))
        tn.append(float(m["grad_norm"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    np.testing.assert_allclose(tn, jn, rtol=1e-4)
    want = convert._flatten(jax.tree.map(np.asarray, jstate["params"]))
    extra = slack.bounds()
    for k, p in state["params"].items():
        atol = 1e-6 + extra[k]
        np.testing.assert_array_less(np.abs(p.detach().numpy() - want[k]), atol + 1e-12,
                                     err_msg=k)


class _NearZeroSlack:
    """JAX's optimizer state and the step's lr, fed after each step
    (:meth:`add`); :meth:`bounds` is leaf → the extra bound of each element:
    Σ lr·|m̂/(√v̂ + eps)| (JAX's own updates, from its Adam moments) where
    the element's gradient (read from mu: (mu_t − b1·mu_{t−1}) / (1 − b1),
    clipped as the update took it) was within 5e-4·max|g| of its leaf at
    every step, 0 elsewhere."""

    def __init__(self, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.t, self.prev, self.near, self.total = 0, {}, {}, {}

    def add(self, opt, lr: float) -> None:
        adam = next(s for s in opt if hasattr(s, "mu"))
        mu = convert._flatten(jax.tree.map(np.array, adam.mu))
        nu = convert._flatten(jax.tree.map(np.array, adam.nu))
        self.t += 1
        b1, b2, t = self.b1, self.b2, self.t
        for k in mu:
            g = (mu[k] - b1 * self.prev.get(k, 0.0)) / (1 - b1)
            u = (mu[k] / (1 - b1 ** t)) / (np.sqrt(nu[k] / (1 - b2 ** t)) + self.eps)
            self.near[k] = self.near.get(k, True) & (np.abs(g) <= 5e-4 * np.abs(g).max())
            self.total[k] = self.total.get(k, 0.0) + lr * np.abs(u)
        self.prev = mu

    def bounds(self) -> dict:
        return {k: np.where(self.near[k], self.total[k], 0.0) for k in self.near}


@pytest.mark.parametrize("name", NAMES)
def test_arch_moe_generate_and_batcher_token_identical_to_jax(name):
    """Greedy ``generate`` (MoE decode) and a ``ContinuousBatcher`` plan of
    three requests on two slots, in fp32: streams token-identical to JAX's."""
    jc, cfg, tree, params = _arch_moe(name)
    prompt = _tokens(2, 8, seed=13)
    want = np.asarray(jgen.generate(tree, jnp.asarray(prompt), jc, 12, **F32))
    got = tgen.generate(params, prompt, cfg, 12, device="cpu", **T32)
    np.testing.assert_array_equal(got.numpy(), want)
    rng = np.random.default_rng(14)
    p1, p2, p3 = (rng.integers(1, 512, n).tolist() for n in (7, 11, 3))
    plan = [(0, p1, 6), (0, p2, 8), (3, p3, 5)]
    kw = dict(max_slots=2, max_len=64, prefill_pad_to=16, chunk_steps=2)
    got = _drive(tsrv.ContinuousBatcher(params, cfg, device="cpu", **T32, **kw), plan)
    want = _drive(jsrv.ContinuousBatcher(jax.tree.map(jnp.asarray, tree), jc, **F32, **kw), plan)
    assert got == want
