"""Port parity: the remat policies of the training forward
(``tpu_engine_torch.models.transformer`` ``remat_policy``) against
``nothing_saveable`` and against JAX's policies, on the CPU.

What a policy keeps is read as the bytes the forward leaves allocated for
the backward: the profiler's CPU memory accounting over the forward call
(``profile_memory``), which sees autograd's saved tensors, the selective
checkpoint's cached products and the inputs each checkpoint keeps alike.
``saved_tensors_hooks`` would not: inside a checkpoint the checkpoint's
own hooks take every saved tensor."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_engine import train as jtrain  # noqa: E402
from tpu_engine.mesh_runtime import MeshConfig, MeshRuntime  # noqa: E402
from tpu_engine.models import transformer as jtfm  # noqa: E402
from tpu_engine.sharding import TPUTrainConfig  # noqa: E402
from tpu_engine_torch import offload  # noqa: E402
from tpu_engine_torch import train as ttrain  # noqa: E402
from tpu_engine_torch.models import config as tcfg  # noqa: E402
from tpu_engine_torch.models import convert  # noqa: E402
from tpu_engine_torch.models import transformer as ttfm  # noqa: E402

# Ordered from most kept to least.
POLICIES = ["everything_saveable", "dots_saveable", "dots_with_no_batch_dims_saveable",
            "save_qkv_attn_out", "save_attn_out", "nothing_saveable"]
NAME = "gpt-tiny"


@pytest.fixture(scope="module")
def weights():
    jc = jtfm.MODEL_CONFIGS[NAME]
    tree = jax.tree.map(np.asarray, jtfm.init_params(jax.random.PRNGKey(0), jc))
    tokens = np.random.default_rng(0).integers(0, jc.vocab_size, (2, 64)).astype(np.int32)
    return tree, tokens


def _port_grads(tree, tokens, policy, impl):
    cfg = tcfg.MODEL_CONFIGS[NAME].with_(attention_impl=impl)
    params = convert.params_from_jax(tree, cfg, device="cpu")
    toks = torch.tensor(tokens, dtype=torch.long)
    logits = ttfm.forward(params, toks, cfg, compute_dtype=torch.float32, remat=True,
                          remat_policy=policy)
    ttrain.lm_loss(logits, toks).backward()
    return {k: p.grad for k, p in params.items()}


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("policy", POLICIES[:-1] + ["offload_dots"])
def test_policy_grads_equal_nothing_saveables(weights, policy, impl):
    """Every policy recomputes or keeps the same values: the gradients
    equal ``nothing_saveable``'s bitwise (on the plain attention path and
    through the flash wrapper's plain versions). ``offload_dots`` runs here
    with plain host copies (the training program refuses it on the CPU, as
    JAX does)."""
    tree, tokens = weights
    want = _port_grads(tree, tokens, "nothing_saveable", impl)
    got = _port_grads(tree, tokens, policy, impl)
    for k, g in want.items():
        assert torch.equal(got[k], g), k


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_grads_match_jax(weights, policy):
    """Each policy's gradients against JAX's under the same policy, in
    fp32, held to tests/test_torch_archs.py's gradient bound (5e-4 of the
    largest)."""
    tree, tokens = weights
    jc = jtfm.MODEL_CONFIGS[NAME]

    def loss(p):
        logits = jtfm.forward(p, jnp.asarray(tokens), jc, compute_dtype=jnp.float32,
                              remat=True, remat_policy=policy)
        return jtrain.lm_loss(logits, jnp.asarray(tokens))

    want = convert._flatten(jax.tree.map(np.asarray, jax.grad(loss)(tree)))
    got = _port_grads(tree, tokens, policy, "xla")
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=5e-4 * np.abs(w).max(),
                                   err_msg=k)


def _forward_bytes(tree, tokens, policy) -> int:
    """Bytes the forward leaves allocated (kept for the backward, and the
    logits): the net of the profiler's CPU allocations over the call."""
    from torch.profiler import ProfilerActivity, profile

    cfg = tcfg.MODEL_CONFIGS[NAME]
    params = convert.params_from_jax(tree, cfg, device="cpu")
    toks = torch.tensor(tokens, dtype=torch.long)
    with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as prof:
        logits = ttfm.forward(params, toks, cfg, compute_dtype=torch.float32, remat=True,
                              remat_policy=policy)
    del logits
    return sum(e.self_cpu_memory_usage for e in prof.events())


def test_bytes_kept_follow_the_policies(weights):
    """everything ≥ dots ≥ dots with no batch dims ≥ save_qkv_attn_out ≥
    save_attn_out ≥ nothing, and each named policy keeps more than
    ``nothing_saveable``."""
    tree, tokens = weights
    kept = {p: _forward_bytes(tree, tokens, p) for p in POLICIES}
    sizes = [kept[p] for p in POLICIES]
    assert sizes == sorted(sizes, reverse=True), kept
    for p in ("save_qkv_attn_out", "save_attn_out"):
        assert kept[p] > kept["nothing_saveable"], kept
    # save_attn_out keeps [B, S, H·HD] more a layer (fp32) than nothing.
    B, S = tokens.shape
    cfg = tcfg.MODEL_CONFIGS[NAME]
    attn_out = cfg.n_layers * B * S * cfg.n_heads * cfg.head_dim * 4
    assert kept["save_attn_out"] - kept["nothing_saveable"] >= attn_out, kept


def test_unknown_and_offload_policies_raise():
    """A typo raises JAX's ValueError (config and forward); ``offload_dots``
    raises JAX's ValueError on the CPU and builds for a CUDA device, where
    it is ported (its card test: tests/test_torch_offload_cuda.py)."""
    with pytest.raises(ValueError, match="unknown remat_policy 'dots'"):
        ttrain.TrainConfig(remat_policy="dots")
    with pytest.raises(ValueError) as want:
        jtfm.resolve_remat_policy("dots")
    with pytest.raises(ValueError) as got:
        ttfm.resolve_remat_policy("dots")
    assert str(got.value) == str(want.value)
    assert sorted(ttfm.REMAT_POLICIES) == sorted(jtfm._REMAT_POLICIES)

    kw = dict(model_name=NAME, seq_len=32, remat_policy="offload_dots")
    with pytest.raises(ValueError) as want:
        jcfg = TPUTrainConfig(mesh=MeshConfig(data=1), **kw)
        jtrain.build_train_program(jcfg, runtime=MeshRuntime(jcfg.mesh,
                                                             devices=jax.devices()[:1]))
    with pytest.raises(ValueError) as got:
        ttrain.build_train_program(ttrain.TrainConfig(**kw), device="cpu")
    assert str(got.value) == str(want.value)
    prog = ttrain.build_train_program(ttrain.TrainConfig(**kw), device="cuda")
    assert prog.config.remat_policy == "offload_dots"


def test_offload_dots_keeps_the_products_on_the_host(weights):
    """``offload_dots``' forward keeps a host copy of each product without
    batch dims (seven a layer of gpt-tiny, a llama block: q, k, v, o, gate,
    up, down) in the device's stash, the recompute takes them back instead
    of running the products, the gradients are ``nothing_saveable``'s, and
    the stash's blocks are free again once the graph is gone."""
    tree, tokens = weights
    stores = []
    real = ttfm._offload_dots_contexts

    def spy():
        fwd, rec = real()
        stores.append(fwd.store)
        return fwd, rec

    cfg = tcfg.MODEL_CONFIGS[NAME]
    params = convert.params_from_jax(tree, cfg, device="cpu")
    toks = torch.tensor(tokens, dtype=torch.long)
    stash = offload.host_stash("cpu")
    before = stash.in_use
    ttfm._offload_dots_contexts = spy
    try:
        logits = ttfm.forward(params, toks, cfg, compute_dtype=torch.float32, remat=True,
                              remat_policy="offload_dots")
        kept = [len(s) for s in stores]
        held = stash.in_use - before
        ttrain.lm_loss(logits, toks).backward()
    finally:
        ttfm._offload_dots_contexts = real
    assert kept == [7] * cfg.n_layers  # q, k, v, o, gate, up, down
    # fp32 outputs: q, k, v; o and down (d_model each); gate and up (d_ff each).
    hd = cfg.head_dim
    per_layer = 4 * toks.numel() * (hd * (cfg.n_heads + 2 * cfg.n_kv_heads)
                                    + 2 * cfg.d_model + 2 * cfg.d_ff)
    assert held == cfg.n_layers * per_layer, (held, per_layer)
    assert all(len(s) <= 1 for s in stores)  # taken back (the last may stay unneeded)
    del logits
    stores.clear()
    assert stash.in_use == before
    want = _port_grads(tree, tokens, "nothing_saveable", "xla")
    assert all(torch.equal(params[k].grad, g) for k, g in want.items())


@pytest.mark.parametrize("policy", ["dots_with_no_batch_dims_saveable", "save_attn_out"])
def test_program_steps_equal_under_policies(policy):
    """Three steps of the training program (fp32, accumulation 2) under a
    policy give ``nothing_saveable``'s losses and weights bitwise."""
    out = {}
    for p in ("nothing_saveable", policy):
        prog = ttrain.build_train_program(ttrain.TrainConfig(
            model_name=NAME, micro_batch_size=2, gradient_accumulation_steps=2, seq_len=32,
            precision="fp32", learning_rate=1e-3, warmup_steps=1, remat_policy=p),
            device="cpu")
        state = prog.init()
        batch = prog.synthetic_batch(0)
        losses = []
        for _ in range(3):
            state, m = prog.step(state, batch)
            losses.append(m["loss"])
        out[p] = (torch.stack(losses), state["params"])
    (la, pa), (lb, pb) = out["nothing_saveable"], out[policy]
    assert torch.equal(la, lb)
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
