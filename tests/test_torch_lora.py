"""Port parity: LoRA fine-tuning (``tpu_engine_torch.lora`` and the LoRA
program of ``tpu_engine_torch.train``) against ``tpu_engine.lora`` and
JAX's LoRA program, on the CPU, from the same numpy base and adapters."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_engine import lora as jlora  # noqa: E402
from tpu_engine import train as jtrain  # noqa: E402
from tpu_engine.mesh_runtime import MeshConfig, MeshRuntime  # noqa: E402
from tpu_engine.models import transformer as jtfm  # noqa: E402
from tpu_engine.sharding import TPUTrainConfig  # noqa: E402
from tpu_engine_torch import lora as tlora  # noqa: E402
from tpu_engine_torch import train as ttrain  # noqa: E402
from tpu_engine_torch.models import config as tcfg  # noqa: E402
from tpu_engine_torch.models import convert  # noqa: E402
from tpu_engine_torch.models import transformer as ttfm  # noqa: E402

RANK, ALPHA = 4, 8.0  # scale 2, so a dropped scale shows
LOGITS_TOL = dict(atol=2e-5, rtol=2e-5)  # tests/test_torch_archs.py's fp32 bound
_CFG = dict(model_name="gpt-tiny", micro_batch_size=2, gradient_accumulation_steps=2,
            seq_len=32, precision="fp32", learning_rate=1e-3, warmup_steps=2,
            total_steps=100, activation_checkpointing=True, attention_impl="xla",
            lora_rank=RANK, lora_alpha=ALPHA)


def _base(name="gpt-tiny", seed=0):
    return jax.tree.map(np.asarray, jtfm.init_params(jax.random.PRNGKey(seed),
                                                     jtfm.MODEL_CONFIGS[name]))


def _adapters(name="gpt-tiny", targets=("q", "k", "v", "o"), seed=1):
    """JAX's adapter tree with B drawn from numpy (nonzero, so the
    adapters act)."""
    tree = jax.tree.map(np.asarray, jlora.init_lora_params(
        jax.random.PRNGKey(seed), jtfm.MODEL_CONFIGS[name], RANK, targets))
    rng = np.random.default_rng(seed)
    for ab in tree["layers"].values():
        ab["B"] = (rng.standard_normal(ab["B"].shape) * 0.05).astype(np.float32)
    return tree


def _tokens(B=2, S=32, seed=2):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(np.int32)


def test_merge_lora_equals_jax():
    base, adapters = _base(), _adapters()
    want = jax.tree.map(np.asarray, jlora.merge_lora(base, adapters, ALPHA, RANK))
    cfg = tcfg.MODEL_CONFIGS["gpt-tiny"]
    got = tlora.merge_lora(convert.params_from_jax(base, cfg, device="cpu"),
                           convert.lora_from_jax(adapters, device="cpu"), ALPHA, RANK)
    got = convert.params_to_numpy(got)
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = got
        for p in path:
            g = g[p.key]
        np.testing.assert_array_equal(g, w, err_msg=".".join(p.key for p in path))
    assert (tlora.lora_param_count(cfg, RANK, ("q", "v"))
            == jlora.lora_param_count(jtfm.MODEL_CONFIGS["gpt-tiny"], RANK, ("q", "v")))


@pytest.mark.parametrize("name,targets", [
    ("gpt-tiny", ("q", "k", "v", "o")),
    ("gpt-tiny", ("q", "o", "gate", "up", "down")),
    ("gpt2-tiny", ("q", "fc", "proj")),
], ids=["llama_attn", "llama_mlp", "gpt2_fc_proj"])
def test_forward_and_adapter_grads_match_jax(name, targets):
    """Logits and every adapter gradient of the LM loss, through JAX's
    ``forward_hidden_and_aux(lora=...)`` and the port's, on the same base,
    adapters (nonzero B) and tokens, in fp32."""
    jc, tc = jtfm.MODEL_CONFIGS[name], tcfg.MODEL_CONFIGS[name]
    base, adapters, toks = _base(name), _adapters(name, targets), _tokens()
    scale = ALPHA / RANK

    def jloss(ad):
        h, _ = jtfm.forward_hidden_and_aux(base, jnp.asarray(toks), jc,
                                           compute_dtype=jnp.float32, lora=ad,
                                           lora_scale=scale)
        logits = jtfm.unembed(base, h, jc)
        return jtrain.lm_loss(logits, jnp.asarray(toks)), logits

    (jl, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, adapters))
    params = convert.params_from_jax(base, tc, device="cpu")
    ad = convert.lora_from_jax(adapters, device="cpu")
    h, _ = ttfm.forward_hidden_and_aux(params, torch.tensor(toks, dtype=torch.long), tc,
                                       compute_dtype=torch.float32, lora=ad,
                                       lora_scale=scale)
    logits = ttfm.unembed(params, h, tc)
    loss = ttrain.lm_loss(logits, torch.tensor(toks, dtype=torch.long))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), **LOGITS_TOL)
    assert float(loss) == pytest.approx(float(jl), rel=1e-6)
    for t in targets:
        for n in ("A", "B"):
            want = np.asarray(jgrads["layers"][t][n])
            np.testing.assert_allclose(ad[f"layers.{t}.{n}"].grad.numpy(), want, rtol=0,
                                       atol=5e-4 * np.abs(want).max(), err_msg=f"{t}.{n}")


def _jax_program(**kw):
    cfg = TPUTrainConfig(mesh=MeshConfig(data=1), **{**_CFG, **kw})
    return jtrain.build_train_program(cfg, runtime=MeshRuntime(cfg.mesh,
                                                               devices=jax.devices()[:1]),
                                      base_params=_base())


def test_four_adamw_steps_match_jax():
    """JAX's LoRA program and the port's from the same base and adapters:
    losses and gradient norms within rtol 1e-4 and the final adapters
    within 1e-6 (the AdamW parity bounds of tests/test_torch_train.py);
    the base unchanged."""
    jprog = _jax_program()
    jstate = jprog.init(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, jstate["params"])
    tprog = ttrain.build_train_program(ttrain.TrainConfig(**_CFG), device="cpu",
                                       base_params=convert.params_from_jax(
                                           _base(), tcfg.MODEL_CONFIGS["gpt-tiny"],
                                           device="cpu"))
    tstate = tprog.init(params=convert.lora_from_jax(init, device="cpu"))
    base_before = {k: v.clone() for k, v in tprog.base_params.items()}
    rng = np.random.default_rng(3)
    jl, tl = [], []
    for _ in range(4):
        b = rng.integers(0, 512, (2, 2, 32)).astype(np.int32)
        jstate, jm = jprog.step(jstate, jax.device_put(jnp.asarray(b), jprog.batch_sharding))
        tstate, tm = tprog.step(tstate, torch.tensor(b, dtype=torch.long))
        jl.append((float(jm["loss"]), float(jm["grad_norm"])))
        tl.append((float(tm["loss"]), float(tm["grad_norm"])))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    for t, ab in jax.tree.map(np.asarray, jstate["params"])["layers"].items():
        for n in ("A", "B"):
            np.testing.assert_allclose(tstate["params"][f"layers.{t}.{n}"].detach().numpy(),
                                       ab[n], atol=1e-6, rtol=0, err_msg=f"{t}.{n}")
    assert all(torch.equal(v, base_before[k]) for k, v in tprog.base_params.items())


def test_step_zero_equals_base_and_state_is_adapter_sized():
    """B = 0 at init: the LoRA program's loss equals the base program's
    bitwise. Only the adapters train: the base is frozen (no gradient,
    unchanged by steps) and the optimizer state is adapter-sized; A and B
    decay."""
    base = convert.params_from_jax(_base(), tcfg.MODEL_CONFIGS["gpt-tiny"], device="cpu")
    kw = {k: v for k, v in _CFG.items() if k not in ("lora_rank", "lora_alpha")}
    plain = ttrain.build_train_program(ttrain.TrainConfig(**kw), device="cpu")
    prog = ttrain.build_train_program(ttrain.TrainConfig(**_CFG), device="cpu",
                                      base_params=base)
    state = prog.init()
    batch = prog.synthetic_batch(0)
    want = plain.eval_step(plain.init(params=base), batch)
    assert torch.equal(prog.eval_step(state, batch), want)
    _, m = prog.step(state, batch)
    assert torch.equal(m["loss"], want)

    n = tlora.lora_param_count(prog.model_config, RANK, ("q", "k", "v", "o"))
    assert set(state["params"]) == {f"layers.{t}.{x}" for t in "qkvo" for x in "AB"}
    assert sum(p.numel() for p in state["params"].values()) == n
    assert prog.tx.state_bytes(state["opt_state"]) == 2 * 4 * n
    assert not any(p.requires_grad for p in prog.base_params.values())
    assert all(torch.equal(prog.base_params[k], base[k].detach()) for k in base)
    assert all(ttrain.kernel_decay_mask(state["params"]).values())


def test_merged_params_forward_equals_adapter_forward():
    """``merged_params`` (W + scale·A@B, compute dtype) gives the adapter
    forward's logits, within the fp32 bound."""
    prog = ttrain.build_train_program(ttrain.TrainConfig(**_CFG), device="cpu")
    adapters = convert.lora_from_jax(_adapters(), device="cpu")
    toks = torch.tensor(_tokens(), dtype=torch.long)
    cfg = prog.model_config
    with torch.no_grad():
        h, _ = ttfm.forward_hidden_and_aux(prog.base_params, toks, cfg,
                                           compute_dtype=torch.float32, lora=adapters,
                                           lora_scale=prog.config.lora_scale())
        want = ttfm.unembed(prog.base_params, h, cfg)
        merged = prog.merged_params(adapters)
        got = ttfm.forward(merged, toks, cfg, compute_dtype=torch.float32)
    assert all(v.dtype == torch.float32 for v in merged.values())
    np.testing.assert_allclose(got.numpy(), want.numpy(), **LOGITS_TOL)


def test_targets_and_combinations():
    """MoE expert targets are refused with JAX's message; int8 with LoRA is
    refused (tests/test_torch_quant_train.py); a ring in one process
    composes with LoRA: its loss and adapter gradients equal the plain
    path's."""
    with pytest.raises(ValueError) as want:
        jlora.validate_targets(jtfm.MODEL_CONFIGS["moe-tiny"], ("gate",))
    with pytest.raises(ValueError) as got:
        ttrain.build_train_program(ttrain.TrainConfig(model_name="moe-tiny", lora_rank=4,
                                                      lora_targets=("gate",)), device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="lora_targets must not be empty"):
        ttrain.build_train_program(ttrain.TrainConfig(lora_rank=4, lora_targets=()),
                                   device="cpu")

    grads = {}
    for seq in (1, 2):
        prog = ttrain.build_train_program(ttrain.TrainConfig(**{**_CFG, "sequence": seq}),
                                          device="cpu")
        state = prog.init()
        for p in state["params"].values():
            torch.nn.init.normal_(p.data, std=0.05, generator=torch.Generator().manual_seed(1))
        loss = ttrain.accumulate_grads(prog.loss_fn, state["params"], prog.synthetic_batch(0))
        grads[seq] = (float(loss), {k: p.grad for k, p in state["params"].items()})
    assert grads[2][0] == pytest.approx(grads[1][0], rel=1e-5)
    for k, g in grads[1][1].items():
        np.testing.assert_allclose(grads[2][1][k].numpy(), g.numpy(), rtol=0,
                                   atol=1e-4 * g.abs().max().item(), err_msg=k)


def test_base_from_hf_state_dict_trains():
    """A frozen base built through the HF bridge (``from_hf_llama``) from a
    state dict made here trains: the adapters' loss falls on a repeated
    batch and the base stays as loaded."""
    cfg = tcfg.MODEL_CONFIGS["gpt-tiny"]
    src = ttfm.init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    state_dict = {k: torch.from_numpy(np.ascontiguousarray(v))
                  for k, v in convert.to_hf_llama(src, cfg).items()}
    base = convert.from_hf_llama(state_dict, cfg, device="cpu")
    prog = ttrain.build_train_program(ttrain.TrainConfig(**_CFG), device="cpu",
                                      base_params=base)
    state = prog.init()
    batch = prog.synthetic_batch(0)
    losses = []
    for _ in range(6):
        state, m = prog.step(state, batch)
        losses.append(float(m["loss"]))
    assert all(b < a for a, b in zip(losses[1:], losses[2:])), losses
    assert all(torch.equal(prog.base_params[k], src[k].detach()) for k in src)
