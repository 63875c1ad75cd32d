"""Port parity: the HF checkpoint bridge of ``tpu_engine_torch.models.convert``
against ``tpu_engine.models.convert`` on the CPU, for the llama, mistral,
gemma, qwen3 (tied and untied) and gpt2 families.

State dicts and configs are built in the test from a numpy seed (configs
as plain objects with the ``transformers`` attribute names), so the exact
comparisons need no ``transformers``. Where it is installed, the port's
fp32 logits of a loaded checkpoint are also held to the ``transformers``
model's, and ``save_hf_checkpoint`` is round-tripped through
``from_pretrained``, within ``tests/test_convert.py``'s 2e-3."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from tpu_engine.models import convert as jconv  # noqa: E402
from tpu_engine.models import transformer as jtfm  # noqa: E402
from tpu_engine_torch.models import config as tcfg  # noqa: E402
from tpu_engine_torch.models import convert as tconv  # noqa: E402
from tpu_engine_torch.models import transformer as ttfm  # noqa: E402

_LLAMA = dict(model_type="llama", vocab_size=96, hidden_size=32, intermediate_size=48,
              num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
              max_position_embeddings=128, rms_norm_eps=1e-5, rope_theta=10_000.0)
# Each family's config, as transformers names its attributes.
FAMILIES = {
    "llama": dict(_LLAMA),
    "mistral": dict(_LLAMA, model_type="mistral", sliding_window=8),
    "gemma": dict(_LLAMA, model_type="gemma", num_key_value_heads=1, head_dim=16,
                  hidden_activation="gelu_pytorch_tanh", rms_norm_eps=1e-6),
    "qwen3": dict(_LLAMA, model_type="qwen3", head_dim=16, rope_theta=1_000_000.0,
                  rms_norm_eps=1e-6, tie_word_embeddings=False),
    "qwen3_tied": dict(_LLAMA, model_type="qwen3", head_dim=16, rope_theta=1_000_000.0,
                       rms_norm_eps=1e-6, tie_word_embeddings=True),
    "gpt2": dict(model_type="gpt2", vocab_size=96, n_embd=32, n_layer=2, n_head=4,
                 n_inner=64, n_positions=64, layer_norm_epsilon=1e-5,
                 activation_function="gelu_new"),
}


def _hf_config(family: str, **over) -> SimpleNamespace:
    return SimpleNamespace(**{**FAMILIES[family], **over})


def _hf_state(family: str, seed: int = 0) -> dict[str, np.ndarray]:
    """A random state dict of ``family``'s HF model: every weight, norm scale
    and bias drawn from the seed, with the buffers HF exports beside them."""
    c = FAMILIES[family]
    rng = np.random.default_rng(seed)

    def w(*shape):
        return rng.standard_normal(shape).astype(np.float32) * 0.1

    if family == "gpt2":
        D, F, V, P = c["n_embd"], c["n_inner"], c["vocab_size"], c["n_positions"]
        sd = {"transformer.wte.weight": w(V, D), "transformer.wpe.weight": w(P, D),
              "transformer.ln_f.weight": 1 + w(D), "transformer.ln_f.bias": w(D)}
        for i in range(c["n_layer"]):
            pre = f"transformer.h.{i}."
            sd.update({pre + "ln_1.weight": 1 + w(D), pre + "ln_1.bias": w(D),
                       pre + "attn.c_attn.weight": w(D, 3 * D), pre + "attn.c_attn.bias": w(3 * D),
                       pre + "attn.c_proj.weight": w(D, D), pre + "attn.c_proj.bias": w(D),
                       pre + "ln_2.weight": 1 + w(D), pre + "ln_2.bias": w(D),
                       pre + "mlp.c_fc.weight": w(D, F), pre + "mlp.c_fc.bias": w(F),
                       pre + "mlp.c_proj.weight": w(F, D), pre + "mlp.c_proj.bias": w(D),
                       pre + "attn.bias": np.tril(np.ones((1, 1, P, P), np.float32))})
        sd["lm_head.weight"] = sd["transformer.wte.weight"]
        return sd
    D, F, V = c["hidden_size"], c["intermediate_size"], c["vocab_size"]
    H, KV = c["num_attention_heads"], c["num_key_value_heads"]
    HD = c.get("head_dim") or D // H
    sd = {"model.embed_tokens.weight": w(V, D), "model.norm.weight": 1 + w(D)}
    for i in range(c["num_hidden_layers"]):
        pre = f"model.layers.{i}."
        sd.update({pre + "input_layernorm.weight": 1 + w(D),
                   pre + "self_attn.q_proj.weight": w(H * HD, D),
                   pre + "self_attn.k_proj.weight": w(KV * HD, D),
                   pre + "self_attn.v_proj.weight": w(KV * HD, D),
                   pre + "self_attn.o_proj.weight": w(D, H * HD),
                   pre + "post_attention_layernorm.weight": 1 + w(D),
                   pre + "mlp.gate_proj.weight": w(F, D), pre + "mlp.up_proj.weight": w(F, D),
                   pre + "mlp.down_proj.weight": w(D, F),
                   pre + "self_attn.rotary_emb.inv_freq": w(HD // 2)})
        if c["model_type"] == "qwen3":
            sd[pre + "self_attn.q_norm.weight"] = 1 + w(HD)
            sd[pre + "self_attn.k_norm.weight"] = 1 + w(HD)
    if family == "gemma":
        sd["lm_head.weight"] = sd["model.embed_tokens.weight"]  # the tie, exported
    elif not c.get("tie_word_embeddings"):
        sd["lm_head.weight"] = w(V, D)
    return sd


def _from_hf(mod, sd, cfg, **kw):
    """``mod.from_hf``; the port's on the CPU."""
    if mod is tconv:
        kw.setdefault("device", "cpu")
    return mod.from_hf(sd, cfg, **kw)


def _as_numpy(mod, params) -> dict:
    if mod is tconv:
        return tconv.params_to_numpy(params)
    return jax.tree.map(np.asarray, params)


def _assert_trees_equal(got: dict, want: dict, path: str = "") -> None:
    assert set(got) == set(want), (path, sorted(got), sorted(want))
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{path}{k}.")
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=path + k)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_config_from_hf_equals_jax_field_for_field(family):
    jc = jconv.config_from_hf(_hf_config(family))
    tc = tconv.config_from_hf(_hf_config(family))
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.arch == {"gpt2": "gpt2", "gemma": "gemma"}.get(
        family, "qwen" if family.startswith("qwen") else "llama")


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_from_hf_and_to_hf_equal_jax_exactly(family):
    """The port's import equals JAX's leaf for leaf in fp32, its export
    JAX's key for key, and export after import gives the state dict back."""
    sd = _hf_state(family)
    jc = jconv.config_from_hf(_hf_config(family))
    tc = tconv.config_from_hf(_hf_config(family))
    jp = _from_hf(jconv, sd, jc)
    tp = _from_hf(tconv, sd, tc)
    assert list(tp) == list(tconv.param_keys(tc))
    assert all(t.dtype == torch.float32 and t.device.type == "cpu" and t.requires_grad
               for t in tp.values())
    _assert_trees_equal(_as_numpy(tconv, tp), _as_numpy(jconv, jp))

    to_hf = "to_hf_gpt2" if family == "gpt2" else "to_hf_llama"
    want = getattr(jconv, to_hf)(jp, jc)
    got = getattr(tconv, to_hf)(tp, tc)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    # Round trip: every weight of the state dict comes back; buffers and
    # gemma's exported tie do not, and a tied head the export omitted comes
    # back materialised.
    weights = {k for k in sd if "inv_freq" not in k and not k.endswith(".attn.bias")
               and not (family == "gemma" and k == "lm_head.weight")}
    assert weights <= set(got)
    for k in weights:
        np.testing.assert_array_equal(got[k], sd[k], err_msg=k)
    for k in set(got) - weights:
        assert k == "lm_head.weight"
        np.testing.assert_array_equal(got[k], sd["model.embed_tokens.weight"])
    _assert_trees_equal(_as_numpy(tconv, _from_hf(tconv, got, tc)), _as_numpy(tconv, tp))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_from_hf_casts_as_it_reads_and_takes_torch_tensors(dtype):
    """A torch state dict in a half dtype reaches numpy through fp32; the
    leaves come back in the caller's dtype, equal to a cast of JAX's fp32
    import (the round trip of half weights through fp32 is exact)."""
    sd = {k: torch.from_numpy(v).to(dtype) for k, v in _hf_state("qwen3").items()}
    tc = tconv.config_from_hf(_hf_config("qwen3"))
    tp = tconv.from_hf(sd, tc, dtype=dtype, device="cpu")
    jp = jconv.from_hf(sd, jconv.config_from_hf(_hf_config("qwen3")))
    ref = tconv.params_to_numpy(tp)
    for k, t in tp.items():
        assert t.dtype == dtype
    _assert_trees_equal(ref, jax.tree.map(np.asarray, jp))
    back = tconv.to_hf_llama(tp, tc)
    for k, v in sd.items():
        if "inv_freq" not in k:
            np.testing.assert_array_equal(back[k], v.float().numpy(), err_msg=k)


def _bias_state(mod):
    sd = _hf_state("llama")
    sd["model.layers.0.self_attn.q_proj.bias"] = np.zeros(32, np.float32)
    return sd


def _untied_gemma(mod):
    sd = _hf_state("gemma")
    sd["lm_head.weight"] = sd["model.embed_tokens.weight"] + 1.0
    return sd


def _missing_norm(mod):
    sd = _hf_state("llama")
    del sd["model.norm.weight"]
    return sd


def _gpt2_extra(mod):
    sd = _hf_state("gpt2")
    sd["transformer.h.0.attn.q_attn.weight"] = np.zeros((32, 32), np.float32)
    return sd


def _import(family, make_state):
    def run(mod, configs):
        return _from_hf(mod, make_state(mod), mod.config_from_hf(_hf_config(family)))
    return run


def _config(family, **over):
    return lambda mod, configs: mod.config_from_hf(_hf_config(family, **over))


# (id, call, exception type, what the message says). Each runs through both
# packages' converters.
REJECTIONS = [
    ("llama_rope_scaling", _config("llama", rope_scaling={"rope_type": "linear", "factor": 2.0}),
     ValueError, "rope_scaling"),
    ("llama_decoupled_head_dim", _config("llama", head_dim=16), ValueError, "head_dim"),
    ("gemma2", _config("gemma", model_type="gemma2"), ValueError, "gemma2"),
    ("gemma3_text", _config("gemma", model_type="gemma3_text"), ValueError, "gemma3_text"),
    ("gemma_softcapping", _config("gemma", final_logit_softcapping=30.0), ValueError,
     "softcapping"),
    ("gemma_attn_softcapping", _config("gemma", attn_logit_softcapping=50.0), ValueError,
     "softcapping"),
    ("gemma_activation", _config("gemma", hidden_activation="relu"), ValueError,
     "hidden_activation"),
    ("qwen2", _config("llama", model_type="qwen2"), ValueError, "qwen2"),
    ("qwen3_rope_scaling", _config("qwen3", rope_scaling={"rope_type": "yarn"}), ValueError,
     "rope_scaling"),
    ("qwen3_layered_windows", _config("qwen3", use_sliding_window=True), ValueError,
     "use_sliding_window"),
    ("gpt2_activation", _config("gpt2", activation_function="relu"), ValueError,
     "activation_function"),
    ("gpt2_inverse_layer_idx", _config("gpt2", scale_attn_by_inverse_layer_idx=True),
     ValueError, "scale_attn_by_inverse_layer_idx"),
    ("gpt2_reorder_upcast", _config("gpt2", reorder_and_upcast_attn=True), ValueError,
     "reorder_and_upcast_attn"),
    ("gpt2_unscaled", _config("gpt2", scale_attn_weights=False), ValueError,
     "scale_attn_weights"),
    ("llama_bias_checkpoint", _import("llama", _bias_state), ValueError, "drop"),
    ("gemma_untied_head", _import("gemma", _untied_gemma), ValueError, "UNTIED"),
    ("llama_missing_tensor", _import("llama", _missing_norm), KeyError, "model.norm.weight"),
    ("gpt2_extra_tensor", _import("gpt2", _gpt2_extra), ValueError, "drop"),
    ("moe_export", lambda mod, configs: mod.hf_config_from(configs["moe-tiny"]), ValueError,
     "MoE"),
    ("windowed_qwen_export",
     lambda mod, configs: mod.hf_config_from(configs["qwen-tiny"].with_(sliding_window=8)),
     ValueError, "globally-windowed"),
]


@pytest.mark.parametrize("case", REJECTIONS, ids=[c[0] for c in REJECTIONS])
def test_rejections_raise_as_jax(case):
    _, call, exc, words = case
    for mod, configs in ((jconv, jtfm.MODEL_CONFIGS), (tconv, tcfg.MODEL_CONFIGS)):
        with pytest.raises(exc, match=words) as info:
            call(mod, configs)
        assert type(info.value) is exc, (mod.__name__, type(info.value))


# ---------------------------------------------------------------------------
# Against transformers, where it is installed
# ---------------------------------------------------------------------------


def _hf_model(family: str, seed: int = 0):
    """A small randomly initialised ``transformers`` model of ``family``."""
    transformers = pytest.importorskip("transformers")
    common = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                  num_attention_heads=4, max_position_embeddings=128,
                  attn_implementation="eager")
    torch.manual_seed(seed)
    if family == "gpt2":
        cfg = transformers.GPT2Config(vocab_size=256, n_embd=64, n_layer=2, n_head=4,
                                      n_inner=128, n_positions=64, layer_norm_epsilon=1e-5,
                                      activation_function="gelu_new",
                                      attn_implementation="eager")
        return cfg, transformers.GPT2LMHeadModel(cfg).eval()
    if family == "gemma":
        cfg = transformers.GemmaConfig(num_key_value_heads=1, head_dim=32, rms_norm_eps=1e-6,
                                       **common)
        return cfg, transformers.GemmaForCausalLM(cfg).eval()
    if family.startswith("qwen3"):
        cfg = transformers.Qwen3Config(num_key_value_heads=2, head_dim=32, rms_norm_eps=1e-6,
                                       rope_theta=1_000_000.0,
                                       tie_word_embeddings=family == "qwen3_tied", **common)
        return cfg, transformers.Qwen3ForCausalLM(cfg).eval()
    if family == "mistral":
        cfg = transformers.MistralConfig(num_key_value_heads=2, sliding_window=8,
                                         tie_word_embeddings=False, **common)
        return cfg, transformers.MistralForCausalLM(cfg).eval()
    cfg = transformers.LlamaConfig(num_key_value_heads=2, attention_bias=False,
                                   tie_word_embeddings=False, **common)
    return cfg, transformers.LlamaForCausalLM(cfg).eval()


def _moved_off_init(model, seed: int) -> None:
    """Norm scales and biases away from their constant init, so a swapped
    or dropped one shows in the logits."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=gen))


def _port_logits(params, cfg, tokens) -> np.ndarray:
    with torch.no_grad():
        return ttfm.forward(params, torch.as_tensor(tokens), cfg,
                            compute_dtype=torch.float32).numpy()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loaded_checkpoint_logits_match_transformers(family):
    """seq 32 > mistral's window 8, so the window engages."""
    hf_cfg, model = _hf_model(family)
    _moved_off_init(model, 1)
    cfg = tconv.config_from_hf(hf_cfg)
    params = tconv.from_hf(model.state_dict(), cfg, device="cpu")
    tokens = np.random.default_rng(3).integers(0, 256, (2, 32))
    with torch.no_grad():
        want = model(torch.as_tensor(tokens)).logits.numpy()
    np.testing.assert_allclose(_port_logits(params, cfg, tokens), want, atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("name,window", [("gpt-tiny", 0), ("gpt-tiny", 16), ("gpt2-tiny", 0),
                                         ("gemma-tiny", 0), ("qwen-tiny", 0)])
def test_save_hf_checkpoint_round_trips(tmp_path, name, window):
    """The port's parameters written by ``save_hf_checkpoint`` load back in
    ``transformers`` (Llama, Mistral for a window, GPT-2, Gemma, Qwen3) and
    score as the port does."""
    transformers = pytest.importorskip("transformers")
    cfg = tcfg.MODEL_CONFIGS[name].with_(sliding_window=window)
    params = ttfm.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    with torch.no_grad():  # norm scales off their constant init
        for k, p in params.items():
            if k.endswith(("scale", "bias")):
                p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(6)))
    out = tconv.save_hf_checkpoint(params, cfg, str(tmp_path / "export"))
    model = transformers.AutoModelForCausalLM.from_pretrained(
        out, attn_implementation="eager").eval()
    assert type(model).__name__.startswith(
        {"gpt2": "GPT2", "gemma": "Gemma", "qwen": "Qwen3"}.get(
            cfg.arch, "Mistral" if window else "Llama"))
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (1, 40))
    with torch.no_grad():
        want = model(torch.as_tensor(tokens)).logits.numpy()
    np.testing.assert_allclose(_port_logits(params, cfg, tokens), want, atol=2e-3, rtol=2e-3)
