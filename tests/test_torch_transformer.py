"""Port parity: the llama forward of ``tpu_engine_torch.models.transformer``
against the JAX ``forward`` on gpt-tiny (fp32, CPU)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_engine.models import transformer as jtfm  # noqa: E402
from tpu_engine_torch.models import config as tcfg  # noqa: E402
from tpu_engine_torch.models import convert  # noqa: E402
from tpu_engine_torch.models import transformer as ttfm  # noqa: E402


def _setup(name="gpt-tiny", seed=0, S=64):
    jc = jtfm.MODEL_CONFIGS[name]
    tree = jax.tree.map(np.asarray, jtfm.init_params(jax.random.PRNGKey(seed), jc))
    params = convert.params_from_jax(tree, tcfg.MODEL_CONFIGS[name], device="cpu")
    tokens = np.random.default_rng(seed).integers(0, jc.vocab_size, (2, S)).astype(np.int32)
    return jc, tree, params, tokens


# fp32 logits: both sides run the same fp32 arithmetic in other summation
# orders; measured max difference ~2e-7 on logits of magnitude ~1.
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_forward_logits_match_jax(remat, impl):
    jc, tree, params, tokens = _setup()
    ref = jtfm.forward(tree, jnp.asarray(tokens), jc, compute_dtype=jnp.float32, remat=remat)
    out = ttfm.forward(params, torch.tensor(tokens, dtype=torch.long),
                       tcfg.MODEL_CONFIGS["gpt-tiny"].with_(attention_impl=impl),
                       compute_dtype=torch.float32, remat=remat)
    assert out.dtype == torch.float32 and tuple(out.shape) == (2, 64, jc.vocab_size)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


def test_windowed_gqa_forward_matches_jax():
    """A llama config with GQA and a sliding window (mistral's shape of
    attention) at tiny width."""
    jc = jtfm.MODEL_CONFIGS["gpt-tiny"].with_(n_kv_heads=2, sliding_window=24)
    tree = jax.tree.map(np.asarray, jtfm.init_params(jax.random.PRNGKey(1), jc))
    tc = tcfg.MODEL_CONFIGS["gpt-tiny"].with_(n_kv_heads=2, sliding_window=24)
    params = convert.params_from_jax(tree, tc, device="cpu")
    tokens = np.random.default_rng(1).integers(0, 512, (2, 64)).astype(np.int32)
    ref = jtfm.forward(tree, jnp.asarray(tokens), jc, compute_dtype=jnp.float32)
    out = ttfm.forward(params, torch.tensor(tokens, dtype=torch.long),
                       tc.with_(attention_impl="flash"), compute_dtype=torch.float32)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


def test_bf16_forward_close_to_jax():
    """bf16 compute: each side rounds at the same places (projections,
    attention probabilities), but rounding ties and summation orders differ;
    logits of magnitude ~1 agree to bf16 resolution."""
    jc, tree, params, tokens = _setup(seed=2)
    ref = jtfm.forward(tree, jnp.asarray(tokens), jc, compute_dtype=jnp.bfloat16)
    out = ttfm.forward(params, torch.tensor(tokens, dtype=torch.long),
                       tcfg.MODEL_CONFIGS["gpt-tiny"], compute_dtype=torch.bfloat16)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=3e-2, rtol=3e-2)


def test_gradients_reach_fp32_masters_through_the_cast():
    _, _, params, tokens = _setup(seed=3)
    logits = ttfm.forward(params, torch.tensor(tokens, dtype=torch.long),
                          tcfg.MODEL_CONFIGS["gpt-tiny"], compute_dtype=torch.bfloat16,
                          remat=True)
    logits.float().square().mean().backward()
    for k, p in params.items():
        assert p.grad is not None and p.grad.dtype == torch.float32, k
        assert torch.isfinite(p.grad).all(), k


@pytest.mark.parametrize("name", ["gpt2-tiny", "gemma-tiny", "qwen-tiny", "moe-tiny"])
def test_unported_archs_raise(name):
    """gpt2, gemma, qwen and MoE, and quantised training, which raised
    before they were ported, now build JAX's parameter tree and run its
    fp32 forward, int8 quantised training's too (the fuller parity tests
    are tests/test_torch_archs.py, tests/test_torch_moe.py and
    tests/test_torch_quant_train.py)."""
    cfg = tcfg.MODEL_CONFIGS[name]
    jc, tree, params, tokens = _setup(name, S=32)
    jq, tq = jc.with_(quant_training="int8"), cfg.with_(quant_training="int8")
    ref = jtfm.forward(tree, jnp.asarray(tokens), jq, compute_dtype=jnp.float32)
    out = ttfm.forward(params, torch.tensor(tokens, dtype=torch.long), tq,
                       compute_dtype=torch.float32)
    # The codes are JAX's, but an input one fp32 ulp from a rounding
    # boundary (other summation orders upstream) can take the neighbouring
    # code, which moves its products by one quantisation step: measured
    # 2.5e-5 on one of gemma-tiny's 32768 logits, held to 1e-4.
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    ref = jtfm.forward(tree, jnp.asarray(tokens), jc, compute_dtype=jnp.float32)
    out = ttfm.forward(params, torch.tensor(tokens, dtype=torch.long), cfg,
                       compute_dtype=torch.float32)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)
