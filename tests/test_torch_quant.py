"""Port parity: weight-only int8 serving (``tpu_engine_torch.quant``) against
``tpu_engine.quant``, on the CPU: the codes and scales, the quantized
sites of every arch, the byte count, quantized logits (fp32 against JAX,
and bit-exact against the unquantized bf16 forward on power-of-two
weights), quantized greedy streams, and snapshots crossing between the
packages in both directions."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_engine import quant as jquant  # noqa: E402
from tpu_engine import serving as jsrv  # noqa: E402
from tpu_engine.models import transformer as jtfm  # noqa: E402
from tpu_engine_torch import generate as tgen  # noqa: E402
from tpu_engine_torch import quant as tquant  # noqa: E402
from tpu_engine_torch import serving as tsrv  # noqa: E402
from tpu_engine_torch.models import config as tcfg  # noqa: E402
from tpu_engine_torch.models import convert  # noqa: E402
from tpu_engine_torch.models import transformer as ttfm  # noqa: E402

jgen = importlib.import_module("tpu_engine.generate")

NAMES = ["gpt-tiny", "gpt2-tiny", "qwen-tiny", "gemma-tiny", "moe-tiny"]
F32, T32 = dict(compute_dtype=jnp.float32), dict(compute_dtype=torch.float32)
LOGITS_TOL = dict(atol=2e-5, rtol=2e-5)  # tests/test_torch_archs.py


def _tree(name: str, seed: int = 0) -> dict:
    """JAX's init for ``name`` as numpy; moe-tiny's router at std 0.1
    (tests/test_torch_moe.py: decisive routing, so that no choice is a
    near-tie)."""
    tree = jax.tree.map(np.asarray, jtfm.init_params(jax.random.PRNGKey(seed),
                                                     jtfm.MODEL_CONFIGS[name]))
    if "router" in tree["layers"]:
        tree["layers"]["router"]["kernel"] = tree["layers"]["router"]["kernel"] * 5.0
    return tree


def _pair(name: str, seed: int = 0):
    """(JAX config, port config, JAX quantized tree, the port's quantized
    tree of the same weights)."""
    tree = _tree(name, seed)
    cfg = tcfg.MODEL_CONFIGS[name]
    params = convert.params_from_jax(tree, cfg, device="cpu")
    return (jtfm.MODEL_CONFIGS[name], cfg, jquant.quantize_params(jax.tree.map(jnp.asarray, tree)),
            tquant.quantize_params(params))


def _assert_sites_equal(got: dict, want: dict):
    """The port's quantized tree holds JAX's leaves: codes exactly, scales
    within one ulp, every other leaf equal."""
    flat = convert._flatten(want)
    assert set(got) == set(flat)
    for k, w in flat.items():
        g = got[k]
        assert isinstance(g, tquant.QuantWeight) == isinstance(w, jquant.QuantWeight), k
        if isinstance(w, jquant.QuantWeight):
            assert g.q.dtype == torch.int8 and g.scale.dtype == torch.float32
            np.testing.assert_array_equal(g.q.numpy(), np.asarray(w.q), err_msg=k)
            np.testing.assert_array_max_ulp(g.scale.numpy(), np.asarray(w.scale), maxulp=1)
        else:
            np.testing.assert_array_equal(g.detach().float().numpy(),
                                          np.asarray(w, np.float32), err_msg=k)


# -- codes, sites, bytes --------------------------------------------------------------


@pytest.mark.parametrize("shape", [(64, 32), (2, 4, 64, 128)])
def test_quantize_weight_codes_equal_jax(shape):
    """[D, F] and stacked MoE [L, E, D, F]: JAX's codes exactly, scales
    [..., 1, F] within one ulp; an all-zero column gets the 1e-12 floor
    and zero codes."""
    w = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    w[..., 3] = 0.0
    want = jquant.quantize_weight(jnp.asarray(w))
    got = tquant.quantize_weight(torch.from_numpy(w))
    assert tuple(got.scale.shape) == shape[:-2] + (1, shape[-1])
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_max_ulp(got.scale.numpy(), np.asarray(want.scale), maxulp=1)
    assert bool((got.q[..., 3] == 0).all()) and bool((got.scale[..., 3] == np.float32(1e-12)).all())
    np.testing.assert_array_equal(tquant.dequantize_weight(got).numpy(),
                                  np.asarray(jquant.dequantize_weight(want)))
    np.testing.assert_array_equal(
        tquant.dequantize_weight(got, torch.bfloat16).float().numpy(),
        np.asarray(jquant.dequantize_weight(want, jnp.bfloat16).astype(jnp.float32)))


@pytest.mark.parametrize("name", NAMES)
def test_quantize_params_sites_equal_jax(name):
    """The same sites as JAX: every projection kernel and the LM head;
    gpt2's biases, gemma's and gpt2's tied embedding (no head of its own),
    qwen's q/k norms and MoE's router stay as they are (the same tensors)."""
    _, cfg, jq, tq = _pair(name)
    _assert_sites_equal(tq, jq)
    params = convert.params_from_jax(_tree(name), cfg, device="cpu")
    tq = tquant.quantize_params(params)
    for k, v in tq.items():
        if not isinstance(v, tquant.QuantWeight):
            assert v is params[k], k
    assert ("lm_head.kernel" in tq) == (cfg.arch not in ("gpt2", "gemma"))
    if cfg.is_moe:
        assert isinstance(tq["layers.gate.kernel"], tquant.QuantWeight)
        assert tuple(tq["layers.gate.kernel"].scale.shape) == (2, 4, 1, 128)
        assert not isinstance(tq["layers.router.kernel"], tquant.QuantWeight)


def test_requantizing_raises():
    _, _, _, tq = _pair("gpt-tiny")
    with pytest.raises(ValueError, match="already int8-quantized"):
        tquant.quantize_params(tq)


@pytest.mark.parametrize("name", NAMES)
def test_quantized_param_bytes_equal_jax(name):
    _, _, jq, tq = _pair(name)
    assert tquant.quantized_param_bytes(tq) == jquant.quantized_param_bytes(jq)


# -- forward -----------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_quantized_logits_match_jax(name):
    """fp32 compute: the int8 projections (codes cast, the scale on the
    product), the int8 head and MoE's dequantized experts against JAX's
    quantized forward; MoE dense and ragged."""
    jc, cfg, jq, tq = _pair(name)
    toks = np.random.default_rng(1).integers(0, 512, (2, 32)).astype(np.int32)
    for impl in (("dense", "ragged") if cfg.is_moe else ("dense",)):
        want = jtfm.forward(jq, jnp.asarray(toks), jc.with_(moe_impl=impl), **F32)
        got = ttfm.forward(tq, torch.from_numpy(toks).long(), cfg.with_(moe_impl=impl), **T32)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **LOGITS_TOL)


def _pow2(params: dict) -> dict:
    """Every quantized site's kernel snapped to int8 codes (one 127 per
    output channel) times per-channel powers of two: quantizing such a
    kernel is lossless, and its scale multiplies bf16 values exactly
    (tests/test_quant.py's construction, on the port's sites)."""
    out = dict(params)
    rng = np.random.default_rng(7)
    for k in tquant.quant_sites(params):
        shape = tuple(params[k].shape)
        codes = rng.integers(-127, 128, shape).astype(np.float32)
        codes[..., 0, :] = 127.0
        exp = rng.integers(-9, -5, shape[:-2] + (1, shape[-1])).astype(np.float32)
        out[k] = torch.from_numpy(codes * np.exp2(exp))
    return out


@pytest.mark.parametrize("name", NAMES)
def test_quantized_forward_bitexact_on_pow2_weights(name):
    """bf16: with power-of-two scales (h @ q)·s equals h @ (q·s) exactly, so
    the quantized forward equals the unquantized one bit for bit, every
    arch, MoE's two dispatches too."""
    cfg = tcfg.MODEL_CONFIGS[name]
    params = _pow2(ttfm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu"))
    qparams = tquant.quantize_params(params)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 512, (2, 16))).long()
    with torch.no_grad():
        for impl in (("dense", "ragged") if cfg.is_moe else ("dense",)):
            c = cfg.with_(moe_impl=impl)
            ref = ttfm.forward(params, toks, c, compute_dtype=torch.bfloat16)
            got = ttfm.forward(qparams, toks, c, compute_dtype=torch.bfloat16)
            assert torch.equal(ref, got), impl


# -- serving -----------------------------------------------------------------------


@pytest.mark.parametrize("name", ["gpt-tiny", "moe-tiny"])
def test_quantized_greedy_streams_equal_jax(name):
    """Greedy ``generate`` and a ``ContinuousBatcher`` plan (three requests
    on two slots, one mid-flight) on the quantized tree: JAX's streams."""
    jc, cfg, jq, tq = _pair(name)
    prompt = np.random.default_rng(3).integers(0, 512, (2, 8)).astype(np.int32)
    want = np.asarray(jgen.generate(jq, jnp.asarray(prompt), jc, 12, **F32))
    got = tgen.generate(tq, prompt, cfg, 12, device="cpu", **T32)
    np.testing.assert_array_equal(got.numpy(), want)

    rng = np.random.default_rng(4)
    plan = [(0, rng.integers(1, 512, 7).tolist(), 6), (0, rng.integers(1, 512, 13).tolist(), 9),
            (3, rng.integers(1, 512, 3).tolist(), 5)]
    kw = dict(max_slots=2, max_len=64, prefill_pad_to=16, chunk_steps=2)

    def drive(srv):
        ids = [None] * len(plan)
        for n in range(200):
            for i, (at, p, m) in enumerate(plan):
                if at == n:
                    ids[i] = srv.submit(p, max_new_tokens=m)
            if all(r is not None and srv.result(r)["status"] == "done" for r in ids):
                break
            srv.step()
        return [srv.result(r)["tokens"] for r in ids]

    srv = tsrv.ContinuousBatcher(tq, cfg, device="cpu", **T32, **kw)
    assert isinstance(srv.params["layers.q.kernel"], tquant.QuantWeight)
    assert srv.params["layers.q.kernel"].scale.dtype == torch.float32
    assert drive(srv) == drive(jsrv.ContinuousBatcher(jq, jc, **F32, **kw))


# -- snapshots ---------------------------------------------------------------------


def _with_bf16_embedding(jq: dict, tq: dict):
    """Both trees with the embedding table in bf16 (a serving snapshot's
    usual table), to carry a leaf numpy has no type for."""
    jq = dict(jq, embed={"embedding": jq["embed"]["embedding"].astype(jnp.bfloat16)})
    tq = dict(tq, **{"embed.embedding": tq["embed.embedding"].detach().to(torch.bfloat16)})
    return jq, tq


def _assert_trees_equal(got: dict, want: dict):
    assert list(got) == list(want) or set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, tquant.QuantWeight):
            assert torch.equal(g.q, w.q) and torch.equal(g.scale, w.scale), k
        else:
            assert g.dtype == w.dtype and torch.equal(g, w.detach()), k


@pytest.mark.parametrize("name", ["moe-tiny", "gpt2-tiny"])
def test_snapshot_written_by_jax_loads_in_the_port(name, tmp_path):
    """JAX's ``save_quantized`` → the port's ``load_quantized``: the port's
    own ``quantize_params`` of the same weights (scales written by JAX,
    within one ulp), and the recorded config equal to the port's."""
    jc, cfg, jq, tq = _pair(name)
    jq, tq = _with_bf16_embedding(jq, tq)
    jquant.save_quantized(jq, str(tmp_path), model_config=jc)
    loaded = tquant.load_quantized(str(tmp_path), device="cpu")
    assert tquant.load_quantized_config(str(tmp_path)) == cfg
    assert loaded["embed.embedding"].dtype == torch.bfloat16
    _assert_sites_equal(loaded, jax.tree.map(lambda a: a, jq))
    for k, v in tq.items():
        if isinstance(v, tquant.QuantWeight):
            assert torch.equal(loaded[k].q, v.q), k


@pytest.mark.parametrize("name", ["moe-tiny", "gpt2-tiny"])
def test_snapshot_written_by_the_port_loads_in_jax(name, tmp_path):
    """The port's ``save_quantized`` → JAX's ``load_quantized`` gives JAX's
    own quantized tree (codes exact, scales within one ulp, the bf16 table
    bitwise) and its config; the port's loader reads it back bitwise."""
    jc, cfg, jq, tq = _pair(name)
    jq, tq = _with_bf16_embedding(jq, tq)
    tquant.save_quantized(tq, str(tmp_path / "snap"), model_config=cfg)
    jloaded = jquant.load_quantized(str(tmp_path / "snap"))
    assert jquant.load_quantized_config(str(tmp_path / "snap")).name == jc.name
    assert jloaded["embed"]["embedding"].dtype == jnp.bfloat16
    for k, w in convert._flatten(jq).items():
        g = convert._flatten(jloaded)[k]
        if isinstance(w, jquant.QuantWeight):
            np.testing.assert_array_equal(np.asarray(g.q), np.asarray(w.q), err_msg=k)
            np.testing.assert_array_max_ulp(np.asarray(g.scale), np.asarray(w.scale), maxulp=1)
        else:
            np.testing.assert_array_equal(np.asarray(g, np.float32), np.asarray(w, np.float32),
                                          err_msg=k)
    _assert_trees_equal(tquant.load_quantized(str(tmp_path / "snap"), device="cpu"), tq)


def test_save_refuses_a_plain_tree_and_an_existing_snapshot(tmp_path):
    _, cfg, _, tq = _pair("gpt-tiny")
    params = convert.params_from_jax(_tree("gpt-tiny"), cfg, device="cpu")
    with pytest.raises(ValueError, match="no QuantWeight"):
        tquant.save_quantized(params, str(tmp_path / "plain"))
    tquant.save_quantized(tq, str(tmp_path / "snap"))
    assert tquant.load_quantized_config(str(tmp_path / "snap")) is None
    with pytest.raises(ValueError, match="already holds a snapshot"):
        tquant.save_quantized(tq, str(tmp_path / "snap"))
