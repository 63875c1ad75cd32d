"""Port parity: the copied model configurations and the weight bridge."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from tpu_engine.models import transformer as jtfm  # noqa: E402
from tpu_engine_torch.models import config as tcfg  # noqa: E402
from tpu_engine_torch.models import convert  # noqa: E402
from tpu_engine_torch.models import transformer as ttfm  # noqa: E402


def test_model_configs_equal_jax_field_for_field():
    assert set(tcfg.MODEL_CONFIGS) == set(jtfm.MODEL_CONFIGS)
    jfields = [f.name for f in dataclasses.fields(jtfm.ModelConfig)]
    assert [f.name for f in dataclasses.fields(tcfg.ModelConfig)] == jfields
    for name, jc in jtfm.MODEL_CONFIGS.items():
        tc = tcfg.MODEL_CONFIGS[name]
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc), name
        assert tc.head_dim == jc.head_dim
        if jc.is_moe:
            assert tc.expert_capacity(2048) == jc.expert_capacity(2048)


@pytest.mark.parametrize("name", sorted(jtfm.MODEL_CONFIGS))
def test_param_count_and_flops_match_jax(name):
    jc, tc = jtfm.MODEL_CONFIGS[name], tcfg.MODEL_CONFIGS[name]
    assert ttfm.param_count(tc) == jtfm.param_count(jc)
    assert ttfm.train_flops_per_token(tc, 2048) == jtfm.train_flops_per_token(jc, 2048)


def test_params_round_trip_exactly():
    cfg = jtfm.MODEL_CONFIGS["gpt-tiny"]
    tree = jax.tree.map(np.asarray, jtfm.init_params(jax.random.PRNGKey(0), cfg))
    params = convert.params_from_jax(tree, tcfg.MODEL_CONFIGS["gpt-tiny"], device="cpu")
    assert all(p.requires_grad and p.dtype == torch.float32 for p in params.values())
    back = convert.params_to_numpy(params)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


def test_params_from_jax_rejects_unported_archs_and_bad_trees():
    """An arch with experts the port refuses (gpt2, as JAX's block would
    look for a router in its dense tree) raises; a tree
    missing a leaf of its arch raises ``ValueError`` naming it; gemma's tree
    (no ``lm_head``: the head is tied) and moe-tiny's (router and stacked
    experts), which raised before they were ported, now round-trip exactly."""
    gemma = jtfm.MODEL_CONFIGS["gemma-tiny"]
    tree = jax.tree.map(np.asarray, jtfm.init_params(jax.random.PRNGKey(0), gemma))
    back = convert.params_to_numpy(
        convert.params_from_jax(tree, tcfg.MODEL_CONFIGS["gemma-tiny"], device="cpu"))
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(tree),
                                jax.tree_util.tree_leaves_with_path(back), strict=True):
        assert pa == pb
        np.testing.assert_array_equal(a, b)
    moe = jax.tree.map(np.asarray, jtfm.init_params(jax.random.PRNGKey(0),
                                                    jtfm.MODEL_CONFIGS["moe-tiny"]))
    back = convert.params_to_numpy(
        convert.params_from_jax(moe, tcfg.MODEL_CONFIGS["moe-tiny"], device="cpu"))
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(moe),
                                jax.tree_util.tree_leaves_with_path(back), strict=True):
        assert pa == pb
        np.testing.assert_array_equal(a, b)
    with pytest.raises(NotImplementedError):
        convert.params_from_jax(moe, tcfg.MODEL_CONFIGS["moe-tiny"].with_(arch="gpt2"),
                                device="cpu")
    with pytest.raises(ValueError, match="lm_head"):
        convert.params_from_jax(tree, tcfg.MODEL_CONFIGS["qwen-tiny"], device="cpu")
    llama = jax.tree.map(np.asarray, jtfm.init_params(jax.random.PRNGKey(0),
                                                      jtfm.MODEL_CONFIGS["gpt-tiny"]))
    del llama["lm_head"]
    with pytest.raises(ValueError, match="lm_head"):
        convert.params_from_jax(llama, tcfg.MODEL_CONFIGS["gpt-tiny"], device="cpu")


def test_port_init_matches_jax_shapes_and_scales():
    cfg = tcfg.MODEL_CONFIGS["gpt-tiny"]
    params = ttfm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    jtree = jax.eval_shape(lambda k: jtfm.init_params(k, jtfm.MODEL_CONFIGS["gpt-tiny"]),
                           jax.random.PRNGKey(0))
    flat = convert._flatten(jtree)
    assert {k: tuple(v.shape) for k, v in flat.items()} == {
        k: tuple(v.shape) for k, v in params.items()}
    res_std = 0.02 / (2 * cfg.n_layers) ** 0.5
    assert float(params["layers.o.kernel"].detach().std()) == pytest.approx(res_std, rel=0.1)
    assert float(params["layers.q.kernel"].detach().std()) == pytest.approx(0.02, rel=0.1)
    assert torch.equal(params["final_norm.scale"], torch.ones(cfg.d_model))
