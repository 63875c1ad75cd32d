"""Port parity: Adafactor and Lion (``tpu_engine_torch.train``) against the
optax chains JAX builds (``tpu_engine.train.make_optimizer``), update by
update on a tree with factored and unfactored leaves, and through four
training steps of gpt-tiny against JAX's train program, on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_engine import train as jtrain  # noqa: E402
from tpu_engine.mesh_runtime import MeshConfig, MeshRuntime  # noqa: E402
from tpu_engine.models import transformer as jtfm  # noqa: E402
from tpu_engine.sharding import TPUTrainConfig  # noqa: E402
from tpu_engine_torch import train as ttrain  # noqa: E402
from tpu_engine_torch.models import convert  # noqa: E402

# A tree with leaves optax factors ([2, 256, 384]: over 256 × 384, never
# the layer axis; [512, 128]) and leaves it does not ([2, 64]: no dim
# reaches 128; [2, 256]: the second-largest dim is 2); the kernels decay.
SHAPES = {
    "layers.q.kernel": (2, 256, 384),
    "lm_head.kernel": (512, 128),
    "layers.attn_norm.scale": (2, 64),
    "layers.mlp_norm.scale": (2, 256),
}
OPTS = [
    ("adafactor", {}),                        # decay exponent 0.8 (beta2 not set)
    ("adafactor", {"beta2": 0.95}),           # beta2 set: exponent 0.95
    ("lion", {}),
    ("lion", {"moment_dtype": "bf16"}),
]
IDS = ["adafactor", "adafactor_beta2_set", "lion", "lion_bf16_moment"]
LR = 1e-2


def _nest(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        *path, leaf = key.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _leaf(tree, key):
    for p in key.split("."):
        tree = tree[p]
    return tree


@pytest.mark.parametrize("opt,kw", OPTS, ids=IDS)
def test_update_matches_optax_chain(opt, kw):
    """Five updates of the whole chain (clip, scaler, masked decay,
    ``p - lr·u``); gradients scaled so that some steps clip and some do
    not. Held to 1e-6: the same fp32 arithmetic in other orders."""
    common = dict(optimizer=opt, weight_decay=0.1, grad_clip_norm=1.0, **kw)
    jtx, _ = jtrain.make_optimizer(TPUTrainConfig(**common))
    ttx, _ = ttrain.make_optimizer(ttrain.TrainConfig(**common))
    rng = np.random.default_rng(0)
    init = {k: rng.standard_normal(s).astype(np.float32) * 0.1 for k, s in SHAPES.items()}
    jp = _nest({k: jnp.asarray(v) for k, v in init.items()})
    jstate = jtx.init(jp)
    tp = {k: torch.tensor(v) for k, v in init.items()}
    tstate = ttx.init(tp)
    for step, scale in enumerate((1.0, 1e-3, 1.0, 1e-3, 1e-3)):
        g = {k: rng.standard_normal(s).astype(np.float32) * scale for k, s in SHAPES.items()}
        upd, jstate = jtx.update(_nest({k: jnp.asarray(v) for k, v in g.items()}), jstate, jp)
        jp = jax.tree.map(lambda p, u: p + (-LR * u).astype(u.dtype), jp, upd)
        ttx.update(tp, {k: torch.tensor(v) for k, v in g.items()}, tstate, LR)
        for k in SHAPES:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(_leaf(jp, k)), atol=1e-6,
                                       rtol=0, err_msg=f"{k} after update {step + 1}")


def test_beta2_picks_jaxs_adafactor_decay():
    """JAX takes ``beta2`` as Adafactor's decay exponent only when it was
    set (``model_fields_set``), else 0.8; the port records the default as
    a marked float. Both cases, and a copy that keeps the mark."""
    import dataclasses

    assert ttrain.make_optimizer(ttrain.TrainConfig(optimizer="adafactor"))[0].decay_rate == 0.8
    for beta2 in (0.95, 0.5):
        tx, _ = ttrain.make_optimizer(ttrain.TrainConfig(optimizer="adafactor", beta2=beta2))
        assert tx.decay_rate == beta2
    copied = dataclasses.replace(ttrain.TrainConfig(optimizer="adafactor"), seq_len=64)
    assert not copied.beta2_is_set and copied.beta2 == 0.95
    assert "beta2" not in TPUTrainConfig(optimizer="adafactor").model_fields_set


def test_optimizer_config_errors_as_jax():
    with pytest.raises(ValueError, match="moment_dtype is not supported with optimizer='adafactor'"):
        jtrain.make_optimizer(TPUTrainConfig(optimizer="adafactor", moment_dtype="bf16"))
    with pytest.raises(ValueError, match="moment_dtype is not supported with optimizer='adafactor'"):
        ttrain.TrainConfig(optimizer="adafactor", moment_dtype="bf16")
    with pytest.raises(ValueError, match="optimizer"):
        ttrain.TrainConfig(optimizer="sgd")


def _meta_params(name: str) -> dict:
    """gpt-125m's parameters as meta tensors (shapes only)."""
    shapes = jax.eval_shape(lambda: jtfm.init_params(jax.random.PRNGKey(0),
                                                     jtfm.MODEL_CONFIGS[name]))
    return {k: torch.empty(v.shape, device="meta")
            for k, v in convert._flatten(shapes).items()}


def test_state_sizes():
    """Adafactor's factored statistics are under 10 % of gpt-125m's
    parameters (JAX's bar, tests/test_optimizers.py); Lion keeps one
    moment; AdamW two."""
    params = _meta_params("gpt-125m")
    n = sum(p.numel() for p in params.values())
    sizes = {}
    for opt in ("adamw", "adafactor", "lion"):
        tx, _ = ttrain.make_optimizer(ttrain.TrainConfig(optimizer=opt))
        sizes[opt] = tx.state_bytes(tx.init(params)) // 4
    assert sizes["adamw"] == 2 * n
    assert sizes["lion"] == n
    assert sizes["adafactor"] < 0.1 * n


_COMMON = dict(
    model_name="gpt-tiny", micro_batch_size=2, gradient_accumulation_steps=2,
    seq_len=32, precision="fp32", attention_impl="xla", learning_rate=1e-3,
    min_lr=1e-4, warmup_steps=2, total_steps=8, weight_decay=0.1,
    activation_checkpointing=True,
)


def _batches(n=4):
    rng = np.random.default_rng(0)
    return [rng.integers(0, 512, (2, 2, 32)).astype(np.int32) for _ in range(n)]


# Lion with a bf16 moment is held update by update above, not here: the two
# frameworks' gradients differ in the last fp32 bits, which can round a
# stored bf16 moment to its neighbour and flip the sign of an update near 0
# (a 2·lr move, seen on 8 of 32768 weights after four steps).
@pytest.mark.parametrize("opt,kw", OPTS[:3], ids=IDS[:3])
def test_train_steps_match_jax(opt, kw):
    """Four steps of gpt-tiny (fp32, accumulation 2) with each optimizer:
    losses, gradient norms and every final weight against JAX's program,
    held to the AdamW parity bound of tests/test_torch_train.py (1e-6)."""
    kw = {**_COMMON, "optimizer": opt, **kw}
    jcfg = TPUTrainConfig(mesh=MeshConfig(data=1), **kw)
    jprog = jtrain.build_train_program(jcfg, runtime=MeshRuntime(jcfg.mesh,
                                                                 devices=jax.devices()[:1]))
    jstate = jprog.init(jax.random.PRNGKey(0))
    tprog = ttrain.build_train_program(ttrain.TrainConfig(**kw), device="cpu")
    tstate = tprog.init(params=convert.params_from_jax(
        jax.tree.map(np.asarray, jstate["params"]), tprog.model_config, device="cpu"))
    jl, tl = [], []
    for b in _batches():
        jstate, jm = jprog.step(jstate, jax.device_put(jnp.asarray(b), jprog.batch_sharding))
        tstate, tm = tprog.step(tstate, torch.tensor(b, dtype=torch.long))
        jl.append((float(jm["loss"]), float(jm["grad_norm"])))
        tl.append((float(tm["loss"]), float(tm["grad_norm"])))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    tp = convert.params_to_numpy(tstate["params"])
    for path, a in jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray,
                                                                    jstate["params"])):
        b = tp
        for p in path:
            b = b[p.key]
        np.testing.assert_allclose(b, a, atol=1e-6, rtol=0,
                                   err_msg=".".join(p.key for p in path))
