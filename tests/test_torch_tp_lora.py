"""Port parity: LoRA and Adafactor over the mesh's ``model`` axis (and
Adafactor with its state over ``fsdp``), on four ``gloo`` ranks on the CPU,
against the JAX package.

One spawn of four ranks (``tests/torch_mesh_worker.py``) runs every case:
LoRA on qwen-tiny at rank 4, targets q/k/v/o and the MLP, on (data=2,
model=2) at stage 0 and on (fsdp=2, model=2) at stage 3 (a column-split
target's B splits on its columns, a row-split target's A on its rows; A of
a column-split target and B of a row-split one are summed over ``model``);
Adafactor on a qwen-tiny widened to d_model 128 and d_ff 256, so that its
kernels' moments are factored over dims ``model`` or ``fsdp`` split, on
(data=2, model=2) at stage 0, (data=2, fsdp=2) at stage 1 (its state split
over ``fsdp``) and (fsdp=2, model=2) at stage 3. Each case takes three
steps at lr 1e-3 from JAX's initial weights on the same global batches
(SFT-masked positions included).

The reference of every case is JAX's single-device program at the same
global batch. Bounds, the AdamW parity bounds of tests/test_torch_train.py:
losses within rtol 1e-6, gradient norms 1e-5, every final weight (the
adapters under LoRA) within 1e-6; under LoRA every adapter gradient of the
first batch within 1e-5 of its largest entry (JAX's read from its Adam mu
after step 0, whose learning rate is 0; Adafactor keeps no first moment to
read it from), each rank's adapters as placed equal to
``convert.model_block_np`` of JAX's, and each rank's merged tree
(``merged_params``) within 1e-6 of its block of JAX's ``merge_lora``.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_engine import lora as jlora  # noqa: E402
from tpu_engine import train as jtrain  # noqa: E402
from tpu_engine.mesh_runtime import MeshConfig, MeshRuntime  # noqa: E402
from tpu_engine.sharding import TPUTrainConfig  # noqa: E402
from tpu_engine_torch import sharding as tsh  # noqa: E402
from tpu_engine_torch import train as ttrain  # noqa: E402
from tpu_engine_torch.models import config as tcfg  # noqa: E402
from tpu_engine_torch.models import convert  # noqa: E402
from test_torch_mesh_train import _unflatten  # noqa: E402
from test_torch_pipeline import _coords  # noqa: E402
from test_torch_tp_train import _adam_mu, _batches, _init, _jcfg  # noqa: E402
from torch_mesh_worker import spawn  # noqa: E402

WORLD = 4
ROWS, SEQ, ACCUM = 4, 32, 2
B1 = 0.9
RANK, ALPHA = 4, 8.0
TARGETS = ("q", "k", "v", "o", "gate", "up", "down")
WIDE = dict(d_model=128, d_ff=256)
_KW = dict(gradient_accumulation_steps=ACCUM, seq_len=SEQ, precision="fp32",
           attention_impl="xla", learning_rate=1e-3, min_lr=1e-4, warmup_steps=1,
           total_steps=8, weight_decay=0.1, beta1=B1, activation_checkpointing=True)
_LORA = dict(lora_rank=RANK, lora_alpha=ALPHA, lora_targets=TARGETS)
# (case, config fields changed, mesh, fields of both programs, port-only fields)
CASES = [
    ("lora_data2", {}, dict(data=2, model=2), _LORA, dict(sharding_stage=0)),
    ("lora_fsdp2_s3", {}, dict(fsdp=2, model=2), _LORA, dict(sharding_stage=3)),
    ("ada_model2", WIDE, dict(data=2, model=2), dict(optimizer="adafactor"),
     dict(sharding_stage=0)),
    ("ada_fsdp2_s1", WIDE, dict(data=2, fsdp=2), dict(optimizer="adafactor"),
     dict(sharding_stage=1)),
    ("ada_fsdp2_model2_s3", WIDE, dict(fsdp=2, model=2), dict(optimizer="adafactor"),
     dict(sharding_stage=3)),
]
_NAMES = [c[0] for c in CASES]


def _adapters(cfg) -> dict:
    """JAX's adapter tree with B drawn from numpy (nonzero, so every
    factor's gradient means something), flattened."""
    tree = jax.tree.map(np.asarray, jlora.init_lora_params(jax.random.PRNGKey(1), cfg, RANK,
                                                           TARGETS))
    rng = np.random.default_rng(1)
    for ab in tree["layers"].values():
        ab["B"] = (rng.standard_normal(ab["B"].shape) * 0.05).astype(np.float32)
    return convert._flatten(tree)


def _jax_run(over: dict, flat: dict, base: dict, batches: np.ndarray, **both):
    """JAX's single-device program: losses, norms, the final trainable
    tree (flat), the first batch's gradients (None under Adafactor)."""
    cfg = TPUTrainConfig(model_name="qwen-tiny", micro_batch_size=ROWS, mesh=MeshConfig(data=1),
                         **{**_KW, **both})
    mcfg = _jcfg("qwen-tiny", over)
    kw = {"base_params": jax.tree.map(jnp.asarray, _unflatten(base))} if base else {}
    prog = jtrain.build_train_program(cfg, mcfg, runtime=MeshRuntime(
        cfg.mesh, devices=jax.devices()[:1]), **kw)
    state = prog.init(jax.random.PRNGKey(0))
    state["params"] = jax.device_put(jax.tree.map(jnp.asarray, _unflatten(flat)),
                                     jax.tree.map(lambda a: a.sharding, state["params"]))
    losses, norms, grads = [], [], None
    for b in batches:
        state, m = prog.step(state, jax.device_put(jnp.asarray(b), prog.batch_sharding))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if grads is None and both.get("optimizer") != "adafactor":
            clip = min(1.0, cfg.grad_clip_norm / norms[0])
            mu = convert._flatten(jax.tree.map(np.asarray, _adam_mu(state["opt_state"])))
            grads = {k: v / ((1 - B1) * clip) for k, v in mu.items()}
    final = convert._flatten(jax.tree.map(np.asarray, state["params"]))
    merged = None
    if base:
        merged = convert._flatten(jax.tree.map(np.asarray, jlora.merge_lora(
            _unflatten(base), _unflatten(final), ALPHA, RANK)))
    return np.array(losses), np.array(norms), final, grads, merged


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_lora")
    bpath = tmp / "batches.npy"
    np.save(bpath, _batches())
    cases, todo, keys = [], {}, {}
    for name, over, mesh, both, extra in CASES:
        weights = tmp / f"qwen{over.get('d_model', '')}.npz"
        if not weights.exists():
            np.savez(weights, **_init("qwen-tiny", over))
        case = {"name": name, "kind": "train", "mesh": mesh, "batches": str(bpath),
                "model_cfg": over, "held": True,
                "cfg": {**_KW, "model_name": "qwen-tiny",
                        "micro_batch_size": ROWS // (mesh.get("data", 1) * mesh.get("fsdp", 1)),
                        **both, **extra}}
        if "lora_rank" in both:
            adapters = tmp / "adapters.npz"
            if not adapters.exists():
                np.savez(adapters, **_adapters(_jcfg("qwen-tiny", over)))
            case.update(init=str(adapters), base=str(weights), grads=True, merged=True)
        else:
            case.update(init=str(weights))
        cases.append(case)
        keys[name] = key = json.dumps([over, both], sort_keys=True)
        todo[key] = (over, case["init"], case.get("base"), both)

    def references():  # JAX's runs (one a configuration), while the ranks run theirs
        return {key: _jax_run(over, dict(np.load(init)), dict(np.load(base)) if base else None,
                              np.load(bpath), **both)
                for key, (over, init, base, both) in todo.items()}

    got, refs = spawn({"cases": cases}, WORLD, tmp, timeout=180, during=references)
    return {name: ([got[(name, r)] for r in range(WORLD)], refs[keys[name]])
            for name in _NAMES}


@pytest.mark.parametrize("case", _NAMES)
def test_steps_match_jax(runs, case):
    """Losses, gradient norms and every final trainable weight of three
    steps, on every rank, against JAX's single-device program."""
    ranks, (losses, norms, weights, _, _) = runs[case]
    for out in ranks:
        np.testing.assert_allclose(out["losses"], losses, rtol=1e-6)
        np.testing.assert_allclose(out["norms"], norms, rtol=1e-5)
    for k, want in weights.items():
        for out in ranks:
            np.testing.assert_allclose(out[f"param:{k}"], want, atol=1e-6, rtol=0, err_msg=k)


@pytest.mark.parametrize("case", ["lora_data2", "lora_fsdp2_s3"])
def test_adapter_gradients_match_jax(runs, case):
    """Every adapter gradient of the first batch, reduced as the step
    reduces it (the partial factors summed over ``model``) and gathered
    whole, on every rank, against JAX's."""
    ranks, (_, _, _, grads, _) = runs[case]
    for k, want in grads.items():
        top = np.abs(want).max()
        for out in ranks:
            np.testing.assert_allclose(out[f"grad:{k}"], want, atol=1e-5 * top, rtol=0,
                                       err_msg=k)


def test_adapters_split_with_their_projections(runs):
    """At stage 0 a rank holds ``convert.model_block_np`` of the adapters:
    B of q/k/v/gate/up on its columns (A whole), A of o/down on its rows (B
    whole); the partial factors are the ones ``model_partial`` names."""
    ranks, _ = runs["lora_data2"]
    cfg = tcfg.MODEL_CONFIGS["qwen-tiny"]
    flat = _adapters(_jcfg("qwen-tiny", {}))
    for r, out in enumerate(ranks):
        want = convert.model_block_np(flat, cfg, 2, _coords(dict(data=2, model=2), r)["model"])
        for k, v in want.items():
            np.testing.assert_array_equal(out[f"held:{k}"], v, err_msg=f"rank {r} {k}")
    logical = tsh.lora_logical_axes(tsh.logical_axes(cfg), TARGETS)
    split = tsh.model_split(cfg, logical, 2)
    assert split["layers.q.B"] == 2 and split["layers.q.A"] is None
    assert split["layers.o.A"] == 1 and split["layers.o.B"] is None
    assert tsh.model_partial(cfg, logical, 2) == frozenset(
        {f"layers.{t}.A" for t in ("q", "k", "v", "gate", "up")}
        | {"layers.o.B", "layers.down.B"})


@pytest.mark.parametrize("case", ["lora_data2", "lora_fsdp2_s3"])
def test_merged_params_are_the_ranks_block(runs, case):
    """``merged_params`` on a ``model`` mesh gives each rank its block of
    the merged tree, JAX's ``merge_lora`` of the final adapters cut by
    ``convert.model_block_np``."""
    ranks, (_, _, _, _, merged) = runs[case]
    cfg = tcfg.MODEL_CONFIGS["qwen-tiny"]
    mesh = next(c[2] for c in CASES if c[0] == case)
    for r, out in enumerate(ranks):
        want = convert.model_block_np(merged, cfg, 2, _coords(mesh, r)["model"])
        for k, v in want.items():
            np.testing.assert_allclose(out[f"merged:{k}"], v, atol=1e-6, rtol=0,
                                       err_msg=f"rank {r} {k}")


def test_adafactor_factors_on_the_whole_shape():
    """Whether a leaf's moment is factored is decided on its whole shape:
    the widened q kernel [2, 128, 128] is factored over (in, out), where
    its block on model=2, [2, 128, 64], alone would not be (64 < 128), and
    ``model`` splits dim 2, one of the two reduced."""
    cfg = tcfg.MODEL_CONFIGS["qwen-tiny"].with_(**WIDE)
    whole = tsh.whole_shapes(cfg)["layers.q.kernel"]
    assert ttrain.factored_dims(whole) == (1, 2)
    assert tsh.model_split(cfg, tsh.logical_axes(cfg), 2)["layers.q.kernel"] == 2
    assert ttrain.factored_dims((2, 128, 64)) is None
