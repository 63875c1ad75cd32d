"""Port parity: tensor and expert parallelism over the mesh's ``model``
axis (``tpu_engine_torch/parallel/tensor_parallel.py``), on four ``gloo``
ranks on the CPU, against the JAX package.

One spawn of four ranks (``tests/torch_mesh_worker.py``) runs every case:
qwen-tiny on (data=2, model=2) at stage 0, on (fsdp=2, model=2) at stage 3
and on model=4 (its two kv heads kept whole, each rank reading one); gemma-
tiny on model=2 (one kv head, the tied head vocabulary-parallel); gpt2-tiny
on model=2 (biases added once after the sum) and with a vocabulary of 509,
which does not split (table and head whole on every rank); the ring and
Ulysses across (sequence=2, model=2); moe-tiny on (fsdp=2, model=2) in
dense dispatch, two experts a rank, with its aux loss; and the chunked
loss with a z-loss. Each case takes three AdamW steps at lr 1e-3 from
JAX's initial weights on the same global batches (SFT-masked positions
included), and its first batch's gradients are gathered whole.

The reference of every case is JAX's single-device program at the same
global batch (``test_jax_model_mesh_equals_single_device``, ``slow``, shows
JAX's own 8-device mesh at model=2 gives it). JAX's gradient of the first
batch is read from its Adam state after step 0, whose learning rate is 0:
mu = (1 - b1) · g · min(1, clip / norm). Bounds: losses within rtol 1e-6,
gradient norms 1e-5 and every final weight within 1e-6, the AdamW parity
bounds of tests/test_torch_train.py; every gradient leaf within 1e-5 of
its largest entry (fp32 sums in other orders). gpt2's k bias has an
exactly zero gradient (tests/test_torch_archs.py, ``ZERO_GRAD``): held to
zero, its weight to its init. With the z-loss the port's own single-device
program ends 1.63e-6 from JAX's on these weights (Adam turns a last-bit
difference of a small gradient into a larger one, tests/test_torch_train.py);
that case's weights are held within 1e-6 of the port's single-device run
and within ``ZLOSS_JAX_ATOL`` of JAX's.
"""

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
from tpu_engine_torch import train as ttrain  # noqa: E402
from tpu_engine_torch.mesh_runtime import MeshConfig as TMeshConfig  # noqa: E402
from tpu_engine_torch.models import config as tcfg  # noqa: E402
from tpu_engine_torch.models import convert  # noqa: E402
from test_torch_mesh_train import _unflatten  # noqa: E402
from torch_mesh_worker import spawn  # noqa: E402

WORLD = 4
STEPS = 3
ROWS, SEQ, ACCUM = 4, 32, 2
B1 = 0.9
ZERO_GRAD = "layers.k.bias"
_KW = dict(gradient_accumulation_steps=ACCUM, seq_len=SEQ, precision="fp32",
           attention_impl="xla", learning_rate=1e-3, min_lr=1e-4, warmup_steps=1,
           total_steps=8, weight_decay=0.1, beta1=B1, activation_checkpointing=True)
ODD_VOCAB = 509
ZLOSS_JAX_ATOL = 2e-6
# (case, model, config fields changed, mesh, port-only fields); the fields
# of _REF_FIELDS change the numbers and key JAX's reference.
CASES = [
    ("data_s0", "qwen-tiny", {}, dict(data=2, model=2), dict(sharding_stage=0)),
    ("fsdp_s3", "qwen-tiny", {}, dict(fsdp=2, model=2), dict(sharding_stage=3)),
    ("model4", "qwen-tiny", {}, dict(model=4), {}),
    ("gemma", "gemma-tiny", {}, dict(model=2, data=2), {}),
    ("gpt2", "gpt2-tiny", {}, dict(model=2, fsdp=2), dict(sharding_stage=2)),
    ("gpt2_odd_vocab", "gpt2-tiny", dict(vocab_size=ODD_VOCAB), dict(model=2, data=2), {}),
    ("ring", "qwen-tiny", {}, dict(sequence=2, model=2), {}),
    ("ulysses", "qwen-tiny", {}, dict(sequence=2, model=2), dict(attention_impl="ulysses")),
    ("moe", "moe-tiny", {}, dict(fsdp=2, model=2), dict(moe_impl="dense")),
    ("chunk_zloss", "qwen-tiny", {}, dict(data=2, model=2),
     dict(loss_chunk_size=8, z_loss_coef=1e-3, sharding_stage=1)),
]
_REF_FIELDS = ("moe_impl", "loss_chunk_size", "z_loss_coef")


def _batches(vocab: int = 512) -> np.ndarray:
    rng = np.random.default_rng(0)
    b = rng.integers(0, vocab, (STEPS, ACCUM, ROWS, SEQ)).astype(np.int32)
    b[:, 0, 1, 3:9] = -b[:, 0, 1, 3:9] - 1      # masked in the first half
    b[:, 1, 2, 20:27] = -b[:, 1, 2, 20:27] - 1  # and in the second
    return b


def _jcfg(model: str, over: dict):
    return jtfm.MODEL_CONFIGS[model].with_(**over) if over else jtfm.MODEL_CONFIGS[model]


def _init(model: str, over: dict) -> dict:
    """JAX's init, norm scales and biases moved off their constants (so
    that each gradient means something), the router drawn wider (clear
    routing margins, tests/test_torch_moe.py)."""
    tree = jax.tree.map(np.asarray, jtfm.init_params(jax.random.PRNGKey(0), _jcfg(model, over)))
    flat = convert._flatten(tree)
    rng = np.random.default_rng(1)
    for k in flat:
        if k.rsplit(".", 1)[-1] in ("scale", "bias"):
            flat[k] = (flat[k] + 0.1 * rng.standard_normal(flat[k].shape)).astype(np.float32)
    if "layers.router.kernel" in flat:
        flat["layers.router.kernel"] = flat["layers.router.kernel"] * 5.0
    return flat


def _adam_mu(opt_state):
    """The ``mu`` tree of the Adam state in an optax chain's state."""
    if hasattr(opt_state, "mu"):
        return opt_state.mu
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            mu = _adam_mu(s)
            if mu is not None:
                return mu
    return None


def _jax_run(model: str, over: dict, flat: dict, batches: np.ndarray, mesh=None, devices=1,
             **extra):
    """JAX's program (single device unless ``mesh``) from ``flat``:
    losses, norms, final flat weights, the first batch's gradients."""
    mesh = mesh or {"data": 1}
    cfg = TPUTrainConfig(model_name=model, micro_batch_size=ROWS // (
        mesh.get("data", 1) * mesh.get("fsdp", 1)), mesh=MeshConfig(**mesh), **{**_KW, **extra})
    prog = jtrain.build_train_program(cfg, _jcfg(model, over),
                                      runtime=MeshRuntime(cfg.mesh, devices=jax.devices()[:devices]))
    state = prog.init(jax.random.PRNGKey(0))
    state["params"] = jax.device_put(jax.tree.map(jnp.asarray, _unflatten(flat)),
                                     jax.tree.map(lambda a: a.sharding, state["params"]))
    losses, norms, grads = [], [], None
    for b in batches:
        state, m = prog.step(state, jax.device_put(jnp.asarray(b), prog.batch_sharding))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if grads is None:  # step 0 has lr 0: its Adam mu holds the clipped gradient
            clip = min(1.0, cfg.grad_clip_norm / norms[0])
            mu = convert._flatten(jax.tree.map(np.asarray, _adam_mu(state["opt_state"])))
            grads = {k: v / ((1 - B1) * clip) for k, v in mu.items()}
    return (np.array(losses), np.array(norms),
            convert._flatten(jax.tree.map(np.asarray, state["params"])), grads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_train")
    cases, keys, todo = [], {}, {}
    for name, model, over, mesh, extra in CASES:
        vocab = over.get("vocab_size", 512)
        bpath = tmp / f"batches{vocab}.npy"
        if not bpath.exists():
            np.save(bpath, _batches(vocab))
        ref_extra = {k: v for k, v in extra.items() if k in _REF_FIELDS}
        key = keys[name] = (model, tuple(sorted(over.items())), tuple(sorted(ref_extra.items())))
        init = tmp / f"{model}{vocab}.npz"
        if not init.exists():
            np.savez(init, **_init(model, over))
        todo.setdefault(key, (model, over, init, bpath, ref_extra))
        dp = mesh.get("data", 1) * mesh.get("fsdp", 1)
        cases.append({"name": name, "kind": "train", "mesh": mesh, "init": str(init),
                      "batches": str(bpath), "grads": True, "model_cfg": over,
                      "cfg": {**_KW, "model_name": model, "micro_batch_size": ROWS // dp,
                              **extra}})

    def references():  # JAX's runs, while the ranks run theirs
        refs = {key: _jax_run(model, over, dict(np.load(init)), np.load(bpath), **ref_extra)
                for key, (model, over, init, bpath, ref_extra) in todo.items()}
        model, over, init, bpath, ref_extra = todo[keys["chunk_zloss"]]
        refs["port_zloss"] = _port_run(model, dict(np.load(init)), np.load(bpath), **ref_extra)
        return refs

    got, refs = spawn({"cases": cases}, WORLD, tmp, during=references)
    out = {name: ([got[(name, r)] for r in range(WORLD)], refs[keys[name]])
           for name, *_ in CASES}
    out["port_zloss"] = refs["port_zloss"]
    return out


def _port_run(model: str, flat: dict, batches: np.ndarray, **extra) -> dict:
    """The port's single-device program from ``flat``: its final weights."""
    prog = ttrain.build_train_program(ttrain.TrainConfig(
        model_name=model, micro_batch_size=ROWS, **{**_KW, **extra}), device="cpu")
    state = prog.init(params={k: torch.tensor(v) for k, v in flat.items()})
    for b in batches:
        state, _ = prog.step(state, torch.tensor(b, dtype=torch.long))
    return {k: p.detach().numpy() for k, p in state["params"].items()}


_NAMES = [c[0] for c in CASES]


@pytest.mark.parametrize("case", _NAMES)
def test_steps_match_jax(runs, case):
    """Losses, gradient norms and every final weight of three AdamW steps,
    on every rank, against JAX's single-device program."""
    ranks, (losses, norms, weights, _) = runs[case]
    _, model, over, _, _ = next(c for c in CASES if c[0] == case)
    atol = ZLOSS_JAX_ATOL if case == "chunk_zloss" else 1e-6
    for out in ranks:
        np.testing.assert_allclose(out["losses"], losses, rtol=1e-6)
        np.testing.assert_allclose(out["norms"], norms, rtol=1e-5)
    for k, want in weights.items():
        for out in ranks:
            got = out[f"param:{k}"]
            if k == ZERO_GRAD:  # moved by Adam-scaled rounding noise alone, in both
                start = _init(model, over)[k]
                assert np.abs(got - start).max() < 1e-5 and np.abs(want - start).max() < 1e-5
                continue
            np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=k)
            if case == "chunk_zloss":
                np.testing.assert_allclose(got, runs["port_zloss"][k], atol=1e-6, rtol=0,
                                           err_msg=k)


@pytest.mark.parametrize("case", _NAMES)
def test_gradients_match_jax(runs, case):
    """Every gradient leaf of the first batch, reduced as the step reduces
    it and gathered whole, on every rank, against JAX's."""
    ranks, (_, _, _, grads) = runs[case]
    for k, want in grads.items():
        top = np.abs(want).max()
        for out in ranks:
            got = out[f"grad:{k}"]
            assert got.shape == want.shape, k
            if k == ZERO_GRAD:
                assert np.abs(got).max() < 1e-6 * max(
                    np.abs(g).max() for g in grads.values()), k
                continue
            np.testing.assert_allclose(got, want, atol=1e-5 * top, rtol=0, err_msg=k)


def test_each_rank_holds_one_model_share_of_each_split_leaf(runs):
    """On model=4 (stage 3, no fsdp) every leaf the rule splits is a
    quarter on each rank, whole otherwise; qwen-tiny's two kv heads stay
    whole; on (fsdp=2, model=2) at stage 3 a leaf split on both holds a
    quarter."""
    from tpu_engine_torch import sharding

    cfg = tcfg.MODEL_CONFIGS["qwen-tiny"]
    whole = {k: int(np.prod(v.shape)) for k, v in _init("qwen-tiny", {}).items()}
    dims4 = sharding.model_split(cfg, sharding.logical_axes(cfg), 4)
    assert dims4["layers.k.kernel"] is None and dims4["layers.q.kernel"] == 2
    assert dims4["embed.embedding"] == 0 and dims4["layers.down.kernel"] == 1
    for out in runs["model4"][0]:
        for k, n in whole.items():
            assert int(out[f"numel:{k}"]) * (4 if dims4[k] is not None else 1) == n, k
    for out in runs["fsdp_s3"][0]:
        assert int(out["numel:layers.q.kernel"]) * 4 == whole["layers.q.kernel"]
    moe = tcfg.MODEL_CONFIGS["moe-tiny"]
    dims = sharding.model_split(moe, sharding.logical_axes(moe), 2)
    assert dims["layers.gate.kernel"] == 1 and dims["layers.router.kernel"] is None
    assert "layers.router.kernel" in sharding.model_partial(moe, sharding.logical_axes(moe), 2)
    odd = tcfg.MODEL_CONFIGS["gpt2-tiny"].with_(vocab_size=ODD_VOCAB)
    assert sharding.model_split(odd, sharding.logical_axes(odd), 2)["embed.embedding"] is None


_TKW = dict(model_name="gpt-tiny", micro_batch_size=1, seq_len=32)


def test_model_axis_refusals():
    """Ragged MoE on model raises JAX's ValueError and heads that do not
    split raise NotImplementedError naming the cause; LoRA and
    Adafactor with a factored moment over a model-split leaf pass the
    refusals (they run: tests/test_torch_tp_lora.py) and reach the mesh's
    shape check (all before any process group is needed)."""
    moe = tcfg.MODEL_CONFIGS["moe-tiny"]
    mesh = TMeshConfig(model=2)
    with pytest.raises(ValueError, match="ragged_dot cannot shard over the expert dim"):
        ttrain.build_train_program(ttrain.TrainConfig(mesh=mesh, **_TKW),
                                   model_cfg=moe.with_(moe_impl="ragged"), device="cpu")
    with pytest.raises(ValueError, match="does not divide device count 1"):
        ttrain.build_train_program(ttrain.TrainConfig(mesh=mesh, lora_rank=4, **_TKW),
                                   device="cpu")
    wide = tcfg.MODEL_CONFIGS["gpt-tiny"].with_(d_model=128, d_ff=256)
    with pytest.raises(ValueError, match="does not divide device count 1"):
        ttrain.build_train_program(ttrain.TrainConfig(mesh=mesh, optimizer="adafactor", **_TKW),
                                   model_cfg=wide, device="cpu")
    with pytest.raises(NotImplementedError, match="n_heads=25"):
        ttrain.build_train_program(ttrain.TrainConfig(mesh=mesh, **{**_TKW,
                                                                    "model_name": "gpt2-xl"}),
                                   device="cpu")


@pytest.mark.slow
def test_jax_model_mesh_equals_single_device():
    """JAX's own program on an 8-device mesh (data=2, fsdp=2, model=2)
    gives its single-device numbers: the reference above stands for the
    mesh's."""
    flat, batches = _init("qwen-tiny", {}), _batches()
    one = _jax_run("qwen-tiny", {}, flat, batches)
    eight = _jax_run("qwen-tiny", {}, flat, batches, mesh=dict(data=2, fsdp=2, model=2),
                     devices=8)
    np.testing.assert_allclose(eight[0], one[0], rtol=1e-6)
    np.testing.assert_allclose(eight[1], one[1], rtol=1e-5)
    for k, want in one[2].items():
        np.testing.assert_allclose(eight[2][k], want, atol=1e-6, rtol=0, err_msg=k)
