"""Port parity: the training step on a mesh of four ``gloo`` ranks on the
CPU (``tpu_engine_torch/parallel/zero.py``) against the JAX package.

One spawn of four ranks (``tests/torch_mesh_worker.py``) runs every case:
ZeRO stages 0–3 on (data=2, fsdp=2), the ring across ranks on (fsdp=2,
sequence=2), Ulysses on (data=2, sequence=2), moe-tiny in dense and
ragged dispatch on (data=2, fsdp=2), LoRA adapters at stage 3, and
Adafactor under a named remat policy on the ring, each through three steps
at lr 1e-3 from JAX's initial weights on the same global batches
(SFT-masked positions included, so the valid-target count is global).

The reference of every case is JAX's single-device program at the same
global batch: GSPMD's result on a mesh is the single-device result, which
``test_jax_mesh_program_equals_single_device`` (``slow``) shows for stage 3
and for the ring on JAX's own meshes of four of the eight CPU devices.
Bounds: losses within rtol 1e-6 and every final weight within 1e-6, the
AdamW parity bounds of tests/test_torch_train.py."""

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
from tpu_engine_torch.models import convert  # noqa: E402
from torch_mesh_worker import spawn  # noqa: E402

WORLD = 4
STEPS = 3
ROWS, SEQ, ACCUM = 4, 32, 2
_KW = dict(gradient_accumulation_steps=ACCUM, seq_len=SEQ, precision="fp32",
           attention_impl="xla", learning_rate=1e-3, min_lr=1e-4, warmup_steps=1,
           total_steps=8, weight_decay=0.1, activation_checkpointing=True)
# (case, model, mesh, port-only fields); micro_batch_size makes every
# global batch ROWS rows.
CASES = [
    *((f"stage{s}", "gpt-tiny", dict(data=2, fsdp=2), dict(sharding_stage=s)) for s in range(4)),
    ("ring", "gpt-tiny", dict(fsdp=2, sequence=2), {}),
    ("ulysses", "gpt-tiny", dict(data=2, sequence=2), dict(attention_impl="ulysses")),
    ("moe_dense", "moe-tiny", dict(data=2, fsdp=2), dict(moe_impl="dense")),
    ("moe_ragged", "moe-tiny", dict(data=2, fsdp=2), dict(moe_impl="ragged")),
    ("lora", "gpt-tiny", dict(data=2, fsdp=2), dict(lora_rank=4, lora_alpha=8.0,
                                                    lora_targets=("q", "v"))),
    ("adafactor", "gpt-tiny", dict(fsdp=2, sequence=2),
     dict(optimizer="adafactor", sharding_stage=0, remat_policy="save_attn_out")),
]
# What each case's JAX reference is keyed by: the model and the fields that
# change its numbers (the stage and the mesh do not).
_REF_FIELDS = ("moe_impl", "lora_rank", "optimizer", "remat_policy")


def _batches() -> np.ndarray:
    rng = np.random.default_rng(0)
    b = rng.integers(0, 512, (STEPS, ACCUM, ROWS, SEQ)).astype(np.int32)
    b[:, 0, 1, 3:9] = -b[:, 0, 1, 3:9] - 1      # masked in the first half
    b[:, 1, 2, 20:27] = -b[:, 1, 2, 20:27] - 1  # and in the second
    return b


def _init(model: str) -> dict:
    tree = jax.tree.map(np.asarray, jtfm.init_params(jax.random.PRNGKey(0),
                                                     jtfm.MODEL_CONFIGS[model]))
    flat = convert._flatten(tree)
    if "layers.router.kernel" in flat:  # clear routing margins (tests/test_torch_moe.py)
        flat["layers.router.kernel"] = flat["layers.router.kernel"] * 5.0
    return flat


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for k, v in flat.items():
        node = tree
        *path, leaf = k.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


def _lora_init(model: str, extra: dict) -> dict:
    """JAX's adapters for ``extra``'s targets, B moved off zero so that A
    has a gradient from the first step."""
    from tpu_engine import lora as jlora

    tree = jlora.init_lora_params(jax.random.PRNGKey(1), jtfm.MODEL_CONFIGS[model],
                                  extra["lora_rank"], extra["lora_targets"])
    flat = convert._flatten(jax.tree.map(np.asarray, tree))
    rng = np.random.default_rng(2)
    return {k: (v + 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
            if k.endswith(".B") else v for k, v in flat.items()}


def _jax_run(model: str, flat: dict, batches: np.ndarray, mesh=None, devices=1, base=None,
             **extra):
    """JAX's program (single device unless ``mesh``) from ``flat`` (with
    ``base``: LoRA adapters on that frozen base): losses, norms, final flat
    weights, held-out loss of the first batch."""
    cfg = TPUTrainConfig(model_name=model, micro_batch_size=ROWS // (
        (mesh or {}).get("data", 1) * (mesh or {}).get("fsdp", 1)),
        mesh=MeshConfig(**(mesh or {"data": 1})), **{**_KW, **extra})
    prog = jtrain.build_train_program(
        cfg, runtime=MeshRuntime(cfg.mesh, devices=jax.devices()[:devices]),
        base_params=None if base is None else jax.tree.map(jnp.asarray, _unflatten(base)))
    state = prog.init(jax.random.PRNGKey(0))
    state["params"] = jax.device_put(jax.tree.map(jnp.asarray, _unflatten(flat)),
                                     jax.tree.map(lambda a: a.sharding, state["params"]))
    losses, norms = [], []
    for b in batches:
        state, m = prog.step(state, jax.device_put(jnp.asarray(b), prog.batch_sharding))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    held = float(prog.eval_step(state, jax.device_put(jnp.asarray(batches[0]),
                                                      prog.batch_sharding)))
    return (np.array(losses), np.array(norms),
            convert._flatten(jax.tree.map(np.asarray, state["params"])), held)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_train")
    batches = _batches()
    np.save(tmp / "batches.npy", batches)
    cases, keys, todo = [], {}, {}
    for name, model, mesh, extra in CASES:
        ref_extra = {k: extra[k] for k in extra if k in _REF_FIELDS or k.startswith("lora")}
        key = keys[name] = (model, tuple(sorted(ref_extra.items())))
        init, base = tmp / f"{model}.npz", None
        if not init.exists():
            np.savez(init, **_init(model))
        if "lora_rank" in extra:
            base, init = init, tmp / f"{name}.adapters.npz"
            np.savez(init, **_lora_init(model, extra))
        todo.setdefault(key, (model, init, base, ref_extra))
        dp = mesh.get("data", 1) * mesh.get("fsdp", 1)
        cases.append({"name": name, "kind": "train", "mesh": mesh, "init": str(init),
                      "base": None if base is None else str(base),
                      "batches": str(tmp / "batches.npy"),
                      "cfg": {**_KW, "model_name": model, "micro_batch_size": ROWS // dp,
                              **extra}})

    def references():  # JAX's runs, while the ranks run theirs
        return {key: _jax_run(model, dict(np.load(init)), batches,
                              base=None if base is None else dict(np.load(base)), **ref_extra)
                for key, (model, init, base, ref_extra) in todo.items()}

    got, refs = spawn({"cases": cases}, WORLD, tmp, during=references)
    return {name: ([got[(name, r)] for r in range(WORLD)], refs[keys[name]])
            for name, _, _, _ in CASES}


def _check(ranks: list, ref) -> None:
    losses, norms, weights, held = ref
    for out in ranks:  # every rank reports the step's global loss and norm
        np.testing.assert_allclose(out["losses"], losses, rtol=1e-6)
        np.testing.assert_allclose(out["norms"], norms, rtol=1e-5)
        np.testing.assert_allclose(float(out["eval"]), held, rtol=1e-6)
    for k, want in weights.items():
        for out in ranks:
            np.testing.assert_allclose(out[f"param:{k}"], want, atol=1e-6, rtol=0, err_msg=k)


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_zero_stage_matches_jax(runs, stage):
    """ZeRO stage ``stage`` on (data=2, fsdp=2): losses, gradient norms,
    the held-out loss and every final weight against JAX's single-device
    program at the same global batch."""
    _check(*runs[f"stage{stage}"])


def test_stage3_holds_one_fsdp_share_of_params_and_optimizer_state(runs):
    """At stage 3 each rank holds 1/fsdp of the parameter and of the
    optimizer bytes that stage 0 holds (every llama leaf has an ``embed``
    axis to split); stage 1 splits only the optimizer state."""
    fsdp = 2
    s0, s1, s3 = (runs[f"stage{s}"][0] for s in (0, 1, 3))
    for r in range(WORLD):
        assert int(s3[r]["param_bytes"]) * fsdp == int(s0[r]["param_bytes"])
        assert int(s3[r]["opt_bytes"]) * fsdp == int(s0[r]["opt_bytes"])
        assert int(s1[r]["param_bytes"]) == int(s0[r]["param_bytes"])
        assert int(s1[r]["opt_bytes"]) * fsdp == int(s0[r]["opt_bytes"])


def test_ring_across_ranks_matches_jax(runs):
    """Ring attention across the ``sequence`` ranks of (fsdp=2,
    sequence=2) at stage 3: each rank's positions and next-token targets
    (the last position of shard 0 predicts shard 1's first token)."""
    _check(*runs["ring"])


def test_ulysses_matches_jax(runs):
    """Ulysses attention (head↔sequence all-to-all) on (data=2,
    sequence=2)."""
    _check(*runs["ulysses"])


@pytest.mark.parametrize("impl", ["dense", "ragged"])
def test_moe_global_aux_matches_jax(runs, impl):
    """moe-tiny on (data=2, fsdp=2): the load-balancing loss's means over
    the whole microbatch (per-expert sums all-reduced before the product),
    weighted into the objective as JAX's, in ``impl`` dispatch."""
    _check(*runs[f"moe_{impl}"])


def test_lora_adapters_match_jax(runs):
    """LoRA (r 4 on q and v, the base frozen and whole on every rank) at
    stage 3 on (data=2, fsdp=2): the adapters are the trainable tree, as
    JAX's ``train_logical``, A split over fsdp along its ``embed`` axis."""
    _check(*runs["lora"])


def test_adafactor_and_named_remat_on_the_ring_match_jax(runs):
    """Adafactor (stage 0: its state whole on every rank) under the
    ``save_attn_out`` remat policy, with the ring across (fsdp=2,
    sequence=2)."""
    _check(*runs["adafactor"])


@pytest.mark.slow
@pytest.mark.parametrize("mesh", [dict(data=2, fsdp=2), dict(fsdp=2, sequence=2)],
                         ids=["stage3", "ring"])
def test_jax_mesh_program_equals_single_device(mesh):
    """JAX's own program on a 4-device mesh gives its single-device
    numbers: the reference above stands for the mesh's."""
    flat, batches = _init("gpt-tiny"), _batches()
    one = _jax_run("gpt-tiny", flat, batches)
    four = _jax_run("gpt-tiny", flat, batches, mesh=mesh, devices=4)
    np.testing.assert_allclose(four[0], one[0], rtol=1e-6)
    np.testing.assert_allclose(four[3], one[3], rtol=1e-6)
    for k, want in one[2].items():
        np.testing.assert_allclose(four[2][k], want, atol=1e-6, rtol=0, err_msg=k)
