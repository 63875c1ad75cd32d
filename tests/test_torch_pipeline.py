"""Port parity: pipelines over the mesh's ``pipe`` axis, one rank a stage
(``tpu_engine_torch/parallel/pipeline.py``, ``pipeline_1f1b.py``,
``pipeline_zb.py``), on four ``gloo`` ranks on the CPU, against the JAX
package.

One spawn of four ranks (``tests/torch_mesh_worker.py``) runs every case
under each schedule (``gpipe``, ``1f1b``, ``zb``): qwen-tiny on (data=2,
pipe=2) at stage 0, on (fsdp=2, pipe=2) at stages 1, 2 and 3, on (model=2,
pipe=2), and with a ring and with Ulysses over (sequence=2, pipe=2);
moe-tiny on (model=2, pipe=2) in
dense dispatch (two experts a rank, its aux loss on each stage); a 4-layer
qwen-tiny on pipe=4 (a layer a stage) at 4 and 8 microbatches (zb's stash
holds up to three deferred weight gradients on stage 0); and gemma-tiny on
(data=2, pipe=2), whose tied table lives on both end stages. Each case
takes three AdamW steps at lr 1e-3 from JAX's initial weights on the same
global batches (SFT-masked positions included), and its first batch's
gradients are gathered whole.

The reference of every case is JAX's single-device program at the same
global batch and accumulation (JAX's own pipelines equal it,
``tests/test_pipeline.py``). JAX's gradient of the first batch is read
from its Adam state after step 0, whose learning rate is 0. Bounds, the
AdamW parity bounds of tests/test_torch_train.py: losses within rtol
1e-6, gradient norms 1e-5, every final weight within 1e-6; every gradient
leaf within 1e-5 of its largest entry.

The pure functions (``zb_op_table``, ``schedule_account``,
``resolve_pipeline_schedule``) are held to JAX's without ranks, and every
refusal JAX makes on a ``pipe`` mesh raises JAX's message.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_engine import train as jtrain  # noqa: E402
from tpu_engine.mesh_runtime import MeshConfig, MeshRuntime  # noqa: E402
from tpu_engine.parallel import pipeline_zb as jzb  # noqa: E402
from tpu_engine.sharding import TPUTrainConfig  # noqa: E402
from tpu_engine.sharding import resolve_pipeline_schedule as jresolve  # noqa: E402
from tpu_engine_torch import sharding as tsh  # noqa: E402
from tpu_engine_torch import train as ttrain  # noqa: E402
from tpu_engine_torch.mesh_runtime import MeshConfig as TMeshConfig  # noqa: E402
from tpu_engine_torch.models import config as tcfg  # noqa: E402
from tpu_engine_torch.models import convert  # noqa: E402
from tpu_engine_torch.parallel import pipeline_zb as tzb  # noqa: E402
from test_torch_mesh_train import _unflatten  # noqa: E402
from test_torch_tp_train import _adam_mu, _init, _jcfg  # noqa: E402
from torch_mesh_worker import spawn  # noqa: E402

WORLD = 4
STEPS = 3
ROWS, SEQ = 4, 32
B1 = 0.9
SCHEDULES = ("gpipe", "1f1b", "zb")
_KW = dict(seq_len=SEQ, precision="fp32", attention_impl="xla", learning_rate=1e-3,
           min_lr=1e-4, warmup_steps=1, total_steps=8, weight_decay=0.1, beta1=B1,
           activation_checkpointing=True)
FOUR = {"n_layers": 4}
# (case, model, config fields changed, mesh, port-only fields, microbatches)
CASES = [
    ("data2", "qwen-tiny", {}, dict(data=2, pipe=2), dict(sharding_stage=0), 4),
    ("fsdp2_s1", "qwen-tiny", {}, dict(fsdp=2, pipe=2), dict(sharding_stage=1), 4),
    ("fsdp2_s2", "qwen-tiny", {}, dict(fsdp=2, pipe=2), dict(sharding_stage=2), 4),
    ("fsdp2_s3", "qwen-tiny", {}, dict(fsdp=2, pipe=2), dict(sharding_stage=3), 4),
    ("model2", "qwen-tiny", {}, dict(model=2, pipe=2), {}, 4),
    ("ring2", "qwen-tiny", {}, dict(sequence=2, pipe=2), {}, 4),
    ("ulysses2", "qwen-tiny", {}, dict(sequence=2, pipe=2), dict(attention_impl="ulysses"), 4),
    ("moe_model2", "moe-tiny", {}, dict(model=2, pipe=2), dict(moe_impl="dense"), 4),
    ("pipe4_m4", "qwen-tiny", FOUR, dict(pipe=4), {}, 4),
    ("pipe4_m8", "qwen-tiny", FOUR, dict(pipe=4), {}, 8),
    ("gemma", "gemma-tiny", {}, dict(data=2, pipe=2), {}, 4),
]
_REF_FIELDS = ("moe_impl",)
_RUNS = [f"{c[0]}.{s}" for c in CASES for s in SCHEDULES]


def _batches(accum: int, vocab: int = 512) -> np.ndarray:
    rng = np.random.default_rng(0)
    b = rng.integers(0, vocab, (STEPS, accum, ROWS, SEQ)).astype(np.int32)
    b[:, 0, 1, 3:9] = -b[:, 0, 1, 3:9] - 1      # masked in the first microbatch
    b[:, -1, 2, 20:27] = -b[:, -1, 2, 20:27] - 1  # and in the last
    return b


def _jax_run(model: str, over: dict, flat: dict, batches: np.ndarray, **extra):
    """JAX's single-device program from ``flat``: losses, norms, final flat
    weights, the first batch's gradients."""
    cfg = TPUTrainConfig(model_name=model, micro_batch_size=ROWS, mesh=MeshConfig(data=1),
                         gradient_accumulation_steps=batches.shape[1], **{**_KW, **extra})
    prog = jtrain.build_train_program(cfg, _jcfg(model, over),
                                      runtime=MeshRuntime(cfg.mesh, devices=jax.devices()[:1]))
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
    held_out = float(prog.eval_step(state, jax.device_put(jnp.asarray(batches[0]),
                                                          prog.batch_sharding)))
    return (np.array(losses), np.array(norms),
            convert._flatten(jax.tree.map(np.asarray, state["params"])), grads, held_out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    cases, keys, todo = [], {}, {}
    for name, model, over, mesh, extra, accum in CASES:
        bpath = tmp / f"batches{accum}.npy"
        if not bpath.exists():
            np.save(bpath, _batches(accum))
        ref_extra = {k: v for k, v in extra.items() if k in _REF_FIELDS}
        key = keys[name] = (model, tuple(sorted(over.items())), accum,
                            tuple(sorted(ref_extra.items())))
        init = tmp / f"{model}{over.get('n_layers', '')}.npz"
        if not init.exists():
            np.savez(init, **_init(model, over))
        todo.setdefault(key, (model, over, init, bpath, ref_extra))
        dp = mesh.get("data", 1) * mesh.get("fsdp", 1)
        for sched in SCHEDULES:
            cases.append({"name": f"{name}.{sched}", "kind": "train", "mesh": mesh,
                          "init": str(init), "batches": str(bpath), "grads": True,
                          "model_cfg": over, "held": sched == "gpipe",
                          "cfg": {**_KW, "model_name": model, "micro_batch_size": ROWS // dp,
                                  "gradient_accumulation_steps": accum,
                                  "pipeline_schedule": sched, **extra}})

    def references():  # JAX's runs, while the ranks run theirs
        return {key: _jax_run(model, over, dict(np.load(init)), np.load(bpath), **ref_extra)
                for key, (model, over, init, bpath, ref_extra) in todo.items()}

    got, refs = spawn({"cases": cases}, WORLD, tmp, timeout=240, during=references)
    return {run: ([got[(run, r)] for r in range(WORLD)], refs[keys[run.split(".")[0]]])
            for run in _RUNS}


@pytest.mark.parametrize("run", _RUNS)
def test_steps_match_jax(runs, run):
    """Losses, gradient norms and every final weight of three AdamW steps,
    and the held-out loss of the first batch after them (the stages'
    forward alone), on every rank, against JAX's single-device program;
    every rank reports the same loss and norm, and the schedule is the one
    asked for."""
    ranks, (losses, norms, weights, _, held_out) = runs[run]
    for out in ranks:
        assert str(out["schedule"]) == run.split(".")[1]
        np.testing.assert_allclose(out["losses"], losses, rtol=1e-6)
        np.testing.assert_allclose(out["norms"], norms, rtol=1e-5)
        np.testing.assert_allclose(float(out["eval"]), held_out, rtol=1e-6)
        np.testing.assert_array_equal(out["losses"], ranks[0]["losses"])
        np.testing.assert_array_equal(out["norms"], ranks[0]["norms"])
    for k, want in weights.items():
        for out in ranks:
            np.testing.assert_allclose(out[f"param:{k}"], want, atol=1e-6, rtol=0, err_msg=k)


@pytest.mark.parametrize("run", _RUNS)
def test_gradients_match_jax(runs, run):
    """Every gradient leaf of the first batch, reduced as the step reduces
    it (a tied table summed over the end stages) and gathered whole, on
    every rank, against JAX's."""
    ranks, (_, _, _, grads, _) = runs[run]
    for k, want in grads.items():
        top = np.abs(want).max()
        for out in ranks:
            got = out[f"grad:{k}"]
            assert got.shape == want.shape, k
            np.testing.assert_allclose(got, want, atol=1e-5 * top, rtol=0, err_msg=k)


def _coords(mesh: dict, rank: int) -> dict:
    shape = [mesh.get(a, 1) for a in ("data", "fsdp", "pipe", "sequence", "model")]
    shape[0] = WORLD // int(np.prod(shape[1:]))
    return dict(zip(("data", "fsdp", "pipe", "sequence", "model"),
                    np.unravel_index(rank, shape)))


@pytest.mark.parametrize("case", ["data2", "model2", "pipe4_m4", "gemma"])
def test_each_rank_holds_its_stage(runs, case):
    """A rank holds its stage's block of every stacked leaf and the outer
    leaves its stage uses (``convert.stage_block_np``; gemma's tied table
    on both end stages), cut to its ``model`` block
    (``convert.model_block_np``)."""
    _, model, over, mesh, _, _ = next(c for c in CASES if c[0] == case)
    cfg = tcfg.MODEL_CONFIGS[model].with_(**over) if over else tcfg.MODEL_CONFIGS[model]
    flat = _init(model, over)
    ranks, _ = runs[f"{case}.gpipe"]
    for r, out in enumerate(ranks):
        c = _coords(mesh, r)
        want = convert.stage_block_np(flat, cfg, mesh["pipe"], c["pipe"])
        want = convert.model_block_np(want, cfg, mesh.get("model", 1), c["model"])
        held = {k[len("held:"):]: v for k, v in out.items() if k.startswith("held:")}
        assert set(held) == set(want), r
        for k, v in want.items():
            np.testing.assert_array_equal(held[k], v, err_msg=f"rank {r} {k}")
    if case == "gemma":
        assert all("embed.embedding" in {k[5:] for k in out if k.startswith("held:")}
                   for out in ranks)


def test_stage3_regathers_on_every_visit(runs):
    """At stage 3 a stage gathers a layer on every visit of a microbatch,
    and the embedding at every call that embeds: on the first stage of
    (fsdp=2, pipe=2) with M = 4, GPipe visits its layer twice a
    microbatch (the forward and the checkpoint's recompute) and embeds
    once; 1F1B three times (its forward without a graph, then the
    backward's forward and recompute) and embeds twice; zb as 1F1B plus
    two visits of its one deferred W. The all-gather bytes of a step
    (``collectives.moved``, the share a rank moves: half of each gathered
    fp32 leaf) are exactly those counts."""
    cfg = tcfg.MODEL_CONFIGS["qwen-tiny"]
    flat = _init("qwen-tiny", {})
    specs = tsh.opt_state_pspecs(tsh.logical_axes(cfg), tsh.ShardingStage.OPTIMIZER_STATE)
    split = [k for k, sp in specs.items() if tsh.fsdp_dim(sp) is not None]
    layer = sum(flat[k][0].nbytes for k in split if k.startswith("layers.")) // 2
    embed = flat["embed.embedding"].nbytes // 2
    M = 4
    want = {"gpipe": embed * M + layer * 2 * M, "1f1b": embed * 2 * M + layer * 3 * M,
            "zb": embed * 2 * M + layer * (3 * M + 2)}
    mesh = dict(fsdp=2, pipe=2)
    for sched, bytes_ in want.items():
        ranks, _ = runs[f"fsdp2_s3.{sched}"]
        for r, out in enumerate(ranks):
            if _coords(mesh, r)["pipe"] == 0:
                assert int(out["moved:all_gather"]) == bytes_, (sched, r)


@pytest.mark.parametrize("P,M", [(2, 2), (2, 4), (4, 4), (4, 8), (4, 2), (3, 5)])
def test_zb_op_table_and_account_equal_jax(P, M):
    """``zb_op_table`` and ``schedule_account`` (every schedule) equal
    JAX's, on tests/test_pipeline_zb.py's combinations; each microbatch's
    F, backward halves and W land once a stage in the port's tables."""
    assert tzb.zb_op_table(P, M) == jzb.zb_op_table(P, M)
    for sched in SCHEDULES:
        assert tzb.schedule_account(sched, P, M) == jzb.schedule_account(sched, P, M)
    for p in range(P):
        ops = [op for row in tzb.zb_table(P, M) for op in row[p]]
        for m in range(M):
            assert ("F", m) in ops
            assert (("BW", m) in ops) != (("B", m) in ops and ("W", m) in ops)


def test_resolve_pipeline_schedule_equals_jax():
    """``"auto"`` resolves as JAX's resolver on the grid of
    tests/test_pipeline.py::test_auto_schedule_selection, and explicit
    choices are kept."""
    grid = [
        (dict(pipe=2, data=2, fsdp=2), {}),
        (dict(pipe=2, data=2, fsdp=2), dict(gradient_accumulation_steps=2)),
        (dict(data=2, fsdp=2, model=2), {}),
        (dict(pipe=2, data=2, fsdp=2), dict(loss_chunk_size=32)),
        (dict(pipe=2, data=2, fsdp=2), dict(precision="bf16", param_dtype="fp32",
                                            grad_allreduce_dtype="bf16")),
        (dict(pipe=2, data=2, fsdp=2), dict(pipeline_schedule="1f1b")),
        (dict(pipe=2, data=2, fsdp=2), dict(pipeline_schedule="gpipe")),
        (dict(pipe=4), dict(gradient_accumulation_steps=8)),
        (dict(pipe=4), dict(gradient_accumulation_steps=4)),
    ]
    for mesh, kw in grid:
        base = {**dict(model_name="gpt-tiny", micro_batch_size=2, seq_len=64,
                       gradient_accumulation_steps=4), **kw}
        want = jresolve(TPUTrainConfig(mesh=MeshConfig(**mesh), **base))
        if kw.get("grad_allreduce_dtype"):  # the port refuses the reduced dtype itself
            port = TMeshConfig(**mesh)
            got = tsh.resolve_pipeline_schedule(
                type("C", (), dict(base, mesh=port, quant_training="none",
                                   loss_chunk_size=None, pipeline_schedule="auto"))())
        else:
            got = tsh.resolve_pipeline_schedule(
                ttrain.TrainConfig(mesh=TMeshConfig(**mesh), **base))
        assert got == want, (mesh, kw)


_TKW = dict(model_name="qwen-tiny", micro_batch_size=2, seq_len=32,
            gradient_accumulation_steps=4)


def _jax_error(mesh: dict, **kw) -> str:
    n = int(np.prod(list(mesh.values())))
    cfg = TPUTrainConfig(mesh=MeshConfig(**mesh), **{**_TKW, **kw})
    with pytest.raises(ValueError) as info:
        jtrain.build_train_program(cfg, runtime=MeshRuntime(cfg.mesh,
                                                            devices=jax.devices()[:n]))
    return str(info.value)


def _port_error(mesh: dict, **kw) -> str:
    with pytest.raises(ValueError) as info:
        ttrain.build_train_program(ttrain.TrainConfig(mesh=TMeshConfig(**mesh),
                                                      **{**_TKW, **kw}), device="cpu")
    return str(info.value)


@pytest.mark.parametrize("name,mesh,kw", [
    ("layers", dict(pipe=4), {}),
    ("lora", dict(pipe=2), dict(lora_rank=4)),
    ("param_offload", dict(pipe=2), dict(param_offload="host")),
    ("disk", dict(pipe=2), dict(optimizer_offload="disk", optimizer_spill_dir="/nonexistent")),
    ("1f1b_chunk", dict(pipe=2), dict(pipeline_schedule="1f1b", loss_chunk_size=8)),
    ("zb_chunk", dict(pipe=2), dict(pipeline_schedule="zb", loss_chunk_size=8)),
])
def test_pipe_refusals_raise_jax_messages(name, mesh, kw):
    """Each combination JAX refuses on a ``pipe`` mesh raises JAX's
    ``ValueError`` with JAX's message in the port (before any process
    group is needed)."""
    assert _port_error(mesh, **kw) == _jax_error(mesh, **kw)


def test_reduced_grad_dtype_with_manual_schedule_raises_jax_message():
    """A reduced ``grad_allreduce_dtype`` with 1f1b raises JAX's message
    (from the config, where the port checks the dtype)."""
    kw = dict(precision="bf16", param_dtype="fp32", grad_allreduce_dtype="bf16",
              pipeline_schedule="1f1b")
    want = _jax_error(dict(pipe=2), **kw)
    with pytest.raises(ValueError) as info:
        ttrain.TrainConfig(mesh=TMeshConfig(pipe=2), **{**_TKW, **kw})
    assert str(info.value) == want
    with pytest.raises(ValueError, match="pipeline_schedule"):
        ttrain.TrainConfig(pipeline_schedule="interleaved", **_TKW)
