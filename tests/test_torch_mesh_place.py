"""Port parity: where the training state lives on a mesh, against the JAX
package: the host placements (``optimizer_offload`` and ``param_offload``
"host") and the disk tier (``optimizer_offload="disk"``) on four ``gloo``
ranks (``tests/torch_mesh_worker.py``), (data=2, fsdp=2).

JAX places the masters and the optimizer state in ``pinned_host`` memory
with their ZeRO shardings; a rank of the port keeps its own shards in host
arenas, stage 3's stream uploading a shard before its gather. The disk
tier spills each rank's shards under ``proc<rank>`` and agrees across the
ranks by one all-reduce (MIN) of a boolean.

Bounds: ``tests/test_torch_mesh_train.py``'s against JAX's single-device
program at the same global batch (losses rtol 1e-6, gradient norms 1e-5,
every final weight 1e-6); the disk tier also against the port's in-memory
mesh step at JAX's own disk bounds (losses rtol 1e-5; weights rtol 2e-5,
atol 2e-6, ``tests/test_disk_offload.py``)."""

import types
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from test_torch_mesh_train import _batches, _check, _init, _jax_run  # noqa: E402
from tpu_engine import train as jtrain  # noqa: E402
from tpu_engine.mesh_runtime import MeshConfig  # noqa: E402
from tpu_engine.sharding import OffloadDevice, TPUTrainConfig  # noqa: E402
from tpu_engine_torch import mesh_runtime as tmr  # noqa: E402
from tpu_engine_torch import train as ttrain  # noqa: E402
from torch_mesh_worker import spawn  # noqa: E402

WORLD = 4
ROWS, SEQ, ACCUM = 4, 32, 2
MESH = dict(data=2, fsdp=2)
_KW = dict(gradient_accumulation_steps=ACCUM, seq_len=SEQ, precision="fp32",
           attention_impl="xla", learning_rate=1e-3, min_lr=1e-4, warmup_steps=1,
           total_steps=8, weight_decay=0.1, activation_checkpointing=True,
           model_name="gpt-tiny", micro_batch_size=ROWS // 4)
HOST = dict(optimizer_offload="host", param_offload="host")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_place")
    batches = _batches()
    np.save(tmp / "batches.npy", batches)
    flat = _init("gpt-tiny")
    np.savez(tmp / "init.npz", **flat)
    spill = str(tmp / "spill")
    disk = dict(optimizer_offload="disk", optimizer_spill_dir=spill)
    common = dict(kind="train", mesh=MESH, init=str(tmp / "init.npz"),
                  batches=str(tmp / "batches.npy"))
    cases = [
        dict(name="host3", cfg={**_KW, **HOST, "sharding_stage": 3}, **common),
        dict(name="host1", cfg={**_KW, **HOST, "sharding_stage": 1}, **common),
        dict(name="opt_host0", cfg={**_KW, "optimizer_offload": "host", "sharding_stage": 0},
             **common),
        dict(name="mem3", cfg={**_KW, "sharding_stage": 3}, **common),
        dict(name="disk", cfg={**_KW, **disk, "sharding_stage": 3}, **common),
        # The agreement, on the spill the disk case left at step 3.
        dict(name="behind", kind="disk", mode="behind", mesh=MESH, init=str(tmp / "init.npz"),
             batches=str(tmp / "batches.npy"), cfg={**_KW, **disk, "sharding_stage": 3}),
        dict(name="torn", kind="disk", mode="torn", mesh=MESH, init=str(tmp / "init.npz"),
             batches=str(tmp / "batches.npy"), cfg={**_KW, **disk, "sharding_stage": 3}),
    ]

    def references():
        return {"mem": _jax_run("gpt-tiny", flat, batches),
                "disk": _jax_run("gpt-tiny", flat, batches, optimizer_offload=OffloadDevice.DISK,
                                 optimizer_spill_dir=str(tmp / "jax_spill"))}

    got, refs = spawn({"cases": cases}, WORLD, tmp, during=references)
    return {c["name"]: [got[(c["name"], r)] for r in range(WORLD)] for c in cases}, refs


@pytest.mark.parametrize("name", ["host3", "host1", "opt_host0"])
def test_host_placements_match_jax(runs, name):
    """Masters and moments in each rank's host arenas (stage 3: the rank's
    shards, streamed up before their gather; stage 1: whole masters, the
    moments' shards; stage 0: the optimizer state alone) train as JAX's
    program: losses, norms, the held-out loss and every final weight."""
    got, refs = runs
    _check(got[name], refs["mem"])
    for out in got[name]:
        assert bool(out["opt_in_arena"])
        assert bool(out["params_in_arena"]) == (name != "opt_host0")
        assert int(out["h2d"]) > 0


def test_host_stage3_holds_a_shard_of_the_in_memory_bytes(runs):
    """At stage 3 a rank's host arenas hold the same shards the in-memory
    program keeps on its device."""
    got, _ = runs
    for a, b in zip(got["host3"], got["mem3"]):
        assert int(a["param_bytes"]) == int(b["param_bytes"])
        assert int(a["opt_bytes"]) == int(b["opt_bytes"])


def test_disk_tier_across_ranks_matches_jax(runs):
    """The disk tier at stage 3: JAX's single-device disk program within
    the mesh bounds, the port's in-memory mesh step within JAX's disk
    bounds, and after three steady steps one discontinuity check ran (the
    first step's; the steady state skips the collective)."""
    got, refs = runs
    _check(got["disk"], refs["disk"])
    for out, mem in zip(got["disk"], got["mem3"]):
        np.testing.assert_allclose(out["losses"], mem["losses"], rtol=1e-5)
        for k in (k for k in mem if k.startswith("param:")):
            np.testing.assert_allclose(out[k], mem[k], rtol=2e-5, atol=2e-6, err_msg=k)
        assert int(out["consensus_checks"]) == 1
        assert int(out["step_on_disk"]) == 3


def test_one_ranks_discontinuity_reseeds_every_rank(runs):
    """Rank 1's spill says step 2, the others' step 3: every rank attaches
    (its masters, the trained weights), and the step from a state at step
    3 reseeds every rank's masters with fresh moments."""
    got, _ = runs
    out = got["behind"]
    assert [int(o["attached_step"]) for o in out] == [3, 2, 3, 3]
    for o in out:
        assert int(o["moment_steps"]) == 1 and int(o["consensus_checks"]) == 1
        for k in (k for k in got["disk"][0] if k.startswith("param:")):
            np.testing.assert_array_equal(o[k.replace("param:", "init:")], got["disk"][0][k])


def test_a_torn_spill_on_one_rank_reseeds_every_rank(runs):
    """Rank 1's spill is torn (an update in progress): no rank attaches,
    and every rank seeds a fresh spill from the weights it is given."""
    got, _ = runs
    init = _init("gpt-tiny")
    for o in got["torn"]:
        assert int(o["attached_step"]) == -1 and int(o["moment_steps"]) == 1
        for k, v in init.items():
            np.testing.assert_array_equal(o[f"init:{k}"], v, err_msg=k)


def _fake_runtime(**axes):
    """The fields of a mesh runtime the program's refusals read, without a
    process group (the pytest process joins none)."""
    sizes = {a: axes.get(a, 1) for a in ("data", "fsdp", "pipe", "sequence", "model")}
    return types.SimpleNamespace(device=torch.device("cpu"), axis_sizes=sizes,
                                 n_devices=int(np.prod(list(sizes.values()))))


def test_disk_below_stage3_across_ranks_raises_jaxs_message(tmp_path):
    """JAX refuses the disk tier below stage 3 across processes; every rank
    of the port is one, so the port refuses it on any mesh of ranks."""
    kw = dict(model_name="gpt-tiny", seq_len=32, sharding_stage=2,
              optimizer_offload="disk", optimizer_spill_dir=str(tmp_path))
    with mock.patch.object(jax, "process_count", return_value=2):
        with pytest.raises(ValueError) as want:
            jtrain.build_train_program(TPUTrainConfig(mesh=MeshConfig(data=2, fsdp=4), **kw))
    cfg = ttrain.TrainConfig(mesh=tmr.MeshConfig(data=2), **kw)
    with pytest.raises(ValueError) as got:
        ttrain.build_train_program(cfg, device="cpu", runtime=_fake_runtime(data=2))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [
    dict(param_offload="host", mesh=dict(data=4, pipe=2)),
    dict(optimizer_offload="disk", mesh=dict(fsdp=4, pipe=2)),
], ids=["param_pipe", "disk_pipe"])
def test_placement_refusals_raise_jaxs_messages(kw, tmp_path):
    """JAX's refusals stay, with its messages: ``param_offload`` and the
    disk tier with ``pipe > 1``."""
    kw = dict(kw)
    mesh = kw.pop("mesh")
    if kw.get("optimizer_offload") == "disk":
        kw["optimizer_spill_dir"] = str(tmp_path)
    base = dict(model_name="gpt-tiny", seq_len=32, sharding_stage=3, **kw)
    with pytest.raises(ValueError) as want:
        jtrain.build_train_program(TPUTrainConfig(mesh=MeshConfig(**mesh), **base))
    with pytest.raises(ValueError) as got:
        ttrain.build_train_program(ttrain.TrainConfig(mesh=tmr.MeshConfig(**mesh), **base),
                                   device="cpu")
    assert str(got.value) == str(want.value)


def test_param_offload_with_a_reduced_gradient_dtype_raises_jaxs_message():
    """``grad_allreduce_dtype`` below fp32 with ``param_offload="host"``."""
    base = dict(model_name="gpt-tiny", seq_len=32, sharding_stage=3, precision="bf16",
                grad_allreduce_dtype="bf16", param_offload="host")
    with pytest.raises(ValueError) as want:
        jtrain.build_train_program(TPUTrainConfig(mesh=MeshConfig(data=2, fsdp=4), **base))
    with pytest.raises(ValueError) as got:
        ttrain.build_train_program(ttrain.TrainConfig(mesh=tmr.MeshConfig(data=2), **base),
                                   device="cpu", runtime=_fake_runtime(data=2))
    assert str(got.value) == str(want.value)
