"""Port parity: the training half of ``tpu_engine/reshard.py`` against
``tpu_engine_torch/reshard.py``.

The topology and plan functions equal JAX's on the same inputs (byte
accounting and cost model included). One spawn of two ``gloo`` ranks
(``tests/torch_mesh_worker.py``) saves gpt-tiny's step 2 at ``fsdp=2``
(stage 3) and takes the uninterrupted step 3, then restores the checkpoint
through ``restore_resharded`` at ``data=2``; the test process restores it
at world 1. Every restore's whole state has the saved checksums, and its
step 3 is within the AdamW bound (1e-6) of the uninterrupted one. A
``pipe`` change is refused, and a planted re-placement corruption
quarantines the step and raises ``ReshardParityError``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from tpu_engine import reshard as jrs  # noqa: E402
from tpu_engine_torch import checkpoint as tck  # noqa: E402
from tpu_engine_torch import reshard as trs  # noqa: E402
from tpu_engine_torch.train import TrainConfig, build_train_program  # noqa: E402
from torch_mesh_worker import spawn  # noqa: E402

_TOPOS = [{}, {"data": 4, "fsdp": 2}, {"data": 2, "fsdp": 4, "pipe": 1},
          {"data": 2, "fsdp": 2, "pipe": 2}, {"model": 2, "sequence": 0}]


def test_topology_functions_equal_jax():
    for a in _TOPOS:
        assert trs.normalize_topology(a) == jrs.normalize_topology(a)
        for b in _TOPOS:
            assert trs.same_topology(a, b) == jrs.same_topology(a, b)
            assert trs.topology_compatible(a, b) == jrs.topology_compatible(a, b)
    assert trs.mesh_topology(None) == jrs.normalize_topology({})
    assert trs.mesh_topology({"fsdp": 2}) == jrs.normalize_topology({"fsdp": 2})


def test_topology_manifest_round_trip(tmp_path):
    assert trs.read_topology(str(tmp_path)) is None
    trs.write_topology(str(tmp_path), {"data": 4, "fsdp": 2}, extra={"run": "a"})
    assert trs.read_topology(str(tmp_path)) == jrs.normalize_topology({"data": 4, "fsdp": 2})
    trs.write_topology(str(tmp_path / "missing" / "dir"), {"data": 2})  # never raises


def _state(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.standard_normal((16, 8)).astype(np.float32),
                       "b": rng.standard_normal((8,)).astype(np.float32)},
            "opt": {"mu": rng.standard_normal((16, 8)).astype(np.float32),
                    "count": np.int32(3)},
            "step": np.int32(7)}


def test_plan_and_cost_equal_jax():
    """The same tree (numpy leaves for the port, JAX's abstract leaves for
    JAX): paths, shapes, dtypes, bytes, totals, the remap and its cost."""
    host = _state()
    abstract = jax.tree.map(lambda a: jax.ShapeDtypeStruct(np.shape(a), np.asarray(a).dtype),
                            host)
    for src, dst in (({"data": 4, "fsdp": 2}, {"data": 2, "fsdp": 4}),
                     ({"fsdp": 2}, {"fsdp": 2}), ({"pipe": 2}, {"data": 2})):
        want = jrs.build_reshard_plan(abstract, src, dst)
        got = trs.build_reshard_plan(host, src, dst)
        assert [(m.path, m.shape, m.dtype, m.nbytes) for m in got.moves] == \
            [(m.path, m.shape, m.dtype, m.nbytes) for m in want.moves]
        assert got.summary() == want.summary()
    for n in (0, 1, 10**9, 3 * 10**10):
        assert trs.reshard_cost_s(n) == jrs.reshard_cost_s(n)
    for name in ("gpt-tiny", "llama-1b", "qwen3-4b", "no-such-model"):
        assert trs.state_bytes_for_model(name) == jrs.state_bytes_for_model(name)
    assert trs.leaf_checksums(host) == jrs.leaf_checksums(host)
    t = {"a": torch.tensor(host["params"]["w"]), "b": {"c": torch.tensor(host["params"]["b"])}}
    assert trs.leaf_checksums(t) == jrs.leaf_checksums({"a": host["params"]["w"],
                                                        "b": {"c": host["params"]["b"]}})


_CFG = dict(model_name="gpt-tiny", micro_batch_size=2, gradient_accumulation_steps=2, seq_len=32,
            precision="fp32", attention_impl="xla", learning_rate=1e-3, min_lr=1e-4,
            warmup_steps=1, total_steps=8)


def _whole(state: dict) -> dict:
    """Params and moments of a one-device state, keyed as the workers'."""
    out = {f"param:{k}": v.detach().numpy() for k, v in state["params"].items()}
    for name in ("mu", "nu"):
        out.update({f"{name}:{k}": v.numpy() for k, v in state["opt_state"][name].items()})
    return out


def _checksums(flat: dict) -> dict:
    return trs.leaf_checksums({k: np.asarray(v) for k, v in flat.items()})


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """Step 2 saved at fsdp=2 and restored at data=2 on the same two ranks."""
    from tpu_engine_torch.models import transformer as tfm
    from tpu_engine_torch.models.config import MODEL_CONFIGS

    tmp = tmp_path_factory.mktemp("reshard")
    gen = torch.Generator().manual_seed(0)
    init = {k: v.detach().numpy()
            for k, v in tfm.init_params(MODEL_CONFIGS["gpt-tiny"], gen, "cpu").items()}
    np.savez(tmp / "init.npz", **init)
    np.save(tmp / "batches.npy",
            np.random.default_rng(1).integers(0, 512, (3, 2, 4, 32)).astype(np.int32))
    common = dict(kind="ckpt", init=str(tmp / "init.npz"), batches=str(tmp / "batches.npy"),
                  dir=str(tmp / "ck"))
    cases = [dict(name="fsdp2", mode="save", mesh=dict(fsdp=2), cfg=_CFG, **common),
             dict(name="data2", mode="reshard", mesh=dict(data=2), cfg=_CFG, **common)]
    return spawn(dict(cases=cases), 2, tmp), tmp


def _strip(o: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in o.items() if k.startswith(prefix)}


def test_restore_at_data2_keeps_checksums_and_step(saved):
    out, _ = saved
    want = _strip(out[("fsdp2", 0)], "s2.")
    for r in range(2):
        o = out[("data2", r)]
        assert int(o["restored_step"]) == 2 and bool(o["parity_ok"])
        assert _checksums(_strip(o, "s2.")) == _checksums(want)
        np.testing.assert_allclose(float(o["loss3"]), float(out[("fsdp2", r)]["loss3"]),
                                   rtol=1e-6)
        ref = _strip(out[("fsdp2", r)], "s3.param:")
        for k, v in _strip(o, "s3.param:").items():
            np.testing.assert_allclose(v, ref[k], atol=1e-6)


def test_restore_at_world1_keeps_checksums_and_step(saved):
    out, tmp = saved
    prog = build_train_program(TrainConfig(**{**_CFG, "micro_batch_size": 4}), device="cpu")
    mgr = tck.TrainCheckpointManager(str(tmp / "ck"), program=prog)
    trs._reset_stats_for_tests()
    step, state = mgr.restore_resharded(tck.abstract_state_like(prog))
    assert step == 2 and state["step"] == 2
    stats = trs.reshard_stats()
    assert stats["plans_applied_total"] == 1 and stats["parity_failures_total"] == 0
    assert stats["last_plan_bytes"] > 0  # fsdp=2 → world 1 remaps everything
    assert _checksums(_whole(state)) == _checksums(_strip(out[("fsdp2", 0)], "s2."))
    batch = torch.tensor(np.load(tmp / "batches.npy")[2], dtype=torch.long)
    state, m = prog.step(state, batch)
    np.testing.assert_allclose(float(m["loss"]), float(out[("fsdp2", 0)]["loss3"]), rtol=1e-6)
    ref = _strip(out[("fsdp2", 0)], "s3.param:")
    for k, v in state["params"].items():
        np.testing.assert_allclose(v.detach().numpy(), ref[k], atol=1e-6)


def test_pipe_change_refused_and_no_checkpoint(saved, tmp_path):
    _, tmp = saved
    prog = build_train_program(TrainConfig(**{**_CFG, "micro_batch_size": 4}), device="cpu")
    mgr = tck.TrainCheckpointManager(str(tmp / "ck"), program=prog)
    step, state, report = trs.restore_resharded(
        mgr, tck.abstract_state_like(prog), saved_topology={"fsdp": 2, "pipe": 2}, program=prog)
    assert step is None and state is None and "incompatible topology" in report["error"]
    assert "pipe extent 2 (saved) != 1 (target)" in report["error"]
    empty = tck.TrainCheckpointManager(str(tmp_path / "none"), program=prog)
    step, state, report = trs.restore_resharded(empty, tck.abstract_state_like(prog),
                                                saved_topology={"fsdp": 2}, program=prog)
    assert step is None and report["error"] == "no restorable checkpoint"


def test_parity_gate_quarantines_and_raises(saved, monkeypatch):
    """JAX's test: a re-placement that changes a leaf's bytes never
    resumes silently; the step is quarantined and the error raised."""
    _, tmp = saved
    prog = build_train_program(TrainConfig(**{**_CFG, "micro_batch_size": 4}), device="cpu")
    mgr = tck.TrainCheckpointManager(str(tmp / "ck"), program=prog)
    real = trs._place_leaf

    def corrupting(whole, target, splits, program):
        real(whole, target, splits, program)
        if target.shape == (512, 64):  # the embedding
            with torch.no_grad():
                target.zero_()

    monkeypatch.setattr(trs, "_place_leaf", corrupting)
    trs._reset_stats_for_tests()
    with pytest.raises(trs.ReshardParityError, match="parity failure"):
        mgr.restore_resharded(tck.abstract_state_like(prog))
    assert 2 in mgr.quarantined_steps()
    stats = trs.reshard_stats()
    assert stats["parity_failures_total"] == 1 and stats["plans_applied_total"] == 0
