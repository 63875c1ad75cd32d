"""Port parity: ``tpu_engine_torch/checkpoint.py`` (DCP) against
``tpu_engine/checkpoint.py`` (Orbax).

JAX's ``TrainCheckpointManager`` and the port's take the same sequence of
calls (saves of steps 1–5 with ``max_to_keep=3``, repeated and off-interval
steps, a stable pointer, a quarantine, injected save and restore faults
through ``tpu_engine.faults``' injector passed explicitly to both, a
fall-back restore, ``delete_after``) and report the same steps at every
point. The port's restored state is bitwise its saved state on one device,
on two ``gloo`` ranks at stage 3 (``tests/torch_mesh_worker.py``), where
the save is asynchronous and raced by the next step's in-place update, and
on four ranks of a ``pipe=2`` program. With a ``trace_id`` both managers
record the same ``checkpoint_save`` / ``checkpoint_restore`` spans, and
with no injector passed both consult their package's process-wide one."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_engine import checkpoint as jck  # noqa: E402
from tpu_engine.faults import FaultInjector, FaultKind, FaultPlan, FaultSpec  # noqa: E402
from tpu_engine_torch import checkpoint as tck  # noqa: E402
from tpu_engine_torch.train import TrainConfig, build_train_program  # noqa: E402
from torch_mesh_worker import spawn  # noqa: E402


def _injector() -> FaultInjector:
    return FaultInjector(FaultPlan(specs=[
        FaultSpec(kind=FaultKind.CHECKPOINT_SAVE_IOERROR, at_step=4, count=1),
        FaultSpec(kind=FaultKind.CHECKPOINT_RESTORE_CORRUPTION, at_step=6, count=1),
    ]))


def _script(mgr, state_at, like, restore) -> list:
    """The call sequence; each entry what a call returned or raised, and
    the manager's view after it."""
    log = []

    def view():
        return (mgr.all_steps(), mgr.latest_step(), mgr.last_stable_step(),
                mgr.quarantined_steps())

    def call(name, fn):
        try:
            log.append((name, fn()))
        except Exception as e:  # noqa: BLE001 — the injected faults are results here
            log.append((name, f"raised {type(e).__name__}: {e}"))
        mgr.wait_until_finished()
        log.append((name + " view", view()))

    for s in (1, 2, 3, 4, 5):
        call(f"save {s}", lambda s=s: mgr.save(s, state_at(s), metrics={"loss": 1.0 / s}))
    call("save 4 again", lambda: mgr.save(4, state_at(4)))  # after its fault: not after 5
    call("save 5 again", lambda: mgr.save(5, state_at(5)))
    call("save 5 forced", lambda: mgr.save(5, state_at(5), force=True, wait=True))
    call("save 6 forced", lambda: mgr.save(6, state_at(6), force=True, wait=True))
    call("mark_stable 3", lambda: mgr.mark_stable(3))
    call("quarantine 5", lambda: mgr.quarantine(5))
    call("restore latest", lambda: restore(mgr, like())[0])  # 6 corrupt → falls back to 3
    call("restore 5 no fall-back", lambda: restore(mgr, like(), step=5, fall_back=False)[0])
    call("delete_after 4", lambda: mgr.delete_after(4))
    call("save 5 after rollback", lambda: mgr.save(5, state_at(5), wait=True))
    call("restore_stable", lambda: mgr.restore_stable(like())[0])
    call("save_with_retry 7", lambda: mgr.save_with_retry(7, state_at(7), backoff_base_s=0.0))
    return log


def _jax_state(s: int) -> dict:
    return {"w": jnp.full((4, 8), float(s)), "b": jnp.arange(3, dtype=jnp.int32) + s}


def _port_state(s: int) -> dict:
    return {"w": torch.full((4, 8), float(s)), "b": torch.arange(3, dtype=torch.int32) + s}


def test_manager_semantics_equal_jax(tmp_path):
    """Every step, pointer and quarantine JAX's manager reports, the
    port's reports for the same calls (the injected save fault at step 4,
    and the restore fault at step 6 falling back to step 3, included)."""
    def jax_like():
        return jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype, sharding=a.sharding),
                            _jax_state(0))

    def jax_restore(mgr, like, step=None, fall_back=True):
        return mgr.restore(like, step=step, fall_back=fall_back)

    def port_restore(mgr, like, step=None, fall_back=True):
        return mgr.restore(like, step=step, fall_back=fall_back)

    inj = _injector()
    jm = jck.TrainCheckpointManager(str(tmp_path / "jax"), max_to_keep=3, fault_injector=inj)
    want = _script(jm, _jax_state, jax_like, jax_restore)
    jm.close()
    inj = _injector()
    pm = tck.TrainCheckpointManager(str(tmp_path / "port"), max_to_keep=3, fault_injector=inj)
    got = _script(pm, _port_state, lambda: _port_state(0), port_restore)
    pm.close()
    assert [g[0] for g in got] == [w[0] for w in want]
    for g, w in zip(got, want):
        if isinstance(w[1], str) and w[1].startswith("raised"):
            assert isinstance(g[1], str) and g[1].split(":")[0] == w[1].split(":")[0], (g, w)
            assert "injected fault" not in w[1] or g[1] == w[1], (g, w)
        else:
            assert g[1] == w[1], (g, w)
    assert dict(want)["restore latest"] == 3 and dict(want)["restore_stable"] == 3
    assert pm.metrics(3) == {"loss": 1.0 / 3}


def test_restore_values_and_refusals(tmp_path):
    """A restore loads the saved values into the given state in place; a
    URL directory raises ``NotImplementedError``."""
    mgr = tck.TrainCheckpointManager(str(tmp_path / "ck"))
    assert mgr.save(3, {**_port_state(3), "step": 3, "lr_scale": 0.5}, wait=True)
    like = {**_port_state(0), "step": 0, "lr_scale": 1.0}
    w = like["w"]
    step, got = mgr.restore(like)
    assert step == 3 and got["step"] == 3 and got["lr_scale"] == 0.5
    assert got["w"] is w and torch.equal(w, torch.full((4, 8), 3.0))
    assert torch.equal(got["b"], torch.arange(3, dtype=torch.int32) + 3)
    with pytest.raises(NotImplementedError, match="object"):
        tck.TrainCheckpointManager("gs://bucket/run")
    assert tck.resolve_checkpoint_dir("~/x") == os.path.expanduser("~/x")


_CFG = dict(model_name="gpt-tiny", micro_batch_size=2, gradient_accumulation_steps=2, seq_len=32,
            precision="fp32", attention_impl="xla", learning_rate=1e-3, min_lr=1e-4,
            warmup_steps=1, total_steps=8)


def _batches(rows: int = 2) -> np.ndarray:
    return np.random.default_rng(0).integers(0, 512, (3, 2, rows, 32)).astype(np.int32)


def test_one_device_restore_is_bitwise(tmp_path):
    """One device: an asynchronous save of step 2, raced by step 3's
    in-place update, restores bitwise into a fresh program, whose step 3
    is bitwise the uninterrupted one."""
    cfg = TrainConfig(**_CFG)
    batches = [torch.tensor(b, dtype=torch.long) for b in _batches()]
    prog = build_train_program(cfg, device="cpu")
    state = prog.init()
    for b in batches[:2]:
        state, _ = prog.step(state, b)
    mgr = tck.TrainCheckpointManager(str(tmp_path / "ck"), program=prog)
    assert mgr.save(2, state)
    snap = {k: v.detach().clone() for k, v in tck.flatten_state(state).items()
            if isinstance(v, torch.Tensor)}
    state, m = prog.step(state, batches[2])
    mgr.wait_until_finished()
    prog2 = build_train_program(cfg, device="cpu")
    step, got = tck.TrainCheckpointManager(str(tmp_path / "ck"), program=prog2).restore(
        tck.abstract_state_like(prog2))
    assert step == 2 and got["step"] == 2 and got["opt_state"]["count"] == 2
    flat = tck.flatten_state(got)
    assert all(torch.equal(flat[k], v) for k, v in snap.items())
    got, m2 = prog2.step(got, batches[2])
    assert float(m2["loss"]) == float(m["loss"])
    assert all(torch.equal(got["params"][k], state["params"][k]) for k in state["params"])


def test_two_ranks_stage3_restore_is_bitwise(tmp_path):
    """Two gloo ranks at stage 3 (fsdp=2): each rank writes its shards
    (``DTensor`` places), and a fresh program's restore is bitwise the
    state saved; its step 3 is bitwise the uninterrupted one."""
    from tpu_engine_torch.models import transformer as tfm
    from tpu_engine_torch.models.config import MODEL_CONFIGS

    gen = torch.Generator().manual_seed(0)
    init = {k: v.detach().numpy()
            for k, v in tfm.init_params(MODEL_CONFIGS["gpt-tiny"], gen, "cpu").items()}
    np.savez(tmp_path / "init.npz", **init)
    np.save(tmp_path / "batches.npy", _batches(rows=4))
    case = dict(name="save", kind="ckpt", mode="save", mesh=dict(fsdp=2),
                cfg={**_CFG, "micro_batch_size": 2}, init=str(tmp_path / "init.npz"),
                batches=str(tmp_path / "batches.npy"), dir=str(tmp_path / "ck"))
    out = spawn(dict(cases=[case]), 2, tmp_path)
    for r in range(2):
        o = out[("save", r)]
        assert bool(o["bitwise"]) and int(o["restored_step"]) == 2
        assert o["scalars"].tolist() == [2, 2]
        assert float(o["loss3_restored"]) == float(o["loss3"])
        for k in o:
            if k.startswith("s3."):
                np.testing.assert_array_equal(o["r3." + k[3:]], o[k])
    files = os.listdir(tmp_path / "ck" / "2")
    assert sum(f.endswith(".distcp") for f in files) == 2  # each rank wrote its shards


def test_pipe_program_restores_bitwise_and_reads_whole(tmp_path):
    """Four gloo ranks of gpt-tiny on (pipe=2, fsdp=2) at stage 3: each
    stage writes its block of layers at its offset and the outer leaves it
    holds (the tied table, held by both end stages, once); a fresh
    program's restore is bitwise the state saved and its step 3 the
    uninterrupted one. The checkpoint then restores onto (pipe=2, data=2)
    through ``restore_resharded`` (its crc32 parity gate passes) and reads
    whole into a one-device program, equal to the saved weights and
    moments."""
    from tpu_engine_torch.models import transformer as tfm
    from tpu_engine_torch.models.config import MODEL_CONFIGS

    gen = torch.Generator().manual_seed(0)
    init = {k: v.detach().numpy()
            for k, v in tfm.init_params(MODEL_CONFIGS["gpt-tiny"], gen, "cpu").items()}
    np.savez(tmp_path / "init.npz", **init)
    np.save(tmp_path / "batches.npy", _batches(rows=4))
    common = dict(kind="ckpt", init=str(tmp_path / "init.npz"),
                  batches=str(tmp_path / "batches.npy"), dir=str(tmp_path / "ck"))
    cases = [dict(name="save", mode="save", mesh=dict(pipe=2, fsdp=2),
                  cfg={**_CFG, "micro_batch_size": 2}, **common),
             dict(name="reshard", mode="reshard", mesh=dict(pipe=2, data=2),
                  cfg={**_CFG, "micro_batch_size": 2}, **common)]
    out = spawn(dict(cases=cases), 4, tmp_path)
    saved = out[("save", 0)]
    for r in range(4):
        o = out[("save", r)]
        assert bool(o["bitwise"]) and int(o["restored_step"]) == 2
        assert o["scalars"].tolist() == [2, 2]
        assert float(o["loss3_restored"]) == float(o["loss3"])
        for k in o:
            if k.startswith("s3."):
                np.testing.assert_array_equal(o["r3." + k[3:]], o[k])
        rs = out[("reshard", r)]
        assert bool(rs["parity_ok"]) and int(rs["restored_step"]) == 2
        for k in saved:
            if k.startswith("s2."):
                np.testing.assert_array_equal(rs[k], saved[k], err_msg=k)
    prog1 = build_train_program(TrainConfig(**{**_CFG, "micro_batch_size": 4}), device="cpu")
    step, whole = tck.TrainCheckpointManager(str(tmp_path / "ck")).restore(
        tck.abstract_state_like(prog1))
    assert step == 2 and whole["step"] == 2
    for k, v in whole["params"].items():
        np.testing.assert_array_equal(v.detach().numpy(), saved[f"s2.param:{k}"], err_msg=k)
    for name in ("mu", "nu"):
        for k, v in whole["opt_state"][name].items():
            np.testing.assert_array_equal(v.numpy(), saved[f"s2.{name}:{k}"], err_msg=k)


def test_spans_and_process_wide_injector_match_jax(tmp_path):
    """With a ``trace_id`` each manager records JAX's spans on its own
    package's flight recorder (save: step, wait, force, blocking, outcome;
    restore: step, quarantined), and with no injector passed each consults
    its package's process-wide one (``faults.set_active``), so an armed
    restore fault quarantines the step in both."""
    from tpu_engine import faults as jfaults
    from tpu_engine import tracing as jtracing
    from tpu_engine_torch import faults as tfaults
    from tpu_engine_torch import tracing as ttracing

    def plan(f):
        return f.FaultInjector(f.FaultPlan(specs=[f.FaultSpec(
            kind=f.FaultKind.CHECKPOINT_RESTORE_CORRUPTION, at_step=2, count=1)]))

    def run(ck, tracing, faults, state, like, restore, d):
        rec = tracing.FlightRecorder()
        tracing.set_recorder(rec)
        faults.set_active(plan(faults))
        try:
            mgr = ck.TrainCheckpointManager(str(d), trace_id="t0", async_save=False)
            for s in (1, 2):
                mgr.save(s, state(s), wait=True)
            mgr.save(2, state(2))  # skipped: saved already
            step, _ = restore(mgr, like())
            quarantined = mgr.quarantined_steps()
        finally:
            faults.clear_active()
            tracing.set_recorder(None)
        spans = [(sp["name"], sp["kind"], sp["trace_id"], sp["attrs"])
                 for sp in rec.spans(trace_id="t0")]
        return step, quarantined, spans

    def jax_like():
        return jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype, sharding=a.sharding),
                            _jax_state(0))

    want = run(jck, jtracing, jfaults, _jax_state, jax_like, lambda m, like: m.restore(like),
               tmp_path / "jax")
    got = run(tck, ttracing, tfaults, _port_state, lambda: _port_state(0),
              lambda m, like: m.restore(like), tmp_path / "port")
    assert got == want
    assert want[0] == 1 and want[1] == [2]


def test_a_step_missing_a_leaf_is_quarantined_as_in_jax(tmp_path):
    """A step whose saved tree lacks a leaf of the state restored into
    fails to load: JAX's manager quarantines it and falls back to the step
    before, and so does the port's, though DCP raises the failure as a
    ``CheckpointException`` (a ``BaseException``)."""
    def run(mgr, state, like):
        mgr.save(1, state(1), wait=True)
        mgr.save(2, {"w": state(2)["w"]}, wait=True)
        step, got = mgr.restore(like())
        return step, mgr.quarantined_steps()

    def jax_like():
        return jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype, sharding=a.sharding),
                            _jax_state(0))

    want = run(jck.TrainCheckpointManager(str(tmp_path / "jax"), async_save=False), _jax_state,
               jax_like)
    got = run(tck.TrainCheckpointManager(str(tmp_path / "port"), async_save=False), _port_state,
              lambda: _port_state(0))
    assert got == want == (1, [2])
