"""Port parity: the disk tier (``tpu_engine_torch/disk_offload.py`` and the
``optimizer_offload="disk"`` program of ``tpu_engine_torch.train``), as
``tests/test_disk_offload.py`` holds JAX's, on the CPU: parity with the
in-memory AdamW, bf16 device params, persistence across programs, the
rollback reseed, the overlapped walk, spill accounting and config checks;
and the port's host AdamW against JAX's on the same slabs, exactly."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402,F401

from tpu_engine import disk_offload as jdsk  # noqa: E402
from tpu_engine_torch import disk_offload as tdsk  # noqa: E402
from tpu_engine_torch import train as ttrain  # noqa: E402


def _cfg(spill_dir=None, **kw):
    base = dict(model_name="gpt-tiny", micro_batch_size=2, gradient_accumulation_steps=2,
                seq_len=16, precision="fp32", param_dtype="fp32", total_steps=8,
                warmup_steps=2, activation_checkpointing=False, learning_rate=1e-2,
                weight_decay=0.1)
    if spill_dir is not None:
        base.update(optimizer_offload="disk", optimizer_spill_dir=str(spill_dir))
    base.update(kw)
    return ttrain.TrainConfig(**base)


def _build(cfg):
    return ttrain.build_train_program(cfg, device="cpu")


def _run(prog, steps, state=None, start=0):
    if state is None:
        state = prog.init()
    losses = []
    for i in range(start, start + steps):
        state, m = prog.step(state, prog.synthetic_batch(i))
        losses.append(float(m["loss"]))
    return state, losses


def test_disk_tier_matches_in_memory_adamw(tmp_path):
    """Step-for-step parity: the same losses and final params (fp32: only
    the host update's rounding order differs)."""
    ref_state, ref_losses = _run(_build(_cfg()), 4)
    state, losses = _run(_build(_cfg(tmp_path / "spill")), 4)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    for k, r in ref_state["params"].items():
        np.testing.assert_allclose(state["params"][k].detach().numpy(), r.detach().numpy(),
                                   rtol=2e-5, atol=2e-6, err_msg=k)
    # No optimizer state on the device; params in the compute dtype.
    assert "opt_state" not in state
    assert state["params"]["lm_head.kernel"].dtype == torch.float32


def test_disk_tier_bf16_device_params(tmp_path):
    """With bf16 compute the device holds bf16 params while the masters stay
    fp32 on disk."""
    state, losses = _run(_build(_cfg(tmp_path / "s", precision="bf16")), 2)
    assert state["params"]["lm_head.kernel"].dtype == torch.bfloat16
    assert np.isfinite(losses).all()
    spill = os.listdir(tmp_path / "s")
    for kind in ("master", "mu", "nu"):
        assert any(f.endswith(f".{kind}.f32") for f in spill)


def test_disk_tier_persistence_across_programs(tmp_path):
    """Stop after 3 steps, rebuild on the same spill, run 2 more: the same as
    5 steps in one program (masters and moments re-attach)."""
    _, cont = _run(_build(_cfg(tmp_path / "cont")), 5)
    state1, losses_a = _run(_build(_cfg(tmp_path / "spill")), 3)
    prog2 = _build(_cfg(tmp_path / "spill"))
    state2 = dict(prog2.init(), step=state1["step"])  # the step a checkpoint restores
    _, losses_b = _run(prog2, 2, state=state2, start=3)
    np.testing.assert_allclose(losses_a + losses_b, cont, rtol=1e-5)


def test_disk_tier_rollback_reseeds_masters(tmp_path):
    """An older state (a rollback) reseeds the masters from it, moments
    zeroed: the trajectory restarts at the restored weights."""
    prog = _build(_cfg(tmp_path / "spill"))
    state1, _ = prog.step(prog.init(), prog.synthetic_batch(0))
    reseeds = []
    real = prog.disk.store.reseed_masters

    def spy(*a, **k):
        reseeds.append(1)
        return real(*a, **k)

    prog.disk.store.reseed_masters = spy
    prog.step(state1, prog.synthetic_batch(1))
    assert not reseeds  # sequential steps never reseed
    redo, _ = prog.step(state1, prog.synthetic_batch(1))
    assert reseeds, "rollback was not detected"
    assert redo["step"] == 2
    masters = prog.disk.store.masters()
    for k, p in redo["params"].items():
        np.testing.assert_array_equal(p.detach().numpy(), masters[k])


def test_disk_tier_config_validation(tmp_path):
    with pytest.raises(ValueError, match="optimizer_spill_dir"):
        _cfg(optimizer_offload="disk")
    with pytest.raises(ValueError, match="adamw"):
        _cfg(tmp_path, optimizer="adafactor")
    with pytest.raises(ValueError, match="moment_dtype"):
        _cfg(tmp_path, moment_dtype="bf16")
    with pytest.raises(ValueError, match="only applies"):
        _cfg(optimizer_spill_dir=str(tmp_path))
    with pytest.raises(ValueError, match="param_offload"):
        _cfg(tmp_path, param_offload="host")
    with pytest.raises(ValueError, match="spill optimizer state"):
        _cfg(param_offload="disk")
    with pytest.raises(ValueError, match="disk_update_overlap"):
        _cfg(disk_update_overlap=True)


def test_disk_adamw_spill_accounting(tmp_path):
    store = tdsk.DiskAdamW(str(tmp_path / "s"), b1=0.9, b2=0.95, weight_decay=0.0)
    params = {"w": np.ones((8, 4), np.float32)}
    assert store.initialize(params, {"w": True}) is False
    assert store.spill_bytes() == 3 * 8 * 4 * 4
    store2 = tdsk.DiskAdamW(str(tmp_path / "s"), b1=0.9, b2=0.95, weight_decay=0.0)
    assert store2.initialize(params, {"w": True}) is True  # re-attach
    store3 = tdsk.DiskAdamW(str(tmp_path / "s"), b1=0.8, b2=0.95, weight_decay=0.0)
    assert store3.initialize(params, {"w": True}) is False  # other hyperparameters


def test_disk_adamw_update_equals_jaxs_exactly(tmp_path):
    """The same slabs, gradients and learning rates through both packages'
    host AdamW (three updates, a decayed and an undecayed leaf, then a
    reseed at bf16): masters and moments equal bitwise, as do the emitted
    masters."""
    rng = np.random.default_rng(0)
    shapes = {"k.kernel": (6, 5), "n.scale": (7,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    mask = {"k.kernel": True, "n.scale": False}
    stores = [mod.DiskAdamW(str(tmp_path / name), b1=0.9, b2=0.95, weight_decay=0.1)
              for name, mod in (("j", jdsk), ("t", tdsk))]
    for s in stores:
        s.initialize(params, mask)
    for step, lr in enumerate((1e-2, 3e-3, 1e-3), start=1):
        grads = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        emitted = []
        for s in stores:
            out = {}
            s.update({k: (lambda g=g: g) for k, g in grads.items()}, lr, step,
                     lambda k, w, out=out: out.__setitem__(k, np.array(w)))
            emitted.append(out)
        for k in shapes:
            np.testing.assert_array_equal(emitted[0][k], emitted[1][k])
    jm, tm = (s.masters() for s in stores)
    for k in shapes:
        np.testing.assert_array_equal(jm[k], tm[k])
        for kind in ("mu", "nu"):
            np.testing.assert_array_equal(getattr(stores[0].slabs[k], kind),
                                          getattr(stores[1].slabs[k], kind))
    # One leaf as its bf16 rounding (each master kept), one moved off it.
    incoming = {"k.kernel": torch.from_numpy(jm["k.kernel"]).to(torch.bfloat16).float().numpy(),
                "n.scale": jm["n.scale"] + 1e-3}
    stores[0].reseed_masters(incoming, step=3, cast_dtype=jax.numpy.bfloat16)
    stores[1].reseed_masters(incoming, step=3, cast_dtype=torch.bfloat16)
    jm, tm = (s.masters() for s in stores)
    for k in shapes:
        np.testing.assert_array_equal(jm[k], tm[k])
    assert stores[1].moment_steps == stores[0].moment_steps == 0


def test_overlap_semantics(tmp_path):
    """disk_update_overlap: step k returns params P_{k-1} (the walk is in
    flight); the first walk equals the serial tier's first step; flush folds
    the walk in, and the flushed params are the disk masters."""
    ov = _build(_cfg(tmp_path / "a", disk_update_overlap=True))
    s0 = ov.init()
    p0 = {k: p.detach().clone() for k, p in s0["params"].items()}
    s1, _ = ov.step(s0, ov.synthetic_batch(0))
    assert all(torch.equal(s1["params"][k], p0[k]) for k in p0)
    assert s1["step"] == 1
    s2, _ = ov.step(s1, ov.synthetic_batch(1))
    serial = _build(_cfg(tmp_path / "b"))
    r1, _ = serial.step(serial.init(), serial.synthetic_batch(0))
    assert all(torch.equal(s2["params"][k], r1["params"][k]) for k in p0)
    flushed = ov.flush(s2)
    assert ov.disk.store.step_on_disk == 2
    masters = ov.disk.store.masters()
    for k, w in masters.items():
        np.testing.assert_array_equal(flushed["params"][k].detach().numpy(), w)
    assert ov.flush(flushed) is flushed  # nothing in flight


def test_overlap_discards_walk_on_rollback(tmp_path):
    ov = _build(_cfg(tmp_path / "a", disk_update_overlap=True))
    s1, _ = ov.step(ov.init(), ov.synthetic_batch(0))
    ov.step(s1, ov.synthetic_batch(1))  # walk 2 in flight
    s_rb, _ = ov.step(s1, ov.synthetic_batch(2))  # rollback to step 1: discard
    flushed = ov.flush(s_rb)
    assert flushed["step"] == 2
    assert ov.disk.store.moment_steps == 1  # reseeded: bias correction restarted
    assert ov.disk.store.step_on_disk == 2
    _, m = ov.step(flushed, ov.synthetic_batch(3))
    assert np.isfinite(float(m["loss"]))


def test_overlap_losses_decrease_and_checks_stay_cached(tmp_path):
    """Six overlapped steps on one batch: the loss falls; the discontinuity
    check runs once (after the fresh spill), as in the serial tier."""
    ov = _build(_cfg(tmp_path / "a", disk_update_overlap=True))
    state, batch, losses = ov.init(), ov.synthetic_batch(0), []
    for _ in range(6):
        state, m = ov.step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] and np.isfinite(losses).all()
    assert ov.disk.store.consensus_checks == 1
    prog = _build(_cfg(tmp_path / "b"))
    state, _ = _run(prog, 3)
    assert prog.disk.store.consensus_checks == 1
    assert prog.transfer_bytes()["d2h"] > 0
