"""Port parity: the supervised training job (``tpu_engine_torch/supervisor.py``)
against JAX's ``TrainingJob``, on the CPU, mirroring
``tests/test_checkpoint_supervisor.py``.

Both packages' jobs drive one program each (the ``program=`` seam), built
once a model and shared by the jobs of this file: gpt-tiny, and a GQA
llama (gpt-tiny with two kv heads of its four query heads). Both programs
start from JAX's ``init_params`` (the port's through
``convert.params_from_jax``'s flat keys) and both jobs read the same token
batches (``data_fn``), fp32, one device. The jobs are short: at most 12
steps, checkpoints every 4, the planted NaN on step 8.

Held: every logged step's loss at rtol 1e-5 (the metrics JSONL, which
logs every step here, rollbacks included); the final weights within
``WEIGHT_ATOL`` of JAX's; the ``describe()`` keys, the status sequence
(every assignment of ``status``), the metrics-JSONL records (kind, step,
rollback) and fields; the checkpoint steps, the stable step, the restored
step, ``rollback_count`` and ``lr_scale``; the elastic admission errors
word for word; greedy samples (equal rows and ragged) equal JAX's job's,
and the exports read back. The port's restore into a fresh
``abstract_state_like`` is shown to leave the live state untouched when a
load fails partway.
"""

import functools
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_mesh_train import _unflatten  # noqa: E402
from tpu_engine import faults as jfaults  # noqa: E402
from tpu_engine import supervisor as jsup  # noqa: E402
from tpu_engine import train as jtrain  # noqa: E402
from tpu_engine.mesh_runtime import MeshConfig, MeshRuntime  # noqa: E402
from tpu_engine.models import transformer as jtfm  # noqa: E402
from tpu_engine.sharding import TPUTrainConfig  # noqa: E402
from tpu_engine_torch import faults as tfaults  # noqa: E402
from tpu_engine_torch import supervisor as tsup  # noqa: E402
from tpu_engine_torch import train as ttrain  # noqa: E402
from tpu_engine_torch.mesh_runtime import MeshConfig as TMeshConfig  # noqa: E402
from tpu_engine_torch.models import config as tcfg  # noqa: E402
from tpu_engine_torch.models import convert  # noqa: E402

MODELS = {"gpt-tiny": {}, "llama-tiny": dict(n_kv_heads=2)}
_KW = dict(model_name="gpt-tiny", micro_batch_size=2, gradient_accumulation_steps=1,
           seq_len=32, precision="fp32", learning_rate=1e-3, warmup_steps=2, total_steps=100,
           activation_checkpointing=False, attention_impl="xla", log_every_steps=1,
           checkpoint_interval_steps=4)
BATCHES = np.random.default_rng(0).integers(0, 512, (20, 1, 2, 32)).astype(np.int32)
NAN_STEP = 8
LOSS_RTOL = 1e-5
# Final weights, read against JAX's on this file's jobs: 1.2e-7 to 1.3e-7
# but 3.16e-6 after gpt-tiny's rollback (Adam's update divides by the root
# of a small second moment, so a last-bit gradient difference of a
# rarely-used embedding row grows). The bound is about three times that.
WEIGHT_ATOL = 1e-5


def _recording(cls):
    """``cls`` with every assignment of ``status`` recorded in order."""

    class Recording(cls):
        def __setattr__(self, key, value):
            if key == "status":
                self.__dict__.setdefault("statuses", []).append(value.value)
            super().__setattr__(key, value)

    return Recording


JJob, TJob = _recording(jsup.TrainingJob), _recording(tsup.TrainingJob)


@functools.lru_cache(maxsize=None)
def _programs(model: str):
    """(JAX's program, the port's) of ``model`` from JAX's initial weights,
    each ``init`` placing them."""
    over = MODELS[model]
    flat = convert._flatten(jax.tree.map(np.asarray, jtfm.init_params(
        jax.random.PRNGKey(0), jtfm.MODEL_CONFIGS["gpt-tiny"].with_(**over))))
    jcfg = TPUTrainConfig(mesh=MeshConfig(data=1), **_KW)
    jprog = jtrain.build_train_program(jcfg, jtfm.MODEL_CONFIGS["gpt-tiny"].with_(**over),
                                       runtime=MeshRuntime(jcfg.mesh, devices=jax.devices()[:1]))
    jreal, tree = jprog.init, _unflatten(flat)

    def jinit(key):
        state = jreal(key)
        if isinstance(jax.tree.leaves(state["params"])[0], jax.core.Tracer):
            return state  # eval_shape: the shapes alone
        # Fresh arrays each time: the step donates the state's buffers.
        state["params"] = jax.device_put(jax.tree.map(np.array, tree),
                                         jax.tree.map(lambda a: a.sharding, state["params"]))
        return state

    jprog.init = jinit
    tprog = ttrain.build_train_program(ttrain.TrainConfig(**_KW),
                                       tcfg.MODEL_CONFIGS["gpt-tiny"].with_(**over), device="cpu")
    treal = tprog.init
    tprog.init = lambda params=None, generator=None: treal(
        params={k: torch.tensor(v) for k, v in flat.items()})
    return jprog, tprog


def _data(side: str):
    if side == "jax":
        return lambda step: jnp.asarray(BATCHES[step])
    return lambda step: torch.tensor(BATCHES[step], dtype=torch.long)


def _job(side: str, model: str, ck, job_id: str, max_steps: int, **kw):
    """A job of ``side`` ("jax" or "port") on ``ck``, run to its end."""
    jprog, tprog = _programs(model)
    fields = dict(_KW, checkpoint_dir=str(ck), metrics_log_path=str(ck) + f".{job_id}.jsonl")
    fields.update(kw.pop("cfg", {}))
    if side == "jax":
        cfg = TPUTrainConfig(mesh=MeshConfig(data=1), **fields)
        job = JJob(job_id, cfg, program=kw.pop("program", jprog), data_fn=_data(side),
                   max_steps=max_steps, devices=jax.devices()[:1], **kw)
    else:
        cfg = ttrain.TrainConfig(**fields)
        job = TJob(job_id, cfg, program=kw.pop("program", tprog), data_fn=_data(side),
                   max_steps=max_steps, devices=["cpu"], **kw)
    job.start()
    job.join(timeout=120)
    return job


def _records(job) -> list[dict]:
    with open(job.config.metrics_log_path) as f:
        return [json.loads(line) for line in f]


def _losses(job) -> list[tuple[int, int, float]]:
    return [(r["step"], r["rollback"], r["loss"]) for r in _records(job) if r["kind"] == "train"]


def _weights(side: str, job) -> dict:
    if side == "jax":
        return convert._flatten(jax.tree.map(np.asarray, job._state["params"]))
    return {k: v.detach().numpy() for k, v in job._state["params"].items()}


def _hold(jjob, tjob, weights: bool = True) -> None:
    """The two jobs' run alike: statuses, records, losses, describe keys,
    checkpoints, and (``weights``) the final weights."""
    assert tjob.statuses == jjob.statuses, (tjob.statuses, jjob.error, tjob.error)
    jr, tr = _records(jjob), _records(tjob)
    assert [(r["kind"], r["step"], r["rollback"]) for r in tr] == \
        [(r["kind"], r["step"], r["rollback"]) for r in jr]
    assert [sorted(r) for r in tr] == [sorted(r) for r in jr]
    for (s, rb, lt), (_, _, lj) in zip(_losses(tjob), _losses(jjob)):
        if not np.isnan(lj):
            assert lt == pytest.approx(lj, rel=LOSS_RTOL), (s, rb)
    assert sorted(tjob.describe()) == sorted(jjob.describe())
    assert tjob.ckpt.all_steps() == jjob.ckpt.all_steps()
    assert tjob.ckpt.last_stable_step() == jjob.ckpt.last_stable_step()
    assert (tjob.current_step, tjob.resumed_from_step, tjob.rollback_count) == \
        (jjob.current_step, jjob.resumed_from_step, jjob.rollback_count)
    if weights:
        want, got = _weights("jax", jjob), _weights("port", tjob)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=WEIGHT_ATOL, err_msg=k)


@pytest.mark.parametrize("model", list(MODELS))
def test_job_completes_and_checkpoints(tmp_path, model):
    """12 steps, checkpoints every 4: COMPLETED, the final save, a stable
    step, the monitor's step count; JAX's losses and weights."""
    jobs = [_job(side, model, tmp_path / side, "job-a", 12, stable_margin_steps=5)
            for side in ("jax", "port")]
    jjob, tjob = jobs
    assert tjob.status == tsup.JobStatus.COMPLETED, tjob.error
    assert tjob.ckpt.latest_step() == 12 and tjob.ckpt.last_stable_step() is not None
    d = tjob.describe()
    assert d["monitor"]["total_steps_seen"] == 12 and d["tokens_per_sec"] > 0
    assert d["profile"]["steps_seen"] == 12
    _hold(jjob, tjob)


def test_auto_resume_from_checkpoint(tmp_path):
    """A second job on the same directory resumes at the first's last step
    (8) and completes 12."""
    for side in ("jax", "port"):
        first = _job(side, "gpt-tiny", tmp_path / side, "job-b1", 8)
        assert first.status.value == "completed", first.error
    jjob, tjob = (_job(side, "gpt-tiny", tmp_path / side, "job-b2", 12)
                  for side in ("jax", "port"))
    assert tjob.resumed_from_step == 8 and tjob.current_step == 12
    assert [r["kind"] for r in _records(tjob)][0] == "resume"
    _hold(jjob, tjob)


@pytest.mark.parametrize("model", list(MODELS))
def test_nan_rolls_back_with_lr_cut(tmp_path, model):
    """A NaN loss on step 8: one rollback to the stable step 4, lr_scale
    0.5, the run continues to 12 on the new timeline (the steps after the
    rollback held to JAX's)."""
    jobs = {}
    for side in ("jax", "port"):
        prog = _programs(model)[0 if side == "jax" else 1]
        real = prog.step

        def sabotaged(state, batch, real=real, side=side):
            new, metrics = real(state, batch)
            step = int(jax.device_get(new["step"])) if side == "jax" else new["step"]
            if step == NAN_STEP and not sabotaged.fired:
                sabotaged.fired = True
                nan = jnp.float32(float("nan")) if side == "jax" else torch.tensor(float("nan"))
                metrics = dict(metrics, loss=nan)
            return new, metrics

        sabotaged.fired = False
        prog.step = sabotaged
        try:
            jobs[side] = _job(side, model, tmp_path / side, "job-c", 12, stable_margin_steps=2,
                              max_rollbacks=2)
        finally:
            prog.step = real
    jjob, tjob = jobs["jax"], jobs["port"]
    assert tjob.status == tsup.JobStatus.COMPLETED, tjob.error
    assert tjob.rollback_count == 1 and float(tjob._state["lr_scale"]) == 0.5
    assert float(jax.device_get(jjob._state["lr_scale"])) == 0.5
    rolled = [r for r in _records(tjob) if r["kind"] == "rollback"]
    assert [(r["step"], r["anomaly_step"]) for r in rolled] == \
        [(r["step"], r["anomaly_step"]) for r in _records(jjob) if r["kind"] == "rollback"] \
        == [(4, NAN_STEP)]
    _hold(jjob, tjob)


def test_preemption_emergency_save_and_resume(tmp_path):
    """The simulated preemption seam fires while step 6 runs: the job
    finishes that step, saves it (the emergency save), ends PREEMPTED; a
    new job on the directory resumes there and completes."""
    for side in ("jax", "port"):
        hit, holder = threading.Event(), {}
        data = _data(side)

        def slow(step, data=data, hit=hit, holder=holder):
            if step == 5:  # held until the watcher (polling every 50 ms) stops the job
                hit.set()
                holder["job"]._stop.wait(60)
            return data(step)

        jprog, tprog = _programs("gpt-tiny")
        cls, prog = (JJob, jprog) if side == "jax" else (TJob, tprog)
        fields = dict(_KW, checkpoint_dir=str(tmp_path / side), checkpoint_interval_steps=1000,
                      metrics_log_path=str(tmp_path / f"{side}.d.jsonl"))
        cfg = (TPUTrainConfig(mesh=MeshConfig(data=1), **fields) if side == "jax"
               else ttrain.TrainConfig(**fields))
        job = holder["job"] = cls("job-d", cfg, program=prog, data_fn=slow, max_steps=500,
                                  watch_preemption=True, simulate_preemption_check=hit.is_set,
                                  devices=jax.devices()[:1] if side == "jax" else ["cpu"])
        job.start()
        job.join(timeout=120)
        assert job.status.value == "preempted", job.error
        assert job.preemption_reason == "gce-metadata"
        assert job.ckpt.latest_step() == job.current_step == 6
        assert job.describe()["preemption_reason"] == "gce-metadata"
    jjob, tjob = (_job(side, "gpt-tiny", tmp_path / side, "job-d2", 9,
                       cfg=dict(checkpoint_interval_steps=1000)) for side in ("jax", "port"))
    assert tjob.resumed_from_step == 6 and tjob.status == tsup.JobStatus.COMPLETED
    _hold(jjob, tjob)


# (case, config fields, number of devices): JAX's admission gates
# (tests/test_checkpoint_supervisor.py), each failing before any step.
ELASTIC = [
    ("batch_bounds", dict(mesh=dict(data=2, fsdp=4), elastic_min_devices=2,
                          elastic_max_devices=8, elastic_min_batch_size=1,
                          elastic_max_batch_size=4), 4),
    ("below_minimum", dict(mesh=dict(data=2, fsdp=4), elastic_min_devices=8), 4),
    ("exact_fit_only", dict(mesh=dict(data=2, fsdp=4)), 4),
    ("minimum_when_fitting", dict(mesh=dict(data=-1, fsdp=1), elastic_min_devices=8), 4),
]


@pytest.mark.parametrize("case", [c[0] for c in ELASTIC])
def test_elastic_admission_gates(tmp_path, case):
    """Given a list of as many devices as JAX's, the port's job refuses the
    configuration with JAX's message, before any step."""
    _, fields, n = next(c for c in ELASTIC if c[0] == case)
    fields = dict(_KW, model_name="gpt-tiny", micro_batch_size=1,
                  checkpoint_dir=str(tmp_path / "ck"), total_steps=4,
                  **{k: v for k, v in fields.items() if k != "mesh"})
    jjob = jsup.TrainingJob("job-el", TPUTrainConfig(mesh=MeshConfig(**dict(
        next(c for c in ELASTIC if c[0] == case)[1]["mesh"])), **fields),
        devices=jax.devices()[:n])
    tjob = tsup.TrainingJob("job-el", ttrain.TrainConfig(mesh=TMeshConfig(**dict(
        next(c for c in ELASTIC if c[0] == case)[1]["mesh"])), **fields),
        devices=["cpu"] * n)
    for job in (jjob, tjob):
        job.start()
        job.join(timeout=120)
    assert jjob.status.value == tjob.status.value == "failed"
    assert tjob.error == jjob.error
    assert tjob.current_step == 0 and tjob.program is None


@pytest.mark.parametrize("world", [1, 2])
def test_a_job_given_no_devices_runs_on_cards(tmp_path, monkeypatch, world):
    """Without ``devices`` a job takes one card a process, at any world
    size: with no card it fails on the card's build and never carries on
    on the CPU."""
    monkeypatch.setattr(tsup, "_world", lambda: (0, world))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ttrain.TrainConfig(**dict(_KW, checkpoint_dir=str(tmp_path)))
    job = tsup.TrainingJob("no-devices", cfg, max_steps=1, data_fn=_data("port"))
    assert job._visible_devices() == [torch.device("cuda")] * world
    job.start()
    job.join(timeout=120)
    assert job.status == tsup.JobStatus.FAILED and job.error
    assert job.program is None or job.program.device.type == "cuda"
    assert job.current_step == 0


def test_elastic_batch_bounds_validator():
    with pytest.raises(ValueError, match="elastic_max_batch_size"):
        ttrain.TrainConfig(model_name="gpt-tiny", elastic_min_batch_size=64,
                           elastic_max_batch_size=8)
    with pytest.raises(ValueError, match="requires elastic_min_devices"):
        ttrain.TrainConfig(model_name="gpt-tiny", elastic_max_devices=8)


def test_corrupt_newest_checkpoint_quarantined_on_resume(tmp_path):
    """``checkpoint-restore-corruption`` at the newest step (10): the resume
    quarantines it and falls back to step 8, in both packages."""
    for side in ("jax", "port"):
        first = _job(side, "gpt-tiny", tmp_path / side, "job-e1", 10)
        assert first.ckpt.all_steps() == [4, 8, 10]
    jobs = []
    for side, fmod in (("jax", jfaults), ("port", tfaults)):
        inj = fmod.FaultInjector(fmod.FaultPlan(specs=[fmod.FaultSpec(
            kind="checkpoint-restore-corruption", at_step=10)]))
        jobs.append(_job(side, "gpt-tiny", tmp_path / side, "job-e2", 12,
                         fault_injector=inj))
    jjob, tjob = jobs
    assert tjob.resumed_from_step == 8 and 10 in tjob.ckpt.quarantined_steps()
    assert tjob.status == tsup.JobStatus.COMPLETED, tjob.error
    _hold(jjob, tjob)


def test_failed_restore_leaves_the_live_state_untouched(tmp_path):
    """Every restore of the port's job loads into a fresh
    ``abstract_state_like``: a rollback whose every load writes the
    checkpoint's tensors in place and then fails leaves the live weights
    bitwise as they were (the manager loads in place, so a restore into
    the live state would not)."""
    job = _job("port", "gpt-tiny", tmp_path / "port", "job-f", 10)
    live = {k: v.detach().clone() for k, v in job._state["params"].items()}
    real = job.ckpt._load
    seen = []

    def load_then_fail(step, state_like, program):
        seen.append(state_like["params"]["layers.q.kernel"])
        real(step, state_like, program)  # the in-place writes
        raise OSError("disk went away partway")

    job.ckpt._load = load_then_fail
    assert job._rollback(before_step=job.current_step + 1) is None
    assert seen and all(t is not job._state["params"]["layers.q.kernel"] for t in seen)
    for k, v in job._state["params"].items():
        assert torch.equal(v, live[k]), k
    assert job.ckpt.quarantined_steps()  # the failed steps, as any failed load


def test_sampling_and_exports_match_jax(tmp_path):
    """After 4 steps: greedy ``generate_sample`` and ragged rows equal
    JAX's job's; the HF export reads back through ``convert.from_hf`` to
    the job's weights exactly, and as a self-draft ``speculative_sample``
    gives the greedy stream; the int8 snapshot reads back through
    ``quant.load_quantized``."""
    from tpu_engine_torch import quant

    jjob, tjob = (_job(side, "gpt-tiny", tmp_path / side, "job-g", 4) for side in ("jax", "port"))
    prompt, rows = [[5, 17, 300, 42]], [[7, 8], [100, 200, 300]]
    greedy = tjob.generate_sample(prompt, max_new_tokens=6)
    assert greedy == jjob.generate_sample(prompt, max_new_tokens=6)
    assert tjob.generate_samples_ragged(rows, max_new_tokens=4) == \
        jjob.generate_samples_ragged(rows, max_new_tokens=4)
    hf_dir, step = tjob.export_hf_checkpoint(str(tmp_path / "hf"))
    assert step == 4
    from transformers import AutoModelForCausalLM

    hf = AutoModelForCausalLM.from_pretrained(hf_dir)
    back = convert.from_hf(hf.state_dict(), convert.config_from_hf(hf.config), device="cpu")
    for k, v in tjob._state["params"].items():
        assert torch.equal(back[k], v.detach()), k
    out, rounds = tjob.speculative_sample(prompt[0], hf_dir, max_new_tokens=6, gamma=2)
    assert out == greedy[0] and rounds >= 1
    snap, _ = tjob.export_quantized_snapshot(str(tmp_path / "q"))
    loaded = quant.load_quantized(snap, device="cpu")
    assert quant.quant_sites(loaded) and set(loaded) == set(tjob._state["params"])
