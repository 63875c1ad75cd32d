"""The port's launcher (``tpu_engine_torch/launcher.py``) against JAX's
(``tpu_engine/launcher.py``).

``presets()`` and ``generate_plan`` of every preset equal JAX's at one
visible device (JAX's device count is set to 1 for the comparison: the
root conftest gives its process 8 CPU devices), with both planners on
JAX's constants and no fleet view. ``launch(dry_run=True)`` gives JAX's
``LaunchResult`` fields. ``--list-presets`` and ``--dry-run`` of each
package's CLI exit 0 with the same lines. A real tiny launch on the CPU
completes; a launch whose gang needs several devices in one process
fails with the reason.
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch").set_num_threads(1)

from tpu_engine import compile_index as jcompile  # noqa: E402
from tpu_engine import launcher as jlaunch  # noqa: E402
from tpu_engine import placement as jplace  # noqa: E402
from tpu_engine import scheduler as jsched  # noqa: E402
from tpu_engine.mesh_runtime import MeshConfig as JMesh  # noqa: E402
from tpu_engine.sharding import TPUTrainConfig  # noqa: E402
from tpu_engine_torch import compile_index as tcompile  # noqa: E402
from tpu_engine_torch import launcher as tlaunch  # noqa: E402
from tpu_engine_torch import placement as tplace  # noqa: E402
from tpu_engine_torch import scheduler as tsched  # noqa: E402
from tpu_engine_torch.mesh_runtime import MeshConfig as TMesh  # noqa: E402
from tpu_engine_torch.train import TrainConfig  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CONSTANTS = dict(peak_flops=jplace.NOMINAL_PEAK_FLOPS, ici_bytes_s=jplace.NOMINAL_ICI_BYTES_S,
                     dcn_bytes_s=jplace.NOMINAL_DCN_BYTES_S)
# Text that names the runtime: JAX's says "TPU slices", the port's a
# process group; the placement note names the module.
PORT_TEXT = {("elasticity", "note"), ("placement", "note")}


@pytest.fixture
def one_device(monkeypatch):
    """JAX's view of one visible device, as the port's on this machine."""
    monkeypatch.setattr(jlaunch.jax, "device_count", lambda: 1)
    assert tplace.visible_device_count() == 1


def _launchers():
    """Each package's launcher on JAX's constants and a fresh compile index
    (the process-wide ones hold what other tests recorded)."""
    j = jlaunch.TPULauncher(scheduler=jsched.FleetScheduler(
        planner=jplace.PlacementPlanner(**JAX_CONSTANTS),
        compile_index=jcompile.CompileCacheIndex()))
    t = tlaunch.TPULauncher(scheduler=tsched.FleetScheduler(
        planner=tplace.PlacementPlanner(**JAX_CONSTANTS), device="cpu",
        compile_index=tcompile.CompileCacheIndex()))
    return j, t


def _strip(plan):
    plan = json.loads(json.dumps(plan, default=str))
    for section, key in PORT_TEXT:
        plan.get(section, {}).pop(key, None)
    return plan


def test_presets_equal_jax():
    want, got = jlaunch.TPULauncher.presets(), tlaunch.TPULauncher.presets()
    assert list(got) == list(want)
    shared = {f.name for f in dataclasses.fields(TrainConfig)} & set(TPUTrainConfig.model_fields)
    for name in want:
        w, g = want[name].model_dump(), dataclasses.asdict(got[name])
        for f in sorted(shared):
            wv, gv = w[f], g[f]
            if f == "mesh":
                wv = {k: wv[k] for k in gv}
            wv = getattr(wv, "value", wv)
            assert (list(gv) if isinstance(gv, tuple) else gv) == (
                list(wv) if isinstance(wv, tuple) else wv), (name, f)


@pytest.mark.parametrize("name", ["125m", "1b", "7b", "13b", "70b", "8x7b"])
def test_generate_plan_equals_jax(name, one_device):
    """Every key of JAX's plan, the representative specs of each ZeRO
    stage and the placement table included; the 1b preset's fsdp=8 reads
    as the requested shape on one device."""
    jl, tl = _launchers()
    try:
        want = _strip(jl.generate_plan(jlaunch.TPULauncher.presets()[name]))
        got = _strip(tl.generate_plan(tlaunch.TPULauncher.presets()[name]))
    finally:
        jl.scheduler.shutdown()
        tl.scheduler.shutdown()
    assert got == want
    if name == "1b":
        assert got["mesh"]["note"].startswith("requested shape (does not fit the 1 visible")


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_plan_specs_each_stage(stage, one_device):
    jl, tl = _launchers()
    kw = dict(model_name="gpt-tiny", seq_len=32, sharding_stage=stage,
              pipeline_schedule="zb", gradient_accumulation_steps=4)
    try:
        want = jl.generate_plan(TPUTrainConfig(mesh=JMesh(data=1, fsdp=2, pipe=2), **kw))
        got = tl.generate_plan(TrainConfig(mesh=TMesh(data=1, fsdp=2, pipe=2), **kw))
    finally:
        jl.scheduler.shutdown()
        tl.scheduler.shutdown()
    assert _strip(got) == _strip(want)


def test_dry_run_result_fields(one_device):
    jl, tl = _launchers()
    try:
        want = jl.launch(jlaunch.TPULauncher.presets()["7b"], dry_run=True)
        got = tl.launch(tlaunch.TPULauncher.presets()["7b"], dry_run=True)
        unknown = tl.launch(TrainConfig(model_name="nope"), block=True)
        junknown = jl.launch(TPUTrainConfig(model_name="nope"), block=True)
    finally:
        jl.scheduler.shutdown()
        tl.scheduler.shutdown()
    assert set(got.model_dump()) == set(want.model_dump())
    for k in ("status", "model_name", "effective_batch_size", "num_devices", "error",
              "submission_id", "queue_position"):
        assert getattr(got, k) == getattr(want, k), k
    assert tl.list_jobs() == [] and got.job_id.startswith("tpu_llama-7b_")
    assert unknown.status == junknown.status == "failed"
    assert unknown.error.split(";")[0] == junknown.error.split(";")[0]


SEP = "=====\n"
JAX_BOTH = (  # JAX's two CLI calls in one interpreter: its import is the slow part
    "import sys\nfrom tpu_engine.launcher import main\n"
    "rc = main(['--list-presets'])\nprint('=====')\n"
    "sys.exit(rc or main(sys.argv[1:]))\n")


def _start(*args):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1",
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)


def test_cli_list_presets_and_dry_run():
    """Both CLIs in subprocesses of one visible device: the same preset
    lines; the 1b dry run's plan equal but for the placement table (H100
    against v5e constants) and the runtime's own text."""
    args = ("--preset", "1b", "--dry-run", "--set", "seq_len=1024")
    procs = [_start("-c", JAX_BOTH, *args),
             _start("-m", "tpu_engine_torch.launcher", "--list-presets"),
             _start("-m", "tpu_engine_torch.launcher", *args)]
    (jout, jerr), (lout, lerr), (dout, derr) = (p.communicate(timeout=240) for p in procs)
    assert [p.returncode for p in procs] == [0, 0, 0], (jerr + lerr + derr)[-3000:]
    want_list, want_dry = jout.split(SEP)
    assert lout == want_list and "1b: llama-1b stage=3 eff_batch=128" in lout
    w, g = json.loads(want_dry), json.loads(dout)
    assert g["status"] == w["status"] == "dry_run" and g["plan"]["model"]["seq_len"] == 1024
    drop = ("placement", "elasticity")
    assert ({k: v for k, v in g["plan"].items() if k not in drop}
            == {k: v for k, v in w["plan"].items() if k not in drop})
    with pytest.raises(SystemExit) as bad:
        tlaunch.main(["--preset", "nope"])
    assert bad.value.code == 2


def test_real_tiny_launch_on_the_cpu(tmp_path):
    """gpt-tiny through ``TPULauncher(device="cpu").launch(block=True)``:
    admitted, run to completion, registered; a gang of two devices in this
    one process fails at construction with the reason."""
    launcher = tlaunch.TPULauncher(device="cpu")
    try:
        cfg = TrainConfig(model_name="gpt-tiny", mesh=TMesh(data=1), micro_batch_size=2,
                          seq_len=32, precision="fp32", total_steps=3, warmup_steps=1,
                          activation_checkpointing=False, attention_impl="xla",
                          checkpoint_dir=str(tmp_path / "ck"))
        res = launcher.launch(cfg, max_steps=3, block=True)
        assert res.status == "launched" and res.num_devices == 1
        job = launcher.get_job(res.job_id)
        d = job.describe()
        assert d["status"] == "completed" and d["current_step"] == 3
        assert launcher.delete_job(res.job_id) and launcher.get_job(res.job_id) is None
        bad = launcher.launch(dataclasses.replace(cfg, mesh=TMesh(data=2)), block=True)
        assert bad.status == "failed" and "one process a rank" in bad.error
    finally:
        launcher.scheduler.shutdown()
