"""One rank of the port's mesh tests (``tests/test_torch_mesh.py``,
``tests/test_torch_mesh_train.py``), run as its own process on the CPU with
``gloo``, and the parent's launcher (:func:`spawn`).

``python tests/torch_mesh_worker.py JOB RANK WORLD`` reads the job (JSON:
the rendezvous store, the output directory, the cases), joins the process
group through ``initialize_distributed`` (a ``file://`` store, so parallel
test workers never share a port) and runs every case in turn, writing
``<out>/<case>.rank<R>.npz``. It imports no JAX."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

TIMEOUT_S = 120


def spawn(job: dict, world: int, tmp_path, timeout: float = TIMEOUT_S, during=None):
    """Run ``job`` on ``world`` worker processes; returns
    {(case, rank): the rank's arrays}, or with ``during`` (called while the
    workers run) the pair (that, what ``during`` returned). A worker that
    fails or outlives ``timeout`` fails the caller (every worker is killed
    first)."""
    import pytest

    job = {**job, "store": str(tmp_path / "store"), "out": str(tmp_path / "out")}
    os.makedirs(job["out"], exist_ok=True)
    path = tmp_path / "job.json"
    path.write_text(json.dumps(job))
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    logs = [tmp_path / f"rank{r}.log" for r in range(world)]
    procs = []
    for r in range(world):  # output to files: nothing blocks on a full pipe
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(path), str(r), str(world)],
                stdout=log, stderr=subprocess.STDOUT, env=env, cwd=root))
    deadline = time.monotonic() + timeout
    try:
        meanwhile = during() if during is not None else None
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                pytest.fail(f"mesh workers outlived {timeout} s (a collective hang?)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r].read_text()[-4000:]}"
    got = {(c["name"], r): dict(np.load(os.path.join(job["out"], f"{c['name']}.rank{r}.npz")))
           for c in job["cases"] for r in range(world)}
    return got if during is None else (got, meanwhile)


_RUNTIMES: dict = {}  # one per mesh shape: its groups are made once


def _train(case: dict, rank: int) -> dict:
    import torch

    from tpu_engine_torch.mesh_runtime import MeshConfig, MeshRuntime
    from tpu_engine_torch.train import TrainConfig, build_train_program

    cfg = TrainConfig(mesh=MeshConfig(**case["mesh"]), **case["cfg"])
    key = json.dumps(case["mesh"], sort_keys=True)
    if key not in _RUNTIMES:
        _RUNTIMES[key] = MeshRuntime(cfg.mesh, device="cpu")
    base = None
    if case.get("base"):  # LoRA: the frozen base; "init" holds the adapters
        base = {k: torch.tensor(v) for k, v in np.load(case["base"]).items()}
    prog = build_train_program(cfg, device="cpu", base_params=base, runtime=_RUNTIMES[key])
    init = np.load(case["init"])
    state = prog.init(params={k: torch.tensor(init[k]).requires_grad_(True)
                              for k in init.files})

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree.values())

    out = {"param_bytes": nbytes(state["params"]),
           "opt_bytes": sum(nbytes(t) for n, t in state["opt_state"].items() if n != "count")}
    losses, norms = [], []
    for b in np.load(case["batches"]):
        state, m = prog.step(state, torch.tensor(b, dtype=torch.long))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out.update(losses=np.array(losses), norms=np.array(norms))
    out["eval"] = float(prog.eval_step(state, torch.tensor(np.load(case["batches"])[0],
                                                           dtype=torch.long)))
    for k, p in prog.whole_params(state).items():
        out[f"param:{k}"] = p.detach().numpy()
    return out


def _attention(case: dict, rank: int) -> dict:
    """This rank's shard of ring or Ulysses attention across the ranks and
    its gradients under a given output cotangent."""
    import torch

    from tpu_engine_torch.mesh_runtime import MeshConfig, MeshRuntime
    from tpu_engine_torch.parallel.ring_attention import ring_mha_group
    from tpu_engine_torch.parallel.ulysses_attention import ulysses_mha_group

    rt = MeshRuntime(MeshConfig(**case["mesh"]), device="cpu")
    n, s = rt.axis_sizes["sequence"], rt.coords["sequence"]
    data = np.load(case["inputs"])
    S = data["q"].shape[1]
    blk = slice(s * S // n, (s + 1) * S // n)
    q, k, v = (torch.tensor(data[x][:, blk]).requires_grad_(True) for x in ("q", "k", "v"))
    fn = ring_mha_group if case["impl"] == "ring" else ulysses_mha_group
    o = fn(q, k, v, rt.group("sequence"), causal=True)
    (o * torch.tensor(data["do"][:, blk])).sum().backward()
    return {"o": o.detach().numpy(), "dq": q.grad.numpy(), "dk": k.grad.numpy(),
            "dv": v.grad.numpy()}


def _rendezvous(case: dict, rank: int) -> dict:
    """The process group as ``initialize_distributed`` joined it: the
    default mesh over every rank, the topology report and one all-reduce."""
    import torch
    import torch.distributed as dist

    from tpu_engine_torch.mesh_runtime import MeshRuntime

    rt = MeshRuntime(device="cpu")
    t = torch.tensor([float(rank + 1)])
    dist.all_reduce(t)
    rep = rt.topology_report()
    return {"sizes": np.array([rt.axis_sizes[a] for a in ("data", "fsdp", "pipe", "sequence",
                                                           "model")]),
            "sum": float(t), "processes": rep["num_processes"], "index": rep["process_index"],
            "backend": rep["backend"], "dp": rt.data_parallel_size()}


def main(job_path: str, rank: int, world: int) -> None:
    import torch

    from tpu_engine_torch.mesh_runtime import initialize_distributed

    torch.set_num_threads(1)
    job = json.loads(open(job_path).read())
    if job.get("master"):
        # torchrun's environment, and no argument.
        assert not initialize_distributed(device="cpu")  # nothing to join yet
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(job["master"]),
                          RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0")
        assert initialize_distributed(device="cpu")
    else:
        assert initialize_distributed(f"file://{job['store']}", world, rank, device="cpu")
    run = {"train": _train, "attention": _attention, "rendezvous": _rendezvous}
    for case in job["cases"]:
        out = run[case["kind"]](case, rank)
        np.savez(os.path.join(job["out"], f"{case['name']}.rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
