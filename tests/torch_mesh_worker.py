"""One rank of the port's mesh tests (``tests/test_torch_mesh.py``,
``tests/test_torch_mesh_train.py``, ``tests/test_torch_tp_train.py``,
``tests/test_torch_tp_serving.py``, ``tests/test_torch_pipeline.py``,
``tests/test_torch_tp_lora.py``, ``tests/test_torch_tp_int8_serving.py``),
run as its own process on the CPU with ``gloo``, and the parent's launcher
(:func:`spawn`).

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


def _runtime(mesh: dict):
    from tpu_engine_torch.mesh_runtime import MeshConfig, MeshRuntime

    key = json.dumps(mesh, sort_keys=True)
    if key not in _RUNTIMES:
        _RUNTIMES[key] = MeshRuntime(MeshConfig(**mesh), device="cpu")
    return _RUNTIMES[key]


def _whole_grads(prog, state, batch) -> dict:
    """The step's gradients of ``batch`` at ``state``'s weights, reduced
    over the ranks as the step reduces them and gathered whole (over
    ``fsdp`` where they are split, then over ``model``, then over
    ``pipe``)."""
    _, grads = prog.mesh_grads(state["params"], batch)
    whole = prog.whole_tree(grads, split=prog.zero.grads_split)
    return {f"grad:{k}": g.numpy() for k, g in whole.items()}


def _train(case: dict, rank: int) -> dict:
    import torch

    from tpu_engine_torch.mesh_runtime import MeshConfig
    from tpu_engine_torch.models.config import MODEL_CONFIGS
    from tpu_engine_torch.train import TrainConfig, build_train_program

    cfg = TrainConfig(mesh=MeshConfig(**case["mesh"]), **case["cfg"])
    model_cfg = None
    if case.get("model_cfg"):  # a config of the catalog with fields changed
        model_cfg = MODEL_CONFIGS[cfg.model_name].with_(**case["model_cfg"])
    base = None
    if case.get("base"):  # LoRA: the frozen base; "init" holds the adapters
        base = {k: torch.tensor(v) for k, v in np.load(case["base"]).items()}
    prog = build_train_program(cfg, model_cfg, device="cpu", base_params=base,
                               runtime=_runtime(case["mesh"]))
    init = np.load(case["init"])
    state = prog.init(params={k: torch.tensor(init[k]).requires_grad_(True)
                              for k in init.files})

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree.values())

    out = {"param_bytes": nbytes(state["params"]),
           "opt_bytes": sum(nbytes(t) for n, t in state["opt_state"].items() if n != "count")}
    out.update({f"numel:{k}": p.numel() for k, p in state["params"].items()})
    if case.get("held"):  # the leaves this rank holds, as placed
        out.update({f"held:{k}": p.detach().numpy().copy() for k, p in state["params"].items()})
    out["schedule"] = prog.pipeline_schedule
    if case.get("grads"):
        out.update(_whole_grads(prog, state, torch.tensor(np.load(case["batches"])[0],
                                                          dtype=torch.long)))
    losses, norms = [], []
    from tpu_engine_torch.parallel import collectives

    for b in np.load(case["batches"]):
        collectives.reset_moved()  # the bytes of the last step are kept
        state, m = prog.step(state, torch.tensor(b, dtype=torch.long))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out.update({f"moved:{k}": v for k, v in collectives.moved.items()})
    out.update(losses=np.array(losses), norms=np.array(norms))
    out["eval"] = float(prog.eval_step(state, torch.tensor(np.load(case["batches"])[0],
                                                           dtype=torch.long)))
    for k, p in prog.whole_params(state).items():
        out[f"param:{k}"] = p.detach().numpy()
    if case.get("merged"):  # LoRA: this rank's block of the merged tree
        out.update({f"merged:{k}": p.numpy()
                    for k, p in prog.merged_params(state["params"]).items()})
    return out


def _attention(case: dict, rank: int) -> dict:
    """This rank's shard of ring or Ulysses attention across the ranks and
    its gradients under a given output cotangent."""
    import torch

    from tpu_engine_torch.parallel.ring_attention import ring_mha_group
    from tpu_engine_torch.parallel.ulysses_attention import ulysses_mha_group

    rt = _runtime(case["mesh"])
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


def _serve(case: dict, rank: int) -> dict:
    """A ``ContinuousBatcher`` on the mesh from the whole weights of
    ``init``, driven as ``tests/test_torch_serving.py``'s ``_drive``: rank 0
    submits ``plan``'s requests (``[at_step, prompt, max_new_tokens,
    temperature]``) before the step of that index and steps until every
    one is done, then shuts the others down; the others step until then.
    Returns every rank's streams, the first-token logits of each request
    and the prefix cache's hits."""
    import torch

    from tpu_engine_torch.models.config import MODEL_CONFIGS
    from tpu_engine_torch.serving import ContinuousBatcher

    from tpu_engine_torch.serving import SpecGeometryError

    rt = _runtime(case["mesh"])
    cfg = MODEL_CONFIGS[case["model"]]
    params = {k: torch.tensor(v) for k, v in np.load(case["init"]).items()}
    held = {}
    if case.get("quant") == "tree":  # the whole int8 tree; the batcher cuts it
        from tpu_engine_torch.quant import quantize_params

        params = quantize_params(params)
    elif case.get("quant") == "snapshot":  # this rank's blocks, read from the files
        from tpu_engine_torch.quant import QuantWeight, load_quantized

        params = load_quantized(case["snapshot"], device="cpu", mesh=rt)
        for k, v in params.items():
            if isinstance(v, QuantWeight):
                held[f"held:{k}.q"], held[f"held:{k}.scale"] = v.q.numpy(), v.scale.numpy()
            else:
                held[f"held:{k}"] = v.numpy()
    if case.get("refusals"):  # a draft on the mesh, and a mesh with data=2
        out = {}
        try:
            ContinuousBatcher(params, cfg, compute_dtype=torch.float32, device="cpu", mesh=rt,
                              draft_params=params, draft_cfg=cfg)
        except SpecGeometryError as e:
            out["draft_kind"] = e.kind
        try:
            ContinuousBatcher(params, cfg, compute_dtype=torch.float32, device="cpu",
                              mesh=_runtime({"data": 2}))
        except NotImplementedError as e:
            out["data2"] = str(e)
        return out
    srv = ContinuousBatcher(params, cfg, compute_dtype=torch.float32, device="cpu", mesh=rt,
                            **case["batcher"])
    first = {}
    real = srv._first_token

    def record(logits, req):
        first[req.id] = logits.numpy().copy()
        return real(logits, req)

    srv._first_token = record
    plan = case["plan"]
    if rt.coords["model"] == 0:
        ids = [None] * len(plan)
        for n in range(200):
            for i, (at, prompt, m, t) in enumerate(plan):
                if at == n:
                    ids[i] = srv.submit(prompt, max_new_tokens=m, temperature=t)
            if all(r is not None and srv.result(r)["status"] == "done" for r in ids):
                break
            srv.step()
        srv.shutdown()
    else:
        while not srv._closed:
            srv.step()
    out = {"hits": srv.stats().get("prefix_cache", {}).get("hits", 0),
           "kv_heads": srv._cache.k.shape[2], **held}
    for i in range(len(plan)):
        res = srv.result(i)
        out[f"tokens:{i}"] = np.array(res["tokens"])
        out[f"status_done:{i}"] = res["status"] == "done"
        out[f"first:{i}"] = first[i]
    return out


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
    run = {"train": _train, "attention": _attention, "rendezvous": _rendezvous,
           "serve": _serve}
    for case in job["cases"]:
        out = run[case["kind"]](case, rank)
        np.savez(os.path.join(job["out"], f"{case['name']}.rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
