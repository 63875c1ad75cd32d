"""One rank of the port's mesh tests (``tests/test_torch_mesh.py``,
``tests/test_torch_mesh_train.py``, ``tests/test_torch_tp_train.py``,
``tests/test_torch_tp_serving.py``, ``tests/test_torch_pipeline.py``,
``tests/test_torch_tp_lora.py``, ``tests/test_torch_tp_int8_serving.py``,
``tests/test_torch_comm_compress.py``, ``tests/test_torch_checkpoint.py``,
``tests/test_torch_disagg.py``,
``tests/test_torch_reshard.py``, ``tests/test_torch_mesh_place.py``,
``tests/test_torch_mesh_int8.py``, ``tests/test_torch_mesh_moe_seq.py``,
``tests/test_torch_data.py``),
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


def _runtime(mesh: dict, slices=None):
    from tpu_engine_torch.mesh_runtime import MeshConfig, MeshRuntime

    key = json.dumps([mesh, slices], sort_keys=True)
    if key not in _RUNTIMES:
        _RUNTIMES[key] = MeshRuntime(MeshConfig(**mesh), device="cpu", slice_assignments=slices)
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
                               runtime=_runtime(case["mesh"], case.get("slices")))
    init = np.load(case["init"])
    state = prog.init(params={k: torch.tensor(init[k]).requires_grad_(True)
                              for k in init.files})

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree.values())

    opt = state.get("opt_state", {})
    out = {"param_bytes": nbytes(state["params"]),
           "opt_bytes": sum(nbytes(t) for n, t in opt.items() if n != "count")}
    # Where the state lives: every leaf in a host arena (host placements).
    out["params_in_arena"] = all(hasattr(t, "_host_arena") for t in state["params"].values())
    out["opt_in_arena"] = all(hasattr(t, "_host_arena") for n, tree in opt.items()
                              if n != "count" for t in tree.values())
    out.update({f"numel:{k}": p.numel() for k, p in state["params"].items()})
    if case.get("held"):  # the leaves this rank holds, as placed
        out.update({f"held:{k}": p.detach().numpy().copy() for k, p in state["params"].items()})
    out["schedule"] = prog.pipeline_schedule
    if case.get("grads"):
        out.update(_whole_grads(prog, state, torch.tensor(np.load(case["batches"])[0],
                                                          dtype=torch.long)))
    losses, norms = [], []
    from tpu_engine_torch import quant_train
    from tpu_engine_torch.parallel import collectives

    quant_train.reset_launches()
    for b in np.load(case["batches"]):
        collectives.reset_moved()  # the bytes of the last step are kept
        state, m = prog.step(state, torch.tensor(b, dtype=torch.long))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out.update({f"moved:{k}": v for k, v in collectives.moved.items()})
    from tpu_engine_torch.comm_compress import collective_stats

    out["stats"] = json.dumps(collective_stats())
    for part, tree in state.get("hpz", {}).items():  # hpZ's store, as the last step left it
        out.update({f"hpz_{part}:{k}": t.numpy() for k, t in tree.items()})
        out.update({f"shard:{k}": state["params"][k].detach().numpy() for k in tree})
    out.update(losses=np.array(losses), norms=np.array(norms))
    out["int_mm"] = quant_train.launches["int_mm"]
    out["h2d"] = prog.transfer_bytes()["h2d"]
    if prog.disk is not None:
        out["consensus_checks"] = prog.disk.store.consensus_checks
        out["step_on_disk"] = prog.disk.store.step_on_disk
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


def _handoff(case: dict, rank: int) -> dict:
    """The batcher's handoff plane on the mesh, rank 0 calling it and
    stepping, the others stepping until it stops them: a held prefill of
    ``prompt`` extracted with the fp32 and the int8 wire, the given payload
    (``payload``: its arrays, ``payload_meta``: the rest) decoded, a prefix
    exported after ``long_prompt``, and the given payload installed under
    ``install_key``, with the first logits of ``probe`` after it."""
    import torch

    from tpu_engine_torch.disagg import KVHandoff
    from tpu_engine_torch.models.config import MODEL_CONFIGS
    from tpu_engine_torch.serving import ContinuousBatcher

    rt = _runtime(case["mesh"])
    cfg = MODEL_CONFIGS[case["model"]]
    params = {k: torch.tensor(v) for k, v in np.load(case["init"]).items()}
    srv = ContinuousBatcher(params, cfg, compute_dtype=torch.float32, device="cpu", mesh=rt,
                            **case["batcher"])
    out = {"kv_heads": srv._cache.k.shape[2]}
    if rt.coords["model"] != 0:
        while not srv._closed:
            srv.step()
        return {**out, "held": len(srv.held_requests())}
    arrays = dict(np.load(case["payload"]))
    given = KVHandoff(**case["payload_meta"], k=arrays["k"], v=arrays["v"])

    def until(pred):
        for _ in range(300):
            if pred():
                return
            srv.step()
        raise AssertionError("the mesh batcher stalled")

    for q in (0, 1):
        rid = srv.submit(case["prompt"], max_new_tokens=1, hold_kv=True)
        until(lambda: srv.result(rid)["status"] == "done")
        srv.request_handoff(rid, quantize=bool(q))
        got = []
        until(lambda: got.append(srv.take_handoff(rid)) or got[-1] is not None)
        h = got[-1]
        out.update({f"extract{q}:k": h.k, f"extract{q}:v": h.v,
                    f"extract{q}:meta": np.array([h.length, h.n_kv_heads] + h.emitted)})
        if q:
            out.update({"extract1:k_scale": h.k_scale, "extract1:v_scale": h.v_scale})
    d = srv.submit_prefilled(given, max_new_tokens=6)
    until(lambda: srv.result(d)["status"] == "done")
    out["decoded"] = np.array(srv.result(d)["tokens"])
    r = srv.submit(case["long_prompt"], max_new_tokens=1)
    until(lambda: srv.result(r)["status"] == "done")
    key = max(srv._prefix_cache._entries, key=len)
    e = srv.export_prefix(list(key))
    out.update({"export:key": np.array(key), "export:k": e.k, "export:v": e.v})
    out["installed"] = srv.install_prefix(case["install_key"], given)
    first = []
    real = srv._first_token
    srv._first_token = lambda logits, req: first.append(logits.numpy().copy()) or real(logits, req)
    p = srv.submit(case["probe"], max_new_tokens=1)
    until(lambda: srv.result(p)["status"] == "done")
    out.update(probe_first=first[-1], hits=srv.stats()["prefix_cache"]["hits"],
               handoffs=[srv.handoffs_out, srv.handoffs_in])
    srv.shutdown()
    return {**out, "held": len(srv.held_requests())}


def _flat_tensors(state: dict) -> dict:
    from tpu_engine_torch.checkpoint import flatten_state

    return {k: v.detach().clone() for k, v in flatten_state(state).items()
            if hasattr(v, "detach")}


def _whole_state(prog, state: dict) -> dict:
    """Params and AdamW moments gathered whole (stage 3's shards, every
    pipeline stage's leaves)."""
    z = prog.zero
    out = {f"param:{k}": v.detach().numpy().copy() for k, v in prog.whole_params(state).items()}
    for name in ("mu", "nu"):
        tree = prog.whole_tree(state["opt_state"][name], split=z.state_split)
        out.update({f"{name}:{k}": v.numpy().copy() for k, v in tree.items()})
    return out


def _ckpt(case: dict, rank: int) -> dict:
    """A checkpoint on the mesh. ``save``: steps 1–2 from ``init``, an
    asynchronous save of step 2 raced by step 3's in-place update, then a
    fresh program restored from it (its state against the snapshot taken
    at the save, bitwise) and its step 3. ``reshard``: a fresh program on
    this mesh restored through ``restore_resharded`` and its step 3. Both
    return the whole state of step 2 and the losses and whole state after
    step 3."""
    import torch

    from tpu_engine_torch import checkpoint as ck
    from tpu_engine_torch import reshard
    from tpu_engine_torch.mesh_runtime import MeshConfig
    from tpu_engine_torch.train import TrainConfig, build_train_program

    rt = _runtime(case["mesh"])
    cfg = TrainConfig(mesh=MeshConfig(**case["mesh"]), **case["cfg"])
    batches = [torch.tensor(b, dtype=torch.long) for b in np.load(case["batches"])]
    prog = build_train_program(cfg, device="cpu", runtime=rt)
    out = {}
    if case["mode"] == "save":
        init = np.load(case["init"])
        state = prog.init(params={k: torch.tensor(init[k]) for k in init.files})
        for b in batches[:2]:
            state, _ = prog.step(state, b)
        mgr = ck.TrainCheckpointManager(case["dir"], program=prog)
        assert mgr.save(2, state)  # asynchronous: step 3 below updates in place meanwhile
        snapshot = _flat_tensors(state)
        out.update({f"s2.{k}": v for k, v in _whole_state(prog, state).items()})
        if rank == 0:
            reshard.write_topology(case["dir"], reshard.mesh_topology(rt))
        state, m = prog.step(state, batches[2])
        mgr.wait_until_finished()
        out["loss3"] = float(m["loss"])
        out.update({f"s3.{k}": v for k, v in _whole_state(prog, state).items()})
        prog2 = build_train_program(cfg, device="cpu", runtime=rt)
        mgr2 = ck.TrainCheckpointManager(case["dir"], program=prog2)
        step, restored = mgr2.restore(ck.abstract_state_like(prog2))
        got = _flat_tensors(restored)
        out["restored_step"] = step
        out["bitwise"] = (got.keys() == snapshot.keys()
                          and all(torch.equal(got[k], snapshot[k]) for k in got))
        out["scalars"] = np.array([restored["step"], restored["opt_state"]["count"]])
        restored, m = prog2.step(restored, batches[2])
        out["loss3_restored"] = float(m["loss"])
        out.update({f"r3.{k}": v for k, v in _whole_state(prog2, restored).items()})
    else:
        mgr = ck.TrainCheckpointManager(case["dir"], program=prog)
        step, state, report = reshard.restore_resharded(mgr, ck.abstract_state_like(prog),
                                                        program=prog)
        out["restored_step"], out["parity_ok"] = step, report["parity_ok"]
        out.update({f"s2.{k}": v for k, v in _whole_state(prog, state).items()})
        state, m = prog.step(state, batches[2])
        out["loss3"] = float(m["loss"])
        out.update({f"s3.{k}": v for k, v in _whole_state(prog, state).items()})
    return out


def _disk(case: dict, rank: int) -> dict:
    """The disk tier's agreement across the ranks, after a ``train`` case
    left its spill under ``case["dir"]`` at step 3. ``torn``: rank 1's
    spill is torn (an update in progress); a fresh program on every rank
    then reseeds from the weights it is given instead of attaching.
    ``behind``: rank 1's spill says it applied step 2; every rank attaches,
    and the first step from a state at step 3 reseeds every rank's masters
    (moments zeroed), so the next steps count moments from 1. Returns each
    rank's params after init (whole), the attach decision and the moment
    steps and checks after one more step."""
    import json as _json

    import torch

    from tpu_engine_torch.mesh_runtime import MeshConfig
    from tpu_engine_torch.train import TrainConfig, build_train_program

    rt = _runtime(case["mesh"])
    cfg = TrainConfig(mesh=MeshConfig(**case["mesh"]), **case["cfg"])
    meta = os.path.join(case["cfg"]["optimizer_spill_dir"], f"proc{rank}", "disk_adamw.json")
    if rank == 1:
        m = _json.load(open(meta))
        if case["mode"] == "torn":
            m["in_progress"] = 4
        else:
            m["step"] = 2
        _json.dump(m, open(meta, "w"))
    torch.distributed.barrier()
    prog = build_train_program(cfg, device="cpu", runtime=rt)
    init = np.load(case["init"])
    state = prog.init(params={k: torch.tensor(init[k]) for k in init.files})
    out = {f"init:{k}": v.detach().float().numpy()
           for k, v in prog.whole_params(state).items()}
    store = prog.disk.store
    out["attached_step"] = -1 if store.step_on_disk is None else store.step_on_disk
    state["step"] = 3
    state, _ = prog.step(state, torch.tensor(np.load(case["batches"])[0], dtype=torch.long))
    out["moment_steps"] = prog.disk.store.moment_steps
    out["consensus_checks"] = prog.disk.store.consensus_checks
    return out


def _int8_scales(case: dict, rank: int) -> dict:
    """The weight gradient's operand scales on this rank's rows of a global
    [B, S, D] operand, reduced over the token ranks (``token_scales``),
    and the forward codes of its own rows."""
    import torch

    from tpu_engine_torch import quant_train as qt
    from tpu_engine_torch.parallel import zero

    rt = _runtime(case["mesh"])
    x = torch.tensor(np.load(case["inputs"])["x"])
    rows = zero.local_rows(x.unsqueeze(0), rt, x.shape[0] // rt.data_parallel_size())[0]
    _, scales = qt.channel_quantize(rows, (0, 1), group=rt.group(("data", "fsdp", "sequence")))
    codes, row_scales = qt.channel_quantize(rows, (2,))
    return {"scales": scales.numpy(), "codes": codes.numpy(), "row_scales": row_scales.numpy()}


def _int8_tp_scales(case: dict, rank: int) -> dict:
    """Two int8 products of gpt-tiny (``case["model_cfg"]`` changed) on
    ``model``, with the scales each operand was quantised with:

    * the o and down forward on this rank's blocks of whole operands (its
      columns of the activation, its rows of the kernel), through the
      block's row-parallel projection, and the output summed over
      ``model``;
    * the q, k and v input gradient, one backward through the block's
      ``_qkv`` from the whole input and this rank's kernel columns (K and V
      whole where the kv heads do not split), each output's cotangent drawn
      from a seed and the rank's ``model`` index: the gradient operand and
      the kernel block each product was given, and their scales."""
    import torch

    from tpu_engine_torch import quant_train as qt
    from tpu_engine_torch.models import transformer as tfm
    from tpu_engine_torch.models.config import MODEL_CONFIGS
    from tpu_engine_torch.parallel.tensor_parallel import model_axis

    cfg = MODEL_CONFIGS["gpt-tiny"].with_(**case.get("model_cfg", {}))
    rt = _runtime(case["mesh"])
    tp = model_axis(rt, cfg)
    seen, plain = [], qt.channel_quantize

    def spy(x, axes, *a, **kw):
        codes, scales = plain(x, axes, *a, **kw)
        seen.append((x.detach().numpy().copy(), scales.numpy().copy()))
        return codes, scales

    qt.channel_quantize = spy
    out = {}
    ops = np.load(case["inputs"])
    try:
        for name in ("o", "down"):
            x, w = torch.tensor(ops[f"{name}_x"]), torch.tensor(ops[f"{name}_w"])
            n = x.shape[-1] // tp.size
            xb, wb = x.narrow(-1, tp.index * n, n), w.narrow(0, tp.index * n, n)
            seen.clear()
            y = tfm._row_proj(xb, {f"{name}.kernel": wb}, name, qt.int8_einsum, tp=tp)
            (_, out[f"{name}_x_scales"]), (_, out[f"{name}_w_scales"]) = seen
            out[f"{name}_y"] = y.numpy()
        h = torch.tensor(ops["qkv_h"], requires_grad=True)
        lp = {}
        for name in ("q", "k", "v"):
            w = torch.tensor(ops[f"{name}_w"])
            n = w.shape[-1] // tp.size
            lp[f"{name}.kernel"] = (w if name != "q" and not tp.kv_split
                                    else w.narrow(-1, tp.index * n, n))
        positions = torch.arange(h.shape[1]).expand(h.shape[0], -1)
        seen.clear()
        outs = tfm._qkv(h, lp, cfg, positions, qt.int8_einsum, tp=tp)
        gen = torch.Generator().manual_seed(10 + tp.index)
        loss = sum((t * torch.randn(t.shape, generator=gen)).sum() for t in outs)
        n_fwd = len(seen)
        loss.backward()
        blocks = {k: v.detach().numpy() for k, v in lp.items()}
        for i in range(n_fwd, len(seen), 2):  # each input gradient: (g, kernel) in turn
            (g, sg), (w, sw) = seen[i], seen[i + 1]
            name = next(k[0] for k, b in blocks.items() if b.shape == w.shape
                        and np.array_equal(b, w))
            out.update({f"{name}_g": g, f"{name}_g_scales": sg, f"{name}_wb": w,
                        f"{name}_wb_scales": sw})
        out.update(model_index=tp.index, data_index=rt.coords["data"])
    finally:
        qt.channel_quantize = plain
    return out


def _hetero_job(case: dict, rank: int) -> dict:
    """A supervised job on the mesh reading a token file through the
    sharded stream, with (``plant``) a live heterogeneity plan that moves
    rows off a slow rank: JAX's rule rejects the unequal split, the job
    records ``hetero_reassign_rejected``, keeps its split and completes.
    Returns the status, the losses and the rejection events' count."""
    import torch.distributed as dist

    from tpu_engine_torch import hetero, tracing
    from tpu_engine_torch.mesh_runtime import MeshConfig
    from tpu_engine_torch.supervisor import TrainingJob
    from tpu_engine_torch.train import TrainConfig

    log_path = os.path.join(case["out"], f"{case['name']}.rank{rank}.jsonl")
    cfg = TrainConfig(mesh=MeshConfig(**case["mesh"]), metrics_log_path=log_path,
                      log_every_steps=1, **case["cfg"])
    world = dist.get_world_size()
    reb = None
    if case["plant"]:
        reb = hetero.HeteroRebalancer(
            hetero.ThroughputTracker(world), cfg.micro_batch_size * world, sustain_consults=1,
            min_gain=0.01, dry_run=False, cooldown_steps=100,
            agree_fn=hetero.broadcast_agree_fn())
        for _ in range(30):
            reb.tracker.note_host_slow(world - 1, 1.0, 1.0)
    job = TrainingJob(f"hetero-{case['name']}", cfg, devices=["cpu"] * world,
                      hetero_rebalancer=reb, hetero_check_interval_steps=1,
                      anomaly_detection=False)
    job.start()
    job.join(timeout=100)
    losses = []
    if os.path.exists(log_path):  # absent when the job failed before its first step
        with open(log_path) as f:
            losses = [r["loss"] for r in map(json.loads, f) if r.get("kind") == "train"]
    rejected = [e for e in tracing.get_recorder().events(limit=0)
                if e["name"] == "hetero_reassign_rejected"]
    return {"status": job.status.value, "error": str(job.error), "losses": np.array(losses),
            "rejected": len(rejected),
            "assignment": np.array(reb.assignment if reb is not None else [])}


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
           "serve": _serve, "ckpt": _ckpt, "disk": _disk, "int8_scales": _int8_scales,
           "int8_tp_scales": _int8_tp_scales, "hetero_job": _hetero_job, "handoff": _handoff}
    for case in job["cases"]:
        out = run[case["kind"]](case, rank)
        np.savez(os.path.join(job["out"], f"{case['name']}.rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
