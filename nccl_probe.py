"""Can two NCCL ranks share one card? On a machine with a single GPU, run
two processes on cuda:0 and check an all-reduce, a reduce-scatter, an
all-to-all and a send/recv, then time a 256 MB all-reduce.

    python3 nccl_probe.py            # distinct NCCL_HOSTID values, then none
    python3 nccl_probe.py --tune     # distinct values, three socket settings
    python3 nccl_probe.py --latency  # a decode step's all-reduce, four settings

``--latency`` times the all-reduce a decode step of llama-1b at model=2
makes twice a layer (bf16 [8, 2048], 32 KB), alone and each after a
[8, 2048] x [2048, 1024] product, 200 times, under each socket setting.

NCCL refuses two ranks with one host hash on one bus id ("Duplicate GPU
detected"); a distinct ``NCCL_HOSTID`` per rank makes them two hosts to
NCCL, which then joins them through its socket transport. Each variant runs
under a 90 s limit; its processes are killed past it.
"""

import json
import os
import subprocess
import sys
import time


def worker(rank: int, port: int) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2)
    out = {"rank": rank, "nccl": ".".join(map(str, torch.cuda.nccl.version()))}
    n = 1 << 20
    x = torch.full((n,), float(rank + 1), device="cuda")
    dist.all_reduce(x)
    out["all_reduce_ok"] = float(x[0]) == 3.0
    y = torch.empty(n // 2, device="cuda")
    dist.reduce_scatter_tensor(y, torch.arange(n, device="cuda", dtype=torch.float32))
    out["reduce_scatter_ok"] = float(y[0]) == 2.0 * rank * n / 2
    z = torch.empty(n, device="cuda")
    dist.all_to_all_single(z, torch.full((n,), float(rank), device="cuda"))
    out["all_to_all_ok"] = [float(z[0]), float(z[-1])] == [0.0, 1.0]
    s, r = torch.full((n,), float(rank), device="cuda"), torch.empty(n, device="cuda")
    for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, s, 1 - rank),
                                     dist.P2POp(dist.irecv, r, 1 - rank)]):
        w.wait()
    out["send_recv_ok"] = float(r[0]) == float(1 - rank)
    t = torch.empty(64 << 20, device="cuda")  # 256 MB of fp32
    dist.all_reduce(t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        dist.all_reduce(t)
    torch.cuda.synchronize()
    out["all_reduce_256MB_ms"] = (time.perf_counter() - t0) / 5 * 1e3
    print("RESULT " + json.dumps(out), flush=True)
    dist.destroy_process_group()


def latency_worker(rank: int, port: int) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2)
    x = torch.ones((8, 2048), dtype=torch.bfloat16, device="cuda")
    w = torch.ones((2048, 1024), dtype=torch.bfloat16, device="cuda")
    out = {"rank": rank}
    for name, product in (("alone", False), ("after_product", True)):
        for n in (20, 200):  # the first 20 warm up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                if product:
                    x[:, :1024] = x @ w * 0
                dist.all_reduce(x)
            torch.cuda.synchronize()
        out[f"{name}_ms"] = (time.perf_counter() - t0) / 200 * 1e3
    print("RESULT " + json.dumps(out), flush=True)
    dist.destroy_process_group()


def variant(name: str, hostids, port: int, extra=None, role: str = "--worker") -> None:
    procs = []
    for r in range(2):
        env = dict(os.environ, NCCL_DEBUG="WARN", **(extra or {}))
        if hostids:
            env["NCCL_HOSTID"] = hostids[r]
        procs.append(subprocess.Popen([sys.executable, __file__, role, str(r), str(port)],
                                      env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=90)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            outs.append("TIMEOUT " + (p.communicate()[0] or ""))
    print(f"== {name}: exit codes {[p.returncode for p in procs]}", flush=True)
    for o in outs:
        lines = o.strip().splitlines()
        print("\n".join([x for x in lines if x.startswith("RESULT")] or lines[-12:]), flush=True)


def main() -> None:
    if sys.argv[1:2] == ["--worker"]:
        worker(int(sys.argv[2]), int(sys.argv[3]))
        return
    if sys.argv[1:2] == ["--latency-worker"]:
        latency_worker(int(sys.argv[2]), int(sys.argv[3]))
        return
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    ids = ["probe-rank-0", "probe-rank-1"]
    if sys.argv[1:] == ["--latency"]:
        for i, (name, extra) in enumerate((
                ("default sockets", {}),
                ("8 threads x 2 sockets, 16 MB buffers (MESH_NCCL_ENV)",
                 {"NCCL_SOCKET_NTHREADS": "8", "NCCL_NSOCKS_PERTHREAD": "2",
                  "NCCL_BUFFSIZE": str(16 << 20)}),
                ("1 thread x 1 socket", {"NCCL_SOCKET_NTHREADS": "1",
                                         "NCCL_NSOCKS_PERTHREAD": "1"}),
                ("default sockets, LL protocol", {"NCCL_PROTO": "LL"}))):
            variant(name, ids, 29531 + i, extra, role="--latency-worker")
    elif sys.argv[1:] == ["--tune"]:
        variant("default sockets", ids, 29521)
        variant("4 threads x 4 sockets", ids, 29522,
                {"NCCL_SOCKET_NTHREADS": "4", "NCCL_NSOCKS_PERTHREAD": "4"})
        variant("8 threads x 2 sockets, 16 MB buffers", ids, 29523,
                {"NCCL_SOCKET_NTHREADS": "8", "NCCL_NSOCKS_PERTHREAD": "2",
                 "NCCL_BUFFSIZE": str(16 << 20)})
    else:
        variant("distinct NCCL_HOSTID", ids, 29511)
        variant("no NCCL_HOSTID", None, 29512)


if __name__ == "__main__":
    main()
