"""Wrappers of the three CUDA flash-attention kernels, their plain PyTorch
versions, the launch counters, the loader, and the autograd functions.

Kernels, each replacing one Pallas kernel of
``tpu_engine/ops/_flash_pallas.py``. In bf16, the Hopper designs (TMA +
wgmma + warp specialisation, helpers shared in ``csrc/sm90.cuh``): K1 at
every head dim is ``csrc/flash_fwd_sm90.cu``; K2 and K3 at 16, 32, 64 and
128 are ``csrc/flash_bwd_sm90.cu``; K2 at 256 is
``csrc/flash_bwd_dq_d256_sm90.cu`` and K3 at 256
``csrc/flash_bwd_dkv_d256_sm90.cu``. In fp32, K1, K2 and K3 at every head
dim are ``csrc/flash_f32_tc.cu``: ``mma.sync`` on the tensor cores in split
TF32 (each product three TF32 products, ``csrc/tf32_split.cuh``), so that
they keep fp32 accuracy; ``csrc/flash_common.cuh`` is its tile schedule.
``csrc/flash_attention.cu`` holds the C entries, which dispatch to them.

- K1 ``flash_fwd``      ← ``_fwd_kernel``      (o, lse) from (q, k, v);
- K2 ``flash_bwd_dq``   ← ``_bwd_dq_kernel``   dq from (q, k, v, dO, lse, Δ);
- K3 ``flash_bwd_dkv``  ← ``_bwd_dkv_kernel``  (dk, dv) from the same.

Each has a causal form (optionally windowed) and a non-causal one
(``causal=False``, ring attention's past hops), counted apart in
:data:`launches`. One autograd function sits on top,
:class:`FlashAttentionLSE` (``flash_fwd_lse``): ``(o, lse)``, both
differentiable. ``flash_mha`` takes its ``o``; ring attention merges both.

Every wrapper takes ``[BH, S, D]`` tensors. On a CPU tensor it runs the plain
PyTorch version of the same function; on a CUDA tensor it launches the
kernel or raises — there is no fallback from the card to the plain path.

The library is built at first use with ``nvcc`` for ``sm_90a`` from the
sources in the checkout (one compiler process per source, all started
together, then one link), into ``tpu_engine_torch/_build/`` (keyed on a hash
of the sources and flags), and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(_PKG / "csrc" / name for name in
                ("flash_attention.cu", "flash_fwd_sm90.cu", "flash_bwd_sm90.cu",
                 "flash_bwd_dq_d256_sm90.cu", "flash_bwd_dkv_d256_sm90.cu", "flash_f32_tc.cu"))
# Included by the sources: sm90.cuh by the Hopper ones, flash_common.cuh and
# tf32_split.cuh by flash_f32_tc.cu.
HEADERS = tuple(_PKG / "csrc" / name for name in
                ("sm90.cuh", "flash_common.cuh", "tf32_split.cuh"))
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)
# Head dims the CUDA build instantiates (the D template parameter), in bf16
# and fp32: every head of MODEL_CONFIGS.
SUPPORTED_HEAD_DIMS = (16, 32, 64, 128, 256)
BLOCK = 64  # the kernels' Q/K tile rows; S must be a multiple

# Launches of each kernel since the last reset_launches(), the causal form
# under the kernel's name and the non-causal one under ``<name>_full``. A
# wrapper adds one where it launches its kernel and nowhere else; the plain
# CPU path does not count.
launches = {f"{name}{suffix}": 0 for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
            for suffix in ("", "_full")}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the flash-attention kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*SOURCES, *HEADERS):
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtpe_flash_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if this source hash has no library yet: one
    ``nvcc -c`` per source, all running at once, then one link. The
    compilers' output (``-Xptxas -v``: registers, shared memory, spills) is
    kept beside the library as ``<lib>.log``. Raises on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        objs = [work / f"{src.stem}.o" for src in SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(SOURCES, objs)]
        log, ok = "", True
        for src, proc in zip(SOURCES, procs):
            text = proc.communicate()[0]
            log += f"== {src.name} (exit {proc.returncode})\n{text}"
            ok = ok and proc.returncode == 0
        if ok:
            link = subprocess.run([nvcc, "-shared", "-o", str(work / "lib.so"), *map(str, objs)],
                                  capture_output=True, text=True)
            log += f"== link (exit {link.returncode})\n{link.stdout}{link.stderr}"
            ok = link.returncode == 0
        Path(str(out) + ".log").write_text(log)
        if not ok:
            raise RuntimeError(f"nvcc failed:\n{log}")
        os.replace(work / "lib.so", out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def ptxas_table(log: str) -> dict[str, dict[str, int]]:
    """Registers and spilled bytes (stores + loads) of every kernel in a
    build log's ``-Xptxas -v`` output, keyed by its mangled name."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            name = m.group(1)
        elif name:
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            regs = re.search(r"Used (\d+) registers", line)
            if spill:
                out.setdefault(name, {})["spill_bytes"] = int(spill[1]) + int(spill[2])
            if regs:
                out.setdefault(name, {})["registers"] = int(regs[1])
    return out


def build_log() -> str:
    """The compilers' output of the build (built first if need be)."""
    return Path(str(build()) + ".log").read_text()


def sass_op_counts(symbol: str, ops: tuple[str, ...]) -> dict[str, dict[str, int]]:
    """How often each SASS opcode of ``ops`` occurs in every built kernel
    whose mangled name contains ``symbol`` (``cuobjdump -sass`` on the
    library, which is built first if need be)."""
    tool = Path(_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(build())], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for chunk in sass.split("Function : ")[1:]:
        name = chunk.split("\n", 1)[0].strip()
        if symbol in name:
            out[name] = {op: chunk.count(op) for op in ops}
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.tpe_flash_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, p]
        lib.tpe_flash_bwd_dq.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, p]
        lib.tpe_flash_bwd_dkv.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, p]
        for fn in (lib.tpe_flash_fwd, lib.tpe_flash_bwd_dq, lib.tpe_flash_bwd_dkv):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


# Negative codes of the Hopper kernels' entries (csrc/sm90.cuh).
_TENSOR_MAP_ERRORS = {
    -1: "libcuda has no cuTensorMapEncodeTiled",
    -2: "cuTensorMapEncodeTiled refused a tensor map",
}


def _check(name: str, err: int) -> None:
    if err in _TENSOR_MAP_ERRORS:
        raise RuntimeError(f"{name}: {_TENSOR_MAP_ERRORS[err]}")
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def check_head_dim(d: int, device) -> None:
    """Raise ``ValueError`` for a head dim the CUDA build does not
    instantiate, on a CUDA device (the plain CPU path takes any). It is not
    ``FlashUnsupported``: ``mha`` must not turn it into the plain path."""
    if torch.device(device).type == "cuda" and d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim={d} has no CUDA flash kernel (built: {SUPPORTED_HEAD_DIMS})")


def _check_inputs(name: str, tensors: dict, dtype_of: str = "q") -> tuple[int, int, int]:
    """Device, dtype, contiguity, alignment and shape checks shared by the
    wrappers."""
    ref = tensors[dtype_of]
    if ref.dim() != 3:
        raise ValueError(f"{name}: {dtype_of} must be [BH, S, D], got {tuple(ref.shape)}")
    BH, S, D = ref.shape
    if ref.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: dtype {ref.dtype} unsupported (bf16 or fp32)")
    if S % BLOCK:
        raise ValueError(f"{name}: S={S} must be a multiple of {BLOCK}")
    check_head_dim(D, ref.device)
    for key, t in tensors.items():
        if t.device != ref.device:
            raise ValueError(f"{name}: {key} on {t.device}, {dtype_of} on {ref.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be 16-byte aligned (the kernels copy 16 B)")
        row = key in ("lse", "delta")
        want_dtype = torch.float32 if row else ref.dtype
        want_shape = (BH, S) if row else (BH, S, D)
        if t.dtype != want_dtype or tuple(t.shape) != want_shape:
            raise ValueError(
                f"{name}: {key} is {t.dtype}{tuple(t.shape)}, want {want_dtype}{want_shape}"
            )
    return BH, S, D


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


_counters: dict[tuple[int, int], torch.Tensor] = {}
# Each Hopper kernel's two tile counters: their offset in a device's block.
# K2's pair serves its D 16-128 and D 256 kernels alike (K3's likewise):
# launches on one stream run in order, and each leaves the pair at zero.
_COUNTER_SLOTS = {"flash_fwd": 0, "flash_bwd_dq": 2, "flash_bwd_dkv": 4}


def _tile_counters(device, stream: int, kernel: str) -> int:
    """Address of the Hopper ``kernel``'s two tile counters for this device
    and stream: zero when made, and set back to zero by every launch that
    completes, so the launches that share them must run in order, on one
    stream. Each kernel has its own pair."""
    key = (device.index, stream)
    if key not in _counters:
        _counters[key] = torch.zeros(2 * len(_COUNTER_SLOTS), dtype=torch.int32, device=device)
    return _counters[key][_COUNTER_SLOTS[kernel]:].data_ptr()


def _route(t: torch.Tensor, name: str) -> bool:
    """True for the kernel (CUDA tensor), False for the plain path (CPU)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: tensors on {t.device} are not supported")


# ---------------------------------------------------------------------------
# Plain versions (fp32 math, same functions as the kernels)
# ---------------------------------------------------------------------------


def _visible(S: int, window: int, device) -> torch.Tensor:
    pos = torch.arange(S, device=device)
    vis = pos[:, None] >= pos[None, :]
    if window:
        vis &= pos[:, None] - pos[None, :] < window
    return vis


def flash_fwd_plain(q, k, v, window: int = 0, causal: bool = True):
    """(o, lse) of causal (windowed) or, with ``causal=False``, unmasked
    attention on [BH, S, D]; lse natural log."""
    D = q.shape[-1]
    scale = 1.0 / (D ** 0.5)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(~_visible(q.shape[1], window, q.device), float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    return torch.matmul(p, v.float()).to(q.dtype), lse


def _p_ds_plain(q, k, v, do, lse, delta, window, causal):
    D = q.shape[-1]
    scale = 1.0 / (D ** 0.5)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        p = p.masked_fill(~_visible(q.shape[1], window, q.device), 0.0)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    return p, ds


def flash_bwd_dq_plain(q, k, v, do, lse, delta, window: int = 0, causal: bool = True):
    _, ds = _p_ds_plain(q, k, v, do, lse, delta, window, causal)
    return torch.matmul(ds, k.float()).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, window: int = 0, causal: bool = True):
    p, ds = _p_ds_plain(q, k, v, do, lse, delta, window, causal)
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_delta(o, do, dlse=None):
    """Δ = rowsum(dO ∘ O) in fp32, minus the lse cotangent ``dlse`` when
    there is one (Δ′, ``_flash_bwd``): the backward prologue, plain torch on
    both devices (it is jnp code outside Pallas in the JAX package)."""
    delta = torch.sum(do.float() * o.float(), dim=-1)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta


def flash_bwd_plain(q, k, v, o, lse, do, window: int = 0, causal: bool = True):
    """(dq, dk, dv) from (q, k, v, o, lse, dO): the reference for K2 + K3."""
    delta = flash_delta(o, do)
    dq = flash_bwd_dq_plain(q, k, v, do, lse, delta, window, causal)
    dk, dv = flash_bwd_dkv_plain(q, k, v, do, lse, delta, window, causal)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _counter(name: str, causal: bool) -> str:
    return name if causal else name + "_full"


def _check_window(name: str, window: int, causal: bool) -> None:
    if window < 0:
        raise ValueError(f"{name}: window must be >= 0, got {window}")
    if window and not causal:
        raise ValueError(f"{name}: a window needs causal=True")


def flash_fwd(q, k, v, window: int = 0, causal: bool = True):
    """K1: (o [BH, S, D], lse [BH, S] fp32) of causal (windowed) or
    unmasked attention."""
    if not _route(q, "flash_fwd"):
        return flash_fwd_plain(q, k, v, window, causal)
    BH, S, D = _check_inputs("flash_fwd", {"q": q, "k": k, "v": v})
    _check_window("flash_fwd", window, causal)
    o = torch.empty_like(q)
    lse = torch.empty((BH, S), dtype=torch.float32, device=q.device)
    stream = _stream()
    err = _load().tpe_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        _tile_counters(q.device, stream, "flash_fwd"), BH, S, D, window, int(causal),
        int(q.dtype == torch.bfloat16), stream,
    )
    _check("flash_fwd", err)
    launches[_counter("flash_fwd", causal)] += 1
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, window: int = 0, causal: bool = True):
    """K2: dq [BH, S, D]."""
    if not _route(q, "flash_bwd_dq"):
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, window, causal)
    BH, S, D = _check_inputs(
        "flash_bwd_dq", {"q": q, "k": k, "v": v, "do": do, "lse": lse, "delta": delta}
    )
    _check_window("flash_bwd_dq", window, causal)
    dq = torch.empty_like(q)
    stream = _stream()
    err = _load().tpe_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), _tile_counters(q.device, stream, "flash_bwd_dq"),
        BH, S, D, window, int(causal), int(q.dtype == torch.bfloat16), stream,
    )
    _check("flash_bwd_dq", err)
    launches[_counter("flash_bwd_dq", causal)] += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, window: int = 0, causal: bool = True):
    """K3: (dk, dv) [BH, S, D]."""
    if not _route(q, "flash_bwd_dkv"):
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, window, causal)
    BH, S, D = _check_inputs(
        "flash_bwd_dkv", {"q": q, "k": k, "v": v, "do": do, "lse": lse, "delta": delta}
    )
    _check_window("flash_bwd_dkv", window, causal)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    stream = _stream()
    err = _load().tpe_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _tile_counters(q.device, stream, "flash_bwd_dkv"), BH, S, D, window, int(causal),
        int(q.dtype == torch.bfloat16), stream,
    )
    _check("flash_bwd_dkv", err)
    launches[_counter("flash_bwd_dkv", causal)] += 1
    return dk, dv


def flash_bwd(q, k, v, o, lse, do, window: int = 0, causal: bool = True, dlse=None):
    """(dq, dk, dv): the Δ (or Δ′) prologue, then K2 and K3 (separate, no
    atomics)."""
    delta = flash_delta(o, do, dlse)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, window, causal)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, window, causal)
    return dq, dk, dv


class FlashAttentionLSE(torch.autograd.Function):
    """Flash attention on [BH, S, D] returning ``(o, lse)``, differentiable in
    both (``flash_fwd_lse`` in JAX, the per-hop entry of ring attention,
    and ``_flash_bhsd`` when only ``o`` is used). The forward saves (q, k,
    v, o, lse). The backward takes cotangents (dO, dlse), either of which
    may be None (zeros), and runs K2 and K3 with Δ′ = rowsum(dO ∘ O) − dlse:
    with that substitution the score gradient P ∘ (dO·Vᵀ − Δ + dlse) is the
    standard one, so the kernels need no change."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        o, lse = flash_fwd(q, k, v, window, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        do = torch.zeros_like(o) if do is None else do.contiguous()
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, ctx.window, ctx.causal, dlse)
        return dq, dk, dv, None, None


def flash_fwd_lse(q, k, v, causal: bool = True, window: int = 0):
    """``(o, lse)`` of flash attention on [BH, S, D], with gradients through
    both: the port of ``_flash_pallas.flash_fwd_lse``. ``causal=False`` runs
    the unmasked kernels (a ring hop strictly in the past is fully visible);
    ``window`` (causal only) limits each query to its last ``window`` keys."""
    return FlashAttentionLSE.apply(q, k, v, causal, window)
