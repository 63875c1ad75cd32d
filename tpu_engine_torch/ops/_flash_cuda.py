"""Wrappers of the three CUDA flash-attention kernels, their plain PyTorch
versions, the launch counters, the loader, and the autograd function.

Kernels (``tpu_engine_torch/csrc/flash_attention.cu``), each replacing one
Pallas kernel of ``tpu_engine/ops/_flash_pallas.py``:

- K1 ``flash_fwd``      ← ``_fwd_kernel``      (o, lse) from (q, k, v);
- K2 ``flash_bwd_dq``   ← ``_bwd_dq_kernel``   dq from (q, k, v, dO, lse, Δ);
- K3 ``flash_bwd_dkv``  ← ``_bwd_dkv_kernel``  (dk, dv) from the same.

Every wrapper takes ``[BH, S, D]`` tensors. On a CPU tensor it runs the plain
PyTorch version of the same function; on a CUDA tensor it launches the
kernel or raises — there is no fallback from the card to the plain path.

The library is built at first use with ``nvcc`` for ``sm_90a`` from the
sources in the checkout, into ``tpu_engine_torch/_build/`` (keyed on a hash
of the sources and flags), and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "flash_attention.cu",)
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)
# Head dims the CUDA build instantiates (the D template parameter).
SUPPORTED_HEAD_DIMS = (64, 128)
BLOCK = 64  # the kernels' Q/K tile rows; S must be a multiple

# Launches of each kernel since the last reset_launches(). A wrapper adds
# one where it launches its kernel and nowhere else; the plain CPU path
# does not count.
launches = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


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
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtpe_flash_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if this source hash has no library yet. The
    compiler's output (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside the library as ``<lib>.log``. Raises on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    Path(str(out) + ".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.tpe_flash_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
        lib.tpe_flash_bwd_dq.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p]
        lib.tpe_flash_bwd_dkv.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, p]
        for fn in (lib.tpe_flash_fwd, lib.tpe_flash_bwd_dq, lib.tpe_flash_bwd_dkv):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def _check_inputs(name: str, tensors: dict, dtype_of: str = "q") -> tuple[int, int, int]:
    """Device, dtype, contiguity and shape checks shared by the wrappers."""
    ref = tensors[dtype_of]
    if ref.dim() != 3:
        raise ValueError(f"{name}: {dtype_of} must be [BH, S, D], got {tuple(ref.shape)}")
    BH, S, D = ref.shape
    if ref.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: dtype {ref.dtype} unsupported (bf16 or fp32)")
    if S % BLOCK or D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"{name}: S={S} must be a multiple of {BLOCK} and D={D} in {SUPPORTED_HEAD_DIMS}"
        )
    for key, t in tensors.items():
        if t.device != ref.device:
            raise ValueError(f"{name}: {key} on {t.device}, {dtype_of} on {ref.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
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


def flash_fwd_plain(q, k, v, window: int = 0):
    """(o, lse) of causal (windowed) attention on [BH, S, D]; lse natural log."""
    D = q.shape[-1]
    scale = 1.0 / (D ** 0.5)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = s.masked_fill(~_visible(q.shape[1], window, q.device), float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    return torch.matmul(p, v.float()).to(q.dtype), lse


def _p_ds_plain(q, k, v, do, lse, delta, window):
    D = q.shape[-1]
    scale = 1.0 / (D ** 0.5)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None])
    p = p.masked_fill(~_visible(q.shape[1], window, q.device), 0.0)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    return p, ds


def flash_bwd_dq_plain(q, k, v, do, lse, delta, window: int = 0):
    _, ds = _p_ds_plain(q, k, v, do, lse, delta, window)
    return torch.matmul(ds, k.float()).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, window: int = 0):
    p, ds = _p_ds_plain(q, k, v, do, lse, delta, window)
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_delta(o, do):
    """Δ = rowsum(dO ∘ O) in fp32: the backward prologue, plain torch on both
    devices (it is jnp code outside Pallas in the JAX package)."""
    return torch.sum(do.float() * o.float(), dim=-1)


def flash_bwd_plain(q, k, v, o, lse, do, window: int = 0):
    """(dq, dk, dv) from (q, k, v, o, lse, dO): the reference for K2 + K3."""
    delta = flash_delta(o, do)
    dq = flash_bwd_dq_plain(q, k, v, do, lse, delta, window)
    dk, dv = flash_bwd_dkv_plain(q, k, v, do, lse, delta, window)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def flash_fwd(q, k, v, window: int = 0):
    """K1: (o [BH, S, D], lse [BH, S] fp32) of causal attention."""
    if not _route(q, "flash_fwd"):
        return flash_fwd_plain(q, k, v, window)
    BH, S, D = _check_inputs("flash_fwd", {"q": q, "k": k, "v": v})
    if window < 0:
        raise ValueError(f"flash_fwd: window must be >= 0, got {window}")
    o = torch.empty_like(q)
    lse = torch.empty((BH, S), dtype=torch.float32, device=q.device)
    err = _load().tpe_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        BH, S, D, window, int(q.dtype == torch.bfloat16), _stream(),
    )
    _check("flash_fwd", err)
    launches["flash_fwd"] += 1
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, window: int = 0):
    """K2: dq [BH, S, D]."""
    if not _route(q, "flash_bwd_dq"):
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, window)
    BH, S, D = _check_inputs(
        "flash_bwd_dq", {"q": q, "k": k, "v": v, "do": do, "lse": lse, "delta": delta}
    )
    dq = torch.empty_like(q)
    err = _load().tpe_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), BH, S, D, window,
        int(q.dtype == torch.bfloat16), _stream(),
    )
    _check("flash_bwd_dq", err)
    launches["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, window: int = 0):
    """K3: (dk, dv) [BH, S, D]."""
    if not _route(q, "flash_bwd_dkv"):
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, window)
    BH, S, D = _check_inputs(
        "flash_bwd_dkv", {"q": q, "k": k, "v": v, "do": do, "lse": lse, "delta": delta}
    )
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _load().tpe_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), BH, S, D, window,
        int(q.dtype == torch.bfloat16), _stream(),
    )
    _check("flash_bwd_dkv", err)
    launches["flash_bwd_dkv"] += 1
    return dk, dv


def flash_bwd(q, k, v, o, lse, do, window: int = 0):
    """(dq, dk, dv): the Δ prologue, then K2 and K3 (separate, no atomics)."""
    delta = flash_delta(o, do)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, window)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, window)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Causal flash attention on [BH, S, D] (``_flash_bhsd`` in JAX): the
    forward saves (q, k, v, o, lse) and the backward runs K2 and K3."""

    @staticmethod
    def forward(ctx, q, k, v, window: int):
        o, lse = flash_fwd(q, k, v, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.window = window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do.contiguous(), ctx.window)
        return dq, dk, dv, None
