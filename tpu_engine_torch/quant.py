"""Weight-only int8 quantization for serving (port of ``tpu_engine/quant.py``).

Decode reads every weight once a step, so it is bound by the bytes of the
weights: storing the projection kernels as int8 halves them against bf16.
That is what lets Mixtral-8x7B (``moe-8x7b``, 46.7 B parameters) serve on
one 80 GB card: its int8 codes are 43.4 GiB where its bf16 tree is 93 GB.

Scheme, as in JAX: symmetric per-output-channel absmax. A kernel
``[..., in, out]`` becomes int8 codes of the same shape and an fp32 scale
``[..., 1, out]`` (the contracted dim reduced). The scale is constant along
the contraction, so a projection applies it to the product's output
(``transformer._proj``); int8 magnitudes up to 127 are exact in bf16, so
casting the codes to the compute dtype loses nothing.

What quantizes: the per-layer projection kernels (q/k/v/o, gate/up/down,
the stacked MoE expert kernels included, or gpt2's fc/proj) and the LM
head. What stays in the master dtype: embeddings (so a tied head, gpt2's
and gemma's, stays full precision), norm scales and biases, projection
biases, the MoE router and qwen's q/k norm scales.

Parameters are the port's flat dict (``"layers.q.kernel"`` → tensor); a
quantized site holds a :class:`QuantWeight` in place of its tensor.
Snapshots use JAX's format (``quant_snapshot.json`` and one ``.npy`` per
leaf), so a snapshot written by either package loads in the other.
Training never sees a :class:`QuantWeight`.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from tpu_engine_torch.models.config import ModelConfig


@dataclass
class QuantWeight:
    """An int8-quantized linear kernel: ``q`` int8 codes of the kernel's
    shape ``[..., in, out]``, ``scale`` fp32 ``[..., 1, out]`` (per output
    channel absmax / 127). Indexing a stacked ``[L, ...]`` weight indexes
    both in lockstep, as ``lax.scan`` slices JAX's."""

    q: torch.Tensor
    scale: torch.Tensor

    @property
    def is_cuda(self) -> bool:
        return self.q.is_cuda

    def __getitem__(self, i) -> "QuantWeight":
        return QuantWeight(self.q[i], self.scale[i])

    def unbind(self, dim: int = 0) -> tuple["QuantWeight", ...]:
        """The weights along a leading stacked dim (``[L, ...]`` layers,
        ``[E, ...]`` experts), as ``Tensor.unbind``."""
        return tuple(QuantWeight(q, s) for q, s in zip(self.q.unbind(dim), self.scale.unbind(dim)))

    def to(self, device) -> "QuantWeight":
        return QuantWeight(self.q.to(device), self.scale.to(device))

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    def narrow(self, dim: int, start: int, length: int) -> "QuantWeight":
        """A block of the codes along ``dim`` and the scale's matching block
        (JAX's ``quantize_pspecs``): the scale takes the codes' split,
        except along the contracted dim (its size 1 there), where a
        row-split site keeps the whole scale."""
        dim = dim % self.q.dim()
        scale = self.scale if dim == self.q.dim() - 2 else self.scale.narrow(dim, start, length)
        return QuantWeight(self.q.narrow(dim, start, length), scale)

    def clone(self) -> "QuantWeight":
        return QuantWeight(self.q.clone(), self.scale.clone())


def quantize_weight(w: torch.Tensor, axis: int = -2) -> QuantWeight:
    """Symmetric int8 quantization with the absmax taken over ``axis`` (the
    contracted dim of every kernel this module touches), JAX's codes
    exactly: fp32 absmax / 127 floored at 1e-12, round half to even, clip
    to ±127. The absmax is max(max, -min), which is exact and needs no
    ``|w|`` copy of a large kernel."""
    with torch.no_grad():
        w32 = w.detach().float()
        absmax = torch.maximum(w32.amax(dim=axis, keepdim=True),
                               -w32.amin(dim=axis, keepdim=True))
        scale = (absmax / 127.0).clamp_min(1e-12)
        q = torch.div(w32, scale).round_().clamp_(-127, 127).to(torch.int8)
    return QuantWeight(q=q, scale=scale)


def mul_round(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``a · b`` computed in fp32 (b is fp32) and rounded once to ``dtype``,
    as JAX's ``(a.astype(f32) * b).astype(dtype)``. Written straight into
    the ``dtype`` result, one pass with no fp32 copy, unless autograd needs
    the graph (``out=`` records none)."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return (a.float() * b).to(dtype)
    out = torch.empty(torch.broadcast_shapes(a.shape, b.shape), dtype=dtype, device=a.device)
    return torch.mul(a, b, out=out)


def dequantize_weight(qw: QuantWeight, dtype=torch.float32) -> torch.Tensor:
    """``q · scale`` in fp32, rounded once to ``dtype``."""
    return mul_round(qw.q, qw.scale, dtype)


# Per-layer projection names whose kernel quantizes: the llama family
# (q/k/v/o/gate/up/down, MoE's stacked expert kernels included), gpt2
# (q/k/v/o/fc/proj). The router stays in the master dtype.
_QUANT_LAYER_KEYS = ("q", "k", "v", "o", "gate", "up", "down", "fc", "proj")


def quant_sites(params: dict[str, Any]) -> list[str]:
    """The keys of ``params`` that :func:`quantize_params` quantizes."""
    sites = [f"layers.{name}.kernel" for name in _QUANT_LAYER_KEYS]
    return [k for k in params if k in sites or k == "lm_head.kernel"]


def quantize_params(params: dict[str, Any]) -> dict[str, Any]:
    """Parameters → the serving tree with every projection kernel and the
    LM head as a :class:`QuantWeight`; every other leaf is the same tensor.
    Quantizing a tree that is already quantized raises ``ValueError``
    (a second quantization would compound the error silently)."""
    out = dict(params)
    for k in quant_sites(params):
        if isinstance(params[k], QuantWeight):
            raise ValueError("params are already int8-quantized")
        out[k] = quantize_weight(params[k])
    return out


def _leaves(params: dict[str, Any]):
    for v in params.values():
        if isinstance(v, QuantWeight):
            yield v.q
            yield v.scale
        else:
            yield v


def quantized_param_bytes(params: dict[str, Any]) -> int:
    """Total bytes of a (possibly quantized) tree: codes 1 byte each,
    scales 4."""
    return sum(t.numel() * t.element_size() for t in _leaves(params))


# ---------------------------------------------------------------------------
# Snapshots: quantize once, serve many times
# ---------------------------------------------------------------------------

_MANIFEST = "quant_snapshot.json"
_CHUNK_BYTES = 128 * 2**20
_NP_DTYPES = {torch.float32: np.float32, torch.int8: np.int8, torch.int32: np.int32,
              torch.int64: np.int64, torch.float16: np.float16}
_TORCH_DTYPES = {"float32": torch.float32, "int8": torch.int8, "int32": torch.int32,
                 "int64": torch.int64, "float16": torch.float16, "bfloat16": torch.bfloat16}


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes as numpy: bf16, which numpy lacks, as its raw 16
    bits (JAX's loader views them back as bfloat16, as it does the void
    bytes its own writer leaves)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def save_quantized(qparams: dict[str, Any], out_dir: str,
                   model_config: Optional[ModelConfig] = None) -> str:
    """Write a quantized serving tree as one ``.npy`` per leaf plus the
    manifest, in JAX's format: a leaf's path is its key with ``/`` for
    ``.`` (``layers/q/kernel``), a quantized site's leaves are
    ``<path>.q`` and ``<path>.scale``, and a file is the path with ``__``
    for ``/``. Large stacked leaves are written in slices along their
    leading dim, so the host holds at most a slice of them.

    Raises ``ValueError`` for a tree with no :class:`QuantWeight` (use
    :func:`quantize_params` first) and for a directory that already holds a
    snapshot (an interrupted overwrite would leave an old manifest over
    leaves of mixed trees)."""
    os.makedirs(out_dir, exist_ok=True)
    if os.path.exists(os.path.join(out_dir, _MANIFEST)):
        raise ValueError(
            f"'{out_dir}' already holds a snapshot; export to a fresh "
            "directory (a crashed overwrite would silently mix steps)")
    if not any(isinstance(v, QuantWeight) for v in qparams.values()):
        raise ValueError("tree has no QuantWeight leaves — quantize_params first")
    manifest: dict[str, Any] = {"leaves": {}}
    if model_config is not None:
        manifest["model_config"] = dataclasses.asdict(model_config)

    def record(path: str, t: torch.Tensor, kind: str) -> None:
        fname = path.replace("/", "__") + ".npy"
        fpath = os.path.join(out_dir, fname)
        shape = tuple(t.shape)
        nbytes = t.numel() * t.element_size()
        if nbytes > _CHUNK_BYTES and shape and shape[0] > 1:
            rows = max(1, shape[0] * _CHUNK_BYTES // nbytes)
            first = _host(t[:1])
            out = np.lib.format.open_memmap(fpath, mode="w+", dtype=first.dtype, shape=shape)
            out[:1] = first
            for i in range(1, shape[0], rows):
                out[i:i + rows] = _host(t[i:i + rows])
            out.flush()
            del out
        else:
            np.save(fpath, _host(t))
        manifest["leaves"][path] = {"file": fname, "kind": kind,
                                    "dtype": str(t.dtype).removeprefix("torch."),
                                    "shape": list(shape)}

    for key, v in qparams.items():
        path = key.replace(".", "/")
        if isinstance(v, QuantWeight):
            record(path + ".q", v.q, "quant_q")
            record(path + ".scale", v.scale, "quant_scale")
        else:
            record(path, v, "array")
    tmp = os.path.join(out_dir, _MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, os.path.join(out_dir, _MANIFEST))
    return out_dir


def load_quantized_config(snapshot_dir: str) -> Optional[ModelConfig]:
    """The :class:`ModelConfig` recorded by :func:`save_quantized`, or None
    for a snapshot written without one."""
    with open(os.path.join(snapshot_dir, _MANIFEST)) as f:
        raw = json.load(f).get("model_config")
    if raw is None:
        return None
    # JSON turns the tuple fields into lists; the configs compare as tuples.
    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in raw.items()})


def load_quantized(snapshot_dir: str, device="cuda", mesh=None,
                   cfg: Optional[ModelConfig] = None) -> dict[str, Any]:
    """The flat serving tree of a snapshot written by either package's
    ``save_quantized``, on ``device``. Each leaf is memory-mapped and
    copied to the device before the next is read, so the host never holds
    the tree.

    ``mesh`` (a :class:`~tpu_engine_torch.mesh_runtime.MeshRuntime`; JAX's
    ``shardings``): the tree of this rank's ``model`` blocks
    (:func:`~tpu_engine_torch.sharding.model_split`; at a quantized site
    the codes take the kernel's split and the scale the same one, whole
    along the contracted dim). Each rank reads only its block of each
    memory-mapped leaf, leaf by leaf. ``cfg`` defaults to the snapshot's
    recorded config."""
    with open(os.path.join(snapshot_dir, _MANIFEST)) as f:
        leaves = json.load(f)["leaves"]
    dims: dict[str, Optional[int]] = {}
    n = index = 1
    if mesh is not None and mesh.axis_sizes["model"] > 1:
        from tpu_engine_torch import sharding

        cfg = cfg or load_quantized_config(snapshot_dir)
        if cfg is None:
            raise ValueError("load_quantized(mesh=...) needs cfg: the snapshot records none")
        n, index = mesh.axis_sizes["model"], mesh.coords["model"]
        dims = sharding.model_split(cfg, sharding.logical_axes(cfg), n)

    def put(path: str, dim: Optional[int] = None) -> torch.Tensor:
        meta = leaves[path]
        host = np.load(os.path.join(snapshot_dir, meta["file"]), mmap_mode="r")
        if dim is not None:  # this rank's block of the mapped file, read alone
            per = host.shape[dim] // n
            host = host[(slice(None),) * dim + (slice(index * per, (index + 1) * per),)]
        want = _TORCH_DTYPES[meta["dtype"]]
        if want == torch.bfloat16:
            # Raw 16-bit words (JAX writes them as void, this package as int16).
            bits = torch.from_numpy(np.ascontiguousarray(host).view(np.int16))
            return bits.view(torch.bfloat16).reshape(host.shape).to(device)
        return torch.from_numpy(np.array(host, dtype=_NP_DTYPES[want])).to(device)

    tree: dict[str, Any] = {}
    for path, meta in leaves.items():
        key = path.replace("/", ".")
        if meta["kind"] == "array":
            tree[key] = put(path, dims.get(key))
        elif meta["kind"] == "quant_q":
            site = path.removesuffix(".q")
            d = dims.get(site.replace("/", "."))
            contracted = d is not None and d == len(meta["shape"]) - 2
            tree[site.replace("/", ".")] = QuantWeight(
                q=put(path, d), scale=put(site + ".scale", None if contracted else d))
    return tree


__all__ = [
    "QuantWeight", "quantize_weight", "mul_round", "dequantize_weight", "quant_sites",
    "quantize_params", "quantized_param_bytes", "save_quantized", "load_quantized_config",
    "load_quantized",
]
