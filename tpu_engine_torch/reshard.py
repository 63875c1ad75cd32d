"""Topology-changing resume of the training state (port of the training
half of ``tpu_engine/reshard.py``).

A checkpoint is a layout-indexed view of the job's logical state: the
bytes are mesh-free, only their placement is not. This module lets a job
saved on one (data × fsdp × pipe × sequence × model) factorization resume
on another:

- the topology manifest (:func:`write_topology`, :func:`read_topology`:
  ``reshard_topology.json`` beside the steps);
- the plan and its cost (:func:`build_reshard_plan`, :func:`reshard_cost_s`);
- the executor (:func:`restore_resharded`): every leaf restored whole
  (``TrainCheckpointManager.restore(..., placed=False)``), cut to the
  target rank's block of it (:func:`_place_leaf`), gathered whole again on
  the target mesh, and held by a crc32 parity gate: a re-placement that
  changed one byte quarantines the step and raises
  :class:`ReshardParityError`. hpZ's store is not restored across
  layouts: it is quantized again from the restored shards.

A ``pipe`` change is refused (stage-stacked state cannot be re-chunked).

The serving half moves KV between serving pools on the handoff wire
(:mod:`tpu_engine_torch.disagg`): :func:`rebucket_for_pool`,
:func:`migrate_held_requests`, :func:`note_migrated_completions`,
:func:`migrate_prefix` and :func:`rehydrate_from_host`, with JAX's counters.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

log = logging.getLogger(__name__)

MESH_AXES = ("data", "fsdp", "pipe", "sequence", "model")
TOPOLOGY_FILE = "reshard_topology.json"

# Remap pricing (JAX's constants): bytes stream through the host at this
# aggregate rate during a resharded restore; the fixed term covers the plan
# and the parity hashing. They only scale a planner's tiebreak.
RESHARD_BANDWIDTH_BYTES_S = 2.0e10
RESHARD_FIXED_OVERHEAD_S = 0.5

_STATS_LOCK = threading.Lock()
_STATS: Dict[str, float] = {
    "plans_built_total": 0,
    "plans_applied_total": 0,
    "bytes_remapped_total": 0,
    "parity_checks_total": 0,
    "parity_failures_total": 0,
    "kv_rebuckets_total": 0,
    "kv_rebucket_bytes_total": 0,
    "migrations_total": 0,
    "held_requests_migrated_total": 0,
    "held_requests_completed_total": 0,
    "prefix_payloads_migrated_total": 0,
    # Gauges: the most recent plan/migration snapshot.
    "last_plan_bytes": 0,
    "last_plan_leaves": 0,
    "last_migration_mttr_s": 0,
}


def reshard_stats() -> Dict[str, float]:
    """Snapshot of the counters and the last plan's gauges."""
    with _STATS_LOCK:
        return dict(_STATS)


def _reset_stats_for_tests() -> None:
    with _STATS_LOCK:
        for k in _STATS:
            _STATS[k] = 0


def _bump(**deltas: float) -> None:
    with _STATS_LOCK:
        for k, v in deltas.items():
            _STATS[k] += v


def _gauge(**values: float) -> None:
    with _STATS_LOCK:
        _STATS.update(values)


# -- topology manifest --------------------------------------------------------


def normalize_topology(topology: Dict[str, Any]) -> Dict[str, int]:
    """Clamp a topology dict onto :data:`MESH_AXES` (missing axes = 1)."""
    return {ax: int(topology.get(ax, 1) or 1) for ax in MESH_AXES}


def mesh_topology(mesh: Any) -> Dict[str, int]:
    """The factorization of a ``MeshRuntime`` (its axis sizes) or a dict;
    None is one device."""
    if mesh is None:
        return normalize_topology({})
    return normalize_topology(mesh if isinstance(mesh, dict) else mesh.axis_sizes)


def same_topology(a: Dict[str, Any], b: Dict[str, Any]) -> bool:
    return normalize_topology(a) == normalize_topology(b)


def topology_compatible(saved: Dict[str, Any], target: Dict[str, Any]) -> Tuple[bool, str]:
    """Whether a checkpoint saved under ``saved`` resumes under ``target``:
    data/fsdp/sequence/model may differ freely; a ``pipe`` change is
    refused."""
    s, t = normalize_topology(saved), normalize_topology(target)
    if s["pipe"] != t["pipe"]:
        return False, (f"pipe extent {s['pipe']} (saved) != {t['pipe']} (target): "
                       "stage-stacked state cannot be re-chunked")
    return True, ""


def _topology_path(directory: str) -> str:
    import os

    from tpu_engine_torch.checkpoint import resolve_checkpoint_dir

    return os.path.join(resolve_checkpoint_dir(directory), TOPOLOGY_FILE)


def write_topology(directory: str, topology: Dict[str, Any],
                   extra: Optional[Dict[str, Any]] = None) -> None:
    """Record the factorization the checkpoints in ``directory`` were saved
    under; best effort (a manifest write never fails a save)."""
    payload = {"topology": normalize_topology(topology)}
    if extra:
        payload.update(extra)
    try:
        with open(_topology_path(directory), "w") as f:
            f.write(json.dumps(payload))
    except Exception:
        log.debug("reshard: topology manifest write failed", exc_info=True)


def read_topology(directory: str) -> Optional[Dict[str, int]]:
    """The saved factorization, or None (no manifest, unreadable)."""
    try:
        with open(_topology_path(directory)) as f:
            return normalize_topology(json.loads(f.read())["topology"])
    except Exception:
        return None


# -- plan and cost --------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LeafMove:
    """One leaf's source→target remap entry."""

    path: str
    shape: Tuple[int, ...]
    dtype: str
    nbytes: int
    dst_spec: str


@dataclasses.dataclass
class ReshardPlan:
    """How saved leaves map onto a target factorization: a same-topology
    restore remaps nothing; a changed one stages every leaf whole through
    the host once."""

    src_topology: Dict[str, int]
    dst_topology: Dict[str, int]
    moves: List[LeafMove]
    total_bytes: int
    bytes_to_remap: int
    compatible: bool
    reason: str = ""

    @property
    def leaves(self) -> int:
        return len(self.moves)

    @property
    def is_same_topology(self) -> bool:
        return self.src_topology == self.dst_topology

    def summary(self) -> Dict[str, Any]:
        return {
            "src_topology": dict(self.src_topology),
            "dst_topology": dict(self.dst_topology),
            "leaves": self.leaves,
            "total_bytes": self.total_bytes,
            "bytes_to_remap": self.bytes_to_remap,
            "same_topology": self.is_same_topology,
            "compatible": self.compatible,
            "reason": self.reason,
            "predicted_reshard_s": reshard_cost_s(self.bytes_to_remap),
        }


def _dtype_name(dtype: Any) -> str:
    return str(dtype).replace("torch.", "")


def _itemsize(dtype: Any) -> int:
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return int(np.dtype(dtype).itemsize)


def _leaves(tree: Any, path: str = "") -> list[tuple[str, Any]]:
    """(JAX ``keystr`` path, leaf) of a nested dict, keys sorted as JAX
    flattens a dict."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaves(tree[k], f"{path}[{k!r}]")
        return out
    return [(path, tree)]


def build_reshard_plan(abstract_target: Any, saved_topology: Dict[str, Any],
                       target_topology: Dict[str, Any]) -> ReshardPlan:
    """Plan the remap onto ``abstract_target``: a nested dict whose leaves
    have the whole leaves' ``shape`` and ``dtype`` (tensors or numpy
    arrays), scalars counted as JAX counts them (4 bytes)."""
    src = normalize_topology(saved_topology)
    dst = normalize_topology(target_topology)
    ok, why = topology_compatible(src, dst)
    moves: List[LeafMove] = []
    total = 0
    for path, leaf in _leaves(abstract_target):
        shape = tuple(int(d) for d in (getattr(leaf, "shape", ()) or ()))
        dtype = getattr(leaf, "dtype", "float32")
        nb = int(np.prod(shape, dtype=np.int64)) * _itemsize(dtype)
        total += nb
        moves.append(LeafMove(path=path, shape=shape, dtype=_dtype_name(dtype), nbytes=nb,
                              dst_spec=str(getattr(leaf, "spec", "") or "")))
    plan = ReshardPlan(src_topology=src, dst_topology=dst, moves=moves, total_bytes=total,
                       bytes_to_remap=0 if src == dst else total, compatible=ok, reason=why)
    _bump(plans_built_total=1)
    _gauge(last_plan_bytes=plan.bytes_to_remap, last_plan_leaves=plan.leaves)
    return plan


def reshard_cost_s(bytes_to_remap: int, bandwidth_bytes_s: float = RESHARD_BANDWIDTH_BYTES_S,
                   fixed_s: float = RESHARD_FIXED_OVERHEAD_S) -> float:
    """Predicted wall seconds a resharded restore adds over a direct one;
    0 when nothing remaps."""
    if bytes_to_remap <= 0:
        return 0.0
    return fixed_s + float(bytes_to_remap) / float(bandwidth_bytes_s)


def state_bytes_for_model(model_name: str) -> Optional[int]:
    """Parameters and optimizer (fp32 master + two Adam moments) of a
    catalog model, the planner's price of a remap; None outside it."""
    from tpu_engine_torch.models import transformer as tfm
    from tpu_engine_torch.models.config import MODEL_CONFIGS

    cfg = MODEL_CONFIGS.get(model_name)
    if cfg is None:
        return None
    return int(tfm.param_count(cfg)) * 12


# -- executor -------------------------------------------------------------------


class ReshardParityError(RuntimeError):
    """A re-placed leaf's bytes differ from the restored whole bytes."""


def _bytes(leaf: Any) -> np.ndarray:
    """A leaf's bytes as a contiguous uint8 array (no copy on the host)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous().cpu()
        return t.view(torch.uint8).numpy() if t.numel() else np.zeros(0, np.uint8)
    return np.ascontiguousarray(np.asarray(leaf)).view(np.uint8)


def leaf_checksums(state: Any) -> Dict[str, int]:
    """crc32 of every leaf's bytes (whole leaves), keyed by JAX's tree
    path."""
    return {path: zlib.crc32(_bytes(leaf)) for path, leaf in _leaves(state)}


def _splits_tree(program, state: dict) -> dict:
    from tpu_engine_torch.checkpoint import flatten_state, leaf_splits

    return leaf_splits(program, flatten_state(state))


def _whole_like(state_like: dict, program=None) -> dict:
    """The host form of a state of ``program``: each tensor leaf an empty
    CPU tensor of the whole leaf's shape (hpZ's store left out: its whole
    depends on the layout), scalars as they are."""
    from tpu_engine_torch.checkpoint import _whole_shape, flatten_state, unflatten_state

    flat = flatten_state({k: v for k, v in state_like.items() if k != "hpz"})
    splits = _splits_tree(program, {k: v for k, v in state_like.items() if k != "hpz"})
    shape = tuple(program.runtime.shape) if getattr(program, "zero", None) is not None else ()
    out = {}
    for k, v in flat.items():
        if isinstance(v, torch.Tensor):
            out[k] = torch.empty(_whole_shape(v, splits[k], shape), dtype=v.dtype)
        else:
            out[k] = v
    return unflatten_state(out)


def _place_leaf(whole: torch.Tensor, target: torch.Tensor, splits, program) -> None:
    """Copy this rank's block of ``whole`` into ``target`` (on its device)."""
    block = whole
    for m, d in splits:
        n = program.runtime.shape[m]
        size = whole.shape[d] // n
        block = block.narrow(d, program.runtime.coords[MESH_AXES[m]] * size, size)
    with torch.no_grad():
        target.copy_(block)


def _gather_whole(t: torch.Tensor, splits, program) -> torch.Tensor:
    from tpu_engine_torch.parallel.collectives import gather_dim

    for m, d in splits:
        t = gather_dim(t.detach().contiguous(), d, program.runtime.group(MESH_AXES[m]))
    return t


def restore_resharded(mgr: Any, state_like: dict, *, step: Optional[int] = None,
                      fall_back: bool = True, saved_topology: Optional[Dict[str, Any]] = None,
                      target_topology: Optional[Dict[str, Any]] = None,
                      program: Any = None) -> Tuple[Optional[int], Optional[dict], Dict[str, Any]]:
    """Restore a checkpoint onto ``program``'s factorization (``state_like``:
    a state of its shapes on its ranks, loaded in place): every leaf read
    whole through ``mgr.restore`` (its quarantine and fall-back included),
    cut to this rank's block, then gathered whole on the target mesh and
    checksummed against the read; hpZ's store is quantized again from the
    restored shards. Returns (step, state, report); (None, None, report)
    when nothing loads or the topologies are incompatible. Raises
    :class:`ReshardParityError` (after quarantining the step) when the
    re-placement changed a leaf."""
    from tpu_engine_torch.checkpoint import flatten_state, unflatten_state

    if saved_topology is None:
        saved_topology = read_topology(getattr(mgr, "directory", "")) or {}
    if target_topology is None:
        target_topology = mesh_topology(getattr(program, "runtime", None))
    host_like = _whole_like(state_like, program)
    plan = build_reshard_plan(host_like, saved_topology, target_topology)
    report: Dict[str, Any] = {"plan": plan.summary(), "step": None, "parity_ok": None}
    if not plan.compatible:
        report["error"] = f"incompatible topology: {plan.reason}"
        return None, None, report
    s, host_state = mgr.restore(host_like, step=step, fall_back=fall_back, placed=False)
    if host_state is None:
        report["error"] = "no restorable checkpoint"
        return None, None, report
    pre = leaf_checksums(host_state)
    body = {k: v for k, v in state_like.items() if k != "hpz"}
    flat_host, flat_like = flatten_state(host_state), flatten_state(body)
    splits = _splits_tree(program, body)
    placed, whole = {}, {}
    for k, v in flat_like.items():
        if isinstance(v, torch.Tensor):
            _place_leaf(flat_host[k], v, splits[k], program)
            placed[k] = v
            whole[k] = _gather_whole(v, splits[k], program) if splits[k] else v
        else:
            placed[k] = whole[k] = flat_host[k]
    post = leaf_checksums(unflatten_state(whole))
    _bump(parity_checks_total=1)
    if pre != post:
        bad = sorted(k for k in pre if pre.get(k) != post.get(k))
        _bump(parity_failures_total=1)
        try:
            mgr.quarantine(s)
        except Exception:
            pass
        raise ReshardParityError(
            f"reshard parity failure at step {s}: {len(bad)} leaf/leaves "
            f"changed bytes across re-placement (first: {bad[:3]})")
    state = unflatten_state(placed)
    if "hpz" in state_like:
        from tpu_engine_torch.comm_compress import refresh_hpz

        hpz = state_like["hpz"]
        keys = list(hpz["codes"])
        block = hpz["codes"][keys[0]].shape[-1] // hpz["scales"][keys[0]].shape[-1] if keys else 1
        state["hpz"] = refresh_hpz(state["params"], block, keys)
    _bump(plans_applied_total=1, bytes_remapped_total=plan.bytes_to_remap)
    report.update(step=int(s), parity_ok=True, leaves=plan.leaves,
                  bytes_remapped=plan.bytes_to_remap)
    return s, state, report


# -- serving executor ---------------------------------------------------------


def rebucket_for_pool(
    handoff: Any,
    *,
    chunk: int,
    max_lanes: int,
    kv_quant: bool,
) -> Any:
    """Re-bucket a wire payload for a destination pool's geometry and
    storage mode (counted wrapper over
    :func:`tpu_engine_torch.disagg.rebucket_handoff`)."""
    from tpu_engine_torch.disagg import rebucket_handoff

    out = rebucket_handoff(
        handoff, chunk=chunk, max_lanes=max_lanes, kv_quant=kv_quant
    )
    _bump(kv_rebuckets_total=1, kv_rebucket_bytes_total=out.wire_bytes())
    return out


def migrate_held_requests(
    src_engine: Any,
    dst_engine: Any,
    req_ids: Optional[List[int]] = None,
    *,
    max_new_tokens: int = 16,
    quantize: bool = False,
    pump_steps: int = 200,
    now_s: Optional[float] = None,
) -> Dict[str, Any]:
    """Move every held ``hold_kv`` request from ``src_engine`` onto
    ``dst_engine`` without dropping any: extract each held slot by
    ``request_handoff``, then admit the payload by ``submit_prefilled`` (the
    destination's ``handoff_to_cache`` re-buckets it to its own geometry and
    storage mode). Both engines must be caller-stepped. Returns
    ``{"mapping": {src_id: dst_id}, "migrated", "wire_bytes", "mttr_s"}``."""
    import time as _time

    if req_ids is None:
        req_ids = src_engine.held_requests()
    t0 = _time.time() if now_s is None else None
    mapping: Dict[int, int] = {}
    wire_bytes = 0
    for rid in req_ids:
        src_engine.request_handoff(rid, quantize=quantize)
        handoff = None
        for _ in range(pump_steps):
            src_engine.step()
            handoff = src_engine.take_handoff(rid)
            if handoff is not None:
                break
        if handoff is None:
            raise RuntimeError(
                f"migration stalled: request {rid} never produced a handoff"
            )
        wire_bytes += int(handoff.wire_bytes())
        mapping[rid] = dst_engine.submit_prefilled(
            handoff, max_new_tokens=max_new_tokens
        )
    mttr = (now_s if now_s is not None
            else max(_time.time() - t0, 0.0))
    _bump(migrations_total=1, held_requests_migrated_total=len(mapping))
    _gauge(last_migration_mttr_s=float(mttr))
    return {
        "mapping": mapping,
        "migrated": len(mapping),
        "wire_bytes": wire_bytes,
        "mttr_s": float(mttr),
    }


def note_migrated_completions(n: int) -> None:
    """Count migrated requests that finished decode on the destination
    (the caller drives the destination engine and reports back)."""
    _bump(held_requests_completed_total=int(n))


def migrate_prefix(src_engine: Any, dst_engine: Any,
                   prefix: List[int]) -> bool:
    """Ship a replica-resident prefix-cache entry across pools:
    ``export_prefix`` on the source, ``install_prefix`` on the destination
    (every wire × pool conversion rides ``handoff_to_cache``). False when
    the source does not hold the prefix or the destination refuses it."""
    payload = src_engine.export_prefix(list(prefix))
    if payload is None:
        return False
    ok = bool(dst_engine.install_prefix(list(prefix), payload))
    if ok:
        _bump(prefix_payloads_migrated_total=1)
    return ok


def rehydrate_from_host(tier: Any, prefix: List[int], dst_engine: Any,
                        now: Optional[float] = None) -> bool:
    """Move a prefix plane's host-tier payload into a destination pool's
    prefix cache: the cross-pool leg of a replica drain (the source replica
    spilled to the host; the replacement pool pulls from it)."""
    payload = tier.get(prefix, now=now)
    if payload is None:
        return False
    ok = bool(dst_engine.install_prefix(list(prefix), payload))
    if ok:
        _bump(prefix_payloads_migrated_total=1)
    return ok
