"""Disaggregated prefill/decode serving: two planner-placed pools and the
live KV handoff between them (port of ``tpu_engine/disagg.py``).

A symmetric :class:`~tpu_engine_torch.serving_fleet.ServingFleet` replica
runs both phases of a request: the compute-bound prompt prefill and the
memory-bound token decode. Under long-prefill traffic a 3k-token prompt
holds the engine that should be emitting the others' decode tokens. This
module splits the fleet:

- **Prefill pool**: replicas sized by ``plan_serving_pool(role="prefill")``.
  A request prefills there with ``hold_kv=True`` and ``max_new_tokens=1``:
  its first token comes off the prefill logits (that is the TTFT), and the
  finished slot stays pinned with the prompt's K/V until extraction.
- **Wire format**, :class:`KVHandoff`: host numpy K/V ``[L, T, KV, HD]``
  and metadata, JAX's byte for byte: fp32 for a bf16 pool (numpy has no
  bf16), or int8 codes with ``[L, T, KV, 1]`` fp32 scales (absmax/127 over
  head_dim, ``quant.quantize_weight(axis=-1)``). A payload made by either
  package is taken by the other's batcher. The port's pool is
  ``[L, B, KV, S, HD]`` and its ingestion cache ``[L, 1, KV, M, HD]``, so
  extraction and insertion swap the lane and head axes.
- **Decode pool**: replicas sized by ``plan_serving_pool(role="decode")``.
  The payload enters through ``ContinuousBatcher.submit_prefilled``, which
  rebuilds a single-row ingestion cache (:func:`handoff_to_cache`, in the
  destination pool's storage mode) and copies it into a reserved slot by
  the ordinary ``_insert_prefill``.
- **Control plane**, :class:`DisaggServingFleet`: two ``ServingFleet``
  pools on one scheduler and the phase machine ``queued → prefilling →
  extracting → handoff → decoding → done``. A replica lost at any phase
  re-prefills the request from scratch; each pool scales on its own signal
  (prefill: queue depth and TTFT; decode: occupancy and end-to-end p99);
  every handoff is a traced span.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
import types
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from tpu_engine_torch import tracing
from tpu_engine_torch.scheduler import FleetScheduler, JobPriority
from tpu_engine_torch.serving_fleet import (
    ReplicaAutoscaler,
    ServingFleet,
    ServingReplicaSpec,
    build_replica_engine,
)

log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Wire format
# ---------------------------------------------------------------------------


@dataclass
class KVHandoff:
    """One request's KV state on the handoff wire (host-side, engine-free).

    Invariant (the slot pool's steady state): the resident K/V covers every
    history token except the last emitted one, which the decode engine's
    next step ingests as it computes the following logits.

    ``k``/``v`` are ``[L, T, KV, HD]`` with ``T == length``: the wire fp
    dtype when ``quantized`` is False, int8 codes with per-(lane, kv-head)
    fp32 ``k_scale``/``v_scale`` ``[L, T, KV, 1]`` when True."""

    prompt: list[int]
    emitted: list[int]            # tokens the prefill engine generated (>= 1)
    length: int                   # resident KV tokens == len(prompt+emitted)-1
    n_layers: int
    n_kv_heads: int
    head_dim: int
    dtype: str                    # wire fp dtype name (codes dtype when quantized)
    quantized: bool
    k: np.ndarray
    v: np.ndarray
    k_scale: Optional[np.ndarray] = None
    v_scale: Optional[np.ndarray] = None
    model_name: Optional[str] = None
    extracted_at: float = field(default_factory=time.time)

    @property
    def last_token(self) -> int:
        """The decode engine's first input token."""
        return int(self.emitted[-1]) if self.emitted else int(self.prompt[-1])

    def wire_bytes(self) -> int:
        n = int(self.k.nbytes) + int(self.v.nbytes)
        if self.k_scale is not None:
            n += int(self.k_scale.nbytes) + int(self.v_scale.nbytes)
        return n


def _to_wire(t: torch.Tensor) -> np.ndarray:
    """A pool or cache slice ``[L, KV, T, X]`` as the wire's host array
    ``[L, T, KV, X]`` (bf16 widened to fp32, which is exact)."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.transpose(1, 2).contiguous().cpu().numpy()


def extract_slot_kv(
    cache: Any,
    slot: int,
    length: int,
    *,
    cfg: Any,
    prompt: list[int],
    emitted: list[int],
    quantize: bool = False,
    model_name: Optional[str] = None,
) -> KVHandoff:
    """Slice one slot's resident lanes out of a pool (a ``SlotCache``, or a
    ``KVCache`` row) into a wire payload. Engine-thread only. Non-ring pools
    only: lane m holds position m, so lanes ``[:length]`` are the resident
    history.

    An int8 pool always ships its own codes and scales (dequantizing would
    add error and bytes); an fp pool quantizes on the wire only when asked."""
    if getattr(cache, "ring", False):
        raise ValueError("extract_slot_kv does not support ring pools")
    k = cache.k[:, slot, :, :length]          # [L, KV, T, HD] on the device
    v = cache.v[:, slot, :, :length]
    meta = dict(prompt=list(prompt), emitted=list(emitted), length=int(length),
                n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                model_name=model_name)
    if cache.quantized:
        return KVHandoff(
            **meta, dtype="int8", quantized=True, k=_to_wire(k), v=_to_wire(v),
            k_scale=_to_wire(cache.k_scale[:, slot, :, :length]),
            v_scale=_to_wire(cache.v_scale[:, slot, :, :length]),
        )
    if quantize:
        from tpu_engine_torch.quant import quantize_weight

        # absmax over head_dim: one scale per (layer, lane, kv-head), the
        # shape a kv_quant pool stores.
        qk = quantize_weight(k.transpose(1, 2), axis=-1)
        qv = quantize_weight(v.transpose(1, 2), axis=-1)

        def host(t):
            return t.contiguous().cpu().numpy()

        return KVHandoff(**meta, dtype="int8", quantized=True, k=host(qk.q), v=host(qv.q),
                         k_scale=host(qk.scale), v_scale=host(qv.scale))
    k_wire, v_wire = _to_wire(k), _to_wire(v)
    return KVHandoff(**meta, dtype=k_wire.dtype.name, quantized=False, k=k_wire, v=v_wire)


def _np_quantize(a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host-side twin of ``quant.quantize_weight(axis=-1)``: int8 codes and
    per-(lane, kv-head) fp32 scales (absmax/127 over head_dim)."""
    a32 = np.asarray(a, dtype=np.float32)
    scale = np.maximum(np.max(np.abs(a32), axis=-1, keepdims=True) / 127.0,
                       1e-12).astype(np.float32)
    q = np.clip(np.round(a32 / scale), -127, 127).astype(np.int8)
    return q, scale


def handoff_to_cache(
    handoff: KVHandoff,
    *,
    dtype: Any,
    kv_quant: bool,
    chunk: int,
    max_lanes: int,
    device="cuda",
) -> Any:
    """Materialise a wire payload as the single-row ingestion
    :class:`~tpu_engine_torch.generate.KVCache` (``[L, 1, KV, M, HD]`` on
    ``device``) that ``_insert_prefill`` consumes, in the destination pool's
    storage mode (all four fp/int8 wire × fp/int8 pool cases). The lane
    count buckets to ``chunk`` multiples, as the prefill path's does."""
    from tpu_engine_torch.generate import KVCache

    T = int(handoff.length)
    L, KV, HD = handoff.n_layers, handoff.n_kv_heads, handoff.head_dim
    chunk = max(int(chunk), 1)
    M = min(max(-(-T // chunk) * chunk, chunk), int(max_lanes))
    if M < T:
        raise ValueError(
            f"handoff length {T} exceeds destination pool lanes {max_lanes}"
        )

    if handoff.quantized:
        codes_k, codes_v = handoff.k, handoff.v
        scale_k, scale_v = handoff.k_scale, handoff.v_scale
        if kv_quant:
            fp_k = fp_v = None
        else:
            fp_k = codes_k.astype(np.float32) * scale_k
            fp_v = codes_v.astype(np.float32) * scale_v
    else:
        fp_k, fp_v = handoff.k, handoff.v
        if kv_quant:
            codes_k, scale_k = _np_quantize(fp_k)
            codes_v, scale_v = _np_quantize(fp_v)

    def lanes(arr: np.ndarray, trailing: int, np_dtype: Any, dt: torch.dtype) -> torch.Tensor:
        # The wire's [L, T, KV, X] into lanes [:T] of [L, 1, KV, M, X].
        out = torch.zeros((L, 1, KV, M, trailing), dtype=dt, device=device)
        rows = torch.from_numpy(np.array(arr, dtype=np_dtype)).to(device)
        out[:, 0, :, :T] = rows.transpose(1, 2).to(dt)
        return out

    if kv_quant:
        k = lanes(codes_k, HD, np.int8, torch.int8)
        v = lanes(codes_v, HD, np.int8, torch.int8)
        k_scale = lanes(scale_k, 1, np.float32, torch.float32)
        v_scale = lanes(scale_v, 1, np.float32, torch.float32)
    else:
        k = lanes(fp_k, HD, np.float32, dtype)
        v = lanes(fp_v, HD, np.float32, dtype)
        k_scale = v_scale = None

    return KVCache(
        k=k, v=v,
        pos=torch.full((M,), -1, dtype=torch.int64, device=device),  # unused on the insert
        length=T, ring=False, k_scale=k_scale, v_scale=v_scale,
    )


def rebucket_handoff(
    handoff: KVHandoff,
    *,
    chunk: int,
    max_lanes: int,
    kv_quant: bool,
) -> KVHandoff:
    """Re-bucket a wire payload to another destination pool's geometry
    (chunk multiple, lane budget) and storage mode, returning a new payload
    for that pool: the round trip runs the destination's own ingestion
    layout (:func:`handoff_to_cache`) and extraction (:func:`extract_slot_kv`)
    on the host. A payload longer than the lane budget raises the
    ``ValueError`` ingestion would."""
    cache = handoff_to_cache(
        handoff, dtype=torch.float32, kv_quant=kv_quant,
        chunk=chunk, max_lanes=max_lanes, device="cpu",
    )
    cfg = types.SimpleNamespace(
        n_layers=handoff.n_layers,
        n_kv_heads=handoff.n_kv_heads,
        head_dim=handoff.head_dim,
    )
    return extract_slot_kv(
        cache, 0, handoff.length, cfg=cfg,
        prompt=handoff.prompt, emitted=handoff.emitted,
        quantize=False,  # a kv_quant staging cache already ships codes
        model_name=handoff.model_name,
    )


# ---------------------------------------------------------------------------
# Disaggregated fleet
# ---------------------------------------------------------------------------

_PENDING_PHASES = ("queued", "prefilling", "extracting", "handoff")


class DisaggServingFleet:
    """Prefill pool + decode pool + the handoff plane between them.

    Each pool is a full :class:`ServingFleet` (scheduler-tenant replicas,
    per-pool HBM admission through ``estimate_serving_hbm(pool_role=...)``,
    its own router and autoscaler); this object owns the request plane:
    route to a prefill replica (``hold_kv``), collect the first token and
    the extracted :class:`KVHandoff`, reserve a decode slot, deliver it by
    ``submit_prefilled`` and stitch the token stream. A replica loss
    re-prefills the request from scratch, at most ``max_redispatch`` times.
    """

    def __init__(
        self,
        scheduler: FleetScheduler,
        prefill_spec: ServingReplicaSpec,
        decode_spec: ServingReplicaSpec,
        prefill_autoscaler: Optional[ReplicaAutoscaler] = None,
        decode_autoscaler: Optional[ReplicaAutoscaler] = None,
        wire_quant: bool = False,
        priority: JobPriority = JobPriority.NORMAL,
        submitter: str = "disagg-serving",
        engine_factory: Callable[[ServingReplicaSpec], Any] = build_replica_engine,
        latency_window: int = 512,
        max_redispatch: int = 8,
        prefill_fault_injector: Optional[Any] = None,
        decode_fault_injector: Optional[Any] = None,
    ):
        inflight = prefill_spec.inflight_handoffs or prefill_spec.max_slots
        prefill_spec = prefill_spec.model_copy(update={
            "pool_role": "prefill",
            # The physical pool is the in-flight handoff window: estimate
            # and allocation agree (see estimate_serving_hbm).
            "max_slots": inflight,
            "inflight_handoffs": inflight,
        })
        decode_spec = decode_spec.model_copy(update={"pool_role": "decode"})
        self.prefill = ServingFleet(
            scheduler, prefill_spec, autoscaler=prefill_autoscaler,
            priority=priority, submitter=f"{submitter}-prefill",
            engine_factory=engine_factory, latency_window=latency_window,
            fault_injector=prefill_fault_injector,
        )
        self.decode = ServingFleet(
            scheduler, decode_spec, autoscaler=decode_autoscaler,
            priority=priority, submitter=f"{submitter}-decode",
            engine_factory=engine_factory, latency_window=latency_window,
            fault_injector=decode_fault_injector,
        )
        self.wire_quant = bool(wire_quant)
        self.max_redispatch = int(max_redispatch)

        self._lock = threading.RLock()
        self._requests: dict[str, dict[str, Any]] = {}
        self._req_seq = 0
        self._latencies: collections.deque[float] = collections.deque(
            maxlen=latency_window)
        self._ttfts: collections.deque[float] = collections.deque(
            maxlen=latency_window)
        self.requests_total = 0
        self.completed_total = 0
        self.failed_total = 0
        self.tokens_total = 0
        self.handoffs_total = 0
        self.handoff_bytes_total = 0
        self.reprefills_total = 0

        rec = tracing.get_recorder()
        self.trace_id = rec.new_trace_id()
        self._fleet_span = rec.start_span(
            f"disagg_fleet:{decode_spec.model_name}",
            kind="disagg_fleet",
            trace_id=self.trace_id,
            attrs={
                "model": decode_spec.model_name,
                "wire_quant": self.wire_quant,
                "prefill_slots": prefill_spec.max_slots,
                "decode_slots": decode_spec.max_slots,
            },
        )

    # -- pool lifecycle ------------------------------------------------------

    def start(self) -> None:
        self.prefill.start()
        self.decode.start()

    def stop(self) -> None:
        self.prefill.stop()
        self.decode.stop()
        if self._fleet_span.t1 is None:
            self._fleet_span.end(stopped=True)

    # -- request plane -------------------------------------------------------

    def submit_request(
        self,
        prompt: list[int],
        max_new_tokens: int = 64,
        temperature: float = 0.0,
    ) -> str:
        with self._lock:
            self._req_seq += 1
            fid = f"dreq_{self._req_seq}"
            self.requests_total += 1
            rec = tracing.get_recorder()
            span = rec.start_span(
                f"disagg_request:{fid}",
                kind="serving_request",
                attrs={
                    "fleet_trace_id": self.trace_id,
                    "prompt_tokens": len(prompt),
                    "max_new_tokens": int(max_new_tokens),
                },
            )
            self._requests[fid] = {
                "prompt": list(prompt),
                "max_new_tokens": int(max_new_tokens),
                "temperature": float(temperature),
                "phase": "queued",
                "prefill_sid": None, "prefill_rid": None,
                "decode_sid": None, "decode_rid": None,
                "prefill_tokens": [], "handoff": None,
                "submitted_at": time.time(),
                "first_token_at": None,
                "redispatches": 0,
                "tokens": [], "error": None,
                "trace_id": span.trace_id, "_span": span,
                "_handoff_span": None,
            }
            self._pump_locked()
            return fid

    def _requeue_locked(self, fid: str, r: dict[str, Any], reason: str) -> None:
        """Re-prefill from scratch (replica loss at any phase): the wire
        payload is re-derivable from the prompt, so retry is the recovery,
        as the symmetric fleet's re-dispatch is."""
        r["redispatches"] += 1
        self.reprefills_total += 1
        hs = r.get("_handoff_span")
        if hs is not None and hs.t1 is None:
            hs.end(status="aborted", reason=reason)
        r["_handoff_span"] = None
        tracing.get_recorder().event(
            "re_prefill", kind="serving", trace_id=r.get("trace_id"),
            parent=r.get("_span"),
            attrs={"fid": fid, "reason": reason, "attempt": r["redispatches"]},
        )
        if r["redispatches"] > self.max_redispatch:
            r["phase"] = "failed"
            r["error"] = f"gave up after {self.max_redispatch} re-dispatches: {reason}"
            self.failed_total += 1
            span = r.get("_span")
            if span is not None and span.t1 is None:
                span.end(status="failed", error=r["error"])
            return
        r.update(phase="queued", prefill_sid=None, prefill_rid=None,
                 decode_sid=None, decode_rid=None, handoff=None,
                 prefill_tokens=[])

    def _finish_locked(self, fid: str, r: dict[str, Any],
                       tokens: list[int]) -> None:
        r["tokens"] = tokens
        r["phase"] = "done"
        self.completed_total += 1
        self.tokens_total += len(tokens)
        latency_ms = (time.time() - r["submitted_at"]) * 1000.0
        self._latencies.append(latency_ms)
        span = r.get("_span")
        if span is not None and span.t1 is None:
            span.end(status="done", tokens=len(tokens),
                     latency_ms=round(latency_ms, 3),
                     redispatches=r["redispatches"])

    def _record_ttft_locked(self, r: dict[str, Any],
                            first_at: Optional[float]) -> None:
        if first_at is None or r["first_token_at"] is not None:
            return
        r["first_token_at"] = float(first_at)
        ttft = (float(first_at) - r["submitted_at"]) * 1000.0
        if ttft >= 0:
            self._ttfts.append(ttft)
        tracing.get_recorder().event(
            "first_token", kind="serving", trace_id=r.get("trace_id"),
            parent=r.get("_span"), attrs={"ttft_ms": round(max(ttft, 0), 2)},
        )

    def _pump_locked(self) -> None:
        """Advance every request's phase machine one notch. Called under
        the lock from submit/result/tick; every engine call here is
        non-blocking (the replica threads do the device work)."""
        rec = tracing.get_recorder()
        prefill_engines = self.prefill.running_replicas()
        decode_engines = self.decode.running_replicas()
        stats_of = ServingFleet._engine_router_stats
        self.prefill.router.update(
            {sid: stats_of(e) for sid, e in prefill_engines.items()})
        self.decode.router.update(
            {sid: stats_of(e) for sid, e in decode_engines.items()})

        for fid, r in self._requests.items():
            if r["phase"] == "queued":
                sid = self.prefill.router.route(r["prompt"])
                if sid is None or sid not in prefill_engines:
                    continue
                try:
                    rid = prefill_engines[sid].submit(
                        r["prompt"], max_new_tokens=1,
                        temperature=r["temperature"], hold_kv=True,
                    )
                except Exception:  # engine died under us — retry next pump
                    continue
                r["prefill_sid"], r["prefill_rid"] = sid, rid
                r["phase"] = "prefilling"
                rec.event(
                    "route_prefill", kind="serving",
                    trace_id=r.get("trace_id"), parent=r.get("_span"),
                    attrs={"fid": fid, "replica": sid, "engine_rid": rid},
                )

            elif r["phase"] == "prefilling":
                eng = prefill_engines.get(r["prefill_sid"])
                if eng is None:
                    self._requeue_locked(fid, r, "prefill replica lost")
                    continue
                try:
                    out = eng.result(r["prefill_rid"])
                except KeyError:
                    self._requeue_locked(fid, r, "prefill engine forgot request")
                    continue
                if out.get("status") == "failed":
                    self._requeue_locked(fid, r, "prefill engine drained")
                    continue
                if out.get("status") != "done":
                    continue
                r["prefill_tokens"] = list(out.get("tokens", []))
                self._record_ttft_locked(r, out.get("first_token_at"))
                try:
                    eng.request_handoff(r["prefill_rid"],
                                        quantize=self.wire_quant)
                except Exception:
                    self._requeue_locked(fid, r, "handoff request failed")
                    continue
                r["phase"] = "extracting"
                r["_handoff_span"] = rec.start_span(
                    f"kv_handoff:{fid}", kind="kv_handoff",
                    trace_id=r.get("trace_id"), parent=r.get("_span"),
                    attrs={"src_replica": r["prefill_sid"],
                           "quantized": self.wire_quant},
                )

            elif r["phase"] == "extracting":
                eng = prefill_engines.get(r["prefill_sid"])
                if eng is None:
                    self._requeue_locked(
                        fid, r, "prefill replica lost during extraction")
                    continue
                try:
                    h = eng.take_handoff(r["prefill_rid"])
                except RuntimeError:
                    self._requeue_locked(fid, r, "handoff extraction failed")
                    continue
                except KeyError:
                    self._requeue_locked(fid, r, "prefill engine forgot request")
                    continue
                if h is None:
                    continue  # engine thread has not serviced the order yet
                r["handoff"] = h
                self.handoffs_total += 1
                self.handoff_bytes_total += h.wire_bytes()
                r["phase"] = "handoff"

            if r["phase"] == "handoff":  # falls through from "extracting"
                h = r["handoff"]
                remaining = max(
                    r["max_new_tokens"] - len(r["prefill_tokens"]), 0)
                if remaining == 0:
                    # The prefill pool already emitted everything asked for.
                    hs = r.get("_handoff_span")
                    if hs is not None and hs.t1 is None:
                        hs.end(status="skipped", reason="no decode tokens needed")
                    r["handoff"] = None
                    self._finish_locked(fid, r, list(r["prefill_tokens"]))
                    continue
                sid = self.decode.router.route(r["prompt"])
                if sid is None or sid not in decode_engines:
                    continue  # no decode slot yet — payload waits host-side
                try:
                    rid = decode_engines[sid].submit_prefilled(
                        h, max_new_tokens=remaining,
                        temperature=r["temperature"],
                    )
                except Exception:
                    self._requeue_locked(fid, r, "decode submit failed")
                    continue
                r["decode_sid"], r["decode_rid"] = sid, rid
                r["handoff"] = None  # delivered — the decode engine owns it
                r["phase"] = "decoding"
                hs = r.get("_handoff_span")
                if hs is not None and hs.t1 is None:
                    hs.end(
                        status="delivered", dst_replica=sid,
                        wire_bytes=h.wire_bytes(), kv_tokens=h.length,
                        quantized=h.quantized,
                    )
                rec.event(
                    "route_decode", kind="serving",
                    trace_id=r.get("trace_id"), parent=r.get("_span"),
                    attrs={"fid": fid, "replica": sid, "engine_rid": rid,
                           "wire_bytes": h.wire_bytes()},
                )

            elif r["phase"] == "decoding":
                eng = decode_engines.get(r["decode_sid"])
                if eng is None:
                    self._requeue_locked(fid, r, "decode replica lost")
                    continue
                try:
                    out = eng.result(r["decode_rid"])
                except KeyError:
                    self._requeue_locked(fid, r, "decode engine forgot request")
                    continue
                if out.get("status") == "failed":
                    self._requeue_locked(fid, r, "decode engine drained")
                    continue
                if out.get("status") == "done":
                    self._finish_locked(
                        fid, r,
                        list(r["prefill_tokens"]) + list(out.get("tokens", [])),
                    )

    def result(self, fid: str) -> dict[str, Any]:
        with self._lock:
            r = self._requests.get(fid)
            if r is None:
                raise KeyError(fid)
            self._pump_locked()
            out: dict[str, Any] = {
                "id": fid,
                "phase": r["phase"],
                "prefill_replica": r["prefill_sid"],
                "decode_replica": r["decode_sid"],
                "redispatches": r["redispatches"],
            }
            if r["phase"] == "done":
                out["status"] = "done"
                out["tokens"] = list(r["tokens"])
            elif r["phase"] == "failed":
                out["status"] = "failed"
                out["error"] = r["error"]
                out["tokens"] = list(r["tokens"])
            else:
                out["status"] = ("running" if r["phase"] == "decoding"
                                 else "pending")
                out["tokens"] = list(r["prefill_tokens"])
            if r["first_token_at"] is not None:
                out["ttft_ms"] = round(
                    (r["first_token_at"] - r["submitted_at"]) * 1000.0, 2)
            out["trace_id"] = r.get("trace_id")
            return out

    def wait(self, fid: str, timeout: float = 60.0,
             poll_s: float = 0.005) -> dict[str, Any]:
        """Poll-pump until the request is terminal (the replica threads do
        the device work; this advances the phase machine)."""
        deadline = time.time() + timeout
        while True:
            out = self.result(fid)
            if out["status"] in ("done", "failed"):
                return out
            if time.time() >= deadline:
                raise TimeoutError(f"request {fid} not done in {timeout}s")
            time.sleep(poll_s)

    # -- control loop --------------------------------------------------------

    def _pct(self, vals: collections.deque, q: float) -> Optional[float]:
        if not vals:
            return None
        s = sorted(vals)
        return round(s[min(int(q * (len(s) - 1)), len(s) - 1)], 2)

    def ttft_percentiles(self) -> dict[str, Optional[float]]:
        with self._lock:
            return {"p50": self._pct(self._ttfts, 0.50),
                    "p99": self._pct(self._ttfts, 0.99)}

    def p99_latency_ms(self) -> Optional[float]:
        with self._lock:
            return self._pct(self._latencies, 0.99)

    def _pool_depths_locked(self) -> tuple[int, int]:
        """(prefill-side, decode-side) demand: the requests waiting on each
        pool, the two autoscaler signals."""
        prefill_depth = sum(
            1 for r in self._requests.values()
            if r["phase"] in ("queued", "prefilling"))
        decode_depth = sum(
            1 for r in self._requests.values()
            if r["phase"] in ("extracting", "handoff"))
        for eng in self.decode.running_replicas().values():
            try:
                decode_depth += int(eng.stats().get("queued_handoffs", 0))
            except Exception:  # noqa: BLE001 — engine mid-teardown
                continue
        return prefill_depth, decode_depth

    def _drive_pool(self, pool: ServingFleet, now: float, depth: int,
                    p99: Optional[float],
                    ttft_p99: Optional[float]) -> None:
        """``ServingFleet.tick``'s convergence-guarded scale action, driven
        by the phase machine's per-pool signal."""
        n_running = len(pool.running_replicas())
        desired = pool.autoscaler.observe(
            now, depth, p99, n_running, ttft_p99_ms=ttft_p99)
        if desired > pool.desired_replicas:
            pool.scale_ups_total += 1
            pool.scale_to(desired)
        elif desired < pool.desired_replicas and n_running >= pool.desired_replicas:
            pool.scale_downs_total += 1
            pool.scale_to(desired)

    def tick(self, now: Optional[float] = None) -> dict[str, Any]:
        """One control pass: pump the phase machine, then scale each pool
        on its signal: prefill on queue depth and the TTFT SLO, decode on
        handoff/occupancy depth and end-to-end p99."""
        now = time.time() if now is None else now
        with self._lock:
            self._pump_locked()
            prefill_depth, decode_depth = self._pool_depths_locked()
            ttft_p99 = self._pct(self._ttfts, 0.99)
            p99 = self._pct(self._latencies, 0.99)
            self._drive_pool(self.prefill, now, prefill_depth, None, ttft_p99)
            self._drive_pool(self.decode, now, decode_depth, p99, None)
        return self.status()

    def status(self) -> dict[str, Any]:
        with self._lock:
            pending = sum(1 for r in self._requests.values()
                          if r["phase"] in _PENDING_PHASES)
            decoding = sum(1 for r in self._requests.values()
                           if r["phase"] == "decoding")
            return {
                "wire_quant": self.wire_quant,
                "requests_total": self.requests_total,
                "completed_total": self.completed_total,
                "failed_total": self.failed_total,
                "tokens_total": self.tokens_total,
                "pending_requests": pending,
                "decoding_requests": decoding,
                "handoffs_total": self.handoffs_total,
                "handoff_bytes_total": self.handoff_bytes_total,
                "reprefills_total": self.reprefills_total,
                "ttft_p50_ms": self._pct(self._ttfts, 0.50),
                "ttft_p99_ms": self._pct(self._ttfts, 0.99),
                "p99_latency_ms": self._pct(self._latencies, 0.99),
                "prefill_pool": self.prefill.status(),
                "decode_pool": self.decode.status(),
            }
