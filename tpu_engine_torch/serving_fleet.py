"""Serving fleet: scheduler-managed decode replicas over the training fleet
(port of ``tpu_engine/serving_fleet.py``).

``tpu_engine_torch/serving.py`` is one in-process :class:`ContinuousBatcher`;
this module makes inference a first-class
:class:`~tpu_engine_torch.scheduler.FleetScheduler` workload:

- :class:`ServingReplicaSpec` — one replica's shape: model, slot pool,
  max sequence length, tensor parallelism, weight/KV quantization, prefix
  cache budget, and the device it serves on. Its HBM footprint goes through
  the KV-pool plane (:func:`tpu_engine_torch.hbm_estimate.estimate_serving_hbm`),
  so admission is gated on params + ``max_slots × lanes`` of KV against the
  same per-device reservation ledger training jobs use.

- :class:`ServingReplicaJob` — the scheduler-driven lifecycle around one
  decode engine. Submitted with ``workload="serving"`` it rides the same
  priority queue, quotas, drain/cancel and preempt machinery as training;
  a CRITICAL training job evicts it through the ordinary watcher seam, and
  the teardown is **checkpoint-free**: a replica is stateless above its
  snapshot, so eviction drops the engine (and returns its cached device
  blocks) and the scheduler requeues the submission for re-admission.

- :class:`FleetRouter` — smooth weighted round-robin dispatch, weighted by
  each replica's measured decode throughput × free-slot fraction, with
  shared-prefix affinity: requests opening with a system prompt already
  resident in some replica's prefix cache land on that replica.

- :class:`ReplicaAutoscaler` — replica count between min/max against a
  sliding window of queue depth and a p99-latency SLO, scale-down behind a
  hysteresis cooldown. A pure function of (now, observation), so a virtual
  clock drives the same object the live fleet ticks.

- :class:`ServingFleet` — submits replicas, routes requests, ticks the
  autoscaler, reports stats (the ``tpu_engine_serving_fleet_*`` Prometheus
  families' names).

Differences from JAX's:

- :func:`build_replica_engine` builds the port's batcher on ``spec.device``
  (the card unless the caller asks for ``"cpu"``) in ``spec.compute_dtype``
  (JAX's batcher serves in its default bf16 whatever the spec says); a
  fresh init draws from torch's generator, so its weights differ from
  JAX's for the same seed. A spec with ``tensor_parallel > 1`` is refused:
  this package runs a mesh as one process a rank.
- :class:`ServingReplicaJob` builds and steps the engine on its own thread
  on the engine's device and stream, as ``serve_forever`` does, and its
  teardown returns the caching allocator's free blocks to the device, so
  the live fleet's memory reading does not hold back the next admission.
"""

from __future__ import annotations

import collections
import gc
import logging
import math
import threading
import time
from typing import Any, Callable, Iterable, Optional

import torch
from pydantic import BaseModel, ConfigDict, Field

from tpu_engine_torch import journal as journal_mod
from tpu_engine_torch import tracing
from tpu_engine_torch.hbm_estimate import HBMEstimate, estimate_serving_hbm
from tpu_engine_torch.mesh_runtime import MeshConfig
from tpu_engine_torch.scheduler import (
    TERMINAL_STATES,
    FleetScheduler,
    JobPriority,
    Submission,
    SubmissionState,
)
from tpu_engine_torch.sharding import Precision
from tpu_engine_torch.supervisor import JobStatus
from tpu_engine_torch.train import TrainConfig

log = logging.getLogger(__name__)


class ServingReplicaSpec(BaseModel):
    """Shape of one decode replica — every replica of a fleet is identical
    (heterogeneity is handled by the router's measured weights, not by
    per-replica shapes)."""

    model_config = ConfigDict(extra="forbid")

    model_name: str
    # Weight source: an int8 serving snapshot directory written by
    # ``quant.save_quantized`` (quantize once, serve N replicas), or None →
    # fresh seeded init (test/demo use).
    snapshot_dir: Optional[str] = None
    max_slots: int = Field(default=8, ge=1, le=256)
    max_len: int = Field(default=1024, ge=8)
    tensor_parallel: int = Field(default=1, ge=1)
    compute_dtype: Precision = Precision.BF16
    # "int8" → weight-only quantization (snapshot weights arrive already
    # quantized; a fresh init is quantized at build).
    weight_quant: Optional[str] = Field(default=None, pattern="^int8$")
    kv_quant: bool = False
    prefill_chunk: int = Field(default=256, ge=16)
    prefix_cache_tokens: int = Field(default=0, ge=0)
    decode_chunk_steps: int = Field(default=8, ge=1)
    eos_id: Optional[int] = Field(default=None, ge=0)
    seed: int = 0
    # Disaggregated serving (tpu_engine_torch/disagg.py): a "prefill" pool's
    # replicas hold KV only for in-flight handoffs (its admission estimate
    # sizes the pool to ``inflight_handoffs`` slots with the prefill
    # workspace dominant); "decode" pools estimate like "unified" ones.
    # "draft" pools (tpu_engine_torch/spec_pool.py) are small decode pools
    # that backfill the verify pools' fragmented headroom.
    pool_role: str = Field(
        default="unified", pattern="^(unified|prefill|decode|draft)$"
    )
    inflight_handoffs: Optional[int] = Field(default=None, ge=1)
    # Where build_replica_engine serves: "cuda" (the current card), "cuda:N"
    # or "cpu".
    device: str = "cuda"

    def placement_config(self) -> TrainConfig:
        """The config the scheduler queues for one replica: its mesh is the
        replica's gang (tensor_parallel devices), and everything
        weight-shaped about footprint comes from the serving estimator, not
        from this stub's training fields."""
        return TrainConfig(
            model_name=self.model_name,
            mesh=MeshConfig(data=1, model=self.tensor_parallel),
            micro_batch_size=1,
            seq_len=32,
            precision=self.compute_dtype,
            checkpoint_dir=None,  # checkpoint-free teardown
        )

    def estimate(self, *_args: Any, **_kw: Any) -> Optional[HBMEstimate]:
        """KV-pool HBM plane for this replica (scheduler ``estimate_fn``
        signature: extra args are the config/n_avail it passes — the spec
        already knows its own shape)."""
        return estimate_serving_hbm(
            self.model_name,
            self.max_slots,
            self.max_len,
            tensor_parallel=self.tensor_parallel,
            compute_dtype=self.compute_dtype,
            kv_quant=self.kv_quant,
            weight_quant=(
                "int8" if self.snapshot_dir is not None else self.weight_quant
            ),
            prefill_chunk=self.prefill_chunk,
            prefix_cache_tokens=self.prefix_cache_tokens,
            pool_role=self.pool_role,
            inflight_handoffs=self.inflight_handoffs,
        )


def build_replica_engine(spec: ServingReplicaSpec) -> Any:
    """Default engine factory: the port's :class:`ContinuousBatcher` on
    ``spec.device`` in ``spec.compute_dtype``, from the spec's weight source
    (an int8 snapshot through ``quant.load_quantized``, or a fresh seeded
    init, quantized when ``weight_quant="int8"``). Fleets under test inject
    their own factory."""
    from tpu_engine_torch.models.config import MODEL_CONFIGS
    from tpu_engine_torch.models.transformer import init_params
    from tpu_engine_torch.serving import ContinuousBatcher
    from tpu_engine_torch.sharding import dtype_of

    if spec.tensor_parallel > 1:
        raise ValueError(
            f"tensor_parallel={spec.tensor_parallel} in one process: tpu_engine_torch runs a "
            "mesh as one process a rank (torchrun, one ContinuousBatcher a rank with mesh=), "
            "not one process over several devices"
        )
    dtype = dtype_of(spec.compute_dtype)
    if spec.snapshot_dir is not None:
        from tpu_engine_torch.quant import load_quantized, load_quantized_config

        cfg = load_quantized_config(spec.snapshot_dir)
        if cfg is None:
            raise ValueError(
                f"snapshot at '{spec.snapshot_dir}' has no recorded model_config"
            )
        params = load_quantized(spec.snapshot_dir, device=spec.device)
    else:
        cfg = MODEL_CONFIGS.get(spec.model_name)
        if cfg is None:
            raise ValueError(f"unknown model '{spec.model_name}'")
        gen = torch.Generator(device=spec.device).manual_seed(spec.seed)
        # Drawn in the compute dtype: no full-width fp32 copy is left in the
        # caching allocator beside the served tree.
        params = init_params(cfg, gen, device=spec.device, dtype=dtype)
        if spec.weight_quant == "int8":
            from tpu_engine_torch.quant import quantize_params

            params = quantize_params(params)

    return ContinuousBatcher(
        params, cfg, max_slots=spec.max_slots, max_len=spec.max_len,
        compute_dtype=dtype, eos_id=spec.eos_id, seed=spec.seed,
        chunk_steps=spec.decode_chunk_steps,
        prefill_chunk=spec.prefill_chunk,
        kv_quant=spec.kv_quant,
        prefix_cache_tokens=spec.prefix_cache_tokens,
        device=spec.device,
    )


def _release_device_memory(device: Any) -> None:
    """Return the caching allocator's free blocks to ``device`` once a
    dropped engine's tensors are collected, so a live memory reading (the
    scheduler's fleet view) sees the teardown at once."""
    gc.collect()
    if device is not None and torch.device(device).type == "cuda":
        with torch.cuda.device(device):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


class _ReplicaWatcher:
    """The scheduler's preempt verb for a replica: no emergency save — fire
    the event, the job loop tears the engine down."""

    def __init__(self) -> None:
        self.fired = threading.Event()

    def simulate_interruption(self) -> None:
        self.fired.set()


class ServingReplicaJob:
    """One decode replica under scheduler lifecycle.

    Presents the job surface :class:`FleetScheduler` drives (``start`` /
    ``join`` / ``is_alive`` / ``status`` / ``watcher`` / ``_stop``) around
    an injected engine. The run thread builds the engine (weight load
    happens off the scheduler's admit pass), then pumps ``engine.step()``
    on the engine's device and stream until stopped or preempted.
    Preemption is checkpoint-free: drop the engine, report ``PREEMPTED`` —
    the scheduler requeues the submission and a later admission rebuilds
    it. In-flight requests die with the engine; the fleet router
    re-dispatches them.
    """

    def __init__(
        self,
        sub: Submission,
        spec: ServingReplicaSpec,
        engine_factory: Callable[[ServingReplicaSpec], Any] = build_replica_engine,
        idle_sleep_s: float = 0.005,
        fault_injector: Optional[Any] = None,
    ):
        self.job_id = sub.job_id
        self.config = sub.config
        self.spec = spec
        # Chaos seam: an armed tpu_engine_torch.faults.FaultInjector whose
        # preemption-signal faults fire against THIS replica's token
        # counter — same consumable contract as the training supervisor.
        self._faults = fault_injector
        self.status = JobStatus.PENDING
        self.error: Optional[str] = None
        self.current_step = 0  # tokens generated — the replica's "progress"
        self.watcher = _ReplicaWatcher()
        self.engine: Any = None
        self.engine_ready = threading.Event()
        self._engine_factory = engine_factory
        self._idle_sleep_s = idle_sleep_s
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"serving-replica-{self.job_id}"
        )

    @property
    def is_alive(self) -> bool:
        return self._thread.is_alive()

    def start(self) -> None:
        self._thread.start()

    def join(self, timeout: Optional[float] = None) -> None:
        self._thread.join(timeout)

    def describe(self) -> dict[str, Any]:
        return {
            "job_id": self.job_id,
            "status": self.status.value,
            "workload": "serving",
            "model_name": self.spec.model_name,
            "tokens_generated": self.current_step,
            "engine_ready": self.engine_ready.is_set(),
            "error": self.error,
        }

    def _run(self) -> None:
        try:
            engine = self._engine_factory(self.spec)
        except Exception as e:  # noqa: BLE001 — weight load / build boundary
            self.status = JobStatus.FAILED
            self.error = f"{type(e).__name__}: {e}"
            log.exception("serving replica %s: engine build failed", self.job_id)
            _release_device_memory(getattr(self.spec, "device", None))
            return
        device = getattr(engine, "device", None)
        stream = getattr(engine, "_stream", None)
        self.engine = engine
        self.engine_ready.set()
        self.status = JobStatus.RUNNING
        try:
            if stream is not None:
                # The engine's work goes on the stream its pool was made on.
                torch.cuda.set_device(device)
                torch.cuda.set_stream(stream)
            while True:
                if self._faults is not None and self._faults.preempt_due(
                    self.current_step
                ):
                    self.watcher.fired.set()
                if self.watcher.fired.is_set():
                    self.status = JobStatus.PREEMPTED
                    return
                if self._stop.is_set():
                    self.status = JobStatus.STOPPED
                    return
                produced = int(engine.step() or 0)
                self.current_step += produced
                if produced == 0:
                    self._stop.wait(self._idle_sleep_s)
        except Exception as e:  # noqa: BLE001 — decode loop boundary
            self.status = JobStatus.FAILED
            self.error = f"{type(e).__name__}: {e}"
            log.exception("serving replica %s: decode loop failed", self.job_id)
        finally:
            # Checkpoint-free teardown: the engine (params + KV pool) is
            # this thread's only strong reference — dropping it, then
            # emptying the allocator's cache, frees the replica's memory
            # for whoever preempted it.
            self.engine = None
            self.engine_ready.clear()
            engine = None
            _release_device_memory(device)


class _PercentileWindow:
    """Bounded sliding-window percentile estimator.

    Replaces the sort-the-whole-window percentile reads: each sample
    lands in a log-spaced bucket, a deque of bucket indexes keeps the
    window bounded, and a percentile read walks the fixed bucket array —
    O(buckets), independent of the window length and of how many samples
    ever passed through. With ``growth=1.015`` the representative value
    (the geometric bucket midpoint) is within ~0.75% of the exact
    sample — inside the 1% contract the property test pins. Values at or
    below ``lo_ms`` collapse into bucket 0 (reported as ``lo_ms``);
    values beyond ``hi_ms`` saturate the last bucket.
    """

    __slots__ = ("window", "_lo", "_log_growth", "_nb", "_counts", "_idxs",
                 "_total")

    def __init__(
        self,
        window: int = 512,
        lo_ms: float = 0.05,
        hi_ms: float = 1e7,
        growth: float = 1.015,
    ):
        self.window = int(window)
        self._lo = float(lo_ms)
        self._log_growth = math.log(float(growth))
        self._nb = int(math.ceil(math.log(hi_ms / lo_ms) / self._log_growth)) + 2
        self._counts = [0] * self._nb
        self._idxs: collections.deque[int] = collections.deque()
        self._total = 0

    def __len__(self) -> int:
        return self._total

    def _bucket(self, v: float) -> int:
        if v <= self._lo:
            return 0
        return min(
            int(math.log(v / self._lo) / self._log_growth) + 1, self._nb - 1
        )

    def _value_at(self, idx: int) -> float:
        if idx <= 0:
            return self._lo
        return self._lo * math.exp(self._log_growth * (idx - 0.5))

    def add(self, v: float) -> None:
        idx = self._bucket(float(v))
        self._idxs.append(idx)
        self._counts[idx] += 1
        self._total += 1
        while self._total > self.window:
            self._counts[self._idxs.popleft()] -= 1
            self._total -= 1

    def percentiles(self, qs: Iterable[float]) -> list[Optional[float]]:
        """Window percentiles at the same rank convention the sorted-window
        read used (``vals[int(q * (n - 1))]``); all-None when empty."""
        qs = list(qs)
        if not self._total:
            return [None] * len(qs)
        ranks = [min(int(q * (self._total - 1)), self._total - 1) for q in qs]
        out: list[Optional[float]] = [None] * len(qs)
        order = sorted(range(len(qs)), key=lambda i: ranks[i])
        cum, oi = 0, 0
        for idx, c in enumerate(self._counts):
            if not c:
                continue
            cum += c
            while oi < len(order) and ranks[order[oi]] < cum:
                out[order[oi]] = self._value_at(idx)
                oi += 1
            if oi == len(order):
                break
        return out


class FleetRouter:
    """Throughput-weighted dispatch with shared-prefix affinity.

    Smooth weighted round-robin (the nginx algorithm) over
    ``weight = (ε + tokens/sec) × (ε + free-slot fraction)``: a degraded
    replica — slow host, busy slots — serves proportionally less traffic
    instead of gating the fleet, and a cold replica (no throughput yet)
    still receives work through the ε floor. Requests whose leading
    ``affinity_tokens`` match a previously routed prompt stick to that
    replica while it has a free slot, so a shared system prompt keeps
    hitting the replica whose prefix cache already holds it.

    When a :class:`~tpu_engine_torch.prefix_plane.PrefixPlane` is attached, the
    plane's radix index outranks the fixed-width pin: the route goes to
    the longest-prefix-HOLDING replica with a free slot (the plane knows
    which replicas actually retain the KV, the pin only remembers who was
    sent it last), and the pin re-anchors to the plane's pick. Every
    cache-steered pick — plane or pin — still pays its smooth-WRR weight
    share, so cache-heavy traffic cannot skew the fair rotation of the
    remaining (cold) traffic.
    """

    def __init__(self, affinity_tokens: int = 32, affinity_max: int = 512,
                 prefix_plane: Any = None):
        self.affinity_tokens = int(affinity_tokens)
        self.affinity_max = int(affinity_max)
        self.prefix_plane = prefix_plane
        self._weights: dict[str, float] = {}
        self._current: dict[str, float] = {}
        self._free: dict[str, int] = {}
        self._affinity: "collections.OrderedDict[tuple, str]" = (
            collections.OrderedDict()
        )
        self.affinity_hits = 0
        self.plane_hits = 0
        self.routed_total = 0

    def update(self, replica_stats: dict[str, dict[str, Any]]) -> None:
        """Refresh weights from live engine stats: ``{replica_id:
        {"tokens_per_sec", "free_slots", "slots"}}``. Replicas absent from
        the snapshot (preempted / torn down) are forgotten."""
        alive = set(replica_stats)
        died = [rid for rid in self._weights if rid not in alive]
        for rid in died:
            self._weights.pop(rid, None)
            self._current.pop(rid, None)
            self._free.pop(rid, None)
        for rid, st in replica_stats.items():
            slots = max(int(st.get("slots", 1)), 1)
            free = max(int(st.get("free_slots", 0)), 0)
            tps = max(float(st.get("tokens_per_sec", 0.0)), 0.0)
            self._weights[rid] = (0.05 + tps) * (0.05 + free / slots)
            self._current.setdefault(rid, 0.0)
            self._free[rid] = free
        # Affinity entries only go stale when a replica actually dies, so
        # the table scan is gated on that — steady-state update() cost is
        # O(live replicas), independent of affinity table size.
        if died:
            dead = set(died)
            for key in [
                k for k, rid in self._affinity.items() if rid in dead
            ]:
                self._affinity.pop(key, None)
            if self.prefix_plane is not None:
                for rid in died:
                    self.prefix_plane.drop_replica(rid)

    def _charge(self, pick: str) -> None:
        """Smooth-WRR accounting for one dispatch landing on ``pick``:
        everyone accrues their weight, the pick pays the total. Cache-
        steered picks (plane/affinity) run the SAME ledger as fair
        rotation — skipping it would permanently skew later WRR picks
        toward whichever replicas the cache never favors."""
        total = sum(self._weights.values())
        for rid, w in self._weights.items():
            self._current[rid] = self._current.get(rid, 0.0) + w
        self._current[pick] -= total

    def _pin(self, key: Optional[tuple], pick: str,
             overwrite: bool = True) -> None:
        if key is None:
            return
        if not overwrite:
            cur = self._affinity.get(key)
            # A live pin survives a busy fall-through: the pinned replica
            # still HOLDS the prefix KV — re-pinning to this dispatch's
            # pick would scatter one prefix across the fleet, one replica
            # per momentary slot-full blip. Only a dead/unknown target
            # releases the pin.
            if cur is not None and cur in self._weights:
                self._affinity.move_to_end(key)
                return
        self._affinity[key] = pick
        self._affinity.move_to_end(key)
        while len(self._affinity) > self.affinity_max:
            self._affinity.popitem(last=False)

    def route(self, prompt: Any = None) -> Optional[str]:
        """Pick a replica id for this prompt; None when the fleet has no
        routable replica (caller queues fleet-side)."""
        if not self._weights:
            return None
        self.routed_total += 1
        key = None
        if prompt is not None and self.affinity_tokens > 0:
            key = tuple(prompt[: self.affinity_tokens])
            # Fleet prefix plane first: the radix index knows who HOLDS
            # the longest prefix (affinity only remembers who was sent it).
            if self.prefix_plane is not None:
                rid, matched = self.prefix_plane.route_hint(
                    list(prompt), self._free
                )
                if rid is not None and matched > 0 and \
                        self._free.get(rid, 0) > 0:
                    self.plane_hits += 1
                    self._charge(rid)
                    self._free[rid] -= 1
                    self._pin(key, rid)
                    return rid
            rid = self._affinity.get(key)
            if rid is not None and self._free.get(rid, 0) > 0:
                self._affinity.move_to_end(key)
                self.affinity_hits += 1
                # Affinity picks pay their weight share too — the hit path
                # skipping the ledger skewed subsequent WRR picks toward
                # the unpinned replicas under affinity-heavy traffic.
                self._charge(rid)
                self._free[rid] -= 1
                return rid
        # Smooth WRR: current += weight; pick the max; charge it the total.
        for rid, w in self._weights.items():
            self._current[rid] = self._current.get(rid, 0.0) + w
        pick = max(self._current, key=lambda r: self._current[r])
        self._current[pick] -= sum(self._weights.values())
        self._free[pick] = max(self._free.get(pick, 0) - 1, 0)
        # Busy fall-through must NOT overwrite a live pin (the prefix
        # plane's rule: the pinned replica still holds the KV).
        self._pin(key, pick, overwrite=False)
        return pick

    def stats(self) -> dict[str, Any]:
        out = {
            "weights": {r: round(w, 4) for r, w in self._weights.items()},
            "affinity_entries": len(self._affinity),
            "affinity_hits": self.affinity_hits,
            "routed_total": self.routed_total,
            "plane_hits": self.plane_hits,
        }
        if self.prefix_plane is not None:
            out["prefix_plane"] = self.prefix_plane.stats()
        return out


class AutoscalerConfig(BaseModel):
    model_config = ConfigDict(extra="forbid")

    min_replicas: int = Field(default=1, ge=0)
    max_replicas: int = Field(default=4, ge=1)
    # Scale up when the windowed mean queue depth per replica crosses this
    # (or p99 breaches the SLO); scale down when it falls below the low
    #-water mark AND p99 has headroom.
    target_queue_per_replica: float = Field(default=4.0, gt=0)
    low_water_queue_per_replica: float = Field(default=0.5, ge=0)
    p99_slo_ms: float = Field(default=2000.0, gt=0)
    # Optional TTFT SLO: breaching it scales up even while end-to-end p99
    # is healthy (long-prefill bursts hurt time-to-first-token long before
    # they hurt completion latency — the disaggregated prefill pool scales
    # on this signal).
    ttft_slo_ms: Optional[float] = Field(default=None, gt=0)
    window_s: float = Field(default=30.0, gt=0)
    scale_up_cooldown_s: float = Field(default=5.0, ge=0)
    # Hysteresis: scaling down waits this long after ANY scale event, so a
    # dip between bursts does not shed the replicas the next burst needs
    # (and a flapping signal cannot thrash submit/cancel cycles through
    # the scheduler).
    scale_down_cooldown_s: float = Field(default=60.0, ge=0)


class ReplicaAutoscaler:
    """Queue-depth + p99-SLO autoscaler, one step per ``observe`` call.

    Deliberately clockless: every decision is a function of the ``now``
    the caller passes, so the virtual-clock benchmark drives the SAME
    object the live fleet ticks."""

    def __init__(self, cfg: Optional[AutoscalerConfig] = None):
        self.cfg = cfg or AutoscalerConfig()
        self._samples: collections.deque[tuple[float, float]] = collections.deque()
        self._last_up: Optional[float] = None
        self._last_down: Optional[float] = None
        self.scale_ups = 0
        self.scale_downs = 0
        self.last_reason = "init"

    def observe(
        self,
        now: float,
        queue_depth: float,
        p99_ms: Optional[float],
        n_replicas: int,
        ttft_p99_ms: Optional[float] = None,
    ) -> int:
        """Record one observation, return the desired replica count.
        ``ttft_p99_ms`` only matters when the config sets ``ttft_slo_ms``
        (the disaggregated prefill pool's scale signal)."""
        c = self.cfg
        self._samples.append((now, float(queue_depth)))
        while self._samples and now - self._samples[0][0] > c.window_s:
            self._samples.popleft()
        mean_q = sum(q for _, q in self._samples) / len(self._samples)
        per_rep = mean_q / max(n_replicas, 1)

        if n_replicas < c.min_replicas:
            self.last_reason = f"below min_replicas ({c.min_replicas})"
            return c.min_replicas

        last_event = max(
            (t for t in (self._last_up, self._last_down) if t is not None),
            default=None,
        )
        slo_breach = p99_ms is not None and p99_ms > c.p99_slo_ms
        ttft_breach = (
            c.ttft_slo_ms is not None
            and ttft_p99_ms is not None
            and ttft_p99_ms > c.ttft_slo_ms
        )
        if (
            (per_rep > c.target_queue_per_replica or slo_breach or ttft_breach)
            and n_replicas < c.max_replicas
            and (self._last_up is None or now - self._last_up >= c.scale_up_cooldown_s)
        ):
            self._last_up = now
            self.scale_ups += 1
            if slo_breach:
                self.last_reason = (
                    f"scale up: p99 {p99_ms:.0f}ms > SLO {c.p99_slo_ms:.0f}ms"
                )
            elif ttft_breach:
                self.last_reason = (
                    f"scale up: ttft p99 {ttft_p99_ms:.0f}ms > TTFT SLO "
                    f"{c.ttft_slo_ms:.0f}ms"
                )
            else:
                self.last_reason = (
                    f"scale up: queue/replica {per_rep:.2f} > "
                    f"{c.target_queue_per_replica}"
                )
            return n_replicas + 1

        window_full = (
            self._samples and now - self._samples[0][0] >= 0.8 * c.window_s
        )
        if (
            n_replicas > c.min_replicas
            and window_full
            and per_rep < c.low_water_queue_per_replica
            and not slo_breach
            and not ttft_breach
            and (last_event is None or now - last_event >= c.scale_down_cooldown_s)
        ):
            self._last_down = now
            self.scale_downs += 1
            self.last_reason = (
                f"scale down: queue/replica {per_rep:.2f} < "
                f"{c.low_water_queue_per_replica} for the window"
            )
            return n_replicas - 1

        self.last_reason = "hold"
        return n_replicas

    def stats(self) -> dict[str, Any]:
        return {
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "last_reason": self.last_reason,
            "window_samples": len(self._samples),
        }


class ServingFleet:
    """N decode replicas as first-class scheduler submissions.

    Each replica is one ``workload="serving"`` submission through the
    SHARED :class:`FleetScheduler` — same priority queue, quota, drain/
    cancel, per-device HBM ledger (via the spec's KV-pool estimator) and
    preempt machinery as every training job. The fleet object routes
    requests across whatever subset is currently RUNNING, so a replica
    preempted by a CRITICAL training job just drops out of rotation until
    the scheduler re-admits it.
    """

    def __init__(
        self,
        scheduler: FleetScheduler,
        spec: ServingReplicaSpec,
        autoscaler: Optional[ReplicaAutoscaler] = None,
        router: Optional[FleetRouter] = None,
        priority: JobPriority = JobPriority.NORMAL,
        submitter: str = "serving-fleet",
        engine_factory: Callable[[ServingReplicaSpec], Any] = build_replica_engine,
        latency_window: int = 512,
        fault_injector: Optional[Any] = None,
        prefix_plane: Optional[Any] = None,
        journal: Optional[journal_mod.ControlPlaneJournal] = None,
        replica_job_factory: Optional[
            Callable[[Submission, ServingReplicaSpec], Any]
        ] = None,
    ):
        self.scheduler = scheduler
        self.spec = spec
        self.autoscaler = autoscaler or ReplicaAutoscaler()
        self.router = router or FleetRouter(prefix_plane=prefix_plane)
        self.priority = priority
        self.submitter = submitter
        self.engine_factory = engine_factory
        self.fault_injector = fault_injector
        # Durable control plane: replica roster, desired count and held
        # requests are written ahead to the journal; re_adopt() rebuilds a
        # crashed fleet object around the replicas that kept serving.
        self._journal = journal
        # Replica job construction seam (the ctl_crash lane swaps in a
        # thread-free virtual-clock job); default is the real thread-backed
        # ServingReplicaJob.
        self.replica_job_factory = replica_job_factory
        # Fleet prefix plane (tpu_engine_torch/prefix_plane.py): the router takes
        # hints from it; dispatch below reports admissions back and spills
        # replica-cache overflow to its host tier via export_prefix.
        self.prefix_plane = prefix_plane
        if prefix_plane is not None:
            if self.router.prefix_plane is None:
                self.router.prefix_plane = prefix_plane
            if prefix_plane.spill is None:
                prefix_plane.spill = self._spill_prefix

        self._lock = threading.RLock()
        self._replicas: dict[str, Submission] = {}  # submission_id → sub
        self.desired_replicas = 0
        self._pending: collections.deque[tuple[str, dict[str, Any]]] = (
            collections.deque()
        )
        self._requests: dict[str, dict[str, Any]] = {}
        self._req_seq = 0
        self._latencies = _PercentileWindow(window=latency_window)
        # Fleet-level TTFT: first_token_at (engine stamp) minus FLEET
        # submission time — includes fleet queueing and routing, which the
        # engine's own ttft_ms cannot see.
        self._ttfts = _PercentileWindow(window=latency_window)
        self.requests_total = 0
        self.completed_total = 0
        self.tokens_total = 0
        self.scale_ups_total = 0
        self.scale_downs_total = 0

        # Fleet-level flight-recorder lane: replica submissions and
        # autoscaler decisions annotate this trace; each request gets its
        # own trace (enqueue → route → completion) linked back to it.
        rec = tracing.get_recorder()
        self.trace_id = rec.new_trace_id()
        self._fleet_span = rec.start_span(
            f"serving_fleet:{spec.model_name}",
            kind="serving_fleet",
            trace_id=self.trace_id,
            attrs={"model": spec.model_name, "submitter": submitter},
        )

    # -- replica lifecycle ---------------------------------------------------

    def start(self) -> None:
        self.scale_to(max(self.autoscaler.cfg.min_replicas, 1))

    def stop(self) -> None:
        with self._lock:
            for sid in list(self._replicas):
                self.scheduler.cancel(sid)
            self.desired_replicas = 0
        if self._fleet_span.t1 is None:
            self._fleet_span.end(stopped=True)

    def _journal_event(self, kind: str, payload: dict[str, Any]) -> None:
        j = self._journal
        if j is not None:
            j.append(kind, payload)

    def _make_replica_job(self, s: Submission) -> Any:
        if self.replica_job_factory is not None:
            return self.replica_job_factory(s, self.spec)
        return ServingReplicaJob(
            s, self.spec, engine_factory=self.engine_factory,
            fault_injector=self.fault_injector,
        )

    def _submit_replica(self) -> Submission:
        spec = self.spec
        sub = self.scheduler.submit(
            spec.placement_config(),
            priority=self.priority,
            submitter=self.submitter,
            workload="serving",
            estimate_fn=spec.estimate,
            job_factory=self._make_replica_job,
        )
        self._replicas[sub.submission_id] = sub
        self._journal_event("fleet.replica", {"sid": sub.submission_id})
        tracing.get_recorder().event(
            "replica_submit",
            kind="serving",
            trace_id=self.trace_id,
            parent=self._fleet_span,
            attrs={
                "submission_id": sub.submission_id,
                "replica_trace_id": sub.trace_id,
            },
        )
        return sub

    def scale_to(self, n: int) -> int:
        """Submit or cancel replicas toward ``n`` (clamped to the
        autoscaler's [min, max]); returns the resulting desired count."""
        c = self.autoscaler.cfg
        n = max(min(int(n), c.max_replicas), c.min_replicas)
        with self._lock:
            live = [
                s for s in self._replicas.values() if s.state not in TERMINAL_STATES
            ]
            while len(live) < n:
                live.append(self._submit_replica())
            if len(live) > n:
                # Shed queued replicas first (they serve nobody), then the
                # emptiest running engines — never a busy one over an idle
                # one.
                def load(s: Submission) -> tuple[int, int]:
                    job = s.job
                    eng = getattr(job, "engine", None) if job is not None else None
                    if s.state == SubmissionState.QUEUED or eng is None:
                        return (0, 0)
                    st = eng.stats()
                    return (1, int(st.get("active_slots", 0)) + int(st.get("queued", 0)))

                for victim in sorted(live, key=load)[: len(live) - n]:
                    self.scheduler.cancel(victim.submission_id)
            if n != self.desired_replicas:
                self._journal_event("fleet.desired", {"n": n})
            self.desired_replicas = n
        return n

    def running_replicas(self) -> dict[str, Any]:
        """Submission id → live engine, for every replica that is admitted
        AND has finished building its engine."""
        out = {}
        with self._lock:
            for sid, sub in self._replicas.items():
                job = sub.job
                if (
                    sub.state == SubmissionState.RUNNING
                    and job is not None
                    and getattr(job, "engine_ready", None) is not None
                    and job.engine_ready.is_set()
                    and job.engine is not None
                ):
                    out[sid] = job.engine
        return out

    # -- durability: journal snapshot + crash recovery -----------------------

    def snapshot_state(self) -> dict[str, Any]:
        """Serialized fleet state — the ``serving`` section of a journal
        snapshot. Deterministically ordered so the digest is comparable
        across double recoveries."""
        with self._lock:
            return {
                "desired_replicas": self.desired_replicas,
                "req_seq": self._req_seq,
                "replicas": sorted(self._replicas),
                "requests": {
                    fid: {
                        "submitted_at": r["submitted_at"],
                        "prompt": list(r["prompt"]),
                        "max_new_tokens": r["max_new_tokens"],
                        "temperature": r["temperature"],
                        "done": bool(r["done"]),
                    }
                    for fid, r in sorted(self._requests.items())
                },
                "counters": {
                    "requests_total": self.requests_total,
                    "completed_total": self.completed_total,
                    "tokens_total": self.tokens_total,
                },
            }

    def re_adopt(
        self, journal: journal_mod.ControlPlaneJournal, redispatch: bool = True
    ) -> dict[str, Any]:
        """Rebuild a crashed fleet object from its journal. Call on a
        freshly constructed fleet whose scheduler already ran
        ``restore(journal, ...)``.

        Journaled replicas whose submissions survived in the restored
        scheduler (re-adopted live jobs, or still queued) are taken back
        into the roster; vanished ones (marked ``vanished_at_recovery``
        by the scheduler) are replaced by re-dispatching fresh replicas
        up to the journaled desired count (``redispatch=False`` skips
        that — used when comparing double-recovery digests, since fresh
        submissions mint fresh ids). Every held (journaled, not done)
        request is re-created and re-queued for dispatch — no request
        accepted before the crash is lost. ``tokens_total`` restores from
        the snapshot only (per-token progress is not journaled)."""
        doc = journal.read()
        snap = doc.get("snapshot") or {}
        base = (snap.get("sections") or {}).get("serving") or {}
        desired = int(base.get("desired_replicas", 0))
        req_seq = int(base.get("req_seq", 0))
        roster = set(base.get("replicas", []))
        requests: dict[str, dict] = {
            fid: dict(r)
            for fid, r in (base.get("requests") or {}).items()
            if isinstance(r, dict)
        }
        counters = {
            "requests_total": 0, "completed_total": 0, "tokens_total": 0,
        }
        counters.update({
            k: int(v) for k, v in (base.get("counters") or {}).items()
            if k in counters
        })
        for ev in doc.get("events", []):
            kind = ev.get("kind") or ""
            p = ev.get("payload")
            if not kind.startswith("fleet.") or not isinstance(p, dict):
                continue
            if kind == "fleet.desired":
                desired = int(p.get("n", desired))
            elif kind == "fleet.replica" and p.get("sid"):
                roster.add(p["sid"])
            elif kind == "fleet.request" and p.get("fid"):
                requests[p["fid"]] = {
                    "submitted_at": p.get("submitted_at"),
                    "prompt": list(p.get("prompt") or []),
                    "max_new_tokens": int(p.get("max_new_tokens", 64)),
                    "temperature": float(p.get("temperature", 0.0)),
                    "done": False,
                }
                counters["requests_total"] += 1
                try:
                    req_seq = max(req_seq, int(p["fid"].rsplit("_", 1)[-1]))
                except (ValueError, IndexError):
                    pass
            elif kind == "fleet.request_done" and p.get("fid") in requests:
                requests[p["fid"]]["done"] = True
                counters["completed_total"] += 1

        readopted = 0
        held: list[str] = []
        with self._lock:
            self._req_seq = max(self._req_seq, req_seq)
            self.requests_total = counters["requests_total"]
            self.completed_total = counters["completed_total"]
            self.tokens_total = counters["tokens_total"]
            for sid in sorted(roster):
                sub = self.scheduler.get(sid)
                if sub is None or sub.state in TERMINAL_STATES:
                    continue  # vanished — replaced by the re-dispatch below
                self._replicas[sid] = sub
                readopted += 1
            # Re-create every held request, oldest first (fid order), with
            # a fresh trace span — the original span died with the crash.
            rec = tracing.get_recorder()
            def _fid_key(fid: str) -> tuple:
                try:
                    return (0, int(fid.rsplit("_", 1)[-1]))
                except (ValueError, IndexError):
                    return (1, fid)
            for fid in sorted(requests, key=_fid_key):
                r = requests[fid]
                if r.get("done"):
                    continue
                span = rec.start_span(
                    f"request:{fid}",
                    kind="serving_request",
                    attrs={
                        "fleet_trace_id": self.trace_id,
                        "prompt_tokens": len(r["prompt"]),
                        "max_new_tokens": int(r["max_new_tokens"]),
                        "recovered": True,
                    },
                )
                req = {
                    "submitted_at": r.get("submitted_at") or time.time(),
                    "prompt": list(r["prompt"]),
                    "max_new_tokens": int(r["max_new_tokens"]),
                    "temperature": float(r.get("temperature", 0.0)),
                    "replica": None,
                    "engine_rid": None,
                    "done": False,
                    "trace_id": span.trace_id,
                    "_span": span,
                }
                self._requests[fid] = req
                self._pending.append((fid, req))
                held.append(fid)
            self.desired_replicas = 0
        # Attach before re-dispatching so the replacement replicas are
        # themselves written ahead — they must survive a second crash.
        self._journal = journal
        redispatched = 0
        if redispatch and desired > 0:
            before = len(self._replicas)
            self.scale_to(desired)
            redispatched = len(self._replicas) - before
        else:
            with self._lock:
                self.desired_replicas = desired
        journal_mod.note_recovery(
            replicas_readopted_total=readopted,
            replicas_redispatched_total=redispatched,
            requests_recovered_total=len(held),
        )
        summary = {
            "desired_replicas": desired,
            "replicas_readopted": readopted,
            "replicas_redispatched": redispatched,
            "requests_recovered": len(held),
            "held_fids": held,
            "ingest": doc.get("stats", {}),
        }
        log.info("serving fleet: re-adopted from journal — %s", summary)
        return summary

    # -- request plane -------------------------------------------------------

    def submit_request(
        self,
        prompt: list[int],
        max_new_tokens: int = 64,
        temperature: float = 0.0,
    ) -> str:
        """Route a request to a replica (or hold it fleet-side until one is
        admitted). Returns a fleet-scoped request id."""
        with self._lock:
            self._req_seq += 1
            fid = f"req_{self._req_seq}"
            self.requests_total += 1
            rec = tracing.get_recorder()
            span = rec.start_span(
                f"request:{fid}",
                kind="serving_request",
                attrs={
                    "fleet_trace_id": self.trace_id,
                    "prompt_tokens": len(prompt),
                    "max_new_tokens": int(max_new_tokens),
                },
            )
            self._requests[fid] = {
                "submitted_at": time.time(),
                "prompt": list(prompt),
                "max_new_tokens": int(max_new_tokens),
                "temperature": float(temperature),
                "replica": None,
                "engine_rid": None,
                "done": False,
                "trace_id": span.trace_id,
                "_span": span,
            }
            rec.event(
                "enqueue", kind="serving", trace_id=span.trace_id, parent=span,
                attrs={"fid": fid},
            )
            self._journal_event("fleet.request", {
                "fid": fid,
                "prompt": list(prompt),
                "max_new_tokens": int(max_new_tokens),
                "temperature": float(temperature),
                "submitted_at": self._requests[fid]["submitted_at"],
            })
            self._pending.append((fid, self._requests[fid]))
            self._flush_pending()
            return fid

    def _flush_pending(self) -> None:
        engines = self.running_replicas()
        if not engines:
            return
        self.router.update({
            sid: self._engine_router_stats(e) for sid, e in engines.items()
        })
        still: collections.deque = collections.deque()
        while self._pending:
            fid, req = self._pending.popleft()
            sid = self.router.route(req["prompt"])
            if sid is None or sid not in engines:
                still.append((fid, req))
                continue
            try:
                rid = engines[sid].submit(
                    req["prompt"],
                    max_new_tokens=req["max_new_tokens"],
                    temperature=req["temperature"],
                )
            except Exception:  # engine died under us — requeue fleet-side
                still.append((fid, req))
                continue
            req["replica"], req["engine_rid"] = sid, rid
            if self.prefix_plane is not None:
                self._observe_plane(req["prompt"], sid, engines.get(sid))
            tracing.get_recorder().event(
                "route",
                kind="serving",
                trace_id=req.get("trace_id"),
                parent=req.get("_span"),
                attrs={"fid": fid, "replica": sid, "engine_rid": rid},
            )
        self._pending.extend(still)

    def _observe_plane(self, prompt: list[int], sid: str, engine: Any) -> None:
        """Report one admission to the prefix plane; a host-tier hit
        rehydrates the payload into the replica's prefix cache. Plane
        bookkeeping is an optimization — it must never fail a dispatch."""
        try:
            obs = self.prefix_plane.observe_admit(prompt, sid)
            if (
                obs["kind"] == "host"
                and obs["payload"] is not None
                and engine is not None
                and hasattr(engine, "install_prefix")
            ):
                engine.install_prefix(list(obs["prefix"]), obs["payload"])
        except Exception:  # noqa: BLE001
            pass

    def _spill_prefix(self, prefix: tuple, rid: str) -> Optional[Any]:
        """Default plane spill: export the evicted prefix's KV off the
        replica that held it (None when the replica or its entry is gone —
        the host tier then simply misses)."""
        eng = self.running_replicas().get(rid)
        if eng is None or not hasattr(eng, "export_prefix"):
            return None
        try:
            return eng.export_prefix(list(prefix))
        except Exception:  # noqa: BLE001
            return None

    @staticmethod
    def _engine_router_stats(engine: Any) -> dict[str, Any]:
        # Busy accounting is pool-aware: active_slots already counts held
        # (finished-but-pinned) prefill slots, and queued_handoffs are wire
        # payloads that will claim a slot before any new route lands.
        st = engine.stats()
        slots = int(st.get("slots", 1))
        busy = (
            int(st.get("active_slots", 0))
            + int(st.get("prefilling", 0))
            + int(st.get("queued_handoffs", 0))
        )
        return {
            "tokens_per_sec": float(st.get("tokens_per_sec_recent", 0.0)),
            "free_slots": max(slots - busy, 0),
            "slots": slots,
        }

    def result(self, fid: str) -> dict[str, Any]:
        """Fleet-side view of one request; re-dispatches it when its
        replica was preempted mid-flight (stateless replicas make retry the
        correct recovery)."""
        with self._lock:
            req = self._requests.get(fid)
            if req is None:
                raise KeyError(fid)
            if req["replica"] is None:
                self._flush_pending()
                if req["replica"] is None:
                    return {"id": fid, "status": "pending", "replica": None}
            engines = self.running_replicas()
            eng = engines.get(req["replica"])
            if eng is None:
                # Replica torn down (preempt/cancel) before completion:
                # requeue the request for the next flush.
                if not req["done"]:
                    req["replica"] = req["engine_rid"] = None
                    self._pending.append((fid, req))
                    tracing.get_recorder().event(
                        "redispatch",
                        kind="serving",
                        trace_id=req.get("trace_id"),
                        parent=req.get("_span"),
                        attrs={"fid": fid, "reason": "replica lost"},
                    )
                    return {"id": fid, "status": "pending", "replica": None}
                return {"id": fid, "status": "done", "replica": req["replica"]}
            try:
                out = eng.result(req["engine_rid"])
            except KeyError:
                req["replica"] = req["engine_rid"] = None
                self._pending.append((fid, req))
                tracing.get_recorder().event(
                    "redispatch",
                    kind="serving",
                    trace_id=req.get("trace_id"),
                    parent=req.get("_span"),
                    attrs={"fid": fid, "reason": "engine forgot request"},
                )
                return {"id": fid, "status": "pending", "replica": None}
            out = dict(out)
            out["id"] = fid
            out["replica"] = req["replica"]
            if out.get("status") in ("done", "failed") and not req["done"]:
                req["done"] = True
                self.completed_total += 1
                self._journal_event("fleet.request_done", {"fid": fid})
                n_new = len(out.get("tokens", []) or [])
                self.tokens_total += n_new
                latency_ms = (time.time() - req["submitted_at"]) * 1000.0
                self._latencies.add(latency_ms)
                first_at = out.get("first_token_at")
                if first_at is not None:
                    ttft = (float(first_at) - req["submitted_at"]) * 1000.0
                    if ttft >= 0:
                        self._ttfts.add(ttft)
                        out["fleet_ttft_ms"] = round(ttft, 2)
                span = req.get("_span")
                if span is not None and span.t1 is None:
                    span.end(
                        status=out.get("status"),
                        tokens=n_new,
                        replica=req["replica"],
                        latency_ms=round(latency_ms, 3),
                    )
            out["trace_id"] = req.get("trace_id")
            return out

    # -- control loop --------------------------------------------------------

    def p99_latency_ms(self) -> Optional[float]:
        with self._lock:
            (p99,) = self._latencies.percentiles((0.99,))
            return p99

    def ttft_percentiles(self) -> dict[str, Optional[float]]:
        """p50/p99 of fleet-level TTFT (fleet submit → engine first token)
        over the latency window; None until a completion reports one.
        Reads walk the bounded histogram (within 1% of the exact window
        percentile) instead of sorting the window per call."""
        with self._lock:
            p50, p99 = self._ttfts.percentiles((0.50, 0.99))
            if p50 is None:
                return {"p50": None, "p99": None}
            return {"p50": round(p50, 2), "p99": round(p99, 2)}

    def queue_depth(self) -> int:
        engines = self.running_replicas()
        with self._lock:
            depth = len(self._pending)
        for eng in engines.values():
            try:
                depth += int(eng.stats().get("queued", 0))
            except Exception:  # noqa: BLE001 — engine mid-teardown
                continue
        return depth

    def tick(self, now: Optional[float] = None) -> dict[str, Any]:
        """One control-loop pass: flush held requests, refresh router
        weights, drive the autoscaler. The HTTP plane calls this on status
        reads; a live deployment would pin it to a timer."""
        now = time.time() if now is None else now
        with self._lock:
            self._flush_pending()
            engines = self.running_replicas()
            self.router.update({
                sid: self._engine_router_stats(e) for sid, e in engines.items()
            })
            n_running = len(engines)
            p99 = self.p99_latency_ms()
            ttfts = self.ttft_percentiles()
            desired = self.autoscaler.observe(
                now, self.queue_depth(), p99, n_running,
                ttft_p99_ms=ttfts["p99"],
            )
            # Feed the fleet SLO alerter's serving-p99 window (burn-rate
            # evaluation happens on the read path, not here).
            if p99 is not None:
                try:
                    from tpu_engine_torch import goodput as goodput_mod

                    goodput_mod.get_alerter().observe_p99(p99, ts=now)
                except Exception:  # alerting must never break serving
                    pass
            # Only act on autoscaler output once the fleet has converged to
            # the previous desired count — scheduler admission latency must
            # not read as "need another replica".
            if desired > self.desired_replicas:
                self.scale_ups_total += 1
                tracing.get_recorder().event(
                    "scale_up",
                    kind="autoscaler",
                    trace_id=self.trace_id,
                    parent=self._fleet_span,
                    attrs={"desired": desired, "running": n_running},
                )
                self.scale_to(desired)
            elif desired < self.desired_replicas and n_running >= self.desired_replicas:
                self.scale_downs_total += 1
                tracing.get_recorder().event(
                    "scale_down",
                    kind="autoscaler",
                    trace_id=self.trace_id,
                    parent=self._fleet_span,
                    attrs={"desired": desired, "running": n_running},
                )
                self.scale_to(desired)
        return self.status()

    def status(self) -> dict[str, Any]:
        with self._lock:
            # Refresh router weights so a status/metrics read reports the
            # dispatch plane as it would route NOW (no autoscaler side
            # effects — only tick() scales).
            self.router.update({
                sid: self._engine_router_stats(e)
                for sid, e in self.running_replicas().items()
            })
            ttfts = self.ttft_percentiles()  # one histogram walk per status
            replicas = {}
            for sid, sub in self._replicas.items():
                job = sub.job
                entry = {
                    "state": sub.state.value,
                    "job_id": sub.job_id,
                    "attempts": sub.attempts,
                    "preemptions": sub.preemptions,
                    "engine_ready": bool(
                        job is not None
                        and getattr(job, "engine_ready", None) is not None
                        and job.engine_ready.is_set()
                    ),
                }
                if entry["engine_ready"]:
                    try:
                        entry["engine"] = job.engine.stats()
                    except Exception:  # noqa: BLE001 — engine mid-teardown
                        entry["engine_ready"] = False
                replicas[sid] = entry
            return {
                "model": self.spec.model_name,
                "desired_replicas": self.desired_replicas,
                "running_replicas": sum(
                    1 for r in replicas.values() if r["engine_ready"]
                ),
                "replicas": replicas,
                "pending_requests": len(self._pending),
                "requests_total": self.requests_total,
                "completed_total": self.completed_total,
                "tokens_total": self.tokens_total,
                "p99_latency_ms": self.p99_latency_ms(),
                "ttft_p50_ms": ttfts["p50"],
                "ttft_p99_ms": ttfts["p99"],
                "scale_ups_total": self.scale_ups_total,
                "scale_downs_total": self.scale_downs_total,
                "router": self.router.stats(),
                "autoscaler": self.autoscaler.stats(),
                "prefix_plane": (
                    None if self.prefix_plane is None
                    else self.prefix_plane.stats()
                ),
            }
