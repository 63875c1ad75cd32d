"""Live card telemetry sources for the fleet manager (port of
``tpu_engine/telemetry.py``).

The reference reads live temperature / utilization / power from hardware on
every poll by shelling out to ``nvidia-smi``
(``ai_engine/gpu_manager.py:100-117,138-215``); on an H100 the port does the
same. Telemetry comes from layered sources, merged in priority order by
:func:`sample_overlay`:

1. :class:`NvidiaSmiSource` — one ``nvidia-smi --query-gpu=...`` call
   (:data:`SMI_FIELDS`, CSV without header or units): per-card GPU
   utilization (the share of time a kernel ran: the duty cycle), memory used
   and total, temperature, power draw and limit, and the active clock
   throttle reasons (the hardware's own slowdown signal, mapped to the
   0-10 throttle score the fleet's thresholds read: :func:`throttle_score`).
2. :class:`DerivedDutySource` — duty cycle derived from the engine's own step
   profiler (device-phase wall time / step wall time). The supervisor feeds
   it after every train step, so fleets report a live duty cycle where
   ``nvidia-smi`` is absent.

Injected snapshots (``TPUManager.parse_metrics``) bypass this module entirely
— they are the canned-telemetry test seam, parity with the reference's
``parse_xml(xml_str=...)``.

TPU-only fields (per-link ICI health, TensorCore utilization per core) have
no source on the card and stay absent; :func:`parse_link_scores` and
:func:`ici_link_alerts` keep JAX's parser and alert lines for the libtpu
string formats:

- ``duty_cycle_pct`` / ``tensorcore_util``: ``["0.00", "20.00", ...]``
  (percent per chip / per core);
- ``hbm_capacity_usage`` / ``hbm_capacity_total``: ``["1073741824", ...]``
  (integer bytes per chip);
- ``tpu_throttle_score``: ``["0-0", "1-1", ...]`` (``<chip>-<score>``,
  score 0 = not throttled, 1-10 = throttled by 10-100%);
- ``ici_link_health``: ``["tray1.chip3.ici0.int: 0", ...]`` (``<loc>: <score>``,
  0 healthy, 1-5 transient, 6-9 persistent minor, 10 unusable).
"""

from __future__ import annotations

import re
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Optional, Protocol, Sequence

# ---------------------------------------------------------------------------
# Snapshot / source protocol
# ---------------------------------------------------------------------------


@dataclass
class TelemetrySnapshot:
    """One source's reading: per-chip overlay dicts + fleet-level extras."""

    source: str
    sampled_at: float
    # Overlay fields per chip position (0..n_chips-1). Recognised keys:
    # duty_cycle_pct, tensorcore_util_pct, throttle_score, temperature_c,
    # power_draw_w, power_limit_w, hbm_total_gb, hbm_used_gb, name,
    # throttle_reasons.
    per_chip: list[dict[str, Any]] = field(default_factory=list)
    # (location, score) per ICI link, scores per the libtpu scale (0-10).
    ici_links: list[tuple[str, int]] = field(default_factory=list)


class TelemetrySource(Protocol):
    name: str

    def sample(self, n_chips: int) -> Optional[TelemetrySnapshot]: ...


# ---------------------------------------------------------------------------
# Parsers for the documented libtpu metric string formats
# ---------------------------------------------------------------------------


def parse_float_list(data: Sequence[str]) -> list[float]:
    """``["0.00", "20.00"]`` → floats; tolerates ``"<idx>: <val>"`` entries."""
    out: list[float] = []
    for item in data:
        s = str(item).strip()
        if ":" in s:
            s = s.rsplit(":", 1)[1].strip()
        try:
            out.append(float(s))
        except ValueError:
            continue
    return out


def parse_indexed_scores(data: Sequence[str]) -> dict[int, int]:
    """``["0-0", "1-1"]`` → {chip: score}; tolerates ``"<idx>: <score>"``."""
    out: dict[int, int] = {}
    for item in data:
        s = str(item).strip()
        sep = "-" if "-" in s else (":" if ":" in s else None)
        if sep is None:
            continue
        left, _, right = s.rpartition(sep)
        try:
            out[int(left.strip())] = int(float(right.strip()))
        except ValueError:
            continue
    return out


def parse_link_scores(data: Sequence[str]) -> list[tuple[str, int]]:
    """``["tray1.chip3.ici0.int: 0"]`` → [(location, score)]."""
    out: list[tuple[str, int]] = []
    for item in data:
        s = str(item).strip()
        loc, sep, score = s.rpartition(":")
        if not sep:
            continue
        try:
            out.append((loc.strip(), int(float(score.strip()))))
        except ValueError:
            continue
    return out


def _per_chip_from_cores(values: list[float], n_chips: int) -> list[float]:
    """Collapse a per-core list to per-chip means (cores enumerate
    contiguously per chip). Falls back to 1:1 when counts don't divide."""
    if n_chips <= 0 or not values:
        return []
    if len(values) % n_chips == 0:
        k = len(values) // n_chips
        return [sum(values[i * k : (i + 1) * k]) / k for i in range(n_chips)]
    return values[:n_chips]


# ---------------------------------------------------------------------------
# Source: nvidia-smi
# ---------------------------------------------------------------------------

# The fields of one ``nvidia-smi --query-gpu`` call, in its column order.
SMI_FIELDS = ("index", "name", "utilization.gpu", "memory.used", "memory.total",
              "temperature.gpu", "power.draw", "power.limit",
              "clocks_throttle_reasons.active")
# Newer nvidia-smi versions name the last field ``clocks_event_reasons.active``; asked
# for when the first form is refused.
_SMI_FIELDS_NEW = SMI_FIELDS[:-1] + ("clocks_event_reasons.active",)

# Clock throttle reason bits (NVML ``nvmlClocksThrottleReason*``) and the
# throttle score each means on the fleet's 0-10 scale (>=1 warning, >=6
# critical): the hardware slowdowns (HW slowdown, HW thermal, HW power
# brake) are critical, the software thermal slowdown a warning. Idle, the
# applications clock setting and the software power cap (a card run under
# its power limit) are no throttle.
THROTTLE_BITS = {
    0x1: "gpu_idle", 0x2: "applications_clocks", 0x4: "sw_power_cap",
    0x8: "hw_slowdown", 0x10: "sync_boost", 0x20: "sw_thermal", 0x40: "hw_thermal",
    0x80: "hw_power_brake", 0x100: "display_clocks",
}
_THROTTLE_SCORE = {"hw_slowdown": 10, "hw_thermal": 10, "hw_power_brake": 10,
                   "sw_thermal": 5}


def throttle_reasons(mask: int) -> list[str]:
    """The names of the reason bits set in ``mask``."""
    return [name for bit, name in THROTTLE_BITS.items() if mask & bit]


def throttle_score(mask: int) -> int:
    """The fleet's 0-10 throttle score of a throttle-reason bitmask: the
    worst of its reasons' scores (:data:`_THROTTLE_SCORE`), 0 for none."""
    return max((_THROTTLE_SCORE.get(r, 0) for r in throttle_reasons(mask)), default=0)


def _smi_number(text: str) -> Optional[float]:
    """A CSV cell as a float; None for ``[N/A]``, ``[Not Supported]``..."""
    try:
        return float(text)
    except ValueError:
        return None


class NvidiaSmiSource:
    """Parses ``nvidia-smi --query-gpu=<SMI_FIELDS> --format=csv,noheader,
    nounits`` — the reference's own telemetry source
    (``gpu_manager.py:100-117``).

    ``runner=`` injects a callable returning canned CSV for tests. Without
    it, the real binary is invoked — when present — with a hard timeout, and
    any failure degrades to "no data" (never an exception on the fleet
    path): it is a telemetry source, not the compute path.

    Fleet polls and /metrics scrapes hit ``sample`` on their hot path, so
    real subprocess invocations are rate-limited: at most one fork per
    ``min_interval_s``; between runs the cached text (including a cached
    miss) is served. Injected runners are not cached — tests control their
    own output.
    """

    name = "nvidia_smi"

    def __init__(self, runner: Any = None, binary: str = "nvidia-smi",
                 timeout_s: float = 5.0, min_interval_s: float = 10.0):
        self._runner = runner
        self._binary = binary
        self._timeout_s = timeout_s
        self._min_interval_s = min_interval_s
        self._cached: Optional[str] = None
        self._cached_at = float("-inf")
        self._which: Optional[bool] = None  # PATH probe, done once
        self._lock = threading.Lock()

    def _invoke(self) -> Optional[str]:
        import shutil
        import subprocess

        if self._which is None:
            self._which = shutil.which(self._binary) is not None
        if not self._which:
            return None
        for fields in (SMI_FIELDS, _SMI_FIELDS_NEW):
            try:
                proc = subprocess.run(
                    [self._binary, f"--query-gpu={','.join(fields)}",
                     "--format=csv,noheader,nounits"],
                    capture_output=True, text=True, timeout=self._timeout_s,
                )
            except Exception:
                return None
            if proc.returncode == 0:
                return proc.stdout
        return None

    def _output(self) -> Optional[str]:
        if self._runner is not None:
            try:
                return self._runner()
            except Exception:
                return None
        with self._lock:
            now = time.time()
            if now - self._cached_at < self._min_interval_s:
                return self._cached
            self._cached = self._invoke()
            self._cached_at = now
            return self._cached

    @staticmethod
    def parse(text: str) -> dict[int, dict[str, Any]]:
        """CSV text → {card index: overlay fields}; a row that is not one
        card's is skipped, a cell that is not a number left out."""
        out: dict[int, dict[str, Any]] = {}
        for line in text.splitlines():
            cells = [c.strip() for c in line.split(",")]
            if len(cells) != len(SMI_FIELDS) or not cells[0].isdigit():
                continue
            util, used, total, temp, draw, limit = (_smi_number(c) for c in cells[2:8])
            entry: dict[str, Any] = {"name": cells[1]}
            if util is not None:
                entry["duty_cycle_pct"] = round(util, 2)
            if used is not None:
                entry["hbm_used_gb"] = round(used / 1024, 3)
            if total is not None and total > 0:
                entry["hbm_total_gb"] = round(total / 1024, 3)
            if temp is not None:
                entry["temperature_c"] = temp
            if draw is not None:
                entry["power_draw_w"] = draw
            if limit is not None:
                entry["power_limit_w"] = limit
            try:
                mask = int(cells[8], 16)
            except ValueError:
                mask = None
            if mask is not None:
                entry["throttle_score"] = throttle_score(mask)
                entry["throttle_reasons"] = throttle_reasons(mask)
            out[int(cells[0])] = entry
        return out

    def sample(self, n_chips: int) -> Optional[TelemetrySnapshot]:
        text = self._output()
        if not text:
            return None
        fields = self.parse(text)
        if not fields:
            return None
        per_chip = [dict(fields.get(i, {})) for i in range(n_chips)]
        return TelemetrySnapshot(
            source=self.name, sampled_at=time.time(), per_chip=per_chip
        )


# ---------------------------------------------------------------------------
# Source: engine-derived duty cycle
# ---------------------------------------------------------------------------


class DerivedDutySource:
    """Duty cycle from the engine's own step timing.

    The train loop calls :meth:`observe` with each step's device-phase and
    total wall seconds; ``sample`` reports
    ``100 · Σ device / Σ wall`` over a rolling window, applied to every chip
    of the (synchronous) local mesh. Readings expire after
    ``max_age_s`` so an idle engine stops claiming a duty cycle.

    On the port this is not the card's busy time: PyTorch dispatches
    eagerly, so the kernels run while the step is being dispatched and the
    device phase is only the wait after the last launch (0.2–6 % of a
    step of llama-1b's width at 2 layers on an H100). Where nvidia-smi answers, its utilization
    is the duty cycle the fleet reads.
    """

    name = "derived"

    def __init__(self, window: int = 50, max_age_s: float = 30.0):
        # Observations are kept PER DEVICE SCOPE (the frozenset of chip
        # ids a job's mesh drives; None = the whole host): two concurrent
        # jobs on disjoint chip subsets must not blend their step timings
        # into one meaningless ratio.
        self._scopes: dict[
            Optional[frozenset[int]], tuple[deque[tuple[float, float]], float]
        ] = {}
        self._window = window
        self._max_age_s = max_age_s
        self._lock = threading.Lock()
        # Staleness visibility: a dead telemetry source must be
        # distinguishable from a never-alive one — age of the newest
        # sample ever seen, plus how many scopes expired unread.
        self._last_observed_at: Optional[float] = None
        self.dropped_stale_total = 0

    def observe(
        self,
        device_s: float,
        wall_s: float,
        device_ids: Optional[Sequence[int]] = None,
    ) -> None:
        """Record one step. ``device_ids`` scopes the reading to the chips
        the step's mesh actually drives (None = every visible chip) — a
        4-chip job on an 8-chip host must not report the 4 idle chips as
        busy."""
        if wall_s <= 0:
            return
        key = (
            frozenset(int(i) for i in device_ids)
            if device_ids is not None
            else None
        )
        with self._lock:
            window, _ = self._scopes.get(key) or (deque(maxlen=self._window), 0.0)
            window.append((max(device_s, 0.0), wall_s))
            now = time.time()
            self._scopes[key] = (window, now)
            self._last_observed_at = now

    def reset(self) -> None:
        with self._lock:
            self._scopes.clear()
            self._last_observed_at = None
            self.dropped_stale_total = 0

    def staleness(self) -> dict[str, Any]:
        """Freshness surface: age of the newest sample (None = never fed),
        per-scope ages, and how many scopes were silently expired — the
        difference between "engine idle" and "telemetry wiring dead"."""
        now = time.time()
        with self._lock:
            scope_ages = {
                (
                    "host"
                    if key is None
                    else ",".join(str(i) for i in sorted(key))
                ): round(now - last, 3)
                for key, (_, last) in self._scopes.items()
            }
            return {
                "last_sample_age_s": (
                    round(now - self._last_observed_at, 3)
                    if self._last_observed_at is not None
                    else None
                ),
                "scope_ages_s": scope_ages,
                "scopes": len(scope_ages),
                "max_age_s": self._max_age_s,
                "dropped_stale_total": self.dropped_stale_total,
            }

    def sample(self, n_chips: int) -> Optional[TelemetrySnapshot]:
        now = time.time()
        duties: list[tuple[Optional[frozenset[int]], float]] = []
        with self._lock:
            for key, (window, last) in list(self._scopes.items()):
                if now - last > self._max_age_s:
                    del self._scopes[key]  # stale scope: job gone idle
                    self.dropped_stale_total += 1
                    continue
                device = sum(d for d, _ in window)
                wall = sum(w for _, w in window)
                if wall > 0:
                    duties.append(
                        (key, round(min(100.0 * device / wall, 100.0), 2))
                    )
        if not duties:
            return None
        chip_ids: list[Optional[int]] = list(range(n_chips))
        try:
            import torch

            if torch.cuda.is_available():
                n = torch.cuda.device_count()
                chip_ids = list(range(min(n, n_chips))) + [None] * max(0, n_chips - n)
        except Exception:
            pass
        per_chip: list[dict[str, Any]] = []
        for cid in chip_ids:
            entry: dict[str, Any] = {}
            # A scoped (per-job) reading beats the unscoped whole-host one.
            for key, duty in sorted(duties, key=lambda kv: kv[0] is None):
                if key is None or (cid is not None and cid in key):
                    entry = {"duty_cycle_pct": duty}
                    break
            per_chip.append(entry)
        return TelemetrySnapshot(
            source=self.name, sampled_at=now, per_chip=per_chip
        )


# ---------------------------------------------------------------------------
# Registry + merge
# ---------------------------------------------------------------------------


@dataclass
class TelemetryOverlay:
    """Priority-merged view across sources, ready to lay over the runtime
    device table."""

    per_chip: list[dict[str, Any]]
    ici_links: list[tuple[str, int]]
    sources: list[str]  # names that contributed, priority order


_derived = DerivedDutySource()
_sources: Optional[list[TelemetrySource]] = None
_sources_lock = threading.Lock()


def derived_duty() -> DerivedDutySource:
    """The process-wide derived-duty source the train loop feeds."""
    return _derived


def observe_step(
    device_s: float,
    wall_s: float,
    device_ids: Optional[Sequence[int]] = None,
) -> None:
    """Record one train step's (device seconds, wall seconds), optionally
    scoped to the device ids the step's mesh drives."""
    _derived.observe(device_s, wall_s, device_ids=device_ids)


# ---------------------------------------------------------------------------
# Per-chip job attribution
# ---------------------------------------------------------------------------
#
# The reference fleet view reports, per GPU, the live process table — pid,
# name, memory (``gpu_manager.py:27-33``, populated ``:174-184``) — so an
# operator can see WHAT occupies a device. TPU runtimes expose no foreign
# process table to this process, but this control plane *owns* its supervised jobs: each
# supervisor registers the chip ids its mesh drives on this host while the
# job runs, and the fleet snapshot lays the claims over the device table.

_claims: dict[str, "JobDeviceClaim"] = {}
_claims_lock = threading.Lock()


@dataclass
class JobDeviceClaim:
    """One running job's hold on a set of local chips."""

    job_id: str
    device_ids: frozenset[int]
    process_index: int
    # Live status read (e.g. ``lambda: job.status.value``) so the fleet
    # shows compiling/running without the registry chasing transitions.
    status_fn: Any


def register_job_devices(
    job_id: str,
    device_ids: Sequence[int],
    process_index: int,
    status_fn,
) -> None:
    """Claim ``device_ids`` for ``job_id`` until :func:`unregister_job_devices`."""
    with _claims_lock:
        _claims[job_id] = JobDeviceClaim(
            job_id=job_id,
            device_ids=frozenset(int(i) for i in device_ids),
            process_index=int(process_index),
            status_fn=status_fn,
        )


def unregister_job_devices(job_id: str) -> None:
    with _claims_lock:
        _claims.pop(job_id, None)


def job_attribution() -> dict[int, list[dict[str, Any]]]:
    """device id → jobs holding it, each ``{job_id, status, process_index}``."""
    with _claims_lock:
        claims = list(_claims.values())
    out: dict[int, list[dict[str, Any]]] = {}
    for c in claims:
        try:
            status = str(c.status_fn())
        except Exception:
            status = "unknown"
        ref = {
            "job_id": c.job_id,
            "status": status,
            "process_index": c.process_index,
        }
        for did in c.device_ids:
            out.setdefault(did, []).append(ref)
    return out


def sources() -> list[TelemetrySource]:
    global _sources
    with _sources_lock:
        if _sources is None:
            # Priority: nvidia-smi > engine-derived.
            _sources = [NvidiaSmiSource(), _derived]
        return list(_sources)


def set_sources(srcs: Optional[list[TelemetrySource]]) -> None:
    """Replace the registry (None restores the default stack). Test seam."""
    global _sources
    with _sources_lock:
        _sources = list(srcs) if srcs is not None else None


def sample_overlay(n_chips: int) -> Optional[TelemetryOverlay]:
    """Sample every registered source and merge per-chip fields,
    first-source-wins. None when no source has data."""
    merged: list[dict[str, Any]] = [{} for _ in range(n_chips)]
    links: list[tuple[str, int]] = []
    contributed: list[str] = []
    for src in sources():
        try:
            snap = src.sample(n_chips)
        except Exception:
            continue
        if snap is None:
            continue
        used = False
        for i, entry in enumerate(snap.per_chip[:n_chips]):
            for k, v in entry.items():
                if v is not None and k not in merged[i]:
                    merged[i][k] = v
                    used = True
        if snap.ici_links and not links:
            links = list(snap.ici_links)
            used = True
        if used:
            contributed.append(snap.source)
    if not contributed:
        return None
    return TelemetryOverlay(per_chip=merged, ici_links=links, sources=contributed)


def ici_link_alerts(links: Sequence[tuple[str, int]]) -> list[str]:
    """Fleet alert lines from ICI link scores (libtpu scale: 0 healthy,
    1-5 transient problem, 6-9 persistent minor problem, 10 unusable)."""
    alerts: list[str] = []
    for loc, score in links:
        if score >= 10:
            alerts.append(f"CRITICAL: ICI link {loc} unusable (score {score})")
        elif score >= 6:
            alerts.append(
                f"WARNING: persistent ICI problem on link {loc} (score {score})"
            )
        elif score >= 1:
            alerts.append(
                f"WARNING: transient ICI problem on link {loc} (score {score})"
            )
    return alerts
