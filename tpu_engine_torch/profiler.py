"""Profiling & tracing: per-step wall-clock breakdown, MFU accounting, and
on-demand ``torch.profiler`` trace capture (port of ``tpu_engine/profiler.py``).

The reference delegates all profiling to DeepSpeed config flags
(``wall_clock_breakdown``, ``dump_state`` — ``ai_engine/deepspeed_launcher.py:79-80,
129-130``) and carries throughput as a passive, never-analysed field
(``ai_engine/loss_monitor.py:50``). Here the engine owns the numbers
(SURVEY.md §5 tracing plan):

- :class:`StepProfiler` — the in-loop wall-clock breakdown: data-wait,
  device-step, host-sync and monitor overhead per step, with rolling
  mean/p50/p95 summaries (bounded window — no unbounded growth);
- :func:`mfu` / :func:`peak_flops_per_chip` — tokens/sec/chip → model-FLOPs
  utilisation against the card's bf16 peak, read from
  ``torch.cuda.get_device_name`` (:data:`PEAK_FLOPS_BF16` is the one table
  of peaks the port, ``chip_smoke.py`` and ``bench_torch.py`` read);
- :class:`TraceSession` — start/stop a ``torch.profiler`` capture (CPU and,
  on a card, CUDA activity), written as a Chrome trace into its
  ``log_dir``, with an optional auto-stop duration, safe to drive from the
  HTTP control plane.
"""

from __future__ import annotations

import statistics
import threading
import os
import time
from collections import deque
from typing import Any, Optional

import torch

# Peak dense bf16 FLOP/s per chip by device kind (public spec sheets): the
# TPU generations of JAX's table and the H100 SXM (NVIDIA data sheet).
PEAK_FLOPS_BF16 = {
    "h100": 989e12,
    "v4": 275e12,
    "v5 lite": 197e12,
    "v5e": 197e12,
    "v5p": 459e12,
    "v6 lite": 918e12,
    "v6e": 918e12,
    "trillium": 918e12,
}


def device_kind(device=None) -> str:
    """The name of ``device`` (a CUDA index or ``torch.device``; default the
    first card) as ``torch.cuda.get_device_name`` gives it; "" on the CPU
    or where no card is visible."""
    if isinstance(device, torch.device):
        if device.type != "cuda":
            return ""
        device = device.index
    if not torch.cuda.is_available():
        return ""
    return torch.cuda.get_device_name(device or 0)


def peak_flops_for_kind(kind: str) -> Optional[float]:
    """Peak bf16 FLOP/s of a device kind (matched case-insensitively by
    substring), or None when :data:`PEAK_FLOPS_BF16` lacks it."""
    kind = kind.lower()
    for key, flops in PEAK_FLOPS_BF16.items():
        if key in kind:
            return flops
    return None


def peak_flops_per_chip(device=None) -> Optional[float]:
    """Peak bf16 FLOP/s for ``device`` (default: the first card), or None if
    the card isn't recognised or there is none (CPU test runs)."""
    return peak_flops_for_kind(device_kind(device))


def mfu(
    flops_per_token: float,
    tokens_per_sec_per_chip: float,
    device=None,
) -> Optional[float]:
    """Model-FLOPs utilisation in [0, 1], or None off known chips.

    Uses *model* FLOPs (6N + attention), not hardware FLOPs: remat recompute
    is deliberately not credited, matching the standard MFU definition.

    Accounting basis under int8 quantized training (``quant_training=
    'int8'``, tpu_engine_torch/quant_train.py): the numerator stays MODEL FLOPs
    and the denominator stays the chip's BF16 peak — quantization changes
    neither the model nor this definition. What it changes is the
    ACHIEVABLE roofline: int8×int8→int32 tensor-core throughput is up to 2× the
    bf16 rate, so a quantized run can legitimately report >100%
    "bf16-MFU" on matmul-bound configs. Compare quantized runs by
    step time / tokens-per-sec, and read their MFU as a fraction of the
    bf16 roofline, not of the hardware's int8 ceiling.
    """
    peak = peak_flops_per_chip(device)
    if peak is None or tokens_per_sec_per_chip <= 0:
        return None
    return flops_per_token * tokens_per_sec_per_chip / peak


def pipeline_tick_account(
    schedule: str, n_stages: int, microbatches: int
) -> Optional[dict[str, Any]]:
    """Analytic tick / busy-lane account for a pipelined run, or None off
    the pipelined path (``n_stages <= 1``).

    Thin re-export of ``tpu_engine_torch.parallel.pipeline_zb.schedule_account``
    so profiler consumers (supervisor telemetry, bench.py) don't import the
    schedule module directly. ``busy_fraction`` is useful lane F-units over
    total lane F-units — see the schedule module for the cost model.
    """
    if n_stages <= 1:
        return None
    from tpu_engine_torch.parallel.pipeline_zb import schedule_account

    return schedule_account(schedule, n_stages, microbatches)


class StepProfiler:
    """Rolling wall-clock breakdown of the train loop's phases.

    Phases (per step): ``data`` (batch fetch / host pipeline), ``dispatch``
    (the step's Python and its async enqueue of kernels), ``device`` (device
    execution + metric transfer — CUDA launches are async, so the wall-clock
    cost of the step lands in the blocking device→host read), ``other``
    (monitor, checkpoint bookkeeping). All in seconds.
    """

    PHASES = ("data", "dispatch", "device", "other")

    def __init__(self, window: int = 100, tokens_per_step: Optional[int] = None,
                 flops_per_token: Optional[float] = None, n_devices: int = 1,
                 pipeline_account: Optional[dict[str, Any]] = None):
        self.window = window
        self.tokens_per_step = tokens_per_step
        self.flops_per_token = flops_per_token
        self.n_devices = max(n_devices, 1)
        # Analytic schedule account for pipelined runs (from
        # pipeline_tick_account): enables bubble-adjusted MFU — raw MFU
        # divided by the schedule's busy-lane fraction, i.e. utilisation of
        # the lanes the schedule actually keeps busy. Without it a report
        # under-reports pipelined MFU: the bubble is a schedule property,
        # not a kernel-efficiency loss.
        self.pipeline_account = pipeline_account
        self._phases: dict[str, deque[float]] = {p: deque(maxlen=window) for p in self.PHASES}
        self._totals: deque[float] = deque(maxlen=window)
        self._steps_seen = 0
        self._lock = threading.Lock()
        self._t_phase: Optional[float] = None
        self._t_step_start: Optional[float] = None
        self._current: dict[str, float] = {}

    # -- recording ----------------------------------------------------------

    def begin_step(self) -> None:
        now = time.perf_counter()
        self._t_step_start = now
        self._t_phase = now
        self._current = {}

    def mark(self, phase: str) -> None:
        """Close the currently-running phase as ``phase``."""
        now = time.perf_counter()
        if self._t_phase is not None:
            self._current[phase] = self._current.get(phase, 0.0) + (now - self._t_phase)
        self._t_phase = now

    def end_step(self) -> float:
        """Close the step; un-attributed time lands in ``other``. Returns
        total step wall-clock seconds."""
        now = time.perf_counter()
        total = (now - self._t_step_start) if self._t_step_start is not None else 0.0
        attributed = sum(self._current.values())
        self._current["other"] = self._current.get("other", 0.0) + max(total - attributed, 0.0)
        with self._lock:
            for p in self.PHASES:
                self._phases[p].append(self._current.get(p, 0.0))
            self._totals.append(total)
            self._steps_seen += 1
        self._t_phase = None
        self._t_step_start = None
        return total

    def last_step_phases(self) -> dict[str, float]:
        """Phase seconds of the most recently ended step (empty before any).
        Feeds the derived duty-cycle telemetry source."""
        return dict(self._current)

    # -- views --------------------------------------------------------------

    @staticmethod
    def _stats(xs: list[float]) -> dict[str, float]:
        if not xs:
            return {"mean_ms": 0.0, "p50_ms": 0.0, "p95_ms": 0.0}
        xs_sorted = sorted(xs)
        p95 = xs_sorted[min(int(0.95 * (len(xs_sorted) - 1)), len(xs_sorted) - 1)]
        return {
            "mean_ms": statistics.fmean(xs) * 1e3,
            "p50_ms": statistics.median(xs_sorted) * 1e3,
            "p95_ms": p95 * 1e3,
        }

    def summary(self) -> dict[str, Any]:
        with self._lock:
            totals = list(self._totals)
            phases = {p: list(v) for p, v in self._phases.items()}
            steps_seen = self._steps_seen
        out: dict[str, Any] = {
            "steps_seen": steps_seen,
            "window": len(totals),
            "total": self._stats(totals),
            "phases": {p: self._stats(v) for p, v in phases.items()},
        }
        mean_total = statistics.fmean(totals) if totals else 0.0
        if totals and mean_total > 0:
            for p, v in phases.items():
                out["phases"][p]["fraction"] = round(statistics.fmean(v) / mean_total, 4)
        if self.tokens_per_step and mean_total > 0:
            tps = self.tokens_per_step / mean_total
            out["tokens_per_sec"] = round(tps, 1)
            out["tokens_per_sec_per_chip"] = round(tps / self.n_devices, 1)
            if self.flops_per_token:
                u = mfu(self.flops_per_token, tps / self.n_devices)
                out["mfu"] = round(u, 4) if u is not None else None
        if self.pipeline_account is not None:
            acct = self.pipeline_account
            busy = acct.get("busy_fraction", 1.0) or 1.0
            out["pipeline"] = {
                "schedule": acct.get("schedule"),
                "n_stages": acct.get("n_stages"),
                "microbatches": acct.get("microbatches"),
                "ticks": acct.get("ticks"),
                "busy_fraction": round(busy, 4),
                "bubble_fraction": round(acct.get("bubble_fraction", 0.0), 4),
            }
            if out.get("mfu") is not None:
                out["mfu_bubble_adjusted"] = round(out["mfu"] / busy, 4)
        return out


class TraceActiveError(RuntimeError):
    """Raised on double-start; carries the active capture's coordinates so
    callers (the ``/api/v1/profile/start`` route, the anomaly auto-trace
    hook) can report a structured conflict instead of a bare string."""

    def __init__(self, log_dir: str, started_at: float):
        self.log_dir = log_dir
        self.started_at = started_at
        super().__init__(f"trace already active (dir={log_dir})")

    def describe(self) -> dict[str, Any]:
        return {
            "log_dir": self.log_dir,
            "started_at": self.started_at,
            "elapsed_s": round(time.time() - self.started_at, 3),
        }


class TraceSession:
    """On-demand ``torch.profiler`` trace capture (one at a time per process).

    Writes a Chrome trace (``trace_<pid>_<ms>.json``) into ``log_dir`` at
    stop, viewable in Perfetto or ``chrome://tracing``; CUDA activity (the
    kernels) is captured where a card is visible. Drive from code or the
    ``/api/v1/profile`` routes.

    Where a card is visible, a capture is started and stopped on the main
    thread only, and ``duration_s`` (whose stop would come from a timer
    thread) is refused: one run that drove a capture from a training job's
    thread ended in an illegal memory access whose cause is not found.
    """

    def __init__(self):
        # RLock: start() reports via status() while still holding the lock.
        self._lock = threading.RLock()
        self._active_dir: Optional[str] = None
        self._started_at: Optional[float] = None
        self._auto_timer: Optional[threading.Timer] = None
        self._prof: Optional[torch.profiler.profile] = None

    @property
    def active(self) -> bool:
        return self._active_dir is not None

    @staticmethod
    def _check_thread(duration_s: Optional[float] = None) -> None:
        if not torch.cuda.is_available():
            return
        if threading.current_thread() is not threading.main_thread():
            raise RuntimeError("a trace capture of the card is started and stopped on the "
                               "main thread only, not on thread "
                               f"{threading.current_thread().name!r}")
        if duration_s is not None and duration_s > 0:
            raise RuntimeError("a timed trace capture of the card is refused: its stop "
                               "would run on a timer thread; call stop() on the main thread")

    def start(self, log_dir: str, duration_s: Optional[float] = None) -> dict[str, Any]:
        self._check_thread(duration_s)
        with self._lock:
            if self._active_dir is not None:
                raise TraceActiveError(
                    self._active_dir, self._started_at or time.time()
                )
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            os.makedirs(log_dir, exist_ok=True)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
            self._active_dir = log_dir
            self._started_at = time.time()
            if duration_s is not None and duration_s > 0:
                self._auto_timer = threading.Timer(duration_s, self._auto_stop)
                self._auto_timer.daemon = True
                self._auto_timer.start()
            return self.status()

    def _auto_stop(self) -> None:
        try:
            self.stop()
        except Exception:
            pass

    def stop(self) -> dict[str, Any]:
        with self._lock:
            if self._active_dir is None:
                raise RuntimeError("no active trace")
            self._check_thread()
            if self._auto_timer is not None:
                self._auto_timer.cancel()
                self._auto_timer = None
            self._prof.stop()
            self._prof.export_chrome_trace(os.path.join(
                self._active_dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))
            self._prof = None
            info = {
                "log_dir": self._active_dir,
                "duration_s": round(time.time() - (self._started_at or time.time()), 3),
                "active": False,
            }
            self._active_dir = None
            self._started_at = None
            return info

    def status(self) -> dict[str, Any]:
        with self._lock:
            if self._active_dir is None:
                return {"active": False}
            return {
                "active": True,
                "log_dir": self._active_dir,
                "elapsed_s": round(time.time() - (self._started_at or time.time()), 3),
            }
