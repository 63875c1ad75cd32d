"""The H100 fleet manager: telemetry and health (port of
``tpu_engine/tpu_manager.py``, whose file and class names it keeps so that
the supervisor's and the backend's imports find them).

Capability parity with the reference's GPU fleet manager
(``ai_engine/gpu_manager.py``): device table, health classification with
warning/critical thresholds, fleet aggregation + alert rollup, best-device
selection, a mock fleet for tests, and injectable raw telemetry. The live
device table comes from ``torch.cuda`` (``mem_get_info`` for memory in use
on the card, ``get_device_properties`` for its name), with GPU utilization
(the duty cycle), temperature, power draw and limit and the clock throttle
score laid over from the telemetry stack (``tpu_engine_torch.telemetry``:
``nvidia-smi`` + engine-derived duty cycle). Health thresholds mirror the
reference's semantics (``gpu_manager.py:92-98``): temp 80/90 °C, memory
85/95 %, utilization 95 %, power 0.9× limit — plus the throttle-score
thresholds (the hardware's own thermal/power-protection signal).
"""

from __future__ import annotations

import json
import time
from enum import Enum
from typing import Any, Optional, Sequence

import torch
from pydantic import BaseModel, Field

# Default HBM per chip when the runtime doesn't report a limit (GiB).
_DEFAULT_HBM_GIB = {
    "NVIDIA H100 80GB HBM3": 80.0,
    "NVIDIA H100": 80.0,
    "TPU v4": 32.0,
    "TPU v5 lite": 16.0,
    "TPU v5e": 16.0,
    "TPU v5": 16.0,
    "TPU v5p": 95.0,
    "TPU v6 lite": 32.0,
    "TPU v6e": 32.0,
}


class TPUHealthStatus(str, Enum):
    """Mirrors reference ``GPUHealthStatus`` (``gpu_manager.py:20-25``)."""

    HEALTHY = "healthy"
    WARNING = "warning"
    CRITICAL = "critical"
    UNKNOWN = "unknown"


class TPUJobRef(BaseModel):
    """A supervised job holding this chip — the TPU analogue of the
    reference's per-GPU process table (``gpu_manager.py:27-33``, populated
    ``:174-184``). The entries are the control plane's OWN jobs, registered
    by their supervisors (``tpu_engine_torch.telemetry.register_job_devices``);
    FOREIGN holders are surfaced separately via :class:`TPUProcessRef`."""

    job_id: str
    status: str
    process_index: int = 0


class TPUProcessRef(BaseModel):
    """An OS process holding this chip — including ones this control plane
    never launched. Reference parity: ``GPUProcess`` (``gpu_manager.py:
    27-33``: pid, name, memory). Kept for the schema; no live source of the
    port fills it yet. ``foreign`` is True when the pid is not this
    control-plane process — a chip held by a job nobody here supervises."""

    pid: int
    name: Optional[str] = None
    foreign: bool = False


class TPUDevice(BaseModel):
    """One card (JAX's TPU chip/core). Reference analogue: ``GPUDevice``
    (``gpu_manager.py:35-62``). ``coords`` and ``core_on_chip`` are TPU-only
    and stay None on a card."""

    index: int
    name: str = "TPU"
    device_kind: str = "unknown"
    platform: str = "tpu"
    process_index: int = 0
    coords: Optional[tuple[int, ...]] = None
    core_on_chip: Optional[int] = None

    hbm_total_gb: float = 0.0
    hbm_used_gb: float = 0.0
    hbm_utilization_pct: float = 0.0

    duty_cycle_pct: Optional[float] = None  # % of time the chip was executing
    tensorcore_util_pct: Optional[float] = None  # MXU utilization (per-core mean)
    # Throttle score: 0 = not throttled, 1-10 = throttled by 10-100% (on a
    # card, from nvidia-smi's clock throttle reasons:
    # ``telemetry.throttle_score``).
    throttle_score: Optional[int] = None
    # On the live path from nvidia-smi (null where it is absent); injected
    # snapshots (``metrics=``/``parse_metrics_json``) and the mock fleet set
    # them directly.
    temperature_c: Optional[float] = None
    power_draw_w: Optional[float] = None
    power_limit_w: Optional[float] = None

    health_status: TPUHealthStatus = TPUHealthStatus.UNKNOWN
    alerts: list[str] = Field(default_factory=list)
    # Supervised jobs whose mesh holds this chip (live snapshots only;
    # injected/mock fleets have no job registry to consult).
    jobs: list[TPUJobRef] = Field(default_factory=list)
    # OS processes holding the chip, including FOREIGN holders the control
    # plane didn't launch (reference ``gpu_manager.py:174-184``).
    processes: list[TPUProcessRef] = Field(default_factory=list)

    @property
    def hbm_free_gb(self) -> float:
        return max(self.hbm_total_gb - self.hbm_used_gb, 0.0)

    @property
    def is_available(self) -> bool:
        """Schedulable: <80% HBM used, duty cycle <90% (if known), not critical.

        Same semantics as reference ``GPUDevice.is_available``
        (``gpu_manager.py:57-62`` — the code, not its stale docstring; see
        SURVEY.md §5 quirks).
        """
        if self.health_status == TPUHealthStatus.CRITICAL:
            return False
        if self.hbm_utilization_pct >= 80.0:
            return False
        if self.duty_cycle_pct is not None and self.duty_cycle_pct >= 90.0:
            return False
        return True


class TPUFleetStatus(BaseModel):
    """Fleet aggregate. Reference analogue: ``GPUFleetStatus`` (``gpu_manager.py:65-77``)."""

    timestamp: float = Field(default_factory=time.time)
    total_devices: int = 0
    available_devices: int = 0
    total_hbm_gb: float = 0.0
    used_hbm_gb: float = 0.0
    average_duty_cycle_pct: Optional[float] = None
    average_temperature_c: Optional[float] = None
    devices: list[TPUDevice] = Field(default_factory=list)
    fleet_alerts: list[str] = Field(default_factory=list)
    # Live telemetry sources that contributed to this snapshot, priority
    # order (e.g. ["nvidia_smi", "derived"]); empty for injected/mock fleets.
    telemetry_sources: list[str] = Field(default_factory=list)
    # (location, score) per ICI link (TPU-only: empty on a card).
    ici_links: list[tuple[str, int]] = Field(default_factory=list)
    # Derived-duty freshness (tpu_engine_torch.telemetry.DerivedDutySource
    # .staleness()): last-sample age + silently-expired scope count, so a
    # dead telemetry feed is visible instead of quietly UNKNOWN.
    telemetry_staleness: Optional[dict[str, Any]] = None


class TPUManager:
    """Fleet manager over the CUDA runtime (reference ``GPUManager``,
    ``gpu_manager.py:80``).

    Telemetry sources, in priority order:

    1. injected snapshot (``metrics=`` argument or :meth:`parse_metrics_json`)
       — the test seam, parity with ``parse_xml(xml_str=...)`` /
       ``parse_csv(csv_str=...)`` (``gpu_manager.py:119-130,219-232``);
    2. the live runtime: ``devices`` (torch devices; default every visible
       card), each read by ``torch.cuda``. With no card and no ``devices``
       the live path raises, naming what is missing (``get_fleet_status``
       reports it as a fleet alert, as JAX's does an unavailable runtime).
       A CPU device (a job run with ``device="cpu"``) is a device with no
       HBM, as JAX's CPU devices are.
    """

    # Health thresholds — reference ``gpu_manager.py:92-98``.
    TEMP_WARNING_C = 80.0
    TEMP_CRITICAL_C = 90.0
    HBM_WARNING_PCT = 85.0
    HBM_CRITICAL_PCT = 95.0
    DUTY_WARNING_PCT = 95.0
    POWER_WARNING_RATIO = 0.9
    # Throttle score (0-10): >=1 warning, >=6 critical (throttled by 60%+ —
    # the chip is protecting itself; treat like a temp-critical GPU).
    THROTTLE_CRITICAL_SCORE = 6

    def __init__(self, devices: Optional[Sequence[Any]] = None):
        self._devices = devices  # None = every visible card, resolved lazily

    # -- telemetry ingestion -------------------------------------------------

    def _runtime_devices(self) -> list[torch.device]:
        if self._devices is not None:
            return [torch.device(d) if not isinstance(d, int) else torch.device("cuda", d)
                    for d in self._devices]
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device visible (torch.cuda.is_available() is False) "
                               "and no devices or metrics given")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]

    @staticmethod
    def _device_id(i: int, d: torch.device) -> int:
        """The id job claims use for ``d``: its CUDA index, else its
        position."""
        return d.index if d.type == "cuda" and d.index is not None else i

    def _device_from_runtime(self, i: int, d: torch.device) -> TPUDevice:
        kind, platform = "cpu", "cpu"
        hbm_total = hbm_used = 0.0
        if d.type == "cuda":
            idx = self._device_id(i, d)
            kind, platform = torch.cuda.get_device_properties(idx).name, "gpu"
            try:
                free, total = torch.cuda.mem_get_info(idx)
                hbm_total, hbm_used = total / 2**30, (total - free) / 2**30
            except Exception:
                pass
        if hbm_total <= 0.0:
            # Longest prefix wins: "TPU v5p" must not fall into "TPU v5"'s bucket.
            for prefix in sorted(_DEFAULT_HBM_GIB, key=len, reverse=True):
                if kind.startswith(prefix):
                    hbm_total = _DEFAULT_HBM_GIB[prefix]
                    break
        util = (hbm_used / hbm_total * 100.0) if hbm_total > 0 else 0.0
        rank = (torch.distributed.get_rank() if torch.distributed.is_available()
                and torch.distributed.is_initialized() else 0)
        dev = TPUDevice(
            index=i,
            name=f"{kind} #{self._device_id(i, d)}",
            device_kind=kind,
            platform=platform,
            process_index=rank,
            hbm_total_gb=round(hbm_total, 3),
            hbm_used_gb=round(hbm_used, 3),
            hbm_utilization_pct=round(util, 2),
        )
        self._assess_health(dev)
        return dev

    def parse_metrics(self, metrics: Sequence[dict[str, Any]]) -> list[TPUDevice]:
        """Build the device table from an injected telemetry snapshot.

        Each entry may carry: index, device_kind, hbm_total_gb, hbm_used_gb,
        duty_cycle_pct, temperature_c, power_draw_w, power_limit_w, coords,
        process_index. Unknown keys are ignored.
        """
        out: list[TPUDevice] = []
        for i, m in enumerate(metrics):
            total = float(m.get("hbm_total_gb", 0.0))
            used = float(m.get("hbm_used_gb", 0.0))
            util = m.get("hbm_utilization_pct")
            if util is None:
                util = (used / total * 100.0) if total > 0 else 0.0
            dev = TPUDevice(
                index=int(m.get("index", i)),
                name=m.get("name", f"{m.get('device_kind', 'TPU')} #{m.get('index', i)}"),
                device_kind=m.get("device_kind", "unknown"),
                platform=m.get("platform", "tpu"),
                process_index=int(m.get("process_index", 0)),
                coords=tuple(m["coords"]) if m.get("coords") is not None else None,
                core_on_chip=m.get("core_on_chip"),
                hbm_total_gb=total,
                hbm_used_gb=used,
                hbm_utilization_pct=round(float(util), 2),
                duty_cycle_pct=m.get("duty_cycle_pct"),
                tensorcore_util_pct=m.get("tensorcore_util_pct"),
                throttle_score=m.get("throttle_score"),
                temperature_c=m.get("temperature_c"),
                power_draw_w=m.get("power_draw_w"),
                power_limit_w=m.get("power_limit_w"),
            )
            self._assess_health(dev)
            out.append(dev)
        return out

    def parse_metrics_json(self, raw: str) -> list[TPUDevice]:
        """Injectable raw-telemetry seam: JSON list of per-chip metric dicts
        (the analogue of canned nvidia-smi XML/CSV)."""
        data = json.loads(raw)
        if isinstance(data, dict):
            data = data.get("devices", [])
        return self.parse_metrics(data)

    # -- health --------------------------------------------------------------

    @staticmethod
    def _sanitize_telemetry(dev: TPUDevice) -> list[str]:
        """Discard non-finite (NaN/inf) telemetry before classification.

        Corrupt telemetry (a flaky collector, or an injected `telemetry-nan`
        fault) must not poison the fleet aggregates — a single NaN
        ``hbm_used_gb`` would turn the fleet-wide HBM sums NaN and wreck the
        scheduler's admission math. Optional fields revert to None (unknown),
        HBM fields to 0.0; the affected field names are returned so the
        caller can alert on them.
        """
        import math

        def bad(v: Any) -> bool:
            return isinstance(v, float) and not math.isfinite(v)

        dropped: list[str] = []
        for field in (
            "duty_cycle_pct",
            "tensorcore_util_pct",
            "temperature_c",
            "power_draw_w",
            "power_limit_w",
        ):
            if bad(getattr(dev, field)):
                setattr(dev, field, None)
                dropped.append(field)
        for field in ("hbm_total_gb", "hbm_used_gb", "hbm_utilization_pct"):
            if bad(getattr(dev, field)):
                setattr(dev, field, 0.0)
                dropped.append(field)
        if "hbm_used_gb" in dropped or "hbm_total_gb" in dropped:
            dev.hbm_utilization_pct = (
                round(dev.hbm_used_gb / dev.hbm_total_gb * 100.0, 2)
                if dev.hbm_total_gb > 0
                else 0.0
            )
        return dropped

    def _assess_health(self, dev: TPUDevice) -> None:
        """Classify health; mirrors reference ``_assess_health`` (``gpu_manager.py:348-379``)."""
        dropped = self._sanitize_telemetry(dev)
        alerts: list[str] = []
        status = TPUHealthStatus.HEALTHY

        if dev.temperature_c is not None:
            if dev.temperature_c >= self.TEMP_CRITICAL_C:
                alerts.append(f"CRITICAL: temperature {dev.temperature_c:.0f}C >= {self.TEMP_CRITICAL_C:.0f}C")
                status = TPUHealthStatus.CRITICAL
            elif dev.temperature_c >= self.TEMP_WARNING_C:
                alerts.append(f"WARNING: temperature {dev.temperature_c:.0f}C >= {self.TEMP_WARNING_C:.0f}C")
                status = TPUHealthStatus.WARNING

        if dev.hbm_total_gb > 0:
            if dev.hbm_utilization_pct >= self.HBM_CRITICAL_PCT:
                alerts.append(f"CRITICAL: HBM {dev.hbm_utilization_pct:.1f}% >= {self.HBM_CRITICAL_PCT:.0f}%")
                status = TPUHealthStatus.CRITICAL
            elif dev.hbm_utilization_pct >= self.HBM_WARNING_PCT:
                alerts.append(f"WARNING: HBM {dev.hbm_utilization_pct:.1f}% >= {self.HBM_WARNING_PCT:.0f}%")
                if status != TPUHealthStatus.CRITICAL:
                    status = TPUHealthStatus.WARNING

        if dev.duty_cycle_pct is not None and dev.duty_cycle_pct >= self.DUTY_WARNING_PCT:
            alerts.append(f"WARNING: duty cycle {dev.duty_cycle_pct:.1f}% >= {self.DUTY_WARNING_PCT:.0f}%")
            if status == TPUHealthStatus.HEALTHY:
                status = TPUHealthStatus.WARNING

        if dev.throttle_score is not None and dev.throttle_score >= 1:
            # The chip's own thermal/power protection kicking in, beside the
            # reference's temperature/power alerts.
            if dev.throttle_score >= self.THROTTLE_CRITICAL_SCORE:
                alerts.append(
                    f"CRITICAL: throttled by {dev.throttle_score * 10}% "
                    f"(score {dev.throttle_score}/10)"
                )
                status = TPUHealthStatus.CRITICAL
            else:
                alerts.append(
                    f"WARNING: throttled by {dev.throttle_score * 10}% "
                    f"(score {dev.throttle_score}/10)"
                )
                if status == TPUHealthStatus.HEALTHY:
                    status = TPUHealthStatus.WARNING

        if (
            dev.power_draw_w is not None
            and dev.power_limit_w is not None
            and dev.power_limit_w > 0
            and dev.power_draw_w >= self.POWER_WARNING_RATIO * dev.power_limit_w
        ):
            alerts.append(
                f"WARNING: power draw {dev.power_draw_w:.0f}W >= "
                f"{self.POWER_WARNING_RATIO:.0%} of limit {dev.power_limit_w:.0f}W"
            )
            if status == TPUHealthStatus.HEALTHY:
                status = TPUHealthStatus.WARNING

        if dropped:
            alerts.append(
                "WARNING: non-finite telemetry discarded for " + ", ".join(dropped)
            )
            # A chip whose telemetry is corrupt is not *known* healthy —
            # but it's not known bad either, so it stays schedulable
            # (is_available treats UNKNOWN as eligible) while the alert flags it.
            if status == TPUHealthStatus.HEALTHY:
                status = TPUHealthStatus.UNKNOWN

        dev.alerts = alerts
        dev.health_status = status

    def _apply_fault_overlay(self, devices: list[TPUDevice], injector: Any) -> None:
        """Lay active injected chip faults over a fleet snapshot.

        `chip-unhealthy` forces CRITICAL (the chip drops out of
        ``is_available`` and the scheduler's eligible set); `telemetry-nan`
        poisons the chip's metrics with NaN and re-assesses, which drives
        the exact sanitization path corrupt real telemetry would.
        """
        overlay = injector.chip_overlay()
        if not overlay:
            return
        from tpu_engine_torch.faults import FaultKind

        by_index = {d.index: d for d in devices}
        for idx, kind in overlay.items():
            dev = by_index.get(idx)
            if dev is None:
                continue
            if kind is FaultKind.TELEMETRY_NAN:
                dev.duty_cycle_pct = float("nan")
                dev.hbm_used_gb = float("nan")
                self._assess_health(dev)
            elif kind is FaultKind.CHIP_UNHEALTHY:
                self._assess_health(dev)
                dev.alerts = [*dev.alerts, "CRITICAL: injected fault: chip-unhealthy"]
                dev.health_status = TPUHealthStatus.CRITICAL

    # -- fleet ---------------------------------------------------------------

    def get_fleet_status(
        self,
        metrics: Optional[Sequence[dict[str, Any]]] = None,
        metrics_json: Optional[str] = None,
    ) -> TPUFleetStatus:
        """Aggregate fleet view (reference ``get_fleet_status``, ``gpu_manager.py:275-321``)."""
        telemetry_sources: list[str] = []
        ici_links: list[tuple[str, int]] = []
        if metrics_json is not None:
            devices = self.parse_metrics_json(metrics_json)
        elif metrics is not None:
            devices = self.parse_metrics(metrics)
        else:
            try:
                runtime_devs = self._runtime_devices()
                devices = [
                    self._device_from_runtime(i, d) for i, d in enumerate(runtime_devs)
                ]
            except Exception as e:  # runtime unavailable
                return TPUFleetStatus(
                    fleet_alerts=[f"CUDA runtime unavailable: {type(e).__name__}: {e}"]
                )
            # Live path: lay the telemetry-source overlay (nvidia-smi,
            # engine-derived duty cycle — tpu_engine_torch.telemetry) over
            # the runtime's memory view, then re-classify health with the
            # merged fields. This is what makes duty/throttle/temperature
            # alerts fire in production, not just on injected snapshots.
            from tpu_engine_torch import telemetry

            overlay = telemetry.sample_overlay(len(devices))
            if overlay is not None:
                telemetry_sources = overlay.sources
                ici_links = overlay.ici_links
                for dev, extra in zip(devices, overlay.per_chip):
                    for key in (
                        "duty_cycle_pct",
                        "tensorcore_util_pct",
                        "throttle_score",
                        "temperature_c",
                        "power_draw_w",
                        "power_limit_w",
                    ):
                        if getattr(dev, key) is None and extra.get(key) is not None:
                            setattr(dev, key, extra[key])
                    # HBM: the runtime's view is exact for the card;
                    # nvidia-smi fills in only when it gave nothing.
                    if dev.hbm_used_gb == 0.0 and extra.get("hbm_used_gb"):
                        dev.hbm_used_gb = extra["hbm_used_gb"]
                        if extra.get("hbm_total_gb"):
                            dev.hbm_total_gb = extra["hbm_total_gb"]
                        if dev.hbm_total_gb > 0:
                            dev.hbm_utilization_pct = round(
                                dev.hbm_used_gb / dev.hbm_total_gb * 100.0, 2
                            )
                    self._assess_health(dev)

            # Per-chip job attribution: lay the supervised-job claims
            # (tpu_engine_torch.telemetry.register_job_devices) over the
            # device table, matched by runtime device id — the answer to the
            # reference's per-GPU process table (``gpu_manager.py:174-184``).
            attribution = telemetry.job_attribution()
            if attribution:
                for i, (dev, d) in enumerate(zip(devices, runtime_devs)):
                    refs = attribution.get(self._device_id(i, d))
                    if refs:
                        dev.jobs = [TPUJobRef(**r) for r in refs]

        # Fault-injection overlay (tpu_engine_torch.faults): applied to EVERY
        # snapshot path — injected, mock, and live — so the chaos harness
        # exercises the same detection pipeline real degradation would.
        from tpu_engine_torch import faults as faults_mod

        injector = faults_mod.get_active()
        if injector is not None:
            self._apply_fault_overlay(devices, injector)

        fleet_alerts: list[str] = []
        if ici_links:
            from tpu_engine_torch import telemetry

            fleet_alerts.extend(telemetry.ici_link_alerts(ici_links))
        for dev in devices:
            for a in dev.alerts:
                fleet_alerts.append(f"chip {dev.index}: {a}")

        duty = [d.duty_cycle_pct for d in devices if d.duty_cycle_pct is not None]
        temps = [d.temperature_c for d in devices if d.temperature_c is not None]
        available = sum(1 for d in devices if d.is_available)
        if devices and available == 0:
            fleet_alerts.append("No TPU devices available for new work")
        if not devices:
            fleet_alerts.append("No TPU devices detected")

        from tpu_engine_torch import telemetry as telemetry_mod

        try:
            staleness = telemetry_mod.derived_duty().staleness()
        except Exception:
            staleness = None

        return TPUFleetStatus(
            total_devices=len(devices),
            available_devices=available,
            total_hbm_gb=round(sum(d.hbm_total_gb for d in devices), 3),
            used_hbm_gb=round(sum(d.hbm_used_gb for d in devices), 3),
            average_duty_cycle_pct=round(sum(duty) / len(duty), 2) if duty else None,
            average_temperature_c=round(sum(temps) / len(temps), 2) if temps else None,
            devices=devices,
            fleet_alerts=fleet_alerts,
            telemetry_sources=telemetry_sources,
            ici_links=ici_links,
            telemetry_staleness=staleness,
        )

    def select_best_device(
        self,
        min_free_hbm_gb: float = 0.0,
        metrics: Optional[Sequence[dict[str, Any]]] = None,
        metrics_json: Optional[str] = None,
    ) -> Optional[TPUDevice]:
        """Pick the least-loaded schedulable chip.

        Reference ``select_best_gpu`` (``gpu_manager.py:323-346``): filter by
        availability + free-memory requirement, sort by (−free HBM, duty).
        """
        fleet = self.get_fleet_status(metrics=metrics, metrics_json=metrics_json)
        return self.select_from_fleet(fleet, min_free_hbm_gb=min_free_hbm_gb)

    @staticmethod
    def select_from_fleet(
        fleet: TPUFleetStatus, min_free_hbm_gb: float = 0.0
    ) -> Optional[TPUDevice]:
        """The selection policy, shared by live and mock/fallback paths."""
        candidates = [
            d for d in fleet.devices if d.is_available and d.hbm_free_gb >= min_free_hbm_gb
        ]
        if not candidates:
            return None
        candidates.sort(key=lambda d: (-d.hbm_free_gb, d.duty_cycle_pct or 0.0))
        return candidates[0]

    # -- fixtures ------------------------------------------------------------

    @staticmethod
    def get_mock_fleet() -> TPUFleetStatus:
        """Hand-built v5e-8 fleet: 7 healthy chips + 1 warning chip.

        Test/demo fixture, parity with reference ``get_mock_fleet``
        (``gpu_manager.py:400-431``).
        """
        mgr = TPUManager(devices=[])
        metrics = []
        for i in range(8):
            hot = i == 5
            metrics.append(
                {
                    "index": i,
                    "device_kind": "TPU v5e",
                    "platform": "tpu",
                    "coords": (i % 4, i // 4, 0),
                    "hbm_total_gb": 16.0,
                    "hbm_used_gb": 14.2 if hot else 6.4,
                    "duty_cycle_pct": 97.5 if hot else 62.0,
                    "temperature_c": 83.0 if hot else 54.0,
                    "power_draw_w": 170.0 if hot else 120.0,
                    "power_limit_w": 192.0,
                    "process_index": 0,
                }
            )
        fleet = mgr.get_fleet_status(metrics=metrics)
        return fleet


# ---------------------------------------------------------------------------
# CLI — `python -m tpu_engine_torch.tpu_manager` (the nvidia-smi UX: one
# fleet table, live sources when available).
# ---------------------------------------------------------------------------


def _fmt(v: Any, suffix: str = "") -> str:
    return "-" if v is None else f"{v}{suffix}"


def main(argv: Optional[list[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="GPU fleet status")
    parser.add_argument("--mock", action="store_true", help="show the mock fleet")
    parser.add_argument("--json", action="store_true", help="raw JSON instead of a table")
    args = parser.parse_args(argv)

    fleet = TPUManager.get_mock_fleet() if args.mock else TPUManager().get_fleet_status()
    if args.json:
        print(fleet.model_dump_json(indent=2))
        return 0

    src = ",".join(fleet.telemetry_sources) or "runtime"
    print(
        f"devices: {fleet.total_devices} ({fleet.available_devices} available)"
        f"   HBM: {fleet.used_hbm_gb:.1f}/{fleet.total_hbm_gb:.1f} GiB"
        f"   telemetry: {src}"
    )
    header = f"{'idx':>3} {'kind':<22} {'hbm':>13} {'duty%':>6} {'thr':>4} {'temp':>5} {'power':>11} {'health':<8}"
    print(header)
    print("-" * len(header))
    for d in fleet.devices:
        print(
            f"{d.index:>3} {d.device_kind:<22} "
            f"{d.hbm_used_gb:>5.1f}/{d.hbm_total_gb:<5.1f}G "
            f"{_fmt(d.duty_cycle_pct):>6} "
            f"{_fmt(d.throttle_score):>4} {_fmt(d.temperature_c):>5} "
            f"{_fmt(d.power_draw_w):>5}/{_fmt(d.power_limit_w):<5} "
            f"{d.health_status.value:<8}"
        )
    for a in fleet.fleet_alerts:
        print(f"! {a}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
