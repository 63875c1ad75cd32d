"""Training-metrics anomaly detection.

Capability parity with the reference's ``LossSpikeMonitor``
(``ai_engine/loss_monitor.py``): the same five detectors with the same
default thresholds and the same check ordering —

1. divergence: NaN/Inf (critical, early-return) or loss > 1e6
   (``loss_monitor.py:126-150``),
2. loss spike: rolling mean + 3σ over a 100-step window, critical at 5σ,
   min history 10, 20-step per-type cooldown (``:153-173``),
3. plateau: best-loss tracking with 500-step patience, 1e-4 min delta
   (``:176-197``),
4. gradient explosion: grad-norm > 100 (``:200-215``),
5. LR anomaly: lr > 10× rolling average, min history 5 (``:218-234``).

Deliberately preserved quirks (SURVEY.md §5): the rolling window *excludes*
the current step (append-after-check, ``:237``) and NaN/Inf losses never
enter the window (early return, ``:126-138``) — diverged values cannot poison
the statistics.

Deliberately fixed (SURVEY.md §5): the reference's unbounded
``_all_metrics``/``_all_alerts`` lists (``:108-109``) leak memory over long
runs and ``max_alerts_per_type`` is defined but never enforced (``:65``).
Here both histories are bounded deques and the per-type alert cap is real.

The port's copy of ``tpu_engine/loss_monitor.py`` (the JAX package's module uses
no JAX, and the port imports nothing of that package): the same code,
with the port's imports and its own exporter name; Prometheus families
keep JAX's names, so one dashboard reads both.
"""

from __future__ import annotations

import math
import statistics
import threading
import time
from collections import deque
from enum import Enum
from typing import Any, Optional

from pydantic import BaseModel, Field


class AlertSeverity(str, Enum):
    """Mirrors reference ``AlertSeverity`` (``loss_monitor.py:23-27``)."""

    INFO = "info"
    WARNING = "warning"
    CRITICAL = "critical"


class SpikeAlert(BaseModel):
    """Mirrors reference ``SpikeAlert`` (``loss_monitor.py:29-42``)."""

    alert_type: str
    severity: AlertSeverity
    step: int
    job_id: str = ""
    message: str
    current_value: float
    threshold_value: float
    timestamp: float = Field(default_factory=time.time)
    remediation: list[str] = Field(default_factory=list)


class TrainingMetrics(BaseModel):
    """Mirrors reference ``TrainingMetrics`` (``loss_monitor.py:44-53``)."""

    step: int
    loss: float
    learning_rate: Optional[float] = None
    gradient_norm: Optional[float] = None
    throughput_tokens_per_sec: Optional[float] = None
    timestamp: float = Field(default_factory=time.time)


class MonitorConfig(BaseModel):
    """Mirrors reference ``MonitorConfig`` (``loss_monitor.py:56-66``)."""

    window_size: int = Field(default=100, ge=2)
    min_history_for_spike: int = Field(default=10, ge=2)
    spike_sigma: float = Field(default=3.0, gt=0)
    critical_sigma: float = Field(default=5.0, gt=0)
    divergence_threshold: float = Field(default=1e6, gt=0)
    plateau_patience_steps: int = Field(default=500, ge=1)
    plateau_min_delta: float = Field(default=1e-4, ge=0)
    gradient_norm_threshold: float = Field(default=100.0, gt=0)
    lr_anomaly_ratio: float = Field(default=10.0, gt=1)
    min_history_for_lr: int = Field(default=5, ge=2)
    alert_cooldown_steps: int = Field(default=20, ge=0)
    max_alerts_per_type: int = Field(default=50, ge=1)  # enforced (unlike reference :65)
    max_history: int = Field(default=10_000, ge=100)  # bounded (reference is unbounded :108)


class LossSpikeMonitor:
    """Per-job anomaly monitor; pure in-memory, no I/O (reference ``loss_monitor.py:79``)."""

    def __init__(self, job_id: str = "", config: Optional[MonitorConfig] = None):
        self.job_id = job_id
        self.config = config or MonitorConfig()
        # The training thread ingests while HTTP handlers read summaries:
        # all public entry points take this lock (the reference mutates its
        # monitor dict unlocked — SURVEY.md §5 race detection).
        self._lock = threading.RLock()
        self._loss_window: deque[float] = deque(maxlen=self.config.window_size)
        self._lr_window: deque[float] = deque(maxlen=self.config.window_size)
        self._metrics: deque[TrainingMetrics] = deque(maxlen=self.config.max_history)
        self._alerts: deque[SpikeAlert] = deque(maxlen=self.config.max_history)
        self._alert_counts: dict[str, int] = {}
        self._last_alert_step: dict[str, int] = {}
        self._best_loss: float = math.inf
        self._best_loss_step: int = 0
        self._plateau_alerted_at_best: float = math.nan

    # -- ingestion (the per-step hot path; reference ``ingest`` :111-243) ----

    def ingest(self, m: TrainingMetrics) -> list[SpikeAlert]:
        with self._lock:
            return self._ingest_locked(m)

    def _ingest_locked(self, m: TrainingMetrics) -> list[SpikeAlert]:
        alerts: list[SpikeAlert] = []

        # 1. Divergence: NaN/Inf — EARLY RETURN, do not append to history.
        if math.isnan(m.loss) or math.isinf(m.loss):
            a = self._emit(
                "divergence",
                AlertSeverity.CRITICAL,
                m.step,
                f"Loss is {m.loss} at step {m.step} — training has diverged",
                current=m.loss,
                threshold=self.config.divergence_threshold,
                remediation=[
                    "Halt training immediately",
                    "Restore from last stable checkpoint",
                    "Reduce learning rate by 2-10x",
                    "Check input data for corrupt batches",
                ],
            )
            if a:
                alerts.append(a)
            self._metrics.append(m)
            return alerts

        # 1b. Divergence by magnitude.
        if m.loss > self.config.divergence_threshold:
            a = self._emit(
                "divergence",
                AlertSeverity.CRITICAL,
                m.step,
                f"Loss {m.loss:.4g} exceeds divergence threshold "
                f"{self.config.divergence_threshold:.4g}",
                current=m.loss,
                threshold=self.config.divergence_threshold,
                remediation=[
                    "Halt training immediately",
                    "Restore from last stable checkpoint",
                    "Reduce learning rate",
                ],
            )
            if a:
                alerts.append(a)

        # 2. Spike: rolling mean + kσ over window EXCLUDING current step.
        if len(self._loss_window) >= self.config.min_history_for_spike:
            mean = statistics.fmean(self._loss_window)
            std = statistics.pstdev(self._loss_window)
            if std > 0:
                spike_thr = mean + self.config.spike_sigma * std
                crit_thr = mean + self.config.critical_sigma * std
                if m.loss > spike_thr:
                    severity = (
                        AlertSeverity.CRITICAL if m.loss > crit_thr else AlertSeverity.WARNING
                    )
                    a = self._emit(
                        "loss_spike",
                        severity,
                        m.step,
                        f"Loss {m.loss:.4f} spiked above rolling mean {mean:.4f} "
                        f"+ {self.config.spike_sigma:.0f}σ ({spike_thr:.4f})",
                        current=m.loss,
                        threshold=spike_thr,
                        remediation=[
                            "Inspect recent data batches for outliers",
                            "Consider reducing learning rate",
                            "Restore from last checkpoint if loss does not recover",
                        ],
                    )
                    if a:
                        alerts.append(a)

        # 3. Plateau: best-loss tracking + patience.
        if m.loss < self._best_loss - self.config.plateau_min_delta:
            self._best_loss = m.loss
            self._best_loss_step = m.step
        elif (
            m.step - self._best_loss_step >= self.config.plateau_patience_steps
            and self._plateau_alerted_at_best != self._best_loss
        ):
            a = self._emit(
                "plateau",
                AlertSeverity.INFO,
                m.step,
                f"No improvement > {self.config.plateau_min_delta} for "
                f"{m.step - self._best_loss_step} steps (best {self._best_loss:.4f} "
                f"at step {self._best_loss_step})",
                current=m.loss,
                threshold=self._best_loss,
                remediation=[
                    "Consider learning-rate schedule changes",
                    "Evaluate early stopping",
                    "Check for data pipeline repetition",
                ],
            )
            if a:
                alerts.append(a)
                self._plateau_alerted_at_best = self._best_loss

        # 4. Gradient explosion.
        if m.gradient_norm is not None and m.gradient_norm > self.config.gradient_norm_threshold:
            a = self._emit(
                "gradient_explosion",
                AlertSeverity.CRITICAL,
                m.step,
                f"Gradient norm {m.gradient_norm:.2f} exceeds "
                f"{self.config.gradient_norm_threshold:.0f}",
                current=m.gradient_norm,
                threshold=self.config.gradient_norm_threshold,
                remediation=[
                    "Enable/tighten gradient clipping",
                    "Reduce learning rate",
                    "Check for bad batches or numerical issues",
                ],
            )
            if a:
                alerts.append(a)

        # 5. LR anomaly: lr > ratio × rolling average.
        if m.learning_rate is not None:
            if len(self._lr_window) >= self.config.min_history_for_lr:
                lr_avg = statistics.fmean(self._lr_window)
                if lr_avg > 0 and m.learning_rate > self.config.lr_anomaly_ratio * lr_avg:
                    a = self._emit(
                        "lr_anomaly",
                        AlertSeverity.WARNING,
                        m.step,
                        f"Learning rate {m.learning_rate:.3g} is more than "
                        f"{self.config.lr_anomaly_ratio:.0f}x the rolling average {lr_avg:.3g}",
                        current=m.learning_rate,
                        threshold=self.config.lr_anomaly_ratio * lr_avg,
                        remediation=[
                            "Verify the LR scheduler configuration",
                            "Check for scheduler restarts or warm restarts",
                        ],
                    )
                    if a:
                        alerts.append(a)
            self._lr_window.append(m.learning_rate)

        # Append AFTER all checks: the window never includes the current step.
        self._loss_window.append(m.loss)
        self._metrics.append(m)
        return alerts

    # -- alert bookkeeping ---------------------------------------------------

    def _can_alert(self, alert_type: str, step: int) -> bool:
        """Cooldown + per-type cap (reference ``_can_alert`` :301-309, cap enforced here)."""
        if self._alert_counts.get(alert_type, 0) >= self.config.max_alerts_per_type:
            return False
        last = self._last_alert_step.get(alert_type)
        if last is not None and step - last < self.config.alert_cooldown_steps:
            return False
        return True

    def _emit(
        self,
        alert_type: str,
        severity: AlertSeverity,
        step: int,
        message: str,
        current: float,
        threshold: float,
        remediation: list[str],
    ) -> Optional[SpikeAlert]:
        if not self._can_alert(alert_type, step):
            return None
        alert = SpikeAlert(
            alert_type=alert_type,
            severity=severity,
            step=step,
            job_id=self.job_id,
            message=message,
            current_value=current,
            threshold_value=threshold,
            remediation=remediation,
        )
        self._alerts.append(alert)
        self._alert_counts[alert_type] = self._alert_counts.get(alert_type, 0) + 1
        self._last_alert_step[alert_type] = step
        return alert

    # -- views (reference ``get_summary`` :245-259, ``get_loss_curve`` :261-271)

    @property
    def alerts(self) -> list[SpikeAlert]:
        with self._lock:
            return list(self._alerts)

    def has_critical_alert(self) -> bool:
        with self._lock:
            return any(a.severity == AlertSeverity.CRITICAL for a in self._alerts)

    def get_summary(self) -> dict[str, Any]:
        with self._lock:
            return self._summary_locked()

    def _summary_locked(self) -> dict[str, Any]:
        losses = [m.loss for m in self._metrics if not (math.isnan(m.loss) or math.isinf(m.loss))]
        return {
            "job_id": self.job_id,
            "total_steps_seen": len(self._metrics),
            "current_loss": self._metrics[-1].loss if self._metrics else None,
            "best_loss": None if math.isinf(self._best_loss) else self._best_loss,
            "best_loss_step": self._best_loss_step if losses else None,
            "rolling_mean_loss": statistics.fmean(self._loss_window) if self._loss_window else None,
            "rolling_std_loss": statistics.pstdev(self._loss_window)
            if len(self._loss_window) >= 2
            else None,
            "total_alerts": len(self._alerts),
            "alerts_by_type": dict(self._alert_counts),
            "critical_alerts": sum(
                1 for a in self._alerts if a.severity == AlertSeverity.CRITICAL
            ),
        }

    def get_loss_curve(self) -> dict[str, list]:
        """Visualization feed: steps/losses/lrs/grad-norms/spike-steps arrays."""
        with self._lock:
            return self._loss_curve_locked()

    def _loss_curve_locked(self) -> dict[str, list]:
        return {
            "steps": [m.step for m in self._metrics],
            "losses": [m.loss for m in self._metrics],
            "learning_rates": [m.learning_rate for m in self._metrics],
            "gradient_norms": [m.gradient_norm for m in self._metrics],
            "throughputs": [m.throughput_tokens_per_sec for m in self._metrics],
            "spike_steps": [a.step for a in self._alerts if a.alert_type == "loss_spike"],
        }

    def reset(self) -> None:
        """Clear all state, e.g. after checkpoint restore (reference :273-280)."""
        with self._lock:
            self._reset_locked()

    def _reset_locked(self) -> None:
        self._loss_window.clear()
        self._lr_window.clear()
        self._metrics.clear()
        self._alerts.clear()
        self._alert_counts.clear()
        self._last_alert_step.clear()
        self._best_loss = math.inf
        self._best_loss_step = 0
        self._plateau_alerted_at_best = math.nan
