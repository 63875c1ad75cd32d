"""Preemption / spot resiliency — the reference's stub, implemented for real.

Reference ``ai_engine/spot_resiliency.py`` is a 49-line stub: it polls a
simulated flag every 5 s (``:24-41``) and *prints* what an emergency
checkpoint would do (``:43-49``); the real metadata URLs exist only in
comments (``:25-29``). Here:

- the GCE metadata preemption endpoint is actually polled
  (``/computeMetadata/v1/instance/preempted``, the exact URL the stub cites);
- a SIGTERM/SIGINT handler triggers the same emergency path (GKE and TPU
  maintenance events deliver SIGTERM with a grace window);
- the fault-injection seam is preserved (``simulate_interruption`` — parity
  with ``_simulate_interruption``, ``spot_resiliency.py:39-41``) so tests can
  drive the full emergency path without a cloud;
- the emergency callback is supplied by the supervisor: synchronous Orbax
  save → mark job preempted → (optionally) exit. Auto-resume on restart is
  the supervisor's side (``tpu_engine/supervisor.py``).

Cloud scope — GCP ONLY, deliberately. The reference stub's comments cite
both the AWS instance-action URL and the GCP preempted URL
(``spot_resiliency.py:25-29``); TPUs exist only in Google Cloud, so this
TPU-native build polls the GCE endpoint and does not carry a dead AWS
code path. Non-GCE environments (including any future AWS-hosted
runtime) are still covered by the SIGTERM handler — every major cloud
delivers spot/maintenance interruptions as SIGTERM with a grace window —
and by the simulation seam for tests.

The port's copy of ``tpu_engine/preemption.py`` (the JAX package's module uses
no JAX, and the port imports nothing of that package): the same code,
with the port's imports and its own exporter name; Prometheus families
keep JAX's names, so one dashboard reads both.
"""

from __future__ import annotations

import logging
import signal
import threading
import urllib.request
from typing import Callable, Optional

log = logging.getLogger(__name__)

GCE_PREEMPTION_URL = (
    "http://metadata.google.internal/computeMetadata/v1/instance/preempted"
)


def probe_gce_preempted(timeout: float = 1.0) -> Optional[bool]:
    """One metadata probe, hardened against every request failure mode.

    Returns True/False from a successful read, or **None** when the probe
    could not determine anything: no route / DNS failure / connection
    refused / socket timeout / HTTP error status / undecodable body. The
    tri-state matters — callers distinguish "not preempted" from "metadata
    server unreachable", which is what drives the watcher's backoff so a
    flapping endpoint can't spin the poll loop at full rate.
    """
    req = urllib.request.Request(
        GCE_PREEMPTION_URL, headers={"Metadata-Flavor": "Google"}
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            status = getattr(resp, "status", 200)
            if status is not None and not (200 <= int(status) < 300):
                return None
            body = resp.read(64)
    except Exception:  # URLError, timeout, OSError, anything urllib raises
        return None
    try:
        return body.decode("utf-8", "replace").strip().upper() == "TRUE"
    except Exception:
        return None


def check_gce_preempted(timeout: float = 1.0) -> bool:
    """Poll the GCE metadata server; False on any error (not on GCE, etc.)."""
    return probe_gce_preempted(timeout) is True


class PreemptionWatcher:
    """Background preemption monitor with a fault-injection seam.

    ``on_preemption`` is called exactly once, from the watcher thread (or the
    signal handler's main thread), when any of these fire:
    metadata says preempted · ``simulate_interruption()`` set · SIGTERM/SIGINT.
    """

    def __init__(
        self,
        on_preemption: Callable[[str], None],
        check_interval_s: float = 5.0,  # reference poll interval, spot_resiliency.py:13
        install_signal_handlers: bool = False,
        metadata_check: Optional[Callable[[], Optional[bool]]] = probe_gce_preempted,
        max_backoff_s: float = 60.0,
    ):
        self.on_preemption = on_preemption
        self.check_interval_s = check_interval_s
        self.metadata_check = metadata_check
        self.max_backoff_s = max_backoff_s
        #: consecutive probe failures (None result or raised exception) —
        #: drives exponential backoff; reset on any successful probe.
        self.metadata_failures = 0
        self._install_signals = install_signal_handlers
        self._simulated = threading.Event()
        self._stop = threading.Event()
        self._fired = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._prev_handlers: dict[int, object] = {}

    # -- fault injection seam (parity with _simulate_interruption :39-41) ----

    def simulate_interruption(self) -> None:
        """Inject a preemption notice (test seam)."""
        self._simulated.set()

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._install_signals:
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    self._prev_handlers[sig] = signal.signal(sig, self._signal_handler)
                except ValueError:
                    pass  # not on main thread; metadata/simulated paths still work
        self._thread = threading.Thread(target=self._loop, daemon=True, name="preemption-watcher")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.check_interval_s + 2)
        for sig, handler in self._prev_handlers.items():
            try:
                signal.signal(sig, handler)  # type: ignore[arg-type]
            except (ValueError, TypeError):
                pass

    @property
    def fired(self) -> bool:
        return self._fired.is_set()

    # -- internals -----------------------------------------------------------

    def _signal_handler(self, signum, frame) -> None:
        log.warning("received signal %s — triggering emergency checkpoint", signum)
        self._fire(f"signal:{signal.Signals(signum).name}")

    def _fire(self, reason: str) -> None:
        if self._fired.is_set():
            return
        self._fired.set()
        try:
            self.on_preemption(reason)
        except Exception:
            log.exception("preemption callback failed")

    def _poll_once(self) -> Optional[str]:
        """One watcher tick → fire reason, or None to keep waiting.

        A raising ``metadata_check`` must NOT kill the watcher thread (it
        used to — an exception here silently disabled preemption handling
        for the rest of the job); raised exceptions count as probe failures
        and feed the same backoff as a None result.
        """
        if self._simulated.is_set():
            return "simulated"
        if self.metadata_check is None:
            return None
        try:
            result = self.metadata_check()
        except Exception:
            log.exception("metadata preemption check raised; backing off")
            result = None
        if result is None:
            self.metadata_failures += 1
        else:
            self.metadata_failures = 0
            if result:
                return "gce-metadata"
        return None

    def _wait_s(self) -> float:
        """Poll interval with exponential backoff while the probe is failing."""
        backoff = self.check_interval_s * (2 ** min(self.metadata_failures, 20))
        return min(backoff, max(self.max_backoff_s, self.check_interval_s))

    def _loop(self) -> None:
        while not self._stop.is_set():
            reason = self._poll_once()
            if reason is not None:
                self._fire(reason)
                return
            self._stop.wait(self._wait_s())
