"""Fleet compile-cache index: layout-keyed warm-start bookkeeping (port of
``tpu_engine/compile_index.py``).

The port's compile is the build of its kernel library into the directory
``tpu_engine_torch/compile_cache.py`` points at (a resumed job on that
directory finds the library and skips ``nvcc``) and the program's
construction. This module is the fleet's view of that cache, JAX's logic:

- :class:`CompileCacheIndex` keys entries by (model config digest, layout
  label, runtime fingerprint), records warm/cold outcomes from the
  supervisor's compile span, maintains a per-layout EMA of measured *cold*
  compile seconds, and persists a bounded JSON sidecar in the build
  directory so warmth survives the process.
- ``is_warm(plan)`` / ``expected_compile_s(plan)`` answer "is this layout
  warm?" for a scheduler's admission and grow-back decisions.
- :class:`PrecompileWorker` warms a target layout in the background (the
  default builds the kernel library) so a grow-back preempts only once the
  destination is warm — or a deadline lapses. Fault-injectable via the
  ``precompile-error`` kind in ``tpu_engine_torch/faults.py``.
"""

from __future__ import annotations

import collections
import hashlib
import json
import logging
import os
import threading
import time
from typing import Any, Callable, Optional

log = logging.getLogger(__name__)

# Sidecar file written inside the kernel build directory.
SIDECAR_NAME = "compile_index.json"
# Nominal cold compile seconds when a layout has no measured EMA yet — the
# order of a full kernel build (``nvcc`` over every source), pessimistic on
# purpose so an unknown-cold layout never out-ranks a measured-warm one for
# free.
DEFAULT_COLD_COMPILE_S = 90.0


class PrecompileError(RuntimeError):
    """A background precompile attempt failed (including injected faults)."""


# -- keying -------------------------------------------------------------------


def model_digest(config: Any) -> str:
    """Digest of the model-shape fields that change the compiled program.

    Mesh/schedule/quant live in the layout label; this digest covers what
    the label does not: which model, at what sequence length and precision.
    """
    parts = {
        "model": getattr(config, "model_name", None),
        "seq_len": getattr(config, "seq_len", None),
        "precision": str(getattr(config, "precision", None)),
        "micro": getattr(config, "micro_batch_size", None),
    }
    blob = json.dumps(parts, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:12]


_runtime_fp: Optional[str] = None


def runtime_fingerprint() -> str:
    """torch's and CUDA's versions, ``nvcc``'s where it is found, the
    card's ``sm_XX`` and the hash of the kernel sources — a cache keyed for
    one runtime is cold for another (the library's own name keys on the
    sources the same way)."""
    global _runtime_fp
    if _runtime_fp is None:
        import torch

        fp = f"torch{torch.__version__}-cuda{torch.version.cuda}"
        try:
            import re
            import subprocess

            from tpu_engine_torch.ops import _flash_cuda

            out = subprocess.run([_flash_cuda._nvcc(), "--version"], capture_output=True,
                                 text=True, timeout=10).stdout
            m = re.search(r"release ([\d.]+)", out)
            if m:
                fp += f"-nvcc{m.group(1)}"
        except Exception:  # no nvcc: the key says so by its absence
            pass
        if torch.cuda.is_available():
            major, minor = torch.cuda.get_device_capability(0)
            fp += f"-sm_{major}{minor}"
        try:
            from tpu_engine_torch.ops import _flash_cuda

            fp += "-src" + _flash_cuda.library_path().stem.rsplit("_", 1)[-1]
        except Exception:
            pass
        _runtime_fp = fp
    return _runtime_fp


def layout_label(
    mesh: dict[str, int],
    sharding_stage: int,
    pipeline_schedule: str,
    quant_training: str = "none",
    comm_compress: bool = False,
) -> str:
    """The layout half of the key — byte-identical to JAX's
    ``PlacementPlan.label`` for the same layout."""
    axes = "x".join(
        f"{k}{v}" for k, v in mesh.items() if v > 1 and k != "dcn_data"
    ) or "data1"
    tags = [pipeline_schedule] if mesh.get("pipe", 1) > 1 else []
    if quant_training != "none":
        tags.append(quant_training)
    if comm_compress:
        tags.append("commq")
    return "·".join([axes, f"s{sharding_stage}", *tags])


def label_for_config(
    config: Any,
    mesh: Optional[Any] = None,
    gang: Optional[int] = None,
) -> str:
    """Layout label for a :class:`~tpu_engine_torch.train.TrainConfig`.

    ``mesh`` overrides the config's mesh (a :class:`MeshConfig` or a plain
    axis dict — the elastic-shrink path runs a different mesh than the one
    configured); ``gang`` resolves elastic ``data=-1`` axes.
    """
    from tpu_engine_torch.sharding import resolve_pipeline_schedule

    m = mesh if mesh is not None else config.mesh
    if isinstance(m, dict):
        mesh_d = dict(m)
    else:
        if gang is None:
            gang = 1
            for v in (m.data, m.fsdp, m.pipe, m.sequence, m.model):
                gang *= max(int(v), 1)
        data, fsdp, pipe, seq_ax, model_ax = m.resolved_shape(gang)
        mesh_d = {
            "data": data, "fsdp": fsdp, "pipe": pipe,
            "sequence": seq_ax, "model": model_ax,
            "dcn_data": getattr(m, "dcn_data", 1),
        }
    return layout_label(
        mesh_d,
        int(config.sharding_stage),
        resolve_pipeline_schedule(config),
        quant_training=getattr(config, "quant_training", "none"),
        comm_compress=bool(
            getattr(config, "comm_quant_weights", False)
            or getattr(config, "comm_quant_grads", False)
        ),
    )


def index_key(label: str, config: Any) -> str:
    return f"{model_digest(config)}|{runtime_fingerprint()}|{label}"


def key_for_config(
    config: Any, mesh: Optional[Any] = None, gang: Optional[int] = None
) -> str:
    return index_key(label_for_config(config, mesh=mesh, gang=gang), config)


# -- index --------------------------------------------------------------------


class CompileCacheIndex:
    """Layout-keyed warm/cold ledger over the kernel build directory.

    Thread-safe; every mutation persists the sidecar (atomic rename) when a
    ``path`` is attached. Bounded: least-recently-used entries beyond
    ``max_entries`` are evicted — the sidecar can never grow without bound.
    """

    def __init__(
        self,
        path: Optional[str] = None,
        max_entries: int = 256,
        ema_alpha: float = 0.3,
        default_cold_s: float = DEFAULT_COLD_COMPILE_S,
        clock: Callable[[], float] = time.time,
    ):
        self.path = path
        self.max_entries = max_entries
        self.ema_alpha = ema_alpha
        self.default_cold_s = default_cold_s
        self.clock = clock
        self._lock = threading.Lock()
        self._entries: dict[str, dict[str, Any]] = {}
        self.hits_total = 0
        self.misses_total = 0
        self.records_total = 0
        self.cold_compile_s_total = 0.0
        self.evictions_total = 0
        self.persist_errors_total = 0
        self.sidecar_load_errors_total = 0
        self._global_cold_ema: Optional[float] = None
        if path:
            self._load()

    # -- keying helpers -------------------------------------------------------

    @staticmethod
    def key_for(config: Any, mesh: Any = None, gang: Optional[int] = None) -> str:
        return key_for_config(config, mesh=mesh, gang=gang)

    @staticmethod
    def key_for_plan(plan: Any) -> str:
        """Key for a placement plan (an object with ``label`` and its
        fully-validated ``config``)."""
        return index_key(plan.label, plan.config)

    def _resolve_key(self, key_or_plan: Any) -> str:
        if isinstance(key_or_plan, str):
            return key_or_plan
        return self.key_for_plan(key_or_plan)

    # -- queries --------------------------------------------------------------

    def is_warm(self, key_or_plan: Any) -> bool:
        key = self._resolve_key(key_or_plan)
        with self._lock:
            e = self._entries.get(key)
            return bool(e and e.get("warm"))

    def expected_cold_s(self, key_or_plan: Any) -> Optional[float]:
        """Measured cold-compile EMA for this layout (or the global EMA as a
        fallback); None when nothing has ever been measured."""
        key = self._resolve_key(key_or_plan)
        with self._lock:
            e = self._entries.get(key)
            if e and e.get("cold_ema_s"):
                return float(e["cold_ema_s"])
            return self._global_cold_ema

    def expected_compile_s(self, key_or_plan: Any) -> float:
        """Expected compile seconds the next admission of this layout pays:
        0 when warm, the cold EMA (global fallback, then the pessimistic
        default) when not."""
        key = self._resolve_key(key_or_plan)
        with self._lock:
            e = self._entries.get(key)
            if e and e.get("warm"):
                return 0.0
            if e and e.get("cold_ema_s"):
                return float(e["cold_ema_s"])
            if self._global_cold_ema is not None:
                return self._global_cold_ema
            return self.default_cold_s

    # -- recording ------------------------------------------------------------

    def record(
        self,
        key_or_plan: Any,
        compile_s: float,
        cache_hit: bool,
        label: str = "",
        model: str = "",
        via: str = "supervisor",
    ) -> dict[str, Any]:
        """One observed compile outcome. A cold observation updates the
        per-layout EMA; either outcome marks the layout warm (the build directory
        now holds its executable)."""
        key = self._resolve_key(key_or_plan)
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                e = {
                    "label": label, "model": model, "warm": False,
                    "cold_ema_s": None, "hits": 0, "misses": 0,
                    "last_compile_s": None, "last_via": via,
                    "last_used": 0.0,
                }
                self._entries[key] = e
            if label:
                e["label"] = label
            if model:
                e["model"] = model
            self.records_total += 1
            e["last_compile_s"] = round(float(compile_s), 6)
            e["last_via"] = via
            e["last_used"] = self.clock()
            if cache_hit:
                self.hits_total += 1
                e["hits"] += 1
            else:
                self.misses_total += 1
                e["misses"] += 1
                self.cold_compile_s_total += float(compile_s)
                prev = e.get("cold_ema_s")
                e["cold_ema_s"] = round(
                    float(compile_s) if prev is None
                    else (1 - self.ema_alpha) * prev + self.ema_alpha * float(compile_s),
                    6,
                )
                g = self._global_cold_ema
                self._global_cold_ema = (
                    float(compile_s) if g is None
                    else (1 - self.ema_alpha) * g + self.ema_alpha * float(compile_s)
                )
            e["warm"] = True
            self._evict_locked()
            snap = dict(e)
        self._persist()
        return snap

    def touch(self, key_or_plan: Any) -> None:
        """LRU bump without an outcome (a consult that led to admission)."""
        key = self._resolve_key(key_or_plan)
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                e["last_used"] = self.clock()

    def invalidate(self, key: Optional[str] = None) -> int:
        """Drop one entry (or all) — e.g. when the build directory is wiped."""
        with self._lock:
            if key is None:
                n = len(self._entries)
                self._entries.clear()
            else:
                n = 1 if self._entries.pop(key, None) is not None else 0
        self._persist()
        return n

    def _evict_locked(self) -> None:
        while len(self._entries) > self.max_entries:
            victim = min(
                self._entries, key=lambda k: self._entries[k].get("last_used", 0.0)
            )
            del self._entries[victim]
            self.evictions_total += 1

    # -- persistence ----------------------------------------------------------

    def attach_dir(self, cache_dir: str) -> None:
        """Point the sidecar at (inside) ``cache_dir`` and merge anything a
        previous process persisted there — called when the kernel build
        cache is enabled/re-pointed."""
        path = os.path.join(cache_dir, SIDECAR_NAME)
        with self._lock:
            if self.path == path:
                return
            self.path = path
        self._load(merge=True)
        self._persist()

    def _load(self, merge: bool = False) -> None:
        path = self.path
        if not path or not os.path.exists(path):
            return
        try:
            with open(path) as f:
                doc = json.load(f)
            if not isinstance(doc, dict):
                raise ValueError(f"sidecar is not a JSON object: {type(doc).__name__}")
            entries = doc.get("entries", {})
            if not isinstance(entries, dict):
                raise ValueError("sidecar 'entries' is not a JSON object")
            with self._lock:
                for k, v in entries.items():
                    if merge and k in self._entries:
                        continue
                    if isinstance(v, dict):
                        self._entries[k] = v
                g = doc.get("global_cold_ema_s")
                if g and self._global_cold_ema is None:
                    self._global_cold_ema = float(g)
                self._evict_locked()
        except Exception:
            # A torn/garbage sidecar (host died mid-write, disk corruption)
            # must never take the process down: warn, count, start fresh.
            with self._lock:
                self.sidecar_load_errors_total += 1
            log.warning("compile index sidecar unreadable: %s", path, exc_info=True)

    def _persist(self) -> None:
        path = self.path
        if not path:
            return
        with self._lock:
            doc = {
                "version": 1,
                "runtime": runtime_fingerprint(),
                "global_cold_ema_s": self._global_cold_ema,
                "entries": self._entries,
            }
            blob = json.dumps(doc, sort_keys=True)
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(blob)
            os.replace(tmp, path)
        except OSError:
            self.persist_errors_total += 1
            log.warning("compile index sidecar write failed: %s", path, exc_info=True)

    # -- views ----------------------------------------------------------------

    def entries(self) -> list[dict[str, Any]]:
        with self._lock:
            return [
                {"key": k, **v}
                for k, v in sorted(
                    self._entries.items(),
                    key=lambda kv: -kv[1].get("last_used", 0.0),
                )
            ]

    def stats(self) -> dict[str, Any]:
        with self._lock:
            entries = len(self._entries)
            warm = sum(1 for e in self._entries.values() if e.get("warm"))
            return {
                "entries": entries,
                "warm_entries": warm,
                "hits_total": self.hits_total,
                "misses_total": self.misses_total,
                "records_total": self.records_total,
                "cold_compile_s_total": round(self.cold_compile_s_total, 6),
                "global_cold_ema_s": (
                    round(self._global_cold_ema, 6)
                    if self._global_cold_ema is not None else None
                ),
                "evictions_total": self.evictions_total,
                "persist_errors_total": self.persist_errors_total,
                "sidecar_load_errors_total": self.sidecar_load_errors_total,
                "sidecar_path": self.path,
                "max_entries": self.max_entries,
            }


# -- background precompile ----------------------------------------------------


class PrecompileTask:
    """One background warm-up request (grow-back target, usually)."""

    __slots__ = (
        "key", "label", "config", "gang", "state", "requested_at",
        "started_at", "finished_at", "compile_s", "error",
    )

    def __init__(self, key: str, label: str, config: Any, gang: Optional[int], now: float):
        self.key = key
        self.label = label
        self.config = config
        self.gang = gang
        self.state = "queued"  # queued | running | warm | failed
        self.requested_at = now
        self.started_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.compile_s: Optional[float] = None
        self.error: Optional[str] = None

    def describe(self) -> dict[str, Any]:
        return {
            "key": self.key,
            "label": self.label,
            "gang": self.gang,
            "state": self.state,
            "requested_at": self.requested_at,
            "started_at": self.started_at,
            "finished_at": self.finished_at,
            "compile_s": self.compile_s,
            "error": self.error,
        }


def _default_precompile(task: PrecompileTask) -> None:
    """Build the kernel library into the current build directory (the
    port's compile; ``_flash_cuda.build``). Raises without a CUDA device —
    the worker degrades that to a failed task, and the grow-back deadline
    then proceeds cold, exactly as if no precompiler existed; nothing runs
    on the CPU, as JAX's skips its CPU backend."""
    if task.config is None:
        raise PrecompileError("no config attached to precompile task")
    import torch

    if not torch.cuda.is_available():
        raise PrecompileError("precompile builds the CUDA kernels: no CUDA device visible")
    from tpu_engine_torch.ops import _flash_cuda

    _flash_cuda.build()


class PrecompileWorker:
    """Bounded background thread that warms layouts ahead of a resize.

    ``compile_fn(task)`` does the actual work — the default builds the
    kernel library; tests and simulators inject a stub.
    Consults the process fault injector's ``precompile-error`` seam before
    every attempt, so chaos plans can break this path deterministically.

    With ``background=False`` no worker thread is ever spawned: requests
    queue and a caller drains them synchronously via :meth:`pump` — the
    autopilot's unified tick subsumes this worker that way, keeping the
    whole control loop single-threaded and virtual-clock-driven.
    """

    def __init__(
        self,
        index: CompileCacheIndex,
        compile_fn: Optional[Callable[[PrecompileTask], None]] = None,
        max_pending: int = 4,
        clock: Callable[[], float] = time.time,
        background: bool = True,
    ):
        self.index = index
        self.compile_fn = compile_fn or _default_precompile
        self.max_pending = max_pending
        self.clock = clock
        self.background = bool(background)
        self._lock = threading.Lock()
        self._tasks: dict[str, PrecompileTask] = {}
        self._queue: collections.deque[str] = collections.deque()
        self._wake = threading.Event()
        self._shutdown = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.started_total = 0
        self.completed_total = 0
        self.failed_total = 0
        self.rejected_total = 0

    def request(
        self,
        key: str,
        label: str = "",
        config: Any = None,
        gang: Optional[int] = None,
    ) -> str:
        """Ask for ``key`` to be warmed; returns the task state ("warm" when
        the index already has it, "rejected" when the bounded queue is
        full). Idempotent per key while a task is in flight."""
        if self.index.is_warm(key):
            return "warm"
        with self._lock:
            task = self._tasks.get(key)
            if task is not None and task.state in ("queued", "running"):
                return task.state
            pending = sum(
                1 for t in self._tasks.values() if t.state in ("queued", "running")
            )
            if pending >= self.max_pending:
                self.rejected_total += 1
                return "rejected"
            task = PrecompileTask(key, label, config, gang, self.clock())
            self._tasks[key] = task
            self._queue.append(key)
            # Bound the terminal-task history alongside the live queue.
            if len(self._tasks) > 4 * self.max_pending + 16:
                for k in [
                    k for k, t in self._tasks.items()
                    if t.state in ("warm", "failed")
                ][: len(self._tasks) - (4 * self.max_pending + 16)]:
                    del self._tasks[k]
        if self.background:
            self._ensure_thread()
            self._wake.set()
        return "queued"

    def status(self, key: str) -> Optional[str]:
        if self.index.is_warm(key):
            return "warm"
        with self._lock:
            task = self._tasks.get(key)
            return task.state if task is not None else None

    def queue_view(self) -> list[dict[str, Any]]:
        with self._lock:
            return [
                t.describe()
                for t in sorted(self._tasks.values(), key=lambda t: t.requested_at)
            ]

    def stats(self) -> dict[str, Any]:
        with self._lock:
            depth = sum(
                1 for t in self._tasks.values() if t.state in ("queued", "running")
            )
            return {
                "queue_depth": depth,
                "started_total": self.started_total,
                "completed_total": self.completed_total,
                "failed_total": self.failed_total,
                "rejected_total": self.rejected_total,
                "max_pending": self.max_pending,
            }

    def pump(self, max_tasks: Optional[int] = None) -> int:
        """Drain queued tasks inline on the caller's thread (the same
        locked pop as the background loop, so both modes can coexist).
        Returns the number of tasks run."""
        ran = 0
        while max_tasks is None or ran < max_tasks:
            with self._lock:
                key = self._queue.popleft() if self._queue else None
                task = self._tasks.get(key) if key else None
            if task is None:
                break
            self._run_one(task)
            ran += 1
        return ran

    def shutdown(self) -> None:
        self._shutdown.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    # -- internals ------------------------------------------------------------

    def _ensure_thread(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="precompile-worker"
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._shutdown.is_set():
            with self._lock:
                key = self._queue.popleft() if self._queue else None
                task = self._tasks.get(key) if key else None
            if task is None:
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue
            self._run_one(task)

    def _run_one(self, task: PrecompileTask) -> None:
        task.state = "running"
        task.started_at = self.clock()
        with self._lock:
            self.started_total += 1
        from tpu_engine_torch import faults

        try:
            inj = faults.get_active()
            if inj is not None and inj.take_precompile_fault(step=0):
                raise PrecompileError(
                    f"injected precompile-error for {task.label or task.key}"
                )
            t0 = self.clock()
            self.compile_fn(task)
            task.compile_s = max(self.clock() - t0, 0.0)
            self.index.record(
                task.key, task.compile_s, cache_hit=False,
                label=task.label,
                model=getattr(task.config, "model_name", "") or "",
                via="precompile",
            )
            task.state = "warm"
            task.finished_at = self.clock()
            with self._lock:
                self.completed_total += 1
            log.info(
                "precompile: warmed %s in %.2fs", task.label or task.key,
                task.compile_s,
            )
        except Exception as e:  # noqa: BLE001 — worker must survive anything
            task.state = "failed"
            task.error = f"{type(e).__name__}: {e}"
            task.finished_at = self.clock()
            with self._lock:
                self.failed_total += 1
            log.warning(
                "precompile: %s failed — %s (grow-back will proceed cold)",
                task.label or task.key, task.error,
            )


# -- process-wide index (the supervisor/scheduler/router default) -------------

_index: Optional[CompileCacheIndex] = None
_index_lock = threading.Lock()


def get_index() -> CompileCacheIndex:
    """The process compile index (created in-memory on first use; attaches
    its sidecar when/if the kernel build directory is enabled)."""
    global _index
    with _index_lock:
        if _index is None:
            _index = CompileCacheIndex()
        return _index


def set_index(index: Optional[CompileCacheIndex]) -> None:
    global _index
    with _index_lock:
        _index = index


def reset_index() -> None:
    set_index(None)
