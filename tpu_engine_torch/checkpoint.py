"""Checkpoints with a stable pointer, rollback and quarantine (port of
``tpu_engine/checkpoint.py``). Orbax becomes ``torch.distributed.checkpoint``
(DCP).

:class:`TrainCheckpointManager` keeps JAX's surface and semantics:

- ``save`` is asynchronous unless ``wait=True``: it snapshots the state on
  its device (the next step's in-place update cannot race the write), and
  a thread writes the snapshot; ``save_interval_steps``, ``max_to_keep``,
  ``metrics`` and Orbax's skip of a step at or below the latest one are
  honoured, and a step already saved returns False;
- a stable pointer (``stable.json``): steps marked stable only after the
  loss monitor saw a healthy window beyond them, for rollback;
- validation on restore: a step that fails to load is quarantined and the
  next older one tried.

A step is the directory ``<dir>/<step>`` (written as ``<step>.tmp`` and
renamed once every rank is done): DCP's files and ``metrics.json``. On a
mesh a rank's ZeRO shards are saved with their place in the whole leaf,
wrapped as ``DTensor.from_local`` on the program's ``DeviceMesh`` for the
save and the load only, so every rank writes only its shards and a
replicated shard is written once. Without a program (one device) every
leaf is whole. DCP's planning collectives run over a ``gloo`` group of
their own, on the save thread.

The fault seam is the explicit, duck-typed injector (``take_save_fault``,
``take_restore_fault``). JAX's process-wide injector and its trace spans
have no counterpart yet. A URL directory (``gs://``) raises
``NotImplementedError``: there is no object-store client.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time
from typing import Any, Optional

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

_STABLE_POINTER = "stable.json"
_METRICS = "metrics.json"
_SEP = "/"


def resolve_checkpoint_dir(directory: str) -> str:
    """A local directory made absolute (``~`` expanded). A URL (``gs://``,
    ``s3://``) raises ``NotImplementedError``: the port has no object-store
    client."""
    if "://" in directory:
        raise NotImplementedError(
            f"checkpoint directory {directory!r}: object stores are not ported (no "
            "object-store client); use a local or mounted path")
    return os.path.abspath(os.path.expanduser(directory))


# ---------------------------------------------------------------------------
# State trees and their placement
# ---------------------------------------------------------------------------


def flatten_state(state: dict, prefix: str = "") -> dict[str, Any]:
    """``state``'s leaves (tensors and scalars) under ``/``-joined paths;
    dotted parameter keys stay whole."""
    out: dict[str, Any] = {}
    for k, v in state.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten_state(v, path + _SEP))
        else:
            out[path] = v
    return out


def unflatten_state(flat: dict[str, Any]) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *parts, leaf = path.split(_SEP)
        for p in parts:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def leaf_splits(program, flat: dict[str, Any]) -> dict[str, list[tuple[int, int]]]:
    """Each tensor leaf of a flattened state of ``program``: the (mesh dim,
    tensor dim) pairs that split it on this rank (``fsdp`` and ``model``;
    empty where the rank holds it whole). ``program`` None or off a mesh:
    every leaf whole. Parameters and hpZ's store are split as stage 3's
    shards, the optimizer's tensors as its view (shards at stage >= 1),
    Adafactor's factored moments with the reduced dim taken out."""
    from tpu_engine_torch.mesh_runtime import MESH_AXES

    z = getattr(program, "zero", None)
    out = {k: [] for k, v in flat.items() if isinstance(v, torch.Tensor)}
    if z is None:
        return out
    if program.pipe is not None:
        raise NotImplementedError(
            "checkpoints of a pipe > 1 program are not ported: a stage's outer leaves "
            "live on some stages only (ROADMAP Queue 1, item 2.5)")
    i_fsdp, i_model = MESH_AXES.index("fsdp"), MESH_AXES.index("model")
    tx = program.tx
    for path in out:
        parts = path.split(_SEP)
        key = parts[-1]
        if parts[0] in ("params", "hpz"):
            fsdp = z.dims[key] if z.params_split else None
        elif parts[0] == "opt_state":
            fsdp = z.dims[key] if z.state_split else None
        else:
            continue
        splits = [(i_fsdp, fsdp), (i_model, z.mdims[key] if z.model is not None else None)]
        if parts[0] == "opt_state" and parts[1] in ("v_row", "v_col"):
            whole = tx.shapes.get(key)
            d1, d0 = tx._dims(key, torch.empty(whole, device="meta")) if whole else (None, None)
            gone = d0 if parts[1] == "v_row" else d1
            splits = [(m, None if d is None or d == gone else (d - 1 if d > gone else d))
                      for m, d in splits]
        out[path] = [(m, d) for m, d in splits if d is not None]
    return out


def _whole_shape(t: torch.Tensor, splits, mesh_shape) -> tuple[int, ...]:
    shape = list(t.shape)
    for m, d in splits:
        shape[d] *= mesh_shape[m]
    return tuple(shape)


def _dcp_leaf(t: torch.Tensor, splits, device_mesh, mesh_shape):
    """``t`` as DCP takes it: itself (whole), or a ``DTensor`` of its
    place in the whole leaf (sharing ``t``'s storage)."""
    if not splits:
        return t
    from torch.distributed.tensor import DTensor, Replicate, Shard

    placements = [Replicate()] * len(mesh_shape)
    for m, d in splits:
        placements[m] = Shard(d)
    shape = _whole_shape(t, splits, mesh_shape)
    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    return DTensor.from_local(t.contiguous(), device_mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def abstract_state_like(program) -> dict:
    """JAX's ``abstract_state_like``: a state of ``program``'s shapes on
    its ranks to restore into (its values are overwritten): a fresh
    ``program.init()``."""
    return program.init()


# ---------------------------------------------------------------------------
# The manager
# ---------------------------------------------------------------------------


class TrainCheckpointManager:
    """DCP checkpoints with a stable pointer and quarantine-on-corrupt.
    ``program``: the ``TrainProgram`` whose states are saved and restored
    (their placement on its mesh); None for whole leaves on one device."""

    def __init__(self, directory: str, max_to_keep: int = 3, save_interval_steps: int = 1,
                 async_save: bool = True, fault_injector: Optional[Any] = None,
                 program: Any = None):
        self._fault_injector = fault_injector
        self.directory = resolve_checkpoint_dir(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self.async_save = async_save
        self.program = program
        self._lock = threading.Lock()
        self._quarantined: set[int] = set()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._joined = dist.is_available() and dist.is_initialized()
        # DCP's planning collectives on a gloo group of their own (made on
        # every rank, in the same order, here).
        self._pg = dist.new_group(backend="gloo") if self._joined else None
        self._rank = dist.get_rank() if self._joined else 0
        self.last_save = {}  # seconds and bytes of the last save

    def _injector(self):
        return self._fault_injector

    # -- save ----------------------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def _should_save(self, step: int) -> bool:
        """Orbax's ``should_save``: a step after the latest, on the interval."""
        latest = self._latest_on_disk()
        if latest is not None and latest >= step:
            return False
        return self.save_interval_steps > 0 and step % self.save_interval_steps == 0

    def save(self, step: int, state: dict, metrics: Optional[dict[str, float]] = None,
             force: bool = False, wait: bool = False) -> bool:
        """Save ``state`` as ``step``: asynchronous (the state snapshotted on
        its device first) unless ``wait`` or ``async_save=False``. Returns
        False for a step that should not be saved (unless ``force``) or is
        saved already."""
        with self._lock:
            inj = self._injector()
            if inj is not None and inj.take_save_fault(step):
                raise OSError(f"injected fault: checkpoint-save-ioerror at step {step}")
            self.wait_until_finished()
            if not force and not self._should_save(step):
                return False
            if step in self._steps_on_disk():
                return False
            t0 = time.perf_counter()
            flat = flatten_state(state)
            splits = leaf_splits(self.program, flat)
            snap = {k: (v.detach().clone() if isinstance(v, torch.Tensor) else v)
                    for k, v in flat.items()}
            ready = None
            devices = {v.device for v in snap.values() if isinstance(v, torch.Tensor)}
            cuda = [d for d in devices if d.type == "cuda"]
            if cuda:
                ready = torch.cuda.current_stream(cuda[0]).record_event()
            self.last_save = {"dispatch_s": time.perf_counter() - t0,
                              "bytes": sum(v.numel() * v.element_size() for v in snap.values()
                                           if isinstance(v, torch.Tensor))}
            self._error = None
            job = (step, snap, splits, metrics, ready, t0)
            if wait or not self.async_save:
                self._write(*job)
                self._raise_error()
                return True
            self._thread = threading.Thread(target=self._write, args=job, daemon=True,
                                            name=f"checkpoint-save-{step}")
            self._thread.start()
            return True

    def _write(self, step, snap, splits, metrics, ready, t0) -> None:
        """Write one snapshot (on the save thread, or inline): DCP into
        ``<step>.tmp``, then on rank 0 the metrics, the rename and the
        retention; every rank waits for that before it returns."""
        import torch.distributed.checkpoint as dcp

        try:
            if ready is not None:
                ready.synchronize()
            mesh = getattr(getattr(self.program, "runtime", None), "mesh", None)
            shape = tuple(getattr(self.program.runtime, "shape", ())) if mesh is not None else ()
            sd = {k: (_dcp_leaf(v, splits[k], mesh, shape) if isinstance(v, torch.Tensor) else v)
                  for k, v in snap.items()}
            tmp = self._step_dir(step) + ".tmp"
            if self._rank == 0 and os.path.exists(tmp):
                shutil.rmtree(tmp)
            self._barrier()
            dcp.save(sd, checkpoint_id=tmp, process_group=self._pg, no_dist=not self._joined)
            if self._rank == 0:
                if metrics is not None:
                    with open(os.path.join(tmp, _METRICS), "w") as f:
                        json.dump({k: float(v) for k, v in metrics.items()}, f)
                os.replace(tmp, self._step_dir(step))
                self._retain()
            self._barrier()
            self.last_save["write_s"] = time.perf_counter() - t0
        except BaseException as e:  # surfaced by wait_until_finished / the next save
            self._error = e
            log.error("checkpoint save of step %s failed: %r", step, e)

    def _barrier(self) -> None:
        if self._pg is not None:
            dist.barrier(group=self._pg)

    def _retain(self) -> None:
        """Orbax's ``max_to_keep``: the newest steps kept, older ones deleted."""
        if not self.max_to_keep:
            return
        steps = self._steps_on_disk()
        for s in steps[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def _join(self) -> None:
        t, self._thread = self._thread, None
        if t is not None:
            t.join()

    def _raise_error(self) -> None:
        err, self._error = self._error, None
        if err is not None:
            raise err

    def wait_until_finished(self) -> None:
        """Join the save in flight; raise what it raised."""
        self._join()
        self._raise_error()

    def save_with_retry(self, step: int, state: dict, metrics: Optional[dict[str, float]] = None,
                        retries: int = 3, backoff_base_s: float = 0.05,
                        on_attempt: Optional[Any] = None) -> bool:
        """Synchronous save with bounded exponential-backoff retry; after
        ``retries`` extra attempts the step is quarantined and False
        returned. Never raises (JAX's)."""
        delay = backoff_base_s
        for attempt in range(retries + 1):
            try:
                self.save(step, state, metrics=metrics, force=True, wait=True)
                return True
            except Exception as e:  # noqa: BLE001 — the retry path must survive anything
                if on_attempt is not None:
                    try:
                        on_attempt(attempt + 1, f"{type(e).__name__}: {e}")
                    except Exception:
                        pass
                if attempt < retries:
                    time.sleep(delay)
                    delay = min(delay * 2.0, 2.0)
        self.quarantine(step)
        return False

    # -- stable pointer ------------------------------------------------------

    def _stable_path(self) -> str:
        return os.path.join(self.directory, _STABLE_POINTER)

    def mark_stable(self, step: int) -> None:
        """Record ``step`` as the newest known-good checkpoint: a tmp file,
        fsync, rename, and the directory fsynced (best effort)."""
        payload = json.dumps({"step": int(step), "timestamp": time.time()})
        path = self._stable_path()
        tmp = f"{path}.{self._rank}.tmp"
        with open(tmp, "w") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        try:
            dfd = os.open(self.directory, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass

    def last_stable_step(self) -> Optional[int]:
        try:
            with open(self._stable_path()) as f:
                step = int(json.loads(f.read())["step"])
        except (OSError, ValueError, KeyError, json.JSONDecodeError):
            return None
        return step if step in self.all_steps() else None

    # -- introspection -------------------------------------------------------

    def _steps_on_disk(self) -> list[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isdir(os.path.join(self.directory, n)))

    def _latest_on_disk(self) -> Optional[int]:
        steps = self._steps_on_disk()
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        return [s for s in self._steps_on_disk() if s not in self._quarantined]

    def quarantine(self, step: int) -> None:
        """Exclude ``step`` from restore/latest candidates (suspect data)."""
        self._quarantined.add(int(step))

    def quarantined_steps(self) -> list[int]:
        return sorted(self._quarantined)

    def delete_after(self, step: int) -> None:
        """Delete checkpoints newer than ``step`` (after a rollback, so a
        crash-restart cannot prefer them); one that will not go is
        quarantined."""
        self._join()
        for s in self._steps_on_disk():
            if s > step:
                shutil.rmtree(self._step_dir(s), ignore_errors=True)
                if os.path.exists(self._step_dir(s)):
                    self._quarantined.add(s)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def metrics(self, step: int) -> Optional[dict[str, float]]:
        try:
            with open(os.path.join(self._step_dir(step), _METRICS)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    # -- restore -------------------------------------------------------------

    def _load(self, step: int, state_like: dict, program) -> dict:
        """Load ``step`` into ``state_like``'s tensors in place; returns the
        state with its scalars loaded."""
        import torch.distributed.checkpoint as dcp

        path = self._step_dir(step)
        if not os.path.isdir(path):
            raise FileNotFoundError(path)
        flat = flatten_state(state_like)
        splits = leaf_splits(program, flat)
        mesh = getattr(getattr(program, "runtime", None), "mesh", None)
        shape = tuple(program.runtime.shape) if mesh is not None else ()
        sd = {k: (_dcp_leaf(v.detach(), splits[k], mesh, shape) if isinstance(v, torch.Tensor)
                  else v) for k, v in flat.items()}
        views = {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}
        with torch.no_grad():
            dcp.load(sd, checkpoint_id=path, process_group=self._pg, no_dist=not self._joined)
        out = {}
        for k, v in flat.items():
            if not isinstance(v, torch.Tensor):
                out[k] = sd[k]
                continue
            loaded = views[k]
            local = loaded.to_local() if hasattr(loaded, "to_local") else loaded
            if local.data_ptr() != v.data_ptr():
                with torch.no_grad():
                    v.copy_(local)
            out[k] = v
        return unflatten_state(out)

    def restore(self, state_like: dict, step: Optional[int] = None, fall_back: bool = True,
                placed: bool = True) -> tuple[Optional[int], Optional[dict]]:
        """Restore ``step`` (default: the latest) into ``state_like`` (a
        state of the manager program's shapes on its ranks,
        :func:`abstract_state_like`; loaded in place). A step that fails to
        load is quarantined; with ``fall_back`` the next older one is tried.
        Returns (step, state), or (None, None) when nothing loads. With
        ``placed=False`` ``state_like`` holds whole leaves and every leaf
        is read whole (JAX's single-replica host form)."""
        self.wait_until_finished()
        program = self.program if placed else None
        candidates = [step] if step is not None else list(reversed(self.all_steps()))
        for s in candidates:
            try:
                inj = self._injector()
                if inj is not None and inj.take_restore_fault(s):
                    raise OSError(f"injected fault: checkpoint-restore-corruption at step {s}")
                return s, self._load(s, state_like, program)
            except Exception:
                self._quarantined.add(s)
                if not fall_back:
                    raise
        return None, None

    def restore_resharded(self, state_like: dict, step: Optional[int] = None,
                          fall_back: bool = True, saved_topology: Optional[dict] = None,
                          program: Any = None) -> tuple[Optional[int], Optional[dict]]:
        """Restore onto a mesh the checkpoint was not saved under: every leaf
        read whole, re-placed onto ``state_like``'s ranks behind the
        checksum parity gate (:func:`tpu_engine_torch.reshard.restore_resharded`).
        Same return as :meth:`restore`."""
        from tpu_engine_torch import reshard

        s, state, _ = reshard.restore_resharded(
            self, state_like, step=step, fall_back=fall_back, saved_topology=saved_topology,
            program=self.program if program is None else program)
        return s, state

    def restore_stable(self, state_like: dict, before_step: Optional[int] = None):
        """Restore the last stable checkpoint (optionally strictly before a
        step); without a usable pointer, the newest that loads."""
        stable = self.last_stable_step()
        if stable is not None and (before_step is None or stable < before_step):
            step, state = self.restore(state_like, step=stable)
            if state is not None:
                return step, state
        for s in reversed(self.all_steps()):
            if before_step is not None and s >= before_step:
                continue
            step, state = self.restore(state_like, step=s)
            if state is not None:
                return step, state
        return None, None

    def close(self) -> None:
        self.wait_until_finished()
