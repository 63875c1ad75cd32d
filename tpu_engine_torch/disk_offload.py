"""Disk-tier optimizer-state offload, ``optimizer_offload="disk"`` (a
copy of ``tpu_engine/disk_offload.py`` without JAX: the NVMe-offload
analogue).

- **master params, mu, nu live in fp32 memory-mapped files** under a spill
  directory: no device memory, and no resident host memory beyond the slab
  being updated (the page cache stages, ``posix_fadvise`` drives it);
- **the device runs only forward/backward** on compute-dtype params;
- **a fused host AdamW** walks the gradient leaves one at a time: prefetch
  leaf i+1's slabs (``POSIX_FADV_WILLNEED``), update leaf i in place on the
  memmap, hand the new master to the caller (which uploads it), then drop
  leaf i's pages (``POSIX_FADV_DONTNEED``).

The update is the optax chain's (clip on the device → scale_by_adam(b1,
b2, eps=1e-8) → add_decayed_weights(wd, kernel mask) → ``-lr``), so the
tier is step-for-step comparable to the in-memory path. The spill persists:
a restart re-attaches to the exact moments.

Slabs are keyed by the port's flat parameter names (``layers.q.kernel``):
its params are already the flat path-keyed dict JAX's
``flatten_with_paths`` makes. On a mesh every rank is one of JAX's
processes with one device: it spills its own shards in a directory of its
own, and :class:`Uploader` puts each updated master shard on the rank's
device, where JAX's ``AsyncShardUploader`` stitches a process's shards
across its devices. A block is a replicated leaf only where it is the
whole leaf (:func:`is_replicated_upload`).
"""

from __future__ import annotations

import json
import os
import queue
import threading
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

_META = "disk_adamw.json"


def _advise(f, advice: int) -> None:
    """Best-effort fadvise on an open memmap's file descriptor."""
    try:
        size = os.fstat(f.fileno()).st_size
        os.posix_fadvise(f.fileno(), 0, size, advice)
    except (OSError, AttributeError):  # non-POSIX or closed — advisory only
        pass


@dataclass
class _Slab:
    """One parameter leaf's on-disk state: master + mu + nu memmaps."""

    path: str
    shape: tuple[int, ...]
    decay: bool
    master: np.memmap
    mu: np.memmap
    nu: np.memmap

    def files(self):
        return (self.master, self.mu, self.nu)


class DiskAdamW:
    """AdamW whose entire state lives in fp32 memmaps under ``spill_dir``.

    ``initialize(params_host)`` writes masters from a host tree and
    zeroes the moments; if a matching spill already exists (same leaf
    paths, shapes and hyperparameters) it re-attaches instead — the
    moments persist across process restarts. ``update`` applies one
    AdamW step in place, emitting each new master leaf as it lands.
    """

    def __init__(self, spill_dir: str, *, b1: float, b2: float,
                 eps: float = 1e-8, weight_decay: float = 0.0):
        self.dir = spill_dir
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.weight_decay = float(weight_decay)
        self.slabs: dict[str, _Slab] = {}
        self.attached = False
        # The step whose update the spill last absorbed (persisted in the
        # meta file): lets a restart detect that the restored train state
        # is OLDER than the spill (a rollback) and reseed masters from it.
        self.step_on_disk: Optional[int] = None
        # Adam bias-correction counter — SEPARATE from the train step:
        # the LR schedule must keep the restored step across a reseed,
        # while the zeroed moments must bias-correct from t=1 again.
        self.moment_steps: int = 0

    # -- layout --------------------------------------------------------------

    def _meta(self) -> dict[str, Any]:
        return {
            "b1": self.b1, "b2": self.b2, "eps": self.eps,
            "weight_decay": self.weight_decay,
            "step": self.step_on_disk,
            "moment_steps": self.moment_steps,
            "leaves": {
                p: {"shape": list(s.shape), "decay": s.decay}
                for p, s in self.slabs.items()
            },
        }

    def _write_meta(self, extra: Optional[dict[str, Any]] = None) -> None:
        """Crash-atomic meta write (tmp + rename): a kill mid-write must
        never leave truncated JSON — that would fail every later attach
        instead of being refused like any other torn spill."""
        meta = self._meta()
        if extra:
            meta.update(extra)
        path = os.path.join(self.dir, _META)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, path)

    def _slab_path(self, leaf_path: str, kind: str) -> str:
        safe = leaf_path.replace("/", "__")
        return os.path.join(self.dir, f"{safe}.{kind}.f32")

    def _open_slabs(self, shapes: dict[str, tuple[int, ...]],
                    decay_mask: dict[str, bool], mode: str) -> None:
        for path, shape in shapes.items():
            self.slabs[path] = _Slab(
                path=path, shape=tuple(shape), decay=bool(decay_mask[path]),
                master=np.memmap(self._slab_path(path, "master"), np.float32,
                                 mode, shape=tuple(shape)),
                mu=np.memmap(self._slab_path(path, "mu"), np.float32, mode,
                             shape=tuple(shape)),
                nu=np.memmap(self._slab_path(path, "nu"), np.float32, mode,
                             shape=tuple(shape)),
            )

    def try_attach(self, shapes: dict[str, Any],
                   decay_mask: dict[str, bool]) -> bool:
        """Attach to an existing spill iff its meta matches this layout
        and hyperparameters AND the spill is clean (no update died
        mid-walk — a torn spill holds mixed-step state and is discarded
        rather than silently resumed). Needs only SHAPES, so a warm
        restart never materialises a throwaway random init."""
        meta_path = os.path.join(self.dir, _META)
        if not os.path.exists(meta_path):
            return False
        try:
            with open(meta_path) as f:
                have = json.load(f)
        except (json.JSONDecodeError, OSError):
            return False  # unreadable meta == untrustworthy spill
        want_leaves = {
            p: {"shape": list(s), "decay": bool(decay_mask[p])}
            for p, s in shapes.items()
        }
        if have.get("in_progress") is not None:
            return False  # torn mid-update — not trustworthy
        if have.get("leaves") != want_leaves or not all(
            have.get(k) == getattr(self, k)
            for k in ("b1", "b2", "eps", "weight_decay")
        ):
            return False
        try:
            self._open_slabs({p: tuple(s) for p, s in shapes.items()},
                             decay_mask, "r+")
        except (FileNotFoundError, ValueError, OSError):
            # Meta survived but slab files are missing/truncated (partial
            # cleanup or copy) — an untrustworthy spill falls back to
            # fresh init like every other one.
            self.slabs.clear()
            return False
        self.step_on_disk = have.get("step")
        self.moment_steps = int(have.get("moment_steps", 0))
        self.attached = True
        return True

    def initialize(self, params_host: Any,
                   decay_mask: dict[str, bool],
                   shapes: Optional[dict[str, tuple[int, ...]]] = None,
                   force_fresh: bool = False) -> bool:
        """Create (or re-attach to) the spill. ``params_host`` maps leaf
        path → fp32 ndarray, OR is a callable ``path -> ndarray`` fetched
        one leaf at a time (bounded host residency — the tier's whole
        point; pass ``shapes`` alongside). Returns True when an existing
        spill was re-attached (masters/moments kept — the caller should
        trust the DISK masters over its own init values).
        ``force_fresh`` skips the attach attempt (a caller that has
        decided to reseed)."""
        os.makedirs(self.dir, exist_ok=True)
        fetch = params_host if callable(params_host) else params_host.get
        if shapes is None:
            if callable(params_host):
                raise ValueError("callable params_host requires shapes")
            shapes = {p: tuple(np.shape(a)) for p, a in params_host.items()}
        if force_fresh:
            self.slabs.clear()
            self.attached = False
            self.step_on_disk = None
            self.moment_steps = 0
        elif not self.slabs and self.try_attach(shapes, decay_mask):
            return True
        self.slabs.clear()
        # Fresh seed: drop slab files from any PREVIOUS layout (another
        # model's leaves) — a failed attach would otherwise leave them
        # orphaned on disk forever, silently doubling spill usage.
        want = {
            self._slab_path(p, kind)
            for p in shapes for kind in ("master", "mu", "nu")
        }
        for f in os.listdir(self.dir):
            full = os.path.join(self.dir, f)
            if f.endswith(".f32") and full not in want:
                try:
                    os.remove(full)
                except OSError:
                    pass
        self._open_slabs(shapes, decay_mask, "w+")
        for path in shapes:
            slab = self.slabs[path]
            slab.master[...] = np.asarray(fetch(path), np.float32)
            slab.mu[...] = 0.0
            slab.nu[...] = 0.0
            for f in slab.files():
                f.flush()
        self.step_on_disk = None
        self._write_meta()
        self.attached = False
        return False

    def masters(self) -> dict[str, np.ndarray]:
        """Read back the fp32 master tree (copies, not memmap views).
        Materialises every leaf — callers with bounded-residency needs
        should iterate ``slabs`` and copy one master at a time."""
        return {p: np.array(s.master) for p, s in self.slabs.items()}

    def reseed_masters(self, params_host: Any,
                       step: Optional[int] = None,
                       cast_dtype: Any = None) -> None:
        """Restart the trajectory from a (restored) param tree: masters
        overwritten, moments ZEROED — exactly what loading a checkpoint
        without optimizer state does. (Keeping moments "warm" across a
        step discontinuity would apply the wrong Adam bias correction:
        ``t`` restarts small while mu/nu stay converged, inflating the
        corrected moments by up to 1/(1-b1).)

        ``params_host`` is a dict OR a callable ``path -> ndarray``
        (leaf-at-a-time, bounded residency). ``cast_dtype``: the compute
        dtype the incoming params were truncated to (a torch dtype, e.g.
        ``torch.bfloat16``) —
        where the existing fp32 master still rounds to exactly the
        incoming value, the MASTER is kept, so a reseed from a state
        that never actually diverged (warm re-attach without a restored
        step counter) does not silently shave the masters to bf16."""
        fetch = params_host if callable(params_host) else params_host.get
        for path, slab in self.slabs.items():
            incoming = np.asarray(fetch(path), np.float32)
            if cast_dtype is not None:
                rounded = torch.from_numpy(np.array(slab.master)).to(cast_dtype).float().numpy()
                keep = rounded == incoming
                slab.master[...] = np.where(keep, slab.master, incoming)
            else:
                slab.master[...] = incoming
            slab.mu[...] = 0.0
            slab.nu[...] = 0.0
            for f in slab.files():
                f.flush()
        self.step_on_disk = step
        self.moment_steps = 0
        self._write_meta()

    # -- the update ----------------------------------------------------------

    def update(self, grads: dict[str, Any], lr: float, step: int,
               emit) -> None:
        """One AdamW step over every slab. ``grads`` maps slab key →
        a tensor OR a callable returning the host block or a tensor
        (already clipped, fp32); ``step`` is the POST-update
        TRAIN step (bookkeeping only — bias correction uses the internal
        ``moment_steps`` counter, which survives restarts and resets with
        the moments on reseed). ``emit(path, new_master_fp32)`` receives
        each updated leaf immediately, so the caller can overlap the
        device upload of leaf i with the disk update of leaf i+1.

        Crash safety: the meta file carries an ``in_progress`` marker for
        the duration of the walk — a spill whose process died mid-update
        holds mixed-step slabs, and the marker makes the next
        ``try_attach`` refuse it instead of silently resuming."""
        b1, b2, eps, wd = self.b1, self.b2, self.eps, self.weight_decay
        t_bias = self.moment_steps + 1
        c1 = 1.0 - b1 ** t_bias
        c2 = 1.0 - b2 ** t_bias
        self._write_meta(extra={"in_progress": step})
        order = list(self.slabs)
        # Kick kernel readahead for the first leaf's slabs, then always
        # stay one leaf ahead of the update loop.
        if order:
            for f in self.slabs[order[0]].files():
                _advise(f, os.POSIX_FADV_WILLNEED)
        # One-leaf-ahead gradient D2H: a fetcher thread pulls leaf i+1
        # off the device while the main thread's numpy update crunches
        # leaf i — the transfer and the math overlap instead of strictly
        # alternating. In the SERIAL walk regime (the default) the gets
        # contend with nothing — the device finished this step's compute
        # before the walk starts; under ``disk_update_overlap`` they
        # share the wire with step N+1's execution (see that config
        # field's measured caveat). The depth-1 queue bounds host
        # residency at THREE gradient leaves (one being updated, one
        # queued, one in the fetcher's in-flight device_get) — still
        # O(leaf), never the tree; ``abort`` poisons the fetcher if the
        # walk dies mid-update, so a failure never strands a thread
        # blocked on the queue pinning the whole device gradient tree.
        fetched: "queue.Queue" = queue.Queue(maxsize=1)
        abort = threading.Event()

        def _put(item) -> bool:
            while not abort.is_set():
                try:
                    fetched.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def _host(v) -> np.ndarray:
            # Slab keys map to a deferred fetch (a callable returning the
            # host block) or to a tensor on any device.
            if callable(v):
                v = v()
            if isinstance(v, torch.Tensor):
                v = v.detach().to("cpu", torch.float32).numpy()
            return np.asarray(v, np.float32)

        def _fetch() -> None:
            try:
                for p in order:
                    if not _put((p, _host(grads[p]))):
                        return
                _put(None)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                _put(e)

        fetcher = threading.Thread(target=_fetch, daemon=True,
                                   name="disk-grad-fetch")
        fetcher.start()
        try:
            for i, path in enumerate(order):
                if i + 1 < len(order):
                    for f in self.slabs[order[i + 1]].files():
                        _advise(f, os.POSIX_FADV_WILLNEED)
                slab = self.slabs[path]
                item = fetched.get()
                if isinstance(item, BaseException):
                    raise item
                _, g = item
                if g.shape != slab.shape:
                    raise ValueError(
                        f"grad leaf {path} shape {g.shape} != master {slab.shape}"
                    )
                mu, nu, w = slab.mu, slab.nu, slab.master
                mu *= b1
                mu += (1.0 - b1) * g
                nu *= b2
                nu += (1.0 - b2) * np.square(g)
                u = (mu / c1) / (np.sqrt(nu / c2) + eps)
                if slab.decay and wd:
                    u += wd * w
                w -= lr * u
                emit(path, w)
                for f in slab.files():
                    f.flush()
                    _advise(f, os.POSIX_FADV_DONTNEED)
        finally:
            abort.set()
            fetcher.join()
        self.step_on_disk = step
        self.moment_steps = t_bias
        self._write_meta()  # clean meta — clears in_progress

    def spill_bytes(self) -> int:
        return sum(3 * int(np.prod(s.shape)) * 4 for s in self.slabs.values())


def is_replicated_upload(block_shape: tuple, leaf_shape: tuple) -> bool:
    """Whether an uploaded block stands for the whole leaf, replicated on
    every rank that holds it (JAX's ``is_replicated_upload`` with one
    device a process): a rank's block of a leaf its mesh splits is a
    fraction of the leaf, and only a block that *is* the full leaf may be
    placed as a replicated one."""
    return tuple(block_shape) == tuple(leaf_shape)


class Uploader:
    """Overlaps device uploads of updated masters with the next leaf's disk
    update: ``emit`` hands a copy of the fp32 master to ONE worker thread
    (depth-1 queue), which casts it to ``dtype`` on the host and copies it
    to ``device`` on ``stream`` (the current stream if None) while the
    walk goes on. At most two copies are resident (one queued, one
    uploading), never the whole fp32 tree. ``result()`` joins, orders the
    caller's stream after the uploads, and returns leaf → device tensor."""

    def __init__(self, device, dtype: torch.dtype, stream=None):
        self._device, self._dtype, self._stream = torch.device(device), dtype, stream
        self._out: dict[str, torch.Tensor] = {}
        self._err: Optional[BaseException] = None
        self._q: "queue.Queue[Optional[tuple[str, np.ndarray]]]" = queue.Queue(maxsize=1)
        self._worker = threading.Thread(target=self._drain, daemon=True)
        self._worker.start()

    def _drain(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            key, arr = item
            try:
                block = torch.from_numpy(arr).to(self._dtype)
                if self._stream is None:
                    self._out[key] = block.to(self._device)
                else:
                    with torch.cuda.stream(self._stream):
                        self._out[key] = block.to(self._device)
            except BaseException as e:  # noqa: BLE001 — rethrown by emit() / result()
                self._err = e

    def emit(self, key: str, master: np.ndarray) -> None:
        # A failed upload poisons the walk: raise here, so the walk stops
        # with its in_progress marker (the next attach refuses the torn
        # spill) rather than writing a clean meta one step ahead of the
        # uploaded state.
        if self._err is not None:
            raise self._err
        # Copy now: the memmap's pages are advised away after the emit.
        self._q.put((key, np.array(master, dtype=np.float32)))

    def close(self) -> None:
        """Stop the worker without raising (the failure path's companion
        to ``result()``)."""
        if self._worker.is_alive():
            self._q.put(None)
            self._worker.join()

    def result(self) -> dict[str, torch.Tensor]:
        self.close()
        if self._err is not None:
            raise self._err
        if self._stream is not None:
            cur = torch.cuda.current_stream(self._device)
            cur.wait_stream(self._stream)
            for t in self._out.values():
                t.record_stream(cur)
        return dict(self._out)


class WalkInFlight:
    """One ``DiskAdamW.update`` running on its own thread, paired with its
    :class:`Uploader`: the host half of delayed-parameter-update overlap
    (``disk_update_overlap``). While this walk drains, the caller returns
    to the train loop and the device computes the next step's
    forward/backward. ``join`` returns the uploaded compute-dtype leaves
    (or raises the walk's error); ``discard`` joins without raising, for
    abandoning a walk after a rollback."""

    def __init__(self, store: DiskAdamW, grads_flat: dict[str, Any],
                 lr: float, step: int, uploader: Uploader):
        self.step = int(step)
        self._up = uploader
        self._err: Optional[BaseException] = None

        def run() -> None:
            try:
                store.update(grads_flat, lr, self.step, self._up.emit)
            except BaseException as e:  # noqa: BLE001 — rethrown in join()
                self._err = e
            finally:
                self._up.close()

        self._t = threading.Thread(target=run, daemon=True, name=f"disk-walk-{step}")
        self._t.start()

    def join(self) -> dict[str, torch.Tensor]:
        self._t.join()
        if self._err is not None:
            raise self._err
        return self._up.result()

    def discard(self) -> None:
        self._t.join()
        self._up.close()
