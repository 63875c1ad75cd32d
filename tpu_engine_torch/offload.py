"""Where the training state lives: host memory for the optimizer state
(``optimizer_offload="host"``), the master weights (``param_offload=
"host"``) and the products ``offload_dots`` keeps, streamed through the
device (port of the host placements of ``tpu_engine/train.py``; the design
of ZeRO-Offload, ``PAPERS.md``).

JAX places an offloaded subtree in ``pinned_host`` memory and moves all of
it to the device for the update. On one card that would put all of a 7B
model's moments on the device at once, so the port streams instead:

- :class:`HostArena` holds a tree of tensors in one host buffer, page-locked
  with ``cudaHostRegister`` on a CUDA machine (torch's caching host
  allocator would round each pinned block up to a power of two: a 5.77 GB
  leaf would take 8 GiB);
- :class:`UpdateWalk` runs the optimizer over *units* (a leaf, or a run of
  whole layers of a stacked leaf), copying unit i + 1's host tensors to the
  device on one stream while unit i updates on the compute stream, and unit
  i's results back on a third;
- :class:`HostParams` streams one layer's masters to the device at a time
  inside the checkpointed block (the recompute streams it again);
- :class:`GradSums` sums a step's gradients over its microbatches in fp32
  on the device, for every placement;
- :class:`HostStash` keeps device tensors in page-locked blocks of their
  exact size, reused from step to step (``offload_dots``' cache).

Host copies run on the two streams of :func:`copy_streams`. The arithmetic
on the device is the in-memory program's, unit by unit, so the offloaded
programs equal it bitwise. On the CPU the "host" is the device: the walk
still copies each unit in and out, and nothing is pinned.
"""

from __future__ import annotations

import collections
import weakref
from collections.abc import Mapping
from typing import Iterator, Optional

import torch

# A unit of the update holds at most this many elements of its leaf (256 MiB
# of fp32), so the device holds a few units' copies, never a whole moment.
UNIT_ELEMS = 1 << 26
# Units whose results may still be on their way to the host before the walk
# waits for the oldest: bounds the device copies in flight.
IN_FLIGHT = 3
_ALIGN = 256


def _unregister(ptr: int) -> None:
    torch.cuda.synchronize()  # no copy may still read or write the buffer
    torch.cuda.cudart().cudaHostUnregister(ptr)


class HostArena:
    """The tensors of ``like`` (name → tensor, any device, meta included) in
    one host buffer: copies of their values, or zeros for meta tensors.
    With ``pin`` the buffer is page-locked (``cudaHostRegister``), so copies
    to and from the card run asynchronously at the bus's rate; pinning
    needs CUDA and raises without it, and a registration that fails raises
    with the bytes it needed. Each tensor of :attr:`tensors` keeps the
    arena alive; the buffer is unregistered when the last one goes, or
    at :attr:`unpin`'s call."""

    def __init__(self, like: dict[str, torch.Tensor], pin: bool):
        offsets, total = {}, 0
        for k, t in like.items():
            offsets[k] = total
            total += -(-t.numel() * t.element_size() // _ALIGN) * _ALIGN
        self.nbytes = total
        self.pinned = False
        try:
            self.buffer = torch.empty(total, dtype=torch.uint8)
        except RuntimeError as e:
            raise RuntimeError(f"host offload needs {total} bytes of host memory: {e}") from e
        self.tensors = {}
        for k, t in like.items():
            nb = t.numel() * t.element_size()
            view = self.buffer[offsets[k]:offsets[k] + nb].view(t.dtype).view(t.shape)
            if t.is_meta:
                view.zero_()
            else:
                view.copy_(t.detach())
            view._host_arena = self
            self.tensors[k] = view
        if pin and total:
            if not torch.cuda.is_available():
                raise RuntimeError("pinning host memory needs CUDA")
            ptr = self.buffer.data_ptr()
            err = torch.cuda.cudart().cudaHostRegister(ptr, total, 0)
            if int(err) != 0:
                raise RuntimeError(f"host offload could not pin {total} bytes of host memory "
                                   f"(cudaHostRegister: {err})")
            self.pinned = True
            self.unpin = weakref.finalize(self, _unregister, ptr)


_STREAMS: dict = {}


def _device(device) -> torch.device:
    """``device`` with its index (a bare "cuda" is the current card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def copy_streams(device) -> tuple:
    """The device's two copy streams, made once: (host→device,
    device→host)."""
    device = _device(device)
    if device not in _STREAMS:
        _STREAMS[device] = (torch.cuda.Stream(device), torch.cuda.Stream(device))
    return _STREAMS[device]


def pinned_bytes(*trees: dict) -> int:
    """Bytes of the page-locked arenas behind the tensors of ``trees``
    (each counted once)."""
    arenas = {id(a): a for tree in trees for t in tree.values()
              if (a := getattr(t, "_host_arena", None)) is not None and a.pinned}
    return sum(a.nbytes for a in arenas.values())


def update_units(params: dict[str, torch.Tensor], split: bool) -> list[tuple[str, slice]]:
    """The units of an update: (leaf, rows of its first dim). With ``split``
    (an elementwise optimizer) a leaf of more than :data:`UNIT_ELEMS`
    elements is cut into runs of whole rows (layers, for a stacked leaf);
    otherwise each leaf is one unit."""
    out = []
    for k, p in params.items():
        if split and p.dim() and p.numel() > UNIT_ELEMS:
            rows = max(1, UNIT_ELEMS // (p.numel() // p.shape[0]))
            out += [(k, slice(a, min(a + rows, p.shape[0]))) for a in range(0, p.shape[0], rows)]
        else:
            out.append((k, slice(None)))
    return out


class UpdateWalk:
    """The device side of an optimizer update over :func:`update_units`.

    ``host_params`` / ``host_state``: the masters / the optimizer's tensors
    live in host memory; a unit's share of them is copied to the device
    before it updates and back after. Otherwise they are used in place.
    :attr:`bytes` counts what crossed the bus each way."""

    def __init__(self, device, host_params: bool = False, host_state: bool = False):
        self.device = torch.device(device)
        self.host_params, self.host_state = host_params, host_state
        self.cuda = self.device.type == "cuda"
        self.bytes = {"h2d": 0, "d2h": 0}

    def _moved(self, name: str) -> bool:
        return self.host_params if name == "p" else self.host_state

    def _load(self, src: dict[str, torch.Tensor]):
        moved = [n for n in src if self._moved(n)]
        if not moved:
            return {}, None
        self.bytes["h2d"] += sum(src[n].numel() * src[n].element_size() for n in moved)
        if not self.cuda:
            return {n: src[n].clone() for n in moved}, None
        s_in = copy_streams(self.device)[0]
        with torch.cuda.stream(s_in):
            dev = {n: torch.empty(src[n].shape, dtype=src[n].dtype, device=self.device)
                   .copy_(src[n], non_blocking=True) for n in moved}
            return dev, s_in.record_event()

    def _store(self, key: str, src: dict[str, torch.Tensor], dev: dict[str, torch.Tensor]):
        """Copy unit ``key``'s device results back to its host tensors;
        returns the event the copies end on (None on the CPU)."""
        self.bytes["d2h"] += sum(t.numel() * t.element_size() for t in dev.values())
        if not self.cuda:
            for n, t in dev.items():
                src[n].copy_(t)
            return None
        s_out = copy_streams(self.device)[1]
        done = torch.cuda.current_stream(self.device).record_event()
        with torch.cuda.stream(s_out):
            s_out.wait_event(done)
            for n, t in dev.items():
                src[n].copy_(t, non_blocking=True)
                t.record_stream(s_out)
            return s_out.record_event()

    def walk(self, params: dict, grads: dict, state: dict,
             split: bool) -> Iterator[tuple[str, torch.Tensor, torch.Tensor, dict]]:
        """Yield (leaf, p, g, the optimizer's tensors of the unit) on the
        device, in :func:`update_units` order; the caller updates p and the
        optimizer's tensors in place before taking the next unit. Unit
        i + 1's copies in are issued before unit i is yielded. On return
        every result is back in host memory."""
        trees = {n: t for n, t in state.items() if n != "count"}
        units = update_units(params, split)

        def source(k, sl):
            src = {"p": params[k][sl]}
            src.update({n: tree[k][sl] for n, tree in trees.items() if k in tree})
            return src

        if self.cuda:
            # Host copies of the last walk (and anything the compute stream
            # wrote before this one) land before any unit is read.
            copy_streams(self.device)[0].wait_stream(torch.cuda.current_stream(self.device))

        def load(k, sl):
            src = source(k, sl)
            return (src, *self._load(src))

        written = collections.deque()
        nxt = load(*units[0]) if units else None
        for i, (k, sl) in enumerate(units):
            src, dev, ready = nxt
            nxt = load(*units[i + 1]) if i + 1 < len(units) else None
            if ready is not None:
                cur = torch.cuda.current_stream(self.device)
                cur.wait_event(ready)
                for t in dev.values():
                    t.record_stream(cur)
            view = {**src, **dev}
            yield k, view.pop("p"), grads[k][sl], view
            if dev:
                ev = self._store(k, src, dev)
                if ev is not None:
                    written.append(ev)
                    if len(written) > IN_FLIGHT:
                        written.popleft().synchronize()
            del src, dev, view
        # The host may read the results once the walk returns.
        while written:
            written.popleft().synchronize()


class GradSums:
    """A step's gradients summed over its microbatches in fp32 on the
    device, as JAX sums them (``jnp.add`` into fp32 zeros): one way of
    summing for every placement. :meth:`begin` opens a step over leaves
    shaped as ``like``; :meth:`finish` returns a gradient a leaf, zeros
    where none arrived.

    - :meth:`take`: a leaf's whole gradient, handed over (its ``.grad``).
      The first is kept as it is: a sum of one addend is that addend, so a
      bf16 gradient takes fp32's bytes only when a second arrives, and is
      then converted and added to.
    - :meth:`add`: layer ``index`` of a stacked leaf (the whole leaf for
      None), written into an fp32 buffer of the leaf, copied first and
      added after; the layers no gradient reached are zeroed."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.like: dict = {}
        self.sums: dict[str, torch.Tensor] = {}
        self._parts: dict[str, set] = {}

    def begin(self, like: dict[str, torch.Tensor]) -> None:
        self.like, self.sums, self._parts = like, {}, {}

    def take(self, key: str, g: torch.Tensor) -> None:
        have = self.sums.get(key)
        if have is None:
            self.sums[key] = g
            return
        if have.dtype != torch.float32:
            have = self.sums[key] = have.float()
        have.add_(g)

    def add(self, key: str, g: torch.Tensor, index: Optional[int] = None) -> None:
        if key not in self.sums:
            self.sums[key] = torch.empty(self.like[key].shape, dtype=torch.float32,
                                         device=self.device)
            self._parts[key] = set()
        buf = self.sums[key] if index is None else self.sums[key][index]
        if index in self._parts[key]:
            buf.add_(g)
        else:
            buf.copy_(g)
            self._parts[key].add(index)

    def finish(self) -> dict[str, torch.Tensor]:
        out = {}
        for k, t in self.like.items():
            s = self.sums.get(k)
            if s is None:
                s = torch.zeros(t.shape, dtype=torch.float32, device=self.device)
            elif k in self._parts and None not in self._parts[k]:
                for i in range(s.shape[0]):
                    if i not in self._parts[k]:
                        s[i].zero_()
            out[k] = s
        self.like, self.sums, self._parts = {}, {}, {}
        return out


class _StreamIn(torch.autograd.Function):
    """A host leaf (or one layer of it) copied to the device and cast to the
    compute dtype. ``anchor`` (a 0-d device tensor that requires grad) puts
    the copy on the graph; the backward rounds the gradient to the master's
    dtype (a cast's backward, as in the in-memory program), adds it to the
    sink's :class:`GradSums` and returns none to the host."""

    @staticmethod
    def forward(ctx, anchor, src, dtype, sink, key, index):
        ctx.sink, ctx.key, ctx.index, ctx.master = sink, key, index, src.dtype
        out = torch.empty(src.shape, dtype=src.dtype, device=anchor.device)
        out.copy_(src, non_blocking=True)
        sink.bytes["h2d"] += src.numel() * src.element_size()
        return out if dtype is None else out.to(dtype)

    @staticmethod
    def backward(ctx, g):
        ctx.sink.sums.add(ctx.key, g.to(ctx.master), ctx.index)
        return None, None, None, None, None, None


class _Layer(Mapping):
    """Layer ``index`` of a layer stream's stacked leaves, keyed as
    ``cast_layer_stack`` keys them; each leaf is fetched on first access
    (``stream.fetch``: :class:`HostParams` copies it to the device and
    casts it; the mesh program's stage-3 stream gathers its shards)."""

    def __init__(self, stream, index: int):
        self._host, self._index, self._got = stream, index, {}

    def __getitem__(self, name):
        if name not in self._got:
            key = f"layers.{name}"
            if key not in self._host.params:
                raise KeyError(name)  # a leaf the arch lacks
            self._got[name] = self._host.fetch(key, self._index)
        return self._got[name]

    def __iter__(self):
        return (k[len("layers."):] for k in self._host.params if k.startswith("layers."))

    def __len__(self):
        return sum(1 for _ in self)


class HostParams:
    """Master weights in host memory, streamed to the device: the non-layer
    leaves once per loss call (:meth:`bind`), each layer inside its
    checkpointed block (:meth:`layer`). Their gradients sum into
    :attr:`sums` (:class:`GradSums`, fp32 on the device), never to the
    host."""

    def __init__(self, device, compute_dtype):
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        self.anchor = torch.zeros((), device=self.device, requires_grad=True)
        self.params: dict[str, torch.Tensor] = {}
        self.sums = GradSums(self.device)
        self.bytes = {"h2d": 0, "d2h": 0}

    def bind(self, params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Stream from ``params`` (host tensors); returns the non-layer
        leaves on the device in the master dtype (the model casts them
        where JAX does) beside the host layer leaves."""
        self.params = params
        return {k: (p if k.startswith("layers.")
                    else _StreamIn.apply(self.anchor, p, None, self, k, None))
                for k, p in params.items()}

    def fetch(self, key: str, index: int) -> torch.Tensor:
        """Layer ``index`` of the host leaf ``key`` on the device, cast."""
        return _StreamIn.apply(self.anchor, self.params[key][index], self.compute_dtype, self,
                               key, index)

    def layer(self, index: int) -> _Layer:
        return _Layer(self, index)


class _Stashed:
    """A tensor's copy in a block of a :class:`HostStash`; the block goes
    back to the stash when this is dropped (taken back or not)."""

    __slots__ = ("host", "ready", "nbytes", "__weakref__")


class HostStash:
    """Device tensors kept in host memory until they are taken back
    (``offload_dots``' cache of products). Each tensor goes to a block of
    its exact size (a :class:`HostArena`, page-locked on a CUDA machine),
    copied on the device→host stream of :func:`copy_streams` once the
    compute stream has made it; it comes back on the compute stream once
    that copy has ended. A block returns to the stash when its tensor's
    entry is dropped and serves a later tensor of the same size (a copy
    into it waits for the compute stream, so for the copy that read it),
    so a step's blocks serve every later step. :attr:`nbytes` is what the
    blocks hold, :attr:`in_use` what the live entries hold; :meth:`release`
    unpins and frees the free blocks."""

    def __init__(self, device):
        self.device = _device(device)
        self.cuda = self.device.type == "cuda"
        self.free: dict[int, list] = collections.defaultdict(list)
        self.nbytes = 0
        self.in_use = 0

    def _give_back(self, block: HostArena, nbytes: int) -> None:
        self.in_use -= nbytes
        self.free[nbytes].append(block)

    def put(self, t: torch.Tensor) -> _Stashed:
        nb = t.numel() * t.element_size()
        if self.free[nb]:
            block = self.free[nb].pop()
        else:
            block = HostArena({"x": torch.empty(nb, dtype=torch.uint8, device="meta")},
                              pin=self.cuda)
            self.nbytes += block.nbytes
        self.in_use += nb
        entry = _Stashed()
        entry.host = block.tensors["x"].view(t.dtype).view(t.shape)
        entry.nbytes, entry.ready = nb, None
        weakref.finalize(entry, self._give_back, block, nb)
        if not self.cuda:
            entry.host.copy_(t)
            return entry
        side = copy_streams(self.device)[1]
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            entry.host.copy_(t, non_blocking=True)
            t.record_stream(side)
            entry.ready = side.record_event()
        return entry

    def get(self, entry: _Stashed) -> torch.Tensor:
        """The stashed tensor on the device (a copy: the block is reused
        once ``entry`` is dropped)."""
        if entry.ready is None:
            return entry.host.clone()
        torch.cuda.current_stream(self.device).wait_event(entry.ready)
        return entry.host.to(self.device, non_blocking=True)

    def release(self) -> None:
        """Unpin and drop every free block."""
        for blocks in self.free.values():
            for b in blocks:
                self.nbytes -= b.nbytes
                if b.pinned:
                    b.unpin()
        self.free.clear()


_STASHES: dict = {}


def host_stash(device) -> HostStash:
    """The device's :class:`HostStash`, made once."""
    device = _device(device)
    if device not in _STASHES:
        _STASHES[device] = HostStash(device)
    return _STASHES[device]
