"""Continuous-batching generation server on one GPU (port of
``tpu_engine/serving.py``: the dense llama, gpt2, qwen and gemma archs,
MoE, and int8 weight-only quantized trees, for the target and the draft).

A fixed pool of decode slots that requests join and leave independently: a
finishing request frees its slot for the next queued prompt while the
others keep decoding. The pool is ``[L, slots, KV, S, HD]`` for the
server's lifetime; each slot carries its own length (per-row positions),
writes land at each row's own lane, and the attention mask is by position.
Sliding-window models get a per-row ring of ``window + prefill_chunk - 1``
lanes. Greedy and sampled requests advance together, ``chunk_steps`` tokens
per dispatch, with one device-to-host copy of the tokens per dispatch.
Prompts are ingested ``prefill_chunk`` tokens per engine step, interleaved
with decode, and a prompt-prefix cache reuses the K/V of shared prefixes.
With a draft model (``draft_params``) every slot advances by speculative
rounds instead: the draft proposes ``spec_gamma`` greedy tokens per slot in
its own pool, the target verifies every slot's chain in one forward
(:func:`decode_verify`), and each slot keeps the longest agreeing prefix
plus the target's next token (:func:`speculative_round`).

:class:`ContinuousBatcher` is thread-safe: ``submit`` from any thread,
drive ``step`` from a serving loop or ``serve_forever`` on a thread. Device
work runs outside the lock; the engine thread is the only one that touches
the pool.

Deliberate differences from JAX:

- **Sampling RNG.** JAX draws with ``fold_in(fold_in(key, request id),
  draw count)`` and ``categorical``. Here a request's draw is the Gumbel-max
  of ``logits / temperature`` with noise from an integer hash of (server
  seed, request id, draw count, vocabulary index), computed on the device
  in int64 ops. The contract is JAX's: a stream is deterministic for a
  server ``seed``, does not depend on which requests share the batch,
  greedy and sampled rows advance in one chunk, and nothing in a chunk
  waits on the host. The tokens differ from JAX's.
- **One-time inference cast.** The parameters are cast to the compute
  dtype once, at construction (``inference_params``); JAX casts them in
  every dispatch.
- **Masked, not dropped, out-of-range writes.** A row that finishes inside
  a chunk keeps decoding to the chunk's end, and a verify chain near a
  slot's end runs past it: both can reach past the pool's last lane. JAX's
  scatter drops such a write; on CUDA an out-of-range index is a
  device-side assert, so the port writes the value the last lane ends
  with instead (the same pool afterwards, :func:`_pool_writer`).
- **Layout and updates** as in :mod:`tpu_engine_torch.generate`: the pool
  is head-major and updated in place.

On a mesh (``mesh=``, a :class:`~tpu_engine_torch.mesh_runtime.MeshRuntime`
whose ranks all lie on ``model``, as the serving fleet's): each rank is a
process that holds its ``model`` blocks of the weights and its kv heads of
the pool (``tpu_engine_torch/generate.py``). A weight-only int8 tree splits
as JAX's ``quantize_pspecs`` does (``QuantWeight.narrow``): a column-split
site's codes and scales on the output (or expert) dim, a row-split site's
codes on the input dim with the whole scale, which multiplies each rank's
partial product before ``g``'s all-reduce sums them (one place: ``_proj``).
The parameters may be whole or already the rank's blocks (``load_quantized``
with ``mesh=``). A draft on a mesh stays refused (JAX's
``draft_mesh_sharded``). ``submit`` is called on rank 0;
each ``step`` first broadcasts rank 0's new admissions over ``model``, so
every rank runs the same plan, and every rank draws the same tokens from
the logits gathered whole. Results are read on rank 0 (every rank holds
the same). Rank 0's :meth:`ContinuousBatcher.shutdown` (or its
``serve_forever`` stopping) ends the other ranks' ``serve_forever``.

Not ported yet; each raises ``NotImplementedError`` when asked for: a
mesh with ``data``, ``fsdp``, ``pipe`` or ``sequence`` above 1, and the
disaggregated-serving plane (``hold_kv``,
``submit_prefilled``, ``request_handoff``, ``release_held``,
``take_handoff``, ``wait_handoff``, ``export_prefix``, ``install_prefix``),
after JAX's own guards (a speculative server refuses ``hold_kv`` and
``submit_prefilled`` with ``ValueError``, as JAX does).
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from tpu_engine_torch.counter_hash import _M32, _mix32, _mul32, _uniform
from tpu_engine_torch.generate import (
    KVCache,
    _hidden_lanes,
    _run_layers,
    forward_with_cache,
    init_cache,
    ring_lanes,
)
from tpu_engine_torch.models.config import ModelConfig
from tpu_engine_torch.models.transformer import (
    _require_ported,
    embed_tokens,
    inference_params,
    unembed,
)
from tpu_engine_torch.parallel.tensor_parallel import gather_vocab, model_axis, model_block
from tpu_engine_torch.quant import QuantWeight

_DISAGG = "the disaggregated-serving handoff plane is not ported"


@dataclass
class SlotCache:
    """Per-slot KV pool with independent row positions.

    ``lengths[b]`` is slot b's resident token count (0 = empty). Non-ring
    pools identify lane m with position m (``pos`` is None); ring pools
    write position p into lane ``p % S`` and track the stored position per
    lane in ``pos`` [B, S] (-1 = empty). int8 pools hold codes in k/v and
    per-(lane, kv-head) scales [L, B, KV, S, 1]."""

    k: torch.Tensor        # [L, B, KV, S, HD]
    v: torch.Tensor
    lengths: torch.Tensor  # [B] int64
    pos: Optional[torch.Tensor] = None
    ring: bool = False
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def n_lanes(self) -> int:
        return self.k.shape[3]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def init_slot_cache(cfg: ModelConfig, slots: int, max_len: int, dtype=torch.bfloat16,
                    prefill_chunk: Optional[int] = None, kv_quant: bool = False,
                    device="cuda", mesh=None) -> SlotCache:
    """Allocate the serving pool: ``max_len`` lanes per slot, or for a
    sliding-window model a per-row ring of ``window + prefill_chunk - 1``.
    ``mesh``: the rank's kv heads (``generate.cache_kv_heads``)."""
    lanes = ring_lanes(cfg, max_len, prefill_chunk)
    ring = lanes < max_len
    one = init_cache(cfg, slots, lanes, dtype=dtype, kv_quant=kv_quant, device=device,
                     mesh=mesh)
    return SlotCache(
        k=one.k, v=one.v, lengths=torch.zeros((slots,), dtype=torch.int64, device=device),
        pos=torch.full((slots, lanes), -1, dtype=torch.int64, device=device) if ring else None,
        ring=ring, k_scale=one.k_scale, v_scale=one.v_scale,
    )


def _pool_writer(start: torch.Tensor, T: int, S: int):
    """``write(arr, new)`` storing new [B, KV, T, X] at lanes ``start[b] + t``
    of a pool layer arr [B, KV, S, X], in place.

    JAX's scatter drops the writes that fall past the last lane. Here every
    such write is sent to the last lane instead, with the value that lane
    ends up holding: the chain's own entry for lane S - 1 where the chain
    reaches it, else the lane's old value. Colliding writes then all carry
    one value, and the pool afterwards equals JAX's."""
    B = start.shape[0]
    rows = torch.arange(B, device=start.device)[:, None]
    t = torch.arange(T, device=start.device)
    last = (S - 1 - start)[:, None]               # the chain index landing on lane S - 1
    lane = (start[:, None] + t).clamp(max=S - 1)  # [B, T]
    src = torch.minimum(t, last).clamp(min=0)     # [B, T]
    lands = (last >= 0)[:, :, None, None]         # the row writes at least one lane

    def write(arr, new):
        new = new.transpose(1, 2).to(arr.dtype)   # [B, T, KV, X], as arr[rows, :, lane]
        if T > 1:
            new = new.gather(1, src[:, :, None, None].expand_as(new))
        arr[rows, :, lane] = torch.where(lands, new, arr[rows, :, lane])

    return write


@torch.inference_mode()
def decode_step(params: dict[str, torch.Tensor], tokens: torch.Tensor, cache: SlotCache,
                active: torch.Tensor, cfg: ModelConfig,
                compute_dtype=torch.bfloat16, mesh=None) -> tuple[torch.Tensor, SlotCache]:
    """One token for every slot: tokens [B] (each slot's last token),
    active [B] bool. Returns (logits [B, V] fp32, the pool, updated in
    place). Inactive rows still compute, but their lengths do not advance
    and their writes land in lanes the mask never shows (a ring row's
    ``pos`` is not updated). A row that finished inside a chunk can run past
    the last lane (:func:`_pool_writer`). ``mesh``: the rank's blocks, the
    logits gathered whole."""
    B = tokens.shape[0]
    S = cache.n_lanes
    rows = torch.arange(B, device=tokens.device)
    positions = cache.lengths[:, None]
    if cache.ring:
        lane = cache.lengths % S
        cache.pos[rows, lane] = torch.where(active, cache.lengths, cache.pos[rows, lane])
        key_pos = cache.pos
    else:
        lane = cache.lengths
        key_pos = torch.arange(S, device=tokens.device)
    write = _pool_writer(lane, 1, S)
    hidden = _hidden_lanes(key_pos, positions, cfg.sliding_window)
    x = embed_tokens(params, tokens[:, None], compute_dtype, positions=positions, cfg=cfg,
                     mesh=mesh)
    x = _run_layers(params, x, cache, write, hidden, positions, cfg, compute_dtype, mesh)
    cache.lengths += active
    return gather_vocab(unembed(params, x, cfg, mesh)[:, 0], model_axis(mesh, cfg)), cache


def _gumbel_noise(seed: int, req_ids: torch.Tensor, counts: torch.Tensor,
                  vocab: int) -> torch.Tensor:
    """Standard Gumbel noise [B, V], a pure function of (seed, request id,
    draw count, vocabulary index), -log(-log u) of :func:`_uniform`."""
    row = _mix32(_mix32(req_ids ^ _mix32(seed & _M32)) ^ counts)
    col = _mul32(torch.arange(vocab, device=req_ids.device), 0x9E3779B9)
    return -torch.log(-torch.log(_uniform(_mix32(row[:, None] ^ col[None, :]))))


def _pick_tokens(logits: torch.Tensor, temps: torch.Tensor, req_ids: torch.Tensor,
                 counts: torch.Tensor, seed: int) -> torch.Tensor:
    """Per-slot choice inside the dispatch: greedy rows (temperature 0) take
    the argmax; sampled rows draw from softmax(logits / temperature) by
    Gumbel-max with :func:`_gumbel_noise`."""
    greedy = logits.argmax(dim=-1)
    t = temps.clamp_min(1e-6)[:, None]
    drawn = (logits / t + _gumbel_noise(seed, req_ids, counts, logits.shape[-1])).argmax(dim=-1)
    return torch.where(temps > 0.0, drawn, greedy)


@torch.inference_mode()
def decode_chunk(params: dict[str, torch.Tensor], tokens: torch.Tensor, cache: SlotCache,
                 active: torch.Tensor, temps: torch.Tensor, req_ids: torch.Tensor,
                 counts: torch.Tensor, seed: int, cfg: ModelConfig, n_steps: int,
                 compute_dtype=torch.bfloat16, mesh=None) -> tuple[torch.Tensor, SlotCache]:
    """``n_steps`` tokens per active slot, each step's choice fed back on
    the device, greedy and sampled alike. Returns (tokens [B, n_steps], the
    pool). The host trims each request's overshoot past eos or its budget:
    its slot is reset, so the overshoot lanes are masked and overwritten."""
    toks, cnts, out = tokens, counts, []
    for _ in range(n_steps):
        logits, cache = decode_step(params, toks, cache, active, cfg, compute_dtype, mesh)
        nxt = _pick_tokens(logits, temps, req_ids, cnts, seed)
        toks = torch.where(active, nxt, toks)
        cnts = cnts + active
        out.append(nxt)
    return torch.stack(out, dim=1), cache


@torch.inference_mode()
def decode_verify(params: dict[str, torch.Tensor], tokens: torch.Tensor, cache: SlotCache,
                  active: torch.Tensor, cfg: ModelConfig,
                  compute_dtype=torch.bfloat16) -> tuple[torch.Tensor, SlotCache]:
    """T tokens per slot in one forward (the speculative verify pass).

    Row b's inputs tokens [B, T] sit at positions ``lengths[b] + arange(T)``;
    their K/V rows are written before attention, so causality inside the
    chain is the ordinary position mask, and logits [B, T, V] fp32 come back
    for every input (``logits[b, i]`` scores the token after input i).
    Lengths advance by T on active rows; the caller rewinds them to the
    accepted frontier, and the rejected lanes stay hidden by length until
    the next chain overwrites them. Flat (non-ring) pools only."""
    B, T = tokens.shape
    S = cache.n_lanes
    positions = cache.lengths[:, None] + torch.arange(T, device=tokens.device)
    write = _pool_writer(cache.lengths, T, S)
    hidden = _hidden_lanes(torch.arange(S, device=tokens.device), positions, cfg.sliding_window)
    x = embed_tokens(params, tokens, compute_dtype, positions=positions, cfg=cfg)
    x = _run_layers(params, x, cache, write, hidden, positions, cfg, compute_dtype)
    cache.lengths += T * active
    return unembed(params, x, cfg), cache


def _draft_propose(draft_params: dict[str, torch.Tensor], tokens: torch.Tensor,
                   draft_cache: SlotCache, active: torch.Tensor, draft_cfg: ModelConfig,
                   n_steps: int, compute_dtype) -> tuple[torch.Tensor, SlotCache]:
    """``n_steps`` greedy draft decode steps from tokens [B], each choice fed
    back on active rows. Returns (choices [B, n_steps], the draft pool)."""
    toks, out = tokens, []
    for _ in range(n_steps):
        logits, draft_cache = decode_step(draft_params, toks, draft_cache, active, draft_cfg,
                                          compute_dtype)
        nxt = logits.argmax(dim=-1)
        toks = torch.where(active, nxt, toks)
        out.append(nxt)
    return torch.stack(out, dim=1), draft_cache


def _rewind(cache: SlotCache, draft_cache: SlotCache, overshoot: torch.Tensor) -> None:
    """Both pools back to the accepted frontier, in place: each row keeps
    every token except its new last one."""
    cache.lengths -= overshoot
    draft_cache.lengths -= overshoot


@torch.inference_mode()
def speculative_round(params: dict[str, torch.Tensor], draft_params: dict[str, torch.Tensor],
                      tokens: torch.Tensor, cache: SlotCache, draft_cache: SlotCache,
                      active: torch.Tensor, cfg: ModelConfig, draft_cfg: ModelConfig,
                      gamma: int, compute_dtype=torch.bfloat16):
    """One batched draft-propose / target-verify round for every slot.

    Both pools hold the K/V of every token but the last emitted one,
    tokens [B]. The draft runs ``gamma + 1`` greedy steps: the first
    ``gamma`` choices are the proposals, and the last step only writes the
    last proposal's K/V, without which a fully accepted round would leave a
    hole in the draft's pool. The target verifies the chains [last,
    proposals] in one forward (:func:`decode_verify`); a row accepts the
    longest prefix on which the proposals equal the target's choices, plus
    the target's next token. Both pools then rewind by the overshoot.

    Returns (tgt [B, gamma + 1] the target's choices, n_acc [B] accepted
    counts in 1..gamma + 1, the target pool, the draft pool). The streams
    equal plain greedy serving wherever the target's chunked and one-token
    argmax agree."""
    props, draft_cache = _draft_propose(draft_params, tokens, draft_cache, active, draft_cfg,
                                        gamma + 1, compute_dtype)
    proposals = props[:, :gamma]
    chain = torch.cat([tokens[:, None], proposals], dim=1)
    logits, cache = decode_verify(params, chain, cache, active, cfg, compute_dtype)
    tgt = logits.argmax(dim=-1)
    n_acc = torch.cumprod((proposals == tgt[:, :gamma]).long(), dim=1).sum(dim=1) + 1
    _rewind(cache, draft_cache, torch.where(active, gamma + 1 - n_acc, 0))
    return tgt, n_acc, cache, draft_cache


def _slice_prefix(c1: KVCache, L: int) -> KVCache:
    """A copy of the first ``L`` lanes of a single-row ingestion cache, the
    stored form of a prefix-cache entry (non-ring caches: lane = position)."""
    def cut(t):
        return None if t is None else t[:, :, :, :L].clone()

    return KVCache(k=cut(c1.k), v=cut(c1.v), pos=c1.pos[:L].clone(), length=L, ring=False,
                   k_scale=cut(c1.k_scale), v_scale=cut(c1.v_scale))


def _paste_prefix(c1: KVCache, entry: KVCache, use_len: int, lanes: int) -> KVCache:
    """Write the first ``lanes`` lanes of a cached prefix into a fresh
    ingestion cache and set its length to ``use_len`` (<= lanes). Lanes at
    or past ``use_len`` hold K/V of tokens the new prompt may not share, but
    the mask hides them and the resumed prefill overwrites each one before
    the frontier reaches it, so reuse is token-granular."""
    for dst, src in ((c1.k, entry.k), (c1.v, entry.v), (c1.k_scale, entry.k_scale),
                     (c1.v_scale, entry.v_scale)):
        if dst is not None:
            dst[:, :, :, :lanes] = src[:, :, :, :lanes]
    c1.pos[:lanes] = entry.pos[:lanes]
    return dataclasses.replace(c1, length=int(use_len))


class _PrefixCache:
    """LRU cache of prompt-prefix KV (host-side bookkeeping; entries are
    device-resident :class:`KVCache` slices). A copy of JAX's, which is
    host-only code.

    Entries are stored at ``prefill_chunk`` boundaries (one per prefill
    walk, its last cacheable boundary). Reuse is token-granular: ``lookup``
    finds the entry with the longest token-level common prefix and returns
    that length floored to ``grain`` lanes. Budgeted in tokens (eviction
    drops least-recently-used entries until a new entry fits)."""

    def __init__(self, budget_tokens: int, chunk: int, grain: int = 0):
        self.budget = int(budget_tokens)
        self.chunk = int(chunk)
        self.grain = int(grain) or int(chunk)
        self._entries: "collections.OrderedDict[tuple, KVCache]" = collections.OrderedDict()
        self._keys: dict[tuple, np.ndarray] = {}
        self._hit_counts: dict[tuple, int] = {}
        self.tokens = 0
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0

    def lookup(self, prompt: list[int]) -> tuple[int, Optional[KVCache]]:
        """Longest token-level common prefix with any stored entry, floored
        to ``grain`` and capped strictly before the prompt's last token
        (whose logits seed the first generated token). Returns (use_len,
        entry or None)."""
        limit = min(len(prompt) - 1, self.budget)
        if limit <= 0 or not self._entries:
            self.misses += 1
            return 0, None
        window = np.asarray(prompt[:limit], dtype=np.int64)
        best_use, best_key = 0, None
        for key, arr in self._keys.items():
            n = min(arr.size, limit)
            diff = np.flatnonzero(arr[:n] != window[:n])
            common = int(n if diff.size == 0 else diff[0])
            use = (common // self.grain) * self.grain
            if use > best_use:
                best_use, best_key = use, key
        if best_key is None:
            self.misses += 1
            return 0, None
        self._entries.move_to_end(best_key)
        self.hits += 1
        self.hit_tokens += best_use
        self._hit_counts[best_key] = self._hit_counts.get(best_key, 0) + 1
        return best_use, self._entries[best_key]

    def wants(self, prefix: tuple) -> bool:
        """True iff ``insert`` would store this key (checked before the
        caller pays the device copy)."""
        return len(prefix) <= self.budget and prefix not in self._entries

    def _drop(self, key: tuple) -> None:
        old = self._entries.pop(key)
        self._keys.pop(key)
        self._hit_counts.pop(key, None)
        self.tokens -= old.max_len

    def insert(self, prefix: tuple, entry: KVCache) -> None:
        """Store ``entry``, charged by its lane count; an entry larger than
        the whole budget is refused rather than evicting everything."""
        if not self.wants(prefix):
            return
        size = int(entry.max_len)
        if size > self.budget:
            return
        while self.tokens + size > self.budget and self._entries:
            self._drop(next(iter(self._entries)))
        self._entries[prefix] = entry
        self._keys[prefix] = np.asarray(prefix, dtype=np.int64)
        self.tokens += size

    def reuse_counts(self) -> dict[tuple, int]:
        """Per-resident-entry lookup-hit counts (entries never hit read 0)."""
        return {k: self._hit_counts.get(k, 0) for k in self._entries}

    def stats(self) -> dict[str, Any]:
        return {
            "entries": len(self._entries), "tokens": self.tokens,
            "hits": self.hits, "misses": self.misses,
            "hit_tokens_total": self.hit_tokens,
            "entry_hits": [
                {"prefix_tokens": len(k), "hits": self._hit_counts.get(k, 0)}
                for k in self._entries
            ],
        }


@dataclass
class Request:
    """One generation request's lifecycle (host-side bookkeeping)."""

    id: int
    prompt: list[int]
    max_new_tokens: int
    temperature: float
    status: str = "queued"        # queued | running | done | failed
    error: Optional[str] = None
    tokens: list[int] = field(default_factory=list)
    slot: Optional[int] = None
    submitted_at: float = field(default_factory=time.time)
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None


class SpecGeometryError(ValueError):
    """A draft/target pairing that can never run a ``speculative_round``,
    refused at construction. ``.kind`` and ``.reason`` (``{"kind": ...,
    **detail}``) let callers report it without parsing the message."""

    def __init__(self, kind: str, message: str, **detail: object):
        self.kind = kind
        self.reason = {"kind": kind, **detail}
        super().__init__(message)


@dataclass
class _PrefillState:
    """A prompt mid-ingestion: ``consumed`` of ``padded`` tokens are in
    ``c1`` (a single-row cache), advanced one bounded chunk per step. A
    speculative server ingests the prompt into the draft's cache ``dc1``
    too."""

    req: Request
    slot: int
    c1: KVCache
    toks: np.ndarray    # [1, padded] — the prompt, zero-padded
    consumed: int = 0
    dc1: Optional[KVCache] = None
    prefix_checked: bool = False

    @property
    def padded(self) -> int:
        return self.toks.shape[1]


def _own(t):
    """``t`` with storage of its own size (a clone of a view into a larger
    leaf), for a tensor or both halves of a :class:`QuantWeight`."""
    if isinstance(t, QuantWeight):
        return QuantWeight(_own(t.q), _own(t.scale))
    return t.clone() if t.untyped_storage().nbytes() > t.nbytes else t


class ContinuousBatcher:
    """Slot-pool batcher over :func:`decode_chunk`.

    ``submit`` is thread-safe; ``step`` admits queued prompts into free
    slots (one bounded prefill chunk per step), then advances every active
    slot ``chunk_steps`` tokens in one dispatch, greedy or sampled. Streams
    are reproducible for a given ``seed``. The arguments are JAX's, plus
    ``device`` (the card unless the caller passes ``"cpu"``); the
    parameters are moved there and cast to ``compute_dtype`` once. With
    ``mesh`` the parameters are whole and each rank keeps its ``model``
    blocks (module docstring)."""

    def __init__(
        self,
        params: Any,
        cfg: ModelConfig,
        max_slots: int = 8,
        max_len: int = 1024,
        compute_dtype=torch.bfloat16,
        eos_id: Optional[int] = None,
        seed: int = 0,
        prefill_pad_to: int = 64,
        chunk_steps: int = 1,
        prefill_chunk: int = 256,
        mesh: Any = None,
        stats_window_s: float = 30.0,
        draft_params: Any = None,
        draft_cfg: Optional[ModelConfig] = None,
        spec_gamma: int = 4,
        kv_quant: bool = False,
        prefix_cache_tokens: int = 0,
        device="cuda",
    ):
        self._mesh, self._tp, self._lead = mesh, None, True
        if mesh is not None:
            sizes = mesh.axis_sizes
            others = {a: sizes[a] for a in ("data", "fsdp", "pipe", "sequence") if sizes[a] > 1}
            if others:
                raise NotImplementedError(
                    f"serving on a mesh with {others} is not ported: the batcher runs on a "
                    "mesh whose ranks all lie on model (ROADMAP Queue 1, item 4: the serving "
                    "fleet)")
            self._tp = model_axis(mesh, cfg)
            self._lead = mesh.coords["model"] == 0
            if self._tp is not None:
                params = model_block(params, cfg, self._tp.size, self._tp.index)
        self._group = None if self._tp is None else self._tp.group
        self._unsent: list[Request] = []  # rank 0's submissions not yet broadcast
        self._closed = False
        self.cfg = cfg
        self.max_slots = int(max_slots)
        self.max_len = int(max_len)
        self.eos_id = eos_id
        self.seed = int(seed)
        self.prefill_pad_to = int(prefill_pad_to)
        # One prefill chunk per engine step, rounded to the pad bucket.
        self.prefill_chunk = max(
            -(-int(prefill_chunk) // self.prefill_pad_to) * self.prefill_pad_to,
            self.prefill_pad_to,
        )
        self.chunk_steps = max(int(chunk_steps), 1)
        self.kv_quant = bool(kv_quant)
        self._compute_dtype = compute_dtype
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        # The engine thread issues its work on the stream the pool was made on.
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)
        self._cache = init_slot_cache(cfg, self.max_slots, self.max_len, compute_dtype,
                                      prefill_chunk=self.prefill_chunk,
                                      kv_quant=self.kv_quant, device=self.device, mesh=mesh)

        # Speculative decoding: the draft's pool has the target pool's
        # slots and lanes, in the compute dtype.
        self._draft_params = None
        self._draft_cfg = draft_cfg
        self.spec_gamma = int(spec_gamma)
        self._draft_cache: Optional[SlotCache] = None
        if draft_params is not None:
            if draft_cfg is None:
                raise SpecGeometryError("draft_cfg_missing", "draft_params requires draft_cfg")
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise SpecGeometryError(
                    "draft_vocab_mismatch",
                    f"draft vocab {draft_cfg.vocab_size} != target vocab "
                    f"{cfg.vocab_size}: speculative verify compares token ids",
                    draft_vocab=draft_cfg.vocab_size, target_vocab=cfg.vocab_size)
            if self._cache.ring or cfg.sliding_window or draft_cfg.sliding_window:
                raise SpecGeometryError(
                    "draft_ring_window",
                    "speculative serving does not support sliding-window "
                    "models (the verify chain's rewind assumes flat lanes)",
                    target_window=cfg.sliding_window, draft_window=draft_cfg.sliding_window)
            if mesh is not None:
                raise SpecGeometryError(
                    "draft_mesh_sharded",
                    "speculative serving does not run mesh-sharded yet; drop draft_params "
                    "or mesh")
            if self.spec_gamma < 1:
                raise SpecGeometryError(
                    "spec_gamma_invalid", f"spec_gamma must be >= 1, got {spec_gamma}",
                    spec_gamma=self.spec_gamma)
            _require_ported(draft_cfg)
            self._draft_cache = init_slot_cache(draft_cfg, self.max_slots, self.max_len,
                                                compute_dtype, prefill_chunk=self.prefill_chunk,
                                                device=self.device)
            self._draft_params = inference_params(draft_params, compute_dtype, self.device)

        self._prefix_cache: Optional[_PrefixCache] = None
        if prefix_cache_tokens:
            if self._cache.ring:
                raise ValueError(
                    "prefix_cache_tokens does not support sliding-window models "
                    "(ring lanes wrap — a stored prefix's lanes are not "
                    "position-stable)")
            if draft_params is not None:
                raise ValueError(
                    "prefix_cache_tokens with speculative serving is not supported "
                    "(the draft cache would miss the prefix and desynchronise)")
            self._prefix_cache = _PrefixCache(prefix_cache_tokens, self.prefill_chunk,
                                              grain=self.prefill_pad_to)
        if cfg.arch == "gpt2" and max_len > cfg.max_seq_len:
            raise ValueError(
                f"max_len {max_len} exceeds the learned position table "
                f"(max_seq_len={cfg.max_seq_len}) of gpt2-family model")
        _require_ported(cfg)
        self.params = inference_params(params, compute_dtype, self.device)
        if self._tp is not None:  # a block owns its bytes: the whole leaf it came from can go
            self.params = {k: _own(v) for k, v in self.params.items()}

        self._slots: list[Optional[Request]] = [None] * self.max_slots
        self._last_tokens = np.zeros((self.max_slots,), np.int64)
        self._queue: list[Request] = []
        self._requests: dict[int, Request] = {}
        self._ids = itertools.count()
        self._prefilling: "collections.OrderedDict[int, _PrefillState]" = \
            collections.OrderedDict()
        self._pending_first_logits: dict[int, torch.Tensor] = {}
        self._lock = threading.Lock()
        self._done = threading.Condition(self._lock)
        self._tokens_out = 0
        self._spec_rounds = 0
        self._spec_accepted = 0
        self._started = time.time()
        self._stats_window_s = float(stats_window_s)
        self._recent: collections.deque[tuple[float, int]] = collections.deque()
        self.last_error: Optional[str] = None

    # -- client side ---------------------------------------------------------

    def submit(self, prompt: list[int], max_new_tokens: int = 64,
               temperature: float = 0.0, hold_kv: bool = False) -> int:
        if self.last_error is not None:
            raise RuntimeError(f"serving loop failed: {self.last_error}")
        if not prompt:
            raise ValueError("empty prompt")
        if temperature > 0.0 and self._draft_params is not None:
            raise ValueError(
                "speculative server is greedy-only: temperature>0 requests would "
                "desynchronise the draft cache (verify is exact only for argmax "
                "streams); start a non-speculative server for sampling")
        if hold_kv and self._cache.ring:
            raise ValueError(
                "hold_kv does not support sliding-window models (ring lanes wrap — "
                "the held slot's lanes are not position-stable for extraction)")
        if hold_kv and self._draft_params is not None:
            raise ValueError(
                "hold_kv with speculative serving is not supported (the draft cache "
                "cannot travel on the handoff wire)")
        if hold_kv:
            raise NotImplementedError(f"hold_kv: {_DISAGG}")
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds the server's max_len {self.max_len}")
        if not self._lead:
            raise ValueError("on a mesh, submit on rank 0 of model: each step broadcasts its "
                             "admissions to the other ranks")
        req = Request(id=next(self._ids), prompt=[int(t) for t in prompt],
                      max_new_tokens=int(max_new_tokens), temperature=float(temperature))
        with self._lock:
            # Re-check under the lock: the failure handler drains the queue
            # holding it, so a submit racing the shutdown cannot strand a
            # request in "queued".
            if self.last_error is not None:
                raise RuntimeError(f"serving loop failed: {self.last_error}")
            self._requests[req.id] = req
            # On a mesh a request joins the queue at the next step's
            # broadcast, on every rank at once.
            (self._unsent if self._group is not None else self._queue).append(req)
        return req.id

    def submit_prefilled(self, handoff: Any, max_new_tokens: int = 64,
                         temperature: float = 0.0) -> int:
        """JAX's guards, then ``NotImplementedError``: the handoff plane is
        not ported."""
        if self.last_error is not None:
            raise RuntimeError(f"serving loop failed: {self.last_error}")
        if self._cache.ring:
            raise ValueError("submit_prefilled does not support sliding-window pools")
        if self._draft_params is not None:
            raise ValueError(
                "submit_prefilled with speculative serving is not supported (the "
                "draft cache has no wire form)")
        raise NotImplementedError(_DISAGG)

    def request_handoff(self, *args, **kwargs) -> None:
        raise NotImplementedError(_DISAGG)

    def release_held(self, *args, **kwargs) -> None:
        raise NotImplementedError(_DISAGG)

    def take_handoff(self, *args, **kwargs) -> Any:
        raise NotImplementedError(_DISAGG)

    def wait_handoff(self, *args, **kwargs) -> Any:
        raise NotImplementedError(_DISAGG)

    def export_prefix(self, *args, **kwargs) -> Any:
        raise NotImplementedError(_DISAGG)

    def install_prefix(self, *args, **kwargs) -> bool:
        raise NotImplementedError(_DISAGG)

    def _result_locked(self, req: Request) -> dict[str, Any]:
        out = {"id": req.id, "status": req.status, "tokens": list(req.tokens),
               "prompt_len": len(req.prompt)}
        if req.first_token_at is not None:
            out["ttft_ms"] = round((req.first_token_at - req.submitted_at) * 1e3, 2)
            out["first_token_at"] = req.first_token_at
        if req.error:
            out["error"] = req.error
        return out

    def result(self, req_id: int) -> dict[str, Any]:
        with self._lock:
            req = self._requests.get(req_id)
            if req is None:
                raise KeyError(req_id)
            return self._result_locked(req)

    def wait_tokens(self, req_id: int, have: int = 0, timeout: float = 30.0) -> dict[str, Any]:
        """Block until the request holds more than ``have`` tokens or is
        terminal, then return its result snapshot; a timeout returns the
        current snapshot instead of raising (the streaming primitive)."""
        deadline = time.time() + timeout
        with self._done:
            while True:
                req = self._requests.get(req_id)
                if req is None:
                    raise KeyError(req_id)
                if len(req.tokens) > have or req.status in ("done", "failed"):
                    return self._result_locked(req)
                remaining = deadline - time.time()
                if remaining <= 0:
                    return self._result_locked(req)
                self._done.wait(remaining)

    def wait(self, req_id: int, timeout: float = 60.0) -> dict[str, Any]:
        deadline = time.time() + timeout
        with self._done:
            while True:
                req = self._requests.get(req_id)
                if req is None:
                    raise KeyError(req_id)
                if req.status in ("done", "failed"):
                    return self._result_locked(req)
                remaining = deadline - time.time()
                if remaining <= 0:
                    raise TimeoutError(f"request {req_id} not done in {timeout}s")
                self._done.wait(remaining)

    def stats(self) -> dict[str, Any]:
        with self._lock:
            now = time.time()
            while self._recent and now - self._recent[0][0] > self._stats_window_s:
                self._recent.popleft()
            recent_tokens = sum(n for _, n in self._recent)
            window = min(max(now - self._started, 1e-9), self._stats_window_s)
            dt = max(now - self._started, 1e-9)
            out = {
                "slots": self.max_slots,
                "active_slots": sum(1 for s in self._slots if s is not None),
                "prefilling": len(self._prefilling),
                "queued": len(self._queue),
                "requests_total": len(self._requests),
                "tokens_generated": self._tokens_out,
                "tokens_per_sec_recent": round(recent_tokens / window, 2),
                "tokens_per_sec_lifetime": round(self._tokens_out / dt, 2),
                "chunk_steps": self.chunk_steps,
                "sharded": self._mesh is not None,
                "speculative": self._draft_params is not None,
                "kv_quant": self.kv_quant,
                "held_slots": 0,
                "queued_handoffs": 0,
                "handoffs_out": 0,
                "handoffs_in": 0,
            }
            if self._prefix_cache is not None:
                out["prefix_cache"] = self._prefix_cache.stats()
            if self._draft_params is not None:
                out["spec_rounds"] = self._spec_rounds
                out["spec_tokens_accepted"] = self._spec_accepted
                out["spec_tokens_proposed"] = self._spec_rounds * (self.spec_gamma + 1)
            if self._spec_rounds:
                # Mean accepted tokens per round, as a share of gamma + 1.
                out["spec_accept_rate"] = round(
                    self._spec_accepted / (self._spec_rounds * (self.spec_gamma + 1)), 3)
            return out

    # -- engine side ---------------------------------------------------------

    def _begin_prefill(self, req: Request, slot: int) -> _PrefillState:
        """Allocate the single-row ingestion cache. Prompts pad up to
        ``prefill_pad_to`` multiples; padded positions are never shown (the
        mask is per-row length) and decode overwrites the first pad lane
        before it can be seen."""
        P_len = len(req.prompt)
        pad = min(-(-P_len // self.prefill_pad_to) * self.prefill_pad_to, self.max_len)
        toks = np.zeros((1, pad), np.int64)
        toks[0, :P_len] = req.prompt
        if self._cache.ring:
            # Lane-aligned with the pool: both write position p at p % S.
            c1 = init_cache(self.cfg, 1, self.max_len, dtype=self._compute_dtype,
                            max_chunk=self.prefill_chunk, kv_quant=self.kv_quant,
                            device=self.device, mesh=self._mesh)
        else:
            # Sized to a prefill_chunk multiple so cache shapes stay few.
            M = max(min(-(-pad // self.prefill_chunk) * self.prefill_chunk, self.max_len), pad)
            c1 = init_cache(self.cfg, 1, M, dtype=self._compute_dtype,
                            kv_quant=self.kv_quant, device=self.device, mesh=self._mesh)
        dc1 = None
        if self._draft_params is not None:
            dc1 = init_cache(self._draft_cfg, 1, c1.max_len, dtype=self._compute_dtype,
                             device=self.device)
        return _PrefillState(req=req, slot=slot, c1=c1, toks=toks, dc1=dc1)

    def _advance_prefill(self, st: _PrefillState) -> bool:
        """Ingest one bounded chunk; True when the prompt is fully in and
        its K/V rows have been copied into the slot."""
        if self._prefix_cache is not None and not st.prefix_checked:
            # Look up at the first advance, not at admission: prefills drain
            # in admission order, so a burst of same-prefix admissions still
            # hits the entry the first prompt creates.
            st.prefix_checked = True
            hit_len, entry = self._prefix_cache.lookup(st.req.prompt)
            if entry is not None and hit_len > 0:
                lanes = min(entry.max_len, st.c1.max_len)
                st.c1 = _paste_prefix(st.c1, entry, hit_len, lanes)
                st.consumed = hit_len
        t0 = st.consumed
        t1 = min(t0 + self.prefill_chunk, st.padded)
        chunk = torch.from_numpy(st.toks[:, t0:t1]).to(self.device)
        P_len = len(st.req.prompt)
        # Logits row of the last real prompt token (it seeds the first
        # token); only meaningful in its own chunk.
        row = min(max(P_len - 1 - t0, 0), t1 - t0 - 1)
        last_row, st.c1 = _prefill_forward(self.params, chunk, st.c1, row, cfg=self.cfg,
                                           compute_dtype=self._compute_dtype, mesh=self._mesh)
        if st.dc1 is not None:  # speculative: the draft ingests the prompt, no logits
            _, st.dc1 = forward_with_cache(self._draft_params, chunk, st.dc1, self._draft_cfg,
                                           compute_dtype=self._compute_dtype, want_logits=False)
        st.consumed = t1
        if self._prefix_cache is not None:
            # Insert only at the walk's last cacheable boundary (the largest
            # full chunk of real tokens within the budget), which the walk
            # covers (t0 < last <= t1) even when a token-granular hit made it
            # start between chunk boundaries.
            c = self.prefill_chunk
            last = min((P_len // c) * c, (self._prefix_cache.budget // c) * c)
            if t0 < last <= t1 and self._prefix_cache.wants(tuple(st.req.prompt[:last])):
                self._prefix_cache.insert(tuple(st.req.prompt[:last]),
                                          _slice_prefix(st.c1, last))
        if t0 <= P_len - 1 < t1:
            self._pending_first_logits[st.slot] = last_row
        if st.consumed < st.padded:
            return False
        _insert_prefill(self._cache, st.c1, st.slot, P_len)
        if st.dc1 is not None:
            _insert_prefill(self._draft_cache, st.dc1, st.slot, P_len)
        self._last_tokens[st.slot] = st.req.prompt[-1]
        return True

    @torch.inference_mode()
    def step(self) -> int:
        """Admit queued requests (one prefill chunk per call), advance active
        slots ``chunk_steps`` tokens. Returns tokens produced.

        The lock guards only host bookkeeping (admission and emission).
        Prefill, the decode dispatch and the token copy to the host run
        without it, so ``submit``/``result``/``stats`` never wait on device
        work. The engine thread is the only mutator of the pool and the
        slot arrays. On a mesh it first takes rank 0's new requests
        (:meth:`_sync`); a step after rank 0's shutdown does nothing."""
        if self._group is not None and (self._closed or not self._sync()):
            return 0
        admitted: list[tuple[int, Request]] = []
        with self._lock:
            for slot in range(self.max_slots):
                if self._slots[slot] is None and self._queue:
                    req = self._queue.pop(0)
                    req.status, req.slot = "running", slot
                    self._slots[slot] = req
                    admitted.append((slot, req))
        for slot, req in admitted:
            self._prefilling[slot] = self._begin_prefill(req, slot)

        if self._prefilling:  # one prefill chunk per step
            slot, st = next(iter(self._prefilling.items()))
            if st.req.status != "running":
                self._prefilling.pop(slot)
            elif self._advance_prefill(st):
                self._prefilling.pop(slot)

        # Freshly prefilled slots take their first token from the prefill
        # logits (outside the lock, like every device operation).
        produced = 0
        fresh, self._pending_first_logits = self._pending_first_logits, {}
        first_toks = {slot: self._first_token(logits, self._slots[slot])
                      for slot, logits in fresh.items() if self._slots[slot] is not None}
        with self._lock:
            for slot, tok in first_toks.items():
                req = self._slots[slot]
                if req is None:
                    continue
                self._emit(req, slot, tok)
                produced += 1
            self._note_tokens(produced)
            active_reqs = [(i, r) for i, r in enumerate(self._slots)
                           if r is not None and r.status == "running"
                           and i not in self._prefilling]
        if not active_reqs:
            return produced

        active = np.zeros((self.max_slots,), bool)
        for i, _ in active_reqs:
            active[i] = True

        def dev(a):
            return torch.from_numpy(a).to(self.device)

        if self._draft_params is not None:
            # Speculative: each round emits 1..gamma+1 tokens per slot (greedy
            # only, by the submit guard).
            tgt, n_acc, self._cache, self._draft_cache = speculative_round(
                self.params, self._draft_params, dev(self._last_tokens), self._cache,
                self._draft_cache, dev(active), self.cfg, self._draft_cfg, self.spec_gamma,
                self._compute_dtype)
            host = torch.cat([tgt, n_acc[:, None]], dim=1).cpu().numpy()  # one copy a round
            with self._lock:
                emitted = 0
                for slot, req in active_reqs:
                    if self._slots[slot] is not req:
                        continue
                    n = int(host[slot, -1])
                    self._spec_rounds += 1
                    self._spec_accepted += n
                    for t in host[slot, :n]:
                        self._emit(req, slot, int(t))
                        emitted += 1
                        if req.status != "running":
                            break  # the slot is reset; surplus accepted tokens dropped
                self._note_tokens(emitted)
            return produced + emitted

        temps = np.zeros((self.max_slots,), np.float32)
        req_ids = np.zeros((self.max_slots,), np.int64)
        counts = np.zeros((self.max_slots,), np.int64)
        for i, r in active_reqs:
            temps[i], req_ids[i], counts[i] = r.temperature, r.id, len(r.tokens)
        toks, self._cache = decode_chunk(
            self.params, dev(self._last_tokens), self._cache, dev(active), dev(temps),
            dev(req_ids), dev(counts), self.seed, self.cfg, self.chunk_steps,
            self._compute_dtype, self._mesh)
        toks_host = toks.cpu().numpy()  # [B, n]: one copy per dispatch
        with self._lock:
            emitted = 0
            for slot, req in active_reqs:
                if self._slots[slot] is not req:
                    continue  # the request changed state meanwhile
                for t in toks_host[slot]:
                    self._emit(req, slot, int(t))
                    emitted += 1
                    if req.status != "running":
                        break  # overshoot dropped; the slot is reset
            self._note_tokens(emitted)
        return produced + emitted

    def _sync(self, stop: bool = False) -> bool:
        """Rank 0's requests submitted since the last step, broadcast over
        ``model`` and queued on every rank in the same order (and rank 0's
        ``stop``). Returns False once rank 0 has stopped."""
        new: list[Request] = []
        if self._lead:
            with self._lock:
                new, self._unsent = self._unsent, []
        box = [(stop, [(r.id, r.prompt, r.max_new_tokens, r.temperature) for r in new])]
        dist.broadcast_object_list(box, src=dist.get_global_rank(self._group, 0),
                                   group=self._group, device=self.device)
        stop, sent = box[0]
        with self._lock:
            if not self._lead:
                new = [Request(id=i, prompt=list(p), max_new_tokens=n, temperature=t)
                       for i, p, n, t in sent]
                self._requests.update((r.id, r) for r in new)
            self._queue.extend(new)
        self._closed = bool(stop)
        return not self._closed

    def shutdown(self) -> None:
        """On a mesh, rank 0 tells the other ranks to stop (their
        ``serve_forever`` returns); elsewhere nothing."""
        if self._group is not None and self._lead and not self._closed:
            self._sync(stop=True)

    def _note_tokens(self, n: int) -> None:
        """Caller holds the lock."""
        if n:
            self._tokens_out += n
            now = time.time()
            self._recent.append((now, n))
            while self._recent and now - self._recent[0][0] > self._stats_window_s:
                self._recent.popleft()
            self._done.notify_all()  # wakes streamers and completion waiters

    def _first_token(self, logits: torch.Tensor, req: Request) -> int:
        """First token from the prefill logits [V], by the same rule and
        noise as the in-dispatch draws (draw count 0)."""
        if req.temperature <= 0.0:
            return int(logits.argmax())

        def one(value, dtype):
            return torch.full((1,), value, dtype=dtype, device=logits.device)

        return int(_pick_tokens(logits[None], one(req.temperature, torch.float32),
                                one(req.id, torch.int64), one(0, torch.int64), self.seed)[0])

    def _emit(self, req: Request, slot: int, tok: int) -> None:
        if req.first_token_at is None:
            req.first_token_at = time.time()
        req.tokens.append(tok)
        self._last_tokens[slot] = tok
        finished = (len(req.tokens) >= req.max_new_tokens
                    or (self.eos_id is not None and tok == self.eos_id)
                    or len(req.prompt) + len(req.tokens) >= self.max_len)
        if finished:
            req.status = "done"
            req.finished_at = time.time()
            self._slots[slot] = None
            # Zero the slot's length (and ring positions): its overshoot
            # lanes become invisible and admission reuses it cleanly.
            _reset_slot(self._cache, slot)
            if self._draft_cache is not None:
                _reset_slot(self._draft_cache, slot)
            self._done.notify_all()

    def serve_forever(self, stop: threading.Event, idle_sleep: float = 0.01):
        """Drive ``step`` until ``stop``, on the pool's device and stream. A
        step failure marks every in-flight and queued request ``failed``
        with the error recorded, and later ``submit`` calls are rejected. A
        clean stop drains the same way ("server stopped"), so blocked
        waiters return. On a mesh, ``stop`` is read on rank 0, which tells
        the other ranks at its last step; they return then."""
        follower = self._group is not None and not self._lead
        try:
            if self._stream is not None:
                torch.cuda.set_device(self.device)
                torch.cuda.set_stream(self._stream)
            while not (self._closed if follower else stop.is_set()):
                try:
                    produced = self.step()
                except Exception as e:  # noqa: BLE001 — serving boundary
                    self._drain(f"{type(e).__name__}: {e}")
                    return
                # Sleep only when idle: a step that advanced a prefill chunk
                # or left admissions waiting loops at once.
                if produced == 0 and not self._prefilling and not self._queue and not follower:
                    time.sleep(idle_sleep)
        finally:
            if self.last_error is None:
                self.shutdown()
                self._drain("server stopped")

    def _drain(self, msg: str) -> None:
        """Fail every queued or running request with ``msg``, reject later
        submits, and wake every waiter."""
        self.last_error = msg  # reject new submits first
        with self._lock:
            for req in list(self._slots) + list(self._queue):
                if req is not None and req.status in ("queued", "running"):
                    req.status, req.error = "failed", msg
                    req.finished_at = time.time()
            self._slots = [None] * self.max_slots
            self._queue.clear()
            self._prefilling.clear()
            self._done.notify_all()


def _prefill_forward(params, toks, cache: KVCache, row_idx: int, *, cfg: ModelConfig,
                     compute_dtype, mesh=None) -> tuple[torch.Tensor, KVCache]:
    """One prefill chunk through the cached forward; returns the logits row
    [V] that seeds the first token (the only row the head computes), and
    the cache."""
    logits, cache = forward_with_cache(params, toks, cache, cfg, compute_dtype=compute_dtype,
                                       mesh=mesh, row=row_idx)
    return logits[0, 0], cache


def _insert_prefill(cache: SlotCache, c1: KVCache, slot: int, true_len: int) -> SlotCache:
    """Copy a single-row prefill cache into ``slot`` and set its length to
    the true prompt length (padding lanes stay masked and are overwritten
    as decoding proceeds). Ring ingestion caches are lane-aligned with the
    pool, so their positions copy too."""
    M = c1.max_len
    for dst, src in ((cache.k, c1.k), (cache.v, c1.v), (cache.k_scale, c1.k_scale),
                     (cache.v_scale, c1.v_scale)):
        if dst is not None:
            dst[:, slot, :, :M] = src[:, 0]
    if cache.ring:
        cache.pos[slot] = c1.pos
    cache.lengths[slot] = true_len
    return cache


def _reset_slot(cache: SlotCache, slot: int) -> SlotCache:
    cache.lengths[slot] = 0
    if cache.ring:
        cache.pos[slot] = -1
    return cache


__all__ = [
    "SlotCache", "init_slot_cache", "decode_step", "decode_chunk", "decode_verify",
    "speculative_round", "Request", "SpecGeometryError", "ContinuousBatcher",
]
