"""Fleet-wide prefix plane: radix token index + host-RAM KV tier. Port of
``tpu_engine/prefix_plane.py``: host-side control code, JAX's names, messages,
defaults and metric families, over this package's planes.

Today's prefix reuse is strictly per-replica: every
:class:`~tpu_engine_torch.serving.ContinuousBatcher` keeps its own
``_PrefixCache`` and the :class:`~tpu_engine_torch.serving_fleet.FleetRouter`
only exploits it through fixed-width affinity pinning. At
millions-of-users traffic the same system prompts get redundantly
prefilled and redundantly cached on every replica, and a replica
eviction throws the fleet's only copy away. This module promotes the
cache to a fleet tier (ZeRO-Infinity's device/host capacity-tiering
idea applied to serving KV, with the int8
:class:`~tpu_engine_torch.disagg.KVHandoff` wire format as the transport):

- :class:`PrefixTrieIndex` — a radix/trie token index over every
  replica's resident prefixes plus the host tier's, so routing can ask
  "who holds the longest prefix of THIS prompt" in one walk instead of
  a per-replica scan.
- :class:`HostKVTier` — a budgeted host-RAM tier of int8 ``KVHandoff``
  payloads absorbing evicted/overflow prefixes. Eviction is driven by
  historian-measured reuse (the per-prefix hit-token series this plane
  records into :class:`~tpu_engine_torch.historian.MetricHistorian`), not
  recency: a prefix that re-earns its bytes stays even when it was not
  touched most recently.
- :class:`PrefixPlane` — the control object the router consults
  (:meth:`PrefixPlane.route_hint`) and the fleet feeds
  (:meth:`PrefixPlane.observe_admit`): cache-aware routing to the
  longest-prefix-holding replica with a free slot, host-tier
  rehydration when no replica holds it, and replica-cache mirrors whose
  overflow spills to the host tier.

Admission stays honest through
:func:`tpu_engine_torch.hbm_estimate.estimate_serving_hbm`'s host-tier term:
:meth:`PrefixPlane.plan_host_tier` sizes the tier through the estimator
and propagates its structured
:class:`~tpu_engine_torch.hbm_estimate.HostBudgetExceeded` rejection, so the
plane can never promise KV the host cannot hold.

Everything is clockless (pass ``now=``) so the twin's
``prefix_plane_lane`` drives the SAME objects the live fleet does, and
module-level counters back the always-rendered
``tpu_engine_prefix_plane_*`` Prometheus families.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from tpu_engine_torch import historian as historian_mod

__all__ = [
    "HIT_TOKENS_SERIES",
    "PrefixTrieIndex",
    "HostKVTier",
    "PrefixPlane",
    "quantize_handoff",
    "plane_stats",
]

# Per-prefix hit-token series the plane records into the historian; the
# host tier's reuse-driven eviction queries it back (agg="sum" over the
# reuse window). One labelled series per prefix key.
HIT_TOKENS_SERIES = "serving.prefix_plane.hit_tokens"

# Sentinel holder id for host-tier residency inside the trie index.
HOST_HOLDER = "__host__"


# -- module health counters (tpu_engine_prefix_plane_* families) --------------

_STATS_LOCK = threading.Lock()
_STATS: Dict[str, float] = {
    "lookups_total": 0,
    "index_hits_total": 0,
    "host_hits_total": 0,
    "host_stores_total": 0,
    "host_evictions_total": 0,
    "rehydrations_total": 0,
    "hit_tokens_total": 0,
    # Gauges: the most recent plane snapshot (one live plane per process
    # in practice; the twin installs its own and restores after).
    "index_prefixes": 0,
    "host_entries": 0,
    "host_bytes": 0,
}


def plane_stats() -> Dict[str, float]:
    """Snapshot of the plane's monotonic counters + last-seen gauges."""
    with _STATS_LOCK:
        return dict(_STATS)


def _reset_stats_for_tests() -> None:
    with _STATS_LOCK:
        for k in _STATS:
            _STATS[k] = 0


def _bump(**deltas: float) -> None:
    with _STATS_LOCK:
        for k, v in deltas.items():
            _STATS[k] += v


def _gauge(**values: float) -> None:
    with _STATS_LOCK:
        _STATS.update(values)


def quantize_handoff(handoff: Any) -> Any:
    """The host tier's storage form: int8 codes + per-(layer, token,
    kv-head) fp32 scales — 3.2x smaller than the fp32 wire, within the
    documented one-token decode bound. Already-quantized payloads pass
    through byte-for-byte (re-quantizing int8 codes would only add
    error)."""
    import dataclasses as _dc

    from tpu_engine_torch.disagg import _np_quantize

    if getattr(handoff, "quantized", False):
        return handoff
    qk, sk = _np_quantize(handoff.k)
    qv, sv = _np_quantize(handoff.v)
    return _dc.replace(
        handoff, dtype="int8", quantized=True,
        k=qk, v=qv, k_scale=sk, v_scale=sv,
    )


# -- radix token index --------------------------------------------------------


class _TrieNode:
    __slots__ = ("children", "holders")

    def __init__(self):
        self.children: Dict[int, "_TrieNode"] = {}
        self.holders: set = set()


class PrefixTrieIndex:
    """Radix/trie index from token prefixes to the holders caching them.

    A holder is a replica id (or :data:`HOST_HOLDER`); each registered
    prefix marks its terminal node. :meth:`longest_holders` walks a
    prompt once and returns the deepest marked node — O(prompt length),
    independent of fleet size and entry count."""

    def __init__(self):
        self._root = _TrieNode()
        self._holder_prefixes: Dict[str, set] = {}
        self.nodes = 1

    @property
    def n_prefixes(self) -> int:
        return len({p for ps in self._holder_prefixes.values() for p in ps})

    def prefixes(self, holder: str) -> set:
        return set(self._holder_prefixes.get(holder, ()))

    def insert(self, prefix: Sequence[int], holder: str) -> None:
        prefix = tuple(int(t) for t in prefix)
        if not prefix:
            return
        node = self._root
        for tok in prefix:
            nxt = node.children.get(tok)
            if nxt is None:
                nxt = node.children[tok] = _TrieNode()
                self.nodes += 1
            node = nxt
        node.holders.add(holder)
        self._holder_prefixes.setdefault(holder, set()).add(prefix)

    def remove(self, prefix: Sequence[int], holder: str) -> None:
        prefix = tuple(int(t) for t in prefix)
        held = self._holder_prefixes.get(holder)
        if held is None or prefix not in held:
            return
        held.discard(prefix)
        if not held:
            self._holder_prefixes.pop(holder, None)
        path: List[Tuple[_TrieNode, int]] = []
        node = self._root
        for tok in prefix:
            nxt = node.children.get(tok)
            if nxt is None:
                return
            path.append((node, tok))
            node = nxt
        node.holders.discard(holder)
        # Prune now-empty tail nodes so the index stays bounded by the
        # LIVE prefix set, not everything ever registered.
        for parent, tok in reversed(path):
            child = parent.children[tok]
            if child.holders or child.children:
                break
            del parent.children[tok]
            self.nodes -= 1

    def drop_holder(self, holder: str) -> None:
        """Forget every prefix a dead holder registered."""
        for prefix in list(self._holder_prefixes.get(holder, ())):
            self.remove(prefix, holder)

    def longest_holders(
        self, prompt: Sequence[int], exclude: Optional[set] = None
    ) -> Tuple[int, set]:
        """Deepest marked node along ``prompt``: (matched token count,
        holder set). ``exclude`` filters holders (e.g. the host sentinel
        when picking a replica)."""
        node = self._root
        best_len, best_holders = 0, set()
        depth = 0
        for tok in prompt:
            node = node.children.get(int(tok))
            if node is None:
                break
            depth += 1
            holders = node.holders if exclude is None else \
                node.holders - exclude
            if holders:
                best_len, best_holders = depth, set(holders)
        return best_len, best_holders


# -- host-RAM KV tier ---------------------------------------------------------


class HostKVTier:
    """Budgeted host-RAM tier of int8 ``KVHandoff`` prefix payloads.

    ``put`` quantizes fp payloads on store (:func:`quantize_handoff`) and
    charges ``wire_bytes()`` against the byte budget; capacity-model
    callers (the twin lane) pass ``nbytes`` instead of a payload and the
    ledger works identically. Eviction picks the LOWEST reuse score —
    hit-tokens over the trailing ``reuse_window_s`` from the historian's
    per-prefix series, falling back to the tier's own lifetime counters
    when the series has no coverage — with insertion-order (LRU via
    ``get``'s move-to-end) as the deterministic tie-break."""

    def __init__(
        self,
        budget_bytes: int = 256 << 20,
        historian: Optional["historian_mod.MetricHistorian"] = None,
        clock: Callable[[], float] = time.time,
        reuse_window_s: float = 600.0,
    ):
        self.budget_bytes = int(budget_bytes)
        self.reuse_window_s = float(reuse_window_s)
        self._historian = historian
        self._clock = clock
        self._entries: "collections.OrderedDict[tuple, Any]" = \
            collections.OrderedDict()
        self._bytes: Dict[tuple, int] = {}
        self._hit_tokens: Dict[tuple, int] = {}
        self.total_bytes = 0
        self.hits = 0
        self.misses = 0
        self.stores = 0
        self.evictions = 0

    # The historian label for one prefix: short, deterministic, and
    # unique for any realistic prefix population (length + first/last
    # token disambiguate shared-prefix traces without shipping the whole
    # token tuple as a label value).
    @staticmethod
    def prefix_label(prefix: tuple) -> str:
        return f"{len(prefix)}:{prefix[0]}:{prefix[-1]}" if prefix else "0"

    def historian(self) -> "historian_mod.MetricHistorian":
        return self._historian if self._historian is not None else \
            historian_mod.get_historian()

    def __contains__(self, prefix: tuple) -> bool:
        return tuple(prefix) in self._entries

    def contains(self, prefix: Sequence[int]) -> bool:
        return tuple(int(t) for t in prefix) in self._entries

    def note_hit(self, prefix: tuple, tokens: int,
                 now: Optional[float] = None) -> None:
        """Record ``tokens`` of prefix reuse: the tier's own ledger AND
        the historian series eviction scores against."""
        prefix = tuple(prefix)
        now = self._clock() if now is None else float(now)
        self._hit_tokens[prefix] = self._hit_tokens.get(prefix, 0) + int(tokens)
        try:
            self.historian().record(
                HIT_TOKENS_SERIES, float(tokens), ts=now,
                labels={"prefix": self.prefix_label(prefix)},
            )
        except Exception:
            pass  # reuse telemetry must never fail a request

    def _reuse_score(self, prefix: tuple, now: float) -> float:
        try:
            q = self.historian().query(
                HIT_TOKENS_SERIES, t0=now - self.reuse_window_s, t1=now,
                agg="sum", labels={"prefix": self.prefix_label(prefix)},
            )
            if q.get("count"):
                return float(q["value"] or 0.0)
        except Exception:
            pass
        return float(self._hit_tokens.get(prefix, 0))

    def put(self, prefix: Sequence[int], handoff: Any = None,
            nbytes: Optional[int] = None,
            now: Optional[float] = None) -> bool:
        """Store (or refresh) a prefix payload; False when it alone
        exceeds the whole budget (storing it would evict every reusable
        entry for bytes that may never be hit again)."""
        prefix = tuple(int(t) for t in prefix)
        if not prefix:
            return False
        now = self._clock() if now is None else float(now)
        if handoff is not None:
            handoff = quantize_handoff(handoff)
            nbytes = int(handoff.wire_bytes())
        nbytes = int(nbytes or 0)
        if nbytes > self.budget_bytes:
            return False
        if prefix in self._entries:
            self.total_bytes -= self._bytes[prefix]
        while self.total_bytes + nbytes > self.budget_bytes and self._entries:
            self._evict_one(now)
        self._entries[prefix] = handoff
        self._bytes[prefix] = nbytes
        self.total_bytes += nbytes
        self.stores += 1
        _bump(host_stores_total=1)
        self._publish()
        return True

    def _evict_one(self, now: float) -> None:
        victim = min(
            self._entries,
            key=lambda p: (self._reuse_score(p, now),
                           list(self._entries).index(p)),
        )
        self.total_bytes -= self._bytes.pop(victim)
        self._entries.pop(victim)
        self._hit_tokens.pop(victim, None)
        self.evictions += 1
        _bump(host_evictions_total=1)

    def get(self, prefix: Sequence[int],
            now: Optional[float] = None) -> Any:
        """The stored payload (None for capacity-model entries AND for
        misses — use :meth:`contains` to tell them apart). A hit counts
        reuse and refreshes recency."""
        prefix = tuple(int(t) for t in prefix)
        if prefix not in self._entries:
            self.misses += 1
            return None
        self._entries.move_to_end(prefix)
        self.hits += 1
        _bump(host_hits_total=1)
        self.note_hit(prefix, len(prefix), now=now)
        return self._entries[prefix]

    def pop(self, prefix: Sequence[int]) -> Any:
        prefix = tuple(int(t) for t in prefix)
        if prefix not in self._entries:
            return None
        self.total_bytes -= self._bytes.pop(prefix)
        self._hit_tokens.pop(prefix, None)
        out = self._entries.pop(prefix)
        self._publish()
        return out

    def _publish(self) -> None:
        _gauge(host_entries=len(self._entries),
               host_bytes=self.total_bytes)

    def stats(self) -> Dict[str, Any]:
        return {
            "entries": len(self._entries),
            "bytes": self.total_bytes,
            "budget_bytes": self.budget_bytes,
            "occupancy": round(
                self.total_bytes / self.budget_bytes, 4
            ) if self.budget_bytes else 0.0,
            "hits": self.hits,
            "misses": self.misses,
            "stores": self.stores,
            "evictions": self.evictions,
        }


# -- the plane ----------------------------------------------------------------


class PrefixPlane:
    """Fleet-wide prefix-cache control plane.

    The router consults :meth:`route_hint` (longest-prefix-holding
    replica with a free slot); the fleet/lane reports every admission
    through :meth:`observe_admit`, which keeps a bounded per-replica
    mirror of what each replica's cache plausibly holds, spills mirror
    overflow to the host tier (via ``spill`` — a real payload exporter
    in the live fleet, a byte-count model in the twin), and classifies
    the admission as ``replica`` hit / ``host`` rehydration / ``cold``.

    ``prefix_tokens`` is the indexed prefix width (matches the router's
    affinity window by default); ``replica_prefix_budget`` bounds each
    replica's mirror at the entry count its on-device cache can actually
    retain."""

    def __init__(
        self,
        prefix_tokens: int = 32,
        replica_prefix_budget: int = 64,
        host: Optional[HostKVTier] = None,
        historian: Optional["historian_mod.MetricHistorian"] = None,
        clock: Callable[[], float] = time.time,
        spill: Optional[Callable[[tuple, str], Any]] = None,
    ):
        self.prefix_tokens = int(prefix_tokens)
        self.replica_prefix_budget = int(replica_prefix_budget)
        self.index = PrefixTrieIndex()
        self.host = host if host is not None else \
            HostKVTier(historian=historian, clock=clock)
        self._historian = historian
        self._clock = clock
        # spill(prefix, rid) -> KVHandoff | int bytes | None: called when
        # a replica-mirror eviction leaves no other replica holding the
        # prefix; None drops it (nothing to absorb).
        self.spill = spill
        self._replica_lru: Dict[str, "collections.OrderedDict[tuple, None]"] = {}
        self.lookups = 0
        self.index_hits = 0
        self.host_rehydrations = 0
        self.hit_tokens = 0

    @classmethod
    def plan_host_tier(
        cls,
        model_name: str,
        max_slots: int,
        max_len: int,
        host_prefix_tokens: int,
        host_budget_gib: float,
        **estimate_kw: Any,
    ) -> HostKVTier:
        """Size a host tier through the HBM estimator's host-tier term —
        raises :class:`~tpu_engine_torch.hbm_estimate.HostBudgetExceeded` (the
        structured rejection) when the promised tokens oversubscribe the
        budget, so a plane can never be built around KV the host cannot
        hold."""
        from tpu_engine_torch.hbm_estimate import estimate_serving_hbm

        est = estimate_serving_hbm(
            model_name, max_slots, max_len,
            host_prefix_tokens=host_prefix_tokens,
            host_budget_gib=host_budget_gib,
            **estimate_kw,
        )
        if est is None:
            raise ValueError(f"unknown model {model_name!r}")
        return HostKVTier(budget_bytes=int(host_budget_gib * (1 << 30)))

    def _prefix_of(self, prompt: Sequence[int]) -> tuple:
        return tuple(int(t) for t in prompt[: self.prefix_tokens])

    def historian(self) -> "historian_mod.MetricHistorian":
        return self._historian if self._historian is not None else \
            historian_mod.get_historian()

    def note_hit(self, prefix: tuple, tokens: int,
                 now: Optional[float] = None) -> None:
        self.hit_tokens += int(tokens)
        _bump(hit_tokens_total=int(tokens))
        self.host.note_hit(tuple(prefix), tokens, now=now)

    # -- routing ----------------------------------------------------------

    def route_hint(
        self,
        prompt: Sequence[int],
        free: Dict[str, int],
    ) -> Tuple[Optional[str], int]:
        """(replica id, matched token count) for the longest-prefix
        holder with a free slot; (None, matched) when only the host tier
        (or nobody) holds it. Ties break on most free slots, then
        replica id — deterministic for the twin."""
        self.lookups += 1
        _bump(lookups_total=1)
        matched, holders = self.index.longest_holders(
            prompt[: self.prefix_tokens], exclude={HOST_HOLDER}
        )
        if matched <= 0:
            return None, 0
        live = [r for r in holders if free.get(r, 0) > 0]
        if not live:
            return None, matched
        pick = max(live, key=lambda r: (free.get(r, 0), r))
        self.index_hits += 1
        _bump(index_hits_total=1)
        return pick, matched

    def host_prefix_for(self, prompt: Sequence[int]) -> Optional[tuple]:
        """Longest host-tier-resident prefix of ``prompt`` (None when the
        host tier holds nothing useful)."""
        matched, holders = self.index.longest_holders(
            prompt[: self.prefix_tokens]
        )
        if matched <= 0 or HOST_HOLDER not in holders:
            return None
        prefix = tuple(int(t) for t in prompt[:matched])
        return prefix if self.host.contains(prefix) else None

    # -- admission bookkeeping --------------------------------------------

    def observe_admit(self, prompt: Sequence[int], rid: str,
                      now: Optional[float] = None) -> Dict[str, Any]:
        """Record that ``rid`` admitted ``prompt``; returns
        ``{"kind": "replica"|"host"|"cold", "prefix", "payload",
        "evicted"}``. ``payload`` is the host-tier payload to rehydrate
        (a ``KVHandoff`` in the live fleet, None in capacity-model
        runs)."""
        now = self._clock() if now is None else float(now)
        prefix = self._prefix_of(prompt)
        if not prefix:
            return {"kind": "cold", "prefix": prefix, "payload": None,
                    "evicted": []}
        lru = self._replica_lru.setdefault(rid, collections.OrderedDict())
        payload = None
        if prefix in lru:
            kind = "replica"
            lru.move_to_end(prefix)
            self.note_hit(prefix, len(prefix), now=now)
        elif self.host.contains(prefix):
            kind = "host"
            payload = self.host.get(prefix, now=now)
            self.host_rehydrations += 1
            _bump(rehydrations_total=1)
        else:
            kind = "cold"
        evicted: List[tuple] = []
        if kind != "replica":
            lru[prefix] = None
            self.index.insert(prefix, rid)
            while len(lru) > self.replica_prefix_budget:
                old, _ = lru.popitem(last=False)
                self.index.remove(old, rid)
                evicted.append(old)
                self._spill(old, rid, now)
        self._publish()
        return {"kind": kind, "prefix": prefix, "payload": payload,
                "evicted": evicted}

    def _spill(self, prefix: tuple, rid: str, now: float) -> None:
        """Absorb a replica-cache eviction into the host tier when no
        other replica still holds the prefix."""
        _, holders = self.index.longest_holders(prefix,
                                                exclude={HOST_HOLDER})
        if holders or self.host.contains(prefix):
            return
        payload = self.spill(prefix, rid) if self.spill is not None else None
        if payload is None:
            return
        stored = (
            self.host.put(prefix, nbytes=payload, now=now)
            if isinstance(payload, (int, float))
            else self.host.put(prefix, handoff=payload, now=now)
        )
        if stored:
            self.index.insert(prefix, HOST_HOLDER)

    def store_host(self, prefix: Sequence[int], handoff: Any = None,
                   nbytes: Optional[int] = None,
                   now: Optional[float] = None) -> bool:
        """Directly park a prefix payload in the host tier (teardown /
        drain paths)."""
        prefix = tuple(int(t) for t in prefix)
        ok = self.host.put(prefix, handoff=handoff, nbytes=nbytes, now=now)
        if ok:
            self.index.insert(prefix, HOST_HOLDER)
        self._sync_host_index()
        self._publish()
        return ok

    def _sync_host_index(self) -> None:
        """Drop index markers for prefixes the host tier evicted."""
        for prefix in self.index.prefixes(HOST_HOLDER):
            if not self.host.contains(prefix):
                self.index.remove(prefix, HOST_HOLDER)

    def drop_replica(self, rid: str) -> None:
        """A replica died/drained: forget its mirror and index entries
        (its device KV is gone — only the host tier survives it)."""
        self._replica_lru.pop(rid, None)
        self.index.drop_holder(rid)
        self._publish()

    # -- durability (control-plane journal snapshot section) -----------------

    def export_host_index(self) -> Dict[str, Any]:
        """Serialized host-tier *index* for the control-plane journal:
        which prefixes the host tier holds and how many bytes each
        charges. Payloads are deliberately NOT journaled — after
        :meth:`load_host_index` the index is warm (routing and capacity
        accounting work immediately) and payloads refetch on miss."""
        entries = []
        for prefix in sorted(self.index.prefixes(HOST_HOLDER)):
            if self.host.contains(prefix):
                entries.append({
                    "prefix": [int(t) for t in prefix],
                    "nbytes": int(self.host._bytes.get(tuple(prefix), 0)),
                })
        return {
            "prefix_tokens": self.prefix_tokens,
            "entries": entries,
        }

    def load_host_index(self, state: Dict[str, Any]) -> int:
        """Inverse of :meth:`export_host_index` on a fresh plane: re-park
        every journaled prefix as a capacity-model entry (``handoff=None``
        — the bytes ledger and routing index are restored; the payload
        itself rehydrates from a replica or refetches on first use).
        Returns the number of entries restored."""
        if not isinstance(state, dict):
            return 0
        restored = 0
        for e in state.get("entries") or []:
            try:
                prefix = tuple(int(t) for t in e["prefix"])
                nbytes = int(e.get("nbytes", 0))
            except (KeyError, TypeError, ValueError):
                continue
            if self.host.put(prefix, nbytes=nbytes):
                self.index.insert(prefix, HOST_HOLDER)
                restored += 1
        self._publish()
        return restored

    def _publish(self) -> None:
        _gauge(index_prefixes=self.index.n_prefixes)

    def stats(self) -> Dict[str, Any]:
        return {
            "prefix_tokens": self.prefix_tokens,
            "lookups": self.lookups,
            "index_hits": self.index_hits,
            "host_rehydrations": self.host_rehydrations,
            "hit_tokens": self.hit_tokens,
            "index_prefixes": self.index.n_prefixes,
            "index_nodes": self.index.nodes,
            "replicas_tracked": len(self._replica_lru),
            "host": self.host.stats(),
        }
