"""Version-keyed result cache for the gateway read path.

Real biomedical-API traffic is heavily repeated: a small set of popular
terms dominates (KGvec2go served exactly this shape as a public web
API), so the same ``sim`` / ``closest-concepts`` / ``get-vector``
requests arrive over and over. Everything upstream of the kernel is
deterministic *per pinned snapshot version*, which makes the full typed
response safely cacheable as long as the key carries the resolved
version — a new release changes the version, so it can never be served
stale bytes, and the publish→invalidate listener purges the old
ontology's entries eagerly anyway.

The cache is an LRU ordered dict with per-entry hit counters and an
LFU-biased eviction: when over budget we look at a small window of the
coldest (least recently used) entries and evict the least *frequently*
used among them. That keeps one-hit-wonder scan traffic from flushing
the hot Zipf head the way pure LRU would, without the bookkeeping of a
full frequency heap. Capacity is bounded twice — by entry count and by
(approximate, caller-reported) response bytes — so a burst of large
``closest-concepts`` pages cannot balloon resident memory.

Keys are built by the gateway as
``(route, ontology, model, resolved_version, canonical_payload)`` where
``canonical_payload`` is a sorted-key JSON dump of the request payload.
JSON canonicalisation matters: a tuple of raw field values would alias
``True`` with ``1`` (equal ints in Python) and serve a cached response
for a payload the validator should reject; ``json.dumps`` keeps them
distinct (``true`` vs ``1``).

Thread-safe; every public method takes the internal lock.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, Hashable, Optional, Tuple

__all__ = ["ResultCache", "canonical_payload"]

# How many cold-end entries the evictor considers before dropping the
# least frequently used among them (the "LFU window" of the LRU order).
_EVICT_WINDOW = 8


def canonical_payload(payload: Dict[str, Any]) -> Optional[str]:
    """Deterministic string form of a request payload, or None if the
    payload contains something non-JSON (then it is simply not cached)."""
    import json
    try:
        return json.dumps(payload, sort_keys=True, separators=(",", ":"))
    except (TypeError, ValueError):
        return None


class _Entry:
    __slots__ = ("value", "nbytes", "hits")

    def __init__(self, value: Any, nbytes: int) -> None:
        self.value = value
        self.nbytes = nbytes
        self.hits = 0


class ResultCache:
    """Bounded LFU/LRU map from request keys to typed response objects.

    Both bounds must be positive — to disable caching the gateway simply
    does not construct a cache (``result_cache_entries=0``) rather than
    carrying an unbounded mode here.
    """

    def __init__(self, max_entries: int = 4096,
                 max_bytes: int = 32 << 20) -> None:
        if max_entries <= 0:
            raise ValueError(f"max_entries must be positive, got {max_entries}")
        if max_bytes <= 0:
            raise ValueError(f"max_bytes must be positive, got {max_bytes}")
        self.max_entries = int(max_entries)
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._data: "OrderedDict[Tuple[Hashable, ...], _Entry]" = OrderedDict()
        self._bytes = 0
        self._hits = 0
        self._misses = 0
        self._insertions = 0
        self._evictions = 0
        self._invalidations = 0
        self._oversize = 0

    # ------------------------------------------------------------- core
    def get(self, key: Tuple[Hashable, ...]) -> Optional[Any]:
        """Return the cached response for ``key`` or None. Hits move the
        entry to the hot end and bump its frequency counter."""
        with self._lock:
            entry = self._data.get(key)
            if entry is None:
                self._misses += 1
                return None
            entry.hits += 1
            self._data.move_to_end(key)
            self._hits += 1
            return entry.value

    def put(self, key: Tuple[Hashable, ...], value: Any, nbytes: int) -> bool:
        """Insert ``value`` under ``key``; ``nbytes`` is the caller's
        estimate of the response's serialized size (used for the byte
        bound). Returns False when the entry alone exceeds ``max_bytes``
        (it is refused rather than flushing the whole cache for it)."""
        nbytes = int(nbytes)
        if nbytes > self.max_bytes:
            with self._lock:
                self._oversize += 1
            return False
        with self._lock:
            old = self._data.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._data[key] = _Entry(value, nbytes)
            self._bytes += nbytes
            self._insertions += 1
            self._evict_locked()
            return True

    def _evict_locked(self) -> None:
        while len(self._data) > self.max_entries or self._bytes > self.max_bytes:
            # LFU over a window of the LRU cold end: among the oldest
            # few entries, drop the one with the fewest hits.
            victim = None
            victim_hits = None
            for i, (k, e) in enumerate(self._data.items()):
                if i >= _EVICT_WINDOW:
                    break
                if victim_hits is None or e.hits < victim_hits:
                    victim, victim_hits = k, e.hits
            if victim is None:  # pragma: no cover - empty cache can't be over
                return
            entry = self._data.pop(victim)
            self._bytes -= entry.nbytes
            self._evictions += 1

    # ----------------------------------------------------- invalidation
    def invalidate_ontology(self, ontology: str) -> int:
        """Drop every entry whose key names ``ontology`` (key slot 1).

        Called from the engine's publish→invalidate listener. Version
        keying already makes stale hits impossible (a new release
        resolves to a new version and therefore a new key); the eager
        purge just stops superseded versions from squatting on capacity.
        """
        with self._lock:
            dead = [k for k in self._data if len(k) > 1 and k[1] == ontology]
            for k in dead:
                self._bytes -= self._data.pop(k).nbytes
            self._invalidations += len(dead)
            return len(dead)

    def clear(self) -> int:
        with self._lock:
            n = len(self._data)
            self._data.clear()
            self._bytes = 0
            self._invalidations += n
            return n

    # ------------------------------------------------------------ stats
    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    @property
    def nbytes(self) -> int:
        with self._lock:
            return self._bytes

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "entries": len(self._data),
                "bytes": self._bytes,
                "max_entries": self.max_entries,
                "max_bytes": self.max_bytes,
                "hits": self._hits,
                "misses": self._misses,
                "insertions": self._insertions,
                "evictions": self._evictions,
                "invalidations": self._invalidations,
                "oversize_rejects": self._oversize,
            }
