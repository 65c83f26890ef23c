"""The Bio-KGvec2go serving subsystem, on PyTorch.

The port of ``repro.core.serving``.  It implements the paper's API
functionalities in-process; the public surface is
``repro_torch.api.Gateway`` (route dispatch, typed wire schema,
structured ``ApiError`` codes, cursor-paginated download), and the HTTP
front end is a thin shim over it:

  * ``download``      — JSON payload of all class vectors for a version;
  * ``similarity``    — cosine similarity between two classes (ids or labels,
                        with case/whitespace normalization);
  * ``closest_concepts`` — top-k most similar classes, ranked table with
                        identifier, label, score and exploration URL.

Every index and engine runs on one explicit device
(``repro_torch.device.resolve_device``: the card unless the caller asks
for the CPU).  Top-k runs in the CUDA kernel on the card and in its plain
PyTorch version on the CPU; pair similarity stays on the host in numpy,
as in the reference, so ``sim`` scores are byte-identical.  With a
``ServingMesh`` of more than one shard, an index's table is row-sharded
over the mesh's devices instead
(``repro_torch.kernels.ops.topk_cosine_sharded``).

Architecture:

  ``EmbeddingIndex``   one (ontology, version, model) table, query-ready.
                       Top-k runs through the streaming driver
                       (``repro_torch.kernels.ops.topk_cosine``) with
                       per-query self-exclusion and k>N clamping *inside*
                       the kernel — sentinel rows are never surfaced.

  ``LRUIndexCache``    bounded LRU over built indices with hit/miss/eviction
                       counters, so a long-lived server over many
                       (ontology, model, version) combinations cannot OOM.

  ``ServingEngine``    resolves queries against an atomic per-ontology
                       *latest pointer*. Endpoints accept an optional
                       ``version`` for pinned reads; the updater's
                       ``invalidate`` swaps the pointer atomically, so
                       in-flight queries pinned to the old version finish
                       consistently while new queries see the new release.

  ``BatchScheduler``   the concurrent serving runtime. ``submit``
                       returns a future-style ``Ticket``; a daemon flush
                       loop drains per-(ontology, model, version, k) queues
                       under a deadline policy — a queue flushes when its
                       oldest request has waited ``flush_after_ms`` OR it
                       reaches ``max_batch``, whichever comes first — so
                       many independent clients get cross-client batching
                       without any of them driving ``flush()`` themselves.
                       Ticket IDs stay monotonic (never reset), micro-
                       batches pad to power-of-two buckets, and a failed
                       request rejects only its own ticket.
"""
from __future__ import annotations

import bisect
import dataclasses
import functools
import itertools
import json
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..device import resolve_device
from ..kernels import ops as kops
from .metrics import LatencyHistogram
from .registry import EmbeddingRegistry
# canonical normalization lives with the store so publish-time sidecars
# (sorted_labels) and serving agree
from ..checkpoint.store import norm_label as _norm_label


def _prefix_upper_bound(p: str) -> Optional[str]:
    """Smallest string greater than every string with prefix ``p`` — the
    exclusive upper bound of the prefix range in a sorted array.  None when
    no such string exists (p empty or all chars at the codepoint maximum),
    meaning the range extends to the end of the array."""
    for i in range(len(p) - 1, -1, -1):
        c = ord(p[i])
        if c < 0x10FFFF:
            return p[:i] + chr(c + 1)
    return None


def _edit_distance_capped(a: str, b: str, cap: int) -> int:
    """Levenshtein with early exit once every band entry exceeds ``cap``."""
    if abs(len(a) - len(b)) > cap:
        return cap + 1
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        best = i
        for j, cb in enumerate(b, 1):
            c = min(prev[j] + 1, cur[j - 1] + 1,
                    prev[j - 1] + (ca != cb))
            cur.append(c)
            best = min(best, c)
        if best > cap:
            return cap + 1
        prev = cur
    return prev[-1]


@dataclasses.dataclass
class ClosestConcept:
    identifier: str
    label: str
    score: float
    url: str


class EmbeddingIndex:
    """One (ontology, version, model) embedding table, ready to query.

    Zero-copy contract: ``embeddings`` may be a read-only ``np.memmap``
    view over the store's raw layout (``SnapshotStore.open_table``) and is
    kept as-is — never copied into a private array.  Normalization is
    lazy: per-row L2 norms come from the sidecar (``norms=``, also a
    memmap view) or are computed once here, and unit rows are produced on
    demand by ``unit_rows``.

    Scale-oblivious device residency: top-k streams the host table
    through the kernel in fixed ``block_rows`` slabs with the norms folded
    into the in-kernel score (``kernels.ops.topk_cosine``), so there is no
    full-table device copy and *no* (N, d) unit array on either side —
    peak device allocation is O(block_rows·d + Q·k) regardless of N.  Host
    memory stays in the shared page cache.  The index owns the pinned
    staging its streamed calls reuse.  With a ``mesh`` of more than one
    ``"data"`` shard the raw rows and norms are laid out in row blocks over
    its devices instead and stay resident there (the residency *is* the
    sharding); each shard normalizes its rows in the kernel.
    """

    def __init__(self, entity_ids: Sequence[str], labels: Sequence[str],
                 embeddings: np.ndarray, url_prefix: str = "https://bio.kgvec2go.org/concept/",
                 norms: Optional[np.ndarray] = None,
                 block_rows: Optional[int] = None,
                 sorted_labels: Optional[Sequence[str]] = None,
                 device=None, mesh=None):
        #: where top-k runs: the card unless the caller asks for the CPU
        #: (with a sharded table, on the mesh's devices)
        self.device = resolve_device(device)
        self.entity_ids = list(entity_ids)
        self.labels = list(labels)
        self.url_prefix = url_prefix
        #: streaming slab size for the host→device top-k walk (None =
        #: kernels.ops.STREAM_BLOCK_ROWS)
        self.block_rows = block_rows
        emb = np.asarray(embeddings)
        if emb.dtype != np.float32:
            emb = emb.astype(np.float32)
        self.embeddings = emb
        if norms is None:
            norms = np.linalg.norm(emb, axis=1)
        self.norms = np.asarray(norms, dtype=np.float32)
        self._staging = kops.StagingPool()
        # shard only when the mesh has more than one "data" device; else
        # the streaming host path keeps no device table at all
        self.mesh = mesh if kops.mesh_data_shards(mesh) > 1 else None
        if self.mesh is not None:
            (self._table_sharded, self._norms_sharded,
             self._n_real) = kops.shard_table_raw(emb, self.norms, self.mesh)
        self._id_to_row = {i: r for r, i in enumerate(self.entity_ids)}
        self._label_to_row: Dict[str, int] = {}
        for r, lbl in enumerate(self.labels):
            self._label_to_row.setdefault(_norm_label(lbl), r)
        #: sorted normalized labels for autocomplete (paper §6 future work).
        #: ``sorted_labels`` is the publish-time sidecar (store header);
        #: accepted only when consistent with this table's label set so a
        #: stale sidecar can never corrupt autocomplete.
        if (sorted_labels is not None
                and len(sorted_labels) == len(self._label_to_row)):
            self._sorted_labels = list(sorted_labels)
        else:
            self._sorted_labels = sorted(self._label_to_row)

    @property
    def nbytes(self) -> int:
        """Host bytes addressed by this index (table + norms). With an
        mmap-backed table these pages are shared and reclaimable, so this
        is an upper bound on private memory, not a measure of it."""
        return int(self.embeddings.nbytes + self.norms.nbytes)

    def unit_rows(self, rows) -> np.ndarray:
        """L2-normalized rows, computed on demand: bit-identical to
        slicing the eagerly-normalized full table (division is
        elementwise), without ever materializing a second (N, d) array on
        the host for the common small-batch case."""
        sub = np.asarray(self.embeddings[rows], dtype=np.float32)
        n = np.asarray(self.norms[rows], dtype=np.float32)
        return sub / np.maximum(n[..., None], 1e-12)

    @property
    def unit(self) -> np.ndarray:
        """Full normalized table, materialized per call — kept for
        callers/tests that want the whole matrix; hot paths use
        ``unit_rows`` or the streaming kernel path."""
        return self.unit_rows(slice(None))

    def device_table_bytes(self) -> int:
        """Bytes of *table* data pinned on devices by this index: 0 on the
        streaming host path (only transient O(block) slabs land on the
        device), the row blocks and norms, pad included, when sharded."""
        if self.mesh is None:
            return 0
        return sum(t.numel() * t.element_size()
                   for t in self._table_sharded + self._norms_sharded)

    # ------------------------------------------------------------------ #
    def autocomplete(self, prefix: str, limit: int = 10) -> List[str]:
        """Concept labels starting with ``prefix`` (paper §6 future work).

        Pure bisect range lookup on the sorted normalized labels: the
        matches are exactly ``[bisect_left(p), bisect_left(upper_bound(p))``
        — no scan, no window cap, O(log n + limit)."""
        p = _norm_label(prefix)
        lo = bisect.bisect_left(self._sorted_labels, p)
        ub = _prefix_upper_bound(p)
        hi = (len(self._sorted_labels) if ub is None
              else bisect.bisect_left(self._sorted_labels, ub, lo))
        return [self.labels[self._label_to_row[lbl]]
                for lbl in self._sorted_labels[lo:min(hi, lo + limit)]]

    def resolve_fuzzy(self, query: str, max_edits: int = 2
                      ) -> Optional[Tuple[int, str]]:
        """Typo-tolerant label match (paper §6 future work): the closest
        label within ``max_edits`` Levenshtein edits. Returns (row, label)
        or None. Exact matches short-circuit via resolve()."""
        q = _norm_label(query)
        best: Optional[Tuple[int, str]] = None
        best_d = max_edits + 1
        for lbl, row in self._label_to_row.items():
            # cheap pre-filters before the DP
            if abs(len(lbl) - len(q)) > max_edits:
                continue
            d = _edit_distance_capped(q, lbl, min(best_d - 1, max_edits))
            if d < best_d:
                best, best_d = (row, self.labels[row]), d
                if d == 1:
                    break
        return best

    # ------------------------------------------------------------------ #
    def resolve(self, query: str, fuzzy: bool = False) -> Optional[int]:
        if query in self._id_to_row:
            return self._id_to_row[query]
        row = self._label_to_row.get(_norm_label(query))
        if row is None and fuzzy:
            hit = self.resolve_fuzzy(query)
            return hit[0] if hit else None
        return row

    def vector(self, query: str) -> np.ndarray:
        row = self.resolve(query)
        if row is None:
            raise KeyError(f"unknown class {query!r}")
        return self.embeddings[row]

    def similarity(self, a: str, b: str) -> float:
        ra, rb = self.resolve(a), self.resolve(b)
        if ra is None or rb is None:
            # report EVERY unresolvable name, not just the first: a client
            # fixing one typo at a time is the paper's UX anti-pattern
            missing = [q for q, r in ((a, ra), (b, rb)) if r is None]
            raise KeyError(
                "unknown class(es): " + ", ".join(repr(m) for m in missing))
        ua, ub = self.unit_rows([ra, rb])
        return float(np.dot(ua, ub))

    def top_k(self, queries: Sequence[str], k: int = 10,
              exclude_self: bool = True) -> List[List[ClosestConcept]]:
        """Batched top-k closest concepts (the paper returns top 10)."""
        rows = []
        for q in queries:
            r = self.resolve(q)
            if r is None:
                raise KeyError(f"unknown class {q!r}")
            rows.append(r)
        return self.top_k_rows(rows, k, exclude_self=exclude_self)

    def top_k_rows(self, rows: Sequence[int], k: int = 10,
                   exclude_self: bool = True) -> List[List[ClosestConcept]]:
        """Top-k for already-resolved table rows.

        Self-exclusion and k>N clamping happen inside the kernel (per-query
        exclude operand + valid-count output), so results contain exactly
        ``min(k, N - exclude_self)`` real entries — no sentinel rows, no
        over-fetch-then-filter.
        """
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        rows = np.asarray(list(rows), dtype=np.int32)
        qvec = self.unit_rows(rows)                             # (Q, d)
        excl = rows if exclude_self else np.full(len(rows), -1, np.int32)
        if self.mesh is not None:
            scores, idx, valid = kops.topk_cosine_sharded(
                qvec, self._table_sharded, int(k), exclude_rows=excl,
                mesh=self.mesh, n_valid=self._n_real,
                norms=self._norms_sharded)
        else:
            # streaming host path: the raw table (np/memmap) is walked in
            # O(block_rows) slabs, norms folded in-kernel — no device copy
            scores, idx, valid = kops.topk_cosine(
                qvec, self.embeddings, int(k), exclude_rows=excl,
                norms=self.norms, block_rows=self.block_rows,
                device=self.device, staging=self._staging)
        return self._hits(scores.cpu().numpy(), idx.cpu().numpy(),
                          valid.cpu().numpy())

    def _hits(self, scores: np.ndarray, idx: np.ndarray,
              valid: np.ndarray) -> List[List[ClosestConcept]]:
        out: List[List[ClosestConcept]] = []
        for qi in range(scores.shape[0]):
            lst: List[ClosestConcept] = []
            for score, j in zip(scores[qi, :valid[qi]], idx[qi, :valid[qi]]):
                ident = self.entity_ids[int(j)]
                lst.append(ClosestConcept(ident, self.labels[int(j)],
                                          float(score), self.url_prefix + ident))
            out.append(lst)
        return out

    def knn_join_rows(self, rows: Sequence[int], k: int = 10,
                      exclude_self: bool = True, slab: int = 256):
        """All-pairs kNN join as a generator of ``(start, hits)`` slabs.

        Walks ``rows`` in fixed ``slab``-sized query blocks through the
        slab-iterated join kernel (streaming table residency on the host
        path), yielding each block's ``List[List[ClosestConcept]]`` as
        soon as it is scored.  The ids match :meth:`top_k_rows` called one
        row at a time.  The kernel scores each (query, row) pair on its
        own, so on the card the scores match bit for bit; on the CPU the
        matmul may sum in another order for another batch shape (last-ulp
        differences).  The generator boundary is where long-running jobs
        publish progress and observe cancellation.
        """
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        rows = np.asarray(list(rows), dtype=np.int32)
        if self.mesh is not None:
            # the sharded table stays on its devices: the sharded call a
            # slab at a time (the same merge contract, the same results)
            for start in range(0, len(rows), slab):
                yield start, self.top_k_rows(rows[start:start + slab], k,
                                             exclude_self=exclude_self)
            return
        excl = rows if exclude_self else np.full(len(rows), -1, np.int32)
        qvec = self.unit_rows(rows)
        for start, scores, idx, valid in kops.topk_cosine_join(
                qvec, self.embeddings, int(k), exclude_rows=excl,
                norms=self.norms, query_block_rows=slab,
                block_rows=self.block_rows, device=self.device,
                staging=self._staging):
            yield start, self._hits(scores, idx, valid)


class LRUIndexCache:
    """Bounded LRU of built ``EmbeddingIndex`` objects.

    Keyed (ontology, model, version). Each entry holds a full embedding
    table, so the bound is what keeps a long-lived server over many
    versions/models from growing without limit. Counters are cumulative.
    """

    def __init__(self, capacity: int = 8):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._data: "OrderedDict[Tuple[str, str, str], EmbeddingIndex]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: Tuple[str, str, str]) -> Optional[EmbeddingIndex]:
        with self._lock:
            idx = self._data.get(key)
            if idx is None:
                self.misses += 1
                return None
            self._data.move_to_end(key)
            self.hits += 1
            return idx

    def put(self, key: Tuple[str, str, str], index: EmbeddingIndex) -> None:
        with self._lock:
            self._data[key] = index
            self._data.move_to_end(key)
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)
                self.evictions += 1

    def pop_where(self, pred) -> int:
        """Drop every entry whose key satisfies ``pred`` (not counted as
        evictions — this is deliberate invalidation, not pressure).
        Returns how many were dropped.  Dropping an mmap-backed index
        releases the map once in-flight queries holding row views finish,
        at which point the snapshot files can be unlinked."""
        with self._lock:
            doomed = [k for k in self._data if pred(k)]
            for k in doomed:
                del self._data[k]
            return len(doomed)

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def __contains__(self, key: Tuple[str, str, str]) -> bool:
        with self._lock:
            return key in self._data

    def keys(self):
        with self._lock:
            return list(self._data.keys())

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"size": len(self._data), "capacity": self.capacity,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "bytes": sum(v.nbytes for v in self._data.values())}


class ServingEngine:
    """Serves published snapshots from an EmbeddingRegistry.

    Latest-version resolution goes through an atomic per-ontology pointer:
    ``invalidate`` (called by the updater after publishing) swaps the
    pointer, and already-built indices for the old version stay in the LRU
    until evicted — in-flight queries pinned to the old version finish
    consistently instead of racing a cache wipe.  Every index the engine
    builds runs top-k on the engine's device, or row-sharded over
    ``mesh`` (a ``launch.mesh.ServingMesh``) when it has several shards.
    """

    def __init__(self, registry: EmbeddingRegistry, cache_capacity: int = 8,
                 device=None, mesh=None):
        self.registry = registry
        self.cache = LRUIndexCache(cache_capacity)
        #: where every index built by this engine runs top-k
        self.device = resolve_device(device)
        #: the mesh every index built by this engine shards its table over
        self.mesh = mesh
        self._latest: Dict[str, str] = {}
        self._lock = threading.Lock()
        #: callbacks fired (outside the lock) after every latest-pointer
        #: swap — the gateway subscribes so versions/lineage caches track
        #: publishes immediately
        self._invalidate_listeners: List = []
        #: the engine's own gateway, built on first use by ``gateway()``
        self._default_gateway = None
        self._gw_lock = threading.Lock()

    # ------------------------- version resolution ---------------------- #
    def latest_version(self, ontology: str) -> str:
        """The pinned latest version for ``ontology`` (resolved from the
        registry on first use, then only moved by ``invalidate``)."""
        with self._lock:
            v = self._latest.get(ontology)
            if v is None:
                v = self.registry.store.latest_version(ontology)
                if v is None:
                    raise KeyError(f"no published versions for {ontology!r}")
                self._latest[ontology] = v
            return v

    def _index(self, ontology: str, model: str,
               version: Optional[str] = None) -> EmbeddingIndex:
        version = version or self.latest_version(ontology)
        key = (ontology, model, version)
        idx = self.cache.get(key)
        if idx is None:
            # serve path: zero-copy mmap view + sidecar norms when the raw
            # layout exists; .npz fallback for pre-raw snapshots
            ids, labels, table, norms, meta = self.registry.get_serving(
                ontology, model, version)
            idx = EmbeddingIndex(ids, labels, table, norms=norms,
                                 sorted_labels=meta.get("sorted_labels"),
                                 device=self.device, mesh=self.mesh)
            self.cache.put(key, idx)
        return idx

    def invalidate(self, ontology: str, new_version: Optional[str] = None
                   ) -> Optional[str]:
        """Atomic latest-pointer swap, called by the updater after a
        publish. Old-version indices are NOT dropped — version-pinned
        in-flight queries keep working; the LRU ages them out. Registered
        invalidate listeners (the gateway's versions/lineage caches) are
        notified after the swap.

        Before the swap, the new version's indices are warm-built for
        every model this engine is currently serving (anything cached for
        the ontology), so the first post-publish query never pays the
        index build — it hits a cache that already has the new version."""
        v = new_version or self.registry.store.latest_version(ontology)
        if v is not None:
            warm = {m for (o, m, _) in self.cache.keys() if o == ontology}
            for m in sorted(warm):
                try:
                    self._index(ontology, m, v)
                except Exception:
                    # a model absent from the new version fails on first
                    # query exactly as it did before warm-building existed
                    pass
        with self._lock:
            if v is None:
                self._latest.pop(ontology, None)
            else:
                self._latest[ontology] = v
            listeners = list(self._invalidate_listeners)
        for fn in listeners:
            try:
                fn(ontology, v)
            except Exception:
                pass     # a broken listener must not break the updater
        return v

    def drop_version(self, ontology: str, version: str) -> int:
        """Release every cached index for (ontology, \\*, version) so their
        mmap references drop and the snapshot's files can be unlinked once
        any in-flight queries finish (the maps close on GC). If the latest
        pointer names the dropped version it is cleared and re-resolves
        from the registry on next use. Returns the number of indices
        dropped."""
        n = self.cache.pop_where(
            lambda key: key[0] == ontology and key[2] == version)
        with self._lock:
            if self._latest.get(ontology) == version:
                self._latest.pop(ontology, None)
        return n

    def add_invalidate_listener(self, fn) -> None:
        """Register ``fn(ontology, new_version)`` to run after every
        latest-pointer swap."""
        with self._lock:
            self._invalidate_listeners.append(fn)

    def remove_invalidate_listener(self, fn) -> None:
        """Unregister a listener (no-op if absent) — a closed gateway
        must not stay reachable from, and mutated by, the engine."""
        with self._lock:
            try:
                self._invalidate_listeners.remove(fn)
            except ValueError:
                pass

    def cache_stats(self) -> Dict[str, int]:
        return self.cache.stats()

    # --------------------- the endpoints (deprecated) ------------------ #
    # Thin delegates kept for callers of the pre-gateway surface. The
    # public surface is repro_torch.api.Gateway — ``engine.gateway()`` —
    # which routes similarity-shaped reads through the BatchScheduler,
    # returns typed responses and raises structured ApiErrors. The
    # delegates translate ApiError back to the legacy KeyError/ValueError
    # contract.

    def gateway(self):
        """This engine's default :class:`repro_torch.api.Gateway` (lazily
        built; synchronous flush mode — pair it with
        ``scheduler.start()`` or a dedicated Gateway for loop mode)."""
        gw = self._default_gateway
        if gw is None:
            # imported here: api.gateway imports this module
            from ..api.gateway import Gateway
            with self._gw_lock:
                if self._default_gateway is None:
                    self._default_gateway = Gateway(self)
                gw = self._default_gateway
        return gw

    def _legacy(self, call):
        from ..api.schema import ApiError
        try:
            return call()
        except ApiError as e:
            raise e.legacy() from None

    def download(self, ontology: str, model: str,
                 version: Optional[str] = None) -> str:
        """Full download payload as one JSON string (deprecated: use
        ``engine.gateway().download(...)``, cursor-paginated)."""
        def run():
            gw = self.gateway()
            page = gw.download(ontology, model, version=version,
                               offset=0, limit=2048)
            rows = list(page.rows)
            while page.next_offset is not None:
                page = gw.download(ontology, model, version=page.version,
                                   offset=page.next_offset, limit=page.limit)
                rows.extend(page.rows)
            return json.dumps({ident: vec for ident, vec in rows})
        return self._legacy(run)

    def get_vector(self, ontology: str, model: str, query: str,
                   fuzzy: bool = False,
                   version: Optional[str] = None) -> np.ndarray:
        """The paper's ``get-vector`` endpoint, the raw embedding row
        (deprecated: use ``engine.gateway().get_vector(...)``)."""
        return self._legacy(lambda: np.asarray(
            self.gateway().get_vector(ontology, model, query, fuzzy=fuzzy,
                                      version=version).vector,
            dtype=np.float32))

    def similarity(self, ontology: str, model: str, a: str, b: str,
                   fuzzy: bool = False, version: Optional[str] = None) -> float:
        """Cosine similarity between two classes, through the gateway and
        its BatchScheduler (deprecated: use
        ``engine.gateway().similarity(...)``)."""
        return self._legacy(lambda: self.gateway().similarity(
            ontology, model, a, b, fuzzy=fuzzy, version=version).score)

    def closest_concepts(self, ontology: str, model: str, query: str,
                         k: int = 10, fuzzy: bool = False,
                         version: Optional[str] = None) -> List[ClosestConcept]:
        """Top-k closest concepts, through the gateway's batch-first path
        (deprecated: use ``engine.gateway().closest_concepts(...)``)."""
        def run():
            resp = self.gateway().closest_concepts(
                ontology, model, query, k=k, fuzzy=fuzzy, version=version)
            return [ClosestConcept(h.identifier, h.label, h.score, h.url)
                    for h in resp.results]
        return self._legacy(run)

    def autocomplete(self, ontology: str, model: str, prefix: str,
                     limit: int = 10, version: Optional[str] = None) -> List[str]:
        """Concept-label autocomplete (deprecated: use
        ``engine.gateway().autocomplete(...)``)."""
        return self._legacy(lambda: self.gateway().autocomplete(
            ontology, model, prefix, limit=limit, version=version).completions)


@dataclasses.dataclass
class TopKRequest:
    ontology: str
    model: str
    query: str
    k: int = 10
    version: Optional[str] = None    # None = pin to latest at submit time
    fuzzy: bool = False              # typo-tolerant query resolution
    #: per-request deadline budget in seconds (None = no deadline). A
    #: ticket still queued past submit+budget is rejected at flush time
    #: *before* any kernel work — its client already gave up.
    budget_s: Optional[float] = None


@dataclasses.dataclass
class SimRequest:
    """A pair-similarity read routed through the scheduler: many
    concurrent ``sim`` calls against the same (ontology, model, version)
    coalesce into one vectorized pairwise-dot batch instead of each
    taking a private index lookup."""
    ontology: str
    model: str
    a: str
    b: str
    fuzzy: bool = False
    version: Optional[str] = None
    budget_s: Optional[float] = None  # same semantics as TopKRequest


#: queue-key slot marking pair-similarity queues (top-k queues use their
#: real k >= 1, so -1 can never collide)
_SIM_K = -1


def _bucket_size(n: int, max_batch: int) -> int:
    """Smallest power of two >= n, capped at max_batch."""
    b = 1
    while b < n:
        b <<= 1
    return min(b, max_batch)


class SchedulerError(RuntimeError):
    """Raised by ``Ticket.result()`` when the request failed (unknown
    query/ontology/model/version, bad k, or a kernel error).

    ``code`` / ``details`` carry the structured cause when the scheduler
    knows it (stable ApiError codes — see ``repro_torch.api.schema``), e.g.
    ``code="UNKNOWN_CLASS", details={"missing": [...]}`` with *every*
    unresolvable name; both are None/{} for unclassified faults.
    """

    def __init__(self, message: str, code: Optional[str] = None,
                 details: Optional[Dict] = None):
        super().__init__(message)
        self.code = code
        self.details = dict(details or {})


@functools.total_ordering
class Ticket:
    """Future-style handle for one submitted top-k request.

    Resolved exactly once, by whichever flush (background loop or a manual
    ``flush()``) executes its batch. Interoperates with plain ints — hash,
    equality and ordering go through ``id`` — so the ticket-id-keyed dicts
    returned by ``flush()`` and ``scheduler.errors`` accept Ticket objects
    directly as keys.
    """

    __slots__ = ("id", "version", "created", "deadline", "_event", "_result",
                 "_error", "_error_code", "_error_details", "_cb_lock",
                 "_callbacks")

    def __init__(self, tid: int, version: Optional[str] = None):
        self.id = tid
        #: serving version pinned at submit time (None if submit failed
        #: before the version could be resolved)
        self.version = version
        #: monotonic submit timestamp — the anchor for the scheduler's
        #: submit->resolve latency histogram
        self.created = time.monotonic()
        #: absolute monotonic deadline (None = no budget): past it the
        #: flush loop rejects instead of executing — see TopKRequest.budget_s
        self.deadline: Optional[float] = None
        self._event = threading.Event()
        self._result = None          # List[ClosestConcept] or float (sim)
        self._error: Optional[str] = None
        self._error_code: Optional[str] = None
        self._error_details: Optional[Dict] = None
        self._cb_lock = threading.Lock()
        self._callbacks: List = []

    # --------------------------- future API ---------------------------- #
    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        """Block until resolved; raises SchedulerError if the request
        failed, TimeoutError if unresolved after ``timeout`` seconds."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"ticket {self.id} unresolved after {timeout}s")
        if self._error is not None:
            raise SchedulerError(self._error, self._error_code,
                                 self._error_details)
        return self._result

    def exception(self, timeout: Optional[float] = None) -> Optional[str]:
        """Block until resolved; the error message, or None on success."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"ticket {self.id} unresolved after {timeout}s")
        return self._error

    def add_done_callback(self, fn) -> None:
        """Call ``fn(self)`` once the ticket resolves — immediately if it
        already has. Fires on whichever thread resolves the ticket, so
        callbacks must be cheap and loop-safe (the async front end posts
        through ``loop.call_soon_threadsafe``). Exceptions are swallowed:
        a broken callback must not poison the flush loop."""
        with self._cb_lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        self._run_callback(fn)

    def _run_callback(self, fn) -> None:
        try:
            fn(self)
        except Exception:
            # swallowing is the add_done_callback contract: a broken
            # callback must not poison the flush loop that resolved us
            pass

    def _fire_callbacks(self) -> None:
        with self._cb_lock:
            cbs, self._callbacks = self._callbacks, []
        for fn in cbs:
            self._run_callback(fn)

    # --------------------- scheduler-internal ----------------------- #
    def _resolve(self, result) -> bool:
        """Returns False if the ticket was already resolved (never expected;
        the stress suite asserts the resolved counter stays exact)."""
        if self._event.is_set():
            return False
        self._result = result
        with self._cb_lock:
            self._event.set()
        self._fire_callbacks()
        return True

    def _reject(self, message: str, code: Optional[str] = None,
                details: Optional[Dict] = None) -> bool:
        if self._event.is_set():
            return False
        self._error = message
        self._error_code = code
        self._error_details = details
        with self._cb_lock:
            self._event.set()
        self._fire_callbacks()
        return True

    # ---------------------------- int interop --------------------------- #
    def __int__(self) -> int:
        return self.id

    __index__ = __int__

    def __hash__(self) -> int:
        return hash(self.id)

    def __eq__(self, other):
        if isinstance(other, Ticket):
            return self.id == other.id
        if isinstance(other, int):
            return self.id == other
        return NotImplemented

    def __lt__(self, other):
        if isinstance(other, Ticket):
            return self.id < other.id
        if isinstance(other, int):
            return self.id < other
        return NotImplemented

    def __repr__(self) -> str:
        if not self.done():
            state = "pending"
        else:
            state = "failed" if self._error is not None else "done"
        return f"Ticket({self.id}, {state})"


class BatchScheduler:
    """The concurrent serving runtime: groups top-k requests from many
    client threads into micro-batched kernel calls.

    ``submit`` returns a future-style ``Ticket``; results come back either
    through the background flush loop (``flush_after_ms``/``start``) with
    clients blocking on ``ticket.result()``, or through a caller-driven
    synchronous ``flush()`` — both resolve every drained ticket exactly
    once. Semantics:

      * **monotonic tickets** — one global ``itertools.count``, never reset,
        so tickets held across flushes can't collide with new submissions;
      * **version pinning at submit** — each request resolves its serving
        version when enqueued, so an update landing between submit and
        flush doesn't change what an in-flight request sees;
      * **per-(ontology, model, version, k) queues** — each flushes as one
        or more batched kernel calls;
      * **deadline policy** — with the flush loop running, a queue is
        drained when its oldest request has waited ``flush_after_ms`` OR
        the queue has reached ``max_batch`` queries, whichever comes
        first: full batches flush immediately, stragglers wait at most one
        deadline;
      * **power-of-two padding buckets** — micro-batches are padded up to
        the next power of two (≤ max_batch) by repeating the last query, so
        the kernel sees at most ~log2(max_batch) distinct Q shapes
        instead of one per batch size;
      * **poison isolation** — a failed request (unknown query, broken
        queue, kernel error) rejects only its own ticket (recorded in
        ``errors``), never the whole batch.
    """

    def __init__(self, engine: ServingEngine, max_batch: int = 64,
                 max_errors: int = 1024,
                 flush_after_ms: Optional[float] = None,
                 max_pending: Optional[int] = None,
                 default_budget_s: Optional[float] = None,
                 overload_retry_after_s: Optional[float] = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if flush_after_ms is not None and flush_after_ms < 0:
            raise ValueError(f"flush_after_ms must be >= 0, got {flush_after_ms}")
        if max_pending is not None and max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self.engine = engine
        #: admission control: once this many tickets are queued, further
        #: submits are fast-rejected with code OVERLOADED instead of
        #: growing the backlog without bound (None = unbounded intake)
        self.max_pending = max_pending
        #: deadline budget applied when the request carries none
        self.default_budget_s = default_budget_s
        #: retry hint attached to OVERLOADED rejects; default derives from
        #: the flush cadence (a couple of flush periods usually clears a
        #: bounded backlog)
        self.overload_retry_after_s = overload_retry_after_s
        # buckets are powers of two capped at the caller's exact max_batch
        # (the cap bounds kernel batch memory; a non-power-of-two max_batch
        # costs at most one extra batch shape for full batches)
        self.max_batch = max_batch
        self.max_errors = max_errors
        self.flush_after_ms = flush_after_ms
        self._tickets = itertools.count()
        self._queues: Dict[Tuple[str, str, str, int],
                           List[Tuple[Ticket, TopKRequest]]] = {}
        #: first-enqueue monotonic time per live queue (deadline anchor)
        self._born: Dict[Tuple[str, str, str, int], float] = {}
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        #: ticket id -> error message for the most recent failed requests
        #: (bounded at ``max_errors``: oldest entries are dropped)
        self.errors: Dict[int, str] = {}
        #: submit->resolve latency over every ticket (success or reject) —
        #: the serving-side histogram the gateway ships in /stats
        self.latency = LatencyHistogram()
        self.stats = {"submitted": 0, "resolved": 0, "flushes": 0,
                      "loop_flushes": 0, "deadline_flushes": 0,
                      "full_flushes": 0, "batches": 0, "sim_batches": 0,
                      "padded_queries": 0, "failed": 0,
                      # admission control / deadline accounting:
                      # rejected_overloaded = fast-rejects at intake,
                      # expired = deadline passed while queued (rejected at
                      # flush, zero kernel work), skipped_resolved = already
                      # resolved when the flush reached them (also skipped)
                      "rejected_overloaded": 0, "expired": 0,
                      "skipped_resolved": 0}
        if flush_after_ms is not None:
            self.start()

    # ------------------------------ intake ------------------------------ #
    def _record_errors_locked(self, errors: Dict[int, str]) -> None:
        """Merge into the error ring, keeping only the most recent
        ``max_errors``.  Caller holds ``self._lock`` (the ``_locked``
        suffix is the BIO001 contract for that)."""
        self.errors.update(errors)
        self.stats["failed"] += len(errors)
        while len(self.errors) > self.max_errors:
            self.errors.pop(next(iter(self.errors)))

    def _observe_latency(self, ticket: Ticket) -> None:
        self.latency.observe(time.monotonic() - ticket.created)

    def _reject_at_submit(self, ticket: Ticket, msg: str,
                          code: Optional[str] = None,
                          details: Optional[Dict] = None) -> Ticket:
        with self._lock:
            self._record_errors_locked({ticket.id: msg})
            if ticket._reject(msg, code, details):
                self.stats["resolved"] += 1
                self._observe_latency(ticket)
        return ticket

    def submit(self, req) -> Ticket:
        """Enqueue a :class:`TopKRequest` or :class:`SimRequest`; returns
        its future-style Ticket (top-k tickets resolve to a ranked
        ``List[ClosestConcept]``, sim tickets to a float score)."""
        with self._lock:
            tid = next(self._tickets)
            self.stats["submitted"] += 1
            # admission control *before* any registry/index work: rejecting
            # must stay cheap precisely when the scheduler is busiest
            if self.max_pending is not None and \
                    sum(len(v) for v in self._queues.values()) \
                    >= self.max_pending:
                self.stats["rejected_overloaded"] += 1
                overloaded = True
            else:
                overloaded = False
        if overloaded:
            return self._reject_at_submit(
                Ticket(tid),
                f"scheduler at capacity ({self.max_pending} pending)",
                "OVERLOADED",
                {"max_pending": self.max_pending,
                 "retry_after_s": self._retry_after_s()})
        try:
            version = req.version or self.engine.latest_version(req.ontology)
        except Exception as e:
            # unknown ontology — or any registry fault — fails only this
            # ticket, not the accept loop (and keeps resolved == submitted)
            code = "UNKNOWN_ONTOLOGY" if isinstance(e, KeyError) else None
            return self._reject_at_submit(
                Ticket(tid), str(e), code,
                {"ontology": req.ontology} if code else None)
        ticket = Ticket(tid, version=version)
        budget = getattr(req, "budget_s", None)
        if budget is None:
            budget = self.default_budget_s
        if budget is not None:
            ticket.deadline = ticket.created + budget
        if isinstance(req, SimRequest):
            key = (req.ontology, req.model, version, _SIM_K)
        else:
            # validate k at intake: a k < 1 (especially k == _SIM_K) must
            # never reach the queue key space — it would land top-k
            # requests in a sim queue and poison its coalesced peers
            if isinstance(req.k, bool) or not isinstance(req.k, int) \
                    or req.k < 1:
                return self._reject_at_submit(
                    ticket, f"k must be >= 1, got {req.k!r}", "BAD_REQUEST")
            key = (req.ontology, req.model, version, req.k)
        with self._cond:
            if self._stopping:
                stopped = True       # reject outside the lock hold below
            else:
                stopped = False
                q = self._queues.setdefault(key, [])
                q.append((ticket, req))
                self._born.setdefault(key, time.monotonic())
                # wake the loop for a brand-new deadline or a full batch; a
                # queue that's merely growing keeps its existing wake-up time
                if self._thread is not None and (
                        len(q) == 1 or len(q) >= self.max_batch):
                    self._cond.notify()
        if stopped:
            # after stop() nothing drains the queues: enqueueing would
            # strand the ticket forever, so refuse it (executor-shutdown
            # semantics; start() re-opens intake)
            return self._reject_at_submit(ticket, "scheduler is stopped",
                                          "SHUTTING_DOWN")
        return ticket

    def _retry_after_s(self) -> float:
        """Retry hint for OVERLOADED rejects: the configured value, else a
        couple of flush periods (a bounded backlog clears in about one)."""
        if self.overload_retry_after_s is not None:
            return float(self.overload_retry_after_s)
        return max(0.05, 2.0 * (self.flush_after_ms or 50.0) / 1e3)

    def accepting(self) -> bool:
        """False once stop() has closed intake (start() re-opens it)."""
        with self._lock:
            return not self._stopping

    def pending(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._queues.values())

    # ----------------------------- execution ---------------------------- #
    def _run_queues(self, queues: Dict[Tuple[str, str, str, int],
                                       List[Tuple[Ticket, TopKRequest]]],
                    collect: bool = True) -> Dict[int, List[ClosestConcept]]:
        """Execute drained queues (no scheduler lock held): batch, call the
        kernel, resolve every ticket exactly once. Returns {ticket id:
        result} for the successful tickets — unless ``collect`` is False
        (the background loop's path, where clients read their Tickets and
        the dict would be allocated only to be discarded)."""
        results: Dict[int, List[ClosestConcept]] = {}
        errors: Dict[int, str] = {}
        n_batches = n_padded = n_resolved = n_sim = 0
        n_expired = n_skipped = 0

        def reject(ticket: Ticket, msg: str, code: Optional[str] = None,
                   details: Optional[Dict] = None) -> None:
            nonlocal n_resolved
            if ticket._reject(msg, code, details):
                errors[ticket.id] = msg
                n_resolved += 1
                self._observe_latency(ticket)

        for (ont, model, version, k), items in queues.items():
            # drop dead weight *before* index build or kernel work: tickets
            # already resolved elsewhere, and tickets whose deadline budget
            # expired while queued — their clients have already received
            # TIMEOUT (e.g. the AsyncGateway call_later expiry), so
            # executing them would burn kernel time on answers nobody reads
            now = time.monotonic()
            fresh: List[Tuple[Ticket, TopKRequest]] = []
            for ticket, req in items:
                if ticket.done():
                    n_skipped += 1
                elif ticket.deadline is not None and now >= ticket.deadline:
                    n_expired += 1
                    reject(ticket,
                           f"deadline budget exhausted after "
                           f"{now - ticket.created:.3f}s in queue", "TIMEOUT",
                           {"queued_s": now - ticket.created})
                else:
                    fresh.append((ticket, req))
            items = fresh
            if not items:
                continue
            # a broken queue (unpublished model, bad version, k < 1) fails
            # only its own tickets — other queues in this flush still serve
            try:
                index = self.engine._index(ont, model, version)
            except Exception as e:
                # can't distinguish unknown model from unknown version at
                # this depth — the gateway classifies both pre-submit
                for ticket, _ in items:
                    reject(ticket, str(e))
                continue
            try:
                if k == _SIM_K:
                    # pair-similarity queue: one vectorized pairwise-dot
                    # per chunk instead of a private lookup per request
                    for start in range(0, len(items), self.max_batch):
                        chunk = items[start:start + self.max_batch]
                        live: List[Tuple[Ticket, int, int]] = []
                        for ticket, req in chunk:
                            try:
                                ra = index.resolve(req.a, fuzzy=req.fuzzy)
                                rb = index.resolve(req.b, fuzzy=req.fuzzy)
                            except Exception as e:
                                reject(ticket,
                                       f"bad query pair ({req.a!r}, {req.b!r})"
                                       f": {e}", "BAD_REQUEST")
                                continue
                            missing = [q for q, r in ((req.a, ra), (req.b, rb))
                                       if r is None]
                            if missing:
                                # report the FULL list of unresolvable names
                                reject(ticket, "unknown class(es): " +
                                       ", ".join(repr(m) for m in missing),
                                       "UNKNOWN_CLASS", {"missing": missing})
                            else:
                                live.append((ticket, ra, rb))
                        if not live:
                            continue
                        ua = index.unit_rows([ra for _, ra, _ in live])
                        ub = index.unit_rows([rb for _, _, rb in live])
                        scores = np.einsum("ij,ij->i", ua, ub)
                        for (ticket, _, _), s in zip(live, scores):
                            if collect:
                                results[ticket.id] = float(s)
                            if ticket._resolve(float(s)):
                                n_resolved += 1
                                self._observe_latency(ticket)
                        n_batches += 1
                        n_sim += 1
                    continue
                for start in range(0, len(items), self.max_batch):
                    chunk = items[start:start + self.max_batch]
                    live: List[Tuple[Ticket, int]] = []     # (ticket, row)
                    for ticket, req in chunk:
                        # a malformed query (e.g. None) fails alone too
                        try:
                            row = index.resolve(req.query, fuzzy=req.fuzzy)
                        except Exception as e:
                            reject(ticket, f"bad query {req.query!r}: {e}",
                                   "BAD_REQUEST")
                            continue
                        if row is None:
                            reject(ticket, f"unknown class {req.query!r}",
                                   "UNKNOWN_CLASS", {"missing": [req.query]})
                        else:
                            live.append((ticket, row))
                    if not live:
                        continue
                    rows = [r for _, r in live]
                    bucket = _bucket_size(len(rows), self.max_batch)
                    pad = bucket - len(rows)
                    try:
                        batch_res = index.top_k_rows(rows + [rows[-1]] * pad, k)
                    except Exception as e:
                        code = "BAD_REQUEST" if isinstance(e, ValueError) \
                            else None
                        for ticket, _ in live:
                            reject(ticket, str(e), code)
                        continue
                    for (ticket, _), res in zip(live, batch_res):
                        if collect:
                            results[ticket.id] = res
                        if ticket._resolve(res):
                            n_resolved += 1
                            self._observe_latency(ticket)
                    n_batches += 1
                    n_padded += pad
            except Exception as e:
                # anything unexpected rejects this queue's still-pending
                # tickets instead of escaping into the drainer
                for ticket, _ in items:
                    reject(ticket, f"scheduler internal error: {e}")
        with self._lock:
            self._record_errors_locked(errors)
            self.stats["batches"] += n_batches
            self.stats["sim_batches"] += n_sim
            self.stats["padded_queries"] += n_padded
            self.stats["resolved"] += n_resolved
            self.stats["expired"] += n_expired
            self.stats["skipped_resolved"] += n_skipped
        return results

    def _drain(self, queues, collect: bool = True
               ) -> Dict[int, List[ClosestConcept]]:
        """_run_queues with a last-resort guard: a bug in batch execution
        must reject the drained tickets, never strand them (queues are
        already popped — there is no requeue) or kill the flush loop."""
        try:
            return self._run_queues(queues, collect=collect)
        except Exception as e:
            msg = f"scheduler internal error: {e}"
            dropped: Dict[int, str] = {}
            for items in queues.values():
                for ticket, _ in items:
                    if ticket._reject(msg):
                        dropped[ticket.id] = msg
                        self._observe_latency(ticket)
            with self._lock:
                self._record_errors_locked(dropped)
                self.stats["resolved"] += len(dropped)
            return {}

    def flush(self) -> Dict[int, List[ClosestConcept]]:
        """Synchronously drain and execute everything pending. Coexists
        with the flush loop: each queue is popped under the lock, so a
        ticket is only ever executed (and resolved) by one drainer."""
        with self._lock:
            queues, self._queues = self._queues, {}
            self._born.clear()
        results = self._drain(queues)
        with self._lock:
            self.stats["flushes"] += 1
        return results

    # ----------------------------- flush loop --------------------------- #
    def start(self, flush_after_ms: Optional[float] = None) -> None:
        """Start the daemon flush loop (idempotent while running)."""
        if flush_after_ms is not None:
            self.flush_after_ms = flush_after_ms
        if self.flush_after_ms is None:
            raise ValueError("flush_after_ms is required to start the loop")
        with self._cond:
            if self._thread is not None and self._thread.is_alive():
                # idempotent while running — and after a timed-out stop()
                # this re-adopts the still-draining loop: clearing
                # _stopping reopens intake and the thread resumes serving
                self._stopping = False
                self._cond.notify_all()
                return
            self._stopping = False
            self._thread = threading.Thread(
                target=self._loop, name="BatchScheduler-flush", daemon=True)
            self._thread.start()

    def stop(self, drain: bool = True, timeout: float = 60.0) -> None:
        """Stop the loop; by default drain what's still queued so every
        outstanding ticket resolves before this returns. Raises
        RuntimeError if an in-flight drain doesn't finish within
        ``timeout`` — the guarantee would be silently broken otherwise."""
        with self._cond:
            thread, self._thread = self._thread, None
            self._stopping = True
            self._cond.notify_all()
        if thread is not None:
            thread.join(timeout)
            if thread.is_alive():
                with self._lock:
                    if self._thread is None:     # don't clobber a racing
                        self._thread = thread    # start()'s fresh loop
                raise RuntimeError(
                    f"flush loop still draining after {timeout}s")
        if drain:
            self.flush()

    def running(self) -> bool:
        with self._lock:
            return self._thread is not None and self._thread.is_alive()

    def __enter__(self) -> "BatchScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def _due_keys(self, now: float, period_s: float) -> List[
            Tuple[str, str, str, int]]:
        """Queues past their deadline or at/over max_batch (lock held)."""
        return [key for key, born in self._born.items()
                if now - born >= period_s
                or len(self._queues[key]) >= self.max_batch]

    def _loop(self) -> None:
        # a loop thread serves only while it is the *registered* thread:
        # stop() deregisters (sets _thread None/new), and a stale thread
        # that wakes later exits instead of racing a replacement loop
        me = threading.current_thread()
        while True:
            take: Dict[Tuple[str, str, str, int],
                       List[Tuple[Ticket, TopKRequest]]] = {}
            with self._cond:
                while not self._stopping and self._thread is me:
                    # re-read the deadline each pass: start(flush_after_ms=)
                    # on a running loop takes effect immediately
                    period_s = self.flush_after_ms / 1e3
                    due = self._due_keys(time.monotonic(), period_s)
                    if due:
                        break
                    if self._born:
                        # sleep until the earliest queue's deadline; a
                        # submit that fills a batch (or opens a queue with
                        # an earlier deadline) notifies us awake sooner
                        timeout = max(
                            0.0, min(self._born.values()) + period_s
                            - time.monotonic())
                        self._cond.wait(timeout=timeout)
                    else:
                        self._cond.wait()
                if self._stopping or self._thread is not me:
                    return
                n_full = 0
                for key in due:
                    items = self._queues.pop(key)
                    self._born.pop(key, None)
                    take[key] = items
                    n_full += len(items) >= self.max_batch
            self._drain(take, collect=False)
            with self._lock:
                self.stats["loop_flushes"] += 1
                self.stats["full_flushes"] += n_full
                self.stats["deadline_flushes"] += len(take) - n_full

