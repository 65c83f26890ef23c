"""Latency histograms for the serving/gateway metrics surface.

One fixed, log-spaced bucket layout shared by every histogram in the
process (Prometheus-style cumulative-friendly counts, but stored
per-bucket): upper bounds run 0.01 ms .. ~84 s at x2 per bucket, plus a
+Inf overflow bucket. Fixed buckets mean snapshots from different
routes, processes, or runs can be merged by adding counts, and p50/p99
are derivable from any snapshot without keeping raw samples.

Thread-safe: ``observe`` is called from gateway request threads and the
scheduler's flush loop concurrently.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence

#: bucket upper bounds in milliseconds: 0.01ms * 2^i, i = 0..23 (~84 s),
#: then +Inf. 25 integers per snapshot — cheap enough to ship in /stats.
BUCKET_BOUNDS_MS: List[float] = [0.01 * (2 ** i) for i in range(24)]


class LatencyHistogram:
    """Fixed log-spaced latency histogram with derivable percentiles."""

    __slots__ = ("_lock", "_counts", "count", "_sum_ms", "_min_ms", "_max_ms")

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = [0] * (len(BUCKET_BOUNDS_MS) + 1)   # last = +Inf
        self.count = 0
        self._sum_ms = 0.0
        self._min_ms: Optional[float] = None
        self._max_ms: Optional[float] = None

    def observe(self, seconds: float) -> None:
        ms = max(seconds, 0.0) * 1e3
        i = 0
        for bound in BUCKET_BOUNDS_MS:
            if ms <= bound:
                break
            i += 1
        with self._lock:
            self._counts[i] += 1
            self.count += 1
            self._sum_ms += ms
            if self._min_ms is None or ms < self._min_ms:
                self._min_ms = ms
            if self._max_ms is None or ms > self._max_ms:
                self._max_ms = ms

    # ------------------------------------------------------------------ #
    @staticmethod
    def percentile_from(counts: Sequence[int], q: float) -> Optional[float]:
        """Derive the q-th percentile (0 < q < 100) from a bucket-count
        vector laid out like :data:`BUCKET_BOUNDS_MS` (+Inf tail). Linear
        interpolation inside the winning bucket; the overflow bucket
        reports its lower bound (the histogram's honest answer)."""
        total = sum(counts)
        if total == 0:
            return None
        target = total * q / 100.0
        seen = 0.0
        for i, c in enumerate(counts):
            if seen + c >= target and c > 0:
                if i >= len(BUCKET_BOUNDS_MS):          # +Inf bucket
                    return BUCKET_BOUNDS_MS[-1]
                lo = BUCKET_BOUNDS_MS[i - 1] if i else 0.0
                hi = BUCKET_BOUNDS_MS[i]
                frac = (target - seen) / c
                return lo + (hi - lo) * frac
            seen += c
        return BUCKET_BOUNDS_MS[-1]

    def percentile(self, q: float) -> Optional[float]:
        with self._lock:
            counts = list(self._counts)
        return self.percentile_from(counts, q)

    @staticmethod
    def merge_snapshots(snapshots: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
        """Merge ``snapshot()`` dicts from different histograms — routes,
        processes, or runs — into one snapshot of the union stream.  The
        fixed bucket layout is what makes this exact for counts and
        min/max/sum; p50/p99 are re-derived from the merged counts (bucket
        resolution, same as any single snapshot).  Empty input or
        all-empty snapshots merge to an all-zero snapshot."""
        counts = [0] * (len(BUCKET_BOUNDS_MS) + 1)
        count, sum_ms = 0, 0.0
        min_ms: Optional[float] = None
        max_ms: Optional[float] = None
        for s in snapshots:
            sc = s.get("bucket_counts") or []
            if len(sc) != len(counts):
                raise ValueError(
                    f"incompatible bucket layout: {len(sc)} buckets, "
                    f"expected {len(counts)}")
            for i, c in enumerate(sc):
                counts[i] += c
            count += s.get("count", 0)
            sum_ms += s.get("sum_ms") or 0.0
            for v in (s.get("min_ms"),):
                if v is not None and (min_ms is None or v < min_ms):
                    min_ms = v
            for v in (s.get("max_ms"),):
                if v is not None and (max_ms is None or v > max_ms):
                    max_ms = v
        out: Dict[str, Any] = {
            "count": count,
            "sum_ms": round(sum_ms, 4),
            "min_ms": None if min_ms is None else round(min_ms, 4),
            "max_ms": None if max_ms is None else round(max_ms, 4),
            "bucket_le_ms": [round(b, 5) for b in BUCKET_BOUNDS_MS] + ["inf"],
            "bucket_counts": counts,
        }
        for name, q in (("p50_ms", 50.0), ("p99_ms", 99.0)):
            p = LatencyHistogram.percentile_from(counts, q)
            out[name] = None if p is None else round(p, 4)
        return out

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able state: bucket bounds + counts (merge by adding
        counts), totals, and the derived p50/p99 for convenience."""
        with self._lock:
            counts = list(self._counts)
            out: Dict[str, Any] = {
                "count": self.count,
                "sum_ms": round(self._sum_ms, 4),
                "min_ms": None if self._min_ms is None
                else round(self._min_ms, 4),
                "max_ms": None if self._max_ms is None
                else round(self._max_ms, 4),
            }
        out["bucket_le_ms"] = [round(b, 5) for b in BUCKET_BOUNDS_MS] + ["inf"]
        out["bucket_counts"] = counts
        for name, q in (("p50_ms", 50.0), ("p99_ms", 99.0)):
            p = self.percentile_from(counts, q)
            out[name] = None if p is None else round(p, 4)
        return out
