"""LRU plan cache — built plans stay hot between requests (the JAX
package's ``serve/plancache.py``, same keys and semantics).

Every executable builds a plan per invocation; a serving process
amortizes that: the first request for a shape pays plan construction
(and, on the card, the kernels' first launch), every later request
reuses the SAME plan object, whose pipelines are already built — a cache
hit performs ZERO plan builds (pinned by ``tests/test_torch_serve.py`` via
build counts). Keys are the request vocabulary shared with the JAX
package (``fft2d/<nx>x<ny>/<f32|f64>/<r2c|c2c>/<shard>``), extended with
the coalescing batch bucket (plans are batch-static; requests coalesce
into power-of-two buckets so a traffic mix of 1..max_coalesce concurrent
same-shape requests builds at most ``log2(max_coalesce)+1`` plans per
shape).

Eviction is strict LRU over a bounded capacity (an unbounded cache is an
unbounded-memory serving process): ``get_or_build`` moves hits to the
back, inserts at the back, and drops the front when over capacity.
``serve.plan_cache.hits/misses/evictions`` count every outcome and the
``serve.plan_cache.size`` gauge tracks occupancy. ``invalidate_prefix``
drops every bucket of a failing request key — the circuit breaker calls
it on OPEN so the half-open probe rebuilds from scratch instead of
re-executing a poisoned plan."""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, Tuple

from .. import obs


VOLUME_DECOMPS = ("slab", "pencil")


def request_key(nx: int, ny: int, dtype_code: str, transform: str,
                shard: str) -> str:
    """The COALESCING key: requests agreeing on it may be stacked into one
    batched execution (and share one circuit breaker). Excludes the batch
    bucket (that is an execution detail) and the direction (forward and
    inverse share a plan)."""
    return f"fft2d/{nx}x{ny}/{dtype_code}/{transform}/{shard}"


def request_key3d(nx: int, ny: int, nz: int, dtype_code: str,
                  transform: str, decomp: str) -> str:
    """The 3D-volume request key. Same contract as the 2D
    family — one key per (shape, dtype, transform, decomposition) sharing
    one plan-cache slot and one circuit breaker — except volumes execute
    SINGLE-SHOT through the slab/pencil plan families, so there is no
    batch-bucket axis: the request key IS the cache key (no ``#b``
    suffix). ``decomp`` names the distributed decomposition the volume
    runs on (``slab`` | ``pencil``)."""
    if decomp not in VOLUME_DECOMPS:
        raise ValueError(f"decomp must be slab|pencil, got {decomp!r}")
    return f"fft3d/{nx}x{ny}x{nz}/{dtype_code}/{transform}/{decomp}"


def cache_key(base_key: str, bucket: int) -> str:
    """One plan-cache slot: the request key plus the batch bucket this
    plan was built for."""
    return f"{base_key}#b{bucket}"


def parse_request_key(key: str) -> Dict[str, Any]:
    """Invert :func:`request_key` / :func:`request_key3d` (any
    ``#b<bucket>`` suffix ignored). 2D keys parse to ``{"nx", "ny",
    "dtype", "transform", "shard"}``; 3D keys to ``{"nx", "ny", "nz",
    "dtype", "transform", "decomp"}``. The fleet uses this to turn the
    hot-key set it tracked for a dead worker back into the concrete
    shapes the REPLACEMENT must ``prewarm()`` before rejoining the ring
    — including a dead MESH worker's hot volume shapes, which the
    replacement rebuilds on whatever mesh it actually acquired. Raises
    ``ValueError`` on a malformed key."""
    base = key.split("#", 1)[0]
    parts = base.split("/")
    if len(parts) != 5 or parts[0] not in ("fft2d", "fft3d"):
        raise ValueError(f"not a serve request key: {key!r}")
    extents = parts[1].split("x")
    want = 2 if parts[0] == "fft2d" else 3
    if len(extents) != want or not all(e.isdigit() for e in extents):
        raise ValueError(f"malformed shape in request key: {key!r}")
    if parts[2] not in ("f32", "f64") or parts[3] not in ("r2c", "c2c"):
        raise ValueError(f"malformed dtype/transform in key: {key!r}")
    if parts[0] == "fft2d":
        return {"nx": int(extents[0]), "ny": int(extents[1]),
                "dtype": parts[2], "transform": parts[3],
                "shard": parts[4]}
    if parts[4] not in VOLUME_DECOMPS:
        raise ValueError(f"malformed decomp in request key: {key!r}")
    return {"nx": int(extents[0]), "ny": int(extents[1]),
            "nz": int(extents[2]), "dtype": parts[2],
            "transform": parts[3], "decomp": parts[4]}


class PlanCache:
    """Bounded LRU of live plan objects (thread-safe)."""

    def __init__(self, capacity: int = 8,
                 metrics_prefix: str = "serve.plan_cache"):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self.prefix = metrics_prefix
        self._lock = threading.Lock()
        self._slots: "OrderedDict[str, Any]" = OrderedDict()
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._builds = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._slots)

    def keys(self) -> Tuple[str, ...]:
        """LRU order, oldest first (the next eviction victim leads)."""
        with self._lock:
            return tuple(self._slots)

    def peek(self, key: str) -> bool:
        """Whether ``key`` holds a plan (no hit or miss is counted, the
        LRU order is unchanged): a multi-rank server's leader tells its
        followers whether it is about to build."""
        with self._lock:
            return key in self._slots

    def invalidate_key(self, key: str) -> bool:
        """Drop exactly ``key`` (a follower whose leader rebuilt it)."""
        with self._lock:
            dropped = self._slots.pop(key, None) is not None
            obs.metrics.gauge(f"{self.prefix}.size", len(self._slots))
        return dropped

    def get_or_build(self, key: str,
                     builder: Callable[[], Any]) -> Tuple[Any, bool]:
        """``(plan, hit)``. The builder runs OUTSIDE the cache lock (plan
        construction can take seconds; a concurrent same-key build is a
        duplicated build, not a deadlock, and the second insert wins)."""
        with self._lock:
            plan = self._slots.get(key)
            if plan is not None:
                self._slots.move_to_end(key)
                self._hits += 1
                obs.metrics.inc(f"{self.prefix}.hits")
                return plan, True
            self._misses += 1
            obs.metrics.inc(f"{self.prefix}.misses")
        with obs.span("serve.plan_build", key=key):
            plan = builder()
        with self._lock:
            self._builds += 1
            self._slots[key] = plan
            self._slots.move_to_end(key)
            while len(self._slots) > self.capacity:
                victim, _ = self._slots.popitem(last=False)
                self._evictions += 1
                obs.metrics.inc(f"{self.prefix}.evictions")
                obs.event("serve.plan_evicted", key=victim)
            obs.metrics.gauge(f"{self.prefix}.size", len(self._slots))
        return plan, False

    def invalidate_prefix(self, base_key: str) -> int:
        """Drop every bucket of ``base_key`` (circuit OPEN: the next probe
        must rebuild — a fault held in a built plan cannot clear without a
        rebuild). Returns the number of slots dropped."""
        dropped = 0
        with self._lock:
            for key in [k for k in self._slots
                        if k == base_key
                        or k.startswith(base_key + "#")]:
                del self._slots[key]
                dropped += 1
            obs.metrics.gauge(f"{self.prefix}.size", len(self._slots))
        if dropped:
            obs.event("serve.plan_invalidated", key=base_key, slots=dropped)
        return dropped

    def snapshot(self) -> Dict[str, Any]:
        """Health-endpoint view (counts since construction)."""
        with self._lock:
            n = len(self._slots)
            total = self._hits + self._misses
            return {"size": n, "capacity": self.capacity,
                    "hits": self._hits, "misses": self._misses,
                    "evictions": self._evictions, "builds": self._builds,
                    "hit_rate": round(self._hits / total, 4) if total else None,
                    "keys": list(self._slots)}

    def clear(self) -> None:
        with self._lock:
            self._slots.clear()
            obs.metrics.gauge(f"{self.prefix}.size", 0)


def bucket_for(n: int, max_coalesce: int) -> int:
    """The batch bucket a batch of ``n`` requests executes under: ALWAYS
    a power of two (the cache-key vocabulary ``prewarm`` enumerates) that
    fits ``n``, capped at the power-of-two CEILING of ``max_coalesce`` —
    so a non-power-of-two ``--max-coalesce`` widens the top bucket with
    padding instead of minting un-prewarmed non-power-of-two slots."""
    if n < 1:
        raise ValueError("bucket_for needs n >= 1")
    cap = 1
    while cap < max(max_coalesce, 1):
        cap <<= 1
    b = 1
    while b < n:
        b <<= 1
    b = min(b, cap)
    while b < n:  # degenerate n > max_coalesce: grow back to fit
        b <<= 1
    return b


