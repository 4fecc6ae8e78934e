"""Plan-key routing and tenant admission for the serving fleet (the JAX
package's ``serve/router.py``; the fleet that composes them is ROADMAP
Queue 1 item 14's second part).

Three pure, process-free pieces the fleet (``fleet.py``) composes — kept
free of subprocess/pipe machinery so every routing and fairness property
is unit-testable without spawning a worker:

* :class:`RendezvousRing` — highest-random-weight (rendezvous) hashing
  of plan keys onto worker names. The property the fleet's plan caches
  live on: membership changes move the MINIMUM of key space. When a
  worker leaves, only ITS keys move (every surviving worker's score for
  every key is unchanged, so no key changes owner between survivors);
  when a worker joins, only the keys the newcomer now wins move —
  1/N of key space in expectation. A restarted worker reuses its NAME, so its
  key range — and the request shapes the fleet prewarms it with —
  come back to the same slot.
* :class:`TenantPolicy` — per-tenant weighted quotas over the fleet's
  admission capacity. A tenant's quota is its weight share of the
  capacity **among currently-active tenants** (a tenant alone may use
  the whole fleet; when others are active the shares contract), so one
  hot tenant degrades to *their* budget, never the fleet's p99. Over
  quota is a structured ``Overloaded(reason="tenant_quota")``.
* :class:`FairQueue` — per-tenant FIFO subqueues drained by stride
  scheduling (each tenant carries a ``pass`` value advancing by
  ``1/weight`` per served request; the lowest pass goes next), so an
  admitted backlog from one tenant cannot starve another tenant's
  queued requests at the same worker.
"""

from __future__ import annotations

import collections
import hashlib
import threading
from typing import Any, Deque, Dict, List, Optional, Tuple

from .server import Overloaded

DEFAULT_TENANT = "default"


def _score(key: str, member: str) -> int:
    """Deterministic 64-bit rendezvous score of (key, member) — stable
    across processes and Python releases (no ``hash()`` randomization)."""
    h = hashlib.blake2b(f"{key}\x00{member}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big")


class RendezvousRing:
    """Highest-random-weight hashing of plan keys onto member names."""

    def __init__(self, members: Tuple[str, ...] = ()):
        self._lock = threading.Lock()
        self._members: List[str] = sorted(set(members))

    def members(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(self._members)

    def __len__(self) -> int:
        with self._lock:
            return len(self._members)

    def add(self, name: str) -> None:
        with self._lock:
            if name not in self._members:
                self._members.append(name)
                self._members.sort()

    def remove(self, name: str) -> None:
        with self._lock:
            if name in self._members:
                self._members.remove(name)

    def owner(self, key: str) -> Optional[str]:
        """The member owning ``key`` (None on an empty ring)."""
        with self._lock:
            if not self._members:
                return None
            return max(self._members, key=lambda m: _score(key, m))

    def ranked(self, key: str) -> Tuple[str, ...]:
        """Every member, best owner first (the reroute order: when the
        owner dies, the key's next home is ``ranked(key)[1]`` — already
        the second-highest score, so no recomputation disagrees)."""
        with self._lock:
            return tuple(sorted(self._members,
                                key=lambda m: _score(key, m),
                                reverse=True))


class TenantPolicy:
    """Weighted per-tenant admission quotas over a shared capacity.

    ``weights`` maps tenant name -> positive weight; unknown tenants get
    ``default_weight``. ``capacity`` is the fleet's total admission
    budget in requests (outstanding = admitted and not yet resolved).
    The quota of tenant *t* at admission time is::

        quota(t) = max(1, floor(capacity * w_t / W_active))

    where ``W_active`` sums the weights of tenants with outstanding > 0
    plus *t* itself — so a tenant alone may use the whole capacity, and
    shares contract only when there is actual contention. ``admit``
    either reserves one slot or raises the structured
    ``Overloaded(reason="tenant_quota")``; every admit must be paired
    with exactly one ``release`` when the request resolves."""

    def __init__(self, capacity: int,
                 weights: Optional[Dict[str, float]] = None,
                 default_weight: float = 1.0):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self.default_weight = float(default_weight)
        self.weights: Dict[str, float] = {}
        for t, w in (weights or {}).items():
            if float(w) <= 0:
                raise ValueError(f"tenant weight must be > 0, got {t}={w}")
            self.weights[str(t)] = float(w)
        self._lock = threading.Lock()
        self._outstanding: Dict[str, int] = {}

    def weight(self, tenant: str) -> float:
        return self.weights.get(tenant, self.default_weight)

    def outstanding(self, tenant: Optional[str] = None) -> int:
        with self._lock:
            if tenant is not None:
                return self._outstanding.get(tenant, 0)
            return sum(self._outstanding.values())

    def quota(self, tenant: str) -> int:
        """Current quota of ``tenant`` given who else is active."""
        with self._lock:
            return self._quota_locked(tenant)

    def _quota_locked(self, tenant: str) -> int:
        active = {t for t, n in self._outstanding.items() if n > 0}
        active.add(tenant)
        w_active = sum(self.weight(t) for t in active)
        share = self.capacity * self.weight(tenant) / w_active
        return max(1, int(share))

    def admit(self, tenant: str) -> int:
        """Reserve one outstanding slot for ``tenant``; returns its new
        outstanding count, or raises ``Overloaded("tenant_quota")``."""
        with self._lock:
            have = self._outstanding.get(tenant, 0)
            quota = self._quota_locked(tenant)
            if have >= quota:
                err = Overloaded("tenant_quota", have, 0.0, float(quota))
                err.tenant = tenant            # type: ignore[attr-defined]
                err.quota = quota              # type: ignore[attr-defined]
                raise err
            self._outstanding[tenant] = have + 1
            return have + 1

    def release(self, tenant: str) -> None:
        with self._lock:
            n = self._outstanding.get(tenant, 0)
            if n <= 1:
                self._outstanding.pop(tenant, None)
            else:
                self._outstanding[tenant] = n - 1

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Health-endpoint view: per active/configured tenant, its
        weight, outstanding count and current quota."""
        with self._lock:
            tenants = set(self._outstanding) | set(self.weights)
            return {t: {"weight": self.weight(t),
                        "outstanding": self._outstanding.get(t, 0),
                        "quota": self._quota_locked(t)}
                    for t in sorted(tenants)}


class FairQueue:
    """Per-tenant FIFO subqueues drained by stride scheduling.

    ``push`` appends to the tenant's subqueue; ``pop`` serves the
    non-empty tenant with the LOWEST pass value and advances that pass
    by ``1/weight`` — over time tenant *t* receives a ``w_t / W`` share
    of pops while backlogged, and an idle tenant's first request after
    a gap is served ahead of a backlogged tenant's queue (its pass is
    clamped up to the global floor, never left in the past to burst).
    Single-consumer semantics; thread-safe."""

    def __init__(self, policy: Optional[TenantPolicy] = None):
        self.policy = policy
        self._lock = threading.Lock()
        self._queues: Dict[str, Deque[Any]] = {}
        self._pass: Dict[str, float] = {}
        self._clock = 0.0

    def _weight(self, tenant: str) -> float:
        return self.policy.weight(tenant) if self.policy else 1.0

    def __len__(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._queues.values())

    def push(self, tenant: str, item: Any) -> int:
        with self._lock:
            q = self._queues.get(tenant)
            if q is None:
                q = self._queues[tenant] = collections.deque()
            if not q:
                # (Re)activation: start at the scheduler clock, not an
                # old pass — an idle tenant must neither burst from the
                # past nor pay for time it was not queued.
                self._pass[tenant] = max(self._pass.get(tenant, 0.0),
                                         self._clock)
            q.append(item)
            return len(q)

    def pop(self) -> Optional[Any]:
        with self._lock:
            candidates = [(self._pass[t], t)
                          for t, q in self._queues.items() if q]
            if not candidates:
                return None
            _, tenant = min(candidates)
            item = self._queues[tenant].popleft()
            self._clock = self._pass[tenant]
            self._pass[tenant] += 1.0 / self._weight(tenant)
            if not self._queues[tenant]:
                # Prune emptied tenants: an adversarial tenant-name
                # sweep must not grow the queue's dicts without bound
                # (the reactivation clamp makes a dropped pass
                # equivalent to the clock anyway).
                del self._queues[tenant]
                del self._pass[tenant]
            return item

    def drain(self) -> List[Any]:
        """Remove and return everything, fair order preserved."""
        out = []
        while True:
            item = self.pop()
            if item is None:
                return out
            out.append(item)

    def depths(self) -> Dict[str, int]:
        with self._lock:
            return {t: len(q) for t, q in self._queues.items() if q}
