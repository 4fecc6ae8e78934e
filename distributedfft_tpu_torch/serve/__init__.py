"""FFT-as-a-service: the long-lived serving layer of the port (the JAX
package's ``serve/``, but the fleet).

One resident process (one rank per process: a leader and its followers
over P > 1 ranks) keeps built plans hot and survives real traffic and
real faults:

* ``plancache`` — bounded LRU of live plans, keyed by request shape plus
  the coalescing batch bucket; a cache hit performs zero plan builds.
* ``server``   — :class:`Server`: deadline-aware admission control with
  load shedding (structured :class:`Overloaded`, never unbounded
  latency), same-shape request coalescing into batched-2D stacked
  execution, a per-key circuit breaker around the fallback ladder, a
  health/readiness snapshot over the metrics registry, and graceful
  drain.
* ``resident`` — :class:`ResidentSolver`: a Navier–Stokes run stepping
  beside the traffic, checkpointed through ``persist``.
* ``router``   — the fleet's pure routing and fairness pieces
  (:class:`RendezvousRing`, :class:`TenantPolicy`, :class:`FairQueue`).
* ``cli``      — the ``dfft-torch-serve`` executable: ``--drive`` runs
  the open-loop load generator (``testing/workloads.serve_load``)
  against an in-process server; ``--http`` serves ``/healthz`` /
  ``/readyz`` / ``/metrics`` / ``POST /fft`` over stdlib HTTP.

The fleet (``Fleet``, ``RemoteWorkerError``, ``ScaleController``: worker
processes behind the router) is ROADMAP Queue 1 item 14's second part;
those names raise ``NotImplementedError`` naming it.
"""

from . import plancache
from .plancache import (PlanCache, bucket_for, cache_key,
                        parse_request_key, request_key, request_key3d)
from .resident import ResidentSolver
from .router import FairQueue, RendezvousRing, TenantPolicy
from .server import (LATER_FLEET, Overloaded, RankFailed, Server,
                     ServerClosed, normalize_request)

__all__ = [
    "FairQueue", "Fleet", "Overloaded", "PlanCache", "RankFailed",
    "RemoteWorkerError", "RendezvousRing", "ResidentSolver",
    "ScaleController", "Server", "ServerClosed", "TenantPolicy",
    "bucket_for", "cache_key", "describe_request", "normalize_request",
    "parse_request_key", "plancache", "request_key", "request_key3d",
]


class _Later:
    """A fleet name of the JAX package: constructing it raises, naming
    the ROADMAP item that ports it."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"serve.{type(self).__name__} is not ported yet ({LATER_FLEET})")


class Fleet(_Later):
    """The JAX package's worker fleet behind the plan-key router."""


class ScaleController(_Later):
    """The JAX package's metrics-driven worker-count controller."""


class RemoteWorkerError(RuntimeError):
    """A fleet worker's failure, re-raised at the router (the fleet is
    not ported yet; nothing raises this)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"serve.RemoteWorkerError is not ported yet ({LATER_FLEET})")


def describe_request(nx: int, ny: int, nz=None, *, double: bool = False,
                     transform: str = "r2c", shard: str = "batch",
                     decomp: str = "slab", config=None, circuit_k: int = 3,
                     circuit_cooldown_s: float = 5.0,
                     max_coalesce: int = 8) -> list:
    """The ``serve:`` section of the JAX package's ``dfft-explain``: for
    one request shape,
    the plan-cache key it would occupy, its coalescing eligibility, and
    the circuit/ladder policy that would wrap its execution — all static
    (nothing is built or executed), reusing the same key and ladder
    machinery the live server uses. A 3D shape (``nz`` given) describes
    the volume form: the ``fft3d`` key family, single-shot execution on
    ``decomp``, no coalescing."""
    from ..resilience import fallback
    from ..utils.wisdom import _describe_comm
    code = "f64" if double else "f32"
    if nz is not None:
        base = request_key3d(nx, ny, int(nz), code, transform, decomp)
        lines = [
            f"  request key: {base}",
            f"  plan cache slots: {base} (single slot — volumes are "
            "single-shot, no coalescing buckets)",
            f"  coalescing: not eligible — 3D volumes execute one-shot "
            f"through the {decomp} plan family (no batch axis to stack "
            "along); concurrent volumes queue behind each other",
        ]
    else:
        base = request_key(nx, ny, code, transform, shard)
        buckets = []
        top = bucket_for(max_coalesce, max_coalesce)
        b = 1
        while b <= top:
            buckets.append(str(b))
            b <<= 1
        lines = [
            f"  request key: {base}",
            f"  plan cache slots: {base}#b{{{','.join(buckets)}}} "
            "(LRU, power-of-two coalescing buckets)",
        ]
    if nz is not None:
        pass
    elif shard == "batch":
        lines.append(
            f"  coalescing: eligible — same-key requests stack along the "
            f"batch axis (up to {max_coalesce}; batch_chunk=1 per-plane "
            "rendering, bit-identical to single-shot)")
    else:
        lines.append(
            f"  coalescing: eligible — stacked along the untouched batch "
            f"axis of the shard='x' slab pipeline (up to {max_coalesce}; "
            "whole-stack fused, exchanges per batch)")
    lines.append(
        f"  circuit: {circuit_k} consecutive failures open; half-open "
        f"probe after {circuit_cooldown_s:g} s (plan cache invalidated on "
        "open, so the probe rebuilds)")
    if config is not None:
        ladder = fallback.ladder_preview(config)
        if ladder:
            steps = " -> ".join(f"[{r}] {lbl}" for r, lbl in ladder)
            lines.append(f"  inside the circuit: fallback ladder {steps} "
                         "-> failure counts toward the breaker")
        else:
            lines.append("  inside the circuit: default rendering, no "
                         "ladder — each failure counts toward the breaker")
        lines.append(f"  served config: {_describe_comm(config)}")
    return lines
