"""Resilience layer of the port: numerical guards, fault injection,
graceful fallback — the JAX package's ``resilience/``, one process per
rank.

* ``guards``   — Parseval/energy-conservation and wire-drift checks
  (``Config(guards="off|check|enforce")`` / ``--guards`` /
  ``$DFFT_GUARDS``), their partial sums all-reduced over the plan's group
  so every rank reaches one verdict; ``GuardViolation`` in enforce mode.
* ``inject``   — deterministic, seed-keyed fault injectors (wire payload
  corruption, coordinator unavailability, ...) active only under
  ``$DFFT_FAULT_SPEC``.
* ``fallback`` — the graceful-degradation ladder (ring/streams -> opt1 ->
  default -> All2All; bf16 -> native), its ranks agreeing on each
  attempt; a kernel error is never a rung.
* ``selftest`` — the CLI ``--selftest`` roundtrip (imported on demand: it
  pulls in the testcase harness, which this package root must not).
* ``deadline`` — cooperative deadlines with thread-local scope
  propagation (``fallback.execute`` bounds its ladder walk by the ambient
  deadline).
* ``circuit``  — a per-key circuit breaker (closed -> open on K
  consecutive failures -> half-open probe -> close).

Host-side retry/backoff (coordinator connect) lives with the machinery it
protects (``parallel/multihost.py``) and reports through ``obs``.
"""

from . import circuit, deadline, fallback, guards, inject
from .circuit import CircuitBreaker, CircuitOpen
from .deadline import Deadline, DeadlineExceeded
from .guards import GuardViolation, parseval_tolerance
from .inject import FaultSpec, parse_fault_spec, parse_fault_specs

__all__ = [
    "CircuitBreaker", "CircuitOpen", "Deadline", "DeadlineExceeded",
    "FaultSpec", "GuardViolation", "circuit", "deadline", "fallback",
    "guards", "inject", "parse_fault_spec", "parse_fault_specs",
    "parseval_tolerance",
]
