"""Per-key circuit breaker — stop re-executing a plan that keeps failing
(the port's copy of the JAX package's ``resilience/circuit.py``).

The fallback ladder (``fallback.py``) handles ONE failure gracefully:
demote a rung, rebuild, retry. A serving process needs the next layer up:
when a plan key fails repeatedly even through the ladder (a poisoned
shape, a faulted link, a compiler regression), re-running it burns the
queue's latency budget on work that is known-bad. The breaker turns that
into fast, structured rejection:

* ``closed``    — normal operation; failures are counted, any success
  resets the count.
* ``open``      — ``failure_threshold`` CONSECUTIVE failures trip the
  circuit: ``allow()`` answers False (callers reject with
  :class:`CircuitOpen` instead of executing) until ``cooldown_s`` has
  passed.
* ``half_open`` — after the cooldown, exactly ONE probe call is admitted.
  Its success closes the circuit (normal traffic resumes); its failure
  re-opens it for another cooldown.

Every transition is loud: an ``obs.event`` named
``<prefix>.open|half_open|close`` (the serving layer uses prefix
``serve.circuit``, so chaos CI can grep the event log for
``serve.circuit.*`` evidence) and ``<prefix>.opened/closed/reopened``
metrics. The breaker is thread-safe and makes no assumptions about WHAT
failed — callers decide which exceptions count via ``record_failure``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from .. import obs

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitOpen(RuntimeError):
    """Structured rejection: the key's circuit is open (or its half-open
    probe slot is taken); the request was NOT executed."""

    def __init__(self, key: str, retry_after_s: float):
        super().__init__(
            f"circuit open for {key!r} (retry after "
            f"{max(retry_after_s, 0.0):.2f} s)")
        self.key = key
        self.retry_after_s = max(float(retry_after_s), 0.0)


class CircuitBreaker:
    """One key's breaker; see module docstring for the state machine."""

    def __init__(self, key: str, failure_threshold: int = 3,
                 cooldown_s: float = 5.0,
                 metrics_prefix: str = "circuit"):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if cooldown_s < 0:
            raise ValueError("cooldown_s must be >= 0")
        self.key = key
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self.prefix = metrics_prefix
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_inflight = False
        self._last_error: Optional[str] = None

    # -- introspection ----------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def snapshot(self) -> Dict[str, object]:
        """Health-endpoint view of this breaker."""
        with self._lock:
            snap: Dict[str, object] = {
                "state": self._state,
                "consecutive_failures": self._consecutive_failures,
                "failure_threshold": self.failure_threshold,
            }
            if self._state != CLOSED:
                snap["cooldown_remaining_s"] = round(
                    max(self._opened_at + self.cooldown_s
                        - time.monotonic(), 0.0), 3)
            if self._last_error:
                snap["last_error"] = self._last_error
            return snap

    def retry_after_s(self) -> float:
        with self._lock:
            if self._state == CLOSED:
                return 0.0
            return max(self._opened_at + self.cooldown_s
                       - time.monotonic(), 0.0)

    # -- state machine ----------------------------------------------------

    def _transition(self, to: str, why: str) -> None:
        """Caller holds the lock."""
        frm, self._state = self._state, to
        verb = {OPEN: "opened" if frm == CLOSED else "reopened",
                HALF_OPEN: "half_open", CLOSED: "closed"}[to]
        obs.metrics.inc(f"{self.prefix}.{verb}")
        obs.event(f"{self.prefix}.{'close' if to == CLOSED else to}",
                  key=self.key, frm=frm, why=why,
                  consecutive_failures=self._consecutive_failures)
        obs.notice(f"circuit[{self.key}]: {frm} -> {to} ({why})",
                   name=f"{self.prefix}.transition", key=self.key,
                   frm=frm, to=to)

    def allow(self) -> bool:
        """Whether a call may proceed now. In ``half_open`` exactly one
        caller gets True (the probe); a True answer obliges the caller to
        later invoke ``record_success`` or ``record_failure``."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if time.monotonic() - self._opened_at < self.cooldown_s:
                    return False
                self._transition(HALF_OPEN, "cooldown elapsed; probing")
                self._probe_inflight = True
                return True
            # half_open: one probe at a time
            if self._probe_inflight:
                return False
            self._probe_inflight = True
            return True

    def release(self) -> None:
        """Release an ``allow()`` slot WITHOUT a verdict (the admitted
        call never executed — e.g. every request in the batch had already
        expired): failure counts and state are untouched, but a
        half-open probe slot is freed for the next caller."""
        with self._lock:
            self._probe_inflight = False

    def record_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            self._probe_inflight = False
            self._last_error = None
            if self._state != CLOSED:
                self._transition(CLOSED, "probe succeeded")

    def record_failure(self, err: Optional[BaseException] = None) -> bool:
        """Count one failure; returns True when this failure OPENED (or
        re-opened) the circuit — callers use that edge to invalidate
        cached artifacts of the failing key (the serve plan cache drops
        the plan so the half-open probe rebuilds from scratch)."""
        with self._lock:
            self._consecutive_failures += 1
            self._probe_inflight = False
            if err is not None:
                self._last_error = f"{type(err).__name__}: {err}"[:300]
            if self._state == HALF_OPEN:
                self._opened_at = time.monotonic()
                self._transition(OPEN, "probe failed")
                return True
            if (self._state == CLOSED
                    and self._consecutive_failures >= self.failure_threshold):
                self._opened_at = time.monotonic()
                self._transition(
                    OPEN, f"{self._consecutive_failures} consecutive "
                          "failures")
                return True
            return False

    def reject(self) -> CircuitOpen:
        """The structured rejection for a disallowed call (also counts
        it: ``<prefix>.rejected``)."""
        obs.metrics.inc(f"{self.prefix}.rejected")
        return CircuitOpen(self.key, self.retry_after_s())
