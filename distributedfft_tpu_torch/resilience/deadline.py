"""Cooperative per-request deadlines — the serving layer's time budget
(the port's copy of the JAX package's ``resilience/deadline.py``).

A long-lived server cannot let one slow request consume unbounded wall
clock: every admitted request carries a deadline, and every host-side
layer under it (the fallback ladder's rebuild-and-retry loop, the serve
executor, future retry machinery) must be able to ask "how much time is
left?" without threading a parameter through every call. This module is
that channel: a monotonic-clock :class:`Deadline` value plus a
thread-local ambient scope —

    with deadline.scope(Deadline.after_ms(250)):
        ...            # anything on this thread can call deadline.current()

Scopes nest; the EFFECTIVE deadline is always the tightest enclosing one
(a caller can only shrink the budget of its callees, never extend it).
``fallback.execute`` consults the ambient deadline so a ladder walk on
behalf of a served request stops when the request's budget is gone, not
at the process-wide ``DFFT_FALLBACK_DEADLINE_S`` horizon.

Deadlines here are COOPERATIVE: nothing is interrupted mid-flight (a
launched pipeline cannot be preempted anyway); expiry is observed at the
next check point. The serving layer checks before execution (an expired
request never executes) and after (a result that arrived too late is
reported as :class:`DeadlineExceeded`, not as a success).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Iterator, Optional


class DeadlineExceeded(TimeoutError):
    """Structured expiry: the request's budget was exhausted before (or
    while) producing its result. ``detail`` says where expiry was
    observed (``queued`` / ``executing`` / ``ladder``)."""

    def __init__(self, msg: str, *, detail: str = "expired",
                 overrun_ms: float = 0.0):
        super().__init__(msg)
        self.detail = detail
        self.overrun_ms = float(overrun_ms)


@dataclasses.dataclass(frozen=True)
class Deadline:
    """An absolute instant on the monotonic clock (``time.monotonic``
    seconds). Immutable; compare/propagate freely across threads."""

    expires_at: float

    @classmethod
    def after_ms(cls, ms: float) -> "Deadline":
        return cls(time.monotonic() + float(ms) / 1e3)

    @classmethod
    def after_s(cls, s: float) -> "Deadline":
        return cls(time.monotonic() + float(s))

    def remaining_s(self) -> float:
        """Seconds left; negative once expired."""
        return self.expires_at - time.monotonic()

    def remaining_ms(self) -> float:
        return self.remaining_s() * 1e3

    def expired(self) -> bool:
        return self.remaining_s() <= 0.0

    def tighter(self, other: Optional["Deadline"]) -> "Deadline":
        """The earlier of the two (``other=None`` keeps self)."""
        if other is None or self.expires_at <= other.expires_at:
            return self
        return other


class _Tls(threading.local):
    def __init__(self) -> None:
        self.stack: list = []


_TLS = _Tls()


def current() -> Optional[Deadline]:
    """The ambient (tightest enclosing) deadline of this thread, or None
    when no scope is open."""
    stack = _TLS.stack
    return stack[-1] if stack else None


@contextlib.contextmanager
def scope(dl: Optional[Deadline]) -> Iterator[Optional[Deadline]]:
    """Install ``dl`` as the ambient deadline for the ``with`` body.
    Nested scopes only ever TIGHTEN: the effective deadline is the min of
    ``dl`` and any enclosing scope. ``scope(None)`` is a no-op pass-through
    (callers need not branch on "has a deadline")."""
    if dl is None:
        yield current()
        return
    eff = dl.tighter(current())
    _TLS.stack.append(eff)
    try:
        yield eff
    finally:
        _TLS.stack.pop()


def remaining_s(default: float) -> float:
    """Seconds left on the ambient deadline, or ``default`` without one."""
    dl = current()
    return default if dl is None else dl.remaining_s()


def check(detail: str = "expired") -> None:
    """Raise :class:`DeadlineExceeded` if the ambient deadline has passed
    (a cheap cooperative checkpoint for host-side loops)."""
    dl = current()
    if dl is not None and dl.expired():
        over = -dl.remaining_ms()
        raise DeadlineExceeded(
            f"deadline exceeded by {over:.1f} ms ({detail})",
            detail=detail, overrun_ms=over)
