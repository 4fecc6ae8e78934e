"""Host-side span tracing with a per-run structured JSONL event log — the
port's copy of the JAX package's ``obs/tracing.py``, same schema.

A nestable ``span("plan.build")`` context manager that

* records wall-clock intervals into a per-process JSONL event log under
  ``$DFFT_OBS_DIR`` (``events-<pid>.jsonl``; one JSON object per line, see
  ``validate_event`` for the schema), and
* enters ``torch.profiler.record_function("dfft:<span name>")`` where the
  JAX package enters a ``jax.profiler.TraceAnnotation``, so inside a
  ``torch.profiler`` trace the same names appear on the timeline next to
  the device work they schedule.

ZERO-OVERHEAD-WHEN-OFF CONTRACT: with no ``$DFFT_OBS_DIR`` (and no
programmatic ``enable()``) there is **no file I/O and no profiler
annotation** — but spans/events/notices still land in the always-on
in-memory flight-recorder ring (``obs/flightrec.py``; a dict build and a
bounded deque append), so a trigger can dump the last seconds of
evidence even from a run that never enabled the log.
``$DFFT_FLIGHTREC=off`` restores the full drop. Spans are host-side
intervals around plan construction and execution; they launch nothing
on the device.

Everything here degrades rather than errors: an unwritable log directory
silently drops events (observability must never fail a run).

Event schema (one JSON object per line)::

    {"ev": "span" | "event",
     "name": "plan.build",           # non-empty dotted name
     "ts": 1722538000.123456,        # wall-clock epoch seconds at open
     "dur_ms": 12.34,                # spans only: wall interval
     "depth": 0,                     # nesting depth at open
     "parent": null | "outer.span",  # enclosing span name
     "pid": 12345, "seq": 7,         # per-process monotone sequence
     "attrs": {...}}                 # JSON-scalar details
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Iterable, Optional

ENV_VAR = "DFFT_OBS_DIR"

_LOCK = threading.Lock()
_SEQ = [0]
_FORCED_DIR: Optional[str] = None   # enable() override
_FORCE_OFF = False                  # disable() override (beats the env)
_CONSOLE = False                    # --obs: mirror notices to stdout


class _Tls(threading.local):
    def __init__(self):
        self.stack = []  # open span names, innermost last


_TLS = _Tls()


# ---------------------------------------------------------------------------
# enablement
# ---------------------------------------------------------------------------

def obs_dir() -> Optional[str]:
    """The active event-log directory, or None when tracing is off:
    ``enable(path)`` wins, then ``$DFFT_OBS_DIR``; ``disable()`` forces
    off regardless of the environment."""
    if _FORCE_OFF:
        return None
    if _FORCED_DIR:
        return _FORCED_DIR
    d = os.environ.get(ENV_VAR, "").strip()
    return d or None


def enabled() -> bool:
    return obs_dir() is not None


def enable(path: str) -> None:
    """Write the event log under ``path`` (programmatic ``$DFFT_OBS_DIR``;
    the CLI ``--obs-dir`` calls this)."""
    global _FORCED_DIR, _FORCE_OFF
    _FORCED_DIR = str(path)
    _FORCE_OFF = False


def disable() -> None:
    """Force tracing off (overrides both ``enable()`` and the env)."""
    global _FORCED_DIR, _FORCE_OFF
    _FORCED_DIR = None
    _FORCE_OFF = True


def reset_enablement() -> None:
    """Back to the pure-environment behavior (test hygiene)."""
    global _FORCED_DIR, _FORCE_OFF
    _FORCED_DIR = None
    _FORCE_OFF = False


def enable_console() -> None:
    """Mirror ``notice()`` one-liners to stdout (the CLI ``--obs`` flag)."""
    global _CONSOLE
    _CONSOLE = True


def disable_console() -> None:
    global _CONSOLE
    _CONSOLE = False


def console_enabled() -> bool:
    return _CONSOLE


def event_log_path() -> Optional[str]:
    """This process's event-log file (None when tracing is off)."""
    d = obs_dir()
    return None if d is None else os.path.join(d, f"events-{os.getpid()}.jsonl")


# ---------------------------------------------------------------------------
# emission
# ---------------------------------------------------------------------------

def _scalar(v):
    """Attrs must round-trip through JSON; anything exotic degrades to str
    (an event log line must never raise)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (tuple, list)):
        return [_scalar(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _scalar(x) for k, x in v.items()}
    return str(v)


def _emit(rec: Dict[str, Any]) -> None:
    """One finished record: always into the flight-recorder ring (bounded,
    in-memory), and into the JSONL log file only when tracing is on."""
    from . import flightrec
    flightrec.add(rec)
    path = event_log_path()
    if path is None:
        return
    try:
        line = json.dumps(rec, sort_keys=True)
        with _LOCK:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "a", encoding="utf-8") as f:
                f.write(line + "\n")
    except (OSError, TypeError, ValueError):
        pass  # observability degrades, never errors


def _base(ev: str, name: str, attrs: Dict[str, Any]) -> Dict[str, Any]:
    with _LOCK:
        _SEQ[0] += 1
        seq = _SEQ[0]
    stack = _TLS.stack
    return {"ev": ev, "name": name, "ts": round(time.time(), 6),
            "depth": len(stack), "parent": stack[-1] if stack else None,
            "pid": os.getpid(), "seq": seq, "attrs": _scalar(attrs)}


class _NullSpan:
    """The disabled-path span: a shared, attribute-free no-op."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    __slots__ = ("name", "attrs", "_rec", "_p0", "_ann")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self._ann = None

    def __enter__(self):
        self._rec = _base("span", self.name, self.attrs)
        self._p0 = time.perf_counter()
        _TLS.stack.append(self.name)
        # Profiler annotation: inside a torch.profiler trace the span name
        # shows on the timeline; outside one it is a cheap no-op. Ring-only
        # spans (log off) skip it.
        if not enabled():
            self._ann = None
            return self
        try:
            import torch
            self._ann = torch.profiler.record_function(f"dfft:{self.name}")
            self._ann.__enter__()
        except Exception:  # noqa: BLE001 — annotation is best-effort
            self._ann = None
        return self

    def __exit__(self, et, ev, tb):
        if self._ann is not None:
            try:
                self._ann.__exit__(et, ev, tb)
            except Exception:  # noqa: BLE001
                pass
        if _TLS.stack and _TLS.stack[-1] == self.name:
            _TLS.stack.pop()
        self._rec["dur_ms"] = round(
            (time.perf_counter() - self._p0) * 1e3, 4)
        if et is not None:
            self._rec["attrs"]["error"] = f"{et.__name__}"
        _emit(self._rec)
        return False


def _recording() -> bool:
    """Whether anything downstream wants records: the JSONL log (opt-in)
    or the always-on flight-recorder ring."""
    if enabled():
        return True
    from . import flightrec
    return flightrec.enabled()


def span(name: str, **attrs):
    """Nestable tracing span. ``with span("plan.build", kind="slab"): ...``
    records a span record into the flight-recorder ring (always) and the
    JSONL event log (when on). Only with ``$DFFT_FLIGHTREC=off`` AND the
    log off does it degrade to the shared no-op."""
    if not _recording():
        return _NULL
    return _Span(name, attrs)


def event(name: str, **attrs) -> None:
    """One-shot point event (no duration): flight-recorder ring always,
    event log when on."""
    if not _recording():
        return
    _emit(_base("event", name, attrs))


def notice(msg: str, *, name: str = "notice", **attrs) -> None:
    """A human-readable one-liner: printed to stdout under the CLI
    ``--obs`` flag, recorded into the ring always and the event log when
    on. Used for wisdom provenance (``hit | miss | migrated(v1→v3)``) so
    the previously silent resolution is visible."""
    if _CONSOLE:
        print(msg, flush=True)
    if _recording():
        a = dict(attrs)
        a["msg"] = msg
        _emit(_base("event", name, a))


# ---------------------------------------------------------------------------
# schema validation (shared by tests and the CI artifact check)
# ---------------------------------------------------------------------------

_EV_KINDS = ("span", "event")


def validate_event(rec: Any) -> None:
    """Raise ``ValueError`` unless ``rec`` is a schema-conforming event
    (see module docstring)."""
    if not isinstance(rec, dict):
        raise ValueError(f"event must be an object, got {type(rec).__name__}")
    ev = rec.get("ev")
    if ev not in _EV_KINDS:
        raise ValueError(f"ev must be one of {_EV_KINDS}, got {ev!r}")
    name = rec.get("name")
    if not isinstance(name, str) or not name:
        raise ValueError(f"name must be a non-empty string, got {name!r}")
    ts = rec.get("ts")
    if not isinstance(ts, (int, float)) or ts <= 0:
        raise ValueError(f"ts must be a positive number, got {ts!r}")
    for key in ("pid", "seq", "depth"):
        v = rec.get(key)
        if not isinstance(v, int) or v < 0:
            raise ValueError(f"{key} must be a non-negative int, got {v!r}")
    parent = rec.get("parent", "MISSING")
    if parent is not None and not isinstance(parent, str):
        raise ValueError(f"parent must be null or a string, got {parent!r}")
    if not isinstance(rec.get("attrs"), dict):
        raise ValueError("attrs must be an object")
    if ev == "span":
        d = rec.get("dur_ms")
        if not isinstance(d, (int, float)) or d < 0:
            raise ValueError(f"span dur_ms must be >= 0, got {d!r}")
    elif "dur_ms" in rec:
        raise ValueError("point events carry no dur_ms")


def validate_events_file(path: str) -> int:
    """Validate every line of one JSONL event log; returns the event count,
    raises ``ValueError`` (with the offending line number) on the first
    defect."""
    n = 0
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f, 1):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
                validate_event(rec)
            except ValueError as e:
                raise ValueError(f"{path}:{i}: {e}") from None
            n += 1
    return n


def validate_events_dir(path: str,
                        pattern: str = "events-") -> int:
    """Validate every ``events-*.jsonl`` under ``path``; returns the total
    event count (0 when no log files exist)."""
    total = 0
    names: Iterable[str] = sorted(os.listdir(path))
    for fn in names:
        if fn.startswith(pattern) and fn.endswith(".jsonl"):
            total += validate_events_file(os.path.join(path, fn))
    return total
