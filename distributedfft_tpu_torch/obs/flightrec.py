"""Always-on flight recorder: a bounded in-memory ring of recent spans,
events and metric deltas, dumped to JSONL only when something goes wrong
— the port's copy of the JAX package's ``obs/flightrec.py``, same ring,
triggers and dump schema.

The event log (``tracing.py``) is opt-in and file-backed; the metrics
registry (``metrics.py``) is always-on but keeps only aggregates. Neither
answers the incident question "what happened in the last two seconds
BEFORE the guard tripped / the circuit opened / the shed burst started".
This module does: every span close, point event, notice and counter
delta is appended to a process-global ring (``collections.deque`` with a
bounded ``maxlen`` — ZERO file I/O in steady state, a dict build and a
deque append per record), and a **trigger** flushes the ring to one JSONL
dump file for post-mortem reading.

Trigger vocabulary (``TRIGGERS``; each call site names its own):

=====================  ====================================================
trigger                fired by
=====================  ====================================================
``guard_violation``    ``resilience/guards.py`` raising ``GuardViolation``
``circuit_open``       a serve circuit breaker tripping closed -> open
``fallback_demotion``  the fallback ladder walking a rung
``shed_burst``         >= ``DFFT_FLIGHTREC_SHED_BURST`` admissions shed
                       within 2 s (``serve/server.py``)
``worker_death``       the fleet failure detector declaring a worker dead
                       (``serve/fleet.py``: missed heartbeats, broken
                       pipe, or a nonzero exit) — the dump carries the
                       beats/dispatches of the worker's final seconds
``scale_decision``     the fleet's worker-count controller acting on the
                       ``/metrics`` signals (``serve/fleet.py``) — the
                       auditable record of WHY capacity changed
``checkpoint_restore_failure``  the persist layer skipping or refusing
                       a checkpoint generation (``persist/checkpoint.py``
                       ``CheckpointStore.load``: corruption fallback,
                       fingerprint mismatch, or zero loadable
                       generations) — the dump carries the writes and
                       injected faults of the run that left the store in
                       that state
``signal``             SIGUSR2 (``install_signal_handler``; the live-
                       debugging surface: kill -USR2 a stuck server)
``manual``             programmatic ``dump()``
=====================  ====================================================

Dump location: ``$DFFT_FLIGHTREC_DIR``, else ``$DFFT_OBS_DIR``, else the
system temp dir; file name ``flightrec-<pid>-<n>.jsonl``. The first line
is a header record (``{"ev": "flightrec", "trigger": ..., "records": N,
...}``), followed by the ring's records oldest-first — the schema
``validate_dump_file`` checks and the CI chaos job asserts on. Dumps are
rate-limited per trigger kind (``DFFT_FLIGHTREC_COOLDOWN_S``, default 5 s)
so a failure storm produces one dump per window, not thousands.

``$DFFT_FLIGHTREC=off`` disables recording entirely (the escape hatch;
``add`` then returns immediately). Like every obs surface, the recorder
degrades rather than errors: an unwritable dump directory loses the dump,
never the run. Records are host-side only: nothing here touches the
device.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
import threading
import time
from typing import Any, Deque, Dict, List, Optional

ENV_DIR = "DFFT_FLIGHTREC_DIR"
ENV_OFF = "DFFT_FLIGHTREC"
ENV_CAPACITY = "DFFT_FLIGHTREC_CAPACITY"
ENV_COOLDOWN = "DFFT_FLIGHTREC_COOLDOWN_S"

DEFAULT_CAPACITY = 2048

TRIGGERS = ("guard_violation", "circuit_open", "fallback_demotion",
            "shed_burst", "worker_death", "scale_decision",
            "checkpoint_restore_failure", "signal", "manual")

_LOCK = threading.Lock()
_RING: Deque[Dict[str, Any]] = collections.deque(maxlen=DEFAULT_CAPACITY)
_SEQ = [0]
_LAST_DUMP: Optional[Dict[str, Any]] = None
_LAST_TRIGGER_AT: Dict[str, float] = {}
_DROPPED = [0]  # records displaced by the bounded ring (accounting only)


# Parse-once-per-value env reads: every span close, event and counter
# delta lands in add()/record(), so the enablement/capacity lookups are
# process-wide hot path — re-parse only when the raw string actually
# changes (tests monkeypatch these mid-process; a plain import-time cache
# would go stale on them).
_ENV_MEMO: Dict[str, Any] = {}


def _parsed(var: str, parse: Any) -> Any:
    raw = os.environ.get(var, "")
    hit = _ENV_MEMO.get(var)
    if hit is None or hit[0] != raw:
        hit = (raw, parse(raw))
        _ENV_MEMO[var] = hit
    return hit[1]


def enabled() -> bool:
    return _parsed(ENV_OFF, lambda raw: raw.strip().lower() != "off")


def _parse_capacity(raw: str) -> int:
    try:
        return max(16, int(raw)) if raw.strip() else DEFAULT_CAPACITY
    except ValueError:
        return DEFAULT_CAPACITY


def capacity() -> int:
    return _parsed(ENV_CAPACITY, _parse_capacity)


def _parse_cooldown(raw: str) -> float:
    try:
        return float(raw) if raw.strip() else 5.0
    except ValueError:
        return 5.0


def _cooldown_s() -> float:
    return _parsed(ENV_COOLDOWN, _parse_cooldown)


def add(rec: Dict[str, Any]) -> None:
    """Append one already-built record (the tracing layer's span/event
    dicts ride through unchanged). Cheap and total: a full ring drops its
    oldest record; a disabled recorder drops everything."""
    if not enabled():
        return
    with _LOCK:
        if _RING.maxlen != capacity():
            _resize_locked()
        if len(_RING) == _RING.maxlen:
            _DROPPED[0] += 1
        _RING.append(rec)


def _resize_locked() -> None:
    global _RING
    _RING = collections.deque(_RING, maxlen=capacity())


def record(ev: str, name: str, **attrs: Any) -> None:
    """Build + append a minimal record (the metric-delta entry point:
    ``record("metric", "serve.shed", delta=1)``)."""
    if not enabled():
        return
    with _LOCK:
        _SEQ[0] += 1
        seq = _SEQ[0]
    add({"ev": ev, "name": name, "ts": round(time.time(), 6),
         "pid": os.getpid(), "seq": seq, "attrs": attrs})


def snapshot() -> List[Dict[str, Any]]:
    """Point-in-time copy of the ring, oldest-first."""
    with _LOCK:
        return list(_RING)


def stats() -> Dict[str, Any]:
    """Ring occupancy for health surfaces (``serve health()``)."""
    with _LOCK:
        return {"enabled": enabled(), "size": len(_RING),
                "capacity": _RING.maxlen, "dropped": _DROPPED[0]}


def clear() -> None:
    """Empty the ring and forget dump/cooldown state (test hygiene)."""
    global _LAST_DUMP
    with _LOCK:
        _RING.clear()
        _LAST_DUMP = None
        _LAST_TRIGGER_AT.clear()
        _DROPPED[0] = 0


def dump_dir() -> str:
    for var in (ENV_DIR, "DFFT_OBS_DIR"):
        d = os.environ.get(var, "").strip()
        if d:
            return d
    # The tracing layer's programmatic enable() also counts as "the obs
    # directory" even though it bypasses the environment.
    from . import tracing
    d = tracing.obs_dir()
    return d if d else tempfile.gettempdir()


def last_dump() -> Optional[Dict[str, Any]]:
    """``{"trigger", "path", "ts", "records"}`` of the most recent dump
    (None before the first) — reported by serve ``health()``."""
    with _LOCK:
        return dict(_LAST_DUMP) if _LAST_DUMP else None


def trigger(kind: str, reason: str = "", **attrs: Any) -> Optional[str]:
    """Flush the ring to a JSONL dump because ``kind`` happened. Returns
    the dump path, or None when disabled, rate-limited (one dump per
    ``kind`` per cooldown window) or unwritable. Never raises."""
    global _LAST_DUMP
    if not enabled():
        return None
    if kind not in TRIGGERS:
        kind = "manual"
    now = time.monotonic()
    with _LOCK:
        last = _LAST_TRIGGER_AT.get(kind)
        if last is not None and now - last < _cooldown_s():
            return None
        _LAST_TRIGGER_AT[kind] = now
        records = list(_RING)
        _SEQ[0] += 1
        seq = _SEQ[0]
    header = {"ev": "flightrec", "trigger": kind, "reason": str(reason)[:300],
              "ts": round(time.time(), 6), "pid": os.getpid(), "seq": seq,
              "records": len(records),
              "attrs": {str(k): _json_safe(v) for k, v in attrs.items()}}
    path = os.path.join(dump_dir(),
                        f"flightrec-{os.getpid()}-{seq}.jsonl")
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            f.write(json.dumps(header, sort_keys=True) + "\n")
            for rec in records:
                f.write(json.dumps(rec, sort_keys=True, default=str) + "\n")
    except OSError:
        # Observability degrades, never errors — but a FAILED write must
        # not consume the cooldown window: give back the stamp so the
        # next trigger of this kind retries (a transiently unwritable
        # dir would otherwise silently eat every dump for cooldown_s).
        with _LOCK:
            if _LAST_TRIGGER_AT.get(kind) == now:
                if last is None:
                    _LAST_TRIGGER_AT.pop(kind, None)
                else:
                    _LAST_TRIGGER_AT[kind] = last
        return None
    with _LOCK:
        _LAST_DUMP = {"trigger": kind, "path": path, "ts": header["ts"],
                      "records": len(records)}
    # The dump itself is an event worth remembering (and, when the JSONL
    # event log is on, correlating).
    from . import metrics, tracing
    metrics.inc("flightrec.dumps")
    tracing.event("flightrec.dump", trigger=kind, path=path,
                  records=len(records))
    return path


def dump(reason: str = "") -> Optional[str]:
    """Programmatic dump (the ``manual`` trigger)."""
    return trigger("manual", reason)


def _json_safe(v: Any) -> Any:
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    return str(v)


_SIGNAL_INSTALLED = [False]


def install_signal_handler() -> bool:
    """SIGUSR2 -> dump (the live-debugging surface). Main-thread only
    (signal module contract); idempotent; returns whether installed."""
    if _SIGNAL_INSTALLED[0]:
        return True
    try:
        import signal

        def _handler(signum: int, frame: Any) -> None:  # noqa: ARG001
            # Dump OFF the signal context: the handler runs between
            # bytecodes of the interrupted main thread, which may hold
            # the non-reentrant ring/metrics locks trigger() needs — a
            # direct call could deadlock the very process the signal is
            # meant to debug. A daemon thread takes the locks safely.
            threading.Thread(target=trigger,
                             args=("signal", f"signal {signum}"),
                             daemon=True).start()

        signal.signal(signal.SIGUSR2, _handler)
    except (ValueError, OSError, AttributeError):
        return False  # non-main thread / platform without SIGUSR2
    _SIGNAL_INSTALLED[0] = True
    return True


# ---------------------------------------------------------------------------
# dump schema validation (tests + the CI chaos artifact check)
# ---------------------------------------------------------------------------

def validate_dump_file(path: str) -> int:
    """Validate one flight-recorder dump: line 1 must be the header
    (``ev == "flightrec"``, a known trigger, a record count matching the
    body), every following line a well-formed ring record. Returns the
    ring-record count; raises ``ValueError`` on the first defect."""
    with open(path, encoding="utf-8") as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    if not lines:
        raise ValueError(f"{path}: empty dump")
    header = json.loads(lines[0])
    if header.get("ev") != "flightrec":
        raise ValueError(f"{path}:1: first line must be the flightrec "
                         f"header, got ev={header.get('ev')!r}")
    if header.get("trigger") not in TRIGGERS:
        raise ValueError(f"{path}:1: unknown trigger "
                         f"{header.get('trigger')!r}")
    n = 0
    for i, ln in enumerate(lines[1:], 2):
        rec = json.loads(ln)
        for key, typ in (("ev", str), ("name", str), ("ts", (int, float)),
                         ("pid", int), ("attrs", dict)):
            if not isinstance(rec.get(key), typ):
                raise ValueError(f"{path}:{i}: record {key} must be "
                                 f"{typ}, got {rec.get(key)!r}")
        n += 1
    if header.get("records") != n:
        raise ValueError(f"{path}: header claims {header.get('records')} "
                         f"record(s) but the body has {n}")
    return n
