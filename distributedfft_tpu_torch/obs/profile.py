"""Stage-attributed device profiling of the port: where the device time
of one plan execution goes, by declared plan-graph node — the first part
of the JAX package's ``obs/profile.py``.

1. **Scope emission** — the plan families wrap each declared graph
   node's work in ``torch.profiler.record_function("dfft/<family>/<node-id>")``
   (``stage_scope`` / ``scoped``; the node ids are the JAX package's:
   ``local_fft:1``, ``exchange:1``, ``local_fft:2``, ..., ``guard``), and
   the wire layer tags its encode/decode with ``dfft/wire/encode`` /
   ``dfft/wire/decode`` (``wire_scope``). A scope changes no result and
   launches nothing. It is entered only while a profiler records, so a
   plan run outside a capture pays one flag test per node; with scopes
   off (``disable_scopes()``, ``scopes_off()`` or
   ``$DFFT_NO_STAGE_SCOPES``) none is entered under a profiler either.
2. **Trace reading** — ``capture_stage_profile`` runs one direction of a
   live plan under ``torch.profiler`` (CPU and CUDA activities) and reads
   the chrome trace it exports. A device op (kernel, memcpy, memset) is
   charged to the innermost ``dfft/...`` scope open on the host thread
   that launched it (the launch's CUPTI correlation id): the port's
   kernels launch through ``ctypes``, outside aten, so no aten op is
   their parent, but their runtime launch call is correlated all the
   same (a device op whose launch the trace lost is unattributed). A
   kernel whose launch no aten op encloses is the port's own, and
   ``device_activity`` counts those, so a caller can hold the trace
   against its launch counts. On the CPU the aten ops are charged to the
   innermost scope open around them on their thread. Nested events are
   resolved by SELF time, so nothing is counted twice. The JAX package's
   trace formats still load: ``*.xplane.pb`` through the same minimal
   protobuf walker, and its chrome trace-events JSON.
3. **Device activity** — ``device_activity`` gives the union of the
   device's busy intervals and the profiled window, hence the device's
   idle share of a capture (``capture_window`` profiles any block, a
   served drive for instance).

The graph join (``stage_profile``: per-node rows, the roofline gap of
each stage) needs the plan-graph IR and the roofline model, which are
ROADMAP Queue 1 item 16 and 15; it raises, naming item 12's rest.
"""

from __future__ import annotations

import bisect
import contextlib
import glob
import gzip
import json
import os
import re
import tempfile
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

SCOPE_PREFIX = "dfft"
ENV_NO_SCOPES = "DFFT_NO_STAGE_SCOPES"

# A scope path segment pair: "dfft/<family>/<node-id>" (also
# "dfft/wire/encode"). A nested name embeds scopes as path segments;
# attribution takes the LAST (innermost) match.
SCOPE_RE = re.compile(r"dfft/([A-Za-z0-9_.-]+/[A-Za-z0-9_.:-]+)")

_SCOPES_FORCED_OFF = [False]

# The later items the rest of the JAX module waits for.
LATER = ("ROADMAP Queue 1, item 12's rest (stage_profile and "
         "--profile-stages: the plan-graph join, after items 15 and 16)")

# Plan class -> the JAX package's graph family name of its scopes.
_FAMILIES = {"SlabFFTPlan": "slab", "PencilFFTPlan": "pencil",
             "Batched2DFFTPlan": "batched2d"}


def scopes_enabled() -> bool:
    """Whether the families emit stage scopes (on by default)."""
    if _SCOPES_FORCED_OFF[0]:
        return False
    return os.environ.get(ENV_NO_SCOPES, "").strip().lower() \
        not in ("1", "true", "on", "yes")


def disable_scopes() -> None:
    _SCOPES_FORCED_OFF[0] = True


def enable_scopes() -> None:
    _SCOPES_FORCED_OFF[0] = False


@contextlib.contextmanager
def scopes_off() -> Iterator[None]:
    """Force scopes off for one block, restoring the PRIOR forced state
    on exit (nests inside a caller that already disabled them)."""
    prev = _SCOPES_FORCED_OFF[0]
    _SCOPES_FORCED_OFF[0] = True
    try:
        yield
    finally:
        _SCOPES_FORCED_OFF[0] = prev


def scope_name(family: str, node_id: str) -> str:
    """The canonical scope string of one declared graph node."""
    return f"{SCOPE_PREFIX}/{family}/{node_id}"


def scope_family(plan: Any) -> str:
    """The family a plan's scopes are named under: the JAX package's
    graph family (``slab``, ``pencil``, ``batched2d``), else the class
    name in lower case."""
    name = type(plan).__name__
    return _FAMILIES.get(name, name.lower())


def stage_scope(family: str, node_id: str):
    """``torch.profiler.record_function`` over one declared node's work,
    entered when the block runs. A no-op context when no profiler is
    recording, when scopes are disabled, or when the node id is falsy
    (an undeclared exchange)."""
    if not node_id:
        return contextlib.nullcontext()
    import torch
    if not getattr(torch.autograd.profiler, "_is_profiler_enabled", True) \
            or not scopes_enabled():
        return contextlib.nullcontext()
    return torch.profiler.record_function(scope_name(family, node_id))


def wire_scope(kind: str):
    """The wire layer's encode/decode scope (``dfft/wire/<kind>``) —
    nested inside the enclosing family exchange scope, so attribution
    can split wire time out of the exchange."""
    return stage_scope("wire", kind)


def scoped(family: str, node_id: str, fn):
    """Wrap a pipeline closure so each call runs under the node scope.
    A falsy ``node_id`` (an exchange the graph does not declare) passes
    the closure through unscoped."""
    if fn is None or not node_id:
        return fn

    def wrapped(*args, **kwargs):
        with stage_scope(family, node_id):
            return fn(*args, **kwargs)

    return wrapped


# ---------------------------------------------------------------------------
# xplane parsing (the JAX package's traces: minimal protobuf walker over
# the XSpace schema)
# ---------------------------------------------------------------------------

def _pb_fields(buf: bytes) -> Iterator[Tuple[int, int, Any]]:
    """Yield ``(field_no, wire_type, value)`` over one protobuf message.
    Varint and length-delimited fields decode; fixed32/64 pass as raw
    bytes. Raises ValueError on malformed input (callers treat that as
    'not a message')."""
    i, n = 0, len(buf)
    while i < n:
        tag, shift = 0, 0
        while True:
            if i >= n:
                raise ValueError("truncated tag")
            b = buf[i]
            i += 1
            tag |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        fno, wt = tag >> 3, tag & 7
        if wt == 0:
            v, shift = 0, 0
            while True:
                if i >= n:
                    raise ValueError("truncated varint")
                b = buf[i]
                i += 1
                v |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            yield fno, wt, v
        elif wt == 2:
            ln, shift = 0, 0
            while True:
                if i >= n:
                    raise ValueError("truncated length")
                b = buf[i]
                i += 1
                ln |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            if i + ln > n:
                raise ValueError("truncated bytes field")
            yield fno, wt, buf[i:i + ln]
            i += ln
        elif wt == 5:
            yield fno, wt, buf[i:i + 4]
            i += 4
        elif wt == 1:
            yield fno, wt, buf[i:i + 8]
            i += 8
        else:
            raise ValueError(f"unsupported wire type {wt}")


def _collect_strings(buf: bytes, depth: int = 0, limit: int = 1) -> List[str]:
    """Shallow utf-8-decodable length-delimited fields of a message tree
    — the schema-drift-robust way to find an event metadata's OWN
    op_name strings (XEventMetadata.name/display_name, a tf_op stat
    string, a direct OpMetadata stat). Depth-limited to 1 so a full HLO
    module proto embedded in a module-level event's stats does NOT leak
    its per-instruction op_names onto that wrapper event —
    ``_harvest_hlo_scopes`` mines those separately and joins them by
    instruction name."""
    out: List[str] = []
    if depth > limit:
        return out
    try:
        for _, wt, v in _pb_fields(buf):
            if wt != 2 or not isinstance(v, bytes):
                continue
            try:
                s = v.decode("utf-8")
            except UnicodeDecodeError:
                s = None
            if s is not None and s.isprintable() and s:
                out.append(s)
            if len(v) > 3:
                out.extend(_collect_strings(v, depth + 1, limit))
    except ValueError:
        pass
    return out


def extract_scope(strings: List[str]) -> Optional[str]:
    """Innermost ``dfft/<x>/<y>`` scope across the given strings (last
    match of the LONGEST matching string, so the full nested path wins
    over a short prefix duplicate)."""
    best: Optional[str] = None
    best_len = -1
    for s in strings:
        ms = SCOPE_RE.findall(s)
        if ms and len(s) > best_len:
            best, best_len = ms[-1], len(s)
    return best


_INSTR_NAME_RE = re.compile(r"^[A-Za-z0-9_.\-]+$")


def _harvest_hlo_scopes(buf: bytes, out: Dict[str, str],
                        depth: int = 0) -> None:
    """Instruction-name -> scope map from any serialized HLO module
    embedded in a plane's stats. The CPU/TPU profilers attach the
    compiled module's HloProto to a module-level event; per-op events
    then carry only the instruction NAME (``fft.7``,
    ``transpose_copy_fusion.2``) — the op_name path with the named
    scopes lives on the proto's instructions. Schema-lightly: any
    message with a name-shaped field 1 string and a field 7 submessage
    whose field 2 matches the scope pattern is an HloInstructionProto
    (name=1, metadata=7{op_name=2}). First mapping wins (HLO names are
    unique module-wide; across modules a collision keeps the first)."""
    if depth > 12:
        return
    try:
        fields = list(_pb_fields(buf))
    except ValueError:
        return
    name: Optional[str] = None
    scope: Optional[str] = None
    for fno, wt, v in fields:
        if fno == 1 and wt == 2 and isinstance(v, bytes):
            try:
                s = v.decode("utf-8")
            except UnicodeDecodeError:
                continue
            if _INSTR_NAME_RE.match(s):
                name = s
        elif fno == 7 and wt == 2 and isinstance(v, bytes):
            try:
                for f2, w2, v2 in _pb_fields(v):
                    if f2 == 2 and w2 == 2 and isinstance(v2, bytes):
                        try:
                            s2 = v2.decode("utf-8")
                        except UnicodeDecodeError:
                            continue
                        ms = SCOPE_RE.findall(s2)
                        if ms:
                            scope = ms[-1]
            except ValueError:
                pass
    if name and scope:
        out.setdefault(name, scope)
    for fno, wt, v in fields:
        if wt == 2 and isinstance(v, bytes) and len(v) > 8:
            _harvest_hlo_scopes(v, out, depth + 1)


def parse_xplane(data: bytes) -> List[Dict[str, Any]]:
    """Parse one ``*.xplane.pb`` (XSpace) into
    ``[{"name", "lines": [{"name", "events": [{"name", "scope",
    "offset_ps", "dur_ps"}]}]}]``. Only the fields attribution needs."""
    planes: List[Dict[str, Any]] = []
    # Pass 1 — instruction-name -> scope from every embedded HLO module
    # proto in the WHOLE space: the profiler parks the serialized module
    # on a metadata plane (``/host:metadata``) while the op events live
    # on the execution planes, so the map must be global.
    name_scopes: Dict[str, str] = {}
    for fno, wt, v in _pb_fields(data):
        if fno == 1 and wt == 2:
            _harvest_hlo_scopes(v, name_scopes)
    for fno, wt, v in _pb_fields(data):
        if fno != 1 or wt != 2:
            continue
        name = ""
        raw_lines: List[bytes] = []
        emeta: Dict[int, Dict[str, Any]] = {}
        for f2, w2, v2 in _pb_fields(v):
            if f2 == 2 and w2 == 2:
                name = v2.decode(errors="replace")
            elif f2 == 3 and w2 == 2:
                raw_lines.append(v2)
            elif f2 == 4 and w2 == 2:
                # map<int64, XEventMetadata> entry: key=1, value=2
                key: Optional[int] = None
                mname = ""
                strings: List[str] = []
                for f3, w3, v3 in _pb_fields(v2):
                    if f3 == 1 and w3 == 0:
                        key = v3
                    elif f3 == 2 and w3 == 2:
                        strings = _collect_strings(v3)
                        for f4, w4, v4 in _pb_fields(v3):
                            if f4 == 2 and w4 == 2:
                                mname = v4.decode(errors="replace")
                if key is not None:
                    emeta[key] = {"name": mname,
                                  "scope": extract_scope(strings)}
        lines = []
        for lv in raw_lines:
            lname = ""
            events: List[Dict[str, Any]] = []
            for f2, w2, v2 in _pb_fields(lv):
                if f2 in (2, 11) and w2 == 2:
                    lname = v2.decode(errors="replace")
                elif f2 == 4 and w2 == 2:
                    mid: Optional[int] = None
                    off = 0
                    dur = 0
                    for f3, w3, v3 in _pb_fields(v2):
                        if f3 == 1 and w3 == 0:
                            mid = v3
                        elif f3 == 2 and w3 == 0:
                            off = v3
                        elif f3 == 3 and w3 == 0:
                            dur = v3
                    meta = emeta.get(mid, {})
                    ename = meta.get("name", "")
                    scope = meta.get("scope") or name_scopes.get(ename)
                    events.append({"name": ename, "scope": scope,
                                   "offset_ps": off, "dur_ps": dur})
            lines.append({"name": lname, "events": events})
        planes.append({"name": name, "lines": lines})
    return planes


# ---------------------------------------------------------------------------
# trace-events parsing (chrome JSON: torch.profiler's export, the JAX
# package's trace-events and its committed fixture)
# ---------------------------------------------------------------------------

def parse_trace_events(obj: Any) -> List[Dict[str, Any]]:
    """Chrome trace-events JSON (``{"traceEvents": [...]}`` or a bare
    list) -> the same event dicts ``parse_xplane`` produces, one flat
    line. ``ph == "X"`` complete events only; scope extracted from the
    event name and any string args; timestamps are microseconds in this
    format (converted to ps for uniformity)."""
    evs = obj.get("traceEvents", []) if isinstance(obj, dict) else obj
    out: List[Dict[str, Any]] = []
    for e in evs:
        if not isinstance(e, dict) or e.get("ph") != "X":
            continue
        strings = [str(e.get("name", ""))]
        args = e.get("args")
        if isinstance(args, dict):
            strings += [str(v) for v in args.values()
                        if isinstance(v, str)]
        out.append({"name": str(e.get("name", "")),
                    "scope": extract_scope(strings),
                    "offset_ps": int(float(e.get("ts", 0)) * 1e6),
                    "dur_ps": int(float(e.get("dur", 0)) * 1e6)})
    return out


# torch.profiler's chrome-trace categories: device work, the host-side
# runtime calls that launch it, the record_function ranges, aten ops.
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_TORCH_CATS = frozenset(_DEVICE_CATS + _LAUNCH_CATS + (
    "cpu_op", "user_annotation", "gpu_user_annotation",
    "python_function"))


def is_torch_trace(obj: Any) -> bool:
    """Whether a chrome trace is ``torch.profiler``'s (its events carry
    Kineto's categories)."""
    evs = obj.get("traceEvents", []) if isinstance(obj, dict) else obj
    return any(isinstance(e, dict) and e.get("cat") in _TORCH_CATS
               for e in evs)


def _ps(x: Any) -> int:
    return int(round(float(x) * 1e6))


def _innermost(ranges: List[Tuple[int, int, str]], t0: int,
               t1: int) -> Optional[str]:
    """The scope of the innermost (latest-starting) range that contains
    ``[t0, t1]`` (``ranges`` sorted by start)."""
    best = None
    for s, e, scope in ranges:
        if s > t0:
            break
        if e >= t1:
            best = scope
    return best


def _merged(ranges: List[Tuple[int, int]]) -> Tuple[List[int], List[int]]:
    """The union of ``ranges`` as disjoint (starts, ends), sorted; ranges
    that only touch stay apart."""
    starts: List[int] = []
    ends: List[int] = []
    for s, e in sorted(ranges):
        if ends and s < ends[-1]:
            ends[-1] = max(ends[-1], e)
        else:
            starts.append(s)
            ends.append(e)
    return starts, ends


def _inside(merged: Tuple[List[int], List[int]], t0: int, t1: int) -> bool:
    """Whether ``[t0, t1]`` lies within one interval of ``_merged``."""
    starts, ends = merged
    i = bisect.bisect_right(starts, t0) - 1
    return i >= 0 and ends[i] >= t1


def parse_torch_trace(obj: Any) -> List[Dict[str, Any]]:
    """``torch.profiler``'s chrome trace -> planes: one
    ``/device:GPU:<n>`` plane per device (a line per stream) holding its
    kernels, memcpys and memsets, and a ``/host:CPU`` plane (a line per
    thread) holding the aten ops. A device op takes the innermost
    ``dfft/...`` range open on the host thread that launched it (joined
    by the launch's correlation id; None where the trace lost the
    launch), and ``outside_aten``: whether no aten op enclosed that
    launch (the port's ``ctypes`` launches); a host op takes the
    innermost range open around it on its thread."""
    evs = [e for e in (obj.get("traceEvents", []) if isinstance(obj, dict)
                       else obj)
           if isinstance(e, dict) and e.get("ph") == "X"]
    host_ranges: Dict[Any, List[Tuple[int, int, str]]] = {}
    op_spans: Dict[Any, List[Tuple[int, int]]] = {}
    for e in evs:
        cat = e.get("cat")
        s = _ps(e.get("ts", 0))
        key = (e.get("pid"), e.get("tid"))
        if cat == "cpu_op":
            op_spans.setdefault(key, []).append((s, s + _ps(e.get("dur", 0))))
            continue
        if cat != "user_annotation":
            continue
        m = SCOPE_RE.findall(str(e.get("name", "")))
        if m:
            host_ranges.setdefault(key, []).append(
                (s, s + _ps(e.get("dur", 0)), m[-1]))
    for v in host_ranges.values():
        v.sort()
    aten = {k: _merged(v) for k, v in op_spans.items()}
    launch: Dict[Any, Tuple[Optional[str], bool]] = {}
    for e in evs:
        if e.get("cat") not in _LAUNCH_CATS:
            continue
        corr = (e.get("args") or {}).get("correlation")
        if corr is None:
            continue
        s = _ps(e.get("ts", 0))
        t = s + _ps(e.get("dur", 0))
        key = (e.get("pid"), e.get("tid"))
        launch[corr] = (_innermost(host_ranges.get(key, []), s, t),
                        not _inside(aten.get(key, ([], [])), s, t))
    device: Dict[Any, Dict[Any, List[Dict[str, Any]]]] = {}
    host: Dict[Any, List[Dict[str, Any]]] = {}
    for e in evs:
        cat = e.get("cat")
        s, d = _ps(e.get("ts", 0)), _ps(e.get("dur", 0))
        name = str(e.get("name", ""))
        if cat in _DEVICE_CATS:
            args = e.get("args") or {}
            scope, outside = launch.get(args.get("correlation"),
                                        (None, False))
            dev = args.get("device", e.get("pid"))
            device.setdefault(dev, {}).setdefault(
                args.get("stream", e.get("tid")), []).append(
                {"name": name, "scope": scope, "offset_ps": s,
                 "dur_ps": d, "kind": cat, "outside_aten": outside})
        elif cat == "cpu_op":
            key = (e.get("pid"), e.get("tid"))
            host.setdefault(key, []).append(
                {"name": name,
                 "scope": _innermost(host_ranges.get(key, []), s, s + d),
                 "offset_ps": s, "dur_ps": d})

    def ordered(d):
        return sorted(d.items(), key=lambda kv: str(kv[0]))

    planes = [{"name": f"/device:GPU:{dev}",
               "lines": [{"name": f"stream {stream}", "events": v}
                         for stream, v in ordered(lines)]}
              for dev, lines in ordered(device)]
    if host:
        planes.append({"name": "/host:CPU",
                       "lines": [{"name": f"ops {k[0]}/{k[1]}", "events": v}
                                 for k, v in ordered(host)]})
    return planes


def load_trace(path: str) -> List[Dict[str, Any]]:
    """One trace artifact -> planes. ``.pb`` parses as xplane;
    ``.json``/``.json.gz`` as ``torch.profiler``'s chrome trace
    (``parse_torch_trace``) or, without Kineto's categories, as plain
    trace-events (wrapped in one synthetic plane so the aggregation sees
    a uniform shape)."""
    if path.endswith(".pb"):
        with open(path, "rb") as f:
            return parse_xplane(f.read())
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8") as f:  # type: ignore[operator]
        obj = json.load(f)
    if is_torch_trace(obj):
        return parse_torch_trace(obj)
    return [{"name": "trace-events",
             "lines": [{"name": "events",
                        "events": parse_trace_events(obj)}]}]


def find_trace_files(logdir: str) -> List[str]:
    """The newest profiler run directory's parseable artifacts, xplane
    preferred; ``torch.profiler``'s exports (``<name>.pt.trace.json``,
    optionally gzipped) sit in the directory itself and match the chrome
    trace pattern."""
    runs = sorted(glob.glob(os.path.join(logdir, "plugins", "profile", "*")))
    if not runs:
        runs = [logdir]
    run = runs[-1]
    pbs = sorted(glob.glob(os.path.join(run, "*.xplane.pb")))
    if pbs:
        return pbs
    return sorted(glob.glob(os.path.join(run, "*trace.json.gz")) +
                  glob.glob(os.path.join(run, "*trace.json")))


# ---------------------------------------------------------------------------
# aggregation (self-time, per scope)
# ---------------------------------------------------------------------------

# Lines that carry host python bookkeeping, not op executions.
_SKIP_LINES = re.compile(r"^(python|launcher|\$)", re.IGNORECASE)


def _self_times(events: List[Dict[str, Any]]) -> List[Tuple[
        Optional[str], float]]:
    """``(scope, self_time_ps)`` per event of ONE line: an event interval
    that contains other events is charged only for the time its children
    do not cover (flame-graph self time), so a ``call`` op wrapping a
    fusion is not counted twice."""
    evs = [e for e in events if e.get("dur_ps", 0) > 0]
    evs.sort(key=lambda e: (e["offset_ps"], -e["dur_ps"]))
    out: List[Tuple[Optional[str], float]] = []
    stack: List[Dict[str, Any]] = []  # open ancestors, innermost last
    child_time: List[float] = []
    for e in evs:
        end = e["offset_ps"] + e["dur_ps"]
        while stack and e["offset_ps"] >= \
                stack[-1]["offset_ps"] + stack[-1]["dur_ps"]:
            parent = stack.pop()
            covered = child_time.pop()
            out.append((parent.get("scope"),
                        max(0.0, parent["dur_ps"] - covered)))
        if stack and end <= stack[-1]["offset_ps"] + stack[-1]["dur_ps"]:
            child_time[-1] += e["dur_ps"]
        stack.append(e)
        child_time.append(0.0)
    while stack:
        parent = stack.pop()
        covered = child_time.pop()
        out.append((parent.get("scope"),
                    max(0.0, parent["dur_ps"] - covered)))
    return out


def aggregate_trace(planes: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Aggregate device time by scope over the op-execution lines.
    Device planes (``/device:...``) win when present (TPU); host planes
    otherwise (the CPU backend runs its ops on host thread-pool lines).
    Returns ``{"scopes": {scope: ms}, "unattributed_ms", "total_ms",
    "planes": [names]}`` — python bookkeeping lines are skipped, nested
    ops resolved by self time."""
    device = [p for p in planes if p["name"].startswith("/device:")
              and any(ln["events"] for ln in p["lines"])]
    chosen = device or [p for p in planes
                        if any(ln["events"] for ln in p["lines"])]
    scopes: Dict[str, float] = {}
    unattributed = 0.0
    for plane in chosen:
        for line in plane["lines"]:
            if _SKIP_LINES.match(line["name"] or ""):
                continue
            for scope, ps in _self_times(line["events"]):
                if scope:
                    scopes[scope] = scopes.get(scope, 0.0) + ps
                else:
                    unattributed += ps
    to_ms = 1e-9  # ps -> ms
    return {
        "scopes": {k: round(v * to_ms, 6) for k, v in sorted(scopes.items())},
        "unattributed_ms": round(unattributed * to_ms, 6),
        "total_ms": round((sum(scopes.values()) + unattributed) * to_ms, 6),
        "planes": [p["name"] for p in chosen],
    }


def _union_ps(spans: List[Tuple[int, int]]) -> int:
    busy, end = 0, None
    for s, t in sorted(spans):
        if end is None or s >= end:
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    return busy


def device_activity(planes: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The device planes' busy time (the union of their op intervals, so
    two streams' overlap counts once; copies between host and device
    count as busy) over the window from the first to the last event of
    every plane, the idle share of that window, and the same for the
    kernels alone: ``{"busy_ms", "window_ms", "idle_share",
    "kernel_busy_ms", "kernel_idle_share", "kernel_events",
    "port_kernel_events"}``; the shares are None where the trace holds no
    device plane (a CPU run). ``port_kernel_events`` counts the kernels
    launched outside aten (the port's own, through ``ctypes``): a caller
    that knows its launches checks that the trace kept them all (the
    tracer can lose records), which the count of every kernel, aten's
    included, could not show."""
    spans, kernels, port = [], [], 0
    lo, hi = None, None
    for p in planes:
        for ln in p["lines"]:
            for e in ln["events"]:
                s, t = e["offset_ps"], e["offset_ps"] + e["dur_ps"]
                lo = s if lo is None else min(lo, s)
                hi = t if hi is None else max(hi, t)
                if p["name"].startswith("/device:") and e["dur_ps"] > 0:
                    spans.append((s, t))
                    if e.get("kind", "kernel") == "kernel":
                        kernels.append((s, t))
                        port += bool(e.get("outside_aten"))
    busy, kbusy = _union_ps(spans), _union_ps(kernels)
    window = (hi - lo) if lo is not None else 0
    has_device = any(p["name"].startswith("/device:") for p in planes)

    def share(b):
        return round(1 - b / window, 6) if has_device and window else None

    return {"busy_ms": round(busy * 1e-9, 6),
            "window_ms": round(window * 1e-9, 6),
            "idle_share": share(busy),
            "kernel_busy_ms": round(kbusy * 1e-9, 6),
            "kernel_idle_share": share(kbusy),
            "kernel_events": len(kernels), "port_kernel_events": port}


# ---------------------------------------------------------------------------
# capture (executes the plan — the ONE obs surface that runs the FFT)
# ---------------------------------------------------------------------------

def _activities(device: Any) -> list:
    import torch
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return acts


def _all_threads() -> Optional[Any]:
    """The profiler setting that records ``record_function`` ranges and
    aten ops of every thread (a server's worker, a resident), where this
    torch has it; without it only the profiling thread's are recorded."""
    try:
        from torch._C._profiler import _ExperimentalConfig
        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


def _sync(device: Any) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class _Window:
    """What ``capture_window`` yields: ``planes`` and ``result`` (the
    aggregation plus ``device_activity``) are filled as the block ends."""

    planes: List[Dict[str, Any]]
    result: Dict[str, Any]


@contextlib.contextmanager
def capture_window(device: Any = "cuda", trace_dir: Optional[str] = None
                   ) -> Iterator[_Window]:
    """Profile the block under ``torch.profiler`` (CPU activity, and CUDA
    on a CUDA ``device``; every thread's ranges where this torch can),
    synchronizing the device on entry and exit;
    the yielded object's ``result`` then holds ``aggregate_trace`` of the
    window plus its ``device_activity`` (busy ms, window ms, idle share).
    The chrome trace is written to ``trace_dir`` (a temporary directory
    by default, removed afterwards).

    The tracer is warmed up first: the profiler opens in a warm-up step
    that runs one small device op, and the block is the step after it:
    recorded from the profiler's first step, an H100 lost kernel records
    of 1024^3 directions, as ``chip_smoke.py``'s ``device_profile`` had
    found."""
    import torch
    from torch.profiler import profile, schedule

    win = _Window()
    with contextlib.ExitStack() as stack:
        td = trace_dir or stack.enter_context(tempfile.TemporaryDirectory())
        os.makedirs(td, exist_ok=True)
        path = os.path.join(td, f"dfft-{os.getpid()}-"
                                f"{len(os.listdir(td))}.pt.trace.json")
        _sync(device)
        cfg = _all_threads()
        extra = {} if cfg is None else {"experimental_config": cfg}
        with profile(activities=_activities(device),
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(path),
                     **extra) as prof:
            torch.ones(1, device=device).add_(1)
            _sync(device)
            prof.step()
            time.sleep(0.002)
            yield win
            _sync(device)
        win.planes = load_trace(path)
    win.result = dict(aggregate_trace(win.planes),
                      **device_activity(win.planes))


def _direction_runner(plan: Any, direction: str, dims: int):
    """``(run, input shape, complex input)`` of one direction of a plan:
    its exec entry point for that direction (pencil: at depth ``dims``)
    and this rank's padded block shape it takes."""
    fwd = direction == "forward"
    if direction not in ("forward", "inverse"):
        raise ValueError(f"direction must be forward|inverse, got "
                         f"{direction!r}")
    c2c = getattr(plan, "transform", "r2c") == "c2c"
    if hasattr(plan, "exec_forward"):            # the batched-2D plan
        run = plan.exec_forward if fwd else plan.exec_inverse
        shape = plan.local_input_shape if fwd else plan.local_output_shape
        return run, shape, c2c or not fwd
    pencil = hasattr(plan, "local_output_shape_for")
    if c2c:
        run = plan.exec_c2c if fwd else plan.exec_c2c_inv
    else:
        run = plan.exec_r2c if fwd else plan.exec_c2r
    if pencil:
        shape = (plan.local_input_shape if fwd
                 else plan.local_output_shape_for(dims))
        return (lambda v: run(v, dims)), shape, c2c or not fwd
    shape = plan.local_input_shape if fwd else plan.local_output_shape
    return run, shape, c2c or not fwd


def capture_stage_profile(plan: Any, direction: str = "forward",
                          dims: int = 3, iters: int = 3,
                          warmup: int = 1) -> Dict[str, Any]:
    """Run one direction of a live plan under ``torch.profiler`` and
    aggregate its device time (host op time on the CPU) by stage scope.
    The input is this rank's padded block, drawn on the plan's device
    from a seeded generator BEFORE the profiled window, so no transfer
    pollutes the attribution (drawn on the host, a 1024^3 input also cost
    kernel records on an H100). Times are per iteration; ``idle_share``
    is the device's over the window, ``kernel_idle_share`` the same
    without copies (None on the CPU).
    Collective on a plan over P ranks: every rank calls it."""
    import torch

    from . import tracing

    run, shape, complex_in = _direction_runner(plan, direction, dims)
    dev = plan.device
    gen = torch.Generator(device=dev).manual_seed(0)
    xd = torch.randn(tuple(shape), generator=gen, device=dev,
                     dtype=plan.real_dtype)
    if complex_in:
        xd = torch.complex(xd, torch.randn(tuple(shape), generator=gen,
                                           device=dev, dtype=plan.real_dtype))
    with torch.no_grad():
        for _ in range(max(0, warmup)):
            run(xd)
        iters = max(1, iters)
        with tracing.span("profile.capture", direction=direction,
                          iters=iters):
            with capture_window(dev) as win:
                for _ in range(iters):
                    run(xd)
    agg = win.result
    out = {
        "scopes": {k: round(v / iters, 6)
                   for k, v in agg["scopes"].items()},
        "unattributed_ms": round(agg["unattributed_ms"] / iters, 6),
        "total_ms": round(agg["total_ms"] / iters, 6),
        "planes": agg["planes"],
        "busy_ms": round(agg["busy_ms"] / iters, 6),
        "kernel_busy_ms": round(agg["kernel_busy_ms"] / iters, 6),
        "window_ms": round(agg["window_ms"] / iters, 6),
        "idle_share": agg["idle_share"],
        "kernel_idle_share": agg["kernel_idle_share"],
        "kernel_events": agg["kernel_events"],
        "port_kernel_events": agg["port_kernel_events"],
    }
    out["iters"] = iters
    out["direction"] = direction
    return out


@contextlib.contextmanager
def maybe_profile(profile_dir: Optional[str], device: Any = "cuda"):
    """``--profile-dir``: a ``torch.profiler`` trace of the block written
    to ``profile_dir`` (a chrome trace ``find_trace_files`` /
    ``load_trace`` read back), or a no-op without a directory."""
    if not profile_dir:
        yield None
        return
    with capture_window(device, trace_dir=profile_dir) as win:
        yield win


def stage_profile(*args: Any, **kwargs: Any) -> Dict[str, Any]:
    """The joined per-node report of the JAX package (device time per
    declared node, the exchange/compute split, each stage's roofline
    gap): it needs the plan-graph IR and the roofline model."""
    raise NotImplementedError(f"stage_profile is not ported yet ({LATER})")
