"""Prometheus text exposition of the obs metrics registry — the port's
copy of the JAX package's ``obs/promexp.py``: on the same registry
contents ``render()`` gives its text byte for byte.

Renders the ALWAYS-CUMULATIVE view of ``obs/metrics.py`` in the
Prometheus text exposition format (version 0.0.4): counters as
``dfft_<name>_total`` (monotone across ``obs.reset()``: a scrape never
sees a counter go backwards), gauges as ``dfft_<name>``, and the latency
histograms as Prometheus histograms (cumulative ``_bucket{le="..."}``
series plus ``_sum``/``_count``). ``dfft-torch-serve --http`` serves this
at ``GET /metrics``.

Metric names are sanitized (dots and other non-name characters become
``_``) and prefixed ``dfft_``; the original registry name is kept in the
``# HELP`` line so the mapping stays greppable.

**Label convention**: the flat registry encodes Prometheus labels in the
metric NAME as a ``[key=value,...]`` suffix —
``metrics.inc("fleet.tenant.shed[tenant=acme]")`` renders as
``dfft_fleet_tenant_shed_total{tenant="acme"} 1``. Every labeled series
of a family shares ONE ``# TYPE``/``# HELP`` header (the exposition
format forbids duplicates), and label values are escaped per the
exposition rules.

``validate_exposition`` is a strict-enough format checker for tests and
scrapers: line grammar, TYPE-before-samples, histogram bucket
monotonicity and the ``+Inf``-bucket == ``_count`` invariant. It
validates structure, not semantics.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Optional, Tuple

from . import metrics

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*")
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{([^}]*)\})?"
    r"\s+([^\s]+)(?:\s+(-?\d+))?$")
_LABEL_RE = re.compile(r'^\s*([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"'
                       r"\s*(?:,|$)")


def sanitize(name: str) -> str:
    """Registry name -> Prometheus metric name body (dots and other
    non-name characters become ``_``)."""
    out = re.sub(r"[^a-zA-Z0-9_:]", "_", str(name))
    if not out or not _NAME_RE.match(out):
        out = "_" + out
    return out


_LABELED_NAME_RE = re.compile(r"^(.*?)\[([^\]]*)\]$")


def split_labels(name: str) -> Tuple[str, Dict[str, str]]:
    """Split a registry name carrying the ``[k=v,...]`` label suffix into
    ``(base_name, labels)``; a name without the suffix (or with a
    malformed one) is returned whole with no labels — the registry never
    rejects a metric name, so neither does the renderer."""
    m = _LABELED_NAME_RE.match(str(name))
    if not m:
        return str(name), {}
    labels: Dict[str, str] = {}
    for pair in m.group(2).split(","):
        k, sep, v = pair.partition("=")
        if not sep or not k.strip():
            return str(name), {}
        labels[sanitize(k.strip())] = v.strip()
    return m.group(1), labels


def _label_body(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    esc = {k: v.replace("\\", r"\\").replace('"', r"\"")
           .replace("\n", r"\n") for k, v in sorted(labels.items())}
    return "{" + ",".join(f'{k}="{v}"' for k, v in esc.items()) + "}"


def _fmt(v: Any) -> str:
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render(snapshot: Optional[Dict[str, Any]] = None,
           prefix: str = "dfft") -> str:
    """The full exposition body. ``snapshot`` defaults to the registry's
    CUMULATIVE view (pass one explicitly only in tests — a "plan"-view
    snapshot would break counter monotonicity across scrapes)."""
    snap = snapshot if snapshot is not None \
        else metrics.snapshot(view="cumulative")
    lines: List[str] = []
    # Labeled series ([k=v] name suffixes) of one family share a single
    # HELP/TYPE header (the format forbids duplicates): group per
    # sanitized family in first-appearance order, samples in registry
    # (sorted-name) order within each family.
    for kind, suffix, store in (("counter", "_total",
                                 snap.get("counters", {})),
                                ("gauge", "", snap.get("gauges", {}))):
        order: List[str] = []
        families: Dict[str, List[Tuple[str, Dict[str, str], Any]]] = {}
        for name, value in store.items():
            base, labels = split_labels(name)
            m = f"{prefix}_{sanitize(base)}{suffix}"
            if m not in families:
                families[m] = []
                order.append(m)
            families[m].append((base, labels, value))
        for m in order:
            base = families[m][0][0]
            desc = ("(cumulative, monotone across obs.reset())"
                    if kind == "counter" else "(last value set)")
            lines.append(f"# HELP {m} obs {kind} {base!r} {desc}")
            lines.append(f"# TYPE {m} {kind}")
            for _, labels, value in families[m]:
                lines.append(f"{m}{_label_body(labels)} {_fmt(value)}")
    for name, h in snap.get("histograms", {}).items():
        m = f"{prefix}_{sanitize(name)}"
        lines.append(f"# HELP {m} obs histogram {name!r} "
                     "(milliseconds; cumulative)")
        lines.append(f"# TYPE {m} histogram")
        running = 0
        for bound, count in zip(h["buckets"], h["counts"]):
            running += count
            lines.append(f'{m}_bucket{{le="{_fmt(bound)}"}} {running}')
        running += h["counts"][len(h["buckets"])]
        lines.append(f'{m}_bucket{{le="+Inf"}} {running}')
        lines.append(f"{m}_sum {_fmt(h['sum'])}")
        lines.append(f"{m}_count {h['count']}")
    return "\n".join(lines) + "\n"


def _parse_value(s: str) -> float:
    if s == "+Inf":
        return math.inf
    if s == "-Inf":
        return -math.inf
    if s == "NaN":
        return math.nan
    return float(s)


def _parse_labels(body: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    rest = body
    while rest.strip():
        m = _LABEL_RE.match(rest)
        if not m:
            raise ValueError(f"malformed label set {body!r}")
        out[m.group(1)] = m.group(2)
        rest = rest[m.end():]
    return out


def validate_exposition(text: str) -> int:
    """Validate one exposition body; returns the sample count, raises
    ``ValueError`` (with the line number) on the first defect. Checks:
    line grammar, every sampled family TYPE-declared first, no duplicate
    TYPE lines, and for histograms: cumulative bucket monotonicity, a
    ``+Inf`` bucket, and ``+Inf`` bucket == ``_count``."""
    types: Dict[str, str] = {}
    samples: List[Tuple[str, Dict[str, str], float]] = []
    for i, raw in enumerate(text.splitlines(), 1):
        line = raw.rstrip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) < 3 or parts[1] not in ("HELP", "TYPE"):
                raise ValueError(f"line {i}: malformed comment {line!r}")
            if parts[1] == "TYPE":
                if len(parts) != 4 or parts[3] not in (
                        "counter", "gauge", "histogram", "summary",
                        "untyped"):
                    raise ValueError(f"line {i}: malformed TYPE {line!r}")
                if parts[2] in types:
                    raise ValueError(
                        f"line {i}: duplicate TYPE for {parts[2]}")
                types[parts[2]] = parts[3]
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {i}: malformed sample {line!r}")
        name, labels, value = m.group(1), m.group(2), m.group(3)
        try:
            v = _parse_value(value)
        except ValueError:
            raise ValueError(f"line {i}: malformed value {value!r}") \
                from None
        lbl = _parse_labels(labels) if labels else {}
        family = name
        for suffix in ("_bucket", "_sum", "_count"):
            base = name[: -len(suffix)] if name.endswith(suffix) else None
            if base and types.get(base) == "histogram":
                family = base
                break
        if family not in types:
            raise ValueError(
                f"line {i}: sample {name!r} before its TYPE declaration")
        if types[family] == "counter" and not name.endswith("_total"):
            raise ValueError(
                f"line {i}: counter sample {name!r} must end _total")
        samples.append((name, lbl, v))
    # Histogram invariants.
    for family, kind in types.items():
        if kind != "histogram":
            continue
        buckets = [(s[1].get("le"), s[2]) for s in samples
                   if s[0] == family + "_bucket"]
        if not buckets:
            raise ValueError(f"histogram {family} has no _bucket samples")
        if buckets[-1][0] != "+Inf":
            raise ValueError(
                f"histogram {family} missing the +Inf bucket (or it is "
                "not last)")
        les = [_parse_value(le) for le, _ in buckets]
        if les != sorted(les):
            raise ValueError(f"histogram {family} le bounds not sorted")
        counts = [c for _, c in buckets]
        if counts != sorted(counts):
            raise ValueError(
                f"histogram {family} bucket counts not cumulative")
        count = [s[2] for s in samples if s[0] == family + "_count"]
        if not count:
            raise ValueError(f"histogram {family} missing _count")
        if counts[-1] != count[0]:
            raise ValueError(
                f"histogram {family} +Inf bucket {counts[-1]} != _count "
                f"{count[0]}")
        if not any(s[0] == family + "_sum" for s in samples):
            raise ValueError(f"histogram {family} missing _sum")
    return len(samples)
