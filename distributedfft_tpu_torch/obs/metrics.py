"""Process-global named counters, gauges and latency histograms — the
port's copy of the JAX package's ``obs/metrics.py``, same names and
semantics.

The runtime's measured decisions (wire-budget rejections, guard
violations, ladder demotions, injected faults) count here, the single
accounting surface. It is ALWAYS active — incrementing a counter is a
dict update under a lock, touches no device state and launches nothing —
while the event log (``tracing.py``) stays opt-in.

Counting per executed call: where the JAX package counts at trace time
(once per traced program: ``wire.exchanges_traced``, ``inject.wire_faults``,
``wire.bytes_per_transpose``), the port has no trace and counts at every
executed exchange or injection instead.

TWO VIEWS, ONE STORE (the reset-semantics contract): counters
and histograms accumulate monotonically for the whole process lifetime —
``reset()`` never erases them. What ``reset()`` does is mark a **baseline**
so the default ``snapshot()`` / ``counter_value()`` read the *per-plan*
window (everything since the last ``reset()``), while
``snapshot(view="cumulative")`` / ``counter_total()`` read the raw
process totals. Tests want a clean per-plan window (reset between
plans), while a scrape surface needs monotone counters, so the two views
stay apart. Gauges hold the last value set and are cleared by
``reset()`` (a gauge has no meaningful baseline). Every snapshot carries
its ``"view"`` so a folded JSON artifact says which window it is.

Histograms (``observe``): fixed-boundary latency histograms in
milliseconds (cumulative bucket counts, Prometheus-shaped: ``le`` upper
bounds plus +Inf, a running sum and count). The serving layer feeds
``serve.queue_wait_ms`` / ``serve.exec_ms`` / ``serve.e2e_ms`` so the
scrape surface carries distributions, not just the EMA.

Metric names (the stable vocabulary; see README "Observability"):

========================== ======= ==========================================
name                       kind    meaning
========================== ======= ==========================================
wisdom.hits                counter resolutions served from the wisdom store
wisdom.misses              counter resolutions that had to race (or default)
wisdom.migrations          counter legacy stores migrated on load (per path)
autotune.race_cells        counter candidate cells measured by any racer
wire.budget_rejections     counter bf16 twins rejected by the error budget
wire.exchanges_traced      counter exchanges run (per executed call)
wire.bytes_per_transpose   gauge   wire bytes of the last exchange's
                                   per-shard payload (``wire_nbytes``)
hlo.all_to_all             gauge   last ``async_collective_counts`` census
hlo.all_to_all_start       gauge   (instance counts in the compiled module;
hlo.collective_permute     gauge   ``hlo.async_total`` is the async-start
hlo.collective_permute_start gauge sum — the overlap detector)
hlo.async_total            gauge
hlo.convert                gauge
guard.parseval_violations  counter energy/finiteness guard failures
guard.wire_drift_violations counter wire drift probe over the error budget
fallback.demotions         counter fallback-ladder rungs walked (total)
fallback.<rung>_demotions  counter per-rung (send/opt/comm/wire)
wisdom.demotion_stamps     counter records stamped demoted after failures
wisdom.lock_breaks         counter stale advisory locks broken (age-based)
wisdom.lock_timeouts       counter lock waits expired (write went unlocked)
multihost.connect_retries  counter coordinator connect attempts retried
autotune.cell_timeouts     counter race cells abandoned on wall-clock
selftest.runs              counter --selftest roundtrips executed
selftest.failures          counter --selftest FAIL lines
inject.wire_faults         counter wire faults injected (per executed call)
inject.coordinator_failures counter simulated coordinator connect failures
inject.lock_contentions    counter simulated held-lock reads
inject.cell_hangs          counter simulated hung race cells
inject.server_slow         counter injected serve-path straggler delays
wisdom.demotion_expired    counter demotion stamps aged out (TTL) on read
flightrec.dumps            counter flight-recorder dumps written
serve.requests             counter requests admitted to the queue
serve.requests_served      counter requests answered with a result
serve.batches              counter coalesced batch executions
serve.batch_failures       counter batch executions that raised
serve.coalesced_requests   counter requests served in batches of size > 1
serve.shed                 counter admissions rejected Overloaded
serve.rejected_closed      counter admissions rejected while draining
serve.deadline_expired     counter requests expired before/after execution
serve.circuit.opened       counter circuits tripped open (closed -> open)
serve.circuit.reopened     counter half-open probes that failed
serve.circuit.half_open    counter cooldown expiries admitting a probe
serve.circuit.closed       counter probes that closed a circuit
serve.circuit.rejected     counter requests rejected on an open circuit
serve.plan_cache.hits      counter plan-cache hits (zero recompiles)
serve.plan_cache.misses    counter plan-cache misses (plan built)
serve.plan_cache.evictions counter LRU evictions
serve.plan_cache.size      gauge   live plan-cache occupancy
serve.queue_depth          gauge   admission queue depth after last change
serve.ema_ms               gauge   per-request execution EMA (warm batches)
serve.queue_wait_ms        histo   admission -> execution start, per request
serve.exec_ms              histo   warm batch execution / batch size
serve.e2e_ms               histo   admission -> reply, served requests only
fleet.workers              gauge   live (in-ring) worker count — the
                                   scale controller's own output signal
fleet.pending              gauge   router-held requests not yet dispatched
fleet.outstanding          gauge   admitted requests not yet resolved
fleet.admitted             counter requests admitted by the fleet router
fleet.served               counter requests resolved with a result
fleet.shed                 counter router admissions rejected Overloaded
fleet.resubmitted          counter in-flight requests rerouted after a
                                   worker death (idempotent by trace id)
fleet.worker_deaths        counter workers declared dead (beats/pipe/exit)
fleet.worker_restarts      counter replacement workers joined the ring
fleet.scale_decisions      counter controller decisions acted on (up/down)
inject.worker_crashes      counter injected worker:crash exits (counted
                                   in the WORKER process's registry —
                                   read them from the worker's event
                                   log, not the router's /metrics)
inject.worker_hangs        counter injected worker:hang stalls (worker-
                                   local, like worker_crashes)
========================== ======= ==========================================

**Labels**: a metric name may carry a ``[key=value,...]`` suffix (build
it with :func:`labeled`); the registry treats the whole string as one
series and the Prometheus exposition (``promexp.py``) renders the suffix
as real labels under a single per-family TYPE header. The fleet records
``fleet.tenant.shed[tenant=...]`` / ``fleet.tenant.outstanding[tenant=...]``
per tenant and ``fleet.worker.queue_depth[worker=...]`` /
``fleet.worker.inflight[worker=...]`` per worker this way.
"""

from __future__ import annotations

import re
import threading
from typing import Dict, List, Tuple, Union

Number = Union[int, float]

_LOCK = threading.Lock()
_COUNTERS: Dict[str, Number] = {}
_BASELINE: Dict[str, Number] = {}
_GAUGES: Dict[str, Number] = {}

# Histogram store: name -> [boundaries, bucket counts (+Inf last), sum,
# count]; *_BASE mirrors counts/sum/count at the last reset().
_HISTOS: Dict[str, list] = {}
_HISTO_BASE: Dict[str, list] = {}

# Default latency boundaries (ms): sub-ms warm hits through multi-second
# cold compiles. A Prometheus histogram's +Inf bucket is implicit here
# (the last slot of the counts list).
DEFAULT_BUCKETS_MS: Tuple[float, ...] = (
    0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000)

VIEWS = ("plan", "cumulative")


def labeled(name: str, **labels: object) -> str:
    """Build a labeled series name: ``labeled("fleet.tenant.shed",
    tenant="acme") -> "fleet.tenant.shed[tenant=acme]"``. Keys are
    sorted so the same label set always names the same series. Label
    VALUES are user-controlled (tenant names arrive from ``submit``),
    so the convention's AND the exposition's structural characters —
    ``[ ] { } , =`` plus quotes/backslashes/newlines — are folded to
    ``_``: a hostile name
    may collide with another sanitized name, but it can never invent a
    label dimension or corrupt the exposition."""
    if not labels:
        return name
    body = ",".join(
        f"{k}={_LABEL_UNSAFE.sub('_', str(labels[k]))}"
        for k in sorted(labels))
    return f"{name}[{body}]"


_LABEL_UNSAFE = re.compile(r'[\[\]{},="\\\n]')


def inc(name: str, n: Number = 1) -> None:
    """Add ``n`` to counter ``name`` (creating it at 0). The delta also
    lands in the flight-recorder ring (``obs/flightrec.py``), so a dump
    shows which counters moved in the final seconds."""
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n
    from . import flightrec
    flightrec.record("metric", name, delta=n)


def gauge(name: str, value: Number) -> None:
    """Set gauge ``name`` to ``value`` (last write wins)."""
    with _LOCK:
        _GAUGES[name] = value


def drop_gauge(name: str) -> None:
    """Remove gauge ``name`` from BOTH views (a gauge describes current
    state; when its subject permanently departs — a fleet worker slot
    retired by scale-down — a frozen last value is misinformation on
    the scrape surface, not history worth keeping)."""
    with _LOCK:
        _GAUGES.pop(name, None)


def observe(name: str, value_ms: Number,
            buckets: Tuple[float, ...] = DEFAULT_BUCKETS_MS) -> None:
    """Record one latency observation into histogram ``name``. The first
    ``observe`` of a name fixes its boundaries; later calls ignore the
    ``buckets`` argument (one histogram, one shape)."""
    v = float(value_ms)
    with _LOCK:
        h = _HISTOS.get(name)
        if h is None:
            bounds = tuple(sorted(float(b) for b in buckets))
            h = [bounds, [0] * (len(bounds) + 1), 0.0, 0]
            _HISTOS[name] = h
        bounds, counts = h[0], h[1]
        i = len(bounds)
        for j, b in enumerate(bounds):
            if v <= b:
                i = j
                break
        counts[i] += 1
        h[2] += v
        h[3] += 1


def counter_value(name: str) -> Number:
    """Per-plan view: the counter's growth since the last ``reset()``."""
    with _LOCK:
        return _COUNTERS.get(name, 0) - _BASELINE.get(name, 0)


def counter_total(name: str) -> Number:
    """Cumulative view: the raw process-lifetime total (what the
    Prometheus exposition renders — monotone across ``reset()``)."""
    with _LOCK:
        return _COUNTERS.get(name, 0)


def gauge_value(name: str, default: Number = 0) -> Number:
    with _LOCK:
        return _GAUGES.get(name, default)


def _histo_view(name: str, cumulative: bool) -> Dict[str, object]:
    """Caller holds the lock."""
    bounds, counts, total, n = _HISTOS[name]
    if not cumulative and name in _HISTO_BASE:
        bcounts, bsum, bn = _HISTO_BASE[name]
        counts = [c - b for c, b in zip(counts, bcounts)]
        total, n = total - bsum, n - bn
    else:
        counts = list(counts)
    return {"buckets": list(bounds), "counts": counts,
            "sum": round(float(total), 4), "count": n}


def snapshot(view: str = "plan") -> Dict[str, object]:
    """Point-in-time copy with deterministically ordered keys (stable for
    JSON diffs): ``{"view", "counters", "gauges", "histograms"}``.

    ``view="plan"`` (default) is the since-last-``reset()`` window — what
    ``bench.py`` folds per child and tests assert on. ``"cumulative"`` is
    the monotone process totals — what ``/metrics`` scrapes. Zero-valued
    per-plan counters are omitted (a counter untouched this plan is not
    part of this plan's story); cumulative keeps every key ever touched.
    """
    if view not in VIEWS:
        raise ValueError(f"view must be one of {VIEWS}, got {view!r}")
    cumulative = view == "cumulative"
    with _LOCK:
        if cumulative:
            counters = {k: _COUNTERS[k] for k in sorted(_COUNTERS)}
        else:
            counters = {}
            for k in sorted(_COUNTERS):
                delta = _COUNTERS[k] - _BASELINE.get(k, 0)
                if delta:
                    counters[k] = delta
        histos = {}
        for k in sorted(_HISTOS):
            h = _histo_view(k, cumulative)
            if cumulative or h["count"]:
                histos[k] = h
        return {"view": view,
                "counters": counters,
                "gauges": {k: _GAUGES[k] for k in sorted(_GAUGES)},
                "histograms": histos}


def reset() -> None:
    """Start a new per-plan window: baseline the counters/histograms and
    clear the gauges. The cumulative view (and therefore the Prometheus
    exposition) is UNAFFECTED — counters stay monotone across plans."""
    with _LOCK:
        _BASELINE.clear()
        _BASELINE.update(_COUNTERS)
        for k, h in _HISTOS.items():
            _HISTO_BASE[k] = [list(h[1]), h[2], h[3]]
        _GAUGES.clear()


def hard_reset() -> None:
    """Erase EVERYTHING, both views (process-start state). Test isolation
    between test files only — production code must use ``reset()``, which
    keeps the scrape surface monotone."""
    with _LOCK:
        _COUNTERS.clear()
        _BASELINE.clear()
        _GAUGES.clear()
        _HISTOS.clear()
        _HISTO_BASE.clear()


def histogram_names() -> List[str]:
    with _LOCK:
        return sorted(_HISTOS)
