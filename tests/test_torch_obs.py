"""The port's observability host core (``distributedfft_tpu_torch/obs/``)
against the JAX package's ``obs``: spans and the JSONL event log, the
metrics registry, the flight recorder; and the deadline and circuit units
of ``resilience/`` (``tests/test_serve.py:63-125``).

Every event log and dump the port writes here is accepted by the port's
validators AND by the JAX package's (``tracing.validate_events_file``,
``flightrec.validate_dump_file``); both validators reject the same
malformed records; the same sequence of metric updates leaves the same
snapshot in both registries.
"""

import json
import os
import time

import pytest

from distributedfft_tpu_torch import obs
from distributedfft_tpu_torch.obs import flightrec, metrics
from distributedfft_tpu_torch.resilience import circuit as rc
from distributedfft_tpu_torch.resilience import deadline as dl


@pytest.fixture(autouse=True)
def _obs_hygiene(monkeypatch, tmp_path):
    """Clean registry, ring and enablement; a writable dump dir."""
    for var in (obs.ENV_VAR, flightrec.ENV_OFF, flightrec.ENV_CAPACITY,
                flightrec.ENV_COOLDOWN):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv(flightrec.ENV_DIR, str(tmp_path / "dumps"))
    metrics.hard_reset()
    flightrec.clear()
    obs.reset_enablement()
    obs.disable_console()
    yield
    metrics.hard_reset()
    flightrec.clear()
    obs.reset_enablement()
    obs.disable_console()


def _both_validate_events(path):
    from distributedfft_tpu.obs import tracing as jtracing
    n = obs.validate_events_file(path)
    assert jtracing.validate_events_file(path) == n
    return n


def _both_validate_dump(path):
    from distributedfft_tpu.obs import flightrec as jflightrec
    n = flightrec.validate_dump_file(path)
    assert jflightrec.validate_dump_file(path) == n
    return n


# ---------------------------------------------------------------------------
# spans and the event log
# ---------------------------------------------------------------------------


def test_span_nesting_and_jsonl_schema_roundtrip(tmp_path):
    d = str(tmp_path / "obs")
    obs.enable(d)
    with obs.span("outer", kind="test"):
        with obs.span("inner.a", i=1):
            pass
        with obs.span("inner.b"):
            obs.event("point", detail="x")
    obs.notice("a one-liner", name="wisdom.provenance", slot="comm")
    path = obs.event_log_path()
    assert path is not None and path.startswith(d)
    assert _both_validate_events(path) == 5
    assert obs.validate_events_dir(d) == 5
    recs = [json.loads(ln) for ln in open(path)]
    by_name = {r["name"]: r for r in recs}
    assert by_name["outer"]["depth"] == 0
    assert by_name["outer"]["parent"] is None
    for child in ("inner.a", "inner.b"):
        assert by_name[child]["parent"] == "outer"
        assert by_name[child]["depth"] == 1
    spans = [r for r in recs if r["ev"] == "span"]
    assert spans[-1]["name"] == "outer"
    assert by_name["outer"]["dur_ms"] >= by_name["inner.a"]["dur_ms"]
    assert "dur_ms" not in by_name["point"]
    assert by_name["point"]["attrs"] == {"detail": "x"}
    assert by_name["point"]["parent"] == "inner.b"
    assert by_name["wisdom.provenance"]["attrs"]["msg"] == "a one-liner"
    seqs = sorted(r["seq"] for r in recs)
    assert seqs == list(range(seqs[0], seqs[0] + len(recs)))
    assert by_name["outer"]["seq"] == min(seqs)


def test_span_error_is_recorded_and_reraised(tmp_path):
    obs.enable(str(tmp_path))
    with pytest.raises(KeyError):
        with obs.span("fails"):
            raise KeyError("x")
    rec = json.loads(open(obs.event_log_path()).read().splitlines()[-1])
    assert rec["attrs"]["error"] == "KeyError"
    _both_validate_events(obs.event_log_path())


def test_span_enters_the_profiler_annotation(tmp_path):
    """With the log on, a span's name appears in a torch.profiler trace
    as ``dfft:<name>``; with the log off it does not."""
    import torch
    obs.enable(str(tmp_path))
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with obs.span("plan.build"):
            torch.ones(4).sum()
    assert "dfft:plan.build" in {e.key for e in prof.key_averages()}
    obs.disable()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with obs.span("plan.quiet"):
            torch.ones(4).sum()
    assert "dfft:plan.quiet" not in {e.key for e in prof.key_averages()}


def test_span_disabled_feeds_ring_only(tmp_path, monkeypatch):
    obs.disable()
    with obs.span("ring.only", k=1):
        pass
    obs.event("ring.event")
    obs.notice("ring notice")
    assert obs.event_log_path() is None
    names = [r["name"] for r in flightrec.snapshot()]
    assert "ring.only" in names and "ring.event" in names
    monkeypatch.setenv(obs.ENV_VAR, str(tmp_path))
    assert not obs.enabled()          # disable() beats the environment
    monkeypatch.setenv("DFFT_FLIGHTREC", "off")
    s1, s2 = obs.span("a"), obs.span("b", k=1)
    assert s1 is s2
    with s1:
        pass
    flightrec.clear()
    obs.event("fully.dropped")
    assert flightrec.snapshot() == []


def test_env_enables_the_log_and_console_notices(tmp_path, monkeypatch,
                                                 capsys):
    monkeypatch.setenv(obs.ENV_VAR, str(tmp_path))
    assert obs.enabled() and obs.obs_dir() == str(tmp_path)
    obs.enable_console()
    obs.notice("printed", name="n")
    assert "printed" in capsys.readouterr().out
    assert _both_validate_events(obs.event_log_path()) == 1


_OK = {"ev": "span", "name": "x", "ts": 1.0, "pid": 1, "seq": 0,
       "depth": 0, "parent": None, "attrs": {}, "dur_ms": 0.1}
_BAD = {
    "not-a-dict": "not a dict",
    "bad-ev": {**_OK, "ev": "bogus"},
    "empty-name": {**_OK, "name": ""},
    "negative-ts": {**_OK, "ts": -1},
    "negative-depth": {**_OK, "depth": -2},
    "int-parent": {**_OK, "parent": 7},
    "list-attrs": {**_OK, "attrs": []},
    "span-without-dur": {k: v for k, v in _OK.items() if k != "dur_ms"},
    "event-with-dur": {**_OK, "ev": "event"},
}


@pytest.mark.parametrize("case", list(_BAD))
def test_validate_event_rejects_as_jax(case):
    from distributedfft_tpu.obs import tracing as jtracing
    obs.validate_event(_OK)
    jtracing.validate_event(_OK)
    with pytest.raises(ValueError):
        obs.validate_event(_BAD[case])
    with pytest.raises(ValueError):
        jtracing.validate_event(_BAD[case])


def test_unwritable_log_dir_degrades(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("occupied")
    obs.enable(str(blocker))
    with obs.span("lost"):
        pass
    obs.event("lost.too")             # never raises


# ---------------------------------------------------------------------------
# the metrics registry (the same updates, the same snapshots as JAX's)
# ---------------------------------------------------------------------------


def _drive(m):
    m.inc("wire.exchanges_traced")
    m.inc("wire.exchanges_traced", 2)
    m.gauge("wire.bytes_per_transpose", 4096)
    for v in (0.3, 2.0, 700.0, 9000.0):
        m.observe("serve.e2e_ms", v)
    m.inc(m.labeled("fleet.tenant.shed", tenant="a[b]=c"))
    first = m.snapshot()
    m.reset()
    m.inc("guard.parseval_violations")
    m.observe("serve.e2e_ms", 1.0)
    m.gauge("fleet.workers", 3)
    m.drop_gauge("fleet.workers")
    return [first, m.snapshot(), m.snapshot("cumulative"),
            m.counter_value("wire.exchanges_traced"),
            m.counter_total("wire.exchanges_traced"),
            m.gauge_value("serve.queue_depth", -1), m.histogram_names()]


def test_metrics_match_jax_registry():
    from distributedfft_tpu.obs import metrics as jmetrics
    jmetrics.hard_reset()
    try:
        want = _drive(jmetrics)
    finally:
        jmetrics.hard_reset()
    assert _drive(metrics) == want


def test_metrics_views_and_validation():
    with pytest.raises(ValueError):
        metrics.snapshot("bogus")
    metrics.inc("serve.requests", 5)
    obs.reset()
    assert metrics.counter_value("serve.requests") == 0
    assert metrics.counter_total("serve.requests") == 5
    assert obs.snapshot()["counters"] == {}
    assert obs.snapshot()["view"] == "plan"


def test_metric_deltas_land_in_the_ring():
    metrics.inc("guard.parseval_violations")
    recs = flightrec.snapshot()
    assert recs[-1]["ev"] == "metric"
    assert recs[-1]["name"] == "guard.parseval_violations"
    assert recs[-1]["attrs"] == {"delta": 1}


# ---------------------------------------------------------------------------
# the flight recorder
# ---------------------------------------------------------------------------


def test_ring_receives_spans_events_and_metric_deltas():
    with obs.span("build.something", kind="t"):
        obs.event("decision.made", choice=1)
    metrics.inc("wisdom.hits")
    kinds = {(r["ev"], r["name"]) for r in flightrec.snapshot()}
    assert ("span", "build.something") in kinds
    assert ("event", "decision.made") in kinds
    assert ("metric", "wisdom.hits") in kinds
    st = flightrec.stats()
    assert st["enabled"] and st["size"] == len(flightrec.snapshot())


def test_ring_bounded_and_displacement_accounted(monkeypatch):
    monkeypatch.setenv(flightrec.ENV_CAPACITY, "16")
    for i in range(40):
        flightrec.record("event", f"e{i}")
    snap = flightrec.snapshot()
    assert len(snap) == 16
    assert snap[0]["name"] == "e24" and snap[-1]["name"] == "e39"
    assert flightrec.stats()["dropped"] == 24


def test_off_switch_drops_everything(monkeypatch):
    monkeypatch.setenv(flightrec.ENV_OFF, "off")
    flightrec.record("event", "dropped")
    with obs.span("also.dropped"):
        pass
    assert flightrec.snapshot() == []
    assert flightrec.trigger("manual", "nothing to dump") is None


def test_trigger_dumps_ring_oldest_first(tmp_path):
    for i in range(5):
        flightrec.record("event", f"e{i}", i=i)
    path = flightrec.trigger("manual", "unit test", extra="x")
    assert path and os.path.dirname(path) == str(tmp_path / "dumps")
    lines = [json.loads(ln) for ln in
             open(path, encoding="utf-8").read().splitlines()]
    header, body = lines[0], lines[1:]
    assert header["ev"] == "flightrec" and header["trigger"] == "manual"
    assert header["reason"] == "unit test"
    assert header["attrs"] == {"extra": "x"}
    assert header["records"] == 5
    assert [r["name"] for r in body] == [f"e{i}" for i in range(5)]
    assert _both_validate_dump(path) == 5
    last = flightrec.last_dump()
    assert last["path"] == path and last["trigger"] == "manual"
    assert metrics.counter_value("flightrec.dumps") == 1


@pytest.mark.parametrize("kind", flightrec.TRIGGERS)
def test_every_trigger_writes_a_dump_both_validators_accept(kind):
    flightrec.record("event", "evidence", k=kind)
    path = flightrec.trigger(kind, f"{kind} happened", n=1)
    assert json.loads(open(path).readline())["trigger"] == kind
    assert _both_validate_dump(path) == 1


def test_trigger_cooldown_rate_limits_per_kind(monkeypatch):
    monkeypatch.setenv(flightrec.ENV_COOLDOWN, "3600")
    assert flightrec.trigger("guard_violation", "first") is not None
    assert flightrec.trigger("guard_violation", "storm") is None
    assert flightrec.trigger("fallback_demotion", "other kind") is not None


def test_unknown_trigger_coerces_to_manual():
    path = flightrec.trigger("not-a-trigger", "coerced")
    assert json.loads(open(path).readline())["trigger"] == "manual"


def test_unwritable_dump_dir_degrades(monkeypatch, tmp_path):
    blocker = tmp_path / "not-a-dir"
    blocker.write_text("occupied")
    monkeypatch.setenv(flightrec.ENV_DIR, str(blocker))
    flightrec.record("event", "e")
    assert flightrec.trigger("manual", "lost") is None
    assert flightrec.last_dump() is None


def _write(tmp_path, lines):
    p = tmp_path / "dump.jsonl"
    p.write_text("\n".join(json.dumps(ln) for ln in lines) + "\n")
    return str(p)


_REC = {"ev": "event", "name": "e", "ts": 1.0, "pid": 1, "seq": 1,
        "attrs": {}}
_HDR = {"ev": "flightrec", "trigger": "manual", "reason": "", "ts": 1.0,
        "pid": 1, "seq": 2, "records": 1, "attrs": {}}
_BAD_DUMPS = {
    "first line": [_REC, _REC],
    "unknown trigger": [dict(_HDR, trigger="frobnicate"), _REC],
    "claims": [dict(_HDR, records=7), _REC],
    "record ts": [_HDR, dict(_REC, ts="late")],
    "empty": [],
}


@pytest.mark.parametrize("match", list(_BAD_DUMPS))
def test_validate_dump_rejects_as_jax(tmp_path, match):
    from distributedfft_tpu.obs import flightrec as jflightrec
    assert _both_validate_dump(_write(tmp_path, [_HDR, _REC])) == 1
    path = _write(tmp_path, _BAD_DUMPS[match])
    with pytest.raises(ValueError, match=match):
        flightrec.validate_dump_file(path)
    with pytest.raises(ValueError, match=match):
        jflightrec.validate_dump_file(path)


def test_signal_handler_dumps(tmp_path):
    import signal
    assert flightrec.install_signal_handler()
    flightrec.record("event", "before.signal")
    os.kill(os.getpid(), signal.SIGUSR2)
    deadline = time.monotonic() + 5
    while flightrec.last_dump() is None and time.monotonic() < deadline:
        time.sleep(0.01)
    last = flightrec.last_dump()
    assert last is not None and last["trigger"] == "signal"
    _both_validate_dump(last["path"])


# ---------------------------------------------------------------------------
# deadline and circuit (tests/test_serve.py:63-125)
# ---------------------------------------------------------------------------


def test_deadline_scope_tightens():
    outer = dl.Deadline.after_ms(10_000)
    inner = dl.Deadline.after_ms(50)
    assert dl.current() is None
    with dl.scope(outer) as eff:
        assert eff is outer and dl.current() is outer
        with dl.scope(inner) as eff2:
            assert eff2 is inner
        with dl.scope(dl.Deadline.after_ms(99_000)) as eff3:
            assert eff3 is outer
        assert dl.current() is outer
    assert dl.current() is None
    with dl.scope(None) as eff4:
        assert eff4 is None


def test_deadline_check_raises():
    with dl.scope(dl.Deadline(time.monotonic() - 0.01)):
        with pytest.raises(dl.DeadlineExceeded) as ei:
            dl.check("unit")
        assert ei.value.detail == "unit"
        assert ei.value.overrun_ms > 0
    dl.check("no ambient deadline -> no raise")
    assert dl.remaining_s(123.0) == 123.0
    assert dl.Deadline.after_s(1.0).remaining_ms() > 900


def test_circuit_lifecycle():
    b = rc.CircuitBreaker("k", failure_threshold=3, cooldown_s=0.15,
                          metrics_prefix="serve.circuit")
    assert b.state == "closed" and b.allow()
    assert not b.record_failure(RuntimeError("one"))
    assert not b.record_failure(RuntimeError("two"))
    b.record_success()
    assert not b.record_failure(RuntimeError("one again"))
    assert not b.record_failure(RuntimeError("two again"))
    assert b.record_failure(RuntimeError("three"))
    assert b.state == "open" and not b.allow()
    assert b.retry_after_s() > 0
    assert isinstance(b.reject(), rc.CircuitOpen)
    time.sleep(0.2)
    assert b.allow()
    assert b.state == "half_open"
    assert not b.allow()
    b.record_failure(RuntimeError("probe failed"))
    assert b.state == "open"
    time.sleep(0.2)
    assert b.allow()
    b.record_success()
    assert b.state == "closed"
    snap = b.snapshot()
    assert snap["state"] == "closed" and snap["consecutive_failures"] == 0
    assert metrics.counter_value("serve.circuit.opened") == 1
    assert metrics.counter_value("serve.circuit.reopened") == 1
    assert metrics.counter_value("serve.circuit.closed") == 1
    assert metrics.counter_value("serve.circuit.rejected") == 1


def test_circuit_release_keeps_state():
    b = rc.CircuitBreaker("k", failure_threshold=2, cooldown_s=60)
    b.record_failure(RuntimeError("x"))
    b.release()
    assert b.record_failure(RuntimeError("y"))
    assert b.state == "open"
    with pytest.raises(ValueError):
        rc.CircuitBreaker("k", failure_threshold=0)
    with pytest.raises(ValueError):
        rc.CircuitBreaker("k", cooldown_s=-1)
