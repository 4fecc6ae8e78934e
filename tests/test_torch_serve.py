"""The port's serving layer (``serve/``) at P = 1 against the JAX
package's: every single-rank case of ``tests/test_serve.py`` (the
multi-rank ones run in ``tests/test_torch_serve_ranks.py``), the served
volume at one rank, replies equal to the JAX ``Server``'s on the same
payloads within 1e-5 ("xla") and 5e-4 ("pallas", the kernels' plain
versions), the data path's split metrics, and the resident cases of
``tests/test_persist.py`` (the fleet's: ``tests/test_torch_fleet.py``).

* plan cache: strict LRU eviction order, hit accounting, prefix
  invalidation, and zero plan builds on a hit (build counts);
* coalescing: concurrent same-shape requests execute as ONE stacked
  batched-2D call whose per-request results are BIT-IDENTICAL to
  single-shot execution;
* deadlines: an expired request is answered ``DeadlineExceeded`` and
  NEVER executes, including under the injected ``server:slow``
  straggler; nested deadline scopes only tighten;
* admission control: bounded queue + latency-budget shedding with
  structured ``Overloaded`` rejections;
* graceful drain: queued work finishes, new submits reject, and the obs
  event log carries the serve.* evidence chain.
"""

import json
import os
import time

import numpy as np
import pytest

import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch import obs, persist
from distributedfft_tpu_torch.ops import hopper_fft as hf
from distributedfft_tpu_torch.persist import CheckpointMismatch, CheckpointStore
from distributedfft_tpu_torch.resilience import circuit as rc
from distributedfft_tpu_torch.resilience import deadline as dl
from distributedfft_tpu_torch.resilience import inject
from distributedfft_tpu_torch.serve import (Overloaded, PlanCache, Server,
                                            ServerClosed, bucket_for,
                                            cache_key, request_key)
from distributedfft_tpu_torch.serve.resident import ResidentSolver
from distributedfft_tpu_torch.testing.workloads import serve_load


@pytest.fixture(autouse=True)
def _serve_hygiene(monkeypatch):
    """Clean metrics and no fault/guard env around every test."""
    for var in (inject.ENV_VAR, "DFFT_GUARDS", "DFFT_FALLBACK",
                "DFFT_DEMOTION_TTL_S"):
        monkeypatch.delenv(var, raising=False)
    obs.reset()
    yield
    obs.reset()


def _img(shape=(24, 24), seed=0, dtype=np.float32):
    return np.random.default_rng(seed).random(shape, dtype=np.float64) \
        .astype(dtype)


def Srv(*args, **kw):
    """The port's Server on the CPU."""
    return Server(*args, device="cpu", **kw)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


# ---------------------------------------------------------------------------
# deadline primitives
# ---------------------------------------------------------------------------

def test_deadline_scope_tightens():
    outer = dl.Deadline.after_ms(10_000)
    inner = dl.Deadline.after_ms(50)
    assert dl.current() is None
    with dl.scope(outer) as eff:
        assert eff is outer and dl.current() is outer
        with dl.scope(inner) as eff2:
            assert eff2 is inner  # tighter wins
        # a LOOSER inner scope cannot extend the budget
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


# ---------------------------------------------------------------------------
# circuit breaker state machine
# ---------------------------------------------------------------------------

def test_circuit_lifecycle():
    b = rc.CircuitBreaker("k", failure_threshold=3, cooldown_s=0.15,
                          metrics_prefix="serve.circuit")
    assert b.state == "closed" and b.allow()
    assert not b.record_failure(RuntimeError("one"))
    assert not b.record_failure(RuntimeError("two"))
    b.record_success()  # success resets the consecutive count
    assert not b.record_failure(RuntimeError("one again"))
    assert not b.record_failure(RuntimeError("two again"))
    assert b.record_failure(RuntimeError("three"))  # opens
    assert b.state == "open" and not b.allow()
    assert b.retry_after_s() > 0
    assert isinstance(b.reject(), rc.CircuitOpen)
    time.sleep(0.2)
    assert b.allow()                # half-open probe slot
    assert b.state == "half_open"
    assert not b.allow()            # only one probe at a time
    b.record_failure(RuntimeError("probe failed"))
    assert b.state == "open"        # re-opened
    time.sleep(0.2)
    assert b.allow()
    b.record_success()
    assert b.state == "closed"
    snap = b.snapshot()
    assert snap["state"] == "closed" and snap["consecutive_failures"] == 0
    assert obs.metrics.counter_value("serve.circuit.opened") == 1
    assert obs.metrics.counter_value("serve.circuit.reopened") == 1
    assert obs.metrics.counter_value("serve.circuit.closed") == 1


def test_circuit_release_keeps_state():
    b = rc.CircuitBreaker("k", failure_threshold=2, cooldown_s=60)
    b.record_failure(RuntimeError("x"))
    b.release()  # no verdict: the count must survive
    assert b.record_failure(RuntimeError("y"))  # second failure opens
    assert b.state == "open"


# ---------------------------------------------------------------------------
# plan cache
# ---------------------------------------------------------------------------

def test_plan_cache_lru_eviction_order():
    c = PlanCache(capacity=2)
    c.get_or_build("a", lambda: "A")
    c.get_or_build("b", lambda: "B")
    _, hit = c.get_or_build("a", lambda: "A2")  # touch a -> b is oldest
    assert hit
    c.get_or_build("c", lambda: "C")            # evicts b, NOT a
    assert c.keys() == ("a", "c")
    plan, hit = c.get_or_build("b", lambda: "B2")
    assert not hit and plan == "B2"
    assert c.keys() == ("c", "b")               # a evicted as oldest
    snap = c.snapshot()
    assert snap["evictions"] == 2 and snap["size"] == 2
    assert obs.metrics.counter_value("serve.plan_cache.evictions") == 2


def test_plan_cache_invalidate_prefix():
    from distributedfft_tpu.serve import plancache as jpc
    c = PlanCache(capacity=8)
    base = request_key(16, 16, "f32", "r2c", "batch")
    assert base == jpc.request_key(16, 16, "f32", "r2c", "batch")
    other = request_key(32, 32, "f32", "r2c", "batch")
    for b in (1, 2, 4):
        c.get_or_build(cache_key(base, b), lambda: b)
    c.get_or_build(cache_key(other, 1), lambda: "keep")
    assert c.invalidate_prefix(base) == 3
    assert c.keys() == (cache_key(other, 1),)
    for key in (cache_key(other, 1), "fft3d/8x8x16/f64/c2c/pencil"):
        from distributedfft_tpu_torch.serve import parse_request_key
        assert parse_request_key(key) == jpc.parse_request_key(key)


def test_bucket_for():
    from distributedfft_tpu.serve.plancache import bucket_for as jbucket
    assert [bucket_for(n, 8) for n in (1, 2, 3, 5, 8)] == [1, 2, 4, 8, 8]
    # a non-power-of-two cap still yields only power-of-two buckets
    assert [bucket_for(n, 6) for n in (1, 3, 5, 6)] == [1, 4, 8, 8]
    assert bucket_for(1, 1) == 1
    assert all(bucket_for(n, c) == jbucket(n, c)
               for n in range(1, 20) for c in range(1, 12))
    with pytest.raises(ValueError):
        bucket_for(0, 8)


def test_batch_chunk_clamps_to_small_buckets():
    """--batch-chunk > 1 must not make single-request (bucket-1) plans
    unbuildable: the chunk clamps to the bucket's local batch."""
    with Srv(batch_chunk=4) as s:
        x = _img((16, 16))
        assert s.request(x).shape == (16, 9)   # bucket 1, chunk clamps to 1
        assert s.prewarm((16, 16)) >= 0        # every bucket builds


def test_worker_survives_injector_crash(monkeypatch):
    """A malformed $DFFT_FAULT_SPEC raises inside the worker's injector
    hook; the batch must fail loudly and the worker must keep serving."""
    with Srv() as s:
        x = _img((16, 16))
        s.request(x)  # warm
        monkeypatch.setenv(inject.ENV_VAR, "not a valid spec")
        with pytest.raises(ValueError):
            s.submit(x).result(30)
        monkeypatch.delenv(inject.ENV_VAR)
        assert s.request(x).shape == (16, 9)  # worker still alive
    assert obs.metrics.counter_value("serve.batch_failures") >= 1


# ---------------------------------------------------------------------------
# server: correctness, coalescing, zero-build hits
# ---------------------------------------------------------------------------

def test_server_forward_inverse_roundtrip():
    with Srv() as s:
        x = _img((20, 26), seed=3)
        spec = s.request(x, "r2c")
        np.testing.assert_allclose(spec, np.fft.rfft2(x), rtol=1e-4,
                                   atol=5e-3)
        back = s.request(spec, "r2c", "inverse", ny=26)
        np.testing.assert_allclose(back / (20 * 26), x, atol=1e-4)
        z = _img((16, 16), seed=4).astype(np.complex64)
        np.testing.assert_allclose(s.request(z, "c2c"), np.fft.fft2(z),
                                   rtol=1e-4, atol=5e-3)
        h = s.health()
        assert h["status"] == "ok"
        assert h["plan_cache"]["size"] == 2  # r2c fwd+inv share one plan


def test_server_rejects_malformed():
    with Srv() as s:
        with pytest.raises(ValueError):
            s.submit(np.zeros((4, 4, 4, 4), np.float32))
        with pytest.raises(ValueError):
            s.submit(np.zeros((4, 4), np.complex64))   # r2c fwd wants real
        with pytest.raises(ValueError):
            s.submit(np.zeros((4, 4), np.float32), "c2c")
        with pytest.raises(ValueError):
            s.submit(np.zeros((4, 5), np.complex64), "r2c", "inverse",
                     ny=12)  # ny inconsistent with spectral width
        with pytest.raises(ValueError):
            s.submit(np.zeros((4, 4), np.float32), decomp="slab")
        with pytest.raises(ValueError):
            s.submit(np.zeros((4, 4, 4), np.float32), decomp="tile")


def test_served_volume_bit_identical_to_direct_plans():
    """A served 3D volume executes the SAME single-shot slab/pencil plan a
    direct caller builds — forward and inverse bit-identical to driving
    the plan family by hand, r2c through the slab default and c2c through
    a per-request pencil override; volumes never coalesce (one rank)."""
    rng = np.random.default_rng(5)
    v = rng.random((16, 16, 16), dtype=np.float64).astype(np.float32)
    z = (rng.random((16, 16, 16)) + 1j * rng.random((16, 16, 16))) \
        .astype(np.complex64)
    g = tdfft.GlobalSize(16, 16, 16)
    with Srv() as s:
        got = np.asarray(s.request(v, "r2c"))
        plan = tdfft.SlabFFTPlan(g, tdfft.SlabPartition(1), tdfft.Config(),
                                 transform="r2c", device="cpu")
        ref = plan.crop_spectral(plan.exec_r2c(v))
        np.testing.assert_array_equal(got, ref)
        back = np.asarray(s.request(got, "r2c", "inverse", ny=16))
        np.testing.assert_array_equal(
            back, plan.crop_real(plan.exec_c2r(ref)))
        gotz = np.asarray(s.request(z, "c2c", decomp="pencil"))
        pplan = tdfft.PencilFFTPlan(g, tdfft.PencilPartition(1, 1),
                                    tdfft.Config(), transform="c2c",
                                    device="cpu")
        refz = pplan.crop_spectral(pplan.exec_c2c(z))
        np.testing.assert_array_equal(gotz, refz)
        backz = np.asarray(s.request(gotz, "c2c", "inverse",
                                     decomp="pencil"))
        np.testing.assert_array_equal(
            backz, pplan.crop_real(pplan.exec_c2c_inv(refz)))
        h = s.health()
        assert h["counters"]["coalesced"] == 0  # volumes never coalesce
        assert any(k.startswith("fft3d/16x16x16/f32/r2c/slab")
                   for k in h["plan_cache"]["keys"])
        assert any("/c2c/pencil" in k for k in h["plan_cache"]["keys"])


def test_describe_request_volume_lines():
    from distributedfft_tpu.serve import describe_request as jdescribe
    from distributedfft_tpu_torch.serve import describe_request
    lines = describe_request(64, 64, 64, decomp="slab")
    assert lines == jdescribe(64, 64, 64, decomp="slab")
    text = "\n".join(lines)
    assert "fft3d/64x64x64/f32/r2c/slab" in text
    assert "single-shot" in text or "single slot" in text
    import distributedfft_tpu as jdfft
    for kw in ({"shard": "x"}, {"double": True, "transform": "c2c"}):
        assert describe_request(32, 48, config=tdfft.Config(), **kw) == \
            jdescribe(32, 48, config=jdfft.Config(), **kw)


def test_coalesced_bit_identical_to_single_shot():
    imgs = [_img((24, 24), seed=i) for i in range(5)]
    with Srv(max_coalesce=1) as s1:
        seq = [np.asarray(s1.request(x)) for x in imgs]
    with Srv(max_coalesce=8) as s2:
        # occupy the worker with a cold build on another key so the five
        # same-key requests are all queued when it comes free
        s2.submit(np.zeros((8, 8), np.float32))
        futs = [s2.submit(x) for x in imgs]
        got = [np.asarray(f.result(60)) for f in futs]
        assert s2.health()["counters"]["coalesced"] >= 2
    for a, b in zip(seq, got):
        np.testing.assert_array_equal(a, b)


def test_trace_id_propagates_through_coalesced_batch():
    """Every admitted request gets a unique trace id that rides its
    future AND the whole event chain — admit, the coalesce event of the
    batch that served it, the execute span, and the reply."""
    from distributedfft_tpu_torch.obs import flightrec
    flightrec.clear()
    imgs = [_img((24, 24), seed=i) for i in range(4)]
    with Srv(max_coalesce=8) as s:
        s.submit(np.zeros((8, 8), np.float32))
        futs = [s.submit(x) for x in imgs]
        [f.result(60) for f in futs]
        assert s.health()["counters"]["coalesced"] >= 2
    tids = [f.trace_id for f in futs]
    assert all(tids) and len(set(tids)) == len(tids)  # unique, nonempty
    recs = [r for r in flightrec.snapshot() if r["ev"] in ("event", "span")]
    admits = {r["attrs"]["trace"] for r in recs
              if r["name"] == "serve.admit"}
    assert set(tids) <= admits
    coalesces = [r["attrs"]["traces"] for r in recs
                 if r["name"] == "serve.coalesce"]
    for tid in tids:  # each id appears in EXACTLY one batch's coalesce
        assert sum(tid in traces for traces in coalesces) == 1
    assert any(len(set(tids) & set(traces)) >= 2 for traces in coalesces)
    execs = [r["attrs"]["traces"] for r in recs
             if r["name"] == "serve.execute"]
    assert all(any(tid in traces for traces in execs) for tid in tids)
    replies = {r["attrs"]["trace"]: r["attrs"] for r in recs
               if r["name"] == "serve.reply"}
    for tid in tids:
        assert replies[tid]["outcome"] == "ok"
        assert replies[tid]["coalesced_n"] >= 2


def test_cache_hit_zero_recompiles(monkeypatch):
    from distributedfft_tpu_torch.models import batched2d as b2
    builds = []
    orig = b2.Batched2DFFTPlan._build

    def counting(self, *a, **k):
        builds.append(1)
        return orig(self, *a, **k)

    monkeypatch.setattr(b2.Batched2DFFTPlan, "_build", counting)
    with Srv() as s:
        x = _img((18, 18))
        s.request(x)
        cold = len(builds)
        assert cold >= 1
        for i in range(4):
            s.request(_img((18, 18), seed=i + 1))
        assert len(builds) == cold  # warm hits: zero plan builds
        assert s.health()["plan_cache"]["hits"] >= 4
        s.request(_img((14, 14)))   # a NEW shape is a miss and builds
        assert len(builds) > cold


# ---------------------------------------------------------------------------
# deadlines + straggler injection
# ---------------------------------------------------------------------------

def test_deadline_expired_never_executes(monkeypatch):
    from distributedfft_tpu_torch.models import batched2d as b2
    executed = []
    orig = b2.Batched2DFFTPlan.exec_forward

    def counting(self, v):
        executed.append(tuple(v.shape))
        return orig(self, v)

    with Srv() as s:
        x = _img((16, 16))
        s.request(x)  # warm
        monkeypatch.setattr(b2.Batched2DFFTPlan, "exec_forward", counting)
        monkeypatch.setenv(inject.ENV_VAR, "server:slow:150")
        f1 = s.submit(x)
        f2 = s.submit(_img((16, 16), seed=9), deadline_ms=20)
        assert f1.result(30).shape == (16, 9)
        with pytest.raises(dl.DeadlineExceeded) as ei:
            f2.result(30)
        assert ei.value.detail == "queued"
        assert s.health()["counters"]["deadline_expired"] == 1
    assert executed and all(shape[0] == 1 for shape in executed)
    assert obs.metrics.counter_value("serve.deadline_expired") == 1
    assert obs.metrics.counter_value("inject.server_slow") >= 1


def test_fallback_ladder_respects_ambient_deadline():
    """The ladder stops walking when the request's budget is gone: with an
    expired ambient deadline a failing riggable plan raises the ORIGINAL
    error after the first attempt instead of retrying."""
    from distributedfft_tpu_torch.resilience import fallback

    class Boom(RuntimeError):
        pass

    class FakePlan:
        config = tdfft.Config(send_method=tdfft.SendMethod.RING)

    calls = []

    def runner():
        def run(x):
            calls.append(1)
            raise Boom("always")
        return run

    with dl.scope(dl.Deadline(time.monotonic() - 0.01)):
        with pytest.raises(Boom):
            fallback.execute(FakePlan(), "forward", None, runner)
    assert len(calls) == 1  # no retry: the budget was already gone


# ---------------------------------------------------------------------------
# admission control / shedding
# ---------------------------------------------------------------------------

def test_shed_on_queue_full(monkeypatch):
    with Srv(max_queue=2, latency_budget_ms=1e9) as s:
        x = _img((16, 16))
        s.request(x)  # warm
        monkeypatch.setenv(inject.ENV_VAR, "server:slow:300")
        futs = [s.submit(_img((16, 16), seed=i)) for i in range(2)]
        time.sleep(0.05)
        shed = 0
        for i in range(6):
            try:
                futs.append(s.submit(_img((16, 16), seed=10 + i)))
            except Overloaded as e:
                assert e.reason in ("queue_full", "latency_budget")
                assert e.queue_depth >= 2
                shed += 1
        assert shed >= 1
        assert s.health()["counters"]["shed"] == shed
    assert obs.metrics.counter_value("serve.shed") == shed


def test_shed_on_latency_budget():
    with Srv(latency_budget_ms=0.00001, max_queue=64) as s:
        x = _img((16, 16))
        s.request(x)  # cold build (excluded from the EMA by design)
        s.request(x)  # warm hit: seeds the queue-delay EMA
        assert s.health()["ema_ms"] is not None
        futs = []
        with pytest.raises(Overloaded) as ei:
            for i in range(10):
                futs.append(s.submit(_img((16, 16), seed=20 + i)))
        assert ei.value.reason == "latency_budget"
        assert ei.value.est_delay_ms > 0
        for f in futs:
            f.result(30)


# ---------------------------------------------------------------------------
# drain + event-log evidence
# ---------------------------------------------------------------------------

def test_graceful_drain_and_event_log(tmp_path):
    obs.enable(str(tmp_path))
    try:
        s = Srv()
        x = _img((16, 16))
        s.request(x)  # warm
        futs = [s.submit(_img((16, 16), seed=i)) for i in range(4)]
        s.close(drain=True)  # queued work FINISHES
        for f in futs:
            assert f.result(0.0).shape == (16, 9)  # already resolved
        with pytest.raises(ServerClosed):
            s.submit(x)
        assert s.health()["status"] == "stopped"
    finally:
        obs.reset_enablement()
    n = obs.validate_events_dir(str(tmp_path))
    assert n > 0
    names = set()
    for fn in os.listdir(tmp_path):
        if fn.startswith("events-") and fn.endswith(".jsonl"):
            with open(tmp_path / fn) as f:
                for ln in f:
                    if ln.strip():
                        names.add(json.loads(ln)["name"])
    for want in ("serve.start", "serve.batch", "serve.drain", "serve.stop"):
        assert want in names, f"missing {want} in {sorted(names)}"


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_close_after_worker_thread_death_answers_everything(monkeypatch):
    """If the serving thread DIES, ``close(drain=True)`` answers every
    leftover with a structured ``ServerClosed`` — both the requests still
    queued AND the batch the dead thread had already popped."""
    with Srv() as s:
        x = _img((16, 16))
        s.request(x)  # warm
        orig = Server._execute

        def lethal(self, batch):
            monkeypatch.setattr(Server, "_execute", orig)
            raise SystemExit(1)  # kills the worker thread itself

        monkeypatch.setattr(Server, "_execute", lethal)
        f1 = s.submit(x)                       # popped by the worker
        time.sleep(0.1)                        # thread takes it and dies
        f2 = s.submit(_img((16, 16), seed=1))  # stays queued forever
        f3 = s.submit(_img((16, 16), seed=2))
        s.close(drain=True, timeout_s=1.0)
        for f in (f1, f2, f3):
            with pytest.raises(ServerClosed):
                f.result(5)
    assert s.health()["status"] == "stopped"


def test_close_without_drain_rejects_queued(monkeypatch):
    with Srv() as s:
        x = _img((16, 16))
        s.request(x)  # warm
        monkeypatch.setenv(inject.ENV_VAR, "server:slow:200")
        futs = [s.submit(_img((16, 16), seed=i)) for i in range(3)]
        time.sleep(0.02)  # let the worker take the first batch
        s.close(drain=False)
        outcomes = []
        for f in futs:
            try:
                f.result(30)
                outcomes.append("ok")
            except ServerClosed:
                outcomes.append("closed")
        assert "ok" in outcomes or "closed" in outcomes
        assert s.state == "stopped"


def test_concurrent_submitters_account_for_every_request():
    """More submitting threads than cores, with a short switch interval:
    every admitted request is answered, and the counters add up (an
    update lost between the admission and worker threads breaks them)."""
    import sys
    import threading
    n_threads, per = 3 * (os.cpu_count() or 4), 6
    futs, shed, lock = [], [0], threading.Lock()

    def submitter(s, seed):
        for i in range(per):
            try:
                f = s.submit(_img((8, 8), seed=seed * per + i))
            except Overloaded:
                with lock:
                    shed[0] += 1
            else:
                with lock:
                    futs.append(f)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with Srv(max_queue=16, latency_budget_ms=1e9) as s:
            threads = [threading.Thread(target=submitter, args=(s, t))
                       for t in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
                assert not t.is_alive()
            replies = [f.result(120) for f in futs]
        c = s.health()["counters"]
    finally:
        sys.setswitchinterval(interval)
    assert all(r.shape == (8, 5) for r in replies)
    assert len(futs) + shed[0] == n_threads * per
    assert c["admitted"] == c["served"] == len(futs)
    assert c["shed"] == shed[0]


# ---------------------------------------------------------------------------
# load generator
# ---------------------------------------------------------------------------

def test_serve_load_measures_and_classifies():
    with Srv(latency_budget_ms=10_000) as s:
        out = serve_load(s, rate_hz=40, n_requests=20,
                         shapes=((16, 16),), seed=2)
    assert out["offered"] == 20
    assert out["outcomes"]["ok"] == out["completed"] > 0
    assert out["p50_ms"] is not None and out["p99_ms"] >= out["p50_ms"]
    assert out["achieved_fps"] > 0


def test_serve_load_counts_rejections():
    s = Srv(latency_budget_ms=10_000)
    s.close()
    out = serve_load(s, rate_hz=100, n_requests=5, shapes=((16, 16),),
                     warmup=0)
    assert out["outcomes"]["closed"] == 5 and out["completed"] == 0


def test_serve_load_arg_validation():
    with Srv() as s:
        with pytest.raises(ValueError):
            serve_load(s, rate_hz=1.0)  # neither duration nor count
        with pytest.raises(ValueError):
            serve_load(s, rate_hz=1.0, duration_s=1, n_requests=1)


def test_serve_load_offers_the_jax_schedule(devices):
    """The same seed, rate and mix offer the JAX generator's requests in
    the same order: every reply matches the JAX server's."""
    from distributedfft_tpu.serve import Server as JServer
    from distributedfft_tpu.testing.workloads import serve_load as jload
    shapes = ((16, 16), (8, 12))
    kw = dict(rate_hz=200, n_requests=12, shapes=shapes, seed=4, warmup=0,
              transforms=("r2c", "c2c"))
    got, want = [], []

    class Tap:
        """Forward ``submit`` and keep each reply."""

        def __init__(self, srv, sink):
            self.srv, self.sink = srv, sink
            self.max_coalesce, self.cache = srv.max_coalesce, srv.cache

        def submit(self, x, t, **k):
            fut = self.srv.submit(x, t, **k)
            self.sink.append(fut)
            return fut

    with Srv(latency_budget_ms=1e9) as s:
        out = serve_load(Tap(s, got), **kw)
    with JServer(latency_budget_ms=1e9) as js:
        jout = jload(Tap(js, want), **kw)
    assert out["offered"] == jout["offered"] == 12
    assert out["outcomes"] == jout["outcomes"]
    for a, b in zip(got, want):
        _close(a.result(), np.asarray(b.result()), 1e-5)


# ---------------------------------------------------------------------------
# replies vs the JAX Server, the split metrics, the fleet's names
# ---------------------------------------------------------------------------

CASES = {
    "r2c-forward": ((20, 26), "r2c", "forward", None),
    "r2c-inverse": ((20, 14), "r2c", "inverse", 26),
    "c2c-forward": ((16, 12), "c2c", "forward", None),
    "c2c-inverse": ((16, 12), "c2c", "inverse", None),
    "volume-r2c": ((8, 12, 16), "r2c", "forward", None),
    "volume-c2r": ((8, 12, 9), "r2c", "inverse", 16),
}


def _payload(shape, transform, direction, seed=7):
    rng = np.random.default_rng(seed)
    if transform == "c2c" or direction == "inverse":
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("backend,tol", [("xla", 1e-5), ("pallas", 5e-4)])
def test_replies_match_the_jax_server(devices, backend, tol):
    import distributedfft_tpu as jdfft
    from distributedfft_tpu.serve import Server as JServer
    # No shedding: a slow interpret-mode reply makes the EMA large, and a
    # request may meet the previous batch still counted in flight.
    with Srv(config=tdfft.Config(fft_backend=backend),
             latency_budget_ms=1e9) as s, \
            JServer(config=jdfft.Config(fft_backend=backend),
                    latency_budget_ms=1e9) as js:
        for name, (shape, t, d, ny) in CASES.items():
            x = _payload(shape, t, d)
            got = s.request(x, t, d, ny=ny)
            want = np.asarray(js.request(x, t, d, ny=ny))
            _close(got, want, tol)


def test_data_path_split_is_recorded():
    """A warm batch records its split: stack, copy in, device, copy out,
    beside ``serve.exec_ms`` and the queue wait."""
    with Srv() as s:
        x = _img((16, 16))
        s.request(x)                    # cold: no split recorded
        for i in range(3):
            s.request(_img((16, 16), seed=i))
        hist = s.health()["obs_metrics"]["histograms"]
    for name in ("serve.exec_ms", "serve.queue_wait_ms", "serve.stack_ms",
                 "serve.copy_in_ms", "serve.device_ms", "serve.copy_out_ms",
                 "serve.e2e_ms"):
        assert hist[name]["count"] >= 3, name


def test_one_rank_server_is_its_own_leader():
    # The counts are the process's: start them at 0, so that an earlier
    # test's matmul dispatches are not counted as the server's.
    hf.reset_launches()
    with Srv(tdfft.SlabPartition(1)) as s:
        assert s.leader and s.health()["role"] == "leader"
        rows = s.rank_counts()
    assert [r["rank"] for r in rows] == [0]
    assert rows[0]["pid"] == os.getpid() and rows[0]["matmul"] == 0


# ---------------------------------------------------------------------------
# the resident (tests/test_persist.py's serve cases)
# ---------------------------------------------------------------------------

def _spec(d, **kw):
    return dict({"kind": "ns2d", "n": 16, "batch": 1, "dt": 1e-3,
                 "dir": str(d), "name": "res", "device": "cpu"}, **kw)


@pytest.mark.slow  # live Server + stepping resident, as in the JAX suite
def test_server_drain_checkpoints_and_resident_restores(tmp_path):
    d = tmp_path / "ck"
    spec = _spec(d, policy="steps:2", step_interval_ms=1)
    srv = Srv(tdfft.SlabPartition(1), tdfft.Config())
    srv.attach_resident(ResidentSolver.build(spec))
    deadline = time.monotonic() + 120
    while srv.resident.step < 4 and time.monotonic() < deadline:
        time.sleep(0.02)
    assert srv.resident.step >= 4
    h = srv.health()
    assert h["resident"]["running"] and h["resident"]["checkpoints"] >= 1
    srv.close(drain=True)  # drain writes the final generation
    sim = CheckpointStore(str(d)).load()
    assert sim.meta["reason"] == "drain"
    stopped_at = sim.step
    assert obs.metrics.gauge_value("persist.last_checkpoint_age_s") >= 0
    res2 = ResidentSolver.build(spec)
    assert res2.restored_from == stopped_at and res2.step == stopped_at


def test_resident_beside_traffic_resumes_bit_equal(tmp_path):
    """The resident steps on its own thread while the server answers
    requests (DEVICE_LOCK); its drain checkpoint restores into a new
    resident whose next steps are bit-equal to the continued run."""
    from distributedfft_tpu_torch.serve.resident import advance_steps
    d = tmp_path / "ck"
    spec = _spec(d, step_interval_ms=1)
    srv = Srv()
    srv.attach_resident(ResidentSolver.build(spec))
    for i in range(4):
        assert srv.request(_img((16, 16), seed=i)).shape == (16, 9)
    while srv.resident.step < 3:
        time.sleep(0.01)
    srv.close(drain=True)
    res = srv.resident
    assert res.error is None and res.checkpoints == 1
    cont = advance_steps(res.solver.step_fn(res.dt), res.state, 2)
    res2 = ResidentSolver.build(spec)
    assert res2.restored_from == res.step
    back = advance_steps(res2.solver.step_fn(res2.dt), res2.state, 2)
    assert np.array_equal(cont.numpy(), back.numpy())


def test_resident_fresh_start_after_unusable_store(tmp_path):
    d = tmp_path / "ck"
    st = CheckpointStore(str(d))
    p = st.save(persist.SimState(
        arrays={"field0": np.zeros((4, 6), np.complex128)}, step=9,
        dt=1e-3, sim_time=9e-3, rng={"seed": 7, "draws": 9},
        plan_fingerprint={"plan": "T", "shape": [4, 6]},
        meta={"n_fields": 1, "tuple_state": False}))
    with open(p, "r+b") as f:
        f.truncate(6)
    before = obs.metrics.counter_total("persist.restore_failures")
    res = ResidentSolver.build(_spec(d))
    assert res.restored_from is None and res.step == 0
    assert obs.metrics.counter_total("persist.restore_failures") \
        == before + 1


def test_resident_mismatch_propagates(tmp_path):
    d = tmp_path / "ck"
    res = ResidentSolver.build(_spec(d))
    res.checkpoint("manual")
    with pytest.raises(CheckpointMismatch):
        ResidentSolver.build(_spec(d, n=32))
