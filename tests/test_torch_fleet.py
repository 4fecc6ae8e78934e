"""The port's serving fleet (``serve/fleet.py``) against the JAX package's:
every case of ``tests/test_fleet.py``, and the fleet cases of
``tests/test_persist.py``, on the CPU.

* the pure pieces give the JAX pieces' outputs on the same inputs: the
  rendezvous ring (leave, join, restart), the tenant policy, the fair
  queue, request-key parsing, the exposition signals, the scale
  controller's decisions, and the error transport (a ``KernelError``
  arrives as ``RemoteWorkerError`` naming it);
* stub fleets (``worker_backend="stub"``: real spawned workers, pipes,
  heartbeats and injectors, an ``np.fft`` core) hold the JAX test's
  assertions: round trip, capability routing, crash and hang recovery
  with zero lost requests, expired reroute, close without drain, tenant
  quotas and p99 isolation, live scale-up;
* real-core fleets on the CPU (``device="cpu"``): replies within 1e-5 of
  JAX's ``Fleet`` on the same payloads; a two-rank worker (a gloo group)
  serving a volume bit for bit like the two-rank ``Server`` (the direct
  plan's crop); a crashed resident host restoring before it rejoins; a
  devloss drill, 2 -> 1 ranks, whose resident restores with
  ``persist.degraded_restore``; every worker's counts gathered rank by
  rank; no worker or follower outlives ``close()`` and no worker imports
  JAX.

Every spawning test bounds its own waits (``timeout_s`` on each result,
deadlines on each poll), so a hung worker fails its test.
"""

import json
import os
import pickle
import threading
import time

import numpy as np
import pytest
import torch

import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch import obs
from distributedfft_tpu_torch.ops import hopper_fft
from distributedfft_tpu_torch.parallel import multihost
from distributedfft_tpu_torch.resilience import inject
from distributedfft_tpu_torch.resilience.deadline import DeadlineExceeded
from distributedfft_tpu_torch.serve import (Fleet, Overloaded,
                                            RemoteWorkerError,
                                            ScaleController, ServerClosed,
                                            parse_request_key, request_key,
                                            request_key3d)
from distributedfft_tpu_torch.serve import fleet as tfleet
from distributedfft_tpu_torch.serve.fleet import parse_exposition_signals
from distributedfft_tpu_torch.serve.router import (FairQueue, RendezvousRing,
                                                   TenantPolicy)


@pytest.fixture(autouse=True)
def _fleet_hygiene(monkeypatch):
    for var in (inject.ENV_VAR, "DFFT_GUARDS", "DFFT_FALLBACK",
                "DFFT_DEVLOSS_AFTER"):
        monkeypatch.delenv(var, raising=False)
    obs.reset()
    yield
    obs.reset()


def _keys(n):
    return [request_key(16 + 2 * i, 16 + 2 * i, "f32", "r2c", "batch")
            for i in range(n)]


def _img(shape=(16, 16), seed=0, dtype=np.float32):
    return np.random.default_rng(seed).random(shape).astype(dtype)


def _alive(pid):
    """Whether ``pid`` runs (a zombie has ended)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _none_alive(pids, within_s=10.0):
    deadline = time.monotonic() + within_s
    while time.monotonic() < deadline:
        if not any(_alive(p) for p in pids):
            return True
        time.sleep(0.1)
    return not any(_alive(p) for p in pids)


def _event_names(d):
    names = set()
    for fn in os.listdir(d):
        if fn.startswith("events-") and fn.endswith(".jsonl"):
            with open(os.path.join(d, fn)) as fh:
                names |= {json.loads(ln)["name"] for ln in fh if ln.strip()}
    return names


def _wait(cond, timeout_s, step=0.1):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(step)
    return cond()


# ---------------------------------------------------------------------------
# rendezvous ring stability (the JAX ring's owners, key by key)
# ---------------------------------------------------------------------------

def test_rendezvous_leave_moves_only_dead_share():
    from distributedfft_tpu.serve.router import RendezvousRing as JRing
    members = [f"worker-{i}" for i in range(5)]
    ring, jring = RendezvousRing(tuple(members)), JRing(tuple(members))
    keys = _keys(1000)
    before = {k: ring.owner(k) for k in keys}
    assert before == {k: jring.owner(k) for k in keys}
    dead = "worker-2"
    ring.remove(dead)
    jring.remove(dead)
    moved = 0
    for k in keys:
        after = ring.owner(k)
        assert after == jring.owner(k)
        if before[k] == dead:
            moved += 1
            assert after != dead
        else:
            assert after == before[k]
    assert 0.08 < moved / len(keys) < 0.35


def test_rendezvous_join_moves_at_most_its_share():
    from distributedfft_tpu.serve.router import RendezvousRing as JRing
    members = tuple(f"worker-{i}" for i in range(4))
    ring, jring = RendezvousRing(members), JRing(members)
    keys = _keys(1000)
    before = {k: ring.owner(k) for k in keys}
    ring.add("worker-4")
    jring.add("worker-4")
    moved = 0
    for k in keys:
        after = ring.owner(k)
        assert after == jring.owner(k)
        if after != before[k]:
            moved += 1
            assert after == "worker-4"
    assert moved / len(keys) < 2 / 5


def test_rendezvous_restart_restores_key_range():
    from distributedfft_tpu.serve.router import RendezvousRing as JRing
    ring = RendezvousRing(("worker-0", "worker-1", "worker-2"))
    keys = _keys(300)
    before = {k: ring.owner(k) for k in keys}
    ring.remove("worker-1")
    ring.add("worker-1")
    assert {k: ring.owner(k) for k in keys} == before
    ring2 = RendezvousRing(("worker-2", "worker-0", "worker-1"))
    assert {k: ring2.owner(k) for k in keys} == before
    assert ring.ranked(keys[0])[0] == before[keys[0]]
    jring = JRing(("worker-0", "worker-1", "worker-2"))
    assert [ring.ranked(k) for k in keys] == [jring.ranked(k) for k in keys]


# ---------------------------------------------------------------------------
# tenant policy + fair queue
# ---------------------------------------------------------------------------

def _policy_trace(TP, Over):
    """The JAX test's sequence on a policy class; returns what it saw."""
    p = TP(8, {"gold": 3.0, "free": 1.0})
    seen = [p.quota("gold")]
    for _ in range(8):
        p.admit("gold")
    try:
        p.admit("gold")
        seen.append("admitted")
    except Over as e:
        seen.append((e.reason, e.tenant))
    p.admit("free")
    seen += [p.quota("gold"), p.quota("free")]
    for _ in range(8):
        p.release("gold")
    p.release("free")
    seen.append(p.outstanding())
    seen.append(TP(8, {"a": 1}).snapshot())
    return seen


def test_tenant_policy_quota_contracts_under_contention():
    from distributedfft_tpu.serve.router import TenantPolicy as JTP
    from distributedfft_tpu.serve.server import Overloaded as JOver
    seen = _policy_trace(TenantPolicy, Overloaded)
    assert seen == _policy_trace(JTP, JOver)
    assert seen[:4] == [8, ("tenant_quota", "gold"), 6, 2]
    assert seen[4] == 0
    assert seen[5]["a"]["quota"] == 8 and seen[5]["a"]["outstanding"] == 0


def _fair_trace(TP, FQ):
    p = TP(100, {"heavy": 2.0, "light": 1.0})
    q = FQ(p)
    for i in range(30):
        q.push("heavy", ("h", i))
        q.push("light", ("l", i))
    first12 = [q.pop() for _ in range(12)]
    q2 = FQ(p)
    for i in range(10):
        q2.push("heavy", ("h", i))
    for _ in range(6):
        q2.pop()
    q2.push("light", ("l", 0))
    return first12, [q2.pop() for _ in range(4)]


def test_fair_queue_weighted_shares_and_no_burst():
    from distributedfft_tpu.serve.router import FairQueue as JFQ
    from distributedfft_tpu.serve.router import TenantPolicy as JTP
    first12, seq = _fair_trace(TenantPolicy, FairQueue)
    assert (first12, seq) == _fair_trace(JTP, JFQ)
    tags = [t for t, _ in first12]
    assert tags.count("h") == 8 and tags.count("l") == 4
    assert [t for t, _ in seq].count("l") == 1


def test_parse_request_key_roundtrip():
    from distributedfft_tpu.serve import plancache as jpc
    key = request_key(48, 36, "f64", "c2c", "x")
    assert key == jpc.request_key(48, 36, "f64", "c2c", "x")
    assert parse_request_key(key) == jpc.parse_request_key(key) == {
        "nx": 48, "ny": 36, "dtype": "f64", "transform": "c2c",
        "shard": "x"}
    assert parse_request_key(key + "#b4")["nx"] == 48
    vkey = request_key3d(64, 48, 32, "f32", "r2c", "slab")
    assert vkey == "fft3d/64x48x32/f32/r2c/slab"
    assert parse_request_key(vkey) == jpc.parse_request_key(vkey) == {
        "nx": 64, "ny": 48, "nz": 32, "dtype": "f32",
        "transform": "r2c", "decomp": "slab"}
    p = parse_request_key(request_key3d(16, 16, 16, "f64", "c2c",
                                        "pencil"))
    assert (p["dtype"], p["decomp"]) == ("f64", "pencil")
    for bad in ("fft2d/axb/f32/r2c/batch", "nope/16x16/f32/r2c/batch",
                "fft2d/16x16/f16/r2c/batch", "fft2d/16x16/f32/dct/batch",
                "fft3d/16x16/f32/r2c/slab", "fft3d/16x16x16/f32/r2c/tile",
                "fft3d/16x16xq/f32/r2c/slab",
                "fft3d/16x16x16/f16/r2c/slab"):
        with pytest.raises(ValueError):
            parse_request_key(bad)
        with pytest.raises(ValueError):
            jpc.parse_request_key(bad)


# ---------------------------------------------------------------------------
# scale controller (pure: injectable exposition source)
# ---------------------------------------------------------------------------

def _expo(workers, shed, queue, pending=0, ema=5.0):
    return "\n".join([
        f"dfft_fleet_workers {workers}",
        f"dfft_fleet_pending {pending}",
        f"dfft_fleet_shed_total {shed}",
        f'dfft_fleet_worker_queue_depth{{worker="worker-0"}} {queue}',
        f'dfft_fleet_worker_ema_ms{{worker="worker-0"}} {ema}',
    ]) + "\n"


def test_parse_exposition_signals():
    from distributedfft_tpu.serve.fleet import \
        parse_exposition_signals as jparse
    sig = parse_exposition_signals(_expo(3, 7, 4, pending=2, ema=9.5))
    assert sig == {"workers": 3.0, "pending": 2.0, "shed_total": 7.0,
                   "queue_depth": 4.0, "ema_ms": 9.5, "capacity": 0.0,
                   "devices_total": 0.0}
    text = (_expo(2, 1, 4)
            + 'dfft_fleet_worker_queue_depth{worker="worker-1"} 6\n'
            + "dfft_fleet_capacity 2.5\n"
            + 'dfft_fleet_worker_devices{worker="worker-0"} 4\n'
            + 'dfft_fleet_worker_devices{worker="worker-1"} 1\n'
            + "# HELP nonsense\nnot a sample line at all\n")
    got = parse_exposition_signals(text)
    assert got["queue_depth"] == 10.0
    assert got["capacity"] == 2.5 and got["devices_total"] == 5.0
    for t in (_expo(3, 7, 4, pending=2, ema=9.5), text):
        assert parse_exposition_signals(t) == jparse(t)


class _FakeFleet:
    def __init__(self):
        self._lock = threading.Lock()
        self._scale_decisions = []
        self.calls = []

    def scale_to(self, n):
        self.calls.append(n)


def _controller_run(SC):
    """The JAX test's exposition feed through a controller class:
    (actions, targets, scale_to calls, audit actions)."""
    fleet = _FakeFleet()
    feed = {"text": _expo(2, 0, 0)}
    ctl = SC(fleet, 1, 4, cooldown_s=0.0, queue_high=4.0,
             down_idle_steps=3, render=lambda: feed["text"])
    recs = [ctl.step()]
    for text, n in ((_expo(2, 5, 0), 1), (_expo(3, 5, 20), 1),
                    (_expo(4, 5, 0), 3), (_expo(1, 5, 0), 5)):
        feed["text"] = text
        recs += [ctl.step() for _ in range(n)]
    return ([r["action"] for r in recs], [r["target"] for r in recs],
            fleet.calls, [d["action"] for d in fleet._scale_decisions],
            fleet._scale_decisions)


def test_scale_controller_policy_and_audit_trail(tmp_path, monkeypatch):
    monkeypatch.setenv("DFFT_FLIGHTREC_DIR", str(tmp_path))
    from distributedfft_tpu.serve.fleet import ScaleController as JSC
    from distributedfft_tpu_torch.obs import flightrec
    flightrec.clear()
    actions, targets, calls, audit, decisions = _controller_run(
        ScaleController)
    assert actions[:4] == ["hold", "up", "up", "hold"]
    assert actions[4:6] == ["hold", "down"]
    assert all(a != "down" for a in actions[6:])
    assert targets[1] == 3 and calls[0] == 3 and calls[-1] == 3
    assert audit == ["up", "up", "down"]
    assert all(("reason" in d and "signals" in d) for d in decisions)
    dumps = [f for f in os.listdir(tmp_path) if f.startswith("flightrec-")]
    assert dumps, "scale_decision must trigger a flight-recorder dump"
    assert flightrec.validate_dump_file(
        os.path.join(tmp_path, dumps[0])) >= 0
    monkeypatch.setenv("DFFT_FLIGHTREC_DIR", str(tmp_path / "jax"))
    assert _controller_run(JSC)[:4] == (actions, targets, calls, audit)


def test_scale_controller_capacity_weighted_threshold():
    from distributedfft_tpu.serve.fleet import ScaleController as JSC
    outs = []
    for SC in (ScaleController, JSC):
        fleet = _FakeFleet()
        feed = {"text": _expo(2, 0, 0)}
        ctl = SC(fleet, 1, 4, cooldown_s=0.0, queue_high=4.0,
                 render=lambda: feed["text"])
        recs = [ctl.step()]
        feed["text"] = _expo(2, 0, 6) + "dfft_fleet_capacity 2\n"
        recs.append(ctl.step())
        feed["text"] = _expo(2, 0, 6) + "dfft_fleet_capacity 1.25\n"
        recs.append(ctl.step())
        outs.append([(r["action"], r["reason"]) for r in recs])
    assert outs[0] == outs[1]
    assert [a for a, _ in outs[0]] == ["hold", "hold", "up"]
    assert "capacity-weighted" in outs[0][2][1]


def test_scale_controller_cooldown_and_validation():
    from distributedfft_tpu.serve.fleet import ScaleController as JSC
    outs = []
    for SC in (ScaleController, JSC):
        fleet = _FakeFleet()
        feed = {"text": _expo(2, 0, 0)}
        ctl = SC(fleet, 1, 4, cooldown_s=60.0, render=lambda: feed["text"])
        ctl.step()
        feed["text"] = _expo(2, 9, 0)
        first = ctl.step()["action"]
        feed["text"] = _expo(3, 99, 0)
        rec = ctl.step()
        outs.append((first, rec["action"], rec["reason"]))
        with pytest.raises(ValueError):
            SC(fleet, 0, 4)
        with pytest.raises(ValueError):
            SC(fleet, 3, 2)
    assert outs[0] == outs[1] == ("up", "hold", "cooldown")


def test_scale_controller_first_act_needs_no_elapsed_cooldown(monkeypatch):
    """A cooldown runs from the controller's last act, not from the
    monotonic clock's origin: on a host up for less than ``cooldown_s``
    the first decision still acts."""
    monkeypatch.setattr(tfleet.time, "monotonic", lambda: 5.0)
    fleet = _FakeFleet()
    feed = {"text": _expo(1, 0, 0)}
    ctl = ScaleController(fleet, 1, 3, cooldown_s=600.0,
                          render=lambda: feed["text"])
    ctl.step()
    feed["text"] = _expo(1, 0, 0, pending=9)
    rec = ctl.step()
    assert (rec["action"], rec["target"]) == ("up", 2) and fleet.calls == [2]
    feed["text"] = _expo(2, 0, 0, pending=9)
    assert ctl.step()["reason"] == "cooldown"


# ---------------------------------------------------------------------------
# error transport
# ---------------------------------------------------------------------------

def test_error_transport_matches_jax():
    """Encoded errors are the JAX fleet's dicts, and decode to the same
    classes; a worker's ``KernelError`` (no router-side twin) arrives as
    ``RemoteWorkerError`` naming it."""
    from distributedfft_tpu.serve import fleet as jfleet
    from distributedfft_tpu_torch.ops._build import KernelError
    from distributedfft_tpu_torch.resilience.circuit import CircuitOpen
    errs = [Overloaded("tenant_quota", 3, 1.5, 8.0),
            DeadlineExceeded("late", detail="queued", overrun_ms=2.0),
            CircuitOpen("fft2d/16x16/f32/r2c/batch", 1.25),
            ServerClosed("closed"), ValueError("bad"),
            KernelError("dfft_cdft: launch failed")]
    for e in errs:
        enc = tfleet._encode_error(e)
        assert enc == jfleet._encode_error(e) or type(e) is KernelError
        dec, jdec = tfleet._decode_error(enc), jfleet._decode_error(enc)
        assert type(dec).__name__ == type(jdec).__name__
        assert str(dec) == str(jdec)
    k = tfleet._decode_error(tfleet._encode_error(errs[-1]))
    assert isinstance(k, RemoteWorkerError) and k.type_name == "KernelError"


# ---------------------------------------------------------------------------
# stub fleets: routing, recovery, fairness (real processes, np.fft core)
# ---------------------------------------------------------------------------

def _stub_fleet(n, **kw):
    kw.setdefault("worker_backend", "stub")
    kw.setdefault("stub_service_ms", 3.0)
    kw.setdefault("heartbeat_interval_s", 0.15)
    # A wide beat window unless a test pins the detector: the suite's
    # other processes load the cores, and a starved but healthy worker
    # must not be declared dead.
    kw.setdefault("heartbeat_k", 20)
    return Fleet(n, **kw)


def test_stub_fleet_roundtrip_health_and_close():
    with _stub_fleet(2) as f:
        x = _img((16, 16))
        np.testing.assert_allclose(f.request(x, timeout_s=60),
                                   np.fft.rfft2(x), rtol=1e-5)
        z = _img((12, 12)).astype(np.complex64)
        np.testing.assert_allclose(f.request(z, "c2c", timeout_s=60),
                                   np.fft.fft2(z), rtol=1e-4, atol=1e-3)
        h = f.health()
        assert h["status"] == "ok"
        assert sorted(h["ring"]) == ["worker-0", "worker-1"]
        assert set(h["workers"]) == {"worker-0", "worker-1"}
        assert all(w["state"] == "ready" for w in h["workers"].values())
        assert h["counters"]["served"] == 2
        assert "flight_recorder" in h
        fut = f.submit(_img((16, 16)))
        assert fut.trace_id
        fut.result(60)
        pids = f.process_ids()
    assert f.state == "stopped"
    with pytest.raises(ServerClosed):
        f.submit(_img((16, 16)))
    assert len(pids) == 2 and _none_alive(pids)


def test_fleet_volume_capability_routing():
    with _stub_fleet(3, worker_devices=[8, 0, 0]) as f:
        v = _img((16, 16, 16))
        spec = f.request(v, "r2c", timeout_s=60)
        np.testing.assert_allclose(spec, np.fft.rfftn(v), rtol=1e-4,
                                   atol=1e-3)
        back = f.request(np.asarray(spec), "r2c", "inverse", ny=16,
                         timeout_s=60)
        np.testing.assert_allclose(back / v.size, v, atol=1e-4)
        z = _img((12, 12, 12)).astype(np.complex64)
        np.testing.assert_allclose(f.request(z, "c2c", timeout_s=60),
                                   np.fft.fftn(z), rtol=1e-3, atol=1e-3)
        h = f.health()
        assert h["mesh_ring"] == ["worker-0"]
        assert sorted(h["ring"]) == ["worker-0", "worker-1", "worker-2"]
        devs = {w: (s["devices"], s["full_devices"])
                for w, s in h["workers"].items()}
        assert devs == {"worker-0": (8, 8), "worker-1": (0, 0),
                        "worker-2": (0, 0)}
        for n in (16, 24, 32, 48, 64, 96, 128, 256):
            key = request_key3d(n, n, n, "f32", "r2c", "slab")
            assert f._ring_for(key) is f.mesh_ring
            assert f.mesh_ring.owner(key) == "worker-0"
        assert f._ring_for(
            request_key(16, 16, "f32", "r2c", "batch")) is f.ring
        with pytest.raises(ValueError):
            f.submit(_img((16, 16)), decomp="slab")
    with _stub_fleet(2) as f2:
        with pytest.raises(ValueError):
            f2.submit(_img((8, 8, 8)))


def test_fleet_worker_crash_recovery_zero_lost(tmp_path, monkeypatch):
    monkeypatch.setenv("DFFT_OBS_DIR", str(tmp_path))
    monkeypatch.setenv(inject.ENV_VAR, "worker:crash:3@seed=1")
    from distributedfft_tpu_torch.obs import flightrec
    flightrec.clear()
    # A generous beat window: the replacement's spawn (a torch import)
    # spikes the cores; this test pins the broken-pipe detector.
    f = _stub_fleet(3, worker_pending=128, heartbeat_interval_s=0.25,
                    heartbeat_k=12)
    try:
        rng = np.random.default_rng(0)
        shapes = [(14 + 2 * i, 14 + 2 * i) for i in range(12)]
        futs = []
        for i in range(60):
            x = rng.random(shapes[i % len(shapes)]).astype(np.float32)
            futs.append((x, f.submit(x, deadline_ms=60_000)))
        ok = 0
        for x, fut in futs:
            np.testing.assert_allclose(fut.result(90), np.fft.rfft2(x),
                                       rtol=1e-5)
            ok += 1
        assert ok == 60
        h = _wait(lambda: (lambda h: h if (
            h["counters"]["worker_restarts"] >= 1 and len(h["ring"]) == 3)
            else None)(f.health()), 60)
        assert h, f.health()
        assert h["counters"]["worker_deaths"] == 1
        assert h["workers"]["worker-1"]["generation"] >= 1
    finally:
        f.close()
    names = _event_names(tmp_path)
    for want in ("fleet.worker_death", "fleet.reroute",
                 "fleet.worker_restart", "fleet.worker_join",
                 "inject.worker_crash"):
        assert want in names, f"missing {want} in {sorted(names)}"
    dumps = [fn for fn in os.listdir(tmp_path)
             if fn.startswith("flightrec-") and fn.endswith(".jsonl")]
    assert dumps
    heads = [json.loads(open(os.path.join(tmp_path, d)).readline())
             for d in dumps]
    assert any(h["trigger"] == "worker_death" for h in heads)
    for d in dumps:
        flightrec.validate_dump_file(os.path.join(tmp_path, d))


def test_fleet_worker_hang_detected_and_rerouted(monkeypatch):
    monkeypatch.setenv(inject.ENV_VAR, "worker:hang:60000@seed=0")
    f = _stub_fleet(2, stub_service_ms=2.0, heartbeat_interval_s=0.25,
                    heartbeat_k=12, worker_pending=64)
    try:
        rng = np.random.default_rng(1)
        shapes = [(14 + 2 * i, 14 + 2 * i) for i in range(8)]
        futs = []
        for i in range(24):
            x = rng.random(shapes[i % len(shapes)]).astype(np.float32)
            futs.append((x, f.submit(x, deadline_ms=60_000)))
        for x, fut in futs:
            np.testing.assert_allclose(fut.result(90), np.fft.rfft2(x),
                                       rtol=1e-5)
        h = f.health()
        assert h["counters"]["worker_deaths"] == 1
        assert h["counters"]["resubmitted"] >= 1
        pids = f.process_ids()
    finally:
        f.close()
    # The hung victim (alive, silent) was killed, not left behind.
    assert _none_alive(pids)


def test_fleet_expired_rerouted_request_answers_deadline(monkeypatch):
    monkeypatch.setenv(inject.ENV_VAR, "worker:hang:60000@seed=0")
    f = _stub_fleet(1, stub_service_ms=5.0, heartbeat_k=2,
                    heartbeat_interval_s=0.15, worker_pending=64)
    try:
        futs = [f.submit(_img((16, 16), seed=i), deadline_ms=120)
                for i in range(6)]
        outcomes = {"ok": 0, "deadline": 0}
        for fut in futs:
            try:
                fut.result(90)
                outcomes["ok"] += 1
            except DeadlineExceeded:
                outcomes["deadline"] += 1
        assert outcomes["deadline"] >= 1
        assert sum(outcomes.values()) == 6
    finally:
        f.close()


def test_fleet_close_without_drain_answers_everything():
    f = _stub_fleet(2, stub_service_ms=30.0)
    futs = [f.submit(_img((16 + 2 * (i % 4),) * 2, seed=i))
            for i in range(16)]
    f.close(drain=False, timeout_s=10)
    resolved = {"ok": 0, "closed": 0}
    for fut in futs:
        try:
            fut.result(5)
            resolved["ok"] += 1
        except ServerClosed:
            resolved["closed"] += 1
    assert sum(resolved.values()) == 16
    assert resolved["closed"] >= 1
    assert _none_alive(f.process_ids())


def test_fleet_tenant_quota_and_p99_isolation():
    ring = RendezvousRing(("worker-0", "worker-1"))
    shapes = [(16 + 2 * i, 16 + 2 * i) for i in range(10)]
    owners = {s: ring.owner(request_key(s[0], s[1], "f32", "r2c",
                                        "batch")) for s in shapes}
    hog_shape = next(s for s, o in owners.items() if o == "worker-0")
    good_shape = next(s for s, o in owners.items() if o == "worker-1")
    f = _stub_fleet(2, stub_service_ms=40.0, heartbeat_interval_s=0.3,
                    worker_inflight=2, worker_pending=32,
                    admission_capacity=32,
                    tenant_weights={"good": 1.0, "hog": 1.0})
    rng = np.random.default_rng(0)
    good_x = [rng.random(good_shape).astype(np.float32)
              for _ in range(50)]
    hog_x = rng.random(hog_shape).astype(np.float32)

    def measure_good():
        lats = []
        for x in good_x:
            t0 = time.perf_counter()
            f.request(x, tenant="good", timeout_s=60)
            lats.append((time.perf_counter() - t0) * 1e3)
        return np.asarray(lats)

    try:
        iso = measure_good()
        stop = threading.Event()
        quota_sheds = [0]
        hog_ok = [0]

        def hog():
            futs = []
            while not stop.is_set():
                try:
                    futs.append(f.submit(hog_x, tenant="hog"))
                except Overloaded as e:
                    if e.reason == "tenant_quota":
                        quota_sheds[0] += 1
                stop.wait(0.02)
            for fut in futs:
                try:
                    fut.result(60)
                    hog_ok[0] += 1
                except Exception:  # noqa: BLE001 — tallying outcomes
                    pass

        t = threading.Thread(target=hog, daemon=True)
        t.start()
        time.sleep(0.3)
        # Best of three 50-sample tails (the JAX test's guard against a
        # scheduler quantum landing in the measuring loop).
        iso_p99 = float(np.percentile(iso, 99))
        for _ in range(3):
            hot_p99 = float(np.percentile(measure_good(), 99))
            if hot_p99 <= 1.25 * iso_p99:
                break
        stop.set()
        t.join(60)
        health = f.health()
    finally:
        f.close()
    assert hot_p99 <= 1.25 * iso_p99, (iso_p99, hot_p99)
    assert quota_sheds[0] > 0
    assert hog_ok[0] > 0
    assert health["tenants"]["hog"]["weight"] == 1.0
    assert obs.metrics.counter_value(
        obs.metrics.labeled("fleet.tenant.shed", tenant="hog")) > 0
    assert obs.metrics.counter_value(
        obs.metrics.labeled("fleet.tenant.shed", tenant="good")) == 0
    for t in ("hog", "good"):
        assert obs.metrics.gauge_value(
            obs.metrics.labeled("fleet.tenant.outstanding", tenant=t),
            default=-1) >= 0


def test_fleet_live_scale_up_joins_ring():
    with _stub_fleet(1, stub_service_ms=200.0, worker_inflight=2,
                     worker_pending=16, heartbeat_interval_s=0.25,
                     heartbeat_k=12) as f:
        ctl = ScaleController(f, 1, 2, cooldown_s=0.0, queue_high=2.0)
        ctl.step()
        futs = [f.submit(_img((14 + 2 * (i % 6),) * 2, seed=i))
                for i in range(14)]
        deadline = time.monotonic() + 30
        rec = ctl.step()
        while rec["action"] != "up" and time.monotonic() < deadline:
            time.sleep(0.1)
            rec = ctl.step()
        assert rec["action"] == "up" and rec["target"] == 2
        assert _wait(lambda: len(f.ring) == 2, 60)
        assert obs.metrics.gauge_value("fleet.workers") == 2
        assert f.health()["scale_decisions"][-1]["action"] == "up"
        for fut in futs:
            fut.result(60)


# ---------------------------------------------------------------------------
# real cores on the CPU
# ---------------------------------------------------------------------------

def _payloads():
    x = _img((20, 26), seed=3)
    z = (_img((12, 10), seed=4) + 1j * _img((12, 10), seed=5)) \
        .astype(np.complex64)
    return x, z


def _serve_payloads(f, x, z):
    spec = f.request(x, "r2c", timeout_s=180)
    back = f.request(np.asarray(spec), "r2c", "inverse", ny=26,
                     timeout_s=120)
    return spec, back, f.request(z, "c2c", timeout_s=120)


def test_real_server_fleet_matches_the_jax_fleet():
    """Two real workers on the CPU: replies within 1e-5 of JAX's Fleet on
    the same payloads (and of numpy); prewarm builds; the heartbeat
    reaches the router's labeled gauges; every worker's counts come back
    rank by rank; no worker imports JAX, and none outlives close()."""
    from distributedfft_tpu.serve.fleet import Fleet as JFleet
    x, z = _payloads()
    with Fleet(2, device="cpu", heartbeat_interval_s=0.5,
               heartbeat_k=10) as f:
        mine = _serve_payloads(f, x, z)
        assert f.prewarm((20, 26)) >= 1
        h = f.health()
        assert h["status"] == "ok" and len(h["ring"]) == 2
        assert _wait(lambda: any(
            k.startswith("fleet.worker.queue_depth[")
            for k in obs.metrics.snapshot()["gauges"]), 30)
        stats = _wait(lambda: all("launches" in w["stats"] for w in
                                  f.health()["workers"].values())
                      and f.health()["workers"], 30)
        assert stats and all(w["stats"]["matmul"] == 0
                             for w in stats.values())
        counts = f.kernel_counts(reset=True)
        assert set(counts) == {"worker-0", "worker-1"}
        for rows in counts.values():
            assert [r["rank"] for r in rows] == [0]
            assert rows[0]["jax"] is False
            assert set(rows[0]["launches"]) == set(hopper_fft.LAUNCHES)
        assert all(not w.info["jax"] for w in f._workers.values())
        pids = f.process_ids()
    assert _none_alive(pids)
    with JFleet(1, worker_backend="server", heartbeat_interval_s=0.5) as jf:
        theirs = _serve_payloads(jf, x, z)
    for a, b in zip(mine, theirs):
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(b).max()))
    np.testing.assert_allclose(mine[0], np.fft.rfft2(x), rtol=1e-4,
                               atol=5e-3)
    np.testing.assert_allclose(mine[1] / (20 * 26), x, atol=1e-4)


def _direct_rank(rank, addr, outdir, v):
    multihost.maybe_initialize(addr, 2, rank, backend="gloo", timeout_s=120)
    try:
        plan = tdfft.SlabFFTPlan(tdfft.GlobalSize(*v.shape),
                                 tdfft.SlabPartition(2), tdfft.Config(),
                                 device="cpu")
        c = plan.crop_spectral(plan.exec_r2c(plan.pad_input(
            torch.from_numpy(v))))
        if rank == 0:
            with open(os.path.join(outdir, "direct.pkl"), "wb") as f:
                pickle.dump(np.asarray(c), f)
    finally:
        multihost.shutdown()


def test_two_rank_worker_serves_a_volume_bit_for_bit(tmp_path):
    """``worker_devices=[2, 0]``: worker 0 is a two-rank gloo group (a
    leader and a follower process) and alone serves the volume keys; its
    16^3 reply is bit for bit the two-rank direct plan's crop (what the
    two-rank ``Server`` replies); images go to either worker; the count
    gather returns both ranks; both processes of the group end with
    close()."""
    v = _img((16, 16, 16), seed=9)
    with Fleet(2, device="cpu", worker_devices=[2, 0],
               heartbeat_interval_s=0.5, heartbeat_k=10) as f:
        h = f.health()
        assert h["mesh_ring"] == ["worker-0"]
        assert len(h["workers"]["worker-0"]["followers"]) == 1
        got = f.request(v, timeout_s=120)
        np.testing.assert_allclose(f.request(_img((12, 12)), timeout_s=60),
                                   np.fft.rfft2(_img((12, 12))), rtol=1e-4,
                                   atol=1e-4)
        rows = f.kernel_counts()["worker-0"]
        assert [r["rank"] for r in rows] == [0, 1]
        assert not any(r["jax"] for r in rows)
        assert rows[1]["pid"] == h["workers"]["worker-0"]["followers"][0]
        pids = f.process_ids()
    assert len(pids) == 3 and _none_alive(pids)
    torch.multiprocessing.start_processes(
        _direct_rank, args=(multihost.local_coordinator(), str(tmp_path), v),
        nprocs=2, start_method="spawn")
    with open(tmp_path / "direct.pkl", "rb") as fh:
        want = pickle.load(fh)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _resident_spec(d, **kw):
    return dict({"kind": "ns2d", "n": 16, "batch": 1, "dt": 1e-3,
                 "dir": str(d), "policy": "steps:2",
                 "step_interval_ms": 20}, **kw)


def test_fleet_worker_crash_resident_restores(tmp_path, monkeypatch):
    """``tests/test_persist.py``'s fleet case: worker:crash kills the
    worker hosting the resident; the replacement RESTORES the simulation
    (restored_from > 0) before rejoining."""
    monkeypatch.setenv("DFFT_FAULT_SPEC", "worker:crash:2@seed=0")
    fleet = Fleet(1, partition=tdfft.SlabPartition(1), device="cpu",
                  worker_backend="server",
                  resident=_resident_spec(tmp_path / "ck"),
                  heartbeat_interval_s=0.25, heartbeat_k=20,
                  spawn_timeout_s=240.0)
    try:
        r = _wait(lambda: (fleet.health().get("resident") or {})
                  .get("checkpoints"), 120, 0.2)
        assert r and r >= 1, fleet.health()
        x = np.random.default_rng(0).standard_normal((16, 16)) \
            .astype(np.float32)
        for _ in range(2):
            try:
                fleet.request(x, timeout_s=60)
            except Exception:  # noqa: BLE001 — the crashed request is
                pass           # resubmitted by the fleet
        restored = _wait(lambda: (lambda h: h.get("resident") if (
            h["counters"]["worker_restarts"] >= 1 and h.get("resident")
            and h["resident"].get("restored_from")) else None)(
                fleet.health()), 240, 0.3)
        assert restored is not None, fleet.health()
        assert restored["restored_from"] > 0
        assert restored["step"] >= restored["restored_from"]
        pids = fleet.process_ids()
    finally:
        monkeypatch.delenv("DFFT_FAULT_SPEC", raising=False)
        fleet.close(drain=False)
    assert _none_alive(pids)


def test_fleet_devloss_resident_restores_degraded(tmp_path, monkeypatch):
    """``worker:devloss:1@seed=0`` on a two-rank worker hosting an NS-3D
    resident (steps posted by the leader to its follower): after its
    first checkpoint the worker dies on its second request; the
    replacement comes up one rank short (``fleet.worker_shrunk``, health
    degraded) and restores the two-rank checkpoint on one rank with
    ``persist.degraded_restore``; every request is answered; no process
    of either incarnation outlives close()."""
    obs_dir = tmp_path / "obs"
    obs_dir.mkdir()
    monkeypatch.setenv("DFFT_OBS_DIR", str(obs_dir))
    monkeypatch.setenv("DFFT_FAULT_SPEC", "worker:devloss:1@seed=0")
    monkeypatch.setenv("DFFT_DEVLOSS_AFTER", "2")
    fleet = Fleet(1, device="cpu", worker_devices=[2],
                  resident=_resident_spec(tmp_path / "ck", kind="ns3d"),
                  heartbeat_interval_s=0.25, heartbeat_k=20,
                  spawn_timeout_s=120.0)
    try:
        first = _wait(lambda: (lambda r: r if r and r.get("checkpoints")
                               else None)(fleet.health().get("resident")),
                      120, 0.2)
        assert first and first["step"] >= 2, fleet.health()
        v = _img((16, 16, 16), seed=2)
        for _ in range(3):
            np.testing.assert_allclose(fleet.request(v, timeout_s=120),
                                       np.fft.rfftn(v), rtol=1e-4,
                                       atol=1e-3)
        h = _wait(lambda: (lambda h: h if (
            h["counters"]["worker_restarts"] >= 1 and h.get("resident")
            and h["resident"].get("restored_from")) else None)(
                fleet.health()), 120, 0.2)
        assert h, fleet.health()
        assert h["status"] == "degraded"
        w = h["workers"]["worker-0"]
        assert (w["devices"], w["full_devices"], w["followers"]) == (1, 2, [])
        assert h["resident"]["restored_from"] >= 2
        assert h["counters"]["worker_deaths"] == 1
        pids = fleet.process_ids()
    finally:
        monkeypatch.delenv("DFFT_FAULT_SPEC", raising=False)
        fleet.close(drain=False)
    assert len(pids) == 3 and _none_alive(pids)
    names = _event_names(obs_dir)
    for want in ("inject.worker_devloss", "fleet.worker_shrunk",
                 "persist.degraded_restore", "persist.resident_restored",
                 "fleet.worker_join"):
        assert want in names, f"missing {want} in {sorted(names)}"
