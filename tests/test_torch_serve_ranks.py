"""The port's serving layer over P = 4 ranks (one gloo world, the
leader/follower protocol of ``serve/server.py``), where the JAX suite
serves from one process on an 8-device mesh (``tests/test_serve.py``'s
multi-device cases):

* a served volume is bit-identical to the direct plans: r2c through the
  slab default, c2c through the 2 x 2 pencil override, both directions;
  volumes never coalesce;
* coalesced images (``shard="batch"``) are bit for bit their single-shot
  replies, and ``shard="x"`` images match the JAX server on the 4-device
  mesh within 1e-5;
* the chaos drill on ``shard="x"`` with guards enforced: under
  ``wire:nan`` the circuit opens after K failures, rejects at admission,
  and the half-open probe closes it once the fault clears; a malformed
  spec in the probe releases its slot; under ``wire:bitflip`` a probe
  failure re-opens; under ``wire:bitflip,server:slow:40`` load sheds —
  every failure one verdict on every rank (each follower counts exactly
  the leader's failed batches), and the ``serve.*`` evidence appears;
* a CPU ``capture_stage_profile`` of the 4-rank slab plan charges every
  declared node (local_fft:1, exchange:1, local_fft:2);
* no rank imports JAX.
"""

import os
import pickle
import sys
import time
import traceback

import numpy as np
import pytest
import torch

import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch.parallel import multihost

P = 4
FORBIDDEN = ("jax", "jaxlib", "distributedfft_tpu")
SEED = 21


def _img(shape, seed):
    return np.random.default_rng(seed).random(shape, dtype=np.float64) \
        .astype(np.float32)


def _volumes():
    rng = np.random.default_rng(5)
    v = rng.random((16, 16, 16), dtype=np.float64).astype(np.float32)
    z = (rng.random((16, 16, 16)) + 1j * rng.random((16, 16, 16))) \
        .astype(np.complex64)
    return v, z


def _x_images():
    return [_img((16, 12), SEED + i) for i in range(3)]


# ---------------------------------------------------------------------------
# the ranks (no JAX here)
# ---------------------------------------------------------------------------

def _volume(rank):
    """Direct plans first (every rank), then the server over the world."""
    from distributedfft_tpu_torch.serve import Server
    v, z = _volumes()
    g = tdfft.GlobalSize(16, 16, 16)
    plan = tdfft.SlabFFTPlan(g, tdfft.SlabPartition(P), tdfft.Config(),
                             device="cpu")
    ref = plan.crop_spectral(plan.exec_r2c(plan.pad_input(v)))
    ref_back = plan.crop_real(plan.exec_c2r(plan.pad_spectral(ref)))
    pplan = tdfft.PencilFFTPlan(g, tdfft.PencilPartition(2, 2),
                                tdfft.Config(), transform="c2c",
                                device="cpu")
    refz = pplan.crop_spectral(pplan.exec_c2c(pplan.pad_input(z)))
    refz_back = pplan.crop_real(pplan.exec_c2c_inv(
        pplan.pad_spectral(refz)))
    out = {}
    with Server(tdfft.SlabPartition(P), device="cpu") as s:
        if s.leader:
            got = s.request(v, "r2c")
            back = s.request(got, "r2c", "inverse", ny=16)
            gotz = s.request(z, "c2c", decomp="pencil")
            backz = s.request(gotz, "c2c", "inverse", decomp="pencil")
            h = s.health()
            out = {"fwd": np.array_equal(got, ref),
                   "inv": np.array_equal(back, ref_back),
                   "fwd_z": np.array_equal(gotz, refz),
                   "inv_z": np.array_equal(backz, refz_back),
                   "coalesced": h["counters"]["coalesced"],
                   "keys": h["plan_cache"]["keys"]}
    out["role_batches"] = s.health()["counters"]["batches"]
    return out


def _images(rank, group):
    """shard='batch' coalescing at P = 4, and shard='x' replies."""
    from distributedfft_tpu_torch.serve import Server
    imgs = [_img((24, 24), seed=i) for i in range(5)]
    out = {}
    with Server(tdfft.SlabPartition(P), group=group, max_coalesce=1,
                device="cpu") as s1:
        if s1.leader:
            out["seq"] = [s1.request(x) for x in imgs]
    with Server(tdfft.SlabPartition(P), group=group, max_coalesce=8,
                device="cpu") as s2:
        if s2.leader:
            s2.submit(np.zeros((8, 8), np.float32))
            futs = [s2.submit(x) for x in imgs]
            got = [f.result(120) for f in futs]
            out["bit_equal"] = all(np.array_equal(a, b)
                                   for a, b in zip(out.pop("seq"), got))
            out["coalesced"] = s2.health()["counters"]["coalesced"]
    with Server(tdfft.SlabPartition(P), group=group, shard="x",
                device="cpu") as s3:
        if s3.leader:
            xs = _x_images()
            fwd = [s3.request(x) for x in xs]
            out["x_fwd"] = fwd
            out["x_inv"] = [s3.request(c, "r2c", "inverse", ny=12)
                            for c in fwd]
    return out


def _chaos(rank, group):
    """The JAX chaos cases on shard='x' with guards enforced, every env
    change agreed by a world barrier before the leader submits."""
    from distributedfft_tpu_torch import obs
    from distributedfft_tpu_torch.obs import flightrec
    from distributedfft_tpu_torch.resilience import circuit as rc
    from distributedfft_tpu_torch.resilience import inject
    from distributedfft_tpu_torch.resilience.guards import GuardViolation
    from distributedfft_tpu_torch.serve import (Overloaded, Server,
                                                request_key)
    import torch.distributed as dist

    def setenv(spec):
        """Every rank finishes the phase before the fault changes, and
        changes it before the leader submits again."""
        dist.barrier()
        if spec is None:
            os.environ.pop(inject.ENV_VAR, None)
        else:
            os.environ[inject.ENV_VAR] = spec
        dist.barrier()

    def server(**kw):
        cfg = tdfft.Config(guards="enforce",
                           comm_method=tdfft.CommMethod.ALL2ALL)
        return Server(tdfft.SlabPartition(P), cfg, group=group, shard="x",
                      circuit_k=3, circuit_cooldown_s=0.25, device="cpu",
                      **kw)

    obs.reset()
    flightrec.clear()
    out = {}
    x = _img((16, 16), 0)
    key = request_key(16, 16, "f32", "r2c", "x")
    # (a) wire:nan opens the circuit; it recovers after the cooldown.
    setenv("wire:nan")
    s = server()
    a = {}
    if s.leader:
        errs = []
        for _ in range(3):
            try:
                s.request(x, "r2c")
            except GuardViolation as e:
                errs.append(type(e).__name__)
        a["errors"] = errs
        h = s.health()
        a["degraded"] = h["status"] == "degraded"
        a["open"] = h["circuits"][key]["state"] == "open"
        try:
            s.request(x, "r2c")
        except rc.CircuitOpen as e:
            a["rejected_key"] = e.key
        a["cache_after_open"] = s.health()["plan_cache"]["size"]
    setenv(None)
    if s.leader:
        time.sleep(0.3)
        a["recovered_shape"] = s.request(x, "r2c").shape
        h = s.health()
        a["status"] = h["status"]
        a["closed"] = h["circuits"][key]["state"] == "closed"
        a["metrics"] = {k: obs.metrics.counter_value(f"serve.circuit.{k}")
                        for k in ("opened", "closed", "rejected")}
    s.close()
    a["failures"] = s.health()["counters"]["batch_failures"]
    out["nan"] = a
    # (b) a malformed spec inside the probe releases its slot.
    setenv("wire:nan")
    s = server()
    b = {}
    if s.leader:
        for _ in range(3):
            try:
                s.request(x, "r2c")
            except GuardViolation:
                pass
        time.sleep(0.3)
    setenv("totally bogus")
    if s.leader:
        try:
            s.request(x, "r2c")
        except ValueError:
            b["probe_crashed"] = True
    setenv(None)
    if s.leader:
        b["shape"] = s.request(x, "r2c").shape
        b["status"] = s.health()["status"]
    s.close()
    b["failures"] = s.health()["counters"]["batch_failures"]
    out["probe_released"] = b
    # (c) a probe that fails re-opens; (d) load sheds under a straggler.
    obs.reset()
    setenv("wire:bitflip,server:slow:40")
    s = server(max_queue=2, latency_budget_ms=1e9)
    c = {}
    if s.leader:
        n_guard = 0
        for _ in range(3):
            try:
                s.request(x, "r2c")
            except GuardViolation:
                n_guard += 1
        c["guard_failures"] = n_guard
        c["degraded"] = s.health()["status"] == "degraded"
        time.sleep(0.3)
        try:
            s.request(x, "r2c")
        except GuardViolation:
            c["probe_failed"] = True
        c["reopened_state"] = s.health()["circuits"][key]["state"]
        c["reopened"] = obs.metrics.counter_value("serve.circuit.reopened")
        # another key under the same straggler: the queue bound sheds
        shed, futs = 0, []
        for i in range(8):
            try:
                futs.append(s.submit(_img((16, 12), 30 + i), "r2c"))
            except Overloaded:
                shed += 1
            except rc.CircuitOpen:
                pass
        outcomes = []
        for f in futs:
            try:
                f.result(120)
                outcomes.append("ok")
            except GuardViolation:
                outcomes.append("guard")
            except Exception as e:  # noqa: BLE001 — recorded
                outcomes.append(type(e).__name__)
        c["shed"] = shed
        c["outcomes"] = outcomes
        c["slow"] = obs.metrics.counter_value("inject.server_slow")
    setenv(None)
    s.close()
    c["failures"] = s.health()["counters"]["batch_failures"]
    names = {r["name"] for r in flightrec.snapshot()}
    c["evidence"] = sorted(n for n in names if n.startswith("serve."))
    out["bitflip"] = c
    return out


def _capture(rank):
    from distributedfft_tpu_torch.obs import profile
    plan = tdfft.SlabFFTPlan(tdfft.GlobalSize(16, 16, 16),
                             tdfft.SlabPartition(P), tdfft.Config(),
                             device="cpu")
    return {d: profile.capture_stage_profile(plan, d, iters=2)
            for d in ("forward", "inverse")}


def _rank_main(rank, addr, outdir):
    multihost.maybe_initialize(addr, P, rank, backend="gloo", timeout_s=180)
    torch.set_num_threads(1)    # four ranks on the host's cores, no more
    import torch.distributed as dist
    group = dist.new_group(list(range(P)))
    results = {}
    for name, fn in (("capture", lambda: _capture(rank)),
                     ("volume", lambda: _volume(rank)),
                     ("images", lambda: _images(rank, group)),
                     ("chaos", lambda: _chaos(rank, group))):
        try:
            results[name] = fn()
        except Exception:  # noqa: BLE001 — reported by that case's test
            results[name] = {"error": traceback.format_exc()}
        dist.barrier()
    results["modules"] = sorted(m for m in sys.modules
                                if m.split(".")[0] in FORBIDDEN)
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    multihost.shutdown()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("serve_ranks")
    torch.multiprocessing.start_processes(
        _rank_main, args=(multihost.local_coordinator(), str(outdir)),
        nprocs=P, start_method="spawn")
    out = []
    for r in range(P):
        with open(outdir / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _result(world, rank, key):
    res = world[rank][key]
    if isinstance(res, dict) and "error" in res:
        pytest.fail(f"rank {rank} failed {key}:\n{res['error']}")
    return res


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def test_served_volume_bit_identical_to_direct_plans(world):
    r = _result(world, 0, "volume")
    assert r["fwd"] and r["inv"] and r["fwd_z"] and r["inv_z"]
    assert r["coalesced"] == 0  # volumes never coalesce
    assert any(k.startswith("fft3d/16x16x16/f32/r2c/slab")
               for k in r["keys"])
    assert any("/c2c/pencil" in k for k in r["keys"])
    # each follower executed every batch the leader posted
    batches = [_result(world, k, "volume")["role_batches"] for k in range(P)]
    assert batches[1:] == [batches[0]] * (P - 1) and batches[0] == 4


def test_coalesced_bit_identical_to_single_shot(world):
    r = _result(world, 0, "images")
    assert r["bit_equal"] and r["coalesced"] >= 2


def test_shard_x_replies_match_the_jax_server(world, devices):
    import distributedfft_tpu as jdfft
    from distributedfft_tpu.serve import Server as JServer
    r = _result(world, 0, "images")
    with JServer(jdfft.SlabPartition(P), shard="x",
                 latency_budget_ms=1e9) as js:
        for x, got, back in zip(_x_images(), r["x_fwd"], r["x_inv"]):
            want = np.asarray(js.request(x))
            assert got.shape == want.shape
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
            wback = np.asarray(js.request(want, "r2c", "inverse", ny=12))
            assert np.abs(back - wback).max() <= 1e-5 * np.abs(wback).max()
    np.testing.assert_allclose(r["x_fwd"][0], np.fft.rfft2(_x_images()[0]),
                               rtol=1e-4, atol=5e-3)


def test_circuit_opens_on_injected_faults_and_recovers(world):
    a = _result(world, 0, "chaos")["nan"]
    assert a["errors"] == ["GuardViolation"] * 3
    assert a["degraded"] and a["open"]
    assert a["rejected_key"] == "fft2d/16x16/f32/r2c/x"
    assert a["cache_after_open"] == 0   # the poisoned plan was dropped
    assert a["recovered_shape"] == (16, 9)
    assert a["status"] == "ok" and a["closed"]
    assert a["metrics"]["opened"] == 1 and a["metrics"]["closed"] == 1
    assert a["metrics"]["rejected"] >= 1
    # one verdict on every rank: each follower failed the same 3 batches
    assert [_result(world, k, "chaos")["nan"]["failures"]
            for k in range(P)] == [3] * P


def test_probe_slot_released_on_injector_crash(world):
    b = _result(world, 0, "chaos")["probe_released"]
    assert b["probe_crashed"] and b["shape"] == (16, 9)
    assert b["status"] == "ok"
    # the crashed probe was never posted: every rank failed the same 3
    assert [_result(world, k, "chaos")["probe_released"]["failures"]
            for k in range(P)] == [3] * P


def test_circuit_probe_failure_reopens_and_load_sheds(world):
    c = _result(world, 0, "chaos")["bitflip"]
    assert c["guard_failures"] == 3 and c["degraded"]
    assert c["probe_failed"] and c["reopened_state"] == "open"
    assert c["reopened"] == 1
    assert c["shed"] >= 1 and c["slow"] >= 1
    # every admitted batch fails its guard or meets the opened circuit
    assert "guard" in c["outcomes"]
    assert set(c["outcomes"]) <= {"guard", "CircuitOpen"}
    fails = [_result(world, k, "chaos")["bitflip"]["failures"]
             for k in range(P)]
    assert fails[1:] == [fails[0]] * (P - 1)
    for name in ("serve.admit", "serve.coalesce", "serve.execute",
                 "serve.batch_failed", "serve.shed", "serve.reply"):
        assert name in c["evidence"], name


def test_four_rank_capture_attributes_every_node(world):
    for k in range(P):
        cap = _result(world, k, "capture")
        for d in ("forward", "inverse"):
            scopes = cap[d]["scopes"]
            assert {"slab/local_fft:1", "slab/exchange:1",
                    "slab/local_fft:2"} <= set(scopes), (k, d, scopes)
            assert all(v > 0 for v in scopes.values())


def test_ranks_import_no_jax(world):
    assert all(w["modules"] == [] for w in world)
