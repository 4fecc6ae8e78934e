"""The port's wisdom store (``utils/wisdom.py``) against the JAX package's:
the cases of ``tests/test_wisdom.py`` (store round trips, key sensitivity,
damage, migration, concurrent writers, "auto" plans racing once then
hitting, fresh processes, the executables' flags), the keys, store files,
folds and agreement vectors equal to JAX's, the demotion stamp and its
TTL, and — in one 4-rank gloo world — the comm and wire races of every
plan family over ranks, each rank resolving rank 0's Config."""

import dataclasses as dc
import importlib
import json
import os
import pickle
import subprocess
import sys
import textwrap
import traceback

import numpy as np
import pytest
import torch

import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch import params as tp
from distributedfft_tpu_torch.parallel import multihost
from distributedfft_tpu_torch.utils import wisdom

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = 4
FORBIDDEN = ("jax", "jaxlib", "distributedfft_tpu")
CPU = "cpu"

VALID_LOCAL = {"fft_backend": "xla", "mxu_precision": None,
               "mxu_direct_max": None}
VALID_COMM = {"comm_method": "All2All", "comm_method2": None, "opt": 1,
              "send_method": None, "streams_chunks": None}
# The device part of each package's keys.
FINGERPRINT = {"platform", "device_kind", "jax", "torch", "cuda"}


def _no_ts(rec):
    rec = dict(rec or {})
    rec.pop("recorded_at", None)
    return rec


def _key(**kw):
    return wisdom.plan_key(device=CPU, **kw)


# ---------------------------------------------------------------------------
# keys, records, folds and vectors against the JAX package
# ---------------------------------------------------------------------------

def _jax():
    import distributedfft_tpu as jdfft
    from distributedfft_tpu import params as jp
    from distributedfft_tpu.utils import wisdom as jw
    return jdfft, jp, jw


def _parts(key):
    return {k: v for k, v in json.loads(key).items() if k not in FINGERPRINT}


KEY_CASES = [
    dict(kind="slab", shape=(16, 16, 16), dp=False, part=("slab", 1)),
    dict(kind="slab", shape=(16, 24, 8), dp=True, part=("slab", 4),
         sequence="Z_Then_YX"),
    dict(kind="slab", shape=(8, 8, 8), dp=False, part=("slab", 2),
         sequence="Y_Then_ZX", transform="c2c"),
    dict(kind="pencil", shape=(16, 16, 16), dp=False, part=("pencil", 2, 2)),
    dict(kind="pencil", shape=(12, 20, 14), dp=True, part=("pencil", 1, 4),
         dims=2),
    dict(kind="batched2d", shape=(3, 32, 32), dp=False, part=("slab", 4),
         variant="x", dims=2),
    dict(kind="batched2d", shape=(4, 16, 16), dp=False, part=("slab", 2),
         variant="batch", dims=2, transform="c2c"),
]


def _partition(mod, spec):
    if spec[0] == "pencil":
        return mod.PencilPartition(spec[1], spec[2])
    return mod.SlabPartition(spec[1])


@pytest.mark.parametrize("case", KEY_CASES,
                         ids=[f"{c['kind']}{i}" for i, c in
                              enumerate(KEY_CASES)])
def test_plan_key_matches_jax(case):
    jdfft, jp, jw = _jax()
    kw = dict(transform=case.get("transform", "r2c"),
              sequence=case.get("sequence"), variant=case.get("variant"),
              dims=case.get("dims", 3))
    mine = wisdom.plan_key(case["kind"], case["shape"], case["dp"],
                           _partition(tp, case["part"]), tp.FFTNorm.NONE,
                           device=CPU, **kw)
    theirs = jw.plan_key(case["kind"], case["shape"], case["dp"],
                         _partition(jdfft, case["part"]), jp.FFTNorm.NONE,
                         **kw)
    assert _parts(mine) == _parts(theirs)
    fp = {k: v for k, v in json.loads(mine).items() if k in FINGERPRINT}
    assert fp == {"platform": "cpu", "device_kind": "cpu",
                  "torch": torch.__version__,
                  "cuda": str(torch.version.cuda)}


def test_local_key_matches_jax():
    _, _, jw = _jax()
    for shape, dp in (((8, 8, 8), False), ((4, 6, 10), True)):
        assert _parts(wisdom.local_key(shape, dp, CPU)) == \
            _parts(jw.local_key(shape, dp))


def test_plan_key_sensitivity():
    base = dict(kind="slab", global_shape=(16, 16, 16), double_prec=False,
                partition=tp.SlabPartition(2), norm=tp.FFTNorm.NONE)
    k0 = _key(**base)
    assert _key(**dict(base, global_shape=(16, 16, 32))) != k0
    assert _key(**dict(base, double_prec=True)) != k0
    assert _key(**dict(base, partition=tp.SlabPartition(4))) != k0
    assert _key(**dict(base, norm=tp.FFTNorm.ORTHO)) != k0
    assert _key(**dict(base, transform="c2c")) != k0
    assert _key(**dict(base, sequence="Z_Then_YX")) != k0
    assert _key(**dict(base, dims=2)) != k0
    assert _key(**base) == k0
    # The device is part of the key: a CPU store misses on the card.
    assert json.loads(k0)["platform"] == "cpu"


def _candidates(mod, pm):
    c = mod.CommCandidate
    return [c(pm.CommMethod.ALL2ALL, None, 0),
            c(pm.CommMethod.PEER2PEER, pm.CommMethod.ALL2ALL, 1,
              send=pm.SendMethod.STREAMS, chunks=4, wire="bf16"),
            c(pm.CommMethod.ALL2ALL, None, 0, send=pm.SendMethod.RING_OVERLAP,
              depth=4, subblocks=2, wire="native"),
            c(pm.CommMethod.ALL2ALL, None, 1, send=pm.SendMethod.SYNC,
              subblocks=2)]


def test_records_match_jax():
    jdfft, jp, jw = _jax()
    from distributedfft_tpu.testing import autotune as jat
    from distributedfft_tpu_torch.testing import autotune as at
    times = [(1.25, 2.5), (0.5, 0.75), (3.0, 1.0), (2.0, 2.0)]
    errs = [float("nan"), 3.2e-3, float("nan"), float("nan")]
    bases = [(tp.Config(), jdfft.Config()),
             (tp.Config(send_method=tp.SendMethod.STREAMS, streams_chunks=8,
                        wire_dtype="bf16", wire_error_budget=5e-2),
              jdfft.Config(send_method=jp.SendMethod.STREAMS,
                           streams_chunks=8, wire_dtype="bf16",
                           wire_error_budget=5e-2))]
    for (bt, bj) in bases:
        for mine, theirs, (f, i), e in zip(_candidates(at, tp),
                                           _candidates(jat, jp), times,
                                           errs):
            mine.fwd_ms, mine.inv_ms, mine.wire_rel_err = f, i, e
            theirs.fwd_ms, theirs.inv_ms, theirs.wire_rel_err = f, i, e
            assert wisdom.comm_record(mine, bt) == \
                jw.comm_record(theirs, bj)
            assert wisdom.comm_record(mine) == jw.comm_record(theirs)
            assert wisdom.wire_record(mine, 2e-2) == \
                jw.wire_record(theirs, 2e-2)
    for backend, prec, dm in (("pallas", None, None),
                              ("matmul", "high", 1024)):
        m = at.Candidate(backend, prec, dm, per_iter_ms=1.234567,
                         rel_err=3.21e-6, ok=True)
        t = jat.Candidate(backend, prec, dm, per_iter_ms=1.234567,
                          rel_err=3.21e-6, ok=True)
        assert wisdom.local_fft_record(m) == jw.local_fft_record(t)


COMM_RECS = [
    VALID_COMM,
    dict(VALID_COMM, comm_method="Peer2Peer", comm_method2="All2All",
         send_method="Streams", streams_chunks=4, wire_dtype="bf16",
         wire_raced=True, wire_rel_err=3e-3, wire_budget=2e-2),
    dict(VALID_COMM, send_method="RingOverlap", overlap_depth=4,
         overlap_subblocks=2, wire_dtype="native", wire_raced=True,
         wire_budget=2e-2),
    dict(VALID_COMM, wire_dtype="bf16", wire_raced=True, wire_rel_err=5e-2),
    dict(VALID_COMM, wire_dtype="native", wire_raced=False),
    dict(VALID_COMM, demoted=True, demoted_at="2020-01-01T00:00:00Z"),
    dict(VALID_COMM, demoted=True),
    dict(VALID_COMM, opt=7), dict(VALID_COMM, comm_method="CarrierPigeon"),
    dict(VALID_COMM, overlap_depth=1), dict(VALID_COMM, wire_dtype="fp8"),
    dict(VALID_COMM, send_method="Streams", streams_chunks=0),
]


@pytest.mark.parametrize("i", range(len(COMM_RECS)))
def test_comm_folds_match_jax(i, monkeypatch):
    jdfft, jp, jw = _jax()
    monkeypatch.setenv("DFFT_DEMOTION_TTL_S", "86400")
    rec = COMM_RECS[i]
    norm_t = dc.replace(tp.Config(), overlap_depth=tp.AUTO)
    norm_j = dc.replace(jdfft.Config(), overlap_depth=jp.AUTO)
    for race_wire in (False, True):
        for budget in (1e-2, 2e-2, 1e-1):
            mine, why = wisdom._comm_hit_fold(norm_t, rec, race_wire, budget)
            theirs, jwhy = jw._comm_hit_fold(norm_j, rec, race_wire, budget)
            assert why == jwhy
            if theirs is None:
                assert mine is None
            else:
                assert mine == tp.config_from_reference(
                    dc.asdict(theirs))


@pytest.mark.parametrize("rec", [
    {"wire_dtype": "bf16", "wire_rel_err": 1e-3},
    {"wire_dtype": "bf16"}, {"wire_dtype": "native", "wire_budget": 2e-2},
    {"wire_dtype": "native"}, {"wire_dtype": "fp8"},
    {"wire_dtype": "bf16", "wire_rel_err": 1e-3, "demoted": True}],
    ids=["bf16", "bf16-no-err", "native-budget", "native", "stale",
         "demoted"])
def test_wire_and_local_folds_match_jax(rec):
    jdfft, jp, jw = _jax()
    for budget in (5e-4, 2e-2, 5e-2):
        mine, why = wisdom._wire_hit_fold(tp.Config(), rec, budget)
        theirs, jwhy = jw._wire_hit_fold(jdfft.Config(), rec, budget)
        assert why == jwhy
        assert (mine is None) == (theirs is None)
        if theirs is not None:
            assert mine.wire_dtype == theirs.wire_dtype
    for lrec in (VALID_LOCAL, {"fft_backend": "matmul",
                               "mxu_precision": "high",
                               "mxu_direct_max": 1024},
                 {"fft_backend": "cufft"},
                 {"fft_backend": "xla", "mxu_precision": "bogus"},
                 {"fft_backend": "xla", "mxu_direct_max": -3}):
        assert wisdom._valid_local_rec(lrec) == jw._valid_local_rec(lrec)
        if jw._valid_local_rec(lrec):
            assert wisdom._fold_local_rec(tp.Config(), lrec) == \
                tp.config_from_reference(dc.asdict(
                    jw._fold_local_rec(jdfft.Config(), lrec)))


def _captured_vec(monkeypatch, fn):
    """The int64 vector a JAX multihost agreement broadcasts (its
    ``broadcast_one_to_all`` replaced by the identity that keeps it)."""
    import jax
    from jax.experimental import multihost_utils
    seen = []

    def bcast(v):
        seen.append(np.asarray(v))
        return v

    monkeypatch.setattr(multihost_utils, "broadcast_one_to_all", bcast)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    out = fn()
    return seen[-1], out


FOLDED = [
    dict(),
    dict(comm_method="PEER2PEER", comm_method2="ALL2ALL", opt=1,
         send_method="STREAMS", streams_chunks=4),
    dict(send_method="RING_OVERLAP", overlap_depth=8, overlap_subblocks=2,
         wire_dtype="bf16"),
    dict(send_method="MPI_TYPE", fft_backend="matmul", mxu_precision="high",
         mxu_direct_max=1024),
]


def _cfgs(kw):
    jdfft, jp, _ = _jax()
    out = []
    for mod in (tp, jp):
        k = dict(kw)
        for f, enum in (("comm_method", "CommMethod"),
                        ("comm_method2", "CommMethod"),
                        ("send_method", "SendMethod")):
            if f in k:
                k[f] = getattr(getattr(mod, enum), k[f])
        out.append(mod.Config(**k))
    return out


@pytest.mark.parametrize("kw", FOLDED, ids=["default", "p2p-streams",
                                            "ring-ovl", "matmul"])
def test_agreement_vectors_match_jax(monkeypatch, kw):
    _, _, jw = _jax()
    mine, theirs = _cfgs(kw)
    vec, back = _captured_vec(monkeypatch,
                              lambda: jw._broadcast_comm_hit(theirs, theirs))
    assert wisdom._comm_hit_vec(mine).tolist() == vec.tolist()
    assert wisdom._comm_hit_from_vec(vec, mine) == \
        tp.config_from_reference(dc.asdict(back))
    vec, back = _captured_vec(monkeypatch,
                              lambda: jw._agree_across_processes(theirs))
    assert wisdom._resolved_vec(mine).tolist() == vec.tolist()
    assert wisdom._config_from_vec(mine, vec) == \
        tp.config_from_reference(dc.asdict(back))
    code, _ = _captured_vec(monkeypatch,
                            lambda: jw._broadcast_wire_hit(theirs, theirs))
    assert int(code) == wisdom._WIRE_CONCRETE.index(mine.wire_dtype)
    miss, _ = _captured_vec(monkeypatch,
                            lambda: jw._broadcast_comm_hit(None, theirs))
    assert wisdom._comm_hit_vec(None).tolist() == miss.tolist()
    assert wisdom._comm_hit_from_vec(miss, mine) is None


def test_describe_comm_matches_jax():
    _, _, jw = _jax()
    for kw in FOLDED + [dict(send_method="RING"),
                        dict(overlap_subblocks=3)]:
        mine, theirs = _cfgs(kw)
        assert wisdom._describe_comm(mine) == jw._describe_comm(theirs)


@pytest.mark.parametrize("case", KEY_CASES,
                         ids=[f"{c['kind']}{i}" for i, c in
                              enumerate(KEY_CASES)])
def test_race_shape_matches_jax(case):
    jdfft, _, jw = _jax()
    g = case["shape"]
    assert wisdom._race_shape(case["kind"], tp.GlobalSize(*g),
                              _partition(tp, case["part"]),
                              case.get("variant")) == \
        jw._race_shape(case["kind"], jdfft.GlobalSize(*g),
                       _partition(jdfft, case["part"]), case.get("variant"))


# ---------------------------------------------------------------------------
# the store file: the same bytes' meaning in both packages
# ---------------------------------------------------------------------------

LEGACY = {"k1": {"local_fft": VALID_LOCAL, "comm": VALID_COMM},
          "k2": {"comm": VALID_COMM},
          "k3": "damaged", "k4": {"wire": {"wire_dtype": "bf16"}}}


@pytest.mark.parametrize("version", [1, 2, 3, 4, 5, 6])
def test_store_and_migration_match_jax(tmp_path, version):
    _, _, jw = _jax()
    p = tmp_path / "w.json"
    p.write_text(json.dumps({"version": version, "entries": LEGACY}))
    assert wisdom.WisdomStore(str(p)).load() == \
        jw.WisdomStore(str(p)).load()
    assert wisdom.WisdomStore(str(p)).raw_version() == version
    # One record through each package: the files read the same.
    q = tmp_path / "q.json"
    q.write_text(p.read_text())
    stamp = {"recorded_at": "2026-01-01T00:00:00Z"}
    assert wisdom.WisdomStore(str(p)).record("k5", "comm",
                                             dict(VALID_COMM, **stamp))
    assert jw.WisdomStore(str(q)).record("k5", "comm",
                                         dict(VALID_COMM, **stamp))
    assert json.loads(p.read_text()) == json.loads(q.read_text())
    assert p.read_text() == q.read_text()


def test_store_hit_miss_record_roundtrip(tmp_path):
    store = wisdom.WisdomStore(str(tmp_path / "sub" / "w.json"))
    key = wisdom.local_key((8, 8, 8), False, CPU)
    assert store.lookup(key, "local_fft") is None
    assert store.record(key, "local_fft", VALID_LOCAL)
    assert _no_ts(store.lookup(key, "local_fft")) == VALID_LOCAL
    assert store.record(key, "comm", VALID_COMM)
    assert _no_ts(store.lookup(key, "local_fft")) == VALID_LOCAL
    assert _no_ts(store.lookup(key, "comm")) == VALID_COMM
    assert store.lookup(key, "wire") is None
    raw = json.loads((tmp_path / "sub" / "w.json").read_text())
    assert raw["version"] == wisdom.WISDOM_VERSION


def test_open_store_resolution(tmp_path, monkeypatch):
    monkeypatch.delenv("DFFT_WISDOM", raising=False)
    assert wisdom.open_store() is None
    assert wisdom.open_store(str(tmp_path / "a.json")).path.endswith("a.json")
    monkeypatch.setenv("DFFT_WISDOM", str(tmp_path / "env.json"))
    assert wisdom.open_store().path.endswith("env.json")
    assert wisdom.open_store(str(tmp_path / "a.json")).path.endswith(
        "a.json")
    assert wisdom.open_store(enabled=False) is None
    assert wisdom.store_for_config(tp.Config(use_wisdom=False)) is None
    assert wisdom.store_for_config(
        tp.Config(wisdom_path=str(tmp_path / "c.json"))).path.endswith(
            "c.json")


@pytest.mark.parametrize("payload", [
    "{not json at all", "", json.dumps([1, 2, 3]),
    json.dumps({"version": 999, "entries": {"k": {}}}),
    json.dumps({"version": wisdom.WISDOM_VERSION, "entries": []}),
    json.dumps({"version": wisdom.WISDOM_VERSION})])
def test_corrupt_store_reads_empty_and_recovers(tmp_path, payload):
    p = tmp_path / "w.json"
    p.write_text(payload)
    store = wisdom.WisdomStore(str(p))
    assert store.load() == {"version": wisdom.WISDOM_VERSION, "entries": {}}
    key = wisdom.local_key((8, 8, 8), False, CPU)
    assert store.lookup(key, "local_fft") is None
    assert store.record(key, "local_fft", VALID_LOCAL)
    assert _no_ts(store.lookup(key, "local_fft")) == VALID_LOCAL


def test_partial_entry_damage_is_per_key(tmp_path):
    p = tmp_path / "w.json"
    p.write_text(json.dumps({
        "version": wisdom.WISDOM_VERSION,
        "entries": {"kb": "not-a-dict", "kg": {"local_fft": VALID_LOCAL}}}))
    store = wisdom.WisdomStore(str(p))
    assert store.lookup("kb", "local_fft") is None
    assert store.lookup("kg", "local_fft") == VALID_LOCAL
    assert store.record("kb", "comm", VALID_COMM)
    assert _no_ts(store.lookup("kb", "comm")) == VALID_COMM
    assert store.lookup("kg", "local_fft") == VALID_LOCAL


def test_unreadable_store_degrades_on_write(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    store = wisdom.WisdomStore(str(blocker / "sub" / "w.json"))
    key = wisdom.local_key((8, 8, 8), False, CPU)
    assert store.lookup(key, "local_fft") is None
    assert store.record(key, "local_fft", VALID_LOCAL) is False


def test_ring_record_roundtrip():
    from distributedfft_tpu_torch.testing.autotune import CommCandidate
    cand = CommCandidate(tp.CommMethod.ALL2ALL, None, 0,
                         send=tp.SendMethod.RING)
    rec = wisdom.comm_record(cand)
    assert rec["send_method"] == "Ring" and rec["streams_chunks"] is None
    out = wisdom._fold_comm_rec(tp.Config(), rec)
    assert out.send_method is tp.SendMethod.RING
    folded = dc.replace(tp.Config(), send_method=tp.SendMethod.RING)
    back = wisdom._broadcast_comm_hit(folded, tp.Config())  # no world
    assert back.send_method is tp.SendMethod.RING


def test_comm_record_reflects_timed_base():
    from distributedfft_tpu_torch.testing.autotune import CommCandidate
    cand = CommCandidate(tp.CommMethod.ALL2ALL, None, 1)
    base = tp.Config(send_method=tp.SendMethod.STREAMS, streams_chunks=8)
    rec = wisdom.comm_record(cand, base)
    assert rec["send_method"] == "Streams" and rec["streams_chunks"] == 8
    assert wisdom.comm_record(cand)["send_method"] is None
    c2 = CommCandidate(tp.CommMethod.ALL2ALL, None, 0,
                       send=tp.SendMethod.STREAMS, chunks=4)
    assert wisdom.comm_record(c2, base)["streams_chunks"] == 4


# ---------------------------------------------------------------------------
# concurrency
# ---------------------------------------------------------------------------

_WISDOM_PY = os.path.join(REPO, "distributedfft_tpu_torch", "utils",
                          "wisdom.py")

_WRITER = textwrap.dedent("""
    import importlib.util, os, sys
    spec = importlib.util.spec_from_file_location("w", sys.argv[1])
    w = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(w)
    store = w.WisdomStore(os.environ["DFFT_WISDOM"])
    wid = sys.argv[2]
    for i in range(8):
        assert store.record(f"key-{wid}-{i}", "local_fft",
                            {"fft_backend": "xla", "writer": wid})
    print("WROTE", flush=True)
""")


def test_concurrent_fresh_process_writers(tmp_path):
    """Four fresh processes write one store at once, the port's module
    loaded on its own (the lock needs neither the package nor torch):
    every record lands, the file stays valid."""
    env = dict(os.environ)
    env["DFFT_WISDOM"] = str(tmp_path / "w.json")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WRITER, _WISDOM_PY, str(wid)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for wid in range(4)]
    for pr in procs:
        out, err = pr.communicate(timeout=120)
        assert pr.returncode == 0 and "WROTE" in out, err[-800:]
    raw = json.loads((tmp_path / "w.json").read_text())
    assert raw["version"] == wisdom.WISDOM_VERSION
    assert len(raw["entries"]) == 32
    store = wisdom.WisdomStore(env["DFFT_WISDOM"])
    for wid in range(4):
        for i in range(8):
            rec = store.lookup(f"key-{wid}-{i}", "local_fft")
            assert rec is not None and rec["writer"] == str(wid)


def test_stale_lock_is_broken_and_timeout_writes(tmp_path, monkeypatch):
    """``wisdom:stale-lock``: a held lock older than the stale age is
    broken once; past the timeout the write lands unlocked."""
    from distributedfft_tpu_torch import obs
    store = wisdom.WisdomStore(str(tmp_path / "w.json"))
    lock = tmp_path / "w.json.lock"
    lock.write_text("")
    os.utime(lock, (1, 1))
    monkeypatch.setenv("DFFT_FAULT_SPEC", "wisdom:stale-lock")
    monkeypatch.setenv("DFFT_WISDOM_LOCK_TIMEOUT_S", "0.05")
    monkeypatch.setenv("DFFT_WISDOM_LOCK_STALE_S", "60")
    b0 = obs.metrics.counter_value("wisdom.lock_breaks")
    t0 = obs.metrics.counter_value("wisdom.lock_timeouts")
    assert store.record("k", "local_fft", VALID_LOCAL)
    assert obs.metrics.counter_value("wisdom.lock_breaks") == b0 + 1
    assert obs.metrics.counter_value("wisdom.lock_timeouts") == t0 + 1
    assert _no_ts(store.lookup("k", "local_fft")) == VALID_LOCAL


# ---------------------------------------------------------------------------
# construction-time resolution (one process)
# ---------------------------------------------------------------------------

def test_concrete_config_passes_through_untouched():
    cfg = tp.Config()
    out = wisdom.resolve_config("slab", tp.GlobalSize(8, 8, 8),
                                tp.SlabPartition(1), cfg, device=CPU)
    assert out is cfg


def _counting_local_race(monkeypatch, backends=("xla",)):
    from distributedfft_tpu_torch.testing import autotune as at
    from distributedfft_tpu_torch.testing import chaintimer
    calls = []
    real = at.autotune_local_fft

    def counting(shape, *a, **kw):
        calls.append(shape)
        kw["backends"] = backends
        return real(shape, *a, **kw)

    monkeypatch.setattr(at, "autotune_local_fft", counting)
    monkeypatch.setattr(chaintimer, "median_pair_diff_ms",
                        lambda fn1, fnK, x, k, repeats, inner: (0.25, 1e-3))
    return calls


@pytest.mark.parametrize("family", ["slab", "pencil", "batched"])
def test_plan_auto_races_once_then_hits(tmp_path, monkeypatch, family):
    monkeypatch.setenv("DFFT_WISDOM_K", "2")
    calls = _counting_local_race(monkeypatch)
    wpath = str(tmp_path / "w.json")
    cfg = tp.Config(fft_backend="auto", wisdom_path=wpath)

    def build(n=8, c=cfg):
        if family == "slab":
            return tdfft.SlabFFTPlan(tp.GlobalSize(8, 8, n),
                                     tp.SlabPartition(1), c, device=CPU)
        if family == "pencil":
            return tdfft.PencilFFTPlan(tp.GlobalSize(8, 8, n),
                                       tp.PencilPartition(1, 1), c,
                                       device=CPU)
        return tdfft.Batched2DFFTPlan(2, 8, n, tp.SlabPartition(1), c,
                                      device=CPU)

    p1 = build()
    assert len(calls) == 1 and p1.config.fft_backend == "xla"
    p2 = build()
    assert len(calls) == 1 and p2.config == p1.config
    build(16)
    assert len(calls) == 2
    off = dc.replace(cfg, use_wisdom=False)
    build(c=off)
    build(c=off)
    assert len(calls) == 4
    rec = wisdom.WisdomStore(wpath).lookup(wisdom.plan_wisdom_key(p1),
                                           "local_fft")
    assert rec is not None and rec["fft_backend"] == "xla"


def test_stale_stored_record_remeasures(tmp_path, monkeypatch):
    monkeypatch.setenv("DFFT_WISDOM_K", "2")
    calls = _counting_local_race(monkeypatch)
    wpath = str(tmp_path / "w.json")
    g = tp.GlobalSize(8, 8, 8)
    key = _key(kind="slab", global_shape=g.shape, double_prec=False,
               partition=tp.SlabPartition(1), norm=tp.FFTNorm.NONE,
               sequence=tp.SlabSequence.ZY_THEN_X)
    store = wisdom.WisdomStore(wpath)
    store.record(key, "local_fft", {"fft_backend": "cufft"})
    cfg = tp.Config(fft_backend="auto", wisdom_path=wpath)
    plan = tdfft.SlabFFTPlan(g, tp.SlabPartition(1), cfg, device=CPU)
    assert len(calls) == 1
    assert plan.config.fft_backend == "xla"
    assert store.lookup(key, "local_fft")["fft_backend"] == "xla"


def test_single_rank_comm_auto_takes_the_defaults(tmp_path, monkeypatch):
    """One rank posts no exchange: comm and wire "auto" resolve to the
    defaults with no race and no store write."""
    from distributedfft_tpu_torch.testing import autotune as at
    monkeypatch.setattr(at, "autotune_comm", None)
    monkeypatch.setattr(at, "autotune_wire", None)
    wpath = tmp_path / "w.json"
    for cfg in (tp.Config(comm_method="auto", wire_dtype="auto",
                          wisdom_path=str(wpath)),
                tp.Config(wire_dtype="auto", wisdom_path=str(wpath))):
        plan = tdfft.SlabFFTPlan(tp.GlobalSize(8, 8, 8), tp.SlabPartition(1),
                                 cfg, device=CPU)
        assert plan.config.comm_method is tp.CommMethod.ALL2ALL
        assert plan.config.wire_dtype == "native"
    batch = tdfft.Batched2DFFTPlan(8, 8, 8, tp.SlabPartition(1),
                                   tp.Config(comm_method="auto",
                                             wisdom_path=str(wpath)),
                                   shard="batch", device=CPU)
    assert batch.config.comm_method is tp.CommMethod.ALL2ALL
    assert not wpath.exists()


def test_unresolved_auto_rejected_by_base_plan():
    from distributedfft_tpu_torch.models.base import DistFFTPlan
    with pytest.raises(ValueError, match="auto"):
        DistFFTPlan(tp.GlobalSize(8, 8, 8), tp.SlabPartition(1),
                    tp.Config(fft_backend="auto"), device=CPU)


def test_peek_config_reports_without_racing(tmp_path, monkeypatch):
    from distributedfft_tpu_torch.testing import autotune as at
    monkeypatch.setattr(at, "autotune_local_fft", None)
    wpath = str(tmp_path / "w.json")
    g = tp.GlobalSize(8, 8, 8)
    cfg = tp.Config(fft_backend="auto", comm_method="auto",
                    wisdom_path=wpath)
    out, prov = wisdom.peek_config("slab", g, tp.SlabPartition(2), cfg,
                                   sequence="ZY_Then_X", device=CPU)
    assert out.fft_backend == "xla"
    assert prov["slots"]["local_fft"]["status"] == "miss"
    assert prov["slots"]["comm"] == {"status": "miss", "reason": "no record",
                                     "record": None}
    wisdom.WisdomStore(wpath).record(prov["key"], "comm", VALID_COMM)
    out, prov = wisdom.peek_config("slab", g, tp.SlabPartition(2), cfg,
                                   sequence="ZY_Then_X", device=CPU)
    assert prov["slots"]["comm"]["status"] == "hit" and out.opt == 1
    assert prov["store_version"] == wisdom.WISDOM_VERSION


# ---------------------------------------------------------------------------
# demotion stamps
# ---------------------------------------------------------------------------

def test_demotion_stamp_and_ttl(tmp_path, monkeypatch):
    store = wisdom.WisdomStore(str(tmp_path / "w.json"))
    assert store.record("k", "comm", dict(VALID_COMM, wire_dtype="native"))
    assert wisdom.stamp_demotion(store, "k", "comm", "send", "boom " * 100)
    rec = store.lookup("k", "comm")
    assert rec["demoted"] and rec["demoted_rung"] == "send"
    assert len(rec["demoted_reason"]) == 300
    assert rec["comm_method"] == "All2All"        # the record kept
    norm = dc.replace(tp.Config(), overlap_depth=tp.AUTO)
    assert wisdom._comm_hit_fold(norm, rec, False, 2e-2) == \
        (None, "record demoted after a runtime failure")
    # The TTL: an old stamp expires and the record reads as a hit again.
    old = dict(rec, demoted_at="2000-01-01T00:00:00Z")
    assert not wisdom.demotion_active(old)
    assert wisdom._comm_hit_fold(norm, old, False, 2e-2)[0] is not None
    monkeypatch.setenv("DFFT_DEMOTION_TTL_S", "0")
    assert wisdom.demotion_active(old)            # <= 0: never expires
    monkeypatch.setenv("DFFT_DEMOTION_TTL_S", "86400")
    assert wisdom.demotion_active(dict(rec, demoted_at="garbage"))
    assert wisdom.demotion_active(dict(rec, demoted_at=None))
    # A bare stamp on an empty slot keeps the why; a fresh record clears it.
    assert wisdom.stamp_demotion(store, "k", "wire", "wire", "drift")
    assert store.lookup("k", "wire")["demoted"]
    assert store.record("k", "comm", VALID_COMM)
    assert "demoted" not in store.lookup("k", "comm")


def test_demotion_matches_jax(monkeypatch):
    _, _, jw = _jax()
    for stamp in ("2000-01-01T00:00:00Z", "garbage", None):
        rec = dict(VALID_COMM, demoted=True, demoted_at=stamp)
        for ttl in ("0", "86400", "1e12"):
            monkeypatch.setenv("DFFT_DEMOTION_TTL_S", ttl)
            assert wisdom.demotion_active(rec) == jw.demotion_active(rec)


def test_ladder_demotion_stamps_the_plans_record(tmp_path, monkeypatch):
    """A rung walk on a plan with a store configured stamps its comm
    record (the ring's "send" rung), and the next resolution of that key
    misses."""
    from distributedfft_tpu_torch.resilience import fallback
    wpath = str(tmp_path / "w.json")
    plan = tdfft.SlabFFTPlan(tp.GlobalSize(8, 8, 8), tp.SlabPartition(1),
                             tp.Config(send_method=tp.SendMethod.RING,
                                       opt=1, wisdom_path=wpath),
                             device=CPU)
    key = wisdom.plan_wisdom_key(plan)
    wisdom.WisdomStore(wpath).record(key, "comm", VALID_COMM)
    assert fallback.demote(plan, RuntimeError("ring failed"))
    rec = wisdom.WisdomStore(wpath).lookup(key, "comm")
    assert rec["demoted"] and "ring failed" in rec["demoted_reason"]
    assert plan.config.send_method is tp.SendMethod.SYNC


# ---------------------------------------------------------------------------
# fresh processes: autotune once, reuse everywhere
# ---------------------------------------------------------------------------

_SEED = textwrap.dedent("""
    from distributedfft_tpu_torch.testing import autotune as at
    from distributedfft_tpu_torch.testing import chaintimer
    real = at.autotune_local_fft
    at.autotune_local_fft = (
        lambda shape, **kw: real(shape, **{**kw, "backends": ("xla",)}))
    chaintimer.median_pair_diff_ms = (
        lambda fn1, fnK, x, k, repeats, inner: (0.25, 1e-3))
    import distributedfft_tpu_torch as tdfft
    plan = tdfft.SlabFFTPlan(tdfft.GlobalSize(8, 8, 8),
                             tdfft.SlabPartition(1),
                             tdfft.Config(fft_backend="auto"), device="cpu")
    assert plan.config.fft_backend == "xla", plan.config.fft_backend
    print("SEEDED", flush=True)
""")

_REUSE = textwrap.dedent("""
    from distributedfft_tpu_torch.testing import autotune as at

    def boom(*a, **kw):
        raise AssertionError("timing race ran on a wisdom hit")

    at.autotune_local_fft = boom
    at.autotune_comm = boom
    import distributedfft_tpu_torch as tdfft
    plan = tdfft.SlabFFTPlan(tdfft.GlobalSize(8, 8, 8),
                             tdfft.SlabPartition(1),
                             tdfft.Config(fft_backend="auto"), device="cpu")
    assert plan.config.fft_backend == "xla", plan.config.fft_backend
    import sys
    assert not any(m.split(".")[0] in ("jax", "distributedfft_tpu")
                   for m in sys.modules)
    print("REUSED", flush=True)
""")


def test_fresh_process_auto_performs_zero_races(tmp_path):
    env = dict(os.environ)
    env.update({"DFFT_WISDOM": str(tmp_path / "w.json"),
                "DFFT_WISDOM_K": "2"})

    def run(code):
        return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                              env=env, capture_output=True, text=True,
                              timeout=240)

    r1 = run(_SEED)
    assert r1.returncode == 0 and "SEEDED" in r1.stdout, r1.stderr[-800:]
    r2 = run(_REUSE)
    assert r2.returncode == 0 and "REUSED" in r2.stdout, r2.stderr[-800:]


# ---------------------------------------------------------------------------
# the executables' flags
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mod", ["slab", "pencil", "batched", "reference"])
def test_cli_accepts_wisdom_flags(mod):
    m = importlib.import_module(f"distributedfft_tpu_torch.cli.{mod}")
    base = ["-nx", "8", "-ny", "8", "-nz", "8"]
    if mod == "pencil":
        base += ["-p1", "2", "-p2", "2"]
    args = m.build_parser().parse_args(base)
    assert args.wisdom is None and args.no_wisdom is False
    args = m.build_parser().parse_args(
        base + ["--wisdom", "/tmp/w.json", "--no-wisdom"])
    assert args.wisdom == "/tmp/w.json" and args.no_wisdom is True
    from distributedfft_tpu_torch.cli.common import config_kwargs
    kw = config_kwargs(args)
    assert kw["wisdom_path"] == "/tmp/w.json" and kw["use_wisdom"] is False


@pytest.mark.parametrize("mod", ["slab", "pencil", "batched", "reference"])
def test_cli_auto_flags_parse_as_jax(mod):
    """``-comm auto`` / ``--fft-backend auto`` / ``-wire auto`` reach the
    Config as "auto", as in the JAX executables."""
    m = importlib.import_module(f"distributedfft_tpu_torch.cli.{mod}")
    base = ["-nx", "8", "-ny", "8", "-nz", "8", "--fft-backend", "auto",
            "-wire", "auto"]
    base += (["-p1", "2", "-p2", "2", "-comm1", "auto", "-comm2", "auto"]
             if mod == "pencil" else ["-comm", "auto"])
    args = m.build_parser().parse_args(base)
    from distributedfft_tpu_torch.cli.common import config_kwargs
    kw = config_kwargs(args)
    assert kw["fft_backend"] == "auto" and kw["wire_dtype"] == "auto"
    comm = args.comm_method1 if mod == "pencil" else args.comm_method
    assert tp.parse_comm_method(comm) == tp.AUTO


# ---------------------------------------------------------------------------
# The 4-rank world: the races over ranks (no JAX in the ranks)
# ---------------------------------------------------------------------------

def _slab_comm(store):
    from distributedfft_tpu_torch import obs
    from distributedfft_tpu_torch.testing import autotune as at
    g = tp.GlobalSize(16, 16, 16)
    cfg = tp.Config(comm_method="auto", wire_dtype="auto", wisdom_path=store)
    c0 = obs.metrics.counter_value("autotune.race_cells")
    p1 = tdfft.SlabFFTPlan(g, tp.SlabPartition(P), cfg, device=CPU)
    c1 = obs.metrics.counter_value("autotune.race_cells")
    p2 = tdfft.SlabFFTPlan(g, tp.SlabPartition(P), cfg, device=CPU)
    c2 = obs.metrics.counter_value("autotune.race_cells")
    x = np.random.default_rng(5).random(g.shape).astype(np.float32)
    got = p2.crop_spectral(p2.exec_r2c(p2.pad_input(x)))
    ranked = at.autotune_comm("slab", g, tp.SlabPartition(P), tp.Config(),
                              iterations=1, warmup=0, device=CPU)
    return {"vec": wisdom._resolved_vec(p1.config).tolist(),
            "same": p2.config == p1.config, "race1": c1 - c0,
            "race2": c2 - c1, "x": x, "spec": got,
            "matrix": [(c.label, c.ok, c.total_ms) for c in ranked],
            "applied": wisdom._resolved_vec(
                at.apply_best_comm(ranked, tp.Config())).tolist()}


def _pencil_comm(store):
    from distributedfft_tpu_torch import obs
    from distributedfft_tpu_torch.testing import autotune as at
    g = tp.GlobalSize(16, 16, 16)
    part = tp.PencilPartition(2, 2)
    out = {}
    for dims in (3, 2):
        cfg = tp.Config(comm_method="auto", comm_method2="auto",
                        wisdom_path=store)
        c0 = obs.metrics.counter_value("autotune.race_cells")
        p1 = tdfft.PencilFFTPlan(g, part, cfg, device=CPU, dims=dims)
        c1 = obs.metrics.counter_value("autotune.race_cells")
        p2 = tdfft.PencilFFTPlan(g, part, cfg, device=CPU, dims=dims)
        out[dims] = {"vec": wisdom._resolved_vec(p1.config).tolist(),
                     "same": p2.config == p1.config, "race1": c1 - c0,
                     "race2": obs.metrics.counter_value(
                         "autotune.race_cells") - c1}
    both = at.autotune_comm("pencil", g, part, tp.Config(), iterations=1,
                            warmup=0, race_opt=False, device=CPU)
    only1 = at.autotune_comm("pencil", g, part, tp.Config(), iterations=1,
                             warmup=0, race_opt=False, dims=2, device=CPU)
    out["both"] = [(c.comm.value, c.comm2.value, c.ok) for c in both]
    out["only1"] = [(c.comm.value, c.comm2, c.ok) for c in only1]
    return out


def _batched_wire(store):
    from distributedfft_tpu_torch import obs
    cfg = tp.Config(comm_method=tp.CommMethod.PEER2PEER, wire_dtype="auto",
                    wisdom_path=store)
    c0 = obs.metrics.counter_value("autotune.race_cells")
    p1 = tdfft.Batched2DFFTPlan(2, 16, 16, tp.SlabPartition(P), cfg,
                                shard="x", device=CPU)
    c1 = obs.metrics.counter_value("autotune.race_cells")
    p2 = tdfft.Batched2DFFTPlan(2, 16, 16, tp.SlabPartition(P), cfg,
                                shard="x", device=CPU)
    return {"wire": p1.config.wire_dtype, "same": p2.config == p1.config,
            "race1": c1 - c0,
            "race2": obs.metrics.counter_value("autotune.race_cells") - c1,
            "comm": p1.config.comm_method.value}


def _split_hit(rank, outdir):
    """Rank 0's store holds a comm record the others' stores lack (and
    the reverse): every rank takes rank 0's decision, hit or race."""
    from distributedfft_tpu_torch import obs
    g = tp.GlobalSize(16, 16, 16)
    out = {}
    for name, seeded in (("rank0-hits", 0), ("rank0-misses", 1)):
        store = os.path.join(outdir, f"{name}-{rank}.json")
        probe = tp.Config(comm_method="auto", wisdom_path=store)
        key = wisdom.plan_key("slab", g.shape, False, tp.SlabPartition(P),
                              tp.FFTNorm.NONE, sequence="ZY_Then_X",
                              device=CPU)
        if (rank == 0) == (seeded == 0):
            wisdom.WisdomStore(store).record(
                key, "comm", dict(VALID_COMM, comm_method="Peer2Peer",
                                  wire_dtype="native"))
        c0 = obs.metrics.counter_value("autotune.race_cells")
        plan = tdfft.SlabFFTPlan(g, tp.SlabPartition(P), probe, device=CPU)
        out[name] = {"vec": wisdom._resolved_vec(plan.config).tolist(),
                     "raced": obs.metrics.counter_value(
                         "autotune.race_cells") - c0}
    return out


def _reference_t4():
    """``dfft-torch-reference -t 4`` over the world: its printed gate."""
    import contextlib
    import io
    from distributedfft_tpu_torch.cli import reference as tref
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tref.main(["-nx", "32", "-ny", "16", "-nz", "16", "-t", "4",
                        "--emulate-devices", str(P)])
    return {"rc": rc, "text": buf.getvalue()}


def _rank_main(rank, addr, outdir):
    multihost.maybe_initialize(addr, P, rank, backend="gloo", timeout_s=180)
    torch.set_num_threads(1)    # four ranks on the host's cores, no more
    # Short construction races: one timed iteration, no warmup.
    wisdom._COMM_ITERATIONS, wisdom._COMM_WARMUP = 1, 0
    shared = os.path.join(outdir, "shared.json")
    results = {}
    for name, fn in (("slab", lambda: _slab_comm(shared)),
                     ("pencil", lambda: _pencil_comm(shared)),
                     ("batched", lambda: _batched_wire(shared)),
                     ("split", lambda: _split_hit(rank, outdir)),
                     ("t4", _reference_t4)):
        try:
            results[name] = fn()
        except Exception:  # noqa: BLE001 — reported by that case's test
            results[name] = {"error": traceback.format_exc()}
    results["modules"] = sorted(m for m in sys.modules
                                if m.split(".")[0] in FORBIDDEN)
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    multihost.shutdown()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("wisdom")
    torch.multiprocessing.start_processes(
        _rank_main, args=(multihost.local_coordinator(), str(outdir)),
        nprocs=P, start_method="spawn")
    out = []
    for r in range(P):
        with open(outdir / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out, outdir


def _result(world, rank, key):
    res = world[0][rank][key]
    if isinstance(res, dict) and "error" in res:
        pytest.fail(f"rank {rank} failed {key}:\n{res['error']}")
    return res


def test_slab_comm_auto_races_once_then_hits_on_every_rank(world):
    rows = [_result(world, r, "slab") for r in range(P)]
    assert all(r["vec"] == rows[0]["vec"] for r in rows)
    assert all(r["race1"] > 0 and r["race2"] == 0 and r["same"]
               for r in rows)
    # The resolved plan's spectrum is the global rfftn (a bf16 winner
    # within the wire's budget).
    ref = np.fft.rfftn(rows[0]["x"])
    assert np.abs(rows[0]["spec"] - ref).max() <= 2e-2 * np.abs(ref).max()
    raw = json.loads((world[1] / "shared.json").read_text())
    recs = [e["comm"] for k, e in raw["entries"].items()
            if json.loads(k)["decomp"].startswith("slab") and "comm" in e]
    assert recs and recs[0]["wire_raced"] is True


def test_comm_race_matrix_and_agreed_winner(world):
    """The slab matrix {A2A, P2P} x opt {0, 1} over 4 ranks: every cell
    ran; rank 0's winner first everywhere, and the same applied Config."""
    rows = [_result(world, r, "slab") for r in range(P)]
    m0 = rows[0]["matrix"]
    assert len(m0) == 4 and all(ok for _, ok, _ in m0)
    totals = [t for _, _, t in m0]
    assert totals == sorted(totals)
    assert all(r["matrix"][0][0] == m0[0][0] for r in rows)
    assert all(r["applied"] == rows[0]["applied"] for r in rows)


def test_pencil_comm_auto_over_row_and_column_groups(world):
    rows = [_result(world, r, "pencil") for r in range(P)]
    for dims in (3, 2):
        assert all(r[dims]["vec"] == rows[0][dims]["vec"] for r in rows)
        assert all(r[dims]["race1"] > 0 and r[dims]["race2"] == 0
                   and r[dims]["same"] for r in rows)
    both = rows[0]["both"]
    assert len(both) == 4 and len({(a, b) for a, b, _ in both}) == 4
    only1 = rows[0]["only1"]
    assert len(only1) == 2 and all(c2 is None for _, c2, _ in only1)


def test_batched_wire_auto_races_native_against_bf16(world):
    rows = [_result(world, r, "batched") for r in range(P)]
    assert all(r["wire"] == rows[0]["wire"] in ("native", "bf16")
               for r in rows)
    assert all(r["race1"] == 2 and r["race2"] == 0 and r["same"]
               and r["comm"] == "Peer2Peer" for r in rows)


def test_per_rank_hits_are_agreed_before_racing(world):
    rows = [_result(world, r, "split") for r in range(P)]
    hit = [r["rank0-hits"] for r in rows]
    assert all(h["vec"] == hit[0]["vec"] and h["raced"] == 0 for h in hit)
    assert hit[0]["vec"][3] == 1        # Peer2Peer: rank 0's record
    miss = [r["rank0-misses"] for r in rows]
    assert all(m["vec"] == miss[0]["vec"] and m["raced"] > 0 for m in miss)


def test_reference_fraction_gate_runs_over_the_world(world):
    t4 = _result(world, 0, "t4")
    assert t4["rc"] == 0 and "All2All fraction:" in t4["text"], t4
    assert all(_result(world, r, "t4")["rc"] == 0 for r in range(P))


def test_ranks_import_no_jax(world):
    assert all(w["modules"] == [] for w in world[0])
