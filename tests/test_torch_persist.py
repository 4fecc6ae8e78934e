"""The port's persistence layer (``persist/``) against the JAX package's:
CRC32C known answers and equality with JAX's checksum (the lanes past
64 KiB included), files written by either package read by the other
(byte for byte the same file at the same clock), every damage class,
rotation and fallback, fingerprint refusals, the mesh-change rules, the
policy and the injected faults; and in one 4-rank gloo world the
bit-exact resume of NS-2D (``shard="x"``) and NS-3D (slab, 16³ float64)
and a JAX-captured NS-3D state restored and stepped once within 1e-12 of
JAX's own step."""

import json
import os
import pickle
import re
import sys
import time
import traceback

import numpy as np
import pytest
import torch

import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch import obs, persist
from distributedfft_tpu_torch.obs import flightrec
from distributedfft_tpu_torch.parallel import multihost
from distributedfft_tpu_torch.persist import (CheckpointCorrupt,
                                              CheckpointMismatch,
                                              CheckpointMissing,
                                              CheckpointPolicy,
                                              CheckpointStore,
                                              CheckpointUnusable, SimState,
                                              crc32c, read_checkpoint,
                                              write_checkpoint)
from distributedfft_tpu_torch.persist import checkpoint as ck

P = 4
FORBIDDEN = ("jax", "jaxlib", "distributedfft_tpu")
NS3D_N, NS2D = 16, (2, 16, 16)
DT, STEPS, EXTRA = 2e-3, 2, 2


def _state(step=1, arr=None, fp=None):
    if arr is None:
        arr = np.arange(24, dtype=np.complex128).reshape(4, 6)
    return SimState(arrays={"field0": arr}, step=step, dt=1e-3,
                    sim_time=step * 1e-3, rng={"seed": 7, "draws": step},
                    plan_fingerprint=fp or {"plan": "T", "shape": [4, 6]},
                    meta={"n_fields": 1, "tuple_state": False})


# ---------------------------------------------------------------------------
# CRC32C
# ---------------------------------------------------------------------------

def test_crc32c_known_answers():
    assert crc32c(b"123456789") == 0xE3069283
    assert crc32c(b"") == 0
    assert crc32c(bytes(32)) == 0x8A9136AA
    assert crc32c(b"\xff" * 32) == 0x62A8AB43
    assert crc32c(bytes(range(32))) == 0x46DD794E
    # continuation: crc(a + b) == crc(b, crc(a))
    assert crc32c(b"56789", crc32c(b"1234")) == 0xE3069283


@pytest.mark.parametrize("n", [1, 7, 255, 4097, 65535, 65536, 65537,
                               200003, (1 << 20) + 13, 3 * (1 << 20) + 5])
def test_crc32c_matches_jax(n):
    """The lanes (past 64 KiB), their tail and the table loop give JAX's
    checksum bit for bit on random buffers of odd lengths, as bytes, as a
    numpy array and as a memoryview, from a nonzero start too."""
    from distributedfft_tpu.persist.checkpoint import crc32c as jcrc
    buf = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    raw = buf.tobytes()
    want = jcrc(raw)
    assert crc32c(raw) == want
    assert crc32c(buf) == want
    assert crc32c(memoryview(raw)) == want
    assert crc32c(raw, 0x1234567) == jcrc(raw, 0x1234567)
    cut = n // 3
    assert crc32c(raw[cut:], crc32c(raw[:cut])) == want


def test_crc32c_lanes_of_typed_arrays():
    """A complex state's bytes as they are written (no copy to bytes)."""
    from distributedfft_tpu.persist.checkpoint import crc32c as jcrc
    a = np.random.default_rng(1).standard_normal((3, 64, 33)) \
        .astype(np.complex64)
    assert crc32c(a) == jcrc(a.tobytes())
    assert ck._raw(ck._as_u8(a), ck._MASK, torch.device("cpu")) \
        ^ ck._MASK == jcrc(a.tobytes())


@pytest.mark.parametrize("n", [3 * (1 << 17) + 12345, 1 << 18])
def test_crc32c_chunks_match_jax(monkeypatch, n):
    """The lanes taken a chunk at a time (bounded device memory) give
    JAX's checksum: chunks with lanes and tails of their own, joined."""
    from distributedfft_tpu.persist.checkpoint import crc32c as jcrc
    monkeypatch.setattr(ck, "_CHUNK_BYTES", 1 << 17)
    buf = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    calls = []
    real = ck._raw_lanes
    monkeypatch.setattr(ck, "_raw_lanes", lambda b, lanes, d: (
        calls.append(b.size), real(b, lanes, d))[1])
    assert crc32c(buf) == jcrc(buf.tobytes())
    assert len(calls) == n // (1 << 17) and max(calls) <= 1 << 17


def test_zero_extension_operator():
    """The combine's operator: n zero bytes from register r, as the table
    loop runs them."""
    for n in (1, 2, 3, 8, 100, 4096):
        for r in (0, 1, 0xDEADBEEF, 0xFFFFFFFF):
            assert ck._mat_apply(ck._zeros_op(n), r) == \
                ck._raw_loop(bytes(n), r)


# ---------------------------------------------------------------------------
# files across packages
# ---------------------------------------------------------------------------

def _jax_state(jp, arrays, step=3):
    return jp.SimState(arrays=arrays, step=step, dt=2.5e-3,
                       sim_time=step * 2.5e-3, rng={"seed": 7},
                       plan_fingerprint={"plan": "SlabFFTPlan", "ranks": 4},
                       wisdom={"path": None, "version": None},
                       meta={"n_fields": 2, "tuple_state": True})


def _arrays():
    rng = np.random.default_rng(3)
    return {"field0": rng.standard_normal((5, 7, 4)).astype(np.complex64),
            "field1": (rng.standard_normal((300, 301))
                       + 1j * rng.standard_normal((300, 301))),
            "energy": np.arange(5, dtype=np.float64)}


def _same_state(a, b):
    for f in ("step", "dt", "sim_time", "rng", "plan_fingerprint", "wisdom",
              "meta", "written_at"):
        assert getattr(a, f) == getattr(b, f), f
    assert set(a.arrays) == set(b.arrays)
    for k in a.arrays:
        assert a.arrays[k].dtype == b.arrays[k].dtype
        assert a.arrays[k].shape == b.arrays[k].shape
        assert a.arrays[k].tobytes() == b.arrays[k].tobytes()


def test_checkpoints_cross_packages(tmp_path, monkeypatch):
    """A file written by JAX reads in the port and the reverse, with
    equal fields and arrays; at the same clock the two files are the same
    bytes."""
    import distributedfft_tpu.persist as jp
    from distributedfft_tpu.persist import checkpoint as jck
    arrays = _arrays()
    stamp = 1760000000.125
    monkeypatch.setattr(ck.time, "time", lambda: stamp)
    monkeypatch.setattr(jck.time, "time", lambda: stamp)
    pj, pt = str(tmp_path / "jax.dfft"), str(tmp_path / "port.dfft")
    nj = jp.write_checkpoint(pj, _jax_state(jp, dict(arrays)))
    nt = write_checkpoint(pt, _jax_state(persist, dict(arrays)))
    assert nj == nt == os.path.getsize(pt)
    assert open(pj, "rb").read() == open(pt, "rb").read()
    _same_state(read_checkpoint(pj), jp.read_checkpoint(pj))
    _same_state(jp.read_checkpoint(pt), read_checkpoint(pt))
    got = read_checkpoint(pj)
    for k, v in arrays.items():
        assert got.arrays[k].tobytes() == v.tobytes()


def test_checkpoint_roundtrip_preserves_everything(tmp_path):
    p = str(tmp_path / "c.dfft")
    a = np.arange(24, dtype=np.complex128).reshape(4, 6)
    st = _state(step=9, arr=a)
    n = write_checkpoint(p, st)
    assert n == os.path.getsize(p) and st.written_at is not None
    got = read_checkpoint(p)
    assert got.step == 9 and got.dt == 1e-3 and got.rng == {"seed": 7,
                                                            "draws": 9}
    assert got.arrays["field0"].tobytes() == a.tobytes()
    assert got.arrays["field0"].flags.writeable
    assert got.plan_fingerprint == {"plan": "T", "shape": [4, 6]}


@pytest.mark.parametrize("damage", ["magic", "header", "payload",
                                    "truncate", "short"])
def test_every_damage_class_detected(tmp_path, damage):
    p = str(tmp_path / "c.dfft")
    write_checkpoint(p, _state())
    size = os.path.getsize(p)
    with open(p, "r+b") as f:
        if damage == "magic":
            f.write(b"NOTACKPT")
        elif damage == "header":
            f.seek(20)
            b = f.read(1)
            f.seek(20)
            f.write(bytes([b[0] ^ 1]))
        elif damage == "payload":
            f.seek(size - 3)
            b = f.read(1)
            f.seek(size - 3)
            f.write(bytes([b[0] ^ 0x80]))
        elif damage == "truncate":
            f.truncate(size - 16)
        else:
            f.truncate(4)
    with pytest.raises(CheckpointCorrupt):
        read_checkpoint(p)


def test_unsupported_version_refused(tmp_path):
    p = str(tmp_path / "c.dfft")
    write_checkpoint(p, _state())
    with open(p, "rb") as f:
        blob = f.read()
    nm = len(ck.MAGIC)
    hlen = int.from_bytes(blob[nm:nm + 4], "little")
    hdr = json.loads(blob[nm + 8:nm + 8 + hlen])
    hdr["version"] = 99
    raw = json.dumps(hdr, sort_keys=True).encode()
    with open(p, "wb") as f:
        f.write(ck.MAGIC + len(raw).to_bytes(4, "little")
                + crc32c(raw).to_bytes(4, "little") + raw
                + blob[nm + 8 + hlen:])
    with pytest.raises(CheckpointCorrupt, match="version"):
        read_checkpoint(p)


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

def test_rotation_two_slots_latest_wins(tmp_path):
    st = CheckpointStore(str(tmp_path))
    paths = [st.save(_state(step=i)) for i in (1, 2, 3)]
    assert paths[0] != paths[1] and paths[0] == paths[2]
    assert st.load().step == 3
    d = st.describe()
    assert d["latest"]["step"] == 3
    assert {g["step"] for g in d["generations"]} == {2, 3}
    assert all(g["valid"] for g in d["generations"])


def test_corrupt_newest_falls_back_exactly_one_generation(tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv("DFFT_FLIGHTREC_DIR", str(tmp_path / "fr"))
    flightrec.clear()
    st = CheckpointStore(str(tmp_path))
    a = np.arange(12, dtype=np.complex64).reshape(3, 4)
    st.save(_state(step=5, arr=a))
    time.sleep(0.02)
    p2 = st.save(_state(step=6, arr=a * 2))
    with open(p2, "r+b") as f:
        f.seek(30)
        b = f.read(1)
        f.seek(30)
        f.write(bytes([b[0] ^ 1]))
    before = obs.metrics.counter_total("persist.generation_fallbacks")
    got = st.load()
    assert got.step == 5
    assert got.arrays["field0"].tobytes() == a.tobytes()
    assert obs.metrics.counter_total("persist.generation_fallbacks") \
        == before + 1
    dump = flightrec.last_dump()
    assert dump and dump["trigger"] == "checkpoint_restore_failure"
    assert flightrec.validate_dump_file(dump["path"]) >= 0
    # The damaged newest generation is the next write's target.
    assert st._write_target() == p2


def test_both_generations_bad_refuses_structurally(tmp_path, monkeypatch):
    monkeypatch.setenv("DFFT_FLIGHTREC_DIR", str(tmp_path / "fr"))
    st = CheckpointStore(str(tmp_path))
    paths = [st.save(_state(step=i)) for i in (1, 2)]
    for p in paths:
        with open(p, "r+b") as f:
            f.truncate(8)
    before = obs.metrics.counter_total("persist.restore_failures")
    with pytest.raises(CheckpointUnusable) as ei:
        st.load()
    assert len(ei.value.reasons) == 2
    assert obs.metrics.counter_total("persist.restore_failures") \
        == before + 1
    assert st.describe()["fingerprint_verdict"].startswith("UNUSABLE")


def test_missing_store_is_a_fresh_start_not_a_failure(tmp_path):
    with pytest.raises(CheckpointMissing):
        CheckpointStore(str(tmp_path / "empty")).load()
    d = CheckpointStore(str(tmp_path / "empty")).describe()
    assert d["fingerprint_verdict"] == "no checkpoint (fresh start)"


def test_fingerprint_mismatch_refused_without_fallback(tmp_path):
    st = CheckpointStore(str(tmp_path))
    st.save(_state(step=4, fp={"plan": "A", "comm": "All2All"}))
    with pytest.raises(CheckpointMismatch) as ei:
        st.load(expect_fingerprint={"plan": "A", "comm": "Ring"})
    assert ei.value.diffs == {"comm": ("All2All", "Ring")}
    assert st.load(expect_fingerprint={"plan": "A",
                                       "comm": "All2All"}).step == 4
    d = st.describe(expect_fingerprint={"plan": "A", "comm": "Ring"})
    assert d["fingerprint_verdict"].startswith("MISMATCH")


def test_mesh_change_two_tier_restore_contract(tmp_path):
    assert persist.MESH_CHANGE_FIELDS == {"ranks", "sequence", "variant"}
    fp8 = {"plan": "SlabFFTPlan", "shape": [18, 18, 18], "ranks": 8,
           "variant": "zy_then_x", "wire": "native"}
    store = CheckpointStore(str(tmp_path / "ck"))
    store.save(_state(step=3, fp=fp8))
    fp4 = dict(fp8, ranks=4)
    with pytest.raises(CheckpointMismatch) as ei:
        store.load(expect_fingerprint=fp4)
    assert set(ei.value.diffs) == {"ranks"}
    c0 = obs.metrics.counter_value("persist.degraded_restores")
    obs.enable(str(tmp_path / "ev"))
    try:
        sim = store.load(expect_fingerprint=fp4, allow_mesh_change=True)
    finally:
        obs.reset_enablement()
    assert sim.step == 3
    assert obs.metrics.counter_value("persist.degraded_restores") == c0 + 1
    names = set()
    for fn in os.listdir(tmp_path / "ev"):
        with open(tmp_path / "ev" / fn) as f:
            names |= {json.loads(ln)["name"] for ln in f if ln.strip()}
    assert "persist.degraded_restore" in names
    assert store.load(expect_fingerprint=fp8).step == 3
    assert obs.metrics.counter_value("persist.degraded_restores") == c0 + 1
    with pytest.raises(CheckpointMismatch) as ei:
        store.load(expect_fingerprint=dict(fp4, wire="bf16"),
                   allow_mesh_change=True)
    assert set(ei.value.diffs) == {"ranks", "wire"}


def test_fit_padded_crops_and_repads_split_axis():
    from distributedfft_tpu_torch.persist.state import _fit_padded

    class _Plan:
        output_shape = (18, 18, 10)
        output_padded_shape = (18, 20, 10)

    class _Plan8:
        output_shape = (18, 18, 10)
        output_padded_shape = (18, 24, 10)

    host8 = np.zeros((18, 24, 10), np.complex128)
    host8[:, :18, :] = np.random.default_rng(0).standard_normal((18, 18, 10))
    out = _fit_padded(host8, _Plan())
    assert out.shape == (18, 20, 10)
    np.testing.assert_array_equal(out[:, :18], host8[:, :18])
    assert not out[:, 18:].any()
    assert _fit_padded(host8, _Plan8()) is host8
    grown = _fit_padded(out, _Plan8())
    np.testing.assert_array_equal(grown[:, :18], host8[:, :18])
    assert grown.shape == (18, 24, 10) and not grown[:, 18:].any()


def test_resolve_env(tmp_path, monkeypatch):
    monkeypatch.delenv(persist.ENV_DIR, raising=False)
    monkeypatch.delenv(persist.ENV_POLICY, raising=False)
    assert persist.resolve_env(None, None) == (None, None)
    monkeypatch.setenv(persist.ENV_DIR, str(tmp_path))
    monkeypatch.setenv(persist.ENV_POLICY, "steps:3")
    assert persist.resolve_env(None, None) == (str(tmp_path), "steps:3")
    assert persist.resolve_env("rel", "drain:off")[1] == "drain:off"
    with pytest.raises(ValueError):
        persist.resolve_env(None, "steps:0")


# ---------------------------------------------------------------------------
# policy and faults
# ---------------------------------------------------------------------------

def test_policy_parse_roundtrip_and_defaults():
    p = CheckpointPolicy.parse("steps:10,secs:30,drain:off")
    assert (p.every_steps, p.every_s, p.on_drain) == (10, 30.0, False)
    assert CheckpointPolicy.parse(str(p)) == p
    assert CheckpointPolicy.parse(None) == CheckpointPolicy()
    assert CheckpointPolicy.parse("").on_drain is True
    for bad in ("steps", "steps:0", "secs:-1", "drain:maybe",
                "steps:5,steps:6", "every:3", "steps:5,,"):
        with pytest.raises(ValueError):
            CheckpointPolicy.parse(bad)


def test_policy_due_and_next():
    from distributedfft_tpu.persist import CheckpointPolicy as JPolicy
    p = CheckpointPolicy.parse("steps:5,secs:10")
    assert p.due(4, 0, 100.0, 101.0) is None
    assert p.due(5, 0, 100.0, 101.0) == "steps:5"
    assert p.due(2, 0, 100.0, 111.0) == "secs:10"
    assert "at step 5" in p.describe_next(2, 0, 100.0, 101.0)
    drain_only = CheckpointPolicy()
    assert drain_only.due(999, 0, 0.0, 1e9) is None
    assert "on drain" in drain_only.describe_next(0, 0, 0.0, 0.0)
    for spec in ("steps:5,secs:10", "drain:off", "secs:2.5", None):
        a, b = CheckpointPolicy.parse(spec), JPolicy.parse(spec)
        assert str(a) == str(b)
        assert a.describe_next(3, 1, 10.0, 12.0) == \
            b.describe_next(3, 1, 10.0, 12.0)


@pytest.mark.parametrize("fault,expect", [
    ("checkpoint:torn:200", "torn payload|short|truncated"),
    ("checkpoint:corrupt@seed=100", "CRC32C"),
    ("checkpoint:stale", "version 0"),
])
def test_injected_fault_detected_and_falls_back(tmp_path, monkeypatch,
                                                fault, expect):
    st = CheckpointStore(str(tmp_path))
    a = np.linspace(0, 1, 30).astype(np.complex128).reshape(5, 6)
    st.save(_state(step=1, arr=a))
    time.sleep(0.02)
    monkeypatch.setenv("DFFT_FAULT_SPEC", fault)
    p2 = st.save(_state(step=2, arr=a * 3))
    monkeypatch.delenv("DFFT_FAULT_SPEC")
    with pytest.raises(CheckpointCorrupt) as ei:
        read_checkpoint(p2)
    assert re.search(expect, ei.value.reason), ei.value.reason
    before = obs.metrics.counter_total("persist.generation_fallbacks")
    got = st.load()
    assert got.step == 1
    assert got.arrays["field0"].tobytes() == a.tobytes()
    assert obs.metrics.counter_total("persist.generation_fallbacks") \
        == before + 1


@pytest.mark.parametrize("fault", ["checkpoint:torn:200",
                                   "checkpoint:corrupt@seed=100",
                                   "checkpoint:stale"])
def test_injected_damage_matches_jax(tmp_path, monkeypatch, fault):
    """Both packages' injectors damage the same landed file the same way."""
    from distributedfft_tpu.resilience import inject as jinject
    from distributedfft_tpu_torch.resilience import inject
    p = str(tmp_path / "c.dfft")
    write_checkpoint(p, _state())
    clean = open(p, "rb").read()
    q = str(tmp_path / "d.dfft")
    open(q, "wb").write(clean)
    monkeypatch.setenv("DFFT_FAULT_SPEC", fault)
    inject.maybe_taint_checkpoint(p)
    jinject.maybe_taint_checkpoint(q)
    assert open(p, "rb").read() == open(q, "rb").read() != clean


def test_checkpoint_fault_grammar():
    from distributedfft_tpu_torch.resilience.inject import (
        parse_fault_spec, parse_fault_specs)
    s = parse_fault_spec("checkpoint:torn:128@seed=2")
    assert (s.kind, s.mode, s.param, s.seed) == ("checkpoint", "torn",
                                                 128.0, 2)
    assert parse_fault_spec(str(s)) == s
    assert parse_fault_spec("checkpoint:stale").param is None
    specs = parse_fault_specs("wire:nan,checkpoint:corrupt@seed=9")
    assert {sp.kind for sp in specs} == {"wire", "checkpoint"}
    for bad in ("checkpoint:rot", "checkpoint",
                "checkpoint:torn,checkpoint:stale"):
        with pytest.raises(ValueError):
            (parse_fault_specs if "," in bad else parse_fault_spec)(bad)


def test_restore_failure_trigger_in_vocabulary():
    assert "checkpoint_restore_failure" in flightrec.TRIGGERS


def test_capture_and_restore_one_rank(tmp_path):
    """One rank: the state's tensors on the host and back, bit for bit;
    the fingerprint is the plan's; the field count is checked."""
    from distributedfft_tpu_torch.solvers import NavierStokes2D
    plan = tdfft.Batched2DFFTPlan(2, 16, 16, tdfft.SlabPartition(1),
                                  tdfft.Config(double_prec=True,
                                               use_wisdom=False),
                                  device="cpu")
    ns = NavierStokes2D(plan, 1e-2)
    w = ns.to_spectral(np.random.default_rng(2).standard_normal(
        (2, 16, 16)))
    sim = persist.capture(ns, w, step=7, dt=DT, rng={"seed": 1})
    assert sim.meta["n_fields"] == 1 and not sim.meta["tuple_state"]
    assert sim.plan_fingerprint == persist.plan_fingerprint(plan)
    assert sim.wisdom == {"path": None, "version": None}
    back = persist.restore(sim, ns)
    assert torch.equal(back, w)
    sim.meta["n_fields"] = 2
    with pytest.raises(ValueError, match="absent"):
        persist.restore(sim, ns)


def test_wisdom_provenance_names_the_store(tmp_path):
    from distributedfft_tpu_torch.utils import wisdom
    path = str(tmp_path / "w.json")
    plan = tdfft.SlabFFTPlan(tdfft.GlobalSize(8, 8, 8),
                             tdfft.SlabPartition(1),
                             tdfft.Config(wisdom_path=path), device="cpu")
    assert persist.wisdom_provenance(plan) == {"path": path,
                                               "version": None}
    wisdom.WisdomStore(path).record("k", "local_fft",
                                    {"fft_backend": "xla"})
    assert persist.wisdom_provenance(plan)["version"] == \
        wisdom.WISDOM_VERSION


# ---------------------------------------------------------------------------
# the 4-rank world: bit-exact resume, a JAX-captured state stepped
# ---------------------------------------------------------------------------

def _cfg():
    return tdfft.Config(double_prec=True, use_wisdom=False)


def _resume(ns, w0, store):
    """(straight, resumed) after STEPS + EXTRA steps, the resumed run
    through a checkpoint at STEPS."""
    step = ns.step_fn(DT)
    with torch.no_grad():
        mid = w0
        for _ in range(STEPS):
            mid = step(mid)
        ref = mid
        for _ in range(EXTRA):
            ref = step(ref)
        store.save(persist.capture(ns, mid, STEPS, DT, rng={"seed": 0}))
        sim = store.load(expect_fingerprint=persist.plan_fingerprint(ns.plan))
        back = persist.restore(sim, ns)
        res = back
        for _ in range(EXTRA):
            res = step(res)
    return ref, res, sim.step


def _leaves(s):
    return s if isinstance(s, tuple) else (s,)


def _ns2d(rank, outdir):
    from distributedfft_tpu_torch.solvers import NavierStokes2D
    plan = tdfft.Batched2DFFTPlan(*NS2D, tdfft.SlabPartition(P), _cfg(),
                                  shard="x", device="cpu")
    ns = NavierStokes2D(plan, 1e-2)
    w0 = ns.to_spectral(np.random.default_rng(11).standard_normal(NS2D))
    ref, res, k = _resume(ns, w0, CheckpointStore(
        os.path.join(outdir, "ns2d")))
    return {"step": k, "equal": all(torch.equal(a, b) for a, b in
                                    zip(_leaves(ref), _leaves(res))),
            "global": persist.capture(ns, res, 0, DT).arrays["field0"]}


def _ns3d(rank, outdir):
    from distributedfft_tpu_torch.solvers import NavierStokes3D
    n = NS3D_N
    plan = tdfft.SlabFFTPlan(tdfft.GlobalSize(n, n, n),
                             tdfft.SlabPartition(P), _cfg(), device="cpu")
    ns = NavierStokes3D(plan, 1e-2)
    u0 = np.random.default_rng(12).standard_normal((3, n, n, n))
    ref, res, k = _resume(ns, ns.to_spectral(u0),
                          CheckpointStore(os.path.join(outdir, "ns3d")))
    # The JAX-captured state (written by the parent) restored, one step.
    jsim = read_checkpoint(os.path.join(outdir, "jax_ns3d.dfft"))
    w = persist.restore(jsim, ns)
    with torch.no_grad():
        stepped = ns.step_fn(DT)(w)
    got = persist.capture(ns, stepped, jsim.step + 1, DT)
    return {"step": k, "equal": all(torch.equal(a, b) for a, b in
                                    zip(ref, res)),
            "jax_fingerprint": jsim.plan_fingerprint,
            "fingerprint": persist.plan_fingerprint(plan),
            "after_jax_state": got.arrays}


def _rank_main(rank, addr, outdir):
    multihost.maybe_initialize(addr, P, rank, backend="gloo", timeout_s=180)
    torch.set_num_threads(1)    # four ranks on the host's cores, no more
    results = {}
    for name, fn in (("ns2d", _ns2d), ("ns3d", _ns3d)):
        try:
            results[name] = fn(rank, outdir)
        except Exception:  # noqa: BLE001 — reported by that case's test
            results[name] = {"error": traceback.format_exc()}
    results["modules"] = sorted(m for m in sys.modules
                                if m.split(".")[0] in FORBIDDEN)
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    multihost.shutdown()


def _jax_ns3d(outdir, devices):
    """JAX's NS-3D on the 4-device slab mesh: its state after STEPS steps
    captured to a checkpoint file, and its next step."""
    import jax
    import distributedfft_tpu as jdfft
    from distributedfft_tpu import persist as jpersist
    from distributedfft_tpu.parallel.mesh import make_slab_mesh
    from distributedfft_tpu.solvers import NavierStokes3D as JNS3D
    n = NS3D_N
    plan = jdfft.SlabFFTPlan(jdfft.GlobalSize(n, n, n),
                             jdfft.SlabPartition(P),
                             jdfft.Config(double_prec=True,
                                          use_wisdom=False),
                             mesh=make_slab_mesh(P, devices))
    ns = JNS3D(plan, 1e-2)
    u0 = np.random.default_rng(13).standard_normal((3, n, n, n))
    step = jax.jit(ns.step_fn(DT))
    w = ns.to_spectral(u0)
    for _ in range(STEPS):
        w = step(w)
    sim = jpersist.capture(ns, w, STEPS, DT)
    jpersist.write_checkpoint(os.path.join(outdir, "jax_ns3d.dfft"), sim)
    nxt = step(w)
    return {f"field{i}": np.asarray(c) for i, c in enumerate(nxt)}


@pytest.fixture(scope="module")
def world(tmp_path_factory, devices):
    outdir = tmp_path_factory.mktemp("persist")
    want = _jax_ns3d(str(outdir), devices)
    torch.multiprocessing.start_processes(
        _rank_main, args=(multihost.local_coordinator(), str(outdir)),
        nprocs=P, start_method="spawn")
    out = []
    for r in range(P):
        with open(outdir / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out, want


def _result(world, rank, key):
    res = world[0][rank][key]
    if isinstance(res, dict) and "error" in res:
        pytest.fail(f"rank {rank} failed {key}:\n{res['error']}")
    return res


@pytest.mark.parametrize("key", ["ns2d", "ns3d"])
def test_bitexact_resume_on_four_ranks(world, key):
    """NS-2D on the batched plan split on x, NS-3D on the slab: 2 steps,
    checkpoint, restore, 2 steps — every rank's block bit-equal to 4
    straight steps."""
    rows = [_result(world, r, key) for r in range(P)]
    assert all(r["equal"] and r["step"] == STEPS for r in rows)


def test_jax_captured_state_steps_in_the_port(world):
    """JAX's NS-3D state (a JAX-written file, the 4-device mesh's padded
    arrays) restored into the port's 4-rank slab plan and stepped once:
    within 1e-12 of JAX's own step; the fingerprints agree."""
    rows = [_result(world, r, "ns3d") for r in range(P)]
    got, want = rows[0]["after_jax_state"], world[1]
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape
        scale = np.abs(want[k]).max()
        assert np.abs(got[k] - want[k]).max() <= 1e-12 * max(scale, 1.0), k
    fp, jfp = rows[0]["fingerprint"], rows[0]["jax_fingerprint"]
    assert {k: fp.get(k) for k in jfp if k != "direction"} == \
        {k: jfp[k] for k in jfp if k != "direction"}


def test_ranks_import_no_jax(world):
    assert all(w["modules"] == [] for w in world[0])
