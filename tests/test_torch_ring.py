"""The port's ring exchanges (RING / RING_OVERLAP, the bf16 wire, the fused
wire) and the three slab sequences, 4 ranks over gloo on the CPU, against
the port's all-to-all and the JAX package on a 4-device mesh.

One 4-rank world is spawned for the whole file (a module fixture) and runs
every case; each case stays its own test. The ranks import this module to
find ``_rank_main``, so it imports neither JAX nor the JAX package at its
top: the references are computed in the parent.

* Bare ``ring_transpose`` is bit for bit the port's ``all_to_all_transpose``
  (followed by the same elementwise ``pipeline_fn``) at every schedule:
  RING, RING_OVERLAP at depth 2, 3 and 4, sub-blocks 1, 2 and 3 (the
  concat extent 5 makes the sub-blocks uneven).
* The bf16 ring is bit for bit JAX's ``ring_transpose(..., wire="bf16")``.
* ``SlabFFTPlan(SlabPartition(4))`` under every sequence, transform,
  ring, wire, fused-wire setting and backend matches the JAX plan under the
  same Config: rel <= 1e-5 (``"xla"``), 2e-3 (``"pallas"``, the JAX
  plan's own bound) on a native wire, 2e-2 on bf16 (``BF16_BOUND`` of
  ``tests/test_wire.py``). RING_OVERLAP equals RING bit for bit.
* A double-precision ring with the fused wire (its arrival decodes and
  runs the matmul backend's DFT) and the settings the plan refused before
  their renderings were ported (STREAMS under ALL2ALL and PEER2PEER, the
  pipelined all-to-all, opt 1) run against the JAX plan.
"""

import dataclasses
import os
import pickle
import sys
import traceback

import numpy as np
import pytest
import torch

import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch.ops import hopper_fft as hf
from distributedfft_tpu_torch.params import SendMethod
from distributedfft_tpu_torch.parallel import multihost
from distributedfft_tpu_torch.parallel.transpose import (all_to_all_transpose,
                                                         ring_transpose)

P = 4
TOL = {"xla": 1e-5, "pallas": 2e-3}
WIRE16_TOL = 2e-2
FORBIDDEN = ("jax", "jaxlib", "distributedfft_tpu")

# Bare exchanges: id -> (global shape, split axis, concat axis). Each rank
# holds the block of its rank along the concat axis.
DIRECTIONS = {"split1-concat0": ((20, 12, 6), 1, 0),
              "split0-concat1": ((12, 20, 6), 0, 1)}
# Schedules: id -> (overlap, depth).
SCHEDULES = {"ring": (False, 2), "overlap-d2": (True, 2),
             "overlap-d3": (True, 3), "overlap-d4": (True, 4)}
SUBBLOCKS = (1, 2, 3)

PLAN_SHAPE = (10, 6, 9)      # nx, ny and nz//2+1 none a multiple of 4
SEQS = ("ZY_Then_X", "Z_Then_YX", "Y_Then_ZX")
WIRES = {"native": ("native", False), "native-fusedflag": ("native", True),
         "wire16": ("bf16", False), "wire16-fused": ("bf16", True)}
PLAN_CASES = {
    f"{seq}-{tr}-{wid}-{be}": (seq, tr, wid, be)
    for seq in SEQS for tr in ("r2c", "c2c") for wid in WIRES
    for be in ("xla", "pallas")}
RINGS = ("Ring", "RingOverlap")


def _block_input(shape, concat, cplx, rank):
    x = np.arange(np.prod(shape), dtype=np.float64).reshape(shape) / 7.0
    x = np.sin(x) * 3.0
    x = (x + 1j * np.cos(x)).astype(np.complex64) if cplx else \
        x.astype(np.float32)
    b = shape[concat] // P
    return x.take(range(rank * b, (rank + 1) * b), axis=concat)


def _pipe(b):
    return b * 3 - 1


def _plan_input(shape, transform, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if transform == "c2c":
        return (x + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return x.astype(np.float32)


def _norm(transform):
    return "BACKWARD" if transform == "c2c" else "ORTHO"


# ---------------------------------------------------------------------------
# The ranks (no JAX here)
# ---------------------------------------------------------------------------


def _run_bare(case):
    shape, s, c, cplx, piped = case
    rank = torch.distributed.get_rank()
    x = torch.from_numpy(_block_input(shape, c, cplx, rank))
    pipe = _pipe if piped else None
    ref = all_to_all_transpose(x, None, s, c)
    out = {"a2a": (_pipe(ref) if piped else ref).numpy()}
    for sid, (overlap, depth) in SCHEDULES.items():
        for sub in SUBBLOCKS:
            out[sid, sub] = ring_transpose(
                x, None, s, c, pipeline_fn=pipe, overlap=overlap,
                depth=depth, subblocks=sub).numpy()
    return out


def _run_bare_wire16(case):
    shape, s, c = case
    rank = torch.distributed.get_rank()
    x = torch.from_numpy(_block_input(shape, c, True, rank))
    return {"ring": ring_transpose(x, None, s, c, wire="bf16").numpy(),
            "overlap": ring_transpose(x, None, s, c, wire="bf16",
                                      overlap=True, depth=3,
                                      subblocks=2).numpy(),
            "a2a": all_to_all_transpose(x, None, s, c, wire="bf16").numpy()}


def _counting(calls, name):
    fn = getattr(hf, name)

    def counted(*args, **kw):
        calls[name] += 1
        return fn(*args, **kw)

    return counted


def _run_plan(case):
    """Both rings under one Config: the local blocks, the gathered arrays,
    and the calls of each fused-wire wrapper per direction."""
    shape, seq, transform, cfgs, seed = case
    out = {}
    wrappers = ("enc_pack", "dec_unpack", "dec_cmatmul")
    for snd, cfg in cfgs.items():
        plan = tdfft.SlabFFTPlan(tdfft.GlobalSize(*shape),
                                 tdfft.SlabPartition(P), cfg,
                                 transform=transform, device="cpu",
                                 sequence=seq)
        hf.reset_launches()
        xl = plan.pad_input(_plan_input(shape, transform, seed))
        calls = dict.fromkeys(wrappers, 0)
        orig = {n: getattr(hf, n) for n in wrappers}
        for n in wrappers:
            setattr(hf, n, _counting(calls, n))
        try:
            fwd = plan.exec_r2c(xl) if transform == "r2c" else \
                plan.exec_c2c(xl)
            calls_fwd = dict(calls)
            back = plan.exec_c2r(fwd) if transform == "r2c" else \
                plan.exec_c2c_inv(fwd)
        finally:
            for n, f in orig.items():
                setattr(hf, n, f)
        out[snd] = {"local_fwd": fwd.numpy(), "local_back": back.numpy(),
                    "crop_fwd": plan.crop_spectral(fwd),
                    "crop_back": plan.crop_real(back),
                    "launches": sum(hf.LAUNCHES.values()),
                    "calls_fwd": calls_fwd,
                    "calls_inv": {n: calls[n] - calls_fwd[n]
                                  for n in wrappers},
                    "out_sizes": plan.out_sizes(),
                    "local_output_shape": plan.local_output_shape}
    return out


def _run_ring_vs_a2a(shape):
    """ZY_Then_X R2C forward: RING (native) against ALL2ALL, bit for bit."""
    x = _plan_input(shape, "r2c", 5)
    outs = []
    for cfg in (tdfft.Config(), tdfft.Config(send_method=SendMethod.RING)):
        plan = tdfft.SlabFFTPlan(tdfft.GlobalSize(*shape),
                                 tdfft.SlabPartition(P), cfg, device="cpu")
        outs.append(plan.exec_r2c(plan.pad_input(x)).numpy())
    return outs


# A double-precision ring whose arrival would take kernel 11: its fused
# decode + DFT runs the plain decode and the matmul backend instead.
F64_FUSED = dict(send_method="Ring", wire_dtype="bf16", fused_wire=True,
                 double_prec=True)
# Settings the plan refused before their renderings were ported, each run
# at P = 4 against the JAX plan: id -> Config fields.
SETTINGS = {"streams": dict(send_method="Streams"),
            "peer2peer": dict(comm_method="Peer2Peer", send_method="Streams"),
            "pipelined-a2a": dict(overlap_subblocks=2),
            "opt1": dict(opt=1)}


def _config(pkg, fields):
    """``pkg.Config`` of ``fields``, the enum fields given by value."""
    kw = dict(fields)
    for k, enum in (("send_method", pkg.SendMethod),
                    ("comm_method", pkg.CommMethod)):
        if k in kw:
            kw[k] = enum(kw[k])
    return pkg.Config(**kw)


def _run_settings(case):
    """One plan of ``fields``: local blocks, gathered arrays, and the
    matmul dispatches and kernel launches of its forward."""
    shape, seq, fields, seed = case
    plan = tdfft.SlabFFTPlan(tdfft.GlobalSize(*shape), tdfft.SlabPartition(P),
                             _config(tdfft, fields), device="cpu",
                             sequence=seq)
    x = _plan_input(shape, "r2c", seed).astype(
        np.float64 if fields.get("double_prec") else np.float32)
    hf.reset_launches()
    fwd = plan.exec_r2c(plan.pad_input(x))
    counts = (dict(hf.DISPATCHES), sum(hf.LAUNCHES.values()))
    back = plan.exec_c2r(fwd)
    return {"local_fwd": fwd.numpy(), "local_back": back.numpy(),
            "crop_fwd": plan.crop_spectral(fwd),
            "crop_back": plan.crop_real(back), "counts": counts}


def _rank_main(rank, addr, cases, outdir):
    multihost.maybe_initialize(addr, P, rank, backend="gloo", timeout_s=120)
    results = {}
    for cid, (kind, case) in cases.items():
        try:
            run = {"bare": _run_bare, "bare_wire16": _run_bare_wire16,
                   "plan": _run_plan, "ring_vs_a2a": _run_ring_vs_a2a,
                   "settings": _run_settings}[kind]
            results[cid] = run(case)
        except Exception:  # noqa: BLE001 — reported by that case's test
            results[cid] = {"error": traceback.format_exc()}
    results["modules"] = sorted(m for m in sys.modules
                                if m.split(".")[0] in FORBIDDEN)
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    multihost.shutdown()


# ---------------------------------------------------------------------------
# The parent: JAX references and comparisons
# ---------------------------------------------------------------------------


def _jax_config(snd, wid, be, transform):
    import distributedfft_tpu as jdfft
    wire, fused = WIRES[wid]
    return jdfft.Config(send_method=jdfft.SendMethod(snd), wire_dtype=wire,
                        fused_wire=fused, fft_backend=be,
                        norm=jdfft.FFTNorm[_norm(transform)])


def _bare_cases():
    out = {}
    for did, (shape, s, c) in DIRECTIONS.items():
        for cplx in (True, False):
            for piped in (False, True):
                out[_bare_id(did, cplx, piped)] = ("bare",
                                                   (shape, s, c, cplx, piped))
        out[f"wire16-{did}"] = ("bare_wire16", (shape, s, c))
    return out


def _bare_id(did, cplx, piped):
    return f"{did}-{'complex' if cplx else 'real'}-{'pipe' if piped else 'nopipe'}"


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases = _bare_cases()
    for i, (cid, (seq, tr, wid, be)) in enumerate(PLAN_CASES.items()):
        cfgs = {snd: tdfft.config_from_reference(
            dataclasses.asdict(_jax_config(snd, wid, be, tr))) for snd in RINGS}
        cases[cid] = ("plan", (PLAN_SHAPE, seq, tr, cfgs, 300 + i))
    cases["ring_vs_a2a"] = ("ring_vs_a2a", (8, 12, 10))
    cases["f64_fused"] = ("settings", ((8, 8, 8), "Z_Then_YX", F64_FUSED,
                                       7))
    for i, (sid, fields) in enumerate(SETTINGS.items()):
        cases[f"settings-{sid}"] = ("settings", (PLAN_SHAPE, "ZY_Then_X",
                                                 fields, 400 + i))
    outdir = tmp_path_factory.mktemp("ring")
    torch.multiprocessing.start_processes(
        _rank_main, args=(multihost.local_coordinator(), cases, str(outdir)),
        nprocs=P, start_method="spawn")
    out = []
    for r in range(P):
        with open(outdir / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _result(world, rank, cid):
    res = world[rank][cid]
    if isinstance(res, dict) and "error" in res:
        pytest.fail(f"rank {rank} failed case {cid}:\n{res['error']}")
    return res


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def _mesh(devices):
    from distributedfft_tpu.parallel.mesh import make_slab_mesh
    return make_slab_mesh(P, devices)


@pytest.mark.parametrize("sched", list(SCHEDULES))
@pytest.mark.parametrize("piped", [False, True], ids=["nopipe", "pipe"])
@pytest.mark.parametrize("cplx", [True, False], ids=["complex", "real"])
@pytest.mark.parametrize("did", list(DIRECTIONS))
def test_ring_matches_all_to_all_bit_for_bit(world, did, cplx, piped, sched):
    cid = _bare_id(did, cplx, piped)
    for r in range(P):
        res = _result(world, r, cid)
        for sub in SUBBLOCKS:
            got, want = res[sched, sub], res["a2a"]
            assert got.dtype == want.dtype and got.shape == want.shape
            assert np.array_equal(got, want), (r, sched, sub)
            assert np.array_equal(got, res["ring", 1]), (r, sched, sub)


@pytest.mark.parametrize("did", list(DIRECTIONS))
def test_wire16_ring_matches_jax_ring_bit_for_bit(world, devices, did):
    """The bf16 ring against ``ring_transpose(..., wire="bf16")`` of the
    JAX package inside ``shard_map`` on the same input; the local block
    stays exact in both, the travelling ones round to bf16 and back."""
    import jax
    from jax.sharding import PartitionSpec as PS
    from distributedfft_tpu.parallel.transpose import \
        ring_transpose as jax_ring
    shape, s, c = DIRECTIONS[did]
    spec = [None] * 3
    spec[c] = "p"
    spec_out = [None] * 3
    spec_out[s] = "p"
    fn = jax.jit(jax.shard_map(
        lambda xl: jax_ring(xl, "p", s, c, wire="bf16"), mesh=_mesh(devices),
        in_specs=PS(*spec), out_specs=PS(*spec_out)))
    full = np.concatenate([_block_input(shape, c, True, r) for r in range(P)],
                          axis=c)
    ref = np.asarray(fn(full))
    b = ref.shape[s] // P
    for r in range(P):
        res = _result(world, r, f"wire16-{did}")
        want = ref.take(range(r * b, (r + 1) * b), axis=s)
        for k in ("ring", "overlap"):
            assert res[k].dtype == want.dtype
            assert np.array_equal(res[k], want), (r, k)
        # The monolithic bf16 exchange also rounds the local block.
        assert _rel(res["a2a"], want) <= WIRE16_TOL


def _jax_plan_run(devices, seq, tr, wid, be, seed, snd="Ring"):
    import distributedfft_tpu as jdfft
    jplan = jdfft.SlabFFTPlan(jdfft.GlobalSize(*PLAN_SHAPE),
                              jdfft.SlabPartition(P),
                              _jax_config(snd, wid, be, tr),
                              mesh=_mesh(devices), sequence=seq, transform=tr)
    x = _plan_input(PLAN_SHAPE, tr, seed)
    jx = jplan.pad_input(x)
    jc = jplan.exec_r2c(jx) if tr == "r2c" else jplan.exec_c2c(jx)
    jb = jplan.exec_c2r(jc) if tr == "r2c" else jplan.exec_c2c_inv(jc)
    return jplan, jc, jb


@pytest.mark.parametrize("cid", list(PLAN_CASES))
def test_ring_plan_matches_reference(world, devices, cid):
    seq, tr, wid, be = PLAN_CASES[cid]
    seed = 300 + list(PLAN_CASES).index(cid)
    tol = WIRE16_TOL if WIRES[wid][0] == "bf16" else TOL[be]
    split = {"ZY_Then_X": 1, "Z_Then_YX": 2, "Y_Then_ZX": 1}[seq]
    for snd in RINGS:
        jplan, jc, jb = _jax_plan_run(devices, seq, tr, wid, be, seed, snd)
        jc_np, jb_np = np.asarray(jc), np.asarray(jb)
        bs = jc_np.shape[split] // P
        bx = jb_np.shape[0] // P
        for r in range(P):
            res = _result(world, r, cid)[snd]
            assert res["launches"] == 0  # CPU tensors: plain versions only
            fwd = jc_np.take(range(r * bs, (r + 1) * bs), axis=split)
            assert res["local_fwd"].shape == fwd.shape
            assert res["local_output_shape"] == fwd.shape
            assert _rel(res["local_fwd"], fwd) <= tol, (r, snd, "forward")
            back = jb_np[r * bx:(r + 1) * bx]
            assert res["local_back"].shape == back.shape
            assert _rel(res["local_back"], back) <= tol, (r, snd, "roundtrip")
            assert res["out_sizes"] == jplan.out_sizes()
        res = _result(world, 0, cid)[snd]
        crop = jplan.crop_spectral(jc)
        assert res["crop_fwd"].shape == crop.shape == jplan.output_shape
        assert _rel(res["crop_fwd"], crop) <= tol
        assert _rel(res["crop_back"], jplan.crop_real(jb)) <= tol
    for r in range(P):
        ring, ovl = (_result(world, r, cid)[snd] for snd in RINGS)
        for k in ("local_fwd", "local_back"):
            assert np.array_equal(ring[k], ovl[k]), (r, k)
        for direction in ("fwd", "inv"):
            want = _fused_calls(seq, tr, wid, direction)
            assert ring[f"calls_{direction}"] == want, (r, direction)
            assert ovl[f"calls_{direction}"] == want, (r, direction)


# Arrivals with a per-block DFT (kernel 11) per (sequence, transform,
# direction); every other arrival decodes only (kernel 10).
_DECODE_DFT = {("Z_Then_YX", "r2c", "fwd"), ("Z_Then_YX", "c2c", "fwd"),
               ("Y_Then_ZX", "r2c", "fwd"), ("Y_Then_ZX", "c2c", "fwd"),
               ("ZY_Then_X", "c2c", "inv")}


def _fused_calls(seq, tr, wid, direction):
    """The fused-wire wrappers one direction calls on a rank: P-1
    travelling blocks, each encoded once and decoded once on arrival."""
    calls = {"enc_pack": 0, "dec_unpack": 0, "dec_cmatmul": 0}
    if wid == "wire16-fused":
        calls["enc_pack"] = P - 1
        dec = ("dec_cmatmul" if (seq, tr, direction) in _DECODE_DFT
               else "dec_unpack")
        calls[dec] = P - 1
    return calls


def test_ring_forward_equals_all_to_all_bit_for_bit(world):
    for r in range(P):
        a2a, ring = _result(world, r, "ring_vs_a2a")
        assert a2a.dtype == ring.dtype and np.array_equal(a2a, ring)


def _settings_vs_reference(world, devices, cid, shape, seq, fields, seed,
                           tol):
    """Each rank's blocks and the gathered arrays of a ``_run_settings``
    case against the JAX plan under the same Config."""
    import distributedfft_tpu as jdfft
    jplan = jdfft.SlabFFTPlan(jdfft.GlobalSize(*shape), jdfft.SlabPartition(P),
                              _config(jdfft, fields), mesh=_mesh(devices),
                              sequence=seq)
    x = _plan_input(shape, "r2c", seed).astype(
        np.float64 if fields.get("double_prec") else np.float32)
    jc = jplan.exec_r2c(jplan.pad_input(x))
    jb = jplan.exec_c2r(jc)
    jc_np, jb_np = np.asarray(jc), np.asarray(jb)
    split = {"ZY_Then_X": 1, "Z_Then_YX": 2, "Y_Then_ZX": 1}[seq]
    bs, bx = jc_np.shape[split] // P, jb_np.shape[0] // P
    for r in range(P):
        res = _result(world, r, cid)
        fwd = jc_np.take(range(r * bs, (r + 1) * bs), axis=split)
        assert res["local_fwd"].dtype == fwd.dtype
        assert _rel(res["local_fwd"], fwd) <= tol, (r, "forward")
        assert _rel(res["local_back"], jb_np[r * bx:(r + 1) * bx]) <= tol
    res = _result(world, 0, cid)
    assert _rel(res["crop_fwd"], jplan.crop_spectral(jc)) <= tol
    assert _rel(res["crop_back"], jplan.crop_real(jb)) <= tol
    return [_result(world, r, cid)["counts"] for r in range(P)]


def test_double_precision_fused_decode_dft_runs(world, devices):
    """The f64 ring's fused arrival (Z_Then_YX: y runs on each arriving
    block) decodes and runs the matmul backend, as the JAX package's does:
    P-1 dispatches a forward, no kernel; within the bf16 wire's bound of
    the JAX plan."""
    counts = _settings_vs_reference(world, devices, "f64_fused", (8, 8, 8),
                                    "Z_Then_YX", F64_FUSED, 7, WIRE16_TOL)
    assert counts == [({"matmul": P - 1}, 0)] * P


@pytest.mark.parametrize("sid", list(SETTINGS))
def test_settings_run_as_the_reference(world, devices, sid):
    """STREAMS (ALL2ALL and PEER2PEER), the pipelined all-to-all and opt 1
    build and run at P = 4, within 1e-5 of the JAX plan."""
    _settings_vs_reference(world, devices, f"settings-{sid}", PLAN_SHAPE,
                           "ZY_Then_X", SETTINGS[sid],
                           400 + list(SETTINGS).index(sid), TOL["xla"])


def test_ranks_import_no_jax(world):
    assert all(w["modules"] == [] for w in world), [w["modules"] for w in world]


def _two_rank_plan(**kw):
    return tdfft.SlabFFTPlan(tdfft.GlobalSize(8, 8, 8), tdfft.SlabPartition(2),
                             tdfft.Config(**kw), device="cpu")


@pytest.mark.parametrize("kw, item", [
    (dict(wire_dtype="auto"), "torch.distributed world"),
], ids=["auto-wire"])
def test_refused_settings_name_their_item(kw, item):
    """A two-rank plan outside a world: ``wire_dtype="auto"`` raised naming
    item 11 until the wisdom resolution was ported; the wire race now
    cannot build its candidates there (it falls back to native) and the
    plan itself asks for the world."""
    with pytest.raises(RuntimeError, match=item):
        _two_rank_plan(**kw)


def test_ring_owns_the_exchange_whatever_comm_method():
    """A ring rendering is accepted under PEER2PEER and opt 1 (both inert,
    as in the JAX package): the plan gets as far as needing a group."""
    for kw in (dict(comm_method=tdfft.CommMethod.PEER2PEER), dict(opt=1)):
        with pytest.raises(RuntimeError, match="maybe_initialize"):
            _two_rank_plan(send_method=SendMethod.RING_OVERLAP, **kw)
