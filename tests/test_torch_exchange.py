"""The slab exchange renderings ported last (opt 1, the pipelined
all-to-all, STREAMS with ALL2ALL and with PEER2PEER) and the distributed
plans of the matmul backend (``"matmul"``, ``"matmul-r2"``, and double
precision under ``"pallas"``), 4 ranks over gloo on the CPU, against the
port's monolithic renderings and the JAX package on a 4-device mesh.

One 4-rank world is spawned for the whole file (a module fixture) and runs
every case; each case stays its own test. The ranks import this module to
find ``_rank_main``, so it imports neither JAX nor the JAX package at its
top: the references are computed in the parent.

* opt 1: ``tests/test_slab.py``'s ``test_forward_vs_reference`` and
  ``test_roundtrip_unnormalized`` at P = 4 for 3 sequences x comm, and
  bit for bit the opt-0 plan on every rank.
* The pipelined all-to-all: bit for bit the monolithic exchange, bare and
  as a plan (``tests/test_overlap_tuning.py:128``, ``:166``), for opt 0
  and 1, depth 2 and 3, native and the bf16 wire ("wire16").
* STREAMS: against SYNC (``tests/test_streams.py:36``, ``:52``), in
  double precision as the JAX pins run: bit for bit under PEER2PEER,
  whose FFTs run on the whole block; within 1e-12 under ALL2ALL, as the
  JAX pin holds it, where each piece runs its own FFTs (on the CPU the
  FFT library may round a narrower batch differently; the card's column
  kernel gives the same bits, ``tests/test_torch_cuda.py``), and, for
  Z_Then_YX and Y_Then_ZX, the free axis's FFT after the pieces'.
* Plans on the matmul backend against the JAX plan
  (``tests/test_mxu_fft.py:102``, ``:224``): 1e-10 in float64, 5e-4 in
  float32; each direction's matmul dispatches and kernel launches counted.

Tolerances otherwise: rel <= 1e-5 under ``"xla"`` (both sides float32 FFT
libraries), 2e-2 on the bf16 wire.
"""

import os
import pickle
import sys
import traceback

import numpy as np
import pytest
import torch

import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch.ops import hopper_fft as hf
from distributedfft_tpu_torch.parallel import multihost
from distributedfft_tpu_torch.parallel.transpose import (
    all_to_all_transpose, pipelined_all_to_all, realigned_pack_shape)

P = 4
FORBIDDEN = ("jax", "jaxlib", "distributedfft_tpu")
SEQS = ("ZY_Then_X", "Z_Then_YX", "Y_Then_ZX")
COMMS = ("All2All", "Peer2Peer")
WIRE16_TOL = 2e-2
# One seed for every case: the cases compared bit for bit share an input.
SEED = 500

# id -> (global shape, sequence, transform, Config fields, input dtype).
PLANS = {}
for _seq in SEQS:
    for _comm in COMMS:
        for _opt in (0, 1):
            PLANS[f"opt{_opt}-{_seq}-{_comm}"] = (
                (16, 16, 16), _seq, "r2c",
                dict(comm_method=_comm, opt=_opt), "f32")
        for _snd in ("Sync", "Streams"):
            PLANS[f"f64-{_snd}-{_seq}-{_comm}"] = (
                (16, 16, 16), _seq, "r2c",
                dict(comm_method=_comm, send_method=_snd, streams_chunks=3,
                     double_prec=True), "f64")
for _comm in COMMS:
    PLANS[f"streams-uneven-{_comm}"] = (
        (20, 16, 16), "Y_Then_ZX", "r2c",
        dict(comm_method=_comm, send_method="Streams", streams_chunks=5,
             double_prec=True), "f64")
    PLANS[f"streams-pallas-{_comm}"] = (
        (16, 16, 16), "ZY_Then_X", "r2c",
        dict(comm_method=_comm, send_method="Streams", fft_backend="pallas"),
        "f32")
PLANS["sync-pallas-All2All"] = ((16, 16, 16), "ZY_Then_X", "r2c",
                                dict(comm_method="All2All",
                                     fft_backend="pallas"), "f32")
# The pipelined all-to-all and its monolithic exchange (G of
# tests/test_overlap_tuning.py).
PIPE_SHAPE = (20, 16, 16)
for _opt in (0, 1):
    for _wire in ("native", "bf16"):
        _base = dict(comm_method="All2All", opt=_opt, wire_dtype=_wire)
        _wid = "wire16" if _wire == "bf16" else "native"
        PLANS[f"mono-opt{_opt}-{_wid}"] = (PIPE_SHAPE, "ZY_Then_X", "r2c",
                                           _base, "f32")
        for _depth in (2, 3):
            PLANS[f"pipe-opt{_opt}-d{_depth}-{_wid}"] = (
                PIPE_SHAPE, "ZY_Then_X", "r2c",
                dict(_base, overlap_subblocks=2, overlap_depth=_depth), "f32")
for _tr in ("c2c",):
    PLANS[f"mono-{_tr}"] = (PIPE_SHAPE, "ZY_Then_X", _tr,
                            dict(comm_method="All2All", opt=1), "f32")
    PLANS[f"pipe-{_tr}"] = (PIPE_SHAPE, "ZY_Then_X", _tr,
                            dict(comm_method="All2All", opt=1,
                                 overlap_subblocks=2), "f32")
PLANS["pipe-pallas-Z_Then_YX"] = ((16, 16, 16), "Z_Then_YX", "r2c",
                                  dict(comm_method="All2All",
                                       overlap_subblocks=3,
                                       fft_backend="pallas"), "f32")
PLANS["mono-pallas-Z_Then_YX"] = ((16, 16, 16), "Z_Then_YX", "r2c",
                                  dict(comm_method="All2All",
                                       fft_backend="pallas"), "f32")
# Plans on the matmul backend: id -> the same tuple.
MATMUL = {
    "matmul-f64": ((16, 16, 16), "ZY_Then_X", "r2c",
                   dict(fft_backend="matmul", double_prec=True), "f64"),
    "matmul-f64-prime": ((7, 11, 13), "ZY_Then_X", "r2c",
                         dict(fft_backend="matmul", double_prec=True), "f64"),
    "matmul-r2-f64": ((160, 16, 16), "ZY_Then_X", "r2c",
                      dict(fft_backend="matmul-r2", double_prec=True), "f64"),
    "matmul-f32": ((16, 16, 16), "Z_Then_YX", "r2c",
                   dict(fft_backend="matmul"), "f32"),
    "matmul-f32-highest-c2c": ((10, 6, 9), "ZY_Then_X", "c2c",
                               dict(fft_backend="matmul",
                                    mxu_precision="highest"), "f32"),
    "pallas-f64": ((16, 16, 16), "ZY_Then_X", "r2c",
                   dict(fft_backend="pallas", double_prec=True), "f64"),
    "pallas-f64-prime": ((7, 11, 13), "Y_Then_ZX", "r2c",
                         dict(fft_backend="pallas", double_prec=True), "f64"),
    "pallas-f64-c2c": ((10, 6, 9), "Z_Then_YX", "c2c",
                       dict(fft_backend="pallas", double_prec=True), "f64"),
    "pallas-f64-a2a-pipe": ((16, 16, 16), "ZY_Then_X", "r2c",
                            dict(fft_backend="pallas", double_prec=True,
                                 comm_method="All2All",
                                 overlap_subblocks=2), "f64"),
}
PLANS.update(MATMUL)
# Bare exchanges: id -> (global shape, split, concat, chunk axis).
BARE = {"split1-concat0": ((8, 12, 6), 1, 0, 2),
        "split0-concat1": ((12, 8, 7), 0, 1, 2),
        "split2-concat0": ((8, 5, 12), 2, 0, 1)}


def _config(pkg, fields):
    """``pkg.Config`` of ``fields``, the enum fields given by value."""
    kw = dict(fields)
    for k, enum in (("send_method", pkg.SendMethod),
                    ("comm_method", pkg.CommMethod)):
        if k in kw:
            kw[k] = enum(kw[k])
    return pkg.Config(**kw)


def _input(shape, transform, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.random(shape)
    if transform == "c2c":
        x = x + 1j * rng.random(shape)
        return x.astype(np.complex128 if dtype == "f64" else np.complex64)
    return x.astype(np.float64 if dtype == "f64" else np.float32)


# ---------------------------------------------------------------------------
# The ranks (no JAX here)
# ---------------------------------------------------------------------------


def _run_plan(cid):
    shape, seq, tr, fields, dtype = PLANS[cid]
    plan = tdfft.SlabFFTPlan(tdfft.GlobalSize(*shape), tdfft.SlabPartition(P),
                             _config(tdfft, fields), transform=tr,
                             device="cpu", sequence=seq)
    xl = plan.pad_input(_input(shape, tr, dtype, SEED))
    hf.reset_launches()
    fwd = plan.exec_r2c(xl) if tr == "r2c" else plan.exec_c2c(xl)
    counts = [dict(hf.DISPATCHES), dict(hf.LAUNCHES)]
    hf.reset_launches()
    back = plan.exec_c2r(fwd) if tr == "r2c" else plan.exec_c2c_inv(fwd)
    counts += [dict(hf.DISPATCHES), dict(hf.LAUNCHES)]
    return {"local_fwd": fwd.numpy(), "local_back": back.numpy(),
            "crop_fwd": plan.crop_spectral(fwd),
            "crop_back": plan.crop_real(back), "counts": counts,
            "a2a_pipe_chunks": plan._a2a_pipe_chunks()}


def _bare_input(shape, concat, rank, cplx):
    """This rank's block (along ``concat``) of a global array whose entries
    are distinct."""
    x = np.arange(np.prod(shape), dtype=np.float64).reshape(shape)
    if cplx:
        x = (x + 0.25j * x).astype(np.complex64)
    else:
        x = x.astype(np.float32)
    b = shape[concat] // P
    return torch.from_numpy(np.ascontiguousarray(
        x.take(range(rank * b, (rank + 1) * b), axis=concat)))


def _run_bare(bid):
    shape, s, c, ca = BARE[bid]
    rank = torch.distributed.get_rank()
    out = {}
    for cplx in (True, False):
        x = _bare_input(shape, c, rank, cplx)
        for wire in ("native", "bf16"):
            mono = all_to_all_transpose(x, None, s, c, wire=wire)
            out[cplx, wire, "mono"] = mono.numpy()
            out[cplx, wire, "opt1"] = all_to_all_transpose(
                x, None, s, c, realigned=True, wire=wire).numpy()
            for chunks in (1, 2, 3, 99):
                for depth in (1, 2, 3):
                    out[cplx, wire, chunks, depth] = pipelined_all_to_all(
                        x, None, s, c, chunk_axis=ca, chunks=chunks,
                        depth=depth, realigned=depth == 3,
                        wire=wire).numpy()
    return out


def _rank_main(rank, addr, cases, outdir):
    multihost.maybe_initialize(addr, P, rank, backend="gloo", timeout_s=120)
    results = {}
    for cid, kind in cases.items():
        try:
            results[cid] = {"plan": _run_plan, "bare": _run_bare}[kind](cid)
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


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases = {cid: "plan" for cid in PLANS}
    cases.update({bid: "bare" for bid in BARE})
    outdir = tmp_path_factory.mktemp("exchange")
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


def _jax_run(devices, cid):
    """The JAX plan of case ``cid`` on the same input: (plan, padded
    forward, padded inverse) as numpy, and the plan."""
    import distributedfft_tpu as jdfft
    shape, seq, tr, fields, dtype = PLANS[cid]
    jplan = jdfft.SlabFFTPlan(jdfft.GlobalSize(*shape), jdfft.SlabPartition(P),
                              _config(jdfft, fields), mesh=_mesh(devices),
                              sequence=seq, transform=tr)
    jx = jplan.pad_input(_input(shape, tr, dtype, SEED))
    jc = jplan.exec_r2c(jx) if tr == "r2c" else jplan.exec_c2c(jx)
    jb = jplan.exec_c2r(jc) if tr == "r2c" else jplan.exec_c2c_inv(jc)
    return jplan, jc, jb


def _vs_reference(world, devices, cid, tol):
    """Every rank's blocks and the gathered arrays against the JAX plan."""
    shape, seq, tr, fields, dtype = PLANS[cid]
    jplan, jc, jb = _jax_run(devices, cid)
    jc_np, jb_np = np.asarray(jc), np.asarray(jb)
    split = {"ZY_Then_X": 1, "Z_Then_YX": 2, "Y_Then_ZX": 1}[seq]
    bs, bx = jc_np.shape[split] // P, jb_np.shape[0] // P
    for r in range(P):
        res = _result(world, r, cid)
        fwd = jc_np.take(range(r * bs, (r + 1) * bs), axis=split)
        assert res["local_fwd"].shape == fwd.shape
        assert res["local_fwd"].dtype == fwd.dtype, (r, cid)
        assert _rel(res["local_fwd"], fwd) <= tol, (r, "forward")
        back = jb_np[r * bx:(r + 1) * bx]
        assert _rel(res["local_back"], back) <= tol, (r, "roundtrip")
    res = _result(world, 0, cid)
    crop = jplan.crop_spectral(jc)
    assert res["crop_fwd"].shape == crop.shape == jplan.output_shape
    assert _rel(res["crop_fwd"], crop) <= tol
    assert _rel(res["crop_back"], jplan.crop_real(jb)) <= tol
    return res


def _same_bits(world, a, b):
    for r in range(P):
        ra, rb = _result(world, r, a), _result(world, r, b)
        for k in ("local_fwd", "local_back"):
            assert ra[k].dtype == rb[k].dtype
            assert np.array_equal(ra[k], rb[k]), (r, k, a, b)


def _reference_forward(x, seq):
    """numpy's R2C of the sequence's halved axis, then the C2Cs."""
    axis = 1 if seq == "Y_Then_ZX" else 2
    c = np.fft.rfft(x, axis=axis)
    for a in (0, 1, 2):
        if a != axis:
            c = np.fft.fft(c, axis=a)
    return c


# -- opt 1 ------------------------------------------------------------------


@pytest.mark.parametrize("comm", COMMS)
@pytest.mark.parametrize("seq", SEQS)
def test_opt1_forward_vs_reference(world, devices, seq, comm):
    cid = f"opt1-{seq}-{comm}"
    res = _vs_reference(world, devices, cid, 1e-5)
    shape = PLANS[cid][0]
    x = _input(shape, "r2c", "f32", SEED).astype(np.float64)
    assert _rel(res["crop_fwd"], _reference_forward(x, seq)) <= 1e-5


@pytest.mark.parametrize("comm", COMMS)
@pytest.mark.parametrize("seq", SEQS)
def test_opt1_roundtrip_unnormalized(world, seq, comm):
    cid = f"opt1-{seq}-{comm}"
    shape = PLANS[cid][0]
    x = _input(shape, "r2c", "f32", SEED)
    back = _result(world, 0, cid)["crop_back"]
    assert _rel(back, x * np.prod(shape)) <= 1e-5


@pytest.mark.parametrize("comm", COMMS)
@pytest.mark.parametrize("seq", SEQS)
def test_opt1_equals_opt0_bit_for_bit(world, seq, comm):
    _same_bits(world, f"opt1-{seq}-{comm}", f"opt0-{seq}-{comm}")


def test_realigned_pack_shape_matches_reference():
    from distributedfft_tpu.parallel.transpose import \
        realigned_pack_shape as jpack
    for shape, s in (((4, 8, 6), 1), ((8, 4, 6), 0), ((5, 7, 12), 2)):
        assert realigned_pack_shape(shape, s, 4) == jpack(shape, s, 4)
    with pytest.raises(ValueError, match="not divisible"):
        realigned_pack_shape((4, 6, 6), 1, 4)


# -- the pipelined all-to-all ------------------------------------------------


@pytest.mark.parametrize("bid", list(BARE))
def test_bare_pipelined_all_to_all_is_the_monolithic_one(world, bid):
    """Every chunk count (clamped past the extent), depth, realigned flag
    and wire: bit for bit ``all_to_all_transpose``; opt 1 too."""
    for r in range(P):
        res = _result(world, r, bid)
        for cplx in (True, False):
            for wire in ("native", "bf16"):
                mono = res[cplx, wire, "mono"]
                assert np.array_equal(res[cplx, wire, "opt1"], mono)
                for chunks in (1, 2, 3, 99):
                    for depth in (1, 2, 3):
                        got = res[cplx, wire, chunks, depth]
                        assert got.dtype == mono.dtype
                        assert np.array_equal(got, mono), (r, chunks, depth)


@pytest.mark.parametrize("wid", ["native", "wire16"])
@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("opt", [0, 1])
def test_pipelined_plan_is_the_monolithic_plan(world, opt, depth, wid):
    """``tests/test_overlap_tuning.py:128``: forward and inverse bit for
    bit the monolithic all-to-all's, on every rank."""
    cid = f"pipe-opt{opt}-d{depth}-{wid}"
    _same_bits(world, cid, f"mono-opt{opt}-{wid}")
    assert _result(world, 0, cid)["a2a_pipe_chunks"] == 2


@pytest.mark.parametrize("wid", ["native", "wire16"])
@pytest.mark.parametrize("opt", [0, 1])
def test_pipelined_plan_vs_reference(world, devices, opt, wid):
    cid = f"pipe-opt{opt}-d2-{wid}"
    _vs_reference(world, devices, cid, WIRE16_TOL if wid == "wire16"
                  else 1e-5)


def test_pipelined_c2c_is_the_monolithic_plan(world, devices):
    """``tests/test_overlap_tuning.py:166``: the c2c inverse too."""
    _same_bits(world, "pipe-c2c", "mono-c2c")
    _vs_reference(world, devices, "pipe-c2c", 1e-5)


def test_pipelined_pallas_plan_is_the_monolithic_plan(world):
    """Under "pallas", three pieces of Z_Then_YX's free y axis: bit for
    bit, the kernels (plain versions here) on every piece."""
    _same_bits(world, "pipe-pallas-Z_Then_YX", "mono-pallas-Z_Then_YX")
    assert _result(world, 0, "pipe-pallas-Z_Then_YX")["a2a_pipe_chunks"] == 3


# -- STREAMS -----------------------------------------------------------------


@pytest.mark.parametrize("comm", COMMS)
@pytest.mark.parametrize("seq", SEQS)
def test_streams_matches_sync(world, devices, seq, comm):
    """``tests/test_streams.py:36`` (double precision, 3 pieces): bit for
    bit SYNC under PEER2PEER, within 1e-12 under ALL2ALL; the roundtrip
    within 1e-10; and the JAX plan within 1e-12."""
    st, base = f"f64-Streams-{seq}-{comm}", f"f64-Sync-{seq}-{comm}"
    if comm == "Peer2Peer":
        _same_bits(world, st, base)
    for r in range(P):
        a, b = _result(world, r, st), _result(world, r, base)
        for k in ("local_fwd", "local_back"):
            assert _rel(a[k], b[k]) <= 1e-12, (r, k)
    shape = PLANS[st][0]
    x = _input(shape, "r2c", "f64", SEED)
    res = _vs_reference(world, devices, st, 1e-12)
    assert _rel(res["crop_back"] / np.prod(shape), x) <= 1e-10


@pytest.mark.parametrize("comm", COMMS)
def test_streams_uneven_extents(world, comm):
    """``tests/test_streams.py:52``: 20 x 16 x 16, Y_Then_ZX, 5 pieces."""
    cid = f"streams-uneven-{comm}"
    x = _input((20, 16, 16), "r2c", "f64", SEED)
    truth = np.fft.fft(np.fft.fft(np.fft.rfft(x, axis=1), axis=2), axis=0)
    np.testing.assert_allclose(_result(world, 0, cid)["crop_fwd"], truth,
                               rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("comm", COMMS)
def test_streams_pallas_matches_sync(world, comm):
    """Four pieces (the default) under "pallas" (the kernels' plain
    versions here): bit for bit SYNC under PEER2PEER, within float32
    rounding (1e-6) under ALL2ALL, whose pieces run their own products."""
    st = f"streams-pallas-{comm}"
    if comm == "Peer2Peer":
        _same_bits(world, st, "sync-pallas-All2All")
    for r in range(P):
        a, b = _result(world, r, st), _result(world, r, "sync-pallas-All2All")
        for k in ("local_fwd", "local_back"):
            assert _rel(a[k], b[k]) <= 1e-6, (r, k)


# -- plans on the matmul backend --------------------------------------------

# Dispatches of the matmul backend per direction on every rank: one per
# axis; no kernel launch.
_AXES_PER_DIRECTION = 3


@pytest.mark.parametrize("cid", list(MATMUL))
def test_matmul_backend_plan_matches_reference(world, devices, cid):
    shape, seq, tr, fields, dtype = PLANS[cid]
    res = _vs_reference(world, devices, cid,
                        1e-10 if dtype == "f64" else 5e-4)
    x = _input(shape, tr, dtype, SEED)
    if tr == "r2c":
        ref = _reference_forward(x.astype(np.float64), seq)
        assert _rel(res["crop_fwd"], ref) <= (1e-10 if dtype == "f64"
                                              else 5e-4)
    n = np.prod(shape)
    assert _rel(res["crop_back"] / n, x) <= (1e-10 if dtype == "f64"
                                             else 5e-4)
    for r in range(P):
        disp_f, launch_f, disp_i, launch_i = _result(world, r, cid)["counts"]
        assert disp_f == disp_i == {"matmul": _AXES_PER_DIRECTION}, (r, cid)
        assert not any(launch_f.values()) and not any(launch_i.values())


def test_ranks_import_no_jax(world):
    assert all(w["modules"] == [] for w in world), [w["modules"] for w in world]
