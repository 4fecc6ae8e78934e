"""The port's Batched2DFFTPlan over 4 gloo ranks on the CPU, against the JAX
package's ``Batched2DFFTPlan`` on a 4-device mesh and against numpy.

One 4-rank world is spawned for the whole file (a module fixture) and runs
every case; each case stays its own test. The ranks import this module to
find ``_rank_main``, so it imports neither JAX nor the JAX package at its
top: the references are computed in the parent, from the JAX plan under the
same Config fields.

Each rank holds its block of the padded global array (the batch for
``shard="batch"``, x then spectral y for ``shard="x"``); its forward and
inverse blocks are compared with the same slices of the JAX plan's padded
global result, the gathered ``crop_*`` arrays with numpy. The cases are
those of ``tests/test_batched2d.py`` (both shards, uneven batch and image,
c2c, Peer2Peer, one rank, validation, ``batch_chunk``, the staged surface,
testcases 0-3 with their CSV, the executable and its testcase-4 exit),
the batched cases of ``tests/test_ring.py``, ``tests/test_streams.py``
(both comm methods), ``tests/test_wire.py``, ``tests/test_overlap.py``,
``tests/test_overlap_tuning.py`` and ``tests/test_testcases.py`` (their
bit-equalities stay bit-equalities), STREAMS on fewer images than pieces,
the fused wire bit for bit the plain bf16 wire, and ``"pallas"`` with one
2048-point axis, x and then y. Tolerances: rel <= 1e-5 under ``"xla"`` in
float32, 2e-3 under ``"pallas"``, 2e-2 on the bf16 wire, 1e-12 in float64
(the JAX pins' 1e-9 against numpy).
"""

import contextlib
import io
import os
import pathlib
import pickle
import sys
import traceback

import numpy as np
import pytest
import torch

import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch.cli import batched as tbatched
from distributedfft_tpu_torch.parallel import multihost
from distributedfft_tpu_torch.testing import testcases as ttc
from distributedfft_tpu_torch.utils.timer import read_timer_csv

P = 4
FORBIDDEN = ("jax", "jaxlib", "distributedfft_tpu")
TOL = {"f32": 1e-5, "pallas": 2e-3, "wire16": 2e-2, "f64": 1e-12}
SEED = 2024
DP = {"double_prec": True}
_RO = {"send_method": "RingOverlap"}

# id -> ((batch, nx, ny), shard, transform, Config fields, precision,
# batch_chunk). Precision: "f32", "f64", "pallas" (float32 on the kernels'
# plain versions) or "wire16" (float32 on the bf16 wire).
CASES = {
    # tests/test_batched2d.py
    "rt-batch": ((16, 32, 32), "batch", "r2c", DP, "f64", None),
    "rt-x": ((16, 32, 32), "x", "r2c", DP, "f64", None),
    "uneven-batch": ((5, 12, 10), "batch", "r2c", DP, "f64", None),
    "uneven-image-x": ((3, 10, 9), "x", "r2c", DP, "f64", None),
    "c2c-x": ((4, 16, 16), "x", "c2c", DP, "f64", None),
    "c2c-batch": ((6, 10, 12), "batch", "c2c", DP, "f64", None),
    "p2p-x": ((4, 32, 32), "x", "r2c", dict(DP, comm_method="Peer2Peer"),
              "f64", None),
    "chunked-sharded-batch": ((16, 8, 8), "batch", "r2c", {}, "f32", 1),
    "harness-batch": ((8, 24, 16), "batch", "r2c", DP, "f64", None),
    "harness-x": ((8, 24, 16), "x", "r2c", DP, "f64", None),
    # tests/test_ring.py:187 (the default exchange is Peer2Peer)
    "default-x": ((8, 16, 16), "x", "r2c", DP, "f64", None),
    "ring-x": ((8, 16, 16), "x", "r2c", dict(DP, send_method="Ring"), "f64",
               None),
    # tests/test_overlap.py:127 and tests/test_overlap_tuning.py:97
    "ring-f32": ((8, 20, 16), "x", "r2c", {"send_method": "Ring"}, "f32",
                 None),
    "overlap-f32": ((8, 20, 16), "x", "r2c", _RO, "f32", None),
    "ring-wire16": ((8, 20, 16), "x", "r2c",
                    {"send_method": "Ring", "wire_dtype": "bf16"}, "wire16",
                    None),
    "overlap-wire16": ((8, 20, 16), "x", "r2c",
                       dict(_RO, wire_dtype="bf16"), "wire16", None),
    "overlap-wire16-fused": ((8, 20, 16), "x", "r2c",
                             dict(_RO, wire_dtype="bf16", fused_wire=True),
                             "wire16", None),
    "overlap-d8-s2": ((8, 20, 16), "x", "r2c",
                      dict(_RO, overlap_depth=8, overlap_subblocks=2), "f32",
                      None),
    # tests/test_overlap_tuning.py:153
    "a2a-opt1": ((8, 20, 16), "x", "r2c",
                 {"comm_method": "All2All", "opt": 1}, "f32", None),
    "a2a-pipe": ((8, 20, 16), "x", "r2c",
                 {"comm_method": "All2All", "opt": 1,
                  "overlap_subblocks": 2}, "f32", None),
    # One 2048-point axis under "pallas": x (after the exchange), then y.
    "pallas-x2048": ((2, 2048, 16), "x", "r2c", {"fft_backend": "pallas"},
                     "pallas", None),
    "pallas-y2048": ((2, 16, 2048), "x", "r2c", {"fft_backend": "pallas"},
                     "pallas", None),
    "pallas-batch": ((8, 16, 12), "batch", "r2c", {"fft_backend": "pallas"},
                     "pallas", 1),
}
# tests/test_wire.py:200: every rendering with the wire named native.
WIRE_RENDERINGS = {"a2a": {"comm_method": "All2All"},
                   "opt1": {"comm_method": "All2All", "opt": 1},
                   "p2p": {"comm_method": "Peer2Peer"},
                   "ring": {"send_method": "Ring"}}
for _r, _f in WIRE_RENDERINGS.items():
    CASES[f"wire-{_r}"] = ((8, 16, 16), "x", "r2c", dict(DP, **_f), "f64",
                           None)
    CASES[f"wire-{_r}-native"] = ((8, 16, 16), "x", "r2c",
                                  dict(DP, wire_dtype="native", **_f), "f64",
                                  None)
# tests/test_streams.py:144 (3 pieces), and 4 pieces of a batch of 2.
for _c in ("All2All", "Peer2Peer"):
    CASES[f"sync-{_c}"] = ((8, 16, 16), "x", "r2c",
                           dict(DP, comm_method=_c), "f64", None)
    CASES[f"streams-{_c}"] = ((8, 16, 16), "x", "r2c",
                              dict(DP, comm_method=_c, send_method="Streams",
                                   streams_chunks=3), "f64", None)
    CASES[f"sync-b2-{_c}"] = ((2, 16, 16), "x", "r2c",
                              dict(DP, comm_method=_c), "f64", None)
    CASES[f"streams-b2-{_c}"] = ((2, 16, 16), "x", "r2c",
                                 dict(DP, comm_method=_c,
                                      send_method="Streams", streams_chunks=4),
                                 "f64", None)
# Bit-equal pairs: (case, the case it equals, directions compared).
SAME_BITS = [
    ("ring-x", "default-x", ("fwd",)),
    ("overlap-f32", "ring-f32", ("fwd", "back")),
    ("overlap-wire16", "ring-wire16", ("fwd", "back")),
    ("overlap-wire16-fused", "overlap-wire16", ("fwd", "back")),
    ("overlap-d8-s2", "ring-f32", ("fwd", "back")),
    ("a2a-pipe", "a2a-opt1", ("fwd", "back")),
    ("streams-Peer2Peer", "sync-Peer2Peer", ("fwd", "back")),
    ("streams-b2-Peer2Peer", "sync-b2-Peer2Peer", ("fwd", "back")),
] + [(f"wire-{r}-native", f"wire-{r}", ("fwd", "back"))
     for r in WIRE_RENDERINGS]
HARNESS = ("batch", "x")
CLI = {"t3-batch": ["--shard", "batch", "-t", "3", "-d"],
       "t3-x": ["--shard", "x", "-t", "3", "-d"],
       "t0-batch-ck1": ["--shard", "batch", "--batch-chunk", "1", "-t", "0",
                        "-i", "2", "-w", "1"],
       "t0-x-a2a": ["--shard", "x", "-comm", "All2All", "-t", "0"]}
CLI_SIZE = ["-nx", "24", "-ny", "16", "-nz", "8"]


def _config(pkg, fields, **more):
    kw = dict(fields, **more)
    for k, enum in (("send_method", pkg.SendMethod),
                    ("comm_method", pkg.CommMethod)):
        if k in kw:
            kw[k] = enum(kw[k])
    return pkg.Config(**kw)


def _input(shape, transform, prec, seed=SEED):
    rng = np.random.default_rng(seed)
    x = rng.random(shape)
    if transform == "c2c":
        x = x + 1j * rng.random(shape)
        return x.astype(np.complex128 if prec == "f64" else np.complex64)
    return x.astype(np.float64 if prec == "f64" else np.float32)


def _truth(x, transform):
    c = np.fft.fft(x, axis=2) if transform == "c2c" else np.fft.rfft(x,
                                                                      axis=2)
    return np.fft.fft(c, axis=1)


# ---------------------------------------------------------------------------
# The ranks (no JAX here)
# ---------------------------------------------------------------------------


def _port_plan(cid, **more):
    shape, shard, tr, fields, _, ck = CASES[cid]
    return tdfft.Batched2DFFTPlan(*shape, tdfft.SlabPartition(P),
                                  _config(tdfft, fields, **more), shard=shard,
                                  transform=tr, batch_chunk=ck, device="cpu")


def _run_case(cid, _):
    shape, shard, tr, fields, prec, _ = CASES[cid]
    plan = _port_plan(cid)
    xl = plan.pad_input(_input(shape, tr, prec))
    fwd = plan.exec_forward(xl)
    back = plan.exec_inverse(fwd)
    return {"local_fwd": fwd.numpy(), "local_back": back.numpy(),
            "crop_fwd": plan.crop_spectral(fwd),
            "crop_back": plan.crop_real(back),
            "shapes": (plan.input_padded_shape, plan.output_padded_shape,
                       plan.local_input_shape, plan.local_output_shape),
            "a2a_pipe_chunks": plan._a2a_pipe_chunks()}


def _run_harness(shard, outdir):
    """The staged surface and testcases 0-3 of the JAX harness test's plan,
    (8, 24, 16) in float64, testcase 0's CSV under ``outdir``."""
    cfg = tdfft.Config(double_prec=True,
                       benchmark_dir=os.path.join(outdir, f"harness-{shard}"))
    plan = tdfft.Batched2DFFTPlan(8, 24, 16, tdfft.SlabPartition(P), cfg,
                                  shard=shard, device="cpu")
    xl = plan.pad_input(_input((8, 24, 16), "r2c", "f64"))
    y = xl
    for _, fn in plan.forward_stages():
        y = fn(y)
    z = y
    for _, fn in plan.inverse_stages():
        z = fn(z)
    out = {"staged_fwd": y.numpy(), "fused_fwd": plan.exec_forward(xl).numpy(),
           "staged_back": z.numpy(), "fused_back": plan.exec_inverse(y).numpy(),
           "descs": sorted({d for d, _ in plan.forward_stages()}
                           | {d for d, _ in plan.inverse_stages()}),
           "sections": plan.section_descriptions,
           "variant": plan.variant_name,
           "global_shape": plan.global_size.shape,
           "transform_axes": plan.transform_axes,
           "transform_size": plan.transform_size,
           "halved": plan.spectral_halved_axis}
    out["t0"] = ttc.testcase0(plan, iterations=2, warmup=1, dims=2)
    out["t1"] = ttc.testcase1(plan, dims=2, write_csv=False)
    out["t2"] = ttc.testcase2(plan, iterations=1, dims=2, write_csv=False)
    out["t3"] = ttc.testcase3(plan, iterations=1, dims=2, write_csv=False)
    return out


def _run_tc1_analytic(_, __):
    """``tests/test_testcases.py:55``: the batch axis keeps the sine
    samples in the analytic truth."""
    plan = ttc.make_plan("batched2d", tdfft.GlobalSize(16, 16, 8),
                         tdfft.SlabPartition(P),
                         tdfft.Config(double_prec=True), device="cpu")
    return {"kind": type(plan).__name__, "shard": plan.shard,
            "shape": plan.input_shape,
            "t1": ttc.testcase1(plan, write_csv=False, truth="analytic")}


def _run_cli(cid, outdir):
    bdir = os.path.join(outdir, f"cli-{cid}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tbatched.main(CLI_SIZE + CLI[cid] + ["-b", bdir,
                                                  "--emulate-devices",
                                                  str(P)])
    return {"rc": rc, "text": buf.getvalue(), "bdir": bdir}


def _rank_main(rank, addr, jobs, outdir):
    multihost.maybe_initialize(addr, P, rank, backend="gloo", timeout_s=120)
    runners = {"case": _run_case, "harness": _run_harness,
               "tc1": _run_tc1_analytic, "cli": _run_cli}
    results = {}
    for key, (kind, arg) in jobs.items():
        try:
            results[key] = runners[kind](arg, outdir)
        except Exception:  # noqa: BLE001 — reported by that case's test
            results[key] = {"error": traceback.format_exc()}
    results["modules"] = sorted(m for m in sys.modules
                                if m.split(".")[0] in FORBIDDEN)
    results["_outdir"] = outdir
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    multihost.shutdown()


# ---------------------------------------------------------------------------
# The parent: JAX references and comparisons
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    jobs = {cid: ("case", cid) for cid in CASES}
    jobs.update({f"staged-{s}": ("harness", s) for s in HARNESS})
    jobs["tc1-analytic"] = ("tc1", None)
    jobs.update({f"cli-{c}": ("cli", c) for c in CLI})
    outdir = tmp_path_factory.mktemp("batched2d")
    torch.multiprocessing.start_processes(
        _rank_main, args=(multihost.local_coordinator(), jobs, str(outdir)),
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


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def _mesh(devices):
    from distributedfft_tpu.parallel.mesh import make_slab_mesh
    return make_slab_mesh(P, devices)


def _jax_run(devices, cid):
    """The JAX plan of case ``cid`` on the same input: (plan, padded
    forward, padded inverse) as numpy."""
    import distributedfft_tpu as jdfft
    from distributedfft_tpu.models.batched2d import Batched2DFFTPlan
    shape, shard, tr, fields, prec, ck = CASES[cid]
    jplan = Batched2DFFTPlan(*shape, jdfft.SlabPartition(P),
                             _config(jdfft, fields), mesh=_mesh(devices),
                             shard=shard, transform=tr, batch_chunk=ck)
    jc = jplan.exec_forward(jplan.pad_input(_input(shape, tr, prec)))
    jb = jplan.exec_inverse(jc)
    return jplan, np.asarray(jc), np.asarray(jb)


def _blocks(a, axis, r):
    b = a.shape[axis] // P
    return a.take(range(r * b, (r + 1) * b), axis=axis)


def _vs_reference(world, devices, cid):
    """Every rank's blocks and the gathered arrays against the JAX plan,
    and the crops against numpy."""
    shape, shard, tr, fields, prec, _ = CASES[cid]
    tol = TOL[prec]
    jplan, jc, jb = _jax_run(devices, cid)
    in_ax, out_ax = (0, 0) if shard == "batch" else (1, 2)
    for r in range(P):
        res = _result(world, r, cid)
        assert res["shapes"][:2] == (jplan.input_padded_shape,
                                     jplan.output_padded_shape)
        fwd = _blocks(jc, out_ax, r)
        assert res["local_fwd"].shape == fwd.shape == res["shapes"][3]
        assert res["local_fwd"].dtype == fwd.dtype, (r, cid)
        assert _rel(res["local_fwd"], fwd) <= tol, (r, "forward")
        back = _blocks(jb, in_ax, r)
        assert res["local_back"].shape == back.shape == res["shapes"][2]
        assert _rel(res["local_back"], back) <= tol, (r, "roundtrip")
    res = _result(world, 0, cid)
    x = _input(shape, tr, prec)
    assert res["crop_fwd"].shape == jplan.output_shape
    assert _rel(res["crop_fwd"], jplan.crop_spectral(jc)) <= tol
    assert _rel(res["crop_fwd"], _truth(x.astype(np.complex128 if tr == "c2c"
                                                 else np.float64), tr)) <= \
        max(tol, 1e-12)
    assert _rel(res["crop_back"], jplan.crop_real(jb)) <= tol
    assert _rel(res["crop_back"] / (shape[1] * shape[2]), x) <= max(tol, 1e-12)
    return res


def _same_bits(world, a, b, keys=("fwd", "back")):
    for r in range(P):
        ra, rb = _result(world, r, a), _result(world, r, b)
        for k in keys:
            ka = f"local_{k}"
            assert ra[ka].dtype == rb[ka].dtype
            assert np.array_equal(ra[ka], rb[ka]), (r, k, a, b)


# -- every case against JAX and numpy ---------------------------------------


@pytest.mark.parametrize("cid", list(CASES))
def test_case_matches_reference(world, devices, cid):
    """``tests/test_batched2d.py``'s forward and roundtrip for both shards,
    uneven batch and image, c2c, Peer2Peer and the chunked batch shard,
    and every case of the renderings below: each rank's blocks against the
    JAX plan's, the crops against numpy."""
    _vs_reference(world, devices, cid)


def test_uneven_batch_pads_the_batch(world):
    res = _result(world, 0, "uneven-batch")
    assert res["shapes"][0] == (8, 12, 10)
    assert res["shapes"][2] == (2, 12, 10)
    res = _result(world, 0, "uneven-image-x")
    assert res["shapes"][:2] == ((3, 12, 9), (3, 10, 8))
    assert res["shapes"][2:] == ((3, 3, 9), (3, 10, 2))


@pytest.mark.parametrize("a,b,keys", SAME_BITS,
                         ids=[f"{a}=={b}" for a, b, _ in SAME_BITS])
def test_renderings_bit_equal(world, a, b, keys):
    """``tests/test_ring.py:187`` (the ring's forward is the default
    exchange's), ``tests/test_overlap.py:127`` (RING_OVERLAP is RING, both
    wires), ``tests/test_overlap_tuning.py:97`` (depth 8, two sub-blocks)
    and ``:153`` (the pipelined all-to-all is the monolithic one),
    ``tests/test_wire.py:200`` (the native wire named is the default), the
    fused wire (kernels 9 and 10's plain versions) is the plain bf16 wire,
    and STREAMS under PEER2PEER is SYNC (its pieced exchanges feed the same
    FFTs), on 8 images and on 2 with 4 pieces asked."""
    _same_bits(world, a, b, keys)


def test_pipelined_all_to_all_cuts_the_batch(world):
    assert _result(world, 0, "a2a-pipe")["a2a_pipe_chunks"] == 2
    assert _result(world, 0, "a2a-opt1")["a2a_pipe_chunks"] == 1


@pytest.mark.parametrize("comm", ["All2All", "Peer2Peer"])
@pytest.mark.parametrize("b", ["", "b2-"])
def test_streams_matches_sync(world, comm, b):
    """``tests/test_streams.py:144``: STREAMS (pieces of the batch) within
    1e-12 of SYNC, the roundtrip within 1e-10 of nx * ny * x; on 2 images
    with 4 pieces asked, 2 pieces of one image each on every rank."""
    st, base = f"streams-{b}{comm}", f"sync-{b}{comm}"
    for r in range(P):
        a, s = _result(world, r, st), _result(world, r, base)
        for k in ("local_fwd", "local_back"):
            assert _rel(a[k], s[k]) <= 1e-12, (r, k)
    shape = CASES[st][0]
    x = _input(shape, "r2c", "f64")
    back = _result(world, 0, st)["crop_back"]
    assert _rel(back / (shape[1] * shape[2]), x) <= 1e-10


def test_ring_roundtrip(world):
    """``tests/test_ring.py:187``: the ring's roundtrip within 1e-10."""
    x = _input((8, 16, 16), "r2c", "f64")
    back = _result(world, 0, "ring-x")["crop_back"]
    np.testing.assert_allclose(back, x * 16 * 16, rtol=1e-10, atol=1e-10)


# -- the staged surface, the testcases, the executable ----------------------


@pytest.mark.parametrize("shard", HARNESS)
def test_staged_matches_fused(world, shard):
    for r in range(P):
        res = _result(world, r, f"staged-{shard}")
        assert _rel(res["staged_fwd"], res["fused_fwd"]) <= 1e-12
        assert _rel(res["staged_back"], res["fused_back"]) <= 1e-12


@pytest.mark.parametrize("shard", HARNESS)
def test_stage_descs_and_protocol_match_jax(world, devices, shard):
    import distributedfft_tpu as jdfft
    from distributedfft_tpu.models.batched2d import Batched2DFFTPlan
    jplan = Batched2DFFTPlan(8, 24, 16, jdfft.SlabPartition(P),
                             jdfft.Config(double_prec=True),
                             mesh=_mesh(devices), shard=shard)
    res = _result(world, 0, f"staged-{shard}")
    assert set(res["descs"]) <= set(res["sections"])
    assert res["sections"] == jplan.section_descriptions
    jdescs = {d for d, _ in jplan.forward_stages()} | \
        {d for d, _ in jplan.inverse_stages()}
    assert set(res["descs"]) == jdescs
    assert res["variant"] == jplan.variant_name == f"batched2d_{shard}"
    assert res["global_shape"] == jplan.global_size.shape == (8, 24, 16)
    assert res["transform_axes"] == jplan.transform_axes
    assert res["transform_size"] == jplan.transform_size
    assert res["halved"] == jplan.spectral_halved_axis


@pytest.mark.parametrize("shard", HARNESS)
def test_testcases_0_to_3(world, tmp_path, devices, shard):
    """``tests/test_batched2d.py``'s harness test: testcase 0 writes two
    gathered blocks under ``batched2d_<shard>``, with the JAX plan's file
    name and sections; testcase 1's residual, testcase 3's roundtrip (nx *
    ny scale) within JAX's bounds."""
    from distributedfft_tpu.models.batched2d import Batched2DFFTPlan
    import distributedfft_tpu as jdfft
    from distributedfft_tpu.testing import testcases as jtc
    res = _result(world, 0, f"staged-{shard}")
    assert res["t0"]["mean_ms"] > 0 and res["t0"]["fused_mean_ms"] > 0
    assert res["t1"]["residual_sum"] < 1e-6
    assert res["t2"]["mean_ms"] > 0
    assert res["t3"]["max_error"] < 1e-8
    for r in range(1, P):
        mine = _result(world, r, f"staged-{shard}")["t3"]
        assert (mine["avg_error"], mine["max_error"]) == \
            (res["t3"]["avg_error"], res["t3"]["max_error"])
    bdir = pathlib.Path(world[0]["_outdir"]) / f"harness-{shard}"
    mine = sorted(p.relative_to(bdir) for p in bdir.rglob("*.csv"))
    assert mine and mine[0].parts[0] == f"batched2d_{shard}"
    blocks = read_timer_csv(str(bdir / mine[0]))
    assert len(blocks) == 2 and "Run complete" in blocks[0]
    assert set(blocks[0]) == set(res["sections"])
    jdir = tmp_path / "jax"
    jplan = Batched2DFFTPlan(8, 24, 16, jdfft.SlabPartition(P),
                             jdfft.Config(double_prec=True,
                                          benchmark_dir=str(jdir)),
                             mesh=_mesh(devices), shard=shard)
    jtc.testcase0(jplan, iterations=2, warmup=1, dims=2)
    theirs = sorted(p.relative_to(jdir) for p in jdir.rglob("*.csv"))
    assert mine == theirs
    assert set(read_timer_csv(str(jdir / theirs[0]))[0]) == set(blocks[0])


def test_tc1_analytic_truth(world):
    """``tests/test_testcases.py:55``: ``make_plan("batched2d")`` builds the
    x-split plan from the (batch, nx, ny) slots, and the analytic truth
    keeps the batch axis's sine samples."""
    for r in range(P):
        res = _result(world, r, "tc1-analytic")
        assert (res["kind"], res["shard"], res["shape"]) == \
            ("Batched2DFFTPlan", "x", (16, 16, 8))
        assert res["t1"]["residual_sum"] < 1e-6


def _printed(text, key):
    line = next(ln for ln in text.splitlines() if ln.startswith(key))
    return float(line[len(key):].split()[0])


@pytest.mark.parametrize("cid", list(CLI))
def test_executable_writes_jax_csv(world, devices, tmp_path, cid):
    """``dfft-torch-batched`` in every rank of the world: exit 0, testcase
    3's result within JAX's bound, and the CSV the JAX executable writes
    for the same flags at ``-p 4``."""
    from distributedfft_tpu.cli import batched as jbatched
    for r in range(P):
        assert _result(world, r, f"cli-{cid}")["rc"] == 0
    res = _result(world, 0, f"cli-{cid}")
    if "-t" in CLI[cid] and CLI[cid][CLI[cid].index("-t") + 1] == "3":
        assert _printed(res["text"], "Result (max): ") < 1e-8
    else:
        assert _printed(res["text"], "Run complete: ") > 0
    bdir = pathlib.Path(res["bdir"])
    mine = sorted(p.relative_to(bdir) for p in bdir.rglob("*.csv"))
    jdir = tmp_path / "jax"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = jbatched.main(CLI_SIZE + CLI[cid] + ["-b", str(jdir), "-p",
                                                  str(P), "--emulate-devices",
                                                  "8"])
    assert rc == 0
    theirs = sorted(p.relative_to(jdir) for p in jdir.rglob("*.csv"))
    assert mine == theirs and len(mine) == 1
    assert set(read_timer_csv(str(bdir / mine[0]))[0]) == \
        set(read_timer_csv(str(jdir / theirs[0]))[0])


def test_executable_refuses_testcase4():
    assert tbatched.main(["-nx", "8", "-ny", "8", "-nz", "4", "-t", "4",
                          "--emulate-devices", str(P)]) == 2


def test_ranks_import_no_jax(world):
    assert all(w["modules"] == [] for w in world), [w["modules"] for w in world]


# -- one rank and validation (no world) -------------------------------------


def test_single_device_and_chunked(devices):
    """``tests/test_batched2d.py``'s one-rank forward and ``TestBatchChunk``
    (chunked within 1e-6 of the whole stack), against the JAX plan."""
    from distributedfft_tpu.models.batched2d import Batched2DFFTPlan
    x = _input((8, 16, 16), "r2c", "f32")
    base = tdfft.Batched2DFFTPlan(8, 16, 16, tdfft.SlabPartition(1),
                                  device="cpu")
    ck = tdfft.Batched2DFFTPlan(8, 16, 16, tdfft.SlabPartition(1),
                                batch_chunk=2, device="cpu")
    c = base.exec_forward(x)
    assert _rel(c.numpy(), _truth(x.astype(np.float64), "r2c")) <= 1e-5
    jc = np.asarray(Batched2DFFTPlan(8, 16, 16,
                                     tdfft.SlabPartition(1)).exec_forward(x))
    assert _rel(c.numpy(), jc) <= 1e-5
    np.testing.assert_allclose(ck.exec_forward(x).numpy(), c.numpy(),
                               rtol=1e-6, atol=1e-6 * np.abs(c.numpy()).max())
    np.testing.assert_allclose(ck.exec_inverse(c).numpy(),
                               base.exec_inverse(c).numpy(), rtol=1e-6,
                               atol=1e-6 * 16 * 16)
    assert ck.variant_name == "batched2d_batch_ck2"
    assert base.forward_stages()[0][0] == "2D FFT X-Y-Direction"


def test_validation():
    one, eight = tdfft.SlabPartition(1), tdfft.SlabPartition(8)
    with pytest.raises(ValueError, match="shard"):
        tdfft.Batched2DFFTPlan(4, 16, 16, eight, shard="y", device="cpu")
    with pytest.raises(ValueError, match="transform"):
        tdfft.Batched2DFFTPlan(4, 16, 16, one, transform="r2r", device="cpu")
    with pytest.raises(ValueError, match="positive"):
        tdfft.Batched2DFFTPlan(0, 16, 16, eight, device="cpu")
    plan = tdfft.Batched2DFFTPlan(4, 16, 16, one, device="cpu")
    with pytest.raises(ValueError, match="expected"):
        plan.exec_forward(np.zeros((4, 8, 8)))
    with pytest.raises(ValueError, match="expected"):
        plan.exec_inverse(np.zeros((4, 16, 16), np.complex64))


def test_chunk_validation():
    one = tdfft.SlabPartition(1)
    with pytest.raises(ValueError, match="divide"):
        tdfft.Batched2DFFTPlan(8, 16, 16, one, batch_chunk=3, device="cpu")
    with pytest.raises(ValueError, match="shard='batch'"):
        tdfft.Batched2DFFTPlan(8, 16, 16, tdfft.SlabPartition(8), shard="x",
                               batch_chunk=2, device="cpu")
    with pytest.raises(ValueError, match="positive"):
        tdfft.Batched2DFFTPlan(8, 16, 16, one, batch_chunk=-1, device="cpu")
    plan = tdfft.Batched2DFFTPlan(8, 16, 16, one, batch_chunk=0, device="cpu")
    assert plan.batch_chunk is None and plan.variant_name == "batched2d_batch"


def test_later_items_raise():
    """``fft_backend="auto"`` raised naming item 11 until the wisdom
    resolution was ported: it now resolves to a measured backend."""
    plan = tdfft.Batched2DFFTPlan(4, 8, 8, tdfft.SlabPartition(1),
                                  tdfft.Config(fft_backend="auto",
                                               use_wisdom=False),
                                  device="cpu")
    assert not plan.config.unresolved()
    assert plan.config.fft_backend in ("xla", "matmul", "matmul-r2",
                                       "pallas")
