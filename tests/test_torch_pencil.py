"""The port's PencilFFTPlan over 8 gloo ranks on the CPU, against the JAX
package's ``PencilFFTPlan`` on the 8-device mesh and against numpy.

One 8-rank world is spawned for the whole file (a module fixture) and runs
every case, on the grids of the JAX tests: 2 x 4, 4 x 2, 1 x 8 and 8 x 1.
Each case stays its own test. The ranks import this module to find
``_rank_main``, so it imports neither JAX nor the JAX package at its top:
the references are computed in the parent, from the JAX plan under the
same Config fields.

Each rank holds its pencil of the padded global array (local in, local
out); its forward and inverse blocks are compared with the same slices of
the JAX plan's padded global result, and the gathered ``crop_*`` arrays
with numpy. The cases are those of ``tests/test_pencil.py`` (forward, the
comm matrix x opt, partial depths, uneven extents, the size tables, one
rank), the pencil cases of ``tests/test_c2c.py``, ``tests/test_streams.py``,
``tests/test_ring.py``, ``tests/test_wire.py``, ``tests/test_overlap.py``
and ``tests/test_overlap_tuning.py`` (their bit-equalities stay
bit-equalities), and the fused wire on a ring. Tolerances: rel <= 1e-5
under ``"xla"`` in float32, 2e-3 under ``"pallas"``, 2e-2 on the bf16
wire, 1e-12 in float64 (the JAX pins' 1e-10 against numpy).
"""

import os
import pickle
import sys
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist

import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch.parallel import mesh as tmesh
from distributedfft_tpu_torch.parallel import multihost

P = 8
GRIDS = [(2, 4), (4, 2), (1, 8), (8, 1)]
FORBIDDEN = ("jax", "jaxlib", "distributedfft_tpu")
TOL = {"f32": 1e-5, "pallas": 2e-3, "wire16": 2e-2, "f64": 1e-12}
SEED = 1234
G20 = (20, 16, 16)
# The stages split over (p1, p2): input and depth 1, depth 2, depth 3.
SPLIT = {1: (0, 1), 2: (0, 2), 3: (1, 2)}

# id -> (global shape, grid, transform, Config fields, precision, depths).
# Precision: "f32", "f64", "pallas" (float32 on the kernels' plain
# versions) or "wire16" (float32, the bf16 wire).
CASES = {}
for _g in GRIDS:
    CASES[f"fwd-{_g[0]}x{_g[1]}"] = ((16, 16, 16), _g, "r2c", {}, "f32",
                                     (3,))
for _c1 in ("All2All", "Peer2Peer"):
    for _c2 in ("All2All", "Peer2Peer"):
        for _o in (0, 1):
            CASES[f"comm-{_c1}-{_c2}-opt{_o}"] = (
                (16, 16, 16), (2, 4), "r2c",
                dict(comm_method=_c1, comm_method2=_c2, opt=_o), "f64", (3,))
CASES["partial"] = ((16, 16, 16), (2, 4), "r2c", {}, "f64", (1, 2, 3))
for _g in ((2, 4), (4, 2)):
    CASES[f"uneven-{_g[0]}x{_g[1]}"] = ((10, 6, 9), _g, "r2c", {}, "f64",
                                        (3,))
CASES["pallas-2x4"] = ((16, 16, 16), (2, 4), "r2c",
                       dict(fft_backend="pallas"), "pallas", (1, 2, 3))
CASES["pallas-uneven-4x2"] = ((10, 6, 9), (4, 2), "r2c",
                              dict(fft_backend="pallas"), "pallas", (3,))
# tests/test_c2c.py
for _g in ((2, 4), (8, 1)):
    CASES[f"c2c-{_g[0]}x{_g[1]}"] = ((16, 16, 16), _g, "c2c", {}, "f64",
                                     (3,))
CASES["c2c-partial"] = ((16, 16, 16), (2, 4), "c2c", {}, "f64", (1, 2))
# tests/test_streams.py
for _g in ((2, 4), (4, 2)):
    for _c1, _c2 in (("All2All", "All2All"), ("Peer2Peer", "Peer2Peer"),
                     ("All2All", "Peer2Peer")):
        CASES[f"streams-{_g[0]}x{_g[1]}-{_c1}-{_c2}"] = (
            G20, _g, "r2c", dict(comm_method=_c1, comm_method2=_c2,
                                 send_method="Streams", streams_chunks=3),
            "f64", (3,))
CASES["streams-partial"] = ((16, 16, 16), (2, 4), "r2c",
                            dict(send_method="Streams", streams_chunks=2),
                            "f64", (1, 2))
# tests/test_ring.py, tests/test_wire.py, tests/test_overlap.py,
# tests/test_overlap_tuning.py: 20 x 16 x 16 on 2 x 4 in float32.
RENDERINGS = {"a2a": dict(comm_method="All2All"),
              "opt1": dict(comm_method="All2All", opt=1),
              "p2p": dict(comm_method="Peer2Peer"),
              "ring": dict(send_method="Ring")}
CASES["base"] = (G20, (2, 4), "r2c", {}, "f32", (1, 2, 3))
CASES["ring-truth-4x2"] = (G20, (4, 2), "r2c", dict(send_method="Ring"),
                           "f64", (3,))
for _r, _f in RENDERINGS.items():
    CASES[f"native-{_r}"] = (G20, (2, 4), "r2c", dict(_f), "f32", (1, 2, 3))
    CASES[f"wire16-{_r}"] = (G20, (2, 4), "r2c",
                             dict(_f, wire_dtype="bf16"), "wire16", (3,))
for _w in ("native", "bf16"):
    for _s in ("Ring", "RingOverlap"):
        CASES[f"{_s}-{_w}"] = (G20, (2, 4), "r2c",
                               dict(send_method=_s, wire_dtype=_w), "f32",
                               (2, 3))
CASES["RingOverlap-d4-s2"] = (G20, (2, 4), "r2c",
                              dict(send_method="RingOverlap", overlap_depth=4,
                                   overlap_subblocks=2), "f32", (3,))
CASES["a2a-mono-opt1"] = (G20, (2, 4), "r2c",
                          dict(comm_method="All2All", opt=1), "f32", (3,))
CASES["a2a-pipe-opt1"] = (G20, (2, 4), "r2c",
                          dict(comm_method="All2All", opt=1,
                               overlap_subblocks=2), "f32", (3,))
# The fused wire (kernels 9 and 10's plain versions) on a ring, against
# the plain wire layer and the JAX plan's fused wire (interpret mode).
_RO16 = dict(send_method="RingOverlap", wire_dtype="bf16",
             fft_backend="pallas")
CASES["ring16-plain"] = ((16, 16, 16), (2, 4), "r2c", _RO16, "wire16", (3,))
CASES["ring16-fused"] = ((16, 16, 16), (2, 4), "r2c",
                         dict(_RO16, fused_wire=True), "wire16", (3,))
# Exchanges over one-rank groups: the bf16 wire's rounding stays (the JAX
# all-to-all and point-to-point encode over a one-device axis too) and the
# ring passes the block through; nothing is posted over the one-rank group.
for _r, _g in (("a2a", (1, 8)), ("p2p", (8, 1)), ("ring", (1, 8)),
               ("streams", (8, 1))):
    _f = dict(RENDERINGS.get(_r, dict(comm_method="All2All",
                                      send_method="Streams")),
              wire_dtype="bf16")
    CASES[f"one-rank-{_r}-{_g[0]}x{_g[1]}"] = ((16, 16, 16), _g, "r2c", _f,
                                               "f64", (3,))


def _config(pkg, fields, precision):
    kw = dict(fields)
    for k, enum in (("send_method", pkg.SendMethod),
                    ("comm_method", pkg.CommMethod),
                    ("comm_method2", pkg.CommMethod)):
        if k in kw:
            kw[k] = enum.parse(kw[k])
    if precision == "f64":
        kw["double_prec"] = True
    return pkg.Config(**kw)


def _input(shape, transform, precision, seed=SEED):
    rng = np.random.default_rng(seed)
    x = rng.random(shape)
    if transform == "c2c":
        x = x + 1j * rng.random(shape)
        return x.astype(np.complex128 if precision == "f64" else np.complex64)
    return x.astype(np.float64 if precision == "f64" else np.float32)


def _truth(x, dims, transform):
    c = np.fft.fft(x, axis=2) if transform == "c2c" else np.fft.rfft(x, axis=2)
    for a in (1, 0)[:dims - 1]:
        c = np.fft.fft(c, axis=a)
    return c


def _scale(shape, dims):
    return {1: shape[2], 2: shape[2] * shape[1], 3: int(np.prod(shape))}[dims]


# ---------------------------------------------------------------------------
# The ranks (no JAX here)
# ---------------------------------------------------------------------------


def _count_one_rank_posts():
    """Wrap the collectives the exchanges post; returns a list that gets
    one entry per call over a one-rank group."""
    hits = []
    a2a, batch = dist.all_to_all_single, dist.batch_isend_irecv

    def all_to_all_single(*a, group=None, **k):
        if dist.get_world_size(group) == 1:
            hits.append("all_to_all_single")
        return a2a(*a, group=group, **k)

    def batch_isend_irecv(ops):
        if ops and dist.get_world_size(ops[0].group) == 1:
            hits.append("batch_isend_irecv")
        return batch(ops)

    dist.all_to_all_single = all_to_all_single
    dist.batch_isend_irecv = batch_isend_irecv
    return hits


def _run_case(cid, hits):
    shape, grid, tr, fields, prec, depths = CASES[cid]
    plan = tdfft.PencilFFTPlan(tdfft.GlobalSize(*shape),
                               tdfft.PencilPartition(*grid),
                               _config(tdfft, fields, prec), transform=tr,
                               device="cpu")
    x = _input(shape, tr, prec)
    out = {"coords": plan.coords}
    del hits[:]
    for d in depths:
        xl = plan.pad_input(x)
        c = plan.exec_r2c(xl, d) if tr == "r2c" else plan.exec_c2c(xl, d)
        back = plan.exec_c2r(c, d) if tr == "r2c" else plan.exec_c2c_inv(c, d)
        out[d] = {"fwd": c.numpy(), "back": back.numpy(),
                  "crop_fwd": plan.crop_spectral(c, d),
                  "crop_back": plan.crop_real(back),
                  "shape_fwd": plan.local_output_shape_for(d),
                  "slices_fwd": plan.local_slices(output=True, dims=d)}
    out["one_rank_posts"] = list(hits)
    out["input_shape"] = plan.local_input_shape
    out["input_slices"] = plan.local_slices()
    return out


def _run_groups():
    """Each grid's groups: this rank's coordinate, its group ranks and the
    global ranks of both groups."""
    out = {}
    for p1, p2 in GRIDS:
        row, col = tmesh.make_pencil_groups(p1, p2)
        out[p1, p2] = (dist.get_rank(row), dist.get_rank(col),
                       dist.get_process_group_ranks(row),
                       dist.get_process_group_ranks(col))
    return out


def _run_tables():
    out = {}
    for shape in ((16, 16, 16), (16, 6, 9)):
        plan = tdfft.PencilFFTPlan(tdfft.GlobalSize(*shape),
                                   tdfft.PencilPartition(2, 4),
                                   tdfft.Config(), device="cpu")
        out[shape] = {
            "dims": {s: plan.partition_dims(s)
                     for s in ("input", "transposed", "output")},
            "in_x": plan.in_sizes("x"), "in_default": plan.in_sizes(),
            "in_y": plan.in_sizes("y"), "out_y": plan.out_sizes("y"),
            "out_z": plan.out_sizes("z"),
            "padded": {d: plan.output_padded_shape_for(d) for d in (1, 2, 3)},
            "input_padded": plan.input_padded_shape}
    return out


def _raises(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the test reads the type
        return type(e).__name__, str(e)
    return None


def _run_errors():
    g = tdfft.GlobalSize(16, 16, 16)
    plan = tdfft.PencilFFTPlan(g, tdfft.PencilPartition(2, 4),
                               tdfft.Config(), device="cpu")
    xl = plan.pad_input(np.zeros(g.shape, np.float32))
    row, col = tmesh.make_pencil_groups(2, 4)
    return {
        "bad_dims": _raises(lambda: plan.exec_r2c(xl, dims=4)),
        "bad_shape": _raises(lambda: plan.exec_r2c(torch.zeros(4, 4, 4))),
        "c2c_on_r2c": _raises(lambda: plan.exec_c2c(xl)),
        "world_mismatch": _raises(lambda: tmesh.make_pencil_groups(2, 2)),
        "swapped_groups": _raises(lambda: tdfft.PencilFFTPlan(
            g, tdfft.PencilPartition(2, 4), tdfft.Config(), device="cpu",
            groups=(col, row))),
    }


def _rank_main(rank, addr, outdir):
    multihost.maybe_initialize(addr, P, rank, backend="gloo", timeout_s=180)
    hits = _count_one_rank_posts()
    results = {}
    jobs = [(cid, lambda c=cid: _run_case(c, hits)) for cid in CASES]
    jobs += [("groups", _run_groups), ("tables", _run_tables),
             ("errors", _run_errors)]
    for cid, fn in jobs:
        try:
            results[cid] = fn()
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
    outdir = tmp_path_factory.mktemp("pencil")
    torch.multiprocessing.start_processes(
        _rank_main, args=(multihost.local_coordinator(), str(outdir)),
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


def _block(arr, grid, stage, coords):
    """Rank ``coords``'s block of a padded global array at ``stage``."""
    a1, a2 = SPLIT[stage]
    b1, b2 = arr.shape[a1] // grid[0], arr.shape[a2] // grid[1]
    i, j = coords
    arr = arr.take(range(i * b1, (i + 1) * b1), axis=a1)
    return arr.take(range(j * b2, (j + 1) * b2), axis=a2)


def _jax_plan(cid):
    import distributedfft_tpu as jdfft
    shape, grid, tr, fields, prec, _ = CASES[cid]
    return jdfft.PencilFFTPlan(jdfft.GlobalSize(*shape),
                               jdfft.PencilPartition(*grid),
                               _config(jdfft, fields, prec), transform=tr)


def _vs_jax(world, cid):
    """Every rank's forward and inverse blocks at every depth against the
    JAX plan's padded global results."""
    shape, grid, tr, fields, prec, depths = CASES[cid]
    jplan = _jax_plan(cid)
    x = _input(shape, tr, prec)
    tol = TOL[prec]
    for d in depths:
        jc = jplan.exec_r2c(x, dims=d) if tr == "r2c" else \
            jplan.exec_c2c(x, dims=d)
        jb = jplan.exec_c2r(jc, dims=d) if tr == "r2c" else \
            jplan.exec_c2c_inv(jc, dims=d)
        jc, jb = np.asarray(jc), np.asarray(jb)
        for r in range(P):
            res = _result(world, r, cid)
            co = res["coords"]
            fwd = _block(jc, grid, d, co)
            assert res[d]["fwd"].shape == fwd.shape, (r, d)
            assert _rel(res[d]["fwd"], fwd) <= tol, (r, d, "forward")
            back = _block(jb, grid, 1, co)
            assert res[d]["back"].shape == back.shape, (r, d)
            assert _rel(res[d]["back"], back) <= tol, (r, d, "inverse")


def _vs_truth(world, cid, tol=None):
    """The gathered forward against numpy and the roundtrip against the
    input times the transformed extents, at every depth."""
    shape, grid, tr, fields, prec, depths = CASES[cid]
    x = _input(shape, tr, prec)
    tol = TOL[prec] if tol is None else tol
    for d in depths:
        res = _result(world, 0, cid)[d]
        truth = _truth(x.astype(np.complex128 if tr == "c2c"
                                else np.float64), d, tr)
        assert res["crop_fwd"].shape == truth.shape
        assert _rel(res["crop_fwd"], truth) <= max(tol, 1e-10), (cid, d)
        assert res["crop_back"].shape == x.shape
        assert _rel(res["crop_back"] / _scale(shape, d), x) <= \
            max(tol, 1e-10), (cid, d)


def _same_bits(world, a, b, depths=None):
    for r in range(P):
        ra, rb = _result(world, r, a), _result(world, r, b)
        for d in depths or CASES[a][5]:
            for k in ("fwd", "back"):
                assert ra[d][k].dtype == rb[d][k].dtype
                assert np.array_equal(ra[d][k], rb[d][k]), (r, d, k, a, b)


# -- tests/test_pencil.py ----------------------------------------------------


@pytest.mark.parametrize("grid", GRIDS, ids=[f"{a}x{b}" for a, b in GRIDS])
def test_forward_vs_reference(world, devices, grid):
    cid = f"fwd-{grid[0]}x{grid[1]}"
    _vs_jax(world, cid)
    _vs_truth(world, cid)


@pytest.mark.parametrize("opt", [0, 1])
@pytest.mark.parametrize("comm2", ["All2All", "Peer2Peer"])
@pytest.mark.parametrize("comm1", ["All2All", "Peer2Peer"])
def test_comm_matrix(world, devices, comm1, comm2, opt):
    """Per-transpose strategy matrix (``-comm1/-comm2``) x opt: the JAX
    plan, numpy, and bit for bit the all-to-all at opt 0."""
    cid = f"comm-{comm1}-{comm2}-opt{opt}"
    _vs_jax(world, cid)
    _vs_truth(world, cid)
    _same_bits(world, cid, "comm-All2All-All2All-opt0")


def test_partial_dims(world, devices):
    """Depths 1, 2 and 3, the reference's ``--fft-dim``."""
    _vs_jax(world, "partial")
    _vs_truth(world, "partial")


@pytest.mark.parametrize("grid", [(2, 4), (4, 2)], ids=["2x4", "4x2"])
def test_uneven_extents(world, devices, grid):
    """10 x 6 x 9: (4, 2) pads x over p1 (10 -> 12), y over p1 on the way
    out (6 -> 8) and the halved z over p2 (5 -> 6); (2, 4) pads y over p2
    on the way in (6 -> 8) and the halved z over p2 (5 -> 8)."""
    cid = f"uneven-{grid[0]}x{grid[1]}"
    _vs_jax(world, cid)
    _vs_truth(world, cid)
    want = {(2, 4): ((5, 2, 9), (10, 3, 2)),
            (4, 2): ((3, 3, 9), (10, 2, 3))}[grid]
    for r in range(P):
        res = _result(world, r, cid)
        assert (res["input_shape"], res[3]["shape_fwd"]) == want


@pytest.mark.parametrize("grid", [(2, 4), (4, 2)], ids=["2x4", "4x2"])
def test_pallas_plan_vs_reference(world, devices, grid):
    """Under "pallas" (the kernels' plain versions here) against the JAX
    plan's Pallas kernels in interpret mode: every depth on 2 x 4, the
    uneven cube on 4 x 2."""
    cid = "pallas-2x4" if grid == (2, 4) else "pallas-uneven-4x2"
    _vs_jax(world, cid)
    _vs_truth(world, cid)


def test_partition_dims_tables(world, devices):
    """``partition_dims`` and the size tables against the JAX plan's
    (``tests/test_pencil.py``'s tables, 16^3 and 16 x 6 x 9 on 2 x 4)."""
    import distributedfft_tpu as jdfft
    tables = _result(world, 0, "tables")
    for shape, t in tables.items():
        jplan = jdfft.PencilFFTPlan(jdfft.GlobalSize(*shape),
                                    jdfft.PencilPartition(2, 4),
                                    jdfft.Config())
        for s in ("input", "transposed", "output"):
            jd = jplan.partition_dims(s)
            assert (t["dims"][s].size_x, t["dims"][s].size_y,
                    t["dims"][s].size_z) == (jd.size_x, jd.size_y, jd.size_z)
            assert t["dims"][s].start_y == jd.start_y
        assert t["in_x"] == t["in_default"] == jplan.in_sizes("x")
        assert t["in_y"] == jplan.in_sizes("y")
        assert t["out_y"] == jplan.out_sizes("y")
        assert t["out_z"] == jplan.out_sizes("z")
        assert t["input_padded"] == jplan.input_padded_shape
        for d in (1, 2, 3):
            assert t["padded"][d] == jplan.output_padded_shape_for(d)
    t = tables[(16, 6, 9)]
    assert t["in_y"] == [2, 2, 2, 0] and t["out_z"] == [2, 2, 1, 0]
    assert tables[(16, 16, 16)]["dims"]["transposed"].size_z == (3, 3, 3, 0)


def test_bad_dims_and_shapes(world):
    err = _result(world, 0, "errors")
    assert err["bad_dims"][0] == "ValueError" and "dims" in err["bad_dims"][1]
    assert err["bad_shape"][0] == "ValueError" and \
        "input block" in err["bad_shape"][1]
    assert err["c2c_on_r2c"][0] == "TypeError" and \
        "transform='r2c'" in err["c2c_on_r2c"][1]


def test_group_validation(world):
    """A grid the world does not hold, and groups of the wrong sizes,
    raise (``tests/test_pencil.py``'s mesh validation)."""
    err = _result(world, 0, "errors")
    assert err["world_mismatch"][0] == "ValueError" and \
        "world has 8" in err["world_mismatch"][1]
    assert err["swapped_groups"][0] == "ValueError"


@pytest.mark.parametrize("grid", GRIDS, ids=[f"{a}x{b}" for a, b in GRIDS])
def test_groups_follow_the_reference_rank_layout(world, grid):
    """Rank (i, j) = i * p2 + j; the row group holds the p2 ranks of row i
    in ascending order (group rank j), the column group the p1 ranks of
    column j (group rank i)."""
    p1, p2 = grid
    for r in range(P):
        j, i, row, col = _result(world, r, "groups")[p1, p2]
        assert r == i * p2 + j
        assert row == [i * p2 + jj for jj in range(p2)]
        assert col == [ii * p2 + j for ii in range(p1)]


def test_best_pencil_grid_matches_jax():
    from distributedfft_tpu.parallel.mesh import best_pencil_grid
    for n in range(1, 65):
        assert tdfft.best_pencil_grid(n) == best_pencil_grid(n)


def test_make_pencil_groups_needs_a_world():
    with pytest.raises(RuntimeError, match="torch.distributed world"):
        tmesh.make_pencil_groups(2, 2)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("transform", ["r2c", "c2c"])
def test_single_device_per_axis(devices, backend, transform):
    """One rank (``tests/test_pencil.py::test_single_device_fallback``,
    ``tests/test_c2c.py::test_single_device_c2c``): every depth against
    the JAX plan and numpy."""
    import distributedfft_tpu as jdfft
    shape = (12, 12, 12)
    f64 = backend == "xla"
    prec = "f64" if f64 else "pallas"
    x = _input(shape, transform, prec)
    plan = tdfft.PencilFFTPlan(tdfft.GlobalSize(*shape),
                               tdfft.PencilPartition(1, 1),
                               tdfft.Config(double_prec=f64,
                                            fft_backend=backend),
                               transform=transform, device="cpu")
    jplan = jdfft.PencilFFTPlan(jdfft.GlobalSize(*shape),
                                jdfft.PencilPartition(1, 1),
                                jdfft.Config(double_prec=f64,
                                             fft_backend=backend),
                                transform=transform)
    assert plan.fft3d and plan.local_input_shape == shape
    fwd = plan.exec_r2c if transform == "r2c" else plan.exec_c2c
    inv = plan.exec_c2r if transform == "r2c" else plan.exec_c2c_inv
    jfwd = jplan.exec_r2c if transform == "r2c" else jplan.exec_c2c
    jinv = jplan.exec_c2r if transform == "r2c" else jplan.exec_c2c_inv
    for d in (1, 2, 3):
        c = fwd(plan.pad_input(x), d)
        jc = jfwd(x, dims=d)
        assert _rel(c.numpy(), np.asarray(jc)) <= TOL[prec], d
        assert _rel(plan.crop_spectral(c, d), _truth(x, d, transform)) <= \
            max(TOL[prec], 1e-10)
        back = inv(c, d)
        assert _rel(back.numpy(), np.asarray(jinv(jc, dims=d))) <= TOL[prec]
        assert _rel(plan.crop_real(back) / _scale(shape, d), x) <= \
            max(TOL[prec], 1e-10)


def test_mode_guards_and_transform_validation():
    g = tdfft.GlobalSize(8, 8, 8)
    r2c = tdfft.PencilFFTPlan(g, tdfft.PencilPartition(1, 1), device="cpu")
    c2c = tdfft.PencilFFTPlan(g, tdfft.PencilPartition(1, 1),
                              transform="c2c", device="cpu")
    with pytest.raises(TypeError, match="transform='r2c'"):
        r2c.exec_c2c(torch.zeros(8, 8, 8, dtype=torch.complex64))
    with pytest.raises(TypeError, match="transform='c2c'"):
        c2c.exec_r2c(torch.zeros(8, 8, 8))
    with pytest.raises(ValueError, match="transform"):
        tdfft.PencilFFTPlan(g, tdfft.PencilPartition(1, 1), transform="bogus",
                            device="cpu")
    with pytest.raises(ValueError, match="dims"):
        r2c.output_padded_shape_for(0)


def test_staged_execution_c2c_single_device(devices):
    """``tests/test_c2c.py::test_staged_execution_c2c``'s one-rank pencil:
    the staged surface runs the whole transform."""
    g = tdfft.GlobalSize(16, 16, 16)
    x = _input(g.shape, "c2c", "f64")
    plan = tdfft.PencilFFTPlan(g, tdfft.PencilPartition(1, 1),
                               tdfft.Config(double_prec=True),
                               transform="c2c", device="cpu")
    y = torch.from_numpy(x)
    for _, fn in plan.forward_stages():
        y = fn(y)
    assert _rel(y.numpy(), np.fft.fftn(x)) <= 1e-12
    for _, fn in plan.inverse_stages():
        y = fn(y)
    assert _rel(y.numpy() / g.n_total, x) <= 1e-12


# -- tests/test_c2c.py -------------------------------------------------------


@pytest.mark.parametrize("grid", [(2, 4), (8, 1)], ids=["2x4", "8x1"])
def test_pencil_c2c(world, devices, grid):
    cid = f"c2c-{grid[0]}x{grid[1]}"
    _vs_jax(world, cid)
    _vs_truth(world, cid)


def test_pencil_c2c_partial_dims(world, devices):
    _vs_jax(world, "c2c-partial")
    _vs_truth(world, "c2c-partial")


# -- tests/test_streams.py ---------------------------------------------------


@pytest.mark.parametrize("comms", [("All2All", "All2All"),
                                   ("Peer2Peer", "Peer2Peer"),
                                   ("All2All", "Peer2Peer")],
                         ids=["a2a-a2a", "p2p-p2p", "a2a-p2p"])
@pytest.mark.parametrize("grid", [(2, 4), (4, 2)], ids=["2x4", "4x2"])
def test_pencil_streams_matches_truth(world, devices, grid, comms):
    """STREAMS on both transposes (3 pieces), mixed comm methods, on an
    uneven size: numpy within 1e-10 and the JAX plan."""
    cid = f"streams-{grid[0]}x{grid[1]}-{comms[0]}-{comms[1]}"
    _vs_truth(world, cid, tol=1e-10)
    _vs_jax(world, cid)


def test_pencil_streams_partial_dims(world):
    """Depth 1 has no transpose to cut; depth 2 cuts only the first."""
    _vs_truth(world, "streams-partial", tol=1e-10)


# -- tests/test_ring.py, tests/test_wire.py ----------------------------------


@pytest.mark.parametrize("dims", [1, 2, 3])
def test_pencil_ring_partial_dims(world, dims):
    """Both transposes as rings (``resolved_snd2``) at every depth on an
    uneven size whose halved z pads over p2: bit for bit the default
    rendering, inverses included."""
    _same_bits(world, "native-ring", "base", depths=(dims,))


def test_pencil_ring_matches_truth(world, devices):
    _vs_truth(world, "ring-truth-4x2", tol=1e-10)
    _vs_jax(world, "ring-truth-4x2")


@pytest.mark.parametrize("rendering", sorted(RENDERINGS))
@pytest.mark.parametrize("dims", [1, 2, 3])
def test_pencil_native_wire_bit_identical(world, dims, rendering):
    """Every rendering with the native wire: bit for bit the default
    rendering (the monolithic exchange) at every depth."""
    _same_bits(world, f"native-{rendering}", "base", depths=(dims,))


@pytest.mark.parametrize("rendering", sorted(RENDERINGS))
def test_pencil_bf16_roundtrip_within_bound(world, rendering):
    """Four wire crossings per roundtrip (two transposes each way), still
    inside the bf16 wire's bound; the forward too."""
    _vs_truth(world, f"wire16-{rendering}")


# -- tests/test_overlap.py, tests/test_overlap_tuning.py ---------------------


@pytest.mark.parametrize("wire", ["native", "bf16"])
@pytest.mark.parametrize("dims", [2, 3])
def test_pencil_overlap_bit_identical_to_ring(world, dims, wire):
    _same_bits(world, f"RingOverlap-{wire}", f"Ring-{wire}", depths=(dims,))


def test_pencil_depth_subblock_bit_identical_to_ring(world):
    _same_bits(world, "RingOverlap-d4-s2", "Ring-native", depths=(3,))


def test_pencil_a2a_pipe_bit_identical_to_monolithic(world):
    _same_bits(world, "a2a-pipe-opt1", "a2a-mono-opt1")


# -- the fused wire on a ring; one-rank groups -------------------------------


def test_pencil_fused_wire_ring(world, devices):
    """RING_OVERLAP with the bf16 wire under "pallas": the fused wire
    (kernels 9 and 10's plain versions: encode, unpack-only arrival) bit
    for bit the plain wire layer, within the bf16 bound of the JAX plan's
    fused wire and of numpy."""
    _same_bits(world, "ring16-fused", "ring16-plain")
    _vs_jax(world, "ring16-fused")
    _vs_truth(world, "ring16-fused")


@pytest.mark.parametrize("cid", [c for c in CASES
                                 if c.startswith("one-rank-")])
def test_one_rank_groups_post_nothing(world, devices, cid):
    """A 1 x 8 or 8 x 1 grid: the exchange over the one-rank group posts
    no collective, and the plan matches the JAX plan (in float64, so the
    bf16 wire's rounding of the all-to-all and point to point over a
    one-device axis shows)."""
    _vs_jax(world, cid)
    for r in range(P):
        assert _result(world, r, cid)["one_rank_posts"] == []


def test_ranks_import_no_jax(world):
    assert all(w["modules"] == [] for w in world), [w["modules"] for w in world]
