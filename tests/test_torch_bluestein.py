"""The port's Bluestein (chirp-z) backend, ``ops/bluestein.py``, against the
JAX package's ``ops/bluestein.py`` and numpy, on the CPU.

Every op (``fft``, ``ifft``, ``rfft``, ``irfft``, and the n-dimensional
wrappers) at the primes 127, 251 and 1031, on the last and a leading axis,
in each norm, float32 and float64, through the ``ops/fft.py`` dispatch of
both packages; on 5-smooth shapes the port's ``"bluestein"`` is bit for
bit its ``"xla"`` (the ops and the fused n-D calls); then the plans of
``tests/test_solvers.py:449-530`` in one 4-rank gloo world spawned for the
file: the all-prime 19 x 17 x 13 slab at P = 4 and pencil on 2 x 2, prime
batched planes (2 x 127 x 31, ``shard="x"``), and the slab's prime
127-point split axis. The ranks import this module to find ``_rank_main``,
so it imports neither JAX nor the JAX package at its top.

Tolerances (max abs error over max |reference|): 1e-5 in float32 (both
packages' FFT libraries in float32), 1e-12 in float64; the plans in
float64 against numpy as the JAX pins hold them (1e-10, 1e-9 absolute).
"""

import os
import pickle
import sys
import traceback

import numpy as np
import pytest
import torch

import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch.ops import bluestein as tbl
from distributedfft_tpu_torch.ops import fft as tlf
from distributedfft_tpu_torch.params import FFTNorm
from distributedfft_tpu_torch.parallel import multihost

P = 4
FORBIDDEN = ("jax", "jaxlib", "distributedfft_tpu")
TOL = {"f32": 1e-5, "f64": 1e-12}
PRIMES = (127, 251, 1031)
NORMS = ("none", "backward", "ortho")
SEED = 4093
# Plans of tests/test_solvers.py in the world: id -> (kind, shape).
PLANS = {"slab-19x17x13": ("slab", (19, 17, 13)),
         "pencil-19x17x13": ("pencil", (19, 17, 13)),
         "batched-2x127x31": ("batched", (2, 127, 31)),
         "slab-127x8x8": ("slab", (127, 8, 8))}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def _data(shape, prec, cplx, seed=SEED):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if cplx:
        x = x + 1j * rng.standard_normal(shape)
        return x.astype(np.complex128 if prec == "f64" else np.complex64)
    return x.astype(np.float64 if prec == "f64" else np.float32)


def _norms(name):
    import distributedfft_tpu as jdfft
    return (getattr(FFTNorm, name.upper()), getattr(jdfft.FFTNorm,
                                                    name.upper()))


def _np_norm(name, inverse):
    if name == "none":
        return "forward" if inverse else "backward"
    return name


# ---------------------------------------------------------------------------
# The helpers and the ops
# ---------------------------------------------------------------------------


def test_bluestein_helpers():
    """``tests/test_solvers.py``'s helper pins, and the JAX helpers' values
    over every n up to 2100."""
    from distributedfft_tpu.ops import bluestein as jbl
    assert [tbl.is_smooth(n) for n in (1, 2, 30, 360, 7, 127)] == \
        [True, True, True, True, False, False]
    assert tbl.chirp_length(127) == 256 and tbl.chirp_length(251) == 512
    assert tbl.chirp_length(4093) == 8192 and tbl.chirp_length(521) == 2048
    assert tbl.good_size(127) == 128 and tbl.good_size(97) == 100
    assert tbl.good_size(30) == 30
    for n in range(1, 2100):
        assert tbl.is_smooth(n) == jbl.is_smooth(n)
        assert tbl.chirp_length(n) == jbl.chirp_length(n)
        assert tbl.good_size(n) == jbl.good_size(n)
    for n in (0, -3):
        assert not tbl.is_smooth(n)
        with pytest.raises(ValueError):
            tbl.chirp_length(n)
        with pytest.raises(ValueError):
            tbl.good_size(n)
    for n, inv, dbl in ((127, False, True), (1031, True, False)):
        assert np.array_equal(tbl._chirp_np(n, inv, dbl),
                              jbl._chirp_np(n, inv, dbl))
        assert np.array_equal(tbl._kernel_spectrum_np(n, inv, dbl),
                              jbl._kernel_spectrum_np(n, inv, dbl))


@pytest.mark.parametrize("prec", ["f32", "f64"])
@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("n", PRIMES)
@pytest.mark.parametrize("op", ["fft", "ifft", "rfft", "irfft"])
def test_op_at_primes_matches_reference(op, n, norm, prec):
    """Each op on the chirp path, on the last axis and on axis 0 of a
    (n, 3) / (3, n) stack, against the JAX backend and numpy."""
    from distributedfft_tpu.ops import fft as jlf
    tnorm, jnorm = _norms(norm)
    tol = TOL[prec]
    inverse = op in ("ifft", "irfft")
    for axis, shape in ((-1, (3, n)), (0, (n, 3))):
        if op == "irfft":
            x = _data(shape[:axis % 2] + (n // 2 + 1,) + shape[axis % 2 + 1:],
                      prec, True)
            got = tlf.irfft(torch.from_numpy(x), n=n, axis=axis, norm=tnorm,
                            backend="bluestein")
            want = jlf.irfft(x, n=n, axis=axis, norm=jnorm,
                             backend="bluestein")
            truth = np.fft.irfft(x.astype(np.complex128), n=n, axis=axis,
                                 norm=_np_norm(norm, True))
        else:
            x = _data(shape, prec, op != "rfft")
            got = getattr(tlf, op)(torch.from_numpy(x), axis=axis, norm=tnorm,
                                   backend="bluestein")
            want = getattr(jlf, op)(x, axis=axis, norm=jnorm,
                                    backend="bluestein")
            truth = getattr(np.fft, op)(x.astype(np.complex128 if op != "rfft"
                                                 else np.float64), axis=axis,
                                        norm=_np_norm(norm, inverse))
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape == truth.shape
        assert got.dtype == (torch.float64 if prec == "f64" else
                             torch.float32) if op == "irfft" else \
            got.dtype == (torch.complex128 if prec == "f64" else
                          torch.complex64)
        assert _rel(got.numpy(), want) <= tol, axis
        assert _rel(got.numpy(), truth) <= tol, axis


@pytest.mark.parametrize("prec", ["f32", "f64"])
@pytest.mark.parametrize("shape", [(19, 17, 13), (12, 127, 10)])
def test_nd_wrappers_off_smooth_match_reference(shape, prec):
    """``rfftn_3d`` / ``irfftn_3d`` / ``fftn`` / ``ifftn`` with a prime
    axis compose per axis, as in the JAX backend."""
    from distributedfft_tpu.ops import fft as jlf
    tol = TOL[prec]
    x = _data(shape, prec, False)
    got = tlf.rfftn_3d(torch.from_numpy(x), backend="bluestein")
    want = np.asarray(jlf.rfftn_3d(x, backend="bluestein"))
    assert _rel(got.numpy(), want) <= tol
    assert _rel(got.numpy(), np.fft.rfftn(x.astype(np.float64))) <= tol
    back = tlf.irfftn_3d(got, shape, backend="bluestein")
    assert _rel(back.numpy() / np.prod(shape), x) <= tol
    assert _rel(back.numpy(), np.asarray(jlf.irfftn_3d(want, shape,
                                                       backend="bluestein"))
                ) <= tol
    z = _data(shape, prec, True)
    for axes in ((0, 1, 2), (1, 2)):
        got = tlf.fftn(torch.from_numpy(z), axes, backend="bluestein")
        assert _rel(got.numpy(), np.fft.fftn(z.astype(np.complex128),
                                             axes=axes)) <= tol
        back = tlf.ifftn(got, axes, backend="bluestein")
        n = np.prod([shape[a] for a in axes])
        assert _rel(back.numpy() / n, z) <= tol


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("prec", ["f32", "f64"])
def test_smooth_axes_are_xla_bit_for_bit(prec, norm):
    """On 5-smooth axes every op and every n-D wrapper makes the port's
    "xla" call: the same bits (the JAX pin holds the fused 3D R2C)."""
    tnorm = getattr(FFTNorm, norm.upper())
    shape = (8, 12, 30)
    xr = torch.from_numpy(_data(shape, prec, False))
    xc = torch.from_numpy(_data(shape, prec, True))
    half = torch.from_numpy(_data((8, 12, 16), prec, True))
    kw = dict(norm=tnorm)
    for axis in (0, 1, 2):
        for op, x in (("fft", xc), ("ifft", xc), ("rfft", xr)):
            a = getattr(tlf, op)(x, axis=axis, backend="bluestein", **kw)
            b = getattr(tlf, op)(x, axis=axis, backend="xla", **kw)
            assert torch.equal(a, b), (op, axis)
    assert torch.equal(tlf.irfft(half, 30, 2, backend="bluestein", **kw),
                       tlf.irfft(half, 30, 2, backend="xla", **kw))
    for fn, x in (("fftn", xc), ("ifftn", xc)):
        a = getattr(tlf, fn)(x, (0, 1, 2), backend="bluestein", **kw)
        assert torch.equal(a, getattr(tlf, fn)(x, (0, 1, 2), backend="xla",
                                               **kw))
    c = tlf.rfftn_3d(xr, backend="bluestein", **kw)
    assert torch.equal(c, tlf.rfftn_3d(xr, backend="xla", **kw))
    assert torch.equal(tlf.irfftn_3d(c, shape, backend="bluestein", **kw),
                       tlf.irfftn_3d(c, shape, backend="xla", **kw))


def test_constants_cached_per_device_and_precision():
    a = tbl._constants(127, False, False, torch.device("cpu"))
    assert a is tbl._constants(127, False, False, torch.device("cpu"))
    assert a[0].dtype == torch.complex64 and a[1].shape == (256,)
    b = tbl._constants(127, True, True, torch.device("cpu"))
    assert b[0].dtype == torch.complex128
    assert torch.equal(b[0], torch.from_numpy(tbl._chirp_np(127, True, True)))


def test_one_rank_batched_plan_matches_jax(devices):
    """One rank, a prime image stack, ``batch_chunk`` 1: the JAX plan."""
    import distributedfft_tpu as jdfft
    from distributedfft_tpu.models.batched2d import Batched2DFFTPlan
    x = _data((4, 13, 31), "f32", False)
    tplan = tdfft.Batched2DFFTPlan(4, 13, 31, tdfft.SlabPartition(1),
                                   tdfft.Config(fft_backend="bluestein"),
                                   batch_chunk=1, device="cpu")
    jplan = Batched2DFFTPlan(4, 13, 31, jdfft.SlabPartition(1),
                             jdfft.Config(fft_backend="bluestein"))
    got = tplan.exec_forward(x)
    want = np.asarray(jplan.exec_forward(x))
    assert _rel(got.numpy(), want) <= TOL["f32"]
    assert _rel(tplan.exec_inverse(got).numpy(),
                np.asarray(jplan.exec_inverse(want))) <= TOL["f32"]


# ---------------------------------------------------------------------------
# The plans over 4 gloo ranks (tests/test_solvers.py:449-530)
# ---------------------------------------------------------------------------


def _cfg():
    return tdfft.Config(double_prec=True, fft_backend="bluestein")


def _plan(pid):
    kind, shape = PLANS[pid]
    if kind == "slab":
        return tdfft.SlabFFTPlan(tdfft.GlobalSize(*shape),
                                 tdfft.SlabPartition(P), _cfg(), device="cpu")
    if kind == "pencil":
        return tdfft.PencilFFTPlan(tdfft.GlobalSize(*shape),
                                   tdfft.PencilPartition(2, 2), _cfg(),
                                   device="cpu")
    return tdfft.Batched2DFFTPlan(*shape, tdfft.SlabPartition(P), _cfg(),
                                  shard="x", device="cpu")


def _run_plan(pid):
    kind, shape = PLANS[pid]
    plan = _plan(pid)
    x = _data(shape, "f64", False)
    if kind == "batched":
        c = plan.exec_forward(plan.pad_input(x))
        back = plan.exec_inverse(c)
        truth = np.fft.rfftn(x, axes=(1, 2))
        return {"crop_fwd": plan.crop_spectral(c),
                "crop_back": plan.crop_real(back), "local_fwd": c.numpy()}
    c = plan.exec_r2c(plan.pad_input(x))
    truth = np.fft.rfftn(x)
    # The inverse of the exact spectrum, as the JAX pin runs it.
    back = plan.exec_c2r(plan.pad_spectral(torch.from_numpy(truth)))
    return {"crop_fwd": plan.crop_spectral(c),
            "crop_back": plan.crop_real(back), "local_fwd": c.numpy()}


def _rank_main(rank, addr, outdir):
    multihost.maybe_initialize(addr, P, rank, backend="gloo", timeout_s=120)
    results = {}
    for pid in PLANS:
        try:
            results[pid] = _run_plan(pid)
        except Exception:  # noqa: BLE001 — reported by that case's test
            results[pid] = {"error": traceback.format_exc()}
    results["modules"] = sorted(m for m in sys.modules
                                if m.split(".")[0] in FORBIDDEN)
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    multihost.shutdown()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("bluestein")
    torch.multiprocessing.start_processes(
        _rank_main, args=(multihost.local_coordinator(), str(outdir)),
        nprocs=P, start_method="spawn")
    out = []
    for r in range(P):
        with open(outdir / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _result(world, rank, pid):
    res = world[rank][pid]
    if isinstance(res, dict) and "error" in res:
        pytest.fail(f"rank {rank} failed {pid}:\n{res['error']}")
    return res


@pytest.mark.parametrize("pid", list(PLANS))
def test_prime_plans_match_numpy(world, pid):
    """``test_bluestein_all_prime_3d_slab_pencil`` (1e-10 forward, 1e-9
    the unnormalized inverse), ``test_bluestein_prime_batched2d`` and
    ``test_bluestein_prime_127_axis_slab`` (1e-9)."""
    kind, shape = PLANS[pid]
    x = _data(shape, "f64", False)
    res = _result(world, 0, pid)
    if kind == "batched":
        np.testing.assert_allclose(res["crop_fwd"],
                                   np.fft.rfftn(x, axes=(1, 2)), atol=1e-9)
        np.testing.assert_allclose(res["crop_back"],
                                   x * shape[1] * shape[2], atol=1e-9)
        return
    np.testing.assert_allclose(res["crop_fwd"], np.fft.rfftn(x),
                               atol=1e-10 if shape[0] == 19 else 1e-9)
    np.testing.assert_allclose(res["crop_back"], x * x.size, atol=1e-9)


@pytest.mark.parametrize("pid", ["slab-19x17x13", "batched-2x127x31",
                                 "slab-127x8x8"])
def test_prime_plans_match_jax(world, devices, pid):
    """Each rank's forward block against the same slice of the JAX plan's
    padded output on a 4-device mesh, 1e-12."""
    import distributedfft_tpu as jdfft
    from distributedfft_tpu.models.batched2d import Batched2DFFTPlan
    from distributedfft_tpu.parallel.mesh import make_slab_mesh
    kind, shape = PLANS[pid]
    mesh = make_slab_mesh(P, devices)
    cfg = jdfft.Config(double_prec=True, fft_backend="bluestein")
    x = _data(shape, "f64", False)
    if kind == "batched":
        jplan = Batched2DFFTPlan(*shape, jdfft.SlabPartition(P), cfg,
                                 mesh=mesh, shard="x")
        jc, axis = np.asarray(jplan.exec_forward(jplan.pad_input(x))), 2
    else:
        jplan = jdfft.SlabFFTPlan(jdfft.GlobalSize(*shape),
                                  jdfft.SlabPartition(P), cfg, mesh=mesh)
        jc, axis = np.asarray(jplan.exec_r2c(jplan.pad_input(x))), 1
    b = jc.shape[axis] // P
    for r in range(P):
        mine = _result(world, r, pid)["local_fwd"]
        assert _rel(mine, jc.take(range(r * b, (r + 1) * b), axis=axis)) \
            <= TOL["f64"], r


def test_ranks_import_no_jax(world):
    assert all(w["modules"] == [] for w in world), [w["modules"] for w in world]
