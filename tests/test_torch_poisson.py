"""The port's PoissonSolver (BASELINE config #5's solver) over 4 gloo
ranks on the CPU, against the JAX package's PoissonSolver on a 4-device
mesh (2 x 2 for the pencil) and against the closed forms: every case of
``tests/test_poisson.py``.

One 4-rank world runs every case (a module fixture). Each rank solves its
block and gathers the solution with ``plan.crop_real`` (every rank holds
the global array); the parent compares. The ranks import this module,
which imports no JAX at its top. Tolerances: the JAX pins' 1e-12 (1e-9
and 1e-10 where they say so), in float64.
"""

import os
import pickle
import sys
import traceback

import numpy as np
import pytest
import torch

import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch.parallel import multihost
from distributedfft_tpu_torch.solvers.poisson import PoissonSolver

P = 4
FORBIDDEN = ("jax", "jaxlib", "distributedfft_tpu")
DP = {"double_prec": True}


def product_of_sines(n):
    i = np.arange(n) * (2 * np.pi / n)
    s = np.sin(i)
    return s[:, None, None] * s[None, :, None] * s[None, None, :]


def _random(n, seed=1234):
    return np.random.default_rng(seed).random((n, n, n))


# id -> (family, n, transform, solver kwargs, forcing)
CASES = {
    "slab-manufactured": ("slab", 32, "r2c", {"lengths": (2 * np.pi,) * 3,
                                              "mode": "physical"}, "sines"),
    "pencil-manufactured": ("pencil", 32, "r2c",
                            {"lengths": (2 * np.pi,) * 3, "mode": "physical"},
                            "sines"),
    "box-2pi": ("slab", 32, "r2c", {"lengths": (2 * np.pi,) * 3}, "sines"),
    "box-4pi": ("slab", 32, "r2c", {"lengths": (4 * np.pi,) * 3}, "sines"),
    "integer": ("slab", 32, "r2c", {"mode": "integer"}, "sines"),
    "gauge": ("slab", 16, "r2c", {}, "random"),
    "c2c": ("slab", 32, "c2c", {"lengths": (2 * np.pi,) * 3}, "sines"),
}


def _forcing(kind, n, transform):
    f = -3.0 * product_of_sines(n) if kind == "sines" else _random(n)
    return f.astype(np.complex128) if transform == "c2c" else f


def _port_plan(family, n, transform):
    g = tdfft.GlobalSize(n, n, n)
    cfg = tdfft.Config(**DP)
    if family == "slab":
        return tdfft.SlabFFTPlan(g, tdfft.SlabPartition(P), cfg,
                                 transform=transform, device="cpu")
    return tdfft.PencilFFTPlan(g, tdfft.PencilPartition(2, 2), cfg,
                               transform=transform, device="cpu")


def _run_case(cid):
    family, n, tr, kw, forcing = CASES[cid]
    plan = _port_plan(family, n, tr)
    solver = PoissonSolver(plan, **kw)
    f = _forcing(forcing, n, tr)
    u = solver.solve(plan.pad_input(f))
    u_global = solver.solve(f)        # the global forcing, cut to the block
    return {"u": plan.crop_real(u), "same": torch.equal(u, u_global),
            "local": tuple(u.shape)}


def _rank_main(rank, addr, outdir):
    multihost.maybe_initialize(addr, P, rank, backend="gloo", timeout_s=120)
    results = {}
    for cid in CASES:
        try:
            results[cid] = _run_case(cid)
        except Exception:  # noqa: BLE001 — reported by that case's test
            results[cid] = {"error": traceback.format_exc()}
    results["modules"] = sorted(m for m in sys.modules
                                if m.split(".")[0] in FORBIDDEN)
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    multihost.shutdown()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("poisson")
    torch.multiprocessing.start_processes(
        _rank_main, args=(multihost.local_coordinator(), str(outdir)),
        nprocs=P, start_method="spawn")
    out = []
    for r in range(P):
        with open(outdir / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _u(world, cid):
    for r in range(P):
        res = world[r][cid]
        if "error" in res:
            pytest.fail(f"rank {r} failed {cid}:\n{res['error']}")
        assert res["same"], (r, cid)
    u = world[0][cid]["u"]
    for r in range(1, P):
        assert np.array_equal(world[r][cid]["u"], u)
    return u


def _jax_u(devices, cid):
    import distributedfft_tpu as jdfft
    from distributedfft_tpu.parallel.mesh import (make_pencil_mesh,
                                                  make_slab_mesh)
    from distributedfft_tpu.solvers.poisson import PoissonSolver as JSolver
    family, n, tr, kw, forcing = CASES[cid]
    g = jdfft.GlobalSize(n, n, n)
    cfg = jdfft.Config(**DP)
    if family == "slab":
        plan = jdfft.SlabFFTPlan(g, jdfft.SlabPartition(P), cfg,
                                 mesh=make_slab_mesh(P, devices),
                                 transform=tr)
    else:
        plan = jdfft.PencilFFTPlan(g, jdfft.PencilPartition(2, 2), cfg,
                                   mesh=make_pencil_mesh(2, 2, devices),
                                   transform=tr)
    return plan.crop_real(JSolver(plan, **kw).solve(_forcing(forcing, n, tr)))


@pytest.mark.parametrize("cid", ["slab-manufactured", "pencil-manufactured"])
def test_manufactured_solution(world, devices, cid):
    """On the 2π box ∇²(Πsin) = -3·Πsin: f = -3u gives back u (slab over 4
    ranks, pencil 2 x 2), as the JAX solver does."""
    u = _u(world, cid)
    np.testing.assert_allclose(u, product_of_sines(32), atol=1e-12)
    np.testing.assert_allclose(u, _jax_u(devices, cid), atol=1e-12)


def test_box_scaling(world):
    """Doubling the box length scales the symbol by 4: u grows 4x."""
    np.testing.assert_allclose(_u(world, "box-4pi"),
                               4.0 * _u(world, "box-2pi"), atol=1e-12)


def test_integer_mode_matches_reference_convention(world, devices):
    """Integer wavenumbers (testcase 4's convention): k² = 3 for Πsin."""
    u = _u(world, "integer")
    np.testing.assert_allclose(u, product_of_sines(32), atol=1e-12)
    np.testing.assert_allclose(u, _jax_u(devices, "integer"), atol=1e-12)


def test_zero_mean_gauge(world, devices):
    """The k=0 component of f is projected out: u is zero-mean."""
    u = _u(world, "gauge")
    assert abs(u.mean()) < 1e-10
    np.testing.assert_allclose(u, _jax_u(devices, "gauge"), atol=1e-12)


def test_c2c_plan(world, devices):
    u = _u(world, "c2c")
    np.testing.assert_allclose(u.real, product_of_sines(32), atol=1e-12)
    np.testing.assert_allclose(u, _jax_u(devices, "c2c"), atol=1e-12)


def test_residual_on_random_rhs(world):
    """The spectral Laplacian of the solution is the zero-mean part of f."""
    n = 16
    f = _random(n)
    u = _u(world, "gauge")
    c = np.fft.rfftn(u)
    k = [np.fft.fftfreq(n) * n] * 2 + [np.arange(n // 2 + 1, dtype=float)]
    k1, k2, k3 = np.meshgrid(*k, indexing="ij")
    lap = np.fft.irfftn(-(k1**2 + k2**2 + k3**2) * c, (n, n, n),
                        axes=(0, 1, 2))
    np.testing.assert_allclose(lap, f - f.mean(), atol=1e-9)


def test_mode_validation():
    plan = tdfft.SlabFFTPlan(tdfft.GlobalSize(16, 16, 16),
                             tdfft.SlabPartition(1), tdfft.Config(),
                             device="cpu")
    with pytest.raises(ValueError, match="mode"):
        PoissonSolver(plan, mode="bogus")


def test_blocks_and_protocol(world):
    """Each rank solved its own block (x split over 4, the pencil's 2 x 2),
    and the ranks imported no JAX."""
    assert world[1]["slab-manufactured"]["local"] == (8, 32, 32)
    assert world[3]["pencil-manufactured"]["local"] == (16, 16, 32)
    for r in range(P):
        assert world[r]["modules"] == [], r
