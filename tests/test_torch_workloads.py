"""The port's chained workload timers (``testing/workloads.py``) on the
CPU: every case of ``tests/test_workloads.py``, against the JAX package's
chains on the same numpy inputs. The sharded chain runs over 4 gloo ranks
(one world, a module fixture; the ranks import this module, which imports
no JAX at its top). Tolerances: the JAX pins' (rel 1e-5, 1e-4), float32
under "xla"."""

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
from distributedfft_tpu_torch.testing import workloads

P = 4
FORBIDDEN = ("jax", "jaxlib", "distributedfft_tpu")


def _x16(seed):
    return np.random.default_rng(seed).random((16, 16, 16)).astype(np.float32)


def test_poisson_chain_converges_and_is_bounded():
    """k=1 equals one plain solve of x + x; a 64-long chain stays bounded;
    both sums are the JAX chains' (rel 1e-5)."""
    from distributedfft_tpu.testing import workloads as jw
    fn1, plan = workloads.poisson_chain(1, 16, backend="xla", device="cpu")
    x = _x16(0)
    xp = plan.pad_input(x)
    s1 = fn1(xp)
    solver = PoissonSolver(plan, mode="integer")
    ref = float(torch.sum(torch.abs(solver.solve(xp + xp))))
    assert s1 == pytest.approx(ref, rel=1e-5)
    fn64, _ = workloads.poisson_chain(64, 16, backend="xla", device="cpu")
    s64 = fn64(xp)
    assert np.isfinite(s64) and s64 < 1e6
    jfn1, jplan = jw.poisson_chain(1, 16, backend="xla")
    assert s1 == pytest.approx(float(jfn1(jplan.pad_input(x))), rel=1e-5)
    jfn64, _ = jw.poisson_chain(64, 16, backend="xla")
    assert s64 == pytest.approx(float(jfn64(jplan.pad_input(x))), rel=1e-4)


def test_batched2d_chain_matches_identity():
    """A roundtrip with the 1/(nx*ny) rescale is the identity: sum |x|."""
    from distributedfft_tpu.testing import workloads as jw
    fn, plan = workloads.batched2d_chain(3, 4, 16, 16, backend="xla",
                                         device="cpu")
    x = np.random.default_rng(2).random((4, 16, 16)).astype(np.float32)
    xp = plan.pad_input(x)
    got = fn(xp)
    assert got == pytest.approx(float(np.abs(x).sum()), rel=1e-4)
    jfn, jplan = jw.batched2d_chain(3, 4, 16, 16, backend="xla")
    assert got == pytest.approx(float(jfn(jplan.pad_input(x))), rel=1e-5)


def test_ns2d_chain_matches_jax():
    """``ns2d_chain`` (float32, "matmul") against the JAX chain."""
    from distributedfft_tpu.testing import workloads as jw
    w0 = np.random.default_rng(3).random((2, 16, 16)).astype(np.float32)
    fn, solver = workloads.ns2d_chain(2, 2, 16, backend="matmul",
                                      device="cpu")
    jfn, _ = jw.ns2d_chain(2, 2, 16, backend="matmul")
    assert fn(w0) == pytest.approx(float(jfn(w0)), rel=1e-5)
    assert isinstance(solver.plan, tdfft.Batched2DFFTPlan)


def test_flops_formulas():
    """Independently derived: 128^3 = 2097152 elements, log2(128^3) = 21,
    so 5 * 2097152 * 21 = 220200960; 64 * 4096^2 with log2(4096^2) = 24,
    so 5 * 64 * 16777216 * 24 = 128849018880."""
    from distributedfft_tpu.testing import workloads as jw
    assert workloads.flops_poisson(128) == 220200960.0
    assert workloads.flops_roundtrip_3d(128) == 220200960.0
    assert workloads.flops_batched2d(64, 4096, 4096) == 128849018880.0
    assert workloads.flops_ns2d_step(16, 4096) == jw.flops_ns2d_step(16, 4096)


def test_serve_load_names_its_item():
    """``serve_load`` runs since item 14 (``tests/test_torch_serve.py``);
    its tenant mix drives the fleet, item 14's second part, and raises
    naming it."""
    from distributedfft_tpu_torch.serve import Server
    with Server(device="cpu") as s:
        with pytest.raises(NotImplementedError, match="item 14, second"):
            workloads.serve_load(s, rate_hz=1.0, n_requests=1,
                                 tenants=["gold"])


def _rank_main(rank, addr, outdir):
    multihost.maybe_initialize(addr, P, rank, backend="gloo", timeout_s=120)
    try:
        fn, plan = workloads.poisson_chain(
            4, 16, backend="xla", partition=tdfft.SlabPartition(P),
            device="cpu")
        res = {"sum": fn(plan.pad_input(_x16(1)))}
    except Exception:  # noqa: BLE001 — reported by the test
        res = {"error": traceback.format_exc()}
    res["modules"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in FORBIDDEN)
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    multihost.shutdown()


def test_poisson_chain_sharded(tmp_path, devices):
    """The chain over a 4-rank slab plan: every rank reads the same finite
    sum, the JAX chain's on a 4-device mesh (rel 1e-5)."""
    from distributedfft_tpu.parallel.mesh import make_slab_mesh
    from distributedfft_tpu.testing import workloads as jw
    import distributedfft_tpu as jdfft
    torch.multiprocessing.start_processes(
        _rank_main, args=(multihost.local_coordinator(), str(tmp_path)),
        nprocs=P, start_method="spawn")
    out = []
    for r in range(P):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    for r, res in enumerate(out):
        assert "error" not in res, res.get("error")
        assert res["sum"] == out[0]["sum"] and res["modules"] == [], r
    assert np.isfinite(out[0]["sum"])
    jfn, jplan = jw.poisson_chain(4, 16, backend="xla",
                                  partition=jdfft.SlabPartition(P),
                                  mesh=make_slab_mesh(P, devices))
    assert out[0]["sum"] == pytest.approx(
        float(jfn(jplan.pad_input(_x16(1)))), rel=1e-5)
