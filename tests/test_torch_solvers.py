"""The port's solvers (``solvers/``) over 4 gloo ranks on the CPU: every
case of ``tests/test_solvers.py`` against its closed form, numpy or scipy
golden, and the JAX package where named.

* Navier-Stokes: NS-2D against the numpy mirror of the discretization
  (batched shard="x" over 4 ranks), Taylor-Green's exact decay, the
  inviscid invariants and viscous decay through ``diagnostics`` (summed
  over the ranks), NS-3D's inviscid energy, the gradients of 4-step
  solves against central differences (NS-2D on the batched plan, NS-3D on
  the slab: the RHS's many independent inverse branches, whose backward
  exchanges every rank must post in one order), NS-3D on the pencil 2 x 2
  equal to the slab, ``make_solver``;
* Poisson's Dirichlet, Neumann and mixed boxes with the extension on the
  split axis (each rank builds its block of the extension from the global
  interior; ``gather_interior``), the periodic batched solve, validation;
* DCT/DST against scipy and the JAX package's ``r2r``;
* convolution and correlation against scipy and the JAX convolver, every
  mode, slab and pencil volumes, the exact pad on Bluestein, the gradient
  of ``conv_fn`` against JAX's;
* the guards + bf16-wire solve (``test_solver_guards_check_with_bf16_wire``)
  on the default exchange and on the ring, plain and fused wire.

The Bluestein cases of ``tests/test_solvers.py`` are held in
``tests/test_torch_bluestein.py``. One 4-rank world runs every ranked case
(a module fixture); the ranks import this module, which imports no JAX at
its top. Tolerances: the JAX pins (1e-12, 1e-13, FD rel=1e-6) in float64;
2e-2 on the bf16 wire; 2e-3 under "pallas".
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
from distributedfft_tpu_torch.parallel import multihost
from distributedfft_tpu_torch.solvers import (NavierStokes2D, NavierStokes3D,
                                              PoissonSolver, make_convolver,
                                              make_solver, r2r,
                                              taylor_green_2d,
                                              taylor_green_3d)
from distributedfft_tpu_torch.solvers.convolve import conv_shape

scipy_fft = pytest.importorskip("scipy.fft")
scipy_signal = pytest.importorskip("scipy.signal")

P = 4
FORBIDDEN = ("jax", "jaxlib", "distributedfft_tpu")
SEED = 1234


def _cfg(**kw):
    return tdfft.Config(double_prec=True, use_wisdom=False, **kw)


def _rng(seed=SEED):
    return np.random.default_rng(seed)


def _batched(b, nx, ny, shard="x", **kw):
    return tdfft.Batched2DFFTPlan(b, nx, ny, tdfft.SlabPartition(P),
                                  _cfg(**kw), shard=shard, device="cpu")


def _slab(n, **kw):
    return tdfft.SlabFFTPlan(tdfft.GlobalSize(n, n, n),
                             tdfft.SlabPartition(P), _cfg(**kw), device="cpu")


def _allsum(t):
    t = torch.as_tensor(t, dtype=torch.float64).clone()
    dist.all_reduce(t)
    return float(t)


# ---------------------------------------------------------------------------
# The ranks (no JAX here)
# ---------------------------------------------------------------------------


def _np_ns2d_steps(w0, steps, dt, nu):
    """The numpy mirror of the NavierStokes2D discretization (rfft2,
    2/3-rule mask, RK4) on an n x n periodic box of side 2π."""
    n = w0.shape[-1]
    kx = (np.fft.fftfreq(n) * n)[:, None]
    ky = np.arange(n // 2 + 1)[None, :]
    k2 = kx ** 2 + ky ** 2
    inv_k2 = np.where(k2 > 0, 1.0 / np.where(k2 > 0, k2, 1.0), 0.0)
    cut = n // 3
    mask = ((np.abs(kx) <= cut) * (ky <= cut)).astype(float)

    def rhs(wh):
        psi = wh * inv_k2
        u = np.fft.irfft2(1j * ky * psi, s=(n, n))
        v = np.fft.irfft2(-1j * kx * psi, s=(n, n))
        wx = np.fft.irfft2(1j * kx * wh, s=(n, n))
        wy = np.fft.irfft2(1j * ky * wh, s=(n, n))
        return -mask * np.fft.rfft2(u * wx + v * wy) - nu * k2 * wh

    wh = mask * np.fft.rfft2(w0)
    for _ in range(steps):
        k1 = rhs(wh)
        k2_ = rhs(wh + 0.5 * dt * k1)
        k3 = rhs(wh + 0.5 * dt * k2_)
        k4 = rhs(wh + dt * k3)
        wh = wh + (dt / 6.0) * (k1 + 2 * k2_ + 2 * k3 + k4)
    return np.fft.irfft2(wh, s=(n, n))


def _ns2d_mirror():
    n, nu, dt = 24, 0.02, 1e-2
    plan = _batched(2, n, n)
    w0 = _rng().random((2, n, n))
    out = NavierStokes2D(plan, nu).run(w0, 3, dt)
    return {"w": plan.crop_real(out), "w0": w0, "local": tuple(out.shape)}


def _ns2d_tg():
    n, nu, dt, steps = 32, 0.05, 1e-2, 5
    plan = _batched(1, n, n)
    return {"w": plan.crop_real(NavierStokes2D(plan, nu).run(
        taylor_green_2d(n, batch=1), steps, dt))}


def _ns_invariants():
    n = 24
    plan = _batched(1, n, n)
    ns = NavierStokes2D(plan, 0.0)
    with torch.no_grad():
        wh0 = ns.to_spectral(_rng().random((1, n, n)) - 0.5)
        d0 = {k: float(v[0]) for k, v in ns.diagnostics(wh0).items()}
        step = ns.step_fn(2e-3)
        wh = wh0
        for _ in range(5):
            wh = step(wh)
        dT = {k: float(v[0]) for k, v in ns.diagnostics(wh).items()}
        nsv = NavierStokes2D(plan, 0.1)
        stepv = nsv.step_fn(2e-3)
        whv = wh0
        for _ in range(5):
            whv = stepv(whv)
        dV = {k: float(v[0]) for k, v in nsv.diagnostics(whv).items()}
    return {"d0": d0, "dT": dT, "dV": dV}


def _ns3d_energy():
    plan = _slab(16, fft_backend="matmul")
    ns = NavierStokes3D(plan, 0.0)
    with torch.no_grad():
        ch = ns.to_spectral(taylor_green_3d(16))
        e0 = float(ns.diagnostics(ch)["energy"])
        step = ns.step_fn(5e-3)
        for _ in range(3):
            ch = step(ch)
        eT = float(ns.diagnostics(ch)["energy"])
    return {"e0": e0, "eT": eT}


def _fd_grad(plan, sfn, w0, idxs, eps=1e-6):
    """The gradient block of sum(sfn(w)^2) summed over the ranks, and
    central differences at the global ``idxs``."""
    def loss(w):
        return torch.sum(sfn(plan.pad_input(w)) ** 2)

    wl = plan.pad_input(w0).requires_grad_()
    torch.sum(sfn(wl) ** 2).backward()
    fds = []
    with torch.no_grad():
        for idx in idxs:
            wp, wm = w0.copy(), w0.copy()
            wp[idx] += eps
            wm[idx] -= eps
            fds.append((_allsum(loss(wp)) - _allsum(loss(wm))) / (2 * eps))
    return {"grad": wl.grad.numpy(),
            "where": [(s.start or 0, s.stop) for s in plan.local_slices()],
            "padded": plan.input_padded_shape, "fd": fds}


def _ns2d_grad():
    n = 16
    plan = _batched(2, n, n, fft_backend="matmul")
    sfn = NavierStokes2D(plan, 0.01).solve_fn(4, 1e-2)
    return _fd_grad(plan, sfn, _rng().random((2, n, n)),
                    ((0, 3, 5), (1, 7, 2)))


def _ns3d_grad():
    plan = _slab(8, fft_backend="matmul")
    ns = NavierStokes3D(plan, 0.02)
    sfn = ns.solve_fn(4, 5e-3)
    u0 = taylor_green_3d(8)

    def loss_fn(u):
        return torch.sum(sfn(u) ** 2)

    ul = torch.stack([plan.pad_input(u0[i]) for i in range(3)])
    ul.requires_grad_()
    loss_fn(ul).backward()
    eps = 1e-6
    vals = []
    with torch.no_grad():
        for d in (eps, -eps):
            u = u0.copy()
            u[0, 1, 2, 3] += d
            vals.append(_allsum(loss_fn(torch.stack(
                [plan.pad_input(u[i]) for i in range(3)]))))
    grad = ul.grad.numpy()
    r0, r1 = plan.local_slices()[0].start, plan.local_slices()[0].stop
    own = r0 <= 1 < r1
    return {"grad_0123": float(grad[0, 1 - r0, 2, 3]) if own else None,
            "fd": (vals[0] - vals[1]) / (2 * eps)}


def _ns3d_pencil():
    g = tdfft.GlobalSize(16, 16, 16)
    u0 = taylor_green_3d(16)
    outs = []
    for plan in (_slab(16, fft_backend="matmul"),
                 tdfft.PencilFFTPlan(g, tdfft.PencilPartition(2, 2),
                                     _cfg(fft_backend="matmul"),
                                     device="cpu")):
        out = NavierStokes3D(plan, 1e-2).run(u0, 1, 1e-3)
        outs.append(np.stack([plan.crop_real(out[i]) for i in range(3)]))
    return {"slab": outs[0], "pencil": outs[1]}


def _dirichlet(bc):
    n, L = 16, 1.3 if bc == "dirichlet" else 2.0
    plan = _slab(2 * n)
    s = PoissonSolver(plan, lengths=(L,) * 3, bc=bc)
    x = (np.arange(n) + 0.5) * (L / n)
    sx = np.sin(np.pi * x / L) if bc == "dirichlet" else np.cos(np.pi * x / L)
    u_true = sx[:, None, None] * sx[None, :, None] * sx[None, None, :]
    u = s.solve(-3.0 * (np.pi / L) ** 2 * u_true)
    grad, s_w = _extended_grad(s, _rng(7).random(s.interior_shape))
    return {"u": s.gather_interior(u), "local": tuple(u.shape),
            "interior": s.interior_shape, "u_true": u_true,
            "solve_fn_grad": grad, "solve_w": s_w}


def _local_part(plan, w, u):
    """The part of the global interior array ``w`` this rank's interior
    block ``u`` covers."""
    return torch.as_tensor(w)[tuple(
        slice(sl.start or 0, (sl.start or 0) + n)
        for sl, n in zip(plan.local_slices(), u.shape))]


def _extended_grad(s, w, f=None):
    """The gradient of sum(w * u) over every rank's part of an extended
    box's ``solve_fn`` (the input the GLOBAL interior on every rank), and
    the gathered solve of w (S is self-adjoint on the interior)."""
    f = _rng(8).random(s.interior_shape) if f is None else f
    ft = torch.tensor(f, requires_grad=True)
    u = s.solve_fn()(ft)
    torch.sum(_local_part(s.plan, w, u) * u).backward()
    return ft.grad.numpy(), s.gather_interior(s.solve(w))


def _mixed():
    nb, nx, ny, L = 2, 16, 16, 1.0
    plan = _batched(nb, 2 * nx, ny)
    s = PoissonSolver(plan, lengths=(1.0, L, 2 * np.pi),
                      bc=("periodic", "dirichlet", "periodic"))
    x = (np.arange(nx) + 0.5) * (L / nx)
    iy = np.arange(ny) * (2 * np.pi / ny)
    u_true = (np.sin(np.pi * x / L)[None, :, None]
              * np.sin(iy)[None, None, :] * np.ones((nb, 1, 1)))
    u = s.solve(-((np.pi / L) ** 2 + 1.0) * u_true)
    return {"u": s.gather_interior(u), "u_true": u_true,
            "interior": s.interior_shape, "local": tuple(u.shape)}


def _periodic_batched():
    n = 32
    plan = _batched(3, n, n)
    s = PoissonSolver(plan, lengths=(1.0, 2 * np.pi, 2 * np.pi))
    i = np.arange(n) * (2 * np.pi / n)
    u = (np.sin(i)[None, :, None] * np.sin(i)[None, None, :]
         * np.ones((3, 1, 1)))
    return {"u": plan.crop_real(s.solve(-2.0 * u)), "u_true": u}


def _conv(mode, correlate=False, family="batched2d", pad="smooth",
          backend="xla"):
    rng = _rng()
    if family == "batched2d":
        img = rng.random((3, 20, 17)) if not correlate else \
            rng.random((2, 12, 15))
        ker = rng.random((5, 4)) if not correlate else rng.random((4, 5))
        cv = make_convolver(ker, img.shape[1:], batch=img.shape[0],
                            mode=mode, correlate=correlate,
                            partition=tdfft.SlabPartition(P), pad=pad,
                            config=_cfg(fft_backend=backend), device="cpu")
    else:
        img = rng.random((12, 10, 9))
        ker = rng.random((3, 3, 3))
        part = tdfft.SlabPartition(P) if family == "slab" else \
            tdfft.PencilPartition(2, 2)
        cv = make_convolver(ker, img.shape, family=family, mode=mode,
                            partition=part, config=_cfg(), device="cpu")
    y = cv(img)
    return {"out": cv.gather(y), "img": img, "ker": ker,
            "plan_shape": tuple(cv.plan.input_shape),
            "conv_fn_grad": _conv_grad(cv, img)}


def _conv_grad(cv, img):
    """The gradient of the sum of squares of every rank's part of
    ``conv_fn`` (the input the global image on every rank)."""
    v = torch.tensor(img, requires_grad=True)
    y = cv.conv_fn()(v)
    torch.sum(y ** 2).backward()
    return v.grad.numpy()


def _conv_grad_matmul():
    """``tests/test_solvers.py::test_convolve_grad`` at P ranks."""
    rng = _rng(9)
    vol, k3 = rng.random((8, 8, 8)), rng.random((3, 3, 3))
    cv = make_convolver(k3, (8, 8, 8), family="slab", mode="same",
                        partition=tdfft.SlabPartition(P),
                        config=_cfg(fft_backend="matmul"), device="cpu")
    return {"vol": vol, "k3": k3, "grad": _conv_grad(cv, vol)}


def _dirichlet_grad_matmul():
    """An extended (Dirichlet) box's ``solve_fn`` gradient at P ranks on
    the matmul backend, for ``jax.grad`` of the JAX solver."""
    n = 8
    plan = _slab(2 * n, fft_backend="matmul")
    s = PoissonSolver(plan, bc="dirichlet")
    w, f = _rng(10).random((n, n, n)), _rng(11).random((n, n, n))
    grad, s_w = _extended_grad(s, w, f)
    return {"w": w, "f": f, "grad": grad, "solve_w": s_w}


def _guards_wire():
    from distributedfft_tpu_torch import obs
    g = tdfft.GlobalSize(32, 32, 32)
    f = _rng().random(g.shape).astype(np.float32)
    f -= f.mean()
    out = {}
    for name, kw in (("native", dict(wire_dtype="native", guards="off")),
                     ("wire16", dict(wire_dtype="bf16", guards="check")),
                     ("ring16", dict(wire_dtype="bf16", guards="check",
                                     send_method=tdfft.SendMethod.RING)),
                     ("ring16-fused", dict(wire_dtype="bf16", guards="check",
                                           send_method=tdfft.SendMethod.RING,
                                           fused_wire=True,
                                           fft_backend="pallas"))):
        seq = "Z_Then_YX" if name == "ring16-fused" else "ZY_Then_X"
        plan = tdfft.SlabFFTPlan(g, tdfft.SlabPartition(P),
                                 tdfft.Config(use_wisdom=False, **kw),
                                 sequence=seq, device="cpu")
        obs.metrics.reset()
        u = plan.crop_real(PoissonSolver(plan).solve(f))
        c = obs.metrics.snapshot()["counters"]
        out[name] = {"u": u,
                     "parseval": c.get("guard.parseval_violations", 0),
                     "drift": c.get("guard.wire_drift_violations", 0)}
    return out


RANKED = {
    "ns2d-mirror": _ns2d_mirror, "ns2d-tg": _ns2d_tg,
    "ns-invariants": _ns_invariants, "ns3d-energy": _ns3d_energy,
    "ns2d-grad": _ns2d_grad, "ns3d-grad": _ns3d_grad,
    "ns3d-pencil": _ns3d_pencil,
    "dirichlet": lambda: _dirichlet("dirichlet"),
    "neumann": lambda: _dirichlet("neumann"),
    "mixed": _mixed, "periodic-batched": _periodic_batched,
    "conv-full": lambda: _conv("full"), "conv-same": lambda: _conv("same"),
    "conv-valid": lambda: _conv("valid"),
    "corr-full": lambda: _conv("full", True),
    "corr-same": lambda: _conv("same", True),
    "corr-valid": lambda: _conv("valid", True),
    "conv-slab": lambda: _conv("same", family="slab"),
    "conv-pencil": lambda: _conv("same", family="pencil"),
    "conv-exact": lambda: _conv("valid", pad="exact", backend="bluestein"),
    "conv-pallas": lambda: _conv("same", backend="pallas"),
    "conv-grad-matmul": _conv_grad_matmul,
    "dirichlet-grad-matmul": _dirichlet_grad_matmul,
    "guards-wire": _guards_wire,
}


def _rank_main(rank, addr, outdir):
    multihost.maybe_initialize(addr, P, rank, backend="gloo", timeout_s=120)
    results = {}
    for key, fn in RANKED.items():
        try:
            results[key] = fn()
        except Exception:  # noqa: BLE001 — reported by that case's test
            results[key] = {"error": traceback.format_exc()}
    results["modules"] = sorted(m for m in sys.modules
                                if m.split(".")[0] in FORBIDDEN)
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    multihost.shutdown()


# ---------------------------------------------------------------------------
# The parent
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("solvers")
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


def _jax_mesh(devices):
    from distributedfft_tpu.parallel.mesh import make_slab_mesh
    return make_slab_mesh(P, devices)


# -- Navier-Stokes ------------------------------------------------------------


def test_ns2d_matches_numpy_reference(world, devices):
    """3 RK4 steps of a random vorticity field through the batched-2D
    pipeline over 4 ranks == the numpy mirror (1e-13), and the JAX
    solver's run on the same plan shape."""
    import distributedfft_tpu as jdfft
    from distributedfft_tpu.models.batched2d import Batched2DFFTPlan
    from distributedfft_tpu.solvers import NavierStokes2D as JNS
    res = _result(world, 0, "ns2d-mirror")
    assert _result(world, 1, "ns2d-mirror")["local"] == (2, 6, 24)
    for b in range(2):
        np.testing.assert_allclose(res["w"][b],
                                   _np_ns2d_steps(res["w0"][b], 3, 1e-2, 0.02),
                                   atol=1e-13)
    jplan = Batched2DFFTPlan(2, 24, 24, jdfft.SlabPartition(P),
                             jdfft.Config(double_prec=True, use_wisdom=False),
                             mesh=_jax_mesh(devices), shard="x")
    jw = np.asarray(JNS(jplan, 0.02).run(res["w0"], 3, 1e-2))[:, :24, :24]
    np.testing.assert_allclose(res["w"], jw, atol=1e-13)


def test_ns2d_taylor_green_exact_decay(world):
    w0 = taylor_green_2d(32, batch=1)
    np.testing.assert_allclose(_result(world, 0, "ns2d-tg")["w"],
                               w0 * np.exp(-2 * 0.05 * 1e-2 * 5), atol=1e-12)


def test_ns_energy_enstrophy_sanity_under_dealiasing(world):
    """Inviscid runs conserve energy and enstrophy to RK4 accuracy;
    viscosity dissipates both; every rank reads the same sums."""
    res = _result(world, 0, "ns-invariants")
    d0, dT, dV = res["d0"], res["dT"], res["dV"]
    assert abs(dT["energy"] - d0["energy"]) <= 1e-9 * max(d0["energy"], 1)
    assert abs(dT["enstrophy"] - d0["enstrophy"]) \
        <= 1e-7 * max(d0["enstrophy"], 1)
    assert dV["energy"] < d0["energy"] and dV["enstrophy"] < d0["enstrophy"]
    for r in range(1, P):
        assert _result(world, r, "ns-invariants") == res, r


def test_ns3d_taylor_green_conserves_energy_inviscid(world):
    res = _result(world, 0, "ns3d-energy")
    assert res["e0"] == pytest.approx(0.125, rel=1e-6)
    assert res["eT"] == pytest.approx(res["e0"], rel=1e-8)


def test_ns2d_grad_multistep(world):
    """``test_ns2d_jit_grad_multistep`` over 4 ranks: the gradient of a
    4-step solve (each RHS four independent inverse branches and a
    forward, each exchange's backward posted by every rank in one order)
    against central differences at rel=1e-6."""
    res0 = _result(world, 0, "ns2d-grad")
    grad = np.zeros(res0["padded"])
    for r in range(P):
        res = _result(world, r, "ns2d-grad")
        grad[tuple(slice(a, b) for a, b in res["where"])] = res["grad"]
    assert np.all(np.isfinite(grad))
    for idx, fd in zip(((0, 3, 5), (1, 7, 2)), res0["fd"]):
        assert grad[idx] == pytest.approx(fd, rel=1e-6, abs=1e-10), idx


def test_ns3d_grad_multistep_slab(world):
    """``test_ns3d_jit_grad_multistep_slab`` over 4 ranks (6 inverse and 3
    forward transforms an RHS)."""
    fd = _result(world, 0, "ns3d-grad")["fd"]
    got = [_result(world, r, "ns3d-grad")["grad_0123"] for r in range(P)]
    owned = [g for g in got if g is not None]
    assert len(owned) == 1
    assert owned[0] == pytest.approx(fd, rel=1e-6)


def test_ns3d_runs_on_pencil(world):
    res = _result(world, 0, "ns3d-pencil")
    np.testing.assert_allclose(res["slab"], res["pencil"], atol=1e-12)


def test_make_solver_dispatch():
    g = tdfft.GlobalSize(16, 16, 16)
    plan3 = tdfft.SlabFFTPlan(g, tdfft.SlabPartition(1), _cfg(), device="cpu")
    plan2 = tdfft.Batched2DFFTPlan(1, 16, 16, tdfft.SlabPartition(1), _cfg(),
                                   device="cpu")
    assert isinstance(make_solver("poisson", plan3), PoissonSolver)
    assert isinstance(make_solver("navier_stokes", plan3, viscosity=1e-3),
                      NavierStokes3D)
    assert isinstance(make_solver("navier-stokes", plan2, viscosity=1e-3),
                      NavierStokes2D)
    conv = make_solver("convolve", plan2, kernel=np.ones((3, 3)),
                       image_shape=(14, 14))
    assert conv.plan is plan2
    with pytest.raises(ValueError, match="unknown solver kind"):
        make_solver("heat", plan3)
    with pytest.raises(TypeError, match="viscosity"):
        make_solver("ns", plan3)


# -- Poisson boundary conditions ----------------------------------------------


@pytest.mark.parametrize("bc", ["dirichlet", "neumann"])
def test_poisson_extended_box_on_the_split_axis(world, devices, bc):
    """``test_poisson_dirichlet_box`` / ``test_poisson_neumann_box`` with
    the extension on the split x axis over 4 ranks: ranks 0 and 1 hold the
    interior rows, ranks 2 and 3 only mirror rows (an empty interior);
    the gathered interior is the closed form and the JAX solver's;
    the gradient of ``solve_fn`` of the extended box on P ranks
    (all-reduced) is the solve of the weights."""
    from distributedfft_tpu.solvers.poisson import PoissonSolver as JSolver
    import distributedfft_tpu as jdfft
    res = _result(world, 0, bc)
    assert res["interior"] == (16, 16, 16)
    assert [_result(world, r, bc)["local"][0] for r in range(P)] == \
        [8, 8, 0, 0]
    np.testing.assert_allclose(res["u"], res["u_true"], atol=1e-12)
    for r in range(P):
        np.testing.assert_allclose(_result(world, r, bc)["solve_fn_grad"],
                                   res["solve_w"], atol=1e-10)
    L = 1.3 if bc == "dirichlet" else 2.0
    jplan = jdfft.SlabFFTPlan(jdfft.GlobalSize(32, 32, 32),
                              jdfft.SlabPartition(P),
                              jdfft.Config(double_prec=True,
                                           use_wisdom=False),
                              mesh=_jax_mesh(devices))
    ju = JSolver(jplan, lengths=(L,) * 3, bc=bc).solve(
        -3.0 * (np.pi / L) ** 2 * res["u_true"])
    np.testing.assert_allclose(res["u"], np.asarray(ju), atol=1e-12)


def test_poisson_mixed_bc_batched2d(world):
    """Dirichlet on x, the split axis of the batched plan, periodic y."""
    res = _result(world, 0, "mixed")
    assert res["interior"] == (2, 16, 16)
    np.testing.assert_allclose(res["u"], res["u_true"], atol=1e-12)


def test_poisson_periodic_batched2d(world):
    res = _result(world, 0, "periodic-batched")
    np.testing.assert_allclose(res["u"], res["u_true"], atol=1e-12)


def test_poisson_bc_validation():
    plan = tdfft.SlabFFTPlan(tdfft.GlobalSize(16, 16, 16),
                             tdfft.SlabPartition(1), _cfg(), device="cpu")
    with pytest.raises(ValueError, match="unknown bc"):
        PoissonSolver(plan, bc="robin")
    with pytest.raises(ValueError, match="integer"):
        PoissonSolver(plan, bc="dirichlet", mode="integer")
    odd = tdfft.SlabFFTPlan(tdfft.GlobalSize(16, 16, 19),
                            tdfft.SlabPartition(1), _cfg(), device="cpu")
    with pytest.raises(ValueError, match="EXTENDED extent"):
        PoissonSolver(odd, bc="dirichlet")


def test_poisson_extended_solve_fn_one_rank(rng):
    """On one rank the extended box's ``solve_fn`` differentiates: its
    gradient is the solve of the weights (S self-adjoint on the interior's
    extension), as the JAX package's ``solve_fn`` gives."""
    n = 8
    plan = tdfft.SlabFFTPlan(tdfft.GlobalSize(2 * n, 2 * n, 2 * n),
                             tdfft.SlabPartition(1), _cfg(), device="cpu")
    s = PoissonSolver(plan, bc="neumann")
    f = torch.tensor(rng.random((n, n, n)), requires_grad=True)
    w = torch.tensor(rng.random((n, n, n)))
    u = s.solve_fn()(f)
    np.testing.assert_allclose(u.detach().numpy(), s.solve(f.detach()).numpy(),
                               atol=1e-12)
    torch.sum(w * u).backward()
    np.testing.assert_allclose(f.grad.numpy(), s.solve(w).numpy(),
                               atol=1e-12)


# -- DCT / DST -----------------------------------------------------------------


@pytest.mark.parametrize("kind", ["dct", "dst"])
@pytest.mark.parametrize("type", [1, 2, 3])
def test_r2r_matches_scipy(rng, kind, type):
    """scipy's goldens (norm None and ortho, the inverses) at 1e-12, and
    the JAX package's ``r2r`` on the same input."""
    from distributedfft_tpu.solvers import r2r as jr2r
    x = rng.random((3, 11))
    ours, ref = getattr(r2r, kind), getattr(scipy_fft, kind)
    np.testing.assert_allclose(ours(x, type=type).numpy(),
                               ref(x, type=type, axis=-1), atol=1e-12)
    np.testing.assert_allclose(ours(x, type=type).numpy(),
                               np.asarray(getattr(jr2r, kind)(x, type=type)),
                               atol=1e-12)
    if type != 1:
        np.testing.assert_allclose(
            ours(x, type=type, norm="ortho").numpy(),
            ref(x, type=type, norm="ortho", axis=-1), atol=1e-12)
    else:
        with pytest.raises(NotImplementedError):
            ours(x, type=1, norm="ortho")
    inv, iref = getattr(r2r, "i" + kind), getattr(scipy_fft, "i" + kind)
    np.testing.assert_allclose(inv(x, type=type).numpy(),
                               iref(x, type=type, axis=-1), atol=1e-12)


def test_r2r_axes_backends_and_n(rng):
    x = rng.random((7, 13))
    np.testing.assert_allclose(r2r.dct(x, axis=0).numpy(),
                               scipy_fft.dct(x, axis=0), atol=1e-12)
    np.testing.assert_allclose(r2r.dctn(x).numpy(), scipy_fft.dctn(x),
                               atol=1e-11)
    np.testing.assert_allclose(r2r.dstn(x).numpy(), scipy_fft.dstn(x),
                               atol=1e-11)
    xp = rng.random((2, 127))
    np.testing.assert_allclose(r2r.dct(xp, backend="bluestein").numpy(),
                               scipy_fft.dct(xp), atol=1e-10)
    np.testing.assert_allclose(r2r.dst(xp[:, :16], backend="matmul").numpy(),
                               scipy_fft.dst(xp[:, :16]), atol=1e-11)
    np.testing.assert_allclose(r2r.idct(r2r.dct(x)).numpy(), x, atol=1e-12)


@pytest.mark.parametrize("kind", ["dctn", "dstn"])
@pytest.mark.parametrize("type", [2, 3])
def test_r2r_pallas_float32(rng, kind, type):
    """Under "pallas" in float32 (the kernels' plain versions on the CPU:
    kernel 1 on the extension rows for type 2, kernel 3 for type 3)
    against scipy in float64 at 2e-3, against "xla" at 2e-3."""
    x = rng.random((6, 16, 8)).astype(np.float32)
    got = getattr(r2r, kind)(x, type=type, backend="pallas").numpy()
    ref = getattr(scipy_fft, kind)(x.astype(np.float64), type=type)
    assert np.max(np.abs(got - ref)) <= 2e-3 * np.max(np.abs(ref))
    xla = getattr(r2r, kind)(x, type=type, backend="xla").numpy()
    assert np.max(np.abs(got - xla)) <= 2e-3 * np.max(np.abs(xla))


# -- convolution -------------------------------------------------------------


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_convolve_batched_images_vs_scipy(world, mode):
    res = _result(world, 0, f"conv-{mode}")
    assert res["plan_shape"][1:] == conv_shape((20, 17), (5, 4))
    ref = np.stack([scipy_signal.convolve2d(res["img"][i], res["ker"],
                                            mode=mode) for i in range(3)])
    np.testing.assert_allclose(res["out"], ref, atol=1e-12)
    # conv_fn's gradient on P ranks (all-reduced) is the one-rank one.
    one = make_convolver(res["ker"], (20, 17), batch=3, mode=mode,
                         partition=tdfft.SlabPartition(1), config=_cfg(),
                         device="cpu")
    v = torch.tensor(res["img"], requires_grad=True)
    torch.sum(one.conv_fn()(v) ** 2).backward()
    for r in range(P):
        np.testing.assert_allclose(
            _result(world, r, f"conv-{mode}")["conv_fn_grad"],
            v.grad.numpy(), atol=1e-10)
    for r in range(1, P):
        assert np.array_equal(_result(world, r, f"conv-{mode}")["out"],
                              res["out"])


def test_convolve_same_matches_jax(world, devices):
    import distributedfft_tpu as jdfft
    from distributedfft_tpu.solvers import make_convolver as jmake
    res = _result(world, 0, "conv-same")
    cv = jmake(res["ker"], (20, 17), batch=3, mode="same",
               partition=jdfft.SlabPartition(P),
               config=jdfft.Config(double_prec=True, use_wisdom=False),
               mesh=_jax_mesh(devices))
    np.testing.assert_allclose(res["out"], np.asarray(cv(res["img"])),
                               atol=1e-12)


def test_convolve_1d_matches_np_convolve(rng):
    x, k = rng.random(21), rng.random(6)
    cv = make_convolver(k[None, :], (1, 21), batch=1, mode="full",
                        partition=tdfft.SlabPartition(1), config=_cfg(),
                        device="cpu")
    got = cv(x[None, None, :]).numpy()[0, 0]
    np.testing.assert_allclose(got, np.convolve(x, k), atol=1e-12)


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_correlate_matches_scipy(world, mode):
    res = _result(world, 0, f"corr-{mode}")
    ref = np.stack([scipy_signal.correlate2d(res["img"][i], res["ker"],
                                             mode=mode) for i in range(2)])
    np.testing.assert_allclose(res["out"], ref, atol=1e-12)


@pytest.mark.parametrize("family", ["slab", "pencil"])
def test_convolve_volume_slab_and_pencil(world, family):
    res = _result(world, 0, f"conv-{family}")
    ref = scipy_signal.convolve(res["img"], res["ker"], mode="same",
                                method="direct")
    np.testing.assert_allclose(res["out"], ref, atol=1e-12)


def test_convolve_exact_pad_bluestein(world):
    res = _result(world, 0, "conv-exact")
    assert res["plan_shape"][1:] == (24, 20)
    ref = np.stack([scipy_signal.convolve2d(res["img"][i], res["ker"],
                                            mode="valid") for i in range(3)])
    np.testing.assert_allclose(res["out"], ref, atol=1e-12)


def test_convolve_pallas_float64(world):
    """float64 "pallas" (the matmul backend's route) over 4 ranks."""
    res = _result(world, 0, "conv-pallas")
    ref = np.stack([scipy_signal.convolve2d(res["img"][i], res["ker"],
                                            mode="same") for i in range(3)])
    np.testing.assert_allclose(res["out"], ref, atol=1e-12)


def test_convolve_grad(rng):
    """``test_convolve_grad``: the gradient through ``conv_fn`` (one rank,
    "matmul") is finite, nonzero, and the JAX package's."""
    import jax
    import jax.numpy as jnp
    import distributedfft_tpu as jdfft
    from distributedfft_tpu.solvers import make_convolver as jmake
    vol, k3 = rng.random((8, 8, 8)), rng.random((3, 3, 3))
    cv = make_convolver(k3, (8, 8, 8), family="slab", mode="same",
                        partition=tdfft.SlabPartition(1),
                        config=_cfg(fft_backend="matmul"), device="cpu")
    v = torch.tensor(vol, requires_grad=True)
    torch.sum(cv.conv_fn()(v) ** 2).backward()
    g = v.grad.numpy()
    assert g.shape == vol.shape and np.all(np.isfinite(g)) and np.any(g != 0)
    jcv = jmake(k3, (8, 8, 8), family="slab", mode="same",
                partition=jdfft.SlabPartition(1),
                config=jdfft.Config(double_prec=True, use_wisdom=False,
                                    fft_backend="matmul"))
    fn = jcv.conv_fn()
    jg = jax.grad(lambda x: jnp.sum(fn(x) ** 2))(jnp.asarray(vol))
    np.testing.assert_allclose(g, np.asarray(jg), atol=1e-10)


def test_convolve_grad_on_four_ranks(world, devices):
    """``test_convolve_grad`` at P = 4 (``SlabPartition(4)``, "matmul",
    float64): every rank holds the gradient of the whole loss, and it is
    ``jax.grad``'s through the JAX convolver on a 4-device mesh."""
    import jax
    import jax.numpy as jnp
    import distributedfft_tpu as jdfft
    from distributedfft_tpu.solvers import make_convolver as jmake
    res = _result(world, 0, "conv-grad-matmul")
    jcv = jmake(res["k3"], (8, 8, 8), family="slab", mode="same",
                partition=jdfft.SlabPartition(P),
                config=jdfft.Config(double_prec=True, use_wisdom=False,
                                    fft_backend="matmul"),
                mesh=_jax_mesh(devices))
    fn = jcv.conv_fn()
    jg = np.asarray(jax.grad(lambda x: jnp.sum(fn(x) ** 2))(
        jnp.asarray(res["vol"])))
    for r in range(P):
        g = _result(world, r, "conv-grad-matmul")["grad"]
        assert g.shape == res["vol"].shape and np.all(np.isfinite(g))
        np.testing.assert_allclose(g, jg, atol=1e-10)


def test_extended_box_solve_fn_grad_on_four_ranks(world, devices):
    """An extended (Dirichlet) box's ``solve_fn`` at P = 4 on the matmul
    backend: the all-reduced gradient of sum(w * u) on every rank is
    ``jax.grad``'s through the JAX solver on a 4-device mesh (and the
    solve of w)."""
    import jax
    import jax.numpy as jnp
    import distributedfft_tpu as jdfft
    from distributedfft_tpu.solvers.poisson import PoissonSolver as JSolver
    res = _result(world, 0, "dirichlet-grad-matmul")
    jplan = jdfft.SlabFFTPlan(jdfft.GlobalSize(16, 16, 16),
                              jdfft.SlabPartition(P),
                              jdfft.Config(double_prec=True,
                                           use_wisdom=False,
                                           fft_backend="matmul"),
                              mesh=_jax_mesh(devices))
    sfn = JSolver(jplan, bc="dirichlet").solve_fn()
    w = res["w"]
    jg = np.asarray(jax.grad(lambda x: jnp.sum(w * sfn(x)))(
        jnp.asarray(res["f"])))
    for r in range(P):
        g = _result(world, r, "dirichlet-grad-matmul")["grad"]
        np.testing.assert_allclose(g, jg, atol=1e-10)
        np.testing.assert_allclose(g, res["solve_w"], atol=1e-10)


# -- guards + compressed wire through a solver path ---------------------------


@pytest.mark.parametrize("name", ["wire16", "ring16", "ring16-fused"])
def test_solver_guards_check_with_wire16(world, devices, name):
    """``test_solver_guards_check_with_bf16_wire`` over 4 ranks: the
    guarded bf16-wire solve (the default exchange; the ring; the ring with
    the fused wire, kernels 9 and 11's plain versions) within 2e-2 of the
    native solve, no guard violation on any rank; the native solve equals
    the JAX package's."""
    import distributedfft_tpu as jdfft
    from distributedfft_tpu.solvers.poisson import PoissonSolver as JSolver
    native = _result(world, 0, "guards-wire")["native"]["u"]
    for r in range(P):
        res = _result(world, r, "guards-wire")
        row = res[name]
        assert np.all(np.isfinite(row["u"]))
        scale = np.max(np.abs(native)) or 1.0
        assert np.max(np.abs(row["u"] - native)) / scale < 2e-2, r
        assert row["parseval"] == 0 and row["drift"] == 0, (r, row)
    if name == "wire16":
        g = jdfft.GlobalSize(32, 32, 32)
        f = _rng().random(g.shape).astype(np.float32)
        f -= f.mean()
        jplan = jdfft.SlabFFTPlan(g, jdfft.SlabPartition(P),
                                  jdfft.Config(use_wisdom=False),
                                  mesh=_jax_mesh(devices))
        ju = np.asarray(JSolver(jplan).solve(f))
        assert np.max(np.abs(native - ju)) / np.max(np.abs(ju)) <= 1e-5


def test_ranks_import_no_jax(world):
    for r in range(P):
        assert world[r]["modules"] == [], r
