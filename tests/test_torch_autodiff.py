"""Differentiability of the port's distributed pipelines: ``forward_fn`` /
``inverse_fn`` of the slab, pencil and batched-2D plans under
``loss.backward()``, across 4 gloo ranks on the CPU, against ``jax.grad``
of the JAX package's plans on a 4-device mesh under the same Config.

Every case of ``tests/test_autodiff.py`` (slab P=4, pencil 2 x 2, batched
both shards, both comm methods, every sequence, c2c, the pad, the shape
check, the cache, the spectral solve against central differences, the
Poisson ``solve_fn``), plus the ring, RING_OVERLAP, the bf16 wire,
STREAMS and the pipelined all-to-all (whose JAX test,
``tests/test_overlap_tuning.py:179``, fails in the reference's own runs:
the port holds its identity, grad = w), and ``"pallas"``: float32
``backward`` raises ``NotImplementedError`` on every rank (the kernels
have no VJP; the JAX package's CPU mesh computes its shard_mapped stages
with jnp instead, so only its single-device kernel path raises), float64
(the matmul backend's route) matches JAX's gradient.

One 4-rank world runs every case (a module fixture); each rank returns its
gradient block and where it lies, and the parent assembles the global
gradient. Each rank differentiates its own share of the loss; the
exchanges' backward brings the other ranks' cotangents. The ranks import
this module, which imports no JAX at its top. Tolerances: 1e-12 in
float64 (the JAX pins' 1e-10 against the identity), 1e-5 in float32 under
"xla", 2e-2 on the bf16 wire; finite differences at ``rel=1e-6``.
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

P = 4
SEED = 31
FORBIDDEN = ("jax", "jaxlib", "distributedfft_tpu")
DP = {"double_prec": True, "fft_backend": "matmul"}
W16 = {"fft_backend": "matmul", "wire_dtype": "bf16"}
G16 = (16, 16, 16)
TOL = {"f64": 1e-12, "f32": 1e-5, "wire16": 2e-2}

# id -> (family, shape, Config fields, transform, sequence, precision)
CASES = {
    "slab": ("slab", G16, DP, "r2c", "ZY_Then_X", "f64"),
    "slab-Z_Then_YX": ("slab", G16, DP, "r2c", "Z_Then_YX", "f64"),
    "slab-Y_Then_ZX": ("slab", G16, DP, "r2c", "Y_Then_ZX", "f64"),
    "slab-All2All": ("slab", G16, dict(DP, comm_method="All2All"), "r2c",
                     "ZY_Then_X", "f64"),
    "slab-Peer2Peer": ("slab", G16, dict(DP, comm_method="Peer2Peer"), "r2c",
                       "ZY_Then_X", "f64"),
    "slab-pad": ("slab", (18, 16, 16), DP, "r2c", "ZY_Then_X", "f64"),
    "pencil": ("pencil", G16, DP, "r2c", None, "f64"),
    "pencil-p2p": ("pencil", G16, dict(DP, comm_method="Peer2Peer"), "r2c",
                   None, "f64"),
    "batched-batch": ("batch", (8, 16, 16), DP, "r2c", None, "f64"),
    "batched-x": ("x", (8, 16, 16), DP, "r2c", None, "f64"),
    "xla-f32": ("slab", G16, {}, "r2c", "ZY_Then_X", "f32"),
    # The renderings the JAX autodiff tests leave out.
    "ring": ("slab", G16, dict(DP, send_method="Ring"), "r2c", "ZY_Then_X",
             "f64"),
    "ring-Z_Then_YX": ("slab", G16, dict(DP, send_method="Ring"), "r2c",
                       "Z_Then_YX", "f64"),
    "overlap-d3-s2": ("slab", G16, dict(DP, send_method="RingOverlap",
                                        overlap_depth=3,
                                        overlap_subblocks=2), "r2c",
                      "Z_Then_YX", "f64"),
    "overlap-wire16": ("slab", G16, dict(W16, send_method="RingOverlap"),
                       "r2c", "Z_Then_YX", "wire16"),
    "a2a-wire16": ("slab", G16, dict(W16, comm_method="All2All"), "r2c",
                   "ZY_Then_X", "wire16"),
    "p2p-wire16": ("slab", G16, dict(W16, comm_method="Peer2Peer"), "r2c",
                   "ZY_Then_X", "wire16"),
    "a2a-pipe": ("slab", G16, dict(DP, comm_method="All2All", opt=1,
                                   overlap_subblocks=2), "r2c", "Z_Then_YX",
                 "f64"),
    "streams": ("slab", G16, dict(DP, comm_method="All2All",
                                  send_method="Streams", streams_chunks=2),
                "r2c", "ZY_Then_X", "f64"),
    "pencil-ring": ("pencil", G16, dict(DP, send_method="Ring"), "r2c", None,
                    "f64"),
    "batched-x-ring": ("x", (8, 16, 16), dict(DP, send_method="RingOverlap"),
                       "r2c", None, "f64"),
    "pallas-f64": ("slab", G16, {"double_prec": True, "fft_backend": "pallas"},
                   "r2c", "ZY_Then_X", "f64"),
}
# The cases also held against ``jax.grad`` of the JAX plan, one a family
# (a JAX gradient through shard_map costs seconds to trace: the rest hold
# the identity the JAX tests assert). Not the pipelined all-to-all (its
# JAX test fails in the reference's runs), nor "xla" (the JAX package's
# XLA FFT has no VJP under shard_map), nor a bf16 wire (a JAX trace of a
# bf16 plan in a worker can fail the reference's HLO pins that run after
# it there: ROADMAP Queue 3).
VS_JAX = ("slab", "pencil", "batched-x")
C2C = "slab-c2c"


def _config(pkg, fields):
    kw = dict(fields)
    for k, enum in (("send_method", pkg.SendMethod),
                    ("comm_method", pkg.CommMethod)):
        if k in kw:
            kw[k] = enum(kw[k])
    return pkg.Config(**kw)


def _dt(prec):
    return np.float64 if prec == "f64" else np.float32


def _draws(shape, prec, seed=SEED):
    rng = np.random.default_rng(seed)
    return rng.random(shape).astype(_dt(prec)), rng.random(shape).astype(
        _dt(prec))


def _norm(family, shape):
    return float(shape[1] * shape[2]) if family in ("batch", "x") else \
        float(np.prod(shape))


# ---------------------------------------------------------------------------
# The ranks (no JAX here)
# ---------------------------------------------------------------------------


def _port_plan(family, shape, fields, transform="r2c", seq="ZY_Then_X"):
    cfg = _config(tdfft, fields)
    if family == "slab":
        return tdfft.SlabFFTPlan(tdfft.GlobalSize(*shape),
                                 tdfft.SlabPartition(P), cfg,
                                 transform=transform, sequence=seq,
                                 device="cpu")
    if family == "pencil":
        return tdfft.PencilFFTPlan(tdfft.GlobalSize(*shape),
                                   tdfft.PencilPartition(2, 2), cfg,
                                   transform=transform, device="cpu")
    return tdfft.Batched2DFFTPlan(*shape, tdfft.SlabPartition(P), cfg,
                                  shard=family, device="cpu")


def _where(plan):
    return [(s.start or 0, s.stop) for s in plan.local_slices()]


def _run_roundtrip(cid):
    family, shape, fields, tr, seq, prec = CASES[cid]
    plan = _port_plan(family, shape, fields, tr, seq)
    x, w = _draws(shape, prec)
    fwd, inv = plan.forward_fn(), plan.inverse_fn()
    xl = plan.pad_input(x).requires_grad_()
    wl = plan.pad_input(w)
    loss = torch.sum(wl * inv(fwd(xl))) / _norm(family, shape)
    loss.backward()
    with torch.no_grad():
        same = torch.equal(fwd(xl), plan.exec_fwd(xl.detach()))
    return {"grad": xl.grad.numpy(), "where": _where(plan),
            "padded": plan.input_padded_shape, "fwd_is_exec": same}


def _run_pad(_):
    """Logical-shaped blocks padded inside ``forward_fn``: (18, 16, 16)
    over 4 ranks, blocks of 5 rows, the last one 3 logical rows."""
    shape = (18, 16, 16)
    plan = _port_plan("slab", shape, DP)
    x, w = _draws(shape, "f64")
    r0, r1 = _where(plan)[0]
    xl = torch.from_numpy(x[r0:min(r1, shape[0])].copy()).requires_grad_()
    fwd, inv = plan.forward_fn(), plan.inverse_fn()
    a = fwd(xl)
    b = plan.exec_r2c(plan.pad_input(x))
    y = inv(a)
    wl = plan.pad_input(w)
    torch.sum(wl * y / float(np.prod(shape))).backward()
    err = None
    try:
        fwd(torch.zeros(r1 - r0 + 1, 16, 16, dtype=torch.float64))
    except ValueError as e:
        err = str(e)
    return {"logical_rows": tuple(xl.shape), "equal": torch.equal(a.detach(), b),
            "grad": xl.grad.numpy(), "rows": (r0, min(r1, shape[0])),
            "shape_error": err}


def _run_cached(_):
    g = tdfft.GlobalSize(*G16)
    plan = tdfft.SlabFFTPlan(g, tdfft.SlabPartition(P),
                             tdfft.Config(double_prec=True), device="cpu")
    pplan = tdfft.PencilFFTPlan(g, tdfft.PencilPartition(2, 2),
                                tdfft.Config(double_prec=True), device="cpu")
    return {"slab": (plan.forward_fn() is plan.forward_fn(),
                     plan.inverse_fn() is plan.inverse_fn()),
            "pencil": (pplan.forward_fn() is pplan.forward_fn(),
                       pplan.forward_fn(dims=2) is pplan.forward_fn(dims=2),
                       pplan.forward_fn(dims=2) is not pplan.forward_fn(3))}


def _run_c2c(_):
    plan = _port_plan("slab", G16, DP, "c2c")
    rng = np.random.default_rng(SEED)
    x0 = rng.random(G16) + 1j * rng.random(G16)
    v = rng.random(G16) + 1j * rng.random(G16)
    fwd, inv = plan.forward_fn(), plan.inverse_fn()
    vl = plan.pad_input(v).requires_grad_()
    y = inv(fwd(vl)) / float(np.prod(G16))
    torch.sum(torch.abs(y - plan.pad_input(x0)) ** 2).backward()
    return {"grad": vl.grad.numpy(), "where": _where(plan)}


def _run_fd(_):
    """Central differences of a spectral solve with a random symbol:
    every rank evaluates its share of the loss; the shares are summed."""
    import torch.distributed as dist
    shape = (8, 8, 8)
    plan = _port_plan("slab", shape, DP)
    rng = np.random.default_rng(SEED)
    w = rng.random(shape)
    sym = rng.random(plan.output_padded_shape) + 0.5
    sym = torch.from_numpy(sym[plan.local_slices(output=True)].copy())
    fwd, inv = plan.forward_fn(), plan.inverse_fn()
    wl = plan.pad_input(w)

    def loss(fl):
        return torch.sum(wl * inv(fwd(fl) * sym) / 512.0)

    f0 = rng.random(shape)
    fl = plan.pad_input(f0).requires_grad_()
    loss(fl).backward()
    fds = {}
    eps = 1e-6
    for idx in (0, 17, 123, 511):
        vals = []
        for d in (eps, -eps):
            f = f0.copy().reshape(-1)
            f[idx] += d
            with torch.no_grad():
                s = loss(plan.pad_input(f.reshape(shape)))
            dist.all_reduce(s)
            vals.append(float(s))
        fds[idx] = (vals[0] - vals[1]) / (2 * eps)
    return {"grad": fl.grad.numpy(), "where": _where(plan), "fd": fds,
        }


def _run_poisson(_):
    from distributedfft_tpu_torch.solvers.poisson import PoissonSolver
    plan = _port_plan("slab", G16, DP)
    solver = PoissonSolver(plan, mode="integer")
    f, w = _draws(G16, "f64")
    a = solver.solve(f)
    fl = plan.pad_input(f).requires_grad_()
    b = solver.solve_fn()(fl)
    wl = plan.pad_input(w)
    torch.sum(wl * b).backward()
    return {"solve": a.numpy(), "solve_fn": b.detach().numpy(),
            "grad": fl.grad.numpy(), "solve_w": solver.solve(w).numpy(),
            "where": _where(plan)}


def _run_pallas_raises(family):
    """float32 "pallas": the forward is exec_fwd's bit for bit, and the
    backward raises on every rank."""
    shape = G16 if family != "x" else (8, 16, 16)
    plan = _port_plan(family, shape, {"fft_backend": "pallas"})
    x, w = _draws(shape, "f32")
    xl = plan.pad_input(x).requires_grad_()
    with torch.no_grad():
        same = torch.equal(plan.forward_fn()(xl), plan.exec_fwd(xl.detach()))
    y = plan.inverse_fn()(plan.forward_fn()(xl))
    try:
        torch.sum(plan.pad_input(w) * y).backward()
        raised = None
    except NotImplementedError as e:
        raised = str(e)
    return {"same": same, "raised": raised}


def _rank_main(rank, addr, jobs, outdir):
    multihost.maybe_initialize(addr, P, rank, backend="gloo", timeout_s=120)
    runners = {"rt": _run_roundtrip, "pad": _run_pad, "cached": _run_cached,
               "c2c": _run_c2c, "fd": _run_fd, "poisson": _run_poisson,
               "pallas": _run_pallas_raises}
    results = {}
    for key, (kind, arg) in jobs.items():
        try:
            results[key] = runners[kind](arg)
        except Exception:  # noqa: BLE001 — reported by that case's test
            results[key] = {"error": traceback.format_exc()}
    results["modules"] = sorted(m for m in sys.modules
                                if m.split(".")[0] in FORBIDDEN)
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    multihost.shutdown()


# ---------------------------------------------------------------------------
# The parent: JAX references and comparisons
# ---------------------------------------------------------------------------

PALLAS_FAMILIES = ("slab", "pencil", "x")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    jobs = {cid: ("rt", cid) for cid in CASES}
    jobs.update({"pad": ("pad", None), "cached": ("cached", None),
                 C2C: ("c2c", None), "fd": ("fd", None),
                 "poisson": ("poisson", None)})
    jobs.update({f"pallas-{f}": ("pallas", f) for f in PALLAS_FAMILIES})
    outdir = tmp_path_factory.mktemp("autodiff")
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


def _assemble(world, key, padded, field="grad"):
    """The global padded array from every rank's block."""
    first = _result(world, 0, key)[field]
    out = np.zeros(padded, dtype=first.dtype)
    for r in range(P):
        res = _result(world, r, key)
        out[tuple(slice(a, b) for a, b in res["where"])] = res[field]
    return out


def _jax_plan(devices, family, shape, fields, transform="r2c",
              seq="ZY_Then_X"):
    import distributedfft_tpu as jdfft
    from distributedfft_tpu.models.batched2d import Batched2DFFTPlan
    from distributedfft_tpu.parallel.mesh import (make_pencil_mesh,
                                                  make_slab_mesh)
    cfg = _config(jdfft, fields)
    if family == "slab":
        return jdfft.SlabFFTPlan(jdfft.GlobalSize(*shape),
                                 jdfft.SlabPartition(P), cfg,
                                 mesh=make_slab_mesh(P, devices),
                                 transform=transform, sequence=seq)
    if family == "pencil":
        return jdfft.PencilFFTPlan(jdfft.GlobalSize(*shape),
                                   jdfft.PencilPartition(2, 2), cfg,
                                   mesh=make_pencil_mesh(2, 2, devices),
                                   transform=transform)
    return Batched2DFFTPlan(*shape, jdfft.SlabPartition(P), cfg,
                            mesh=make_slab_mesh(P, devices), shard=family)


def _jax_roundtrip_grad(devices, cid):
    import jax
    import jax.numpy as jnp
    family, shape, fields, tr, seq, prec = CASES[cid]
    plan = _jax_plan(devices, family, shape, fields, tr, seq or "ZY_Then_X")
    x, w = _draws(shape, prec)
    fwd, inv = plan.forward_fn(), plan.inverse_fn()
    n = _norm(family, shape)

    def loss(v):
        y = inv(fwd(v))[tuple(slice(0, s) for s in shape)]
        return jnp.sum(jnp.asarray(w) * y) / n

    return np.asarray(jax.grad(loss)(jnp.asarray(x)))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


@pytest.mark.parametrize("cid", list(CASES))
def test_grad_through_roundtrip(world, devices, cid):
    """``tests/test_autodiff.py``'s roundtrip cases (slab P=4, both comm
    methods, every sequence, pencil 2 x 2, batched both shards) and the
    renderings it leaves out: the unnormalized roundtrip over N is the
    identity, so d loss / d x = w; the gradient equals JAX's (every case
    in ``VS_JAX``), and ``forward_fn`` under ``no_grad`` is ``exec_fwd`` bit for
    bit."""
    family, shape, _, _, _, prec = CASES[cid]
    res0 = _result(world, 0, cid)
    got = _assemble(world, cid, res0["padded"])[
        tuple(slice(0, s) for s in shape)]
    _, w = _draws(shape, prec)
    tol = max(TOL[prec], 1e-10 if prec == "f64" else 0)
    assert _rel(got, w) <= tol, "grad != w"
    for r in range(P):
        assert _result(world, r, cid)["fwd_is_exec"], r
    if cid in VS_JAX:
        assert _rel(got, _jax_roundtrip_grad(devices, cid)) <= TOL[prec]


def test_forward_fn_pads_like_exec(world):
    """``test_forward_fn_pads_like_exec``: a rank's logical rows (3 on the
    last rank of 18 over 4) are padded inside ``forward_fn``, whose output
    is ``exec_r2c``'s of the padded block bit for bit; the gradient of the
    padded pipeline is w on every logical row, and a block of another
    shape raises."""
    shape = (18, 16, 16)
    _, w = _draws(shape, "f64")
    got = np.zeros(shape)
    for r in range(P):
        res = _result(world, r, "pad")
        assert res["equal"], r
        a, b = res["rows"]
        assert res["logical_rows"] == (b - a, 16, 16)
        got[a:b] = res["grad"]
        assert "neither the logical" in res["shape_error"]
    assert _result(world, P - 1, "pad")["logical_rows"] == (3, 16, 16)
    assert _rel(got, w) <= 1e-10


def test_forward_fn_rejects_wrong_shape():
    """``test_forward_fn_rejects_wrong_shape``, on one rank."""
    plan = tdfft.SlabFFTPlan(tdfft.GlobalSize(20, 16, 16),
                             tdfft.SlabPartition(1),
                             tdfft.Config(double_prec=True,
                                          fft_backend="matmul"),
                             device="cpu")
    with pytest.raises(ValueError, match="neither the logical"):
        plan.forward_fn()(np.zeros((21, 16, 16)))


def test_forward_fn_is_cached(world):
    for r in range(P):
        res = _result(world, r, "cached")
        assert all(res["slab"]) and all(res["pencil"]), (r, res)


def test_grad_c2c_transform(world):
    """``test_grad_c2c_transform``: loss = |v - x0|² through the c2c
    roundtrip. torch's gradient of a real loss of complex v is
    2 (v - x0), the conjugate of JAX's 2 conj(v - x0)."""
    res0 = _result(world, 0, C2C)
    got = _assemble(world, C2C, G16)
    rng = np.random.default_rng(SEED)
    x0 = rng.random(G16) + 1j * rng.random(G16)
    v = rng.random(G16) + 1j * rng.random(G16)
    assert res0["grad"].dtype == np.complex128
    np.testing.assert_allclose(got, 2 * (v - x0), atol=1e-10)


def test_grad_through_spectral_solve_matches_fd(world):
    """``test_grad_through_spectral_solve_matches_fd`` at P=4: the
    gradient against central differences at rel=1e-6 (JAX's pin is
    1e-5)."""
    shape = (8, 8, 8)
    got = _assemble(world, "fd", shape).reshape(-1)
    res0 = _result(world, 0, "fd")
    for idx, fd in res0["fd"].items():
        assert got[idx] == pytest.approx(fd, rel=1e-6, abs=1e-9), idx


def test_grad_through_poisson_solve_fn(world, devices):
    """``test_grad_through_poisson_solve_fn``: ``solve_fn`` equals
    ``solve`` and, the operator being symmetric, d/df sum(w S f) = S w;
    the solve against the JAX solver's."""
    from distributedfft_tpu.solvers.poisson import PoissonSolver
    padded = _result(world, 0, "poisson")["grad"].shape
    padded = (padded[0] * P,) + padded[1:]
    a = _assemble(world, "poisson", padded, "solve")
    b = _assemble(world, "poisson", padded, "solve_fn")
    g = _assemble(world, "poisson", padded, "grad")
    sw = _assemble(world, "poisson", padded, "solve_w")
    assert _rel(b, a) <= 1e-12
    assert np.max(np.abs(g - sw)) <= 1e-12
    plan = _jax_plan(devices, "slab", G16, DP)
    solver = PoissonSolver(plan, mode="integer")
    f, _ = _draws(G16, "f64")
    assert _rel(a, np.asarray(solver.solve(f))) <= 1e-12


@pytest.mark.parametrize("family", PALLAS_FAMILIES)
def test_pallas_backward_raises(world, family):
    """float32 "pallas": ``forward_fn`` is ``exec_fwd`` bit for bit, and
    ``backward`` raises ``NotImplementedError`` on every rank, naming the
    missing VJP of the JAX package's Pallas kernel."""
    for r in range(P):
        res = _result(world, r, f"pallas-{family}")
        assert res["same"], r
        assert res["raised"] and "has no VJP" in res["raised"], (r, res)


def test_pallas_single_card_raises_like_jax(rng):
    """On one device the JAX package's Pallas kernels (interpret mode) give
    no gradient either; float64 "pallas" (the matmul backend's route)
    differentiates in both, to the same gradient."""
    import jax
    import jax.numpy as jnp
    import distributedfft_tpu as jdfft
    g = (8, 8, 8)
    x, w = rng.random(g), rng.random(g)
    for double in (False, True):
        cfg = dict(fft_backend="pallas", double_prec=double)
        jplan = jdfft.SlabFFTPlan(jdfft.GlobalSize(*g), jdfft.SlabPartition(1),
                                  jdfft.Config(**cfg))
        fwd, inv = jplan.forward_fn(), jplan.inverse_fn()
        dt = np.float64 if double else np.float32
        jloss = (lambda v: jnp.sum(jnp.asarray(w.astype(dt))
                                   * inv(fwd(v))) / 512.0)
        plan = tdfft.SlabFFTPlan(tdfft.GlobalSize(*g), tdfft.SlabPartition(1),
                                 tdfft.Config(**cfg), device="cpu")
        xt = torch.tensor(x.astype(dt), requires_grad=True)
        loss = torch.sum(torch.from_numpy(w.astype(dt))
                         * plan.inverse_fn()(plan.forward_fn()(xt))) / 512.0
        if not double:
            with pytest.raises(ValueError):
                jax.grad(jloss)(jnp.asarray(x.astype(dt)))
            with pytest.raises(NotImplementedError, match="has no VJP"):
                loss.backward()
            continue
        loss.backward()
        jg = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
        assert _rel(xt.grad.numpy(), jg) <= 1e-12
        assert _rel(xt.grad.numpy(), w) <= 1e-12


def test_long_prime_pallas_differentiates(rng):
    """A prime axis past the kernels' 1024 points takes the matmul backend
    under "pallas" (``hopper_fft._long_prime``): its gradient flows, and
    equals JAX's on the same route (full float32 products, as JAX's CPU
    dots are)."""
    import jax
    import jax.numpy as jnp
    from distributedfft_tpu.ops import fft as jfft
    from distributedfft_tpu_torch.ops import fft as tfft
    x = rng.random((2, 1031)).astype(np.float32)
    w = rng.random((2, 516)).astype(np.float32)
    from distributedfft_tpu_torch.ops import mxu_fft
    xt = torch.tensor(x, requires_grad=True)
    highest = mxu_fft.MXUSettings.make(precision="highest")
    torch.sum(torch.from_numpy(w) * torch.abs(
        tfft.rfft(xt, axis=-1, backend="pallas", settings=highest))).backward()
    jg = jax.grad(lambda v: jnp.sum(jnp.asarray(w) * jnp.abs(
        jfft.rfft(v, axis=-1, backend="pallas"))))(jnp.asarray(x))
    assert _rel(xt.grad.numpy(), np.asarray(jg)) <= 1e-5


def test_ranks_import_no_jax(world):
    for r in range(P):
        assert world[r]["modules"] == [], r
