"""The port's distributed SlabFFTPlan (4 ranks over gloo, on the CPU)
against the JAX package's plan on a 4-device mesh.

One 4-rank world is spawned for the whole file (a module fixture) and runs
every case; each case stays its own test. The ranks import this module to
find ``_rank_main``, so it imports neither JAX nor the JAX package at its
top: the references are computed in the parent, from the JAX
``SlabFFTPlan(..., SlabPartition(4), mesh=make_slab_mesh(4, devices))``
under the same Config, which reaches the ranks through
``config_from_reference``.

Each rank holds its block of the padded global array (local in, local
out); its forward and inverse blocks are compared with the same slices of
the JAX plan's padded global result, and the gathered ``crop_*`` arrays
with the JAX ``crop_*``. Tolerances: rel <= 1e-5 under ``"xla"`` (both
sides are float32 FFT libraries), 2e-3 under ``"pallas"``
(``tests/test_pallas_fft.py:115``, the JAX plan's own bound).
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
from distributedfft_tpu_torch.parallel import multihost
from distributedfft_tpu_torch.parallel.transpose import all_to_all_transpose

P = 4
TOL = {"xla": 1e-5, "pallas": 2e-3}

# id -> (global shape, fft_backend, norm name, transform)
PLAN_CASES = {
    f"{be}-{norm}": ((16, 16, 16), be, norm, "r2c")
    for be in ("xla", "pallas") for norm in ("NONE", "ORTHO", "BACKWARD")}
PLAN_CASES.update({
    "xla-uneven": ((10, 6, 9), "xla", "NONE", "r2c"),
    "pallas-uneven": ((10, 6, 9), "pallas", "NONE", "r2c"),
    "xla-c2c": ((10, 6, 9), "xla", "NONE", "c2c"),
    "pallas-c2c": ((10, 6, 9), "pallas", "ORTHO", "c2c"),
    "pallas-axis640": ((8, 4, 640), "pallas", "NONE", "r2c"),
})
TABLE_SHAPE = (22, 10, 16)   # nx and ny not divisible by 4
# id -> (global shape, split axis, concat axis, complex?)
A2A_CASES = {"split1-concat0": ((8, 12, 6), 1, 0, True),
             "split0-concat1": ((12, 8, 6), 0, 1, False)}
FORBIDDEN = ("jax", "jaxlib", "distributedfft_tpu")


def _global_input(shape, transform, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if transform == "c2c":
        return (x + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return x.astype(np.float32)


def _a2a_input(shape, cplx):
    x = np.arange(np.prod(shape), dtype=np.float64).reshape(shape)
    return (x + 0.5j * x).astype(np.complex64) if cplx else x


# ---------------------------------------------------------------------------
# The ranks (no JAX here)
# ---------------------------------------------------------------------------


def _run_plan(case):
    shape, cfg, transform, seed = case
    plan = tdfft.SlabFFTPlan(tdfft.GlobalSize(*shape), tdfft.SlabPartition(P),
                             cfg, transform=transform, device="cpu")
    hf.reset_launches()
    xl = plan.pad_input(_global_input(shape, transform, seed))
    c = plan.exec_r2c(xl) if transform == "r2c" else plan.exec_c2c(xl)
    back = plan.exec_c2r(c) if transform == "r2c" else plan.exec_c2c_inv(c)
    return {"local_in": xl.numpy(), "local_fwd": c.numpy(),
            "local_back": back.numpy(), "crop_fwd": plan.crop_spectral(c),
            "crop_back": plan.crop_real(back),
            "launches": sum(hf.LAUNCHES.values())}


def _run_tables(shape):
    plan = tdfft.SlabFFTPlan(tdfft.GlobalSize(*shape), tdfft.SlabPartition(P),
                             device="cpu")
    attrs = ("input_shape", "output_shape", "input_padded_shape",
             "output_padded_shape", "local_input_shape", "local_output_shape")
    out = {a: getattr(plan, a) for a in attrs}
    out.update(in_sizes=plan.in_sizes(), out_sizes=plan.out_sizes(),
               slices_in=multihost.process_local_slices(plan),
               slices_out=multihost.process_local_slices(plan, output=True),
               local_input=tuple(multihost.plan_local_input(plan, 3).shape),
               fft3d=plan.fft3d, rank=plan.rank,
               group_is_world=plan.group is None)
    return out


def _run_a2a(case):
    shape, split, concat, cplx = case
    rank = torch.distributed.get_rank()
    b = shape[0] // P if split == 1 else shape[1] // P
    x = torch.from_numpy(_a2a_input(shape, cplx))
    block = (x[rank * b:(rank + 1) * b] if split == 1
             else x[:, rank * b:(rank + 1) * b])
    return all_to_all_transpose(block.contiguous(), None, split, concat).numpy()


def _rank_main(rank, addr, cases, outdir):
    multihost.maybe_initialize(addr, P, rank, backend="gloo", timeout_s=120)
    results = {}
    for cid, (kind, case) in cases.items():
        try:
            run = {"plan": _run_plan, "tables": _run_tables,
                   "a2a": _run_a2a}[kind]
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


def _jax_config(backend, norm):
    import distributedfft_tpu as jdfft
    return jdfft.Config(fft_backend=backend, norm=jdfft.FFTNorm[norm])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases = {}
    for i, (cid, (shape, be, norm, tr)) in enumerate(PLAN_CASES.items()):
        cfg = tdfft.config_from_reference(
            dataclasses.asdict(_jax_config(be, norm)))
        cases[cid] = ("plan", (shape, cfg, tr, 100 + i))
    cases["tables"] = ("tables", TABLE_SHAPE)
    cases.update({cid: ("a2a", c) for cid, c in A2A_CASES.items()})
    outdir = tmp_path_factory.mktemp("slab_dist")
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


@pytest.mark.parametrize("cid", list(PLAN_CASES))
def test_plan_matches_reference(world, devices, cid):
    import distributedfft_tpu as jdfft
    shape, be, norm, tr = PLAN_CASES[cid]
    seed = 100 + list(PLAN_CASES).index(cid)
    jplan = jdfft.SlabFFTPlan(jdfft.GlobalSize(*shape), jdfft.SlabPartition(P),
                              _jax_config(be, norm), mesh=_mesh(devices),
                              transform=tr)
    x = _global_input(shape, tr, seed)
    jx = jplan.pad_input(x)
    jc = jplan.exec_r2c(jx) if tr == "r2c" else jplan.exec_c2c(jx)
    jb = jplan.exec_c2r(jc) if tr == "r2c" else jplan.exec_c2c_inv(jc)
    jc_np, jb_np, jx_np = np.asarray(jc), np.asarray(jb), np.asarray(jx)
    tol = TOL[be]
    by = jc_np.shape[1] // P
    bx = jx_np.shape[0] // P
    for r in range(P):
        res = _result(world, r, cid)
        assert res["launches"] == 0  # CPU tensors: plain versions only
        assert np.array_equal(res["local_in"], jx_np[r * bx:(r + 1) * bx])
        fwd = jc_np[:, r * by:(r + 1) * by]
        assert res["local_fwd"].shape == fwd.shape
        assert _rel(res["local_fwd"], fwd) <= tol, (r, "forward")
        back = jb_np[r * bx:(r + 1) * bx]
        assert res["local_back"].shape == back.shape
        assert _rel(res["local_back"], back) <= tol, (r, "roundtrip")
    res = _result(world, 0, cid)
    crop = jplan.crop_spectral(jc)
    assert res["crop_fwd"].shape == crop.shape == jplan.output_shape
    assert _rel(res["crop_fwd"], crop) <= tol
    assert _rel(res["crop_back"], jplan.crop_real(jb)) <= tol


def test_size_tables_match_reference(world, devices):
    import distributedfft_tpu as jdfft
    from distributedfft_tpu.parallel import multihost as jmh
    jplan = jdfft.SlabFFTPlan(jdfft.GlobalSize(*TABLE_SHAPE),
                              jdfft.SlabPartition(P), jdfft.Config(),
                              mesh=_mesh(devices))
    jin = jmh.process_local_slices(jplan.input_sharding,
                                   jplan.input_padded_shape)
    jout = jmh.process_local_slices(jplan.output_sharding,
                                    jplan.output_padded_shape)
    for r in range(P):
        res = _result(world, r, "tables")
        assert res["rank"] == r and not res["fft3d"]
        # The world group is held as None, not as its object: a plan still
        # holding that object at interpreter exit can abort a gloo rank.
        assert res["group_is_world"]
        for a in ("input_shape", "output_shape", "input_padded_shape",
                  "output_padded_shape"):
            assert res[a] == getattr(jplan, a), a
        assert res["in_sizes"] == jplan.in_sizes() == [6, 6, 6, 4]
        assert res["out_sizes"] == jplan.out_sizes() == [3, 3, 3, 1]
        assert res["slices_in"] == [jin[r]] and res["slices_out"] == [jout[r]]
        assert res["local_input"] == res["local_input_shape"] == (6, 10, 16)
        assert res["local_output_shape"] == (22, 3, 9)


@pytest.mark.parametrize("cid", list(A2A_CASES))
def test_all_to_all_transpose_matches_lax_tiled(world, devices, cid):
    """Bit for bit the layout of ``lax.all_to_all(..., tiled=True)`` (the
    JAX package's ``all_to_all_transpose`` inside ``shard_map``)."""
    import jax
    from jax.sharding import PartitionSpec as PS
    from distributedfft_tpu.parallel.transpose import \
        all_to_all_transpose as jax_a2a
    shape, split, concat, cplx = A2A_CASES[cid]
    spec_in = PS("p") if split == 1 else PS(None, "p")
    spec_out = PS(None, "p") if split == 1 else PS("p")
    fn = jax.shard_map(lambda xl: jax_a2a(xl, "p", split, concat),
                       mesh=_mesh(devices), in_specs=spec_in,
                       out_specs=spec_out)
    ref = np.asarray(fn(_a2a_input(shape, cplx)))
    b = ref.shape[split] // P
    for r in range(P):
        got = _result(world, r, cid)
        want = ref[:, r * b:(r + 1) * b] if split == 1 else ref[r * b:(r + 1) * b]
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_ranks_import_no_jax(world):
    assert all(w["modules"] == [] for w in world), [w["modules"] for w in world]
