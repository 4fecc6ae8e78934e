"""The kernels and C entry points a rank of the two-rank slab plan
launches, on the CPU: the all-to-all, every ring rendering and every
other exchange rendering that ``chip_smoke.py`` runs on the card, each
direction counted from zero and held against the counts and entry points
``chip_smoke.py`` expects (``A2A_ENTRIES``, ``RING_PATHS``,
``EXCHANGE_PATHS``), so that those expectations are checked before the
card runs them.

The wrappers' checks and ``_launch`` are patched so that every wrapper
takes its CUDA route on CPU tensors and each launch is only counted: the
plan runs its dispatch, its exchange over gloo and its ring hooks, and no
kernel. The cube is 32³ (every axis a power of two the engine takes, as
at 512³), P = 2, spawned once for the module.
"""

import importlib.util
import os
import pathlib
import pickle
import traceback

import pytest
import torch

import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch.ops import hopper_fft as hf
from distributedfft_tpu_torch.parallel import multihost

P, N = 2, 32
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _smoke()
PATHS = {"all_to_all": ({}, "ZY_Then_X", dict(rmatmul=1, cmatmul=2),
                        dict(cmatmul=2, c2r=1), *SMOKE.A2A_ENTRIES),
         **SMOKE.RING_PATHS, **SMOKE.EXCHANGE_PATHS}


def _counted(plan, x):
    """Forward then inverse of plan, each counted from zero: (launches,
    entry points) per direction."""
    out = []
    for run in (plan.exec_r2c, plan.exec_c2r):
        hf.reset_launches()
        seen = {}
        hf._launch = lambda kernel, fn, *args: (
            hf.LAUNCHES.__setitem__(kernel, hf.LAUNCHES[kernel] + 1),
            seen.__setitem__(fn, seen.get(fn, 0) + 1))
        x = run(x)
        out.append((dict(hf.LAUNCHES), seen))
    return out


def _rank_main(rank, addr, outdir):
    multihost.maybe_initialize(addr, P, rank, backend="gloo", timeout_s=120)
    for name in ("_check_rows", "_check_cols", "_check_wire"):
        setattr(hf, name, lambda *a: False)
    hf._check = lambda *a, **k: False
    results = {}
    for pid, (fields, seq, *_) in PATHS.items():
        try:
            kw = dict(fields, fft_backend="pallas")
            if "send_method" in fields:
                kw["send_method"] = tdfft.SendMethod(fields["send_method"])
            if "comm_method" in fields:
                kw["comm_method"] = tdfft.CommMethod(fields["comm_method"])
            plan = tdfft.SlabFFTPlan(tdfft.GlobalSize(N, N, N),
                                     tdfft.SlabPartition(P),
                                     tdfft.Config(**kw), sequence=seq,
                                     device="cpu")
            results[pid] = _counted(plan, plan.pad_input(torch.zeros(N, N, N)))
        except Exception:  # noqa: BLE001 — reported by that path's test
            results[pid] = {"error": traceback.format_exc()}
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    multihost.shutdown()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("rank_entries")
    torch.multiprocessing.start_processes(
        _rank_main, args=(multihost.local_coordinator(), str(outdir)),
        nprocs=P, start_method="spawn")
    out = []
    for r in range(P):
        with open(outdir / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.mark.parametrize("pid", list(PATHS))
def test_rank_launches_what_chip_smoke_expects(world, pid):
    """Every rank launches each kernel, through each C entry point, as
    many times per direction as ``chip_smoke.py`` requires of rank 0 on
    the card."""
    _, _, want_f, want_i, ent_f, ent_i = PATHS[pid]
    for rank in range(P):
        res = world[rank][pid]
        if isinstance(res, dict):
            pytest.fail(f"rank {rank} failed {pid}:\n{res['error']}")
        (fwd, got_f), (inv, got_i) = res
        assert fwd == SMOKE.expect(hf, **want_f), (rank, fwd)
        assert inv == SMOKE.expect(hf, **want_i), (rank, inv)
        assert (got_f, got_i) == (ent_f, ent_i), (rank, got_f, got_i)

