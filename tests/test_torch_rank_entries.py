"""The kernels and C entry points a rank of the two-rank slab and
batched-2D plans launches, on the CPU: the all-to-all, every ring
rendering and every other exchange rendering that ``chip_smoke.py`` runs
on the card, each direction counted from zero and held against the counts
and entry points ``chip_smoke.py`` expects (``A2A_ENTRIES``,
``RING_PATHS``, ``EXCHANGE_PATHS``; ``BATCHED_RENDERINGS``, and
``BATCHED_SPLIT`` for both shards at 4096-point images), so that those
expectations are checked before the card runs them; and the single-card
batched stacks of ``BATCHED_CARD`` at full size, whole and chunked.

The wrappers' checks and ``_launch`` are patched so that every wrapper
takes its CUDA route on CPU tensors and each launch is only counted: the
plan runs its dispatch, its exchange over gloo and its ring hooks, and no
kernel. The slab cube is 32³ (every axis a power of two the engine takes,
as at 512³) and the batched renderings' images 32²; P = 2, spawned once
for the module. The single-card stacks run on "meta" tensors, which
allocate nothing.
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
# The batched plan's paths on two ranks: id -> (shape, shard, Config
# fields, launches forward, inverse, entry points forward, inverse).
BATCHED = {f"batched-{pid}": ((4, 32, 32), "x", fields, *rest)
           for pid, (fields, *rest) in SMOKE.BATCHED_RENDERINGS.items()}
# shard="x" at the card's 4096^2 images: each rank's FFT stages on "meta"
# tensors (a CPU tensor takes the plain versions, whose routing differs
# past 1024 points), the exchange left out.
BATCHED.update({
    f"batched-x-{c}": (SMOKE.BATCHED_X, "x", {"comm_method": c},
                       *SMOKE.BATCHED_SPLIT) for c in SMOKE.BATCHED_X_COMMS})
PATCHED = ("_check_rows", "_check_cols", "_check_wire", "_check_short",
           "_check_tw_cols", "_check")


def _counted(plan, x):
    """Forward then inverse of plan, each counted from zero: (launches,
    entry points) per direction."""
    out = []
    for run in SMOKE.directions(plan):
        hf.reset_launches()
        seen = {}
        hf._launch = lambda kernel, fn, *args: (
            hf.LAUNCHES.__setitem__(kernel, hf.LAUNCHES[kernel] + 1),
            seen.__setitem__(fn, seen.get(fn, 0) + 1))
        x = run(x)
        out.append((dict(hf.LAUNCHES), seen))
    return out


def _counted_stages(plan):
    """(launches, entry points) per direction of a shard="x" plan's FFT
    stages, run on "meta" tensors of the rank's block shapes."""
    out = []
    shapes = (plan.local_input_shape, plan.local_output_shape)
    for forward, shape in ((True, shapes[0]), (False, shapes[1])):
        first, _, last = plan._slab_parts(forward)
        hf.reset_launches()
        seen = {}
        hf._launch = lambda kernel, fn, *args: (
            hf.LAUNCHES.__setitem__(kernel, hf.LAUNCHES[kernel] + 1),
            seen.__setitem__(fn, seen.get(fn, 0) + 1))
        dtype = torch.float32 if forward else torch.complex64
        a = first(torch.zeros(shape, dtype=dtype, device="meta"))
        # The exchange's result: x gathered and spectral y split (forward),
        # or back (inverse).
        b = ((plan.batch, plan._nx_pad, a.shape[2] // P) if forward
             else (plan.batch, a.shape[1] // P, plan._nys_pad))
        last(torch.zeros(b, dtype=torch.complex64, device="meta"))
        out.append((dict(hf.LAUNCHES), seen))
    return out


def _rank_main(rank, addr, outdir):
    multihost.maybe_initialize(addr, P, rank, backend="gloo", timeout_s=120)
    for name in PATCHED:
        setattr(hf, name, lambda *a, **k: False)
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
    for pid, (shape, shard, fields, *_) in BATCHED.items():
        try:
            plan = tdfft.Batched2DFFTPlan(
                *shape, tdfft.SlabPartition(P),
                SMOKE.pencil_config(tdfft, fields), shard=shard,
                device="cpu")
            results[pid] = (_counted_stages(plan) if shape[1] > 1024 else
                            _counted(plan, plan.pad_input(torch.zeros(shape))))
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



@pytest.mark.parametrize("pid", list(BATCHED))
def test_batched_rank_launches_what_chip_smoke_expects(world, pid):
    """The batched plan's renderings at 32^2 images and its 4096^2 shards:
    every rank's launches and entry points as ``chip_smoke.py`` requires."""
    _, _, _, want_f, want_i, ent_f, ent_i = BATCHED[pid]
    for rank in range(P):
        res = world[rank][pid]
        if isinstance(res, dict):
            pytest.fail(f"rank {rank} failed {pid}:\n{res['error']}")
        (fwd, got_f), (inv, got_i) = res
        assert fwd == SMOKE.expect(hf, **want_f), (rank, fwd)
        assert inv == SMOKE.expect(hf, **want_i), (rank, inv)
        assert (got_f, got_i) == (ent_f, ent_i), (rank, got_f, got_i)


@pytest.mark.parametrize("pid", list(SMOKE.BATCHED_CARD))
def test_batched_stacks_launch_what_chip_smoke_expects(monkeypatch, pid):
    """``chip_smoke.py``'s single-card batched stacks at their full size on
    "meta" tensors: one call's launches and entry points a direction,
    times the calls of each ``batch_chunk``."""
    shape, (want_f, want_i, ent_f, ent_i), chunks = SMOKE.BATCHED_CARD[pid]
    log = []
    for name in PATCHED:
        monkeypatch.setattr(hf, name, lambda *a, **k: False)
    monkeypatch.setattr(hf, "_launch", lambda kernel, fn, *args:
                        log.append((kernel, fn)))

    def counted():
        kernels, entries = {}, {}
        for k, e in log:
            kernels[k] = kernels.get(k, 0) + 1
            entries[e] = entries.get(e, 0) + 1
        del log[:]
        return kernels, entries

    for ck in (None,) + tuple(chunks):
        calls = shape[0] // (ck or shape[0])
        plan = tdfft.Batched2DFFTPlan(*shape, tdfft.SlabPartition(1),
                                      tdfft.Config(fft_backend="pallas"),
                                      batch_chunk=ck, device="cpu")
        c = plan._build(True)(torch.zeros(shape, device="meta"))
        assert c.shape == shape[:2] + (shape[2] // 2 + 1,)
        assert c.dtype == torch.complex64
        assert counted() == (SMOKE.scaled(want_f, calls, {}, 0),
                             SMOKE.scaled(ent_f, calls, {}, 0))
        back = plan._build(False)(c)
        assert back.shape == shape and back.dtype == torch.float32
        assert counted() == (SMOKE.scaled({}, 0, want_i, calls),
                             SMOKE.scaled({}, 0, ent_i, calls))
