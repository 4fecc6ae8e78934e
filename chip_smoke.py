#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
It builds the port's CUDA kernels from the checkout (``csrc/*.cu``, all at
once, before any rank is spawned) and then, under
``Config(fft_backend="pallas")``:

1. holds each kernel against its plain PyTorch version at the main paths'
   shapes: the fused kernels 6-8 at 512^3 (kernel 7 on each layout pair
   the fused plan launches), the per-axis kernels 1-5 at the shapes of the
   512^3 two-rank plan (kernel 2's column body on a rank's y and x axes,
   its row body on the y blocks of the ``Z_Then_YX`` rings), of the
   1024^3 plan (kernels 1, 2 and 3 on 1024-point rows, kernel 2's column
   body on the y and x axes where they lie) and of the 2048 x 256 x 2048
   four-step (kernels 4 and 5 on rows, kernel 4's column body on its x
   axis where it lies, kernel 2's column body on its y axis and its
   short-stage body on the 4-point second stage of x and z, with each of
   its output geometries; the 4-point row body it replaced),
   the fused-wire kernels 9-11 at the per-rank shapes of a 1024^3 plan
   over four ranks (9 and 10 bit for bit, NaN and Inf included); kernels
   3, 4, 5, 6, 7, 8 and 11 also on their other body (dense or tile) at a
   shape whose axes are not powers of two;
2. runs a small cube against numpy, then the single-card slab plan at
   512^3 (fused kernels), at 1024^3 (per-axis kernels 1, 2 and 3, every
   axis one launch of the row FFT engine, y and x where they lie) and at
   2048 x 256 x 2048 (x and z split four-step, 4 x 512: kernels 4, 5 and
   2, x where it lies): ``exec_r2c`` then
   ``exec_c2r``, checked against ``torch.fft`` and the input, with the
   launch counts of every kernel and the entry point (the body) of every
   launch, each direction counted from zero;
3. runs the distributed slab plan at 512^3 as two ranks sharing the card
   over a gloo group (``torch.multiprocessing.spawn``; gloo stages the
   exchange through the host): the all-to-all, then the ring renderings
   (RING, RING_OVERLAP with the bf16 wire, without and with the fused wire
   of kernels 9-11, at depth 3 with two sub-blocks, and ``Z_Then_YX``),
   each rank checking its launches and their entry points per direction
   and each plan against
   ``torch.fft`` and against the plans it must equal;
4. times each kernel, its plain version and one PyTorch call of the same
   function, the plans under "pallas" and "xla", and the exchange of each
   rendering with its wire bytes; one run of each direction of the fused
   and per-axis plans under ``torch.profiler`` names the device time op by
   op and gives the device's idle share. A per-axis plan fails if the ops
   of its dispatch (copies, transposes: every aten op with device time)
   take more than its limit in either direction: ``COPY_LIMIT_MS`` at
   1024^3, and at 2048 x 256 x 2048 the limits ``split_copy_limits``
   computes from the bytes of the copies that remain;
5. runs the port's executables in this process, as a user would call them
   (``cli.slab.main`` / ``cli.reference.main``): the slab executable's
   testcases 0-4 at 1024^3 (the per-axis kernels) and testcases 0 and 4 at
   512^3 (the fused kernels) under "pallas" and "xla", testcase 1 with the
   host's float64 truth at 128^3, the reference executable's testcase 0 at
   512^3; then, as two spawned ranks over gloo, the slab executable at
   512^3 over both exchanges (Peer2Peer and All2All, testcases 3 and 0),
   the renderings' bit equality and the reference executable's bandwidth
   probe. Each run's launches and entry points are counted from zero and
   held against the plan phases'; testcases 1 and 3 hold within TOL of
   their reference magnitude, testcase 4 too or, where float32 cannot,
   within twice cuFFT's error (``gate_cli_results``); every phase CSV
   parses with the port's reader, and its means stand beside
   ``plan_time``'s.

Phases print JSON lines. Before the last line come one ``{"kernels": ...}``
line and the card's name and power limit as ``nvidia-smi`` gives them; the
last line is ``{"ok": true, "device": {...}}``. Any failed phase raises, so
the script exits non-zero with no result line; so does a machine without a
CUDA device, or a directory without the port. Takes about 170-190 s on
an H100, the kernels' build (25-55 s) and the executables' phase (about
50 s, most of it the host's random draws at 1024^3) included.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 20261016
N = 512            # the fused single-card cube and the two-rank cube
NBIG = 1024        # the per-axis single-card cube (one launch an axis)
SPLIT = (2048, 256, 2048)  # per-axis, x and z split four-step (4 x 512)
RANKS = 2
TOL = 5e-4         # max relative error, the JAX package's per-stage bound
WIRE16_TOL = 2e-2  # the bf16 wire's documented bound (DEFAULT_WIRE_ERROR_BUDGET)
SMALL = (6, 12, 15)
REPS = 10
WARMUP = 2
REPS_BIG = 3       # repetitions of a per-axis plan direction (~0.1 s each)
COPY_LIMIT_MS = 1.0  # the 1024^3 plan's dispatch ops, a direction
COPY_RATE = 0.55     # share of the HBM rate the dispatch's copies reach
COPY_MARGIN = 1.2    # on top of the copies' time at COPY_RATE
# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3 rate.
FP32_FLOPS = 67e12
HBM_BYTES = 3.35e12
PALLAS = "distributedfft_tpu/ops/pallas_fft.py"


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def rel_err(got, ref):
    """(max abs error, max abs error relative to max |ref|)."""
    abs_err = float((got - ref).abs().max())
    return abs_err, abs_err / max(float(ref.abs().max()), 1e-30)


def median_ms(torch, fn, reps: int = REPS, warmup: int = WARMUP) -> float:
    """Median over ``reps`` runs of fn's device time (CUDA events), after
    ``warmup`` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def fft_flops(rows: int, n: int, real: bool = False) -> float:
    """The function's work: the FFT's nominal 5 n log2 n flop per complex
    row of n points, 2.5 n log2 n with real input or output (PERF.md §2's
    GFLOP/s metric)."""
    return (2.5 if real else 5.0) * rows * n * math.log2(n)


def bound(flops: float, nbytes: float):
    """(bound ms, what bounds it) on the data sheet's peaks."""
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


# Kernels whose body is a pure function of their shape: the row FFT engine
# or the dense tile loop (hopper_fft._fft_body of the row length; for
# kernels 2 and 3 on rows of at most 16 points the row path of stage.cu's
# launch; kernels 2 and 4 on columns, shape (outer, n, inner), the column
# kernel, "cols", or for kernel 2 on 2..16 points the short-stage kernel,
# "short"), or, for kernels 6, 7 and 8, the engine or the dense kernel
# (hopper_fft._zy_body, hopper_fft._x_body).
ROUTED = ("rmatmul", "cmatmul", "c2r", "rmatmul_tw", "dec_cmatmul",
          "cmatmul_tw", "zy_fwd", "x_c2c", "yz_inv")


def split_copy_limits(shape):
    """(forward, inverse) limits, in ms, of the device time of the aten ops
    of a single-card per-axis plan whose x and z axes split, set from the
    bytes of the copies its dispatch still makes, at ``COPY_RATE`` of the
    HBM rate, plus ``COPY_MARGIN``. Forward: the swap of the real z input
    (4 bytes a point read and written). Inverse: the z axis's Hermitian
    extension (the flip of the n/2 - 1 conjugated bins, read and written;
    the cat of the half spectrum and that tail, read, and the full
    spectrum written), the four-step's swap of the full spectrum (read and
    written) and its real part (8 bytes a point read, 4 written). The x
    axis copies nothing: its four-step runs where it lies."""
    X, Y, Z = shape
    rows = X * Y
    half, tail = Z // 2 + 1, (Z + 1) // 2 - 1
    fwd = 2 * 4 * rows * Z
    inv = (2 * 8 * rows * tail + 8 * rows * (half + tail) + 8 * rows * Z
           + 2 * 8 * rows * Z + 12 * rows * Z)
    return tuple(1e3 * b / (COPY_RATE * HBM_BYTES) * COPY_MARGIN
                 for b in (fwd, inv))


def body_of(hf, k) -> str:
    """The body a kernel row runs: for the routed kernels 1-8 and 11 the
    body of its shape, which must be the row's ``body`` ("fft" unless the
    row names another), else the one body the kernel has."""
    if k["name"] in ROUTED:
        sh = k["shape"]
        if k["name"] in ("zy_fwd", "yz_inv"):
            body = hf._zy_body(sh["Y"], sh["Z"])
        elif k["name"] == "x_c2c":
            body = hf._x_body(sh["X"])
        elif "inner" in sh:
            body = ("cols" if hf._fft_body(sh["n"]) == "fft" else
                    "short" if hf._short_body(sh["n"]) else "none")
        else:
            body = hf._fft_body(sh["n"])
            if body == "tile" and k["name"] in ("cmatmul", "c2r") \
                    and sh["n"] <= 16:
                body = "row"
        if body != k.get("body", "fft"):
            fail(f"kernel {k['name']} {k['shape']} routes to the {body} body")
        return body
    if k["name"] in ("enc_pack", "dec_unpack"):
        return "elementwise"
    return "dense"


def expect(hf, **counts):
    """The full launch-count dict with the given kernels, zero elsewhere."""
    return {k: counts.get(k, 0) for k in hf.LAUNCHES}


@contextlib.contextmanager
def kernel_events(torch, hf):
    """Record a CUDA event pair around every kernel launch; yields a list
    of (kernel name, C entry point, start, end), the name being the counter
    the wrapper passes to ``_launch``. Measurement only: the port is
    unchanged and the counts still rise in ``_launch``."""
    orig, log = hf._launch, []

    def launch(kernel, fn, *args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        orig(kernel, fn, *args)
        end.record()
        log.append((kernel, fn, start, end))

    hf._launch = launch
    try:
        yield log
    finally:
        hf._launch = orig


@contextlib.contextmanager
def entry_counts(hf):
    """Count the launches of each C entry point (so the body each kernel
    ran) while the block runs; yields the dict. Measurement only: the
    counts in ``LAUNCHES`` still rise in ``_launch``."""
    orig, seen = hf._launch, {}

    def launch(kernel, fn, *args):
        orig(kernel, fn, *args)
        seen[fn] = seen.get(fn, 0) + 1

    hf._launch = launch
    try:
        yield seen
    finally:
        hf._launch = orig


def run_counted(torch, hf, plan, x):
    """One forward and one inverse of ``plan``, each counted from zero:
    (spectrum, inverse, launches forward, launches inverse, entry points
    forward, entry points inverse)."""
    hf.reset_launches()
    with entry_counts(hf) as ent_f:
        c = plan.exec_r2c(x)
        torch.cuda.synchronize()
    fwd = dict(hf.LAUNCHES)
    hf.reset_launches()
    with entry_counts(hf) as ent_i:
        back = plan.exec_c2r(c)
        torch.cuda.synchronize()
    return c, back, fwd, dict(hf.LAUNCHES), ent_f, ent_i


def kernel_share(torch, hf, fn, by_entry=False):
    """Run fn once with kernel events: (total ms, {kernel: ms summed}), or
    {C entry point: ms summed} with ``by_entry``."""
    torch.cuda.synchronize()
    with kernel_events(torch, hf) as log:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
    per = {}
    for name, entry, s, e in log:
        key = entry if by_entry else name
        per[key] = per.get(key, 0.0) + s.elapsed_time(e)
    return start.elapsed_time(end), per


def entry_ms(torch, hf, fn, reps: int = REPS):
    """Median over ``reps`` runs of fn of each C entry point's device ms
    (the passes of a kernel with more than one launch), after one run."""
    fn()
    runs = [kernel_share(torch, hf, fn, by_entry=True)[1] for _ in range(reps)]
    return {e: statistics.median(r[e] for r in runs) for e in runs[0]}


def device_profile(torch, fn, top: int = 8):
    """One run of fn under ``torch.profiler``: the device ms of the largest
    kernels and of each aten op that launched kernels (the copies of the
    dispatch; the port's kernels launch outside aten), their sum
    ("aten_ms"), the kernels' summed ms ("busy") and the device's idle share of the run's CUDA-event
    window (the profiler's own overhead inside it). One run before the
    kept one warms the tracer up, and the kept one starts 2 ms after the
    step that opens it; its events are read as its cycle ends. Where the
    trace holds no device time: "not measured". Measurement only."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    torch.cuda.synchronize()
    kept = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: kept.append(p.key_averages())
                 ) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(0.002)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        prof.step()
    window = start.elapsed_time(end)
    kernels, ops = {}, {}
    for e in (kept[-1] if kept else []):
        ms = e.self_device_time_total / 1e3
        if e.key.startswith("ProfilerStep"):   # the step's own span
            continue
        if ms > 0 and e.device_type == DeviceType.CUDA:
            name = e.key[:90]          # kernels whose names share it add up
            kernels[name] = kernels.get(name, 0.0) + ms
        elif ms > 0 and e.key.startswith("aten::"):
            ops[e.key] = ms
    busy = sum(kernels.values())
    largest = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:top])
    return {"window_ms": window, "busy_ms": busy if busy else "not measured",
            "idle_share": 1 - busy / window if busy else "not measured",
            "aten_ops_ms": ops, "aten_ms": sum(ops.values()),
            "kernels_ms": largest}


# ---------------------------------------------------------------------------
# The two ranks of the distributed phase (spawned; they import the port only)
# ---------------------------------------------------------------------------


def rank_main(rank: int, addr: str, outdir: str) -> None:
    import torch
    import torch.distributed as dist
    import distributedfft_tpu_torch as dft
    from distributedfft_tpu_torch.ops import hopper_fft as hf
    from distributedfft_tpu_torch.parallel import multihost

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    multihost.maybe_initialize(addr, RANKS, rank, backend="gloo",
                               timeout_s=300)
    dev = torch.device("cuda")
    plan = dft.SlabFFTPlan(dft.GlobalSize(N, N, N), dft.SlabPartition(RANKS),
                           dft.Config(fft_backend="pallas"))
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    x = torch.randn((N, N, N), generator=gen, device=dev)
    xl = plan.pad_input(x)

    c, back, fwd, inv, ent_f, ent_i = run_counted(torch, hf, plan, xl)
    if fwd != expect(hf, rmatmul=1, cmatmul=2) or \
            inv != expect(hf, cmatmul=2, c2r=1) or \
            (ent_f, ent_i) != A2A_ENTRIES:
        fail(f"rank {rank}: the two-rank plan did not launch the per-axis "
             f"kernels as expected: forward {fwd} (entries {ent_f}), "
             f"inverse {inv} (entries {ent_i})")
    ref = torch.fft.rfftn(x)
    _, local_rel = rel_err(c, ref[plan.local_slices(output=True)])
    _, local_rt = rel_err(back / float(N ** 3), xl)
    if not (local_rel <= TOL and local_rt <= TOL):
        fail(f"rank {rank}: local block wrong: forward rel {local_rel:.3e}, "
             f"roundtrip rel {local_rt:.3e}")
    full = torch.from_numpy(plan.crop_spectral(c))       # gathered, host
    rt = torch.from_numpy(plan.crop_real(back))
    out = {"rank": rank, "launches_forward": fwd, "launches_inverse": inv,
           "entries_forward": ent_f, "entries_inverse": ent_i,
           "local_forward_rel": local_rel, "local_roundtrip_rel": local_rt,
           "local_input_shape": list(plan.local_input_shape),
           "local_output_shape": list(plan.local_output_shape)}
    if rank == 0:
        _, out["forward_vs_torch_fft"] = rel_err(full, ref.cpu())
        _, out["roundtrip_vs_input"] = rel_err(rt / float(N ** 3), x.cpu())
        if not (out["forward_vs_torch_fft"] <= TOL
                and out["roundtrip_vs_input"] <= TOL):
            fail(f"two-rank plan wrong: {out}")
    del full, rt, ref

    def wall_ms(fn, reps=5):
        """Median host wall time of fn on both ranks at once: both start
        after a barrier, each ends on its own synchronize."""
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times)

    first, xpose, _ = plan._fwd_parts()
    ifirst, ixpose, _ = plan._inv_parts()
    a, b = first(xl), ifirst(c)
    out.update(forward_ms=wall_ms(lambda: plan.exec_r2c(xl)),
               inverse_ms=wall_ms(lambda: plan.exec_c2r(c)),
               exchange_forward_ms=wall_ms(lambda: xpose(a)),
               exchange_inverse_ms=wall_ms(lambda: ixpose(b)),
               exchange_bytes=a.numel() * a.element_size())
    # This rank's kernel time inside one run of each direction (CUDA events
    # around each launch; the other rank's work shares the card meanwhile).
    for name, fn in (("forward", lambda: plan.exec_r2c(xl)),
                     ("inverse", lambda: plan.exec_c2r(c))):
        _, per = kernel_share(torch, hf, fn)
        out[f"{name}_kernel_ms"] = per
        out[f"{name}_kernel_total_ms"] = sum(per.values())
    out["ring"] = ring_paths(rank, x, xl, c, back, wall_ms)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    multihost.shutdown()


# The entry points of a rank's per-axis launches, forward and inverse: z on
# rows, y (after the z-R2C) and x (after the exchange) on kernel 2's column
# body in place.
A2A_ENTRIES = ({"dfft_rdft": 1, "dfft_cdft_cols": 2},
               {"dfft_cdft_cols": 2, "dfft_c2r": 1})


def _plus(entries, **more):
    return tuple({**e, **{f"dfft_{k}": v for k, v in more.items()}}
                 for e in entries)


# The ring renderings of the two-rank phase: id -> (Config fields,
# sequence, launches forward, launches inverse, entry points forward and
# inverse). Two ranks make one ring step, so each direction sends one
# block (two with two sub-blocks). Z_Then_YX runs y on the row body on the
# rank's own block, on the fused wire's decode (kernel 11) on the one it
# receives, and the inverse's y on the column body after the exchange.
_RO = {"send_method": "RingOverlap", "wire_dtype": "bf16"}
RING_PATHS = {
    "ring_native": ({"send_method": "Ring"}, "ZY_Then_X",
                    dict(rmatmul=1, cmatmul=2), dict(cmatmul=2, c2r=1),
                    *A2A_ENTRIES),
    "ring_overlap_wire16": (_RO, "ZY_Then_X",
                            dict(rmatmul=1, cmatmul=2), dict(cmatmul=2, c2r=1),
                            *A2A_ENTRIES),
    "ring_overlap_wire16_fused": (
        {**_RO, "fused_wire": True}, "ZY_Then_X",
        dict(rmatmul=1, cmatmul=2, enc_pack=1, dec_unpack=1),
        dict(cmatmul=2, enc_pack=1, dec_unpack=1, c2r=1),
        *_plus(A2A_ENTRIES, enc_pack=1, dec_unpack=1)),
    "ring_overlap_wire16_fused_d3_s2": (
        {**_RO, "fused_wire": True, "overlap_depth": 3,
         "overlap_subblocks": 2}, "ZY_Then_X",
        dict(rmatmul=1, cmatmul=2, enc_pack=2, dec_unpack=2),
        dict(cmatmul=2, enc_pack=2, dec_unpack=2, c2r=1),
        *_plus(A2A_ENTRIES, enc_pack=2, dec_unpack=2)),
    "z_then_yx_ring_overlap_wire16": (
        _RO, "Z_Then_YX", dict(rmatmul=1, cmatmul=3), dict(cmatmul=2, c2r=1),
        *_plus(A2A_ENTRIES[:1], cdft=1) + A2A_ENTRIES[1:]),
    "z_then_yx_ring_overlap_wire16_fused": (
        {**_RO, "fused_wire": True}, "Z_Then_YX",
        dict(rmatmul=1, cmatmul=2, enc_pack=1, dec_cmatmul=1),
        dict(cmatmul=2, enc_pack=1, dec_unpack=1, c2r=1),
        {"dfft_rdft": 1, "dfft_enc_pack": 1, "dfft_cdft": 1,
         "dfft_dec_fft": 1, "dfft_cdft_cols": 1},
        *_plus(A2A_ENTRIES[1:], enc_pack=1, dec_unpack=1)),
}
# The exchange of these is timed beside the all-to-all's.
EXCHANGE_TIMED = ("ring_native", "ring_overlap_wire16",
                  "ring_overlap_wire16_fused")


def ring_paths(rank, x, xl, a2a_fwd, a2a_back, wall_ms):
    """Run every ring rendering of RING_PATHS on this rank (the same input
    as the all-to-all plan): launch counts per direction, checks against
    torch.fft, the bit-equalities the renderings promise, and times."""
    import torch
    import distributedfft_tpu_torch as dft
    from distributedfft_tpu_torch.ops import hopper_fft as hf
    from distributedfft_tpu_torch.parallel import transpose as tr

    out = {"transport": "gloo, staged through pinned host memory"
           if tr._Transport(None, x.device).staged else "device memory"}
    ref = torch.fft.rfftn(x)
    res = {}
    for pid, (fields, seq, want_f, want_i, ent_f_want,
              ent_i_want) in RING_PATHS.items():
        kw = dict(fields, send_method=dft.SendMethod(fields["send_method"]),
                  fft_backend="pallas")
        plan = dft.SlabFFTPlan(dft.GlobalSize(N, N, N),
                               dft.SlabPartition(RANKS), dft.Config(**kw),
                               sequence=seq)
        c, back, fwd, inv, ent_f, ent_i = run_counted(torch, hf, plan, xl)
        if fwd != expect(hf, **want_f) or inv != expect(hf, **want_i) or \
                ent_f != ent_f_want or ent_i != ent_i_want:
            fail(f"rank {rank} {pid}: launches forward {fwd} (entries "
                 f"{ent_f}), inverse {inv} (entries {ent_i}); expected "
                 f"{want_f} ({ent_f_want}), {want_i} ({ent_i_want})")
        tol = WIRE16_TOL if plan.config.wire_dtype == "bf16" else TOL
        _, f_rel = rel_err(c, plan.pad_spectral(ref))   # pad lanes are 0
        _, rt_rel = rel_err(back / float(N ** 3), xl)
        if not (f_rel <= tol and rt_rel <= tol):
            fail(f"rank {rank} {pid}: forward rel {f_rel:.3e}, roundtrip rel "
                 f"{rt_rel:.3e} (tol {tol})")
        row = {"sequence": seq, "launches_forward": fwd,
               "launches_inverse": inv, "entries_forward": ent_f,
               "entries_inverse": ent_i, "forward_vs_torch_fft": f_rel,
               "roundtrip_vs_input": rt_rel, "tol": tol,
               "forward_ms": wall_ms(lambda: plan.exec_r2c(xl)),
               "inverse_ms": wall_ms(lambda: plan.exec_c2r(c))}
        if pid in EXCHANGE_TIMED:
            first, xpose, _ = plan._fwd_parts()
            ifirst, ixpose, _ = plan._inv_parts()
            a, b = first(xl), ifirst(c)
            sched = {d: tr.ring_schedule(
                (t.shape[0] * RANKS,) + tuple(t.shape[1:]), t.dtype,
                plan.config.wire_dtype, RANKS,
                overlap=plan.config.send_method is dft.SendMethod.RING_OVERLAP,
                depth=plan.config.resolved_overlap_depth(),
                subblocks=plan.config.resolved_overlap_subblocks())
                for d, t in (("forward", a), ("inverse", b))}
            row.update(exchange_forward_ms=wall_ms(lambda: xpose(a)),
                       exchange_inverse_ms=wall_ms(lambda: ixpose(b)),
                       wire_bytes_per_rank={
                           d: v["total_wire_bytes"] // RANKS
                           for d, v in sched.items()},
                       schedule_forward=sched["forward"])
            del a, b
        res[pid] = (c, back)
        out[pid] = row
        del plan
    pairs = [("ring_native", None, "bit"),
             ("ring_overlap_wire16_fused", "ring_overlap_wire16", "bit"),
             ("ring_overlap_wire16_fused_d3_s2", "ring_overlap_wire16_fused",
              "bit"),
             ("z_then_yx_ring_overlap_wire16_fused",
              "z_then_yx_ring_overlap_wire16", TOL)]
    for pid, other, how in pairs:
        got = res[pid]
        want = (a2a_fwd, a2a_back) if other is None else res[other]
        if how == "bit":
            ok = all(torch.equal(g, w) for g, w in zip(got, want))
            out[f"{pid}_equals_{other or 'all_to_all'}"] = ok
        else:
            errs = [rel_err(g, w)[1] for g, w in zip(got, want)]
            out[f"{pid}_vs_{other}_rel"] = max(errs)
            ok = max(errs) <= how
        if not ok:
            fail(f"rank {rank}: {pid} does not match {other or 'all_to_all'}"
                 f" ({how})")
    return out


# ---------------------------------------------------------------------------
# The parent
# ---------------------------------------------------------------------------


def stage_cases(torch, hf, dev, gen):
    """Kernels 1-5 at the main paths' shapes: (entry, make inputs)."""
    def rr(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def cr(*shape):
        return torch.complex(rr(*shape), rr(*shape))

    def planes(kind, n, inverse=False):
        return hf._planes(kind, n, inverse, dev)

    def cols_case(variant, shape, axis):
        """Kernel 2's column body on axis ``axis`` of a contiguous complex
        tensor of ``shape``, as the plan holds it."""
        n = shape[axis]
        outer, inner = math.prod(shape[:axis]), math.prod(shape[axis + 1:])
        rows = outer * inner
        return dict(
            name="cmatmul", variant=variant, body="cols",
            replaces=f"{PALLAS}:164",
            shape=dict(outer=outer, n=n, inner=inner, axis=axis),
            make=lambda: dict(x=cr(*shape)),
            run=lambda t: hf.cdft_cols(t["x"], axis, False),
            plain=lambda t: hf.cdft_cols_plain(t["x"], axis, False),
            library=lambda t: torch.fft.fft(t["x"], dim=axis),
            library_call=f"fft(dim={axis}) of the same tensor",
            flops=fft_flops(rows, n), gemm_flops=8 * rows * n * n,
            bytes=16 * rows * n)

    def short_case(variant, shape, kind, inverse):
        """Kernel 2's short-stage body on (outer, n1, inner) columns with
        one of its output geometries: "last" (natural order), "crop"
        (bins 0..n/2) or "strided" (a non-last axis of n1 * outer points,
        outer index k2, stored in its (n, inner) layout)."""
        outer, n1, inner = shape
        if kind == "strided":
            geom = hf.short_strided(n1, outer, inner)
            out_shape = (n1 * outer, inner)
        else:
            n_out = n1 * inner // 2 + 1 if kind == "crop" else n1 * inner
            geom, out_shape = hf.short_last(n1, inner, n_out), (outer, n_out)
        cols = outer * inner
        return dict(
            name="cmatmul", variant=variant, body="short",
            replaces=f"{PALLAS}:164",
            shape=dict(outer=outer, n=n1, inner=inner, geometry=kind,
                       out=list(out_shape)),
            make=lambda: dict(x=cr(*shape)),
            run=lambda t: hf.cdft_short(t["x"], inverse, geom, out_shape),
            plain=lambda t: hf.cdft_short_plain(t["x"], inverse, geom,
                                                out_shape),
            library=lambda t: torch.fft.fft(t["x"], dim=1),
            library_call="fft(dim=1) of the same columns",
            flops=fft_flops(cols, n1), gemm_flops=8 * cols * n1 * n1,
            bytes=8 * cols * n1 + 8 * math.prod(out_shape))

    rows_r = (N // RANKS) * N                 # z-R2C rows of a rank's slab
    k_half = -(-(N // 2 + 1) // RANKS)        # a rank's padded z bins
    rows_zyx = (N // RANKS) * k_half          # Z_Then_YX rings' y rows
    big_c = NBIG * (NBIG // 2 + 1)            # 1024^3 y/x forward rows
    big_r = NBIG * NBIG                       # 1024^3 z rows (R2C, C2C inverse)
    sx, sy, sz = SPLIT
    big_tw = sy * (sz // 2 + 1) * 4           # SPLIT x forward first stage rows
    big_rtw = sx * sy * 4                     # SPLIT z forward first stage rows
    big_n1 = sy * (sz // 2 + 1) * 512         # SPLIT x forward 4-point stage rows
    x_inner = sy * (sz // 2 + 1)              # SPLIT x axis: points a column
    rows_640 = 640 * 640 * 2                  # 640^3 z first stage rows
    rows_640c = 640 * 321 * 2                 # 640^3 y/x first stage rows
    k_r = N // 2 + 1
    kb = NBIG // 2 + 1
    k480 = 480 // 2 + 1
    # Kernels 1, 2 and 3 take no F: rdft / cdft / irdft pick their body by
    # n (the FFT body at 512 and 1024, the row body at 4, the tile body at
    # 480). An FFT body's bytes count no DFT matrix.
    return [
        dict(name="rmatmul", replaces=f"{PALLAS}:182",
             shape=dict(M=rows_r, n=N, k=k_r),
             make=lambda: dict(x=rr(rows_r, N), F=planes("rdft", N)),
             run=lambda t: hf.rdft(t["x"]),
             plain=lambda t: hf.stage_plain(t["x"], *t["F"]),
             library=lambda t: torch.fft.rfft(t["x"]), library_call="rfft",
             flops=fft_flops(rows_r, N, real=True),
             gemm_flops=4 * rows_r * N * k_r,
             bytes=4 * rows_r * N + 8 * rows_r * k_r),
        dict(name="rmatmul", variant="fft_1024", replaces=f"{PALLAS}:182",
             shape=dict(M=big_r, n=NBIG, k=kb),
             make=lambda: dict(x=rr(big_r, NBIG), F=planes("rdft", NBIG)),
             run=lambda t: hf.rdft(t["x"]),
             plain=lambda t: hf.stage_plain(t["x"], *t["F"]),
             library=lambda t: torch.fft.rfft(t["x"]), library_call="rfft",
             flops=fft_flops(big_r, NBIG, real=True),
             gemm_flops=4 * big_r * NBIG * kb,
             bytes=4 * big_r * NBIG + 8 * big_r * kb),
        # Kernel 2's row body at 512 points: the y pass of the Z_Then_YX
        # rings, on a rank's (256, 129)-column block of rows.
        dict(name="cmatmul", replaces=f"{PALLAS}:164",
             shape=dict(M=rows_zyx, n=N, k=N),
             make=lambda: dict(x=cr(rows_zyx, N), F=planes("dft", N)),
             run=lambda t: hf.cdft(t["x"], False),
             plain=lambda t: hf.stage_plain(t["x"], *t["F"]),
             library=lambda t: torch.fft.fft(t["x"]), library_call="fft",
             flops=fft_flops(rows_zyx, N), gemm_flops=8 * rows_zyx * N * N,
             bytes=16 * rows_zyx * N),
        dict(name="cmatmul", variant="fft_1024", replaces=f"{PALLAS}:164",
             shape=dict(M=big_c, n=NBIG, k=NBIG),
             make=lambda: dict(x=cr(big_c, NBIG), F=planes("dft", NBIG)),
             run=lambda t: hf.cdft(t["x"], False),
             plain=lambda t: hf.stage_plain(t["x"], *t["F"]),
             library=lambda t: torch.fft.fft(t["x"]), library_call="fft",
             flops=fft_flops(big_c, NBIG), gemm_flops=8 * big_c * NBIG * NBIG,
             bytes=16 * big_c * NBIG),
        dict(name="cmatmul", variant="fft_1024_inverse_z",
             replaces=f"{PALLAS}:164", shape=dict(M=big_r, n=NBIG, k=NBIG),
             make=lambda: dict(x=cr(big_r, NBIG),
                               F=planes("dft", NBIG, True)),
             run=lambda t: hf.cdft(t["x"], True),
             plain=lambda t: hf.stage_plain(t["x"], *t["F"]),
             library=lambda t: torch.fft.ifft(t["x"], norm="forward"),
             library_call="ifft(norm='forward')",
             flops=fft_flops(big_r, NBIG), gemm_flops=8 * big_r * NBIG * NBIG,
             bytes=16 * big_r * NBIG),
        # Kernel 2's column body where the plans run it: the y axis of the
        # 1024^3 spectrum (rows of 513 elements, every other one 8 bytes
        # off a 16-byte boundary, a one-column last group) and its x axis;
        # a rank's y axis of the two-rank plan after its z-R2C and its x
        # axis after the exchange; the y axis of the 2048 x 256 x 2048
        # plan, whose rows of 8200 bytes take 8-byte parts.
        cols_case("cols_1024_y", (NBIG, NBIG, kb), 1),
        cols_case("cols_1024_x", (NBIG, NBIG, kb), 0),
        cols_case("cols_512_y", (N // RANKS, N, k_r), 1),
        cols_case("cols_512_x", (N, N // RANKS, k_r), 0),
        cols_case("cols_2048_y", (sx, sy, sz // 2 + 1), 1),
        # Kernel 2's short-stage body on the 4-point second stage of the
        # 2048 x 256 x 2048 plan: the forward z (bins 0..1024 stored, the
        # crop), the inverse z (natural order) and x where it lies (the
        # bins stored in the axis's layout). Library: fft over the same
        # columns, no crop and no permutation.
        short_case("short_2048_z_crop", (sx * sy, 4, sz // 4), "crop", False),
        short_case("short_2048_z", (sx * sy, 4, sz // 4), "last", True),
        short_case("short_2048_x", (sx // 4, 4, sy * (sz // 2 + 1)),
                   "strided", False),
        # The 4-point row body the short-stage body replaced (no main path
        # since it did).
        dict(name="cmatmul", variant="row_n4_stage_2048", body="row",
             replaces=f"{PALLAS}:164", shape=dict(M=big_n1, n=4, k=4),
             make=lambda: dict(x=cr(big_n1, 4), F=planes("dft", 4)),
             run=lambda t: hf.cdft(t["x"], False),
             plain=lambda t: hf.stage_plain(t["x"], *t["F"]),
             library=lambda t: torch.fft.fft(t["x"]), library_call="fft",
             flops=fft_flops(big_n1, 4), gemm_flops=8 * big_n1 * 4 * 4,
             bytes=64 * big_n1 + 8 * 4 * 4),
        # Kernel 3 on random half spectra: their DC and Nyquist bins have
        # imaginary parts, which the C2R ignores.
        dict(name="c2r", replaces=f"{PALLAS}:156",
             shape=dict(M=rows_r, n_in=k_r, n=N),
             make=lambda: dict(x=cr(rows_r, k_r), C=planes("c2r", N)),
             run=lambda t: hf.irdft(t["x"], N),
             plain=lambda t: hf.c2r_plain(t["x"], *t["C"]),
             library=lambda t: torch.fft.irfft(t["x"], n=N, norm="forward"),
             library_call="irfft(norm='forward')",
             flops=fft_flops(rows_r, N, real=True),
             gemm_flops=4 * rows_r * k_r * N,
             bytes=8 * rows_r * k_r + 4 * rows_r * N),
        dict(name="c2r", variant="rows_1024", replaces=f"{PALLAS}:156",
             shape=dict(M=big_r, n_in=kb, n=NBIG),
             make=lambda: dict(x=cr(big_r, kb), C=planes("c2r", NBIG)),
             run=lambda t: hf.irdft(t["x"], NBIG),
             plain=lambda t: hf.c2r_plain(t["x"], *t["C"]),
             library=lambda t: torch.fft.irfft(t["x"], n=NBIG,
                                               norm="forward"),
             library_call="irfft(norm='forward') of the same rows",
             flops=fft_flops(big_r, NBIG, real=True),
             gemm_flops=4 * big_r * kb * NBIG,
             bytes=8 * big_r * kb + 4 * big_r * NBIG),
        dict(name="c2r", variant="tile_480", body="tile",
             replaces=f"{PALLAS}:156", shape=dict(M=rows_r, n_in=k480, n=480),
             make=lambda: dict(x=cr(rows_r, k480), C=planes("c2r", 480)),
             run=lambda t: hf.irdft(t["x"], 480),
             plain=lambda t: hf.c2r_plain(t["x"], *t["C"]),
             library=lambda t: torch.fft.irfft(t["x"], n=480, norm="forward"),
             library_call="irfft(norm='forward')",
             flops=fft_flops(rows_r, 480, real=True),
             gemm_flops=4 * rows_r * k480 * 480,
             bytes=8 * rows_r * k480 + 4 * rows_r * 480 + 8 * k480 * 480),
        # Kernel 4 takes no F: cdft_tw picks its body by n2 (the FFT body
        # at 512, the 2048-point axis's 4 x 512; the tile body at 320, the
        # 640-point axis's 2 x 320). "rows": torch.fft.fft of the same
        # rows, the stage without its twiddle, the nearer yardstick beside
        # the whole axis.
        dict(name="cmatmul_tw", replaces=f"{PALLAS}:171",
             shape=dict(M=big_tw, n=N, k=N, n1=4),
             make=lambda: dict(x=cr(big_tw, N), F=planes("dft", N),
                               T=hf._twiddle_planes(4, N, False, dev),
                               z=cr(big_tw // 4, 4 * N)),
             run=lambda t: hf.cdft_tw(t["x"], 4, False),
             plain=lambda t: hf.stage_plain(t["x"], *t["F"], *t["T"]),
             pair=lambda t: hf._fft_last(t["z"], False),
             rows=lambda t: torch.fft.fft(t["x"]),
             library=lambda t: torch.fft.fft(t["z"]),
             library_call="fft of the whole 2048-point axis",
             flops=fft_flops(big_tw, N) + 6 * big_tw * N,
             gemm_flops=8 * big_tw * N * N,
             bytes=16 * big_tw * N + 8 * 4 * N),
        # Kernel 4's column body where the plan's x axis lies: the (1, 512,
        # 4 * 262400) view of the (2048, 256, 1025) spectrum. "rows": fft
        # of the same columns without the twiddle; "pair": the port's
        # whole axis (this body, then the short-stage body).
        dict(name="cmatmul_tw", variant="cols_2048_x", body="cols",
             replaces=f"{PALLAS}:171",
             shape=dict(outer=1, n=sx // 4, inner=4 * x_inner, n1=4, axis=0),
             make=lambda: dict(z=cr(sx, sy, sz // 2 + 1)),
             run=lambda t: hf.cdft_tw_cols(
                 t["z"].view(1, sx // 4, 4 * x_inner), 4, False),
             plain=lambda t: hf.cdft_tw_cols_plain(
                 t["z"].view(1, sx // 4, 4 * x_inner), 4, False),
             pair=lambda t: hf.fft(t["z"], axis=0),
             rows=lambda t: torch.fft.fft(
                 t["z"].view(1, sx // 4, 4 * x_inner), dim=1),
             library=lambda t: torch.fft.fft(t["z"], dim=0),
             library_call="fft(dim=0) of the whole 2048-point axis",
             flops=fft_flops(4 * x_inner, sx // 4) + 6 * 4 * x_inner * sx // 4,
             gemm_flops=8 * 4 * x_inner * (sx // 4) ** 2,
             bytes=16 * 4 * x_inner * sx // 4 + 8 * 4 * sx // 4),
        dict(name="cmatmul_tw", variant="tile_n2_320", body="tile",
             replaces=f"{PALLAS}:171",
             shape=dict(M=rows_640c, n=320, k=320, n1=2),
             make=lambda: dict(x=cr(rows_640c, 320), F=planes("dft", 320),
                               T=hf._twiddle_planes(2, 320, False, dev),
                               z=cr(rows_640c // 2, 640)),
             run=lambda t: hf.cdft_tw(t["x"], 2, False),
             plain=lambda t: hf.stage_plain(t["x"], *t["F"], *t["T"]),
             rows=lambda t: torch.fft.fft(t["x"]),
             library=lambda t: torch.fft.fft(t["z"]),
             library_call="fft of the whole 640-point axis",
             flops=fft_flops(rows_640c, 320) + 6 * rows_640c * 320,
             gemm_flops=8 * rows_640c * 320 * 320,
             bytes=16 * rows_640c * 320 + 8 * 320 * 320 + 8 * 2 * 320),
        # Kernel 5 takes no F: rdft_tw picks its body by n2 (the FFT body
        # at 512, the 2048-point axis's 4 x 512; the tile body at 320, the
        # 640-point axis's 2 x 320).
        dict(name="rmatmul_tw", replaces=f"{PALLAS}:188",
             shape=dict(M=big_rtw, n=N, k=N, n1=4),
             make=lambda: dict(x=rr(big_rtw, N), F=planes("dft", N),
                               T=hf._twiddle_planes(4, N, False, dev),
                               z=rr(big_rtw // 4, 4 * N)),
             run=lambda t: hf.rdft_tw(t["x"], 4),
             plain=lambda t: hf.stage_plain(t["x"], *t["F"], *t["T"]),
             pair=lambda t: hf._rfft_last(t["z"]),
             library=lambda t: torch.fft.rfft(t["z"]),
             library_call="rfft of the whole 2048-point axis",
             flops=fft_flops(big_rtw, N, real=True) + 6 * big_rtw * N,
             gemm_flops=4 * big_rtw * N * N,
             bytes=12 * big_rtw * N + 8 * 4 * N),
        dict(name="rmatmul_tw", variant="tile_n2_320", body="tile",
             replaces=f"{PALLAS}:188",
             shape=dict(M=rows_640, n=320, k=320, n1=2),
             make=lambda: dict(x=rr(rows_640, 320), F=planes("dft", 320),
                               T=hf._twiddle_planes(2, 320, False, dev),
                               z=rr(rows_640 // 2, 640)),
             run=lambda t: hf.rdft_tw(t["x"], 2),
             plain=lambda t: hf.stage_plain(t["x"], *t["F"], *t["T"]),
             library=lambda t: torch.fft.rfft(t["z"]),
             library_call="rfft of the whole 640-point axis",
             flops=fft_flops(rows_640, 320, real=True) + 6 * rows_640 * 320,
             gemm_flops=4 * rows_640 * 320 * 320,
             bytes=12 * rows_640 * 320 + 8 * 320 * 320 + 8 * 2 * 320),
    ]


def wire_cases(torch, hf, dev, gen):
    """Kernels 9-11 at the per-rank shapes of a 1024^3 plan over four
    ranks: (entry, make inputs). ``check`` is "bit" or a tolerance."""
    xb, zo = NBIG // 4, NBIG // 2 + 1              # 256, 513
    m11 = xb * xb                                  # c2c inverse arrival rows
    elems = xb * xb * zo                           # 33,619,968

    def make_block():
        full = torch.complex(torch.randn((xb, NBIG, zo), generator=gen,
                                         device=dev),
                             torch.randn((xb, NBIG, zo), generator=gen,
                                         device=dev))
        chunk = full.narrow(1, xb, xb)             # chunk 1 of y: strided
        chunk[0, 0, :4] = torch.tensor(
            [complex(float("nan"), 1.0), complex(float("inf"), -2.0),
             complex(1 + 2 ** -8, -float("inf")), complex(1e-40, 3e38)],
            dtype=torch.complex64, device=dev)
        planes = hf.enc_pack_plain(chunk)
        return dict(full=full, x=chunk, planes=planes,
                    inter=torch.view_as_real(chunk).to(torch.bfloat16))

    def make_arrival(n):
        y = torch.randn((2, m11, n), generator=gen, device=dev).to(
            torch.bfloat16)
        return dict(y=y, F=hf._planes("dft", n, True, dev),
                    dec=hf.dec_unpack_plain(y))

    src = "distributedfft_tpu_torch/csrc/wire.cu"
    return [
        dict(name="enc_pack", replaces=f"{PALLAS}:725", source=src,
             shape=dict(block=[xb, xb, zo], of=[xb, NBIG, zo]),
             make=make_block, check="bit",
             run=lambda t: hf.enc_pack(t["x"]),
             plain=lambda t: hf.enc_pack_plain(t["x"]),
             library=lambda t: torch.view_as_real(t["x"]).to(torch.bfloat16),
             library_call="view_as_real(x).to(bfloat16) (interleaved)",
             flops=0, gemm_flops=0, bytes=12 * elems),
        dict(name="dec_unpack", replaces=f"{PALLAS}:731", source=src,
             shape=dict(block=[xb, xb, zo]), make=make_block, check="bit",
             run=lambda t: hf.dec_unpack(t["planes"]),
             plain=lambda t: hf.dec_unpack_plain(t["planes"]),
             library=lambda t: t["inter"].to(torch.float32),
             library_call="to(float32) of the interleaved bf16 pairs",
             flops=0, gemm_flops=0, bytes=12 * elems),
        # Kernel 11 takes no F: dec_cmatmul picks its body by n (the FFT
        # body at 1024, the tile body at 520).
        dict(name="dec_cmatmul", replaces=f"{PALLAS}:737", source=src,
             shape=dict(M=m11, n=NBIG), make=lambda: make_arrival(NBIG),
             check=TOL, run=lambda t: hf.dec_cmatmul(t["y"], True),
             plain=lambda t: hf.dec_cmatmul_plain(t["y"], *t["F"]),
             library=lambda t: torch.fft.ifft(t["dec"], norm="forward"),
             library_call="ifft(norm='forward') of the decoded block",
             flops=fft_flops(m11, NBIG), gemm_flops=8 * m11 * NBIG * NBIG,
             bytes=12 * m11 * NBIG),
        dict(name="dec_cmatmul", variant="tile_n_520", body="tile",
             replaces=f"{PALLAS}:737",
             source=src, shape=dict(M=m11, n=520),
             make=lambda: make_arrival(520), check=TOL,
             run=lambda t: hf.dec_cmatmul(t["y"], True),
             plain=lambda t: hf.dec_cmatmul_plain(t["y"], *t["F"]),
             library=lambda t: torch.fft.ifft(t["dec"], norm="forward"),
             library_call="ifft(norm='forward') of the decoded block",
             flops=fft_flops(m11, 520), gemm_flops=8 * m11 * 520 * 520,
             bytes=12 * m11 * 520 + 8 * 520 * 520),
    ]


def check_wire(torch, k, got, ref):
    """(max abs error, max rel error) of kernel k against its plain version;
    kernels 9 and 10 must be bit for bit (NaN and Inf included)."""
    if k["check"] != "bit":
        return rel_err(got, ref)
    if got.is_complex():
        got, ref = torch.view_as_real(got), torch.view_as_real(ref)
    bits = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    if got.shape != ref.shape or not torch.equal(got.view(bits),
                                                 ref.view(bits)):
        fail(f"kernel {k['name']} is not bit-equal to its plain version")
    return 0.0, 0.0


# The 512^3 fused plan, per direction: launches and entry points. Kernels
# 6 and 8 on their FFT bodies (three passes each), kernel 7 on its column
# body; the dense kernels never. Any cube of powers of two in [8, 512]
# runs the same.
FUSED_PATH = (dict(zy_fwd=3, x_c2c=1), dict(x_c2c=1, yz_inv=3),
              {"dfft_zy_rows": 1, "dfft_zy_cols": 1, "dfft_zy_planes": 1,
               "dfft_x_cols": 1},
              {"dfft_x_cols": 1, "dfft_yz_scratch": 1, "dfft_yz_cols": 1,
               "dfft_yz_rows": 1})

# The single-card per-axis paths under "pallas": id -> (shape, launches
# forward, launches inverse, C entry points forward, inverse, the limits
# of the dispatch's aten ops in ms, forward and inverse). At 1024^3 every
# axis is one launch of the row FFT engine: z on rows (kernel 1, and on
# the inverse kernel 3's C2R Body), y and x where they lie on kernel 2's
# column body, so no axis moves and the dispatch copies nothing. At 2048 x
# 256 x 2048 the x and z axes split 4 x 512 and y is one column launch.
# The z axis swaps its rows once, runs its first stage on them (kernel 5
# forward, kernel 4 inverse) and its 4-point second stage on kernel 2's
# short-stage body, which stores the crop (forward) or the natural order
# (inverse). The x axis runs its four-step where it lies, no copy: kernel
# 4's column body over s with the twiddle, then the short-stage body over
# r, storing each bin in the spectrum's layout. No dfft_stage launch.
# The inverse C2R of the split z axis inverts the Hermitian-extended
# spectrum as a complex transform and keeps its real part: the copies
# that remain, with the forward's swap, set the aten limits.
PER_AXIS_PATHS = {
    "per_axis_1024": (
        (NBIG,) * 3, dict(rmatmul=1, cmatmul=2), dict(cmatmul=2, c2r=1),
        {"dfft_rdft": 1, "dfft_cdft_cols": 2},
        {"dfft_cdft_cols": 2, "dfft_c2r": 1}, (COPY_LIMIT_MS, COPY_LIMIT_MS)),
    "per_axis_2048x256x2048": (
        SPLIT, dict(rmatmul_tw=1, cmatmul_tw=1, cmatmul=3),
        dict(cmatmul_tw=2, cmatmul=3),
        {"dfft_rdft_tw": 1, "dfft_cdft_short": 2, "dfft_cdft_cols": 1,
         "dfft_cdft_tw_cols": 1},
        {"dfft_cdft_tw_cols": 1, "dfft_cdft_short": 2, "dfft_cdft_cols": 1,
         "dfft_cdft_tw": 1}, split_copy_limits(SPLIT)),
}


def per_axis_path(torch, dft, hf, gen, pid, shape, want_f, want_i, ent_f_want,
                  ent_i_want, copy_limits_ms):
    """Run one single-card per-axis plan: launches and entry points per
    direction, forward against torch.fft.rfftn and the roundtrip against
    the input, then times under "pallas" and "xla", the kernel share of
    each direction and its profile, whose aten ops (the dispatch's copies)
    must stay within ``copy_limits_ms`` (forward, inverse). Returns the
    launches of the roundtrip and the plan's times."""
    torch.cuda.reset_peak_memory_stats()
    xb = torch.randn(shape, generator=gen, device="cuda")
    big = dft.SlabFFTPlan(dft.GlobalSize(*shape), dft.SlabPartition(1),
                          dft.Config(fft_backend="pallas"))
    cb, bb, fwd, inv, ent_f, ent_i = run_counted(torch, hf, big, xb)
    emit(phase="main_path", path=pid, shape=list(shape), launches_forward=fwd,
         launches_inverse=inv, entries_forward=ent_f, entries_inverse=ent_i,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    if fwd != expect(hf, **want_f) or inv != expect(hf, **want_i) or \
            ent_f != ent_f_want or ent_i != ent_i_want:
        fail(f"{pid} plan did not launch the per-axis kernels as expected: "
             f"forward {fwd} (entries {ent_f}), inverse {inv} (entries "
             f"{ent_i})")
    spectral = tuple(shape[:2]) + (shape[2] // 2 + 1,)
    if tuple(cb.shape) != spectral or tuple(bb.shape) != tuple(shape):
        fail(f"unexpected {pid} outputs {tuple(cb.shape)}, {tuple(bb.shape)}")
    _, fwd_rel = rel_err(cb, torch.fft.rfftn(xb))
    bb /= float(math.prod(shape))
    _, rt_rel = rel_err(bb, xb)
    emit(phase="main_path_check", path=pid, forward_vs_torch_fft=fwd_rel,
         roundtrip_vs_input=rt_rel, tol=TOL)
    if not (fwd_rel <= TOL and rt_rel <= TOL):
        fail(f"{pid} plan wrong: forward rel {fwd_rel:.3e}, roundtrip rel "
             f"{rt_rel:.3e} (tol {TOL})")
    del bb
    torch.cuda.empty_cache()
    xla_big = dft.SlabFFTPlan(dft.GlobalSize(*shape), dft.SlabPartition(1),
                              dft.Config())
    timed = dict(
        path=pid, shape=list(shape), reps=REPS_BIG,
        pallas_forward_ms=median_ms(torch, lambda: big.exec_r2c(xb),
                                    REPS_BIG, 1),
        pallas_inverse_ms=median_ms(torch, lambda: big.exec_c2r(cb),
                                    REPS_BIG, 1))
    cxb = xla_big.exec_r2c(xb)
    timed.update(
        xla_forward_ms=median_ms(torch, lambda: xla_big.exec_r2c(xb),
                                 REPS_BIG, 1),
        xla_inverse_ms=median_ms(torch, lambda: xla_big.exec_c2r(cxb),
                                 REPS_BIG, 1))
    del cxb
    torch.cuda.empty_cache()
    # Kernel time inside one run of each direction; the rest is the axis
    # moves, the four-step swaps of a split axis (copies) and the Hermitian
    # extension, which one profiled run names op by op.
    for name, fn in (("forward", lambda: big.exec_r2c(xb)),
                     ("inverse", lambda: big.exec_c2r(cb))):
        total, per = kernel_share(torch, hf, fn)
        timed[f"{name}_events_ms"] = total
        timed[f"{name}_kernel_ms"] = per
        timed[f"{name}_rest_ms"] = total - sum(per.values())
        timed[f"{name}_profile"] = device_profile(torch, fn)
    timed["aten_limit_ms"] = dict(zip(("forward", "inverse"), copy_limits_ms))
    emit(phase="plan_time", **timed)
    for name, limit in zip(("forward", "inverse"), copy_limits_ms):
        prof = timed[f"{name}_profile"]
        if prof["busy_ms"] == "not measured" or prof["aten_ms"] > limit:
            fail(f"{pid} {name}: the dispatch's ops took {prof['aten_ms']} "
                 f"ms of device time ({prof['aten_ops_ms']}; limit {limit} "
                 f"ms, busy {prof['busy_ms']})")
    del xb, cb, big, xla_big
    torch.cuda.empty_cache()
    return {k: fwd[k] + inv[k] for k in fwd}, timed


# ---------------------------------------------------------------------------
# The executables: the port's slab and reference CLIs, run in-process
# ---------------------------------------------------------------------------

CLI_N = (NBIG, N)     # the cubes the slab executable runs on one card
CLI_HOST_TRUTH_N = 128  # testcase 1's host truth: a float64 numpy cube
# Testcase -> (arguments, CSV blocks, forward runs, inverse runs): the
# executable runs each direction once as stages and once as the plan's
# exec_* (the "Run complete (fused)" mark), warm-ups included.
CLI_CASES = {
    0: (["-t", "0", "-i", "5", "-w", "2"], 5, 14, 0),
    2: (["-t", "2", "-i", "5", "-w", "2"], 5, 0, 14),
    3: (["-t", "3", "-i", "3", "-w", "1"], 3, 8, 8),
    4: (["-t", "4", "-i", "3", "-w", "1"], 3, 8, 8),
    1: (["-t", "1", "--tc1-truth", "analytic"], 1, 1, 0),
}
# The two-rank runs: (arguments, CSV blocks, forward runs, inverse runs).
CLI_RANK_CASES = {3: (["-t", "3"], 1, 2, 2),
                  0: (["-t", "0", "-i", "3", "-w", "1"], 3, 8, 0)}


def scaled(want_f, k_f, want_i, k_i):
    """Launch (or entry-point) counts of k_f forwards and k_i inverses."""
    keys = set(want_f) | set(want_i)
    out = {k: k_f * want_f.get(k, 0) + k_i * want_i.get(k, 0) for k in keys}
    return {k: v for k, v in out.items() if v}


def cli_run(torch, hf, main, argv):
    """Run an executable's ``main(argv)`` in this process with the launch
    counts set to 0 just before and read just after: (printed text,
    launches, C entry points, seconds). A non-zero exit code fails."""
    import io
    buf = io.StringIO()
    hf.reset_launches()
    t0 = time.perf_counter()
    with entry_counts(hf) as ent, contextlib.redirect_stdout(buf):
        rc = main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if rc != 0:
        fail(f"{argv} exited with {rc}: {buf.getvalue()}")
    return buf.getvalue(), dict(hf.LAUNCHES), dict(ent), seconds


def printed(text: str, key: str) -> float:
    """The number the executable printed after ``key``."""
    for line in text.splitlines():
        if line.startswith(key):
            return float(line[len(key):].split()[0])
    fail(f"no {key!r} in the executable's output: {text!r}")


def cli_csv(bdir, sections, blocks_want, ranks):
    """The one CSV an executable wrote under ``bdir``: (file name, mean "Run
    complete" ms, mean fused ms) of rank 0's column, after checking it
    parses with the port's reader into ``blocks_want`` blocks of
    ``sections``, each with ``ranks`` columns."""
    import glob
    from distributedfft_tpu_torch.testing.testcases import FUSED_DESC
    from distributedfft_tpu_torch.utils.timer import read_timer_csv
    paths = glob.glob(os.path.join(bdir, "*", "*.csv"))
    if len(paths) != 1:
        fail(f"expected one CSV under {bdir}, found {paths}")
    with open(paths[0]) as f:
        header = f.readline().rstrip("\n")
    blocks = read_timer_csv(paths[0])
    if header != "," + "".join(f"{r}," for r in range(ranks)) or \
            len(blocks) != blocks_want or \
            any(list(b) != sections or any(len(v) != ranks
                                           for v in b.values())
                for b in blocks):
        fail(f"{paths[0]}: header {header!r}, {len(blocks)} blocks "
             f"(expected {blocks_want} of {sections} with {ranks} columns)")
    run = [b["Run complete"][0] for b in blocks]
    fused = [b[FUSED_DESC][0] - b["Run complete"][0] for b in blocks]
    return (os.path.relpath(paths[0], bdir), statistics.mean(run),
            statistics.mean(fused) if blocks_want and fused[0] > 0 else None)


def cli_result(tc: int, text: str, n_total: int, truth_asum: float):
    """Testcases 1, 3 and 4: (the printed result, the result over its
    reference magnitude: the truth's asum, N, 3 sqrt(N))."""
    if tc == 1:
        val, scale = printed(text, "Result "), truth_asum
    elif tc == 3:
        val, scale = printed(text, "Result (max): "), float(n_total)
    elif tc == 4:
        val, scale = printed(text, "Result (max): "), 3 * math.sqrt(n_total)
    else:
        return None, None
    if not math.isfinite(val):
        fail(f"testcase {tc} printed {val}")
    return val, val / scale


def gate_cli_results(rows):
    """Testcases 1 and 3 within TOL of their reference magnitude. Testcase
    4 too, or, where float32 cannot reach TOL with any FFT (its Laplacian
    symbol multiplies the forward's rounding noise by up to 3 (n/2)^2 /
    sqrt(N), so its error over 3 sqrt(N) grows about fivefold a doubling of
    n), no worse than twice the error of cuFFT ("xla") on the same cube."""
    cufft = {(r["n"], r["testcase"]): r["result"] for r in rows
             if r.get("result") is not None and r["backend"] == "xla"}
    for r in rows:
        if r.get("result") is None:
            continue
        r["gate"] = "tol"
        if r["result_rel"] > TOL:
            ref = cufft.get((r["n"], r["testcase"]))
            if r["testcase"] != 4 or ref is None or r["result"] > 2 * ref:
                fail(f"slab {r['argv']}: result {r['result']} ({r['result_rel']}"
                     f" of its reference magnitude; cuFFT's {ref})")
            r["gate"] = f"2 x cufft ({ref})"


def cli_single_card(torch, dft, hf, plan_times):
    """The slab executable at 1024^3 and 512^3 on one card (testcases 0-4
    under "pallas" and "xla"), testcase 1's host truth at 128^3, and the
    reference executable's testcase 0 at 512^3: launches and entry points
    against the plan phases', results within TOL of their reference
    magnitude, every CSV parsed. Returns (launches by path, rows)."""
    from distributedfft_tpu_torch.cli import reference as cli_ref
    from distributedfft_tpu_torch.cli import slab as cli_slab
    from distributedfft_tpu_torch.testing import testcases as tcs

    paths = {NBIG: PER_AXIS_PATHS["per_axis_1024"][1:5],
             N: FUSED_PATH, CLI_HOST_TRUTH_N: FUSED_PATH}
    runs = [(n, tc) for n in CLI_N for tc in ((0, 2, 3, 4, 1) if n == NBIG
                                              else (0, 4))]
    runs.append((CLI_HOST_TRUTH_N, 1))
    launches, rows = {}, []
    root = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    sections = tcs.make_plan("slab", dft.GlobalSize(N, N, N), dft.SlabPartition(1), None,
                             device="cuda").section_descriptions
    for be in ("pallas", "xla"):
        for n, tc in runs:
            args, blocks, k_f, k_i = CLI_CASES[tc]
            host_truth = n == CLI_HOST_TRUTH_N
            if host_truth:
                args = ["-t", "1"]
            bdir = os.path.join(root, f"{be}_{n}_{tc}")
            argv = ["-nx", str(n), "-ny", str(n), "-nz", str(n), "-comm",
                    "All2All", "--fft-backend", be, "-b", bdir] + args
            text, got, ent, secs = cli_run(torch, hf, cli_slab.main, argv)
            want_f, want_i, ent_f, ent_i = paths[n]
            want = scaled(want_f, k_f, want_i, k_i) if be == "pallas" else {}
            ent_want = scaled(ent_f, k_f, ent_i, k_i) if be == "pallas" \
                else {}
            if got != expect(hf, **want) or ent != ent_want:
                fail(f"slab {argv}: launches {got} (entries {ent}), "
                     f"expected {want} ({ent_want})")
            truth = n ** 3 / 2
            if host_truth:
                plan = tcs.make_plan("slab", dft.GlobalSize(n, n, n), dft.SlabPartition(1), None,
                                     device="cuda")
                truth = float(np.abs(tcs.reference_spectrum(
                    plan, tcs.random_real_input(plan).astype(np.float64))
                ).sum())
            val, rel = cli_result(tc, text, n ** 3, truth)
            name, run_ms, fused_ms = cli_csv(bdir, sections, blocks, 1)
            launches[f"cli_slab_{be}_{n}_t{tc}"] = got
            rows.append(dict(executable="slab", backend=be, n=n, testcase=tc,
                             argv=argv, seconds=secs, csv=name,
                             run_complete_ms=run_ms, fused_ms=fused_ms,
                             result=val, result_rel=rel,
                             printed=text.strip().splitlines()[-3:],
                             entries=ent))
            emit(phase="cli", **rows[-1])
            torch.cuda.empty_cache()
        argv = ["-nx", str(N), "-ny", str(N), "-nz", str(N), "-t", "0",
                "-i", "5", "-w", "2", "--fft-backend", be]
        text, got, ent, secs = cli_run(torch, hf, cli_ref.main, argv)
        want_f, _, ent_f, _ = FUSED_PATH
        want = scaled(want_f, 7, {}, 0) if be == "pallas" else {}
        ent_want = scaled(ent_f, 7, {}, 0) if be == "pallas" else {}
        if got != expect(hf, **want) or ent != ent_want:
            fail(f"reference {argv}: launches {got} (entries {ent})")
        launches[f"cli_reference_{be}_{N}_t0"] = got
        rows.append(dict(executable="reference", backend=be, n=N, testcase=0,
                         argv=argv, seconds=secs,
                         run_complete_ms=printed(text, "Run complete: "),
                         printed=text.strip().splitlines(), entries=ent))
        emit(phase="cli", **rows[-1])
        torch.cuda.empty_cache()
    gate_cli_results(rows)
    emit(phase="cli_results", rows=[
        {k: r.get(k) for k in ("backend", "n", "testcase", "result",
                               "result_rel", "gate")}
        for r in rows if r.get("result") is not None])
    # The executables' means beside the plan phases' medians, same plans:
    # testcase 0 is the forward, testcase 2 the inverse (reported only).
    table = []
    for r in rows:
        pid = {NBIG: "per_axis_1024", N: "fused_512"}.get(r["n"])
        d = {0: "forward", 2: "inverse"}.get(r["testcase"])
        if pid in plan_times and d:
            ref = plan_times[pid][f"{r['backend']}_{d}_ms"]
            got = r["fused_ms"] if r["executable"] == "slab" else \
                r["run_complete_ms"]
            table.append(dict(executable=r["executable"], n=r["n"],
                              backend=r["backend"], direction=d,
                              run_complete_ms=r["run_complete_ms"],
                              fused_ms=r.get("fused_ms"),
                              plan_time_ms=ref, ratio=got / ref))
    emit(phase="cli_vs_plan_time", rows=table)
    return launches, rows


def xla_inverse_probe(torch, dft):
    """cuFFT's ("xla") 1024^3 inverse on testcase 2's kind of input (a
    uniform random spectrum, not Hermitian) and on a forward's output, in
    turns in one process: whether the inverse's time depends on its input
    or on the run before it."""
    from distributedfft_tpu_torch.testing import testcases as tcs
    plan = tcs.make_plan("slab", dft.GlobalSize(NBIG, NBIG, NBIG), dft.SlabPartition(1), dft.Config(),
                         device="cuda")
    spec = plan.output_shape
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    c_fwd = plan.exec_r2c(torch.rand(plan.input_shape, generator=gen,
                                     device="cuda"))
    c_rand = torch.complex(torch.rand(spec, generator=gen, device="cuda"),
                           torch.rand(spec, generator=gen, device="cuda"))
    out = {}
    for name, c in (("random", c_rand), ("forward_output", c_fwd),
                    ("random_again", c_rand), ("forward_output_again", c_fwd)):
        out[f"{name}_ms"] = median_ms(torch, lambda: plan.exec_c2r(c),
                                      REPS_BIG, 1)
    emit(phase="cli_xla_inverse_probe", n=NBIG, reps=REPS_BIG, **out)
    del c_fwd, c_rand, plan
    torch.cuda.empty_cache()
    return out


def cli_rank_main(rank: int, addr: str, outdir: str) -> None:
    """One of the two ranks of the executables' phase: the slab executable
    at 512^3 over both exchanges (testcases 3 and 0), the renderings' bit
    equality, and the reference executable's bandwidth probe."""
    import torch
    import torch.distributed as dist
    import distributedfft_tpu_torch as dft
    from distributedfft_tpu_torch.cli import reference as cli_ref
    from distributedfft_tpu_torch.cli import slab as cli_slab
    from distributedfft_tpu_torch.ops import hopper_fft as hf
    from distributedfft_tpu_torch.parallel import multihost
    from distributedfft_tpu_torch.testing import testcases as tcs

    torch.cuda.set_device(0)
    multihost.maybe_initialize(addr, RANKS, rank, backend="gloo",
                               timeout_s=300)
    out = {"rank": rank, "runs": [], "launches": {}}
    sections = tcs.make_plan("slab", dft.GlobalSize(N, N, N), dft.SlabPartition(1), None,
                             device="cuda").section_descriptions
    for comm in ("Peer2Peer", "All2All"):
        for tc, (args, blocks, k_f, k_i) in CLI_RANK_CASES.items():
            bdir = os.path.join(outdir, f"{comm}_t{tc}")
            argv = ["-nx", str(N), "-ny", str(N), "-nz", str(N), "-p",
                    str(RANKS), "-comm", comm, "--fft-backend", "pallas",
                    "-b", bdir] + args
            text, got, ent, secs = cli_run(torch, hf, cli_slab.main, argv)
            want = scaled(dict(rmatmul=1, cmatmul=2), k_f,
                          dict(cmatmul=2, c2r=1), k_i)
            ent_want = scaled(A2A_ENTRIES[0], k_f, A2A_ENTRIES[1], k_i)
            if got != expect(hf, **want) or ent != ent_want:
                fail(f"rank {rank} slab {argv}: launches {got} (entries "
                     f"{ent}), expected {want} ({ent_want})")
            out["launches"][f"cli_slab_{comm}_{N}_t{tc}"] = got
            row = dict(comm=comm, testcase=tc, argv=argv, seconds=secs,
                       entries=ent)
            dist.barrier()      # rank 0 has written the CSV
            if rank == 0:
                val, rel = cli_result(tc, text, N ** 3, 0.0)
                if rel is not None and rel > TOL:
                    fail(f"rank 0 slab {argv}: {val} is {rel} of N")
                name, run_ms, fused_ms = cli_csv(bdir, sections, blocks,
                                                 RANKS)
                row.update(csv=name, run_complete_ms=run_ms,
                           fused_ms=fused_ms, result=val, result_rel=rel,
                           printed=text.strip().splitlines())
            out["runs"].append(row)
            torch.cuda.empty_cache()
    # The renderings of one exchange, bit for bit: PEER2PEER + SYNC and
    # ALL2ALL + MPI_TYPE against ALL2ALL + SYNC.
    res = {}
    for rid, comm, snd in (("a2a_sync", "All2All", "Sync"),
                           ("p2p_sync", "Peer2Peer", "Sync"),
                           ("a2a_mpi_type", "All2All", "MPI_Type")):
        plan = tcs.make_plan("slab", dft.GlobalSize(N, N, N), dft.SlabPartition(RANKS),
                             dft.Config(comm_method=dft.CommMethod.parse(comm),
                                        send_method=dft.SendMethod.parse(snd),
                                        fft_backend="pallas"), device="cuda")
        xl = plan.pad_input(tcs.random_real_input(plan))
        c = plan.exec_r2c(xl)
        res[rid] = (c, plan.exec_c2r(c))
        del plan, xl
    for rid in ("p2p_sync", "a2a_mpi_type"):
        ok = all(torch.equal(g, w) for g, w in zip(res[rid], res["a2a_sync"]))
        out[f"{rid}_equals_a2a_sync"] = ok
        if not ok:
            fail(f"rank {rank}: {rid} is not bit-equal to All2All + Sync")
    del res
    torch.cuda.empty_cache()
    for o in ("0", "1"):
        argv = ["-nx", str(N), "-ny", str(N), "-nz", str(N), "-t", "1",
                "-o", o, "-i", "3", "-w", "1"]
        text, got, ent, secs = cli_run(torch, hf, cli_ref.main, argv)
        if any(got.values()):
            fail(f"rank {rank} reference {argv} launched kernels: {got}")
        if rank == 0:
            line = next(ln for ln in text.splitlines()
                        if ln.startswith("Bandwidth: "))
            want = "isend" if o == "0" else "all_to_all_single"
            if want not in line:
                fail(f"reference -o {o}: {line}")
            out[f"reference_t1_o{o}"] = dict(
                argv=argv, seconds=secs, printed=line,
                mb_per_s=printed(text, "Bandwidth: "))
    with open(os.path.join(outdir, f"cli_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    multihost.shutdown()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    try:
        import distributedfft_tpu_torch as dft
        from distributedfft_tpu_torch.ops import _build
        from distributedfft_tpu_torch.ops import hopper_fft as hf
        from distributedfft_tpu_torch.parallel import multihost
    except ImportError as err:
        print(f"chip_smoke: the port is not importable ({err}); run from the "
              "root of a checkout", file=sys.stderr)
        return 1
    t_start = time.perf_counter()

    # -- 1. device -----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    emit(phase="device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=card,
         torch=torch.__version__, cuda=torch.version.cuda)

    # -- 2. build: every source at once, before any rank is spawned ----------
    t0 = time.perf_counter()
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    per_lib = _build.build(sources)
    emit(phase="build", sources=sources, seconds=time.perf_counter() - t0,
         per_library_s=per_lib)

    # -- 3. fused kernels 6-8 against their plain versions at 512^3 ----------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    Zo = N // 2 + 1

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32)

    x = randn(N, N, N)
    x480 = randn(N, 480, 480)     # kernels 6 and 8's dense bodies (not
    Z4 = 480 // 2 + 1             # powers of two)
    pr480, pi480 = randn(N, 480, Z4), randn(N, 480, Z4)
    pr, pi = randn(N, N, Zo), randn(N, N, Zo)
    fzr, fzi = hf._planes("rdft", N, False, dev)
    fyr, fyi = hf._planes("dft", N, False, dev)
    fxr, fxi = hf._planes("dft", N, True, dev)
    fxfr, fxfi = hf._planes("dft", N, False, dev)
    xr480, xi480 = randn(480, N, Zo), randn(480, N, Zo)   # kernel 7's dense
    f480x = hf._planes("dft", 480, True, dev)              # body (X = 480)
    fyir, fyii = hf._planes("dft", N, True, dev)
    cr, ci = hf._planes("c2r", N, False, dev)
    pc = torch.complex(pr, pi)
    pc480 = torch.complex(pr480, pi480)
    X = Y = Z = N
    f480 = (hf._planes("rdft", 480, False, dev) + hf._planes("dft", 480, False,
                                                             dev))
    i480 = (hf._planes("dft", 480, True, dev) + hf._planes("c2r", 480, False,
                                                           dev))
    fused = [
        dict(name="zy_fwd", replaces=f"{PALLAS}:427",
             shape=dict(X=X, Y=Y, Z=Z),
             run=lambda: hf.zy_fwd(x),
             plain=lambda: hf.zy_fwd_plain(x, fzr, fzi, fyr, fyi),
             library=lambda: torch.fft.rfft2(x), library_call="rfft2",
             flops=fft_flops(X * Y, Z, real=True) + fft_flops(X * Zo, Y),
             gemm_flops=4 * X * Y * Z * Zo + 8 * X * Y * Y * Zo,
             bytes=4 * (X * Y * Z + 2 * X * Y * Zo)),
        dict(name="zy_fwd", variant="dense_480", body="dense",
             replaces=f"{PALLAS}:427",
             shape=dict(X=X, Y=480, Z=480),
             run=lambda: hf.zy_fwd(x480),
             plain=lambda: hf.zy_fwd_plain(x480, *f480),
             library=lambda: torch.fft.rfft2(x480), library_call="rfft2",
             flops=fft_flops(X * 480, 480, real=True) + fft_flops(X * Z4, 480),
             gemm_flops=4 * X * 480 * 480 * Z4 + 8 * X * 480 * 480 * Z4,
             bytes=4 * (X * 480 * 480 + 2 * 480 * Z4 + 2 * 480 * 480
                        + 2 * X * 480 * Z4)),
        # Kernel 7 on each layout pair the fused plan launches: the
        # inverse's (the complex64 spectrum in, kernel 8's planes out) and
        # the forward's (kernel 6's planes in, the spectrum out); the dense
        # body at X = 480. An FFT body's bytes count no DFT matrix.
        dict(name="x_c2c", replaces=f"{PALLAS}:443",
             shape=dict(X=X, Y=Y, Zo=Zo),
             run=lambda: hf.x_cols(pc, True, complex_out=False),
             plain=lambda: hf.x_c2c_plain(pr, pi, fxr, fxi),
             library=lambda: torch.fft.ifft(pc, dim=0, norm="forward"),
             library_call="ifft(dim=0, norm='forward')",
             flops=fft_flops(Y * Zo, X), gemm_flops=8 * X * X * Y * Zo,
             bytes=16 * X * Y * Zo),
        dict(name="x_c2c", variant="forward_to_complex",
             replaces=f"{PALLAS}:443", shape=dict(X=X, Y=Y, Zo=Zo),
             run=lambda: hf.x_cols((pr, pi), False, complex_out=True),
             plain=lambda: torch.complex(*hf.x_c2c_plain(pr, pi, fxfr, fxfi)),
             library=lambda: torch.fft.fft(pc, dim=0),
             library_call="fft(dim=0)",
             flops=fft_flops(Y * Zo, X), gemm_flops=8 * X * X * Y * Zo,
             bytes=16 * X * Y * Zo),
        dict(name="x_c2c", variant="dense_480", body="dense",
             replaces=f"{PALLAS}:443", shape=dict(X=480, Y=Y, Zo=Zo),
             run=lambda: hf.x_c2c(xr480, xi480, inverse=True),
             plain=lambda: hf.x_c2c_plain(xr480, xi480, *f480x),
             library=lambda: torch.fft.ifft(torch.complex(xr480, xi480),
                                            dim=0, norm="forward"),
             library_call="ifft(dim=0, norm='forward')",
             flops=fft_flops(Y * Zo, 480), gemm_flops=8 * 480 * 480 * Y * Zo,
             bytes=16 * 480 * Y * Zo + 8 * 480 * 480),
        # Kernel 8 on random spectra: their DC and Nyquist z-bins have
        # imaginary parts, which the C2R ignores.
        dict(name="yz_inv", replaces=f"{PALLAS}:452",
             shape=dict(X=X, Y=Y, Z=Z),
             run=lambda: hf.yz_inv(pr, pi, Z),
             plain=lambda: hf.yz_inv_plain(pr, pi, fyir, fyii, cr, ci),
             library=lambda: torch.fft.irfft2(pc, s=(Y, Z), norm="forward"),
             library_call="irfft2",
             flops=fft_flops(X * Zo, Y) + fft_flops(X * Y, Z, real=True),
             gemm_flops=8 * X * Y * Y * Zo + 4 * X * Y * Zo * Z,
             bytes=4 * (2 * X * Y * Zo + X * Y * Z)),
        dict(name="yz_inv", variant="dense_480", body="dense",
             replaces=f"{PALLAS}:452",
             shape=dict(X=X, Y=480, Z=480),
             run=lambda: hf.yz_inv(pr480, pi480, 480),
             plain=lambda: hf.yz_inv_plain(pr480, pi480, *i480),
             library=lambda: torch.fft.irfft2(pc480, s=(480, 480),
                                              norm="forward"),
             library_call="irfft2",
             flops=fft_flops(X * Z4, 480) + fft_flops(X * 480, 480, real=True),
             gemm_flops=8 * X * 480 * 480 * Z4 + 4 * X * 480 * Z4 * 480,
             bytes=4 * (2 * X * 480 * Z4 + 2 * 480 * 480 + 2 * Z4 * 480
                        + X * 480 * 480)),
    ]
    for k in fused:
        k["source"] = "distributedfft_tpu_torch/csrc/fused3d.cu"
        k["body"] = body_of(hf, k)
        got, ref = k["run"](), k["plain"]()
        torch.cuda.synchronize()
        if not isinstance(got, tuple):
            got, ref = (got,), (ref,)
        errs = [rel_err(g, r) for g, r in zip(got, ref)]
        k["max_abs_err"] = max(e[0] for e in errs)
        k["max_rel_err"] = max(e[1] for e in errs)
        emit(phase="kernel_check", name=k["name"], variant=k.get("variant"),
             body=k["body"], shape=k["shape"], max_abs_err=k["max_abs_err"],
             max_rel_err=k["max_rel_err"], tol=TOL)
        if not k["max_rel_err"] <= TOL:
            fail(f"kernel {k['name']} {k['shape']} disagrees with its plain "
                 f"version: rel {k['max_rel_err']:.3e} > {TOL}")
        del got, ref

    # -- 4. the 512^3 fused plan and a small cube against numpy --------------
    pallas = dft.Config(fft_backend="pallas")
    small = dft.SlabFFTPlan(dft.GlobalSize(*SMALL), dft.SlabPartition(1),
                            pallas)
    xs = torch.randn(SMALL, generator=gen, device=dev, dtype=torch.float32)
    ref_small = torch.from_numpy(np.fft.rfftn(xs.cpu().double().numpy()))
    _, small_rel = rel_err(small.exec_r2c(xs).cpu().to(torch.complex128),
                           ref_small)
    emit(phase="small_vs_numpy", shape=list(SMALL), max_rel_err=small_rel)
    if not small_rel <= TOL:
        fail(f"{SMALL} forward disagrees with numpy: rel {small_rel:.3e}")

    plan = dft.SlabFFTPlan(dft.GlobalSize(N, N, N), dft.SlabPartition(1),
                           pallas)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    c, back, fwd, inv, entries, entries_inv = run_counted(torch, hf, plan, x)
    launches = {"fused_512": {k: fwd[k] + inv[k] for k in fwd}}
    emit(phase="main_path", path="fused_512", launches_forward=fwd,
         launches_inverse=inv, entries_forward=entries,
         entries_inverse=entries_inv,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    want_f, want_i, ent_f_want, ent_i_want = FUSED_PATH
    if fwd != expect(hf, **want_f) or inv != expect(hf, **want_i) or \
            entries != ent_f_want or entries_inv != ent_i_want:
        fail(f"main path did not launch each kernel as expected: forward "
             f"{fwd} (entries {entries}), inverse {inv} (entries "
             f"{entries_inv})")
    if tuple(c.shape) != (N, N, Zo) or c.dtype != torch.complex64 or \
            tuple(back.shape) != (N, N, N) or back.dtype != torch.float32:
        fail(f"unexpected outputs {tuple(c.shape)} {c.dtype}, "
             f"{tuple(back.shape)} {back.dtype}")
    if not (bool(torch.isfinite(c).all()) and bool(torch.isfinite(back).all())):
        fail("non-finite values on the main path")
    _, fwd_rel = rel_err(c, torch.fft.rfftn(x))
    _, rt_rel = rel_err(back / float(N ** 3), x)
    emit(phase="main_path_check", path="fused_512", forward_vs_torch_fft=fwd_rel,
         roundtrip_vs_input=rt_rel, tol=TOL)
    if not (fwd_rel <= TOL and rt_rel <= TOL):
        fail(f"main path wrong: forward rel {fwd_rel:.3e}, roundtrip rel "
             f"{rt_rel:.3e} (tol {TOL})")
    del c, back

    # -- 5. timing of the fused kernels and the 512^3 plans ------------------
    for k in fused:
        k["kernel_ms"] = median_ms(torch, k["run"])
        k["plain_ms"] = median_ms(torch, k["plain"])
        k["library_ms"] = median_ms(torch, k["library"])
        k["bound_ms"], k["bound_by"] = bound(k["flops"], k["bytes"])
        if k["body"] == "fft" and k["name"] != "x_c2c":  # 6 and 8: passes
            k["pass_ms"] = entry_ms(torch, hf, k["run"])
        emit(phase="kernel_time", name=k["name"], variant=k.get("variant"),
             kernel_ms=k["kernel_ms"], plain_ms=k["plain_ms"],
             library_ms=k["library_ms"], bound_ms=k["bound_ms"],
             bound_by=k["bound_by"], pass_ms=k.get("pass_ms"))
    xla = dft.SlabFFTPlan(dft.GlobalSize(N, N, N), dft.SlabPartition(1),
                          dft.Config())
    cp, cx = plan.exec_r2c(x), xla.exec_r2c(x)
    plan_times = {"fused_512": dict(
        pallas_forward_ms=median_ms(torch, lambda: plan.exec_r2c(x)),
        pallas_inverse_ms=median_ms(torch, lambda: plan.exec_c2r(cp)),
        xla_forward_ms=median_ms(torch, lambda: xla.exec_r2c(x)),
        xla_inverse_ms=median_ms(torch, lambda: xla.exec_c2r(cx)))}
    emit(phase="plan_time", path="fused_512", shape=[N, N, N],
         **plan_times["fused_512"],
         forward_profile=device_profile(torch, lambda: plan.exec_r2c(x)),
         inverse_profile=device_profile(torch, lambda: plan.exec_c2r(cp)))
    del x, x480, pr, pi, pc, pr480, pi480, pc480, xr480, xi480, cp, cx, plan, \
        xla
    torch.cuda.empty_cache()

    # -- 6. per-axis kernels 1-5: check against plain, then time -------------
    staged = stage_cases(torch, hf, dev, gen)
    for k in staged:
        k["source"] = "distributedfft_tpu_torch/csrc/stage.cu"
        k["body"] = body_of(hf, k)
        t = k["make"]()
        got, ref = k["run"](t), k["plain"](t)
        torch.cuda.synchronize()
        k["max_abs_err"], k["max_rel_err"] = rel_err(got, ref)
        del got, ref
        emit(phase="kernel_check", name=k["name"], variant=k.get("variant"),
             body=k["body"], shape=k["shape"], max_abs_err=k["max_abs_err"],
             max_rel_err=k["max_rel_err"], tol=TOL)
        if not k["max_rel_err"] <= TOL:
            fail(f"kernel {k['name']} {k['shape']} disagrees with its plain "
                 f"version: rel {k['max_rel_err']:.3e} > {TOL}")
        k["kernel_ms"] = median_ms(torch, lambda: k["run"](t))
        k["plain_ms"] = median_ms(torch, lambda: k["plain"](t))
        k["library_ms"] = median_ms(torch, lambda: k["library"](t))
        if "pair" in k:
            k["pair_ms"] = median_ms(torch, lambda: k["pair"](t))
        if "rows" in k:
            k["library_rows_ms"] = median_ms(torch, lambda: k["rows"](t))
        k["bound_ms"], k["bound_by"] = bound(k["flops"], k["bytes"])
        emit(phase="kernel_time", name=k["name"], variant=k.get("variant"),
             kernel_ms=k["kernel_ms"], plain_ms=k["plain_ms"],
             library_ms=k["library_ms"], library_call=k["library_call"],
             pair_ms=k.get("pair_ms"),
             library_rows_ms=k.get("library_rows_ms"),
             bound_ms=k["bound_ms"], bound_by=k["bound_by"])
        del t
        torch.cuda.empty_cache()

    # -- 6b. fused-wire kernels 9-11: check against plain, then time --------
    wired = wire_cases(torch, hf, dev, gen)
    for k in wired:
        k["body"] = body_of(hf, k)
        t = k["make"]()
        got, ref = k["run"](t), k["plain"](t)
        torch.cuda.synchronize()
        k["max_abs_err"], k["max_rel_err"] = check_wire(torch, k, got, ref)
        del got, ref
        emit(phase="kernel_check", name=k["name"], variant=k.get("variant"),
             body=k["body"], shape=k["shape"], max_abs_err=k["max_abs_err"],
             max_rel_err=k["max_rel_err"], tol=k["check"])
        if k["check"] != "bit" and not k["max_rel_err"] <= k["check"]:
            fail(f"kernel {k['name']} disagrees with its plain version: "
                 f"rel {k['max_rel_err']:.3e} > {k['check']}")
        k["kernel_ms"] = median_ms(torch, lambda: k["run"](t))
        k["plain_ms"] = median_ms(torch, lambda: k["plain"](t))
        k["library_ms"] = median_ms(torch, lambda: k["library"](t))
        k["bound_ms"], k["bound_by"] = bound(k["flops"], k["bytes"])
        emit(phase="kernel_time", name=k["name"], variant=k.get("variant"),
             kernel_ms=k["kernel_ms"], plain_ms=k["plain_ms"],
             library_ms=k["library_ms"], library_call=k["library_call"],
             bound_ms=k["bound_ms"], bound_by=k["bound_by"])
        del t
        torch.cuda.empty_cache()

    # -- 7. the single-card per-axis plans -----------------------------------
    for pid, spec in PER_AXIS_PATHS.items():
        launches[pid], plan_times[pid] = per_axis_path(torch, dft, hf, gen,
                                                       pid, *spec)

    # -- 8. the 512^3 plan as two ranks sharing the card over gloo -----------
    import torch.multiprocessing as tmp
    outdir = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    t0 = time.perf_counter()
    tmp.spawn(rank_main, args=(multihost.local_coordinator(), outdir),
              nprocs=RANKS, join=True)
    ranks = []
    for r in range(RANKS):
        with open(os.path.join(outdir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    r0 = ranks[0]
    launches["distributed_512_rank0"] = {
        k: r0["launches_forward"][k] + r0["launches_inverse"][k]
        for k in r0["launches_forward"]}
    for pid in RING_PATHS:
        row = r0["ring"][pid]
        launches[f"distributed_512_{pid}_rank0"] = {
            k: row["launches_forward"][k] + row["launches_inverse"][k]
            for k in row["launches_forward"]}
    emit(phase="main_path", path="distributed_512", ranks=RANKS,
         exchange="gloo, host-staged, 2 ranks on 1 card",
         seconds=time.perf_counter() - t0, per_rank=ranks)
    # The exchange alone per direction (host wall clock, median of 5, both
    # ranks at once) and the bytes each rank sends: gloo over the host on
    # one card, which says nothing about NCCL across cards.
    for rk in ranks:
        sent = rk["exchange_bytes"] * (RANKS - 1) // RANKS
        table = {"all_to_all_native": dict(
            forward_ms=rk["exchange_forward_ms"],
            inverse_ms=rk["exchange_inverse_ms"],
            wire_bytes_per_rank={"forward": sent, "inverse": sent})}
        for pid in EXCHANGE_TIMED:
            row = rk["ring"][pid]
            table[pid] = dict(forward_ms=row["exchange_forward_ms"],
                              inverse_ms=row["exchange_inverse_ms"],
                              wire_bytes_per_rank=row["wire_bytes_per_rank"])
        emit(phase="exchange", rank=rk["rank"],
             transport=rk["ring"]["transport"], renderings=table)

    # -- 8b. the executables: slab and reference, on one card and two ranks -
    t0 = time.perf_counter()
    cli_launches, cli_rows = cli_single_card(torch, dft, hf, plan_times)
    launches.update(cli_launches)
    xla_inverse_probe(torch, dft)
    tmp.spawn(cli_rank_main, args=(multihost.local_coordinator(), outdir),
              nprocs=RANKS, join=True)
    cli_ranks = []
    for r in range(RANKS):
        with open(os.path.join(outdir, f"cli_rank{r}.json")) as f:
            cli_ranks.append(json.load(f))
    for name, v in cli_ranks[0]["launches"].items():
        launches[f"{name}_rank0"] = v
    emit(phase="cli_ranks", ranks=RANKS,
         exchange="gloo, host-staged, 2 ranks on 1 card", per_rank=cli_ranks)
    emit(phase="cli_done", seconds=time.perf_counter() - t0)

    # -- 9. the kernels line, the card, the result ---------------------------
    def total_launches(name):
        return sum(v.get(name, 0) for v in launches.values())

    rows = []
    every = fused + staged + wired
    for k in [k for k in every if "variant" not in k]:
        row = {"name": k["name"], "route": "cuda", "source": k["source"],
               "replaces": k["replaces"], "body": k["body"],
               "launches": total_launches(k["name"]),
               "launches_by_path": {p: v[k["name"]] for p, v in
                                    launches.items()},
               "max_abs_err": k["max_abs_err"],
               "max_rel_err": k["max_rel_err"], "ms": k["kernel_ms"],
               "kernel_ms": k["kernel_ms"], "plain_ms": k["plain_ms"],
               "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
               "library_ms": k["library_ms"],
               "library_call": k["library_call"], "flops": k["flops"],
               "gemm_flops": k["gemm_flops"], "bytes": k["bytes"],
               "shape": k.get("shape")}
        for f in ("pair_ms", "library_rows_ms", "pass_ms"):
            if f in k:
                row[f] = k[f]
        for v in every:
            if v.get("variant") and v["name"] == k["name"]:
                row[v["variant"]] = {
                    f: v[f] for f in ("body", "shape", "max_abs_err",
                                      "max_rel_err", "kernel_ms", "plain_ms",
                                      "library_ms", "library_call",
                                      "library_rows_ms", "pair_ms", "bound_ms",
                                      "bound_by", "flops", "gemm_flops",
                                      "bytes") if f in v}
        rows.append(row)
    if any(r["launches"] < 1 for r in rows):
        fail(f"a kernel never launched on the main paths: {launches}")
    emit(phase="done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
