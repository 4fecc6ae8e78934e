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
   its output geometries; the 4-point row body it replaced), of the
   batched 64 x 4096 x 4096 stack (the 8-point short stage of y and x,
   kernel 4's column body on x), the fused-wire kernels 9-11 at the per-rank shapes of a 1024^3 plan
   over four ranks (9 and 10 bit for bit, NaN and Inf included); kernel
   6 at (512, 480, 480) and (512, 448, 448), kernel 4 at n2 = 320 (n1 =
   2), 480 (n1 = 9, the 8 x 4320^2 plan's x axis), 448 and 416 (n1 = 2,
   an 896- and an 832-point axis), kernel 8 at (512, 480, 480) and (512,
   448, 448), kernel 1 on 131072 rows of 480 and kernel 2 at 480, 448 and
   440 on the row FFT engine's mixed-radix kernel (checked only: kernel 8
   at the odd Z of (512, 250, 375), kernel 1 on 4097 rows of 375);
   kernels 1, 2, 3, 4, 5, 6, 7, 8 and 11 also on their other body (dense
   or tile) at a shape the engine does not take (kernels 6 and 8 at 442,
   kernel 4 at n2 = 408, kernels 1, 2 and 3 at 442, kernel 7 at 480);
   kernel 3 past the direct lengths: its packed body (the m = n/2-point
   inverse of a packed spectrum on the engine) at the 2048 x 256 x 2048
   plan's z inverse and the 64 x 896^2 and 64 x 832^2 stacks' y inverse,
   its pack pass at the 64 x 4096^2 stack's y inverse and the 4320
   convolution's, each row's launches on the main paths counted by its
   entry point;
2. runs a small cube against numpy, then the single-card slab plan at
   512^3 (fused kernels), at 480^3 and at 448^3 (kernels 6 and 8 on the
   mixed-radix engine, kernel 7 dense), at 1024^3 (per-axis
   kernels 1, 2 and 3, every axis one launch of the row FFT engine, y and
   x where they lie) and at
   2048 x 256 x 2048 (x and z split four-step, 4 x 512: kernels 4, 5 and
   2, x where it lies; the z C2R one launch of kernel 3's packed body):
   ``exec_r2c`` then
   ``exec_c2r``, checked against ``torch.fft`` and the input, with the
   launch counts of every kernel and the entry point (the body) of every
   launch, each direction counted from zero;
3. runs what the ``"pallas"`` backend hands the matmul backend
   (``ops/mxu_fft.py``; no kernel of the port, its dispatches counted):
   the single-card float64 plan at 512^3 and 1024^3 against
   ``torch.fft`` in float64 (``F64_TOL``), with its peak memory, and a
   1031-point prime axis in float32; then the ``"matmul"`` backends at
   512^3 under HIGHEST, HIGH, DEFAULT and ``"matmul-r2"``, and that
   HIGHEST refuses TF32;
4. runs the distributed slab plan at 512^3 as two ranks sharing the card
   over a gloo group (``torch.multiprocessing.spawn``; gloo stages the
   exchange through the host): the all-to-all, then the ring renderings
   (RING, RING_OVERLAP with the bf16 wire, without and with the fused wire
   of kernels 9-11, at depth 3 with two sub-blocks, and ``Z_Then_YX``),
   then opt 1, the pipelined all-to-all (depth 2 and 3, native and bf16
   wire) and STREAMS (ALL2ALL and PEER2PEER, 4 pieces), each rank checking
   its launches and their entry points per direction and each plan
   against ``torch.fft`` and, bit for bit, against the plans it must
   equal;
5. times each kernel, its plain version and one PyTorch call of the same
   function (kernel 9 also in 50 calls alternated with that call), the plans under "pallas" and "xla", and the exchange of each
   rendering with its wire bytes; one run of each direction of the fused
   and per-axis plans under ``torch.profiler`` names the device time op by
   op and gives the device's idle share. A per-axis plan fails if the ops
   of its dispatch (copies, transposes: every aten op with device time)
   take more than its limit in either direction: ``COPY_LIMIT_MS`` at
   1024^3, and at 2048 x 256 x 2048 the limits ``split_copy_limits``
   computes from the bytes of the copies that remain;
6. runs the port's executables in this process, as a user would call them
   (``cli.slab.main`` / ``cli.reference.main``): the slab executable's
   testcases 0-4 at 1024^3 (the per-axis kernels) and testcases 0 and 4 at
   512^3 (the fused kernels) under "pallas" and "xla", testcase 1 with the
   host's float64 truth at 128^3, the reference executable's testcase 0 at
   512^3, and ``-d --fft-backend pallas`` (the matmul backend) testcases
   0-4 at 512^3; then, as two spawned ranks over gloo, the slab executable
   at 512^3 over both exchanges (Peer2Peer and All2All, testcases 3 and
   0) and with ``-o 1``, ``-snd Streams`` and ``-comm All2All
   --overlap-subblocks 2`` (testcase 0), the renderings' bit equality and
   the reference executable's bandwidth probe. Each run's launches and
   entry points are counted from zero and held against the plan phases';
   testcases 1 and 3 hold within TOL of their reference magnitude,
   testcase 4 too or, where float32 cannot, within twice cuFFT's error
   (``gate_cli_results``); every phase CSV parses with the port's reader,
   and its means stand beside ``plan_time``'s;
7. runs the pencil plan: one rank on the card at 1024^3 at depths 1, 2 and
   3 (per axis: kernels 1, 2 and 3, never 6-8), then a 2 x 2 grid as four
   ranks sharing the card over gloo (two sub-groups each): at 512^3
   (``PENCIL_FULL_N``) the reference's default exchange (Peer2Peer +
   Sync) and the all-to-all at
   opt 1, each rank's block against torch.fft.rfftn (the ranks draw the
   reference in turn) with the exchange time of each transpose (one run
   after a warm-up each), the wire bytes and the peak memory; at 512^3
   every rendering of
   ``PENCIL_PATHS`` (Peer2Peer, the all-to-all at opt 0 and 1, mixed
   comm methods, the pipelined all-to-all, STREAMS under both, the rings,
   the bf16 wire with and without the fused wire of kernels 9 and 10,
   depths 1 and 2), bit for bit the monolithic all-to-all; and the
   executables: ``dfft-torch-pencil`` testcases 3 and 0 at 512^3 for
   both exchanges and ``dfft-torch-reference`` testcases 2 and 3 (the 2D
   and 3D geometries) at 512^3.

8. runs the batched-2D plan (BASELINE config #4): on one card the
   64 x 4096 x 4096 stack under "pallas" (every 4096 axis split 8 x 512:
   kernels 5, 4 and 2's short stage; the y C2R kernel 3's pack pass and
   the 2048 = 4 x 512-point complex inverse) as a whole and with
   ``batch_chunk=1`` (bit-equal to the
   whole stack), 256 x 1024 x 1024 (kernels 1, 2 and 3), 256 x 480 x 480
   and 256 x 440 x 440 (x on kernel 2's FFT body, the mixed-radix kernel)
   and 64 x 896 x 896 and 64 x 832 x 832 (both axes split 2 x 448 or 2 x
   416, kernel 4 on the mixed-radix kernel, the y C2R kernel 3's packed
   body at 448 or 416), the four last failing unless
   kernels 2 and 4, and kernels 1 and 3 (the 480 and 440 stacks' y R2C
   and C2R) or 5 (the 896 and 832 forwards' first stage), ran there on
   the mixed-radix kernel and none of kernels 1-5 on its tile body, each
   against
   ``torch.fft.rfft2`` and beside "xla", with peak
   memory and a profile of each direction; ``dfft-torch-batched``
   testcases 0 and 3 at 64 x 4096^2, whole and one image at a time; then
   two ranks sharing the card over gloo: ``shard="batch"`` at 64 x 4096^2
   (32 images a rank), ``shard="x"`` at 8 x 4096^2 (All2All and
   Peer2Peer, bit-equal), every exchange rendering at 16 x 512^2
   (bit-equal to the all-to-all; the fused wire of kernels 9 and 10 to
   the plain bf16 wire) and the executable with ``--shard x``;
9. runs the Bluestein backend (``fft_backend="bluestein"``, no kernel of
   the port: the chirp-z identity over ``torch.fft``): 64 x 4093 x 4093
   (both axes prime) at ``batch_chunk=8`` against float64
   ``torch.fft.rfft2``, beside "xla", float64 on one chunk, the whole
   stack where its estimated peak fits; the 521^3 slab plan on one rank;
   the smooth 512^3 plan bit-equal to "xla";
10. runs the resilience layer: the guards on the 512^3 and 1024^3
   single-card plans (off, check, enforce: bit-equal outputs, the same
   launches and entry points, no violation; ms per direction beside the
   guard's bound; peak memory within 1% of off), and beside PR 13's
   unguarded times; in the two-rank 512^3 world, each wire fault (NaN,
   a bit flip aimed at a value it makes visible, 0.5x) under enforce on
   both exchanges (one verdict on both ranks), check counting, a bf16
   wire over its budget demoted to native, the fused-wire ring (kernels
   9-11) under NaN, a failing ring walking the ladder to the all-to-all's
   bits, a failing launch's ``KernelError`` never demoted, the
   collectives beside the exchange (none on the default plan; the
   ladder's agreement on a ring, timed); enforce under NaN on the
   pencil's four ranks and the batched plan's two;
11. runs ``--selftest`` through the slab executable at 1024^3 and 128^3
   (the host reference only at 128^3) and, on two ranks under
   ``wire:nan``, exits 1 with ``selftest: FAIL``, a valid event log
   carrying the fault and the violation (``--obs --obs-dir``) and, under
   ``--guards enforce``, a flight-recorder dump;
12. runs the solvers (``solvers/``, ``testing/workloads.py``) under
   "pallas": Poisson at 1024^3 (the manufactured solution, integer mode
   against "xla", one forward and one inverse of the plan's launches a
   solve, ``poisson_chain``), Navier-Stokes 3D at 512^3 (Taylor-Green on
   the fused kernels, against "xla", inviscid energy), the convolution of
   64 x 4064^2 images with a 33^2 kernel on the 64 x 4096^2 batched plan
   (against "xla" and direct float64 sums) and at a 5-smooth 4320 extent,
   ``ns2d_chain`` at 16 x 4096^2, ``dctn`` / ``dstn`` at 512^3; the
   gradients (Poisson ``solve_fn`` under "xla" at 512^3, NS-2D against
   central differences, the "pallas" backward raising); and two ranks
   sharing the card: Poisson at 512^3 against one card, a Dirichlet box
   extended on the split axis, the guarded bf16-wire solve on a ring
   (kernels 9-11) and the roundtrip's gradient across the ranks;
13. runs the autotune, wisdom and persistence slice (``wisdom_phase``;
   ``wisdom_only()`` runs it alone): the 512 x 512 x 1024 slab plan with
   ``fft_backend="auto"`` (every candidate's time and error, the
   "pallas" cell on kernels 1-3, the winner against ``torch.fft``, the
   second construction racing nothing), the 8 x 4320^2 batched plan's
   race (kernels 2, 4 and 5) beside both backends' plan
   times, on two ranks the all-"auto" comm and wire race at 256^3 (the
   fused wire's twins on kernels 9 and 10, equal Configs on both ranks,
   the comm record, a second construction racing nothing), the fraction
   chain (``dfft-torch-reference -t 4``) and a check-mode wire demotion
   under ``wire:nan`` stamping the record the next construction re-races;
   ``dfft-torch-reference --autotune`` at 1024^3 and ``dfft-torch-slab
   -comm auto --fft-backend auto`` at 512^3; NS-3D at 512^3 on kernels
   6-8: 2 steps, a checkpoint, restore, 2 steps bit-equal to 4 straight
   ones, a corrupted newest generation falling back one, the write, read
   and CRC32C rates of the 1.62 GB state;
14. runs the serving layer (``serve_phase``; ``serve_only()`` runs it
   alone): a one-rank ``Server`` (max_coalesce 8, batch_chunk 1) prewarms
   the 4096^2 buckets and a 512^3 volume; 4096^2 replies against
   ``torch.fft`` (kernels 2, 4 and 5 only), eight coalesced replies bit
   for bit their single shots; 512^3 (kernels 6-8) and 1024^3 (kernels
   1-3) volumes; ``serve_load`` drives at 0.7x and 1.5x the throughput of
   the warm batch of eight (latencies, outcomes, the split of a request's
   time) and one under the profiler (the device's idle share); an NS-3D
   512^3 resident steps beside a drive, checkpoints on drain and resumes
   bit-equal; ``dfft-torch-serve --http`` as a child (healthz, readyz,
   metrics validated, one POST of a 4096^2 image); ``dfft-torch-solve``
   NS-2D 16 x 4096^2 resumed bit-equal; two ranks sharing the card as a
   leader and a follower (the 512^3 volume bit for bit the direct plan,
   ``shard="x"`` 1024^2 images and a 256^3 c2c volume on the fused bf16
   ring: kernels 9-11; each rank's idle share); and the profile capture of
   the 1024^3 plan and of one NS-3D 512^3 step, ms per ``dfft/...`` scope;
15. runs the serving fleet (``fleet_phase``; ``fleet_only()`` runs it and
   16 alone): fleet A, two one-rank worker processes (coalescing 8,
   ``batch_chunk=1``, tenants gold:free 3:1) prewarmed on a 4096^2 and a
   4096 x 2048 image (one key a worker) and 512^3: single requests bit for
   bit the in-process ``Server``'s and within TOL of ``torch.fft``, the
   workers' summed launches and entry points equal to that Server's for
   the same requests (kernels 2, 4, 5, 6-8), a burst for the fleet's
   capacity, open-loop drives at 0.7x and 1.5x of it (the second over the
   tenants), a request's time through the fleet against the in-process
   Server's (the pipe); fleet B, one worker under a ``ScaleController``
   1:3 growing under load, then ``worker:crash:3@seed=1``; fleet C,
   ``worker:hang``; both with every request answered; fleet D,
   ``worker_devices=[2, 0]`` on the fused bf16 ring: the two-rank worker
   (a leader and a follower process over gloo) takes the 512^3 volume and
   1024^2 images (kernels 9-11, its ranks' counts gathered) and hosts an
   NS-3D 256^3 resident, then ``worker:devloss:1@seed=0`` brings it back
   one rank short, restoring the resident with ``persist.degraded_restore``
   (kernels 6-8); no matmul dispatch, no worker JAX, and no process of any
   worker alive after each ``close``;
16. runs evaluation and launch: the matmul backend's chain-timed
   roundtrips (``testing/chaintimer.py``) at 128^3-512^3 written in
   ``roofline_rows``' CSV schema and rendered by ``dfft-torch-roofline
   --csv`` on H100 peaks; ``dfft-torch-launch`` on a job of
   ``dfft-torch-slab`` at 512^3 under "pallas", reduced by
   ``dfft-torch-eval``, whose fused mean holds within 10% of
   ``plan_time``'s;
17. runs the static analysis and the stage profile (``analysis_phase``;
   ``analysis_only()`` runs it alone): ``dfft-torch-verify --fft-backend
   pallas`` on the card (its single-device combos, each trace holding
   every launch the kernels counted; the pins, schedules and source
   lints), ``stage_profile`` of the 1024^3 slab (kernels 1-3) and the
   512^3 fused plan (kernels 6-8) in both directions, every declared node
   attributed and the nodes' ms within 10% of the capture's busy ms,
   each node's ms, ideal ms and gap printed; ``dfft-torch-explain`` of
   the 1024^3 slab under "pallas" (its contract line PASS); then two
   ranks sharing the card over gloo: every slab rendering of the verify
   matrix on both wires and in both directions under "pallas", and the
   stage profile of the 256^3 fused bf16 ring (``Z_Then_YX``: kernels
   9-11).

Phases print JSON lines. Before the last line come one
``{"matmul_backend": ...}`` line (the matmul backend is no kernel), one
``{"kernels": ...}`` line and the card's name and power limit as
``nvidia-smi`` gives them; the last line is ``{"ok": true, "device":
{...}}``. Any failed phase raises, so
the script exits non-zero with no result line; so does a machine without a
CUDA device, or a directory without the port. On the way out it stops
every process it started (the ranks, multiprocessing's resource tracker)
and any descendant they left behind (the fleets' workers and their
followers among them). Takes about 900 s on an H100, the kernels' build
(25-55 s), the matmul backend's phase (about 10 s), the executables'
phase (about 60 s, most of it the host's random draws), the pencil's
(about 170 s before its 2 x 2 full-size cube was cut to 512^3, most of it
gloo's host-staged exchanges), the batched and Bluestein phases, the
resilience phases, the solvers' (about 45 s), the wisdom phase's (about
140 s before its local race was cut from 1024^3 to 512 x 512 x 1024, most
of it the matmul candidates of the races), the serving phase's (about
120 s, most of it the host's
copies of 4096^2 images and 1024^3 volumes), the fleet's (about 190 s,
most of it the workers' starts and the pipes' transfers of 512^3
volumes), evaluation's (about 20 s) and the analysis phase's (about 30 s)
included.
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
ALTERNATED_REPS = 50  # kernel 9 beside its library call, alternated
# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3 rate;
# the tensor cores in float64 and in bfloat16 (dense).
FP32_FLOPS = 67e12
HBM_BYTES = 3.35e12
FP64_TC_FLOPS = 67e12
BF16_TC_FLOPS = 989e12
F64_TOL = 1e-10      # the JAX package's float64 bound (tests/test_mxu_fft.py)
DEFAULT_TOL = 2e-3   # one bfloat16 pass (mxu_precision "default"), forward
# Its roundtrip: six one-pass stages, each adding about 2^-9 / 3 of max |x|
# (rms) on uniform input, so about 1e-2 at the maximum over 512^3 points;
# the bound is three times that.
DEFAULT_RT_TOL = 2 ** -5
PRIME = 1031         # a prime axis past the kernels' N_MAX = 1024
PALLAS = "distributedfft_tpu/ops/pallas_fft.py"
BATCHED = (64, 4096, 4096)      # BASELINE config #4: 64 images of 4096^2
BATCHED_DIRECT = (256, 1024, 1024)  # every axis one engine launch (1 GiB)
BATCHED_X = (8, 4096, 4096)     # shard="x" on two ranks: the batch cut to 8
BATCHED_RENDER = (16, 512, 512)  # the shard="x" renderings on two ranks
BLUESTEIN = (64, 4093, 4093)    # both axes prime: chirp length 8192
BLUESTEIN_CHUNK = 8
BLUESTEIN_SLAB = 521            # a prime cube: chirp length 2048
XLA_CHUNK_TOL = 1e-6            # "xla" chunked against the whole stack
MEMORY_SHARE = 0.9              # the whole Bluestein stack runs below this


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


def alternated_ms(torch, fa, fb, reps: int = ALTERNATED_REPS) -> dict:
    """``reps`` calls of fa and of fb alternated (a, b, a, b, ...), each
    timed by its own CUDA events after one warm-up call of each: the
    median and the quartiles of each, and whether a's median exceeds b's
    by more than the spread (half the sum of the two interquartile
    ranges)."""
    fa(), fb()
    torch.cuda.synchronize()
    times = {"a": [], "b": []}
    for _ in range(reps):
        for key, fn in (("a", fa), ("b", fb)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[key].append(start.elapsed_time(end))
    out = {"reps": reps}
    for key in ("a", "b"):
        q1, med, q3 = np.percentile(times[key], [25, 50, 75])
        out[key] = {"median_ms": float(med), "q1_ms": float(q1),
                    "q3_ms": float(q3)}
    spread = ((out["a"]["q3_ms"] - out["a"]["q1_ms"])
              + (out["b"]["q3_ms"] - out["b"]["q1_ms"])) / 2
    out["spread_ms"] = spread
    out["a_slower_beyond_spread"] = bool(
        out["a"]["median_ms"] - out["b"]["median_ms"] > spread)
    return out


def _roofline():
    from distributedfft_tpu_torch.evalkit import roofline
    return roofline


def fft_flops(rows: int, n: int, real: bool = False) -> float:
    """The function's work: the FFT's nominal 5 n log2 n flop per complex
    row of n points, 2.5 n log2 n with real input or output (PERF.md §2's
    GFLOP/s metric; ``evalkit/roofline.py``'s ``fft_flops``)."""
    return _roofline().fft_flops(rows, n, real)


def bound(flops: float, nbytes: float):
    """(bound ms, what bounds it) on the data sheet's peaks: the port's one
    bound rule, ``evalkit/roofline.py``'s ``bound``."""
    return _roofline().bound(flops, nbytes)


# Kernels whose body is a pure function of their shape: the row FFT engine
# or the dense tile loop (hopper_fft._fft_body of the row length for
# kernel 11, hopper_fft._cdft_body for kernels 1-5, which adds the
# engine's mixed-radix kernel at 13-smooth lengths; for kernels 1, 2 and 3
# on rows of at most 16 points the row path of stage.cu's launch; kernels
# 2 and 4 on columns, shape (outer, n, inner), the column kernel, "cols",
# or for kernel 2 on 2..16 points the short-stage kernel, "short"), or,
# for kernels 6, 7 and 8, the engine or the dense kernel
# (hopper_fft._zy_engine_body for kernels 6 and 8, hopper_fft._x_body).
ROUTED = ("rmatmul", "cmatmul", "c2r", "rmatmul_tw", "dec_cmatmul",
          "cmatmul_tw", "zy_fwd", "x_c2c", "yz_inv")


def split_copy_limits(shape):
    """(forward, inverse) limits, in ms, of the device time of the aten ops
    of a single-card per-axis plan whose x and z axes split, set from the
    bytes of the copies its dispatch still makes, at ``COPY_RATE`` of the
    HBM rate, plus ``COPY_MARGIN``; a direction that copies nothing is
    held to ``COPY_LIMIT_MS``, as the 1024^3 plan is. Forward: the swap of
    the real z input (4 bytes a point read and written). Inverse: nothing.
    The z axis's C2R is kernel 3 on the half spectra as they lie (its
    packed body, or its pack pass writing the four-step's first-stage
    layout), whose complex output is the real rows, and the x axis's
    four-step runs where it lies."""
    X, Y, Z = shape
    fwd = 2 * 4 * X * Y * Z
    return tuple(max(COPY_LIMIT_MS,
                     1e3 * b / (COPY_RATE * HBM_BYTES) * COPY_MARGIN)
                 for b in (fwd, 0))


def body_of(hf, k) -> str:
    """The body a kernel row runs: for the routed kernels 1-8 and 11 the
    body of its shape, which must be the row's ``body`` ("fft" unless the
    row names another), else the one body the kernel has."""
    if k["name"] in ROUTED:
        sh = k["shape"]
        if k["name"] == "zy_fwd":
            body = hf._zy_engine_body(sh["Y"], sh["Z"])
        elif k["name"] == "yz_inv":
            body = hf._zy_engine_body(sh["Y"], sh["Z"])
        elif k["name"] == "x_c2c":
            body = hf._x_body(sh["X"])
        elif "inner" in sh and "geometry" in sh:   # the short-stage body
            body = "short" if hf._short_body(sh["n"]) else "none"
        elif "inner" in sh:
            body = "cols" if hf._fft_body(sh["n"]) == "fft" else "none"
        elif k["name"] == "c2r" and "m" in sh:     # past the direct lengths
            body = ("none" if hf._direct(sh["n"]) or sh["n"] % 2
                    else "packed" if hf._engine_length(sh["m"]) else "pack")
        elif k["name"] in ("rmatmul", "cmatmul", "cmatmul_tw", "c2r",
                           "rmatmul_tw"):
            body = hf._cdft_body(sh["n"])
            if body == "tile" and k["name"] in ("rmatmul", "cmatmul",
                                                "c2r") and sh["n"] <= 16:
                body = "row"
        else:
            body = hf._fft_body(sh["n"])
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
    """Count the launches of each (kernel, C entry point) pair while the
    block runs: the body each kernel ran; yields the dict (``per_entry``
    sums it by entry point). Measurement only: the counts in ``LAUNCHES``
    still rise in ``_launch``."""
    orig, seen = hf._launch, {}

    def launch(kernel, fn, *args):
        orig(kernel, fn, *args)
        seen[kernel, fn] = seen.get((kernel, fn), 0) + 1

    hf._launch = launch
    try:
        yield seen
    finally:
        hf._launch = orig


def per_entry(pairs: dict) -> dict:
    """``entry_counts``' launches summed by C entry point."""
    out = {}
    for (_, fn), v in pairs.items():
        out[fn] = out.get(fn, 0) + v
    return out


# The FFT body of kernels 1-5 on rows (at a 13-smooth length the engine's
# mixed-radix kernel).
ENGINE_ENTRY = {"rmatmul": "dfft_rdft", "cmatmul": "dfft_cdft",
                "cmatmul_tw": "dfft_cdft_tw", "c2r": "dfft_c2r",
                "rmatmul_tw": "dfft_rdft_tw"}
# The 4320 = 9 x 480 paths' first stages: kernels 4 and 5.
SPLIT_ENGINE = ("cmatmul_tw", "rmatmul_tw")


def on_the_engine(pairs: dict, what: str, kernels=SPLIT_ENGINE) -> dict:
    """Fail unless each of ``kernels`` (kernel 1, "rmatmul", 2, "cmatmul",
    3, "c2r", 4, "cmatmul_tw", or 5, "rmatmul_tw") ran its FFT body on rows
    (``ENGINE_ENTRY``) and none of kernels 1-5 ever ran its tile body
    (``dfft_stage``); returns ``entry_counts``' pairs as "kernel/entry" ->
    launches."""
    named = {f"{k}/{e}": v for (k, e), v in sorted(pairs.items())}
    if any(pairs.get((k, "dfft_stage")) for k in ENGINE_ENTRY) or \
            not all(pairs.get((k, ENGINE_ENTRY[k])) for k in kernels):
        fail(f"{what}: kernels {kernels} did not run on the engine alone: "
             f"{named}")
    return named


def counted(hf):
    """The kernel launch counts since the last reset, with the matmul
    backend's dispatches (``hf.DISPATCHES``, not a kernel) under "matmul"
    where there were any: a path that must run only kernels then fails its
    comparison with ``expect``."""
    out = dict(hf.LAUNCHES)
    if hf.DISPATCHES["matmul"]:
        out["matmul"] = hf.DISPATCHES["matmul"]
    return out


def directions(plan):
    """(forward, inverse) of a plan: ``exec_r2c`` / ``exec_c2r``, or a
    batched-2D plan's ``exec_forward`` / ``exec_inverse``."""
    if hasattr(plan, "exec_forward"):
        return plan.exec_forward, plan.exec_inverse
    return plan.exec_r2c, plan.exec_c2r


# The C entry points the plans of ``run_counted`` launched in this process,
# summed: the kernels line reads the launches of a body that shares its
# kernel's count (kernel 3's packed body and pack pass) by its entry.
MAIN_ENTRIES: dict = {}


def run_counted(torch, hf, plan, x, dims=None, pairs=None):
    """One forward and one inverse of ``plan`` (a pencil plan's at depth
    ``dims``), each counted from zero: (spectrum, inverse, launches
    forward, launches inverse, entry points forward, entry points
    inverse); the launches as ``counted`` gives them. ``pairs``, a list,
    receives ``entry_counts``' (kernel, entry) pairs of each direction."""
    kw = {} if dims is None else {"dims": dims}
    fwd_fn, inv_fn = directions(plan)
    hf.reset_launches()
    with entry_counts(hf) as ent_f:
        c = fwd_fn(x, **kw)
        torch.cuda.synchronize()
    fwd = counted(hf)
    hf.reset_launches()
    with entry_counts(hf) as ent_i:
        back = inv_fn(c, **kw)
        torch.cuda.synchronize()
    if pairs is not None:
        pairs.extend((ent_f, ent_i))
    for seen in (ent_f, ent_i):
        for e, v in per_entry(seen).items():
            MAIN_ENTRIES[e] = MAIN_ENTRIES.get(e, 0) + v
    return c, back, fwd, counted(hf), per_entry(ent_f), per_entry(ent_i)


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
        if e.key.startswith(("ProfilerStep", "dfft/", "dfft:")):
            continue    # the step's span, the stage scopes and obs spans:
            #             Kineto draws each on the device over its kernels
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

    def wall_ms(fn, reps=3):
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
    out["ring"] = rendering_paths(rank, x, xl, c, back, wall_ms, RING_PATHS,
                                  RING_PAIRS)
    out["exchange_renderings"] = rendering_paths(
        rank, x, xl, c, back, wall_ms, EXCHANGE_PATHS, EXCHANGE_PAIRS)
    t0 = time.perf_counter()
    out["resilience"] = resilience_ranks(torch, dist, dft, hf, rank, xl, c,
                                         wall_ms)
    out["resilience_seconds"] = time.perf_counter() - t0
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
# Bit-equalities of the ring renderings: (rendering, the one it equals or
# None for the all-to-all, "bit" or a tolerance).
RING_PAIRS = [("ring_native", None, "bit"),
              ("ring_overlap_wire16_fused", "ring_overlap_wire16", "bit"),
              ("ring_overlap_wire16_fused_d3_s2", "ring_overlap_wire16_fused",
               "bit"),
              ("z_then_yx_ring_overlap_wire16_fused",
               "z_then_yx_ring_overlap_wire16", TOL)]
# The exchange of these is timed beside the all-to-all's.
EXCHANGE_TIMED = ("ring_native", "ring_overlap_wire16",
                  "ring_overlap_wire16_fused", "a2a_wire16", "opt1",
                  "a2a_pipelined_d2", "a2a_pipelined_d3",
                  "a2a_pipelined_d2_wire16", "a2a_pipelined_d3_wire16",
                  "streams_a2a", "streams_p2p")

# The monolithic renderings beside the all-to-all (ALL2ALL + SYNC, opt 0,
# the native wire), with RING_PATHS' fields: opt 1, the pipelined
# all-to-all (two pieces of the free z axis, depth 2 and 3, native and
# bf16 wire) and STREAMS (4 pieces; under ALL2ALL each piece runs its x
# FFT on the column body after its exchange, forward, and before it,
# inverse).
_STREAMS = {"send_method": "Streams", "streams_chunks": 4}
EXCHANGE_PATHS = {
    "a2a_wire16": ({"wire_dtype": "bf16"}, "ZY_Then_X",
                   dict(rmatmul=1, cmatmul=2), dict(cmatmul=2, c2r=1),
                   *A2A_ENTRIES),
    "opt1": ({"opt": 1}, "ZY_Then_X", dict(rmatmul=1, cmatmul=2),
             dict(cmatmul=2, c2r=1), *A2A_ENTRIES),
    "a2a_pipelined_d2": ({"overlap_subblocks": 2}, "ZY_Then_X",
                         dict(rmatmul=1, cmatmul=2), dict(cmatmul=2, c2r=1),
                         *A2A_ENTRIES),
    "a2a_pipelined_d3": ({"overlap_subblocks": 2, "overlap_depth": 3},
                         "ZY_Then_X", dict(rmatmul=1, cmatmul=2),
                         dict(cmatmul=2, c2r=1), *A2A_ENTRIES),
    "a2a_pipelined_d2_wire16": ({"overlap_subblocks": 2,
                                 "wire_dtype": "bf16"}, "ZY_Then_X",
                                dict(rmatmul=1, cmatmul=2),
                                dict(cmatmul=2, c2r=1), *A2A_ENTRIES),
    "a2a_pipelined_d3_wire16": ({"overlap_subblocks": 2, "overlap_depth": 3,
                                 "wire_dtype": "bf16"}, "ZY_Then_X",
                                dict(rmatmul=1, cmatmul=2),
                                dict(cmatmul=2, c2r=1), *A2A_ENTRIES),
    "streams_a2a": (_STREAMS, "ZY_Then_X", dict(rmatmul=1, cmatmul=5),
                    dict(cmatmul=5, c2r=1),
                    {"dfft_rdft": 1, "dfft_cdft_cols": 5},
                    {"dfft_cdft_cols": 5, "dfft_c2r": 1}),
    "streams_p2p": ({**_STREAMS, "comm_method": "Peer2Peer"}, "ZY_Then_X",
                    dict(rmatmul=1, cmatmul=2), dict(cmatmul=2, c2r=1),
                    *A2A_ENTRIES),
}
EXCHANGE_PAIRS = [("opt1", None, "bit"),
                  ("a2a_pipelined_d2", None, "bit"),
                  ("a2a_pipelined_d3", None, "bit"),
                  ("a2a_pipelined_d2_wire16", "a2a_wire16", "bit"),
                  ("a2a_pipelined_d3_wire16", "a2a_wire16", "bit"),
                  ("streams_a2a", None, "bit"),
                  ("streams_p2p", None, "bit")]


def rendering_paths(rank, x, xl, a2a_fwd, a2a_back, wall_ms, paths, pairs):
    """Run every rendering of ``paths`` (RING_PATHS' fields) on this rank,
    on the same input as the all-to-all plan: launch counts and entry
    points per direction, checks against torch.fft, the bit-equalities of
    ``pairs``, and times (the exchange too, for ``EXCHANGE_TIMED``)."""
    import torch
    import distributedfft_tpu_torch as dft
    from distributedfft_tpu_torch.ops import hopper_fft as hf
    from distributedfft_tpu_torch.parallel import transpose as tr

    out = {"transport": "gloo, staged through pinned host memory"
           if tr._Transport(None, x.device).staged else "device memory"}
    ref = torch.fft.rfftn(x)
    res = {}
    for pid, (fields, seq, want_f, want_i, ent_f_want,
              ent_i_want) in paths.items():
        kw = dict(fields, fft_backend="pallas")
        if "send_method" in kw:
            kw["send_method"] = dft.SendMethod(kw["send_method"])
        if "comm_method" in kw:
            kw["comm_method"] = dft.CommMethod(kw["comm_method"])
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
        row = {"sequence": seq, "config": fields, "launches_forward": fwd,
               "launches_inverse": inv, "entries_forward": ent_f,
               "entries_inverse": ent_i, "forward_vs_torch_fft": f_rel,
               "roundtrip_vs_input": rt_rel, "tol": tol,
               "forward_ms": wall_ms(lambda: plan.exec_r2c(xl)),
               "inverse_ms": wall_ms(lambda: plan.exec_c2r(c))}
        if pid in EXCHANGE_TIMED:
            first, xpose, _ = plan._fwd_parts()
            ifirst, ixpose, _ = plan._inv_parts()
            a, b = first(xl), ifirst(c)
            wire = plan.config.wire_dtype
            row.update(exchange_forward_ms=wall_ms(lambda: xpose(a)),
                       exchange_inverse_ms=wall_ms(lambda: ixpose(b)),
                       wire_bytes_per_rank={
                           d: tr.wire_nbytes(t.shape, t.dtype, wire)
                           * (RANKS - 1) // RANKS
                           for d, t in (("forward", a), ("inverse", b))})
            if plan.config.send_method.is_ring:
                row["schedule_forward"] = tr.ring_schedule(
                    (a.shape[0] * RANKS,) + tuple(a.shape[1:]), a.dtype,
                    wire, RANKS,
                    overlap=plan.config.send_method
                    is dft.SendMethod.RING_OVERLAP,
                    depth=plan.config.resolved_overlap_depth(),
                    subblocks=plan.config.resolved_overlap_subblocks())
            del a, b
        res[pid] = (c, back)
        out[pid] = row
        del plan
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
# The pencil plan: one rank on the card (per axis, with depth), and a 2 x 2
# grid as four spawned ranks sharing the card over gloo
# ---------------------------------------------------------------------------

PENCIL_GRID = (2, 2)
PENCIL_RANKS = 4
# A pencil rank's launches per direction at each depth, and their entry
# points: z on rows (kernel 1, the inverse on kernel 3's C2R Body), y and x
# on kernel 2's column body where they lie after each exchange. The
# single-card pencil (1 x 1) launches the same per axis.
PENCIL_DEPTHS = {
    1: (dict(rmatmul=1), dict(c2r=1), {"dfft_rdft": 1}, {"dfft_c2r": 1}),
    2: (dict(rmatmul=1, cmatmul=1), dict(cmatmul=1, c2r=1),
        {"dfft_rdft": 1, "dfft_cdft_cols": 1},
        {"dfft_cdft_cols": 1, "dfft_c2r": 1}),
    3: (dict(rmatmul=1, cmatmul=2), dict(cmatmul=2, c2r=1), *A2A_ENTRIES),
}
# The full-size pencil over 2 x 2: the reference's default exchange
# (Peer2Peer + Sync on both transposes) and the all-to-all at opt 1: id ->
# (Config fields, executable flags). Its cube is PENCIL_FULL_N^3 (cut from
# 1024^3: four ranks staging every block through the host took 71 s of
# the script there), each of its times is one run after a warm-up
# (PENCIL_FULL_REPS), and the executable runs both exchanges at
# PENCIL_CLI_N: the depth cuts that keep the whole script within its time
# limit.
PENCIL_FULL_N = N
PENCIL_FULL_REPS = 1
PENCIL_CLI_N = N
_PP = {"comm_method": "Peer2Peer"}
PENCIL_FULL = {
    "p2p": (_PP, []),
    "a2a_opt1": ({"comm_method": "All2All", "comm_method2": "All2All",
                  "opt": 1},
                 ["-comm1", "All2All", "-comm2", "All2All", "-o", "1"]),
}
# The renderings at 512^3 over 2 x 2: id -> (Config fields, depth, launches
# forward, inverse, entry points forward, inverse). STREAMS under ALL2ALL
# runs each piece's next FFT after its exchange: y on 4 pieces of x and x
# on 4 pieces of z forward; inverse, x on the whole block, then y on 4
# pieces of z and the z C2R on 4 pieces of x. On the fused wire each
# transpose is one ring step (two ranks a group): one encode (kernel 9)
# and one unpack-only arrival (kernel 10) each.
_P3 = PENCIL_DEPTHS[3]
_PRO16 = {"send_method": "RingOverlap", "wire_dtype": "bf16"}
PENCIL_PATHS = {
    "a2a": ({"comm_method": "All2All"}, 3, *_P3),
    "p2p_p2p": (_PP, 3, *_P3),
    "a2a_p2p": ({"comm_method": "All2All", "comm_method2": "Peer2Peer"}, 3,
                *_P3),
    "opt1": ({"comm_method": "All2All", "opt": 1}, 3, *_P3),
    "a2a_pipelined": ({"comm_method": "All2All", "overlap_subblocks": 2}, 3,
                      *_P3),
    "streams_a2a": ({"comm_method": "All2All", "send_method": "Streams",
                     "streams_chunks": 4}, 3,
                    dict(rmatmul=1, cmatmul=8), dict(cmatmul=5, c2r=4),
                    {"dfft_rdft": 1, "dfft_cdft_cols": 8},
                    {"dfft_cdft_cols": 5, "dfft_c2r": 4}),
    "streams_p2p": ({**_PP, "send_method": "Streams", "streams_chunks": 4},
                    3, *_P3),
    "ring": ({"send_method": "Ring"}, 3, *_P3),
    "ring_overlap": ({"send_method": "RingOverlap"}, 3, *_P3),
    "ring_overlap_wire16": (_PRO16, 3, *_P3),
    "ring_overlap_wire16_fused": (
        {**_PRO16, "fused_wire": True}, 3,
        dict(rmatmul=1, cmatmul=2, enc_pack=2, dec_unpack=2),
        dict(cmatmul=2, c2r=1, enc_pack=2, dec_unpack=2),
        *_plus(A2A_ENTRIES, enc_pack=2, dec_unpack=2)),
    "p2p_dims1": (_PP, 1, *PENCIL_DEPTHS[1]),
    "p2p_dims2": (_PP, 2, *PENCIL_DEPTHS[2]),
}
# Bit-equalities of the renderings: every one runs the kernels on the same
# columns and rows as the monolithic all-to-all.
PENCIL_PAIRS = [(pid, "a2a") for pid in (
    "p2p_p2p", "a2a_p2p", "opt1", "a2a_pipelined", "streams_a2a",
    "streams_p2p", "ring", "ring_overlap")] + [
    ("ring_overlap_wire16_fused", "ring_overlap_wire16")]


def pencil_config(dft, fields, **more):
    """The port's Config of a pencil path's fields under "pallas"."""
    kw = dict(fields, fft_backend="pallas", **more)
    for k, enum in (("send_method", dft.SendMethod),
                    ("comm_method", dft.CommMethod),
                    ("comm_method2", dft.CommMethod)):
        if k in kw:
            kw[k] = enum.parse(kw[k])
    return dft.Config(**kw)


def barrier_ms(torch, dist, fn, reps: int = 3) -> float:
    """Median host wall time of fn on every rank at once: each run starts
    after a barrier and ends on the rank's own synchronize."""
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


def pencil_single_card(torch, dft, hf, gen):
    """The 1 x 1 pencil at 1024^3 at depths 1, 2 and 3: launches and entry
    points per direction (kernels 1, 2 and 3 per axis, never the fused 3D
    kernels), forward against torch.fft and the roundtrip against the
    input over the transformed extents, and times. Returns (launches by
    path, rows)."""
    shape = (NBIG,) * 3
    x = torch.randn(shape, generator=gen, device="cuda")
    plan = dft.PencilFFTPlan(dft.GlobalSize(*shape), dft.PencilPartition(1, 1),
                             dft.Config(fft_backend="pallas"))
    launches, rows = {}, {}
    ref = torch.fft.rfft(x, dim=2)
    for d in (1, 2, 3):
        if d > 1:
            ref = torch.fft.fft(ref, dim=3 - d)
        torch.cuda.reset_peak_memory_stats()
        c, back, fwd, inv, ent_f, ent_i = run_counted(torch, hf, plan, x,
                                                      dims=d)
        want_f, want_i, ent_f_want, ent_i_want = PENCIL_DEPTHS[d]
        if fwd != expect(hf, **want_f) or inv != expect(hf, **want_i) or \
                (ent_f, ent_i) != (ent_f_want, ent_i_want):
            fail(f"pencil 1x1 dims {d}: launches forward {fwd} (entries "
                 f"{ent_f}), inverse {inv} (entries {ent_i})")
        _, f_rel = rel_err(c, ref)
        back /= float(NBIG ** d)
        _, rt_rel = rel_err(back, x)
        del back
        if not (f_rel <= TOL and rt_rel <= TOL):
            fail(f"pencil 1x1 dims {d}: forward rel {f_rel:.3e}, roundtrip "
                 f"rel {rt_rel:.3e}")
        row = dict(dims=d, launches_forward=fwd, launches_inverse=inv,
                   entries_forward=ent_f, entries_inverse=ent_i,
                   forward_vs_torch_fft=f_rel, roundtrip_vs_input=rt_rel,
                   peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                   forward_ms=median_ms(
                       torch, lambda: plan.exec_r2c(x, d), REPS_BIG, 1),
                   inverse_ms=median_ms(
                       torch, lambda: plan.exec_c2r(c, d), REPS_BIG, 1))
        emit(phase="main_path", path=f"pencil_1x1_dims{d}", **row)
        launches[f"pencil_1x1_dims{d}"] = {k: fwd[k] + inv[k] for k in fwd}
        rows[d] = row
        del c
        torch.cuda.empty_cache()
    del x, ref, plan
    torch.cuda.empty_cache()
    return launches, rows


def pencil_input(torch, dist, plan, n: int, rank: int):
    """This rank's block of a random n^3 cube drawn on the card from one
    seed, and the same block of the cube's torch.fft.rfftn. The ranks draw
    in turn, so one full spectrum is on the card at a time."""
    xl = ref = None
    for turn in range(PENCIL_RANKS):
        if turn == rank:
            gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
            x = torch.randn((n,) * 3, generator=gen, device="cuda")
            xl = plan.pad_input(x)
            ref = plan.pad_spectral(torch.fft.rfftn(x))
            del x
            torch.cuda.empty_cache()
        dist.barrier()
    return xl, ref


def pencil_full(torch, dist, dft, hf, tr, rank: int):
    """The pencil at PENCIL_FULL_N^3 on 2 x 2 (``PENCIL_FULL``): each rank's
    launches and entry points per direction, its forward block against
    torch.fft.rfftn and its roundtrip block against the input, the times
    of each direction and of each transpose alone, the wire bytes and the
    peak memory."""
    n = PENCIL_FULL_N
    g = dft.GlobalSize(n, n, n)
    part = dft.PencilPartition(*PENCIL_GRID)
    out, xl, ref = {}, None, None
    for pid, (fields, _) in PENCIL_FULL.items():
        plan = dft.PencilFFTPlan(g, part, pencil_config(dft, fields))
        if xl is None:
            xl, ref = pencil_input(torch, dist, plan, n, rank)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        c, back, fwd, inv, ent_f, ent_i = run_counted(torch, hf, plan, xl)
        peak = torch.cuda.max_memory_allocated() / 1e9
        want_f, want_i, ent_f_want, ent_i_want = _P3
        if fwd != expect(hf, **want_f) or inv != expect(hf, **want_i) or \
                (ent_f, ent_i) != (ent_f_want, ent_i_want):
            fail(f"rank {rank} pencil {pid}: launches forward {fwd} "
                 f"(entries {ent_f}), inverse {inv} (entries {ent_i})")
        _, f_rel = rel_err(c, ref)
        back /= float(n ** 3)
        _, rt_rel = rel_err(back, xl)
        del back
        if not (f_rel <= TOL and rt_rel <= TOL):
            fail(f"rank {rank} pencil {pid}: forward rel {f_rel:.3e}, "
                 f"roundtrip rel {rt_rel:.3e}")
        row = dict(config=fields, coords=list(plan.coords),
                   local_input_shape=list(plan.local_input_shape),
                   local_output_shape=list(plan.local_output_shape),
                   launches_forward=fwd, launches_inverse=inv,
                   entries_forward=ent_f, entries_inverse=ent_i,
                   forward_vs_torch_fft=f_rel, roundtrip_vs_input=rt_rel,
                   peak_memory_gb=peak,
                   forward_ms=barrier_ms(torch, dist,
                                         lambda: plan.exec_r2c(xl),
                                         PENCIL_FULL_REPS),
                   inverse_ms=barrier_ms(torch, dist,
                                         lambda: plan.exec_c2r(c),
                                         PENCIL_FULL_REPS))
        # Each transpose alone, on the block the plan hands it, and the
        # bytes this rank sends over its group (two ranks: half the block).
        s, i = plan._fwd_ffts(3), plan._inv_ffts()
        a = s[0](xl)
        t1 = plan._xpose(1, False)
        b = s[1](t1(a))
        t2 = plan._xpose(2, False)
        ms = {"transpose1_forward": barrier_ms(torch, dist, lambda: t1(a),
                                               PENCIL_FULL_REPS),
              "transpose2_forward": barrier_ms(torch, dist, lambda: t2(b),
                                               PENCIL_FULL_REPS)}
        sent = {"transpose1": a.numel() * a.element_size() // 2,
                "transpose2": b.numel() * b.element_size() // 2}
        del a, b
        ia = i[3](c)
        t2b = plan._xpose(2, True)
        ib = i[2](t2b(ia))
        t1b = plan._xpose(1, True)
        ms.update(
            transpose2_inverse=barrier_ms(torch, dist, lambda: t2b(ia),
                                          PENCIL_FULL_REPS),
            transpose1_inverse=barrier_ms(torch, dist, lambda: t1b(ib),
                                          PENCIL_FULL_REPS))
        del ia, ib
        row.update(exchange_ms=ms, wire_bytes_per_rank=sent,
                   transport="gloo, staged through the host"
                   if tr._Transport(plan.row_group, xl.device).staged
                   else "device memory")
        for name, fn in (("forward", lambda: plan.exec_r2c(xl)),
                         ("inverse", lambda: plan.exec_c2r(c))):
            _, per = kernel_share(torch, hf, fn)
            row[f"{name}_kernel_ms"] = per
        out[pid] = row
        del c, plan
        torch.cuda.empty_cache()
    del xl, ref
    torch.cuda.empty_cache()
    return out


def pencil_renderings(torch, dist, dft, hf, rank: int):
    """Every rendering of ``PENCIL_PATHS`` at 512^3 on 2 x 2: launches and
    entry points per direction, the forward block against torch.fft at
    its depth, the roundtrip against the input, the bit-equalities of
    ``PENCIL_PAIRS`` and each direction's time."""
    g = dft.GlobalSize(N, N, N)
    part = dft.PencilPartition(*PENCIL_GRID)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    x = torch.randn((N,) * 3, generator=gen, device="cuda")
    refs = {1: torch.fft.rfft(x, dim=2)}
    refs[2] = torch.fft.fft(refs[1], dim=1)
    refs[3] = torch.fft.fft(refs[2], dim=0)
    out, res = {}, {}
    for pid, (fields, d, want_f, want_i, ent_f_want,
              ent_i_want) in PENCIL_PATHS.items():
        plan = dft.PencilFFTPlan(g, part, pencil_config(dft, fields))
        xl = plan.pad_input(x)
        c, back, fwd, inv, ent_f, ent_i = run_counted(torch, hf, plan, xl,
                                                      dims=d)
        if fwd != expect(hf, **want_f) or inv != expect(hf, **want_i) or \
                (ent_f, ent_i) != (ent_f_want, ent_i_want):
            fail(f"rank {rank} pencil {pid}: launches forward {fwd} "
                 f"(entries {ent_f}), inverse {inv} (entries {ent_i}); "
                 f"expected {want_f} ({ent_f_want}), {want_i} "
                 f"({ent_i_want})")
        tol = WIRE16_TOL if plan.config.wire_dtype == "bf16" else TOL
        _, f_rel = rel_err(c, plan.pad_spectral(refs[d], d))
        _, rt_rel = rel_err(back / float(N ** d), xl)
        if not (f_rel <= tol and rt_rel <= tol):
            fail(f"rank {rank} pencil {pid}: forward rel {f_rel:.3e}, "
                 f"roundtrip rel {rt_rel:.3e} (tol {tol})")
        out[pid] = dict(config=fields, dims=d, launches_forward=fwd,
                        launches_inverse=inv, entries_forward=ent_f,
                        entries_inverse=ent_i, forward_vs_torch_fft=f_rel,
                        roundtrip_vs_input=rt_rel, tol=tol,
                        forward_ms=barrier_ms(
                            torch, dist, lambda: plan.exec_r2c(xl, d)),
                        inverse_ms=barrier_ms(
                            torch, dist, lambda: plan.exec_c2r(c, d)))
        res[pid] = (c, back)
        del plan, xl
    for pid, other in PENCIL_PAIRS:
        ok = all(torch.equal(g_, w) for g_, w in zip(res[pid], res[other]))
        out[f"{pid}_equals_{other}"] = ok
        if not ok:
            errs = [rel_err(g_, w)[1] for g_, w in zip(res[pid], res[other])]
            fail(f"rank {rank}: pencil {pid} is not bit-equal to {other} "
                 f"(rel {max(errs):.3e})")
    del res, refs, x
    torch.cuda.empty_cache()
    return out


def pencil_csv_name(argv) -> str:
    """Where the pencil executable writes the CSV of ``argv``, under its
    ``-b`` directory (the CPU tests hold it equal to the JAX
    executable's)."""
    from distributedfft_tpu_torch import params as pm
    from distributedfft_tpu_torch.cli import common
    from distributedfft_tpu_torch.cli import pencil as cli_pencil
    from distributedfft_tpu_torch.utils.timer import benchmark_filename
    args = cli_pencil.build_parser().parse_args(argv)
    cfg = pm.Config(
        comm_method=pm.CommMethod.parse(args.comm_method1),
        send_method=pm.SendMethod.parse(args.send_method1),
        comm_method2=(pm.CommMethod.parse(args.comm_method2)
                      if args.comm_method2 else None),
        **common.config_kwargs(args))
    g = pm.GlobalSize(args.input_dim_x, args.input_dim_y, args.input_dim_z)
    return os.path.relpath(benchmark_filename(
        args.benchmark_dir, "pencil", cfg, g, PENCIL_RANKS,
        pencil_grid=(args.partition1, args.partition2)), args.benchmark_dir)


def csv_rank_means(bdir):
    """Each rank's mean "Run complete" and fused ms over the blocks of the
    one CSV under ``bdir``."""
    import glob
    from distributedfft_tpu_torch.testing.testcases import FUSED_DESC
    from distributedfft_tpu_torch.utils.timer import read_timer_csv
    blocks = read_timer_csv(glob.glob(os.path.join(bdir, "*", "*.csv"))[0])
    ranks = range(len(blocks[0]["Run complete"]))
    return {"run_complete_ms": [statistics.mean(b["Run complete"][r]
                                                for b in blocks)
                                for r in ranks],
            "fused_ms": [statistics.mean(b[FUSED_DESC][r]
                                         - b["Run complete"][r]
                                         for b in blocks) for r in ranks]}


def pencil_cli(torch, dist, dft, hf, rank: int, outdir: str):
    """``dfft-torch-pencil`` at PENCIL_CLI_N^3 on 2 x 2 under "pallas",
    testcases 3 and 0, for each exchange of ``PENCIL_FULL``, and
    ``dfft-torch-reference`` testcases 2 and 3 at 512^3 over the four
    ranks: launches and entry points against the plan's, testcase 3's
    result within TOL of N, each CSV's name, sections and per-rank means,
    the probes' rates."""
    from distributedfft_tpu_torch.cli import pencil as cli_pencil
    from distributedfft_tpu_torch.cli import reference as cli_ref
    sections = dft.PencilFFTPlan(
        dft.GlobalSize(8, 8, 8), dft.PencilPartition(1, 1), None,
        device="cuda").section_descriptions
    out = {"runs": [], "launches": {}}
    for rid, (_, flags) in PENCIL_FULL.items():
        for tc, (args, blocks, k_f, k_i) in CLI_RANK_CASES.items():
            bdir = os.path.join(outdir, f"pencil_{rid}_t{tc}")
            n = PENCIL_CLI_N
            argv = ["-nx", str(n), "-ny", str(n), "-nz", str(n),
                    "-p1", str(PENCIL_GRID[0]), "-p2", str(PENCIL_GRID[1]),
                    "--fft-backend", "pallas", "-b", bdir] + flags + args
            text, got, ent, secs = cli_run(torch, hf, cli_pencil.main, argv)
            want = scaled(_P3[0], k_f, _P3[1], k_i)
            ent_want = scaled(_P3[2], k_f, _P3[3], k_i)
            if got != expect(hf, **want) or ent != ent_want:
                fail(f"rank {rank} pencil {argv}: launches {got} (entries "
                     f"{ent}), expected {want} ({ent_want})")
            out["launches"][f"cli_pencil_{rid}_{n}_t{tc}"] = got
            row = dict(rendering=rid, testcase=tc, argv=argv, seconds=secs,
                       entries=ent)
            dist.barrier()      # rank 0 has written the CSV
            if rank == 0:
                val, rel = cli_result(tc, text, n ** 3, 0.0)
                if rel is not None and rel > TOL:
                    fail(f"pencil {argv}: {val} is {rel} of N")
                name, run_ms, fused_ms = cli_csv(bdir, sections, blocks,
                                                 PENCIL_RANKS)
                if name != pencil_csv_name(argv):
                    fail(f"pencil {argv} wrote {name}, not "
                         f"{pencil_csv_name(argv)}")
                row.update(csv=name, result=val, result_rel=rel,
                           per_rank=csv_rank_means(bdir),
                           printed=text.strip().splitlines())
            out["runs"].append(row)
            torch.cuda.empty_cache()
    for tc, geometry in ((2, "2d"), (3, "3d")):
        for o in ("0", "1"):
            argv = ["-nx", str(N), "-ny", str(N), "-nz", str(N), "-t",
                    str(tc), "-o", o, "-i", "3", "-w", "1"]
            text, got, _, secs = cli_run(torch, hf, cli_ref.main, argv)
            if any(got.values()):
                fail(f"rank {rank} reference {argv} launched kernels: {got}")
            if rank == 0:
                line = next(ln for ln in text.splitlines()
                            if ln.startswith("Bandwidth: "))
                call = "isend" if o == "0" else "all_to_all_single"
                if f", {geometry}, {PENCIL_RANKS} devices" not in line or \
                        call not in line:
                    fail(f"reference -t {tc} -o {o}: {line}")
                out[f"reference_t{tc}_o{o}"] = dict(
                    argv=argv, seconds=secs, printed=line,
                    mb_per_s=printed(text, "Bandwidth: "))
    return out


def pencil_rank_main(rank: int, addr: str, outdir: str) -> None:
    """One of the four ranks of the pencil phase (``torch.cuda.set_device``
    0 on each: they share the card over gloo)."""
    import torch
    import torch.distributed as dist
    import distributedfft_tpu_torch as dft
    from distributedfft_tpu_torch.ops import hopper_fft as hf
    from distributedfft_tpu_torch.parallel import multihost
    from distributedfft_tpu_torch.parallel import transpose as tr

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    multihost.maybe_initialize(addr, PENCIL_RANKS, rank, backend="gloo",
                               timeout_s=600)
    out = {"rank": rank}
    t0 = time.perf_counter()
    out["full"] = pencil_full(torch, dist, dft, hf, tr, rank)
    out["full_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["renderings"] = pencil_renderings(torch, dist, dft, hf, rank)
    out["renderings_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["cli"] = pencil_cli(torch, dist, dft, hf, rank, outdir)
    out["cli_seconds"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    out["guard"] = guard_case(
        torch, lambda: dft.PencilFFTPlan(
            dft.GlobalSize(N, N, N), dft.PencilPartition(*PENCIL_GRID),
            dft.Config(fft_backend="pallas", guards="enforce")),
        "exec_r2c", SEED + 7, f"pencil rank {rank}")
    with open(os.path.join(outdir, f"pencil_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    multihost.shutdown()


# ---------------------------------------------------------------------------
# The batched-2D plan (BASELINE config #4): one card, two ranks sharing it
# over gloo, the executable; then the Bluestein backend
# ---------------------------------------------------------------------------

# Launches and entry points of one call of the batched plan under
# "pallas", forward and inverse. A 4096-point axis splits 8 x 512: y
# forward is the R2C first stage on rows (kernel 5) and the 8-point second
# stage storing the crop (kernel 2's short-stage body); x, where it lies,
# kernel 4's column body then the short stage. The inverse runs x the same
# way; the C2R of y is the complex inverse of its 2048 = 4 x 512-point
# packed spectrum: kernel 3's pack pass stores it in the four-step's
# first-stage layout, then kernel 4 on rows and the short stage. At 1024
# points every axis is one
# engine launch: y on rows (kernel 1, inverse kernel 3), x on kernel 2's
# column body where it lies. At 480 and 440 points (not powers of two) x
# moves last and runs on rows: kernel 2 on the engine's mixed-radix kernel
# (480 = 12 x 10 x 4, 440 = 11 x 10 x 4), and the forward's y R2C, kernel
# 1, and the inverse's y C2R, kernel 3, on it too. At 896 = 2 x
# 448 and 832 = 2 x 416 both axes split: y forward kernel 5 and x kernel
# 4, all on the mixed-radix kernel (448 = 8 x 8 x 7, 416 = 16 x 13 x 2),
# each with its 2-point short stage; the inverse's y C2R one launch of
# kernel 3's packed body, the 448- or 416-point inverse of the packed
# spectrum on the mixed-radix kernel.
BATCHED_SPLIT = (dict(rmatmul_tw=1, cmatmul=2, cmatmul_tw=1),
                 dict(cmatmul_tw=2, cmatmul=2, c2r=1),
                 {"dfft_rdft_tw": 1, "dfft_cdft_short": 2,
                  "dfft_cdft_tw_cols": 1},
                 {"dfft_cdft_tw_cols": 1, "dfft_cdft_short": 2,
                  "dfft_c2r_pack": 1, "dfft_cdft_tw": 1})
BATCHED_DIRECT_PATH = (dict(rmatmul=1, cmatmul=1), dict(cmatmul=1, c2r=1),
                       {"dfft_rdft": 1, "dfft_cdft_cols": 1},
                       {"dfft_cdft_cols": 1, "dfft_c2r": 1})
# x moved last at 480 and 440; both axes split in halves at 896 and 832.
BATCHED_MOVED_PATH = (dict(rmatmul=1, cmatmul=1), dict(cmatmul=1, c2r=1),
                      {"dfft_rdft": 1, "dfft_cdft": 1},
                      {"dfft_cdft": 1, "dfft_c2r": 1})
BATCHED_HALVES_PATH = (dict(rmatmul_tw=1, cmatmul=2, cmatmul_tw=1),
                       dict(cmatmul_tw=1, cmatmul=1, c2r=1),
                       {"dfft_rdft_tw": 1, "dfft_cdft_short": 2,
                        "dfft_cdft_tw": 1},
                       {"dfft_cdft_tw": 1, "dfft_cdft_short": 1,
                        "dfft_c2r_packed": 1})
BATCHED_480 = (256, 480, 480)   # 0.24 GB of spectrum
BATCHED_440 = (256, 440, 440)   # 0.20 GB of spectrum
BATCHED_896 = (64, 896, 896)    # 0.21 GB of spectrum
BATCHED_832 = (64, 832, 832)    # 0.18 GB of spectrum
# The single-card stacks: id -> (shape, one call's launches and entry
# points, the batch_chunk values run beside the whole stack).
BATCHED_CARD = {"batched_64x4096": (BATCHED, BATCHED_SPLIT, (1,)),
                "batched_256x1024": (BATCHED_DIRECT, BATCHED_DIRECT_PATH,
                                     ()),
                "batched_256x480": (BATCHED_480, BATCHED_MOVED_PATH, ()),
                "batched_64x896": (BATCHED_896, BATCHED_HALVES_PATH, ()),
                "batched_64x832": (BATCHED_832, BATCHED_HALVES_PATH, ()),
                "batched_256x440": (BATCHED_440, BATCHED_MOVED_PATH, ())}
# The stacks whose path proves that kernels 1-5 ran on the engine's
# mixed-radix kernel (``on_the_engine``): id -> (kernels forward, kernels
# inverse).
BATCHED_ENGINE = {"batched_256x480": (("cmatmul", "rmatmul"),
                                      ("cmatmul", "c2r")),
                  "batched_64x896": (("cmatmul_tw", "rmatmul_tw"),
                                     ("cmatmul_tw",)),
                  "batched_64x832": (("cmatmul_tw", "rmatmul_tw"),
                                     ("cmatmul_tw",)),
                  "batched_256x440": (("cmatmul", "rmatmul"),
                                      ("cmatmul", "c2r"))}
# The shard="x" renderings at 16 x 512^2 on two ranks: id -> (Config
# fields, launches forward, inverse, entry points forward, inverse).
# STREAMS under ALL2ALL runs x on each of its 4 pieces of the batch after
# the piece's exchange, forward, and the y C2R on each piece after it,
# inverse. On the fused wire the one ring step is one encode (kernel 9)
# and one unpack-only arrival (kernel 10) a direction.
_BD = BATCHED_DIRECT_PATH
_BRO = {"send_method": "RingOverlap"}
BATCHED_RENDERINGS = {
    "a2a": ({"comm_method": "All2All"}, *_BD),
    "p2p": ({"comm_method": "Peer2Peer"}, *_BD),
    "opt1": ({"comm_method": "All2All", "opt": 1}, *_BD),
    "a2a_pipelined": ({"comm_method": "All2All", "overlap_subblocks": 2},
                      *_BD),
    "streams_a2a": ({"comm_method": "All2All", "send_method": "Streams",
                     "streams_chunks": 4},
                    dict(rmatmul=1, cmatmul=4), dict(cmatmul=1, c2r=4),
                    {"dfft_rdft": 1, "dfft_cdft_cols": 4},
                    {"dfft_cdft_cols": 1, "dfft_c2r": 4}),
    "streams_p2p": ({"comm_method": "Peer2Peer", "send_method": "Streams",
                     "streams_chunks": 4}, *_BD),
    "ring": ({"send_method": "Ring"}, *_BD),
    "ring_overlap": (_BRO, *_BD),
    "ring_overlap_wire16": (dict(_BRO, wire_dtype="bf16"), *_BD),
    "ring_overlap_wire16_fused": (
        dict(_BRO, wire_dtype="bf16", fused_wire=True),
        dict(rmatmul=1, cmatmul=1, enc_pack=1, dec_unpack=1),
        dict(cmatmul=1, c2r=1, enc_pack=1, dec_unpack=1),
        *_plus(_BD[2:], enc_pack=1, dec_unpack=1)),
}
# Bit-equalities of the renderings: every one runs the kernels on the same
# rows and columns as the all-to-all.
BATCHED_PAIRS = [(pid, "a2a") for pid in (
    "p2p", "opt1", "a2a_pipelined", "streams_a2a", "streams_p2p", "ring",
    "ring_overlap")] + [("ring_overlap_wire16_fused", "ring_overlap_wire16")]
BATCHED_X_COMMS = ("All2All", "Peer2Peer")
# The batched executable's runs: testcase -> (arguments, CSV blocks,
# forward calls, inverse calls).
BATCHED_CLI_CASES = {0: (["-t", "0", "-i", "3", "-w", "1"], 3, 8, 0),
                     3: (["-t", "3"], 1, 2, 2)}


def batched_path(torch, dft, hf, gen, pid, shape, path, chunks):
    """One batched-2D stack on one card under "pallas", as a whole and in
    each ``batch_chunk`` of ``chunks``: launches and entry points per
    direction (one call's, times the calls), the forward against
    torch.fft.rfft2 and the roundtrip against nx ny x, each chunked run
    bit-equal to the whole stack; "xla" beside it (chunked within
    ``XLA_CHUNK_TOL`` of its whole stack); times (median of 3), peak
    memory, the kernels' share and a profile of each direction. Returns
    (launches by path, the row)."""
    B, nx, ny = shape
    want_f, want_i, ent_f_want, ent_i_want = path
    x = torch.randn(shape, generator=gen, device="cuda")
    launches, row, whole = {}, dict(path=pid, shape=list(shape),
                                    reps=REPS_BIG), None
    for ck in (None,) + tuple(chunks):
        name = "whole" if ck is None else f"chunk{ck}"
        plan = dft.Batched2DFFTPlan(*shape, dft.SlabPartition(1),
                                    dft.Config(fft_backend="pallas"),
                                    batch_chunk=ck)
        calls = B // (ck or B)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pairs = []
        c, back, fwd, inv, ent_f, ent_i = run_counted(torch, hf, plan, x,
                                                      pairs=pairs)
        r = dict(batch_chunk=ck, calls=calls, launches_forward=fwd,
                 launches_inverse=inv, entries_forward=ent_f,
                 entries_inverse=ent_i,
                 peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        if pid in BATCHED_ENGINE:
            for d, seen, kernels in zip(("forward", "inverse"), pairs,
                                        BATCHED_ENGINE[pid]):
                r[f"pairs_{d}"] = on_the_engine(seen, f"{pid} {name} {d}",
                                                kernels)
        if fwd != expect(hf, **scaled(want_f, calls, {}, 0)) or \
                inv != expect(hf, **scaled({}, 0, want_i, calls)) or \
                ent_f != scaled(ent_f_want, calls, {}, 0) or \
                ent_i != scaled({}, 0, ent_i_want, calls):
            fail(f"{pid} {name}: launches forward {fwd} (entries {ent_f}), "
                 f"inverse {inv} (entries {ent_i}); one call's are "
                 f"{want_f} ({ent_f_want}), {want_i} ({ent_i_want})")
        if whole is None:
            if tuple(c.shape) != (B, nx, ny // 2 + 1) or \
                    c.dtype != torch.complex64 or \
                    tuple(back.shape) != tuple(shape):
                fail(f"{pid}: outputs {tuple(c.shape)} {c.dtype}, "
                     f"{tuple(back.shape)}")
            ref = torch.fft.rfft2(x)
            _, r["forward_vs_torch_fft"] = rel_err(c, ref)
            del ref
            _, r["roundtrip_vs_input"] = rel_err(back / float(nx * ny), x)
            if not (r["forward_vs_torch_fft"] <= TOL
                    and r["roundtrip_vs_input"] <= TOL):
                fail(f"{pid}: forward rel {r['forward_vs_torch_fft']:.3e}, "
                     f"roundtrip rel {r['roundtrip_vs_input']:.3e}")
            whole = (c, back)
        else:
            r["equals_whole_stack"] = (torch.equal(c, whole[0])
                                       and torch.equal(back, whole[1]))
            if not r["equals_whole_stack"]:
                fail(f"{pid} {name} is not bit-equal to the whole stack")
        del back
        f_fn, i_fn = directions(plan)
        r["forward_ms"] = median_ms(torch, lambda: f_fn(x), REPS_BIG, 1)
        r["inverse_ms"] = median_ms(torch, lambda: i_fn(c), REPS_BIG, 1)
        if ck is None:
            for d, fn in (("forward", lambda: f_fn(x)),
                          ("inverse", lambda: i_fn(c))):
                total, per = kernel_share(torch, hf, fn)
                r[f"{d}_kernel_ms"] = per
                r[f"{d}_rest_ms"] = total - sum(per.values())
                r[f"{d}_profile"] = device_profile(torch, fn)
        emit(phase="main_path", path=f"{pid}_{name}", shape=list(shape),
             **r)
        launches[f"{pid}_{name}"] = {k: fwd[k] + inv[k] for k in fwd}
        row[name] = r
        del c, plan
        torch.cuda.empty_cache()
    whole = xla_c = None
    torch.cuda.empty_cache()
    for ck in (None,) + tuple(chunks):
        name = "whole" if ck is None else f"chunk{ck}"
        plan = dft.Batched2DFFTPlan(*shape, dft.SlabPartition(1),
                                    dft.Config(), batch_chunk=ck)
        f_fn, i_fn = directions(plan)
        c = f_fn(x)
        r = dict(forward_ms=median_ms(torch, lambda: f_fn(x), REPS_BIG, 1),
                 inverse_ms=median_ms(torch, lambda: i_fn(c), REPS_BIG, 1))
        if xla_c is None:
            xla_c = c
        else:
            _, r["vs_whole_stack"] = rel_err(c, xla_c)
            if not r["vs_whole_stack"] <= XLA_CHUNK_TOL:
                fail(f"{pid} xla {name}: {r['vs_whole_stack']:.3e} off its "
                     f"whole stack")
        row[f"xla_{name}"] = r
        del c, plan
    row["library_ms"] = dict(
        rfft2=median_ms(torch, lambda: torch.fft.rfft2(x), REPS_BIG, 1),
        irfft2=median_ms(torch, lambda: torch.fft.irfft2(xla_c, s=(nx, ny)),
                         REPS_BIG, 1))
    row["pallas_over_xla"] = {
        d: row["whole"][f"{d}_ms"] / row["xla_whole"][f"{d}_ms"]
        for d in ("forward", "inverse")}
    emit(phase="plan_time", **{k: v for k, v in row.items()
                               if not isinstance(v, dict)
                               or not k.startswith(("whole", "chunk"))},
         pallas_ms={k: {d: row[k][f"{d}_ms"] for d in ("forward", "inverse")}
                    for k in row if k.startswith(("whole", "chunk"))})
    del x, xla_c
    torch.cuda.empty_cache()
    return launches, row


def batched_csv_name(argv, ranks: int) -> str:
    """Where the batched executable writes the CSV of ``argv``, under its
    ``-b`` directory (the CPU tests hold it equal to the JAX
    executable's)."""
    from distributedfft_tpu_torch import params as pm
    from distributedfft_tpu_torch.cli import batched as cli_batched
    from distributedfft_tpu_torch.cli import common
    from distributedfft_tpu_torch.utils.timer import benchmark_filename
    args = cli_batched.build_parser().parse_args(argv)
    cfg = pm.Config(comm_method=pm.CommMethod.parse(args.comm_method),
                    send_method=pm.SendMethod.parse(args.send_method),
                    **common.config_kwargs(args))
    g = pm.GlobalSize(args.input_dim_z, args.input_dim_x, args.input_dim_y)
    variant = f"batched2d_{args.shard}" + (
        f"_ck{args.batch_chunk}" if args.batch_chunk else "")
    return os.path.relpath(benchmark_filename(
        args.benchmark_dir, variant, cfg, g, ranks), args.benchmark_dir)


def batched_cli_run(torch, hf, argv, tc, calls, sections, ranks, rank=0):
    """One run of ``dfft-torch-batched`` under "pallas" (shape ``BATCHED``
    or ``BATCHED_X``, each call one of ``BATCHED_SPLIT``): its launches
    and entry points, and on rank 0 testcase 3's result within TOL of nx
    ny and the CSV where ``batched_csv_name`` says, with ``sections``.
    Returns (launches, row)."""
    from distributedfft_tpu_torch.cli import batched as cli_batched
    args, blocks, k_f, k_i = BATCHED_CLI_CASES[tc]
    text, got, ent, secs = cli_run(torch, hf, cli_batched.main, argv + args)
    want = scaled(BATCHED_SPLIT[0], k_f * calls, BATCHED_SPLIT[1], k_i * calls)
    ent_want = scaled(BATCHED_SPLIT[2], k_f * calls, BATCHED_SPLIT[3],
                      k_i * calls)
    if got != expect(hf, **want) or ent != ent_want:
        fail(f"rank {rank} batched {argv + args}: launches {got} (entries "
             f"{ent}), expected {want} ({ent_want})")
    row = dict(testcase=tc, argv=argv + args, seconds=secs, entries=ent)
    if ranks > 1:
        import torch.distributed as dist
        dist.barrier()          # rank 0 has written the CSV
    if rank == 0:
        bdir = argv[argv.index("-b") + 1]
        nxy = int(argv[argv.index("-nx") + 1]) * int(
            argv[argv.index("-ny") + 1])
        val, rel = cli_result(tc, text, nxy, 0.0)
        if rel is not None and rel > TOL:
            fail(f"batched {argv + args}: {val} is {rel} of nx ny")
        name, run_ms, fused_ms = cli_csv(bdir, sections, blocks, ranks)
        if name != batched_csv_name(argv + args, ranks):
            fail(f"batched {argv + args} wrote {name}, not "
                 f"{batched_csv_name(argv + args, ranks)}")
        row.update(csv=name, run_complete_ms=run_ms, fused_ms=fused_ms,
                   result=val, result_rel=rel,
                   printed=text.strip().splitlines()[-3:])
    return got, row


def batched_cli_single_card(torch, dft, hf, plan_row):
    """``dfft-torch-batched -nx 4096 -ny 4096 -nz 64 --shard batch
    --fft-backend pallas``, testcases 0 and 3, with and without
    ``--batch-chunk 1``, on one card: each run's launches (one call's
    times the calls), results and CSV, and testcase 0's fused mean beside
    the plan's own forward time (``plan_row``). Returns (launches by
    path, rows)."""
    B, nx, ny = BATCHED
    root = tempfile.mkdtemp(prefix="chip_smoke_cli_batched_")
    sections = dft.Batched2DFFTPlan(*BATCHED, dft.SlabPartition(1),
                                    None).section_descriptions
    launches, rows = {}, []
    for ck in (None, 1):
        name = "whole" if ck is None else f"chunk{ck}"
        for tc in BATCHED_CLI_CASES:
            argv = ["-nx", str(nx), "-ny", str(ny), "-nz", str(B), "--shard",
                    "batch", "--fft-backend", "pallas", "-b",
                    os.path.join(root, f"{name}_t{tc}")]
            if ck:
                argv += ["--batch-chunk", str(ck)]
            got, row = batched_cli_run(torch, hf, argv, tc, B // (ck or B),
                                       sections, 1)
            if tc == 0:
                row["plan_forward_ms"] = plan_row[name]["forward_ms"]
                row["fused_over_plan"] = (row["fused_ms"]
                                          / row["plan_forward_ms"])
            launches[f"cli_batched_{name}_t{tc}"] = got
            rows.append(row)
            emit(phase="cli_batched", **row)
            torch.cuda.empty_cache()
    return launches, rows


def batched_batch_shard(torch, dist, dft, hf, rank: int, outdir: str):
    """shard="batch" at 64 x 4096^2 on the two ranks: 32 images a rank
    drawn from its own seed, no exchange: launches and entry points, the
    block against torch.fft.rfft2 and nx ny x, peak memory, times."""
    B, nx, ny = BATCHED
    plan = dft.Batched2DFFTPlan(*BATCHED, dft.SlabPartition(RANKS),
                                dft.Config(fft_backend="pallas"),
                                shard="batch")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20 + rank)
    xl = torch.randn(plan.local_input_shape, generator=gen, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    c, back, fwd, inv, ent_f, ent_i = run_counted(torch, hf, plan, xl)
    peak = torch.cuda.max_memory_allocated() / 1e9
    want_f, want_i, ent_f_want, ent_i_want = BATCHED_SPLIT
    if fwd != expect(hf, **want_f) or inv != expect(hf, **want_i) or \
            (ent_f, ent_i) != (ent_f_want, ent_i_want):
        fail(f"rank {rank} batched shard=batch: launches forward {fwd} "
             f"(entries {ent_f}), inverse {inv} (entries {ent_i})")
    ref = torch.fft.rfft2(xl)
    _, f_rel = rel_err(c, ref)
    del ref
    _, rt_rel = rel_err(back / float(nx * ny), xl)
    del back
    if not (f_rel <= TOL and rt_rel <= TOL):
        fail(f"rank {rank} batched shard=batch: forward rel {f_rel:.3e}, "
             f"roundtrip rel {rt_rel:.3e}")
    return dict(local_input_shape=list(plan.local_input_shape),
                local_output_shape=list(plan.local_output_shape),
                launches_forward=fwd, launches_inverse=inv,
                entries_forward=ent_f, entries_inverse=ent_i,
                forward_vs_torch_fft=f_rel, roundtrip_vs_input=rt_rel,
                peak_memory_gb=peak,
                forward_ms=barrier_ms(torch, dist,
                                      lambda: plan.exec_forward(xl)),
                inverse_ms=barrier_ms(torch, dist,
                                      lambda: plan.exec_inverse(c)))


def batched_x_shard(torch, dist, dft, hf, rank: int, outdir: str):
    """shard="x" at 8 x 4096^2 on the two ranks, All2All and Peer2Peer +
    Sync: launches and entry points, the blocks against torch.fft.rfft2 and
    nx ny x, the two exchanges bit-equal, times of each direction and of
    the exchange alone, the bytes a rank sends, peak memory."""
    B, nx, ny = BATCHED_X
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    x = torch.randn(BATCHED_X, generator=gen, device="cuda")
    ref = torch.fft.rfft2(x)
    out, res = {}, {}
    for comm in BATCHED_X_COMMS:
        plan = dft.Batched2DFFTPlan(*BATCHED_X, dft.SlabPartition(RANKS),
                                    pencil_config(dft,
                                                  {"comm_method": comm}),
                                    shard="x")
        xl, refl = plan.pad_input(x), plan.pad_spectral(ref)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        c, back, fwd, inv, ent_f, ent_i = run_counted(torch, hf, plan, xl)
        peak = torch.cuda.max_memory_allocated() / 1e9
        want_f, want_i, ent_f_want, ent_i_want = BATCHED_SPLIT
        if fwd != expect(hf, **want_f) or inv != expect(hf, **want_i) or \
                (ent_f, ent_i) != (ent_f_want, ent_i_want):
            fail(f"rank {rank} batched shard=x {comm}: launches forward "
                 f"{fwd} (entries {ent_f}), inverse {inv} (entries {ent_i})")
        _, f_rel = rel_err(c, refl)
        _, rt_rel = rel_err(back / float(nx * ny), xl)
        if not (f_rel <= TOL and rt_rel <= TOL):
            fail(f"rank {rank} batched shard=x {comm}: forward rel "
                 f"{f_rel:.3e}, roundtrip rel {rt_rel:.3e}")
        first, xpose, _ = plan._slab_parts(True)
        ifirst, ixpose, _ = plan._slab_parts(False)
        a, b = first(xl), ifirst(c)
        row = dict(local_input_shape=list(plan.local_input_shape),
                   local_output_shape=list(plan.local_output_shape),
                   launches_forward=fwd, launches_inverse=inv,
                   entries_forward=ent_f, entries_inverse=ent_i,
                   forward_vs_torch_fft=f_rel, roundtrip_vs_input=rt_rel,
                   peak_memory_gb=peak,
                   forward_ms=barrier_ms(torch, dist,
                                         lambda: plan.exec_forward(xl)),
                   inverse_ms=barrier_ms(torch, dist,
                                         lambda: plan.exec_inverse(c)),
                   exchange_forward_ms=barrier_ms(torch, dist,
                                                  lambda: xpose(a)),
                   exchange_inverse_ms=barrier_ms(torch, dist,
                                                  lambda: ixpose(b)),
                   wire_bytes_per_rank={
                       "forward": a.numel() * a.element_size() // RANKS,
                       "inverse": b.numel() * b.element_size() // RANKS})
        del a, b
        for d, fn in (("forward", lambda: plan.exec_forward(xl)),
                      ("inverse", lambda: plan.exec_inverse(c))):
            _, per = kernel_share(torch, hf, fn)
            row[f"{d}_kernel_ms"] = per
        out[comm] = row
        res[comm] = (c, back)
        del plan, xl, refl
        torch.cuda.empty_cache()
    ok = all(torch.equal(g, w) for g, w in zip(res["Peer2Peer"],
                                               res["All2All"]))
    out["peer2peer_equals_all2all"] = ok
    if not ok:
        fail(f"rank {rank}: batched shard=x Peer2Peer is not bit-equal to "
             f"All2All")
    return out


def batched_renderings(torch, dist, dft, hf, rank: int, outdir: str):
    """Every rendering of ``BATCHED_RENDERINGS`` at 16 x 512^2, shard="x",
    on the two ranks: launches and entry points per direction, the blocks
    against torch.fft.rfft2 and nx ny x, the bit-equalities of
    ``BATCHED_PAIRS`` and each direction's time."""
    B, nx, ny = BATCHED_RENDER
    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    x = torch.randn(BATCHED_RENDER, generator=gen, device="cuda")
    ref = torch.fft.rfft2(x)
    out, res = {}, {}
    for pid, (fields, want_f, want_i, ent_f_want,
              ent_i_want) in BATCHED_RENDERINGS.items():
        plan = dft.Batched2DFFTPlan(*BATCHED_RENDER, dft.SlabPartition(RANKS),
                                    pencil_config(dft, fields), shard="x")
        xl = plan.pad_input(x)
        c, back, fwd, inv, ent_f, ent_i = run_counted(torch, hf, plan, xl)
        if fwd != expect(hf, **want_f) or inv != expect(hf, **want_i) or \
                (ent_f, ent_i) != (ent_f_want, ent_i_want):
            fail(f"rank {rank} batched {pid}: launches forward {fwd} "
                 f"(entries {ent_f}), inverse {inv} (entries {ent_i}); "
                 f"expected {want_f} ({ent_f_want}), {want_i} "
                 f"({ent_i_want})")
        tol = WIRE16_TOL if plan.config.wire_dtype == "bf16" else TOL
        _, f_rel = rel_err(c, plan.pad_spectral(ref))
        _, rt_rel = rel_err(back / float(nx * ny), xl)
        if not (f_rel <= tol and rt_rel <= tol):
            fail(f"rank {rank} batched {pid}: forward rel {f_rel:.3e}, "
                 f"roundtrip rel {rt_rel:.3e} (tol {tol})")
        out[pid] = dict(config=fields, launches_forward=fwd,
                        launches_inverse=inv, entries_forward=ent_f,
                        entries_inverse=ent_i, forward_vs_torch_fft=f_rel,
                        roundtrip_vs_input=rt_rel, tol=tol,
                        forward_ms=barrier_ms(
                            torch, dist, lambda: plan.exec_forward(xl)),
                        inverse_ms=barrier_ms(
                            torch, dist, lambda: plan.exec_inverse(c)))
        res[pid] = (c, back)
        del plan, xl
    for pid, other in BATCHED_PAIRS:
        ok = all(torch.equal(g_, w) for g_, w in zip(res[pid], res[other]))
        out[f"{pid}_equals_{other}"] = ok
        if not ok:
            errs = [rel_err(g_, w)[1] for g_, w in zip(res[pid], res[other])]
            fail(f"rank {rank}: batched {pid} is not bit-equal to {other} "
                 f"(rel {max(errs):.3e})")
    del res, ref, x
    torch.cuda.empty_cache()
    return out


def batched_cli_ranks(torch, dist, dft, hf, rank: int, outdir: str):
    """``dfft-torch-batched -nx 4096 -ny 4096 -nz 8 --shard x
    --fft-backend pallas`` (the default Peer2Peer exchange), testcases 0
    and 3, over the two ranks."""
    B, nx, ny = BATCHED_X
    sections = dft.Batched2DFFTPlan(*BATCHED_X, dft.SlabPartition(RANKS),
                                    None, shard="x").section_descriptions
    out = {"runs": [], "launches": {}}
    for tc in BATCHED_CLI_CASES:
        argv = ["-nx", str(nx), "-ny", str(ny), "-nz", str(B), "--shard", "x",
                "--fft-backend", "pallas", "-b",
                os.path.join(outdir, f"batched_x_t{tc}")]
        got, row = batched_cli_run(torch, hf, argv, tc, 1, sections, RANKS,
                                   rank)
        out["launches"][f"cli_batched_x_{B}_t{tc}"] = got
        out["runs"].append(row)
        torch.cuda.empty_cache()
    return out


def batched_rank_main(rank: int, addr: str, outdir: str) -> None:
    """One of the two ranks of the batched phase, sharing the card over
    gloo: shard="batch" at 64 x 4096^2, shard="x" at 8 x 4096^2, the
    renderings at 16 x 512^2 and the executable."""
    import torch
    import torch.distributed as dist
    import distributedfft_tpu_torch as dft
    from distributedfft_tpu_torch.ops import hopper_fft as hf
    from distributedfft_tpu_torch.parallel import multihost

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    multihost.maybe_initialize(addr, RANKS, rank, backend="gloo",
                               timeout_s=600)
    out = {"rank": rank}
    for name, fn in (("batch_shard", batched_batch_shard),
                     ("x_shard", batched_x_shard),
                     ("renderings", batched_renderings),
                     ("cli", batched_cli_ranks)):
        t0 = time.perf_counter()
        out[name] = fn(torch, dist, dft, hf, rank, outdir)
        out[f"{name}_seconds"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    out["guard"] = guard_case(
        torch, lambda: dft.Batched2DFFTPlan(
            *BATCHED_RENDER, dft.SlabPartition(RANKS),
            dft.Config(fft_backend="pallas", guards="enforce"), shard="x"),
        "exec_forward", SEED + 8, f"batched rank {rank}")
    with open(os.path.join(outdir, f"batched_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    multihost.shutdown()


def bluestein_paths(torch, dft, hf, gen):
    """The Bluestein backend on one card: the 64 x 4093^2 stack (both axes
    prime, chirp length 8192) at ``batch_chunk`` 8 against float64
    torch.fft.rfft2 chunk by chunk and nx ny x, its peak memory, its times
    against "xla" (cuFFT) at the same chunking; float64 on one chunk; the
    whole stack where its estimated peak fits; the 521^3 slab plan on one
    rank against float64 torch.fft.rfftn; and the 512^3 plan, all smooth,
    bit-equal to "xla". No kernel launches on any of these."""
    from distributedfft_tpu_torch.ops import bluestein as bl
    B, nx, ny = BLUESTEIN
    ck = BLUESTEIN_CHUNK
    out = dict(shape=list(BLUESTEIN), chirp_length=bl.chirp_length(ny),
               batch_chunk=ck, reps=REPS_BIG)
    x = torch.randn(BLUESTEIN, generator=gen, device="cuda")
    plan = dft.Batched2DFFTPlan(*BLUESTEIN, dft.SlabPartition(1),
                                dft.Config(fft_backend="bluestein"),
                                batch_chunk=ck)
    hf.reset_launches()
    torch.cuda.synchronize()
    base_f = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    c = plan.exec_forward(x)
    torch.cuda.synchronize()
    peak_f = torch.cuda.max_memory_allocated()
    base_i = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    back = plan.exec_inverse(c)
    torch.cuda.synchronize()
    peak_i = torch.cuda.max_memory_allocated()
    if any(counted(hf).values()):
        fail(f"the Bluestein plan launched kernels: {counted(hf)}")
    err = top = rt_err = 0.0
    for i in range(0, B, ck):
        ref = torch.fft.rfft2(x[i:i + ck].double())
        err = max(err, float((c[i:i + ck] - ref).abs().max()))
        top = max(top, float(ref.abs().max()))
        rt_err = max(rt_err, float((back[i:i + ck].double() / (nx * ny)
                                    - x[i:i + ck]).abs().max()))
        del ref
    out.update(forward_vs_torch_fft_f64=err / top,
               roundtrip_vs_input=rt_err / float(x.abs().max()),
               peak_memory_gb={"forward": peak_f / 1e9,
                               "inverse": peak_i / 1e9})
    if not (out["forward_vs_torch_fft_f64"] <= TOL
            and out["roundtrip_vs_input"] <= TOL):
        fail(f"Bluestein {BLUESTEIN}: {out}")
    del back
    out["forward_ms"] = median_ms(torch, lambda: plan.exec_forward(x),
                                  REPS_BIG, 1)
    out["inverse_ms"] = median_ms(torch, lambda: plan.exec_inverse(c),
                                  REPS_BIG, 1)
    xla = dft.Batched2DFFTPlan(*BLUESTEIN, dft.SlabPartition(1), dft.Config(),
                               batch_chunk=ck)
    cx = xla.exec_forward(x)
    out["xla_forward_ms"] = median_ms(torch, lambda: xla.exec_forward(x),
                                      REPS_BIG, 1)
    out["xla_inverse_ms"] = median_ms(torch, lambda: xla.exec_inverse(cx),
                                      REPS_BIG, 1)
    del cx, xla
    torch.cuda.empty_cache()
    # Float64 on one chunk.
    p64 = dft.Batched2DFFTPlan(ck, nx, ny, dft.SlabPartition(1),
                               dft.Config(fft_backend="bluestein",
                                          double_prec=True))
    x64 = x[:ck].double()
    c64 = p64.exec_forward(x64)
    _, out["f64_forward_vs_torch_fft"] = rel_err(c64, torch.fft.rfft2(x64))
    _, out["f64_roundtrip_vs_input"] = rel_err(
        p64.exec_inverse(c64) / float(nx * ny), x64)
    if not (out["f64_forward_vs_torch_fft"] <= F64_TOL
            and out["f64_roundtrip_vs_input"] <= F64_TOL):
        fail(f"Bluestein float64 chunk: {out}")
    del p64, x64, c64
    torch.cuda.empty_cache()
    # The whole stack at once, where the chunked run's intermediates times
    # the chunks fit: the estimate, the decision and what it took.
    chunks = B // ck
    out_bytes = c.numel() * c.element_size()
    est = {"forward": base_f + out_bytes
           + (peak_f - base_f - out_bytes) * chunks,
           "inverse": base_i + x.numel() * x.element_size()
           + (peak_i - base_i - x.numel() * x.element_size()) * chunks}
    total = torch.cuda.get_device_properties(0).total_memory
    out["whole_stack"] = whole = dict(
        estimated_peak_gb={d: v / 1e9 for d, v in est.items()},
        device_memory_gb=total / 1e9,
        runs=max(est.values()) <= MEMORY_SHARE * total)
    if whole["runs"]:
        wp = dft.Batched2DFFTPlan(*BLUESTEIN, dft.SlabPartition(1),
                                  dft.Config(fft_backend="bluestein"))
        for d, fn in (("forward", lambda: wp.exec_forward(x)),
                      ("inverse", lambda: wp.exec_inverse(c))):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            whole[f"{d}_ms"] = median_ms(torch, fn, 1, 0)
            whole[f"{d}_peak_memory_gb"] = \
                torch.cuda.max_memory_allocated() / 1e9
            torch.cuda.empty_cache()
        cw = wp.exec_forward(x)
        _, whole["forward_vs_chunked"] = rel_err(cw, c)
        del cw, wp
        if not whole["forward_vs_chunked"] <= TOL:
            fail(f"Bluestein whole stack: {whole}")
    del x, c, plan
    torch.cuda.empty_cache()
    # The slab plan on one rank at a prime cube.
    n = BLUESTEIN_SLAB
    g = dft.GlobalSize(n, n, n)
    xs = torch.randn((n, n, n), generator=gen, device="cuda")
    sp = dft.SlabFFTPlan(g, dft.SlabPartition(1),
                         dft.Config(fft_backend="bluestein"))
    hf.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cs = sp.exec_r2c(xs)
    bs = sp.exec_c2r(cs)
    torch.cuda.synchronize()
    slab = dict(shape=[n] * 3, chirp_length=bl.chirp_length(n),
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    if any(counted(hf).values()):
        fail(f"the Bluestein slab plan launched kernels: {counted(hf)}")
    _, slab["forward_vs_torch_fft_f64"] = rel_err(
        cs, torch.fft.rfftn(xs.double()))
    _, slab["roundtrip_vs_input"] = rel_err(bs / float(n ** 3), xs)
    del bs
    if not (slab["forward_vs_torch_fft_f64"] <= TOL
            and slab["roundtrip_vs_input"] <= TOL):
        fail(f"Bluestein slab {n}^3: {slab}")
    xsp = dft.SlabFFTPlan(g, dft.SlabPartition(1), dft.Config())
    cx = xsp.exec_r2c(xs)
    slab.update(
        forward_ms=median_ms(torch, lambda: sp.exec_r2c(xs), REPS_BIG, 1),
        inverse_ms=median_ms(torch, lambda: sp.exec_c2r(cs), REPS_BIG, 1),
        xla_forward_ms=median_ms(torch, lambda: xsp.exec_r2c(xs), REPS_BIG,
                                 1),
        xla_inverse_ms=median_ms(torch, lambda: xsp.exec_c2r(cx), REPS_BIG,
                                 1))
    out["slab_prime"] = slab
    del xs, cs, cx, sp, xsp
    torch.cuda.empty_cache()
    # A smooth cube: "bluestein" is "xla", bit for bit.
    g = dft.GlobalSize(N, N, N)
    xs = torch.randn((N, N, N), generator=gen, device="cuda")
    bp = dft.SlabFFTPlan(g, dft.SlabPartition(1),
                         dft.Config(fft_backend="bluestein"))
    xp = dft.SlabFFTPlan(g, dft.SlabPartition(1), dft.Config())
    cb, cx = bp.exec_r2c(xs), xp.exec_r2c(xs)
    out["smooth_512_equals_xla"] = (torch.equal(cb, cx) and torch.equal(
        bp.exec_c2r(cb), xp.exec_c2r(cx)))
    if not out["smooth_512_equals_xla"]:
        fail("Bluestein on the smooth 512^3 cube is not bit-equal to xla")
    del xs, cb, cx, bp, xp
    torch.cuda.empty_cache()
    emit(phase="bluestein", **out)
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

    def short_case(variant, shape, kind, inverse, n2=None):
        """Kernel 2's short-stage body on (outer, n1, inner) columns with
        one of its output geometries: "last" (natural order), "crop"
        (bins 0..n/2) or "strided" (a non-last axis of n1 * n2 points,
        outer index o n2 + k2 (n2 = outer by default), stored in its
        (outer / n2, n, inner) layout)."""
        outer, n1, inner = shape
        if kind == "strided":
            n2 = n2 or outer
            geom = hf.short_strided(n1, n2, inner)
            out_shape = ((n1 * outer, inner) if n2 == outer
                         else (outer // n2, n1 * n2, inner))
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
    bb, bx, by = BATCHED                      # the batched 4096^2 stack
    bys = by // 2 + 1
    rows_640 = 640 * 640 * 2                  # 640^3 z first stage rows
    rows_640c = 640 * 321 * 2                 # 640^3 y/x first stage rows
    k_r = N // 2 + 1
    kb = NBIG // 2 + 1
    k480 = 480 // 2 + 1
    wb, wx, wy = WISDOM_BATCHED               # 8 x 4320^2: 4320 = 9 x 480
    from distributedfft_tpu_torch.ops.bluestein import good_size
    cb, cn, ck = CONV_SMOOTH                  # the convolution's 4320 extent:
    cx = good_size(cn + ck - 1)               # its y C2R rows are cb cx
    rows_4320 = wb * (wy // 2 + 1) * 9        # its x axis's first stage rows
    # Kernels 1, 2 and 3 take no F: rdft / cdft / irdft pick their body by
    # n (the FFT body at 512 and 1024, the row body at 4; the engine's
    # mixed-radix kernel at 480, kernel 2 also at 448 and 440 = 11 x 10 x
    # 4, and their tile body at 442 = 2 x 13 x 17). An FFT body's bytes
    # count no DFT matrix.
    k442 = 442 // 2 + 1
    m_odd = 4097                              # the check-only rows
    k375 = 375 // 2 + 1

    def half_spectra(m, n):
        """Random half spectra whose DC bin is real (so that irfft, the
        yardstick of the check-only rows, and the C2R agree); the last
        bin keeps its imaginary part."""
        c = cr(m, n // 2 + 1)
        c[:, 0] = c[:, 0].real.clone()
        return c

    def packed_case(variant, rows, m):
        """Kernel 3's packed body on rows of m + 1 bins to n = 2 m: the
        engine's m-point inverse of the packed spectrum (``dfft_c2r_packed``)."""
        n = 2 * m
        return dict(
            name="c2r", variant=variant, body="packed",
            entry="dfft_c2r_packed", replaces=f"{PALLAS}:156",
            shape=dict(M=rows, m=m, n=n),
            make=lambda: dict(x=cr(rows, m + 1)),
            run=lambda t: hf.irdft_packed(t["x"], n),
            plain=lambda t: hf.c2r_packed_plain(t["x"], n),
            library=lambda t: torch.fft.irfft(t["x"], n=n, norm="forward"),
            library_call="irfft(norm='forward') of the same rows",
            flops=fft_flops(rows, m) + 12 * rows * m,
            gemm_flops=4 * rows * (m + 1) * n,
            bytes=8 * rows * (m + 1) + 4 * rows * n)

    def pack_case(variant, rows, m):
        """Kernel 3's pack pass on rows of m + 1 bins: the packed spectrum
        in the first-stage layout of ``hf._split_axis(m)``
        (``dfft_c2r_pack``); the library's time is the whole C2R's."""
        n1 = hf._split_axis(m)[0]
        return dict(
            name="c2r", variant=variant, body="pack", entry="dfft_c2r_pack",
            replaces=f"{PALLAS}:156",
            shape=dict(M=rows, m=m, n=2 * m, n1=n1),
            make=lambda: dict(x=cr(rows, m + 1)),
            run=lambda t: hf.c2r_pack(t["x"], n1),
            plain=lambda t: hf.c2r_pack_plain(t["x"], n1),
            library=lambda t: torch.fft.irfft(t["x"], n=2 * m,
                                              norm="forward"),
            library_call="irfft(norm='forward') of the same rows (the whole "
                         "C2R)",
            flops=12 * rows * m, gemm_flops=4 * rows * (m + 1) * 2 * m,
            bytes=8 * rows * (m + 1) + 8 * rows * m)

    def twiddled_fft(x, n1):
        """The library's rfft of a check-only row's full spectrum times
        the twiddle row r % n1."""
        tr, ti = hf._twiddle_planes(n1, x.shape[1], False, dev)
        rows = torch.arange(x.shape[0], device=dev) % n1
        return torch.fft.fft(x) * torch.complex(tr, ti)[rows]

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
        # Kernel 1's FFT body on the mixed-radix kernel at 480 points (the
        # 256 x 480^2 stack's y R2C) and, checked only, at the odd 375 on
        # an odd number of rows, and its tile body at 442 (a factor past
        # 13), checked only; kernel 2's FFT body on the mixed-radix kernel
        # at 480, 448 and 440 and its tile body at 442; on as many rows as
        # a rank's z rows of the 512^3 two-rank plan.
        dict(name="rmatmul", variant="fft_480",
             replaces=f"{PALLAS}:182", shape=dict(M=rows_r, n=480, k=k480),
             make=lambda: dict(x=rr(rows_r, 480), F=planes("rdft", 480)),
             run=lambda t: hf.rdft(t["x"]),
             plain=lambda t: hf.stage_plain(t["x"], *t["F"]),
             library=lambda t: torch.fft.rfft(t["x"]), library_call="rfft",
             flops=fft_flops(rows_r, 480, real=True),
             gemm_flops=4 * rows_r * 480 * k480,
             bytes=4 * rows_r * 480 + 8 * rows_r * k480),
        dict(name="rmatmul", variant="odd_375", check_only=True,
             replaces=f"{PALLAS}:182", shape=dict(M=m_odd, n=375, k=k375),
             make=lambda: dict(x=rr(m_odd, 375), F=planes("rdft", 375)),
             run=lambda t: hf.rdft(t["x"]),
             plain=lambda t: hf.stage_plain(t["x"], *t["F"]),
             library=lambda t: torch.fft.rfft(t["x"]), library_call="rfft"),
        dict(name="rmatmul", variant="tile_442", body="tile",
             replaces=f"{PALLAS}:182", shape=dict(M=rows_r, n=442, k=k442),
             make=lambda: dict(x=rr(rows_r, 442), F=planes("rdft", 442)),
             run=lambda t: hf.rdft(t["x"]),
             plain=lambda t: hf.stage_plain(t["x"], *t["F"]),
             library=lambda t: torch.fft.rfft(t["x"]), library_call="rfft",
             flops=fft_flops(rows_r, 442, real=True),
             gemm_flops=4 * rows_r * 442 * k442,
             bytes=4 * rows_r * 442 + 8 * rows_r * k442 + 8 * 442 * k442),
        *(dict(name="cmatmul", variant=f"fft_{n}",
               replaces=f"{PALLAS}:164", shape=dict(M=rows_r, n=n, k=n),
               make=lambda n=n: dict(x=cr(rows_r, n), F=planes("dft", n)),
               run=lambda t: hf.cdft(t["x"], False),
               plain=lambda t: hf.stage_plain(t["x"], *t["F"]),
               library=lambda t: torch.fft.fft(t["x"]), library_call="fft",
               flops=fft_flops(rows_r, n), gemm_flops=8 * rows_r * n * n,
               bytes=16 * rows_r * n) for n in (480, 448, 440)),
        dict(name="cmatmul", variant="tile_442", body="tile",
             replaces=f"{PALLAS}:164", shape=dict(M=rows_r, n=442, k=442),
             make=lambda: dict(x=cr(rows_r, 442), F=planes("dft", 442)),
             run=lambda t: hf.cdft(t["x"], False),
             plain=lambda t: hf.stage_plain(t["x"], *t["F"]),
             library=lambda t: torch.fft.fft(t["x"]), library_call="fft",
             flops=fft_flops(rows_r, 442), gemm_flops=8 * rows_r * 442 * 442,
             bytes=16 * rows_r * 442 + 8 * 442 * 442),
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
        # Its 8-point second stage on the batched plan's 64 x 4096 x 4096
        # stack (BASELINE config #4): y forward (the R2C crop) and x where
        # it lies (64 images of 512 x 8 columns of 2049 points).
        short_case("short_4096_y_crop", (bb * bx, 8, by // 8), "crop", False),
        short_case("short_4096_x", (bb * bx // 8, 8, bys), "strided", False,
                   n2=bx // 8),
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
        # Kernel 3 on the engine's mixed-radix kernel at 480 = 12 x 10 x 4
        # (the 256 x 480^2 stack's y C2R), on its tile body at 442 (a
        # factor past 13), and, checked only, at the odd 375 on an odd
        # number of rows, against its plain version and irfft.
        dict(name="c2r", variant="fft_480", replaces=f"{PALLAS}:156",
             shape=dict(M=rows_r, n_in=k480, n=480),
             make=lambda: dict(x=cr(rows_r, k480), C=planes("c2r", 480)),
             run=lambda t: hf.irdft(t["x"], 480),
             plain=lambda t: hf.c2r_plain(t["x"], *t["C"]),
             library=lambda t: torch.fft.irfft(t["x"], n=480, norm="forward"),
             library_call="irfft(norm='forward')",
             flops=fft_flops(rows_r, 480, real=True),
             gemm_flops=4 * rows_r * k480 * 480,
             bytes=8 * rows_r * k480 + 4 * rows_r * 480),
        dict(name="c2r", variant="tile_442", body="tile",
             replaces=f"{PALLAS}:156", shape=dict(M=rows_r, n_in=k442, n=442),
             make=lambda: dict(x=cr(rows_r, k442), C=planes("c2r", 442)),
             run=lambda t: hf.irdft(t["x"], 442),
             plain=lambda t: hf.c2r_plain(t["x"], *t["C"]),
             library=lambda t: torch.fft.irfft(t["x"], n=442, norm="forward"),
             library_call="irfft(norm='forward')",
             flops=fft_flops(rows_r, 442, real=True),
             gemm_flops=4 * rows_r * k442 * 442,
             bytes=8 * rows_r * k442 + 4 * rows_r * 442 + 8 * k442 * 442),
        dict(name="c2r", variant="odd_375", check_only=True,
             replaces=f"{PALLAS}:156", shape=dict(M=m_odd, n_in=k375, n=375),
             make=lambda: dict(x=half_spectra(m_odd, 375),
                               C=planes("c2r", 375)),
             run=lambda t: hf.irdft(t["x"], 375),
             plain=lambda t: hf.c2r_plain(t["x"], *t["C"]),
             library=lambda t: torch.fft.irfft(t["x"], n=375, norm="forward"),
             library_call="irfft(norm='forward')"),
        # Kernel 3 past the direct lengths, on random half spectra: its
        # packed body at the 2048 x 256 x 2048 plan's z inverse (m 1024)
        # and the 64 x 896^2 and 64 x 832^2 stacks' y inverse (m 448 and
        # 416, the mixed-radix kernel); its pack pass at the 64 x 4096^2
        # stack's y inverse (m 2048 = 4 x 512) and the convolution's 4320
        # extent (m 2160 = 5 x 432).
        *[packed_case(f"packed_{2 * m}", rows, m)
          for rows, m in ((sx * sy, sz // 2), (896 * 64, 448),
                          (832 * 64, 416))],
        *[pack_case(f"pack_{2 * m}", rows, m)
          for rows, m in ((bb * bx, by // 2), (cb * cx, cx // 2))],
        # Kernel 4 takes no F: cdft_tw picks its body by n2 (the FFT body
        # at 512, the 2048-point axis's 4 x 512, and, on the engine's
        # mixed-radix kernel, at 320, the 640-point axis's 2 x 320, at 480,
        # the 4320-point axis's 9 x 480, at 448, the 896-point axis's 2 x
        # 448, and at 416 = 16 x 13 x 2, the 832-point axis's 2 x 416; the
        # tile body at 408 = 24 x 17, an 816-point axis's 2 x 408). "rows":
        # torch.fft.fft of the same rows, the stage without its twiddle,
        # the nearer yardstick beside the whole axis.
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
        # The same body on the batched stack's x axis: (64, 512, 8 * 2049)
        # views of the (64, 4096, 2049) spectrum, an odd inner extent.
        dict(name="cmatmul_tw", variant="cols_4096_batched_x", body="cols",
             replaces=f"{PALLAS}:171",
             shape=dict(outer=bb, n=bx // 8, inner=8 * bys, n1=8, axis=1),
             make=lambda: dict(z=cr(bb, bx, bys)),
             run=lambda t: hf.cdft_tw_cols(
                 t["z"].view(bb, bx // 8, 8 * bys), 8, False),
             plain=lambda t: hf.cdft_tw_cols_plain(
                 t["z"].view(bb, bx // 8, 8 * bys), 8, False),
             pair=lambda t: hf.fft(t["z"], axis=1),
             rows=lambda t: torch.fft.fft(
                 t["z"].view(bb, bx // 8, 8 * bys), dim=1),
             library=lambda t: torch.fft.fft(t["z"], dim=1),
             library_call="fft(dim=1) of the whole 4096-point axis",
             flops=fft_flops(bb * 8 * bys, bx // 8) + 6 * bb * bx * bys,
             gemm_flops=8 * bb * 8 * bys * (bx // 8) ** 2,
             bytes=16 * bb * bx * bys + 8 * bx),
        dict(name="cmatmul_tw", variant="fft_n2_320",
             replaces=f"{PALLAS}:171",
             shape=dict(M=rows_640c, n=320, k=320, n1=2),
             make=lambda: dict(x=cr(rows_640c, 320), F=planes("dft", 320),
                               T=hf._twiddle_planes(2, 320, False, dev),
                               z=cr(rows_640c // 2, 640)),
             run=lambda t: hf.cdft_tw(t["x"], 2, False),
             plain=lambda t: hf.stage_plain(t["x"], *t["F"], *t["T"]),
             pair=lambda t: hf._fft_last(t["z"], False),
             rows=lambda t: torch.fft.fft(t["x"]),
             library=lambda t: torch.fft.fft(t["z"]),
             library_call="fft of the whole 640-point axis",
             flops=fft_flops(rows_640c, 320) + 6 * rows_640c * 320,
             gemm_flops=8 * rows_640c * 320 * 320,
             bytes=16 * rows_640c * 320 + 8 * 2 * 320),
        dict(name="cmatmul_tw", variant="fft_n2_480_n1_9",
             replaces=f"{PALLAS}:171",
             shape=dict(M=rows_4320, n=480, k=480, n1=9),
             make=lambda: dict(x=cr(rows_4320, 480), F=planes("dft", 480),
                               T=hf._twiddle_planes(9, 480, False, dev),
                               z=cr(rows_4320 // 9, wx)),
             run=lambda t: hf.cdft_tw(t["x"], 9, False),
             plain=lambda t: hf.stage_plain(t["x"], *t["F"], *t["T"]),
             pair=lambda t: hf._fft_last(t["z"], False),
             rows=lambda t: torch.fft.fft(t["x"]),
             library=lambda t: torch.fft.fft(t["z"]),
             library_call="fft of the whole 4320-point axis",
             flops=fft_flops(rows_4320, 480) + 6 * rows_4320 * 480,
             gemm_flops=8 * rows_4320 * 480 * 480,
             bytes=16 * rows_4320 * 480 + 8 * 9 * 480),
        *(dict(name="cmatmul_tw", variant=f"fft_n2_{n}",
               replaces=f"{PALLAS}:171",
               shape=dict(M=rows_640c, n=n, k=n, n1=2),
               make=lambda n=n: dict(x=cr(rows_640c, n), F=planes("dft", n),
                                     T=hf._twiddle_planes(2, n, False, dev),
                                     z=cr(rows_640c // 2, 2 * n)),
               run=lambda t: hf.cdft_tw(t["x"], 2, False),
               plain=lambda t: hf.stage_plain(t["x"], *t["F"], *t["T"]),
               pair=lambda t: hf._fft_last(t["z"], False),
               rows=lambda t: torch.fft.fft(t["x"]),
               library=lambda t: torch.fft.fft(t["z"]),
               library_call=f"fft of the whole {2 * n}-point axis",
               flops=fft_flops(rows_640c, n) + 6 * rows_640c * n,
               gemm_flops=8 * rows_640c * n * n,
               bytes=16 * rows_640c * n + 8 * 2 * n) for n in (448, 416)),
        dict(name="cmatmul_tw", variant="tile_n2_408", body="tile",
             replaces=f"{PALLAS}:171",
             shape=dict(M=rows_640c, n=408, k=408, n1=2),
             make=lambda: dict(x=cr(rows_640c, 408), F=planes("dft", 408),
                               T=hf._twiddle_planes(2, 408, False, dev),
                               z=cr(rows_640c // 2, 816)),
             run=lambda t: hf.cdft_tw(t["x"], 2, False),
             plain=lambda t: hf.stage_plain(t["x"], *t["F"], *t["T"]),
             rows=lambda t: torch.fft.fft(t["x"]),
             library=lambda t: torch.fft.fft(t["z"]),
             library_call="fft of the whole 816-point axis",
             flops=fft_flops(rows_640c, 408) + 6 * rows_640c * 408,
             gemm_flops=8 * rows_640c * 408 * 408,
             bytes=16 * rows_640c * 408 + 8 * 408 * 408 + 8 * 2 * 408),
        # Kernel 5 takes no F: rdft_tw picks its body by n2 (the FFT body
        # at 512, the 2048-point axis's 4 x 512; on the engine's
        # mixed-radix kernel at 320 = 10 x 8 x 4, the 640-point axis's 2 x
        # 320; the tile body at 408 = 24 x 17, the 816-point axis's 2 x
        # 408; checked only, the odd 375 on an odd number of rows, against
        # its plain version and fft times the twiddle).
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
        dict(name="rmatmul_tw", variant="fft_n2_320",
             replaces=f"{PALLAS}:188",
             shape=dict(M=rows_640, n=320, k=320, n1=2),
             make=lambda: dict(x=rr(rows_640, 320), F=planes("dft", 320),
                               T=hf._twiddle_planes(2, 320, False, dev),
                               z=rr(rows_640 // 2, 640)),
             run=lambda t: hf.rdft_tw(t["x"], 2),
             plain=lambda t: hf.stage_plain(t["x"], *t["F"], *t["T"]),
             pair=lambda t: hf._rfft_last(t["z"]),
             rows=lambda t: torch.fft.fft(t["x"]),
             library=lambda t: torch.fft.rfft(t["z"]),
             library_call="rfft of the whole 640-point axis",
             flops=fft_flops(rows_640, 320, real=True) + 6 * rows_640 * 320,
             gemm_flops=4 * rows_640 * 320 * 320,
             bytes=12 * rows_640 * 320 + 8 * 2 * 320),
        dict(name="rmatmul_tw", variant="tile_n2_408", body="tile",
             replaces=f"{PALLAS}:188",
             shape=dict(M=rows_640, n=408, k=408, n1=2),
             make=lambda: dict(x=rr(rows_640, 408), F=planes("dft", 408),
                               T=hf._twiddle_planes(2, 408, False, dev),
                               z=rr(rows_640 // 2, 816)),
             run=lambda t: hf.rdft_tw(t["x"], 2),
             plain=lambda t: hf.stage_plain(t["x"], *t["F"], *t["T"]),
             library=lambda t: torch.fft.rfft(t["z"]),
             library_call="rfft of the whole 816-point axis",
             flops=fft_flops(rows_640, 408, real=True) + 6 * rows_640 * 408,
             gemm_flops=4 * rows_640 * 408 * 408,
             bytes=12 * rows_640 * 408 + 8 * 408 * 408 + 8 * 2 * 408),
        dict(name="rmatmul_tw", variant="odd_n2_375", check_only=True,
             replaces=f"{PALLAS}:188",
             shape=dict(M=m_odd, n=375, k=375, n1=2),
             make=lambda: dict(x=rr(m_odd, 375), F=planes("dft", 375),
                               T=hf._twiddle_planes(2, 375, False, dev)),
             run=lambda t: hf.rdft_tw(t["x"], 2),
             plain=lambda t: hf.stage_plain(t["x"], *t["F"], *t["T"]),
             library=lambda t: twiddled_fft(t["x"], 2),
             library_call="fft times the twiddle row r % 2"),
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

# The 480^3 and 448^3 fused plans, per direction: launches and entry
# points. Kernels 6 and 8's FFT bodies on the engine's mixed-radix kernel
# (480 = 12 x 10 x 4, 448 = 8 x 8 x 7 on both passes of each), kernel 7 on
# its mixed-radix column kernel (``dfft_x_mixed``); the dense bodies never.
FUSED_480 = (480, 480, 480)
FUSED_448 = (448, 448, 448)
FUSED_MIXED_PATH = (dict(zy_fwd=3, x_c2c=1), dict(x_c2c=1, yz_inv=3),
                    {"dfft_zy_rows": 1, "dfft_zy_cols": 1,
                     "dfft_zy_planes": 1, "dfft_x_mixed": 1},
                    {"dfft_x_mixed": 1, "dfft_yz_scratch": 1,
                     "dfft_yz_cols": 1, "dfft_yz_rows": 1})
# id -> (shape, its launches and entry points).
FUSED_SLABS = {"fused_480": (FUSED_480, FUSED_MIXED_PATH),
               "fused_448": (FUSED_448, FUSED_MIXED_PATH)}


def fused_slab_path(torch, dft, hf, gen, pid):
    """A single-card slab plan of ``FUSED_SLABS`` under "pallas" (480^3:
    0.44 GB, 448^3: 0.36 GB): launches and entry points per direction, the
    forward against torch.fft.rfftn and the roundtrip against the input,
    each direction's ms beside "xla"'s and rfftn's, and the forward's ms
    by entry point. Returns the roundtrip's launches and the times."""
    shape, (want_f, want_i, ef, ei) = FUSED_SLABS[pid]
    x = torch.randn(shape, generator=gen, device="cuda")
    plan = dft.SlabFFTPlan(dft.GlobalSize(*shape), dft.SlabPartition(1),
                           dft.Config(fft_backend="pallas"))
    c, back, fwd, inv, ent_f, ent_i = run_counted(torch, hf, plan, x)
    emit(phase="main_path", path=pid, shape=list(shape),
         launches_forward=fwd, launches_inverse=inv, entries_forward=ent_f,
         entries_inverse=ent_i)
    if fwd != expect(hf, **want_f) or inv != expect(hf, **want_i) or \
            ent_f != ef or ent_i != ei:
        fail(f"{pid} plan did not launch as expected: forward {fwd} "
             f"(entries {ent_f}), inverse {inv} (entries {ent_i})")
    if tuple(c.shape) != shape[:2] + (shape[2] // 2 + 1,) or \
            not bool(torch.isfinite(c).all()) or \
            not bool(torch.isfinite(back).all()):
        fail(f"{pid} outputs {tuple(c.shape)}, finite "
             f"{bool(torch.isfinite(c).all())}")
    _, fwd_rel = rel_err(c, torch.fft.rfftn(x))
    _, rt_rel = rel_err(back / float(math.prod(shape)), x)
    emit(phase="main_path_check", path=pid,
         forward_vs_torch_fft=fwd_rel, roundtrip_vs_input=rt_rel, tol=TOL)
    if not (fwd_rel <= TOL and rt_rel <= TOL):
        fail(f"{pid} plan wrong: forward rel {fwd_rel:.3e}, roundtrip "
             f"rel {rt_rel:.3e} (tol {TOL})")
    del back
    xla = dft.SlabFFTPlan(dft.GlobalSize(*shape), dft.SlabPartition(1),
                          dft.Config())
    cx = xla.exec_r2c(x)
    timed = dict(
        path=pid, shape=list(shape),
        pallas_forward_ms=median_ms(torch, lambda: plan.exec_r2c(x)),
        pallas_inverse_ms=median_ms(torch, lambda: plan.exec_c2r(c)),
        xla_forward_ms=median_ms(torch, lambda: xla.exec_r2c(x)),
        xla_inverse_ms=median_ms(torch, lambda: xla.exec_c2r(cx)),
        rfftn_ms=median_ms(torch, lambda: torch.fft.rfftn(x)),
        forward_entry_ms=entry_ms(torch, hf, lambda: plan.exec_r2c(x)))
    emit(phase="plan_time", **timed)
    del x, c, cx, plan, xla
    torch.cuda.empty_cache()
    return {k: fwd[k] + inv[k] for k in fwd}, timed


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
# The inverse C2R of the z axis is one launch of kernel 3's packed body,
# the 1024-point inverse of the packed spectrum, whose complex output is
# the real rows: the inverse copies nothing, and the forward's swap alone
# sets an aten limit.
PER_AXIS_PATHS = {
    "per_axis_1024": (
        (NBIG,) * 3, dict(rmatmul=1, cmatmul=2), dict(cmatmul=2, c2r=1),
        {"dfft_rdft": 1, "dfft_cdft_cols": 2},
        {"dfft_cdft_cols": 2, "dfft_c2r": 1}, (COPY_LIMIT_MS, COPY_LIMIT_MS)),
    "per_axis_2048x256x2048": (
        SPLIT, dict(rmatmul_tw=1, cmatmul_tw=1, cmatmul=3),
        dict(cmatmul_tw=1, cmatmul=2, c2r=1),
        {"dfft_rdft_tw": 1, "dfft_cdft_short": 2, "dfft_cdft_cols": 1,
         "dfft_cdft_tw_cols": 1},
        {"dfft_cdft_tw_cols": 1, "dfft_cdft_short": 1, "dfft_cdft_cols": 1,
         "dfft_c2r_packed": 1}, split_copy_limits(SPLIT)),
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
# The matmul backend: what "pallas" hands it (float64, a prime axis past
# 1024) and the "matmul" / "matmul-r2" backends themselves. No kernel of
# the port runs on these paths; the backend's dispatches are counted.
# ---------------------------------------------------------------------------


def matmul_flops(mx, n: int, rows: int, kind: str = "c2c",
                 radix2: bool = False) -> float:
    """The dense-product flops of the matmul backend on ``rows`` rows of n
    points (``mx._fft_last``, ``_rfft_last``, ``_c2r_last``), 8 a complex
    multiply-add and 4 a real row's against a complex column: a direct
    product up to ``DIRECT_MAX`` (the R2C's n/2+1 columns; the C2R's
    folded (CR, CI) pair), else the four-step's two stages (a C2R past
    ``DIRECT_MAX`` inverts the Hermitian extension, a complex transform);
    with ``radix2`` a C2C stage past ``_R2_BASE`` halves. The twiddles'
    products are left out (a few flops a point)."""
    dm = mx.DIRECT_MAX
    if kind == "c2c" and radix2 and n > mx._R2_BASE and n % 2 == 0:
        return 2 * matmul_flops(mx, n // 2, rows, "c2c", True)
    if kind != "c2c" and n <= dm:
        return 4 * rows * n * (n // 2 + 1)
    if kind == "c2r":
        return matmul_flops(mx, n, rows, "c2c", radix2)
    n1, n2 = mx._split_for(n, dm) if n > dm else (1, n)
    if n1 == 1:
        return (4 * rows * n * (n // 2 + 1) if kind == "r2c"
                else 8 * rows * n * n)
    first = (4 * rows * n1 * n2 * n2 if kind == "r2c" and n2 <= dm
             else matmul_flops(mx, n2, rows * n1, "c2c", radix2))
    return first + matmul_flops(mx, n1, rows * n2, "c2c", radix2)


def matmul_plan_flops(mx, shape, inverse: bool, extended_c2r: bool = False,
                      radix2: bool = False) -> float:
    """One direction of a single-card R2C plan on the matmul backend: the
    z axis (the R2C, or the C2R: folded, or with ``extended_c2r`` the
    Hermitian extension's complex inverse, as "pallas" runs it in float64),
    then y and x on the half spectrum."""
    X, Y, Z = shape
    half = Z // 2 + 1
    zkind = ("c2c" if extended_c2r else "c2r") if inverse else "r2c"
    return (matmul_flops(mx, Z, X * Y, zkind, radix2)
            + matmul_flops(mx, Y, X * half, "c2c", radix2)
            + matmul_flops(mx, X, Y * half, "c2c", radix2))


def matmul_bound(flops: float, nbytes: float, rate: float):
    """(bound ms, what bounds it) at a tensor-core ``rate`` (the same
    rule)."""
    return _roofline().bound(flops, nbytes, rate)


# float64 under "pallas" on one card: id -> cube edge. Forward and inverse
# each dispatch one transform an axis to the matmul backend and launch no
# kernel.
F64_PATHS = {"f64_pallas_512": N, "f64_pallas_1024": NBIG}
AXIS_DISPATCHES = {"matmul": 3}


def f64_path(torch, dft, hf, mx, gen, pid, n):
    """One float64 "pallas" plan on one card: its dispatches and launches
    per direction, the forward against ``torch.fft.rfftn`` in float64 and
    the roundtrip against the input (``F64_TOL``), each direction's time
    beside the "xla" float64 plan's, the bound of its dense products on
    the float64 tensor cores, and the peak memory."""
    shape = (n, n, n)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    x = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float64)
    plan = dft.SlabFFTPlan(dft.GlobalSize(*shape), dft.SlabPartition(1),
                           dft.Config(fft_backend="pallas", double_prec=True))
    c, back, fwd, inv, ent_f, ent_i = run_counted(torch, hf, plan, x)
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = dict(expect(hf), **AXIS_DISPATCHES)
    if fwd != want or inv != want or ent_f or ent_i:
        fail(f"{pid}: forward {fwd} (entries {ent_f}), inverse {inv} "
             f"(entries {ent_i}); expected {want} and no kernel")
    if c.dtype != torch.complex128 or back.dtype != torch.float64 or \
            tuple(c.shape) != (n, n, n // 2 + 1):
        fail(f"{pid}: outputs {tuple(c.shape)} {c.dtype}, {back.dtype}")
    ref = torch.fft.rfftn(x)
    f_abs, f_rel = rel_err(c, ref)
    del ref
    back /= float(n ** 3)
    rt_abs, rt_rel = rel_err(back, x)
    del back
    out = dict(path=pid, shape=list(shape), launches_forward=fwd,
               launches_inverse=inv, entries_forward=ent_f,
               entries_inverse=ent_i, forward_max_abs_err=f_abs,
               forward_vs_torch_fft=f_rel, roundtrip_max_abs_err=rt_abs,
               roundtrip_vs_input=rt_rel, tol=F64_TOL,
               peak_memory_gb=peak,
               device_memory_gb=torch.cuda.get_device_properties(0)
               .total_memory / 1e9)
    emit(phase="main_path", **out)
    if not (f_rel <= F64_TOL and rt_rel <= F64_TOL):
        fail(f"{pid} wrong: forward rel {f_rel:.3e}, roundtrip rel "
             f"{rt_rel:.3e} (tol {F64_TOL})")
    xla = dft.SlabFFTPlan(dft.GlobalSize(*shape), dft.SlabPartition(1),
                          dft.Config(double_prec=True))
    timed = dict(path=pid, shape=list(shape), reps=REPS_BIG,
                 pallas_forward_ms=median_ms(torch, lambda: plan.exec_r2c(x),
                                             REPS_BIG, 1),
                 pallas_inverse_ms=median_ms(torch, lambda: plan.exec_c2r(c),
                                             REPS_BIG, 1),
                 xla_forward_ms=median_ms(torch, lambda: xla.exec_r2c(x),
                                          REPS_BIG, 1),
                 xla_inverse_ms=median_ms(torch, lambda: xla.exec_c2r(c),
                                          REPS_BIG, 1))
    rbytes, cbytes = 8 * n ** 3, 16 * n * n * (n // 2 + 1)
    for d, inverse in (("forward", False), ("inverse", True)):
        flops = matmul_plan_flops(mx, shape, inverse, extended_c2r=True)
        timed[f"{d}_dense_flops"] = flops
        timed[f"{d}_bound_ms"], timed[f"{d}_bound_by"] = matmul_bound(
            flops, rbytes + cbytes, FP64_TC_FLOPS)
    timed["bound_rate"] = "float64 tensor cores, 67 TFLOP/s"
    emit(phase="plan_time", **timed)
    out.update(timed)
    del x, c, plan, xla
    torch.cuda.empty_cache()
    return {k: fwd.get(k, 0) + inv.get(k, 0) for k in want}, out


# The "matmul" backends at 512^3 in float32: id -> Config fields. Input
# uniform in [0, 1), as the reference's testcases draw it (the error the
# JAX package documents for one bfloat16 pass is on such input).
MATMUL_PATHS = {
    "matmul_highest": dict(fft_backend="matmul", mxu_precision="highest"),
    "matmul_high": dict(fft_backend="matmul", mxu_precision="high"),
    "matmul_default": dict(fft_backend="matmul", mxu_precision="default"),
    "matmul_r2": dict(fft_backend="matmul-r2"),
}


def matmul_paths(torch, dft, hf, mx, gen):
    """Each ``MATMUL_PATHS`` plan at 512^3: its dispatches and launches per
    direction, the forward against ``torch.fft.rfftn`` and the roundtrip
    (``TOL``; one bfloat16 pass ``DEFAULT_TOL`` and ``DEFAULT_RT_TOL``),
    each direction's time and the bound of its products (the bfloat16 passes at the tensor
    cores' rate when they ran there, else float32 on the CUDA cores); then
    that HIGHEST refuses to run with TF32 enabled."""
    shape = (N, N, N)
    x = torch.rand(shape, generator=gen, device="cuda")
    ref = torch.fft.rfftn(x)
    rows, want = {}, dict(expect(hf), **AXIS_DISPATCHES)
    for pid, fields in MATMUL_PATHS.items():
        plan = dft.SlabFFTPlan(dft.GlobalSize(*shape), dft.SlabPartition(1),
                               dft.Config(**fields))
        mx.MM16_ROUTE["route"] = None
        c, back, fwd, inv, ent_f, ent_i = run_counted(torch, hf, plan, x)
        if fwd != want or inv != want or ent_f or ent_i:
            fail(f"{pid}: forward {fwd}, inverse {inv}; expected {want}")
        one_pass = fields.get("mxu_precision") == "default"
        tol = DEFAULT_TOL if one_pass else TOL
        rt_tol = DEFAULT_RT_TOL if one_pass else TOL
        _, f_rel = rel_err(c, ref)
        back /= float(N ** 3)
        _, rt_rel = rel_err(back, x)
        prec = plan._mxu_st.precision if plan._mxu_st else \
            mx.current_settings().precision
        passes = {"DEFAULT": 1, "HIGH": 3, "HIGHEST": 1}[prec.name]
        route = (mx.MM16_ROUTE["route"] if prec.name != "HIGHEST"
                 else "float32 CUDA cores (IEEE, TF32 off)")
        rate = (BF16_TC_FLOPS if route == mx._TENSOR_CORES else FP32_FLOPS)
        row = dict(path=pid, config=fields, precision=prec.name,
                   bf16_passes=passes if prec.name != "HIGHEST" else 0,
                   products_ran_on=route, launches_forward=fwd,
                   launches_inverse=inv, forward_vs_torch_fft=f_rel,
                   roundtrip_vs_input=rt_rel, tol=tol, roundtrip_tol=rt_tol,
                   forward_ms=median_ms(torch, lambda: plan.exec_r2c(x),
                                        REPS_BIG, 1),
                   inverse_ms=median_ms(torch, lambda: plan.exec_c2r(c),
                                        REPS_BIG, 1))
        rbytes, cbytes = 4 * N ** 3, 8 * N * N * (N // 2 + 1)
        for d, inverse in (("forward", False), ("inverse", True)):
            flops = passes * matmul_plan_flops(
                mx, shape, inverse, radix2=fields["fft_backend"] == "matmul-r2")
            row[f"{d}_bound_ms"], row[f"{d}_bound_by"] = matmul_bound(
                flops, rbytes + cbytes, rate)
        emit(phase="matmul_path", **row)
        if not (f_rel <= tol and rt_rel <= rt_tol):
            fail(f"{pid} wrong: forward rel {f_rel:.3e} (tol {tol}), "
                 f"roundtrip rel {rt_rel:.3e} (tol {rt_tol})")
        rows[pid] = row
        del c, back, plan
    # HIGHEST must be IEEE float32: with TF32 enabled the plan refuses.
    plan = dft.SlabFFTPlan(dft.GlobalSize(*shape), dft.SlabPartition(1),
                           dft.Config(**MATMUL_PATHS["matmul_highest"]))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        plan.exec_r2c(x)
    except RuntimeError as err:
        refused = "allow_tf32" in str(err)
    else:
        refused = False
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    emit(phase="matmul_tf32_guard", refused=refused)
    if not refused:
        fail("a HIGHEST matmul plan ran with TF32 enabled")
    del x, ref, plan
    torch.cuda.empty_cache()
    return rows


def long_prime(torch, hf, gen):
    """A prime axis of ``PRIME`` points under "pallas" in float32: ``fft``
    and ``rfft`` of 8192 rows each dispatch once to the matmul backend and
    launch no kernel, within ``TOL`` of ``torch.fft``; timed beside it."""
    xc = torch.complex(torch.randn((8192, PRIME), generator=gen,
                                   device="cuda"),
                       torch.randn((8192, PRIME), generator=gen,
                                   device="cuda"))
    xr = torch.randn((8192, PRIME), generator=gen, device="cuda")
    rows = {}
    for name, run, lib in (
            ("fft", lambda: hf.fft(xc, axis=-1), lambda: torch.fft.fft(xc)),
            ("rfft", lambda: hf.rfft(xr, axis=-1),
             lambda: torch.fft.rfft(xr))):
        hf.reset_launches()
        got = run()
        torch.cuda.synchronize()
        n_f = counted(hf)
        _, rel = rel_err(got, lib())
        rows[name] = dict(rows=8192, n=PRIME, launches=n_f,
                          vs_torch_fft=rel, tol=TOL,
                          ms=median_ms(torch, run, REPS_BIG, 1),
                          library_ms=median_ms(torch, lib, REPS_BIG, 1))
        if n_f != dict(expect(hf), matmul=1) or not rel <= TOL:
            fail(f"prime {PRIME} {name}: launches {n_f}, rel {rel:.3e}")
    emit(phase="long_prime", **rows)
    del xc, xr
    torch.cuda.empty_cache()
    return rows


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
# Renderings run through the executable over two ranks, testcase 0 (the
# executable's default exchange is Peer2Peer): id -> flags.
CLI_RANK_RENDERINGS = {
    "opt1": ["-o", "1"],
    "streams": ["-snd", "Streams"],
    "a2a_pipelined": ["-comm", "All2All", "--overlap-subblocks", "2"]}


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
    return buf.getvalue(), counted(hf), per_entry(ent), seconds


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


def csv_name(argv, ranks: int) -> str:
    """Where the slab executable writes the CSV of ``argv``, under its
    ``-b`` directory: the port's ``benchmark_filename`` of the Config its
    flags make (the CPU tests hold that name equal to the JAX
    executable's)."""
    from distributedfft_tpu_torch import params as pm
    from distributedfft_tpu_torch.cli import common
    from distributedfft_tpu_torch.cli import slab as cli_slab
    from distributedfft_tpu_torch.utils.timer import benchmark_filename
    args = cli_slab.build_parser().parse_args(argv)
    cfg = pm.Config(comm_method=pm.CommMethod.parse(args.comm_method),
                    send_method=pm.SendMethod.parse(args.send_method),
                    **common.config_kwargs(args))
    g = pm.GlobalSize(args.input_dim_x, args.input_dim_y, args.input_dim_z)
    return os.path.relpath(benchmark_filename(
        args.benchmark_dir, "slab_default", cfg, g, ranks),
        args.benchmark_dir)


def cli_f64(torch, dft, hf):
    """``dfft-torch-slab -d --fft-backend pallas``, testcases 0-4 at 512^3
    on one card: no kernel, the matmul backend's dispatches (one an axis,
    each direction), results within TOL of their reference magnitude, the
    CSV where ``csv_name`` says with the sections of the plan. Returns
    (launches by path, rows)."""
    from distributedfft_tpu_torch.cli import slab as cli_slab
    from distributedfft_tpu_torch.testing import testcases as tcs
    launches, rows = {}, []
    root = tempfile.mkdtemp(prefix="chip_smoke_cli_f64_")
    sections = tcs.make_plan("slab", dft.GlobalSize(N, N, N),
                             dft.SlabPartition(1), None,
                             device="cuda").section_descriptions
    for tc in (0, 2, 3, 4, 1):
        args, blocks, k_f, k_i = CLI_CASES[tc]
        bdir = os.path.join(root, f"t{tc}")
        argv = ["-nx", str(N), "-ny", str(N), "-nz", str(N), "-comm",
                "All2All", "--fft-backend", "pallas", "-d", "-b",
                bdir] + args
        text, got, ent, secs = cli_run(torch, hf, cli_slab.main, argv)
        want = dict(expect(hf), **scaled(AXIS_DISPATCHES, k_f,
                                         AXIS_DISPATCHES, k_i))
        if got != want or ent:
            fail(f"slab {argv}: launches {got} (entries {ent}), expected "
                 f"{want} and no kernel")
        val, rel = cli_result(tc, text, N ** 3, N ** 3 / 2)
        name, run_ms, fused_ms = cli_csv(bdir, sections, blocks, 1)
        if name != csv_name(argv, 1):
            fail(f"slab {argv} wrote {name}, not {csv_name(argv, 1)}")
        launches[f"cli_slab_f64_pallas_{N}_t{tc}"] = got
        rows.append(dict(executable="slab", backend="pallas", precision="f64",
                         n=N, testcase=tc, argv=argv, seconds=secs, csv=name,
                         run_complete_ms=run_ms, fused_ms=fused_ms,
                         result=val, result_rel=rel,
                         printed=text.strip().splitlines()[-3:],
                         launches=got))
        emit(phase="cli_f64", **rows[-1])
        if rel is not None and not rel <= TOL:
            fail(f"slab {argv}: result {val} ({rel} of its reference "
                 f"magnitude)")
        torch.cuda.empty_cache()
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
    # The renderings that raised until item 2's opt 1 and item 7's STREAMS
    # and pipelined all-to-all were ported: testcase 0 through the
    # executable, the all-to-all's launches, the CSV where the port names
    # it.
    args, blocks, k_f, k_i = CLI_RANK_CASES[0]
    for rid, flags in CLI_RANK_RENDERINGS.items():
        bdir = os.path.join(outdir, f"render_{rid}")
        argv = ["-nx", str(N), "-ny", str(N), "-nz", str(N), "-p",
                str(RANKS), "--fft-backend", "pallas", "-b", bdir] + flags \
            + args
        text, got, ent, secs = cli_run(torch, hf, cli_slab.main, argv)
        want = scaled(dict(rmatmul=1, cmatmul=2), k_f,
                      dict(cmatmul=2, c2r=1), k_i)
        ent_want = scaled(A2A_ENTRIES[0], k_f, A2A_ENTRIES[1], k_i)
        if got != expect(hf, **want) or ent != ent_want:
            fail(f"rank {rank} slab {argv}: launches {got} (entries "
                 f"{ent}), expected {want} ({ent_want})")
        out["launches"][f"cli_slab_{rid}_{N}_t0"] = got
        row = dict(rendering=rid, testcase=0, argv=argv, seconds=secs,
                   entries=ent)
        dist.barrier()      # rank 0 has written the CSV
        if rank == 0:
            name, run_ms, fused_ms = cli_csv(bdir, sections, blocks, RANKS)
            if name != csv_name(argv, RANKS):
                fail(f"slab {argv} wrote {name}, not "
                     f"{csv_name(argv, RANKS)}")
            row.update(csv=name, run_complete_ms=run_ms, fused_ms=fused_ms,
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
    t0 = time.perf_counter()
    out["selftest"] = selftest_ranks(torch, dist, rank, outdir)
    out["selftest_seconds"] = time.perf_counter() - t0
    with open(os.path.join(outdir, f"cli_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    multihost.shutdown()


# ---------------------------------------------------------------------------
# The resilience layer: the guards on the single-card main paths, faults
# injected across ranks, the executables' --selftest
# ---------------------------------------------------------------------------

GUARD_MODES = ("off", "check", "enforce")
GUARD_PATHS = {"fused_512": (N,) * 3, "per_axis_1024": (NBIG,) * 3}
# PR 13's "pallas" times of the unguarded plans, forward / inverse ms
# (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W; PERF.md section 5), and
# the run-to-run spread the plans' times stay within.
PR13_MS = {"fused_512": (1.76, 1.75), "per_axis_1024": (12.73, 12.30)}
PR13_SPREAD = 0.10
PEAK_SHARE = 0.01     # guards on: peak device memory within 1% of off
# The wire faults of the two-rank phase. A top-exponent bit flip blows a
# value below 2 up to ~1e38 (the guard sees it) but shrinks a larger one
# to ~1e-38: at 512^3 the payload's values are ~512, so flipping one
# removes ~1e-11 of the energy, far under the tolerance, in the JAX
# package as here. The bit flip is aimed (``@seed=``) at the first payload
# element that is below 2 on both ranks.
RESILIENCE_FAULTS = ("wire:nan", "wire:bitflip", "wire:scale:0.5")
FLIP_VISIBLE = (1e-3, 2.0)
SELFTEST_N = (NBIG, 128)   # the host reference runs at 128^3 only
SELFTEST_RANKS_N = 256


def guard_bound_ms(shape):
    """(forward, inverse) least time of the guard's own reads at the HBM
    rate: the forward's Parseval check reads the input (4 bytes a point)
    and the spectrum (8 bytes a bin); the inverse's finiteness check reads
    the real output."""
    X, Y, Z = shape
    n, bins = X * Y * Z, X * Y * (Z // 2 + 1)
    return (1e3 * (4 * n + 8 * bins) / HBM_BYTES, 1e3 * 4 * n / HBM_BYTES)


def faulted_verdict(torch, spec, fn):
    """Run fn with ``$DFFT_FAULT_SPEC`` set to spec (None: unset), the
    metrics counted from zero: {"violation": the GuardViolation's check,
    value, tolerance and fingerprint, or None; "counters": the counters
    that moved}."""
    from distributedfft_tpu_torch import obs
    from distributedfft_tpu_torch.resilience import GuardViolation, inject
    obs.reset()
    if spec:
        os.environ[inject.ENV_VAR] = spec
    try:
        try:
            fn()
            v = None
        except GuardViolation as e:
            v = dict(check=e.check, value=e.value, tolerance=e.tolerance,
                     fingerprint=e.fingerprint)
    finally:
        os.environ.pop(inject.ENV_VAR, None)
    torch.cuda.synchronize()
    return {"violation": v, "counters": obs.metrics.snapshot()["counters"]}


def same_violation(rows, what: str) -> dict:
    """Every rank's row raised, with one check and one fingerprint: the
    shared verdict."""
    vs = [r["violation"] for r in rows]
    if any(v is None for v in vs) or \
            len({(v["check"], json.dumps(v["fingerprint"], sort_keys=True))
                 for v in vs}) != 1:
        fail(f"{what}: the ranks did not all raise one GuardViolation: {vs}")
    return vs[0]


def guards_main(torch, dft, hf, gen, plan_times):
    """The single-card slab plan under "pallas" at 512^3 (fused kernels
    6-8) and 1024^3 (per-axis kernels 1-3) with guards off, check and
    enforce: the outputs bit for bit off's, the same launches and entry
    points, no violation; ms per direction of each mode and the guard's
    extra ms against its bound; the peak device memory of a roundtrip in
    each mode over what was allocated before it (within ``PEAK_SHARE`` of
    off's); the unguarded plans' times beside PR 13's."""
    from distributedfft_tpu_torch import obs
    rows = {}
    for pid, shape in GUARD_PATHS.items():
        reps, warm = (REPS, WARMUP) if shape[0] == N else (REPS_BIG, 1)
        x = torch.randn(shape, generator=gen, device="cuda")
        bounds = guard_bound_ms(shape)
        ref, modes = None, {}
        for mode in GUARD_MODES:
            plan = dft.SlabFFTPlan(dft.GlobalSize(*shape), dft.SlabPartition(1),
                                   dft.Config(fft_backend="pallas",
                                              guards=mode))
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            obs.reset()
            got = run_counted(torch, hf, plan, x)
            peak = torch.cuda.max_memory_allocated() - base
            c, back = got[:2]
            row = dict(launches_forward=got[2], launches_inverse=got[3],
                       entries_forward=got[4], entries_inverse=got[5],
                       violations=obs.metrics.snapshot()["counters"],
                       peak_gb=peak / 1e9,
                       forward_ms=median_ms(torch, lambda: plan.exec_r2c(x),
                                            reps, warm),
                       inverse_ms=median_ms(torch, lambda: plan.exec_c2r(c),
                                            reps, warm))
            if ref is None:
                ref = got
            else:
                row["bit_equal_to_off"] = bool(torch.equal(c, ref[0])
                                              and torch.equal(back, ref[1]))
                if not row["bit_equal_to_off"] or got[2:] != ref[2:]:
                    fail(f"{pid} guards {mode}: not off's bits or launches: "
                         f"{row}")
                off = modes["off"]
                row["peak_over_off"] = peak / (off["peak_gb"] * 1e9) - 1
                for d, b in zip(("forward", "inverse"), bounds):
                    row[f"guard_{d}_ms"] = row[f"{d}_ms"] - off[f"{d}_ms"]
                    row[f"guard_{d}_bound_ms"] = b
                if row["peak_over_off"] > PEAK_SHARE:
                    fail(f"{pid} guards {mode}: peak memory {peak} bytes, "
                         f"{row['peak_over_off']:.2%} over off's")
            if any(k.startswith("guard.") for k in row["violations"]):
                fail(f"{pid} guards {mode}: a clean run violated: {row}")
            modes[mode] = row
            if mode != "off":
                del c, back
            del got, plan
        del ref, x
        torch.cuda.empty_cache()
        unguarded = plan_times[pid]
        rows[pid] = dict(
            shape=list(shape), modes=modes,
            unguarded_forward_ms=unguarded["pallas_forward_ms"],
            unguarded_inverse_ms=unguarded["pallas_inverse_ms"],
            pr13_ms=list(PR13_MS[pid]),
            within_pr13_spread=all(
                abs(unguarded[f"pallas_{d}_ms"] / w - 1) <= PR13_SPREAD
                for d, w in zip(("forward", "inverse"), PR13_MS[pid])))
        emit(phase="guards_main", path=pid, **rows[pid])
    return rows


def resilience_ranks(torch, dist, dft, hf, rank, xl, a2a_fwd, wall_ms):
    """One rank's resilience cases on the 512^3 slab plan over two gloo
    ranks sharing the card ("pallas"): enforce under each wire fault and
    both exchanges; check counting; a bf16 wire over its error budget
    demoted to native (the next call bit for bit the all-to-all's); the
    fused-wire ring (kernels 9-11) under NaN, both directions; a ring that
    fails walking send -> opt to the all-to-all's bits; a kernel launch
    that fails never demoted; the default plan posting no collective but
    its exchange; the cost of the ladder's agreement collective on a ring
    plan."""
    from distributedfft_tpu_torch import obs
    from distributedfft_tpu_torch.models import slab as slab_mod
    from distributedfft_tpu_torch.ops import _build
    from distributedfft_tpu_torch.parallel import transpose as tr
    from distributedfft_tpu_torch.resilience import fallback
    g, part = dft.GlobalSize(N, N, N), dft.SlabPartition(RANKS)

    def plan(seq="ZY_Then_X", **fields):
        for k, enum in (("comm_method", dft.CommMethod),
                        ("send_method", dft.SendMethod)):
            if k in fields:
                fields[k] = enum.parse(fields[k])
        return dft.SlabFFTPlan(g, part, dft.Config(fft_backend="pallas",
                                                   **fields), sequence=seq)

    def counters():
        return obs.metrics.snapshot()["counters"]

    # The first element of the exchange payload (this rank's block after
    # the z and y transforms, as it goes on the wire) in FLIP_VISIBLE on
    # every rank.
    pay = plan()._fwd_parts()[0](xl).real.abs().reshape(-1)[:1 << 20]
    lo, hi = FLIP_VISIBLE
    visible = ((pay >= lo) & (pay < hi)).to(torch.int32)
    dist.all_reduce(visible, op=dist.ReduceOp.MIN)
    flip_seed = int(torch.nonzero(visible)[0])
    del pay, visible
    out = {"bitflip_seed": flip_seed}
    for comm in ("All2All", "Peer2Peer"):
        for spec in RESILIENCE_FAULTS:
            if spec == "wire:bitflip":
                spec += f"@seed={flip_seed}"
            p = plan(comm_method=comm, guards="enforce")
            row = faulted_verdict(torch, spec, lambda: p.exec_r2c(xl))
            if row["violation"] is None:
                fail(f"rank {rank}: {comm} under {spec} did not raise")
            out[f"enforce_{comm}_{spec}"] = row
    p = plan(guards="check")
    row = faulted_verdict(torch, "wire:nan", lambda: p.exec_r2c(xl))
    if row["violation"] is not None or \
            row["counters"].get("guard.parseval_violations") != 1:
        fail(f"rank {rank}: check mode under wire:nan: {row}")
    out["check_wire:nan"] = row
    p = plan(wire_dtype="bf16", wire_error_budget=1e-9, guards="check")
    row = faulted_verdict(torch, None, lambda: p.exec_r2c(xl))
    row.update(wire_after=p.config.wire_dtype,
               next_call_equals_native=bool(torch.equal(p.exec_r2c(xl),
                                                        a2a_fwd)))
    if row["wire_after"] != "native" or not row["next_call_equals_native"] \
            or row["counters"].get("fallback.wire_demotions") != 1:
        fail(f"rank {rank}: the bf16 wire over its budget: {row}")
    out["wire_budget_demotion"] = row
    p = plan("Z_Then_YX", send_method="RingOverlap", wire_dtype="bf16",
             fused_wire=True, guards="enforce")
    c = p.exec_r2c(xl)
    hf.reset_launches()
    row = {"forward": faulted_verdict(torch, "wire:nan",
                                      lambda: p.exec_r2c(xl)),
           "inverse": faulted_verdict(torch, "wire:nan",
                                      lambda: p.exec_c2r(c)),
           "launches": counted(hf)}
    if row["forward"]["violation"] is None or \
            row["inverse"]["violation"] is None or \
            not all(row["launches"][k] for k in ("enc_pack", "dec_unpack",
                                                 "dec_cmatmul")):
        fail(f"rank {rank}: the fused-wire ring under wire:nan: {row}")
    out["ring_fused_wire_nan"] = row
    del c
    real_ring, real_a2a = slab_mod.ring_transpose, tr.all_to_all_transpose

    def ring_fails(*a, **k):
        raise RuntimeError("patched ring failure")

    def opt1_fails(x, group, split, concat, *, realigned=False,
                   wire="native"):
        if realigned:
            raise RuntimeError("patched realigned all-to-all failure")
        return real_a2a(x, group, split, concat, wire=wire)

    slab_mod.ring_transpose, tr.all_to_all_transpose = ring_fails, opt1_fails
    try:
        p = plan(send_method="Ring")
        obs.reset()
        y = p.exec_r2c(xl)
    finally:
        slab_mod.ring_transpose, tr.all_to_all_transpose = real_ring, real_a2a
    row = dict(counters=counters(), send=p.config.send_method.value,
               opt=p.config.opt, equals_a2a=bool(torch.equal(y, a2a_fwd)))
    if (row["counters"].get("fallback.send_demotions"),
            row["counters"].get("fallback.opt_demotions"),
            row["counters"].get("fallback.demotions"),
            row["send"], row["opt"], row["equals_a2a"]) != \
            (1, 1, 2, "Sync", 0, True):
        fail(f"rank {rank}: the ring's ladder: {row}")
    out["ladder"] = row
    del y
    real_launch = hf._launch

    def launch_fails(kernel, fn, *args):
        raise _build.KernelError(f"{fn}: CUDA error 700 (patched launch)")

    hf._launch = launch_fails
    try:
        p = plan(send_method="Ring")
        obs.reset()
        try:
            p.exec_r2c(xl)
            err = None
        except _build.KernelError as e:
            err = str(e)
    finally:
        hf._launch = real_launch
    row = dict(raised=err, counters=counters(),
               send=p.config.send_method.value)
    if err is None or row["counters"].get("fallback.demotions", 0) or \
            row["send"] != "Ring":
        fail(f"rank {rank}: a failing launch on a ring plan: {row}")
    out["kernel_error"] = row
    # Collectives posted beside the exchange: none on the default plan; on
    # a ring plan (rungs left) the agreement's one-element all-reduce.
    calls, real_reduce = [], dist.all_reduce

    def reduce_counted(*a, **k):
        calls.append(1)
        return real_reduce(*a, **k)

    ring = plan(send_method="Ring")
    dist.all_reduce = reduce_counted
    try:
        plan().exec_r2c(xl)
        default_calls = len(calls)
        ring.exec_r2c(xl)
        ring_calls = len(calls) - default_calls
    finally:
        dist.all_reduce = real_reduce
    if default_calls or ring_calls != 1:
        fail(f"rank {rank}: collectives beside the exchange: default "
             f"{default_calls}, ring {ring_calls}")
    agree = []
    for _ in range(20):
        dist.barrier()
        t0 = time.perf_counter()
        fallback._any_rank_failed(ring, False)
        agree.append(1e3 * (time.perf_counter() - t0))
    ring_on = wall_ms(lambda: ring.exec_r2c(xl))
    os.environ["DFFT_FALLBACK"] = "off"
    try:
        ring_off = wall_ms(lambda: ring.exec_r2c(xl))
    finally:
        os.environ.pop("DFFT_FALLBACK")
    out["collectives"] = dict(
        default_plan_all_reduces=default_calls,
        ring_plan_all_reduces=ring_calls,
        agreement_ms=statistics.median(agree),
        ring_forward_ms_ladder_on=ring_on, ring_forward_ms_ladder_off=ring_off)
    return out


def guard_case(torch, make_plan, fwd_name, gen_seed, what):
    """One enforce run under ``wire:nan`` of a distributed plan of the
    pencil or batched phase: this rank's verdict (it must raise)."""
    gen = torch.Generator(device="cuda").manual_seed(gen_seed)
    plan = make_plan()
    x = torch.randn(plan.local_input_shape, generator=gen, device="cuda")
    row = faulted_verdict(torch, "wire:nan",
                          lambda: getattr(plan, fwd_name)(x))
    if row["violation"] is None:
        fail(f"{what}: enforce under wire:nan did not raise")
    return row


def selftest_lines(text: str) -> list:
    return [ln for ln in text.splitlines() if ln.startswith("selftest: ")]


def selftest_single_card(torch, dft, hf):
    """``dfft-torch-slab ... --fft-backend pallas -t 3 --selftest`` in this
    process at 1024^3 (no host reference: the cube exceeds
    ``DEFAULT_REF_MAX``) and at 128^3 (with it): PASS, then the testcase."""
    from distributedfft_tpu_torch.cli import slab as cli_slab
    rows = {}
    for n in SELFTEST_N:
        bdir = tempfile.mkdtemp(prefix="chip_smoke_selftest_")
        argv = ["-nx", str(n), "-ny", str(n), "-nz", str(n), "--fft-backend",
                "pallas", "-t", "3", "--selftest", "-b", bdir]
        text, got, ent, secs = cli_run(torch, hf, cli_slab.main, argv)
        lines = selftest_lines(text)
        with_ref = n ** 3 <= (1 << 21)
        if len(lines) != 1 or not lines[0].startswith("selftest: PASS") or \
                ("reference" in lines[0]) != with_ref:
            fail(f"slab {argv}: selftest line {lines}")
        rows[f"selftest_{n}"] = dict(argv=argv, seconds=secs, launches=got,
                                     selftest=lines[0],
                                     result_max=printed(text,
                                                        "Result (max): "))
        torch.cuda.empty_cache()
    return rows


def selftest_ranks(torch, dist, rank: int, outdir: str) -> dict:
    """Two ranks of the slab executable under ``wire:nan``: with
    ``--selftest --guards check --obs --obs-dir`` both exit 1 printing
    ``selftest: FAIL`` and each event log (valid) carries the injected
    fault and the violation; with ``--guards enforce -t 3 --obs-dir`` each
    rank raises and leaves a valid flight-recorder dump."""
    import io
    from distributedfft_tpu_torch import obs
    from distributedfft_tpu_torch.cli import slab as cli_slab
    from distributedfft_tpu_torch.resilience import GuardViolation, inject
    n = SELFTEST_RANKS_N
    size = ["-nx", str(n), "-ny", str(n), "-nz", str(n), "-p", str(RANKS),
            "--fft-backend", "pallas"]
    logs = os.path.join(outdir, "selftest_obs")
    dumps = os.path.join(outdir, "selftest_dumps")
    out = {}
    os.environ[inject.ENV_VAR] = "wire:nan"
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli_slab.main(size + ["-t", "3", "--selftest", "--guards",
                                       "check", "--obs", "--obs-dir", logs,
                                       "-b", os.path.join(outdir, "st_b")])
        obs.reset_enablement()
        obs.disable_console()
        dist.barrier()
        obs.flightrec.clear()
        try:
            cli_slab.main(size + ["-t", "3", "--guards", "enforce",
                                  "--obs-dir", dumps, "-b",
                                  os.path.join(outdir, "st_b2")])
            raised = None
        except GuardViolation as e:
            raised = e.check
    finally:
        os.environ.pop(inject.ENV_VAR, None)
        obs.reset_enablement()
        obs.disable_console()
    text = buf.getvalue()
    log = os.path.join(logs, f"events-{os.getpid()}.jsonl")
    with open(log) as f:
        names = sorted({json.loads(ln)["name"] for ln in f if ln.strip()})
    dump = obs.flightrec.last_dump()
    out = dict(rc=rc, selftest=selftest_lines(text), raised=raised,
               events=obs.validate_events_file(log), event_names=names,
               dump=dump, dump_records=(obs.flightrec.validate_dump_file(
                   dump["path"]) if dump else None))
    if rc != 1 or not any(ln.startswith("selftest: FAIL")
                          for ln in out["selftest"]) or raised is None or \
            not {"inject.wire_fault", "guard.violation"} <= set(names) or \
            dump is None or dump["trigger"] != "guard_violation":
        fail(f"rank {rank}: the executable's selftest under wire:nan: {out}")
    return out


# ---------------------------------------------------------------------------
# The solvers (solvers/, testing/workloads.py) on the card
# ---------------------------------------------------------------------------

POISSON_N = NBIG          # BASELINE config #5's solver at the reference's
                          # 1024^3 (2048^3: 34.4 GB a float32 field)
NS3D_N = N                # Taylor-Green, 3 RK4 steps
NS3D_STEPS = 3
NS3D_DT = 5e-3
NS2D = (16, 4096)         # ns2d_chain: BASELINE config #4's images, the
                          # batch cut from 64 to bound RK4's state
NS2D_STEPS = 2
NS2D_DT = 1e-3
CONV_IMAGES = (64, 4064)  # BASELINE config #4: 64 x 4064^2 images, 33^2
CONV_KERNEL = 33          # kernel, "same" -> a 64 x 4096^2 plan
CONV_SMOOTH = (8, 4096, 225)  # images, extent, kernel: 4320 = good_size
CONV_PIXELS = 16
DCT_N = N                 # dctn over a 512^3 cube: 1024-point extensions
GRAD_N = N                # Poisson solve_fn's gradient under "xla"
NS_GRAD = (2, 64, 4, 1e-2)  # batch, n, steps, dt (float64, "matmul")
ENERGY_TOL = 1e-5         # inviscid energy drift, float32
GRAD_TOL = 1e-4
RANK_POISSON_N = N        # two ranks: the 512^3 solve
RANK_DIRICHLET_N = 256    # the extended box (interior 128^3)
RANK_GRAD_N = 128
WIRE_TOL = 2e-2


def peak_gb(torch, base: int) -> float:
    """Peak device memory since the last reset, over ``base`` bytes."""
    return (torch.cuda.max_memory_allocated() - base) / 1e9


def fresh_peak(torch) -> int:
    """Free the cache, reset the peak; the bytes allocated now."""
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def host_ms(torch, fn, reps: int = 3) -> float:
    """Median host wall ms of fn, each run fenced by a synchronize."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def counted_call(torch, hf, fn):
    """fn() once with the launches counted from zero: (result, launches,
    entry points)."""
    hf.reset_launches()
    with entry_counts(hf) as ent:
        out = fn()
        torch.cuda.synchronize()
    return out, counted(hf), per_entry(ent)


def combine(a: dict, ka: int, b: dict, kb: int) -> dict:
    """ka a + kb b, key by key."""
    return {k: ka * a.get(k, 0) + kb * b.get(k, 0) for k in set(a) | set(b)}


def plan_directions(torch, hf, plan, x):
    """One forward and one inverse of ``plan`` counted: (launches forward,
    inverse, entry points forward, inverse)."""
    _, _, f, i, ef, ei = run_counted(torch, hf, plan, x)
    return f, i, ef, ei


def solver_poisson(torch, dft, hf, dev):
    """Poisson at 1024^3 on one card under "pallas": the manufactured
    solution, integer mode against "xla", one forward and one inverse of
    the plan's launches per solve, its time beside the plan's directions
    and the symbol multiply's bound, the chain, the peak."""
    from distributedfft_tpu_torch.solvers import PoissonSolver
    from distributedfft_tpu_torch.testing import workloads
    n = POISSON_N
    g = dft.GlobalSize(n, n, n)
    base = fresh_peak(torch)
    plan = dft.SlabFFTPlan(g, dft.SlabPartition(1),
                           dft.Config(fft_backend="pallas"))
    t = torch.arange(n, device=dev, dtype=torch.float32) * (2 * math.pi / n)
    u = (torch.sin(t)[:, None, None] * torch.sin(2 * t)[None, :, None]
         * torch.cos(3 * t)[None, None, :])
    f = -14.0 * u
    solver = PoissonSolver(plan, mode="physical")
    got, launches, ents = counted_call(torch, hf, lambda: solver.solve(f))
    peak = peak_gb(torch, base)
    lf, li, ef, ei = plan_directions(torch, hf, plan, f)
    want, want_ents = combine(lf, 1, li, 1), combine(ef, 1, ei, 1)
    if launches != want or ents != want_ents:
        fail(f"poisson {n}^3: a solve launched {launches} ({ents}), not one "
             f"forward and one inverse of the plan: {want} ({want_ents})")
    _, rel = rel_err(got, u)
    del got
    if not rel <= TOL:
        fail(f"poisson {n}^3 manufactured solution: rel {rel:.3e} > {TOL}")
    solve_ms = median_ms(torch, lambda: solver.solve(f), reps=REPS_BIG,
                         warmup=1)
    fwd_ms = median_ms(torch, lambda: plan.exec_fwd(f), reps=REPS_BIG,
                       warmup=1)
    c = plan.exec_fwd(f)
    inv_ms = median_ms(torch, lambda: plan.exec_inv(c), reps=REPS_BIG,
                       warmup=1)
    sym = solver._symbol()
    mul_ms = median_ms(torch, lambda: torch.view_as_real(c).mul_(
        sym.unsqueeze(-1)), reps=REPS_BIG, warmup=1)
    mul_bytes = 2 * c.numel() * c.element_size() + sym.numel() * 4
    del c, solver, sym
    # Integer mode: "pallas" against cuFFT on the same random forcing.
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    fr = torch.rand((n, n, n), generator=gen, device=dev)
    a = PoissonSolver(plan, mode="integer").solve(fr)
    sx = PoissonSolver(dft.SlabFFTPlan(g, dft.SlabPartition(1), dft.Config()),
                       mode="integer")
    _, int_rel = rel_err(a, sx.solve(fr))
    del a, sx
    if not int_rel <= TOL:
        fail(f"poisson {n}^3 integer mode vs xla: rel {int_rel:.3e}")
    torch.cuda.empty_cache()
    chain_k = 8
    fn, cplan = workloads.poisson_chain(chain_k, n, "pallas")
    hf.reset_launches()
    s = fn(fr)
    chain_launches = counted(hf)
    if not math.isfinite(s) or chain_launches != combine(want, chain_k, {},
                                                         0):
        fail(f"poisson_chain({chain_k}, {n}): sum {s}, launches "
             f"{chain_launches}")
    chain_ms = host_ms(torch, lambda: fn(fr), reps=2) / chain_k
    del fr, fn, cplan, u, f, plan
    torch.cuda.empty_cache()
    bound_ms = 1e3 * mul_bytes / HBM_BYTES
    row = dict(path=f"poisson_{n}", shape=[n] * 3, backend="pallas",
               launches_per_solve=want, entries_per_solve=ents,
               manufactured_rel=rel, integer_vs_xla_rel=int_rel, tol=TOL,
               solve_ms=solve_ms, forward_ms=fwd_ms, inverse_ms=inv_ms,
               multiply_ms=mul_ms, multiply_bound_ms=bound_ms,
               directions_plus_multiply_bound_ms=fwd_ms + inv_ms + bound_ms,
               chain_k=chain_k, chain_ms_per_solve=chain_ms, chain_sum=s,
               peak_memory_gb=peak,
               cut="2048^3 does not fit one card (34.4 GB a float32 field)")
    emit(phase="solver", **row)
    return {f"poisson_{n}": want}, row


def solver_ns3d(torch, dft, hf, dev):
    """Navier-Stokes 3D at 512^3 (slab, one card: the fused kernels 6-8):
    inviscid Taylor-Green, 3 RK4 steps, against "xla", energy conserved,
    launches per step against 4 x (3 forward + 6 inverse) directions."""
    from distributedfft_tpu_torch.solvers import NavierStokes3D
    n = NS3D_N
    g = dft.GlobalSize(n, n, n)
    base = fresh_peak(torch)
    t = torch.arange(n, device=dev, dtype=torch.float32) * (2 * math.pi / n)
    cx, sx = torch.cos(t), torch.sin(t)
    u0 = torch.stack([cx[:, None, None] * sx[None, :, None] * sx[None, None],
                      -sx[:, None, None] * cx[None, :, None] * sx[None, None],
                      torch.zeros((n, n, n), device=dev)])
    outs, rows = {}, {}
    for be in ("pallas", "xla"):
        plan = dft.SlabFFTPlan(g, dft.SlabPartition(1),
                               dft.Config(fft_backend=be))
        ns = NavierStokes3D(plan, 0.0)
        step = ns.step_fn(NS3D_DT)
        with torch.no_grad():
            ch = ns.to_spectral(u0)
            e0 = float(ns.diagnostics(ch)["energy"])
            rest = NS3D_STEPS
            if be == "pallas":
                ch, per_step, ents = counted_call(torch, hf,
                                                  lambda: step(ch))
                rest -= 1
            for _ in range(rest):
                ch = step(ch)
            eT = float(ns.diagnostics(ch)["energy"])
            outs[be] = ns.to_physical(ch)
            rows[be] = dict(energy0=e0, energyT=eT,
                            energy_drift=abs(eT - e0) / e0,
                            step_ms=median_ms(torch, lambda: step(ch),
                                              reps=REPS_BIG, warmup=1))
        del ns, step, ch, plan
        torch.cuda.empty_cache()
    want_f, want_i, ent_f, ent_i = FUSED_PATH
    want = combine(expect(hf, **want_f), 12, expect(hf, **want_i), 24)
    want_ents = combine(ent_f, 12, ent_i, 24)
    if per_step != want or ents != want_ents:
        fail(f"ns3d {n}^3: one step launched {per_step} ({ents}), not "
             f"4 x (3 forward + 6 inverse): {want} ({want_ents})")
    _, rel = rel_err(outs["pallas"], outs["xla"])
    peak = peak_gb(torch, base)
    del outs, u0
    drift = rows["pallas"]["energy_drift"]
    if not (rel <= TOL and drift <= ENERGY_TOL
            and abs(rows["pallas"]["energy0"] - 0.125) <= 1e-5):
        fail(f"ns3d {n}^3: vs xla rel {rel:.3e}, energy {rows}")
    row = dict(path=f"ns3d_{n}", shape=[3, n, n, n], steps=NS3D_STEPS,
               dt=NS3D_DT, launches_per_step=per_step,
               entries_per_step=ents, vs_xla_rel=rel, tol=TOL,
               energy_tol=ENERGY_TOL, pallas=rows["pallas"],
               xla=rows["xla"], peak_memory_gb=peak)
    emit(phase="solver", **row)
    return {f"ns3d_{n}": per_step}, row


def direct_conv_pixels(img, ker, pixels):
    """Direct float64 sums on the host of ``mode="same"`` convolution
    pixels of the device stack ``img`` (np.convolve's centering: output i
    is full i + (k-1)//2), each from its own k x k window."""
    k = ker.shape[0]
    s = (k - 1) // 2
    n = img.shape[1]
    kf = ker.astype(np.float64)
    out = []
    for b, i, j in pixels:
        # full[i + s] = sum_p img[i + s - p] ker[p]
        r0, r1 = max(0, i + s - k + 1), min(n, i + s + 1)
        c0, c1 = max(0, j + s - k + 1), min(n, j + s + 1)
        win = img[b, r0:r1, c0:c1].double().cpu().numpy()
        acc = 0.0
        for ii in range(r0, r1):
            for jj in range(c0, c1):
                acc += win[ii - r0, jj - c0] * kf[i + s - ii, j + s - jj]
        out.append(acc)
    return np.asarray(out)


def solver_convolve(torch, dft, hf, dev):
    """BASELINE config #4's convolution: 64 x 4064^2 images, a 33^2 kernel,
    "same", on the 64 x 4096^2 batched plan (kernels 2, 4 and 5); against
    the "xla" convolver and 16 direct float64 sums on the host; its time
    beside the plan's roundtrip; then a 5-smooth extent (4320 =
    good_size(4096 + 225 - 1) = 9 x 480), whose first stages run kernels 4
    and 5 on the engine's mixed-radix kernel (never a tile body)."""
    from distributedfft_tpu_torch.solvers import make_convolver
    b, n = CONV_IMAGES
    k = CONV_KERNEL
    base = fresh_peak(torch)
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    img = torch.rand((b, n, n), generator=gen, device=dev)
    ker = np.random.default_rng(SEED).random((k, k)).astype(np.float32)
    cv = make_convolver(ker, (n, n), batch=b, mode="same",
                        config=dft.Config(fft_backend="pallas"))
    ext = tuple(cv.plan.input_shape)
    out, launches, ents = counted_call(torch, hf, lambda: cv(img))
    peak = peak_gb(torch, base)
    xin = torch.zeros(ext, device=dev)
    lf, li, ef, ei = plan_directions(torch, hf, cv.plan, xin)
    want, want_ents = combine(lf, 1, li, 1), combine(ef, 1, ei, 1)
    if launches != want or ents != want_ents:
        fail(f"convolution: a call launched {launches} ({ents}), not one "
             f"forward and one inverse of the plan: {want} ({want_ents})")
    c = cv.plan.exec_forward(xin)
    rt_ms = (median_ms(torch, lambda: cv.plan.exec_forward(xin),
                       reps=REPS_BIG, warmup=1)
             + median_ms(torch, lambda: cv.plan.exec_inverse(c),
                         reps=REPS_BIG, warmup=1))
    del xin, c
    call_ms = median_ms(torch, lambda: cv(img), reps=REPS_BIG, warmup=1)
    rng = np.random.default_rng(SEED + 1)
    pix = [(int(rng.integers(b)), int(rng.integers(n)), int(rng.integers(n)))
           for _ in range(CONV_PIXELS - 4)] + [(0, 0, 0), (b - 1, n - 1, 0),
                                              (1, 0, n - 1), (2, 5, 7)]
    got_pix = np.asarray([float(out[q]) for q in pix])
    ref_pix = direct_conv_pixels(img, ker, pix)
    pix_err = float(np.max(np.abs(got_pix - ref_pix))) / float(
        out.abs().max())
    del cv
    torch.cuda.empty_cache()
    cvx = make_convolver(ker, (n, n), batch=b, mode="same",
                         config=dft.Config())
    _, xla_rel = rel_err(out, cvx(img))
    xla_ms = median_ms(torch, lambda: cvx(img), reps=REPS_BIG, warmup=1)
    del cvx, out, img
    torch.cuda.empty_cache()
    if not (xla_rel <= TOL and pix_err <= TOL):
        fail(f"convolution: vs xla rel {xla_rel:.3e}, direct pixels rel "
             f"{pix_err:.3e}")
    # The 5-smooth extent.
    sb, sn, sk = CONV_SMOOTH
    img = torch.rand((sb, sn, sn), generator=gen, device=dev)
    ker2 = np.random.default_rng(SEED + 2).random((sk, sk)).astype(np.float32)
    cvs = make_convolver(ker2, (sn, sn), batch=sb, mode="same",
                         config=dft.Config(fft_backend="pallas"))
    hf.reset_launches()
    with entry_counts(hf) as seen:
        outs = cvs(img)
        torch.cuda.synchronize()
    smooth_launches, smooth_ents = counted(hf), per_entry(seen)
    smooth_pairs = on_the_engine(seen, f"convolution at {sn}")
    smooth_ms = median_ms(torch, lambda: cvs(img), reps=REPS_BIG, warmup=1)
    sext = list(cvs.plan.input_shape)
    del cvs
    torch.cuda.empty_cache()
    cvsx = make_convolver(ker2, (sn, sn), batch=sb, mode="same",
                          config=dft.Config())
    _, smooth_rel = rel_err(outs, cvsx(img))
    smooth_xla_ms = median_ms(torch, lambda: cvsx(img), reps=REPS_BIG,
                              warmup=1)
    del cvsx, outs, img
    torch.cuda.empty_cache()
    if not smooth_rel <= TOL or smooth_launches.get("matmul"):
        fail(f"convolution at the 5-smooth extent {sext}: rel "
             f"{smooth_rel:.3e}, launches {smooth_launches}")
    row = dict(path=f"conv_{b}x{n}", images=[b, n, n], kernel=[k, k],
               plan_shape=list(ext), mode="same", backend="pallas",
               launches_per_call=want, entries_per_call=ents,
               vs_xla_rel=xla_rel, direct_pixels_rel=pix_err,
               pixels=CONV_PIXELS, tol=TOL, call_ms=call_ms,
               plan_roundtrip_ms=rt_ms, xla_call_ms=xla_ms,
               peak_memory_gb=peak,
               smooth=dict(images=[sb, sn, sn], kernel=[sk, sk],
                           plan_shape=sext, launches=smooth_launches,
                           entries=smooth_ents, kernel_entries=smooth_pairs,
                           vs_xla_rel=smooth_rel,
                           call_ms=smooth_ms, xla_call_ms=smooth_xla_ms))
    emit(phase="solver", **row)
    return {f"conv_{b}x{n}": want,
            f"conv_smooth_{sext[1]}": smooth_launches}, row


def smooth_vorticity(torch, dev, batch: int, n: int, modes: int = 4,
                     seed: int = SEED):
    """A (batch, n, n) float32 vorticity of random low modes (|m| <= modes
    per axis), made on the device."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    t = torch.arange(n, device=dev, dtype=torch.float32) * (2 * math.pi / n)
    w = torch.zeros((batch, n, n), device=dev)
    for mx_ in range(modes + 1):
        for my in range(-modes, modes + 1):
            a = torch.rand((batch, 1, 1), generator=gen, device=dev) - 0.5
            ph = 2 * math.pi * torch.rand((batch, 1, 1), generator=gen,
                                          device=dev)
            w += a * torch.cos(mx_ * t[None, :, None] + my * t[None, None, :]
                               + ph)
    return w


def solver_ns2d(torch, dft, hf, dev):
    """``ns2d_chain`` at 16 x 4096^2 under "pallas" against "xla", ms per
    step; the chain's launches against (4k + 1) forward and (16k + 1)
    inverse directions of the plan."""
    from distributedfft_tpu_torch.testing import workloads
    b, n = NS2D
    k = NS2D_STEPS
    base = fresh_peak(torch)
    w0 = smooth_vorticity(torch, dev, b, n)
    outs, rows = {}, {}
    for be in ("pallas", "xla"):
        fn, solver = workloads.ns2d_chain(k, b, n, dt=NS2D_DT, backend=be)
        if be == "pallas":
            s, launches, ents = counted_call(torch, hf, lambda: fn(w0))
            peak = peak_gb(torch, base)
            lf, li, ef, ei = plan_directions(torch, hf, solver.plan, w0)
            want = combine(lf, 4 * k + 1, li, 16 * k + 1)
            want_ents = combine(ef, 4 * k + 1, ei, 16 * k + 1)
            if launches != want or ents != want_ents:
                fail(f"ns2d {b}x{n}^2: the chain launched {launches} "
                     f"({ents}), not {want} ({want_ents})")
        else:
            s = fn(w0)
        outs[be] = solver.run(w0, k, NS2D_DT)
        rows[be] = dict(chain_sum=s, ms_per_step=host_ms(
            torch, lambda: fn(w0), reps=2) / k)
        del fn, solver
        torch.cuda.empty_cache()
    _, rel = rel_err(outs["pallas"], outs["xla"])
    del outs, w0
    torch.cuda.empty_cache()
    if not rel <= TOL:
        fail(f"ns2d {b}x{n}^2: vs xla rel {rel:.3e}")
    row = dict(path=f"ns2d_{b}x{n}", shape=[b, n, n], steps=k, dt=NS2D_DT,
               launches_chain=launches, entries_chain=ents, vs_xla_rel=rel,
               tol=TOL, pallas=rows["pallas"], xla=rows["xla"],
               peak_memory_gb=peak,
               cut="batch 64 -> 16 (RK4's state: 5 spectra of 1.07 GB, the "
                   "RHS temporaries and the split C2R's extension)")
    emit(phase="solver", **row)
    return {f"ns2d_{b}x{n}": launches}, row


def solver_dct(torch, dft, hf, dev):
    """dctn / dstn over a 512^3 float32 cube, type 2 and type 3, under
    "pallas" (1024-point extension rows: kernels 1 and 3) against
    "xla"."""
    from distributedfft_tpu_torch.solvers import r2r
    n = DCT_N
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    x = torch.rand((n, n, n), generator=gen, device=dev)
    rows, launches = {}, {}
    for name, fn, tp in (("dctn2", r2r.dctn, 2), ("dctn3", r2r.dctn, 3),
                         ("dstn2", r2r.dstn, 2)):
        got, lau, ents = counted_call(
            torch, hf, lambda: fn(x, type=tp, backend="pallas"))
        _, rel = rel_err(got, fn(x, type=tp, backend="xla"))
        if not rel <= TOL or lau.get("matmul"):
            fail(f"{name} {n}^3: vs xla rel {rel:.3e}, launches {lau}")
        rows[name] = dict(vs_xla_rel=rel, launches=lau, entries=ents,
                          ms=median_ms(torch, lambda: fn(x, type=tp,
                                                         backend="pallas"),
                                       reps=REPS_BIG, warmup=1),
                          xla_ms=median_ms(torch, lambda: fn(x, type=tp,
                                                             backend="xla"),
                                           reps=REPS_BIG, warmup=1))
        launches[f"{name}_{n}"] = lau
        del got
    if not (launches[f"dctn2_{n}"]["rmatmul"] == 3
            and launches[f"dctn3_{n}"]["c2r"] == 3):
        fail(f"dctn at {n}^3 did not run kernels 1 and 3 once an axis: "
             f"{launches}")
    del x
    torch.cuda.empty_cache()
    emit(phase="solver", path=f"r2r_{n}", shape=[n] * 3, tol=TOL, **rows)
    return launches, rows


def solver_grad(torch, dft, hf, dev):
    """Gradients on one card: Poisson ``solve_fn`` under "xla" at 512^3
    (integer mode, self-adjoint: grad of sum(w S f) is S w), 4 steps of
    ``NavierStokes2D.solve_fn`` (float64, "matmul", 2 x 64^2) against
    central differences, and "pallas": ``forward_fn`` bit for bit
    ``exec_fwd`` and ``backward`` raising."""
    from distributedfft_tpu_torch.solvers import (NavierStokes2D,
                                                  PoissonSolver)
    n = GRAD_N
    g = dft.GlobalSize(n, n, n)
    gen = torch.Generator(device=dev).manual_seed(SEED + 50)
    f = torch.rand((n, n, n), generator=gen, device=dev)
    w = torch.rand((n, n, n), generator=gen, device=dev)
    solver = PoissonSolver(dft.SlabFFTPlan(g, dft.SlabPartition(1),
                                           dft.Config()), mode="integer")
    fl = f.clone().requires_grad_()
    torch.sum(w * solver.solve_fn()(fl)).backward()
    _, poisson_rel = rel_err(fl.grad, solver.solve(w))
    del fl, solver
    # NS-2D against central differences.
    b, m, steps, dt = NS_GRAD
    plan = dft.Batched2DFFTPlan(b, m, m, dft.SlabPartition(1),
                                dft.Config(double_prec=True,
                                           fft_backend="matmul"))
    sfn = NavierStokes2D(plan, 0.01).solve_fn(steps, dt)
    w0 = torch.rand((b, m, m), generator=gen, device=dev,
                    dtype=torch.float64)
    wl = w0.clone().requires_grad_()
    torch.sum(sfn(wl) ** 2).backward()
    fd_rows = []
    eps = 1e-6
    with torch.no_grad():
        for idx in ((0, 3, 5), (1, 7, 2)):
            wp, wm = w0.clone(), w0.clone()
            wp[idx] += eps
            wm[idx] -= eps
            fd = (float(torch.sum(sfn(wp) ** 2))
                  - float(torch.sum(sfn(wm) ** 2))) / (2 * eps)
            fd_rows.append(dict(index=list(idx), grad=float(wl.grad[idx]),
                                fd=fd))
    fd_ok = all(abs(r["grad"] - r["fd"]) <= 1e-6 * abs(r["fd"]) + 1e-10
                for r in fd_rows)
    # "pallas": the fused forward bit for bit, the backward raising.
    plan = dft.SlabFFTPlan(g, dft.SlabPartition(1),
                           dft.Config(fft_backend="pallas"))
    with torch.no_grad():
        same = torch.equal(plan.forward_fn()(f), plan.exec_fwd(f))
    fl = f.clone().requires_grad_()
    try:
        torch.sum(w * plan.inverse_fn()(plan.forward_fn()(fl))).backward()
        raised = None
    except NotImplementedError as e:
        raised = str(e)
    del f, w, fl, plan
    torch.cuda.empty_cache()
    row = dict(poisson=dict(shape=[n] * 3, backend="xla",
                            grad_vs_solve_rel=poisson_rel, tol=GRAD_TOL),
               ns2d=dict(shape=[b, m, m], steps=steps, fd=fd_rows,
                         rel=1e-6),
               pallas=dict(forward_fn_is_exec_fwd=same, raised=raised))
    emit(phase="solver_grad", **row)
    if not (poisson_rel <= GRAD_TOL and fd_ok and same and raised
            and "has no VJP" in raised):
        fail(f"solver gradients: {row}")
    return row


def solver_rank_main(rank: int, addr: str, outdir: str) -> None:
    """Two ranks sharing the card over gloo: Poisson at 512^3 against the
    one-card solve, a Dirichlet box extended on the split x axis against
    its closed form, the guards + bf16 wire solve under RING (kernels 9
    and 10) and with the fused wire (kernel 11), and the gradient of the
    slab roundtrip under "xla" at 128^3."""
    import torch
    import torch.distributed as dist
    import distributedfft_tpu_torch as dft
    from distributedfft_tpu_torch import obs
    from distributedfft_tpu_torch.ops import hopper_fft as hf
    from distributedfft_tpu_torch.parallel import multihost
    from distributedfft_tpu_torch.solvers import PoissonSolver

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    multihost.maybe_initialize(addr, RANKS, rank, backend="gloo",
                               timeout_s=300)
    dev = torch.device("cuda")
    out = {"rank": rank}
    n = RANK_POISSON_N
    g = dft.GlobalSize(n, n, n)
    gen = torch.Generator(device=dev).manual_seed(SEED + 60)
    f = torch.rand((n, n, n), generator=gen, device=dev)
    f -= f.mean()
    plan = dft.SlabFFTPlan(g, dft.SlabPartition(RANKS),
                           dft.Config(fft_backend="pallas"))
    solver = PoissonSolver(plan, mode="integer")
    fl = plan.pad_input(f)
    ul, launches, ents = counted_call(torch, hf, lambda: solver.solve(fl))
    lf, li, ef, ei = plan_directions(torch, hf, plan, fl)
    if launches != combine(lf, 1, li, 1) or ents != combine(ef, 1, ei, 1):
        fail(f"rank {rank}: the two-rank solve launched {launches}, not one "
             f"forward and one inverse: {lf}, {li}")
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        solver.solve(fl)
    torch.cuda.synchronize()
    out["poisson_ms"] = 1e3 * (time.perf_counter() - t0) / 3
    full = torch.from_numpy(plan.crop_real(ul))
    del ul, solver, plan
    torch.cuda.empty_cache()
    if rank == 0:
        one = PoissonSolver(dft.SlabFFTPlan(g, dft.SlabPartition(1),
                                            dft.Config(fft_backend="pallas")),
                            mode="integer")
        _, out["poisson_vs_one_card_rel"] = rel_err(full, one.solve(f).cpu())
        del one
        if not out["poisson_vs_one_card_rel"] <= TOL:
            fail(f"two-rank poisson vs one card: {out}")
    out["poisson_launches"] = launches
    out["poisson_entries"] = ents
    del full
    torch.cuda.empty_cache()
    dist.barrier()
    # The Dirichlet box, extended on every axis, the split x included.
    ne = RANK_DIRICHLET_N
    m, L = ne // 2, 1.3
    plan = dft.SlabFFTPlan(dft.GlobalSize(ne, ne, ne),
                           dft.SlabPartition(RANKS),
                           dft.Config(fft_backend="pallas"))
    s = PoissonSolver(plan, lengths=(L,) * 3, bc="dirichlet")
    xs = (torch.arange(m, device=dev, dtype=torch.float32) + 0.5) * (L / m)
    sx = torch.sin(math.pi * xs / L)
    u_true = sx[:, None, None] * sx[None, :, None] * sx[None, None, :]
    ul = s.solve(-3.0 * (math.pi / L) ** 2 * u_true)
    out["dirichlet_local_interior"] = list(ul.shape)
    got = torch.from_numpy(s.gather_interior(ul))
    _, out["dirichlet_vs_closed_form_rel"] = rel_err(got, u_true.cpu())
    if not out["dirichlet_vs_closed_form_rel"] <= TOL or \
            out["dirichlet_local_interior"][0] != (m if rank == 0 else 0):
        fail(f"rank {rank}: the extended Dirichlet box: {out}")
    del s, plan, ul, got
    # The JAX package's guards + bf16 wire solve, under RING.
    fr = torch.rand((n, n, n), generator=gen, device=dev)
    fr -= fr.mean()
    wire_rows = {}
    native = None
    for name, kw in (("native", dict(guards="off")),
                     ("ring_wire16", dict(send_method=dft.SendMethod.RING,
                                          wire_dtype="bf16", guards="check")),
                     ("ring_wire16_fused", dict(
                         send_method=dft.SendMethod.RING, wire_dtype="bf16",
                         fused_wire=True, guards="check"))):
        seq = "Z_Then_YX" if name == "ring_wire16_fused" else "ZY_Then_X"
        plan = dft.SlabFFTPlan(g, dft.SlabPartition(RANKS),
                               dft.Config(fft_backend="pallas", **kw),
                               sequence=seq)
        sol = PoissonSolver(plan)
        fb = plan.pad_input(fr)
        obs.metrics.reset()
        u, lau, ents = counted_call(torch, hf, lambda: sol.solve(fb))
        snap = obs.metrics.snapshot()["counters"]
        full = torch.from_numpy(plan.crop_real(u))
        row = dict(sequence=seq, launches=lau, entries=ents,
                   parseval_violations=snap.get(
                       "guard.parseval_violations", 0),
                   wire_drift_violations=snap.get(
                       "guard.wire_drift_violations", 0))
        if native is None:
            native = full
        else:
            _, row["vs_native_rel"] = rel_err(full, native)
            if not (row["vs_native_rel"] <= WIRE_TOL
                    and row["parseval_violations"] == 0
                    and row["wire_drift_violations"] == 0
                    and bool(torch.isfinite(full).all())):
                fail(f"rank {rank}: guarded bf16-wire solve {name}: {row}")
        wire_rows[name] = row
        del plan, sol, u, full, fb
    fused = wire_rows["ring_wire16_fused"]["launches"]
    if not (wire_rows["ring_wire16"]["launches"]["enc_pack"] == 0
            and fused["enc_pack"] and fused["dec_cmatmul"]
            and fused["dec_unpack"]):
        fail(f"rank {rank}: the fused-wire solve did not run kernels 9-11: "
             f"{wire_rows}")
    out["wire"] = wire_rows
    del native, fr, f, fl
    torch.cuda.empty_cache()
    # The gradient of the slab roundtrip under "xla" across the two ranks.
    ng = RANK_GRAD_N
    grads = {}
    for comm in ("Peer2Peer", "All2All"):
        plan = dft.SlabFFTPlan(dft.GlobalSize(ng, ng, ng),
                               dft.SlabPartition(RANKS),
                               dft.Config(comm_method=dft.CommMethod(comm)))
        gx = torch.Generator(device=dev).manual_seed(SEED + 70)
        x = torch.rand((ng, ng, ng), generator=gx, device=dev)
        w = torch.rand((ng, ng, ng), generator=gx, device=dev)
        xl = plan.pad_input(x).requires_grad_()
        wl = plan.pad_input(w)
        loss = torch.sum(wl * plan.inverse_fn()(plan.forward_fn()(xl))) \
            / float(ng ** 3)
        loss.backward()
        _, grads[comm] = rel_err(xl.grad, wl)
        if not grads[comm] <= 1e-5:
            fail(f"rank {rank}: grad of the {comm} roundtrip: rel "
                 f"{grads[comm]:.3e}")
        del plan, x, w, xl, wl, loss
    out["roundtrip_grad_rel"] = grads
    with open(os.path.join(outdir, f"solver_rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    dist.barrier()
    multihost.shutdown()


def solvers_phase(torch, dft, hf, multihost, dev, outdir):
    """``solvers_main``, ``solver_grad`` and ``solver_ranks``: (the
    launches of each path, the rows)."""
    import torch.multiprocessing as tmp
    t0 = time.perf_counter()
    launches, rows = {}, {}
    for fn in (solver_poisson, solver_ns3d, solver_convolve, solver_ns2d,
               solver_dct):
        t1 = time.perf_counter()
        got, rows[fn.__name__] = fn(torch, dft, hf, dev)
        rows[fn.__name__]["seconds"] = time.perf_counter() - t1
        launches.update(got)
    emit(phase="solvers_main", seconds=time.perf_counter() - t0,
         paths=sorted(launches))
    t1 = time.perf_counter()
    rows["grad"] = solver_grad(torch, dft, hf, dev)
    emit(phase="solver_grad_done", seconds=time.perf_counter() - t1)
    t1 = time.perf_counter()
    tmp.spawn(solver_rank_main, args=(multihost.local_coordinator(), outdir),
              nprocs=RANKS, join=True)
    ranks = []
    for r in range(RANKS):
        with open(os.path.join(outdir, f"solver_rank{r}.json")) as fh:
            ranks.append(json.load(fh))
    r0 = ranks[0]
    launches[f"poisson_{RANK_POISSON_N}_p{RANKS}_rank0"] = \
        r0["poisson_launches"]
    for name, row in r0["wire"].items():
        launches[f"poisson_{RANK_POISSON_N}_{name}_rank0"] = row["launches"]
    emit(phase="solver_ranks", ranks=RANKS,
         exchange="gloo, host-staged, 2 ranks on 1 card", per_rank=ranks,
         seconds=time.perf_counter() - t1)
    return launches, rows


def solvers_only() -> int:
    """Build the kernels and run the solvers' phases alone (a shorter run
    while the solvers change; ``main`` runs them after every other
    phase): ``python3 -c "import chip_smoke; chip_smoke.solvers_only()"``."""
    import tempfile as _tf
    import torch
    import distributedfft_tpu_torch as dft
    from distributedfft_tpu_torch.ops import _build
    from distributedfft_tpu_torch.ops import hopper_fft as hf
    from distributedfft_tpu_torch.parallel import multihost
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(sorted(p.stem for p in _build.CSRC.glob("*.cu")))
    launches, _ = solvers_phase(torch, dft, hf, multihost,
                                torch.device("cuda"),
                                _tf.mkdtemp(prefix="chip_smoke_solvers_"))
    emit(phase="solvers_only", launches=launches)
    return 0


# -- 13. autotune, wisdom and persistence ------------------------------------

WISDOM_LOCAL = (N, N, NBIG)     # (a): the local race, cut from 1024^3 (z
                                # 1024: still kernels 1-3 on every axis)
WISDOM_BATCHED = (8, 4320, 4320)  # (b): the convolution's 5-smooth extent
WISDOM_COMM_N = 256             # (c): the comm race, cut from 512^3
WISDOM_T4_N = 128               # (d): the fraction chain over two ranks
WISDOM_K = 2                    # chain length of every race: one (t_2 - t_1)
WISDOM_REPEATS = 1              # pair a cell (a 1024^3 matmul@high roundtrip
                                # takes 1.7 s on the card: the race's cost)
WISDOM_CLI_N = N                # (d): the executables' autotune and "auto"
CKPT_N = N                      # (f): NS-3D 512^3, 3 x 512 x 512 x 257
CKPT_DT = 1e-3
LOCAL_KERNELS = ("rmatmul", "cmatmul", "c2r")   # kernels 1-3
# 2, 4, 5 and 3 (its pack pass): 4320
SPLIT_KERNELS = ("cmatmul", "cmatmul_tw", "rmatmul_tw", "c2r")


@contextlib.contextmanager
def race_log(hf, at):
    """Record each race cell's launches (counted from zero inside the
    cell) and the ranked candidates of each local race while the block
    runs; yields {"cells": {label: launches}, "local": [ranked...]}.
    Measurement only: the cells and the races run unchanged."""
    log = {"cells": {}, "local": []}
    orig_cell, orig_local = at._call_with_timeout, at.autotune_local_fft

    def cell(fn, label):
        hf.reset_launches()
        try:
            return orig_cell(fn, label)
        finally:
            log["cells"][label] = counted(hf)

    def local(*a, **kw):
        ranked = orig_local(*a, **kw)
        log["local"].append([dict(label=c.label, ms=c.per_iter_ms,
                                  rel_err=c.rel_err, ok=c.ok, error=c.error)
                             for c in ranked])
        return ranked

    at._call_with_timeout, at.autotune_local_fft = cell, local
    try:
        yield log
    finally:
        at._call_with_timeout, at.autotune_local_fft = orig_cell, orig_local


def race_cells(obs) -> int:
    return int(obs.metrics.counter_value("autotune.race_cells"))


def check_local_race(hf, log, what: str, kernels) -> dict:
    """The ranked table of the one local race in ``log``: every
    candidate measured or failed with a reason, the ok ones with a
    positive time, fastest first; the "pallas" cell launched exactly
    ``kernels``."""
    if len(log["local"]) != 1:
        fail(f"{what}: {len(log['local'])} local races, not 1")
    table = log["local"][0]
    ok = [c for c in table if c["ok"]]
    if not ok or any(not (c["ms"] > 0) for c in ok):
        fail(f"{what}: a usable candidate without a positive time: {table}")
    if [c["ms"] for c in ok] != sorted(c["ms"] for c in ok) or \
            table[:len(ok)] != ok:
        fail(f"{what}: the ranking is not fastest first: {table}")
    pallas = log["cells"].get("pallas")
    if pallas is None or {k for k, v in pallas.items() if v} != set(kernels):
        fail(f"{what}: the pallas cell launched {pallas}, not {kernels}")
    return {"table": table, "winner": table[0]["label"],
            "pallas_cell_launches": pallas}


def wisdom_local(torch, dft, hf, obs, at, wisdom, dev, store):
    """(a): the WISDOM_LOCAL slab plan with fft_backend="auto" (one card,
    per axis: z 1024 on kernels 1 and 3, y and x on kernel 2's column
    body): the race on the miss, the plan against torch.fft, the second
    construction a hit."""
    shape = WISDOM_LOCAL
    n = "x".join(map(str, shape))
    g = dft.GlobalSize(*shape)
    cfg = dft.Config(fft_backend="auto", wisdom_path=store)
    t0 = time.perf_counter()
    with race_log(hf, at) as log:
        plan = dft.SlabFFTPlan(g, dft.SlabPartition(1), cfg)
    race_s = time.perf_counter() - t0
    row = check_local_race(hf, log, f"local race {n}", LOCAL_KERNELS)
    winner = plan.config.fft_backend
    if not row["winner"].startswith(winner):
        fail(f"local race {n}: plan took {winner}, race {row['winner']}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 90)
    x = torch.rand(shape, generator=gen, device=dev)
    c, back, lf_, li, _, _ = run_counted(torch, hf, plan, x)
    _, fwd_rel = rel_err(c, torch.fft.rfftn(x))
    _, rt_rel = rel_err(back / float(math.prod(shape)), x)
    del c, back
    cells0 = race_cells(obs)
    t1 = time.perf_counter()
    again = dft.SlabFFTPlan(g, dft.SlabPartition(1), cfg)
    hit_s = time.perf_counter() - t1
    _, _, lf2, li2, _, _ = run_counted(torch, hf, again, x)
    want = ((expect(hf, rmatmul=1, cmatmul=2), expect(hf, cmatmul=2, c2r=1))
            if winner == "pallas" else (lf_, li))
    if not (fwd_rel <= TOL and rt_rel <= TOL):
        fail(f"local race {n}: {winner} plan rel {fwd_rel:.3e} / "
             f"{rt_rel:.3e}")
    if race_cells(obs) != cells0 or again.config != plan.config:
        fail(f"local race {n}: the second construction raced "
             f"({race_cells(obs) - cells0} cells) or resolved "
             f"{again.config} != {plan.config}")
    if (lf_, li) != want or (lf2, li2) != want:
        fail(f"local race {n}: {winner} plans launched {lf_}/{li} and "
             f"{lf2}/{li2}, not {want}")
    row.update(path=f"wisdom_local_{n}", resolved=winner,
               race_seconds=race_s, hit_seconds=hit_s, forward_rel=fwd_rel,
               roundtrip_rel=rt_rel, launches_forward=lf_,
               launches_inverse=li)
    emit(phase="wisdom_local", **row)
    del plan, again, x
    torch.cuda.empty_cache()
    return {f"wisdom_local_{n}": combine(lf_, 1, li, 1)}, row


def wisdom_batched(torch, dft, hf, obs, at, wisdom, dev, store):
    """(b): the 8 x 4320^2 batched plan with fft_backend="auto" (raced as
    a 3D roundtrip of the block, as in the JAX package), its winner
    beside both backends' own plan times."""
    b, nx, ny = WISDOM_BATCHED
    cfg = dft.Config(fft_backend="auto", wisdom_path=store)
    t0 = time.perf_counter()
    with race_log(hf, at) as log:
        plan = dft.Batched2DFFTPlan(b, nx, ny, dft.SlabPartition(1), cfg)
    race_s = time.perf_counter() - t0
    row = check_local_race(hf, log, f"local race {b}x{nx}^2",
                           SPLIT_KERNELS)
    gen = torch.Generator(device=dev).manual_seed(SEED + 91)
    x = torch.rand((b, nx, ny), generator=gen, device=dev)
    c, back, lf_, li, _, _ = run_counted(torch, hf, plan, x)
    _, fwd_rel = rel_err(c, torch.fft.rfft2(x))
    _, rt_rel = rel_err(back / float(nx * ny), x)
    del c, back
    if not (fwd_rel <= TOL and rt_rel <= TOL):
        fail(f"batched race: {plan.config.fft_backend} rel {fwd_rel:.3e} / "
             f"{rt_rel:.3e}")
    cells0 = race_cells(obs)
    again = dft.Batched2DFFTPlan(b, nx, ny, dft.SlabPartition(1), cfg)
    if race_cells(obs) != cells0 or again.config != plan.config:
        fail("batched race: the second construction raced or differed")
    plan_ms = {}
    for be in ("pallas", "xla"):
        p = dft.Batched2DFFTPlan(b, nx, ny, dft.SlabPartition(1),
                                 dft.Config(fft_backend=be))
        if be == "pallas":
            with entry_counts(hf) as seen:
                p.exec_inverse(p.exec_forward(x))
                torch.cuda.synchronize()
            row["pallas_kernel_entries"] = on_the_engine(
                seen, f"batched {b}x{nx}^2 under pallas")
        spec = p.exec_forward(x)
        plan_ms[be] = {
            "forward": median_ms(torch, lambda: p.exec_forward(x), reps=5),
            "inverse": median_ms(torch, lambda: p.exec_inverse(spec),
                                 reps=5)}
        del p, spec
    row.update(path=f"wisdom_batched_{b}x{nx}", resolved=plan.config
               .fft_backend, race_seconds=race_s, forward_rel=fwd_rel,
               roundtrip_rel=rt_rel, launches_forward=lf_,
               launches_inverse=li, plan_ms=plan_ms)
    emit(phase="wisdom_batched", **row)
    del plan, again, x
    torch.cuda.empty_cache()
    return {f"wisdom_batched_{b}x{nx}": combine(lf_, 1, li, 1)}, row


def wisdom_rank_main(rank: int, addr: str, outdir: str, store: str) -> None:
    """(c) and (e) on two ranks sharing the card over gloo, and (d)'s
    ``dfft-torch-reference -t 4``: the comm and wire race of an all-"auto"
    Config (the pallas backend, the fused wire), both ranks' resolutions,
    the second construction; then the demotion stamp of a check-mode wire
    demotion under an injected ``wire:nan``."""
    import torch
    import distributedfft_tpu_torch as dft
    from distributedfft_tpu_torch import obs
    from distributedfft_tpu_torch.cli import reference as cli_ref
    from distributedfft_tpu_torch.ops import hopper_fft as hf
    from distributedfft_tpu_torch.parallel import multihost
    from distributedfft_tpu_torch.testing import autotune as at
    from distributedfft_tpu_torch.utils import wisdom

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    multihost.maybe_initialize(addr, RANKS, rank, backend="gloo",
                               timeout_s=600)
    n = WISDOM_COMM_N
    g = dft.GlobalSize(n, n, n)
    part = dft.SlabPartition(RANKS)
    out = {"rank": rank}
    cfg = dft.Config(comm_method="auto", wire_dtype="auto", fused_wire=True,
                     fft_backend="pallas", wisdom_path=store)
    t0 = time.perf_counter()
    with race_log(hf, at) as log:
        plan = dft.SlabFFTPlan(g, part, cfg)
    out["race_seconds"] = time.perf_counter() - t0
    out["cells"] = log["cells"]
    out["resolved"] = wisdom._describe_comm(plan.config)
    out["resolved_vec"] = wisdom._resolved_vec(plan.config).tolist()
    dev = plan.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 92)
    x = torch.rand((n, n, n), generator=gen, device=dev)
    xl = plan.pad_input(x)
    c, back, lf_, li, _, _ = run_counted(torch, hf, plan, xl)
    _, out["forward_rel"] = rel_err(
        c, torch.fft.rfftn(x)[plan.local_slices(output=True)])
    _, out["roundtrip_rel"] = rel_err(back / float(n ** 3), xl)
    out["launches"] = combine(lf_, 1, li, 1)
    cells0 = race_cells(obs)
    again = dft.SlabFFTPlan(g, part, cfg)
    out["second_raced_cells"] = race_cells(obs) - cells0
    out["second_same"] = again.config == plan.config
    del plan, again, c, back

    # (d): the fraction chain of the reference executable over both ranks.
    import io
    buf = io.StringIO()
    t0 = time.perf_counter()
    m = WISDOM_T4_N
    with contextlib.redirect_stdout(buf):
        rc = cli_ref.main(["-nx", str(m), "-ny", str(m), "-nz", str(m),
                           "-t", "4", "-i", "3"])
    out["reference_t4"] = {"rc": rc, "text": buf.getvalue().strip(),
                           "seconds": time.perf_counter() - t0}

    # (e): an explicit bf16 wire under check-mode guards; the comm race
    # records its winner, an injected NaN on the wire demotes the wire,
    # the stamp lands on the record, the next construction re-races.
    cfg_e = dft.Config(comm_method="auto", wire_dtype="bf16",
                       fft_backend="pallas", guards="check",
                       wisdom_path=store)
    plan = dft.SlabFFTPlan(g, part, cfg_e)
    key = wisdom.plan_wisdom_key(plan)
    os.environ["DFFT_FAULT_SPEC"] = "wire:nan"
    try:
        plan.exec_r2c(xl)
        torch.cuda.synchronize()
    finally:
        del os.environ["DFFT_FAULT_SPEC"]
    out["demoted_wire"] = plan.config.wire_dtype
    ws = wisdom.WisdomStore(store)
    out["stamps"] = {s: bool((ws.lookup(key, s) or {}).get("demoted"))
                     for s in ("comm", "wire")}
    _, prov = wisdom.peek_config("slab", g, part, cfg_e,
                                 sequence=plan.sequence, device=dev)
    out["peek"] = prov["slots"].get("comm")
    cells0 = race_cells(obs)
    dft.SlabFFTPlan(g, part, cfg_e)
    out["reraced_cells"] = race_cells(obs) - cells0
    with open(os.path.join(outdir, f"wisdom_rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    multihost.shutdown()


def wisdom_ranks(multihost, outdir, store) -> tuple:
    """Spawn (c)-(e)'s two ranks and gate what they report."""
    import torch.multiprocessing as tmp
    t0 = time.perf_counter()
    tmp.spawn(wisdom_rank_main,
              args=(multihost.local_coordinator(), outdir, store),
              nprocs=RANKS, join=True)
    ranks = []
    for r in range(RANKS):
        with open(os.path.join(outdir, f"wisdom_rank{r}.json")) as fh:
            ranks.append(json.load(fh))
    r0 = ranks[0]
    if any(rk["resolved_vec"] != r0["resolved_vec"] for rk in ranks):
        fail(f"comm race: the ranks resolved different Configs: "
             f"{[rk['resolved'] for rk in ranks]}")
    with open(store) as fh:
        entries = json.load(fh)["entries"]
    slots = sorted({s for e in entries.values() for s in e})
    if not any("comm" in e for e in entries.values()):
        fail(f"comm race: no comm record in the store ({slots})")
    for rk in ranks:
        if rk["second_raced_cells"] or not rk["second_same"]:
            fail(f"comm race: rank {rk['rank']}'s second construction "
                 f"raced {rk['second_raced_cells']} cells")
        if not (rk["forward_rel"] <= WIRE_TOL
                and rk["roundtrip_rel"] <= WIRE_TOL):
            fail(f"comm race: rank {rk['rank']} resolved plan rel "
                 f"{rk['forward_rel']:.3e} / {rk['roundtrip_rel']:.3e}")
        for label, got in rk["cells"].items():
            wire_k = {k for k in ("enc_pack", "dec_unpack", "dec_cmatmul")
                      if got.get(k)}
            ring16 = label.endswith("/bf16") and "/ring" in label
            if ring16 and not {"enc_pack", "dec_unpack"} <= wire_k:
                fail(f"comm race: the fused-wire twin {label} launched "
                     f"{got}, not kernels 9 and 10")
            if not ring16 and wire_k:
                fail(f"comm race: {label} launched the wire kernels {got}")
        t4 = rk["reference_t4"]
        if t4["rc"] != 0 or (rk["rank"] == 0
                             and "All2All fraction:" not in t4["text"]):
            fail(f"reference -t 4 on rank {rk['rank']}: "
                 f"{rk['reference_t4']}")
        if rk["demoted_wire"] != "native" or not all(rk["stamps"].values()):
            fail(f"demotion: rank {rk['rank']} wire {rk['demoted_wire']}, "
                 f"stamps {rk['stamps']}")
        peek = rk["peek"] or {}
        if peek.get("status") != "miss" or "demoted" not in \
                str(peek.get("reason")) or not rk["reraced_cells"]:
            fail(f"demotion: rank {rk['rank']}'s next construction did not "
                 f"see the stamp: {peek}, re-raced {rk['reraced_cells']}")
    emit(phase="wisdom_ranks", ranks=RANKS, shape=[WISDOM_COMM_N] * 3,
         exchange="gloo, host-staged, 2 ranks on 1 card",
         winner=r0["resolved"], store_slots=slots,
         cells={label: {k: v for k, v in got.items() if v}
                for label, got in r0["cells"].items()},
         per_rank=[{k: rk[k] for k in rk if k != "cells"} for rk in ranks],
         seconds=time.perf_counter() - t0)
    launches = {f"wisdom_comm_{WISDOM_COMM_N}_rank0": r0["launches"]}
    for label, got in r0["cells"].items():
        launches[f"wisdom_comm_cell_{label}_rank0"] = got
    return launches, r0


def wisdom_cli(torch, dft, hf, at, store, store_cli):
    """(d) on one card: ``dfft-torch-reference --autotune`` at 512^3
    records its winner (the per-axis race is (a)'s); ``dfft-torch-slab -comm
    auto --fft-backend auto`` at 512^3 resolves and runs."""
    import functools
    from distributedfft_tpu_torch.cli import reference as cli_ref
    from distributedfft_tpu_torch.cli import slab as cli_slab
    from distributedfft_tpu_torch.utils import wisdom
    n = WISDOM_CLI_N
    orig = at.autotune_local_fft
    # One timing pair per cell (the executable's own repeats are 3 x 3).
    at.autotune_local_fft = functools.partial(orig, repeats=WISDOM_REPEATS,
                                              inner=1)
    try:
        text, got, _, secs = cli_run(
            torch, hf, cli_ref.main,
            ["-nx", str(n), "-ny", str(n), "-nz", str(n), "--autotune",
             "--autotune-k", str(WISDOM_K), "--wisdom", store_cli])
    finally:
        at.autotune_local_fft = orig
    rec = wisdom.WisdomStore(store_cli).lookup(
        wisdom.local_key((n, n, n), False, "cuda"), "local_fft")
    if rec is None or "wisdom: winner recorded" not in text:
        fail(f"reference --autotune recorded nothing: {text}")
    m = WISDOM_CLI_N
    bdir = tempfile.mkdtemp(prefix="chip_smoke_wisdom_cli_")
    text2, got2, _, secs2 = cli_run(
        torch, hf, cli_slab.main,
        ["-nx", str(m), "-ny", str(m), "-nz", str(m), "-t", "0", "-i", "3",
         "-comm", "auto", "--fft-backend", "auto", "--wisdom", store,
         "-b", bdir])
    if "Run complete:" not in text2:
        fail(f"slab -comm auto --fft-backend auto: {text2}")
    row = dict(reference_autotune=dict(text=text, seconds=secs,
                                       record=rec, launches=got),
               slab_auto=dict(text=text2, seconds=secs2, launches=got2))
    emit(phase="wisdom_cli", **row)
    return {"wisdom_cli_reference_autotune": got,
            "wisdom_cli_slab_auto": got2}, row


def wisdom_persist(torch, dft, hf, obs, dev, ckdir):
    """(f): NS-3D at 512^3 under "pallas" (kernels 6-8): 2 steps,
    checkpoint, restore, 2 steps, bit-equal to 4 straight steps; a
    corrupted newest generation falls back exactly one generation; write,
    read and CRC32C rates of the 1.62 GB state."""
    from distributedfft_tpu_torch import persist
    from distributedfft_tpu_torch.persist import checkpoint as ck
    from distributedfft_tpu_torch.solvers import NavierStokes3D
    n = CKPT_N
    plan = dft.SlabFFTPlan(dft.GlobalSize(n, n, n), dft.SlabPartition(1),
                           dft.Config(fft_backend="pallas"))
    ns = NavierStokes3D(plan, 1e-3)
    step = ns.step_fn(CKPT_DT)
    t = torch.arange(n, device=dev, dtype=torch.float32) * (2 * math.pi / n)
    cx, sx = torch.cos(t), torch.sin(t)
    gen = torch.Generator(device=dev).manual_seed(SEED + 93)
    u0 = torch.stack([cx[:, None, None] * sx[None, :, None] * sx[None, None],
                      -sx[:, None, None] * cx[None, :, None] * sx[None, None],
                      torch.zeros((n, n, n), device=dev)])
    u0 = u0 + 1e-3 * torch.rand(u0.shape, generator=gen, device=dev)
    with torch.no_grad():
        w0 = ns.to_spectral(u0)
        del u0
        hf.reset_launches()
        w = step(w0)
        torch.cuda.synchronize()
        per_step = counted(hf)
        w = step(w)
        straight = step(step(w))
        torch.cuda.synchronize()
    store = persist.CheckpointStore(ckdir)
    sim = persist.capture(ns, w, step=2, dt=CKPT_DT)
    nbytes = sum(a.nbytes for a in sim.arrays.values())
    t0 = time.perf_counter()
    store.save(sim)
    write_s = time.perf_counter() - t0
    fp = persist.plan_fingerprint(plan)
    t0 = time.perf_counter()
    back = store.load(expect_fingerprint=fp)
    read_s = time.perf_counter() - t0
    with torch.no_grad():
        r = persist.restore(back, ns)
        resumed = step(step(r))
        torch.cuda.synchronize()
    diffs = [int((a != b).sum()) for a, b in zip(resumed, straight)]
    if any(diffs):
        fail(f"resume {n}^3: {diffs} elements differ from 4 straight steps")
    # The newest generation damaged as it lands: load falls back one.
    sim4 = persist.capture(ns, straight, step=4, dt=CKPT_DT)
    os.environ["DFFT_FAULT_SPEC"] = "checkpoint:corrupt@seed=1000"
    try:
        store.save(sim4)
    finally:
        del os.environ["DFFT_FAULT_SPEC"]
    fb0 = obs.metrics.counter_value("persist.generation_fallbacks")
    older = store.load(expect_fingerprint=fp)
    fallbacks = obs.metrics.counter_value("persist.generation_fallbacks") \
        - fb0
    same = all(np.array_equal(older.arrays[k], sim.arrays[k])
               for k in sim.arrays)
    if older.step != 2 or fallbacks != 1 or not same:
        fail(f"fallback {n}^3: loaded step {older.step}, {fallbacks} "
             f"fallbacks, arrays equal {same}")
    buf = sim.arrays["field0"]
    ck.crc32c(buf.reshape(-1).view(np.uint8)[:1 << 20])  # the lanes warm
    t0 = time.perf_counter()
    crc = ck.crc32c(buf)
    torch.cuda.synchronize()
    crc_s = time.perf_counter() - t0
    row = dict(path=f"persist_ns3d_{n}", state_bytes=nbytes,
               state_gb=nbytes / 1e9, write_s=write_s, read_s=read_s,
               write_gb_s=nbytes / write_s / 1e9,
               read_gb_s=nbytes / read_s / 1e9,
               crc_bytes=int(buf.nbytes), crc_s=crc_s,
               crc_gb_s=buf.nbytes / crc_s / 1e9, crc=crc,
               resume="bit-equal to 4 straight steps",
               fallback_step=older.step, fallbacks=fallbacks,
               launches_per_step=per_step)
    emit(phase="wisdom_persist", **row)
    del plan, ns, step, w, w0, straight, resumed, r, sim, sim4, back, older
    torch.cuda.empty_cache()
    return {f"persist_ns3d_{n}": per_step}, row


def wisdom_phase(torch, dft, hf, multihost, dev, outdir):
    """(a)-(f) of the autotune, wisdom and persistence slice: (the
    launches of each path, the rows)."""
    from distributedfft_tpu_torch import obs
    from distributedfft_tpu_torch.testing import autotune as at
    from distributedfft_tpu_torch.utils import wisdom
    t0 = time.perf_counter()
    os.environ["DFFT_WISDOM_K"] = str(WISDOM_K)
    wisdom._RACE_REPEATS, wisdom._RACE_INNER = WISDOM_REPEATS, 1
    wdir = tempfile.mkdtemp(prefix="chip_smoke_wisdom_")
    store = os.path.join(wdir, "wisdom.json")
    launches, rows = {}, {}
    for fn in (wisdom_local, wisdom_batched):
        t1 = time.perf_counter()
        got, rows[fn.__name__] = fn(torch, dft, hf, obs, at, wisdom, dev,
                                    store)
        rows[fn.__name__]["seconds"] = time.perf_counter() - t1
        launches.update(got)
    got, rows["ranks"] = wisdom_ranks(multihost, outdir,
                                      os.path.join(wdir, "ranks.json"))
    launches.update(got)
    got, rows["cli"] = wisdom_cli(torch, dft, hf, at, store,
                                  os.path.join(wdir, "cli.json"))
    launches.update(got)
    got, rows["persist"] = wisdom_persist(torch, dft, hf, obs, dev,
                                          os.path.join(wdir, "ckpt"))
    launches.update(got)
    emit(phase="wisdom_done", seconds=time.perf_counter() - t0)
    return launches, rows


def wisdom_only() -> int:
    """Build the kernels and run the autotune, wisdom and persistence
    phases alone: ``python3 -c "import sys, chip_smoke;
    sys.exit(chip_smoke.wisdom_only())"``."""
    import torch
    import distributedfft_tpu_torch as dft
    from distributedfft_tpu_torch.ops import _build
    from distributedfft_tpu_torch.ops import hopper_fft as hf
    from distributedfft_tpu_torch.parallel import multihost
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(sorted(p.stem for p in _build.CSRC.glob("*.cu")))
    launches, _ = wisdom_phase(torch, dft, hf, multihost,
                               torch.device("cuda"),
                               tempfile.mkdtemp(prefix="chip_smoke_w_"))
    emit(phase="wisdom_only", launches=launches)
    return 0


# -- 14. the serving layer and the profile capture ----------------------------

SERVE_IMAGE = BATCHED[1:]       # BASELINE config #4's image: 4096^2
SERVE_COALESCE = 8
SERVE_DRIVE_S = 3.0             # each open-loop drive
SERVE_IDLE_S = 2.0              # the drive profiled for the idle share
SERVE_LOADS = (0.7, 1.5)        # x the throughput the warm batch implies
SERVE_CAPTURE_TRIES = 3         # the tracer can lose kernel records: capture anew


def capture_complete(what, port_records, launched):
    """Fail unless a capture's trace holds a record of every launch of the
    port's kernels in its window (``port_kernel_records``: the kernel
    records of the port's kernels by name, so aten's own kernels cannot
    make up for lost ones, and a launch whose host-side record the trace
    lost or put inside an aten op still counts by its kernel)."""
    if port_records < launched:
        fail(f"{what}: the trace kept {port_records} of the {launched} "
             f"kernel launches after {SERVE_CAPTURE_TRIES} captures")
SERVE_VOLUMES = (N, NBIG)       # single-shot volumes: fused, per axis
SERVE_RESIDENT_N = N            # the NS-3D resident beside the traffic
SERVE_RESIDENT_MS = 20          # its pause between steps
SERVE_SOLVE = (16, 4096)        # dfft-torch-solve: NS-2D, 16 x 4096^2
SERVE_SOLVE_STEPS = (2, 4)      # the checkpoint, the target
# Explicit RK4 at 4096^2 (dealiased |k| to ~1365): the default viscosity
# 1e-2 makes nu k^2 dt ~19 at dt 1e-3, past RK4's ~2.8, and the run
# overflows in four steps; these give 0.09 and an advective 0.7.
SERVE_SOLVE_FLOW = ("--viscosity", "1e-4", "--dt", "5e-4")
SERVE_RANK_IMAGE = (4, 1024, 1024)  # two ranks: shard="x" on the bf16 wire
SERVE_RANK_C2C = 256            # two ranks: the c2c volume (kernel 11)
SERVE_SPLIT = ("queue_wait_ms", "stack_ms", "copy_in_ms", "device_ms",
               "copy_out_ms", "exec_ms", "e2e_ms")
# One 4096^2 image a direction under batch_chunk=1: BATCHED_SPLIT's call.
SERVE_IMAGE_F, SERVE_IMAGE_I = BATCHED_SPLIT[0], BATCHED_SPLIT[1]
SERVE_RING = dict(send_method="RingOverlap", wire_dtype="bf16",
                  fused_wire=True)   # enums parsed by pencil_config


def split_means(obs) -> dict:
    """Mean of each ``serve.*`` split histogram since the last reset."""
    hist = obs.snapshot()["histograms"]
    return {k: (hist[f"serve.{k}"]["sum"] / hist[f"serve.{k}"]["count"]
                if hist.get(f"serve.{k}", {}).get("count") else None)
            for k in SERVE_SPLIT}


def serve_requests_ok(out: dict, what: str) -> None:
    bad = {k: v for k, v in out["outcomes"].items()
           if k in ("failed", "circuit_open", "closed") and v}
    if bad:
        fail(f"{what}: failed requests {bad} ({out})")


def serve_batch_ms(flightrec, n: int) -> float:
    """The newest ``serve.batch`` event of ``n`` requests: its ms."""
    rows = [r for r in flightrec.snapshot()
            if r["name"] == "serve.batch" and r["attrs"]["n"] == n]
    if not rows:
        fail(f"no serve.batch of {n} requests in the flight recorder")
    return rows[-1]["attrs"]["ms"]


def serve_images(torch, hf, s, dev):
    """4096^2 images on the card: a forward and an inverse against
    torch.fft, eight single-shot replies and the same eight coalesced (bit
    for bit), each request's launches. Returns (launches, row)."""
    from distributedfft_tpu_torch.obs import flightrec
    gen = torch.Generator(device=dev).manual_seed(SEED + 90)
    xs = [torch.rand(SERVE_IMAGE, generator=gen, device=dev)
          for _ in range(SERVE_COALESCE)]
    hosts = [x.cpu().numpy() for x in xs]
    row, launches = {}, {}
    single, times = [], []
    for i, h in enumerate(hosts):
        t0 = time.perf_counter()
        got, fwd, ents = counted_call(torch, hf, lambda h=h: s.request(h))
        times.append((time.perf_counter() - t0) * 1e3)
        single.append(got)
        if fwd != expect(hf, **SERVE_IMAGE_F):
            fail(f"serve 4096^2 forward launched {fwd} ({ents}), not "
                 f"{SERVE_IMAGE_F}")
        if i == 0:
            row["forward_entries"] = ents
    launches["serve_4096_forward"] = fwd
    ref = torch.fft.rfft2(xs[0])
    _, row["forward_vs_torch_fft"] = rel_err(torch.from_numpy(single[0])
                                             .to(dev), ref)
    back, inv, ents = counted_call(
        torch, hf, lambda: s.request(single[0], "r2c", "inverse",
                                     ny=SERVE_IMAGE[1]))
    if inv != expect(hf, **SERVE_IMAGE_I):
        fail(f"serve 4096^2 inverse launched {inv} ({ents}), not "
             f"{SERVE_IMAGE_I}")
    launches["serve_4096_inverse"] = inv
    row["inverse_entries"] = ents
    _, row["inverse_vs_torch_fft"] = rel_err(
        torch.from_numpy(back).to(dev),
        torch.fft.irfft2(ref, s=SERVE_IMAGE, norm="forward"))
    del ref
    if not (row["forward_vs_torch_fft"] <= TOL
            and row["inverse_vs_torch_fft"] <= TOL):
        fail(f"serve 4096^2: {row}")
    # Coalesced: a 512^3 volume occupies the worker while the eight queue.
    vol = torch.rand((N,) * 3, generator=gen, device=dev).cpu().numpy()
    hf.reset_launches()
    first = s.submit(vol)
    futs = [s.submit(h) for h in hosts]
    got = [f.result(600) for f in futs]
    first.result(600)
    torch.cuda.synchronize()
    coalesced = counted(hf)
    launches["serve_4096_coalesced"] = coalesced
    row["coalesced_equal_single"] = all(np.array_equal(a, b)
                                        for a, b in zip(single, got))
    if not row["coalesced_equal_single"]:
        fail("serve 4096^2: a coalesced reply differs from its single shot")
    row["batch_of_8_ms"] = serve_batch_ms(flightrec, SERVE_COALESCE)
    row["single_request_ms"] = statistics.median(times[1:])
    row["coalesced_launches"] = coalesced
    return launches, row


def serve_volumes(torch, hf, s, dev):
    """Single-shot volumes: 512^3 (kernels 6-8) and 1024^3 (kernels 1-3),
    a forward and an inverse each against torch.fft. Returns (launches,
    rows)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 91)
    launches, rows = {}, {}
    for n in SERVE_VOLUMES:
        x = torch.rand((n,) * 3, generator=gen, device=dev)
        h = x.cpu().numpy()
        r = {}
        t0 = time.perf_counter()
        got, fwd, ent_f = counted_call(torch, hf, lambda: s.request(h))
        r["forward_request_ms"] = (time.perf_counter() - t0) * 1e3
        ref = torch.fft.rfftn(x)
        del x
        _, r["forward_vs_torch_fft"] = rel_err(torch.from_numpy(got).to(dev),
                                               ref)
        t0 = time.perf_counter()
        back, inv, ent_i = counted_call(
            torch, hf, lambda: s.request(got, "r2c", "inverse", ny=n))
        r["inverse_request_ms"] = (time.perf_counter() - t0) * 1e3
        _, r["inverse_vs_torch_fft"] = rel_err(
            torch.from_numpy(back).to(dev),
            torch.fft.irfftn(ref, s=(n,) * 3, norm="forward"))
        del ref, got, back, h
        torch.cuda.empty_cache()
        want = ((FUSED_PATH[0], FUSED_PATH[1]) if n == N else
                PER_AXIS_PATHS["per_axis_1024"][1:3])
        if fwd != expect(hf, **want[0]) or inv != expect(hf, **want[1]):
            fail(f"serve {n}^3: launched {fwd} ({ent_f}) / {inv} "
                 f"({ent_i}), not {want}")
        if not (r["forward_vs_torch_fft"] <= TOL
                and r["inverse_vs_torch_fft"] <= TOL):
            fail(f"serve {n}^3: {r}")
        r.update(entries_forward=ent_f, entries_inverse=ent_i)
        launches[f"serve_{n}_volume"] = {k: fwd[k] + inv[k] for k in fwd}
        rows[f"volume_{n}"] = r
    return launches, rows


def serve_drives(torch, hf, obs, s, dev, capacity):
    """The open-loop drives of 4096^2 r2c forwards at SERVE_LOADS x
    ``capacity`` (FFTs/s), each SERVE_DRIVE_S long, with the split of a
    request's time. Returns (launches, rows)."""
    from distributedfft_tpu_torch.testing.workloads import serve_load
    launches, rows = {}, {}
    for load in SERVE_LOADS:
        rate = load * capacity
        obs.reset()
        hf.reset_launches()
        out = serve_load(s, rate_hz=rate, duration_s=SERVE_DRIVE_S,
                         shapes=(SERVE_IMAGE,), seed=SEED, warmup=1)
        torch.cuda.synchronize()
        serve_requests_ok(out, f"drive at {load}x")
        launches[f"serve_drive_{load}x"] = counted(hf)
        out["split_ms"] = split_means(obs)
        out["load"] = load
        rows[f"drive_{load}x"] = out
        emit(phase="serve_drive", **out)
    return launches, rows


def serve_idle_row(torch, dft, hf, dev, capacity):
    """A drive at the first of SERVE_LOADS x ``capacity`` under the
    profiler for the device's idle share, on a server of its own warmed
    by a drive outside the window; taken again (up to
    SERVE_CAPTURE_TRIES) until the trace holds a record for every launch
    of the port's kernels in the window."""
    from distributedfft_tpu_torch import obs
    from distributedfft_tpu_torch.obs import profile
    from distributedfft_tpu_torch.serve import Server
    from distributedfft_tpu_torch.testing.workloads import serve_load
    s = Server(config=dft.Config(fft_backend="pallas"),
               max_coalesce=SERVE_COALESCE, batch_chunk=1, device=dev)
    try:
        serve_load(s, rate_hz=SERVE_LOADS[0] * capacity,
                   duration_s=SERVE_IDLE_S, shapes=(SERVE_IMAGE,),
                   seed=SEED, warmup=1)
        torch.cuda.synchronize()
        for attempt in range(1, SERVE_CAPTURE_TRIES + 1):
            obs.reset()
            hf.reset_launches()
            with profile.capture_window(dev) as win:
                out = serve_load(s, rate_hz=SERVE_LOADS[0] * capacity,
                                 duration_s=SERVE_IDLE_S,
                                 shapes=(SERVE_IMAGE,), seed=SEED + 1,
                                 warmup=0)
            serve_requests_ok(out, "profiled drive")
            res = win.result
            launched = sum(hf.LAUNCHES.values())
            if res["port_kernel_records"] >= launched:
                break
    finally:
        s.close(drain=False)
    return dict(
        load=SERVE_LOADS[0], seconds=SERVE_IDLE_S, outcomes=out["outcomes"],
        p50_ms=out["p50_ms"], idle_share=res["idle_share"],
        kernel_idle_share=res["kernel_idle_share"],
        kernel_busy_ms=res["kernel_busy_ms"],
        busy_ms=res["busy_ms"], window_ms=res["window_ms"],
        device_scopes_ms=res["scopes"],
        unattributed_ms=res["unattributed_ms"],
        kernel_events=res["kernel_events"],
        port_kernel_events=res["port_kernel_events"],
        port_kernel_records=res["port_kernel_records"],
        kernels_launched=launched, attempts=attempt,
        note="under torch.profiler (CPU and CUDA activities)")


def serve_resident(torch, hf, obs, s, dev, capacity, ckdir):
    """An NS-3D 512^3 resident stepping on its own thread while a drive
    runs (DEVICE_LOCK), checkpointed on drain; a new resident restored
    from that checkpoint steps bit-equal to the continued run. Closes
    ``s``. Returns (launches, row)."""
    from distributedfft_tpu_torch.serve.resident import (ResidentSolver,
                                                         advance_steps)
    from distributedfft_tpu_torch.testing.workloads import serve_load
    spec = {"kind": "ns3d", "n": SERVE_RESIDENT_N, "dt": CKPT_DT,
            "dir": ckdir, "policy": "drain:on", "fft_backend": "pallas",
            "device": "cuda", "name": "resident",
            "step_interval_ms": SERVE_RESIDENT_MS}
    res = ResidentSolver.build(spec)
    s.attach_resident(res)
    obs.reset()
    out = serve_load(s, rate_hz=SERVE_LOADS[0] * capacity,
                     duration_s=SERVE_DRIVE_S, shapes=(SERVE_IMAGE,),
                     seed=SEED + 2, warmup=0)
    serve_requests_ok(out, "drive beside the resident")
    out["split_ms"] = split_means(obs)
    row = {"drive": out, "steps_during_drive": res.step}
    t0 = time.perf_counter()
    s.close(drain=True)        # stops the resident through its drain
    row["close_drain_s"] = time.perf_counter() - t0
    if res.error is not None or res.checkpoints != 1:
        fail(f"resident: error {res.error}, checkpoints {res.checkpoints}")
    step = res.solver.step_fn(res.dt)
    cont, launches, ents = counted_call(
        torch, hf, lambda: advance_steps(step, res.state, 2))
    # A step: 4 RK stages of 3 forward and 6 inverse directions.
    want = combine(expect(hf, **FUSED_PATH[0]), 2 * 12,
                   expect(hf, **FUSED_PATH[1]), 2 * 24)
    if launches != want:
        fail(f"resident: two steps launched {launches}, not {want}")
    stopped_at = res.step
    del res, step
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res2 = ResidentSolver.build(spec)
    row["restore_s"] = time.perf_counter() - t0
    back = advance_steps(res2.solver.step_fn(res2.dt), res2.state, 2)
    row.update(stopped_at=stopped_at, restored_from=res2.restored_from,
               bit_equal=all(torch.equal(a, b) for a, b in zip(cont, back)))
    if not (row["bit_equal"] and res2.restored_from == stopped_at):
        fail(f"resident resume: {row}")
    del res2, cont, back
    torch.cuda.empty_cache()
    return {"serve_resident_2_steps": launches}, row


def free_port() -> int:
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as so:
        so.bind(("127.0.0.1", 0))
        return so.getsockname()[1]


def serve_http(torch, dev):
    """``dfft-torch-serve --http`` as a child on a free local port:
    /healthz, /readyz, /metrics (validated), one POST /fft of a 4096^2
    .npy against torch.fft, then SIGTERM and a drained exit 0."""
    import io
    import signal
    import urllib.request
    from distributedfft_tpu_torch.obs import promexp
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributedfft_tpu_torch.serve.cli",
         "--http", str(port), "--fft-backend", "pallas"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    base = f"http://127.0.0.1:{port}"
    row = {"port": port}
    try:
        t0 = time.perf_counter()
        while True:
            try:
                with urllib.request.urlopen(base + "/healthz",
                                            timeout=30) as r:
                    row["healthz"] = json.loads(r.read())["status"]
                break
            except OSError:
                if proc.poll() is not None or time.perf_counter() - t0 > 120:
                    fail(f"dfft-torch-serve --http did not come up: "
                         f"{proc.communicate()[1][-2000:]}")
                time.sleep(0.25)
        row["up_s"] = time.perf_counter() - t0
        with urllib.request.urlopen(base + "/readyz", timeout=30) as r:
            row["readyz"] = json.loads(r.read())["ready"]
        gen = torch.Generator(device=dev).manual_seed(SEED + 92)
        x = torch.rand(SERVE_IMAGE, generator=gen, device=dev)
        buf = io.BytesIO()
        np.save(buf, x.cpu().numpy())
        req = urllib.request.Request(base + "/fft", data=buf.getvalue(),
                                     headers={"X-DFFT-Transform": "r2c"},
                                     method="POST")
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as r:
            got = np.load(io.BytesIO(r.read()))
            row["trace"] = r.headers["X-DFFT-Trace"]
        row["post_ms"] = (time.perf_counter() - t0) * 1e3
        _, row["post_vs_torch_fft"] = rel_err(torch.from_numpy(got).to(dev),
                                              torch.fft.rfft2(x))
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            body = r.read().decode()
        row["metrics_samples"] = promexp.validate_exposition(body)
        if not (row["healthz"] == "ok" and row["readyz"]
                and row["post_vs_torch_fft"] <= TOL
                and "dfft_serve_requests_total 1" in body):
            fail(f"dfft-torch-serve --http: {row}")
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
        try:
            out, err = proc.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
    row["exit_code"] = proc.returncode
    if proc.returncode != 0 or "graceful drain" not in out:
        fail(f"dfft-torch-serve --http exited {proc.returncode}: "
             f"{err[-2000:]}")
    return row


def serve_solve(torch, hf, outdir):
    """``dfft-torch-solve`` NS-2D 16 x 4096^2 under "pallas": the target
    in one run, then a run to the checkpoint and a resume to the target,
    whose ``--out`` fields are bit-equal. Returns (launches, row)."""
    import contextlib as _cl
    import io
    import signal
    from distributedfft_tpu_torch.solvers import driver
    batch, n = SERVE_SOLVE
    k, steps = SERVE_SOLVE_STEPS
    ck = os.path.join(outdir, "solve_ckpt")
    a, b = os.path.join(outdir, "solve_a.npy"), os.path.join(outdir,
                                                             "solve_b.npy")
    base = ["--kind", "ns2d", "--n", str(n), "--batch", str(batch),
            "--fft-backend", "pallas", *SERVE_SOLVE_FLOW]
    row, summaries = {}, []
    hf.reset_launches()
    for extra, target in ((["--out", a], steps),
                          (["--checkpoint-dir", ck], k),
                          (["--checkpoint-dir", ck, "--resume", "--out", b],
                           steps)):
        buf = io.StringIO()
        t0 = time.perf_counter()
        handlers = {g: signal.getsignal(g) for g in (signal.SIGTERM,
                                                     signal.SIGINT)}
        try:
            with _cl.redirect_stdout(buf):
                rc = driver.main(base + ["--steps", str(target)] + extra)
        finally:           # dfft-torch-solve installs drain handlers
            for g, hd in handlers.items():
                signal.signal(g, hd)
        summary = json.loads(buf.getvalue().strip().splitlines()[-1])
        summary["seconds"] = time.perf_counter() - t0
        summaries.append(summary)
        if rc != 0:
            fail(f"dfft-torch-solve {extra}: exit {rc}, {summary}")
    launches = counted(hf)
    torch.cuda.synchronize()
    fa, fb = np.load(a, mmap_mode="r"), np.load(b, mmap_mode="r")
    row.update(runs=summaries, shape=list(fa.shape),
               finite=bool(np.isfinite(fa).all()),
               bit_equal=fa.tobytes() == fb.tobytes())
    del fa, fb
    os.remove(a)
    os.remove(b)
    if not (row["bit_equal"] and row["finite"]
            and summaries[2]["restored_from"] == k
            and summaries[2]["step"] == steps):
        fail(f"dfft-torch-solve resume: {row}")
    if launches.get("matmul") or not all(
            launches[kk] for kk in SPLIT_KERNELS):
        fail(f"dfft-torch-solve launched {launches}")
    return {"serve_solve_ns2d": launches}, row




def serve_capture_rows(torch, dft, hf, dev):
    """capture_stage_profile of the 1024^3 slab plan's directions, and one
    NS-3D 512^3 step under the profiler: ms per dfft/... scope,
    unattributed and total; each capture taken again (up to
    SERVE_CAPTURE_TRIES) until its trace holds a record for every launch
    of the port's kernels in the window ("complete"; the parent fails the
    run where one is not)."""
    from distributedfft_tpu_torch.obs import profile
    from distributedfft_tpu_torch.solvers import NavierStokes3D
    rows = {}
    plan = dft.SlabFFTPlan(dft.GlobalSize(NBIG, NBIG, NBIG),
                           dft.SlabPartition(1),
                           dft.Config(fft_backend="pallas"))
    per_dir = {"forward": PER_AXIS_PATHS["per_axis_1024"][1],
               "inverse": PER_AXIS_PATHS["per_axis_1024"][2]}
    for d, launched in per_dir.items():
        want = 3 * sum(launched.values())          # iters=3
        for attempt in range(1, SERVE_CAPTURE_TRIES + 1):
            r = profile.capture_stage_profile(plan, d, iters=3)
            r.update(attempts=attempt, kernels_launched=want,
                     complete=r["port_kernel_records"] >= want)
            if r["complete"]:
                break
        rows[f"slab_{NBIG}_{d}"] = r
    del plan
    torch.cuda.empty_cache()
    n = N
    plan = dft.SlabFFTPlan(dft.GlobalSize(n, n, n), dft.SlabPartition(1),
                           dft.Config(fft_backend="pallas"))
    ns = NavierStokes3D(plan, 1e-3)
    step = ns.step_fn(CKPT_DT)
    t = torch.arange(n, device=dev, dtype=torch.float32) * (2 * math.pi / n)
    cx, sx = torch.cos(t), torch.sin(t)
    u0 = torch.stack([cx[:, None, None] * sx[None, :, None] * sx[None, None],
                      -sx[:, None, None] * cx[None, :, None] * sx[None, None],
                      torch.zeros((n, n, n), device=dev)])
    with torch.no_grad():
        ch = step(ns.to_spectral(u0))
        torch.cuda.synchronize()
        for attempt in range(1, SERVE_CAPTURE_TRIES + 1):
            hf.reset_launches()
            with profile.capture_window(dev) as win:
                ch = step(ch)
            want = sum(hf.LAUNCHES.values())
            res = win.result
            if res["port_kernel_records"] >= want:
                break
    rows[f"ns3d_{n}_step"] = dict(
        scopes=res["scopes"], unattributed_ms=res["unattributed_ms"],
        total_ms=res["total_ms"], busy_ms=res["busy_ms"],
        window_ms=res["window_ms"], idle_share=res["idle_share"],
        kernel_idle_share=res["kernel_idle_share"],
        kernel_events=res["kernel_events"],
        port_kernel_events=res["port_kernel_events"],
        port_kernel_records=res["port_kernel_records"], kernels_launched=want,
        attempts=attempt, complete=res["port_kernel_records"] >= want,
        transforms_share=(sum(res["scopes"].values()) / res["total_ms"]
                          if res["total_ms"] else None))
    return rows


def serve_capture_main(rank: int, outdir: str, capacity: float) -> None:
    """The captures in a process of their own: late in this script's long
    process the tracer lost every kernel record of a 1024^3 capture on an
    H100, and a quarter of a profiled drive's; in a fresh process it kept
    them."""
    import torch
    import distributedfft_tpu_torch as dft
    from distributedfft_tpu_torch.ops import hopper_fft as hf
    torch.cuda.set_device(0)
    dev = torch.device("cuda")
    rows = serve_capture_rows(torch, dft, hf, dev)
    torch.cuda.empty_cache()
    idle = serve_idle_row(torch, dft, hf, dev, capacity)
    with open(os.path.join(outdir, "serve_capture.json"), "w") as f:
        json.dump(dict(captures=rows, idle=idle), f)


def serve_captures(outdir, capacity):
    """Spawn the capture process; emit its rows. Returns (the captures'
    rows, the profiled drive's row)."""
    import torch.multiprocessing as tmp
    tmp.spawn(serve_capture_main, args=(outdir, capacity), nprocs=1,
              join=True)
    with open(os.path.join(outdir, "serve_capture.json")) as f:
        got = json.load(f)
    rows, idle = got["captures"], got["idle"]
    for k, v in rows.items():
        emit(phase="serve_capture", path=k, **v)
    emit(phase="serve_idle", **idle)
    for k, v in rows.items():
        capture_complete(f"capture {k}", v["port_kernel_records"],
                         v["kernels_launched"])
    capture_complete("profiled drive", idle["port_kernel_records"],
                     idle["kernels_launched"])
    return rows, idle


def serve_rank_main(rank: int, addr: str, outdir: str) -> None:
    """Two ranks sharing the card over gloo: a leader/follower server.
    The 512^3 slab volume bit for bit the direct plan; shard="x" 1024^2
    images and a 256^3 c2c volume on the fused bf16 ring (kernels 9-11)
    within WIRE16_TOL of torch.fft; each rank's device idle share of the
    512^3 plan from capture_stage_profile."""
    import torch
    import torch.distributed as dist
    import distributedfft_tpu_torch as dft
    from distributedfft_tpu_torch.obs import profile
    from distributedfft_tpu_torch.ops import hopper_fft as hf
    from distributedfft_tpu_torch.parallel import multihost
    from distributedfft_tpu_torch.serve import Server

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    multihost.maybe_initialize(addr, RANKS, rank, backend="gloo",
                               timeout_s=300)
    bar = dist.new_group(list(range(RANKS)))   # beside the servers' world
    dev = torch.device("cuda")
    out = {"rank": rank}
    t_all = time.perf_counter()
    n = N
    gen = torch.Generator(device=dev).manual_seed(SEED + 93)
    x = torch.rand((n, n, n), generator=gen, device=dev)
    h = x.cpu().numpy()
    plan = dft.SlabFFTPlan(dft.GlobalSize(n, n, n), dft.SlabPartition(RANKS),
                           dft.Config(fft_backend="pallas"))
    ref = plan.crop_spectral(plan.exec_r2c(plan.pad_input(x)))
    ref_back = plan.crop_real(plan.exec_c2r(plan.pad_spectral(ref)))
    del x
    # (a) the slab volume through the server: bit for bit the direct plan.
    s = Server(dft.SlabPartition(RANKS), dft.Config(fft_backend="pallas"),
               device=dev)
    dist.barrier(group=bar)
    hf.reset_launches()
    dist.barrier(group=bar)
    if s.leader:
        t0 = time.perf_counter()
        got = s.request(h)
        out["volume_forward_ms"] = (time.perf_counter() - t0) * 1e3
        back = s.request(got, "r2c", "inverse", ny=n)
        out["volume_bit_equal"] = (np.array_equal(got, ref)
                                   and np.array_equal(back, ref_back))
        del got, back
    dist.barrier(group=bar)
    out["volume_launches"] = counted(hf)
    s.close()
    del ref, ref_back, h
    # (b) shard="x" images and the c2c volume on the fused bf16 ring.
    s = Server(dft.SlabPartition(RANKS), pencil_config(dft, SERVE_RING),
               shard="x", device=dev)
    b, ny, nx = SERVE_RANK_IMAGE
    imgs = torch.rand((b, ny, nx), generator=gen, device=dev)
    m = SERVE_RANK_C2C
    z = torch.complex(torch.rand((m,) * 3, generator=gen, device=dev),
                      torch.rand((m,) * 3, generator=gen, device=dev))
    dist.barrier(group=bar)
    hf.reset_launches()
    dist.barrier(group=bar)
    if s.leader:
        futs = [s.submit(im.cpu().numpy()) for im in imgs]
        got = np.stack([f.result(600) for f in futs])
        ref = torch.fft.rfft2(imgs)
        _, out["images_forward_rel"] = rel_err(torch.from_numpy(got).to(dev),
                                               ref)
        back = np.stack([s.request(g, "r2c", "inverse", ny=nx)
                         for g in got])
        _, out["images_inverse_rel"] = rel_err(
            torch.from_numpy(back).to(dev),
            torch.fft.irfft2(ref, s=(ny, nx), norm="forward"))
        zc = s.request(z.cpu().numpy(), "c2c")
        zref = torch.fft.fftn(z)
        _, out["c2c_forward_rel"] = rel_err(torch.from_numpy(zc).to(dev),
                                            zref)
        zb = s.request(zc, "c2c", "inverse")
        _, out["c2c_inverse_rel"] = rel_err(
            torch.from_numpy(zb).to(dev), torch.fft.ifftn(zref, norm="forward"))
        out["coalesced"] = s.health()["counters"]["coalesced"]
    dist.barrier(group=bar)
    out["ring_launches"] = counted(hf)
    s.close()
    out["failures"] = s.health()["counters"]["batch_failures"]
    # (c) each rank's device idle share of the 512^3 two-rank plan (one
    # warm-up call and three in the window: 3/4 of the launches counted);
    # taken anew on both ranks while either trace lost a launch's kernel.
    for d in ("forward", "inverse"):
        for attempt in range(1, SERVE_CAPTURE_TRIES + 1):
            hf.reset_launches()
            cap = profile.capture_stage_profile(plan, d, iters=3)
            want = 3 * sum(hf.LAUNCHES.values()) // 4
            kept = torch.tensor([int(cap["port_kernel_records"] >= want)])
            dist.all_reduce(kept, op=dist.ReduceOp.MIN, group=bar)
            if kept.item():
                break
        out[f"capture_{d}"] = dict(cap, kernels_launched=want,
                                   attempts=attempt)
    out["seconds"] = time.perf_counter() - t_all
    with open(os.path.join(outdir, f"serve_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    multihost.shutdown()


def serve_ranks(multihost, outdir):
    """Spawn the two serving ranks; check their rows. Returns (launches,
    rows)."""
    import torch.multiprocessing as tmp
    tmp.spawn(serve_rank_main, args=(multihost.local_coordinator(), outdir),
              nprocs=RANKS, join=True)
    rows = []
    for r in range(RANKS):
        with open(os.path.join(outdir, f"serve_rank{r}.json")) as f:
            rows.append(json.load(f))
    r0 = rows[0]
    if not r0["volume_bit_equal"]:
        fail("two-rank served 512^3 volume differs from the direct plan")
    for k in ("images_forward_rel", "images_inverse_rel", "c2c_forward_rel",
              "c2c_inverse_rel"):
        if not r0[k] <= WIRE16_TOL:
            fail(f"two-rank served {k} {r0[k]:.3e} > {WIRE16_TOL}")
    for rk in rows:
        ring = rk["ring_launches"]
        if rk["failures"] or ring.get("matmul") or not all(
                ring[kk] for kk in ("enc_pack", "dec_unpack", "dec_cmatmul")):
            fail(f"two-rank server rank {rk['rank']}: failures "
                 f"{rk['failures']}, ring launches {ring}")
    for rk in rows:
        for d in ("forward", "inverse"):
            cap = rk[f"capture_{d}"]
            capture_complete(f"rank {rk['rank']} capture {d}",
                             cap["port_kernel_records"],
                             cap["kernels_launched"])
    launches = {}
    for rk in rows:
        launches[f"serve_ranks_volume_rank{rk['rank']}"] = rk[
            "volume_launches"]
        launches[f"serve_ranks_ring_rank{rk['rank']}"] = rk["ring_launches"]
    emit(phase="serve_ranks", ranks=RANKS,
         exchange="gloo, host-staged, 2 ranks on 1 card", per_rank=rows)
    return launches, rows


def serve_phase(torch, dft, hf, multihost, dev, outdir):
    """The serving layer on the card (``serve/``, ``obs/promexp.py``,
    ``obs/profile.py``): (the launches of each path, the rows)."""
    from distributedfft_tpu_torch import obs
    from distributedfft_tpu_torch.serve import Server
    t_phase = time.perf_counter()
    launches, rows = {}, {}
    s = Server(config=dft.Config(fft_backend="pallas"),
               max_coalesce=SERVE_COALESCE, batch_chunk=1, device=dev)
    try:
        t0 = time.perf_counter()
        hf.reset_launches()
        with entry_counts(hf) as ents:
            built = s.prewarm(SERVE_IMAGE, directions=("forward", "inverse"))
            built += s.prewarm((N,) * 3, directions=("forward", "inverse"))
            torch.cuda.synchronize()
        rows["prewarm"] = dict(built=built,
                               seconds=time.perf_counter() - t0,
                               launches=counted(hf),
                               entries=per_entry(ents))
        launches["serve_prewarm"] = rows["prewarm"]["launches"]
        emit(phase="serve_prewarm", **rows["prewarm"])
        got, rows["images"] = serve_images(torch, hf, s, dev)
        launches.update(got)
        emit(phase="serve_images", **rows["images"])
        got, vol = serve_volumes(torch, hf, s, dev)
        launches.update(got)
        rows.update(vol)
        emit(phase="serve_volumes", **vol)
        capacity = SERVE_COALESCE / (rows["images"]["batch_of_8_ms"] / 1e3)
        rows["capacity_fps"] = capacity
        got, drives = serve_drives(torch, hf, obs, s, dev, capacity)
        launches.update(got)
        rows.update(drives)
        got, rows["resident"] = serve_resident(
            torch, hf, obs, s, dev, capacity,
            os.path.join(outdir, "serve_ckpt"))
        launches.update(got)
        emit(phase="serve_resident", **rows["resident"])
    finally:
        s.close(drain=False)
    torch.cuda.empty_cache()
    rows["http"] = serve_http(torch, dev)
    emit(phase="serve_http", **rows["http"])
    got, rows["solve"] = serve_solve(torch, hf, outdir)
    launches.update(got)
    emit(phase="serve_solve", **rows["solve"])
    torch.cuda.empty_cache()
    got, rows["ranks"] = serve_ranks(multihost, outdir)
    launches.update(got)
    rows["captures"], rows["idle"] = serve_captures(outdir, capacity)
    rows["seconds"] = time.perf_counter() - t_phase
    emit(phase="serve_done", seconds=rows["seconds"])
    return launches, rows


def serve_only() -> int:
    """Build the kernels and run the serving phase alone: ``python3 -c
    "import sys, chip_smoke; sys.exit(chip_smoke.serve_only())"``."""
    import torch
    import distributedfft_tpu_torch as dft
    from distributedfft_tpu_torch.ops import _build
    from distributedfft_tpu_torch.ops import hopper_fft as hf
    from distributedfft_tpu_torch.parallel import multihost
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    emit(phase="device", name=torch.cuda.get_device_name(0),
         nvidia_smi=subprocess.run(
             ["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"], capture_output=True, text=True,
             check=True, timeout=60).stdout.strip())
    _build.build(sorted(p.stem for p in _build.CSRC.glob("*.cu")))
    launches, _ = serve_phase(torch, dft, hf, multihost, torch.device("cuda"),
                              tempfile.mkdtemp(prefix="chip_smoke_serve_"))
    emit(phase="serve_only", launches=launches)
    return 0


# -- 15. the serving fleet ------------------------------------------------------

# The drives mix two 4096-row images, each key owned by one of the two
# workers (rendezvous over worker-0, worker-1: 4096^2 -> worker-0, 4096 x
# 2048 -> worker-1; a key is served by its owner, so one shape keeps one
# worker busy).
FLEET_IMAGES = ((4096, 4096), (4096, 2048))
FLEET_TENANTS = {"gold": 3.0, "free": 1.0}
# A worker's start holds the torch import, the CUDA context, the kernels'
# libraries and the prewarm: the beats' window and the spawn timeout allow
# for it.
FLEET_HB = dict(heartbeat_interval_s=0.5, heartbeat_k=12,
                spawn_timeout_s=300.0)
FLEET_SCALE = (1, 3)              # ScaleController bounds, fleet B
# Requests at once: past the router's admission capacity (64 for one
# worker), so the rest shed and the controller sees shed grow within its
# 0.5 s step however fast the card drains the queue.
FLEET_SCALE_BURST = 160
# Fleets B and D measure recovery, not shedding: a worker's latency budget
# there admits what a volume or a rerouted request would otherwise shed.
FLEET_DRILL_BUDGET_MS = 60_000.0
FLEET_CRASH = "worker:crash:3@seed=1"
FLEET_HANG = "worker:hang:60000@seed=0"
# Fleets B and C (the drills): small images, one key a worker in a ring of
# two (512 x 1024 -> worker-0, 1024^2 -> worker-1), so the pipe costs
# little.
FLEET_SMALL = ((512, 1024), (1024, 1024))
FLEET_DEVLOSS = "worker:devloss:1@seed=0"
# Fleet D's resident: NS-3D cut from 512^3 to 256^3, since its two ranks
# exchange through gloo's host staging (a 512^3 step there is ~7 s).
FLEET_RESIDENT_N = 256
FLEET_RANK_IMAGES = SERVE_RANK_IMAGE   # shard="x" 1024^2 on worker-0: 9, 10
# The c2c volume whose arriving ring blocks run kernel 11 (the serving
# phase's two-rank 256^3), in place of a 512^3 c2c's 1 GiB each way
# through the pipe.
FLEET_RANK_C2C = SERVE_RANK_C2C
# Kernels each fleet's paths may launch (all others must stay at 0).
FLEET_IMAGE_KERNELS = ("cmatmul", "cmatmul_tw", "rmatmul_tw")     # 2, 4, 5
# The images' inverses add kernel 3: the 2048-point y C2R its packed body,
# the 4096-point one its pack pass.
FLEET_IMAGE_INVERSE = ("c2r",)
FLEET_SMALL_KERNELS = ("rmatmul", "cmatmul")                     # 1, 2
FLEET_RANK_KERNELS = ("rmatmul", "cmatmul", "c2r", "enc_pack", "dec_unpack",
                      "dec_cmatmul")                              # 1-3, 9-11
FLEET_FUSED_KERNELS = ("zy_fwd", "x_c2c", "yz_inv")               # 6-8


@contextlib.contextmanager
def env_set(**kv):
    """os.environ with ``kv`` for the block (the spawned workers inherit
    it), then as it was."""
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update({k: str(v) for k, v in kv.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def fleet_sum(hf, rows_by_worker):
    """The launches (a full dict), entry points and matmul dispatches of
    every rank of every worker, summed; fails on a worker that did not
    answer or holds JAX."""
    launches = {k: 0 for k in hf.LAUNCHES}
    entries, matmul = {}, 0
    for name, rows in rows_by_worker.items():
        if rows is None:
            fail(f"fleet worker {name} did not report its counts")
        for r in rows:
            if "error" in r or r.get("jax"):
                fail(f"fleet worker {name}: {r}")
            for k, v in r["launches"].items():
                launches[k] += v
            for k, v in r["entries"].items():
                entries[k] = entries.get(k, 0) + v
            matmul += r["matmul"]
    if matmul:
        launches["matmul"] = matmul
    return launches, entries


def fleet_only_kernels(what, launches, allowed, required=None):
    """Fail unless ``launches`` stay within ``allowed`` (no matmul
    dispatch) and every kernel of ``required`` (default: all of
    ``allowed``) launched."""
    extra = {k: v for k, v in launches.items() if v and k not in allowed}
    missing = [k for k in (allowed if required is None else required)
               if not launches.get(k)]
    if extra or missing:
        fail(f"{what}: launched {launches} (outside {allowed}: {extra}; "
             f"never: {missing})")


def fleet_closed(fleet, what):
    """Fail unless every process the fleet's workers ran as (leaders,
    followers, every generation) has ended; returns their count."""
    pids = fleet.process_ids()
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        alive = [p for p in pids if _alive_pid(p)]
        if not alive:
            return len(pids)
        time.sleep(0.1)
    fail(f"{what}: worker processes {alive} outlived close()")


def _alive_pid(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def fleet_wait(fleet, cond, timeout_s, what):
    """cond(health) until it is true (returned) or ``timeout_s`` passes
    (fail, with the last health's counters, ring and workers)."""
    deadline = time.monotonic() + timeout_s
    while True:
        h = fleet.health()
        got = cond(h)
        if got:
            return got
        if time.monotonic() >= deadline:
            from distributedfft_tpu_torch.obs import flightrec
            recent = [(r["name"], r.get("attrs")) for r in
                      flightrec.snapshot()[-25:]]
            fail(f"fleet: {what} within {timeout_s} s: counters "
                 f"{h['counters']}, ring {h['ring']}, workers "
                 f"{ {k: (w['state'], w['generation'], w['devices']) for k, w in h['workers'].items()} }, "
                 f"recent records {recent}")
        time.sleep(0.1)


def fleet_no_jax(fleet, what):
    bad = {w.name: w.info for w in list(fleet._workers.values())
           if w.info.get("jax", True)}
    if bad:
        fail(f"{what}: a worker imports JAX or sent no ready info: {bad}")


def fleet_serving(torch, dft, hf, dev):
    """Fleet A: two one-rank workers (coalescing 8, batch_chunk 1, tenants
    gold:free 3:1) prewarmed on the two images and 512^3; single requests
    (each image and 512^3, forward and inverse) bit for bit the in-process
    Server's, within TOL of torch.fft, the workers' summed launches and
    entry points the in-process Server's for the same requests; a burst
    of eight of each image for the fleet's capacity; open-loop drives at
    0.7x (one tenant) and 1.5x (gold:free) of it; a single request's time
    through the fleet against the in-process Server's (the pipe's cost).
    Returns (launches, row)."""
    from distributedfft_tpu_torch.serve import Fleet, Overloaded, Server
    from distributedfft_tpu_torch.testing.workloads import serve_load
    cfg = dft.Config(fft_backend="pallas")
    row, launches = {}, {}
    t0 = time.perf_counter()
    fleet = Fleet(2, config=cfg, max_coalesce=SERVE_COALESCE, batch_chunk=1,
                  worker_inflight=SERVE_COALESCE,
                  tenant_weights=FLEET_TENANTS, **FLEET_HB)
    ref = None
    try:
        row["spawn_s"] = time.perf_counter() - t0
        fleet_no_jax(fleet, "fleet A")
        t0 = time.perf_counter()
        row["prewarm_built"] = (sum(fleet.prewarm(s) for s in FLEET_IMAGES)
                                + fleet.prewarm((N,) * 3))
        row["prewarm_s"] = time.perf_counter() - t0
        fleet.kernel_counts(reset=True)
        ref = Server(config=cfg, max_coalesce=SERVE_COALESCE, batch_chunk=1,
                     device=dev)
        gen = torch.Generator(device=dev).manual_seed(SEED + 95)
        xs = [torch.rand(s, generator=gen, device=dev)
              for s in FLEET_IMAGES + ((N,) * 3,)]
        hosts = [x.cpu().numpy() for x in xs]
        got, times = [], {"fleet": [], "local": []}
        for h in hosts:
            t0 = time.perf_counter()
            f = fleet.request(h, timeout_s=600)
            times["fleet"].append((time.perf_counter() - t0) * 1e3)
            b = fleet.request(f, "r2c", "inverse", ny=h.shape[-1],
                              timeout_s=600)
            got.append((f, b))
        counts = fleet.kernel_counts(reset=True)
        flaunch, fents = fleet_sum(hf, counts)
        hf.reset_launches()
        bit, errs = True, {}
        for (f, b), h, x in zip(got, hosts, xs):
            t0 = time.perf_counter()
            wf = ref.request(h)
            times["local"].append((time.perf_counter() - t0) * 1e3)
            wb = ref.request(wf, "r2c", "inverse", ny=h.shape[-1])
            bit = bit and np.array_equal(f, wf) and np.array_equal(b, wb)
            spec = torch.fft.rfftn(x)
            name = "x".join(map(str, h.shape))
            _, errs[f"{name}_forward"] = rel_err(torch.from_numpy(f).to(dev),
                                                 spec)
            _, errs[f"{name}_inverse"] = rel_err(
                torch.from_numpy(b).to(dev),
                torch.fft.irfftn(spec, s=h.shape, norm="forward"))
            del spec
        torch.cuda.synchronize()
        want, went = counted(hf), dict(hf.ENTRIES)
        del xs, got
        row.update(singles_bit_equal=bit, singles_vs_torch_fft=errs,
                   single_fleet_ms=times["fleet"],
                   single_local_ms=times["local"], singles_launches=flaunch,
                   singles_entries=fents, local_launches=want)
        if not bit or max(errs.values()) > TOL:
            fail(f"fleet A singles: bit-equal {bit}, errors {errs}")
        if flaunch != want or fents != went:
            fail(f"fleet A singles: workers launched {flaunch} ({fents}), "
                 f"the in-process Server {want} ({went})")
        fleet_only_kernels("fleet A singles", flaunch,
                           FLEET_IMAGE_KERNELS + FLEET_IMAGE_INVERSE
                           + FLEET_FUSED_KERNELS)
        launches["fleet_singles"] = flaunch
        emit(phase="fleet_singles", **row)
        # Capacity: eight of each image at once (a warm batch a worker),
        # the answered ones over the wall time (a worker sheds what its
        # latency budget cannot hold).
        imgs = [hosts[0], hosts[1]] * SERVE_COALESCE
        t0 = time.perf_counter()
        futs = [fleet.submit(h) for h in imgs]
        answered = 0
        for fu in futs:
            try:
                fu.result(600)
                answered += 1
            except Overloaded:
                pass
        burst = time.perf_counter() - t0
        row.update(burst_s=burst, burst_answered=answered)
        capacity = answered / burst
        row["capacity_fps"] = capacity
        emit(phase="fleet_capacity", burst_s=burst, answered=answered,
             capacity_fps=capacity)
        fleet.kernel_counts(reset=True)
        for load, tenants in zip(SERVE_LOADS, (None, list(FLEET_TENANTS))):
            out = serve_load(fleet, rate_hz=load * capacity,
                             duration_s=SERVE_DRIVE_S, shapes=FLEET_IMAGES,
                             seed=SEED + 5, warmup=0, tenants=tenants)
            serve_requests_ok(out, f"fleet drive at {load}x")
            out["load"] = load
            row[f"drive_{load}x"] = out
            emit(phase="fleet_drive", **out)
        dl, _ = fleet_sum(hf, fleet.kernel_counts(reset=True))
        fleet_only_kernels("fleet A drives", dl, FLEET_IMAGE_KERNELS)
        launches["fleet_drives"] = dl
        row["health"] = {k: fleet.health()[k] for k in ("status", "counters",
                                                        "tenants")}
    finally:
        if ref is not None:
            ref.close(drain=False)
        fleet.close(drain=False)
    row["processes"] = fleet_closed(fleet, "fleet A")
    return launches, row


def fleet_drills(torch, dft, hf, dev):
    """Fleets B and C, on FLEET_SMALL images. B: one worker under a
    ScaleController 1:3 and ``worker:crash:3@seed=1`` (in the workers'
    environment): a burst of FLEET_SCALE_BURST requests (the admitted
    ones answered, the rest shed) grows it to two;
    worker-1 (the 1024^2 key's owner) dies on its third request of a
    burst; every request is answered and the slot respawns. C: two
    workers under
    ``worker:hang:60000@seed=0``: worker-0 stops answering, is declared
    dead on missed beats and replaced; every request is answered. Returns
    (launches, rows)."""
    from distributedfft_tpu_torch.serve import (Fleet, Overloaded,
                                                ScaleController)
    cfg = dft.Config(fft_backend="pallas")
    launches, rows = {}, {}
    gen = torch.Generator(device=dev).manual_seed(SEED + 96)
    # -- B: scale-up, then the crash -----------------------------------------
    t0 = time.perf_counter()
    fleet = Fleet(FLEET_SCALE[0], config=cfg, max_coalesce=SERVE_COALESCE,
                  batch_chunk=1, worker_env={"DFFT_FAULT_SPEC": FLEET_CRASH},
                  latency_budget_ms=FLEET_DRILL_BUDGET_MS, **FLEET_HB)
    row = {"spawn_s": time.perf_counter() - t0, "fault": FLEET_CRASH}
    try:
        fleet_no_jax(fleet, "fleet B")
        for s in FLEET_SMALL:
            fleet.prewarm(s)
        ctl = ScaleController(fleet, *FLEET_SCALE, interval_s=0.5,
                              cooldown_s=600.0, queue_high=2.0)
        fleet.attach_controller(ctl)
        fleet.kernel_counts(reset=True)
        xs = [torch.rand(s, generator=gen, device=dev).cpu().numpy()
              for s in FLEET_SMALL]
        t0 = time.perf_counter()
        futs, shed = [], 0
        for i in range(FLEET_SCALE_BURST):
            try:
                futs.append(fleet.submit(xs[i % 2]))
            except Overloaded:
                shed += 1
        for f in futs:
            f.result(600)
        row.update(load_burst_s=time.perf_counter() - t0,
                   load_burst_answered=len(futs), load_burst_shed=shed)
        fleet_wait(fleet, lambda h: len(h["ring"]) >= 2, 120,
                   "the scale-up joined no worker")
        row["scale_up_s"] = time.perf_counter() - t0
        row["scale_decisions"] = fleet.health()["scale_decisions"]
        x = torch.rand(FLEET_SMALL[1], generator=gen, device=dev)
        h = x.cpu().numpy()
        spec = torch.fft.rfft2(x)
        t0 = time.perf_counter()
        futs = [fleet.submit(h) for _ in range(SERVE_COALESCE)]
        errs = [rel_err(torch.from_numpy(f.result(600)).to(dev), spec)[1]
                for f in futs]
        row["burst_s"] = time.perf_counter() - t0
        row["burst_max_rel_err"] = max(errs)
        if max(errs) > TOL:
            fail(f"fleet B burst: errors {errs}")
        hb = fleet_wait(fleet, lambda h: h if h["counters"][
            "worker_restarts"] >= 1 and len(h["ring"]) >= 2 else None, 180,
            "the crashed slot did not rejoin")
        row["recovered_s"] = time.perf_counter() - t0
        row["counters"] = hb["counters"]
        if hb["counters"]["worker_deaths"] != 1 or \
                hb["counters"]["failed"] or hb["counters"]["abandoned"]:
            fail(f"fleet B: counters {hb['counters']}")
        got, _ = fleet_sum(hf, fleet.kernel_counts(reset=True))
        fleet_only_kernels("fleet B", got, FLEET_SMALL_KERNELS)
        launches["fleet_scale_crash"] = got
    finally:
        fleet.close(drain=False)
    row["processes"] = fleet_closed(fleet, "fleet B")
    rows["scale_crash"] = row
    emit(phase="fleet_scale_crash", **row)
    # -- C: the hang -------------------------------------------------------
    t0 = time.perf_counter()
    fleet = Fleet(2, config=cfg, worker_env={"DFFT_FAULT_SPEC": FLEET_HANG},
                  heartbeat_interval_s=0.5, heartbeat_k=6,
                  spawn_timeout_s=300.0)
    row = {"spawn_s": time.perf_counter() - t0, "fault": FLEET_HANG}
    try:
        fleet_no_jax(fleet, "fleet C")
        xs = [torch.rand(s, generator=gen, device=dev)
              for s in FLEET_SMALL for _ in range(4)]
        t0 = time.perf_counter()
        futs = [fleet.submit(x.cpu().numpy(), deadline_ms=120_000)
                for x in xs]
        errs = [rel_err(torch.from_numpy(f.result(600)).to(dev),
                        torch.fft.rfft2(x))[1] for f, x in zip(futs, xs)]
        row["answered_s"] = time.perf_counter() - t0
        row["max_rel_err"] = max(errs)
        hc = fleet.health()
        row["counters"] = hc["counters"]
        if max(errs) > TOL or hc["counters"]["worker_deaths"] != 1 or \
                not hc["counters"]["resubmitted"]:
            fail(f"fleet C: errors {errs}, counters {hc['counters']}")
        rows_by_worker = fleet.kernel_counts(reset=True)
        got, _ = fleet_sum(hf, {k: v for k, v in rows_by_worker.items()
                                if v is not None})
        fleet_only_kernels("fleet C", got, FLEET_SMALL_KERNELS)
        launches["fleet_hang"] = got
    finally:
        fleet.close(drain=False)
    row["processes"] = fleet_closed(fleet, "fleet C")
    rows["hang"] = row
    emit(phase="fleet_hang", **row)
    return launches, rows


def fleet_ranks(torch, dft, hf, dev, outdir):
    """Fleet D: ``worker_devices=[2, 0]`` on the fused bf16 ring,
    ``shard="x"``: worker-0 a two-rank group (a leader and a follower
    process sharing the card over gloo) alone serves the volume keys and
    hosts an NS-3D resident whose steps the leader posts to the follower;
    the 512^3 volume's forward (kernels 1-2, 9, 10), a 256^3
    c2c volume (kernel 11) and 1024^2 images within WIRE16_TOL of
    torch.fft; the group's counts rank by rank; then
    ``worker:devloss:1@seed=0``: worker-0 dies on its next request, comes
    back one rank short, restores the two-rank checkpoint with
    ``persist.degraded_restore`` and serves that request on the fused
    kernels. Returns (launches, row)."""
    from distributedfft_tpu_torch.serve import Fleet
    row, launches = {}, {}
    obs_dir = os.path.join(outdir, "fleet_obs")
    ckdir = os.path.join(outdir, "fleet_ckpt")
    os.makedirs(obs_dir, exist_ok=True)
    resident = {"kind": "ns3d", "n": FLEET_RESIDENT_N, "dt": CKPT_DT,
                "dir": ckdir, "policy": "steps:2", "fft_backend": "pallas",
                "step_interval_ms": SERVE_RESIDENT_MS}
    gen = torch.Generator(device=dev).manual_seed(SEED + 97)
    x = torch.rand((N,) * 3, generator=gen, device=dev)
    b, ny, nx = FLEET_RANK_IMAGES
    imgs = torch.rand((b, ny, nx), generator=gen, device=dev)
    m = FLEET_RANK_C2C
    z = torch.complex(torch.rand((m,) * 3, generator=gen, device=dev),
                      torch.rand((m,) * 3, generator=gen, device=dev))
    # 1 request (the volume's forward: its 1 GiB round trip through the
    # pipe is the phase's longest) + 2 (the c2c volume) + b images, then
    # the request that meets the devloss (one more image).
    after = 1 + 2 + b + 1
    t0 = time.perf_counter()
    with env_set(DFFT_FAULT_SPEC=FLEET_DEVLOSS, DFFT_DEVLOSS_AFTER=after,
                 DFFT_OBS_DIR=obs_dir):
        fleet = Fleet(2, config=pencil_config(dft, SERVE_RING), shard="x",
                      worker_devices=[2, 0], resident=resident,
                      latency_budget_ms=FLEET_DRILL_BUDGET_MS, **FLEET_HB)
        try:
            row["spawn_s"] = time.perf_counter() - t0
            fleet_no_jax(fleet, "fleet D")
            h = fleet.health()
            if h["mesh_ring"] != ["worker-0"] or \
                    len(h["workers"]["worker-0"]["followers"]) != 1:
                fail(f"fleet D: {h['mesh_ring']}, {h['workers']}")
            first = fleet_wait(fleet, lambda h: h["resident"] if h[
                "resident"] and h["resident"].get("checkpoints") else None,
                240, "the two-rank resident wrote no checkpoint")
            row["resident_first"] = first
            fleet.kernel_counts(reset=True)
            hx = x.cpu().numpy()
            t0 = time.perf_counter()
            got = fleet.request(hx, timeout_s=600)
            row["volume_forward_ms"] = (time.perf_counter() - t0) * 1e3
            spec = torch.fft.rfftn(x)
            _, row["volume_forward_rel"] = rel_err(
                torch.from_numpy(got).to(dev), spec)
            del got, spec
            zc = fleet.request(z.cpu().numpy(), "c2c", timeout_s=600)
            zref = torch.fft.fftn(z)
            _, row["c2c_forward_rel"] = rel_err(torch.from_numpy(zc).to(dev),
                                                zref)
            zb = fleet.request(zc, "c2c", "inverse", timeout_s=600)
            _, row["c2c_inverse_rel"] = rel_err(
                torch.from_numpy(zb).to(dev),
                torch.fft.ifftn(zref, norm="forward"))
            del zc, zb, zref
            futs = [fleet.submit(im.cpu().numpy()) for im in imgs]
            gi = np.stack([f.result(600) for f in futs])
            _, row["images_forward_rel"] = rel_err(
                torch.from_numpy(gi).to(dev), torch.fft.rfft2(imgs))
            rows2 = fleet.kernel_counts(reset=True)["worker-0"]
            if rows2 is None or [r["rank"] for r in rows2] != [0, 1]:
                fail(f"fleet D: worker-0's ranks reported {rows2}")
            row["ranks"] = [{k: r[k] for k in ("rank", "pid", "launches",
                                               "matmul", "jax")}
                            for r in rows2]
            got2, ents2 = fleet_sum(hf, {"worker-0": rows2})
            for k in ("volume_forward_rel", "c2c_forward_rel",
                      "c2c_inverse_rel",
                      "images_forward_rel"):
                if not row[k] <= WIRE16_TOL:
                    fail(f"fleet D {k} {row[k]:.3e} > {WIRE16_TOL}")
            fleet_only_kernels("fleet D two-rank worker", got2,
                               FLEET_RANK_KERNELS)
            launches["fleet_two_rank_worker"] = got2
            row["two_rank_entries"] = ents2
            # The devloss: the next request kills worker-0's group; it is
            # resubmitted to the one-rank replacement.
            t0 = time.perf_counter()
            again = fleet.request(imgs[0].cpu().numpy(), timeout_s=600)
            row["devloss_request_ms"] = (time.perf_counter() - t0) * 1e3
            _, row["devloss_request_rel"] = rel_err(
                torch.from_numpy(again).to(dev), torch.fft.rfft2(imgs[0]))
            del again
            if not row["devloss_request_rel"] <= TOL:
                fail(f"fleet D after the devloss: {row}")
            hd = fleet_wait(fleet, lambda h: h if h["counters"][
                "worker_restarts"] >= 1 and h["resident"] and h[
                    "resident"].get("restored_from") and h["resident"][
                        "step"] > h["resident"]["restored_from"] else None,
                240, "the resident was not restored and stepping")
            w0 = hd["workers"]["worker-0"]
            row.update(after_devloss=dict(
                status=hd["status"], devices=w0["devices"],
                full_devices=w0["full_devices"], followers=w0["followers"],
                resident=hd["resident"], counters=hd["counters"]))
            if (w0["devices"], w0["full_devices"], w0["followers"]) != \
                    (1, 2, []) or hd["status"] != "degraded":
                fail(f"fleet D after the devloss: {row['after_devloss']}")
            rows3 = fleet.kernel_counts(reset=True)["worker-0"]
            got3, _ = fleet_sum(hf, {"worker-0": rows3})
            # The replacement runs the hot keys on one rank: the images
            # (prewarm, the resubmitted request: kernels 1 and 2) and the
            # volume's prewarm and the resident's steps (kernels 6-8).
            fleet_only_kernels("fleet D replacement", got3,
                               FLEET_FUSED_KERNELS + ("rmatmul", "cmatmul"),
                               FLEET_FUSED_KERNELS)
            launches["fleet_devloss_replacement"] = got3
        finally:
            fleet.close(drain=False)
    row["processes"] = fleet_closed(fleet, "fleet D")
    names = set()
    for fn in os.listdir(obs_dir):
        if fn.startswith("events-") and fn.endswith(".jsonl"):
            with open(os.path.join(obs_dir, fn)) as f:
                names |= {json.loads(ln)["name"] for ln in f if ln.strip()}
    row["events"] = sorted(n for n in names if n.startswith(
        ("persist.", "fleet.worker", "inject.")))
    for want in ("inject.worker_devloss", "fleet.worker_shrunk",
                 "persist.degraded_restore", "persist.resident_restored"):
        if want not in names:
            fail(f"fleet D: no {want} event ({sorted(names)})")
    return launches, row


def fleet_phase(torch, dft, hf, dev, outdir):
    """The serving fleet on the card (``serve/fleet.py``): (the launches
    of each path, the rows)."""
    t_phase = time.perf_counter()
    launches, rows = {}, {}
    torch.cuda.empty_cache()
    got, rows["serving"] = fleet_serving(torch, dft, hf, dev)
    launches.update(got)
    emit(phase="fleet_serving", **{k: v for k, v in rows["serving"].items()
                                   if not k.startswith("drive_")})
    got, rows["drills"] = fleet_drills(torch, dft, hf, dev)
    launches.update(got)
    got, rows["ranks"] = fleet_ranks(torch, dft, hf, dev, outdir)
    launches.update(got)
    emit(phase="fleet_ranks", **rows["ranks"])
    rows["seconds"] = time.perf_counter() - t_phase
    emit(phase="fleet_done", seconds=rows["seconds"])
    return launches, rows


# -- 16. evaluation and launch (roofline, launcher, reducer) -----------------

ROOFLINE_N = (128, 256, 512)       # the matmul backend's chain-timed cubes
ROOFLINE_PRECISIONS = ("high", "highest")
ROOFLINE_K = 3
LAUNCH_ITERS = ("-i", "10", "-w", "2")
LAUNCH_TOL = 0.10                  # reduced means against plan_time
LAUNCH_BACKENDS = ("pallas",)      # the kernels' plan


def roofline_csv(torch, path):
    """Chain-timed roundtrips of the matmul backend (``testing/
    chaintimer.py``) at ROOFLINE_N under each precision, written in
    ``roofline_rows``' CSV schema. Returns the rows written."""
    from distributedfft_tpu_torch.evalkit import roofline as rl
    from distributedfft_tpu_torch.ops import mxu_fft as mx
    from distributedfft_tpu_torch.testing import chaintimer as ct
    from distributedfft_tpu_torch.testing.workloads import flops_roundtrip_3d
    lines = [rl.CSV_HEADER]
    for prec in ROOFLINE_PRECISIONS:
        st = mx.MXUSettings.make(precision=prec)
        for n in ROOFLINE_N:
            x = torch.rand((n,) * 3, device="cuda")
            f1 = ct.roundtrip_chain(1, (n,) * 3, "matmul", st)
            fk = ct.roundtrip_chain(ROOFLINE_K, (n,) * 3, "matmul", st)
            ct._fence(f1(x))
            ct._fence(fk(x))
            ms, _ = ct.median_pair_diff_ms(f1, fk, x, ROOFLINE_K, 3, 1)
            gflops = flops_roundtrip_3d(n) / (ms * 1e-3) / 1e9
            lines.append(f"{n}^3,roundtrip,matmul@{prec},{ms},{gflops},"
                         f"{ROOFLINE_K},chain")
            del x
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return lines[1:]


def evalkit_phase(torch, outdir, plan_times):
    """Item 15 on the card: the matmul backend's chain-timed rows ->
    ``dfft-torch-roofline --csv`` (the H100 table); ``dfft-torch-launch``
    on a job of ``dfft-torch-slab`` at 512^3 under LAUNCH_BACKENDS (a
    ``-b`` prefix each), then ``dfft-torch-eval --prefix``, whose reduced
    fused means lie within LAUNCH_TOL of ``plan_time``'s for the same
    plans. Returns the row."""
    import contextlib as _cl
    import io
    from distributedfft_tpu_torch import launch
    from distributedfft_tpu_torch.evalkit import evaluate
    from distributedfft_tpu_torch.evalkit import roofline as rl
    t_phase = time.perf_counter()
    row = {}
    csv = os.path.join(outdir, "roofline_h100.csv")
    row["roofline_rows"] = roofline_csv(torch, csv)
    buf = io.StringIO()
    with _cl.redirect_stdout(buf):
        if rl.main(["--csv", csv]) != 0:
            fail("dfft-torch-roofline failed")
    row["roofline_table"] = buf.getvalue().splitlines()
    if len([ln for ln in row["roofline_table"] if ln.startswith("| ")
            and "^3" in ln]) != len(ROOFLINE_N) * len(ROOFLINE_PRECISIONS):
        fail(f"roofline table: {row['roofline_table']}")
    root = os.path.join(outdir, "launch")
    job = {"size": [N], "global_test_settings": {
        "$-t": 0, "-p": 1, "-comm": "All2All",
        **dict(zip(LAUNCH_ITERS[::2], LAUNCH_ITERS[1::2]))},
        "tests": [{"name": "Slab", "--fft-backend": be,
                   "-b": os.path.join(root, be)} for be in LAUNCH_BACKENDS]}
    path = os.path.join(outdir, "launch_job.json")
    with open(path, "w") as f:
        json.dump(job, f)
    t0 = time.perf_counter()
    buf = io.StringIO()
    with _cl.redirect_stdout(buf):
        rc = launch.main(["--jobs", path])
    row["launch_s"] = time.perf_counter() - t0
    row["launch_lines"] = [ln for ln in buf.getvalue().splitlines()
                           if ln.startswith("+ ")]
    if rc != 0:
        fail(f"dfft-torch-launch exited {rc}: {buf.getvalue()[-2000:]}")
    means = {}
    for be in LAUNCH_BACKENDS:
        out = os.path.join(root, f"eval_{be}")
        with _cl.redirect_stdout(io.StringIO()):
            if evaluate.main(["--prefix", os.path.join(root, be),
                              "--out", out]) != 0:
                fail(f"dfft-torch-eval {be} failed")
        with open(os.path.join(out, "slab_default", "runs",
                               "fused_0_1_1.csv")) as f:
            lines = f.read().splitlines()
        fused = float(lines[1].split(",")[2])
        ref = plan_times["fused_512"][f"{be}_forward_ms"] if plan_times \
            else None
        means[be] = dict(fused_ms=fused, plan_time_ms=ref,
                         ratio=fused / ref if ref else None)
    row["eval_vs_plan_time"] = means
    for be, m in means.items():
        if m["ratio"] is not None and abs(m["ratio"] - 1) > LAUNCH_TOL:
            fail(f"dfft-torch-eval {be}: fused mean {m['fused_ms']:.3f} ms "
                 f"against plan_time {m['plan_time_ms']:.3f}")
    row["seconds"] = time.perf_counter() - t_phase
    emit(phase="evalkit", **row)
    return row


def fleet_only() -> int:
    """Build the kernels and run the fleet and evaluation phases alone:
    ``python3 -c "import sys, chip_smoke; sys.exit(chip_smoke.fleet_only())"``
    (the launcher's means then stand beside a fresh 512^3 plan time)."""
    import torch
    import distributedfft_tpu_torch as dft
    from distributedfft_tpu_torch.ops import _build
    from distributedfft_tpu_torch.ops import hopper_fft as hf
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    emit(phase="device", name=torch.cuda.get_device_name(0),
         nvidia_smi=subprocess.run(
             ["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"], capture_output=True, text=True,
             check=True, timeout=60).stdout.strip())
    _build.build(sorted(p.stem for p in _build.CSRC.glob("*.cu")))
    outdir = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    dev = torch.device("cuda")
    launches, _ = fleet_phase(torch, dft, hf, dev, outdir)
    emit(phase="fleet_only", launches=launches)
    plan_times = {"fused_512": {}}
    for be in LAUNCH_BACKENDS:
        plan = dft.SlabFFTPlan(dft.GlobalSize(N, N, N), dft.SlabPartition(1),
                               dft.Config(fft_backend=be))
        x = torch.rand((N,) * 3, device=dev)
        plan_times["fused_512"][f"{be}_forward_ms"] = median_ms(
            torch, lambda: plan.exec_r2c(x))
        del plan, x
    evalkit_phase(torch, outdir, plan_times)
    return 0


# ---------------------------------------------------------------------------
# 17. static analysis, the stage profile and explain
# ---------------------------------------------------------------------------

ANALYSIS_ITERS = 3              # profiled iterations of each direction
ANALYSIS_BUSY_TOL = 0.10        # the nodes' summed ms against the busy ms
ANALYSIS_RING_N = 256           # two ranks: the fused bf16 ring's cube
ANALYSIS_RING = dict(wire_dtype="bf16", fused_wire=True)  # RingOverlap
ANALYSIS_RING_SEQ = "Z_Then_YX"  # its forward decodes into the y DFT (11)
ANALYSIS_PROFILES = {           # one card: the shape, the kernels it runs
    "slab_1024": ((NBIG,) * 3, ("rmatmul", "cmatmul", "c2r")),
    "fused_512": ((N,) * 3, ("zy_fwd", "x_c2c", "yz_inv")),
}
ANALYSIS_RING_KERNELS = ("enc_pack", "dec_unpack", "dec_cmatmul")
ANALYSIS_RENDERINGS = ("a2a", "opt1", "p2p", "streams", "ring", "ring_ovl",
                       "ring_ovl_d4", "ring_ovl_d8", "ring_sub2", "a2a_pipe",
                       "fused")
# The entry points each verified combo's route launches, on the verifier's
# 20 x 16 x 16 gate shape (ZY_Then_X, "pallas"): forward, z through kernel 1
# (rdft), y through kernel 2's column form, the 20-point x through kernel
# 2's row FFT body (cdft, the engine's mixed-radix kernel); the inverse
# mirrors it and ends in kernel 3 (c2r).
# Only the fused wire packs and unpacks in kernels 9 and 10; the unfused
# bf16 wire encodes with a plain convert, as the JAX reference's does.
ANALYSIS_SLAB_ENTRIES = {
    "forward": {"dfft_rdft", "dfft_cdft_cols", "dfft_cdft"},
    "inverse": {"dfft_cdft", "dfft_cdft_cols", "dfft_c2r"},
}
ANALYSIS_FUSED_WIRE_ENTRIES = {"dfft_enc_pack", "dfft_dec_unpack"}
ANALYSIS_CARD_ENTRIES = {     # dfft-torch-verify's single-card combos
    # the 16^3 single-device plan: kernel 6 (zy_*) and kernel 7 (x_cols)
    ("slab", "none"): {"dfft_zy_rows", "dfft_zy_cols", "dfft_zy_planes",
                       "dfft_x_cols"},
    ("slab", "bluestn"): set(),   # the chirp-z backend runs no kernel
    ("batched", "none"): {"dfft_rdft", "dfft_cdft"},    # batch-sharded 2D
}


def analysis_expected(c: dict) -> set:
    """The entry points a two-rank slab combo's route must launch."""
    want = set(ANALYSIS_SLAB_ENTRIES[c["direction"]])
    if c["rendering"] == "fused" and c["wire"] == "bf16":
        want |= ANALYSIS_FUSED_WIRE_ENTRIES
    return want


def analysis_profile(torch, hf, plan, what, agree=None):
    """``stage_profile`` of both directions of ``plan`` (collective on a
    plan over ranks; ``agree(ok)`` then gives every rank's verdict on a
    capture, so all retry together): a capture is taken anew while the
    trace lost a launch of the port's kernels (up to
    SERVE_CAPTURE_TRIES). Fails unless every declared node is attributed
    with device time and the nodes' summed ms lie within
    ANALYSIS_BUSY_TOL of the capture's busy ms. Returns ({direction:
    row}, {direction: launches})."""
    from distributedfft_tpu_torch.obs import profile
    agree = agree or (lambda ok: ok)
    rows, launches = {}, {}
    for d in ("forward", "inverse"):
        for _ in range(SERVE_CAPTURE_TRIES):
            hf.reset_launches()
            cap = profile.capture_stage_profile(plan, d,
                                                iters=ANALYSIS_ITERS)
            got = counted(hf)
            # one warmup call precedes the window's ANALYSIS_ITERS calls
            in_window = sum(got.values()) * ANALYSIS_ITERS \
                // (ANALYSIS_ITERS + 1)
            if agree(cap["port_kernel_records"] >= in_window):
                break
        capture_complete(f"{what} {d}", cap["port_kernel_records"],
                         in_window)
        prof = profile.stage_profile(plan, d, capture=cap)
        nodes = [r for r in prof["stages"]
                 if r["kind"] not in ("input", "output")]
        if not all(r["attributed"] and r["device_ms"] > 0 for r in nodes):
            fail(f"{what} {d}: a declared node has no device time: {nodes}")
        nodes_ms = sum(r["device_ms"] for r in nodes)
        busy = prof["busy_ms"]
        if not abs(nodes_ms - busy) <= ANALYSIS_BUSY_TOL * busy:
            fail(f"{what} {d}: the nodes' {nodes_ms:.3f} ms against the "
                 f"capture's busy {busy:.3f} ms")
        rows[d] = dict(
            nodes=[{k: r.get(k) for k in ("node", "kind", "label",
                                          "device_ms", "fraction",
                                          "ideal_ms", "bound_by", "gap_x")}
                   for r in nodes],
            nodes_ms=nodes_ms, busy_ms=busy, total_ms=prof["total_ms"],
            unattributed_ms=prof["unattributed_ms"],
            exchange_ms=prof["exchange_ms"], compute_ms=prof["compute_ms"],
            idle_share=prof["idle_share"],
            kernel_idle_share=prof["kernel_idle_share"],
            port_kernel_events=cap["port_kernel_events"],
            port_kernel_records=cap["port_kernel_records"],
            launches_in_window=in_window,
            lines=profile.format_stage_profile(prof))
        launches[d] = got
    return rows, launches


def analysis_capture_main(rank: int, outdir: str) -> None:
    """The single-card stage profiles in a process of their own, as the
    serve phase's captures (``serve_capture_main``): late in this script's
    long process the tracer lost every kernel record of the 1024^3 slab's
    capture on an H100."""
    import torch
    import distributedfft_tpu_torch as dft
    from distributedfft_tpu_torch.ops import hopper_fft as hf

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = {}
    for what, (shape, _) in ANALYSIS_PROFILES.items():
        t0 = time.perf_counter()
        plan = dft.SlabFFTPlan(dft.GlobalSize(*shape), dft.SlabPartition(1),
                               dft.Config(fft_backend="pallas"), device=dev)
        prof, got = analysis_profile(torch, hf, plan, what)
        prof["seconds"] = time.perf_counter() - t0
        out[what] = (prof, got)
        del plan
        torch.cuda.empty_cache()
    with open(os.path.join(outdir, "analysis_capture.json"), "w") as f:
        json.dump(out, f)


def analysis_rank_main(rank: int, addr: str, outdir: str) -> None:
    """Two ranks sharing the card over gloo: every slab rendering of
    ``dfft-torch-verify``'s matrix under "pallas" on both wires and in
    both directions (census, payload, graph against the trace, the lints,
    the launches each trace recorded), then the stage profile of the
    256^3 fused bf16 ring (kernels 9-11)."""
    import torch
    import torch.distributed as dist
    import distributedfft_tpu_torch as dft
    from distributedfft_tpu_torch.analysis import verify
    from distributedfft_tpu_torch.ops import hopper_fft as hf
    from distributedfft_tpu_torch.parallel import multihost

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    multihost.maybe_initialize(addr, RANKS, rank, backend="gloo",
                               timeout_s=300)
    dev = torch.device("cuda")
    out = {"rank": rank, "combos": []}
    t0 = time.perf_counter()
    for rendering in ANALYSIS_RENDERINGS:
        for wire in ("native", "bf16"):
            for d in ("forward", "inverse"):
                combo = dict(family="slab", rendering=rendering,
                             sequence="ZY_Then_X", wire=wire, guards="off",
                             direction=d)
                res = verify.run_combo(combo, RANKS, dev, "pallas")
                out["combos"].append({k: res[k] for k in (
                    "rendering", "wire", "direction", "contract", "census",
                    "kernels", "violations", "ok")})
    out["verify_seconds"] = time.perf_counter() - t0

    def agree(ok: bool) -> bool:
        flag = torch.tensor([int(ok)], dtype=torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        return bool(flag.item())

    t0 = time.perf_counter()
    n = ANALYSIS_RING_N
    plan = dft.SlabFFTPlan(dft.GlobalSize(n, n, n), dft.SlabPartition(RANKS),
                           dft.Config(fft_backend="pallas",
                                      send_method=dft.SendMethod.RING_OVERLAP,
                                      **ANALYSIS_RING),
                           sequence=ANALYSIS_RING_SEQ, device=dev)
    out["ring"], out["ring_launches"] = analysis_profile(
        torch, hf, plan, f"rank {rank} ring {n}^3", agree)
    out["ring_seconds"] = time.perf_counter() - t0
    with open(os.path.join(outdir, f"analysis_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    multihost.shutdown()


def analysis_phase(torch, dft, hf, multihost, dev, outdir):
    """Phase 17 (``analysis_only()`` runs it alone): ``dfft-torch-verify
    --fft-backend pallas`` on the card (its single-device combos, pins,
    schedules and source lints), the stage profile of the 1024^3 slab
    (kernels 1-3) and the 512^3 fused plan (kernels 6-8) in both
    directions (in a fresh process, ``analysis_capture_main``),
    ``dfft-torch-explain`` of the 1024^3 slab under "pallas"
    (its contract line PASS), then two ranks sharing the card: the slab's
    renderings verified and the 256^3 fused bf16 ring profiled. Prints
    each node's ms, ideal ms and gap. Returns (launches, row)."""
    import contextlib as _cl
    import io
    import torch.multiprocessing as tmp
    from distributedfft_tpu_torch.analysis import verify
    from distributedfft_tpu_torch.obs import explain
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    row, launches = {}, {}

    t0 = time.perf_counter()
    path = os.path.join(outdir, "verify_card.json")
    buf = io.StringIO()
    with _cl.redirect_stdout(buf):
        rc = verify.main(["--fft-backend", "pallas", "--json", path])
    with open(path) as f:
        rep = json.load(f)
    if rc != 0 or not rep["ok"]:
        fail(f"dfft-torch-verify on the card: rc {rc}\n"
             f"{buf.getvalue()[-3000:]}")
    row["verify_card"] = dict(
        combos=[{k: c[k] for k in ("family", "rendering", "contract",
                                    "census", "kernels", "ok")}
                for c in rep["combos"]],
        pins=rep["pins"], sched=len(rep["sched"]), srclint=rep["srclint"],
        seconds=time.perf_counter() - t0)
    bad = [(c["family"], c["rendering"], c["kernels"])
           for c in rep["combos"]
           if set(c["kernels"]) != ANALYSIS_CARD_ENTRIES.get(
               (c["family"], c["rendering"]))]
    if bad or len(rep["combos"]) != len(ANALYSIS_CARD_ENTRIES):
        fail(f"verify on the card: combos whose launches differ from "
             f"their route's {ANALYSIS_CARD_ENTRIES}: {bad}")

    row["profiles"] = {}
    tmp.spawn(analysis_capture_main, args=(outdir,), nprocs=1, join=True)
    with open(os.path.join(outdir, "analysis_capture.json")) as f:
        captured = json.load(f)
    for what, (shape, kernels) in ANALYSIS_PROFILES.items():
        prof, got = captured[what]
        used = {k for c in got.values() for k, v in c.items() if v}
        if not set(kernels) <= used:
            fail(f"{what}: launches {got}, expected {kernels}")
        for d, counts in got.items():
            launches[f"analysis_{what}_{d}"] = counts
        row["profiles"][what] = prof
        for d in ("forward", "inverse"):
            for ln in prof[d]["lines"]:
                print(f"stage_profile {what} {d}: {ln}", flush=True)

    t0 = time.perf_counter()
    buf = io.StringIO()
    with _cl.redirect_stdout(buf):
        rc = explain.main(["--kind", "slab", "-nx", str(NBIG), "-ny",
                           str(NBIG), "-nz", str(NBIG), "--fft-backend",
                           "pallas"])
    text = buf.getvalue()
    contract = [ln for ln in text.splitlines() if "contract:" in ln]
    if rc != 0 or not contract or "contract: PASS" not in contract[0]:
        fail(f"dfft-torch-explain 1024^3: rc {rc}\n{text[-3000:]}")
    row["explain"] = dict(contract=contract[0].strip(),
                          census=[ln.strip() for ln in text.splitlines()
                                  if ln.startswith("  all_to_all:")
                                  or ln.startswith("  kernels:")],
                          roofline=[ln.strip() for ln in text.split(
                              "roofline (")[-1].splitlines()[1:]],
                          seconds=time.perf_counter() - t0)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    tmp.spawn(analysis_rank_main, args=(multihost.local_coordinator(),
                                        outdir),
              nprocs=RANKS, join=True)
    ranks = []
    for r in range(RANKS):
        with open(os.path.join(outdir, f"analysis_rank{r}.json")) as f:
            ranks.append(json.load(f))
    for rk in ranks:
        bad = [c for c in rk["combos"] if not c["ok"]
               or set(c["kernels"]) != analysis_expected(c)]
        if bad or len(rk["combos"]) != 4 * len(ANALYSIS_RENDERINGS):
            fail(f"rank {rk['rank']}: combos failed or launched other "
                 f"entries than their route's: {bad}")
        for d, counts in rk["ring_launches"].items():
            launches[f"analysis_ring_{ANALYSIS_RING_N}_{d}_rank{rk['rank']}"
                     ] = counts
        used = {k for c in rk["ring_launches"].values() for k, v in
                c.items() if v}
        if not set(ANALYSIS_RING_KERNELS) <= used:
            fail(f"rank {rk['rank']} ring: launches "
                 f"{rk['ring_launches']}, expected {ANALYSIS_RING_KERNELS}")
    r0 = ranks[0]
    for d in ("forward", "inverse"):
        for ln in r0["ring"][d]["lines"]:
            print(f"stage_profile ring_{ANALYSIS_RING_N}_rank0 {d}: {ln}",
                  flush=True)
    row["ranks"] = dict(
        combos=len(r0["combos"]),
        per_rank=[{k: rk[k] for k in ("rank", "ring", "verify_seconds",
                                      "ring_seconds")} for rk in ranks],
        kernels_by_combo={f"{c['rendering']}/{c['wire']}/{c['direction']}":
                          c["kernels"] for c in r0["combos"]},
        census_by_combo={f"{c['rendering']}/{c['wire']}/{c['direction']}":
                         c["census"] for c in r0["combos"]},
        seconds=time.perf_counter() - t0)
    row["seconds"] = time.perf_counter() - t_phase
    emit(phase="analysis", **row)
    return launches, row


def analysis_only() -> int:
    """Build the kernels and run phase 17 alone:
    ``python3 -c "import sys, chip_smoke; sys.exit(chip_smoke.analysis_only())"``."""
    import torch
    import distributedfft_tpu_torch as dft
    from distributedfft_tpu_torch.ops import _build
    from distributedfft_tpu_torch.ops import hopper_fft as hf
    from distributedfft_tpu_torch.parallel import multihost
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    emit(phase="device", name=torch.cuda.get_device_name(0),
         nvidia_smi=subprocess.run(
             ["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"], capture_output=True, text=True,
             check=True, timeout=60).stdout.strip())
    t0 = time.perf_counter()
    _build.build(sorted(p.stem for p in _build.CSRC.glob("*.cu")))
    emit(phase="build", seconds=time.perf_counter() - t0)
    outdir = tempfile.mkdtemp(prefix="chip_smoke_analysis_")
    launches, _ = analysis_phase(torch, dft, hf, multihost,
                                 torch.device("cuda"), outdir)
    emit(phase="analysis_only", launches=launches)
    return 0


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
    x480 = randn(N, 480, 480)     # kernels 6 and 8 on the mixed-radix
    Z4 = 480 // 2 + 1             # engine (480 = 12 x 10 x 4)
    x448 = randn(N, 448, 448)     # kernel 6 on the engine at 448 = 8 x 8 x 7
    x442 = randn(N, 442, 442)     # its dense body (442 = 2 x 13 x 17)
    Z8 = 448 // 2 + 1
    Z2 = 442 // 2 + 1
    Z375 = 375 // 2 + 1           # kernel 8 at an odd Z, checked only
    pr480, pi480 = randn(N, 480, Z4), randn(N, 480, Z4)
    pr448, pi448 = randn(N, 448, Z8), randn(N, 448, Z8)
    pr442, pi442 = randn(N, 442, Z2), randn(N, 442, Z2)
    pc442 = torch.complex(pr442, pi442)
    pr375, pi375 = randn(N, 250, Z375), randn(N, 250, Z375)
    pr, pi = randn(N, N, Zo), randn(N, N, Zo)
    fzr, fzi = hf._planes("rdft", N, False, dev)
    fyr, fyi = hf._planes("dft", N, False, dev)
    fxr, fxi = hf._planes("dft", N, True, dev)
    fxfr, fxfi = hf._planes("dft", N, False, dev)
    # Kernel 7 on the mixed-radix column kernel at (480, 512, 257) beside
    # PR 1-24's dense row there, and at the 480^3 and 448^3 plans' shapes
    # and the ragged odd (375, 375, 188): planes and the complex64 spectrum
    # of each, made once, so that no library call times a join. Its dense
    # body at X = 442 (a factor past 13).
    x7 = {}
    for name7, X7, Ky7 in (("mixed_480_y512", 480, N), ("mixed_480", 480, 480),
                           ("mixed_448", 448, 448), ("odd_375", 375, 375)):
        ar7, ai7 = randn(X7, Ky7, Ky7 // 2 + 1), randn(X7, Ky7, Ky7 // 2 + 1)
        x7[name7] = (X7, (ar7, ai7, torch.complex(ar7, ai7)))
    xr442, xi442 = randn(442, N, Zo), randn(442, N, Zo)
    xc442 = torch.complex(xr442, xi442)
    fyir, fyii = hf._planes("dft", N, True, dev)
    cr, ci = hf._planes("c2r", N, False, dev)
    pc = torch.complex(pr, pi)
    pc480 = torch.complex(pr480, pi480)
    pc448 = torch.complex(pr448, pi448)
    X = Y = Z = N
    f480 = (hf._planes("rdft", 480, False, dev) + hf._planes("dft", 480, False,
                                                             dev))
    f448 = (hf._planes("rdft", 448, False, dev) + hf._planes("dft", 448, False,
                                                             dev))
    f442 = (hf._planes("rdft", 442, False, dev) + hf._planes("dft", 442, False,
                                                             dev))

    def inv_planes(y, z):
        return hf._planes("dft", y, True, dev) + hf._planes("c2r", z, False,
                                                             dev)

    def x_row(variant, X7, inverse, data, check_only=False):
        """Kernel 7's row on (X7, Ky, Zo) data (planes and their complex64
        spectrum): the inverse's layouts (complex64 in, planes out) or the
        forward's (planes in, complex64 out)."""
        ar7, ai7, c7 = data
        f7 = hf._planes("dft", X7, inverse, dev)
        rows = ar7[0].numel()
        if inverse:
            calls = dict(
                run=lambda: hf.x_cols(c7, True, complex_out=False),
                plain=lambda: hf.x_c2c_plain(ar7, ai7, *f7),
                library=lambda: torch.fft.ifft(c7, dim=0, norm="forward"),
                library_call="ifft(dim=0, norm='forward')")
        else:
            calls = dict(
                run=lambda: hf.x_cols((ar7, ai7), False, complex_out=True),
                plain=lambda: torch.complex(*hf.x_c2c_plain(ar7, ai7, *f7)),
                library=lambda: torch.fft.fft(c7, dim=0),
                library_call="fft(dim=0)")
        return dict(name="x_c2c", variant=variant, replaces=f"{PALLAS}:443",
                    shape=dict(X=X7, Y=ar7.shape[1], Zo=ar7.shape[2]),
                    check_only=check_only, flops=fft_flops(rows, X7),
                    gemm_flops=8 * X7 * X7 * rows, bytes=16 * X7 * rows,
                    **calls)
    fused = [
        dict(name="zy_fwd", replaces=f"{PALLAS}:427",
             shape=dict(X=X, Y=Y, Z=Z),
             run=lambda: hf.zy_fwd(x),
             plain=lambda: hf.zy_fwd_plain(x, fzr, fzi, fyr, fyi),
             library=lambda: torch.fft.rfft2(x), library_call="rfft2",
             flops=fft_flops(X * Y, Z, real=True) + fft_flops(X * Zo, Y),
             gemm_flops=4 * X * Y * Z * Zo + 8 * X * Y * Y * Zo,
             bytes=4 * (X * Y * Z + 2 * X * Y * Zo)),
        # Kernel 6 at 480 and 448 on the engine's mixed-radix kernel (its
        # three passes), and its dense body at 442 (a factor past 13).
        dict(name="zy_fwd", variant="fft_480",
             replaces=f"{PALLAS}:427",
             shape=dict(X=X, Y=480, Z=480),
             run=lambda: hf.zy_fwd(x480),
             plain=lambda: hf.zy_fwd_plain(x480, *f480),
             library=lambda: torch.fft.rfft2(x480), library_call="rfft2",
             flops=fft_flops(X * 480, 480, real=True) + fft_flops(X * Z4, 480),
             gemm_flops=4 * X * 480 * 480 * Z4 + 8 * X * 480 * 480 * Z4,
             bytes=4 * (X * 480 * 480 + 2 * X * 480 * Z4)),
        dict(name="zy_fwd", variant="fft_448",
             replaces=f"{PALLAS}:427",
             shape=dict(X=X, Y=448, Z=448),
             run=lambda: hf.zy_fwd(x448),
             plain=lambda: hf.zy_fwd_plain(x448, *f448),
             library=lambda: torch.fft.rfft2(x448), library_call="rfft2",
             flops=fft_flops(X * 448, 448, real=True) + fft_flops(X * Z8, 448),
             gemm_flops=4 * X * 448 * 448 * Z8 + 8 * X * 448 * 448 * Z8,
             bytes=4 * (X * 448 * 448 + 2 * X * 448 * Z8)),
        dict(name="zy_fwd", variant="dense_442", body="dense",
             replaces=f"{PALLAS}:427",
             shape=dict(X=X, Y=442, Z=442),
             run=lambda: hf.zy_fwd(x442),
             plain=lambda: hf.zy_fwd_plain(x442, *f442),
             library=lambda: torch.fft.rfft2(x442), library_call="rfft2",
             flops=fft_flops(X * 442, 442, real=True) + fft_flops(X * Z2, 442),
             gemm_flops=4 * X * 442 * 442 * Z2 + 8 * X * 442 * 442 * Z2,
             bytes=4 * (X * 442 * 442 + 2 * 442 * Z2 + 2 * 442 * 442
                        + 2 * X * 442 * Z2)),
        # Kernel 7 on each layout pair the fused plan launches: the
        # inverse's (the complex64 spectrum in, kernel 8's planes out) and
        # the forward's (kernel 6's planes in, the spectrum out); on the
        # mixed-radix column kernel (x_row); the dense body at X = 442. An
        # FFT body's bytes count no DFT matrix.
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
        *(x_row(f"{name7}_{d}", X7, d == "inverse", data,
                check_only=name7 == "odd_375")
          for name7, (X7, data) in x7.items()
          for d in (("inverse",) if name7 == "mixed_480_y512"
                    else ("inverse", "forward"))),
        dict(name="x_c2c", variant="dense_442", body="dense",
             replaces=f"{PALLAS}:443", shape=dict(X=442, Y=Y, Zo=Zo),
             run=lambda: hf.x_c2c(xr442, xi442, inverse=True),
             plain=lambda: hf.x_c2c_plain(xr442, xi442,
                                          *hf._planes("dft", 442, True, dev)),
             library=lambda: torch.fft.ifft(xc442, dim=0, norm="forward"),
             library_call="ifft(dim=0, norm='forward')",
             flops=fft_flops(Y * Zo, 442), gemm_flops=8 * 442 * 442 * Y * Zo,
             bytes=16 * 442 * Y * Zo + 8 * 442 * 442),
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
        # Kernel 8 at 480 and 448 on the engine's mixed-radix kernel (its
        # three passes; the 480^3 and 448^3 inverses), checked only at the
        # odd Z of (X, 250, 375) (z-pass batches of 12 rows crossing
        # x-planes) and on its dense body at 442 (a factor past 13).
        *(dict(name="yz_inv", variant=f"fft_{n}", replaces=f"{PALLAS}:452",
               shape=dict(X=X, Y=n, Z=n),
               run=lambda a=a, b=b, n=n: hf.yz_inv(a, b, n),
               plain=lambda a=a, b=b, n=n: hf.yz_inv_plain(
                   a, b, *inv_planes(n, n)),
               library=lambda c=c, n=n: torch.fft.irfft2(
                   c, s=(n, n), norm="forward"),
               library_call="irfft2",
               flops=fft_flops(X * (n // 2 + 1), n)
               + fft_flops(X * n, n, real=True),
               gemm_flops=8 * X * n * n * (n // 2 + 1)
               + 4 * X * n * (n // 2 + 1) * n,
               bytes=4 * (2 * X * n * (n // 2 + 1) + X * n * n))
          for n, a, b, c in ((480, pr480, pi480, pc480),
                             (448, pr448, pi448, pc448))),
        dict(name="yz_inv", variant="odd_375", check_only=True,
             replaces=f"{PALLAS}:452", shape=dict(X=X, Y=250, Z=375),
             run=lambda: hf.yz_inv(pr375, pi375, 375),
             plain=lambda: hf.yz_inv_plain(pr375, pi375,
                                           *inv_planes(250, 375))),
        dict(name="yz_inv", variant="dense_442", body="dense",
             replaces=f"{PALLAS}:452", shape=dict(X=X, Y=442, Z=442),
             run=lambda: hf.yz_inv(pr442, pi442, 442),
             plain=lambda: hf.yz_inv_plain(pr442, pi442,
                                           *inv_planes(442, 442)),
             library=lambda: torch.fft.irfft2(pc442, s=(442, 442),
                                              norm="forward"),
             library_call="irfft2",
             flops=fft_flops(X * Z2, 442) + fft_flops(X * 442, 442, real=True),
             gemm_flops=8 * X * 442 * 442 * Z2 + 4 * X * 442 * Z2 * 442,
             bytes=4 * (2 * X * 442 * Z2 + 2 * 442 * 442 + 2 * Z2 * 442
                        + X * 442 * 442)),
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
    del pr375, pi375
    torch.cuda.empty_cache()

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
        if k.get("check_only"):
            continue
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
    del x, x480, x448, x442, pr, pi, pc, pr480, pi480, pc480, pr448, pi448, \
        pc448, pr442, pi442, pc442, x7, xr442, xi442, xc442, cp, cx, plan, \
        xla
    for k in fused:                  # their closures hold the inputs too
        for f in ("run", "plain", "library"):
            k.pop(f, None)
    torch.cuda.empty_cache()

    # -- 5b. the 480^3 and 448^3 fused plans: kernels 6 and 8 on the ---------
    # mixed-radix engine
    for pid in FUSED_SLABS:
        launches[pid], plan_times[pid] = fused_slab_path(torch, dft, hf, gen,
                                                         pid)

    # -- 6. per-axis kernels 1-5: check against plain, then time -------------
    staged = stage_cases(torch, hf, dev, gen)
    for k in staged:
        k["source"] = "distributedfft_tpu_torch/csrc/stage.cu"
        k["body"] = body_of(hf, k)
        t = k["make"]()
        got, ref = k["run"](t), k["plain"](t)
        torch.cuda.synchronize()
        k["max_abs_err"], k["max_rel_err"] = rel_err(got, ref)
        if k.get("check_only"):      # and against the library's function
            _, k["library_rel_err"] = rel_err(got, k["library"](t))
        del got, ref
        emit(phase="kernel_check", name=k["name"], variant=k.get("variant"),
             body=k["body"], shape=k["shape"], max_abs_err=k["max_abs_err"],
             max_rel_err=k["max_rel_err"],
             library_rel_err=k.get("library_rel_err"), tol=TOL)
        if not (k["max_rel_err"] <= TOL
                and k.get("library_rel_err", 0.0) <= TOL):
            fail(f"kernel {k['name']} {k['shape']} disagrees with its plain "
                 f"version (rel {k['max_rel_err']:.3e}) or the library's "
                 f"(rel {k.get('library_rel_err')}), tol {TOL}")
        if k.get("check_only"):
            del t
            continue
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
        if k["name"] == "enc_pack" and "variant" not in k:
            k["alternated"] = alternated_ms(torch, lambda: k["run"](t),
                                            lambda: k["library"](t))
            emit(phase="kernel9_alternated", **k["alternated"])
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

    # -- 7a. the guards on the single-card main paths ------------------------
    t0 = time.perf_counter()
    guards_main(torch, dft, hf, gen, plan_times)
    emit(phase="guards_done", seconds=time.perf_counter() - t0)

    # -- 7b. the matmul backend: float64 "pallas", "matmul", a long prime ----
    t0 = time.perf_counter()
    from distributedfft_tpu_torch.ops import mxu_fft as mx
    matmul_rows = {}
    for pid, n in F64_PATHS.items():
        launches[pid], matmul_rows[pid] = f64_path(torch, dft, hf, mx, gen,
                                                   pid, n)
    matmul_rows.update(matmul_paths(torch, dft, hf, mx, gen))
    matmul_rows["long_prime"] = long_prime(torch, hf, gen)
    # The four-step's pieces at 1 GiB of float64 1024-point rows, in the
    # formulation the backend runs and the one it replaced.
    from distributedfft_tpu_torch.testing import microbench
    matmul_rows["fourstep_pieces_ms"] = microbench.matmul_fourstep_ms()
    emit(phase="matmul_fourstep_pieces", **matmul_rows["fourstep_pieces_ms"])
    torch.cuda.empty_cache()
    emit(phase="matmul_done", seconds=time.perf_counter() - t0)

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
    for group, paths in (("ring", RING_PATHS),
                         ("exchange_renderings", EXCHANGE_PATHS)):
        for pid in paths:
            row = r0[group][pid]
            launches[f"distributed_512_{pid}_rank0"] = {
                k: row["launches_forward"][k] + row["launches_inverse"][k]
                for k in row["launches_forward"]}
    emit(phase="main_path", path="distributed_512", ranks=RANKS,
         exchange="gloo, host-staged, 2 ranks on 1 card",
         seconds=time.perf_counter() - t0, per_rank=ranks)
    # The exchange alone per direction (host wall clock, median of 3, both
    # ranks at once) and the bytes each rank sends: gloo over the host on
    # one card, which says nothing about NCCL across cards.
    for rk in ranks:
        sent = rk["exchange_bytes"] * (RANKS - 1) // RANKS
        table = {"all_to_all_native": dict(
            forward_ms=rk["exchange_forward_ms"],
            inverse_ms=rk["exchange_inverse_ms"],
            wire_bytes_per_rank={"forward": sent, "inverse": sent})}
        for pid in EXCHANGE_TIMED:
            row = (rk["ring"] if pid in RING_PATHS
                   else rk["exchange_renderings"])[pid]
            table[pid] = dict(forward_ms=row["exchange_forward_ms"],
                              inverse_ms=row["exchange_inverse_ms"],
                              wire_bytes_per_rank=row["wire_bytes_per_rank"])
        emit(phase="exchange", rank=rk["rank"],
             transport=rk["ring"]["transport"], renderings=table)
    # The resilience cases of the two ranks: one verdict on both.
    res = [rk["resilience"] for rk in ranks]
    verdicts = {key: same_violation([r[key] for r in res], key)
                for key in res[0] if key.startswith("enforce_")}
    if len({r["bitflip_seed"] for r in res}) != 1:
        fail(f"the ranks aimed the bit flip apart: {res}")
    for d in ("forward", "inverse"):
        verdicts[f"ring_fused_wire_nan_{d}"] = same_violation(
            [r["ring_fused_wire_nan"][d] for r in res], f"fused ring {d}")
    emit(phase="resilience_ranks", ranks=RANKS, shape=[N] * 3,
         exchange="gloo, host-staged, 2 ranks on 1 card", verdicts=verdicts,
         seconds=[rk["resilience_seconds"] for rk in ranks], per_rank=res)

    # -- 8b. the executables: slab and reference, on one card and two ranks -
    t0 = time.perf_counter()
    cli_launches, cli_rows = cli_single_card(torch, dft, hf, plan_times)
    launches.update(cli_launches)
    cli_launches, matmul_rows["cli_f64"] = cli_f64(torch, dft, hf)
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
         exchange="gloo, host-staged, 2 ranks on 1 card",
         per_rank=[{k: v for k, v in rk.items() if k != "selftest"}
                   for rk in cli_ranks])
    emit(phase="cli_done", seconds=time.perf_counter() - t0)

    # -- 8b'. the executables' --selftest: one card, then two ranks ----------
    t0 = time.perf_counter()
    emit(phase="selftest_cli", single_card=selftest_single_card(torch, dft,
                                                                  hf),
         ranks=[rk["selftest"] for rk in cli_ranks],
         seconds=time.perf_counter() - t0
         + sum(rk["selftest_seconds"] for rk in cli_ranks) / RANKS)

    # -- 8c. the pencil plan: 1 x 1 per axis, then 2 x 2 as four ranks -------
    t0 = time.perf_counter()
    pen_launches, _ = pencil_single_card(torch, dft, hf, gen)
    launches.update(pen_launches)
    tmp.spawn(pencil_rank_main, args=(multihost.local_coordinator(), outdir),
              nprocs=PENCIL_RANKS, join=True)
    pen_ranks = []
    for r in range(PENCIL_RANKS):
        with open(os.path.join(outdir, f"pencil_rank{r}.json")) as f:
            pen_ranks.append(json.load(f))
    p0 = pen_ranks[0]
    for group, prefix in (("full", f"pencil_full_{PENCIL_FULL_N}"),
                          ("renderings", f"pencil_{N}")):
        for pid in (PENCIL_FULL if group == "full" else PENCIL_PATHS):
            row = p0[group][pid]
            launches[f"{prefix}_{pid}_rank0"] = {
                k: row["launches_forward"][k] + row["launches_inverse"][k]
                for k in row["launches_forward"]}
    for name, v in p0["cli"]["launches"].items():
        launches[f"{name}_rank0"] = v
    for rk in pen_ranks:
        emit(phase="pencil_full", rank=rk["rank"], grid=list(PENCIL_GRID),
             shape=[PENCIL_FULL_N] * 3,
             exchange="gloo, host-staged, 4 ranks on 1 card",
             seconds=rk["full_seconds"], paths=rk["full"])
    emit(phase="pencil_renderings", shape=[N] * 3, grid=list(PENCIL_GRID),
         per_rank={rk["rank"]: rk["renderings"] for rk in pen_ranks},
         seconds=p0["renderings_seconds"])
    emit(phase="pencil_cli", rank0=p0["cli"], seconds=p0["cli_seconds"])
    emit(phase="resilience_pencil", grid=list(PENCIL_GRID), shape=[N] * 3,
         verdict=same_violation([rk["guard"] for rk in pen_ranks],
                                "pencil enforce under wire:nan"),
         per_rank=[rk["guard"] for rk in pen_ranks])
    emit(phase="pencil_done", seconds=time.perf_counter() - t0)

    # -- 8d. the batched-2D plan: one card, the executable, two ranks --------
    t0 = time.perf_counter()
    batched_rows = {}
    for pid, (shape, path, chunks) in BATCHED_CARD.items():
        got, batched_rows[pid] = batched_path(torch, dft, hf, gen, pid, shape,
                                              path, chunks)
        launches.update(got)
    got, batched_rows["cli"] = batched_cli_single_card(
        torch, dft, hf, batched_rows["batched_64x4096"])
    launches.update(got)
    torch.cuda.empty_cache()
    tmp.spawn(batched_rank_main, args=(multihost.local_coordinator(), outdir),
              nprocs=RANKS, join=True)
    b_ranks = []
    for r in range(RANKS):
        with open(os.path.join(outdir, f"batched_rank{r}.json")) as f:
            b_ranks.append(json.load(f))
    b0 = b_ranks[0]
    rows0 = {"batched_batch_shard": b0["batch_shard"],
             **{f"batched_x_{c}": b0["x_shard"][c] for c in BATCHED_X_COMMS},
             **{f"batched_{BATCHED_RENDER[1]}_{pid}": b0["renderings"][pid]
                for pid in BATCHED_RENDERINGS}}
    for name, row in rows0.items():
        launches[f"{name}_rank0"] = {
            k: row["launches_forward"][k] + row["launches_inverse"][k]
            for k in row["launches_forward"]}
    for name, v in b0["cli"]["launches"].items():
        launches[f"{name}_rank0"] = v
    for rk in b_ranks:
        emit(phase="batched_ranks", rank=rk["rank"],
             exchange="gloo, host-staged, 2 ranks on 1 card",
             **{k: rk[k] for k in rk if k not in ("rank", "guard")})
    emit(phase="resilience_batched", shard="x", shape=list(BATCHED_RENDER),
         verdict=same_violation([rk["guard"] for rk in b_ranks],
                                "batched enforce under wire:nan"),
         per_rank=[rk["guard"] for rk in b_ranks])
    emit(phase="batched_done", seconds=time.perf_counter() - t0)

    # -- 8e. the Bluestein backend (no kernel: torch.fft's chirp-z) ----------
    t0 = time.perf_counter()
    bluestein_paths(torch, dft, hf, gen)
    emit(phase="bluestein_done", seconds=time.perf_counter() - t0)

    # -- 8f. the solvers: one card, gradients, two ranks ---------------------
    t0 = time.perf_counter()
    got, _ = solvers_phase(torch, dft, hf, multihost, dev, outdir)
    launches.update(got)
    emit(phase="solvers_done", seconds=time.perf_counter() - t0)

    # -- 8g. autotune, wisdom and persistence --------------------------------
    got, _ = wisdom_phase(torch, dft, hf, multihost, dev, outdir)
    launches.update(got)

    # -- 8h. the serving layer and the profile capture -----------------------
    got, _ = serve_phase(torch, dft, hf, multihost, dev, outdir)
    launches.update(got)

    # -- 8i. the serving fleet -----------------------------------------------
    got, _ = fleet_phase(torch, dft, hf, dev, outdir)
    launches.update(got)

    # -- 8j. evaluation and launch --------------------------------------------
    evalkit_phase(torch, outdir, plan_times)

    # -- 8k. static analysis, the stage profile, explain ----------------------
    got, _ = analysis_phase(torch, dft, hf, multihost, dev, outdir)
    launches.update(got)

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
        for f in ("pair_ms", "library_rows_ms", "pass_ms", "alternated"):
            if f in k:
                row[f] = k[f]
        for v in every:
            if v.get("variant") and v["name"] == k["name"]:
                row[v["variant"]] = {
                    f: v[f] for f in ("body", "entry", "shape", "max_abs_err",
                                      "max_rel_err", "library_rel_err",
                                      "kernel_ms", "plain_ms",
                                      "library_ms", "library_call",
                                      "library_rows_ms", "pair_ms", "bound_ms",
                                      "bound_by", "flops", "gemm_flops",
                                      "bytes") if f in v}
                if "entry" in v:
                    row[v["variant"]]["launches"] = MAIN_ENTRIES.get(
                        v["entry"], 0)
        rows.append(row)
    if any(r["launches"] < 1 for r in rows):
        fail(f"a kernel never launched on the main paths: {launches}")
    if any(v["launches"] < 1 for r in rows for v in r.values()
           if isinstance(v, dict) and "entry" in v):
        fail(f"a body never launched on the main paths: {MAIN_ENTRIES}")
    emit(phase="done", seconds=time.perf_counter() - t_start)
    # The matmul backend is no kernel: its numbers stand on a line of their
    # own (every plan of it launched no kernel; its dispatches counted).
    print(json.dumps({"matmul_backend": matmul_rows}))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _children() -> list:
    """The pids whose parent is this process, zombies included."""
    me, out = os.getpid(), []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        # after the parenthesised command come the state, then the parent
        if int(stat.rsplit(")", 1)[1].split()[1]) == me:
            out.append(int(d))
    return out


def _cmdline(pid: int) -> str:
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read().replace(b"\0", b" ").decode(errors="replace")
    except OSError:
        return "?"


def _running(pid: int) -> bool:
    """Whether the child ``pid`` still runs; reaps it if it has ended."""
    try:
        return os.waitpid(pid, os.WNOHANG) == (0, 0)
    except ChildProcessError:
        return False


def stop_children() -> None:
    """Stop every process this run started, and every descendant left
    behind (the script is their subreaper, so orphans come back here):
    multiprocessing's children and its resource tracker first, then
    whatever is still a child of this process, SIGTERM then SIGKILL, each
    reaped. What had to be stopped goes to stderr."""
    import gc
    import multiprocessing
    import signal
    from multiprocessing import resource_tracker
    for p in multiprocessing.active_children():
        p.terminate()
        p.join(10)
    gc.collect()                 # finalize the spawns' queues first
    resource_tracker._resource_tracker._stop()
    for _ in range(5):           # a stopped child's own children come next
        pids = _children()
        if not pids:
            return
        for pid in pids:
            print(f"chip_smoke: stopping leftover process {pid}: "
                  f"{_cmdline(pid)}", file=sys.stderr)
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, signal.SIGTERM)
        deadline = time.monotonic() + 5
        while pids and time.monotonic() < deadline:
            pids = [p for p in pids if _running(p)]
            time.sleep(0.05)
        for pid in pids:
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, signal.SIGKILL)
            with contextlib.suppress(ChildProcessError):
                os.waitpid(pid, 0)
    if _children():
        raise RuntimeError(f"chip_smoke: processes left: {_children()}")


if __name__ == "__main__":
    import ctypes
    # PR_SET_CHILD_SUBREAPER: a descendant whose parent exits becomes this
    # process's child, so stop_children finds it.
    ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0)
    try:
        rc = main()
    finally:
        stop_children()
    sys.exit(rc)
