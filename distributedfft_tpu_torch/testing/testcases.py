"""The reference's five testcases as library functions, for the slab plan —
the port's counterpart of the JAX package's ``testing/testcases.py``.

Semantics of the reference (``tests/src/slab/random_dist_default.cu``):

* 0 — perf: random input, loop the forward transform. No check.
* 1 — distributed vs reference: a single-host full 3D transform is the
  ground truth (the reference's coordinator rank,
  ``random_dist_default.cu:227-459``); prints ``Result <sum|diff|>``, the
  asum residual. ``truth="analytic"`` takes the sine field and its
  closed-form spectrum instead, built per rank on the device, so the check
  needs no host cube.
* 2 — perf of the inverse on random spectral input.
* 3 — round trip: forward then inverse vs input * Nx*Ny*Nz (cuFFT's
  unnormalized transforms); prints ``Result (avg)`` / ``Result (max)``.
* 4 — analytic Laplacian: u = sin(2πx/Nx)sin(2πy/Ny)sin(2πz/Nz); forward,
  times -(k1²+k2²+k3²)/sqrt(N), inverse; compared with the closed form
  -3·sqrt(N)·u (``random_dist_default.cu:626-758``).

Each rank runs the testcase on its own block (a rank is one process of the
``torch.distributed`` world); random inputs are drawn over the global
shape from one seed, the same on every rank, and each rank keeps its
block. Phase times go through the reference-schema ``Timer``: the stages
of ``forward_stages`` / ``inverse_stages`` with a fence after each, then
one call of the plan's own ``exec_*`` marked "Run complete (fused)".
Warm-up iterations are not gathered. Only rank 0 prints.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import numpy as np
import torch

from .. import params as pm
from ..models.slab import SlabFFTPlan
from ..ops.fft import dtypes_for
from ..parallel import multihost
from ..utils.timer import Timer, benchmark_filename
from . import sharded

FUSED_DESC = "Run complete (fused)"

_KINDS_ITEM = {"pencil": "ROADMAP Queue 1, item 5 (the pencil plan)",
               "batched2d": "ROADMAP Queue 1, item 6 (the batched-2D plan)"}


def say(msg: str) -> None:
    """Print on rank 0 only."""
    if multihost.world()[0] == 0:
        print(msg, flush=True)


def make_plan(kind: str, global_size: pm.GlobalSize, partition, config,
              sequence=None, device: "str | torch.device" = "cuda"):
    """The plan a testcase runs; the slab plan only in this port."""
    if kind == "slab":
        return SlabFFTPlan(global_size, partition, config, device=device,
                           sequence=sequence or pm.SlabSequence.ZY_THEN_X)
    if kind in _KINDS_ITEM:
        raise NotImplementedError(
            f"the {kind} plan is not ported yet ({_KINDS_ITEM[kind]})")
    raise ValueError(f"unknown plan kind {kind!r}")


def make_timer(plan, write_csv: bool = True) -> Timer:
    cfg = plan.config
    filename = None
    if write_csv:
        filename = benchmark_filename(cfg.benchmark_dir, plan.variant_name,
                                      cfg, plan.global_size,
                                      plan.partition.num_ranks)
    rank, world = multihost.world()
    return Timer(plan.section_descriptions, plan.partition.num_ranks, filename,
                 process_index=rank, num_processes=world, device=plan.device)


# Draws per chunk of the random inputs. Chunks are filled in parallel, each
# from a copy of the generator advanced to the chunk's first draw, so the
# values are those of one sequential ``rng.random(shape)`` call.
_CHUNK = 1 << 24


def _uniform(rng: np.random.Generator, shape, dtype) -> np.ndarray:
    """``rng.random(shape).astype(dtype)``, the same values: one 64-bit draw
    a value, chunk c drawn by a copy of the bit generator advanced by c's
    offset, cast into the output as it is drawn (no float64 copy of the
    whole array). ``rng`` ends advanced past every draw, as after the
    one-shot call."""
    out = np.empty(shape, dtype=dtype)
    flat = out.reshape(-1)
    bits = rng.bit_generator

    def fill(start: int) -> None:
        mine = type(bits)()
        mine.state = bits.state
        mine.advance(start)
        flat[start:start + _CHUNK] = np.random.Generator(mine).random(
            min(_CHUNK, flat.size - start))

    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        list(pool.map(fill, range(0, flat.size, _CHUNK)))
    bits.advance(flat.size)
    return out


def random_real_input(plan, seed: int = 0) -> np.ndarray:
    """Uniform random input over the global shape, as the reference's cuRAND
    generation (``tests/include/tests_base.hpp:30-43``), in the plan's
    precision: float64 draws from ``default_rng(seed)``, then cast."""
    rdt = np.float64 if plan.config.double_prec else np.float32
    return _uniform(np.random.default_rng(seed), plan.input_shape, rdt)


def random_spectral_input(plan, seed: int = 0) -> torch.Tensor:
    """This rank's block of a uniform random spectrum (real part, then
    imaginary part, each over the global spectral shape from
    ``default_rng(seed)``), on the plan's device."""
    rdt = np.float64 if plan.config.double_prec else np.float32
    rng = np.random.default_rng(seed)
    re = torch.from_numpy(_uniform(rng, plan.output_shape, rdt))
    im = torch.from_numpy(_uniform(rng, plan.output_shape, rdt))
    return plan.pad_spectral(torch.complex(re, im))


def reference_spectrum(plan, x: np.ndarray) -> np.ndarray:
    """Single-host ground truth in the plan's own spectral layout."""
    if plan.sequence is pm.SlabSequence.Y_THEN_ZX:
        r = np.fft.rfft(x, axis=1)
        r = np.fft.fft(r, axis=2)
        return np.fft.fft(r, axis=0)
    return np.fft.fft(np.fft.fft(np.fft.rfft(x, axis=2), axis=1), axis=0)


def _whole_fns(plan):
    """(forward, inverse) of the plan's own ``exec_*``."""
    return plan._whole(True), plan._whole(False)


def _run_staged(plan, stages, timer: Timer, x, warmup: int, iterations: int,
                run_desc: str = "Run complete", fused_fn=None):
    """Timed loop over the stages; CSV blocks are gathered after the
    warm-ups. Returns (last output, per-iteration "Run complete" ms, fused
    ms). With ``fused_fn`` each iteration also runs it once and stores its
    mark under ``FUSED_DESC``, so the fused time is that mark minus "Run
    complete"."""
    out = None
    times, fused_times = [], []
    for it in range(warmup + iterations):
        timer.start()
        y = x
        for desc, fn in stages:
            y = fn(y)
            if desc is not None:
                timer.stop_store(desc)
        ms = timer.stop_store(run_desc)
        fused_ms = None
        if fused_fn is not None:
            fused_fn(x)
            fused_ms = timer.stop_store(FUSED_DESC) - ms
        if it >= warmup:
            times.append(ms)
            if fused_ms is not None:
                fused_times.append(fused_ms)
            timer.gather()
        out = y
    return out, times, fused_times


def _perf(times, fused) -> Dict:
    return {"times_ms": times, "mean_ms": float(np.mean(times)),
            "fused_times_ms": fused, "fused_mean_ms": float(np.mean(fused))}


def testcase0(plan, iterations: int = 1, warmup: int = 0, seed: int = 0,
              write_csv: bool = True) -> Dict:
    """Forward perf (reference testcase 0)."""
    x = plan.pad_input(random_real_input(plan, seed))
    timer = make_timer(plan, write_csv)
    fwd, _ = _whole_fns(plan)
    _, times, fused = _run_staged(plan, plan.forward_stages(), timer, x,
                                  warmup, iterations, fused_fn=fwd)
    return _perf(times, fused)


def testcase1(plan, seed: int = 0, write_csv: bool = True,
              truth: str = "host") -> Dict:
    """Distributed vs reference spectrum (testcase 1); prints the asum
    residual as ``Result <sum>``.

    ``truth="host"``: dense random input, the truth a full ``np.fft`` in
    float64 on the host (bounded by host memory). ``truth="analytic"``: the
    sine field and its closed-form spectrum, both built per rank on the
    device, so any size runs. Either way the residual is reduced on the
    device and leaves it as a scalar."""
    if truth not in ("host", "analytic"):
        raise ValueError(f"truth must be 'host' or 'analytic', got {truth!r}")
    timer = make_timer(plan, write_csv)
    if truth == "analytic":
        x = sharded.sine_input(plan)
        refdev = sharded.sine_spectrum_ref(plan)
    else:
        _, cdt = dtypes_for(plan.config.double_prec)
        xh = random_real_input(plan, seed)
        x = plan.pad_input(xh)
        ref = reference_spectrum(plan, xh.astype(np.float64))
        refdev = plan.pad_spectral(torch.from_numpy(ref).to(cdt))
    out, _, _ = _run_staged(plan, plan.forward_stages(), timer, x, 0, 1)
    resid, _ = sharded.residuals(plan, out, refdev, "spectral")
    say(f"Result {resid}")
    return {"residual_sum": resid}


def testcase2(plan, iterations: int = 1, warmup: int = 0, seed: int = 0,
              write_csv: bool = True) -> Dict:
    """Inverse perf on random spectral input (testcase 2)."""
    c = random_spectral_input(plan, seed)
    timer = make_timer(plan, write_csv)
    _, inv = _whole_fns(plan)
    _, times, fused = _run_staged(plan, plan.inverse_stages(), timer, c,
                                  warmup, iterations, fused_fn=inv)
    return _perf(times, fused)


def _roundtrip_loop(plan, timer: Timer, x, rfn, warmup: int, iterations: int,
                    scale=None) -> Dict:
    """Testcases 3 and 4: forward, ``scale`` (testcase 4's symbol), inverse,
    timed as "Run complete", then the fused pair; the residual of every
    iteration against the input, printed after the last."""
    g = plan.global_size
    fwd, inv = plan.forward_stages(), plan.inverse_stages()
    ffwd, finv = _whole_fns(plan)
    scale = scale or (lambda c: c)
    avg = mx = 0.0
    fused_times = []
    for it in range(warmup + iterations):
        timer.start()
        y = x
        for _, fn in fwd:
            y = fn(y)
        y = scale(y)
        for _, fn in inv:
            y = fn(y)
        ms = timer.stop_store("Run complete")
        finv(scale(ffwd(x)))
        fused_ms = timer.stop_store(FUSED_DESC) - ms
        if it >= warmup:
            fused_times.append(fused_ms)
            timer.gather()
        s, m = rfn(y, x)
        avg, mx = s / g.n_total, m
    say(f"Result (avg): {avg}")
    say(f"Result (max): {mx}")
    return {"avg_error": avg, "max_error": mx,
            "fused_mean_ms": float(np.mean(fused_times))}


def _roundtrip_scale(plan) -> float:
    if plan.config.norm is not pm.FFTNorm.NONE:
        return 1.0
    return float(plan.global_size.n_total)


def testcase3(plan, iterations: int = 1, warmup: int = 0, seed: int = 0,
              write_csv: bool = True) -> Dict:
    """Round trip forward + inverse vs the scaled input (testcase 3, the
    reference's ``differenceInv`` and all-reduce of avg and max,
    ``random_dist_default.cu:529-623``)."""
    x = plan.pad_input(random_real_input(plan, seed))
    timer = make_timer(plan, write_csv)
    rfn = sharded.residual_fn(plan, "real", ref_scale=_roundtrip_scale(plan))
    return _roundtrip_loop(plan, timer, x, rfn, warmup, iterations)


def testcase4(plan, iterations: int = 1, warmup: int = 0,
              write_csv: bool = True) -> Dict:
    """Analytic Laplacian (testcase 4). The wavenumbers are the reference's
    ``derivativeCoefficients`` (``random_dist_default.cu:71-119``): integer
    frequencies folded to [-N/2, N/2), Nyquist zeroed, scaled by
    -1/sqrt(N); the result is held against -3·sqrt(N)·u."""
    g = plan.global_size
    x = sharded.sine_input(plan)
    timer = make_timer(plan, write_csv)
    rfn = sharded.residual_fn(plan, "real",
                              ref_scale=-3.0 * float(np.sqrt(g.n_total)))
    return _roundtrip_loop(plan, timer, x, rfn, warmup, iterations,
                           scale=sharded.laplacian_scale_fn(plan))
