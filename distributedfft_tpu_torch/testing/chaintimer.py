"""Chained-roundtrip timing harness of the port (the JAX package's
``testing/chaintimer.py``; ``testing/autotune.py`` times every race cell
with it).

Method: a chain of ``k`` transforms issued back to back on torch's current
stream and fenced by ONE scalar readback (``.item()``, and
``torch.cuda.synchronize`` on the card). The per-iteration time is the
median over ``repeats`` pairs of (t_K - t_1) divided by k - 1, so the
constant cost of the launch, the readback and the fence cancels. Where
the JAX chains are jitted ``fori_loop``s, these are Python loops of the
same k calls: the numbers mean the same thing. A nonpositive median means
the work was swamped by noise; callers treat it as a degenerate
measurement, not a timing.

Every chain function returns ``run(x)`` giving a 0-d tensor; ``float()``
of it is the fence. ``directional_chain`` and ``stage_chain`` take a seed
(the input is drawn on the device, no host transfer) or an input array
(the same values as another package's draw, for comparisons).
"""

from __future__ import annotations

import time
from typing import Tuple

import numpy as np
import torch

from ..params import FFTNorm

_TINY = 1e-30


def _fence(t) -> float:
    """The scalar readback every timed call ends on."""
    v = float(t)
    if isinstance(t, torch.Tensor) and t.is_cuda:
        torch.cuda.synchronize(t.device)
    return v


def roundtrip_chain(k: int, shape, backend: str, settings=None):
    """``run(x)``: ``k`` R2C + C2R roundtrips of ``x`` (dtype follows the
    input: float32 or float64), each rescaled by 1/N, reduced to
    ``sum |v|``. ``settings`` is a ``mxu_fft.MXUSettings`` threaded into
    every local transform (how the race runs precision variants without
    touching the process defaults). ``backend="matmul-planes"`` runs the
    all-real-planes formulation (``mxu_fft.rfftn_3d_planes``)."""
    from ..ops import fft as lf
    from ..ops import mxu_fft as mx

    shape = tuple(int(s) for s in shape)
    scale = 1.0 / float(np.prod(shape))

    def run(x) -> torch.Tensor:
        v = torch.as_tensor(x)
        with torch.no_grad():
            for _ in range(k):
                if backend == "matmul-planes":
                    with mx.use_settings(settings):
                        cr, ci = mx.rfftn_3d_planes(v)
                        v = mx.irfftn_3d_planes(cr, ci, shape) * scale
                else:
                    # FFTNorm.NONE leaves both directions unnormalized
                    # (cuFFT's convention); rescaling keeps v bounded.
                    c = lf.rfftn_3d(v, norm=FFTNorm.NONE, backend=backend,
                                    settings=settings)
                    v = lf.irfftn_3d(c, shape, norm=FFTNorm.NONE,
                                     backend=backend,
                                     settings=settings) * scale
            return v.abs().sum()

    return run


def _input(seed_or_x, shape, dtype: torch.dtype, device) -> torch.Tensor:
    """The chain's input: uniform [0, 1) drawn on ``device`` from an int
    seed, or the given array as it is (cast to ``dtype``)."""
    if isinstance(seed_or_x, (int, np.integer)):
        g = torch.Generator(device=device).manual_seed(int(seed_or_x))
        return torch.rand(tuple(shape), generator=g, dtype=dtype,
                          device=device)
    if isinstance(seed_or_x, np.ndarray) and not seed_or_x.flags.writeable:
        seed_or_x = seed_or_x.copy()
    return torch.as_tensor(seed_or_x).to(device=device, dtype=dtype)


def _accum_forward_chain(k: int, shape, fwd, dtype, device):
    """The forward chains' body: the scalar accumulator folds into the
    next input as ``+ acc * 1e-30`` (negligible, but a real data
    dependency between the iterations). ``directional_chain`` and
    ``chunked_forward_chain`` share it so they stay comparable."""
    scale = 1.0 / float(np.prod(shape))

    def run(seed_or_x) -> torch.Tensor:
        with torch.no_grad():
            u = _input(seed_or_x, shape, dtype, device)
            acc = torch.zeros((), dtype=dtype, device=device)
            for _ in range(k):
                c = fwd(u + acc * _TINY)
                acc = acc + torch.real(c)[0, 0, 0] * scale
            return acc

    return run


def directional_chain(k: int, shape, backend: str, direction: str,
                      settings=None, dtype=None,
                      device: "str | torch.device" = "cuda"):
    """``run(seed_or_x)``: ``k`` transforms of ONE direction
    (``"forward"``, ``"inverse"`` or ``"roundtrip"``) of a cube drawn on
    the device. The one-way directions chain through a scalar
    accumulator folded into the next input as ``+ acc * 1e-30``; the
    inverse's spectral input is one forward outside the loop, which runs
    once per call and cancels in the pair difference."""
    from ..ops import fft as lf

    if direction not in ("forward", "inverse", "roundtrip"):
        raise ValueError(f"direction must be forward/inverse/roundtrip, "
                         f"got {direction!r}")
    device = torch.device(device)
    rdt = torch.float32 if dtype is None else torch.from_numpy(
        np.zeros(0, dtype=np.dtype(dtype))).dtype
    shape = tuple(int(s) for s in shape)
    scale = 1.0 / float(np.prod(shape))
    kw = dict(norm=FFTNorm.NONE, backend=backend, settings=settings)

    if direction == "forward":
        return _accum_forward_chain(k, shape,
                                    lambda v: lf.rfftn_3d(v, **kw), rdt,
                                    device)

    def run(seed_or_x) -> torch.Tensor:
        with torch.no_grad():
            u = _input(seed_or_x, shape, rdt, device)
            if direction == "inverse":
                c0 = lf.rfftn_3d(u, **kw)
                acc = torch.zeros((), dtype=rdt, device=device)
                for _ in range(k):
                    y = lf.irfftn_3d(c0 + acc * _TINY, shape, **kw)
                    acc = acc + y[0, 0, 0] * scale
                return acc
            v = u
            for _ in range(k):
                v = lf.irfftn_3d(lf.rfftn_3d(v, **kw), shape, **kw) * scale
            return v.abs().sum()

    return run


def chunked_forward_chain(k: int, n: int, chunk: int = 8,
                          backend: str = "matmul",
                          device: "str | torch.device" = "cuda"):
    """Forward chain of a single-device plan whose z and y stages run in
    ``chunk`` slices of x (``Config.fft3d_chunk``), bounding the live
    intermediates of an n³ cube; the chaining of ``directional_chain``."""
    from ..models.slab import SlabFFTPlan
    from ..params import Config, GlobalSize, SlabPartition

    plan = SlabFFTPlan(GlobalSize(n, n, n), SlabPartition(1),
                       Config(fft_backend=backend, fft3d_chunk=chunk,
                              use_wisdom=False), device=device)
    return _accum_forward_chain(k, (n, n, n), plan.forward_fn(),
                                torch.float32, plan.device)


STAGES = ("rfft_z", "fft_y", "fft_x", "ifft_x", "ifft_y", "irfft_z")


def stage_chain(k: int, shape, backend: str, stage: str, settings=None,
                device: "str | torch.device" = "cuda"):
    """``run(seed_or_x)``: ``k`` transforms of ONE axis, one stage of the
    3D R2C/C2R pipeline on the shapes the whole pipeline gives it.
    ``rfft_z`` runs on a real cube; the complex stages and ``irfft_z`` on
    the halved cube from one forward z transform outside the loop (which
    cancels in the pair difference). Chained like ``directional_chain``."""
    from ..ops import fft as lf

    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
    device = torch.device(device)
    shape = tuple(int(s) for s in shape)
    nz = shape[-1]
    scale = 1.0 / float(np.prod(shape))
    kw = dict(backend=backend, settings=settings)
    f32 = torch.float32

    def run(seed_or_x) -> torch.Tensor:
        with torch.no_grad():
            u = _input(seed_or_x, shape, f32, device)
            acc = torch.zeros((), dtype=f32, device=device)
            if stage == "rfft_z":
                for _ in range(k):
                    c = lf.rfft(u + acc * _TINY, axis=-1, **kw)
                    acc = acc + torch.real(c)[0, 0, 0] * scale
                return acc
            c0 = lf.rfft(u, axis=-1, **kw)
            if stage == "irfft_z":
                for _ in range(k):
                    y = lf.irfft(c0 + acc * _TINY, n=nz, axis=-1, **kw)
                    acc = acc + y[0, 0, 0] * scale
                return acc
            axis = -2 if stage in ("fft_y", "ifft_y") else -3
            op = lf.fft if stage.startswith("fft") else lf.ifft
            for _ in range(k):
                y = op(c0 + acc * _TINY, axis=axis, **kw)
                acc = acc + torch.real(y)[0, 0, 0] * scale
            return acc

    return run


def timed_best(fn, x, inner: int) -> float:
    """Best of ``inner`` wall-clock seconds of one fenced call."""
    best = float("inf")
    for _ in range(inner):
        t0 = time.perf_counter()
        _fence(fn(x))
        best = min(best, time.perf_counter() - t0)
    return best


def median_pair_diff_ms(fn1, fnK, x, k: int, repeats: int,
                        inner: int) -> Tuple[float, float]:
    """(per-iteration ms from the median (t_K - t_1) pair, the last t_1 in
    seconds). Callers warm both functions first (the first "pallas" call
    may build the kernels, the first "xla" call a cuFFT plan)."""
    if k < 2:
        raise ValueError(f"k must be >= 2 (got {k})")
    pairs = [(timed_best(fnK, x, inner), timed_best(fn1, x, inner))
             for _ in range(repeats)]
    diffs = sorted(tk - t1 for tk, t1 in pairs)
    per_ms = diffs[len(diffs) // 2] / (k - 1) * 1e3
    return per_ms, pairs[-1][1]
