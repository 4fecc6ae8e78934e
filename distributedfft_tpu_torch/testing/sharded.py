"""Per-rank test inputs, spectral symbols and residuals of the testcases —
the port's counterpart of the JAX package's ``testing/sharded.py``, for
the slab, pencil and batched-2D plans.

The reference generates its validation inputs and residuals on the GPU
(cuRAND, the ``difference`` / ``derivativeCoefficients`` kernels and a
cublas asum, ``tests/src/slab/random_dist_default.cu:40-135, 365-371``).
Here every 3D field is the outer product of three 1D vectors, built on the
plan's device for this rank's block only, so no rank ever holds the global
cube; a residual leaves the device as two scalars, all-reduced over the
ranks (SUM for the abs-sum, MAX for the abs-max).

A plan's block is its share of the padded global array: a slab plan's
input split over x and its spectrum over the split axis; a pencil plan's
blocks split over two axes, its spectrum's at the depth ``dims`` of its
partial transforms; a batched-2D plan's over the batch (``shard="batch"``)
or over x, then spectral y (``shard="x"``), its batch axis never
transformed. Pad lanes carry no data, so the residuals run over the
logical region of the block only.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..models.batched2d import Batched2DFFTPlan
from ..models.pencil import PencilFFTPlan


def _halved_axis(plan) -> int:
    """The R2C-halved axis of the spectrum (none for a c2c plan)."""
    if plan.transform == "c2c":
        return -1
    if isinstance(plan, (PencilFFTPlan, Batched2DFFTPlan)):
        return 2
    return plan._seq.r2c_axis


def _geometry(plan, space: str, dims: int = 3):
    """(padded global shape, logical shape, this rank's slices) of the
    plan's real input or spectral output (a pencil plan's at depth
    ``dims``)."""
    if space == "real":
        return plan.input_padded_shape, plan.input_shape, plan.local_slices()
    if space == "spectral":
        if isinstance(plan, PencilFFTPlan):
            return (plan.output_padded_shape_for(dims), plan.output_shape,
                    plan.local_slices(output=True, dims=dims))
        return (plan.output_padded_shape, plan.output_shape,
                plan.local_slices(output=True))
    raise ValueError(f"space must be 'real' or 'spectral', got {space!r}")


def _outer3(plan, vs: List[np.ndarray], space: str,
            dims: int = 3) -> torch.Tensor:
    """This rank's block of the outer product of three padded 1D vectors,
    computed on the plan's device."""
    sl = _geometry(plan, space, dims)[2]
    v1, v2, v3 = (torch.from_numpy(v[s]).to(plan.device)
                  for v, s in zip(vs, sl))
    return v1[:, None, None] * v2[None, :, None] * v3[None, None, :]


def _sine_vec(n: int, ext: int, dtype) -> np.ndarray:
    """Padded 1D samples of sin(2πj/n) (pad lanes exactly 0)."""
    v = np.zeros(ext, dtype=dtype)
    v[:n] = np.sin(2 * np.pi * np.arange(n) / n)
    return v


def sine_input(plan) -> torch.Tensor:
    """This rank's block of u = sin(2πx/Nx)·sin(2πy/Ny)·sin(2πz/Nz) in the
    plan's padded input layout (pad lanes exactly 0): the testcase-4 field
    (``random_dist_default.cu:640-647``)."""
    g, ps = plan.global_size, plan.input_padded_shape
    rdt = np.float64 if plan.config.double_prec else np.float32
    return _outer3(plan, [_sine_vec(n, ext, rdt)
                          for n, ext in zip(g.shape, ps)], "real")


def sine_spectrum_ref(plan, dims: int = 3) -> torch.Tensor:
    """This rank's block of the analytic, unnormalized spectrum of
    ``sine_input`` in the plan's padded output layout: a transformed axis of
    n points carries ``-i n/2`` at wavenumber 1 and ``+i n/2`` at n-1 (the
    halved R2C axis keeps only bin 1; n <= 2 is identically zero), so the
    truth needs no host FFT and no host memory. A pencil plan's spectrum at
    depth ``dims`` transforms z, then y, then x; an axis it leaves alone
    carries the sine samples themselves."""
    g = plan.global_size
    padded = _geometry(plan, "spectral", dims)[0]
    halved = _halved_axis(plan)
    cdt = np.complex128 if plan.config.double_prec else np.complex64
    if isinstance(plan, PencilFFTPlan):
        transformed = (dims >= 3, dims >= 2, True)
    elif isinstance(plan, Batched2DFFTPlan):
        transformed = (False, True, True)    # the batch keeps its samples
    else:
        transformed = (True,) * 3
    vs = []
    for ax, (n, ext) in enumerate(zip(g.shape, padded)):
        if not transformed[ax]:
            vs.append(_sine_vec(n, ext, cdt))
            continue
        v = np.zeros(ext, dtype=cdt)
        if ax == halved:
            if n > 2:
                v[1] = -0.5j * n
        elif n > 1:
            # += so that at n == 2 bins 1 and n-1 cancel to the true zero.
            v[1] += -0.5j * n
            v[n - 1] += 0.5j * n
        vs.append(v)
    return _outer3(plan, vs, "spectral", dims)


def axis_freqs(n: int, ext: int, halved: bool) -> np.ndarray:
    """The reference kernel's folded integer wavenumber per spectral index
    of one axis (``random_dist_default.cu:80-88``): k = i below n/2, n - i
    above it, 0 at the Nyquist index n/2 (odd n too); 0 in pad lanes."""
    k = np.zeros(ext)
    if halved:
        m = np.arange(n // 2 + 1, dtype=np.float64)
        m[n // 2] = 0.0
        k[: n // 2 + 1] = m
    else:
        i = np.arange(n)
        k[:n] = np.where(i < n // 2, i, np.where(i > n // 2, n - i, 0))
    return k


def laplacian_scale_fn(plan) -> Callable[[torch.Tensor], torch.Tensor]:
    """``c -> c * symbol`` on this rank's spectral block, the symbol the
    reference's Laplacian -(k1²+k2²+k3²)/sqrt(N) (``derivativeCoefficients``,
    ``random_dist_default.cu:71-119``); pad lanes scale to 0. The symbol is
    formed once, on the plan's device."""
    g = plan.global_size
    shape = plan.output_padded_shape
    halved = _halved_axis(plan)
    rdt = torch.float64 if plan.config.double_prec else torch.float32
    sl = plan.local_slices(output=True)
    k1, k2, k3 = (torch.from_numpy(axis_freqs(n, shape[ax], ax == halved)
                                   [sl[ax]]).to(device=plan.device, dtype=rdt)
                  for ax, n in enumerate(g.shape))
    sym = -(k1[:, None, None] ** 2 + k2[None, :, None] ** 2
            + k3[None, None, :] ** 2) * (1.0 / np.sqrt(g.n_total))

    def apply(c: torch.Tensor) -> torch.Tensor:
        return c * sym

    return apply


def residual_fn(plan, space: str = "real", ref_scale: float = 1.0,
                dims: int = 3) -> Callable[[torch.Tensor, torch.Tensor],
                                           Tuple[float, float]]:
    """``(y, ref) -> (abs-sum, abs-max)`` of ``y - ref * ref_scale`` over
    the logical region, as host floats: this rank's block, then an
    ``all_reduce`` (SUM, MAX) over the plan's groups when it has ranks (a
    pencil plan's row group, then its column group).

    ``y`` and ``ref`` are this rank's blocks in the padded ``space`` layout
    ("real": the input, "spectral": the output, a pencil plan's at depth
    ``dims``); their pad lanes are left out. ``ref_scale`` is testcase 3's
    Nx·Ny·Nz or testcase 4's -3·sqrt(N)."""
    padded, logical, sl = _geometry(plan, space, dims)
    keep = []
    for a in range(3):
        lo = sl[a].start or 0
        hi = padded[a] if sl[a].stop is None else sl[a].stop
        keep.append(max(0, min(logical[a] - lo, hi - lo)))

    def f(y: torch.Tensor, ref: torch.Tensor) -> Tuple[float, float]:
        d = (y - ref * ref_scale).abs()
        for a in range(3):
            d = d.narrow(a, 0, keep[a])
        acc = torch.float64 if plan.config.double_prec else torch.float32
        pair = torch.stack([d.sum(dtype=acc), d.amax()]) if d.numel() else \
            torch.zeros(2, dtype=acc, device=d.device)
        if plan.fft3d:
            s, m = pair.tolist()
            return s, m
        groups = _groups(plan)
        red = pair.to(_reduce_device(plan, groups[0]))
        total, top = red[:1].clone(), red[1:].clone()
        for g in groups:
            dist.all_reduce(total, op=dist.ReduceOp.SUM, group=g)
            dist.all_reduce(top, op=dist.ReduceOp.MAX, group=g)
        return float(total), float(top)

    return f


def _groups(plan) -> tuple:
    """The groups a reduction over every rank of the plan runs over."""
    return plan.groups if isinstance(plan, PencilFFTPlan) else (plan.group,)


def _reduce_device(plan, group) -> torch.device:
    """Where a collective's tensor lives: the plan's device under NCCL
    (CUDA tensors only), the CPU under gloo."""
    if dist.get_backend(group) == dist.Backend.NCCL:
        return plan.device
    return torch.device("cpu")


def residuals(plan, y, ref, space: str = "real", ref_scale: float = 1.0,
              dims: int = 3) -> Tuple[float, float]:
    """One ``residual_fn`` call."""
    return residual_fn(plan, space, ref_scale, dims)(y, ref)

