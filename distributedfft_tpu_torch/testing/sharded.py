"""Per-rank test inputs, spectral symbols and residuals of the testcases —
the port's counterpart of the JAX package's ``testing/sharded.py``, for
the slab plan.

The reference generates its validation inputs and residuals on the GPU
(cuRAND, the ``difference`` / ``derivativeCoefficients`` kernels and a
cublas asum, ``tests/src/slab/random_dist_default.cu:40-135, 365-371``).
Here every 3D field is the outer product of three 1D vectors, built on the
plan's device for this rank's block only, so no rank ever holds the global
cube; a residual leaves the device as two scalars, all-reduced over the
ranks (SUM for the abs-sum, MAX for the abs-max).

A plan's block is its share of the padded global array: the input split
over x, the spectrum over the split axis. Pad lanes carry no data, so the
residuals run over the logical region of the block only.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch
import torch.distributed as dist


def _halved_axis(plan) -> int:
    """The R2C-halved axis of the spectrum (none for a c2c plan)."""
    if plan.transform == "c2c":
        return -1
    return plan._seq.r2c_axis


def _geometry(plan, space: str):
    """(padded global shape, logical shape, decomposed axis, this rank's
    slices) of the plan's real input or spectral output."""
    if space == "real":
        return (plan.input_padded_shape, plan.input_shape, 0,
                plan.local_slices())
    if space == "spectral":
        return (plan.output_padded_shape, plan.output_shape,
                plan._seq.split_axis, plan.local_slices(output=True))
    raise ValueError(f"space must be 'real' or 'spectral', got {space!r}")


def _outer3(plan, vs: List[np.ndarray], space: str) -> torch.Tensor:
    """This rank's block of the outer product of three padded 1D vectors,
    computed on the plan's device."""
    sl = _geometry(plan, space)[3]
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


def sine_spectrum_ref(plan) -> torch.Tensor:
    """This rank's block of the analytic, unnormalized spectrum of
    ``sine_input`` in the plan's padded output layout: a transformed axis of
    n points carries ``-i n/2`` at wavenumber 1 and ``+i n/2`` at n-1 (the
    halved R2C axis keeps only bin 1; n <= 2 is identically zero), so the
    truth needs no host FFT and no host memory."""
    g = plan.global_size
    padded = plan.output_padded_shape
    halved = _halved_axis(plan)
    cdt = np.complex128 if plan.config.double_prec else np.complex64
    vs = []
    for ax, (n, ext) in enumerate(zip(g.shape, padded)):
        v = np.zeros(ext, dtype=cdt)
        if ax == halved:
            if n > 2:
                v[1] = -0.5j * n
        elif n > 1:
            # += so that at n == 2 bins 1 and n-1 cancel to the true zero.
            v[1] += -0.5j * n
            v[n - 1] += 0.5j * n
        vs.append(v)
    return _outer3(plan, vs, "spectral")


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


def residual_fn(plan, space: str = "real", ref_scale: float = 1.0
                ) -> Callable[[torch.Tensor, torch.Tensor],
                              Tuple[float, float]]:
    """``(y, ref) -> (abs-sum, abs-max)`` of ``y - ref * ref_scale`` over
    the logical region, as host floats: this rank's block, then an
    ``all_reduce`` (SUM, MAX) over the plan's group when it has ranks.

    ``y`` and ``ref`` are this rank's blocks in the padded ``space`` layout
    ("real": the input, "spectral": the output); their pad lanes are left
    out. ``ref_scale`` is testcase 3's Nx·Ny·Nz or testcase 4's
    -3·sqrt(N)."""
    padded, logical, axis, sl = _geometry(plan, space)
    lo = sl[axis].start or 0
    keep = max(0, min(logical[axis] - lo, padded[axis] // plan.partition.p))

    def f(y: torch.Tensor, ref: torch.Tensor) -> Tuple[float, float]:
        d = (y - ref * ref_scale).abs()
        d = d.narrow(axis, 0, keep)
        for a in range(3):
            if a != axis:
                d = d.narrow(a, 0, logical[a])
        acc = torch.float64 if plan.config.double_prec else torch.float32
        pair = torch.stack([d.sum(dtype=acc), d.amax()]) if d.numel() else \
            torch.zeros(2, dtype=acc, device=d.device)
        if plan.fft3d:
            s, m = pair.tolist()
            return s, m
        red = pair.to(_reduce_device(plan))
        total, top = red[:1].clone(), red[1:].clone()
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=plan.group)
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=plan.group)
        return float(total), float(top)

    return f


def _reduce_device(plan) -> torch.device:
    """Where a collective's tensor lives: the plan's device under NCCL
    (CUDA tensors only), the CPU under gloo."""
    if dist.get_backend(plan.group) == dist.Backend.NCCL:
        return plan.device
    return torch.device("cpu")


def residuals(plan, y, ref, space: str = "real",
              ref_scale: float = 1.0) -> Tuple[float, float]:
    """One ``residual_fn`` call."""
    return residual_fn(plan, space, ref_scale)(y, ref)

