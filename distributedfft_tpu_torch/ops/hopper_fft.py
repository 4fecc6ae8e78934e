"""Hand-written Hopper kernels of the fused single-device 3D FFT path.

The counterpart of the fused-3D section of the JAX package's
``ops/pallas_fft.py``. At direct sizes (every axis in [2, 512]) a 3D R2C
is two kernel passes and its C2R inverse two more:

* forward: ``zy_fwd`` (z-R2C then y-C2C per x-row, intermediate on chip),
  then ``x_c2c`` (C2C along x);
* inverse: ``x_c2c`` (inverse C2C along x), then ``yz_inv`` (y-C2C
  inverse then the half-spectrum z-C2R per x-row).

Complex data crosses the kernels as split float32 (real, imag) planes.
Each kernel (``csrc/fused3d.cu``) has here:

* a wrapper, which checks device, dtype, shape and contiguity, allocates
  the outputs with ``torch.empty`` and launches on the current stream;
* its plain PyTorch version (``*_plain``), the same arithmetic as dense
  products. The wrapper takes it only for tensors on the CPU; for a CUDA
  tensor it launches the kernel or raises;
* a launch count in ``LAUNCHES``, raised by one per kernel launch.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from ..params import FFTNorm
from . import _build
from . import mxu_fft as mx

# Kernel launches since the last ``reset_launches()``.
LAUNCHES: Dict[str, int] = {"zy_fwd": 0, "x_c2c": 0, "yz_inv": 0}

# Entry points of csrc/fused3d.cu: (pointer arguments, int arguments).
_SIGNATURES = {"dfft_zy_fwd": (7, 3), "dfft_x_c2c": (6, 2),
               "dfft_yz_inv": (7, 3)}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def fused3d_applicable(shape3, dtype) -> bool:
    """The fused path takes 3D single-precision data whose axes all take
    one direct DFT matmul (``pallas_fft.fused3d_applicable``)."""
    return (not mx._is_double(dtype) and len(shape3) == 3
            and all(2 <= n <= mx.DIRECT_MAX for n in shape3))


# ---------------------------------------------------------------------------
# Constants: float32 planes of the reference's numpy DFT matrices, cached
# per device.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _planes(kind: str, n: int, inverse: bool,
            device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    if kind == "dft":
        m = mx._dft_np(n, inverse, False)
    elif kind == "rdft":  # (n, n//2+1) R2C columns
        m = mx._dft_np(n, False, False)[:, :n // 2 + 1]
    else:  # "c2r": (n//2+1, n) half-spectrum inverse, already real planes
        cr, ci = mx._c2r_np(n, False)
        return (torch.from_numpy(cr).to(device), torch.from_numpy(ci).to(device))
    return (torch.from_numpy(np.ascontiguousarray(m.real)).to(device),
            torch.from_numpy(np.ascontiguousarray(m.imag)).to(device))


# ---------------------------------------------------------------------------
# Plain versions (the kernels' arithmetic as dense float32 products)
# ---------------------------------------------------------------------------


def zy_fwd_plain(x, fzr, fzi, fyr, fyi):
    cr, ci = x @ fzr, x @ fzi                      # (X, Y, Zo)
    return fyr @ cr - fyi @ ci, fyr @ ci + fyi @ cr


def x_c2c_plain(ar, ai, fr, fi):
    X = ar.shape[0]
    a_r, a_i = ar.reshape(X, -1), ai.reshape(X, -1)
    zr = fr @ a_r - fi @ a_i
    zi = fr @ a_i + fi @ a_r
    return zr.reshape(ar.shape), zi.reshape(ai.shape)


def yz_inv_plain(er, ei, fyr, fyi, cr, ci):
    e_r = fyr @ er - fyi @ ei                      # (X, Y, Zo)
    e_i = fyr @ ei + fyi @ er
    return e_r @ cr - e_i @ ci


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check(name: str, *ts: torch.Tensor) -> bool:
    """Validate kernel operands; True when they lie on the CPU (plain
    version), False on CUDA (kernel). Anything else raises."""
    dev = ts[0].device
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32 planes, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {dev}")
    if not fused3d_applicable(ts[0].shape, ts[0].dtype):
        raise ValueError(f"{name}: shape {tuple(ts[0].shape)} is outside the "
                         f"fused path (3D, every axis in [2, {mx.DIRECT_MAX}])")
    return dev.type == "cpu"


def _launch(fn: str, *args) -> None:
    """Call one entry point of csrc/fused3d.cu on the current stream:
    tensors go as data pointers, ints as ints."""
    lib = _build.load("fused3d", _SIGNATURES)
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    stream = torch.cuda.current_stream().cuda_stream
    _build.check(lib, fn, getattr(lib, fn)(*conv, stream))


def zy_fwd(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(X, Y, Z) float32 -> (X, Y, Z//2+1) planes: z-R2C then y-C2C,
    unnormalized forward (kernel 6, ``_zy_fwd_kernel``)."""
    cpu = _check("zy_fwd", x)
    X, Y, Z = x.shape
    fzr, fzi = _planes("rdft", Z, False, x.device)
    fyr, fyi = _planes("dft", Y, False, x.device)
    if cpu:
        return zy_fwd_plain(x, fzr, fzi, fyr, fyi)
    Zo = Z // 2 + 1
    yr = torch.empty((X, Y, Zo), dtype=torch.float32, device=x.device)
    yi = torch.empty_like(yr)
    _launch("dfft_zy_fwd", x, fzr, fzi, fyr, fyi, yr, yi, X, Y, Z)
    LAUNCHES["zy_fwd"] += 1
    return yr, yi


def x_c2c(ar: torch.Tensor, ai: torch.Tensor,
          inverse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """C2C along axis 0 of (X, Ky, Zo) planes, unnormalized (kernel 7,
    ``_x_c2c_kernel``; forward pass 2 and inverse pass 1)."""
    cpu = _check("x_c2c", ar, ai)
    if ar.shape != ai.shape:
        raise ValueError(f"x_c2c: plane shapes {tuple(ar.shape)} and "
                         f"{tuple(ai.shape)} differ")
    X = ar.shape[0]
    fr, fi = _planes("dft", X, inverse, ar.device)
    if cpu:
        return x_c2c_plain(ar, ai, fr, fi)
    zr, zi = torch.empty_like(ar), torch.empty_like(ai)
    _launch("dfft_x_c2c", ar, ai, fr, fi, zr, zi, X, ar[0].numel())
    LAUNCHES["x_c2c"] += 1
    return zr, zi


def yz_inv(er: torch.Tensor, ei: torch.Tensor, z: int) -> torch.Tensor:
    """(X, Y, z//2+1) planes -> (X, Y, z) float32: y-C2C inverse then the
    half-spectrum z-C2R, unnormalized (kernel 8, ``_yz_inv_kernel``)."""
    X, Y, Zo = er.shape
    if Zo != z // 2 + 1 or er.shape != ei.shape:
        raise ValueError(f"yz_inv: planes {tuple(er.shape)}, "
                         f"{tuple(ei.shape)} do not fit z = {z}")
    cpu = _check("yz_inv", er, ei)
    if not 2 <= z <= mx.DIRECT_MAX:
        raise ValueError(f"yz_inv: z = {z} outside [2, {mx.DIRECT_MAX}]")
    fyr, fyi = _planes("dft", Y, True, er.device)
    cr, ci = _planes("c2r", z, False, er.device)
    if cpu:
        return yz_inv_plain(er, ei, fyr, fyi, cr, ci)
    y = torch.empty((X, Y, z), dtype=torch.float32, device=er.device)
    _launch("dfft_yz_inv", er, ei, fyr, fyi, cr, ci, y, X, Y, z)
    LAUNCHES["yz_inv"] += 1
    return y


# ---------------------------------------------------------------------------
# The fused 3D transforms (``pallas_fft._rfftn3d_fused`` /
# ``_irfftn3d_fused`` and their normalized public forms)
# ---------------------------------------------------------------------------


def rfftn3d_fused(x: torch.Tensor) -> torch.Tensor:
    """(X, Y, Z) float32 -> (X, Y, Z//2+1) complex64, unnormalized."""
    yr, yi = zy_fwd(x.contiguous())
    zr, zi = x_c2c(yr, yi, inverse=False)
    return torch.complex(zr, zi)


def irfftn3d_fused(c: torch.Tensor, shape_3d) -> torch.Tensor:
    """(X, Y, Z//2+1)-croppable complex -> (X, Y, Z) float32, unnormalized."""
    X, Y, Z = shape_3d
    c = c.to(torch.complex64)
    for ax, n in ((-3, X), (-2, Y), (-1, Z // 2 + 1)):
        c = mx._fit_axis(c, ax, n)
    er, ei = x_c2c(c.real.contiguous(), c.imag.contiguous(), inverse=True)
    return yz_inv(er, ei, Z)


def _require_fused(shape3, dtype) -> None:
    if not fused3d_applicable(shape3, dtype):
        raise NotImplementedError(
            f"the hand-written kernels cover 3D single-precision transforms "
            f"with every axis in [2, {mx.DIRECT_MAX}] (got shape "
            f"{tuple(shape3)}, {dtype}); the per-axis kernels for the rest "
            f"are the next slice of the port (ROADMAP Queue 1, item 2)")


def rfftn_3d(x: torch.Tensor, norm: FFTNorm = FFTNorm.NONE) -> torch.Tensor:
    _require_fused(x.shape, x.dtype)
    s = 1.0
    for n in x.shape:
        s *= mx._fwd_scale(n, norm)
    return mx._scaled(rfftn3d_fused(x.to(torch.float32)), s)


def irfftn_3d(x: torch.Tensor, shape_3d: Tuple[int, int, int],
              norm: FFTNorm = FFTNorm.NONE) -> torch.Tensor:
    _require_fused(tuple(shape_3d) if x.ndim == 3 else x.shape, x.dtype)
    s = 1.0
    for n in shape_3d:
        s *= mx._inv_scale(n, norm)
    return mx._scaled(irfftn3d_fused(x, tuple(shape_3d)), s)
