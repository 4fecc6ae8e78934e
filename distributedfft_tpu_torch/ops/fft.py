"""Local (per-device) FFT layer of the port — the analog of the reference's
cuFFT shim (``include/cufft.hpp:23-61``).

Every entry point takes ``backend`` (the ``Config.fft_backend`` strings of
the JAX package):

* ``"xla"`` runs ``torch.fft`` — cuFFT on the card — with the cuFFT
  "unnormalized both ways" convention mapped through ``FFTNorm``;
* ``"pallas"`` runs the hand-written Hopper kernels (``ops/hopper_fft.py``):
  the fused 3D kernels for single-device cubes at direct sizes, the
  per-axis stage kernels everywhere else. Double precision and prime axes
  above 1024 raise ``NotImplementedError`` (the JAX package runs them on
  its matmul backend, not ported yet);
* ``"matmul"``, ``"matmul-r2"`` and ``"bluestein"`` are not ported yet and
  raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..params import FFTNorm
from . import hopper_fft

BACKENDS = ("xla", "matmul", "matmul-r2", "pallas", "bluestein")

# Where in ROADMAP.md each backend that is not ported yet is scheduled.
_NOT_PORTED = {
    "matmul": "ROADMAP Queue 1, item 3 (the mxu_fft matmul backend)",
    "matmul-r2": "ROADMAP Queue 1, item 3 (the mxu_fft matmul backend)",
    "bluestein": "ROADMAP Queue 1, item 8 (arbitrary sizes)",
}


def validate_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"unknown fft backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    return backend


def _pallas(backend: str, what: str) -> bool:
    """True for "pallas", False for "xla"; raise for a backend that is not
    ported yet (``what`` names the call)."""
    if validate_backend(backend) in ("xla", "pallas"):
        return backend == "pallas"
    raise NotImplementedError(
        f"{what} with fft_backend={backend!r} is not ported yet: "
        f"{_NOT_PORTED[backend]}")


def dtypes_for(double_prec: bool) -> Tuple[torch.dtype, torch.dtype]:
    """(real, complex) dtypes of a plan."""
    if double_prec:
        return torch.float64, torch.complex128
    return torch.float32, torch.complex64


def _fwd_norm(norm: FFTNorm) -> str:
    # cuFFT forward is unnormalized == numpy "backward" forward.
    return "ortho" if norm is FFTNorm.ORTHO else "backward"


def _inv_norm(norm: FFTNorm) -> str:
    # cuFFT inverse is also unnormalized; norm="forward" puts the full 1/N
    # on the forward side, making the inverse unnormalized.
    if norm is FFTNorm.NONE:
        return "forward"
    if norm is FFTNorm.ORTHO:
        return "ortho"
    return "backward"


def rfft(x, axis: int, norm: FFTNorm = FFTNorm.NONE, backend: str = "xla"):
    """Forward R2C along one axis (cuFFT ``execR2C`` analog, 1D case)."""
    if _pallas(backend, "rfft"):
        return hopper_fft.rfft(x, axis=axis, norm=norm)
    return torch.fft.rfft(x, dim=axis, norm=_fwd_norm(norm))


def irfft(x, n: int, axis: int, norm: FFTNorm = FFTNorm.NONE,
          backend: str = "xla"):
    """Inverse C2R along one axis; ``n`` is the real output extent."""
    if _pallas(backend, "irfft"):
        return hopper_fft.irfft(x, n=n, axis=axis, norm=norm)
    return torch.fft.irfft(x, n=n, dim=axis, norm=_inv_norm(norm))


def fft(x, axis: int, norm: FFTNorm = FFTNorm.NONE, backend: str = "xla"):
    """Forward C2C along one axis (cuFFT ``execC2C(..., CUFFT_FORWARD)``)."""
    if _pallas(backend, "fft"):
        return hopper_fft.fft(x, axis=axis, norm=norm)
    return torch.fft.fft(x, dim=axis, norm=_fwd_norm(norm))


def ifft(x, axis: int, norm: FFTNorm = FFTNorm.NONE, backend: str = "xla"):
    """Inverse C2C along one axis (cuFFT ``execC2C(..., CUFFT_INVERSE)``)."""
    if _pallas(backend, "ifft"):
        return hopper_fft.ifft(x, axis=axis, norm=norm)
    return torch.fft.ifft(x, dim=axis, norm=_inv_norm(norm))


def fftn(x, axes: Sequence[int], norm: FFTNorm = FFTNorm.NONE,
         backend: str = "xla"):
    if _pallas(backend, "fftn"):
        return hopper_fft.fftn(x, axes, norm=norm)
    return torch.fft.fftn(x, dim=tuple(axes), norm=_fwd_norm(norm))


def ifftn(x, axes: Sequence[int], norm: FFTNorm = FFTNorm.NONE,
          backend: str = "xla"):
    if _pallas(backend, "ifftn"):
        return hopper_fft.ifftn(x, axes, norm=norm)
    return torch.fft.ifftn(x, dim=tuple(axes), norm=_inv_norm(norm))


def rfftn_3d(x, norm: FFTNorm = FFTNorm.NONE, backend: str = "xla"):
    """Single-device full 3D R2C over the trailing three axes — the analog
    of the reference's ``cufftMakePlan3d`` single-process fallback
    (``src/mpicufft.cpp:65``). The halved axis is z (the last)."""
    if _pallas(backend, "rfftn_3d"):
        return hopper_fft.rfftn_3d(x, norm=norm)
    return torch.fft.rfftn(x, dim=(-3, -2, -1), norm=_fwd_norm(norm))


def irfftn_3d(x, shape_3d: Tuple[int, int, int], norm: FFTNorm = FFTNorm.NONE,
              backend: str = "xla"):
    if _pallas(backend, "irfftn_3d"):
        return hopper_fft.irfftn_3d(x, shape_3d=shape_3d, norm=norm)
    return torch.fft.irfftn(x, s=tuple(shape_3d), dim=(-3, -2, -1),
                            norm=_inv_norm(norm))
