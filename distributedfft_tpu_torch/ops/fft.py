"""Local (per-device) FFT layer of the port — the analog of the reference's
cuFFT shim (``include/cufft.hpp:23-61``).

Every entry point takes ``backend`` (the ``Config.fft_backend`` strings of
the JAX package) and ``settings`` (an ``mxu_fft.MXUSettings``, scoped
around the call; None keeps the settings in effect):

* ``"xla"`` runs ``torch.fft`` — cuFFT on the card — with the cuFFT
  "unnormalized both ways" convention mapped through ``FFTNorm``; it reads
  no settings;
* ``"matmul"`` runs the matmul backend (``ops/mxu_fft.py``): DFT products
  and the four-step, at the settings' precision; ``"matmul-r2"`` is the
  same backend with ``radix2`` forced on;
* ``"pallas"`` runs the hand-written Hopper kernels (``ops/hopper_fft.py``):
  the fused 3D kernels for single-device cubes at direct sizes, the
  per-axis stage kernels everywhere else. Double precision and prime axes
  above 1024 take the matmul backend there, under the same settings scope,
  as in the JAX package;
* ``"bluestein"`` runs the chirp-z backend (``ops/bluestein.py``) for
  arbitrary axis sizes: a 5-smooth axis makes the ``"xla"`` call bit for
  bit, any other length the chirp-z identity over ``torch.fft``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Sequence, Tuple

import torch

from ..params import FFTNorm
from . import bluestein
from . import hopper_fft
from . import mxu_fft

BACKENDS = ("xla", "matmul", "matmul-r2", "pallas", "bluestein")

_MODULES = {"matmul": mxu_fft, "matmul-r2": mxu_fft, "pallas": hopper_fft,
            "bluestein": bluestein}


def validate_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"unknown fft backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    return backend


def _impl(backend: str):
    """The module that runs ``backend`` (None for "xla")."""
    return _MODULES.get(validate_backend(backend))


def _settings_ctx(backend: str, settings):
    """The ``MXUSettings`` scope of a non-"xla" dispatch. ``"matmul-r2"``
    forces ``radix2`` on whatever the caller's settings say; "pallas" is
    scoped the same way, so a plan's precision reaches the axes it hands to
    the matmul backend."""
    if backend == "matmul-r2":
        settings = dataclasses.replace(
            settings or mxu_fft.current_settings(), radix2=True)
    if settings is None:
        return contextlib.nullcontext()
    return mxu_fft.use_settings(settings)


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


def rfft(x, axis: int, norm: FFTNorm = FFTNorm.NONE, backend: str = "xla",
         settings=None):
    """Forward R2C along one axis (cuFFT ``execR2C`` analog, 1D case)."""
    m = _impl(backend)
    if m is not None:
        with _settings_ctx(backend, settings):
            return m.rfft(x, axis=axis, norm=norm)
    return torch.fft.rfft(x, dim=axis, norm=_fwd_norm(norm))


def irfft(x, n: int, axis: int, norm: FFTNorm = FFTNorm.NONE,
          backend: str = "xla", settings=None):
    """Inverse C2R along one axis; ``n`` is the real output extent."""
    m = _impl(backend)
    if m is not None:
        with _settings_ctx(backend, settings):
            return m.irfft(x, n=n, axis=axis, norm=norm)
    return torch.fft.irfft(x, n=n, dim=axis, norm=_inv_norm(norm))


def fft(x, axis: int, norm: FFTNorm = FFTNorm.NONE, backend: str = "xla",
        settings=None):
    """Forward C2C along one axis (cuFFT ``execC2C(..., CUFFT_FORWARD)``)."""
    m = _impl(backend)
    if m is not None:
        with _settings_ctx(backend, settings):
            return m.fft(x, axis=axis, norm=norm)
    return torch.fft.fft(x, dim=axis, norm=_fwd_norm(norm))


def ifft(x, axis: int, norm: FFTNorm = FFTNorm.NONE, backend: str = "xla",
         settings=None):
    """Inverse C2C along one axis (cuFFT ``execC2C(..., CUFFT_INVERSE)``)."""
    m = _impl(backend)
    if m is not None:
        with _settings_ctx(backend, settings):
            return m.ifft(x, axis=axis, norm=norm)
    return torch.fft.ifft(x, dim=axis, norm=_inv_norm(norm))


def fftn(x, axes: Sequence[int], norm: FFTNorm = FFTNorm.NONE,
         backend: str = "xla", settings=None):
    m = _impl(backend)
    if m is not None:
        with _settings_ctx(backend, settings):
            return m.fftn(x, axes, norm=norm)
    return torch.fft.fftn(x, dim=tuple(axes), norm=_fwd_norm(norm))


def ifftn(x, axes: Sequence[int], norm: FFTNorm = FFTNorm.NONE,
          backend: str = "xla", settings=None):
    m = _impl(backend)
    if m is not None:
        with _settings_ctx(backend, settings):
            return m.ifftn(x, axes, norm=norm)
    return torch.fft.ifftn(x, dim=tuple(axes), norm=_inv_norm(norm))


def rfftn_3d(x, norm: FFTNorm = FFTNorm.NONE, backend: str = "xla",
             settings=None):
    """Single-device full 3D R2C over the trailing three axes — the analog
    of the reference's ``cufftMakePlan3d`` single-process fallback
    (``src/mpicufft.cpp:65``). The halved axis is z (the last)."""
    m = _impl(backend)
    if m is not None:
        with _settings_ctx(backend, settings):
            return m.rfftn_3d(x, norm=norm)
    return torch.fft.rfftn(x, dim=(-3, -2, -1), norm=_fwd_norm(norm))


def irfftn_3d(x, shape_3d: Tuple[int, int, int], norm: FFTNorm = FFTNorm.NONE,
              backend: str = "xla", settings=None):
    m = _impl(backend)
    if m is not None:
        with _settings_ctx(backend, settings):
            return m.irfftn_3d(x, shape_3d=shape_3d, norm=norm)
    return torch.fft.irfftn(x, s=tuple(shape_3d), dim=(-3, -2, -1),
                            norm=_inv_norm(norm))
