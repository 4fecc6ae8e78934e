"""Bluestein (chirp-z) FFT backend of the port — arbitrary axis sizes, the
JAX package's ``ops/bluestein.py``.

A length-n DFT of any n (prime, 4093, ...) is evaluated with the chirp-z
identity

    X[k] = c*_k * ( (x * c) circ-conv b )[k],   c_j = exp(-i*pi*j^2/n),
                                                b_j = conj(c_j),

one pointwise chirp multiply, a circular convolution at the chirp length
``m = chirp_length(n)`` (the next power of two >= 2n-1) as FFT(m) ->
pointwise -> IFFT(m), and a last chirp multiply: two power-of-two
transforms and O(m) elementwise work, O(n log n) for every n.

Selected as ``Config(fft_backend="bluestein")`` (``ops/fft.py``). A
5-smooth axis (2^a 3^b 5^c) makes the exact ``torch.fft`` call of the
``"xla"`` backend, so the backend is bit-identical to ``"xla"`` off the
chirp path; the n-dimensional wrappers hand an all-smooth shape to the
same fused ``torch.fft`` call as ``"xla"`` as a whole (composing it per
axis would give other bits). A non-smooth axis takes the chirp path,
whose FFTs are ``torch.fft`` (cuFFT on the card) as they are XLA's in the
JAX package: the backend has no kernel of its own.

The chirp and the kernel spectrum are built on the host in float64, the
quadratic exponent reduced mod 2n before the trig (``j^2 mod 2n``: f64
sin/cos lose about n*eps for angles of order n^2 otherwise), and cast to
the working precision after the FFT. They are cached per (n, inverse,
precision), and per device once moved there.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from ..params import FFTNorm
from . import fft as lf
from . import mxu_fft as mx

# The smoothness radices of every fast path in the repo.
SMOOTH_RADICES = (2, 3, 5)


def is_smooth(n: int, radices: Tuple[int, ...] = SMOOTH_RADICES) -> bool:
    """True when ``n`` factors entirely over ``radices`` (5-smooth by
    default)."""
    if n < 1:
        return False
    for p in radices:
        while n % p == 0:
            n //= p
    return n == 1


def chirp_length(n: int) -> int:
    """The chirp-z working length of a length-``n`` axis: the smallest power
    of two >= 2n-1 (the circular convolution holds the whole linear
    convolution, so nothing wraps onto the first n outputs)."""
    if n < 1:
        raise ValueError(f"axis length must be positive, got {n}")
    return 1 << (max(2 * n - 1, 1) - 1).bit_length()


def good_size(n: int, radices: Tuple[int, ...] = SMOOTH_RADICES) -> int:
    """The smallest 5-smooth integer >= ``n``: the padding target of a
    workload that may round an axis up (an exact-length FFT cannot and takes
    the chirp path)."""
    if n < 1:
        raise ValueError(f"axis length must be positive, got {n}")
    m = n
    while not is_smooth(m, radices):
        m += 1
    return m


# ---------------------------------------------------------------------------
# The chirp constants, built on the host
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _chirp_np(n: int, inverse: bool, double: bool) -> np.ndarray:
    """c_j = exp(-+ i pi j^2 / n), j in [0, n) (the sign flipped for the
    inverse transform), the exponent reduced mod 2n."""
    dt = np.complex128 if double else np.complex64
    j = np.arange(n, dtype=np.int64)
    sign = 1j if inverse else -1j
    return np.exp(sign * np.pi * ((j * j) % (2 * n)) / n).astype(dt)


@functools.lru_cache(maxsize=None)
def _kernel_spectrum_np(n: int, inverse: bool, double: bool) -> np.ndarray:
    """FFT(m) of the chirp kernel b_j = conj(c_j) laid out for the circular
    convolution: b at [0, n), mirrored into [m-n+1, m) so index k-j wraps to
    b_|k-j|. Built in float64, cast after the FFT."""
    m = chirp_length(n)
    c = _chirp_np(n, inverse, True)
    b = np.zeros(m, dtype=np.complex128)
    b[:n] = np.conj(c)
    b[m - n + 1:] = np.conj(c[1:][::-1])
    dt = np.complex128 if double else np.complex64
    return np.fft.fft(b).astype(dt)


@functools.lru_cache(maxsize=None)
def _constants(n: int, inverse: bool, double: bool,
               device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(chirp, kernel spectrum) of a length-n axis on ``device``."""
    return (torch.from_numpy(_chirp_np(n, inverse, double)).to(device),
            torch.from_numpy(_kernel_spectrum_np(n, inverse, double))
            .to(device))


# ---------------------------------------------------------------------------
# The chirp path along the last axis
# ---------------------------------------------------------------------------


def _fft_last(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """Unnormalized DFT (inverse DFT when ``inverse``) along the last axis
    of a complex tensor by the chirp-z identity. The smooth lengths never
    come here: the public wrappers hand them to ``torch.fft`` first."""
    n = x.shape[-1]
    c, bf = _constants(n, inverse, mx._is_double(x.dtype), x.device)
    a = torch.fft.fft(x * c, n=chirp_length(n), norm="backward")
    a.mul_(bf)
    y = torch.fft.ifft(a, norm="backward")
    del a
    return y[..., :n] * c


# ---------------------------------------------------------------------------
# Public per-axis API (the signatures of ops/mxu_fft.py, dispatched by
# ops/fft.py; its FFTNorm scales). A smooth axis makes the "xla" backend's
# call, with its norm string (``lf._fwd_norm`` / ``lf._inv_norm``).
# ---------------------------------------------------------------------------


def fft(x: torch.Tensor, axis: int, norm: FFTNorm = FFTNorm.NONE
        ) -> torch.Tensor:
    n = x.shape[axis]
    if is_smooth(n):
        return torch.fft.fft(x, dim=axis, norm=lf._fwd_norm(norm))
    c = x.to(mx._complex_of(x)).movedim(axis, -1)
    y = mx._scaled(_fft_last(c, False), mx._fwd_scale(n, norm))
    return y.movedim(-1, axis)


def ifft(x: torch.Tensor, axis: int, norm: FFTNorm = FFTNorm.NONE
         ) -> torch.Tensor:
    n = x.shape[axis]
    if is_smooth(n):
        return torch.fft.ifft(x, dim=axis, norm=lf._inv_norm(norm))
    c = x.to(mx._complex_of(x)).movedim(axis, -1)
    y = mx._scaled(_fft_last(c, True), mx._inv_scale(n, norm))
    return y.movedim(-1, axis)


def rfft(x: torch.Tensor, axis: int, norm: FFTNorm = FFTNorm.NONE
         ) -> torch.Tensor:
    """Forward R2C: a chirp axis runs the complex transform and keeps the
    half spectrum."""
    n = x.shape[axis]
    if is_smooth(n):
        return torch.fft.rfft(x, dim=axis, norm=lf._fwd_norm(norm))
    c = x.to(mx._complex_of(x)).movedim(axis, -1)
    y = mx._scaled(_fft_last(c, False)[..., :n // 2 + 1],
                   mx._fwd_scale(n, norm))
    return y.movedim(-1, axis)


def irfft(x: torch.Tensor, n: int, axis: int,
          norm: FFTNorm = FFTNorm.NONE) -> torch.Tensor:
    """Inverse C2R to n points: a chirp axis inverts the Hermitian-extended
    spectrum as a complex transform and keeps its real part."""
    if is_smooth(n):
        return torch.fft.irfft(x, n=n, dim=axis, norm=lf._inv_norm(norm))
    c = mx._fit_axis(x.to(mx._complex_of(x)).movedim(axis, -1), -1,
                     n // 2 + 1)
    y = _fft_last(mx._hermitian_extend(c, n), True).real.contiguous()
    return mx._scaled(y, mx._inv_scale(n, norm)).movedim(-1, axis)


# The n-dimensional wrappers hand an all-smooth shape WHOLESALE to the
# fused torch.fft call of the "xla" backend: composing the same transforms
# per axis agrees within rounding but not bit for bit.


def fftn(x: torch.Tensor, axes: Sequence[int],
         norm: FFTNorm = FFTNorm.NONE) -> torch.Tensor:
    if all(is_smooth(x.shape[a]) for a in axes):
        return torch.fft.fftn(x, dim=tuple(axes), norm=lf._fwd_norm(norm))
    for a in axes:
        x = fft(x, axis=a, norm=norm)
    return x


def ifftn(x: torch.Tensor, axes: Sequence[int],
          norm: FFTNorm = FFTNorm.NONE) -> torch.Tensor:
    if all(is_smooth(x.shape[a]) for a in axes):
        return torch.fft.ifftn(x, dim=tuple(axes), norm=lf._inv_norm(norm))
    for a in axes:
        x = ifft(x, axis=a, norm=norm)
    return x


def rfftn_3d(x: torch.Tensor, norm: FFTNorm = FFTNorm.NONE) -> torch.Tensor:
    if all(is_smooth(n) for n in x.shape[-3:]):
        return torch.fft.rfftn(x, dim=(-3, -2, -1), norm=lf._fwd_norm(norm))
    c = rfft(x, axis=-1, norm=norm)
    c = fft(c, axis=-2, norm=norm)
    return fft(c, axis=-3, norm=norm)


def irfftn_3d(x: torch.Tensor, shape_3d: Tuple[int, int, int],
              norm: FFTNorm = FFTNorm.NONE) -> torch.Tensor:
    if all(is_smooth(n) for n in shape_3d[-3:]):
        return torch.fft.irfftn(x, s=tuple(shape_3d), dim=(-3, -2, -1),
                                norm=lf._inv_norm(norm))
    c = ifft(mx._fit_axis(x, -3, shape_3d[-3]), axis=-3, norm=norm)
    c = ifft(mx._fit_axis(c, -2, shape_3d[-2]), axis=-2, norm=norm)
    return irfft(c, n=shape_3d[-1], axis=-1, norm=norm)
