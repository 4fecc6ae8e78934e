"""Real-to-real transforms (DCT / DST, types I-III) through the R2C layer
of the port — the JAX package's ``solvers/r2r.py`` on ``torch``.

scipy's conventions (``scipy.fft.dct/dst``, ``norm=None`` and
``"ortho"``), every flop through the port's local R2C layer
(``ops/fft.py``), so a DCT runs on whichever backend the caller picks:
``"xla"`` (cuFFT), ``"matmul"``, ``"bluestein"`` for extension lengths off
the smooth path, or ``"pallas"``, where the extension's rows take kernel 1
(``rfft``) and kernel 3 (``irfft``).

The construction is the even/odd EXTENSION and a TWIDDLE:

* DCT-II: y = [x, flip x] (length 2n) -> ``rfft`` ->
  ``C[k] = Re(e^{-iπk/2n} Y[k])``;
* DST-II: y = [x, -flip x] -> ``rfft`` ->
  ``S[k] = -Im(e^{-iπ(k+1)/2n} Y[k+1])``;
* DCT-I / DST-I: the whole-sample extensions (lengths 2(n-1) / 2(n+1)),
  no twiddle;
* type III = the transpose of type II: the extension spectrum rebuilt from
  the coefficients (the same twiddles, conjugated), ``irfft``, the first n
  samples.

These are LOCAL transforms of a tensor (or numpy array) along its axes,
differentiable wherever their backend is, not distributed plans: a
distributed non-periodic solve goes through a plan built at the extended
size (``PoissonSolver``). ``dctn`` / ``dstn`` apply along several axes.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops import fft as lf
from ..params import FFTNorm

_NORMS = (None, "ortho")


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


def _check(x: torch.Tensor, type: int, norm: Optional[str],
           kinds=(1, 2, 3)) -> None:
    if type not in kinds:
        raise ValueError(f"transform type must be one of {kinds}, got {type}")
    if norm not in _NORMS:
        raise ValueError(f"norm must be None or 'ortho', got {norm!r}")
    if x.is_complex():
        raise TypeError("R2R transforms take real input")


def _dbl(x: torch.Tensor) -> bool:
    return x.dtype == torch.float64


@functools.lru_cache(maxsize=None)
def _twiddle_np(n: int, double: bool, shift: int = 0) -> np.ndarray:
    """e^{-iπ(k+shift)/(2n)}, k in [0, n): the half-sample phase that
    aligns the length-2n extension spectrum with the DCT/DST layout."""
    dt = np.complex128 if double else np.complex64
    k = np.arange(n, dtype=np.float64) + shift
    return np.exp(-1j * np.pi * k / (2 * n)).astype(dt)


def _twiddle(x: torch.Tensor, n: int, shift: int = 0,
             conj: bool = False) -> torch.Tensor:
    tw = _twiddle_np(n, _dbl(x), shift)
    return torch.from_numpy(np.conj(tw) if conj else tw).to(x.device)


def _rfft(y: torch.Tensor, backend: str) -> torch.Tensor:
    return lf.rfft(y, axis=-1, norm=FFTNorm.NONE, backend=backend)


def _irfft(Y: torch.Tensor, n: int, backend: str) -> torch.Tensor:
    return lf.irfft(Y, n=n, axis=-1, norm=FFTNorm.BACKWARD, backend=backend)


def _cdt(x: torch.Tensor) -> torch.dtype:
    return torch.complex128 if _dbl(x) else torch.complex64


# ---------------------------------------------------------------------------
# forward transforms along the LAST axis (norm=None scipy conventions)
# ---------------------------------------------------------------------------


def _dct2_last(x: torch.Tensor, backend: str) -> torch.Tensor:
    n = x.shape[-1]
    ext = torch.cat([x, torch.flip(x, dims=(-1,))], dim=-1)
    Y = _rfft(ext, backend)[..., :n]
    return torch.real(_twiddle(x, n) * Y)


def _dst2_last(x: torch.Tensor, backend: str) -> torch.Tensor:
    n = x.shape[-1]
    ext = torch.cat([x, -torch.flip(x, dims=(-1,))], dim=-1)
    Y = _rfft(ext, backend)[..., 1: n + 1]
    return -torch.imag(_twiddle(x, n, shift=1) * Y)


def _dct1_last(x: torch.Tensor, backend: str) -> torch.Tensor:
    n = x.shape[-1]
    if n < 2:
        raise ValueError("DCT-I needs n >= 2")
    ext = torch.cat([x, torch.flip(x[..., 1:-1], dims=(-1,))], dim=-1)
    return torch.real(_rfft(ext, backend))[..., :n]


def _dst1_last(x: torch.Tensor, backend: str) -> torch.Tensor:
    n = x.shape[-1]
    z = x.new_zeros(x.shape[:-1] + (1,))
    ext = torch.cat([z, x, z, -torch.flip(x, dims=(-1,))], dim=-1)
    return -torch.imag(_rfft(ext, backend))[..., 1: n + 1]


def _dct3_last(x: torch.Tensor, backend: str) -> torch.Tensor:
    """Type III = 2n * (type-II inverse): the extension spectrum Y[k] =
    conj(tw)[k] x_k (Y[n] = 0: the half-sample-symmetric class has no
    Nyquist energy), ``irfft``, the first n samples."""
    n = x.shape[-1]
    Y = x.to(_cdt(x)) * _twiddle(x, n, conj=True)
    Y = torch.cat([Y, Y.new_zeros(Y.shape[:-1] + (1,))], dim=-1)
    return 2 * n * _irfft(Y, 2 * n, backend)[..., :n]


def _dst3_last(x: torch.Tensor, backend: str) -> torch.Tensor:
    """Type III = 2n * (type-II inverse): Y[m] = -i conj(tw)[m] x_{m-1}
    for m in [1, n], Y[0] = 0 (an odd extension has zero mean)."""
    n = x.shape[-1]
    Y = -1j * _twiddle(x, n, shift=1, conj=True) * x.to(_cdt(x))
    Y = torch.cat([Y.new_zeros(Y.shape[:-1] + (1,)), Y], dim=-1)
    return 2 * n * _irfft(Y, 2 * n, backend)[..., :n]


# ---------------------------------------------------------------------------
# ortho scalings (scipy conventions: type III ortho inverts type II ortho)
# ---------------------------------------------------------------------------


def _scales(y: torch.Tensor, kind: str, distinguished: float
            ) -> torch.Tensor:
    n = y.shape[-1]
    f = np.full(n, math.sqrt(1.0 / (2 * n)))
    f[0 if kind == "dct" else n - 1] = distinguished
    return torch.from_numpy(f).to(device=y.device, dtype=y.dtype)


def _ortho_post_2(y: torch.Tensor, kind: str) -> torch.Tensor:
    """A norm=None type-II result scaled to ortho: sqrt(1/(2n)) but the
    distinguished element (k=0 for DCT, k=n-1 for DST) at sqrt(1/(4n))."""
    return y * _scales(y, kind, math.sqrt(1.0 / (4 * y.shape[-1])))


def _ortho_pre_3(x: torch.Tensor, kind: str) -> torch.Tensor:
    """Type-III ortho input prescaled: the transpose of ``_ortho_post_2``
    with the distinguished element at 2 sqrt(1/(4n)) = sqrt(1/n)."""
    return x * _scales(x, kind, math.sqrt(1.0 / x.shape[-1]))


# ---------------------------------------------------------------------------
# public API (scipy.fft signatures, + backend)
# ---------------------------------------------------------------------------


def _r2r(x, type: int, axis: int, norm: Optional[str], backend: str,
         kind: str) -> torch.Tensor:
    x = _as_tensor(x)
    _check(x, type, norm)
    if type == 1 and norm == "ortho":
        raise NotImplementedError(
            f"ortho-normalized {kind.upper()}-I is not provided (types 2/3 "
            "cover the solver suite)")
    one, two, three = ((_dct1_last, _dct2_last, _dct3_last) if kind == "dct"
                       else (_dst1_last, _dst2_last, _dst3_last))
    y = torch.movedim(x, axis, -1)
    if type == 1:
        out = one(y, backend)
    elif type == 2:
        out = two(y, backend)
        if norm == "ortho":
            out = _ortho_post_2(out, kind)
    else:
        out = three(_ortho_pre_3(y, kind) if norm == "ortho" else y, backend)
    return torch.movedim(out, -1, axis)


def dct(x, type: int = 2, axis: int = -1, norm: Optional[str] = None,
        backend: str = "xla") -> torch.Tensor:
    """Discrete cosine transform (types 1-3, scipy conventions). ``norm``
    is None (unnormalized) or "ortho"; ``backend`` picks the local R2C
    implementation (``ops/fft.py``)."""
    return _r2r(x, type, axis, norm, backend, "dct")


def dst(x, type: int = 2, axis: int = -1, norm: Optional[str] = None,
        backend: str = "xla") -> torch.Tensor:
    """Discrete sine transform (types 1-3, scipy conventions)."""
    return _r2r(x, type, axis, norm, backend, "dst")


def _inverse(x, type: int, axis: int, norm: Optional[str], backend: str,
             kind: str) -> torch.Tensor:
    x = _as_tensor(x)
    _check(x, type, norm)
    n = x.shape[axis]
    y = _r2r(x, {1: 1, 2: 3, 3: 2}[type], axis, norm, backend, kind)
    if norm is None:
        one = 2.0 * (n - 1) if kind == "dct" else 2.0 * (n + 1)
        y = y / (one if type == 1 else 2.0 * n)
    return y


def idct(x, type: int = 2, axis: int = -1, norm: Optional[str] = None,
         backend: str = "xla") -> torch.Tensor:
    """Inverse DCT (scipy ``idct``): the ortho family inverts through the
    transpose; norm=None divides by the roundtrip factor (2n for types
    2/3, 2(n-1) for type 1)."""
    return _inverse(x, type, axis, norm, backend, "dct")


def idst(x, type: int = 2, axis: int = -1, norm: Optional[str] = None,
         backend: str = "xla") -> torch.Tensor:
    """Inverse DST (scipy ``idst``; 2(n+1) for type 1)."""
    return _inverse(x, type, axis, norm, backend, "dst")


def dctn(x, type: int = 2, axes: Optional[Sequence[int]] = None,
         norm: Optional[str] = None, backend: str = "xla") -> torch.Tensor:
    """Separable multi-axis DCT (scipy ``dctn``)."""
    x = _as_tensor(x)
    for a in (range(x.ndim) if axes is None else axes):
        x = dct(x, type=type, axis=a, norm=norm, backend=backend)
    return x


def dstn(x, type: int = 2, axes: Optional[Sequence[int]] = None,
         norm: Optional[str] = None, backend: str = "xla") -> torch.Tensor:
    """Separable multi-axis DST (scipy ``dstn``)."""
    x = _as_tensor(x)
    for a in (range(x.ndim) if axes is None else axes):
        x = dst(x, type=type, axis=a, norm=norm, backend=backend)
    return x
