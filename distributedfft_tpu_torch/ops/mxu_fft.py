"""DFT constants, the four-step factorisation and norm helpers shared by
the port's FFT backends.

Copies of the constant builders and the factor choice of the JAX
package's ``ops/mxu_fft.py``: the numpy constants are built by the same
expressions, so they are bit-identical to the reference's, the factor
pairs are the same, and the tensor helpers follow its jnp ones. The matmul
backend itself is not ported yet.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from ..params import FFTNorm

# Largest length transformed by a single direct DFT matmul.
DIRECT_MAX = 512

# Largest prime length the per-axis kernels take as one direct DFT stage
# (``pallas_fft._N_MAX``); a longer prime axis needs the matmul backend.
N_MAX = 1024


@functools.lru_cache(maxsize=None)
def _dft_np(n: int, inverse: bool, double: bool) -> np.ndarray:
    """Dense DFT matrix F[j,k] = exp(-+ 2*pi*i*j*k/n) (numpy, cached)."""
    dt = np.complex128 if double else np.complex64
    j = np.arange(n)
    sign = 2j if inverse else -2j
    # W^(jk) = W^(jk mod n): reduce the exponent first so sin/cos see small
    # exact angles (f64 trig loses ~n*eps for angles of order n).
    return np.exp(sign * np.pi * (np.outer(j, j) % n) / n).astype(dt)


@functools.lru_cache(maxsize=None)
def _twiddle_np(n1: int, n2: int, inverse: bool, double: bool) -> np.ndarray:
    """Four-step twiddle T[r,k2] = exp(-+ 2*pi*i*r*k2/(n1*n2))."""
    dt = np.complex128 if double else np.complex64
    n = n1 * n2
    sign = 2j if inverse else -2j
    return np.exp(sign * np.pi * np.outer(np.arange(n1), np.arange(n2)) / n
                  ).astype(dt)


@functools.lru_cache(maxsize=None)
def _c2r_np(n: int, double: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Half-spectrum inverse-DFT matrices (CR, CI) with conjugate symmetry
    folded in: for Hermitian input of length n//2+1,
    ``y = Re(c) @ CR - Im(c) @ CI`` equals ``Re(idft(hermitian_extend(c)))``."""
    dt = np.float64 if double else np.float32
    n_out = n // 2 + 1
    jk = np.outer(np.arange(n_out), np.arange(n)) % n  # reduce for exact trig
    ang = 2.0 * np.pi * jk / n
    a = np.full((n_out, 1), 2.0)
    a[0] = 1.0
    if n % 2 == 0:
        a[n // 2] = 1.0
    return (a * np.cos(ang)).astype(dt), (a * np.sin(ang)).astype(dt)


@functools.lru_cache(maxsize=None)
def _split(n: int) -> Tuple[int, int]:
    """Balanced factorization n = n1*n2 with n1 <= n2, n1 maximal; (1, n)
    for primes."""
    r = int(math.isqrt(n))
    for n1 in range(r, 1, -1):
        if n % n1 == 0:
            return n1, n // n1
    return 1, n


@functools.lru_cache(maxsize=None)
def _split_wide(n: int, direct_max: int) -> Tuple[int, int]:
    """n = n1*n2 with n2 the largest divisor of n not above ``direct_max``;
    (1, n) when no divisor > 1 qualifies."""
    for n2 in range(min(int(direct_max), n - 1), 1, -1):
        if n % n2 == 0:
            return n // n2, n2
    return 1, n


@functools.lru_cache(maxsize=None)
def _split_for(n: int, direct_max: int) -> Tuple[int, int]:
    """The (n1, n2) the four-step dispatch uses for an axis of length
    ``n > direct_max``: the deep split of ``_split_wide`` when its n1 is a
    direct size too (1024 -> 2x512, 2048 -> 4x512), else the balanced
    ``_split``."""
    n1, n2 = _split_wide(n, direct_max)
    if 1 < n1 <= direct_max:
        return n1, n2
    return _split(n)


def _is_double(dtype) -> bool:
    return dtype in (torch.float64, torch.complex128)


def _hermitian_extend(c: torch.Tensor, n: int) -> torch.Tensor:
    """Rebuild the full length-n spectrum from its n//2+1 half (C2R input)."""
    tail = torch.flip(torch.conj(c[..., 1:(n + 1) // 2]), dims=(-1,))
    return torch.cat([c, tail], dim=-1)


def _fit_axis(c: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """Crop or zero-pad axis to extent n (numpy's ``s=``/``n=`` semantics,
    applied before transforming along that axis)."""
    cur = c.shape[axis]
    if cur > n:
        c = c.narrow(axis, 0, n)
    elif cur < n:
        shape = list(c.shape)
        shape[axis] = n - cur
        c = torch.cat([c, c.new_zeros(shape)], dim=axis)
    return c


def _fwd_scale(n: int, norm: FFTNorm) -> float:
    return 1.0 / math.sqrt(n) if norm is FFTNorm.ORTHO else 1.0


def _inv_scale(n: int, norm: FFTNorm) -> float:
    if norm is FFTNorm.ORTHO:
        return 1.0 / math.sqrt(n)
    if norm is FFTNorm.BACKWARD:
        return 1.0 / n
    return 1.0  # NONE: unnormalized inverse (cuFFT convention)


def _scaled(y: torch.Tensor, s: float) -> torch.Tensor:
    return y if s == 1.0 else y * s
