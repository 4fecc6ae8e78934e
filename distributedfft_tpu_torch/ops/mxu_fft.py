"""The matmul FFT backend of the port (``Config.fft_backend = "matmul"`` /
``"matmul-r2"``) — the counterpart of the JAX package's ``ops/mxu_fft.py``.

A DFT along an axis is a product with the dense DFT matrix ``F[j, k] =
w^(jk)``: one product for ``n <= direct_max``, else the four-step split of
``_split_for`` (reshape, the n2-point DFT, the twiddle, the n1-point DFT,
reshape), recursing while a factor is still too long; a prime length takes
one full product. The ``"pallas"`` backend hands this module what its
kernels do not take, as the JAX package does: double precision, and a
prime axis above ``N_MAX`` points (``ops/hopper_fft.py``).

The numpy constants are built by the reference's own expressions, so they
are bit-identical to its; on a device they are built once per (matrix,
dtype, device). Every product is plain tensor code on the input's device.

Precision (``MXUSettings.precision``) follows the JAX contract for single
precision: ``DEFAULT`` is one bfloat16 pass, ``HIGH`` (the default) three
(``hi = bf16(x)``, ``lo = bf16(x - hi)``; ``hi Fhi + hi Flo + lo Fhi``),
``HIGHEST`` full float32; every output is float32 and every pass
accumulates in float32. Double precision always runs ``HIGHEST``. On a
card the bfloat16 passes run on the tensor cores where ``torch.mm`` takes
``out_dtype=torch.float32``, else as float32 products of the rounded
operands, whose products are exact, so the numbers are the same
(``MM16_ROUTE`` records which ran). ``HIGHEST`` in float32 must be IEEE
float32: with TF32 enabled on the card a product raises and names the flag;
no process-global flag is changed here.

Settings are per call: every public entry point reads
``current_settings()``, a ``contextvars`` scope (``use_settings``) over the
process defaults (``default_settings``, changed only by the deprecated
``set_*`` shims), so two plans with different settings coexist.

``DISPATCHES["matmul"]`` counts the per-axis transforms this backend runs
(each public ``fft`` / ``ifft`` / ``rfft`` / ``irfft``, and each axis the
``"pallas"`` backend hands over), so a run can show which route it took.
A transform of more than ``CHUNK_BYTES`` of rows runs in groups of rows
(each row's arithmetic is unchanged), which bounds the intermediates of
the four-step.

Normalization follows the cuFFT "unnormalized both ways" convention mapped
through ``FFTNorm``, as in ``ops/fft.py``.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import enum
import functools
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..params import FFTNorm

# Largest length transformed by a single direct DFT matmul.
DIRECT_MAX = 512

# Largest prime length the per-axis kernels take as one direct DFT stage
# (``pallas_fft._N_MAX``); a longer prime axis takes this backend.
N_MAX = 1024

# Per-axis transforms run by this backend since the last reset.
DISPATCHES: Dict[str, int] = {"matmul": 0}

# How the bfloat16 passes of DEFAULT / HIGH ran on the card (the right
# products: a tensor's rows times a constant): None until the first one.
MM16_ROUTE: Dict[str, Optional[str]] = {"route": None}
_TENSOR_CORES = "tensor cores (torch.mm, bfloat16 in, out_dtype float32)"
_ROUNDED_F32 = "float32 products of the bfloat16-rounded operands"

# Input bytes of rows transformed at once; larger inputs run in groups.
CHUNK_BYTES = 1 << 30


class Precision(enum.Enum):
    """Precision of single-precision DFT products (``lax.Precision``'s
    names and values)."""

    DEFAULT = "default"
    HIGH = "high"
    HIGHEST = "highest"


def as_precision(p) -> Precision:
    """A ``Precision``, its value in any case (``Config.mxu_precision``),
    or an enum member of the same name (the JAX package's
    ``lax.Precision``)."""
    if isinstance(p, Precision):
        return p
    name = getattr(p, "name", None)
    if isinstance(name, str) and name in Precision.__members__:
        return Precision[name]
    return Precision(str(p).lower())


@dataclasses.dataclass(frozen=True)
class MXUSettings:
    """Per-call backend knobs (the JAX package's ``MXUSettings``).

    * ``precision`` — of single-precision products (f64 is always
      HIGHEST);
    * ``radix2`` — DIF splitting of C2C stages down to ``_R2_BASE``;
    * ``karatsuba`` — the 3-product complex multiply of ``_matmul_F``;
    * ``fourstep_einsum`` — the four-step as direct contractions of the
      factor axes (``_fourstep_einsum``);
    * ``direct_max`` — the longest length one direct product takes."""

    precision: Precision = Precision.HIGH
    radix2: bool = False
    karatsuba: bool = False
    fourstep_einsum: bool = False
    direct_max: int = DIRECT_MAX

    @classmethod
    def make(cls, precision=None, radix2: bool = False,
             karatsuba: bool = False, fourstep_einsum: bool = False,
             direct_max: Optional[int] = None) -> "MXUSettings":
        """Build from loosely typed values (precision a name in any case, a
        ``Precision``, or None for HIGH)."""
        p = Precision.HIGH if precision is None else as_precision(precision)
        return cls(p, bool(radix2), bool(karatsuba), bool(fourstep_einsum),
                   DIRECT_MAX if direct_max is None else int(direct_max))


# Process defaults, changed only by the deprecated ``set_*`` shims.
_DEFAULTS = MXUSettings()

# Active per-call override; None falls through to _DEFAULTS.
_ACTIVE: contextvars.ContextVar[Optional[MXUSettings]] = \
    contextvars.ContextVar("mxu_settings", default=None)


def current_settings() -> MXUSettings:
    """The settings in effect: the scoped override, else the defaults."""
    return _ACTIVE.get() or _DEFAULTS


def default_settings() -> MXUSettings:
    """The process defaults, ignoring any scoped override."""
    return _DEFAULTS


@contextlib.contextmanager
def use_settings(settings: Optional[MXUSettings]):
    """Scope ``settings`` for this context; None keeps what is in effect."""
    if settings is None:
        yield
        return
    token = _ACTIVE.set(settings)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


@contextlib.contextmanager
def radix2(on: bool = True):
    """Scoped radix-2 override of the current settings."""
    with use_settings(dataclasses.replace(current_settings(),
                                          radix2=bool(on))):
        yield


@contextlib.contextmanager
def fourstep_einsum(on: bool = True):
    """Scoped four-step-einsum override of the current settings."""
    with use_settings(dataclasses.replace(current_settings(),
                                          fourstep_einsum=bool(on))):
        yield


def _set_default(**kw) -> None:
    global _DEFAULTS
    _DEFAULTS = dataclasses.replace(_DEFAULTS, **kw)


def set_precision(p) -> None:
    """DEPRECATED: set the process-default precision (prefer
    ``Config(mxu_precision=...)``)."""
    _set_default(precision=as_precision(p))


def set_karatsuba(on: bool) -> None:
    """DEPRECATED: set the process-default 3-product complex multiply."""
    _set_default(karatsuba=bool(on))


def set_radix2(on: bool) -> None:
    """DEPRECATED: set the process-default radix-2 splitting (prefer the
    backend "matmul-r2")."""
    _set_default(radix2=bool(on))


def set_fourstep_einsum(on: bool) -> None:
    """DEPRECATED: set the process-default four-step einsum."""
    _set_default(fourstep_einsum=bool(on))


def _is_double(dtype) -> bool:
    return dtype in (torch.float64, torch.complex128)


def _prec_for(dtype) -> Precision:
    return (Precision.HIGHEST if _is_double(dtype)
            else current_settings().precision)


def _count() -> None:
    DISPATCHES["matmul"] += 1


# ---------------------------------------------------------------------------
# DFT / twiddle constants (numpy, cached; the reference's expressions)
# ---------------------------------------------------------------------------


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
def _r2_twiddle_np(n: int, inverse: bool, double: bool) -> np.ndarray:
    """Radix-2 DIF twiddle w^j = exp(-+2*pi*i*j/n), j in [0, n/2)."""
    dt = np.complex128 if double else np.complex64
    sign = 2j if inverse else -2j
    return np.exp(sign * np.pi * np.arange(n // 2) / n).astype(dt)


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


def _np_const(key: tuple) -> np.ndarray:
    """The numpy matrix a constant key names: ("dft", n, inverse, double),
    ("rdft", n, double) (the R2C columns), ("tw", n1, n2, inverse,
    double), ("r2", n, inverse, double), ("c2r", n, double, part)."""
    kind = key[0]
    if kind == "dft":
        return _dft_np(*key[1:])
    if kind == "rdft":
        n, double = key[1:]
        return _dft_np(n, False, double)[:, :n // 2 + 1]
    if kind == "tw":
        return _twiddle_np(*key[1:])
    if kind == "r2":
        return _r2_twiddle_np(*key[1:])
    n, double, part = key[1:]
    return _c2r_np(n, double)[part]


@functools.lru_cache(maxsize=None)
def _const(key: tuple, part: str, device: torch.device) -> torch.Tensor:
    """The constant ``key`` on ``device``: "c" the matrix itself; of a
    complex one, "re", "im", "sum" (re + im) or "cat" ([re | im] along its
    columns), in its real dtype."""
    m = _np_const(key)
    if part == "re":
        m = m.real
    elif part == "im":
        m = m.imag
    elif part == "sum":
        m = m.real + m.imag
    elif part == "cat":
        m = np.concatenate([m.real, m.imag], axis=-1)
    return torch.from_numpy(np.ascontiguousarray(m)).to(device)


@functools.lru_cache(maxsize=None)
def _const16(key: tuple, part: str,
             device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) bfloat16 split of a float32 real constant."""
    m = _const(key, part, device)
    hi = m.to(torch.bfloat16)
    return hi, (m - hi.to(m.dtype)).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# Products at a precision
# ---------------------------------------------------------------------------


def tf32_enabled() -> bool:
    """Whether float32 products on the card may run as TF32."""
    return (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest")


def _require_ieee(t: torch.Tensor) -> None:
    """HIGHEST in single precision must be IEEE float32 on the card."""
    if t.is_cuda and t.dtype in (torch.float32, torch.complex64) \
            and tf32_enabled():
        raise RuntimeError(
            "the matmul backend's HIGHEST precision needs IEEE float32 "
            "products, but TF32 is enabled "
            "(torch.backends.cuda.matmul.allow_tf32 or "
            "torch.set_float32_matmul_precision); disable it, or ask for "
            "mxu_precision='high'")


def _mm16(a: torch.Tensor, b: torch.Tensor, left: bool) -> torch.Tensor:
    """float32 product of two bfloat16 operands (a @ b, or b @ a with
    ``left``), float32 accumulation: on the card's tensor cores where
    ``torch.mm`` takes ``out_dtype``; ``left`` products (the four-step's
    second stage, the einsum and real-plane paths) and the rest as float32
    products of the rounded operands."""
    if a.is_cuda and not left and MM16_ROUTE["route"] != _ROUNDED_F32:
        try:
            y = torch.mm(a.reshape(-1, a.shape[-1]), b,
                         out_dtype=torch.float32)
            MM16_ROUTE["route"] = _TENSOR_CORES
            return y.reshape(a.shape[:-1] + b.shape[-1:])
        except torch.cuda.OutOfMemoryError:
            raise
        except (TypeError, RuntimeError):   # no bfloat16 -> float32 mm
            MM16_ROUTE["route"] = _ROUNDED_F32
    return _product(a.to(torch.float32), b.to(torch.float32), left)


def _product(a: torch.Tensor, m: torch.Tensor, left: bool) -> torch.Tensor:
    """``a @ m`` as one 2D product of a's rows (a strided view is copied
    first: a batched product over a view is far slower on the card), or
    ``m @ a`` with ``left``."""
    if left:
        return torch.matmul(m, a)
    y = torch.matmul(a.reshape(-1, a.shape[-1]), m)
    return y.reshape(a.shape[:-1] + m.shape[-1:])


def _mm(a: torch.Tensor, key: tuple, part: str, prec: Precision,
        left: bool = False) -> torch.Tensor:
    """``a @ M`` (``M @ a`` with ``left``) for a real tensor ``a`` and the
    real constant ``M`` = ``_const(key, part)``, at ``prec``."""
    if a.dtype == torch.float64 or prec is Precision.HIGHEST:
        _require_ieee(a)
        return _product(a, _const(key, part, a.device), left)
    hi, lo = _const16(key, part, a.device)
    ah = a.to(torch.bfloat16)
    y = _mm16(ah, hi, left)
    if prec is Precision.HIGH:
        al = (a - ah.to(a.dtype)).to(torch.bfloat16)
        y += _mm16(ah, lo, left)
        y += _mm16(al, hi, left)
    return y


def _matmul_F(x: torch.Tensor, key: tuple, left: bool = False
              ) -> torch.Tensor:
    """``x @ F`` (``F @ x`` with ``left``) for complex x and the constant
    complex matrix ``key`` names."""
    prec = _prec_for(x.dtype)
    if current_settings().karatsuba:
        ar, ai = x.real, x.imag
        t1 = _mm(ar, key, "re", prec, left)
        t2 = _mm(ai, key, "im", prec, left)
        t3 = _mm(ar + ai, key, "sum", prec, left)
        return torch.complex(t1 - t2, t3 - t1 - t2)
    if _is_double(x.dtype) or prec is Precision.HIGHEST:
        _require_ieee(x)
        return _product(x, _const(key, "c", x.device), left)
    if left:
        ar, ai = x.real, x.imag
        return torch.complex(
            _mm(ar, key, "re", prec, True) - _mm(ai, key, "im", prec, True),
            _mm(ai, key, "re", prec, True) + _mm(ar, key, "im", prec, True))
    # One product of the stacked (re, im) planes with [Fr | Fi].
    k = _np_const(key).shape[-1]
    p = _mm(torch.stack((x.real, x.imag)), key, "cat", prec)
    return torch.complex(p[0, ..., :k] - p[1, ..., k:],
                         p[0, ..., k:] + p[1, ..., :k])


def _rmatmul_F(x: torch.Tensor, key: tuple, left: bool = False
               ) -> torch.Tensor:
    """``x @ F`` for REAL x: real products instead of a complex one."""
    prec = _prec_for(x.dtype)
    if left:
        return torch.complex(_mm(x, key, "re", prec, True),
                             _mm(x, key, "im", prec, True))
    k = _np_const(key).shape[-1]
    p = _mm(x, key, "cat", prec)
    return torch.complex(p[..., :k], p[..., k:])


# ---------------------------------------------------------------------------
# Core transforms along the LAST axis
# ---------------------------------------------------------------------------

# Radix-2 DIF recursion of the C2C stages stops at this depth.
_R2_BASE = 128


def _fft_radix2(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """DIF radix-2 split of an even-length last-axis DFT: two half-length
    DFTs (recursively down to ``_R2_BASE``) + butterfly + interleave."""
    n = x.shape[-1]
    h = n // 2
    dbl = _is_double(x.dtype)
    x1, x2 = x[..., :h], x[..., h:]
    even = _fft_last(x1 + x2, inverse)
    tw = _const(("r2", n, inverse, dbl), "c", x.device)
    odd = _fft_last((x1 - x2) * tw, inverse)
    # X[2k] = even[k], X[2k+1] = odd[k]
    return torch.stack([even, odd], dim=-1).reshape(x.shape[:-1] + (n,))


def _fourstep_einsum(x4: torch.Tensor, inverse: bool, n1: int, n2: int,
                     dbl: bool) -> torch.Tensor:
    """The four-step as contractions of the [..., s, r] factor array
    (x[..., s*n1 + r]); returns [..., n] in natural order. The DFT matrices
    are symmetric, so the first contraction over s is ``F2 @ x4``."""
    key2 = ("dft", n2, inverse, dbl)
    b = (_matmul_F(x4, key2, left=True) if x4.is_complex()
         else _rmatmul_F(x4, key2, left=True))             # [.., k2, r]
    b *= _const(("tw", n1, n2, inverse, dbl), "c", x4.device).T
    d = _matmul_F(b, ("dft", n1, inverse, dbl))            # [.., k2, k1]
    return d.transpose(-1, -2).reshape(d.shape[:-2] + (n1 * n2,))


def _fft_last(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """Unnormalized DFT along the last axis of a complex tensor."""
    n = x.shape[-1]
    dbl = _is_double(x.dtype)
    st = current_settings()
    if st.radix2 and n > _R2_BASE and n % 2 == 0:
        return _fft_radix2(x, inverse)
    if n <= st.direct_max:
        return _matmul_F(x, ("dft", n, inverse, dbl))
    n1, n2 = _split_for(n, st.direct_max)
    if n1 == 1:  # prime length: direct full-size product
        return _matmul_F(x, ("dft", n, inverse, dbl))
    lead = x.shape[:-1]
    if st.fourstep_einsum and n1 <= st.direct_max and n2 <= st.direct_max:
        return _fourstep_einsum(x.reshape(lead + (n2, n1)), inverse, n1, n2,
                                dbl)
    # x[..., s*n1 + r] -> A[..., r, s]: the one swap
    a = x.reshape(lead + (n2, n1)).transpose(-1, -2).contiguous()
    b = _fft_last(a, inverse)                        # DFT over s: (r, k2)
    del a
    b *= _const(("tw", n1, n2, inverse, dbl), "c", x.device)
    return _second_stage(b, n1, inverse, dbl).reshape(lead + (n,))


def _rfft_last(x: torch.Tensor) -> torch.Tensor:
    """Unnormalized R2C DFT along the last axis of a real tensor; output
    length n//2+1."""
    n = x.shape[-1]
    n_out = n // 2 + 1
    dbl = _is_double(x.dtype)
    st = current_settings()
    if n <= st.direct_max:
        return _rmatmul_F(x, ("rdft", n, dbl))
    n1, n2 = _split_for(n, st.direct_max)
    if n1 == 1:
        return _rmatmul_F(x, ("rdft", n, dbl))
    lead = x.shape[:-1]
    if st.fourstep_einsum and n1 <= st.direct_max and n2 <= st.direct_max:
        return _fourstep_einsum(x.reshape(lead + (n2, n1)), False, n1, n2,
                                dbl)[..., :n_out]
    a = x.reshape(lead + (n2, n1)).transpose(-1, -2).contiguous()
    # First stage on real data: the real product pair.
    if n2 <= st.direct_max:
        b = _rmatmul_F(a, ("dft", n2, False, dbl))
    else:
        b = _fft_last(a.to(torch.complex128 if dbl else torch.complex64),
                      False)
    del a
    b *= _const(("tw", n1, n2, False, dbl), "c", x.device)
    return _second_stage(b, n1, False, dbl).reshape(lead + (n,))[..., :n_out]


def _second_stage(b: torch.Tensor, n1: int, inverse: bool,
                  dbl: bool) -> torch.Tensor:
    """The four-step's n1-point DFT over r of b[.., r, k2], returned as
    [.., k1, k2]: bin k1 n2 + k2 in natural order. Where it is one direct
    product, it contracts r where it lies (F1 is symmetric, so it is
    ``F1 @ b``, the sums of the JAX package's product on the swapped
    array), so no swap back is needed; else b swaps, ``_fft_last`` runs
    and its result swaps back."""
    st = current_settings()
    if n1 <= st.direct_max and not (st.radix2 and n1 > _R2_BASE
                                    and n1 % 2 == 0):
        return _matmul_F(b, ("dft", n1, inverse, dbl), left=True)
    return _fft_last(b.transpose(-1, -2), inverse).transpose(-1, -2)


def _c2r_last(c: torch.Tensor, n: int) -> torch.Tensor:
    """Unnormalized C2R along the last axis of a half spectrum (n//2+1 ->
    n, real): the folded (CR, CI) products up to ``direct_max``, else the
    Hermitian extension's complex inverse."""
    if n <= current_settings().direct_max:
        dbl = _is_double(c.dtype)
        prec = _prec_for(c.dtype)
        return (_mm(c.real, ("c2r", n, dbl, 0), "c", prec)
                - _mm(c.imag, ("c2r", n, dbl, 1), "c", prec))
    return _extended_c2r(c, n)


def _extended_c2r(c: torch.Tensor, n: int) -> torch.Tensor:
    """The real part of the inverse DFT of the Hermitian extension."""
    return _fft_last(_hermitian_extend(c, n), True).real


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


def rows(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
         n_out: int, dtype: torch.dtype) -> torch.Tensor:
    """``fn`` along the last axis of ``x`` (any layout), as (rows, n) in
    groups of at most ``CHUNK_BYTES`` of input, written into one new
    contiguous (.., n_out) tensor of ``dtype``. One dispatch of the
    backend (``DISPATCHES``)."""
    _count()
    lead, n = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, n)
    m = x2.shape[0]
    step = max(1, CHUNK_BYTES // max(1, n * x2.element_size()))
    if m <= step:
        return fn(x2).reshape(lead + (n_out,)).contiguous()
    out = torch.empty((m, n_out), dtype=dtype, device=x.device)
    for i in range(0, m, step):
        out[i:i + step] = fn(x2[i:i + step])
    return out.reshape(lead + (n_out,))


# ---------------------------------------------------------------------------
# Norm scaling (same FFTNorm semantics as ops/fft.py)
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# Public API (mirrors ops/fft.py signatures)
# ---------------------------------------------------------------------------


def _complex_of(x: torch.Tensor) -> torch.dtype:
    return torch.complex128 if _is_double(x.dtype) else torch.complex64


def _real_of(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if _is_double(x.dtype) else torch.float32


def _c2c(x: torch.Tensor, axis: int, inverse: bool,
         norm: FFTNorm) -> torch.Tensor:
    cdt = _complex_of(x)
    x = x.to(cdt).movedim(axis, -1)
    n = x.shape[-1]
    y = rows(lambda r: _fft_last(r, inverse), x, n, cdt)
    s = _inv_scale(n, norm) if inverse else _fwd_scale(n, norm)
    return _scaled(y, s).movedim(-1, axis)


def fft(x: torch.Tensor, axis: int, norm: FFTNorm = FFTNorm.NONE
        ) -> torch.Tensor:
    return _c2c(x, axis, False, norm)


def ifft(x: torch.Tensor, axis: int, norm: FFTNorm = FFTNorm.NONE
         ) -> torch.Tensor:
    return _c2c(x, axis, True, norm)


def rfft(x: torch.Tensor, axis: int, norm: FFTNorm = FFTNorm.NONE
         ) -> torch.Tensor:
    x = x.to(_real_of(x)).movedim(axis, -1)
    n = x.shape[-1]
    y = rows(_rfft_last, x, n // 2 + 1, _complex_of(x))
    return _scaled(y, _fwd_scale(n, norm)).movedim(-1, axis)


def _c2r(x: torch.Tensor, n: int, axis: int, norm: FFTNorm,
         fn: Callable[[torch.Tensor, int], torch.Tensor]) -> torch.Tensor:
    c = x.to(_complex_of(x)).movedim(axis, -1)
    # numpy's irfft contract: the spectral axis is cropped or zero-padded
    # to n//2+1 before the inversion.
    c = _fit_axis(c, -1, n // 2 + 1)
    y = rows(lambda r: fn(r, n), c, n, _real_of(c))
    return _scaled(y, _inv_scale(n, norm)).movedim(-1, axis)


def irfft(x: torch.Tensor, n: int, axis: int, norm: FFTNorm = FFTNorm.NONE
          ) -> torch.Tensor:
    return _c2r(x, n, axis, norm, _c2r_last)


def irfft_extended(x: torch.Tensor, n: int, axis: int,
                   norm: FFTNorm = FFTNorm.NONE) -> torch.Tensor:
    """``irfft`` as the real part of the Hermitian extension's complex
    inverse at every length (the ``"pallas"`` backend's double-precision
    C2R, ``pallas_fft.irfft``'s fallback branch): no folded C2R matrices."""
    return _c2r(x, n, axis, norm, _extended_c2r)


def fftn(x: torch.Tensor, axes: Sequence[int],
         norm: FFTNorm = FFTNorm.NONE) -> torch.Tensor:
    for a in axes:
        x = fft(x, axis=a, norm=norm)
    return x


def ifftn(x: torch.Tensor, axes: Sequence[int],
          norm: FFTNorm = FFTNorm.NONE) -> torch.Tensor:
    for a in axes:
        x = ifft(x, axis=a, norm=norm)
    return x


def rfftn_3d(x: torch.Tensor, norm: FFTNorm = FFTNorm.NONE) -> torch.Tensor:
    c = rfft(x, axis=-1, norm=norm)
    c = fft(c, axis=-2, norm=norm)
    return fft(c, axis=-3, norm=norm)


def irfftn_3d(x: torch.Tensor, shape_3d: Tuple[int, int, int],
              norm: FFTNorm = FFTNorm.NONE) -> torch.Tensor:
    c = ifft(_fit_axis(x, -3, shape_3d[-3]), axis=-3, norm=norm)
    c = ifft(_fit_axis(c, -2, shape_3d[-2]), axis=-2, norm=norm)
    return irfft(c, n=shape_3d[-1], axis=-1, norm=norm)


# ---------------------------------------------------------------------------
# All-real-planes 3D transform: the same DFT products with the complex
# arithmetic written out on separate (re, im) float32 planes, so no complex
# dtype appears anywhere. Direct sizes only (every axis <= DIRECT_MAX).
# ---------------------------------------------------------------------------


def _rp_dot(a: torch.Tensor, key: tuple, part: str,
            axis: int) -> torch.Tensor:
    """Contract ``axis`` of a 3D real tensor with the real constant (a DFT
    matrix's part: symmetric, so the left product is the contraction)."""
    prec = _prec_for(a.dtype)
    if axis == 2:
        return _mm(a, key, part, prec)
    if axis == 1:
        return _mm(a, key, part, prec, left=True)
    n = a.shape[0]
    return _mm(a.reshape(n, -1), key, part, prec,
               left=True).reshape((-1,) + a.shape[1:])


def _rp_stage(ar: torch.Tensor, ai: Optional[torch.Tensor], key: tuple,
              axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One DFT stage along ``axis`` of split-plane data (``ai=None``: real
    input)."""
    def e(part, a):
        return _rp_dot(a, key, part, axis)

    if ai is None:
        return e("re", ar), e("im", ar)
    return e("re", ar) - e("im", ai), e("re", ai) + e("im", ar)


def _direct_only(shape3, what: str) -> None:
    for n in shape3:
        if n > DIRECT_MAX:
            raise ValueError(f"{what} is direct-size only (axis {n} > "
                             f"{DIRECT_MAX})")


def rfftn_3d_planes(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unnormalized forward R2C over a REAL 3D float32 tensor, returned as
    (re, im) float32 planes of shape (X, Y, Z//2+1)."""
    X, Y, Z = x.shape
    _direct_only(x.shape, "rfftn_3d_planes")
    ar, ai = _rp_stage(x.to(torch.float32), None, ("rdft", Z, False), 2)
    ar, ai = _rp_stage(ar, ai, ("dft", Y, False, False), 1)
    return _rp_stage(ar, ai, ("dft", X, False, False), 0)


def irfftn_3d_planes(cr: torch.Tensor, ci: torch.Tensor,
                     shape_3d: Tuple[int, int, int]) -> torch.Tensor:
    """Unnormalized inverse of ``rfftn_3d_planes``: (re, im) spectral planes
    of shape (X, Y, Z//2+1) -> real float32 (X, Y, Z)."""
    X, Y, Z = shape_3d
    _direct_only(shape_3d, "irfftn_3d_planes")
    er, ei = _rp_stage(cr, ci, ("dft", X, True, False), 0)
    er, ei = _rp_stage(er, ei, ("dft", Y, True, False), 1)
    prec = _prec_for(er.dtype)
    return (_mm(er, ("c2r", Z, False, 0), "c", prec)
            - _mm(ei, ("c2r", Z, False, 1), "c", prec))


# ---------------------------------------------------------------------------
# The four-step factorisation (shared with ops/hopper_fft.py)
# ---------------------------------------------------------------------------


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
