"""Hand-written Hopper kernels of the ``"pallas"`` FFT backend.

The counterpart of the JAX package's ``ops/pallas_fft.py``, at two
granularities:

* **fused 3D path** (``csrc/fused3d.cu``): at direct sizes (every axis in
  [2, 512]) a single-device 3D R2C is two kernels and its C2R inverse two
  more — forward ``zy_fwd`` (z-R2C then y-C2C per x-row) then
  ``x_c2c``; inverse ``x_c2c`` then ``yz_inv`` (y-C2C inverse then the
  half-spectrum z-C2R). Complex data crosses these kernels as split
  float32 (real, imag) planes. ``zy_fwd`` and ``yz_inv`` pick their body
  by ``_zy_engine_body(Y, Z)``: three launches through a complex64 scratch
  (``zy_fwd``: the row FFT engine on the z rows into the scratch, the
  engine on the scratch's y rows in place, a transpose into the planes;
  ``yz_inv`` the same backwards, its z pass kernel 3's C2R Body) when Y
  and Z are each an engine length in [8, 512] with Y even (the engine's
  power-of-two kernel when both are powers of two, ``_zy_body``, else its
  mixed-radix kernel), else the dense kernel. ``x_c2c`` picks its
  body by ``_x_body(X)``: for a power of two in [8, 512] the column kernel
  of the row FFT engine, for one of ``MIXED_LENGTHS`` its mixed-radix
  column kernel, each reading kernel 6's planes and writing the complex64
  spectrum (forward) or reading the spectrum and writing kernel 8's planes
  (inverse); else the dense kernel on planes.
* **per-axis path** (``csrc/stage.cu``): one kernel launch is one DFT
  stage along the last axis, ``y = x @ F`` on rows of interleaved complex
  (or real) data, optionally with the four-step twiddle fused into its
  epilogue, plus the half-spectrum C2R. ``fft``/``ifft``/``rfft``/
  ``irfft`` dispatch as ``pallas_fft._fft_last`` / ``_rfft_last`` do,
  but for the engine's lengths. ``fft`` / ``ifft`` of a contiguous tensor
  along a non-last axis whose length the engine takes run one
  ``cdft_cols`` (kernel 2's column body) where the axis lies; any other
  axis moves last first. On the last axis: one direct stage
  (``cdft`` / ``rdft``, kernels 2 and 1) up to 512 points, for a power of
  two up to 1024 and for a prime up to 1024, else the four-step split of
  ``mxu_fft._split_for`` (the JAX package splits every axis past 512,
  where the TPU's direct matmul stops): one swap, the first stage
  ``cdft_tw`` or ``rdft_tw`` on rows, the second (n1 = 2..16 points)
  ``cdft_short`` (kernel 2's short-stage body) on columns where the first
  left them, its bins stored in natural order or as the R2C crop. A
  non-last split axis of a contiguous complex64 tensor runs its
  four-step where it lies: ``cdft_tw_cols`` (kernel 4's column body)
  then ``cdft_short`` storing into the input's layout. ``irfft`` takes one
  ``irdft`` (kernel 3) on the same direct lengths; past them an even n is
  the complex inverse of n / 2 points of a packed spectrum: one
  ``irdft_packed`` (kernel 3's packed body) where the engine takes n / 2,
  else ``c2r_pack`` (kernel 3's pack pass) and the complex inverse; an odd
  n keeps the Hermitian extension and a complex inverse. This path
  carries every distributed plan and every single-device cube the fused
  path does not take.
* **fused wire** (``csrc/wire.cu``): the bf16 wire of the ring exchanges
  (``parallel/transpose.ring_transpose``) as kernels — ``enc_pack``
  encodes a travelling block, ``dec_unpack`` decodes an arrived one, and
  ``dec_cmatmul`` decodes it straight into the first per-block DFT. The
  hooks ``fused_ring_hooks`` / ``decode_fft_fused`` plug them into a ring.
* **row FFT engine** (``csrc/fft_rows.cuh``): the body of ``rdft``
  (kernel 1), ``cdft`` (kernel 2), ``irdft`` (kernel 3), ``cdft_tw``
  (kernel 4), ``rdft_tw`` (kernel 5) and ``dec_cmatmul`` (kernel 11) on
  rows of a power of two in [8, 1024], and, on its mixed-radix kernel, of
  ``rdft``, ``cdft``, ``irdft``, ``cdft_tw`` and ``rdft_tw`` on the 155
  13-smooth lengths in [9, 507] (``MIXED_LENGTHS``; kernel 11 routes by
  ``_fft_body``, kernels 1-5 by ``_cdft_body``), and of ``irdft_packed``
  (kernel 3's packed body) on half rows of either; other lengths take the
  dense bodies of ``stage.cu``. It also runs the two FFT passes
  of the FFT bodies of ``zy_fwd`` (kernel 6) and ``yz_inv`` (kernel 8), and,
  as its column kernel, ``x_c2c`` (kernel 7), ``cdft_cols`` (kernel 2
  on a non-last axis) and ``cdft_tw_cols`` (kernel 4 on a non-last split
  axis), and as its mixed-radix column kernel ``x_c2c`` on the
  ``MIXED_LENGTHS``; its short-stage kernel, on the column kernel's
  loader, is ``cdft_short``. ``fft_plan`` is its host side.

Each kernel has here:

* a wrapper, which checks device, dtype, shape and contiguity, allocates
  the outputs with ``torch.empty`` and launches on the current stream;
* its plain PyTorch version (``*_plain``), the same arithmetic as dense
  products. The wrapper takes it only for tensors on the CPU; for a CUDA
  tensor it launches the kernel or raises;
* a launch count in ``LAUNCHES``, raised by one per kernel launch;
* an autograd boundary (``_no_vjp``): a gradient through the wrapper
  raises ``NotImplementedError``, on the card and on the CPU, as
  ``jax.grad`` through a Pallas kernel does.

Double precision, and a prime axis above ``mxu_fft.N_MAX``, take the
matmul backend (``ops/mxu_fft.py``), as ``pallas_fft._use_fallback`` and its
prime branches route them in the JAX package; each such axis counts one
in ``DISPATCHES["matmul"]`` (the backend's own counter), never in
``LAUNCHES``; a gradient flows through them, as through the JAX
package's jnp route.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..params import FFTNorm
from . import _build
from . import mxu_fft as mx

# Kernel launches since the last ``reset_launches()``.
LAUNCHES: Dict[str, int] = {
    "zy_fwd": 0, "x_c2c": 0, "yz_inv": 0,                   # fused3d.cu
    "rmatmul": 0, "cmatmul": 0, "c2r": 0, "cmatmul_tw": 0,  # stage.cu
    "rmatmul_tw": 0,
    "enc_pack": 0, "dec_unpack": 0, "dec_cmatmul": 0}       # wire.cu

# Launches of each C entry point (the body each kernel ran) since the last
# ``reset_launches()``.
ENTRIES: Dict[str, int] = {}

# Callables ``hook(kernel, entry, args)`` that ``_launch`` calls before each
# launch (the op recorder of ``analysis/opscan.py``: a ctypes launch is not
# a dispatched op). Empty unless a recorder is active.
LAUNCH_HOOKS: list = []

# Entry points: library (csrc/<name>.cu), (pointer arguments, int
# arguments[, 64-bit int arguments]).
_ENTRIES = {"dfft_zy_fwd": ("fused3d", (7, 3)),
            "dfft_zy_rows": ("fused3d", (3, 4)),
            "dfft_zy_cols": ("fused3d", (2, 4)),
            "dfft_zy_planes": ("fused3d", (3, 3)),
            "dfft_x_c2c": ("fused3d", (6, 2)),
            "dfft_x_cols": ("fused3d", (5, 4)),
            "dfft_x_mixed": ("fused3d", (5, 4)),
            "dfft_yz_inv": ("fused3d", (7, 3)),
            "dfft_yz_scratch": ("fused3d", (3, 3)),
            "dfft_yz_cols": ("fused3d", (2, 4)),
            "dfft_yz_rows": ("fused3d", (3, 4)),
            "dfft_stage": ("stage", (6, 6)),
            "dfft_rdft_tw": ("stage", (5, 4)),
            "dfft_cdft_tw": ("stage", (5, 5)),
            "dfft_cdft": ("stage", (3, 4)),
            "dfft_cdft_cols": ("stage", (4, 5)),
            "dfft_cdft_tw_cols": ("stage", (5, 6)),
            "dfft_cdft_short": ("stage", (3, 5, 4)),
            "dfft_rdft": ("stage", (3, 3)),
            "dfft_c2r": ("stage", (3, 3)),
            "dfft_c2r_packed": ("stage", (4, 3)),
            "dfft_c2r_pack": ("stage", (3, 3)),
            "dfft_enc_pack": ("wire", (2, 6)),
            "dfft_dec_unpack": ("wire", (2, 1)),
            "dfft_dec_cmatmul": ("wire", (4, 2)),
            "dfft_dec_fft": ("wire", (3, 4))}

# Per-axis transforms handed to the matmul backend (the same dict as
# ``mxu_fft.DISPATCHES``).
DISPATCHES = mx.DISPATCHES


def reset_launches() -> None:
    """Set every kernel's launch count, the entry points' and the matmul
    dispatches to 0."""
    for d in (LAUNCHES, DISPATCHES):
        for k in d:
            d[k] = 0
    ENTRIES.clear()


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


@functools.lru_cache(maxsize=None)
def _twiddle_planes(n1: int, n2: int, inverse: bool,
                    device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Four-step twiddle T[r, k2] (n1, n2) as float32 planes. The kernel
    indexes it by ``row % n1`` directly, so it is not tiled to a row block
    as the TPU kernel's is (``pallas_fft._tiled_twiddle``)."""
    t = mx._twiddle_np(n1, n2, inverse, False)
    return (torch.from_numpy(np.ascontiguousarray(t.real)).to(device),
            torch.from_numpy(np.ascontiguousarray(t.imag)).to(device))


@functools.lru_cache(maxsize=None)
def _twiddle(n1: int, n2: int, inverse: bool,
             device: torch.device) -> torch.Tensor:
    """The same twiddle as one complex64 tensor (the unfused branch)."""
    return torch.from_numpy(mx._twiddle_np(n1, n2, inverse, False)).to(device)


@functools.lru_cache(maxsize=None)
def half_roots(n: int) -> np.ndarray:
    """(2, n / 2) float32 planes of exp(+2 pi i k / n), k < n / 2, built in
    float64: the half-step twiddle of the packing of an even-n C2R
    (``_packed_spectrum``), which kernel 3's packed body and its pack pass
    read. Not the n / 2-point engine table: these are roots of n."""
    w = np.exp(2j * np.pi * np.arange(n // 2) / n)
    return np.ascontiguousarray(np.stack([w.real, w.imag]), np.float32)


@functools.lru_cache(maxsize=None)
def _half_roots(n: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(half_roots(n)).to(device)


# ---------------------------------------------------------------------------
# The row FFT engine of kernels 1-6, 8 and 11 (csrc/fft_rows.cuh): its
# host side
# ---------------------------------------------------------------------------

# Row lengths the engine's power-of-two kernel takes: the powers of two in
# [FFT_MIN, FFT_MAX].
FFT_MIN, FFT_MAX = 8, 1024

# The engine's mixed-radix kernel (``fft_mixed_kernel`` in fft_rows.cuh):
# the butterflies it has (``MIXED_RADICES``), the most points a batch holds
# (``MIXED_POINTS``), threads a block (``THREADS``), the longest row
# (``MIXED_MAX``), the first bit of its schedule's rows field
# (``MIXED_ROWS_SHIFT``, past 4 passes of 5 bits), its ring of input
# buffers (``STAGES``) and the most shared memory a block takes
# (``MIXED_SMEM``: two blocks an SM of an H100). It runs the 13-smooth
# lengths 2^a 3^b 5^c 7^d 11^e 13^f in [FFT_MIN, MIXED_MAX] that are not
# powers of two (``MIXED_LENGTHS``, 155 of them: kernels 1-6 and 8 on rows,
# kernel 3's packed body on half rows of m = n / 2 of them, and kernel 7 on
# its column form), and, beside them on the passes of kernels 6 and 8, the
# powers of two up to MIXED_MAX.
MIXED_RADICES = (16, 15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2)
MIXED_POINTS = 2560
MIXED_MAX = 512
THREADS = 256
MIXED_ROWS_SHIFT = 20
STAGES = 3
MIXED_SMEM = 115712


def _smooth(n: int, primes: Sequence[int]) -> bool:
    """Whether n has no prime factor but ``primes``."""
    for p in primes:
        while n > 1 and n % p == 0:
            n //= p
    return n == 1


MIXED_LENGTHS = tuple(n for n in range(FFT_MIN, MIXED_MAX + 1)
                      if _smooth(n, (2, 3, 5, 7, 11, 13)) and n & (n - 1))


def _fft_body(n: int) -> str:
    """The body kernel 11 runs on rows of n points: ``"fft"`` (the row FFT
    engine's power-of-two kernel) for a power of two in [FFT_MIN,
    FFT_MAX], else ``"tile"`` (the dense body of ``wire.cu`` with the DFT
    planes). Kernels 1-5 on rows route by ``_cdft_body``; the column,
    short-stage and fused bodies read this too."""
    return "fft" if FFT_MIN <= n <= FFT_MAX and n & (n - 1) == 0 else "tile"


def _engine_length(n: int) -> bool:
    """Whether the row FFT engine runs rows of n points: a power of two in
    [FFT_MIN, FFT_MAX] or one of ``MIXED_LENGTHS``."""
    return _fft_body(n) == "fft" or n in MIXED_LENGTHS


def _cdft_body(n: int) -> str:
    """The body kernels 1 (``rdft``), 2 (``cdft``), 3 (``irdft``), 4
    (``cdft_tw``) and 5 (``rdft_tw``) run on rows of n points: ``"fft"``
    (the row FFT engine: its power-of-two kernel, or its mixed-radix kernel
    for a 13-smooth n) where ``_engine_length(n)``, else ``"tile"`` (the
    tile loop of ``stage.cu`` with the R2C, DFT or C2R planes, or for
    kernels 1, 2 and 3 on rows of a few points the row path). This routes
    the ``_direct`` lengths; past them an even-n C2R takes kernel 3's
    packed body on rows of n / 2 (``irdft_packed``, where
    ``_engine_length(n // 2)``) or its pack pass (``c2r_pack``)."""
    return "fft" if _engine_length(n) else "tile"


def _zy_body(Y: int, Z: int) -> str:
    """Which of the engine's kernels the FFT bodies of kernels 6 and 8
    (``_zy_engine_body``) run both passes on: ``"fft"`` (the power-of-two
    kernel) when Y and Z are both powers of two in [FFT_MIN,
    ``mx.DIRECT_MAX``], else ``"dense"`` (the mixed-radix kernel where
    ``_zy_engine_body`` says "fft", the dense-product ``zy_fwd_kernel`` /
    ``yz_inv_kernel`` where it says "dense")."""
    return ("fft" if all(_fft_body(n) == "fft" and n <= mx.DIRECT_MAX
                         for n in (Y, Z)) else "dense")


def _zy_engine_body(Y: int, Z: int) -> str:
    """The body kernels 6 (``zy_fwd``) and 8 (``yz_inv``) run on (X, Y,
    Z): ``"fft"`` (the engine's two passes and a transpose) when Y and Z
    are each an engine length (``_engine_length``) in [FFT_MIN,
    ``mx.DIRECT_MAX``] and Y is even: the power-of-two kernel on both
    passes where ``_zy_body`` says "fft", else the mixed-radix kernel on
    both (kernel 6's z pass stores, and kernel 8's gathers, the half
    spectra of two neighbouring y as one 16-byte vector, so a pair of rows
    must not straddle two x-planes); else ``"dense"``: an odd Y, or a
    length with a prime factor past 13 (``fused3d.cu``'s ``zy_mixed_ok``,
    the same predicate)."""
    return ("fft" if Y % 2 == 0 and all(
        _engine_length(n) and n <= mx.DIRECT_MAX for n in (Y, Z))
        else "dense")


def _x_body(X: int) -> str:
    """The body kernel 7 runs on (X, Ky, Zo): ``"fft"`` for an engine
    length in [FFT_MIN, ``mx.DIRECT_MAX``] (the column kernel of the row
    FFT engine for a power of two, its mixed-radix column kernel for one of
    ``MIXED_LENGTHS``), else ``"dense"`` (the dense-product
    ``x_c2c_kernel``: a prime factor past 13, or X < 8). A pure function of
    X."""
    return "fft" if _engine_length(X) and X <= mx.DIRECT_MAX else "dense"


# Threads a block of the column kernels (``COL_THREADS`` in fft_rows.cuh)
# and the most points a batch of the mixed-radix column kernel holds
# (``COL_POINTS``: 16 a thread).
COL_THREADS = 512
COL_POINTS = 16 * COL_THREADS


class ColGeometry(NamedTuple):
    """The column kernel's batch on columns of n points (``ColGeometry``
    in fft_rows.cuh): ``width`` columns a batch, every point-row of it one
    strip of ``width`` contiguous elements, in ``halves`` buffers (2 at n =
    1024: the split kernel, each half of the rows a 512-point FFT); each
    thread holds ``points`` (16, or n below 16) of one column of each
    half, ``threads`` threads a column (``COL_THREADS = width *
    threads``)."""
    points: int
    threads: int
    width: int
    halves: int


def cols_geometry(n: int) -> ColGeometry:
    if _fft_body(n) != "fft":
        raise ValueError(f"the column kernel takes a power of two in "
                         f"[{FFT_MIN}, {FFT_MAX}], not {n}")
    halves = 2 if n == FFT_MAX else 1
    m = n // halves                       # points of one FFT
    pt = min(m, 16)
    return ColGeometry(pt, m // pt, COL_THREADS * pt // m, halves)


class ColsPlan(NamedTuple):
    """What the column kernel runs on columns of n points: the engine's
    plan of each FFT (n points, or 512 for the split kernel at n =
    1024), and for the split kernel the radix-2 split's
    twiddles w^i = exp(-+ 2 pi i i / n), i < n / 2, as (2, n / 2) float32
    planes built in float64 (else None)."""
    plan: FFTPlan
    split: Optional[np.ndarray]


@functools.lru_cache(maxsize=None)
def cols_plan(n: int, inverse: bool) -> ColsPlan:
    if cols_geometry(n).halves == 1:
        return ColsPlan(fft_plan(n, inverse), None)
    w = np.exp((1.0 if inverse else -1.0) * 2j * np.pi * np.arange(n // 2) / n)
    return ColsPlan(fft_plan(n // 2, inverse),
                    np.ascontiguousarray(np.stack([w.real, w.imag]),
                                         np.float32))


@functools.lru_cache(maxsize=None)
def _cols_tables(n: int, inverse: bool, device: torch.device):
    """(table, split or None) of ``cols_plan`` on ``device``."""
    cp = cols_plan(n, inverse)
    return (torch.from_numpy(cp.plan.table).to(device),
            None if cp.split is None else torch.from_numpy(cp.split).to(device))


def mixed_cols_width(n: int) -> int:
    """Columns a batch of the mixed-radix column kernel on columns of n
    points (one of ``MIXED_LENGTHS``): the largest power of two W in [16,
    ``COL_THREADS``] with W n <= ``COL_POINTS``, so each point-row of a
    batch is a strip of at least 128 bytes of complex64 (W = 16 for every n
    past 256) and three buffers of 8 W n bytes fit a block (``col_plan``
    in fft_rows.cuh)."""
    if n not in MIXED_LENGTHS:
        raise ValueError(f"the mixed-radix column kernel takes one of "
                         f"MIXED_LENGTHS, not {n}")
    return min(COL_THREADS, 1 << ((COL_POINTS // n).bit_length() - 1))


def mixed_cols_schedule(n: int, inverse: bool) -> int:
    """The packed schedule the mixed-radix column kernel takes on columns
    of n points (``col_plan`` in fft_rows.cuh): ``fft_plan(n,
    inverse).schedule`` and, from bit ``MIXED_ROWS_SHIFT`` on, the columns
    of a batch (``mixed_cols_width``)."""
    return (fft_plan(n, inverse).schedule
            | mixed_cols_width(n) << MIXED_ROWS_SHIFT)


def _zy_scratch_shape(X: int, Y: int, Z: int) -> Tuple[int, int, int]:
    """The complex64 scratch of the FFT bodies of kernels 6 and 8: (X,
    Z // 2 + 1, Y), column zo of plane x one contiguous row, so the y pass
    runs on rows and the transposes read and write whole plane rows."""
    return (X, Z // 2 + 1, Y)


class FFTPlan(NamedTuple):
    """What the engine runs on rows of n points.

    radices: the Stockham passes in order. For a power of two ceil(log2 n
        / 4) of them, the log2 n bits split as evenly as possible, larger
        radices first (1024 = 16 * 8 * 8, 512 = 8 * 8 * 8); for a mixed
        length (``MIXED_LENGTHS``) the fewest passes of ``MIXED_RADICES``
        whose batch (``mixed_geometry``) leaves the fewest lanes idle,
        larger radices first (480 = 12 * 10 * 4, 320 = 10 * 8 * 4, 448 =
        8 * 8 * 7, 416 = 16 * 13 * 2, 440 = 11 * 10 * 4);
    schedule: the radices packed as the kernel checks them, the radix of
        pass p in bits 5p .. 5p + 4;
    table: (2, n - radices[0]) float32 (real, imag) twiddles, built in
        float64: for each pass p > 0 in order, with NS the product of the
        radices before it and r its radix, a block of (r - 1) x NS entries
        exp(-+ 2 pi i m k / (NS r)) at [m - 1, k] (sign + for the inverse),
        so that neighbouring threads (neighbouring k) read neighbouring
        entries."""
    radices: Tuple[int, ...]
    schedule: int
    table: np.ndarray


def _lane_use(n: int, radices: Sequence[int], rows: int) -> Tuple[int, int]:
    """(points transformed, lane slots spent) by the mixed-radix kernel's
    passes on a batch of ``rows`` rows of n points: a pass of radix r runs
    rows n / r butterflies over the block's ``THREADS`` lanes in
    ceil(rows n / (r THREADS)) rounds of r points a lane."""
    pts = rows * n
    slots = sum(THREADS * -(-pts // (r * THREADS)) * r for r in radices)
    return len(radices) * pts, slots


def _stage_bytes(n: int, rows: int, half: bool = False,
                 packed: bool = False) -> int:
    """Bytes of one input buffer of the mixed-radix kernel on batches of
    ``rows`` rows of n points (each Body's ``stage_bytes(g)``): 8 rows n
    (complex rows, or twice as many real rows), for kernel 3's half
    spectra (``half``) 16 rows (n // 2 + 1), two half rows of n // 2 + 1
    bins a complex row, or for its packed body (``packed``) 8 rows (n +
    1), one half row of n + 1 bins a complex row of n points."""
    if half:
        return 16 * rows * (n // 2 + 1)
    return 8 * rows * (n + 1) if packed else 8 * rows * n


def mixed_smem(n: int, r0: int, rows: int, half: bool = False,
               packed: bool = False) -> int:
    """Shared memory a block of the mixed-radix kernel takes on batches of
    ``rows`` rows of n points, r0 the first radix (``mixed_smem`` in
    fft_rows.cuh): the ring's barriers (128 bytes), the twiddle table's
    two planes of n - r0 floats rounded up to 4, ``STAGES`` input buffers
    (``_stage_bytes``) and two pairs of work planes of rows n + rows n //
    32 floats."""
    points = rows * n
    tld = (n - r0 + 3) & ~3
    return (128 + 8 * tld + STAGES * _stage_bytes(n, rows, half, packed)
            + 16 * (points + points // 32))


def _batch_rows(n: int, radices: Sequence[int], half: bool = False,
                packed: bool = False) -> int:
    """Rows a batch of the mixed-radix kernel: the count, at most
    ``MIXED_POINTS`` / n, with rows n even (16-byte aligned batches) and
    the block within ``MIXED_SMEM`` (``mixed_smem``; ``half``: kernel 3's
    larger buffers, which cap the rows of the shortest lengths;
    ``packed``: its packed body's rows of n + 1 bins, an even count of
    them so that every batch starts 16-byte aligned), whose passes leave
    the smallest share of lane slots idle, the larger count on a tie. The
    kernel takes it from ``mixed_schedule``."""
    best, best_use = 2, (0, 1)
    for rows in range(1, MIXED_POINTS // n + 1):
        if rows * n % 2 or packed and rows % 2 or \
                mixed_smem(n, radices[0], rows, half, packed) > MIXED_SMEM:
            continue
        used, slots = _lane_use(n, radices, rows)
        if used * best_use[1] >= best_use[0] * slots:
            best, best_use = rows, (used, slots)
    return best


def _mixed_radices(n: int) -> Tuple[int, ...]:
    """The passes of a mixed length: every factorization of n into
    ``MIXED_RADICES`` with the fewest factors (3 at most below 513),
    larger radices first; of those the one whose batch leaves the
    smallest share of lanes idle, the larger radices on a tie."""
    found = set()

    def split(m, pre):
        if m == 1:
            found.add(tuple(sorted(pre, reverse=True)))
        elif len(pre) < 4:
            for r in MIXED_RADICES:
                if m % r == 0:
                    split(m // r, pre + [r])

    split(n, [])
    fewest = min(len(f) for f in found)

    def use(radices):
        used, slots = _lane_use(n, radices, _batch_rows(n, radices))
        return used / slots, radices

    return max((f for f in found if len(f) == fewest), key=use)


class MixedGeometry(NamedTuple):
    """The mixed-radix kernel's batch on rows of n points: ``rows`` rows
    (``points`` = rows n), and the share of its lane slots the passes
    leave idle (the rounds' last lanes past rows n / r butterflies)."""
    rows: int
    points: int
    idle: float


def mixed_geometry(n: int) -> MixedGeometry:
    rows = mixed_schedule(n, False) >> MIXED_ROWS_SHIFT
    used, slots = _lane_use(n, fft_plan(n, False).radices, rows)
    return MixedGeometry(rows, rows * n, 1 - used / slots)


def _engine_schedule(n: int, inverse: bool, half: bool = False,
                     packed: bool = False) -> int:
    """The schedule an engine length's rows launch with: ``fft_plan``'s for
    a power of two (the power-of-two kernel), else ``mixed_schedule``
    (``half``: kernel 3's; ``packed``: kernel 3's packed body's)."""
    return (fft_plan(n, inverse).schedule if _fft_body(n) == "fft"
            else mixed_schedule(n, inverse, half, packed))


def mixed_schedule(n: int, inverse: bool, half: bool = False,
                   packed: bool = False) -> int:
    """The packed schedule the mixed-radix kernel takes on rows of n points
    (``mixed_plan`` in fft_rows.cuh): ``fft_plan(n, inverse).schedule``
    and, from bit ``MIXED_ROWS_SHIFT`` on, the rows of a batch
    (``_batch_rows``; ``half`` for kernel 3's Body, ``packed`` for its
    packed body), so the rows that run are the ones chosen here."""
    plan = fft_plan(n, inverse)
    return plan.schedule | (_batch_rows(n, plan.radices, half, packed)
                            << MIXED_ROWS_SHIFT)


@functools.lru_cache(maxsize=None)
def fft_plan(n: int, inverse: bool) -> FFTPlan:
    if _fft_body(n) == "fft":
        bits = n.bit_length() - 1
        passes = (bits + 3) // 4
        radices = tuple(1 << (bits // passes + (p < bits % passes))
                        for p in range(passes))
    elif n in MIXED_LENGTHS:
        radices = _mixed_radices(n)
    else:
        raise ValueError(f"the row FFT engine takes a power of two in "
                         f"[{FFT_MIN}, {FFT_MAX}] or a 13-smooth length in "
                         f"[{FFT_MIN}, {MIXED_MAX}], not {n}")
    schedule = sum(r << (5 * p) for p, r in enumerate(radices))
    sign = 1.0 if inverse else -1.0
    blocks, ns = [np.zeros(0)], radices[0]
    for r in radices[1:]:
        mk = np.outer(np.arange(1, r), np.arange(ns))
        blocks.append(np.exp(sign * 2j * np.pi * mk / (ns * r)).ravel())
        ns *= r
    w = np.concatenate(blocks)
    table = np.ascontiguousarray(np.stack([w.real, w.imag]), np.float32)
    return FFTPlan(radices, schedule, table)


@functools.lru_cache(maxsize=None)
def _fft_table(n: int, inverse: bool, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(fft_plan(n, inverse).table).to(device)


# cos and sin of 2 pi m / 16 in float32: the constants of the kernel's
# in-register radix-2 networks (``cos16`` / ``sin16`` in fft_rows.cuh).
_C16 = np.cos(2 * np.pi * np.arange(8) / 16).astype(np.float32)
_S16 = np.sin(2 * np.pi * np.arange(8) / 16).astype(np.float32)


def _dft_regs_mirror(a: torch.Tensor, inverse: bool) -> torch.Tensor:
    """The kernel's radix-r DFT along dim -2 of (..., r, B) complex64: the
    radix-2 network on bit-reversed input (``dft_regs``)."""
    r = a.shape[-2]
    bits = r.bit_length() - 1
    rev = [int(format(i, f"0{bits}b")[::-1], 2) if bits else 0
           for i in range(r)]
    b = list(a[..., rev, :].unbind(-2))
    half = 1
    while half < r:
        for i in range(0, r, 2 * half):
            for k in range(half):
                m = k * (8 // half)
                v = b[i + k + half]
                if m:
                    s = _S16[m] if inverse else -_S16[m]
                    v = v * complex(_C16[m], s)
                u = b[i + k]
                b[i + k], b[i + k + half] = u + v, u - v
        half *= 2
    return torch.stack(b, -2)


def _f32(x: float) -> float:
    return float(np.float32(x))


# Constants of the kernel's odd prime butterflies (``dft3``, ``dft5``,
# ``dft7``, ``dft11``, ``dft13`` in fft_rows.cuh), float32: sin 2 pi / 3,
# cos and sin of 2 pi m / 5, m = 1, 2, of 2 pi m / 7, m = 1, 2, 3, of 2 pi
# m / 11, m = 1 .. 5, and of 2 pi m / 13, m = 1 .. 6.
_S3 = _f32(np.sin(2 * np.pi / 3))
_C5 = (_f32(np.cos(2 * np.pi / 5)), _f32(np.cos(4 * np.pi / 5)))
_S5 = (_f32(np.sin(2 * np.pi / 5)), _f32(np.sin(4 * np.pi / 5)))
_C7 = tuple(_f32(np.cos(2 * np.pi * m / 7)) for m in (1, 2, 3))
_S7 = tuple(_f32(np.sin(2 * np.pi * m / 7)) for m in (1, 2, 3))
_C11 = tuple(_f32(np.cos(2 * np.pi * m / 11)) for m in range(1, 6))
_S11 = tuple(_f32(np.sin(2 * np.pi * m / 11)) for m in range(1, 6))
_C13 = tuple(_f32(np.cos(2 * np.pi * m / 13)) for m in range(1, 7))
_S13 = tuple(_f32(np.sin(2 * np.pi * m / 13)) for m in range(1, 7))
# cos and sin of 2 pi m / r, m = 1 .. (r - 1) / 2, of each butterfly on
# ``dft_odd``'s pairs and combinations (``dft5``, ``dft7``, ``dft11``,
# ``dft13``).
_ODD = {5: (_C5, _S5), 7: (_C7, _S7), 11: (_C11, _S11), 13: (_C13, _S13)}
# The composite butterflies R = P Q (``dft_small`` in fft_rows.cuh): P-point
# DFTs, the twiddles w_R^(j2 k1), Q-point DFTs.
_CT = {6: (2, 3), 9: (3, 3), 10: (2, 5), 12: (4, 3), 14: (2, 7),
       15: (3, 5)}


def _dft_small_mirror(a: torch.Tensor, inverse: bool) -> torch.Tensor:
    """The kernel's radix-r DFT along dim -2 of (..., r, B) complex64
    (``dft_small``): the radix-2 network for a power of two, the radix-3
    butterfly, the radix-5, 7, 11 and 13 ones (``dft_odd``'s pairs and
    combinations), and for a composite r = P Q the P-point DFTs of a[Q j1
    + j2] over j1, the twiddles exp(-+ 2 pi i j2 k1 / r) (float32 from
    float64), the Q-point DFTs over j2, bin k1 + P k2 out."""
    r = a.shape[-2]
    sgn = 1.0 if inverse else -1.0
    if r & (r - 1) == 0:
        return _dft_regs_mirror(a, inverse)
    if r == 3:
        a0, a1, a2 = a.unbind(-2)
        t1, d = a1 + a2, a1 - a2
        t2 = a0 - 0.5 * t1
        rot = d * complex(0.0, sgn * _S3)
        return torch.stack([a0 + t1, t2 + rot, t2 - rot], -2)
    if r in _ODD:
        c, s = _ODD[r]
        h = r // 2
        e = a.unbind(-2)
        b = [e[k] + e[r - k] for k in range(1, h + 1)]
        d = [e[k] - e[r - k] for k in range(1, h + 1)]
        out = [e[0] + sum(b)] + [None] * (r - 1)
        for m in range(1, h + 1):
            u, w = e[0], 0
            for k in range(1, h + 1):
                j = m * k % r                  # cos, sin of 2 pi j / r
                cj = c[j - 1] if j <= h else c[r - j - 1]
                sj = s[j - 1] if j <= h else -s[r - j - 1]
                u, w = u + cj * b[k - 1], w + sj * d[k - 1]
            v = w * complex(0.0, sgn)
            out[m], out[r - m] = u + v, u - v
        return torch.stack(out, -2)
    p, q = _CT[r]
    x = a.unflatten(-2, (p, q)).transpose(-3, -2)          # [.., j2, j1, B]
    x = _dft_small_mirror(x, inverse)                      # [.., j2, k1, B]
    m = np.outer(np.arange(q), np.arange(p))
    w = np.exp(sgn * 2j * np.pi * m / r).astype(np.complex64)
    x = x * torch.from_numpy(w)[..., None]
    x = _dft_small_mirror(x.transpose(-3, -2), inverse)    # [.., k1, k2, B]
    return x.transpose(-3, -2).reshape(a.shape)            # k1 + p k2


def fft_rows_mirror(z: torch.Tensor, inverse: bool) -> torch.Tensor:
    """The engine's passes in plain PyTorch, from ``fft_plan``: (..., n)
    complex -> (..., n) complex64, the unnormalized DFT of each row. Pass p
    (radix r, NS the product of the radices before it) takes inputs
    j + m n / r of butterfly j, twiddles input m by the table's
    [m - 1, j mod NS], runs the radix-r DFT (``_dft_small_mirror``) and
    writes output m to (j - k) r + k + m NS, k = j mod NS. The same for
    both of the engine's kernels: the power-of-two one and the mixed-radix
    one. For tests: the port runs the kernel, its plain version the dense
    product."""
    n = z.shape[-1]
    plan = fft_plan(n, inverse)
    table = torch.from_numpy(plan.table)
    w = torch.complex(table[0], table[1])
    x = z.to(torch.complex64)
    ns = 1
    for r in plan.radices:
        j = torch.arange(n // r)
        m = torch.arange(r)[:, None]
        k = j % ns
        a = x[..., j + m * (n // r)]                     # (..., r, n / r)
        if ns > 1:
            t = ns - plan.radices[0] + (m[1:] - 1) * ns + k
            a = torch.cat([a[..., :1, :], a[..., 1:, :] * w[t]], -2)
        a = _dft_small_mirror(a, inverse)
        y = torch.empty_like(x)
        y[..., (j - k) * r + k + m * ns] = a
        x, ns = y, ns * r
    return x


def fft_cols_mirror(x3: torch.Tensor, inverse: bool) -> torch.Tensor:
    """The column kernels in plain PyTorch: (outer, n, inner) complex ->
    (outer, n, inner) complex64, the unnormalized DFT of every column.
    Batches of ``cols_geometry(n).width`` columns of one outer index (of
    ``mixed_cols_width(n)`` for a mixed length: the mixed-radix column
    kernel), the last group of a ragged inner extent filled out (the kernel
    transforms stale columns there and stores none of them), the engine's
    passes on each column (``fft_plan(n)``'s), the filled columns dropped.
    At n = 1024 (the split kernel) the radix-2 split first: halves a and b
    of each column, u = a + b and v = (a - b) w^i (``cols_plan``'s
    twiddles), the 512-point passes on each, u's bins the even ones and v's
    the odd."""
    outer, n, inner = x3.shape
    width = (mixed_cols_width(n) if n in MIXED_LENGTHS
             else cols_geometry(n).width)
    groups = -(-inner // width)
    x = x3.new_zeros((outer, n, groups * width), dtype=torch.complex64)
    x[..., :inner] = x3
    cols = x.reshape(outer, n, groups, width).permute(0, 2, 3, 1)
    split = None if n in MIXED_LENGTHS else cols_plan(n, inverse).split
    if split is None:
        y = fft_rows_mirror(cols, inverse)
    else:
        a, b = cols[..., :n // 2], cols[..., n // 2:]
        w = torch.complex(*torch.from_numpy(split))
        y = torch.stack([fft_rows_mirror(a + b, inverse),
                         fft_rows_mirror((a - b) * w, inverse)], -1)
        y = y.reshape(cols.shape)
    return y.permute(0, 3, 1, 2).reshape(outer, n, groups * width)[..., :inner]


def _real_pairs_mirror(x2: torch.Tensor) -> torch.Tensor:
    """The real-row loader and split of kernels 1, 5 and 6 in plain
    PyTorch: real rows 2c and 2c + 1 packed as one complex row (an odd last
    row paired with zeros), the engine, the split X_a[k] = (Z[k] + conj
    Z[n-k]) / 2, X_b[k] = (Z[k] - conj Z[n-k]) / 2i: (M, n) -> (M, n), the
    full spectrum of each row."""
    M, n = x2.shape
    x = x2.to(torch.float32)
    if M % 2:
        x = torch.cat([x, x.new_zeros((1, n))])
    z = fft_rows_mirror(torch.complex(x[0::2], x[1::2]), False)
    zn = z[:, (-torch.arange(n)) % n].conj()
    return torch.stack([(z + zn) / 2, (z - zn) / 2j], 1).reshape(-1, n)[:M]


def rdft_mirror(x2: torch.Tensor) -> torch.Tensor:
    """Kernel 1's FFT body in plain PyTorch: the real-row pairs, bins
    k in [0, n/2] kept: (M, n) -> (M, n/2 + 1)."""
    return _real_pairs_mirror(x2)[:, :x2.shape[1] // 2 + 1]


def rdft_tw_mirror(x2: torch.Tensor, n1: int) -> torch.Tensor:
    """Kernel 5's FFT body in plain PyTorch: the real-row pairs, every bin,
    times the twiddle row T[r % n1]."""
    M, n = x2.shape
    tr, ti = _twiddle_planes(n1, n, False, x2.device)
    rows = torch.arange(M) % n1
    return _real_pairs_mirror(x2) * torch.complex(tr[rows], ti[rows])


def cdft_tw_mirror(x2: torch.Tensor, n1: int, inverse: bool) -> torch.Tensor:
    """Kernel 4's FFT body in plain PyTorch: the engine on each complex row,
    then the twiddle row T[r % n1] in the epilogue."""
    M, n = x2.shape
    y = fft_rows_mirror(x2, inverse)
    tr, ti = _twiddle_planes(n1, n, inverse, x2.device)
    rows = torch.arange(M) % n1
    return y * torch.complex(tr[rows], ti[rows])


def zy_rows_mirror(x: torch.Tensor) -> torch.Tensor:
    """Kernel 6's pass A in plain PyTorch: real z-rows 2c and 2c + 1 packed
    as one complex row, the engine, the split, k in [0, Z/2] kept, laid
    out as the scratch of ``_zy_scratch_shape``."""
    X, Y, Z = x.shape
    half = rdft_mirror(x.reshape(-1, Z))
    return half.reshape(X, Y, -1).transpose(1, 2).contiguous()


def zy_cols_mirror(s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 6's passes B and C in plain PyTorch: the engine on each
    (x, zo) row of the scratch (the y-C2C), then the transpose into the two
    (X, Y, Zo) planes."""
    X, Zo, Y = s.shape
    f = fft_rows_mirror(s.reshape(-1, Y), False).reshape(X, Zo, Y)
    f = f.transpose(1, 2)
    return f.real.contiguous(), f.imag.contiguous()


def zy_fwd_mirror(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 6's FFT body in plain PyTorch: pass A, then passes B and C."""
    return zy_cols_mirror(zy_rows_mirror(x))


def c2r_mirror(c2: torch.Tensor, n: int) -> torch.Tensor:
    """Kernel 3's FFT body in plain PyTorch: (M, n/2 + 1) half spectra ->
    (M, n) float32, the unnormalized C2R of each row. Half rows 2c and
    2c + 1 (an odd last row paired with zeros), the imaginary parts of
    their DC bin and, for an even n, of their Nyquist bin n/2 zeroed (an
    odd n has no Nyquist bin: its last bin (n - 1)/2 keeps its imaginary
    part), extended by Hermitian symmetry and packed as one complex row A +
    iB; the engine's inverse passes; the real and imaginary parts split
    into the two real rows."""
    M = c2.shape[0]
    c = c2.to(torch.complex64).clone()
    for k in (0, n // 2) if n % 2 == 0 else (0,):
        c[:, k] = c[:, k].real.to(torch.complex64)
    if M % 2:
        c = torch.cat([c, c.new_zeros((1, c.shape[1]))])
    full = mx._hermitian_extend(c, n)
    z = fft_rows_mirror(full[0::2] + 1j * full[1::2], True)
    return torch.stack([z.real, z.imag], 1).reshape(-1, n)[:M]


def _packed_spectrum(c2: torch.Tensor) -> torch.Tensor:
    """The half-length packing of an even-n C2R: (M, m + 1) half spectra X,
    n = 2 m, -> (M, m) complex64 Z = E + i O, E[k] = X[k] + conj X[m - k]
    and O[k] = (X[k] - conj X[m - k]) exp(+2 pi i k / n) (``half_roots``),
    the imaginary parts of bins 0 and m dropped (the C2R ignores them; the
    packing would not). The unnormalized m-point inverse DFT z of Z holds
    the C2R x as z[j] = x[2j] + i x[2j + 1]: the complex64 (M, m) tensor of
    z is the float32 (M, n) tensor of x. Kernel 3's packed body forms it in
    its first pass, its pack pass stores it."""
    m = c2.shape[1] - 1
    x = c2.to(torch.complex64)
    a = x[:, :m].clone()
    b = torch.conj_physical(x.flip(-1)[:, :m])          # conj X[m - k]
    a[:, 0] = x[:, 0].real
    b[:, 0] = x[:, m].real
    w = _half_roots(2 * m, c2.device)
    return a + b + 1j * ((a - b) * torch.complex(w[0], w[1]))


def c2r_packed_mirror(c2: torch.Tensor, n: int) -> torch.Tensor:
    """Kernel 3's packed body in plain PyTorch: (M, n/2 + 1) half spectra
    -> (M, n) float32, the packing (``_packed_spectrum``), the engine's
    inverse passes on rows of m = n / 2 (``fft_rows_mirror``), the complex
    rows read as the real ones. For tests."""
    z = fft_rows_mirror(_packed_spectrum(c2), True)
    return torch.view_as_real(z).reshape(c2.shape[0], n)


def yz_inv_mirror(er: torch.Tensor, ei: torch.Tensor,
                  z: int) -> torch.Tensor:
    """Kernel 8's FFT body in plain PyTorch: pass 1 the transpose of the
    (X, Y, Zo) planes into the (X, Zo, Y) scratch, pass 2 the engine's
    inverse on its rows (the y-C2C), pass 3 kernel 3's C2R Body on the (x,
    y) half rows gathered from it."""
    X, Y, Zo = er.shape
    s = torch.complex(er, ei).transpose(1, 2).contiguous()
    s = fft_rows_mirror(s.reshape(-1, Y), True).reshape(X, Zo, Y)
    return c2r_mirror(s.transpose(1, 2).reshape(-1, Zo), z).reshape(X, Y, z)


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


def _check(name: str, *ts: torch.Tensor,
           dtype: torch.dtype = torch.float32) -> bool:
    """Validate kernel operands (float32 planes, or one complex64 tensor);
    True when they lie on the CPU (plain version), False on CUDA (kernel).
    Anything else raises."""
    dev = ts[0].device
    for t in ts:
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
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


def _launch(kernel: str, fn: str, *args) -> None:
    """Launch ``kernel`` through entry point ``fn`` of a csrc/*.cu library on
    the current stream and count it in ``LAUNCHES[kernel]``: tensors go as
    data pointers, None as a null pointer, ints as ints."""
    for hook in LAUNCH_HOOKS:
        hook(kernel, fn, args)
    name = _ENTRIES[fn][0]
    lib = _build.load(name, {f: sig for f, (lib_name, sig) in _ENTRIES.items()
                             if lib_name == name})
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    stream = torch.cuda.current_stream().cuda_stream
    _build.check(lib, fn, getattr(lib, fn)(*conv, stream))
    LAUNCHES[kernel] += 1
    ENTRIES[fn] = ENTRIES.get(fn, 0) + 1


class _NoVJP(torch.autograd.Function):
    """The autograd boundary of a kernel wrapper: the forward runs the
    wrapper as it is (the same launches, the same bits, no copy); the
    backward raises, as ``jax.grad`` does through a Pallas kernel (no
    ``custom_vjp`` in ``pallas_fft.py``, no transpose rule for
    ``pallas_call``). It raises on the CPU too, where the plain version
    that stands in for the kernel would differentiate by accident."""

    @staticmethod
    def forward(ctx, what, run, *tensors):
        ctx.what = what
        return run()

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            f"{ctx.what} has no VJP (the JAX package's Pallas kernel has "
            f"none either); differentiate with fft_backend 'xla' or "
            f"'matmul', or in double precision")


def _no_vjp(jax_kernel: str):
    """Put the wrapper behind ``_NoVJP`` when autograd would record it (a
    tensor argument, or one inside a tuple argument, requires grad under
    grad mode); otherwise call it as it is."""
    def wrap(fn):
        what = f"hopper_fft.{fn.__name__} ({jax_kernel})"

        @functools.wraps(fn)
        def run(*args, **kw):
            ts = [t for a in args
                  for t in (a if isinstance(a, tuple) else (a,))
                  if isinstance(t, torch.Tensor)]
            if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
                return _NoVJP.apply(what, lambda: fn(*args, **kw), *ts)
            return fn(*args, **kw)

        return run

    return wrap


@_no_vjp("_zy_fwd_kernel")
def zy_fwd(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(X, Y, Z) float32 -> (X, Y, Z//2+1) planes: z-R2C then y-C2C,
    unnormalized forward (kernel 6, ``_zy_fwd_kernel``). The body is
    ``_zy_engine_body(Y, Z)``: on ``"fft"`` three launches through a complex64
    scratch of ``_zy_scratch_shape`` (x and the scratch 16-byte aligned):
    the row FFT engine on the z rows, the engine on the scratch's y rows in
    place, the transpose into the planes (the engine's power-of-two kernel
    when Y and Z are both powers of two, else its mixed-radix kernel on
    both passes); else one launch of the dense kernel. Every launch counts
    as ``zy_fwd``."""
    cpu = _check("zy_fwd", x)
    X, Y, Z = x.shape
    dev = x.device
    fzr, fzi = _planes("rdft", Z, False, dev)
    fyr, fyi = _planes("dft", Y, False, dev)
    if cpu:
        return zy_fwd_plain(x, fzr, fzi, fyr, fyi)
    Zo = Z // 2 + 1
    yr = torch.empty((X, Y, Zo), dtype=torch.float32, device=dev)
    yi = torch.empty_like(yr)
    if _zy_engine_body(Y, Z) == "dense":
        _launch("zy_fwd", "dfft_zy_fwd", x, fzr, fzi, fyr, fyi, yr, yi, X, Y,
                Z)
        return yr, yi
    s = torch.empty(_zy_scratch_shape(X, Y, Z), dtype=torch.complex64,
                    device=dev)
    _require_aligned("zy_fwd", x, s)
    if _zy_body(Y, Z) == "fft":     # both passes on the power-of-two kernel
        zs, ys = fft_plan(Z, False).schedule, fft_plan(Y, False).schedule
    else:                           # both on the mixed-radix kernel
        zs, ys = mixed_schedule(Z, False), mixed_schedule(Y, False)
    _launch("zy_fwd", "dfft_zy_rows", x, _fft_table(Z, False, dev), s, X, Y,
            Z, zs)
    _launch("zy_fwd", "dfft_zy_cols", s, _fft_table(Y, False, dev), X, Y, Z,
            ys)
    _launch("zy_fwd", "dfft_zy_planes", s, yr, yi, X, Y, Z)
    return yr, yi


@_no_vjp("_x_c2c_kernel")
def x_cols(a, inverse: bool, complex_out: bool):
    """Kernel 7 (``_x_c2c_kernel``) on one layout pair: the unnormalized
    C2C along axis 0 of (X, Ky, Zo) data ``a``, a pair of float32 planes
    (kernel 6's output, the fused forward) or one contiguous complex64
    tensor (the spectrum, the fused inverse), out as one complex64 tensor
    (``complex_out``) or a pair of planes (kernel 8's input). The body is
    ``_x_body(X)``: on ``"fft"`` one launch on the layouts as they are, of
    the column kernel (``dfft_x_cols``) for a power of two or of the
    mixed-radix column kernel (``dfft_x_mixed``, ``mixed_cols_schedule``)
    for one of ``MIXED_LENGTHS``; else the dense kernel on planes (a
    complex side split or joined around it). Every launch counts as
    ``x_c2c``."""
    planes_in = isinstance(a, tuple)
    if planes_in:
        ar, ai = a
        cpu = _check("x_c2c", ar, ai)
        if ar.shape != ai.shape:
            raise ValueError(f"x_c2c: plane shapes {tuple(ar.shape)} and "
                             f"{tuple(ai.shape)} differ")
    else:
        cpu = _check("x_c2c", a, dtype=torch.complex64)
        ar, ai = a, None
    X, dev = ar.shape[0], ar.device
    if cpu or _x_body(X) == "dense":
        if not planes_in:
            ar, ai = a.real.contiguous(), a.imag.contiguous()
        fr, fi = _planes("dft", X, inverse, dev)
        if cpu:
            zr, zi = x_c2c_plain(ar, ai, fr, fi)
        else:
            zr, zi = torch.empty_like(ar), torch.empty_like(ai)
            _launch("x_c2c", "dfft_x_c2c", ar, ai, fr, fi, zr, zi, X,
                    ar[0].numel())
        return torch.complex(zr, zi) if complex_out else (zr, zi)
    if complex_out:
        z = torch.empty(ar.shape, dtype=torch.complex64, device=dev)
        outs = (z, None)
    else:
        outs = (torch.empty(ar.shape, dtype=torch.float32, device=dev),
                torch.empty(ar.shape, dtype=torch.float32, device=dev))
    if X in MIXED_LENGTHS:
        entry, schedule = "dfft_x_mixed", mixed_cols_schedule(X, inverse)
    else:
        entry, schedule = "dfft_x_cols", fft_plan(X, inverse).schedule
    _launch("x_c2c", entry, ar, ai, _fft_table(X, inverse, dev), *outs, X,
            ar[0].numel(), schedule, int(inverse))
    return outs[0] if complex_out else outs


def x_c2c(ar: torch.Tensor, ai: torch.Tensor,
          inverse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """C2C along axis 0 of (X, Ky, Zo) planes, unnormalized, planes out
    (kernel 7, ``_x_c2c_kernel``; ``x_cols``)."""
    return x_cols((ar, ai), inverse, complex_out=False)


@_no_vjp("_yz_inv_kernel")
def yz_inv(er: torch.Tensor, ei: torch.Tensor, z: int) -> torch.Tensor:
    """(X, Y, z//2+1) planes -> (X, Y, z) float32: y-C2C inverse then the
    half-spectrum z-C2R, unnormalized (kernel 8, ``_yz_inv_kernel``). The
    body is ``_zy_engine_body(Y, z)``: on ``"fft"`` three launches through
    a complex64 scratch of ``_zy_scratch_shape`` (it and the output
    16-byte aligned): the transpose of the planes into the scratch, the
    row FFT engine's inverse on its y rows in place, kernel 3's C2R Body
    on the z rows gathered from it (the engine's power-of-two kernel when Y
    and z are both powers of two, else its mixed-radix kernel on both
    passes, the z pass with kernel 3's rows, ``mixed_schedule(z, True,
    half=True)``); else one launch of the dense kernel. Every launch counts
    as ``yz_inv``."""
    X, Y, Zo = er.shape
    if Zo != z // 2 + 1 or er.shape != ei.shape:
        raise ValueError(f"yz_inv: planes {tuple(er.shape)}, "
                         f"{tuple(ei.shape)} do not fit z = {z}")
    cpu = _check("yz_inv", er, ei)
    if not 2 <= z <= mx.DIRECT_MAX:
        raise ValueError(f"yz_inv: z = {z} outside [2, {mx.DIRECT_MAX}]")
    dev = er.device
    dense = _planes("dft", Y, True, dev) + _planes("c2r", z, False, dev)
    if cpu:
        return yz_inv_plain(er, ei, *dense)
    y = torch.empty((X, Y, z), dtype=torch.float32, device=dev)
    if _zy_engine_body(Y, z) == "dense":
        _launch("yz_inv", "dfft_yz_inv", er, ei, *dense, y, X, Y, z)
        return y
    s = torch.empty(_zy_scratch_shape(X, Y, z), dtype=torch.complex64,
                    device=dev)
    _require_aligned("yz_inv", s, y)
    if _zy_body(Y, z) == "fft":     # both passes on the power-of-two kernel
        ys, zs = fft_plan(Y, True).schedule, fft_plan(z, True).schedule
    else:                           # both on the mixed-radix kernel
        ys, zs = mixed_schedule(Y, True), mixed_schedule(z, True, half=True)
    _launch("yz_inv", "dfft_yz_scratch", er, ei, s, X, Y, z)
    _launch("yz_inv", "dfft_yz_cols", s, _fft_table(Y, True, dev), X, Y, z,
            ys)
    _launch("yz_inv", "dfft_yz_rows", s, _fft_table(z, True, dev), y, X, Y,
            z, zs)
    return y


# ---------------------------------------------------------------------------
# The fused 3D transforms (``pallas_fft._rfftn3d_fused`` /
# ``_irfftn3d_fused`` and their normalized public forms)
# ---------------------------------------------------------------------------


def rfftn3d_fused(x: torch.Tensor) -> torch.Tensor:
    """(X, Y, Z) float32 -> (X, Y, Z//2+1) complex64, unnormalized."""
    yr, yi = zy_fwd(x.contiguous())
    return x_cols((yr, yi), False, complex_out=True)


def irfftn3d_fused(c: torch.Tensor, shape_3d) -> torch.Tensor:
    """(X, Y, Z//2+1)-croppable complex -> (X, Y, Z) float32, unnormalized."""
    X, Y, Z = shape_3d
    c = c.to(torch.complex64)
    for ax, n in ((-3, X), (-2, Y), (-1, Z // 2 + 1)):
        c = mx._fit_axis(c, ax, n)
    er, ei = x_cols(c.contiguous(), True, complex_out=False)
    return yz_inv(er, ei, Z)


def rfftn_3d(x: torch.Tensor, norm: FFTNorm = FFTNorm.NONE) -> torch.Tensor:
    """3D R2C over the trailing three axes: the fused kernels at direct
    sizes, else the per-axis path (``pallas_fft.rfftn_3d``)."""
    _require_3d(x)
    if x.ndim == 3 and fused3d_applicable(x.shape, x.dtype):
        s = 1.0
        for n in x.shape:
            s *= mx._fwd_scale(n, norm)
        return mx._scaled(rfftn3d_fused(x.to(torch.float32)), s)
    c = rfft(x, axis=-1, norm=norm)
    c = fft(c, axis=-2, norm=norm)
    return fft(c, axis=-3, norm=norm)


def irfftn_3d(x: torch.Tensor, shape_3d: Tuple[int, int, int],
              norm: FFTNorm = FFTNorm.NONE) -> torch.Tensor:
    """3D C2R to ``shape_3d``; the spectrum is cropped or zero-padded to
    (X, Y, Z//2+1) first (numpy's ``s=``)."""
    _require_3d(x)
    if x.ndim == 3 and fused3d_applicable(tuple(shape_3d), x.dtype):
        s = 1.0
        for n in shape_3d:
            s *= mx._inv_scale(n, norm)
        return mx._scaled(irfftn3d_fused(x, tuple(shape_3d)), s)
    c = ifft(mx._fit_axis(x, -3, shape_3d[-3]), axis=-3, norm=norm)
    c = ifft(mx._fit_axis(c, -2, shape_3d[-2]), axis=-2, norm=norm)
    return irfft(c, n=shape_3d[-1], axis=-1, norm=norm)


def _require_3d(x: torch.Tensor) -> None:
    if x.ndim < 3:
        raise ValueError(f"a 3D transform needs at least 3 axes, got shape "
                         f"{tuple(x.shape)}")


# ---------------------------------------------------------------------------
# Per-axis path: one DFT stage per launch (kernels 1-5, csrc/stage.cu)
# ---------------------------------------------------------------------------

# dfft_stage modes.
_MODES = {"cmatmul": 0, "rmatmul": 1, "c2r": 2}
_INT_MAX = 2 ** 31 - 1


def stage_plain(x2: torch.Tensor, fr: torch.Tensor, fi: torch.Tensor,
                tr: Optional[torch.Tensor] = None,
                ti: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernels 1, 2, 4, 5 as dense products: ``(x2 @ F) [* T[row % n1]]``."""
    if x2.is_complex():
        xr, xi = x2.real, x2.imag
        yr, yi = xr @ fr - xi @ fi, xr @ fi + xi @ fr
    else:
        yr, yi = x2 @ fr, x2 @ fi
    if tr is not None:
        rows = torch.arange(x2.shape[0], device=x2.device) % tr.shape[0]
        wr, wi = tr[rows], ti[rows]
        yr, yi = yr * wr - yi * wi, yr * wi + yi * wr
    return torch.complex(yr, yi)


def c2r_plain(c2: torch.Tensor, cr: torch.Tensor,
              ci: torch.Tensor) -> torch.Tensor:
    """Kernel 3 as dense products: ``Re(c) @ CR - Im(c) @ CI``."""
    return c2.real @ cr - c2.imag @ ci


def c2r_packed_plain(c2: torch.Tensor, n: int) -> torch.Tensor:
    """Kernel 3's packed body in plain PyTorch: the packing in tensor ops
    (``_packed_spectrum``), then the dense m-point inverse DFT
    (``stage_plain`` with the planes), the complex64 (M, m) result read as
    the float32 (M, n) rows."""
    z = stage_plain(_packed_spectrum(c2), *_planes("dft", n // 2, True,
                                                   c2.device))
    return torch.view_as_real(z).reshape(c2.shape[0], n)


def c2r_pack_plain(c2: torch.Tensor, n1: int) -> torch.Tensor:
    """Kernel 3's pack pass in plain PyTorch: (M, m + 1) half spectra ->
    (M, m) complex64, each row's packed spectrum Z (``_packed_spectrum``)
    in the four-step's first-stage layout of m = n1 n2, Z[s n1 + r] at r
    n2 + s (n1 = 1: natural order)."""
    M, m = c2.shape[0], c2.shape[1] - 1
    z = _packed_spectrum(c2).view(M, m // n1, n1)
    return z.transpose(1, 2).contiguous().view(M, m)


def _check_rows(name: str, x2: torch.Tensor, dtype: torch.dtype,
                *consts: torch.Tensor) -> bool:
    """Validate the operands of a stage launch; True for CPU tensors (plain
    version), False for CUDA (kernel). Anything else raises."""
    if x2.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype} rows, got {x2.dtype}")
    if x2.ndim != 2:
        raise ValueError(f"{name}: expected 2D rows, got shape "
                         f"{tuple(x2.shape)}")
    dev = x2.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {dev}")
    for t in (x2,) + consts:
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    for t in consts:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: constants must be float32 planes")
    if x2.shape[0] > _INT_MAX:
        raise ValueError(f"{name}: {x2.shape[0]} rows exceed one launch")
    return dev.type == "cpu"


@_no_vjp("_cmatmul_kernel / _rmatmul_kernel / their _tw forms")
def stage(x2: torch.Tensor, fr: torch.Tensor, fi: torch.Tensor,
          twiddle: Optional[Tuple[int, int, bool]] = None) -> torch.Tensor:
    """One DFT stage on rows: ``y = (x2 @ F) [* T]`` (``_call_stage``).

    x2: (M, n) complex64, or float32 for the real-input stage; F: (n, k)
    float32 planes; twiddle: (n1, n2, inverse) with k == n2 and the rows of
    x2 cycling through n1. Returns (M, k) complex64. Kernel 2
    (``cmatmul``), 1 (``rmatmul``), 4 (``cmatmul_tw``) or 5
    (``rmatmul_tw``)."""
    real = not x2.is_complex()
    name = ("rmatmul" if real else "cmatmul") + ("_tw" if twiddle else "")
    if fr.shape != fi.shape or fr.ndim != 2 or x2.ndim != 2 \
            or fr.shape[0] != x2.shape[1]:
        raise ValueError(f"{name}: rows {tuple(x2.shape)} do not fit F "
                         f"{tuple(fr.shape)}, {tuple(fi.shape)}")
    M, n = x2.shape
    k = fr.shape[1]
    tr = ti = None
    n1 = 1
    if twiddle is not None:
        n1, n2, inv = twiddle
        if n2 != k:
            raise ValueError(f"{name}: twiddle width {n2} != {k} columns")
        tr, ti = _twiddle_planes(n1, n2, inv, x2.device)
    tw_planes = () if tr is None else (tr, ti)
    cpu = _check_rows(name, x2, torch.float32 if real else torch.complex64,
                      fr, fi, *tw_planes)
    if cpu:
        return stage_plain(x2, fr, fi, tr, ti)
    y = torch.empty((M, k), dtype=torch.complex64, device=x2.device)
    if M:
        _launch(name, "dfft_stage", x2, fr, fi, tr, ti, y, M, n, k, n1,
                _MODES["rmatmul" if real else "cmatmul"],
                int(twiddle is not None))
    return y


@_no_vjp("_cmatmul_kernel")
def cdft(x2: torch.Tensor, inverse: bool) -> torch.Tensor:
    """Complex rows to their DFT: (M, n) complex64 -> (M, n) complex64, the
    unnormalized n-point DFT (inverse DFT when ``inverse``) of each row
    (kernel 2, ``_cmatmul_kernel`` with the full DFT matrix). The body is
    ``_cdft_body(n)``: the row FFT engine (``dfft_cdft``) for a power of
    two in [8, 1024] (its power-of-two kernel) or a 13-smooth n in [9, 507]
    (its mixed-radix kernel, ``mixed_schedule``), on a CPU tensor its
    plain version, ``stage_plain``; else ``stage`` with the DFT planes (the
    tile or row body); both count as ``cmatmul``."""
    cpu = _check_rows("cmatmul", x2, torch.complex64)
    M, n = x2.shape
    dev = x2.device
    if _cdft_body(n) == "tile":
        return stage(x2, *_planes("dft", n, inverse, dev))
    if cpu:
        return stage_plain(x2, *_planes("dft", n, inverse, dev))
    y = torch.empty_like(x2)
    if M:
        _require_aligned("cmatmul", x2, y)
        _launch("cmatmul", "dfft_cdft", x2, _fft_table(n, inverse, dev), y, M,
                n, _engine_schedule(n, inverse), int(inverse))
    return y


def cdft_cols_plain(x: torch.Tensor, axis: int,
                    inverse: bool) -> torch.Tensor:
    """Kernel 2's column body as a dense product: the axis moved last, the
    rows times the DFT planes (``stage_plain``), moved back into a
    contiguous tensor of the input's layout."""
    n = x.shape[axis]
    xm = x.movedim(axis, -1).contiguous()
    y = stage_plain(xm.reshape(-1, n), *_planes("dft", n, inverse, x.device))
    return y.reshape(xm.shape).movedim(-1, axis).contiguous()


def _check_cols(name: str, x: torch.Tensor, axis: int) -> bool:
    """Validate the operand of a column launch along ``axis`` (already
    in [0, ndim)); True for a CPU tensor (plain version), False for CUDA
    (kernel). Anything else raises."""
    if x.dtype != torch.complex64:
        raise TypeError(f"{name}: expected complex64, got {x.dtype}")
    if not 0 <= axis < x.ndim - 1:
        raise ValueError(f"{name}: axis {axis} of shape {tuple(x.shape)} "
                         f"is not a non-last axis")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: operand must be contiguous")
    if _fft_body(x.shape[axis]) != "fft":
        raise ValueError(f"{name}: the column kernel takes a power of two "
                         f"in [{FFT_MIN}, {FFT_MAX}], not {x.shape[axis]}")
    if max(math.prod(x.shape[:axis]), math.prod(x.shape[axis + 1:])) \
            > _INT_MAX:
        raise ValueError(f"{name}: shape {tuple(x.shape)} exceeds one launch")
    return x.device.type == "cpu"


@_no_vjp("_cmatmul_kernel")
def cdft_cols(x: torch.Tensor, axis: int, inverse: bool) -> torch.Tensor:
    """The unnormalized DFT (inverse DFT when ``inverse``) along a non-last
    ``axis`` of a contiguous complex64 tensor, where the axis lies: the
    result has the input's shape and layout, with no axis moved and no
    copy (kernel 2, ``_cmatmul_kernel``, on its column body: the column
    kernel of the row FFT engine on the (outer, n, inner) view, one
    ``dfft_cdft_cols`` launch counted as ``cmatmul``). n is a power of two
    in [8, 1024]; on a CPU tensor the plain version ``cdft_cols_plain``."""
    axis = axis % x.ndim if x.ndim else axis
    cpu = _check_cols("cmatmul", x, axis)
    n, dev = x.shape[axis], x.device
    if cpu:
        return cdft_cols_plain(x, axis, inverse)
    y = torch.empty_like(x)
    if x.numel():
        _launch("cmatmul", "dfft_cdft_cols", x, *_cols_tables(n, inverse, dev),
                y, math.prod(x.shape[:axis]), n,
                math.prod(x.shape[axis + 1:]),
                cols_plan(n, inverse).plan.schedule, int(inverse))
    return y


# ---------------------------------------------------------------------------
# A split axis where it lies: kernel 2's short-stage body (the four-step's
# second stage) and kernel 4's column body (its first stage on a non-last
# axis)
# ---------------------------------------------------------------------------

# Longest second stage the short-stage body takes (``SHORT_MAX`` in
# fft_rows.cuh): every n1 that ``mx._split_for`` gives up to 8192 points.
SHORT_MAX = 16


def _short_body(n1: int) -> bool:
    """Whether the short-stage body takes a four-step second stage of n1
    points: 2 <= n1 <= ``SHORT_MAX``. A pure function of n1."""
    return 2 <= n1 <= SHORT_MAX


@functools.lru_cache(maxsize=None)
def short_roots(n1: int, inverse: bool) -> np.ndarray:
    """(2, n1) float32 planes of exp(-+ 2 pi i m / n1), built in float64:
    the roots of the short-stage body's dense DFT (n1 not a power of
    two)."""
    w = np.exp((1.0 if inverse else -1.0) * 2j * np.pi * np.arange(n1) / n1)
    return np.ascontiguousarray(np.stack([w.real, w.imag]), np.float32)


@functools.lru_cache(maxsize=None)
def _short_roots(n1: int, inverse: bool, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(short_roots(n1, inverse)).to(device)


class ShortOut(NamedTuple):
    """Where the short-stage body stores bin k1 of column c of outer index
    q: element (q // group) * s1 + (q % group) * s2 + k1 * row + c of its
    output, when k1 * row + c < limit."""
    group: int
    s1: int
    s2: int
    row: int
    limit: int


def short_last(n1: int, n2: int, n_out: Optional[int] = None) -> ShortOut:
    """A last split axis, (.., n1, n2) columns -> (.., n_out): bin k1 n2 +
    k2 of a row at k1 n2 + k2, bins from n_out on not stored (n_out = n1
    n2, the natural order, by default; n / 2 + 1 for the R2C crop)."""
    n_out = n1 * n2 if n_out is None else n_out
    return ShortOut(1, n_out, 0, n2, n_out)


def short_strided(n1: int, n2: int, inner: int) -> ShortOut:
    """A non-last split axis: (outer n2, n1, inner) columns, outer index q
    = o n2 + k2, bin k1 n2 + k2 to (o, k1 n2 + k2, b) of an (outer, n1 n2,
    inner) tensor."""
    n = n1 * n2
    return ShortOut(n2, n * inner, inner, n2 * inner, n * inner)


def _short_extent(outer: int, n1: int, inner: int, g: ShortOut) -> int:
    """Elements an output needs to hold every bin that ``g`` stores."""
    last = min((n1 - 1) * g.row + inner, g.limit)
    return (outer // g.group - 1) * g.s1 + (g.group - 1) * g.s2 + last


def cdft_short_mirror(x3: torch.Tensor, inverse: bool) -> torch.Tensor:
    """The short-stage body's DFT in plain PyTorch: (outer, n1, inner)
    complex -> (outer, n1, inner) complex64, the n1-point DFT of every
    column, as the kernel computes it: the radix-2 network of the engine
    (``_dft_regs_mirror``) for a power of two, else the dense product with
    ``short_roots``. For tests."""
    n1 = x3.shape[1]
    x = x3.to(torch.complex64)
    if n1 & (n1 - 1) == 0:
        return _dft_regs_mirror(x, inverse)
    w = torch.complex(*torch.from_numpy(short_roots(n1, inverse)))
    m = (torch.arange(n1)[:, None] * torch.arange(n1)) % n1      # [k, j]
    return torch.einsum("kj,ojc->okc", w[m], x)


def cdft_short_plain(x3: torch.Tensor, inverse: bool, geom: ShortOut,
                     out_shape: Sequence[int]) -> torch.Tensor:
    """Kernel 2's short-stage body as a dense product (``cdft_cols_plain``
    along axis 1 of (outer, n1, inner)), its bins stored by ``geom`` into a
    new complex64 tensor of ``out_shape`` (elements no bin reaches are
    zero here; the kernel leaves them unset)."""
    outer, n1, inner = x3.shape
    g = geom.group
    y = cdft_cols_plain(x3, 1, inverse).view(outer // g, g, n1, inner)
    out = x3.new_zeros(tuple(out_shape), dtype=torch.complex64)
    full = min(n1, geom.limit // geom.row)
    rem = min(inner, geom.limit - full * geom.row) if full < n1 else 0
    if full and outer:
        out.as_strided((outer // g, g, full, inner),
                       (geom.s1, geom.s2, geom.row, 1)).copy_(y[:, :, :full])
    if rem > 0 and outer:
        out.as_strided((outer // g, g, rem), (geom.s1, geom.s2, 1),
                       full * geom.row).copy_(y[:, :, full, :rem])
    return out


def _check_short(x3: torch.Tensor, geom: ShortOut,
                 out_shape: Sequence[int]) -> bool:
    """Validate a short-stage launch; True for a CPU tensor (plain
    version), False for CUDA (kernel). Anything else raises."""
    name = "cmatmul"
    if x3.dtype != torch.complex64:
        raise TypeError(f"{name}: expected complex64, got {x3.dtype}")
    if x3.ndim != 3 or not _short_body(x3.shape[1]):
        raise ValueError(f"{name}: the short-stage body takes (outer, n1, "
                         f"inner) with 2 <= n1 <= {SHORT_MAX}, not "
                         f"{tuple(x3.shape)}")
    if x3.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {x3.device}")
    if not x3.is_contiguous():
        raise ValueError(f"{name}: operand must be contiguous")
    outer, n1, inner = x3.shape
    if min(geom) < 0 or geom.group < 1 or geom.row < 1 or outer % geom.group:
        raise ValueError(f"{name}: geometry {geom} does not fit {outer} "
                         f"outer indices")
    if max(outer, inner) > _INT_MAX:
        raise ValueError(f"{name}: shape {tuple(x3.shape)} exceeds one launch")
    if outer and _short_extent(outer, n1, inner, geom) > math.prod(out_shape):
        raise ValueError(f"{name}: geometry {geom} stores past an output of "
                         f"shape {tuple(out_shape)}")
    return x3.device.type == "cpu"


@_no_vjp("_cmatmul_kernel")
def cdft_short(x3: torch.Tensor, inverse: bool, geom: ShortOut,
               out_shape: Sequence[int]) -> torch.Tensor:
    """The four-step's second stage where the first stage left it: the
    unnormalized n1-point DFT (inverse DFT when ``inverse``) of every
    column of a contiguous (outer, n1, inner) complex64 tensor, 2 <= n1 <=
    ``SHORT_MAX``, each bin stored by ``geom`` (``short_last``,
    ``short_strided``) into a new complex64 tensor of ``out_shape``
    (kernel 2, ``_cmatmul_kernel``, on its short-stage body: one
    ``dfft_cdft_short`` launch counted as ``cmatmul``). On a CPU tensor the
    plain version ``cdft_short_plain``."""
    cpu = _check_short(x3, geom, out_shape)
    if cpu:
        return cdft_short_plain(x3, inverse, geom, out_shape)
    out = torch.empty(tuple(out_shape), dtype=torch.complex64,
                      device=x3.device)
    if x3.numel():
        outer, n1, inner = x3.shape
        _launch("cmatmul", "dfft_cdft_short", x3,
                _short_roots(n1, inverse, x3.device), out, outer, n1, inner,
                geom.group, int(inverse), geom.s1, geom.s2, geom.row,
                geom.limit)
    return out


def cdft_tw_cols_plain(x3: torch.Tensor, n1: int,
                       inverse: bool) -> torch.Tensor:
    """Kernel 4's column body as dense products: ``cdft_cols_plain`` along
    axis 1 of (outer, n2, n1 span), times T[r][k2] on the columns r span ..
    (r + 1) span."""
    outer, n2, inner = x3.shape
    tr, ti = _twiddle_planes(n1, n2, inverse, x3.device)
    y = cdft_cols_plain(x3, 1, inverse).view(outer, n2, n1, inner // n1)
    return (y * torch.complex(tr, ti).t()[None, :, :, None]).view(x3.shape)


def cdft_tw_cols_mirror(x3: torch.Tensor, n1: int,
                        inverse: bool) -> torch.Tensor:
    """Kernel 4's column body in plain PyTorch: the column kernel
    (``fft_cols_mirror``), then its epilogue's twiddle, T[c // span][k2]
    on bin k2 of column c. For tests."""
    outer, n2, inner = x3.shape
    tr, ti = _twiddle_planes(n1, n2, inverse, x3.device)
    rows = torch.arange(inner) // (inner // n1)
    return fft_cols_mirror(x3, inverse) * torch.complex(tr, ti)[rows].t()


def _check_tw_cols(x3: torch.Tensor, n1: int) -> bool:
    """Validate a launch of kernel 4's column body; True for a CPU tensor
    (plain version), False for CUDA (kernel). Anything else raises."""
    name = "cmatmul_tw"
    if x3.dtype != torch.complex64:
        raise TypeError(f"{name}: expected complex64, got {x3.dtype}")
    if x3.ndim != 3 or _fft_body(x3.shape[1]) != "fft" \
            or x3.shape[1] > mx.DIRECT_MAX:
        raise ValueError(f"{name}: the column body takes (outer, n2, inner) "
                         f"with n2 a power of two in [{FFT_MIN}, "
                         f"{mx.DIRECT_MAX}], not {tuple(x3.shape)}")
    if n1 < 1 or x3.shape[2] % n1:
        raise ValueError(f"{name}: n1 = {n1} does not divide the "
                         f"{x3.shape[2]} columns")
    if x3.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {x3.device}")
    if not x3.is_contiguous():
        raise ValueError(f"{name}: operand must be contiguous")
    if max(x3.shape[0], x3.shape[2]) > _INT_MAX:
        raise ValueError(f"{name}: shape {tuple(x3.shape)} exceeds one launch")
    return x3.device.type == "cpu"


@_no_vjp("_cmatmul_tw_kernel")
def cdft_tw_cols(x3: torch.Tensor, n1: int, inverse: bool) -> torch.Tensor:
    """The four-step's first stage where a non-last split axis lies: x3 is
    the contiguous complex64 view (outer, n2, n1 span) of the axis j = s
    n1 + r, point (s, r span + b); the result has the same layout, y[o,
    k2, r span + b] = T[r][k2] sum_s x3[o, s, r span + b] exp(-+ 2 pi i s
    k2 / n2), unnormalized (kernel 4, ``_cmatmul_tw_kernel``, on its
    column body: the column kernel with the twiddle in its epilogue, one
    ``dfft_cdft_tw_cols`` launch counted as ``cmatmul_tw``). n2 is a
    power of two in [8, 512]; on a CPU tensor the plain version
    ``cdft_tw_cols_plain``."""
    cpu = _check_tw_cols(x3, n1)
    if cpu:
        return cdft_tw_cols_plain(x3, n1, inverse)
    outer, n2, inner = x3.shape
    dev = x3.device
    y = torch.empty_like(x3)
    if x3.numel():
        tr, ti = _twiddle_planes(n1, n2, inverse, dev)
        _launch("cmatmul_tw", "dfft_cdft_tw_cols", x3,
                _fft_table(n2, inverse, dev), tr, ti, y, outer, n2, inner, n1,
                fft_plan(n2, inverse).schedule, int(inverse))
    return y


@_no_vjp("_rmatmul_kernel")
def rdft(x2: torch.Tensor) -> torch.Tensor:
    """Real rows to their half spectra: (M, n) float32 -> (M, n//2+1)
    complex64, bins 0..n/2 of each row's unnormalized DFT (kernel 1,
    ``_rmatmul_kernel`` with the R2C columns). The body is
    ``_cdft_body(n)``: the row FFT engine (``dfft_rdft``) for a power of
    two in [8, 1024] (its power-of-two kernel) or a 13-smooth n in [9,
    507] (its mixed-radix kernel, ``mixed_schedule``), on a CPU tensor its
    plain version, ``stage_plain``; else ``stage`` with the R2C planes (the
    tile or row body); both count as ``rmatmul``."""
    cpu = _check_rows("rmatmul", x2, torch.float32)
    M, n = x2.shape
    dev = x2.device
    if _cdft_body(n) == "tile":
        return stage(x2, *_planes("rdft", n, False, dev))
    if cpu:
        return stage_plain(x2, *_planes("rdft", n, False, dev))
    y = torch.empty((M, n // 2 + 1), dtype=torch.complex64, device=dev)
    if M:
        _require_aligned("rmatmul", x2, y)
        _launch("rmatmul", "dfft_rdft", x2, _fft_table(n, False, dev), y, M,
                n, _engine_schedule(n, False))
    return y


@_no_vjp("_rmatmul_tw_kernel")
def rdft_tw(x2: torch.Tensor, n1: int) -> torch.Tensor:
    """Real rows to the four-step first stage: (M, n2) float32 -> (M, n2)
    complex64, the full n2-point DFT of each row times the twiddle row
    T[r % n1] (kernel 5, ``_rmatmul_tw_kernel``). The body is
    ``_cdft_body(n2)``: the row FFT engine for a power of two in [8, 1024]
    or a 13-smooth n2 in [8, 512] (its mixed-radix kernel), else the dense
    tile loop of ``stage`` with the DFT planes; both count as
    ``rmatmul_tw``."""
    if x2.ndim != 2:
        raise ValueError(f"rmatmul_tw: expected 2D rows, got shape "
                         f"{tuple(x2.shape)}")
    if n1 < 1:
        raise ValueError(f"rmatmul_tw: n1 = {n1} < 1")
    M, n2 = x2.shape
    dev = x2.device
    if dev.type == "cpu" or _cdft_body(n2) == "tile":
        return stage(x2, *_planes("dft", n2, False, dev), (n1, n2, False))
    tr, ti = _twiddle_planes(n1, n2, False, dev)
    _check_rows("rmatmul_tw", x2, torch.float32, tr, ti)
    y = torch.empty((M, n2), dtype=torch.complex64, device=dev)
    if M:
        _require_aligned("rmatmul_tw", x2, y)
        _launch("rmatmul_tw", "dfft_rdft_tw", x2, _fft_table(n2, False, dev),
                tr, ti, y, M, n2, n1, _engine_schedule(n2, False))
    return y


@_no_vjp("_cmatmul_tw_kernel")
def cdft_tw(x2: torch.Tensor, n1: int, inverse: bool) -> torch.Tensor:
    """Complex rows to the four-step first stage: (M, n2) complex64 ->
    (M, n2) complex64, the n2-point DFT (inverse DFT when ``inverse``) of
    each row times the twiddle row T[r % n1] (kernel 4,
    ``_cmatmul_tw_kernel``). The body is ``_cdft_body(n2)``: the row
    FFT engine for a power of two in [8, 1024] or a 13-smooth n2 in [8,
    512] (its mixed-radix kernel), else the dense tile loop of ``stage``
    with the DFT planes; both count as ``cmatmul_tw``."""
    if x2.ndim != 2:
        raise ValueError(f"cmatmul_tw: expected 2D rows, got shape "
                         f"{tuple(x2.shape)}")
    if n1 < 1:
        raise ValueError(f"cmatmul_tw: n1 = {n1} < 1")
    if x2.dtype != torch.complex64:
        raise TypeError(f"cmatmul_tw: expected complex64 rows, got "
                        f"{x2.dtype}")
    M, n2 = x2.shape
    dev = x2.device
    if dev.type == "cpu" or _cdft_body(n2) == "tile":
        return stage(x2, *_planes("dft", n2, inverse, dev),
                     (n1, n2, inverse))
    tr, ti = _twiddle_planes(n1, n2, inverse, dev)
    _check_rows("cmatmul_tw", x2, torch.complex64, tr, ti)
    y = torch.empty((M, n2), dtype=torch.complex64, device=dev)
    if M:
        _require_aligned("cmatmul_tw", x2, y)
        _launch("cmatmul_tw", "dfft_cdft_tw", x2,
                _fft_table(n2, inverse, dev), tr, ti, y, M, n2, n1,
                _engine_schedule(n2, inverse), int(inverse))
    return y


@_no_vjp("_c2r_kernel")
def c2r(c2: torch.Tensor, cr: torch.Tensor, ci: torch.Tensor) -> torch.Tensor:
    """Half-spectrum C2R on rows: (M, n//2+1) complex64 -> (M, n) float32,
    ``Re(c) @ CR - Im(c) @ CI``, unnormalized (kernel 3, ``_c2r_kernel``):
    the dense body (the tile loop, or the row path for a few points)."""
    if cr.shape != ci.shape or cr.ndim != 2 or c2.ndim != 2 \
            or cr.shape[0] != c2.shape[1]:
        raise ValueError(f"c2r: rows {tuple(c2.shape)} do not fit CR/CI "
                         f"{tuple(cr.shape)}, {tuple(ci.shape)}")
    if _check_rows("c2r", c2, torch.complex64, cr, ci):
        return c2r_plain(c2, cr, ci)
    M, n_in = c2.shape
    n = cr.shape[1]
    y = torch.empty((M, n), dtype=torch.float32, device=c2.device)
    if M:
        _launch("c2r", "dfft_stage", c2, cr, ci, None, None, y, M, n_in, n,
                1, _MODES["c2r"], 0)
    return y


@_no_vjp("_c2r_kernel")
def irdft(c2: torch.Tensor, n: int) -> torch.Tensor:
    """Half spectra to their real rows: (M, n//2+1) complex64 -> (M, n)
    float32, the unnormalized C2R of each row (kernel 3, ``_c2r_kernel``;
    the imaginary parts of bin 0 and, for an even n, of bin n/2 are
    ignored). The body is ``_cdft_body(n)``: the row FFT engine for a
    power of two in [8, 1024] or a 13-smooth n in [8, 512] (its
    mixed-radix kernel; on a CPU tensor its plain version, ``c2r_plain``),
    else ``c2r`` with the C2R planes (the tile or row body); both count as
    ``c2r``. ``irfft`` calls it on the ``_direct`` lengths; past them an
    even n takes the packed route (``_c2r_packed``: ``irdft_packed`` or
    ``c2r_pack``)."""
    cpu = _check_rows("c2r", c2, torch.complex64)
    M, k = c2.shape
    if n < 1 or k != n // 2 + 1:
        raise ValueError(f"c2r: rows {tuple(c2.shape)} do not fit n = {n}")
    dev = c2.device
    if _cdft_body(n) == "tile":
        return c2r(c2, *_planes("c2r", n, False, dev))
    if cpu:
        return c2r_plain(c2, *_planes("c2r", n, False, dev))
    y = torch.empty((M, n), dtype=torch.float32, device=dev)
    if M:
        _require_aligned("c2r", c2, y)
        _launch("c2r", "dfft_c2r", c2, _fft_table(n, True, dev), y, M, n,
                _engine_schedule(n, True, half=True))
    return y


@_no_vjp("_c2r_kernel")
def irdft_packed(c2: torch.Tensor, n: int) -> torch.Tensor:
    """Half spectra to their real rows by the half-length packing: (M, n/2
    + 1) complex64 -> (M, n) float32, the unnormalized C2R of each row of
    an even n whose half m = n / 2 the row FFT engine takes
    (``_engine_length(m)``; the imaginary parts of bins 0 and m are
    ignored). Kernel 3, ``_c2r_kernel``, on its packed body: one
    ``dfft_c2r_packed`` launch counted as ``c2r``, the engine's m-point
    inverse (its power-of-two kernel, or its mixed-radix kernel with
    ``mixed_schedule(m, True, packed=True)``) whose first pass forms Z
    from bins i and m - i of the landed row (``_packed_spectrum``) and
    whose epilogue stores the complex row. The result is the complex64
    (M, m) output viewed as float32: no copy. On a CPU tensor the plain
    version ``c2r_packed_plain``."""
    cpu = _check_rows("c2r", c2, torch.complex64)
    M, k = c2.shape
    m = n // 2
    if n % 2 or k != m + 1 or not _engine_length(m):
        raise ValueError(f"c2r: the packed body takes rows of n/2 + 1 bins "
                         f"of an even n whose half is an engine length, not "
                         f"rows {tuple(c2.shape)} to n = {n}")
    if cpu:
        return c2r_packed_plain(c2, n)
    dev = c2.device
    z = torch.empty((M, m), dtype=torch.complex64, device=dev)
    if M:
        _require_aligned("c2r", c2, z)
        _launch("c2r", "dfft_c2r_packed", c2, _fft_table(m, True, dev),
                _half_roots(n, dev), z, M, m,
                _engine_schedule(m, True, packed=True))
    return torch.view_as_real(z).view(M, n)


@_no_vjp("_c2r_kernel")
def c2r_pack(c2: torch.Tensor, n1: int) -> torch.Tensor:
    """The pack pass of an even-n C2R whose half m = n / 2 the engine does
    not take: (M, m + 1) complex64 half spectra -> (M, m) complex64, each
    row's packed spectrum Z (``_packed_spectrum``) stored in the
    four-step's first-stage layout of m = n1 n2, Z[s n1 + r] at r n2 + s
    (n1 = 1: natural order), so that the complex m-point inverse takes it
    as it lies. Kernel 3, ``_c2r_kernel``: one ``dfft_c2r_pack`` launch
    counted as ``c2r``, each bin read once and Z written once through a
    shared-memory tile. On a CPU tensor the plain version
    ``c2r_pack_plain``."""
    cpu = _check_rows("c2r", c2, torch.complex64)
    M, m = c2.shape[0], c2.shape[1] - 1
    if m < 1 or n1 < 1 or m % n1:
        raise ValueError(f"c2r: the pack pass takes rows of m + 1 bins with "
                         f"n1 dividing m, not rows {tuple(c2.shape)} and "
                         f"n1 = {n1}")
    if cpu:
        return c2r_pack_plain(c2, n1)
    z = torch.empty((M, m), dtype=torch.complex64, device=c2.device)
    if M:
        _launch("c2r", "dfft_c2r_pack", c2, _half_roots(2 * m, c2.device), z,
                M, m, n1)
    return z


def _last_rows(fn, x: torch.Tensor, *args) -> torch.Tensor:
    """``fn(rows, *args)`` along the LAST axis of an nd tensor (rows = the
    flattened rest)."""
    y2 = fn(x.reshape(-1, x.shape[-1]).contiguous(), *args)
    return y2.reshape(x.shape[:-1] + y2.shape[-1:])


def _stage(x: torch.Tensor, F: Tuple[torch.Tensor, torch.Tensor],
           twiddle: Optional[Tuple[int, int, bool]] = None) -> torch.Tensor:
    """DFT stage along the LAST axis of an nd tensor (rows = flattened rest)."""
    return _last_rows(stage, x, *F, twiddle)


def _c2r_stage(c: torch.Tensor, n: int) -> torch.Tensor:
    """Half-spectrum C2R along the last axis (n//2+1 -> n, real)."""
    return _last_rows(irdft, c.to(torch.complex64), n)


def _c2r_packed(c: torch.Tensor, n: int) -> torch.Tensor:
    """The C2R along the last axis of contiguous complex64 (.., n/2 + 1)
    half spectra of an even n that is not ``_direct``, unnormalized:
    ``pallas_fft.irfft``'s function, computed as the complex inverse of m =
    n / 2 points of the packed spectrum (``_packed_spectrum``). An engine
    length m takes one ``irdft_packed``; any other m the pack pass
    (``c2r_pack``), then the complex inverse: the four-step entered after
    its swap (``_four_step_swapped``), the pack having stored its first
    stage's layout, or, for an m that does not split (``_direct``, a
    prime), one ``_fft_last`` on the natural order. No Hermitian
    extension, no swap of the spectrum and no copy of the real part: the
    complex64 result is the float32 (.., n) output."""
    m = n // 2
    lead = c.shape[:-1]
    c2 = c.reshape(-1, m + 1).contiguous()
    if _engine_length(m):
        y = irdft_packed(c2, n)
    else:
        n1, n2 = ((1, m) if _direct(m) or _long_prime(m)
                  else _split_axis(m))
        if n1 == 1:
            z = _fft_last(c2r_pack(c2, 1), True)
        else:
            z = _four_step_swapped(c2r_pack(c2, n1).view(-1, n1, n2), True,
                                   n1, n2)
        y = torch.view_as_real(z).view(-1, n)
    return y.reshape(lead + (n,))


def _swap_last(x: torch.Tensor) -> torch.Tensor:
    """Swap the two last axes into a new contiguous tensor."""
    return x.transpose(-1, -2).contiguous()


def _direct(n: int) -> bool:
    """One launch for a whole axis of n points: every n up to
    ``mx.DIRECT_MAX`` and, past it, a power of two the row FFT engine takes
    (up to ``FFT_MAX``). A pure function of n."""
    return n <= mx.DIRECT_MAX or _fft_body(n) == "fft"


def _split_axis(n: int) -> Tuple[int, int]:
    """(n1, n2) of the four-step split of a length that is not ``_direct``
    (``mx._split_for``): n1 = 1 for a prime, which takes one ``cdft`` up
    to ``mx.N_MAX`` points and the matmul backend past it
    (``_long_prime``)."""
    return mx._split_for(n, mx.DIRECT_MAX)


def _long_prime(n: int) -> bool:
    """A prime axis past ``mx.N_MAX``: the matmul backend's, in float32
    under the caller's settings (``pallas_fft._fft_last``'s prime branch)."""
    return n > mx.N_MAX and _split_axis(n)[0] == 1


def _first_stage(a: torch.Tensor, inverse: bool, n1: int,
                 n2: int) -> torch.Tensor:
    """The four-step's first stage on contiguous (.., n1, n2) rows, a[..,
    r, s] = x[s n1 + r]: the n2-point DFT over s times T[r][k2] (kernel 4,
    or kernel 5 on real rows, up to ``mx.DIRECT_MAX`` points; past it the
    recursion and the twiddle as a product)."""
    dev = a.device
    if a.is_complex():
        if n2 <= mx.DIRECT_MAX:
            return cdft_tw(a.reshape(-1, n2), n1, inverse).reshape(a.shape)
        return _fft_last(a, inverse) * _twiddle(n1, n2, inverse, dev)
    if n2 <= mx.DIRECT_MAX:
        return rdft_tw(a.reshape(-1, n2), n1).reshape(a.shape)
    return _fft_last(a.to(torch.complex64), False) * _twiddle(n1, n2, False,
                                                              dev)


def _four_step(x: torch.Tensor, inverse: bool, n1: int, n2: int,
               n_out: Optional[int] = None) -> torch.Tensor:
    """The four-step along the last axis of a contiguous tensor (.., n), n
    = n1 n2: complex64, or float32 for the forward R2C. Returns (..,
    n_out) complex64, bins 0 .. n_out - 1 of the unnormalized DFT in
    natural order (n_out = n by default, n / 2 + 1 for the R2C). One swap
    puts r = j mod n1 ahead of s = j div n1 and the first stage runs on
    rows of s; the second stage, the n1-point DFT over r, runs on the
    short-stage body's columns where the first stage left them and stores
    bin k1 n2 + k2 in its place, so nothing moves after it. An n1 past
    ``SHORT_MAX`` swaps again, runs rows of n1 and copies the bins back in
    order."""
    lead = x.shape[:-1]
    return _four_step_swapped(_swap_last(x.reshape(lead + (n2, n1))),
                              inverse, n1, n2, n_out)


def _four_step_swapped(a: torch.Tensor, inverse: bool, n1: int, n2: int,
                       n_out: Optional[int] = None) -> torch.Tensor:
    """``_four_step`` from its first stage's layout: contiguous (.., n1,
    n2), a[.., r, s] = x[s n1 + r] (the swap's output, or kernel 3's pack
    pass). The caller hands ``a`` over: it is freed once the first stage
    has read it."""
    lead = a.shape[:-2]
    n_out = n1 * n2 if n_out is None else n_out
    c = _first_stage(a, inverse, n1, n2)
    del a
    if _short_body(n1):
        return cdft_short(c.reshape(-1, n1, n2), inverse,
                          short_last(n1, n2, n_out), lead + (n_out,))
    d = _fft_last(_swap_last(c), inverse)      # (.., n2, n1): bin k1 n2 + k2
    del c
    q, rem = divmod(n_out, n2)
    out = d.new_empty(lead + (n_out,))
    out[..., :q * n2].unflatten(-1, (q, n2)).copy_(
        d[..., :q].transpose(-1, -2))
    if rem:
        out[..., q * n2:].copy_(d[..., :rem, q])
    return out


def _fft_last(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """Unnormalized C2C along the last axis of a contiguous complex64
    tensor (``pallas_fft._fft_last``, with ``_direct`` lengths in one
    ``cdft``)."""
    n = x.shape[-1]
    if _direct(n):
        return _last_rows(cdft, x, inverse)
    if _long_prime(n):
        return mx.rows(lambda r: mx._fft_last(r, inverse), x, n,
                       torch.complex64)
    n1, n2 = _split_axis(n)
    if n1 == 1:
        return _last_rows(cdft, x, inverse)
    return _four_step(x, inverse, n1, n2)


def _rfft_last(x: torch.Tensor) -> torch.Tensor:
    """Unnormalized R2C along the last axis of a contiguous float32 tensor
    (``pallas_fft._rfft_last``, with ``_direct`` lengths in one ``rdft``):
    (.., n) -> (.., n//2+1)."""
    n = x.shape[-1]
    if _direct(n):
        return _last_rows(rdft, x)
    if _long_prime(n):
        return mx.rows(mx._rfft_last, x, n // 2 + 1, torch.complex64)
    n1, n2 = _split_axis(n)
    if n1 == 1:
        return _last_rows(rdft, x)
    return _four_step(x, False, n1, n2, n // 2 + 1)


def _four_step_in_place(x: torch.Tensor, axis: int,
                        inverse: bool) -> torch.Tensor:
    """The four-step along a non-last ``axis`` of a contiguous complex64
    tensor where it lies (``_split_in_place``): the axis j = s n1 + r of
    the (outer, n, inner) view read as (outer, n2, n1 inner), kernel 4's
    column body over s with the twiddle, then the short-stage body over r
    on the (outer n2, n1, inner) view of its output, each bin stored at its
    place in a new tensor of the input's shape and layout. Two launches,
    no copy."""
    n1, n2 = _split_axis(x.shape[axis])
    outer = math.prod(x.shape[:axis])
    inner = math.prod(x.shape[axis + 1:])
    c = cdft_tw_cols(x.view(outer, n2, n1 * inner), n1, inverse)
    return cdft_short(c.view(outer * n2, n1, inner), inverse,
                      short_strided(n1, n2, inner), x.shape)


# ---------------------------------------------------------------------------
# Public per-axis API (``pallas_fft.fft`` ...; same FFTNorm semantics).
# Results keep the input's axis order. ``fft`` / ``ifft`` along a
# non-last axis: where ``_strided`` holds, one ``cdft_cols`` where the axis
# lies, and where ``_split_in_place`` holds, the four-step where it lies
# (``cdft_tw_cols`` then ``cdft_short``), the result in the input's layout;
# else the axis moves last, and the result is a strided view of the
# kernel's output, or, for a split axis, a contiguous tensor in the input's
# axis order.
# ---------------------------------------------------------------------------


def _strided(x: torch.Tensor, axis: int) -> bool:
    """Whether ``fft`` / ``ifft`` transform ``axis`` of ``x`` where it lies,
    by one ``cdft_cols``: a non-last axis of a contiguous complex64 tensor
    whose length the row FFT engine takes (``_fft_body``). A pure function
    of dtype, shape and strides: a split axis (2048) takes
    ``_split_in_place`` or moves last, and any other length and a
    non-contiguous view (a ring's block) move the axis last."""
    return (x.ndim > 1 and axis % x.ndim != x.ndim - 1
            and x.dtype == torch.complex64
            and _fft_body(x.shape[axis]) == "fft" and x.is_contiguous())


def _split_in_place(x: torch.Tensor, axis: int) -> bool:
    """Whether ``fft`` / ``ifft`` run the four-step of a split ``axis`` of
    ``x`` where it lies (``_four_step_in_place``): a non-last axis of a
    contiguous complex64 tensor that is not ``_direct``, split n1 x n2
    (``mx._split_for``) with n1 a short stage (``_short_body``) and n2 a
    power of two in [8, 512] (kernel 4's column body). A pure function of
    dtype, shape and strides: n1 past 16 (16384 = 32 x 512), an n2 that is
    not a power of two (640 = 2 x 320) and a non-contiguous view move the
    axis last."""
    if not (x.ndim > 1 and axis % x.ndim != x.ndim - 1
            and x.dtype == torch.complex64 and x.is_contiguous()):
        return False
    n = x.shape[axis]
    if _direct(n):
        return False
    n1, n2 = mx._split_for(n, mx.DIRECT_MAX)
    return (_short_body(n1) and _fft_body(n2) == "fft"
            and n2 <= mx.DIRECT_MAX)


def _c2c_axis(x: torch.Tensor, axis: int, inverse: bool) -> torch.Tensor:
    """Unnormalized C2C along ``axis`` of a complex64 tensor, in the
    input's axis order (see the note above)."""
    axis %= x.ndim
    if _strided(x, axis):
        return cdft_cols(x, axis, inverse)
    if _split_in_place(x, axis):
        return _four_step_in_place(x, axis, inverse)
    y = _fft_last(x.movedim(axis, -1).contiguous(), inverse)
    if axis == x.ndim - 1:
        return y
    n = x.shape[axis]
    split = not _direct(n) and _split_axis(n)[0] > 1
    y = y.movedim(-1, axis)
    return y.contiguous() if split else y


# Double precision takes the matmul backend before anything narrows it to
# single precision (``pallas_fft._use_fallback``): ``fft`` / ``ifft`` /
# ``rfft`` as ``mx._fft_last`` / ``mx._rfft_last``, ``irfft`` as the real
# part of the Hermitian extension's complex inverse (``pallas_fft.irfft``),
# never the folded C2R matrices.


def fft(x: torch.Tensor, axis: int, norm: FFTNorm = FFTNorm.NONE
        ) -> torch.Tensor:
    if mx._is_double(x.dtype):
        return mx.fft(x, axis=axis, norm=norm)
    y = _c2c_axis(x.to(torch.complex64), axis, False)
    return mx._scaled(y, mx._fwd_scale(x.shape[axis], norm))


def ifft(x: torch.Tensor, axis: int, norm: FFTNorm = FFTNorm.NONE
         ) -> torch.Tensor:
    if mx._is_double(x.dtype):
        return mx.ifft(x, axis=axis, norm=norm)
    y = _c2c_axis(x.to(torch.complex64), axis, True)
    return mx._scaled(y, mx._inv_scale(x.shape[axis], norm))


def rfft(x: torch.Tensor, axis: int, norm: FFTNorm = FFTNorm.NONE
         ) -> torch.Tensor:
    if mx._is_double(x.dtype):
        return mx.rfft(x, axis=axis, norm=norm)
    x = x.movedim(axis, -1).to(torch.float32).contiguous()
    y = mx._scaled(_rfft_last(x), mx._fwd_scale(x.shape[-1], norm))
    return y.movedim(-1, axis)


def irfft(x: torch.Tensor, n: int, axis: int,
          norm: FFTNorm = FFTNorm.NONE) -> torch.Tensor:
    if mx._is_double(x.dtype):
        return mx.irfft_extended(x, n=n, axis=axis, norm=norm)
    c = mx._fit_axis(x.movedim(axis, -1).to(torch.complex64), -1, n // 2 + 1)
    if _direct(n):
        y = _c2r_stage(c, n)
    elif n % 2 == 0:
        # Kernel 3's packed body, or its pack pass and the complex inverse
        # of n / 2 points.
        y = _c2r_packed(c, n)
    else:
        # An odd n has no half-length packing: invert the
        # Hermitian-extended spectrum as a complex transform, as the JAX
        # package does.
        full = mx._hermitian_extend(c, n).contiguous()
        y = _fft_last(full, True).real.contiguous()
    return mx._scaled(y, mx._inv_scale(n, norm)).movedim(-1, axis)


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


# ---------------------------------------------------------------------------
# Fused wire: kernels 9-11 (csrc/wire.cu) and the ring hooks
# (``pallas_fft.wire_encode_fused`` / ``wire_decode_fused`` /
# ``decode_fft_fused`` / ``fused_ring_hooks``)
# ---------------------------------------------------------------------------


def enc_pack_plain(x: torch.Tensor) -> torch.Tensor:
    """Kernel 9's function: complex -> planar (real, imag) bfloat16 pair,
    round to nearest even (``transpose.wire_encode``'s formula)."""
    return torch.stack([x.real, x.imag]).to(torch.bfloat16)


def dec_unpack_plain(y: torch.Tensor) -> torch.Tensor:
    """Kernel 10's function: planar bfloat16 pair -> complex64, exact."""
    z = y.to(torch.float32)
    return torch.complex(z[0], z[1])


def dec_cmatmul_plain(y2: torch.Tensor, fr: torch.Tensor,
                      fi: torch.Tensor) -> torch.Tensor:
    """Kernel 11's function: decode (2, M, n) planes, then the dense
    float32 DFT product ``(M, n) @ F``."""
    return stage_plain(dec_unpack_plain(y2), fr, fi)


def _check_wire(name: str, t: torch.Tensor, dtype: torch.dtype) -> bool:
    """Validate a wire kernel's data operand; True on the CPU (plain
    version), False on CUDA (kernel). Anything else raises."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {t.device}")
    if t.numel() > _INT_MAX:
        raise ValueError(f"{name}: {t.numel()} elements exceed one launch")
    return t.device.type == "cpu"


def _planes_of(name: str, y: torch.Tensor) -> None:
    if y.ndim < 2 or y.shape[0] != 2:
        raise ValueError(f"{name}: expected (2, ...) planes, got shape "
                         f"{tuple(y.shape)}")
    if not y.is_contiguous():
        raise ValueError(f"{name}: planes must be contiguous")


@_no_vjp("_enc_pack_kernel")
def enc_pack(x: torch.Tensor) -> torch.Tensor:
    """complex64 block of up to 3 dims, any strides -> contiguous
    ``(2,) + x.shape`` bfloat16 planes (kernel 9, ``_enc_pack_kernel``).
    The block is read in place: a chunk of the plan's array needs no
    contiguous copy first."""
    cpu = _check_wire("enc_pack", x, torch.complex64)
    if x.ndim > 3:
        raise ValueError(f"enc_pack: at most 3 dims, got {x.ndim}")
    if cpu:
        return enc_pack_plain(x)
    y = torch.empty((2,) + tuple(x.shape), dtype=torch.bfloat16,
                    device=x.device)
    if x.numel():
        dims = (1,) * (3 - x.ndim) + tuple(x.shape)
        strides = (0,) * (3 - x.ndim) + tuple(x.stride())
        if max(strides) > _INT_MAX:
            raise ValueError(f"enc_pack: stride {max(strides)} exceeds a "
                             f"C int")
        _launch("enc_pack", "dfft_enc_pack", x, y, *dims, *strides)
    return y


@_no_vjp("_dec_unpack_kernel")
def dec_unpack(y: torch.Tensor) -> torch.Tensor:
    """Contiguous ``(2, ...)`` bfloat16 planes -> complex64 of shape
    ``y.shape[1:]`` (kernel 10, ``_dec_unpack_kernel``); exact."""
    cpu = _check_wire("dec_unpack", y, torch.bfloat16)
    _planes_of("dec_unpack", y)
    if cpu:
        return dec_unpack_plain(y)
    out = torch.empty(tuple(y.shape[1:]), dtype=torch.complex64,
                      device=y.device)
    if out.numel():
        _launch("dec_unpack", "dfft_dec_unpack", y, out, out.numel())
    return out


def _require_aligned(name: str, *ts: torch.Tensor) -> None:
    """The FFT body moves rows with bulk copies: 16-byte aligned operands."""
    for t in ts:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operand at {t.data_ptr():#x} is not "
                             f"16-byte aligned (the bulk copies need it)")


@_no_vjp("_dec_cmatmul_kernel")
def dec_cmatmul(y2: torch.Tensor, inverse: bool) -> torch.Tensor:
    """(2, M, n) bfloat16 planes -> (M, n) complex64, the unnormalized DFT
    (inverse DFT) of each decoded row (kernel 11, ``_dec_cmatmul_kernel``).
    The planes widen to float32 as they are loaded, so the decoded block
    never reaches device memory. The body is ``_fft_body(n)``: the row FFT
    engine for a power of two in [8, 1024], else the dense tile loop with
    the DFT planes; both count as ``dec_cmatmul``."""
    cpu = _check_wire("dec_cmatmul", y2, torch.bfloat16)
    _planes_of("dec_cmatmul", y2)
    if y2.ndim != 3 or y2.shape[2] < 1:
        raise ValueError(f"dec_cmatmul: expected (2, M, n) planes, got shape "
                         f"{tuple(y2.shape)}")
    _, M, n = y2.shape
    dev = y2.device
    if cpu:
        return dec_cmatmul_plain(y2, *_planes("dft", n, inverse, dev))
    out = torch.empty((M, n), dtype=torch.complex64, device=dev)
    if not M:
        return out
    if _fft_body(n) == "fft":
        _require_aligned("dec_cmatmul", y2, out)
        _launch("dec_cmatmul", "dfft_dec_fft", y2, _fft_table(n, inverse, dev),
                out, M, n, fft_plan(n, inverse).schedule, int(inverse))
    else:
        _launch("dec_cmatmul", "dfft_dec_cmatmul", y2,
                *_planes("dft", n, inverse, dev), out, M, n)
    return out


def _wire_kernel_usable(dtype: torch.dtype) -> bool:
    """The wire kernels take single precision only: a double-precision
    payload takes the plain wire formulas (``pallas_fft._wire_kernel_usable``
    routes by dtype the same way)."""
    return not mx._is_double(dtype)


def wire_encode_fused(x: torch.Tensor) -> torch.Tensor:
    """A travelling ring block -> its bfloat16 wire planes in one pass."""
    if not _wire_kernel_usable(x.dtype):
        return enc_pack_plain(x)
    return enc_pack(x)


def wire_decode_fused(y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An arrived ring block's planes -> complex ``dtype`` in one pass."""
    if not _wire_kernel_usable(dtype):
        z = y.to(torch.float64)
        return torch.complex(z[0], z[1])
    return dec_unpack(y)


def decode_fft_fused(y: torch.Tensor, dtype: torch.dtype, axis: int,
                     inverse: bool = False, norm: FFTNorm = FFTNorm.NONE,
                     settings: Optional[mx.MXUSettings] = None
                     ) -> torch.Tensor:
    """Decode an arrived block's ``(2,) + block`` planes and run the direct
    DFT along ``axis`` of the block, in one kernel (11) whatever the plan's
    ``fft_backend``, as the JAX package's fused arrival does. The axis
    moves last on the bfloat16 planes (half the bytes of a float32 move);
    the norm scale is applied after the kernel, as in the JAX package.
    A double-precision target, or an axis above ``mx.N_MAX`` points, takes
    the plain decode and then the matmul backend's ``fft`` / ``ifft``
    under ``settings`` (``pallas_fft.decode_fft_fused``)."""
    block_ndim = y.ndim - 1
    axis %= block_ndim
    n = y.shape[1 + axis]
    if not _wire_kernel_usable(dtype) or n > mx.N_MAX:
        z = y.to(torch.float64 if mx._is_double(dtype) else torch.float32)
        with mx.use_settings(settings):
            return (mx.ifft if inverse else mx.fft)(
                torch.complex(z[0], z[1]), axis=axis, norm=norm)
    planes = y.movedim(1 + axis, -1).contiguous()
    shape = planes.shape[1:]
    out = dec_cmatmul(planes.reshape(2, -1, n), inverse)
    scale = mx._inv_scale(n, norm) if inverse else mx._fwd_scale(n, norm)
    return mx._scaled(out.reshape(shape), scale).movedim(-1, axis)


def fused_ring_hooks(config, snd=None):
    """``(encode_fn, arrive_fn)`` of a ring whose arriving blocks run no
    per-block FFT: the one-pass encode and the unpack-only arrival, or
    ``(None, None)`` — the plain wire layer — when the fused wire is off
    for this exchange (``Config.fused_wire_for``) or the plan is double
    precision (the wire kernels take single precision only)."""
    active = (config.fused_wire_for(snd) if snd is not None
              else config.fused_wire_active())
    if not active or config.double_prec:
        return None, None
    return wire_encode_fused, (
        lambda b: wire_decode_fused(b, torch.complex64))
