"""Kernels 3 and 5 on the row FFT engine's mixed-radix kernel
(``fft_mixed_kernel`` in ``csrc/fft_rows.cuh`` with stage.cu's
``HalfRows`` and ``RealTwiddleRows``), on the CPU.

* Kernel 5's FFT body (``rdft_tw_mirror``: real rows 2c and 2c + 1 packed
  as one complex row, the engine's passes, the split, the twiddle by ``r
  % n1``) at n2 320, 480, 448, 416, 440 and 375, n1 2 and 9, an odd row
  count, against ``stage_plain`` (1e-5: float32 on both sides, sums in
  another order) and the JAX package's ``pallas_fft._call_stage`` with the
  DFT and the twiddle (its Pallas kernel in interpret mode; 5e-4, the JAX
  per-stage bound).
* Kernel 3's FFT body (``c2r_mirror``) at n 480, 440, 448, 416, 375, 405,
  9 and 45 on random half spectra, an odd row count, against
  ``c2r_plain`` and ``pallas_fft._c2r_stage``. At an odd n there is no
  Nyquist bin: the last bin (n - 1)/2 keeps its imaginary part, which
  the C2R reads (``_c2r_np``'s CI row there is not zero).
* The routes: ``irdft`` and ``rdft_tw`` launch ``dfft_c2r`` /
  ``dfft_rdft_tw`` with ``_engine_schedule`` at every 13-smooth length in
  [9, 512] that is not a power of two, and ``dfft_stage`` (the tile body)
  where a prime factor passes 13.
* The kernel's shared memory: every Body's ``stage_bytes(g)``, the block
  within ``MIXED_SMEM`` (two blocks an SM) at every length for both
  buffer sizes, kernel 3's rows capped where its larger buffers would pass
  it (10 points).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from distributedfft_tpu.ops import mxu_fft as jmx
from distributedfft_tpu.ops import pallas_fft
from distributedfft_tpu_torch.ops import hopper_fft as hf

CPU = torch.device("cpu")
MIXED = list(hf.MIXED_LENGTHS)
CSRC = pathlib.Path(hf.__file__).parent.parent / "csrc"


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def _real(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _half(M, n, seed):
    """Random (M, n//2 + 1) half spectra: every bin, DC and the last one
    included, has a non-zero imaginary part."""
    rng = np.random.default_rng(seed)
    shape = (M, n // 2 + 1)
    c = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    assert np.all(np.abs(c[:, [0, n // 2]].imag) > 0)
    return c.astype(np.complex64)


# ---------------------------------------------------------------------------
# Kernel 5
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n1", [2, 9])
@pytest.mark.parametrize("n2", [320, 480, 448, 416, 440, 375])
def test_kernel5_mixed_rows_match_plain_and_jax(n2, n1):
    """Kernel 5's FFT body on the mixed-radix kernel: an odd row count (the
    last real row paired with zeros), rows cycling through n1."""
    M = 2 * n1 + 3
    x = _real((M, n2), 11 * n2 + n1)
    got = hf.rdft_tw_mirror(torch.from_numpy(x), n1)
    assert got.dtype == torch.complex64 and got.shape == (M, n2)
    plain = hf.stage_plain(torch.from_numpy(x),
                           *hf._planes("dft", n2, False, CPU),
                           *hf._twiddle_planes(n1, n2, False, CPU))
    assert _rel(got.numpy(), plain.numpy()) <= 1e-5
    assert torch.equal(hf.rdft_tw(torch.from_numpy(x), n1), plain)
    want = np.asarray(pallas_fft._call_stage(
        x, jmx._dft_np(n2, False, False), (n1, n2, False)))
    assert _rel(got.numpy(), want) <= 5e-4


# ---------------------------------------------------------------------------
# Kernel 3
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [480, 440, 448, 416, 375, 405, 9, 45])
def test_kernel3_mixed_rows_match_plain_and_jax(n):
    """Kernel 3's FFT body on the mixed-radix kernel on random half spectra
    (an odd row count): the imaginary part of DC, and at an even n of the
    Nyquist bin, ignored; at an odd n the last bin's counts."""
    M = 7
    c = _half(M, n, 5 * n)
    got = hf.c2r_mirror(torch.from_numpy(c), n)
    assert got.dtype == torch.float32 and got.shape == (M, n)
    plain = hf.c2r_plain(torch.from_numpy(c),
                         *hf._planes("c2r", n, False, CPU))
    assert _rel(got.numpy(), plain.numpy()) <= 1e-5
    assert torch.equal(hf.irdft(torch.from_numpy(c), n), plain)
    want = np.asarray(pallas_fft._c2r_stage(c, n))
    assert _rel(got.numpy(), want) <= 5e-4


@pytest.mark.parametrize("n", [375, 405, 9, 45])
def test_kernel3_odd_n_keeps_the_last_bins_imaginary_part(n):
    """At an odd n, bin (n - 1)/2 is an ordinary bin: with only its
    imaginary part non-zero the C2R is 2 Im(c) sin(2 pi j (n - 1)/2 / n)
    up to sign, not zero, and the mirror gives numpy's irfft (times n),
    which reads it. Zeroing it, as at an even n's Nyquist bin, would be a
    different result."""
    h = (n - 1) // 2
    c = np.zeros((3, h + 1), np.complex64)
    c[:, h] = [0.5j, -1.25j, 2j]
    got = hf.c2r_mirror(torch.from_numpy(c), n).numpy()
    want = np.fft.irfft(c.astype(np.complex128), n) * n
    assert np.max(np.abs(want)) > 0.5
    assert _rel(got, want) <= 1e-5
    j = np.arange(n)
    exact = -2 * c.imag[:, h:h + 1].astype(np.float64) * np.sin(
        2 * np.pi * j * h / n)
    assert _rel(got, exact) <= 1e-5
    plain = hf.c2r_plain(torch.from_numpy(c),
                         *hf._planes("c2r", n, False, CPU)).numpy()
    assert _rel(got, plain) <= 1e-5
    # A random spectrum with that bin's imaginary part set: the mirror and
    # JAX's C2R agree, and both move when it changes.
    d = _half(5, n, n + 3)
    e = d.copy()
    e[:, h] += 10j
    for spec in (d, e):
        assert _rel(hf.c2r_mirror(torch.from_numpy(spec), n).numpy(),
                    np.asarray(pallas_fft._c2r_stage(spec, n))) <= 5e-4
    assert _rel(hf.c2r_mirror(torch.from_numpy(d), n).numpy(),
                hf.c2r_mirror(torch.from_numpy(e), n).numpy()) > 1e-2


# ---------------------------------------------------------------------------
# Routes and launches (recorded on "meta" tensors, nothing run)
# ---------------------------------------------------------------------------


def _record_launches(monkeypatch):
    """Make the row wrappers take their CUDA route, recording each launch
    as (counter, C entry point, arguments) instead of running it."""
    log = []
    monkeypatch.setattr(hf, "_check_rows", lambda *a, **k: False)
    monkeypatch.setattr(hf, "_launch", lambda kernel, fn, *args:
                        log.append((kernel, fn, args)))
    return log


TILE = [408, 442, 520, 17, 257]


@pytest.mark.parametrize("n", MIXED + [512, 1024] + TILE)
def test_irdft_launches_by_cdft_body(monkeypatch, n):
    """``irdft`` launches ``dfft_c2r`` on the engine at every engine length
    (the mixed-radix kernel with kernel 3's rows, ``_engine_schedule(n,
    True, half=True)``, at the 155 13-smooth ones), else the tile body
    ``dfft_stage`` with the C2R planes."""
    log = _record_launches(monkeypatch)
    c = torch.zeros((9, n // 2 + 1), dtype=torch.complex64, device="meta")
    y = hf.irdft(c, n)
    assert y.shape == (9, n) and y.dtype == torch.float32
    ((kernel, entry, args),) = log
    assert kernel == "c2r"
    if n in TILE:
        assert hf._cdft_body(n) == "tile"
        assert entry == "dfft_stage"
        return
    assert entry == "dfft_c2r"
    assert args[3:] == (9, n, hf._engine_schedule(n, True, half=True))
    assert args[1] is hf._fft_table(n, True, c.device)
    if n in hf.MIXED_LENGTHS:
        assert args[-1] == hf.mixed_schedule(n, True, half=True)


@pytest.mark.parametrize("n2", MIXED + [512, 1024] + TILE)
def test_rdft_tw_launches_by_cdft_body(monkeypatch, n2):
    """``rdft_tw`` on a card's rows launches ``dfft_rdft_tw`` at every
    engine length (``_engine_schedule(n2, False)``), else ``dfft_stage``
    with the DFT planes and the twiddle."""
    log = _record_launches(monkeypatch)
    x = torch.zeros((7, n2), device="meta")
    y = hf.rdft_tw(x, 3)
    assert y.shape == (7, n2) and y.dtype == torch.complex64
    ((kernel, entry, args),) = log
    assert kernel == "rmatmul_tw"
    if n2 in TILE:
        assert entry == "dfft_stage"
        assert args[6:] == (7, n2, n2, 3, 1, 1)
        return
    assert entry == "dfft_rdft_tw"
    assert args[5:] == (7, n2, 3, hf._engine_schedule(n2, False))


# ---------------------------------------------------------------------------
# Shared memory: two blocks an SM for every Body
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", MIXED)
def test_mixed_blocks_fit_two_an_sm(n):
    """At every mixed length the block of either buffer size fits
    ``MIXED_SMEM``; kernel 3's rows are the other Bodies' rows, less
    only where its larger buffer would pass it."""
    plan = hf.fft_plan(n, True)
    r0 = plan.radices[0]
    rows = hf.mixed_schedule(n, True) >> hf.MIXED_ROWS_SHIFT
    half = hf.mixed_schedule(n, True, half=True) >> hf.MIXED_ROWS_SHIFT
    assert hf.mixed_schedule(n, True, half=True) & (
        (1 << hf.MIXED_ROWS_SHIFT) - 1) == plan.schedule
    assert hf.mixed_smem(n, r0, rows) <= hf.MIXED_SMEM
    assert hf.mixed_smem(n, r0, half, half=True) <= hf.MIXED_SMEM
    assert half * n % 2 == 0 and half * n <= hf.MIXED_POINTS
    if hf.mixed_smem(n, r0, rows, half=True) <= hf.MIXED_SMEM:
        assert half == rows
    else:
        assert half < rows
    assert hf._stage_bytes(n, half, half=True) % 16 == 0
    assert hf._stage_bytes(n, half, half=True) - hf._stage_bytes(n, half) \
        == (16 if n % 2 == 0 else 8) * half


def test_kernel3_rows_capped_only_at_ten_points():
    capped = [n for n in MIXED if hf.mixed_schedule(n, True, half=True)
              != hf.mixed_schedule(n, True)]
    assert capped == [10]
    assert hf.mixed_schedule(10, True) >> hf.MIXED_ROWS_SHIFT == 256
    assert hf.mixed_schedule(10, True, half=True) >> hf.MIXED_ROWS_SHIFT \
        == 255


def test_stage_bytes_agree_with_the_kernel_source():
    """The kernel sizes its buffers by the Body's ``stage_bytes(g)`` and
    ``launch_mixed`` its shared memory by it (``mixed_smem``,
    ``MIXED_SMEM``, ``STAGES``), as ``hf.mixed_smem`` does; stage.cu's
    kernels 1, 3 and 5 dispatch on n to both of the engine's kernels."""
    rows_src = (CSRC / "fft_rows.cuh").read_text()
    stage_src = (CSRC / "stage.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             rows_src).group(1))

    assert const("MIXED_SMEM") == hf.MIXED_SMEM
    assert const("STAGES") == hf.STAGES
    assert "const int SB = body.stage_bytes(g);" in rows_src
    assert "mixed_smem(g, body.stage_bytes(g))" in rows_src
    assert "if (smem > MIXED_SMEM) return cudaErrorInvalidValue;" in rows_src
    smem = re.search(r"inline size_t mixed_smem\(const MixedPlan& g, "
                     r"int stage\) \{(.*?)\n\}", rows_src, re.S).group(1)
    assert re.sub(r"\s+", " ", smem).strip() == (
        "return 128 + 8 * (size_t)g.tld + STAGES * (size_t)stage + "
        "16 * (size_t)g.padded;")

    # The mixed launches of stage.cu: kernels 1, 2, 3, 4 and 5.
    launches = re.findall(r"launch_mixed\(n, schedule, body, table, "
                          r"(\w+), st\)", stage_src)
    assert len(launches) == 5
    for entry in ("dfft_rdft_tw", "dfft_c2r", "dfft_rdft"):
        body = stage_src[stage_src.index(f"int {entry}("):]
        body = body[:body.index("\n}")]
        assert "fft_rows::launch_mixed(" in body
        assert "fft_rows::launch(n, schedule" in body
