"""Kernel 8's FFT body and kernel 1's on the row FFT engine's mixed-radix
kernel (``fft_mixed_kernel`` in ``csrc/fft_rows.cuh`` with fused3d.cu's
``YZRows`` and stage.cu's ``RealRows``), on the CPU.

* Kernel 8 (``yz_inv_mirror``: the (X, Y, Zo) planes transposed into the
  (X, Zo, Y) scratch, the engine's inverse on its y rows, kernel 3's C2R
  Body on the gathered z rows) at even mixed Y (30 and 56 not multiples of
  8, every batch of the z pass crossing x-planes at 30, 56 and 96) and
  mixed Z, odd ones among them (39, 45, 75), against ``yz_inv_plain``
  (1e-5: float32 on both sides, sums in another order) and, after
  ``x_c2c_plain``'s inverse, the JAX package's
  ``pallas_fft._irfftn3d_fused`` (its Pallas kernels in interpret mode;
  5e-4, the JAX per-stage bound), on random spectra.
* Kernel 1 (``rdft_mirror``: real rows 2c and 2c + 1 packed as one
  complex row, the engine's passes, the split, bins 0..n/2 kept) at n 480,
  440, 375 and 39 on an odd row count, against ``stage_plain`` and JAX's
  ``_stage`` with the R2C planes.
* Pass 3's gather replayed (``_gather_replay``: ``YZRows::issue``'s parts
  and ``YZRows::load``'s reads on the mixed-radix kernel) over every
  batch of shapes whose batches cross planes: the rows it loads are the
  scratch transposed, every part 16-byte aligned, no slot written twice.
* The routes, launches recorded with ``_launch`` patched: ``yz_inv``
  takes ``dfft_yz_scratch`` / ``dfft_yz_cols`` / ``dfft_yz_rows`` with the
  mixed schedules at a mixed (Y, Z) and ``dfft_yz_inv`` at an odd Y or a
  prime past 13; ``rdft`` takes ``dfft_rdft`` with ``mixed_schedule`` at
  a 13-smooth n and ``dfft_stage`` at 442 and 520.
* The block's shared memory: ``YZRows``' and ``RealRows``' buffers pinned
  to the source, both blocks within ``MIXED_SMEM`` (two an SM) at every
  length the mixed-radix kernel runs.
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
CSRC = pathlib.Path(hf.__file__).parent.parent / "csrc"
# Lengths the mixed-radix kernel runs: the 155 13-smooth ones and, beside
# them on kernel 8's passes, the powers of two up to 512.
ENGINE = list(hf.MIXED_LENGTHS) + [8, 16, 32, 64, 128, 256, 512]
# (X, Y, Z): Y even, 30 and 56 not multiples of 8; Z odd at 39, 45, 75.
SHAPES = [(2, 30, 39), (3, 56, 45), (2, 96, 75), (4, 30, 40), (2, 56, 96)]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def _real(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _spectrum(shape, seed):
    """Random (X, Y, Z // 2 + 1) float32 planes of a half spectrum."""
    X, Y, Z = shape
    half = (X, Y, Z // 2 + 1)
    return (torch.from_numpy(_real(half, seed)),
            torch.from_numpy(_real(half, seed + 1)))


def _half_rows(Z):
    """The rows of a batch of kernel 8's z pass: kernel 3's."""
    return hf.mixed_schedule(Z, True, half=True) >> hf.MIXED_ROWS_SHIFT


def _block(n, rows, stage):
    """Shared memory a block of the mixed-radix kernel takes on batches of
    ``rows`` rows of n points with input buffers of ``stage`` bytes
    (``mixed_smem`` in fft_rows.cuh; ``hf.mixed_smem`` with another
    buffer)."""
    r0 = hf.fft_plan(n, True).radices[0]
    return (hf.mixed_smem(n, r0, rows)
            + hf.STAGES * (stage - hf._stage_bytes(n, rows)))


def _pitch(n, rows):
    """``YZRows::pitch``: parts (16 bytes, bin k of two neighbouring y) a
    bin's row of the buffer holds, part (k, c) in slot k P + c; P = rows |
    1, odd so that a row's reads of neighbouring bins fall on distinct
    banks, where three such buffers fit ``MIXED_SMEM``, else rows."""
    odd = rows | 1
    return odd if _block(n, rows, 16 * odd * (n // 2 + 1)) \
        <= hf.MIXED_SMEM else rows


def _yz_stage_bytes(n, rows):
    """``YZRows::stage_bytes(g)``."""
    return 16 * _pitch(n, rows) * (n // 2 + 1)


def _gather_replay(s, z, rows):
    """Kernel 8's mixed z pass gather replayed on the (X, Zo, Y) scratch
    ``s``, batch by batch of 2 ``rows`` real rows: ``YZRows::issue``'s
    parts (k, c), c fastest, each 16 bytes of the scratch (bin k of rows
    (x, y) and (x, y + 1), y even) into slot k P + c of a buffer of
    ``_pitch`` Zo parts, the division only where a pair's y passes a
    plane's end; then ``YZRows::load``'s reads, bin k of complex row c from
    slot k P + c. Returns the (X Y, Zo) half rows the loads see."""
    X, Zo, Y = s.shape
    M, P = X * Y, _pitch(z, rows)
    flat = torch.view_as_real(s.contiguous()).reshape(-1, 2)
    out = torch.empty((M, Zo, 2), dtype=torch.float32)
    for b in range(-(-M // (2 * rows))):
        r0 = 2 * rows * b
        pairs = min(M - r0, 2 * rows) // 2
        x0 = r0 // Y
        y0 = r0 - x0 * Y
        e = torch.arange(pairs * Zo)
        k, c = e // pairs, e % pairs
        y = y0 + 2 * c
        planes = torch.where(y >= Y, y // Y, 0)
        x, y = x0 + planes, y - planes * Y
        src = (x * Zo + k) * Y + y
        assert bool((src % 2 == 0).all())             # 16-byte aligned
        slot = k * P + c
        assert len(set(slot.tolist())) == len(slot)   # no slot twice
        buf = torch.full((P * Zo, 4), float("nan"))
        buf[slot] = torch.cat([flat[src], flat[src + 1]], 1)
        got = buf[torch.arange(Zo)[None, :] * P
                  + torch.arange(pairs)[:, None]]     # (pairs, Zo, 4)
        out[r0:r0 + 2 * pairs:2] = got[..., :2]
        out[r0 + 1:r0 + 2 * pairs:2] = got[..., 2:]
    return torch.view_as_complex(out)


# ---------------------------------------------------------------------------
# Kernel 8
# ---------------------------------------------------------------------------


def test_shapes_take_the_mixed_body_and_cross_planes():
    for X, Y, Z in SHAPES:
        assert hf._zy_engine_body(Y, Z) == "fft"
        assert hf._zy_body(Y, Z) == "dense"     # the mixed-radix kernel
    crossing = [(Y, Z) for _, Y, Z in SHAPES if Y % (2 * _half_rows(Z))]
    assert {Y for Y, _ in crossing} == {30, 56, 96}


@pytest.mark.parametrize("shape", SHAPES)
def test_yz_inv_mirror_matches_plain_and_jax(shape):
    """Kernel 7's plain inverse, then kernel 8's mixed body, against the
    JAX package's fused 3D C2R; kernel 8 alone against its plain
    version."""
    X, Y, Z = shape
    cr, ci = _spectrum(shape, 3 + sum(shape))
    er, ei = hf.x_c2c_plain(cr, ci, *hf._planes("dft", X, True, CPU))
    got = hf.yz_inv_mirror(er, ei, Z)
    assert got.shape == shape and got.dtype == torch.float32
    plain = hf.yz_inv_plain(er, ei, *hf._planes("dft", Y, True, CPU),
                            *hf._planes("c2r", Z, False, CPU))
    assert _rel(got.numpy(), plain.numpy()) <= 1e-5
    assert torch.equal(hf.yz_inv(er, ei, Z), plain)
    want = np.asarray(pallas_fft._irfftn3d_fused(
        torch.complex(cr, ci).numpy(), shape))
    assert _rel(got.numpy(), want) <= 5e-4


@pytest.mark.parametrize("shape", SHAPES + [(3, 30, 420), (2, 12, 10)])
def test_pass3_gather_is_the_scratch_transposed(shape):
    """The z pass's gather, replayed over every batch of 2 rows real rows
    (each batch of Y = 30, 56, 96 crossing x-planes off a batch's edge;
    420 at its even pitch, 10 at 255 rows), loads the scratch transposed:
    row (x, y) bin k from scratch row (x, k)."""
    X, Y, Z = shape
    Zo = Z // 2 + 1
    rng = np.random.default_rng(sum(shape))
    s = torch.from_numpy((rng.standard_normal((X, Zo, Y))
                          + 1j * rng.standard_normal((X, Zo, Y))).astype(
                              np.complex64))
    rows = _half_rows(Z)
    got = _gather_replay(s, Z, rows)
    assert torch.equal(got, s.transpose(1, 2).reshape(X * Y, Zo))


def test_pitch_is_odd_where_it_fits():
    """A bin's row of the buffer is ``rows | 1`` parts (an odd stride: a
    warp's reads of neighbouring bins on distinct banks), except at 420,
    where that would pass ``MIXED_SMEM``."""
    even = [n for n in ENGINE if _pitch(n, _half_rows(n)) % 2 == 0]
    assert even == [420]
    for n in ENGINE:
        rows = _half_rows(n)
        assert _pitch(n, rows) in (rows, rows | 1)


# ---------------------------------------------------------------------------
# Kernel 1
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [480, 440, 375, 39])
def test_rdft_mirror_matches_plain_and_jax(n):
    """Kernel 1's FFT body on the mixed-radix kernel, an odd row count
    (the last real row paired with zeros), odd and even n."""
    assert n in hf.MIXED_LENGTHS
    M = 7
    x = _real((M, n), 13 * n)
    got = hf.rdft_mirror(torch.from_numpy(x))
    assert got.dtype == torch.complex64 and got.shape == (M, n // 2 + 1)
    plain = hf.stage_plain(torch.from_numpy(x),
                           *hf._planes("rdft", n, False, CPU))
    assert _rel(got.numpy(), plain.numpy()) <= 1e-5
    assert torch.equal(hf.rdft(torch.from_numpy(x)), plain)
    want = np.asarray(pallas_fft._stage(
        x, jmx._dft_np(n, False, False)[:, :n // 2 + 1]))
    assert _rel(got.numpy(), want) <= 5e-4


# ---------------------------------------------------------------------------
# Routes (launches recorded, nothing run)
# ---------------------------------------------------------------------------


def _record_launches(monkeypatch):
    log = []
    for name in ("_check_rows", "_check"):
        monkeypatch.setattr(hf, name, lambda *a, **k: False)
    monkeypatch.setattr(hf, "_launch", lambda kernel, fn, *args:
                        log.append((kernel, fn, args)))
    return log


@pytest.mark.parametrize("shape", SHAPES + [
    (512, 480, 480), (512, 448, 448), (2, 30, 512), (2, 512, 480),
    (3, 15, 480), (2, 442, 442), (2, 480, 442), (2, 512, 512)])
def test_yz_inv_routes(monkeypatch, shape):
    """A mixed (Y, Z) takes the three passes on the mixed-radix kernel,
    with ``mixed_schedule(Y, True)`` on the y pass and kernel 3's rows,
    ``mixed_schedule(Z, True, half=True)``, on the z pass, never
    ``dfft_yz_inv``; both powers of two take the power-of-two kernel's
    schedules; an odd Y (15) or a prime past 13 (442 = 2 x 13 x 17) the
    dense kernel once."""
    log = _record_launches(monkeypatch)
    X, Y, Z = shape
    half = torch.zeros((X, Y, Z // 2 + 1), device="meta")
    assert hf.yz_inv(half, half, Z).shape == shape
    if Y % 2 or 442 in (Y, Z):
        assert [(k, e) for k, e, _ in log] == [("yz_inv", "dfft_yz_inv")]
        return
    assert [(k, e) for k, e, _ in log] == [
        ("yz_inv", "dfft_yz_scratch"), ("yz_inv", "dfft_yz_cols"),
        ("yz_inv", "dfft_yz_rows")]
    if hf._zy_body(Y, Z) == "fft":
        ys, zs = hf.fft_plan(Y, True).schedule, hf.fft_plan(Z, True).schedule
    else:
        ys, zs = hf.mixed_schedule(Y, True), hf.mixed_schedule(Z, True,
                                                              half=True)
    assert log[0][2][3:] == (X, Y, Z)
    assert log[1][2][2:] == (X, Y, Z, ys)
    assert log[1][2][1] is hf._fft_table(Y, True, half.device)
    assert log[2][2][3:] == (X, Y, Z, zs)
    assert log[2][2][1] is hf._fft_table(Z, True, half.device)


@pytest.mark.parametrize("n", [480, 440, 448, 375, 39, 12, 512, 1024,
                               442, 520, 4])
def test_rdft_routes(monkeypatch, n):
    """``rdft`` launches ``dfft_rdft`` at every engine length, with
    ``mixed_schedule(n, False)`` at a 13-smooth one; the tile body
    (``dfft_stage`` with the R2C planes) at 442 and 520, and the row path
    at 4 points."""
    log = _record_launches(monkeypatch)
    x = torch.zeros((9, n), device="meta")
    y = hf.rdft(x)
    assert y.shape == (9, n // 2 + 1) and y.dtype == torch.complex64
    ((kernel, entry, args),) = log
    assert kernel == "rmatmul"
    if n in (442, 520, 4):
        assert hf._cdft_body(n) == "tile"
        assert entry == "dfft_stage"
        assert args[6:] == (9, n, n // 2 + 1, 1, 1, 0)
        return
    assert entry == "dfft_rdft"
    assert args[1] is hf._fft_table(n, False, x.device)
    assert args[3:] == (9, n, hf._engine_schedule(n, False))
    if n in hf.MIXED_LENGTHS:
        assert args[-1] == hf.mixed_schedule(n, False)


# ---------------------------------------------------------------------------
# Shared memory: two blocks an SM
# ---------------------------------------------------------------------------


def _struct(text, name):
    start = text.index(f"struct {name}")
    return text[start:text.index("\n};", start)]


def test_stage_bytes_agree_with_the_kernel_source():
    """YZRows sizes its buffer by its own pitch (``_pitch``) and
    RealRows by RealRowPairs' 8 g.points (``hf._stage_bytes``); the
    mixed-radix kernel takes YZRows' issuers, every thread, from the
    Body."""
    fused = (CSRC / "fused3d.cu").read_text()
    stage = (CSRC / "stage.cu").read_text()
    rows_src = (CSRC / "fft_rows.cuh").read_text()
    yz = _struct(fused, "YZRows")
    assert "static constexpr int ISSUERS = fft_rows::THREADS;" in yz
    assert re.findall(r"static int stage_bytes\(const fft_rows::MixedPlan& g\)"
                      r" \{\s*return ([^;]+);", yz) == [
        "16 * pitch(g) * (g.n / 2 + 1)"]
    pitch = re.search(r"static int pitch\(const fft_rows::MixedPlan& g\) "
                      r"\{(.*?)\n  \}", yz, re.S).group(1)
    assert re.sub(r"\s+", " ", pitch).strip() == (
        "const int odd = g.rows | 1; return fft_rows::mixed_smem(g, 16 * "
        "odd * (g.n / 2 + 1)) <= (size_t)fft_rows::MIXED_SMEM ? odd : "
        "g.rows;")
    assert "buf + 16 * (k * P + c)" in yz
    assert "buf + 16 * (k * pitch(g) + c)" in yz
    real = _struct(stage, "RealRows")
    assert "stage_bytes" not in real          # RealRowPairs' buffers
    assert "store(const fft_rows::MixedPlan& g" in real
    kernel = rows_src[rows_src.index("fft_mixed_kernel(const Body body"):]
    kernel = kernel[:kernel.index("\n}\n")]
    assert "init_ring(full, STAGES, ISSUERS);" in kernel
    assert "const bool issuer = ISSUERS == 1 ? tid == 0 : true;" in kernel
    assert kernel.count("if (issuer") == 2 and "tid == 0 &&" not in kernel
    for entry in ("dfft_yz_rows", "dfft_rdft"):
        src = fused if entry == "dfft_yz_rows" else stage
        body = src[src.index(f"int {entry}("):]
        body = body[:body.index("\n}")]
        assert "fft_rows::launch_mixed(" in body
        assert "fft_rows::launch(" in body


@pytest.mark.parametrize("n", ENGINE)
def test_yz_and_rdft_blocks_fit_two_an_sm(n):
    """At every length of the mixed-radix kernel, kernel 8's z pass block
    (kernel 3's rows, ``yz_pitch`` parts a bin) and kernel 1's (the
    complex rows' rows, 8 g.points bytes a buffer) fit ``MIXED_SMEM``."""
    r0 = hf.fft_plan(n, True).radices[0]
    rows = _half_rows(n)
    assert _block(n, rows, _yz_stage_bytes(n, rows)) <= hf.MIXED_SMEM
    assert _block(n, rows, hf._stage_bytes(n, rows, half=True)) \
        == hf.mixed_smem(n, r0, rows, half=True)
    assert _yz_stage_bytes(n, rows) % 16 == 0
    assert _yz_stage_bytes(n, rows) >= hf._stage_bytes(n, rows, half=True)
    rows1 = hf.mixed_schedule(n, False) >> hf.MIXED_ROWS_SHIFT
    assert hf.mixed_smem(n, r0, rows1) <= hf.MIXED_SMEM
    assert rows1 * n % 2 == 0 and rows1 * n <= hf.MIXED_POINTS
