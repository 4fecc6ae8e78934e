"""The row FFT engine's mixed-radix kernel (``fft_mixed_kernel`` in
``csrc/fft_rows.cuh``): its host side and the bodies it carries, on the
CPU.

* ``fft_plan(n, inverse)`` at every 13-smooth length in [8, 512] that is
  not a power of two (``MIXED_LENGTHS``, 155 of them, the 92 7-smooth and
  55 5-smooth ones among them): radices of the kernel's that multiply to
  n, the packed schedule, the twiddle table of n - radix[0] entries from
  its documented layout; ``mixed_geometry``'s batch; the 7-smooth lengths'
  radices and schedules as they were before radix 11 and 13.
* ``fft_rows_mirror`` (the kernel's passes: ``_dft_small_mirror``'s radix
  3, 5, 7, 11, 13 and composite butterflies) against ``torch.fft`` at
  every length, both directions (1e-5, float32 against float64), and
  against the JAX package's ``pallas_fft._stage`` with ``_dft_np`` (its
  Pallas kernel in interpret mode; 5e-4, the JAX per-stage bound) at 480,
  320, 96, 375, 448, 343, 490, 504, 416, 440, 143 and 429: kernel 2's FFT
  body on the kernel.
* Kernel 4 on the kernel (``cdft_tw_mirror``: the engine, then the twiddle
  by ``r % n1``) at n2 320, 480, 448 and 416, n1 2 and 9, both directions,
  against ``stage_plain`` and the JAX ``_call_stage`` with the twiddle.
* Kernel 6's three passes on the kernel (``zy_fwd_mirror``) at 5-, 7-, 11-
  and 13-smooth Y and Z, against ``zy_fwd_plain`` and, followed by
  ``x_c2c_plain``, the JAX ``_rfftn3d_fused`` in interpret mode (5e-4).
* The routes: ``_zy_engine_body`` (kernels 6 and 8, engine lengths, Y
  even), ``_zy_body`` (the power-of-two kernel for both of their passes:
  powers of two only), ``_cdft_body`` (kernels 1-5, 13-smooth) and
  ``_fft_body`` (kernel 11, powers of two only), and the launches of
  ``zy_fwd``, ``cdft``, ``cdft_tw``, a
  4320-point axis, the 448^3 slab plan and ``chip_smoke.py``'s 256 x
  480^2, 64 x 896^2, 64 x 832^2 and 256 x 440^2 batched stacks with the
  launch patched.
"""

import math

import numpy as np
import pytest
import torch

from distributedfft_tpu.ops import mxu_fft as jmx
from distributedfft_tpu.ops import pallas_fft
from distributedfft_tpu_torch.ops import hopper_fft as hf

CPU = torch.device("cpu")
MIXED = list(hf.MIXED_LENGTHS)
MIXED7 = [n for n in MIXED if n % 11 and n % 13]   # the 7-smooth ones
MIXED5 = [n for n in MIXED7 if n % 7]              # the 5-smooth ones
# The radices the kernel had before radix 11 and 13.
RADICES7 = tuple(r for r in hf.MIXED_RADICES if r not in (11, 13))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def _complex(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _real(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_mixed_lengths():
    smooth = [n for n in range(8, 513) if n & (n - 1) and
              2 ** 9 * 3 ** 6 * 5 ** 4 * 7 ** 4 * 11 ** 3 * 13 ** 3 % n == 0]
    assert list(hf.MIXED_LENGTHS) == smooth
    assert len(MIXED) == 155 and MIXED[0] == 9 and MIXED[-1] == 507
    smooth7 = [n for n in range(8, 513)
               if n & (n - 1) and 2 ** 9 * 3 ** 6 * 5 ** 4 * 7 ** 4 % n == 0]
    assert MIXED7 == smooth7
    assert len(MIXED7) == 92 and MIXED7[0] == 9 and MIXED7[-1] == 504
    assert len(MIXED5) == 55 and MIXED5[-1] == 500
    assert len([n for n in MIXED7 if n % 7 == 0]) == 37
    assert len([n for n in MIXED if n % 11 == 0]) == 35
    assert len([n for n in MIXED if n % 13 == 0]) == 31
    assert {416, 440, 143, 429, 11, 13} <= set(MIXED)
    assert not {408, 442, 17, 520} & set(MIXED)


@pytest.mark.parametrize("n", MIXED)
def test_fft_plan_schedule_and_table(n):
    plan = hf.fft_plan(n, False)
    inv = hf.fft_plan(n, True)
    assert plan.radices == inv.radices and plan.schedule == inv.schedule
    assert math.prod(plan.radices) == n
    assert all(r in hf.MIXED_RADICES for r in plan.radices)
    assert list(plan.radices) == sorted(plan.radices, reverse=True)
    # The fewest passes: one radix, else two where n splits into two.
    R = hf.MIXED_RADICES
    fewest = (1 if n in R else 2 if any(n % r == 0 and n // r in R for r in R)
              else 3)
    assert len(plan.radices) == fewest
    assert [(plan.schedule >> (5 * p)) & 31
            for p in range(len(plan.radices))] == list(plan.radices)
    assert plan.schedule >> (5 * len(plan.radices)) == 0
    assert plan.table.dtype == np.float32 and plan.table.flags.c_contiguous
    assert plan.table.shape == (2, n - plan.radices[0])
    want, ns = [], plan.radices[0]
    for r in plan.radices[1:]:
        for m in range(1, r):
            for k in range(ns):
                want.append(np.exp(-2j * np.pi * m * k / (ns * r)))
        ns *= r
    want = np.asarray(want, np.complex128)
    got = plan.table[0] + 1j * plan.table[1].astype(np.float64)
    assert np.max(np.abs(got - want), initial=0.0) <= 6e-8
    assert np.array_equal(inv.table[1], -plan.table[1])
    g = hf.mixed_geometry(n)
    assert g.points == g.rows * n and g.points % 2 == 0
    # 455 = 13 x 7 x 5 idles 42.4% (4 rows a batch: 140 butterflies of
    # radix 13 over 256 lanes); every 7-smooth length below 42%.
    assert g.points <= hf.MIXED_POINTS
    assert 0.0 <= g.idle < (0.42 if n in MIXED7 else 0.43)
    # The mixed-radix kernel's schedule: the plan's, then the batch's rows.
    for p, inverse in ((plan, False), (inv, True)):
        sched = hf.mixed_schedule(n, inverse)
        assert sched & ((1 << hf.MIXED_ROWS_SHIFT) - 1) == p.schedule
        assert sched >> hf.MIXED_ROWS_SHIFT == g.rows


def test_fft_plan_examples():
    assert hf.fft_plan(480, False).radices == (12, 10, 4)
    assert hf.fft_plan(320, False).radices == (10, 8, 4)
    assert hf.fft_plan(9, False).radices == (9,)
    assert hf.fft_plan(448, False).radices == (8, 8, 7)
    assert hf.fft_plan(343, False).radices == (7, 7, 7)
    assert hf.fft_plan(14, False).radices == (14,)
    assert hf.fft_plan(490, False).radices == (14, 7, 5)
    g = hf.mixed_geometry(480)
    assert (g.rows, g.points) == (5, 2400) and 0.17 < g.idle < 0.18
    g = hf.mixed_geometry(448)
    assert (g.rows, g.points) == (4, 1792) and 0.08 < g.idle < 0.09
    idle = [hf.mixed_geometry(n).idle for n in MIXED5]
    assert 0.12 < sum(idle) / len(idle) < 0.14
    idle = [hf.mixed_geometry(n).idle for n in MIXED7]
    assert 0.15 < sum(idle) / len(idle) < 0.16
    idle = [hf.mixed_geometry(n).idle for n in MIXED]
    assert 0.17 < sum(idle) / len(idle) < 0.18
    assert hf.fft_plan(416, False).radices == (16, 13, 2)
    assert hf.fft_plan(440, False).radices == (11, 10, 4)
    assert hf.fft_plan(429, False).radices == (13, 11, 3)
    assert hf.fft_plan(143, False).radices == (13, 11)
    assert hf.fft_plan(11, False).radices == (11,)
    assert hf.fft_plan(13, False).radices == (13,)
    g = hf.mixed_geometry(416)
    assert (g.rows, g.points) == (6, 2496) and g.idle == 0.25
    g = hf.mixed_geometry(440)
    assert (g.rows, g.points) == (5, 2200) and 0.21 < g.idle < 0.22


@pytest.mark.parametrize("n", MIXED7)
def test_seven_smooth_plans_unchanged(monkeypatch, n):
    """Radix 11 and 13 only add lengths: every 7-smooth length keeps the
    radices and the batch it had on the kernel's earlier radices."""
    monkeypatch.setattr(hf, "MIXED_RADICES", RADICES7)
    before = hf._mixed_radices(n)
    monkeypatch.undo()
    assert hf.fft_plan(n, False).radices == before
    assert hf.fft_plan(n, True).radices == before
    assert all(r not in (11, 13) for r in before)
    assert hf.mixed_schedule(n, False) == (
        sum(r << (5 * p) for p, r in enumerate(before))
        | hf._batch_rows(n, before) << hf.MIXED_ROWS_SHIFT)


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("n", MIXED)
def test_mirror_matches_torch_fft(n, inverse):
    z = torch.from_numpy(_complex((5, n), n))
    got = hf.fft_rows_mirror(z, inverse)
    z64 = z.to(torch.complex128)
    want = (torch.fft.ifft(z64, norm="forward") if inverse
            else torch.fft.fft(z64))
    assert got.dtype == torch.complex64 and got.shape == (5, n)
    assert _rel(got.numpy(), want.numpy()) <= 1e-5


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("r", [3, 5, 6, 7, 9, 10, 11, 12, 13, 14, 15])
def test_butterflies_match_the_dft(r, inverse):
    """Each of the kernel's odd and composite butterflies alone (a one-pass
    length where there is one, else ``_dft_small_mirror`` directly)."""
    a = torch.from_numpy(_complex((4, r, 3), r))
    got = hf._dft_small_mirror(a, inverse)
    sign = 1.0 if inverse else -1.0
    w = np.exp(sign * 2j * np.pi * np.outer(np.arange(r), np.arange(r)) / r)
    want = np.einsum("kj,bjc->bkc", w, a.numpy().astype(np.complex128))
    assert _rel(got.numpy(), want) <= 1e-6


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("n", [480, 320, 96, 375, 448, 343, 490, 504, 416,
                               440, 143, 429])
def test_mirror_matches_jax_stage(n, inverse):
    """Against ``pallas_fft._stage`` with the dense DFT, its Pallas kernel
    in interpret mode."""
    z = _complex((3, n), n + 7)
    want = np.asarray(pallas_fft._stage(z, jmx._dft_np(n, inverse, False)))
    got = hf.fft_rows_mirror(torch.from_numpy(z), inverse).numpy()
    assert _rel(got, want) <= 5e-4


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("n1", [2, 9])
@pytest.mark.parametrize("n2", [320, 480, 448, 416])
def test_kernel4_mixed_rows_path(n2, n1, inverse):
    """Kernel 4's FFT body on the mixed-radix kernel: the engine on complex
    rows and the twiddle by ``r % n1`` (an odd M), against ``stage_plain``
    and JAX's ``_call_stage`` with the twiddle."""
    M = 2 * n1 + 1
    x = _complex((M, n2), n2 + n1 + inverse)
    got = hf.cdft_tw_mirror(torch.from_numpy(x), n1, inverse)
    assert got.dtype == torch.complex64 and got.shape == (M, n2)
    plain = hf.stage_plain(torch.from_numpy(x),
                           *hf._planes("dft", n2, inverse, CPU),
                           *hf._twiddle_planes(n1, n2, inverse, CPU))
    assert _rel(got.numpy(), plain.numpy()) <= 1e-5
    assert torch.equal(hf.cdft_tw(torch.from_numpy(x), n1, inverse), plain)
    want = np.asarray(pallas_fft._call_stage(
        x, jmx._dft_np(n2, inverse, False), (n1, n2, inverse)))
    assert _rel(got.numpy(), want) <= 5e-4


def _zy_plain(x):
    X, Y, Z = x.shape
    return hf.zy_fwd_plain(x, *hf._planes("rdft", Z, False, CPU),
                           *hf._planes("dft", Y, False, CPU))


@pytest.mark.parametrize("shape", [(2, 96, 120), (3, 480, 40), (2, 12, 9),
                                   (3, 30, 512), (2, 512, 45), (2, 28, 448),
                                   (2, 14, 56), (2, 26, 22), (2, 22, 143)])
def test_zy_mirror_matches_plain(shape):
    """Kernel 6's three passes at 5-, 7-, 11- and 13-smooth Y and Z (an odd
    Z, a power of two beside a mixed length, 448 = 8 x 8 x 7, 143 = 13 x
    11) against the dense products."""
    assert hf._zy_engine_body(*shape[1:]) == "fft"
    x = torch.from_numpy(_real(shape, sum(shape)))
    yr, yi = hf.zy_fwd_mirror(x)
    pr, pi = _zy_plain(x)
    X, Y, Z = shape
    assert yr.shape == yi.shape == (X, Y, Z // 2 + 1)
    assert _rel(torch.complex(yr, yi).numpy(),
                torch.complex(pr, pi).numpy()) <= 1e-5


@pytest.mark.parametrize("shape", [(2, 96, 120), (3, 480, 40), (2, 14, 143)])
def test_zy_mirror_then_x_matches_rfftn3d_fused(shape):
    """Kernel 6's FFT body on the mixed-radix kernel, then kernel 7's plain
    version, against the JAX package's fused 3D R2C (interpret mode): at
    5-smooth Y and Z, and at Y = 14 = 2 x 7, Z = 143 = 11 x 13 (radices 14,
    13 and 11)."""
    x = _real(shape, 7 + sum(shape))
    assert hf._zy_engine_body(*shape[1:]) == "fft"
    yr, yi = hf.zy_fwd_mirror(torch.from_numpy(x))
    zr, zi = hf.x_c2c_plain(yr, yi, *hf._planes("dft", shape[0], False, CPU))
    want = np.asarray(pallas_fft._rfftn3d_fused(x))
    assert _rel(torch.complex(zr, zi).numpy(), want) <= 5e-4


def test_routes(monkeypatch):
    """Kernels 6 and 8 take the engine where Y and Z are each an engine
    length up to 512 and Y is even (448 = 8 x 8 x 7, 416, 440 and
    13-smooth lengths among them), on its power-of-two kernel only where
    ``_zy_body`` says so (both powers of two), and keep their dense body
    on an odd Y and on a length with a prime factor past 13 (408 = 24 x
    17, 442 = 2 x 13 x 17); kernels 2 and 4 take the engine on 13-smooth
    lengths up to 512 (416 = 32 x 13, 440 = 8 x 5 x 11 among them) and
    their tile body on a length with a factor past 13, and so do kernels 1
    (``rdft``), 3 (``irdft``) and 5 (``rdft_tw``), which route by
    ``_cdft_body`` too; the other kernels' ``_fft_body`` (kernel 11, the
    column and short-stage bodies) stays powers of two."""
    for y, z in ((480, 480), (96, 120), (480, 40), (12, 10), (512, 480),
                 (480, 512), (8, 9), (500, 375), (448, 448), (480, 448),
                 (448, 480), (416, 440), (26, 22), (14, 56), (28, 448),
                 (22, 143), (512, 11)):
        assert hf._zy_engine_body(y, z) == "fft", (y, z)
        assert hf._zy_body(y, z) == "dense", (y, z)
    for y, z in ((15, 480), (480, 7), (4, 480), (480, 2), (6, 12),
                 (514, 480), (480, 1024), (13, 448), (143, 26), (448, 17),
                 (408, 448), (448, 442), (34, 480)):
        assert hf._zy_engine_body(y, z) == "dense", (y, z)
    assert hf._zy_engine_body(512, 512) == hf._zy_body(512, 512) == "fft"
    assert [(y, z) for y in range(1, 600) for z in (8, 448, 507, 1024)
            if hf._zy_engine_body(y, z) == "fft"] == [
        (y, z) for y in range(8, 513, 2) for z in (8, 448, 507)
        if hf._engine_length(y)]
    pow2 = [8, 16, 32, 64, 128, 256, 512, 1024]
    fft = [n for n in range(1, 2100) if hf._cdft_body(n) == "fft"]
    assert fft == sorted(MIXED + pow2)
    assert [n for n in range(1, 2100) if hf._fft_body(n) == "fft"] == pow2
    for n in (320, 480, 9, 500, 448, 14, 343, 504, 20, 416, 440, 11, 13,
              143, 429):
        assert hf._cdft_body(n) == "fft"
        assert hf._fft_body(n) == "tile"
    for n in (7, 520, 1000, 206, 408, 442, 17, 4):
        assert hf._cdft_body(n) == "tile"
    # Kernels 3 and 5 on rows, launches recorded on "meta" tensors: the
    # engine at 13-smooth lengths, the tile body past 13 or 512.
    log = _record_launches(monkeypatch)
    for n in (320, 480, 375, 416, 440, 448, 9, 507, 408, 442, 520):
        del log[:]
        hf.irdft(torch.zeros((3, n // 2 + 1), dtype=torch.complex64,
                             device="meta"), n)
        hf.rdft_tw(torch.zeros((3, n), device="meta"), 2)
        tile = n in (408, 442, 520)
        assert [(k, e) for k, e, _ in log] == (
            [("c2r", "dfft_stage"), ("rmatmul_tw", "dfft_stage")] if tile
            else [("c2r", "dfft_c2r"), ("rmatmul_tw", "dfft_rdft_tw")]), n


def _record_launches(monkeypatch):
    """Make every wrapper take its CUDA route, recording each launch as
    (counter, C entry point, arguments) instead of running it (meta tensors
    allocate nothing)."""
    log = []
    for name in ("_check_rows", "_check", "_check_cols", "_check_short",
                 "_check_tw_cols"):
        monkeypatch.setattr(hf, name, lambda *a, **k: False)
    monkeypatch.setattr(hf, "_launch", lambda kernel, fn, *args:
                        log.append((kernel, fn, args)))
    return log


@pytest.mark.parametrize("shape", [(3, 480, 480), (2, 96, 120), (4, 448, 448),
                                   (2, 15, 480), (2, 512, 512), (2, 26, 22),
                                   (2, 416, 440), (2, 408, 448)])
def test_zy_fwd_launches(monkeypatch, shape):
    """Off the CPU, ``zy_fwd`` launches the three passes where
    ``_zy_engine_body`` says "fft" (the schedules of Z and Y: the mixed-radix
    kernel's, with the rows of a batch, unless both are powers of two),
    else the dense kernel once."""
    log = _record_launches(monkeypatch)
    X, Y, Z = shape
    hf.zy_fwd(torch.zeros(shape))
    if hf._zy_engine_body(Y, Z) == "dense":
        assert [e for _, e, _ in log] == ["dfft_zy_fwd"]
        return
    assert [(k, e) for k, e, _ in log] == [
        ("zy_fwd", "dfft_zy_rows"), ("zy_fwd", "dfft_zy_cols"),
        ("zy_fwd", "dfft_zy_planes")]
    pow2 = hf._zy_body(Y, Z) == "fft"
    zs, ys = (hf.fft_plan(n, False).schedule if pow2
              else hf.mixed_schedule(n, False) for n in (Z, Y))
    assert log[0][2][3:] == (X, Y, Z, zs)
    assert log[1][2][2:] == (X, Y, Z, ys)


@pytest.mark.parametrize("n2", [320, 480, 448, 416, 440, 408])
def test_cdft_tw_launches(monkeypatch, n2):
    """Kernel 4 at a 13-smooth n2 launches its FFT body with the mixed
    schedule (448 = 8 x 8 x 7, 416 = 16 x 13 x 2 among them), at 408 = 24
    x 17 its tile body."""
    log = _record_launches(monkeypatch)
    x = torch.zeros((18, n2), dtype=torch.complex64, device="meta")
    hf.cdft_tw(x, 9, True)
    ((kernel, entry, args),) = log
    assert kernel == "cmatmul_tw"
    if n2 == 408:
        assert entry == "dfft_stage"
    else:
        assert entry == "dfft_cdft_tw"
        assert args[5:] == (18, n2, 9, hf.mixed_schedule(n2, True), 1)


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("n", [480, 448, 20, 512, 440, 416, 442, 408])
def test_cdft_launches(monkeypatch, n, inverse):
    """Kernel 2 on rows: ``dfft_cdft`` with ``mixed_schedule(n, inverse)``
    at a 13-smooth n (480, 448, 440, 416, the verifier's 20-point x), with
    the power-of-two kernel's schedule at 512, and its tile body
    (``dfft_stage`` with the DFT planes) at 442 and 408."""
    log = _record_launches(monkeypatch)
    x = torch.zeros((7, n), dtype=torch.complex64, device="meta")
    y = hf.cdft(x, inverse)
    assert y.shape == (7, n) and y.dtype == torch.complex64
    ((kernel, entry, args),) = log
    assert kernel == "cmatmul"
    if n in (442, 408):
        assert entry == "dfft_stage"
        assert args[6:] == (7, n, n, 1, 0, 0)
        return
    assert entry == "dfft_cdft"
    sched = (hf.fft_plan(n, inverse).schedule if n == 512
             else hf.mixed_schedule(n, inverse))
    assert args[3:] == (7, n, sched, int(inverse))
    assert args[1] is hf._fft_table(n, inverse, x.device)   # fft_plan's


# chip_smoke.py's batched stacks on the mixed-radix kernel, one call a
# direction: (shape, launches forward, inverse as (kernel, entry) pairs).
_DIRECT_ENGINE = (
    [("rmatmul", "dfft_rdft"), ("cmatmul", "dfft_cdft")],
    [("cmatmul", "dfft_cdft"), ("c2r", "dfft_c2r")])
_SPLIT_ENGINE = (
    [("rmatmul_tw", "dfft_rdft_tw"), ("cmatmul", "dfft_cdft_short"),
     ("cmatmul_tw", "dfft_cdft_tw"), ("cmatmul", "dfft_cdft_short")],
    [("cmatmul_tw", "dfft_cdft_tw"), ("cmatmul", "dfft_cdft_short"),
     ("c2r", "dfft_c2r_packed")])
_BATCHED_ENGINE = {(256, 480, 480): _DIRECT_ENGINE,
                   (64, 896, 896): _SPLIT_ENGINE,
                   (64, 832, 832): _SPLIT_ENGINE,
                   (256, 440, 440): _DIRECT_ENGINE}


def _chip_smoke():
    import importlib.util
    import pathlib
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("shape", list(_BATCHED_ENGINE))
def test_batched_stacks_run_kernels_2_and_4_on_the_engine(monkeypatch,
                                                         shape):
    """The "pallas" batched-2D plan at 256 x 480^2 and 256 x 440^2 (x moved
    last, kernel 2 on the mixed-radix kernel at 480 = 12 x 10 x 4 and 440
    = 11 x 10 x 4, and the forward's y R2C, kernel 1, and the inverse's y
    C2R, kernel 3, on it too) and 64 x 896^2 and 64 x 832^2 (both axes 2 x 448
    or 2 x 416: kernel 4 on the mixed-radix kernel, the 2-point short
    stage, and the forward's first stage, kernel 5, on the mixed-radix
    kernel; the inverse's y C2R one launch of kernel 3's packed body on
    it, 448 or 416 points), recorded on "meta" tensors: none of kernels 1-5 reaches
    ``dfft_stage``, and the entries are the ones ``chip_smoke.py``'s
    ``BATCHED_CARD`` counts and ``BATCHED_ENGINE`` names a direction."""
    smoke = _chip_smoke()
    from distributedfft_tpu_torch import Batched2DFFTPlan, Config
    from distributedfft_tpu_torch import SlabPartition
    log = _record_launches(monkeypatch)
    plan = Batched2DFFTPlan(*shape, SlabPartition(1),
                            Config(fft_backend="pallas"), device="cpu")
    c = plan._build(True)(torch.zeros(shape, device="meta"))
    fwd = [(k, e) for k, e, _ in log]
    del log[:]
    back = plan._build(False)(c)
    inv = [(k, e) for k, e, _ in log]
    assert c.shape == shape[:2] + (shape[2] // 2 + 1,)
    assert back.shape == shape
    assert (fwd, inv) == _BATCHED_ENGINE[shape]
    for pairs in (fwd, inv):
        for kernel in ("rmatmul", "cmatmul", "cmatmul_tw", "c2r",
                       "rmatmul_tw"):
            assert (kernel, "dfft_stage") not in pairs
    (pid,) = [p for p, v in smoke.BATCHED_CARD.items() if v[0] == shape]
    _, _, ent_f, ent_i = smoke.BATCHED_CARD[pid][1]
    for pairs, want in ((fwd, ent_f), (inv, ent_i)):
        got = {}
        for _, e in pairs:
            got[e] = got.get(e, 0) + 1
        assert got == want
    for pairs, kernels in zip((fwd, inv), smoke.BATCHED_ENGINE[pid]):
        seen = {}
        for p in pairs:
            seen[p] = seen.get(p, 0) + 1
        assert {k for k, e in pairs
                if smoke.ENGINE_ENTRY.get(k) == e} == set(kernels)
        smoke.on_the_engine(seen, pid, kernels)


def test_slab_448_runs_kernel6_on_the_engine(monkeypatch):
    """The "pallas" 448^3 slab plan on one rank (ZY_Then_X, the fused
    path), recorded on "meta" tensors: forward kernel 6's three passes on
    the mixed-radix kernel (448 = 8 x 8 x 7 on both) and kernel 7 on the
    mixed-radix column kernel, inverse kernel 7 on it and kernel 8's three
    passes on the mixed-radix kernel (its z pass with kernel 3's rows); the
    launches and entries ``chip_smoke.py``'s ``FUSED_SLABS`` counts for
    it."""
    smoke = _chip_smoke()
    from distributedfft_tpu_torch import Config, GlobalSize, SlabFFTPlan
    from distributedfft_tpu_torch import SlabPartition
    shape, (want_f, want_i, ent_f, ent_i) = smoke.FUSED_SLABS["fused_448"]
    assert shape == (448, 448, 448)
    log = _record_launches(monkeypatch)
    plan = SlabFFTPlan(GlobalSize(*shape), SlabPartition(1),
                       Config(fft_backend="pallas"), device="cpu")
    c = plan._build_r2c()(torch.zeros(shape, device="meta"))
    fwd = list(log)
    del log[:]
    back = plan._build_c2r()(c)
    inv = list(log)
    assert c.shape == (448, 448, 225) and back.shape == shape
    assert [e for _, e, _ in fwd] == ["dfft_zy_rows", "dfft_zy_cols",
                                      "dfft_zy_planes", "dfft_x_mixed"]
    assert fwd[0][2][3:] == (448, 448, 448, hf.mixed_schedule(448, False))
    assert fwd[1][2][2:] == (448, 448, 448, hf.mixed_schedule(448, False))
    assert [e for _, e, _ in inv] == ["dfft_x_mixed", "dfft_yz_scratch",
                                      "dfft_yz_cols", "dfft_yz_rows"]
    assert inv[2][2][2:] == (448, 448, 448, hf.mixed_schedule(448, True))
    assert inv[3][2][3:] == (448, 448, 448,
                             hf.mixed_schedule(448, True, half=True))
    for got, launches, entries in ((fwd, want_f, ent_f), (inv, want_i, ent_i)):
        per_kernel, per_entry = {}, {}
        for k, e, _ in got:
            per_kernel[k] = per_kernel.get(k, 0) + 1
            per_entry[e] = per_entry.get(e, 0) + 1
        assert per_kernel == launches and per_entry == entries


@pytest.mark.parametrize("fn", ["fft", "ifft", "irfft", "rfft"])
def test_4320_axis_runs_kernel4_on_the_engine(monkeypatch, fn):
    """The convolver's 5-smooth 4320 = 9 x 480 (``good_size``): kernel 4's
    first stage launches ``dfft_cdft_tw`` and kernel 5's (the real input
    of rfft) ``dfft_rdft_tw``, both on the mixed-radix kernel, never
    ``dfft_stage``; irfft's complex inverse is of 2160 = 5 x 432 points,
    after kernel 3's pack pass, its first stage kernel 4 at 432 on the
    mixed-radix kernel."""
    log = _record_launches(monkeypatch)
    if fn == "rfft":
        hf.rfft(torch.zeros((2, 4320), device="meta"), axis=-1)
    elif fn == "irfft":
        hf.irfft(torch.zeros((2, 2161), dtype=torch.complex64,
                             device="meta"), n=4320, axis=-1)
    else:
        x = torch.zeros((4320, 2), dtype=torch.complex64, device="meta")
        getattr(hf, fn)(x, axis=0)
    entries = [(k, e) for k, e, _ in log]
    assert all(e != "dfft_stage" for _, e in entries)
    if fn == "rfft":
        assert entries == [("rmatmul_tw", "dfft_rdft_tw"),
                           ("cmatmul", "dfft_cdft_short")]
        assert log[0][2][5:] == (2 * 9, 480, 9,
                                 hf.mixed_schedule(480, False))
    elif fn == "irfft":
        assert entries == [("c2r", "dfft_c2r_pack"),
                           ("cmatmul_tw", "dfft_cdft_tw"),
                           ("cmatmul", "dfft_cdft_short")]
        assert log[0][2][3:] == (2, 2160, 5)
        assert log[1][2][5:] == (2 * 5, 432, 5,
                                 hf.mixed_schedule(432, True), 1)
    else:
        assert entries == [("cmatmul_tw", "dfft_cdft_tw"),
                           ("cmatmul", "dfft_cdft_short")]


def test_kernel_source_agrees_with_the_host_side():
    """The constants ``fft_plan`` and ``mixed_schedule`` assume are the
    kernel's: its batch cap, longest row, block size, the schedule's rows
    field and radices (admitted, dispatched and given a butterfly:
    ``dft_small``'s branches, its composites the mirror's ``_CT``, the
    float32 constants of radix 5, 7, 11 and 13 the mirror's ``_ODD``)
    (``csrc/fft_rows.cuh``), so the host never plans a length the kernel
    refuses."""
    import pathlib
    import re
    src = (pathlib.Path(hf.__file__).parent.parent / "csrc"
           / "fft_rows.cuh").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("MIXED_POINTS") == hf.MIXED_POINTS
    assert const("MIXED_MAX") == hf.MIXED_MAX
    assert const("THREADS") == hf.THREADS
    assert const("MIXED_ROWS_SHIFT") == hf.MIXED_ROWS_SHIFT
    assert const("MIXED_SMEM") == hf.MIXED_SMEM
    # Every Body the mixed-radix kernel runs sizes its input buffer by its
    # own stage_bytes(g): 8 g.points bytes, kernel 3's half spectra 16
    # g.rows (g.n / 2 + 1) (``hf._stage_bytes``).
    stage_src = (pathlib.Path(hf.__file__).parent.parent / "csrc"
                 / "stage.cu").read_text()
    fused_src = (pathlib.Path(hf.__file__).parent.parent / "csrc"
                 / "fused3d.cu").read_text()

    def stage_bytes(text, name):
        start = text.index(f"struct {name}")
        return re.findall(
            r"static int stage_bytes\(const (?:fft_rows::)?MixedPlan& g\) "
            r"\{\s*return ([^;]+);", text[start:text.index("\n};", start)])

    for text, name, want in (
            (src, "ComplexTwiddleRows", "8 * g.points"),
            (stage_src, "RealRowPairs", "8 * g.points"),
            (stage_src, "HalfRows", "16 * g.rows * (g.n / 2 + 1)"),
            (fused_src, "ZRows", "8 * g.points")):
        assert stage_bytes(text, name) == [want], name
    g = hf.mixed_geometry(480)
    assert hf._stage_bytes(480, g.rows) == 8 * g.points
    assert hf._stage_bytes(480, g.rows, half=True) == 16 * g.rows * 241
    body = re.search(r"inline bool mixed_radix\(int r\) \{(.*?)\n\}", src,
                     re.S).group(1)
    cases = {int(c) for c in re.findall(r"case (\d+):", body)}
    assert cases == set(hf.MIXED_RADICES)
    dispatch = re.search(r"void with_radix\(int r, F&& f\) \{(.*?)\n\}", src,
                         re.S).group(1)
    assert {int(c) for c in re.findall(r"case (\d+):", dispatch)} == cases
    small = re.search(r"void dft_small\(float2\* a, float sgn\) \{(.*?)\n\}",
                      src, re.S).group(1)
    composite = {int(r): (int(p), int(q)) for r, p, q in re.findall(
        r"R == (\d+)[^;{]*[;{]\s*dft_ct<(\d+), (\d+)>", small)}
    assert composite == hf._CT
    odd = {int(r) for r in re.findall(r"R == (\d+)\) \{\s*dft\1\(", small)}
    assert odd == {3, 5, 7, 11, 13}
    assert {r for r in cases if r & (r - 1)} == odd | set(composite)
    for r, (c, s) in hf._ODD.items():
        body = re.search(rf"void dft{r}\(float2\* a, float sgn\) \{{(.*?)\n\}}",
                         src, re.S).group(1)
        lit = {name: np.float32(v) for name, v in re.findall(
            r"constexpr float (\w+) = (-?[\d.]+)f;", body)}
        h = r // 2
        assert len(lit) == 2 * h
        assert [lit[f"C{m}"] for m in range(1, h + 1)] == list(c)
        assert [lit[f"S{m}"] for m in range(1, h + 1)] == list(s)
