"""The row FFT engine's mixed-radix kernel (``fft_mixed_kernel`` in
``csrc/fft_rows.cuh``): its host side and the bodies it carries, on the
CPU.

* ``fft_plan(n, inverse)`` at every 5-smooth length in [8, 512] that is not
  a power of two (``MIXED_LENGTHS``, 55 of them): radices of the kernel's
  that multiply to n, the packed schedule, the twiddle table of n - radix[0]
  entries from its documented layout; ``mixed_geometry``'s batch.
* ``fft_rows_mirror`` (the kernel's passes: ``_dft_small_mirror``'s radix
  3, 5 and composite butterflies) against ``torch.fft`` at every length,
  both directions (1e-5, float32 against float64), and against the JAX
  package's ``pallas_fft._stage`` with ``_dft_np`` (its Pallas kernel in
  interpret mode; 5e-4, the JAX per-stage bound) at 480, 320, 96 and 375.
* Kernel 4 on the kernel (``cdft_tw_mirror``: the engine, then the twiddle
  by ``r % n1``) at n2 320 and 480, n1 2 and 9, both directions, against
  ``stage_plain`` and the JAX ``_call_stage`` with the twiddle.
* Kernel 6's three passes on the kernel (``zy_fwd_mirror``) at 5-smooth Y
  and Z, against ``zy_fwd_plain`` and, followed by ``x_c2c_plain``, the JAX
  ``_rfftn3d_fused`` in interpret mode (5e-4).
* The routes: ``_zy_fwd_body`` (kernel 6), ``_zy_body`` (kernel 8, powers
  of two only), ``_cdft_tw_body`` (kernel 4) and ``_fft_body`` (kernels 1,
  2, 3, 5 and 11, powers of two only), and the launches of ``zy_fwd``,
  ``cdft_tw`` and a 4320-point axis with the launch patched.
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
    smooth = [n for n in range(8, 513)
              if n & (n - 1) and 2 ** 9 * 3 ** 6 * 5 ** 4 % n == 0]
    assert list(hf.MIXED_LENGTHS) == smooth
    assert len(MIXED) == 55 and MIXED[0] == 9 and MIXED[-1] == 500


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
    assert g.points <= hf.MIXED_POINTS and 0.0 <= g.idle < 0.42
    # The mixed-radix kernel's schedule: the plan's, then the batch's rows.
    for p, inverse in ((plan, False), (inv, True)):
        sched = hf.mixed_schedule(n, inverse)
        assert sched & ((1 << hf.MIXED_ROWS_SHIFT) - 1) == p.schedule
        assert sched >> hf.MIXED_ROWS_SHIFT == g.rows


def test_fft_plan_examples():
    assert hf.fft_plan(480, False).radices == (12, 10, 4)
    assert hf.fft_plan(320, False).radices == (10, 8, 4)
    assert hf.fft_plan(9, False).radices == (9,)
    g = hf.mixed_geometry(480)
    assert (g.rows, g.points) == (5, 2400) and 0.17 < g.idle < 0.18
    idle = [hf.mixed_geometry(n).idle for n in MIXED]
    assert 0.12 < sum(idle) / len(idle) < 0.14


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
@pytest.mark.parametrize("r", [3, 5, 6, 9, 10, 12, 15])
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
@pytest.mark.parametrize("n", [480, 320, 96, 375])
def test_mirror_matches_jax_stage(n, inverse):
    """Against ``pallas_fft._stage`` with the dense DFT, its Pallas kernel
    in interpret mode."""
    z = _complex((3, n), n + 7)
    want = np.asarray(pallas_fft._stage(z, jmx._dft_np(n, inverse, False)))
    got = hf.fft_rows_mirror(torch.from_numpy(z), inverse).numpy()
    assert _rel(got, want) <= 5e-4


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("n1", [2, 9])
@pytest.mark.parametrize("n2", [320, 480])
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
                                   (3, 30, 512), (2, 512, 45)])
def test_zy_mirror_matches_plain(shape):
    """Kernel 6's three passes at 5-smooth Y and Z (an odd Z, a power of
    two beside a mixed length) against the dense products."""
    assert hf._zy_fwd_body(*shape[1:]) == "fft"
    x = torch.from_numpy(_real(shape, sum(shape)))
    yr, yi = hf.zy_fwd_mirror(x)
    pr, pi = _zy_plain(x)
    X, Y, Z = shape
    assert yr.shape == yi.shape == (X, Y, Z // 2 + 1)
    assert _rel(torch.complex(yr, yi).numpy(),
                torch.complex(pr, pi).numpy()) <= 1e-5


@pytest.mark.parametrize("shape", [(2, 96, 120), (3, 480, 40)])
def test_zy_mirror_then_x_matches_rfftn3d_fused(shape):
    """Kernel 6's FFT body on the mixed-radix kernel, then kernel 7's plain
    version, against the JAX package's fused 3D R2C (interpret mode)."""
    x = _real(shape, 7 + sum(shape))
    assert hf._zy_fwd_body(*shape[1:]) == "fft"
    yr, yi = hf.zy_fwd_mirror(torch.from_numpy(x))
    zr, zi = hf.x_c2c_plain(yr, yi, *hf._planes("dft", shape[0], False, CPU))
    want = np.asarray(pallas_fft._rfftn3d_fused(x))
    assert _rel(torch.complex(zr, zi).numpy(), want) <= 5e-4


def test_routes():
    """Kernel 6 takes the engine on 5-smooth Y and Z (Y even) and keeps its
    dense body on 448 = 2^6 7, on a prime and on an odd Y; kernel 8 stays
    on powers of two; kernel 4 takes the engine on 5-smooth n2 up to 512
    and its tile body on 448; the other kernels' ``_fft_body`` stays
    powers of two."""
    for y, z in ((480, 480), (96, 120), (480, 40), (12, 10), (512, 480),
                 (480, 512), (8, 9), (500, 375)):
        assert hf._zy_fwd_body(y, z) == "fft", (y, z)
        assert hf._zy_body(y, z) == "dense", (y, z)
    for y, z in ((448, 448), (480, 448), (448, 480), (15, 480), (480, 7),
                 (4, 480), (480, 2), (6, 12), (514, 480), (480, 1024)):
        assert hf._zy_fwd_body(y, z) == "dense", (y, z)
    assert hf._zy_fwd_body(512, 512) == hf._zy_body(512, 512) == "fft"
    fft = [n for n in range(1, 2100) if hf._cdft_tw_body(n) == "fft"]
    assert fft == sorted(MIXED + [8, 16, 32, 64, 128, 256, 512, 1024])
    for n in (320, 480, 9, 500):
        assert hf._cdft_tw_body(n) == "fft" and hf._fft_body(n) == "tile"
    for n in (448, 7, 520, 1000, 206):
        assert hf._cdft_tw_body(n) == "tile"


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
                                   (2, 15, 480), (2, 512, 512)])
def test_zy_fwd_launches(monkeypatch, shape):
    """Off the CPU, ``zy_fwd`` launches the three passes where
    ``_zy_fwd_body`` says "fft" (the schedules of Z and Y: the mixed-radix
    kernel's, with the rows of a batch, unless both are powers of two),
    else the dense kernel once."""
    log = _record_launches(monkeypatch)
    X, Y, Z = shape
    hf.zy_fwd(torch.zeros(shape))
    if hf._zy_fwd_body(Y, Z) == "dense":
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


@pytest.mark.parametrize("n2", [320, 480, 448])
def test_cdft_tw_launches(monkeypatch, n2):
    log = _record_launches(monkeypatch)
    x = torch.zeros((18, n2), dtype=torch.complex64, device="meta")
    hf.cdft_tw(x, 9, True)
    ((kernel, entry, args),) = log
    assert kernel == "cmatmul_tw"
    if n2 == 448:
        assert entry == "dfft_stage"
    else:
        assert entry == "dfft_cdft_tw"
        assert args[5:] == (18, n2, 9, hf.mixed_schedule(n2, True), 1)


@pytest.mark.parametrize("fn", ["fft", "ifft", "irfft", "rfft"])
def test_4320_axis_runs_kernel4_on_the_engine(monkeypatch, fn):
    """The convolver's 5-smooth 4320 = 9 x 480 (``good_size``): kernel 4's
    first stage launches ``dfft_cdft_tw``, never ``dfft_stage``; kernel 5
    (the real input of rfft) keeps its tile body."""
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
    assert ("cmatmul_tw", "dfft_stage") not in entries
    if fn == "rfft":
        assert entries == [("rmatmul_tw", "dfft_stage"),
                           ("cmatmul", "dfft_cdft_short")]
    else:
        assert entries == [("cmatmul_tw", "dfft_cdft_tw"),
                           ("cmatmul", "dfft_cdft_short")]


def test_kernel_source_agrees_with_the_host_side():
    """The constants ``fft_plan`` and ``mixed_schedule`` assume are the
    kernel's: its batch cap, longest row, block size, the schedule's rows
    field and radices
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
    body = re.search(r"inline bool mixed_radix\(int r\) \{(.*?)\n\}", src,
                     re.S).group(1)
    cases = {int(c) for c in re.findall(r"case (\d+):", body)}
    assert cases == set(hf.MIXED_RADICES)
    dispatch = re.search(r"void with_radix\(int r, F&& f\) \{(.*?)\n\}", src,
                         re.S).group(1)
    assert {int(c) for c in re.findall(r"case (\d+):", dispatch)} == cases
