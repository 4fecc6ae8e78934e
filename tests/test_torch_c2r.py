"""Kernel 3's FFT body (``irdft`` on the row FFT engine) and the C2R
dispatch of ``irfft``, on the CPU.

``c2r_mirror`` runs the kernel's arithmetic in plain PyTorch: half rows 2c
and 2c + 1 packed as one complex row A + iB (the imaginary parts of the DC
and Nyquist bins zeroed), extended by Hermitian symmetry, the engine's
inverse passes from ``fft_plan``, the real and imaginary parts split into
the two real rows. The inputs are random half spectra, not spectra of real
signals, so their DC and Nyquist bins have imaginary parts that the C2R
must ignore. The mirror is held against

* ``c2r_plain`` (the dense products with ``_c2r_np``'s CR / CI), to 1e-5:
  float32 on both sides, sums in another order;
* the JAX package's ``pallas_fft._c2r_stage`` (its Pallas kernel in
  interpret mode) to 5e-4, the JAX package's per-stage bound, and at 1024
  points ``pallas_fft.irfft``, which inverts the Hermitian extension there.

Also the routing: ``irfft`` sends a power of two up to 1024 and every
other length up to 512 to one ``irdft`` (on the engine at a power of two
or a 13-smooth length, else ``c2r`` with the planes), an even split
length to kernel 3's packed route (``tests/test_torch_c2rpack.py``) and an
odd one to the Hermitian extension; on a CUDA tensor ``irdft`` and
``yz_inv`` name the entry points of their body (checked here with the
launch recorded, not run).
"""

import numpy as np
import pytest
import torch

from distributedfft_tpu.ops import pallas_fft
from distributedfft_tpu_torch.ops import hopper_fft as hf

CPU = torch.device("cpu")
POW2 = [8, 16, 32, 64, 128, 256, 512, 1024]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def _half(M, n, seed):
    """Random (M, n/2 + 1) half spectra; bins 0 and n/2 keep non-zero
    imaginary parts."""
    rng = np.random.default_rng(seed)
    shape = (M, n // 2 + 1)
    c = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    assert np.all(np.abs(c[:, [0, n // 2]].imag) > 0)
    return c.astype(np.complex64)


def _plain(c, n):
    return hf.c2r_plain(c, *hf._planes("c2r", n, False, CPU))


# M: one row, an odd count (the last half row paired with zeros), even.
@pytest.mark.parametrize("M", [1, 5, 6])
@pytest.mark.parametrize("n", POW2)
def test_c2r_mirror_matches_plain_and_jax(n, M):
    c = _half(M, n, 3 * n + M)
    got = hf.c2r_mirror(torch.from_numpy(c), n)
    assert got.dtype == torch.float32 and got.shape == (M, n)
    assert _rel(got.numpy(), _plain(torch.from_numpy(c), n).numpy()) <= 1e-5
    want = np.asarray(pallas_fft._c2r_stage(c, n))
    assert _rel(got.numpy(), want) <= 5e-4


def test_c2r_mirror_at_1024_matches_jax_extension_path():
    """At 1024 points the JAX package's ``irfft`` inverts the Hermitian
    extension as a complex transform (the port runs one ``irdft``)."""
    c = _half(3, 1024, 17)
    got = hf.c2r_mirror(torch.from_numpy(c), 1024)
    want = np.asarray(pallas_fft.irfft(c, 1024, axis=-1))
    assert _rel(got.numpy(), want) <= 5e-4
    assert _rel(hf.irfft(torch.from_numpy(c), 1024, axis=-1).numpy(),
                want) <= 5e-4


@pytest.mark.parametrize("n", [8, 64, 1024])
def test_c2r_mirror_ignores_dc_and_nyquist_imaginary_parts(n):
    """Packed as A + iB, an imaginary DC or Nyquist bin of one half row
    would land in its partner's output; the C2R drops them."""
    c = _half(4, n, n)
    real = c.copy()
    real[:, [0, n // 2]] = real[:, [0, n // 2]].real
    got = hf.c2r_mirror(torch.from_numpy(c), n)
    assert torch.equal(got, hf.c2r_mirror(torch.from_numpy(real), n))
    want = np.fft.irfft(real.astype(np.complex128), n) * n
    assert _rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("n", POW2 + [1, 2, 12, 257])
def test_irdft_on_cpu_equals_c2r_plain(n):
    """On CPU tensors ``irdft`` is its plain version exactly, whichever
    body ``_cdft_body(n)`` names, and launches nothing."""
    hf.reset_launches()
    c = torch.from_numpy(_half(5, n, n))
    assert torch.equal(hf.irdft(c, n), _plain(c, n))
    assert hf.irdft(c[:0], n).shape == (0, n)
    assert all(v == 0 for v in hf.LAUNCHES.values()), hf.LAUNCHES


def _count_calls(monkeypatch, module, *names):
    """Record the calls of the named functions of ``module``: name -> list
    of (shape of the first argument, the rest)."""
    calls = {name: [] for name in names}

    def wrap(name, orig):
        def counted(x, *args):
            calls[name].append((tuple(x.shape),) + args)
            return orig(x, *args)
        return counted

    for name in names:
        monkeypatch.setattr(module, name, wrap(name, getattr(module, name)))
    return calls


@pytest.mark.parametrize("n", POW2)
def test_irfft_power_of_two_takes_one_irdft(monkeypatch, n):
    """A power of two up to 1024 (1024 included) goes to one ``irdft`` on
    its engine body: never the Hermitian extension, a complex inverse or
    the C2R planes."""
    calls = _count_calls(monkeypatch, hf, "irdft", "c2r", "cdft",
                         "_fft_last")
    calls.update(_count_calls(monkeypatch, hf.mx, "_hermitian_extend"))
    c = _half(6, n, n + 1)
    got = hf.irfft(torch.from_numpy(c.reshape(2, 3, -1)), n, axis=-1)
    assert got.shape == (2, 3, n)
    assert _rel(got.reshape(6, n).numpy(),
                _plain(torch.from_numpy(c), n).numpy()) <= 1e-5
    assert calls.pop("irdft") == [((6, n // 2 + 1), n)]
    assert all(not v for v in calls.values()), calls


@pytest.mark.parametrize("n", [2, 4, 12, 96, 257, 320])
def test_irfft_other_direct_lengths_take_the_planes(monkeypatch, n):
    """Any other length up to 512 also takes one ``irdft``, whose body is
    then ``c2r`` with the C2R planes (the tile or row body); at a
    13-smooth length (12, 96, 320) it runs the engine's mixed-radix kernel
    instead, whose plain version on the CPU is the product with the same
    planes, not through ``c2r``."""
    calls = _count_calls(monkeypatch, hf, "irdft", "c2r", "cdft",
                         "_fft_last")
    calls.update(_count_calls(monkeypatch, hf.mx, "_hermitian_extend"))
    c = _half(3, n, n)
    got = hf.irfft(torch.from_numpy(c), n, axis=-1).numpy()
    assert _rel(got, np.fft.irfft(c.astype(np.complex128), n) * n) <= 1e-5
    assert hf._fft_body(n) == "tile"
    assert calls.pop("irdft") == [((3, n // 2 + 1), n)]
    if hf._cdft_body(n) == "fft":
        assert n in hf.MIXED_LENGTHS and not calls.pop("c2r")
        assert torch.equal(torch.from_numpy(got), _plain(
            torch.from_numpy(c), n))
        assert all(not v for v in calls.values()), calls
        return
    ((shape, cr, ci),) = calls.pop("c2r")
    assert shape == (3, n // 2 + 1)
    want = hf._planes("c2r", n, False, CPU)
    assert torch.equal(cr, want[0]) and torch.equal(ci, want[1])
    assert all(not v for v in calls.values()), calls


@pytest.mark.parametrize("n", [640, 2048, 1025])
def test_irfft_split_lengths_keep_the_extension(monkeypatch, n):
    """Past the direct lengths only an odd n (1025 = 5 x 205) keeps the
    Hermitian extension and a complex inverse of n points, as the JAX
    package does past 512 points: it has no half-length packing. An even
    one (640 = 2 x 320, 2048 = 4 x 512) takes one ``irdft_packed``, kernel
    3's packed body on rows of n / 2 (320 and 1024, engine lengths): no
    extension, no complex inverse of n points. Both match the JAX
    package's ``irfft``."""
    calls = _count_calls(monkeypatch, hf, "irdft", "c2r", "_fft_last",
                         "irdft_packed", "c2r_pack")
    calls.update(_count_calls(monkeypatch, hf.mx, "_hermitian_extend"))
    c = _half(3, n, n)
    got = hf.irfft(torch.from_numpy(c), n, axis=-1).numpy()
    if n % 2:
        assert calls.pop("_hermitian_extend") == [((3, n // 2 + 1), n)]
        assert calls.pop("_fft_last")[0] == ((3, n), True)
    else:
        assert calls.pop("irdft_packed") == [((3, n // 2 + 1), n)]
    assert all(not v for v in calls.values()), calls
    assert _rel(got, np.asarray(pallas_fft.irfft(c, n, axis=-1))) <= 5e-4


def test_irdft_checks_its_arguments():
    c = torch.zeros((4, 5), dtype=torch.complex64)
    with pytest.raises(ValueError):
        hf.irdft(c, 16)                                     # 5 != 16/2 + 1
    with pytest.raises(ValueError):
        hf.irdft(c[None], 8)                                # not 2D rows
    with pytest.raises(TypeError):
        hf.irdft(c.real.contiguous(), 8)                    # not complex
    with pytest.raises(ValueError):
        hf.irdft(torch.zeros((5, 4), dtype=torch.complex64).t(), 8)
    with pytest.raises(ValueError):
        hf.irdft(c.to("meta"), 8)                           # no kernel


def _record_launches(monkeypatch):
    """Make the wrappers take their CUDA route on CPU tensors, recording
    each launch as (counter, C entry point) instead of running it."""
    log = []
    monkeypatch.setattr(hf, "_check_rows", lambda *a: False)
    monkeypatch.setattr(hf, "_check", lambda *a: False)
    monkeypatch.setattr(hf, "_launch", lambda kernel, fn, *args:
                        log.append((kernel, fn)))
    return log


@pytest.mark.parametrize("n", POW2 + [2, 12, 96, 480, 375, 442])
def test_irdft_routes_by_fft_body(monkeypatch, n):
    """Off the CPU, ``irdft`` launches ``dfft_c2r`` (the engine: its
    power-of-two kernel, or its mixed-radix kernel at a 13-smooth n such
    as 12, 96, 480 and 375) where ``_cdft_body(n)`` is "fft", else the
    dense ``dfft_stage`` (2, 442); both count as ``c2r``. No other
    route."""
    log = _record_launches(monkeypatch)
    hf.irdft(torch.zeros((7, n // 2 + 1), dtype=torch.complex64), n)
    entry = "dfft_c2r" if hf._cdft_body(n) == "fft" else "dfft_stage"
    assert log == [("c2r", entry)]


@pytest.mark.parametrize("shape", [(2, 8, 8), (3, 16, 32), (2, 512, 512),
                                   (4, 8, 512), (2, 12, 16), (2, 16, 12),
                                   (3, 480, 480), (2, 4, 64)])
def test_yz_inv_routes_by_zy_body(monkeypatch, shape):
    """Off the CPU, ``yz_inv`` launches its three FFT-body passes when
    ``_zy_engine_body(Y, Z)`` is ``"fft"`` (both powers of two, or engine
    lengths with Y even: 12 x 16, 16 x 12, 480 x 480), else the dense
    kernel once (Y = 4 is no engine length); every launch counts as
    ``yz_inv``."""
    log = _record_launches(monkeypatch)
    X, Y, Z = shape
    half = torch.zeros((X, Y, Z // 2 + 1))
    assert hf.yz_inv(half, half, Z).shape == shape
    want = (["dfft_yz_scratch", "dfft_yz_cols", "dfft_yz_rows"]
            if hf._zy_engine_body(Y, Z) == "fft" else ["dfft_yz_inv"])
    assert log == [("yz_inv", fn) for fn in want]
