"""The FFT bodies of kernels 6 (``zy_fwd``) and 8 (``yz_inv``) on the row
FFT engine, on the CPU.

``zy_fwd_mirror`` runs the passes of the kernel in plain PyTorch from
``fft_plan``: pass A packs two real z-rows as one complex row, runs the
engine's passes, splits the spectrum and lays the half spectra out as the
kernel's scratch (``_zy_scratch_shape``, one row per (x, zo)); pass B runs
the engine on those rows along y, pass C transposes into the planes. It
is held against

* ``zy_fwd_plain`` (the dense products), to 1e-5: float32 on both sides,
  sums in another order;
* the JAX package's ``pallas_fft._rfftn3d_fused`` (its Pallas kernels in
  interpret mode), followed by ``x_c2c_plain``, to 5e-4, the JAX package's
  per-stage bound.

Kernel 8's ``yz_inv_mirror`` runs its passes the other way: pass 1
transposes the (X, Y, Zo) planes into the same scratch, pass 2 runs the
engine's inverse on its rows (the y-C2C), pass 3 runs kernel 3's C2R Body
(``c2r_mirror``) on the (x, y) half rows gathered from it. It is held
against ``yz_inv_plain`` to 1e-5 and, after ``x_c2c_plain``'s inverse,
against the JAX package's ``pallas_fft._irfftn3d_fused`` to 5e-4, on
random spectra (their DC and Nyquist z-bins have imaginary parts, which
both ignore).

Also ``_zy_body``'s routing, the scratch layout, and that CPU tensors take
the plain version and launch nothing.
"""

import numpy as np
import pytest
import torch

from distributedfft_tpu.ops import pallas_fft
from distributedfft_tpu_torch.ops import hopper_fft as hf

CPU = torch.device("cpu")
# Powers of two on y and z (the FFT body), small enough for interpret mode:
# z-rows of 8 to 64 points, y-columns of 8 to 32, x-planes 2 and 3.
FFT_SHAPES = [(3, 8, 16), (2, 32, 8), (2, 16, 64), (2, 8, 8), (3, 16, 32)]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def _real(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _plain(x):
    X, Y, Z = x.shape
    return hf.zy_fwd_plain(x, *hf._planes("rdft", Z, False, CPU),
                           *hf._planes("dft", Y, False, CPU))


@pytest.mark.parametrize("shape", FFT_SHAPES + [(4, 512, 8), (2, 8, 512)])
def test_mirror_matches_plain(shape):
    x = torch.from_numpy(_real(shape, sum(shape)))
    yr, yi = hf.zy_fwd_mirror(x)
    pr, pi = _plain(x)
    X, Y, Z = shape
    assert yr.shape == yi.shape == (X, Y, Z // 2 + 1)
    assert yr.dtype == yi.dtype == torch.float32
    assert _rel(torch.complex(yr, yi).numpy(),
                torch.complex(pr, pi).numpy()) <= 1e-5


@pytest.mark.parametrize("shape", FFT_SHAPES)
def test_mirror_then_x_matches_rfftn3d_fused(shape):
    """Kernel 6's FFT body, then kernel 7's plain version, against the JAX
    package's fused 3D R2C."""
    x = _real(shape, 7 + sum(shape))
    assert hf._zy_body(*shape[1:]) == "fft"
    yr, yi = hf.zy_fwd_mirror(torch.from_numpy(x))
    zr, zi = hf.x_c2c_plain(yr, yi, *hf._planes("dft", shape[0], False, CPU))
    want = np.asarray(pallas_fft._rfftn3d_fused(x))
    assert _rel(torch.complex(zr, zi).numpy(), want) <= 5e-4


def test_zy_body_routing():
    pow2 = [8, 16, 32, 64, 128, 256, 512]
    for y in range(1, 600):
        for z in (8, 12, 15, 256, 512, 513):
            want = "fft" if y in pow2 and z in pow2 else "dense"
            assert hf._zy_body(y, z) == want, (y, z)
    # The fused path's shapes of the other tests keep the dense kernel.
    for shape in ((6, 12, 15), (16, 10, 12), (2, 2, 2), (512, 9, 511)):
        assert hf._zy_body(*shape[1:]) == "dense"


@pytest.mark.parametrize("shape", [(2, 8, 8), (3, 16, 32), (2, 8, 64)])
def test_pass_a_scratch_layout(shape):
    """Pass A's scratch is (X, Zo, Y): row (x, zo) holds the z-R2C bin zo
    of every y of plane x."""
    X, Y, Z = shape
    x = _real(shape, 5)
    s = hf.zy_rows_mirror(torch.from_numpy(x))
    assert s.shape == hf._zy_scratch_shape(X, Y, Z) == (X, Z // 2 + 1, Y)
    assert s.dtype == torch.complex64 and s.is_contiguous()
    want = np.fft.rfft(x.astype(np.float64), axis=2)        # (X, Y, Zo)
    assert _rel(s.transpose(1, 2).numpy(), want) <= 1e-5


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    hf.reset_launches()
    x = torch.from_numpy(_real((3, 16, 32), 11))
    yr, yi = hf.zy_fwd(x)
    pr, pi = _plain(x)
    assert torch.equal(yr, pr) and torch.equal(yi, pi)
    hf.rfftn3d_fused(x)
    assert all(v == 0 for v in hf.LAUNCHES.values()), hf.LAUNCHES


def _spectrum(shape, seed):
    """Random (X, Y, Z/2 + 1) float32 planes of a half spectrum."""
    X, Y, Z = shape
    half = (X, Y, Z // 2 + 1)
    return (torch.from_numpy(_real(half, seed)),
            torch.from_numpy(_real(half, seed + 1)))


@pytest.mark.parametrize("shape", FFT_SHAPES + [(4, 512, 8), (2, 8, 512)])
def test_yz_inv_mirror_matches_plain(shape):
    X, Y, Z = shape
    er, ei = _spectrum(shape, sum(shape))
    got = hf.yz_inv_mirror(er, ei, Z)
    want = hf.yz_inv_plain(er, ei, *hf._planes("dft", Y, True, CPU),
                           *hf._planes("c2r", Z, False, CPU))
    assert got.shape == shape and got.dtype == torch.float32
    assert _rel(got.numpy(), want.numpy()) <= 1e-5


@pytest.mark.parametrize("shape", FFT_SHAPES)
def test_x_then_yz_inv_mirror_matches_irfftn3d_fused(shape):
    """Kernel 7's plain inverse, then kernel 8's FFT body, against the JAX
    package's fused 3D C2R."""
    X, Y, Z = shape
    assert hf._zy_body(Y, Z) == "fft"
    cr, ci = _spectrum(shape, 3 + sum(shape))
    er, ei = hf.x_c2c_plain(cr, ci, *hf._planes("dft", X, True, CPU))
    got = hf.yz_inv_mirror(er, ei, Z)
    want = np.asarray(pallas_fft._irfftn3d_fused(
        torch.complex(cr, ci).numpy(), shape))
    assert _rel(got.numpy(), want) <= 5e-4


@pytest.mark.parametrize("shape", [(2, 8, 8), (3, 16, 32), (2, 8, 64)])
def test_yz_inv_pass_1_scratch_layout(shape):
    """Pass 1 fills kernel 6's scratch shape: row (x, zo) holds bin zo of
    every y of plane x, and pass 2 leaves it the y-inverse of each."""
    X, Y, Z = shape
    er, ei = _spectrum(shape, 9)
    s = torch.complex(er, ei).transpose(1, 2).contiguous()
    assert s.shape == hf._zy_scratch_shape(X, Y, Z)
    rows = hf.fft_rows_mirror(s.reshape(-1, Y), True).reshape(s.shape)
    want = np.fft.ifft(torch.complex(er, ei).numpy().astype(np.complex128),
                       axis=1) * Y
    assert _rel(rows.transpose(1, 2).numpy(), want) <= 1e-5


def test_yz_inv_on_cpu_takes_the_plain_version_and_launches_nothing():
    hf.reset_launches()
    for shape in ((3, 16, 32), (2, 12, 10)):
        X, Y, Z = shape
        er, ei = _spectrum(shape, 13)
        want = hf.yz_inv_plain(er, ei, *hf._planes("dft", Y, True, CPU),
                               *hf._planes("c2r", Z, False, CPU))
        assert torch.equal(hf.yz_inv(er, ei, Z), want)
    assert all(v == 0 for v in hf.LAUNCHES.values()), hf.LAUNCHES
