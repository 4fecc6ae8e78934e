"""Kernel 6's FFT body (``zy_fwd`` on the row FFT engine), on the CPU.

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
