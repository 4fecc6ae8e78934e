"""The port's fused-3D kernels (ops/hopper_fft.py) against the JAX
package's Pallas kernels, on the CPU.

The same seeded numpy input goes through both. The JAX wrappers are called
outside ``shard_map``, so their Pallas bodies run in interpret mode; the
port's wrappers take their plain versions for CPU tensors. Tolerance:
rel <= 5e-4, the JAX package's per-stage bound (tests/test_pallas_fft.py):
its kernels emulate HIGH precision with three bf16 products, the port
computes in float32.
"""

import numpy as np
import pytest
import torch

from distributedfft_tpu.ops import pallas_fft
from distributedfft_tpu_torch.ops import hopper_fft as hf
from distributedfft_tpu_torch.params import FFTNorm

SHAPES = [(8, 8, 8), (6, 12, 15), (16, 10, 12)]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def _real(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _spectrum(shape, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("shape", SHAPES)
def test_oracle_is_the_pallas_path(shape):
    assert pallas_fft.fused3d_applicable(shape, np.float32)
    assert hf.fused3d_applicable(shape, torch.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_zy_fwd_then_x_matches_rfftn3d_fused(shape):
    """Kernel 6 (then kernel 7) against ``_rfftn3d_fused``; kernel 6 alone
    against numpy's z-R2C + y-C2C."""
    x = _real(shape)
    yr, yi = hf.zy_fwd(torch.from_numpy(x))
    zy = (yr + 1j * yi).numpy()
    assert _rel(zy, np.fft.fft(np.fft.rfft(x, axis=2), axis=1)) < 5e-4
    zr, zi = hf.x_c2c(yr, yi, inverse=False)
    ref = np.asarray(pallas_fft._rfftn3d_fused(x))
    assert _rel((zr + 1j * zi).numpy(), ref) < 5e-4


# Kernel 7 runs in both directions at every shape inside the two fused
# comparisons above and below; this one case holds it alone.
@pytest.mark.parametrize("shape, inverse", [((16, 10, 12), True)])
def test_x_c2c_matches_x_transform(shape, inverse):
    X, Y, Z = shape
    c = _spectrum((X, Y, Z // 2 + 1))
    jr, ji = pallas_fft._x_transform(c.real, c.imag, inverse, frozenset())
    zr, zi = hf.x_c2c(torch.from_numpy(np.ascontiguousarray(c.real)),
                      torch.from_numpy(np.ascontiguousarray(c.imag)), inverse)
    ref = np.asarray(jr) + 1j * np.asarray(ji)
    assert _rel((zr + 1j * zi).numpy(), ref) < 5e-4


@pytest.mark.parametrize("shape", SHAPES)
def test_yz_inv_matches_irfftn3d_fused(shape):
    """Kernel 7 (inverse) then kernel 8 against ``_irfftn3d_fused``."""
    X, Y, Z = shape
    c = _spectrum((X, Y, Z // 2 + 1))
    ref = np.asarray(pallas_fft._irfftn3d_fused(c, shape))
    er, ei = hf.x_c2c(torch.from_numpy(np.ascontiguousarray(c.real)),
                      torch.from_numpy(np.ascontiguousarray(c.imag)), True)
    got = hf.yz_inv(er, ei, Z).numpy()
    assert got.shape == ref.shape
    assert _rel(got, ref) < 5e-4


# Normalization and the input fit are host-side arithmetic around the
# kernels; numpy states the same semantics without another interpret-mode
# Pallas run (FFTNorm.NONE is numpy's "backward" forward and its "forward"
# inverse, both unnormalized).
_NP_NORM = {"NONE": ("backward", "forward"), "ORTHO": ("ortho", "ortho"),
            "BACKWARD": ("backward", "backward")}


@pytest.mark.parametrize("norm", ["NONE", "ORTHO", "BACKWARD"])
def test_rfftn_3d_norms_follow_the_reference(norm):
    shape = (6, 12, 15)
    x = _real(shape, 2)
    fwd, inv = _NP_NORM[norm]
    got = hf.rfftn_3d(torch.from_numpy(x), norm=FFTNorm[norm])
    assert got.dtype == torch.complex64
    assert _rel(got.numpy(), np.fft.rfftn(x, norm=fwd)) < 5e-4
    back = hf.irfftn_3d(got, shape, norm=FFTNorm[norm])
    ref = np.fft.irfftn(got.numpy(), s=shape, axes=(0, 1, 2), norm=inv)
    assert _rel(back.numpy(), ref) < 5e-4


def test_irfftn_3d_fits_a_cropped_spectrum():
    """The inverse crops / zero-pads its input to (X, Y, Z//2+1) first, as
    ``_irfftn3d_fused`` does (numpy's ``s=``)."""
    shape = (8, 8, 8)
    c = _spectrum((6, 10, 5))
    got = hf.irfftn_3d(torch.from_numpy(c), shape)
    ref = np.fft.irfftn(c, s=shape, axes=(0, 1, 2), norm="forward")
    assert _rel(got.numpy(), ref) < 5e-4


def test_cpu_tensors_take_the_plain_versions():
    hf.reset_launches()
    c = hf.rfftn_3d(torch.from_numpy(_real((8, 8, 8))))
    hf.irfftn_3d(c, (8, 8, 8))
    assert all(v == 0 for v in hf.LAUNCHES.values()), hf.LAUNCHES


@pytest.mark.parametrize("bad, err", [
    (torch.zeros((8, 8, 8), dtype=torch.float64), TypeError),
    (torch.zeros((8, 8, 16))[:, :, ::2], ValueError),
    (torch.zeros((8, 8, 513)), ValueError),
    (torch.zeros((8, 8)), ValueError),
    (torch.zeros((8, 8, 8), device="meta"), ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, err):
    with pytest.raises(err):
        hf.zy_fwd(bad)


@pytest.mark.parametrize("shape", [(8, 8, 513), (1, 8, 8)])
def test_outside_the_fused_path_matches_the_per_axis_path(shape):
    """A cube with an axis above 512 or below 2 takes the per-axis kernels,
    as ``pallas_fft.rfftn_3d`` / ``irfftn_3d`` do."""
    assert not hf.fused3d_applicable(shape, torch.float32)
    assert not pallas_fft.fused3d_applicable(shape, np.float32)
    x = _real(shape, 3)
    ref = np.asarray(pallas_fft.rfftn_3d(x))
    got = hf.rfftn_3d(torch.from_numpy(x))
    assert tuple(got.shape) == ref.shape and _rel(got.numpy(), ref) < 5e-4
    back = hf.irfftn_3d(got, shape)
    assert _rel(back.numpy(), pallas_fft.irfftn_3d(ref, shape)) < 5e-4


@pytest.mark.parametrize("shape, dtype", [
    ((8, 8, 8), torch.float64), ((8, 8, 513), torch.float64)])
def test_outside_the_fused_path_takes_the_matmul_backend(shape, dtype):
    """Double precision leaves the fused path for the per-axis one, where
    every axis runs the matmul backend, as in the JAX package: three
    dispatches, no kernel, within 1e-11 of ``pallas_fft.rfftn_3d``."""
    x = np.random.default_rng(11).standard_normal(shape)
    hf.reset_launches()
    got = hf.rfftn_3d(torch.from_numpy(x).to(dtype))
    assert hf.DISPATCHES == {"matmul": 3} and not any(hf.LAUNCHES.values())
    assert got.dtype == torch.complex128
    assert _rel(got.numpy(), pallas_fft.rfftn_3d(x)) < 1e-11


def test_3d_transforms_need_three_axes():
    with pytest.raises(ValueError):
        hf.rfftn_3d(torch.zeros((8, 8)))
    with pytest.raises(ValueError):
        hf.irfftn_3d(torch.zeros((8, 5), dtype=torch.complex64), (8, 8, 8))
