"""The resilience guard's energy sum (``resilience/guards._sumsq``) is a
float64 sum, on the CPU: a numpy-seeded (2048, 1024) float32 tensor whose
rows are scaled by e^-6 .. e^6 (energies 24 orders of magnitude apart,
where a float32 reduction of the whole operand loses ~1.6e-4 of the sum)
matches numpy's float64 sum within 1e-7 relative, contiguous and as
strided views (a ``narrow`` of the last axis, a transposed view, a
complex tensor and its narrowed view), and so does the weighted energy
``_energy`` of a half spectrum against the same weights applied in
float64."""

import numpy as np
import pytest
import torch

from distributedfft_tpu_torch.resilience import guards

SHAPE = (2048, 1024)


def _scaled(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(SHAPE)
    return (x * np.exp(rng.uniform(-6.0, 6.0, (SHAPE[0], 1)))).astype(
        np.float32)


def _rel(got, want):
    return abs(float(got) - want) / abs(want)


@pytest.mark.parametrize("view", ["contiguous", "narrow", "transposed"])
def test_sumsq_of_a_real_tensor_is_a_float64_sum(view):
    x = _scaled(5)
    t = torch.from_numpy(x)
    if view == "narrow":
        t, x = t.narrow(1, 3, 1000), x[:, 3:1003]
    elif view == "transposed":
        t, x = t.t(), x.T
    assert t.is_contiguous() == (view == "contiguous")
    got = guards._sumsq(t)
    assert got.dtype == torch.float64 and got.shape == ()
    assert _rel(got, np.sum(x.astype(np.float64) ** 2)) <= 1e-7


@pytest.mark.parametrize("view", ["contiguous", "narrow"])
def test_sumsq_of_a_complex_tensor_is_a_float64_sum(view):
    z = (_scaled(6) + 1j * _scaled(7)).astype(np.complex64)
    t = torch.from_numpy(z)
    if view == "narrow":
        t, z = t.narrow(1, 0, 513), z[:, :513]
    got = guards._sumsq(t)
    want = np.sum(np.abs(z.astype(np.complex128)) ** 2)
    assert got.dtype == torch.float64 and _rel(got, want) <= 1e-7


def test_sumsq_of_scalars_and_empty_tensors():
    assert float(guards._sumsq(torch.tensor(3.0))) == 9.0
    assert float(guards._sumsq(torch.tensor(3.0 + 4.0j))) == 25.0
    assert float(guards._sumsq(torch.tensor([3.0, 4.0]))) == 25.0
    assert float(guards._sumsq(torch.zeros((0, 5)))) == 0.0


def test_halved_energy_is_a_float64_sum():
    """``_energy`` of a half spectrum along its last axis (DC and the
    Nyquist bin once, the interior bins twice) against numpy's float64
    sum with the same weights."""
    n = 1022
    z = (_scaled(8) + 1j * _scaled(9)).astype(np.complex64)[:, :n // 2 + 1]
    got = guards._energy(torch.from_numpy(np.ascontiguousarray(z)),
                         halved_axis=1, halved_n=n)
    w = guards._halved_weights(n // 2 + 1, n).astype(np.float64)
    want = np.sum(np.abs(z.astype(np.complex128)) ** 2 * w)
    assert got.dtype == torch.float64 and _rel(got, want) <= 1e-7
