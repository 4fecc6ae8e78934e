"""The port's per-axis kernels (ops/hopper_fft.py, kernels 1-5) against the
JAX package's Pallas per-axis path, on the CPU.

The same seeded numpy input goes through both. The JAX functions are
called outside ``shard_map``, so their Pallas bodies run in interpret mode
and the TPU kernels themselves are the oracle; the port's wrappers take
their plain versions for CPU tensors. Tolerances are
``tests/test_pallas_fft.py``'s own: rel <= 5e-4 (the JAX kernels emulate
HIGH precision with three bf16 products, the port computes in float32),
2e-3 for the unfused 1042-point recursion.
"""

import numpy as np
import pytest
import torch

from distributedfft_tpu.ops import mxu_fft as jmx
from distributedfft_tpu.ops import pallas_fft
from distributedfft_tpu_torch.ops import hopper_fft as hf
from distributedfft_tpu_torch.ops import mxu_fft as tmx
from distributedfft_tpu_torch.params import FFTNorm
from distributedfft_tpu.params import FFTNorm as JNorm

# direct (8, 96), odd direct (12, 13-prime), four-step with the fused
# twiddle (640 -> 2x320), a power of two the port runs direct where the JAX
# package splits (1024 -> 2x512 there), and one both split (2048 -> 4x512).
NS = [8, 12, 13, 96, 640, 1024, 2048]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def _complex(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _real(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("n", NS)
def test_fft_ifft_match_pallas(n):
    x = _complex((3, n), n)
    t = torch.from_numpy(x)
    assert _rel(hf.fft(t, axis=-1).numpy(), pallas_fft.fft(x, axis=-1)) < 5e-4
    assert _rel(hf.ifft(t, axis=-1).numpy(),
                pallas_fft.ifft(x, axis=-1)) < 5e-4


@pytest.mark.parametrize("n", NS)
def test_rfft_irfft_match_pallas(n):
    x = _real((4, n), n + 1)
    got = hf.rfft(torch.from_numpy(x), axis=-1)
    ref = np.array(pallas_fft.rfft(x, axis=-1))   # writable, for from_numpy
    assert got.shape == ref.shape and got.dtype == torch.complex64
    assert _rel(got.numpy(), ref) < 5e-4
    back = hf.irfft(torch.from_numpy(ref), n=n, axis=-1, norm=FFTNorm.BACKWARD)
    jback = pallas_fft.irfft(ref, n=n, axis=-1, norm=JNorm.BACKWARD)
    assert back.shape == (4, n) and back.dtype == torch.float32
    assert _rel(back.numpy(), jback) < 5e-4


def test_four_step_recursion_unfused_branch():
    """1042 -> (2, 521): n2 > 512 takes the recurse-then-twiddle branch,
    its inner 521-point prime stage direct (<= N_MAX)."""
    n = 1042
    assert tmx._split_for(n, tmx.DIRECT_MAX) == (2, 521)
    x = _real((2, n), 5)
    got = hf.rfft(torch.from_numpy(x), axis=-1).numpy()
    assert _rel(got, pallas_fft.rfft(x, axis=-1)) < 2e-3
    c = _complex((2, n), 6)
    assert _rel(hf.ifft(torch.from_numpy(c), axis=-1).numpy(),
                pallas_fft.ifft(c, axis=-1)) < 2e-3


def test_axis_and_ortho():
    x = _real((5, 32, 7), 7)
    got = hf.rfft(torch.from_numpy(x), axis=1, norm=FFTNorm.ORTHO)
    assert _rel(got.numpy(), pallas_fft.rfft(x, axis=1, norm=JNorm.ORTHO)) < 5e-4
    c = x.astype(np.complex64)
    got2 = hf.ifft(torch.from_numpy(c), axis=0, norm=FFTNorm.ORTHO)
    assert _rel(got2.numpy(), pallas_fft.ifft(c, axis=0, norm=JNorm.ORTHO)) < 5e-4
    got3 = hf.irfft(got, n=32, axis=1, norm=FFTNorm.ORTHO)
    assert _rel(got3.numpy(), x) < 5e-4


@pytest.mark.parametrize("real", [False, True])
@pytest.mark.parametrize("twiddle", [False, True])
def test_stage_matches_call_stage(real, twiddle):
    """Kernels 1, 2, 4 and 5 against ``pallas_fft._stage`` (its Pallas
    kernels in interpret mode), rows cycling through n1 = 8."""
    n1, n2 = 8, 16
    a = _real((3, n1, n2), 8) if real else _complex((3, n1, n2), 8)
    tw = (n1, n2, False) if twiddle else None
    F = jmx._dft_np(n2, False, False)
    ref = np.asarray(pallas_fft._stage(a, F, twiddle=tw))
    got = hf._stage(torch.from_numpy(a), hf._planes("dft", n2, False,
                                                    torch.device("cpu")), tw)
    assert got.shape == ref.shape and got.dtype == torch.complex64
    assert _rel(got.numpy(), ref) < 5e-4


def test_fused_twiddle_stage_matches_unfused():
    """The fused epilogue agrees with an explicit stage then twiddle (the
    JAX test of the same name, held by the port)."""
    n1, n2 = 8, 16
    a = torch.from_numpy(_complex((3, n1, n2), 9))
    F = hf._planes("dft", n2, False, torch.device("cpu"))
    fused = hf._stage(a, F, twiddle=(n1, n2, False)).numpy()
    unfused = hf._stage(a, F).numpy() * jmx._twiddle_np(n1, n2, False, False)
    assert _rel(fused, unfused) < 5e-4


@pytest.mark.parametrize("n", [8, 13, 96])
def test_c2r_stage_matches_pallas(n):
    """Kernel 3 against ``pallas_fft._c2r_stage``."""
    c = _complex((6, n // 2 + 1), n + 2)
    ref = np.asarray(pallas_fft._c2r_stage(c, n))
    got = hf._c2r_stage(torch.from_numpy(c), n)
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert _rel(got.numpy(), ref) < 5e-4


@pytest.mark.parametrize("n", [520, 640, 1024, 1030, 1042, 2048])
def test_split_for_matches_reference(n):
    assert tmx._split_for(n, tmx.DIRECT_MAX) == jmx._split_for(n, jmx.DIRECT_MAX)
    assert tmx._split(n) == jmx._split(n)
    assert tmx._split_wide(n, 512) == jmx._split_wide(n, 512)
    assert tmx.N_MAX == pallas_fft._N_MAX and tmx.DIRECT_MAX == jmx.DIRECT_MAX


@pytest.mark.parametrize("fn", ["fft", "ifft", "rfft", "irfft"])
def test_double_precision_takes_the_matmul_backend(fn):
    """f64 under "pallas" runs the matmul backend, as ``pallas_fft`` routes
    it (``_use_fallback``; its ``irfft`` inverts the Hermitian extension):
    one dispatch, no kernel, complex128 / float64 out, within 1e-11 of the
    JAX package."""
    rng = np.random.default_rng(40)
    if fn == "rfft":
        x = rng.standard_normal((2, 1024))
    else:
        x = rng.standard_normal((2, 513)) + 1j * rng.standard_normal((2, 513))
    kw = {"n": 1024} if fn == "irfft" else {}
    hf.reset_launches()
    got = getattr(hf, fn)(torch.from_numpy(x), axis=-1, **kw)
    ref = np.asarray(getattr(pallas_fft, fn)(x, axis=-1, **kw))
    assert hf.DISPATCHES == {"matmul": 1}
    assert not any(hf.LAUNCHES.values())
    assert got.dtype == (torch.float64 if fn == "irfft" else torch.complex128)
    assert got.shape == ref.shape and _rel(got.numpy(), ref) < 1e-11


def test_prime_axis_above_n_max_takes_the_matmul_backend():
    """A prime axis past ``N_MAX`` runs the matmul backend in float32 (the
    prime branches of ``pallas_fft._fft_last`` / ``_rfft_last``)."""
    n = 1031  # prime, above N_MAX = 1024
    assert tmx._split_for(n, tmx.DIRECT_MAX) == (1, n)
    x, xr = _complex((2, n), 41), _real((2, n), 42)
    hf.reset_launches()
    got = hf.fft(torch.from_numpy(x), axis=-1)
    assert _rel(got.numpy(), pallas_fft.fft(x, axis=-1)) < 5e-4
    got_r = hf.rfft(torch.from_numpy(xr), axis=-1)
    assert _rel(got_r.numpy(), pallas_fft.rfft(xr, axis=-1)) < 5e-4
    assert got.dtype == got_r.dtype == torch.complex64
    assert hf.DISPATCHES == {"matmul": 2}
    assert not any(hf.LAUNCHES.values())


def test_cpu_tensors_take_the_plain_versions():
    hf.reset_launches()
    c = hf.rfft(torch.from_numpy(_real((2, 1024), 10)), axis=-1)
    hf.irfft(hf.fft(c, axis=0), n=1024, axis=-1)
    hf.irfft(c[:, :9], n=16, axis=-1)
    assert all(v == 0 for v in hf.LAUNCHES.values()), hf.LAUNCHES


@pytest.mark.parametrize("bad, err", [
    (torch.zeros((4, 8), dtype=torch.float64), TypeError),
    (torch.zeros((8, 4), dtype=torch.complex64).t(), ValueError),
    (torch.zeros((4, 8), dtype=torch.complex64, device="meta"), ValueError),
    (torch.zeros((4, 7), dtype=torch.complex64), ValueError),
])
def test_stage_rejects_what_the_kernel_does_not_take(bad, err):
    F = hf._planes("dft", 8, False, torch.device("cpu"))
    with pytest.raises(err):
        hf.stage(bad, *F)
