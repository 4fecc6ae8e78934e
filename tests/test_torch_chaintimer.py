"""The port's chain timing harness (``testing/chaintimer.py``) against the
JAX package's: every case of ``tests/test_chaintimer.py``, and the chains'
values held against JAX's on the same numpy inputs (1e-5 in float32,
1e-12 in float64)."""

import numpy as np
import pytest
import torch

from distributedfft_tpu_torch.testing import chaintimer as ct

CPU = "cpu"


def _jax_uniform(seed, shape):
    import jax
    import jax.numpy as jnp
    return np.asarray(jax.jit(lambda: jax.random.uniform(
        jax.random.key(seed), shape, jnp.float32))())


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5),
                                       (np.float64, 1e-12)],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("backend", ["xla", "matmul", "pallas"])
@pytest.mark.parametrize("k", [1, 3])
def test_roundtrip_chain_matches_jax(rng, dtype, tol, backend, k):
    import jax
    from distributedfft_tpu.testing import chaintimer as jct
    shape = (8, 12, 10)
    x = rng.random(shape).astype(dtype)
    got = float(ct.roundtrip_chain(k, shape, backend)(torch.from_numpy(x)))
    want = float(jct.roundtrip_chain(k, shape, backend)(jax.device_put(x)))
    assert got == pytest.approx(want, rel=tol)


@pytest.mark.parametrize("stage", ct.STAGES)
@pytest.mark.parametrize("backend", ["xla", "matmul"])
def test_stage_chain_matches_jax(stage, backend):
    from distributedfft_tpu.testing import chaintimer as jct
    shape, seed = (8, 8, 8), 4
    u = _jax_uniform(seed, shape)
    for k in (1, 3):
        got = float(ct.stage_chain(k, shape, backend, stage,
                                   device=CPU)(u))
        want = float(jct.stage_chain(k, shape, backend, stage)(seed))
        assert got == pytest.approx(want, rel=1e-5, abs=1e-7), (stage, k)


@pytest.mark.parametrize("direction", ["forward", "inverse", "roundtrip"])
def test_directional_chain_matches_jax(direction):
    from distributedfft_tpu.testing import chaintimer as jct
    shape, seed = (8, 8, 8), 5
    u = _jax_uniform(seed, shape)
    got = float(ct.directional_chain(3, shape, "matmul", direction,
                                     device=CPU)(u))
    want = float(jct.directional_chain(3, shape, "matmul", direction)(seed))
    assert got == pytest.approx(want, rel=1e-5)


def test_chain_is_identity_scaled(rng):
    """One roundtrip through the chain reproduces sum|x|."""
    shape = (8, 8, 8)
    x = torch.from_numpy(rng.random(shape).astype(np.float32))
    for k in (1, 3):
        got = float(ct.roundtrip_chain(k, shape, "xla")(x))
        assert got == pytest.approx(float(x.abs().sum()), rel=1e-4)


def test_median_pair_diff_positive_on_real_work(rng):
    shape = (16, 16, 16)
    x = torch.from_numpy(rng.random(shape).astype(np.float32))
    fn1 = ct.roundtrip_chain(1, shape, "xla")
    fnK = ct.roundtrip_chain(33, shape, "xla")
    float(fn1(x))
    float(fnK(x))
    per_ms, t1 = ct.median_pair_diff_ms(fn1, fnK, x, 33, repeats=2, inner=2)
    assert per_ms > 0
    assert t1 > 0


def test_k_guard():
    """The (t_K - t_1) pair needs k >= 2, in both packages."""
    from distributedfft_tpu.testing import chaintimer as jct
    for mod in (ct, jct):
        with pytest.raises(ValueError, match="k must be >= 2"):
            mod.median_pair_diff_ms(None, None, None, 1, 1, 1)


class TestDirectionalChain:
    def test_forward_accumulates_serially(self):
        fn1 = ct.directional_chain(1, (16, 16, 16), "matmul", "forward",
                                   device=CPU)
        fn5 = ct.directional_chain(5, (16, 16, 16), "matmul", "forward",
                                   device=CPU)
        a, b = float(fn1(0)), float(fn5(0))
        assert abs(b - 5 * a) < 1e-3 * abs(b)

    def test_inverse_matches_input_mean(self):
        v = float(ct.directional_chain(1, (16, 16, 16), "xla", "inverse",
                                       device=CPU)(3))
        assert np.isfinite(v) and 0.0 <= v <= 1.0

    def test_roundtrip_direction_matches_external_input_chain(self):
        shape = (8, 8, 8)
        internal = float(ct.directional_chain(2, shape, "matmul",
                                              "roundtrip", device=CPU)(5))
        g = torch.Generator(device=CPU).manual_seed(5)
        u = torch.rand(shape, generator=g)
        external = float(ct.roundtrip_chain(2, shape, "matmul")(u))
        assert abs(internal - external) / abs(external) < 1e-5

    def test_bad_direction_rejected(self):
        with pytest.raises(ValueError, match="direction"):
            ct.directional_chain(2, (8, 8, 8), "xla", "sideways")


def test_stage_chain_all_stages_run():
    for stage in ct.STAGES:
        fn1 = ct.stage_chain(1, (8, 8, 8), "matmul", stage, device=CPU)
        fn3 = ct.stage_chain(3, (8, 8, 8), "matmul", stage, device=CPU)
        a, b = float(fn1(0)), float(fn3(0))
        assert np.isfinite(a) and np.isfinite(b), stage
        assert abs(b) >= abs(a) or a == b == 0.0, stage
    with pytest.raises(ValueError, match="stage"):
        ct.stage_chain(2, (8, 8, 8), "xla", "fft_w")


def test_direct_max_override_changes_factorization(rng):
    """``MXUSettings.direct_max`` forces the four-step on a length that
    would run direct, with the same result (the matmul backend counts a
    four-step axis as more products)."""
    import dataclasses
    from distributedfft_tpu_torch.ops import fft as lf
    from distributedfft_tpu_torch.ops import mxu_fft as mx
    x = rng.random((4, 256)).astype(np.float32)
    cx = torch.from_numpy(x.astype(np.complex64))
    st = dataclasses.replace(mx.current_settings(), direct_max=128)
    a = lf.fft(cx, axis=-1, backend="matmul").numpy()
    b = lf.fft(cx, axis=-1, backend="matmul", settings=st).numpy()
    ref = np.fft.fft(x, axis=-1)
    denom = np.abs(ref).max()
    assert np.abs(a - ref).max() / denom < 1e-4
    assert np.abs(b - ref).max() / denom < 1e-4
    assert not np.array_equal(a, b)     # another factorization ran


def test_chunked_forward_chain_accumulates():
    a1 = float(ct.chunked_forward_chain(1, 32, chunk=4, device=CPU)(0))
    a5 = float(ct.chunked_forward_chain(5, 32, chunk=4, device=CPU)(0))
    assert np.isfinite(a1) and np.isfinite(a5)
    assert abs(a5 - 5 * a1) < 5e-3 * max(1.0, abs(a1) * 5)


def test_chunked_forward_chain_matches_jax():
    """The chunked plan's forward chain on JAX's draw, against JAX's."""
    from distributedfft_tpu.testing import chaintimer as jct
    u = _jax_uniform(0, (32, 32, 32))
    got = float(ct.chunked_forward_chain(3, 32, chunk=4, device=CPU)(u))
    want = float(jct.chunked_forward_chain(3, 32, chunk=4)(0))
    assert got == pytest.approx(want, rel=1e-5)
