"""The port's matmul backend (``ops/mxu_fft.py``) and the routes the
``"pallas"`` backend gives it, against the JAX package's ``mxu_fft`` and
``pallas_fft`` on the CPU.

The cases of ``tests/test_mxu_fft.py``: the same seeded numpy inputs go
through both packages. Bounds are that file's: 5e-4 in float32, 1e-11 in
float64 (1e-10 where the JAX file holds numpy to it). The JAX package
computes float32 products in full float32 on the CPU whatever the
precision, so ``HIGHEST`` and ``HIGH`` are held to it within 5e-4, and
``DEFAULT`` (one bfloat16 pass) to numpy: within 2e-3 on the reference
testcases' uniform input, whose measured error at 256^3 the JAX package
documents (5.4e-4), and within 2^-7 (four bfloat16 unit roundoffs) on
zero-mean normal data, where one pass's relative error is about twice the
unit roundoff.
"""

import dataclasses

import numpy as np
import pytest
import torch

import distributedfft_tpu as jdfft
from distributedfft_tpu.ops import mxu_fft as jmx
from distributedfft_tpu.ops import pallas_fft
from distributedfft_tpu.params import FFTNorm as JNorm

import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch.ops import fft as tlf
from distributedfft_tpu_torch.ops import hopper_fft as hf
from distributedfft_tpu_torch.ops import mxu_fft as tmx
from distributedfft_tpu_torch.params import FFTNorm

# Small direct, odd direct, prime, composite four-step (640 = 2 x 320),
# a power of two split 2 x 512.
NS = [8, 12, 13, 96, 640, 1024]
TOL = {False: 5e-4, True: 1e-11}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def _complex(shape, seed, double=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return x.astype(np.complex128 if double else np.complex64)


def _real(shape, seed, double=True):
    x = np.random.default_rng(seed).standard_normal(shape)
    return x.astype(np.float64 if double else np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(autouse=True)
def _clean_settings():
    """Every case starts and ends on the default settings of both
    packages."""
    yield
    tmx._DEFAULTS = tmx.MXUSettings()
    jmx._DEFAULTS = jmx.MXUSettings()


# ---------------------------------------------------------------------------
# The transforms against the JAX backend and numpy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("double", [False, True])
def test_fft_ifft_match_reference(n, double):
    x = _complex((3, n), n, double)
    got, goti = tmx.fft(_t(x), axis=-1), tmx.ifft(_t(x), axis=-1)
    assert got.dtype == (torch.complex128 if double else torch.complex64)
    assert _rel(got.numpy(), jmx.fft(x, axis=-1)) < TOL[double]
    assert _rel(goti.numpy(), jmx.ifft(x, axis=-1)) < TOL[double]
    assert _rel(goti.numpy(), n * np.fft.ifft(x, axis=-1)) < TOL[double]


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("double", [False, True])
def test_rfft_irfft_match_reference(n, double):
    x = _real((4, n), n + 1, double)
    got = tmx.rfft(_t(x), axis=-1)
    ref = np.asarray(jmx.rfft(x, axis=-1))
    assert got.shape == ref.shape and _rel(got.numpy(), ref) < TOL[double]
    back = tmx.irfft(got, n=n, axis=-1, norm=FFTNorm.BACKWARD)
    jback = jmx.irfft(ref, n=n, axis=-1, norm=JNorm.BACKWARD)
    assert back.dtype == (torch.float64 if double else torch.float32)
    assert _rel(back.numpy(), jback) < TOL[double]
    assert _rel(back.numpy(), x) < TOL[double]


def test_axis_and_ortho():
    x = _real((5, 32, 7), 3)
    got = tmx.rfft(_t(x), axis=1, norm=FFTNorm.ORTHO)
    assert _rel(got.numpy(), jmx.rfft(x, axis=1, norm=JNorm.ORTHO)) < 1e-11
    c = x.astype(np.complex128)
    got2 = tmx.ifft(_t(c), axis=0, norm=FFTNorm.ORTHO)
    assert _rel(got2.numpy(), jmx.ifft(c, axis=0, norm=JNorm.ORTHO)) < 1e-11


def test_four_step_recursion():
    """1042 splits 2 x 521 with 521 > DIRECT_MAX: the recursion and the
    R2C's complex promotion."""
    n = 1042
    assert tmx._split_for(n, tmx.DIRECT_MAX) == jmx._split_for(
        n, jmx.DIRECT_MAX) == (2, 521)
    x, c = _real((2, n), 4), _complex((2, n), 5)
    assert _rel(tmx.rfft(_t(x), axis=-1).numpy(),
                jmx.rfft(x, axis=-1)) < 1e-11
    assert _rel(tmx.fft(_t(c), axis=-1).numpy(), jmx.fft(c, axis=-1)) < 1e-11


@pytest.mark.parametrize("key", [("dft", 12, False), ("dft", 640, True),
                                 ("tw", 2, 320, True), ("r2", 256, False),
                                 ("c2r", 96)])
@pytest.mark.parametrize("double", [False, True])
def test_constants_are_the_references(key, double):
    """The numpy constants are the reference's, bit for bit."""
    name = {"dft": "_dft_np", "tw": "_twiddle_np", "r2": "_r2_twiddle_np",
            "c2r": "_c2r_np"}[key[0]]
    mine = getattr(tmx, name)(*key[1:], double)
    theirs = getattr(jmx, name)(*key[1:], double)
    for a, b in zip(np.atleast_1d(mine) if key[0] != "c2r" else mine,
                    np.atleast_1d(theirs) if key[0] != "c2r" else theirs):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("n", [520, 640, 1024, 1030, 1042, 2048, 6007])
def test_splits_are_the_references(n):
    assert tmx._split(n) == jmx._split(n)
    assert tmx._split_for(n, 512) == jmx._split_for(n, 512)
    assert tmx._split_wide(n, 256) == jmx._split_wide(n, 256)


# ---------------------------------------------------------------------------
# Precision
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prec", ["highest", "high"])
@pytest.mark.parametrize("n", [96, 640])
def test_single_precision_matches_reference(prec, n):
    x, xr = _complex((4, n), 6, False), _real((4, n), 7, False)
    jst, st = jmx.MXUSettings.make(prec), tmx.MXUSettings.make(prec)
    with tmx.use_settings(st):
        got, got_r = tmx.fft(_t(x), axis=-1), tmx.rfft(_t(xr), axis=-1)
    with jmx.use_settings(jst):
        ref, ref_r = jmx.fft(x, axis=-1), jmx.rfft(xr, axis=-1)
    assert got.dtype == torch.complex64
    assert _rel(got.numpy(), ref) < 5e-4
    assert _rel(got_r.numpy(), ref_r) < 5e-4


def test_high_is_three_passes_and_default_one():
    """HIGH recovers what one bfloat16 pass loses: closer to the float64
    truth than DEFAULT by more than an order of magnitude."""
    x = _complex((8, 512), 8, False)
    truth = np.fft.fft(x.astype(np.complex128), axis=-1)
    err = {}
    for prec in ("default", "high", "highest"):
        with tmx.use_settings(tmx.MXUSettings.make(prec)):
            err[prec] = _rel(tmx.fft(_t(x), axis=-1).numpy(), truth)
    assert err["highest"] < 1e-5 and err["high"] < 1e-5
    assert err["default"] > 10 * err["high"]


def test_default_precision_vs_numpy():
    st = tmx.MXUSettings.make("DEFAULT")
    uniform = np.random.default_rng(9).random((32, 32, 32)).astype(np.float32)
    normal = _complex((16, 640), 10, False)
    with tmx.use_settings(st):
        c = tmx.rfftn_3d(_t(uniform))
        g = tmx.fft(_t(normal), axis=-1)
    assert _rel(c.numpy(), np.fft.rfftn(uniform.astype(np.float64))) < 2e-3
    assert _rel(g.numpy(), np.fft.fft(normal.astype(np.complex128))) < 2 ** -7


def test_double_precision_ignores_the_precision_setting():
    x = _complex((3, 96), 11)
    base = tmx.fft(_t(x), axis=-1)
    with tmx.use_settings(tmx.MXUSettings.make("default")):
        assert torch.equal(tmx.fft(_t(x), axis=-1), base)


# ---------------------------------------------------------------------------
# Karatsuba, radix-2, four-step einsum, direct_max
# ---------------------------------------------------------------------------


def test_karatsuba_matches_the_plain_product():
    x = _complex((8, 64), 12)
    with tmx.use_settings(tmx.MXUSettings.make(karatsuba=True)):
        a = tmx.fft(_t(x), axis=-1).numpy()
    with jmx.use_settings(jmx.MXUSettings.make(karatsuba=True)):
        ref = jmx.fft(x, axis=-1)
    b = tmx.fft(_t(x), axis=-1).numpy()
    assert _rel(a, b) < 1e-12 and _rel(a, ref) < 1e-12
    assert _rel(a, np.fft.fft(x, axis=-1)) < 1e-12


@pytest.mark.parametrize("n", [160, 256, 512])
@pytest.mark.parametrize("double", [False, True])
def test_radix2_matches_reference(n, double):
    x = _complex((3, n), 13, double)
    tol = 1e-10 if double else 5e-4
    with tmx.radix2():
        got, goti = tmx.fft(_t(x), axis=-1), tmx.ifft(_t(x), axis=-1)
    with jmx.radix2():
        ref = jmx.fft(x, axis=-1)
    assert _rel(got.numpy(), ref) < tol
    assert _rel(got.numpy(), np.fft.fft(x, axis=-1)) < tol
    assert _rel(goti.numpy(), n * np.fft.ifft(x, axis=-1)) < tol


def test_matmul_r2_backend_scopes_radix2():
    """"matmul-r2" forces radix2 for the call only."""
    assert tmx.current_settings().radix2 is False
    x = np.random.default_rng(14).random((256, 4, 4)).astype(np.float32)
    c = tlf.rfftn_3d(_t(x), backend="matmul-r2")
    assert tmx.current_settings().radix2 is False
    assert _rel(c.numpy(), jdfft.ops.fft.rfftn_3d(x, backend="matmul-r2")) \
        < 5e-4
    y = tlf.irfftn_3d(c, x.shape, backend="matmul-r2")
    assert _rel(y.numpy() / x.size, x) < 5e-4


def test_radix2_roundtrip_f64_tight():
    x = np.random.default_rng(15).standard_normal((256, 6, 6))
    c = tlf.rfftn_3d(_t(x), backend="matmul-r2")
    y = tlf.irfftn_3d(c, x.shape, backend="matmul-r2").numpy() / x.size
    assert np.abs(y - x).max() < 1e-10


def test_radix2_leaves_odd_lengths_alone():
    x = _complex((3, 81), 16)
    base = tmx.fft(_t(x), axis=-1)
    with tmx.radix2():
        assert torch.equal(tmx.fft(_t(x), axis=-1), base)


@pytest.mark.parametrize("n", [640, 1024, 2048])
def test_fourstep_einsum_matches_swap_path(n):
    x = _complex((3, n), 17)
    base = tmx.fft(_t(x), axis=-1).numpy()
    with tmx.fourstep_einsum():
        got = tmx.fft(_t(x), axis=-1).numpy()
    with jmx.fourstep_einsum():
        ref = jmx.fft(x, axis=-1)
    assert _rel(got, base) < 1e-14 and _rel(got, ref) < 1e-11


def test_fourstep_einsum_r2c():
    x = _real((4, 640), 18)
    with tmx.fourstep_einsum():
        got = tmx.rfft(_t(x), axis=-1).numpy()
    assert _rel(got, np.fft.rfft(x, axis=-1)) < 1e-10


@pytest.mark.parametrize("direct_max", [64, 256])
def test_direct_max_forces_the_four_step(direct_max):
    x, xr = _complex((3, 512), 19), _real((3, 512), 20)
    st = tmx.MXUSettings.make(direct_max=direct_max)
    jst = jmx.MXUSettings.make(direct_max=direct_max)
    with tmx.use_settings(st):
        got, got_r = tmx.fft(_t(x), axis=-1), tmx.rfft(_t(xr), axis=-1)
        back = tmx.irfft(got_r, n=512, axis=-1)
    with jmx.use_settings(jst):
        ref, ref_r = jmx.fft(x, axis=-1), jmx.rfft(xr, axis=-1)
        jback = jmx.irfft(ref_r, n=512, axis=-1)
    assert _rel(got.numpy(), ref) < 1e-11
    assert _rel(got_r.numpy(), ref_r) < 1e-11
    assert _rel(back.numpy(), jback) < 1e-11


def test_row_groups_change_no_row():
    """A transform larger than ``CHUNK_BYTES`` runs in groups of rows; each
    row's arithmetic is unchanged."""
    x = _complex((40, 1024), 21)
    whole = tmx.fft(_t(x), axis=0)
    old = tmx.CHUNK_BYTES
    tmx.CHUNK_BYTES = 3 * 16 * 40        # three rows of the moved axis
    try:
        parts = tmx.fft(_t(x), axis=0)
        back = tmx.irfft(tmx.rfft(_t(x.real), axis=-1), n=1024, axis=-1)
    finally:
        tmx.CHUNK_BYTES = old
    assert parts.shape == whole.shape and _rel(parts, whole) < 1e-13
    assert _rel(back.numpy() / 1024, x.real) < 1e-12


# ---------------------------------------------------------------------------
# Settings
# ---------------------------------------------------------------------------


def test_config_builds_the_references_settings():
    kw = dict(fft_backend="matmul", mxu_precision="highest",
              mxu_karatsuba=True, mxu_direct_max=256)
    mine = tdfft.Config(**kw).mxu_settings()
    theirs = jdfft.Config(**kw).mxu_settings()
    assert mine.precision.name == theirs.precision.name == "HIGHEST"
    for f in ("radix2", "karatsuba", "fourstep_einsum", "direct_max"):
        assert getattr(mine, f) == getattr(theirs, f), f
    assert tdfft.Config(fft_backend="matmul").mxu_settings() is None
    with pytest.raises(ValueError, match="mxu_precision"):
        tdfft.Config(mxu_precision="bf16")


def test_config_from_reference_carries_the_knobs():
    j = jdfft.Config(fft_backend="matmul-r2", mxu_precision="default",
                     mxu_fourstep_einsum=True, mxu_direct_max=128,
                     streams_chunks=5)
    cfg = tdfft.config_from_reference(dataclasses.asdict(j))
    assert (cfg.mxu_precision, cfg.mxu_fourstep_einsum, cfg.mxu_direct_max,
            cfg.streams_chunks) == ("default", True, 128, 5)
    assert cfg.resolved_streams_chunks() == j.resolved_streams_chunks() == 5
    assert tdfft.Config().resolved_streams_chunks() == 4


def test_settings_scope_and_restore():
    st = tmx.MXUSettings.make("highest", fourstep_einsum=True)
    assert tmx.current_settings() == tmx.MXUSettings()
    with tmx.use_settings(st):
        assert tmx.current_settings() is st
        with tmx.use_settings(None):
            assert tmx.current_settings() is st
    assert tmx.current_settings() == tmx.MXUSettings()
    tmx.set_precision("highest")          # the deprecated process default
    assert tmx.current_settings().precision is tmx.Precision.HIGHEST
    with tmx.use_settings(tmx.MXUSettings()):
        assert tmx.current_settings().precision is tmx.Precision.HIGH
    tmx.set_precision(tmx.Precision.HIGH)
    assert tmx.as_precision(jmx.as_precision("high")) is tmx.Precision.HIGH


def test_settings_kwarg_overrides_the_process_default():
    """An explicit ``settings=`` beats the process default and does not
    escape the call."""
    x = _complex((4, 1024), 22, False)
    tmx.set_fourstep_einsum(True)
    st_off = tmx.MXUSettings.make(fourstep_einsum=False)
    seen = []
    orig = tmx._fourstep_einsum

    def spy(*a):
        seen.append(1)
        return orig(*a)

    tmx._fourstep_einsum = spy
    try:
        tlf.fft(_t(x), axis=-1, backend="matmul", settings=st_off)
        assert not seen
        tlf.fft(_t(x), axis=-1, backend="matmul")
        assert seen
    finally:
        tmx._fourstep_einsum = orig
    assert tmx.current_settings().fourstep_einsum is True


def test_two_plans_with_different_settings_coexist():
    g = tdfft.GlobalSize(8, 8, 8)
    part = tdfft.SlabPartition(1)
    plain = tdfft.SlabFFTPlan(g, part, tdfft.Config(fft_backend="matmul"),
                              device="cpu")
    kara = tdfft.SlabFFTPlan(g, part, tdfft.Config(fft_backend="matmul",
                                                   mxu_karatsuba=True),
                             device="cpu")
    assert plain._mxu_st is None and kara._mxu_st.karatsuba
    calls = []
    orig = tmx._mm

    def spy(a, key, part_, prec, left=False):
        calls.append(part_)
        return orig(a, key, part_, prec, left)

    x = np.random.default_rng(23).random(g.shape).astype(np.float32)
    tmx._mm = spy
    try:
        a = plain.exec_r2c(_t(x)).numpy()
        n_plain = list(calls)
        calls.clear()
        b = kara.exec_r2c(_t(x)).numpy()
    finally:
        tmx._mm = orig
    assert "sum" in calls and "sum" not in n_plain   # Karatsuba's product
    assert tmx.current_settings() == tmx.MXUSettings()
    ref = np.fft.rfftn(x)
    assert _rel(a, ref) < 1e-4 and _rel(b, ref) < 1e-4


# ---------------------------------------------------------------------------
# The all-real-planes 3D pair
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(16, 16, 16), (8, 12, 10), (4, 8, 9)])
def test_real_planes_3d_match_reference(shape):
    x = np.random.default_rng(24).random(shape).astype(np.float32)
    cr, ci = tmx.rfftn_3d_planes(_t(x))
    jcr, jci = jmx.rfftn_3d_planes(x)
    ref = np.fft.rfftn(x)
    assert cr.dtype == ci.dtype == torch.float32
    got = cr.numpy() + 1j * ci.numpy()
    assert _rel(got, ref) < 1e-5
    assert _rel(got, np.asarray(jcr) + 1j * np.asarray(jci)) < 1e-5
    y = tmx.irfftn_3d_planes(_t(ref.real.astype(np.float32)),
                             _t(ref.imag.astype(np.float32)), shape)
    assert np.abs(y.numpy() / np.prod(shape) - x).max() < 1e-4


def test_real_planes_reject_non_direct():
    with pytest.raises(ValueError, match="direct-size"):
        tmx.rfftn_3d_planes(torch.zeros((4, 4, 1024)))


# ---------------------------------------------------------------------------
# The backend through ops/fft.py and the plans
# ---------------------------------------------------------------------------


def test_backend_dispatch_matches_xla():
    x = _real((4, 64), 25)
    a = tlf.rfft(_t(x), axis=-1, backend="matmul")
    b = tlf.rfft(_t(x), axis=-1, backend="xla")
    assert _rel(a.numpy(), b.numpy()) < 1e-11
    # "bluestein", which raised until it was ported: a smooth axis is the
    # "xla" call, bit for bit.
    assert torch.equal(tlf.rfft(_t(x), axis=-1, backend="bluestein"), b)


def test_rfftn3d_matches_reference():
    x = _real((8, 8, 8), 26)
    got = tmx.rfftn_3d(_t(x))
    assert _rel(got.numpy(), jmx.rfftn_3d(x)) < 1e-11
    back = tmx.irfftn_3d(got, (8, 8, 8))
    assert _rel(back.numpy(), x * 8 ** 3) < 1e-11


@pytest.mark.parametrize("backend", ["matmul", "matmul-r2", "pallas"])
@pytest.mark.parametrize("shape", [(16, 16, 16), (7, 11, 13)])
def test_one_rank_plan_in_double_precision(backend, shape):
    """One rank, f64: the matmul backend (under "pallas" too, as the JAX
    package routes f64) against the JAX plan, 1e-10."""
    cfg = dict(double_prec=True, fft_backend=backend)
    g = tdfft.GlobalSize(*shape)
    plan = tdfft.SlabFFTPlan(g, tdfft.SlabPartition(1), tdfft.Config(**cfg),
                             device="cpu")
    jplan = jdfft.SlabFFTPlan(jdfft.GlobalSize(*shape), jdfft.SlabPartition(1),
                              jdfft.Config(**cfg))
    x = _real(shape, 27)
    hf.reset_launches()
    c = plan.exec_r2c(_t(x))
    assert hf.DISPATCHES == {"matmul": 3} and not any(hf.LAUNCHES.values())
    jc = np.asarray(jplan.exec_r2c(x))
    assert c.dtype == torch.complex128 and _rel(c.numpy(), jc) < 1e-10
    assert _rel(c.numpy(), np.fft.rfftn(x)) < 1e-10
    back = plan.exec_c2r(c)
    assert back.dtype == torch.float64
    assert _rel(back.numpy(), np.asarray(jplan.exec_c2r(jc))) < 1e-10
    assert _rel(back.numpy(), x * g.n_total) < 1e-10


def test_one_rank_plan_matmul_single_precision():
    g = tdfft.GlobalSize(16, 16, 16)
    cfg = dict(fft_backend="matmul", mxu_precision="high")
    plan = tdfft.SlabFFTPlan(g, tdfft.SlabPartition(1), tdfft.Config(**cfg),
                             device="cpu")
    jplan = jdfft.SlabFFTPlan(jdfft.GlobalSize(16, 16, 16),
                              jdfft.SlabPartition(1), jdfft.Config(**cfg))
    x = np.random.default_rng(28).random(g.shape).astype(np.float32)
    c = plan.exec_r2c(_t(x))
    assert c.dtype == torch.complex64
    assert _rel(c.numpy(), jplan.exec_r2c(x)) < 5e-4
    assert _rel(plan.exec_c2r(c).numpy() / g.n_total, x) < 5e-4


# ---------------------------------------------------------------------------
# What "pallas" hands the matmul backend
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn", ["fft", "ifft", "rfft", "irfft"])
@pytest.mark.parametrize("n", [12, 640, 2048])
def test_pallas_double_precision_matches_reference(fn, n):
    """f64 under "pallas" against ``pallas_fft`` run as its tests run it:
    ``fft`` / ``ifft`` / ``rfft`` the matmul backend's, ``irfft`` the real
    part of the Hermitian extension's complex inverse (never the folded
    C2R matrices); 1e-11."""
    if fn == "rfft":
        x = _real((3, n), 29)
    elif fn == "irfft":
        x = _complex((3, n // 2 + 1), 30)
    else:
        x = _complex((3, n), 31)
    kw = {"n": n} if fn == "irfft" else {}
    hf.reset_launches()
    got = getattr(hf, fn)(_t(x), axis=-1, **kw)
    ref = np.asarray(getattr(pallas_fft, fn)(x, axis=-1, **kw))
    assert hf.DISPATCHES == {"matmul": 1} and not any(hf.LAUNCHES.values())
    assert got.shape == ref.shape and _rel(got.numpy(), ref) < 1e-11


def test_pallas_double_irfft_is_not_the_folded_c2r():
    """At a direct length the f64 "pallas" C2R inverts the extension, as
    ``pallas_fft.irfft`` does: closer to it than the matmul backend's
    folded (CR, CI) product is."""
    n = 96
    x = _complex((4, n // 2 + 1), 32)
    got = hf.irfft(_t(x), n=n, axis=-1).numpy()
    ref = np.asarray(pallas_fft.irfft(x, n=n, axis=-1))
    folded = tmx.irfft(_t(x), n=n, axis=-1).numpy()
    assert _rel(got, ref) <= _rel(folded, ref)
    assert _rel(got, tmx.irfft_extended(_t(x), n=n, axis=-1).numpy()) == 0


@pytest.mark.parametrize("fn", ["fft", "ifft", "rfft", "irfft"])
def test_pallas_long_prime_matches_reference(fn):
    """A 1031-point prime axis under "pallas" float32 (above N_MAX): the
    matmul backend at the default precision, within 5e-4 of
    ``pallas_fft``."""
    n = 1031
    if fn == "rfft":
        x = _real((2, n), 33, False)
    elif fn == "irfft":
        x = _complex((2, n // 2 + 1), 34, False)
    else:
        x = _complex((2, n), 35, False)
    kw = {"n": n} if fn == "irfft" else {}
    hf.reset_launches()
    got = getattr(hf, fn)(_t(x), axis=-1, **kw)
    ref = np.asarray(getattr(pallas_fft, fn)(x, axis=-1, **kw))
    assert hf.DISPATCHES == {"matmul": 1} and not any(hf.LAUNCHES.values())
    assert got.dtype == (torch.float32 if fn == "irfft" else torch.complex64)
    assert _rel(got.numpy(), ref) < 5e-4


def test_pallas_long_prime_non_last_axis():
    x = _complex((1031, 3), 36, False)
    got = hf.fft(_t(x), axis=0)
    assert _rel(got.numpy(), pallas_fft.fft(x, axis=0)) < 5e-4


def test_pallas_settings_reach_the_long_prime():
    """The plan's precision reaches the axes "pallas" hands over."""
    x = _complex((2, 1031), 37, False)
    truth = np.fft.fft(x.astype(np.complex128), axis=-1)
    hi = tlf.fft(_t(x), axis=-1, backend="pallas",
                 settings=tmx.MXUSettings.make("highest"))
    lo = tlf.fft(_t(x), axis=-1, backend="pallas",
                 settings=tmx.MXUSettings.make("default"))
    assert _rel(hi.numpy(), truth) < 1e-5 < _rel(lo.numpy(), truth)


def test_fourstep_microbench_runs():
    """``microbench.matmul_fourstep_ms`` times each piece it names (the
    times mean something only on the card)."""
    from distributedfft_tpu_torch.testing.microbench import \
        matmul_fourstep_ms
    out = matmul_fourstep_ms(rows=8, iterations=1, warmup=0, device="cpu")
    assert set(out) == {"whole", "first_product_over_the_view", "swap_copy",
                        "first_product_2d", "second_product_inner_2",
                        "second_product_in_place"}
    assert all(v > 0 for v in out.values())
