"""A split axis where it lies, on the CPU: kernel 2's short-stage body (the
four-step's second stage, ``cdft_short``), kernel 4's column body (its
first stage on a non-last axis, ``cdft_tw_cols``) and the dispatch that
runs them.

* The short-stage body's plain version (``cdft_short_plain``) against a
  dense numpy DFT on the axis, to 1e-5 (float32 against float64), for n1
  in {2, 3, 4, 5, 6, 8, 12, 16} and each output geometry: the natural
  order of a last split axis, the R2C crop, the store of a non-last
  axis into its layout. Its kernel arithmetic (``cdft_short_mirror``:
  the engine's radix-2 network, or the dense product with
  ``short_roots``) against numpy (1e-5) and against the JAX package's
  ``pallas_fft._stage`` on the same rows of n1 points (its Pallas kernel
  in interpret mode; 5e-4, the JAX per-stage bound).
* Kernel 4's column body (``cdft_tw_cols_mirror``: the column kernel's
  passes, then the twiddle of its epilogue) against ``stage_plain`` with
  the twiddle (1e-5) and against JAX's ``_call_stage`` with ``twiddle=(n1,
  n2, inverse)`` (interpret mode, 5e-4), at the same n1.
* ``fft`` / ``ifft`` / ``rfft`` / ``irfft`` of the split lengths 640,
  1042, 1536, 2048, 4096 and 8192, last and non-last, against
  ``pallas_fft``'s at small lead dimensions (5e-4).
* The routing, with the wrappers' checks and ``_launch`` patched and the
  tensors on the "meta" device, so the card's route runs with no memory
  and no kernel: which entries each split axis launches, that its second
  stage never takes ``dfft_stage`` (and a power-of-two n2 no
  ``dfft_stage`` at all), the arguments of the in-place route, and the
  entry points of ``chip_smoke.py``'s per-axis plans at their full size.
"""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from distributedfft_tpu.ops import mxu_fft as jmx
from distributedfft_tpu.ops import pallas_fft
from distributedfft_tpu.params import FFTNorm as JNorm
from distributedfft_tpu_torch.ops import hopper_fft as hf
from distributedfft_tpu_torch.params import FFTNorm

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
N1S = [2, 3, 4, 5, 6, 8, 12, 16]
SPLIT_NS = [640, 1042, 1536, 2048, 4096, 8192]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def _complex(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _real(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _dft(x, axis, inverse):
    """The unnormalized DFT in float64."""
    n = x.shape[axis]
    x = x.astype(np.complex128)
    return np.fft.ifft(x, axis=axis) * n if inverse else np.fft.fft(x, axis=axis)


# ---------------------------------------------------------------------------
# The short-stage body
# ---------------------------------------------------------------------------


def test_short_body_and_roots():
    assert [n for n in range(40) if hf._short_body(n)] == list(range(2, 17))
    assert hf.SHORT_MAX == 16
    for n1 in N1S:
        for inverse in (False, True):
            r = hf.short_roots(n1, inverse)
            w = np.exp((1 if inverse else -1) * 2j * np.pi * np.arange(n1)
                       / n1)
            assert r.shape == (2, n1) and r.dtype == np.float32
            assert np.abs(r[0] + 1j * r[1] - w).max() <= 1e-7


def _geometry(kind, outer, n1, inner):
    """(input shape, geometry, output shape, numpy placement of the DFT d
    of the (outer, n1, inner) input) of one caller's layout."""
    if kind == "natural":
        return ((outer, n1, inner), hf.short_last(n1, inner),
                (outer, n1 * inner), lambda d: d.reshape(outer, -1))
    if kind == "crop":
        n_out = n1 * inner // 2 + 1
        return ((outer, n1, inner), hf.short_last(n1, inner, n_out),
                (outer, n_out), lambda d: d.reshape(outer, -1)[:, :n_out])
    # A non-last axis of n1 * n2 points: outer index q = o n2 + k2, bin
    # k1 n2 + k2 at (o, k1 n2 + k2, b).
    n2, o = 5, outer
    return ((o * n2, n1, inner), hf.short_strided(n1, n2, inner),
            (o, n1 * n2, inner),
            lambda d: d.reshape(o, n2, n1, inner).transpose(0, 2, 1, 3)
            .reshape(o, n1 * n2, inner))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("kind", ["natural", "crop", "strided"])
@pytest.mark.parametrize("n1", N1S)
def test_short_plain_matches_numpy(n1, kind, inverse):
    """Every output geometry: an odd outer count, an odd inner extent."""
    shape, geom, out_shape, place = _geometry(kind, 3, n1, 7)
    x = _complex(shape, n1 + 10 * inverse)
    got = hf.cdft_short(torch.from_numpy(x), inverse, geom, out_shape)
    assert got.shape == out_shape and got.dtype == torch.complex64
    assert torch.equal(got, hf.cdft_short_plain(torch.from_numpy(x), inverse,
                                                geom, out_shape))
    assert _rel(got.numpy(), place(_dft(x, 1, inverse))) <= 1e-5


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n1", N1S)
def test_short_mirror_matches_numpy_and_jax_stage(n1, inverse):
    """The kernel's DFT on (outer, n1, inner) columns against numpy and
    against JAX's stage on the same rows of n1 points."""
    x = _complex((4, n1, 6), 2 * n1 + inverse)
    got = hf.cdft_short_mirror(torch.from_numpy(x), inverse).numpy()
    assert got.dtype == np.complex64
    assert _rel(got, _dft(x, 1, inverse)) <= 1e-5
    rows = np.ascontiguousarray(x.transpose(0, 2, 1))         # (4, 6, n1)
    ref = np.asarray(pallas_fft._stage(rows, jmx._dft_np(n1, inverse, False)))
    assert _rel(got, ref.transpose(0, 2, 1)) <= 5e-4


def test_short_checks_its_arguments():
    x = torch.zeros((6, 4, 8), dtype=torch.complex64)
    g = hf.short_last(4, 8)
    with pytest.raises(TypeError):
        hf.cdft_short(x.to(torch.complex128), False, g, (6, 32))
    with pytest.raises(ValueError):
        hf.cdft_short(torch.zeros((6, 17, 8), dtype=torch.complex64), False,
                      hf.short_last(17, 8), (6, 136))      # n1 past 16
    with pytest.raises(ValueError):
        hf.cdft_short(torch.zeros((6, 1, 8), dtype=torch.complex64), False,
                      hf.short_last(1, 8), (6, 8))         # n1 below 2
    with pytest.raises(ValueError):
        hf.cdft_short(x[:, :, :4], False, hf.short_last(4, 4), (6, 16))
    with pytest.raises(ValueError):
        hf.cdft_short(x, False, g, (6, 31))                # output too small
    with pytest.raises(ValueError):
        hf.cdft_short(x, False, hf.short_strided(4, 4, 8), (1, 16, 8))
    with pytest.raises(ValueError):
        hf.cdft_short(x.to("meta"), False, g, (6, 32))     # no kernel
    hf.reset_launches()
    assert hf.cdft_short(x[:0], False, g, (0, 32)).shape == (0, 32)
    assert all(v == 0 for v in hf.LAUNCHES.values()), hf.LAUNCHES


# ---------------------------------------------------------------------------
# Kernel 4's column body
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n1", N1S)
def test_tw_cols_mirror_matches_stage_plain_and_call_stage(n1, inverse):
    """(outer, n2, n1 span) columns: the mirror, the wrapper's plain
    version, ``stage_plain`` and JAX's ``_call_stage`` on the same rows of
    n2 points, ordered so that row % n1 is the twiddle row r."""
    outer, span = 2, 3
    n2 = 16 if n1 % 2 else 64
    x = _complex((outer, n2, n1 * span), 3 * n1 + inverse)
    got = hf.cdft_tw_cols_mirror(torch.from_numpy(x), n1, inverse).numpy()
    plain = hf.cdft_tw_cols(torch.from_numpy(x), n1, inverse).numpy()
    rows = np.ascontiguousarray(
        x.reshape(outer, n2, n1, span).transpose(0, 3, 2, 1)).reshape(-1, n2)
    ref = hf.stage_plain(torch.from_numpy(rows),
                         *hf._planes("dft", n2, inverse, CPU),
                         *hf._twiddle_planes(n1, n2, inverse, CPU)).numpy()

    def back(r):
        return r.reshape(outer, span, n1, n2).transpose(0, 3, 2, 1).reshape(
            x.shape)

    assert _rel(got, back(ref)) <= 1e-5
    assert _rel(plain, back(ref)) <= 1e-5
    jax = np.asarray(pallas_fft._call_stage(
        rows, jmx._dft_np(n2, inverse, False), twiddle=(n1, n2, inverse)))
    assert _rel(got, back(jax)) <= 5e-4


def test_tw_cols_checks_its_arguments():
    x = torch.zeros((2, 16, 12), dtype=torch.complex64)
    with pytest.raises(TypeError):
        hf.cdft_tw_cols(x.real.contiguous(), 4, False)
    with pytest.raises(ValueError):
        hf.cdft_tw_cols(x, 5, False)                       # 5 does not divide 12
    with pytest.raises(ValueError):
        hf.cdft_tw_cols(x, 0, False)
    with pytest.raises(ValueError):
        hf.cdft_tw_cols(torch.zeros((2, 12, 4), dtype=torch.complex64), 4,
                        False)                             # n2 not 2^k
    with pytest.raises(ValueError):
        hf.cdft_tw_cols(torch.zeros((1, 1024, 4), dtype=torch.complex64), 4,
                        False)                             # n2 past 512
    with pytest.raises(ValueError):
        hf.cdft_tw_cols(x.transpose(0, 2).contiguous().transpose(0, 2), 4,
                        False)                             # not contiguous
    with pytest.raises(ValueError):
        hf.cdft_tw_cols(x.to("meta"), 4, False)            # no kernel


# ---------------------------------------------------------------------------
# The split lengths through the public per-axis API, against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("where", ["last", "non_last"])
@pytest.mark.parametrize("fn", ["fft", "ifft", "rfft", "irfft"])
@pytest.mark.parametrize("n", SPLIT_NS)
def test_split_lengths_match_jax(n, fn, where):
    axis = -1 if where == "last" else 0
    seed = n + len(fn) + len(where)
    if fn in ("fft", "ifft"):
        x = _complex((2, n) if where == "last" else (n, 3), seed)
        got = getattr(hf, fn)(torch.from_numpy(x), axis=axis)
        ref = getattr(pallas_fft, fn)(x, axis=axis)
        assert got.is_contiguous()
    elif fn == "rfft":
        x = _real((2, n) if where == "last" else (n, 3), seed)
        got = hf.rfft(torch.from_numpy(x), axis=axis)
        ref = pallas_fft.rfft(x, axis=axis)
    else:
        half = n // 2 + 1
        r = _real((2, n) if where == "last" else (n, 3), seed)
        c = np.fft.rfft(r, axis=axis).astype(np.complex64)
        assert c.shape[axis] == half
        got = hf.irfft(torch.from_numpy(c), n=n, axis=axis,
                       norm=FFTNorm.BACKWARD)
        ref = pallas_fft.irfft(c, n=n, axis=axis, norm=JNorm.BACKWARD)
        assert _rel(got.numpy(), r) <= 5e-4
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape
    assert _rel(got.numpy(), ref) <= 5e-4


# ---------------------------------------------------------------------------
# Routing: the card's route on meta tensors, nothing launched
# ---------------------------------------------------------------------------


def _record_launches(monkeypatch):
    """Make every wrapper take its CUDA route, recording each launch as
    (counter, C entry point, arguments) instead of running it. With meta
    tensors the whole route runs and allocates nothing."""
    log = []
    for name in ("_check_rows", "_check", "_check_cols", "_check_short",
                 "_check_tw_cols"):
        monkeypatch.setattr(hf, name, lambda *a, **k: False)
    monkeypatch.setattr(hf, "_launch", lambda kernel, fn, *args:
                        log.append((kernel, fn, args)))
    return log


_TW_COLS = ("cmatmul_tw", "dfft_cdft_tw_cols")
_SHORT = ("cmatmul", "dfft_cdft_short")
_TW = ("cmatmul_tw", "dfft_cdft_tw")
_PACKED = ("c2r", "dfft_c2r_packed")
_PACK = ("c2r", "dfft_c2r_pack")


@pytest.mark.parametrize("call, want", [
    # Non-last split axes of contiguous tensors: where they lie.
    (("fft", (2048, 3, 5), 0), [_TW_COLS, _SHORT]),
    (("ifft", (2, 8192, 3), 1), [_TW_COLS, _SHORT]),
    (("fft", (1536, 2), 0), [_TW_COLS, _SHORT]),
    (("ifft", (4096, 4, 1), 0), [_TW_COLS, _SHORT]),
    (("fft", (3, 1030, 2), 1),                          # 5 x 206: n2 not 2^k
     [("cmatmul_tw", "dfft_stage"), _SHORT]),
    # Last split axes: one swap, the first stage on rows, the short stage.
    (("fft", (3, 2048), -1), [_TW, _SHORT]),
    (("ifft", (2, 6144), -1), [_TW, _SHORT]),
    (("rfft", (3, 2048), -1), [("rmatmul_tw", "dfft_rdft_tw"), _SHORT]),
    # irfft of an even n: the complex inverse of n / 2 points, one launch
    # of kernel 3's packed body where the engine takes n / 2 (2048), else
    # its pack pass and the four-step of n / 2 entered after its swap
    # (4096 = 2 x 4 x 512).
    (("irfft", (3, 1025), -1), [_PACKED]),
    (("irfft", (3, 2049), -1), [_PACK, _TW, _SHORT]),
    # A non-last split axis that moves: n2 = 320 (its first stage on the
    # engine's mixed-radix kernel), a prime n2 = 521 (its direct stage,
    # then the twiddle as a product), a non-contiguous view, rfft of a
    # non-last axis.
    (("fft", (640, 3), 0), [_TW, _SHORT]),
    (("fft", (1042, 2), 0), [("cmatmul", "dfft_stage"), _SHORT]),
    (("view", (2048, 3, 4), 0), [_TW, _SHORT]),
    (("rfft", (2048, 3), 0), [("rmatmul_tw", "dfft_rdft_tw"), _SHORT]),
    # n1 past 16 (16384 = 32 x 512): its second stage on rows of 32.
    (("fft", (16384, 2), 0), [_TW, ("cmatmul", "dfft_cdft")]),
])
def test_split_axis_routes(monkeypatch, call, want):
    """Which entries a split axis launches on the card. The second stage of
    every split with n1 <= 16 is the short-stage body, never
    ``dfft_stage``; a power-of-two n2 launches no ``dfft_stage`` at all."""
    log = _record_launches(monkeypatch)
    fn, shape, axis = call
    if fn == "rfft":
        x = torch.zeros(shape, device="meta")
        y = hf.rfft(x, axis=axis)
    elif fn == "irfft":
        x = torch.zeros(shape, dtype=torch.complex64, device="meta")
        y = hf.irfft(x, n=2 * (shape[-1] - 1), axis=axis)
    elif fn == "view":
        x = torch.zeros(shape[:2] + (2 * shape[2],), dtype=torch.complex64,
                        device="meta")[..., ::2]
        assert not x.is_contiguous() and not hf._split_in_place(x, axis)
        y = hf.fft(x, axis=axis)
    else:
        x = torch.zeros(shape, dtype=torch.complex64, device="meta")
        y = getattr(hf, fn)(x, axis=axis)
    assert [(k, e) for k, e, _ in log] == want
    # irfft: the complex inverse's n / 2 points, split when not direct.
    n = shape[-1] - 1 if fn == "irfft" else shape[axis]
    n1, n2 = hf._split_axis(n) if not hf._direct(n) else (1, n)
    if hf._short_body(n1):
        assert log[-1][:2] == _SHORT
        assert ("cmatmul", "dfft_stage") not in [(k, e) for k, e, _ in log[1:]]
    if hf._fft_body(n2) == "fft":
        assert all(e != "dfft_stage" for _, e, _ in log)
    if fn in ("fft", "ifft", "view"):
        assert tuple(y.shape) == shape and y.is_contiguous()


@pytest.mark.parametrize("shape, axis", [((2048, 3, 5), 0), ((2, 1536, 7), 1),
                                         ((8192, 4), 0)])
@pytest.mark.parametrize("inverse", [False, True])
def test_split_in_place_arguments(monkeypatch, shape, axis, inverse):
    """The in-place route: kernel 4's column body on the (outer, n2, n1
    inner) view of the caller's tensor, then the short-stage body on the
    (outer n2, n1, inner) view of its output, storing each bin into a
    tensor of the input's shape."""
    log = _record_launches(monkeypatch)
    x = torch.zeros(shape, dtype=torch.complex64, device="meta")
    assert hf._split_in_place(x, axis)
    y = (hf.ifft if inverse else hf.fft)(x, axis=axis)
    n = shape[axis]
    n1, n2 = hf._split_axis(n)
    outer, inner = math.prod(shape[:axis]), math.prod(shape[axis + 1:])
    (k1, e1, a1), (k2, e2, a2) = log
    assert (k1, e1) == _TW_COLS and (k2, e2) == _SHORT
    assert a1[0]._base is x and a1[0].shape == (outer, n2, n1 * inner)
    assert a1[5:] == (outer, n2, n1 * inner, n1,
                      hf.fft_plan(n2, inverse).schedule, int(inverse))
    assert a2[0]._base is a1[4] and a2[0].shape == (outer * n2, n1, inner)
    assert a2[2] is y and y.shape == shape
    assert a2[3:] == (outer * n2, n1, inner, n2, int(inverse), n * inner,
                      inner, n2 * inner, n * inner)


def test_split_in_place_is_a_pure_predicate():
    c64 = torch.complex64

    def t(shape, dtype=c64):
        return torch.zeros(shape, dtype=dtype, device="meta")

    assert hf._split_in_place(t((2048, 3)), 0)
    assert hf._split_in_place(t((2, 1536, 3)), 1)
    assert hf._split_in_place(t((2, 1536, 3)), -2)
    assert hf._split_in_place(t((8192, 1)), 0)
    assert not hf._split_in_place(t((3, 2048)), 1)         # last axis
    assert not hf._split_in_place(t((3, 2048)), -1)
    assert not hf._split_in_place(t((1024, 3)), 0)         # direct
    assert not hf._split_in_place(t((640, 3)), 0)          # n2 = 320
    assert not hf._split_in_place(t((1042, 3)), 0)         # n2 = 521
    assert not hf._split_in_place(t((16384, 3)), 0)        # n1 = 32
    assert not hf._split_in_place(t((2048, 3), torch.complex128), 0)
    assert not hf._split_in_place(t((2048, 6))[:, ::2], 0)
    assert not hf._split_in_place(t((2048,)), 0)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("pid", ["per_axis_1024", "per_axis_2048x256x2048"])
def test_per_axis_plans_launch_what_chip_smoke_expects(monkeypatch, pid):
    """``chip_smoke.py``'s single-card per-axis plans at their full size,
    each direction's launches and entry points as it requires, with no
    ``dfft_stage``; the split plan's aten limits are the ones its copies
    set."""
    cs = _chip_smoke()
    shape, want_f, want_i, ent_f, ent_i, limits = cs.PER_AXIS_PATHS[pid]
    log = _record_launches(monkeypatch)

    def counted():
        kernels, entries = {}, {}
        for k, e, _ in log:
            kernels[k] = kernels.get(k, 0) + 1
            entries[e] = entries.get(e, 0) + 1
        del log[:]
        return kernels, entries

    c = hf.rfftn_3d(torch.zeros(shape, device="meta"))
    assert c.shape == shape[:2] + (shape[2] // 2 + 1,) and c.is_contiguous()
    assert counted() == (want_f, ent_f)
    back = hf.irfftn_3d(c, shape)
    assert back.shape == shape and back.dtype == torch.float32
    assert counted() == (want_i, ent_i)
    assert "dfft_stage" not in ent_f and "dfft_stage" not in ent_i
    if pid == "per_axis_2048x256x2048":
        assert limits == cs.split_copy_limits(shape)
        assert 5.5 < limits[0] < 5.7 and limits[1] == cs.COPY_LIMIT_MS
