"""The column kernel of the row FFT engine (kernel 7's FFT body, and kernel
2 on a non-last axis) and its dispatch, on the CPU.

``fft_cols_mirror`` runs the kernel's function in plain PyTorch: batches
of ``cols_geometry(n).width`` columns of an (outer, n, inner) array, the
last group of a ragged inner extent filled out, the engine's passes on
each column (``fft_rows_mirror``), the filled columns dropped. It is held
against

* ``x_c2c_plain`` (kernel 7's dense products) and ``cdft_cols_plain``, to
  1e-5: float32 on both sides, sums in another order;
* the JAX package's ``pallas_fft._x_transform`` (its Pallas kernel in
  interpret mode where a tile fits, its einsum at X = 512) and
  ``pallas_fft.fft`` / ``ifft``, to 5e-4, the JAX package's per-stage
  bound.

Also the routing, with the wrappers' checks and ``_launch`` patched so that
nothing runs: ``fft`` / ``ifft`` of a contiguous tensor along a non-last
axis the engine takes reach ``dfft_cdft_cols`` with the caller's tensor
(no copy); a split axis runs its four-step where it lies
(``dfft_cdft_tw_cols``, ``dfft_cdft_short``); another length, or a
non-contiguous view, keeps the axis move; the fused plan reaches kernel
7's column body (``dfft_x_cols``, or ``dfft_x_mixed`` at a mixed length)
exactly when ``_x_body(X)`` is "fft"; and the per-axis
plans launch the entry points ``chip_smoke.py`` expects.
"""

import numpy as np
import pytest
import torch

from distributedfft_tpu.ops import pallas_fft
from distributedfft_tpu_torch.ops import hopper_fft as hf

CPU = torch.device("cpu")
POW2 = [8, 16, 32, 64, 128, 256, 512, 1024]
X_POW2 = [n for n in POW2 if n <= 512]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def _complex(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _tail_shape(X):
    """(X, Ky, 5) with Ky * 5 one group of ``width`` columns and a ragged
    tail of 3 to 7 more."""
    width = hf.cols_geometry(X).width
    return (X, -(-(width + 3) // 5), 5)


@pytest.mark.parametrize("n", POW2)
def test_cols_geometry(n):
    """Every point-row of a batch is a strip of at least 128 bytes of
    complex64 (16 columns), each half of a batch fills one 64 KB buffer
    (32 KB at n = 8; at n = 1024 a batch is two halves of 512 rows), the
    threads of a block cover it, and a thread's points hold whole
    butterflies of every pass of the plan."""
    g = hf.cols_geometry(n)
    cp = hf.cols_plan(n, False)
    assert g.width * g.threads == hf.COL_THREADS
    assert g.points * g.threads * g.halves == n
    assert 8 * g.width >= 128
    assert 8 * g.width * n // g.halves == (32768 if n == 8 else 65536)
    assert g.halves == (2 if n == 1024 else 1)
    assert all(g.points % r == 0 for r in cp.plan.radices)
    assert cp.plan == hf.fft_plan(n // g.halves, False)
    if g.halves == 2:
        w = np.exp(-2j * np.pi * np.arange(n // 2) / n)
        assert cp.split.shape == (2, n // 2)
        assert np.abs(cp.split[0] + 1j * cp.split[1] - w).max() <= 1e-7
    else:
        assert cp.split is None
    with pytest.raises(ValueError):
        hf.cols_geometry(2048)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("X", X_POW2)
def test_cols_mirror_matches_x_c2c_plain_and_x_transform(X, inverse):
    """Kernel 7's FFT body on (X, Ky, Zo) planes: one outer index, a
    ragged last group of columns."""
    shape = _tail_shape(X)
    c = _complex(shape, X + inverse)
    ar = torch.from_numpy(np.ascontiguousarray(c.real))
    ai = torch.from_numpy(np.ascontiguousarray(c.imag))
    got = hf.fft_cols_mirror(torch.from_numpy(c).reshape(1, X, -1), inverse)
    got = got.reshape(shape)
    assert got.dtype == torch.complex64
    pr, pi = hf.x_c2c_plain(ar, ai, *hf._planes("dft", X, inverse, CPU))
    assert _rel(got.numpy(), torch.complex(pr, pi).numpy()) <= 1e-5
    jr, ji = pallas_fft._x_transform(c.real, c.imag, inverse, frozenset())
    assert _rel(got.numpy(), np.asarray(jr) + 1j * np.asarray(ji)) <= 5e-4


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shape", [(3, 1024, 5), (2, 1024, 11),
                                   (1, 512, 21), (4, 8, 513), (2, 64, 129)])
def test_cols_mirror_matches_cdft_cols_plain(shape, inverse):
    """Kernel 2's column body on (outer, n, inner): several outer indices,
    an odd inner extent (the 1024^3 y axis's rows of 513 elements), a
    partial last group."""
    x = torch.from_numpy(_complex(shape, sum(shape) + inverse))
    got = hf.fft_cols_mirror(x, inverse)
    assert got.shape == x.shape
    assert _rel(got.numpy(), hf.cdft_cols_plain(x, 1, inverse).numpy()) <= 1e-5


@pytest.mark.parametrize("shape, axis", [((3, 1024, 5), 1), ((1024, 6, 5), 0),
                                         ((5, 64, 3, 7), 1), ((16, 9), 0)])
@pytest.mark.parametrize("inverse", [False, True])
def test_fft_of_a_non_last_axis_matches_jax(shape, axis, inverse):
    """``fft`` / ``ifft`` of a contiguous tensor along a non-last axis the
    engine takes: its column body, the result in the input's layout,
    against the JAX package's ``fft`` / ``ifft`` (which split 1024 as 2 x
    512)."""
    c = _complex(shape, len(shape) + axis + inverse)
    fn, ref = (hf.ifft, pallas_fft.ifft) if inverse else (hf.fft,
                                                          pallas_fft.fft)
    got = fn(torch.from_numpy(c), axis=axis)
    assert got.shape == shape and got.is_contiguous()
    assert _rel(got.numpy(), np.asarray(ref(c, axis=axis))) <= 5e-4


def test_cdft_cols_on_cpu_is_its_plain_version_and_launches_nothing():
    hf.reset_launches()
    x = torch.from_numpy(_complex((8, 64, 7), 5))
    for axis, inverse in ((0, False), (1, True), (-2, False)):
        y = hf.cdft_cols(x, axis, inverse)
        assert y.is_contiguous()
        assert torch.equal(y, hf.cdft_cols_plain(x, axis % 3, inverse))
    assert hf.cdft_cols(x[:0], 1, False).shape == (0, 64, 7)
    assert all(v == 0 for v in hf.LAUNCHES.values()), hf.LAUNCHES


def test_cdft_cols_checks_its_arguments():
    x = torch.zeros((4, 16, 3), dtype=torch.complex64)
    with pytest.raises(ValueError):
        hf.cdft_cols(x, 2, False)                           # last axis
    with pytest.raises(ValueError):
        hf.cdft_cols(x, -1, False)                          # last axis
    with pytest.raises(TypeError):
        hf.cdft_cols(x.real.contiguous(), 1, False)         # not complex
    with pytest.raises(ValueError):
        hf.cdft_cols(x.transpose(0, 2), 1, False)           # not contiguous
    with pytest.raises(ValueError):
        hf.cdft_cols(torch.zeros((4, 12, 3), dtype=torch.complex64), 1,
                     False)                                 # not 2^k
    with pytest.raises(ValueError):
        hf.cdft_cols(torch.zeros((3, 2048, 2), dtype=torch.complex64), 1,
                     False)                                 # past 1024
    with pytest.raises(ValueError):
        hf.cdft_cols(x.to("meta"), 1, False)                # no kernel


def test_x_body_routing():
    for X in range(1, 1100):
        assert hf._x_body(X) == ("fft" if X in X_POW2 or X in hf.MIXED_LENGTHS
                                 else "dense"), X


@pytest.mark.parametrize("shape", [(8, 8, 8), (12, 16, 15), (16, 10, 12)])
def test_x_c2c_layouts_on_cpu_are_the_plain_version(shape):
    """Every layout pair of kernel 7 is ``x_c2c_plain`` on CPU tensors,
    bit for bit, and launches nothing."""
    hf.reset_launches()
    c = torch.from_numpy(_complex(shape, 9))
    ar, ai = c.real.contiguous(), c.imag.contiguous()
    for inverse in (False, True):
        pr, pi = hf.x_c2c_plain(ar, ai, *hf._planes("dft", shape[0], inverse,
                                                    CPU))
        zr, zi = hf.x_c2c(ar, ai, inverse)
        assert torch.equal(zr, pr) and torch.equal(zi, pi)
        assert torch.equal(hf.x_cols((ar, ai), inverse, complex_out=True),
                           torch.complex(pr, pi))
        zr, zi = hf.x_cols(c, inverse, complex_out=False)
        assert torch.equal(zr, pr) and torch.equal(zi, pi)
    assert all(v == 0 for v in hf.LAUNCHES.values()), hf.LAUNCHES
    with pytest.raises(TypeError):
        hf.x_cols(c.to(torch.complex128), False, complex_out=False)
    with pytest.raises(ValueError):
        hf.x_cols(c.transpose(0, 1), False, complex_out=False)


def _record_launches(monkeypatch):
    """Make the wrappers take their CUDA route on CPU tensors, recording
    each launch as (counter, C entry point, arguments) instead of running
    it."""
    log = []
    monkeypatch.setattr(hf, "_check_rows", lambda *a: False)
    monkeypatch.setattr(hf, "_check", lambda *a, **k: False)
    monkeypatch.setattr(hf, "_check_cols", lambda *a: False)
    monkeypatch.setattr(hf, "_check_short", lambda *a: False)
    monkeypatch.setattr(hf, "_check_tw_cols", lambda *a: False)
    monkeypatch.setattr(hf, "_launch", lambda kernel, fn, *args:
                        log.append((kernel, fn, args)))
    return log


@pytest.mark.parametrize("shape, axis", [((4, 1024, 513), 1),
                                         ((1024, 8, 9), 0),
                                         ((3, 16, 2, 5), 1), ((8, 3), -2)])
@pytest.mark.parametrize("name", ["fft", "ifft"])
def test_strided_axis_reaches_cdft_cols_with_no_copy(monkeypatch, shape, axis,
                                                     name):
    """A contiguous tensor's non-last power-of-two axis up to 1024: one
    ``dfft_cdft_cols`` launch on the caller's own tensor (no axis move, no
    copy) with the (outer, n, inner) of the axis, into a tensor of the
    same shape and layout."""
    log = _record_launches(monkeypatch)
    x = torch.zeros(shape, dtype=torch.complex64)
    y = getattr(hf, name)(x, axis=axis)
    assert y.shape == x.shape and y.is_contiguous()
    ((kernel, fn, args),) = log
    assert (kernel, fn) == ("cmatmul", "dfft_cdft_cols")
    a = axis % len(shape)
    n, inverse = shape[a], name == "ifft"
    assert args[0] is x and args[3] is y
    table, split = hf._cols_tables(n, inverse, CPU)
    assert args[1] is table and args[2] is split
    assert (split is None) == (n < 1024)
    assert args[4:7] == (int(np.prod(shape[:a])), n,
                         int(np.prod(shape[a + 1:])))
    assert args[7:] == (hf.cols_plan(n, inverse).plan.schedule, int(inverse))


# On a CPU tensor ``cdft_tw`` / ``rdft_tw`` take their dense form through
# ``stage`` (``dfft_stage``) whatever the checks say; on the card they
# launch ``dfft_cdft_tw`` / ``dfft_rdft_tw``, which chip_smoke.py checks.
@pytest.mark.parametrize("shape, axis, want", [
    ((2048, 3, 4), 0, [("cmatmul_tw", "dfft_cdft_tw_cols"),
                       ("cmatmul", "dfft_cdft_short")]),     # split 4 x 512
    ((3, 96, 4), 1, [("cmatmul", "dfft_cdft")]),             # mixed radix
    ((3, 136, 4), 1, [("cmatmul", "dfft_stage")]),           # tile body
    ((5, 4, 3), 1, [("cmatmul", "dfft_stage")]),             # row body
    ((3, 521, 2), 1, [("cmatmul", "dfft_stage")]),           # prime
    ((4, 3, 64), 2, [("cmatmul", "dfft_cdft")]),             # last axis
    ((3, 88, 4), 1, [("cmatmul", "dfft_cdft")]),             # radix 11
])
def test_other_axes_keep_their_route(monkeypatch, shape, axis, want):
    """A length the column kernel does not take, or the last axis, keep the
    route they had: no column launch; the axis moves last and runs kernel
    2's row body (the engine's mixed-radix kernel at 96 and 88 = 8 x 11,
    the tile body at 136 = 8 x 17). A split axis (4 x 512) takes the
    four-step where it lies: kernel 4's column body, then the short-stage
    body."""
    log = _record_launches(monkeypatch)
    y = hf.fft(torch.zeros(shape, dtype=torch.complex64), axis=axis)
    assert y.shape == shape
    assert [(k, fn) for k, fn, _ in log] == want


def test_non_contiguous_view_keeps_the_axis_move(monkeypatch):
    """A non-contiguous view (a ring's block) moves the axis last and runs
    the row body, as before."""
    log = _record_launches(monkeypatch)
    block = torch.zeros((4, 64, 10), dtype=torch.complex64)[:, :, 2:7]
    assert not block.is_contiguous()
    hf.ifft(block, axis=1)
    assert [(k, fn) for k, fn, _ in log] == [("cmatmul", "dfft_cdft")]
    assert log[0][2][0] is not block


@pytest.mark.parametrize("shape", [(8, 8, 8), (12, 8, 8), (2, 16, 16),
                                   (512, 16, 32), (480, 8, 16), (64, 12, 10)])
def test_fused_plan_reaches_x_cols_when_x_body_is_fft(monkeypatch, shape):
    """The fused 3D transforms launch kernel 7's column body when
    ``_x_body(X)`` is "fft" (planes in, complex64 out forward; complex64
    in, planes out inverse): ``dfft_x_cols`` for a power of two,
    ``dfft_x_mixed`` (the mixed-radix column kernel) for one of
    ``MIXED_LENGTHS`` (12, 480); else the dense ``dfft_x_c2c``."""
    log = _record_launches(monkeypatch)
    X, Y, Z = shape
    c = hf.rfftn3d_fused(torch.zeros(shape))
    assert c.shape == (X, Y, Z // 2 + 1) and c.dtype == torch.complex64
    fwd = [fn for _, fn, _ in log]
    del log[:]
    hf.irfftn3d_fused(c, shape)
    inv = [fn for _, fn, _ in log]
    x = ("dfft_x_c2c" if hf._x_body(X) == "dense" else
         "dfft_x_mixed" if X in hf.MIXED_LENGTHS else "dfft_x_cols")
    zy = (["dfft_zy_rows", "dfft_zy_cols", "dfft_zy_planes"]
          if hf._zy_engine_body(Y, Z) == "fft" else ["dfft_zy_fwd"])
    yz = (["dfft_yz_scratch", "dfft_yz_cols", "dfft_yz_rows"]
          if hf._zy_engine_body(Y, Z) == "fft" else ["dfft_yz_inv"])
    assert fwd == zy + [x] and inv == [x] + yz


def _entries(log):
    seen = {}
    for kernel, fn, _ in log:
        seen[kernel, fn] = seen.get((kernel, fn), 0) + 1
    return seen


_COLS, _SHORT = ("cmatmul", "dfft_cdft_cols"), ("cmatmul", "dfft_cdft_short")
_TW_COLS = ("cmatmul_tw", "dfft_cdft_tw_cols")


@pytest.mark.parametrize("shape, fwd, inv", [
    # chip_smoke.py's PER_AXIS_PATHS at a depth the CPU holds (the twiddle
    # kernels through dfft_stage on the CPU, see above).
    ((1024, 16, 16), {("rmatmul", "dfft_rdft"): 1, _COLS: 2},
     {_COLS: 2, ("c2r", "dfft_c2r"): 1}),
    ((2048, 8, 2048),
     {("rmatmul_tw", "dfft_stage"): 1, _TW_COLS: 1, _COLS: 1, _SHORT: 2},
     {_TW_COLS: 1, _COLS: 1, _SHORT: 1, ("c2r", "dfft_c2r_packed"): 1}),
])
def test_per_axis_plans_launch_the_column_body(monkeypatch, shape, fwd, inv):
    """The per-axis 3D transforms: z on rows, y and x (where not split) on
    the column body in place; a split x axis's four-step where it lies
    (kernel 4's column body, the short-stage body), a split z axis's
    second stage on the short-stage body writing the crop (forward), and
    its C2R one launch of kernel 3's packed body on rows of 1024 (inverse),
    so the next axis gets a contiguous tensor."""
    log = _record_launches(monkeypatch)
    c = hf.rfftn_3d(torch.zeros(shape))
    assert c.is_contiguous() and c.shape == shape[:2] + (shape[2] // 2 + 1,)
    assert _entries(log) == fwd
    del log[:]
    hf.irfftn_3d(c, shape)
    assert _entries(log) == inv


def test_split_axes_come_back_contiguous_and_match_jax():
    """A split axis's result is written straight into the input's layout:
    the same values the axis move gave, in a contiguous tensor."""
    c = _complex((2048, 3, 2), 21)
    got = hf.ifft(torch.from_numpy(c), axis=0)
    assert got.is_contiguous()
    assert _rel(got.numpy(), np.asarray(pallas_fft.ifft(c, axis=0))) <= 5e-4
    x = np.random.default_rng(22).standard_normal((3, 2, 2048)).astype(
        np.float32)
    half = hf.rfft(torch.from_numpy(x), axis=-1)
    assert half.is_contiguous() and half.shape == (3, 2, 1025)
    assert _rel(half.numpy(), np.asarray(pallas_fft.rfft(x, axis=-1))) <= 5e-4
