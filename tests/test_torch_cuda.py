"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test skips without a CUDA device. On a GPU machine
(which need not have JAX) run them without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Shapes cover the ragged edges of each kernel's tiling: odd and tiny axes,
axes that are not a multiple of any tile, the 512 limit of the fused path,
and the per-axis path's four-step sizes and 1024-point prime limit. Tolerance:
rel <= 5e-4, the JAX package's per-stage bound; kernel and plain version
both compute in float32, with sums taken in another order.
"""

import time

import numpy as np
import pytest
import torch

import distributedfft_tpu_torch as dft
from distributedfft_tpu_torch.ops import hopper_fft as hf

pytestmark = pytest.mark.cuda

POW2 = [8, 16, 32, 64, 128, 256, 512, 1024]
SHAPES = [(2, 2, 2), (8, 8, 8), (6, 12, 15), (16, 10, 12), (3, 17, 33),
          (65, 129, 66), (7, 512, 512), (512, 9, 511)]
# Kernel 6's FFT body (hf._zy_body: Y and Z powers of two in [8, 512]):
# every engine geometry of both passes, batches that straddle x-planes
# (small Y or Z), and a last batch that is partial.
ZY_FFT_SHAPES = [(2, 8, 8), (3, 8, 16), (5, 16, 8), (2, 32, 64),
                 (3, 64, 32), (9, 128, 16), (2, 16, 256), (4, 256, 128),
                 (3, 512, 8), (2, 8, 512), (5, 512, 512), (512, 16, 32)]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _randn(shape, seed, device):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(device)


def _crandn(shape, seed, device):
    return torch.complex(_randn(shape, seed, device),
                         _randn(shape, seed + 1, device))


@pytest.mark.parametrize("shape", SHAPES + ZY_FFT_SHAPES)
def test_zy_fwd_kernel(cuda, shape):
    """Both bodies of kernel 6: three launches on the FFT body, one dense."""
    x = _randn(shape, 1, cuda)
    X, Y, Z = shape
    before = hf.LAUNCHES["zy_fwd"]
    yr, yi = hf.zy_fwd(x)
    torch.cuda.synchronize()
    assert hf.LAUNCHES["zy_fwd"] == before + (
        3 if hf._zy_body(Y, Z) == "fft" else 1)
    pr, pi = hf.zy_fwd_plain(x, *hf._planes("rdft", Z, False, cuda),
                             *hf._planes("dft", Y, False, cuda))
    assert _rel(yr, pr) <= 5e-4 and _rel(yi, pi) <= 5e-4


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_x_c2c_kernel(cuda, shape, inverse):
    X, Y, Z = shape
    ar, ai = _randn(shape, 2, cuda), _randn(shape, 3, cuda)
    zr, zi = hf.x_c2c(ar, ai, inverse)
    torch.cuda.synchronize()
    pr, pi = hf.x_c2c_plain(ar, ai, *hf._planes("dft", X, inverse, cuda))
    assert _rel(zr, pr) <= 5e-4 and _rel(zi, pi) <= 5e-4


# Kernel 7's column body (hf._x_body: X a power of two in [8, 512]): every
# X, one column group or many, a ragged last group (Ky * Zo not a multiple
# of the batch width), plane rows whose 4 Ky Zo bytes are not a multiple of
# 16 (8-byte or 4-byte parts).
X_FFT_SHAPES = [(8, 8, 8), (16, 3, 5), (32, 17, 33), (64, 9, 7),
                (128, 10, 12), (256, 6, 11), (512, 16, 9), (512, 512, 257),
                (8, 101, 13), (64, 2, 3)]


@pytest.mark.parametrize("layout", ["planes", "to_complex", "from_complex"])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shape", X_FFT_SHAPES + [(12, 16, 15), (480, 4, 9)])
def test_x_c2c_layouts(cuda, shape, inverse, layout):
    """Every layout pair of kernel 7 against ``x_c2c_plain``: planes to
    planes (``x_c2c``), planes to complex64 (the fused forward), complex64
    to planes (the fused inverse); one launch, on the body of
    ``_x_body(X)``."""
    X = shape[0]
    ar, ai = _randn(shape, 41, cuda), _randn(shape, 42, cuda)
    pr, pi = hf.x_c2c_plain(ar, ai, *hf._planes("dft", X, inverse, cuda))
    before = hf.LAUNCHES["x_c2c"]
    if layout == "planes":
        zr, zi = hf.x_c2c(ar, ai, inverse)
    elif layout == "to_complex":
        z = hf.x_cols((ar, ai), inverse, complex_out=True)
        assert z.dtype == torch.complex64 and z.is_contiguous()
        zr, zi = z.real, z.imag
    else:
        zr, zi = hf.x_cols(torch.complex(ar, ai), inverse, complex_out=False)
    torch.cuda.synchronize()
    assert hf.LAUNCHES["x_c2c"] == before + 1
    assert zr.shape == shape
    assert _rel(zr, pr) <= 5e-4 and _rel(zi, pi) <= 5e-4


# Kernel 2's column body (``cdft_cols``): every n, one batch, an odd inner
# extent (the 1024^3 y axis: rows of 513 elements, every other one 8 bytes
# off a 16-byte boundary, a one-column last group), more batches than one
# wave of the persistent grid, and the x axis shape (outer 1).
COLS_SHAPES = ([(1, n, 1) for n in POW2] + [(3, n, 513) for n in POW2]
               + [(300, n, 8) for n in POW2]
               + [(1, 1024, 4104), (2, 512, 33), (5, 64, 1000)])


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shape", COLS_SHAPES)
def test_cdft_cols_kernel(cuda, shape, inverse):
    x = _crandn(shape, 43, cuda)
    before = hf.LAUNCHES["cmatmul"]
    y = hf.cdft_cols(x, 1, inverse)
    torch.cuda.synchronize()
    assert hf.LAUNCHES["cmatmul"] == before + 1
    assert y.shape == shape and y.is_contiguous()
    assert _rel(y, hf.cdft_cols_plain(x, 1, inverse)) <= 5e-4


def test_cdft_cols_takes_an_8_byte_aligned_view(cuda):
    """The column loads and stores take 8-byte parts where a tensor starts
    8 bytes off a 16-byte boundary (no 16-byte alignment needed)."""
    raw = _crandn((3 * 64 * 7 + 1,), 44, cuda)
    x = raw[1:].view(3, 64, 7)
    assert x.data_ptr() % 16 == 8
    y = hf.cdft_cols(x, 1, False)
    torch.cuda.synchronize()
    assert _rel(y, hf.cdft_cols_plain(x, 1, False)) <= 5e-4


# Kernel 2's short-stage body (``cdft_short``): n1 from 2 to 16 (dense and
# radix-2 DFTs); inner below a batch's width (several outer indices a
# batch, an odd strip), above it with a ragged last group, and many
# batches; an odd outer count; each output geometry.
SHORT_N1 = [2, 3, 4, 5, 6, 7, 8, 12, 13, 16]
SHORT_INNER = [3, 512, 2733]


def _short_geometry(kind, outer, n1, inner):
    """(input shape, geometry, output shape) of one caller's layout."""
    if kind == "natural":
        return ((outer, n1, inner), hf.short_last(n1, inner),
                (outer, n1 * inner))
    if kind == "crop":
        n_out = n1 * inner // 2 + 1
        return ((outer, n1, inner), hf.short_last(n1, inner, n_out),
                (outer, n_out))
    n2 = 8                                   # a non-last split axis
    return ((outer * n2, n1, inner), hf.short_strided(n1, n2, inner),
            (outer, n1 * n2, inner))


@pytest.mark.parametrize("kind", ["natural", "crop", "strided"])
@pytest.mark.parametrize("inner", SHORT_INNER)
@pytest.mark.parametrize("n1", SHORT_N1)
def test_cdft_short_kernel(cuda, n1, inner, kind):
    shape, geom, out_shape = _short_geometry(kind, 5, n1, inner)
    inverse = bool(n1 % 2)
    x = _crandn(shape, 45, cuda)
    before = hf.LAUNCHES["cmatmul"]
    y = hf.cdft_short(x, inverse, geom, out_shape)
    torch.cuda.synchronize()
    assert hf.LAUNCHES["cmatmul"] == before + 1
    assert y.shape == out_shape and y.dtype == torch.complex64
    assert _rel(y, hf.cdft_short_plain(x, inverse, geom, out_shape)) <= 5e-4


@pytest.mark.parametrize("shape", [(1001, 4, 512), (3, 16, 70001),
                                   (4099, 3, 1)])
def test_cdft_short_kernel_many_batches(cuda, shape):
    """More batches than one wave of the persistent grid."""
    outer, n1, inner = shape
    geom = hf.short_last(n1, inner)
    x = _crandn(shape, 46, cuda)
    y = hf.cdft_short(x, False, geom, (outer, n1 * inner))
    torch.cuda.synchronize()
    ref = hf.cdft_short_plain(x, False, geom, (outer, n1 * inner))
    assert _rel(y, ref) <= 5e-4


# Kernel 4's column body (``cdft_tw_cols``): every n2 up to 512, n1 = 3, 4
# and 16, a span of one column, an odd span and one past a batch.
@pytest.mark.parametrize("span", [1, 7, 33])
@pytest.mark.parametrize("n1", [3, 4, 16])
@pytest.mark.parametrize("n2", [n for n in POW2 if n <= 512])
def test_cdft_tw_cols_kernel(cuda, n2, n1, span):
    outer = 3
    inverse = bool(span % 2)
    x = _crandn((outer, n2, n1 * span), 47, cuda)
    before = hf.LAUNCHES["cmatmul_tw"]
    y = hf.cdft_tw_cols(x, n1, inverse)
    torch.cuda.synchronize()
    assert hf.LAUNCHES["cmatmul_tw"] == before + 1
    assert y.shape == x.shape and y.is_contiguous()
    assert _rel(y, hf.cdft_tw_cols_plain(x, n1, inverse)) <= 5e-4


@pytest.mark.parametrize("shape, axis", [((2048, 3, 5), 0), ((2, 1536, 7), 1),
                                         ((8192, 9), 0), ((3, 4096, 2, 3), 1),
                                         ((6144, 1, 4), 0)])
@pytest.mark.parametrize("inverse", [False, True])
def test_split_axis_in_place_matches_torch_fft(cuda, shape, axis, inverse):
    """A non-last split axis: kernel 4's column body, then the short-stage
    body writing the input's layout, one launch each."""
    x = _crandn(shape, 48, cuda)
    assert hf._split_in_place(x, axis)
    before = dict(hf.LAUNCHES)
    y = (hf.ifft if inverse else hf.fft)(x, axis=axis)
    torch.cuda.synchronize()
    assert hf.LAUNCHES["cmatmul_tw"] == before["cmatmul_tw"] + 1
    assert hf.LAUNCHES["cmatmul"] == before["cmatmul"] + 1
    assert y.shape == shape and y.is_contiguous()
    ref = (torch.fft.ifft(x, dim=axis, norm="forward") if inverse
           else torch.fft.fft(x, dim=axis))
    assert _rel(y, ref) <= 5e-4


def test_split_bodies_reject_misaligned_pointers(cuda):
    """Both entries refuse an operand that is not 8-byte aligned (a float
    off a complex64 boundary) before launching: the wrapper raises and
    counts nothing."""
    x = _crandn((4, 4, 64), 49, cuda)
    y = torch.empty_like(x)
    before = dict(hf.LAUNCHES)
    with pytest.raises(RuntimeError, match="misaligned"):
        hf._launch("cmatmul", "dfft_cdft_short", x.data_ptr() + 4,
                   hf._short_roots(4, False, cuda), y, 4, 4, 64, 1, 0,
                   256, 0, 64, 256)
    with pytest.raises(RuntimeError, match="misaligned"):
        hf._launch("cmatmul_tw", "dfft_cdft_tw_cols", x,
                   hf._fft_table(8, False, cuda),
                   *hf._twiddle_planes(4, 8, False, cuda), y.data_ptr() + 4,
                   4, 8, 32, 4, hf.fft_plan(8, False).schedule, 0)
    assert hf.LAUNCHES == before
    with pytest.raises(ValueError):
        hf.cdft_short(x, False, hf.short_last(4, 64), (4, 255))  # too small
    with pytest.raises(ValueError):
        hf.cdft_tw_cols(x.reshape(4, 8, 32), 3, False)          # 3 !| 32
    with pytest.raises(ValueError):
        hf.cdft_tw_cols(x.reshape(1, 1024, 1), 1, False)        # n2 > 512


@pytest.mark.parametrize("shape", SHAPES + ZY_FFT_SHAPES)
def test_yz_inv_kernel(cuda, shape):
    """Both bodies of kernel 8 (``hf._zy_body``): three launches on the FFT
    body, one dense; random spectra, so the DC and Nyquist z-bins have
    imaginary parts that both ignore."""
    X, Y, Z = shape
    half = (X, Y, Z // 2 + 1)
    er, ei = _randn(half, 4, cuda), _randn(half, 5, cuda)
    before = hf.LAUNCHES["yz_inv"]
    y = hf.yz_inv(er, ei, Z)
    torch.cuda.synchronize()
    assert hf.LAUNCHES["yz_inv"] == before + (
        3 if hf._zy_body(Y, Z) == "fft" else 1)
    assert y.shape == shape and y.dtype == torch.float32
    ref = hf.yz_inv_plain(er, ei, *hf._planes("dft", Y, True, cuda),
                          *hf._planes("c2r", Z, False, cuda))
    assert _rel(y, ref) <= 5e-4


@pytest.mark.parametrize("shape", SHAPES)
def test_pallas_plan_matches_torch_fft(cuda, shape):
    x = _randn(shape, 6, cuda)
    plan = dft.SlabFFTPlan(dft.GlobalSize(*shape), dft.SlabPartition(1),
                           dft.Config(fft_backend="pallas"))
    hf.reset_launches()
    c = plan.exec_r2c(x)
    back = plan.exec_c2r(c)
    torch.cuda.synchronize()
    zy = 3 if hf._zy_body(*shape[1:]) == "fft" else 1
    assert hf.LAUNCHES == {**dict.fromkeys(hf.LAUNCHES, 0),
                           "zy_fwd": zy, "x_c2c": 2, "yz_inv": zy}
    assert _rel(c, torch.fft.rfftn(x)) <= 5e-4
    assert _rel(back / float(np.prod(shape)), x) <= 5e-4


# Per-axis kernels 1-5 (csrc/stage.cu): (rows M, points n), from one row
# to more than a grid row of tiles, every n from the row path (n <= 16) to
# ragged tiles (13, 257, 521) and the 1024-point direct prime limit.
ROWS = [(1, 1), (3, 2), (7, 8), (65, 13), (129, 16), (300, 96), (70, 257),
        (4099, 512), (33, 521), (5, 1021)]




@pytest.mark.parametrize("M, n", ROWS)
def test_cmatmul_and_rmatmul_kernels(cuda, M, n):
    x = _crandn((M, n), 7, cuda)
    F = hf._planes("dft", n, True, cuda)
    before = dict(hf.LAUNCHES)
    y = hf.stage(x, *F)
    xr = _randn((M, n), 9, cuda)
    Fr = hf._planes("rdft", n, False, cuda)
    yr = hf.stage(xr, *Fr)
    torch.cuda.synchronize()
    assert hf.LAUNCHES["cmatmul"] == before["cmatmul"] + 1
    assert hf.LAUNCHES["rmatmul"] == before["rmatmul"] + 1
    assert _rel(y, hf.stage_plain(x, *F)) <= 5e-4
    assert _rel(yr, hf.stage_plain(xr, *Fr)) <= 5e-4


@pytest.mark.parametrize("M, n", [r for r in ROWS if r[1] >= 2])
def test_c2r_kernel(cuda, M, n):
    c = _crandn((M, n // 2 + 1), 11, cuda)
    C = hf._planes("c2r", n, False, cuda)
    y = hf.c2r(c, *C)
    torch.cuda.synchronize()
    assert tuple(y.shape) == (M, n)
    assert _rel(y, hf.c2r_plain(c, *C)) <= 5e-4


# Kernel 5's two bodies (hf._fft_body): the row FFT engine for a
# power-of-two n2 in [8, 1024] (M = 1, odd M, and M above one persistent
# wave of the grid), else the tile loop (320, 206, 171).
TWIDDLE_ROWS = [(2, 512, 3), (2, 320, 33), (5, 206, 7), (4, 512, 2),
                (8, 16, 5), (3, 171, 9), (1, 1024, 1), (3, 64, 5),
                (2, 512, 2000), (2, 8, 110001), (4, 32, 33), (2, 128, 17),
                (8, 256, 3)]


@pytest.mark.parametrize("n1, n2, lines", TWIDDLE_ROWS)
@pytest.mark.parametrize("real", [False, True])
def test_twiddle_kernels(cuda, n1, n2, lines, real):
    """Kernels 4 and 5: rows cycle through n1 (M = lines * n1). Kernel 5
    takes no F: ``rdft_tw`` picks its body by n2."""
    M = lines * n1
    x = _randn((M, n2), 13, cuda) if real else _crandn((M, n2), 13, cuda)
    F = hf._planes("dft", n2, not real, cuda)
    tw = (n1, n2, not real)
    name = "rmatmul_tw" if real else "cmatmul_tw"
    before = hf.LAUNCHES[name]
    y = hf.rdft_tw(x, n1) if real else hf.stage(x, *F, tw)
    torch.cuda.synchronize()
    assert hf.LAUNCHES[name] == before + 1
    ref = hf.stage_plain(x, *F, *hf._twiddle_planes(*tw, cuda))
    assert _rel(y, ref) <= 5e-4


@pytest.mark.parametrize("n1, n2, lines", TWIDDLE_ROWS)
@pytest.mark.parametrize("inverse", [False, True])
def test_cdft_tw_kernel(cuda, n1, n2, lines, inverse):
    """Kernel 4 through ``cdft_tw``, both bodies (``_fft_body(n2)``), both
    directions: rows cycle through n1 (M = lines * n1)."""
    M = lines * n1
    x = _crandn((M, n2), 27, cuda)
    before = hf.LAUNCHES["cmatmul_tw"]
    y = hf.cdft_tw(x, n1, inverse)
    torch.cuda.synchronize()
    assert hf.LAUNCHES["cmatmul_tw"] == before + 1
    tw = (n1, n2, inverse)
    ref = hf.stage_plain(x, *hf._planes("dft", n2, inverse, cuda),
                         *hf._twiddle_planes(*tw, cuda))
    assert _rel(y, ref) <= 5e-4


# Kernels 1 and 2's FFT bodies (``rdft`` / ``cdft``, hf._fft_body): every
# power of two in [8, 1024] at one row, an odd count and a count above one
# persistent wave of the grid.
DIRECT_ROWS = [(M, n) for n in POW2 for M in (1, 7, (1 << 21) // n + 2)]


@pytest.mark.parametrize("M, n", DIRECT_ROWS)
@pytest.mark.parametrize("inverse", [False, True])
def test_cdft_kernel(cuda, M, n, inverse):
    """Kernel 2 on its FFT body (one ``dfft_cdft`` launch)."""
    x = _crandn((M, n), 29, cuda)
    before = hf.LAUNCHES["cmatmul"]
    y = hf.cdft(x, inverse)
    torch.cuda.synchronize()
    assert hf.LAUNCHES["cmatmul"] == before + 1
    assert y.shape == (M, n) and y.dtype == torch.complex64
    assert _rel(y, hf.stage_plain(x, *hf._planes("dft", n, inverse,
                                                 cuda))) <= 5e-4


@pytest.mark.parametrize("M, n", DIRECT_ROWS)
def test_rdft_kernel(cuda, M, n):
    """Kernel 1 on its FFT body (one ``dfft_rdft`` launch): (M, n) real
    rows to (M, n/2 + 1) bins, an odd last row paired with zeros."""
    x = _randn((M, n), 31, cuda)
    before = hf.LAUNCHES["rmatmul"]
    y = hf.rdft(x)
    torch.cuda.synchronize()
    assert hf.LAUNCHES["rmatmul"] == before + 1
    assert y.shape == (M, n // 2 + 1) and y.dtype == torch.complex64
    assert _rel(y, hf.stage_plain(x, *hf._planes("rdft", n, False,
                                                 cuda))) <= 5e-4


@pytest.mark.parametrize("M, n", DIRECT_ROWS)
def test_irdft_kernel(cuda, M, n):
    """Kernel 3 on its FFT body (one ``dfft_c2r`` launch): (M, n/2 + 1)
    random half spectra (imaginary DC and Nyquist bins, which the C2R
    ignores) to (M, n) real rows, an odd last row paired with zeros."""
    c = _crandn((M, n // 2 + 1), 33, cuda)
    before = hf.LAUNCHES["c2r"]
    y = hf.irdft(c, n)
    torch.cuda.synchronize()
    assert hf.LAUNCHES["c2r"] == before + 1
    assert y.shape == (M, n) and y.dtype == torch.float32
    assert _rel(y, hf.c2r_plain(c, *hf._planes("c2r", n, False,
                                               cuda))) <= 5e-4


@pytest.mark.parametrize("shape", [(4, 6, 1024), (3, 640, 10), (1024, 2, 3),
                                   (5, 8, 1042), (8, 1, 8), (2, 8, 2048),
                                   (2048, 3, 4), (3, 1024, 2048),
                                   (1024, 5, 1024)])
def test_per_axis_plan_matches_torch_fft(cuda, shape):
    x = _randn(shape, 15, cuda)
    plan = dft.SlabFFTPlan(dft.GlobalSize(*shape), dft.SlabPartition(1),
                           dft.Config(fft_backend="pallas"))
    hf.reset_launches()
    c = plan.exec_r2c(x)
    back = plan.exec_c2r(c)
    torch.cuda.synchronize()
    assert hf.LAUNCHES["zy_fwd"] == hf.LAUNCHES["yz_inv"] == 0
    tol = 2e-3 if 1042 in shape else 5e-4
    assert _rel(c, torch.fft.rfftn(x)) <= tol
    assert _rel(back / float(np.prod(shape)), x) <= tol


# Fused-wire kernels 9-11 (csrc/wire.cu).


def _with_edges(x):
    """Plant NaN, +-Inf, a bf16 rounding tie and a subnormal in x."""
    flat = torch.view_as_real(x).reshape(-1)
    edges = torch.tensor([float("nan"), float("inf"), -float("inf"),
                          1 + 2 ** -8, -(1 + 3 * 2 ** -9), 1e-40],
                         device=x.device)
    k = min(edges.numel(), flat.numel())
    flat[:k] = edges[:k]
    return x


@pytest.mark.parametrize("shape, axis, chunk", [
    ((1, 1, 1), None, None), ((3, 17, 33), None, None),
    ((4, 12, 513), 1, (6, 3)), ((8, 5, 7), 0, (4, 2)), ((2, 9, 11), 2, (3, 5)),
    ((6, 40), None, None)])
def test_enc_pack_kernel_bit_equal(cuda, shape, axis, chunk):
    """Kernel 9 against Tensor.to(torch.bfloat16) bit for bit, NaN and Inf
    included, on a contiguous block or a strided chunk of one."""
    x = _with_edges(_crandn(shape, 17, cuda))
    if axis is not None:
        x = x.narrow(axis, *chunk)
    before = hf.LAUNCHES["enc_pack"]
    got = hf.enc_pack(x)
    torch.cuda.synchronize()
    assert hf.LAUNCHES["enc_pack"] == before + 1
    want = hf.enc_pack_plain(x)
    assert got.shape == want.shape and got.is_contiguous()
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("shape", [(1,), (3, 17, 33), (256, 513), (5, 7, 9)])
def test_dec_unpack_kernel_bit_equal(cuda, shape):
    bits = torch.from_numpy(np.random.default_rng(19).integers(
        -2 ** 15, 2 ** 15, size=(2,) + shape, dtype=np.int16)).to(cuda)
    y = bits.view(torch.bfloat16)
    before = hf.LAUNCHES["dec_unpack"]
    got = hf.dec_unpack(y)
    torch.cuda.synchronize()
    assert hf.LAUNCHES["dec_unpack"] == before + 1
    want = hf.dec_unpack_plain(y)
    assert got.dtype == torch.complex64 and got.shape == want.shape
    assert torch.equal(torch.view_as_real(got).view(torch.int32),
                       torch.view_as_real(want).view(torch.int32))


# Kernel 11's FFT body (powers of two in [8, 1024]: M = 1, odd M, and M
# above one persistent wave of the grid) beside the tile body of ROWS.
FFT_ROWS = [(1, 1024), (1, 8), (33, 32), (257, 64), (3, 128), (1000, 256),
            (40001, 1024), (200001, 8), (5, 16), (99, 512)]


@pytest.mark.parametrize("M, n", ROWS + FFT_ROWS)
@pytest.mark.parametrize("inverse", [False, True])
def test_dec_cmatmul_kernel(cuda, M, n, inverse):
    y = hf.enc_pack_plain(_crandn((M, n), 21, cuda))
    F = hf._planes("dft", n, inverse, cuda)
    before = hf.LAUNCHES["dec_cmatmul"]
    got = hf.dec_cmatmul(y, inverse)
    torch.cuda.synchronize()
    assert hf.LAUNCHES["dec_cmatmul"] == before + 1
    assert _rel(got, hf.dec_cmatmul_plain(y, *F)) <= 5e-4


def test_fft_body_rejects_misaligned_views(cuda):
    """The FFT body's bulk copies need 16-byte aligned rows: a contiguous
    view that starts one element in raises instead of launching."""
    M, n = 4, 64
    raw = torch.zeros(2 * M * n + 1, dtype=torch.bfloat16, device=cuda)
    before = dict(hf.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte aligned"):
        hf.dec_cmatmul(raw[1:].view(2, M, n), False)
    real = torch.zeros(M * n + 1, device=cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        hf.rdft_tw(real[1:].view(M, n), 2)
    cplx = torch.zeros(M * n + 1, dtype=torch.complex64, device=cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        hf.cdft_tw(cplx[1:].view(M, n), 2, True)
    with pytest.raises(ValueError, match="16-byte aligned"):
        hf.zy_fwd(real[1:].view(M, 8, 8))
    with pytest.raises(ValueError, match="16-byte aligned"):
        hf.cdft(cplx[1:].view(M, n), False)
    with pytest.raises(ValueError, match="16-byte aligned"):
        hf.rdft(real[1:].view(M, n))
    half = torch.zeros(M * (n // 2 + 1) + 1, dtype=torch.complex64,
                       device=cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        hf.irdft(half[1:].view(M, n // 2 + 1), n)
    assert hf.LAUNCHES == before


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_decode_fft_fused_matches_torch_fft(cuda, axis):
    x = _crandn((6, 20, 33), 23, cuda)
    y = hf.enc_pack_plain(x)
    got = hf.decode_fft_fused(y, torch.complex64, axis, inverse=True,
                              norm=dft.FFTNorm.BACKWARD)
    want = torch.fft.ifft(hf.dec_unpack_plain(y), dim=axis)
    assert _rel(got, want) <= 5e-4


def test_wire_kernels_reject_bad_operands(cuda):
    y = hf.enc_pack_plain(_crandn((4, 8), 25, cuda))
    with pytest.raises(TypeError):
        hf.enc_pack(_randn((4, 8), 1, cuda))                 # not complex
    with pytest.raises(TypeError):
        hf.dec_unpack(y.float())
    with pytest.raises(ValueError):
        hf.dec_unpack(y[:1])                                 # not 2 planes
    with pytest.raises(ValueError):
        hf.dec_cmatmul(y[0], False)                          # not 2 planes
    with pytest.raises(ValueError):
        hf.dec_cmatmul(y.reshape(2, 32), False)              # not (2, M, n)
    with pytest.raises(ValueError):
        hf.dec_cmatmul(y.transpose(1, 2), False)             # not contiguous


def test_failed_build_raises(cuda, tmp_path, monkeypatch):
    from distributedfft_tpu_torch.ops import _build
    (tmp_path / "broken.cu").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="build failed"):
        _build.build(["broken"])


# ---------------------------------------------------------------------------
# The executables and the phase Timer on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t", [3, 4])
def test_slab_executable_on_the_card(cuda, tmp_path, t, capsys):
    """``dfft-slab`` at 64^3 under "pallas": the fused path's kernels
    launch and the result is within 5e-4 of its reference magnitude."""
    from distributedfft_tpu_torch.cli import slab
    from distributedfft_tpu_torch.utils.timer import read_timer_csv
    hf.reset_launches()
    rc = slab.main(["-nx", "64", "-ny", "64", "-nz", "64", "-t", str(t),
                    "-i", "2", "-w", "1", "--fft-backend", "pallas",
                    "-b", str(tmp_path)])
    assert rc == 0
    # 3 iterations, each a staged and a fused roundtrip: kernels 6 and 8
    # three passes each, kernel 7 once a direction.
    assert hf.LAUNCHES["zy_fwd"] == 18 and hf.LAUNCHES["yz_inv"] == 18
    assert hf.LAUNCHES["x_c2c"] == 12
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines()
                if ln.startswith("Result (max): "))
    err = float(line.split()[-1])
    scale = 64.0 ** 3 if t == 3 else 3 * 64.0 ** 1.5
    assert err / scale <= 5e-4
    (csv,) = tmp_path.rglob("*.csv")
    assert csv.name == "test_0_0_0_64_64_64_1_1.csv"
    assert len(read_timer_csv(str(csv))) == 2


def test_timer_fences_the_card(cuda, monkeypatch):
    """A mark waits for the queued work: it is at least the device time of
    the work, and each mark synchronizes the timer's device once."""
    from distributedfft_tpu_torch.utils.timer import Timer
    a = torch.randn(4096, 4096, device=cuda)
    t = Timer(["mm"], 1, None, device=cuda)
    t.start()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        a = a @ a / 64.0
    end.record()
    ms = t.stop_store("mm")
    assert ms >= start.elapsed_time(end) * 0.95
    calls = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: (calls.append(d), real(d)))
    t.start()
    t.stop_store("mm")
    assert calls == [cuda, cuda]


def test_timer_gathers_device_tensors_under_nccl(cuda, tmp_path):
    """Under NCCL the all-gather's tensor lives on the card (NCCL refuses a
    CPU tensor); a one-rank world writes its own column."""
    import torch.distributed as dist
    from distributedfft_tpu_torch.parallel import multihost
    from distributedfft_tpu_torch.utils import timer
    dist.init_process_group("nccl", init_method=
                            f"tcp://{multihost.local_coordinator()}",
                            world_size=1, rank=0)
    try:
        with pytest.raises(Exception):
            dist.all_gather([torch.empty(2)], torch.ones(2))
        assert timer._all_gather_rows([1.5, 2.0], cuda) == [[1.5, 2.0]]
        t = timer.Timer(["a", "Run complete"], 1, str(tmp_path / "t.csv"),
                        num_processes=1, device=cuda)
        t._durations = {"a": 0.25, "Run complete": 3.0}
        assert t._rank_columns() == [[0.25], [3.0]]
    finally:
        dist.destroy_process_group()


# The matmul backend (ops/mxu_fft.py) on the card: float64 and a long prime
# under "pallas", the "matmul" backends' precisions, the TF32 guard.


def _matmul_case(fn, n, dtype, device, seed):
    x = _crandn((64, n), seed, device) if fn != "rfft" else \
        _randn((64, n), seed, device)
    if fn == "irfft":
        x = x[:, :n // 2 + 1]
    x = x.to(torch.complex128 if dtype == "f64" else torch.complex64) \
        if x.is_complex() else x.to(torch.float64 if dtype == "f64"
                                    else torch.float32)
    kw = {"n": n} if fn == "irfft" else {}
    lib = {"fft": lambda: torch.fft.fft(x),
           "ifft": lambda: torch.fft.ifft(x, norm="forward"),
           "rfft": lambda: torch.fft.rfft(x),
           "irfft": lambda: torch.fft.irfft(x, n=n, norm="forward")}[fn]
    return x, kw, lib


@pytest.mark.parametrize("fn", ["fft", "ifft", "rfft", "irfft"])
@pytest.mark.parametrize("n", [12, 640, 1024, 2048])
def test_pallas_double_precision_on_the_matmul_backend(cuda, fn, n):
    """f64 under "pallas": one matmul dispatch, no kernel, within 1e-11 of
    torch.fft in float64."""
    x, kw, lib = _matmul_case(fn, n, "f64", cuda, 60)
    hf.reset_launches()
    got = getattr(hf, fn)(x, axis=-1, **kw)
    torch.cuda.synchronize()
    assert hf.DISPATCHES == {"matmul": 1} and not any(hf.LAUNCHES.values())
    assert got.dtype == lib().dtype and _rel(got, lib()) <= 1e-11


@pytest.mark.parametrize("fn", ["fft", "ifft", "rfft", "irfft"])
def test_pallas_long_prime_on_the_matmul_backend(cuda, fn):
    x, kw, lib = _matmul_case(fn, 1031, "f32", cuda, 61)
    hf.reset_launches()
    got = getattr(hf, fn)(x, axis=-1, **kw)
    torch.cuda.synchronize()
    assert hf.DISPATCHES == {"matmul": 1} and not any(hf.LAUNCHES.values())
    assert _rel(got, lib()) <= 5e-4


@pytest.mark.parametrize("prec, tol", [("highest", 5e-4), ("high", 5e-4),
                                       ("default", 2 ** -7)])
@pytest.mark.parametrize("fn", ["fft", "rfft", "irfft"])
@pytest.mark.parametrize("n", [96, 512, 1024])
def test_matmul_backend_precisions(cuda, fn, n, prec, tol):
    """float32 at each precision against torch.fft (normal data: one
    bfloat16 pass within 2^-7)."""
    from distributedfft_tpu_torch.ops import fft as lf
    from distributedfft_tpu_torch.ops import mxu_fft as mx
    x, kw, lib = _matmul_case(fn, n, "f32", cuda, 62)
    got = getattr(lf, fn)(x, axis=-1, backend="matmul",
                          settings=mx.MXUSettings.make(prec), **kw)
    assert got.dtype == lib().dtype and _rel(got, lib()) <= tol
    if prec != "highest":
        assert mx.MM16_ROUTE["route"] is not None


@pytest.mark.parametrize("backend", ["matmul", "matmul-r2"])
@pytest.mark.parametrize("shape", [(16, 16, 16), (7, 11, 13), (160, 8, 6)])
def test_matmul_plan_matches_torch_fft(cuda, backend, shape):
    x = _randn(shape, 63, cuda)
    for double, tol in ((False, 5e-4), (True, 1e-10)):
        xt = x.double() if double else x
        plan = dft.SlabFFTPlan(dft.GlobalSize(*shape), dft.SlabPartition(1),
                               dft.Config(fft_backend=backend,
                                          double_prec=double))
        hf.reset_launches()
        c = plan.exec_r2c(xt)
        back = plan.exec_c2r(c)
        torch.cuda.synchronize()
        assert hf.DISPATCHES == {"matmul": 6} and not any(hf.LAUNCHES.values())
        assert _rel(c, torch.fft.rfftn(xt)) <= tol
        assert _rel(back / float(np.prod(shape)), xt) <= tol


def test_highest_refuses_tf32(cuda):
    """HIGHEST in float32 needs IEEE products: with TF32 on it raises and
    names the flag; the other precisions and float64 still run."""
    from distributedfft_tpu_torch.ops import mxu_fft as mx
    x = _crandn((8, 64), 64, cuda)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with mx.use_settings(mx.MXUSettings.make("highest")):
            with pytest.raises(RuntimeError, match="allow_tf32"):
                mx.fft(x, axis=-1)
        mx.fft(x, axis=-1)
        mx.fft(x.to(torch.complex128), axis=-1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


# The exchange renderings on the card: two gloo ranks sharing it, "pallas"
# float32, each rendering bit for bit its monolithic (or SYNC) plan.

_RENDER_N = 32
_RENDERINGS = {"a2a": {}, "a2a_wire16": {"wire_dtype": "bf16"},
               "opt1": {"opt": 1},
               "pipe_d2": {"overlap_subblocks": 2},
               "pipe_d3": {"overlap_subblocks": 3, "overlap_depth": 3},
               "pipe_d2_wire16": {"overlap_subblocks": 2,
                                  "wire_dtype": "bf16"},
               "streams_a2a": {"send_method": "Streams"},
               "streams_p2p": {"send_method": "Streams",
                               "comm_method": "Peer2Peer"}}
_SAME = {"opt1": "a2a", "pipe_d2": "a2a", "pipe_d3": "a2a",
         "pipe_d2_wire16": "a2a_wire16", "streams_a2a": "a2a",
         "streams_p2p": "a2a"}


def _render_rank(rank, addr, outdir):
    import os
    from distributedfft_tpu_torch.parallel import multihost
    torch.cuda.set_device(0)
    multihost.maybe_initialize(addr, 2, rank, backend="gloo", timeout_s=120)
    n = _RENDER_N
    x = torch.randn((n, n, n), generator=torch.Generator("cuda")
                    .manual_seed(65), device="cuda")
    out = {}
    for rid, fields in _RENDERINGS.items():
        kw = dict(fields, fft_backend="pallas")
        for k, enum in (("send_method", dft.SendMethod),
                        ("comm_method", dft.CommMethod)):
            if k in kw:
                kw[k] = enum(kw[k])
        plan = dft.SlabFFTPlan(dft.GlobalSize(n, n, n), dft.SlabPartition(2),
                               dft.Config(**kw))
        c = plan.exec_r2c(plan.pad_input(x))
        out[rid] = (c.cpu(), plan.exec_c2r(c).cpu())
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))
    multihost.shutdown()


def test_renderings_bit_equal_over_two_ranks(cuda, tmp_path):
    from distributedfft_tpu_torch.parallel import multihost
    torch.multiprocessing.start_processes(
        _render_rank, args=(multihost.local_coordinator(), str(tmp_path)),
        nprocs=2, start_method="spawn")
    for r in range(2):
        res = torch.load(tmp_path / f"rank{r}.pt")
        for rid, other in _SAME.items():
            for got, want in zip(res[rid], res[other]):
                assert torch.equal(got, want), (r, rid, other)


# The single-card pencil (1 x 1): per axis with the depth of its partial
# transforms, on kernels 1, 2 and 3, never the fused 3D kernels.


@pytest.mark.parametrize("dims", [1, 2, 3])
@pytest.mark.parametrize("shape", [(8, 16, 32), (6, 12, 15), (64, 32, 1024),
                                   (1024, 8, 16)])
def test_pencil_single_card_per_axis(cuda, shape, dims):
    x = _randn(shape, 21, cuda)
    plan = dft.PencilFFTPlan(dft.GlobalSize(*shape), dft.PencilPartition(1, 1),
                             dft.Config(fft_backend="pallas"))
    hf.reset_launches()
    c = plan.exec_r2c(x, dims)
    back = plan.exec_c2r(c, dims)
    torch.cuda.synchronize()
    assert hf.LAUNCHES["zy_fwd"] == hf.LAUNCHES["x_c2c"] == \
        hf.LAUNCHES["yz_inv"] == 0
    assert hf.LAUNCHES["rmatmul"] == 1 and hf.LAUNCHES["c2r"] == 1
    assert hf.LAUNCHES["cmatmul"] == 2 * (dims - 1)
    ref = torch.fft.rfft(x, dim=2)
    for a in (1, 0)[:dims - 1]:
        ref = torch.fft.fft(ref, dim=a)
    assert _rel(c, ref) <= 5e-4
    scale = float(np.prod(shape[3 - dims:]))
    assert _rel(back / scale, x) <= 5e-4


# The batched-2D plan on one card: "pallas" against torch.fft.rfft2, a
# chunked stack bit for bit the whole one (every kernel computes each row
# and column alone), and the executable.


@pytest.mark.parametrize("shape", [(4, 64, 48), (3, 16, 2048), (2, 2048, 16),
                                   (5, 1024, 1024), (2, 4096, 4096),
                                   (3, 13, 31)])
def test_batched_plan_on_the_card(cuda, shape):
    B, nx, ny = shape
    x = _randn(shape, 31, cuda)
    whole = dft.Batched2DFFTPlan(*shape, dft.SlabPartition(1),
                                 dft.Config(fft_backend="pallas"))
    one = dft.Batched2DFFTPlan(*shape, dft.SlabPartition(1),
                               dft.Config(fft_backend="pallas"),
                               batch_chunk=1)
    hf.reset_launches()
    c = whole.exec_forward(x)
    back = whole.exec_inverse(c)
    torch.cuda.synchronize()
    assert sum(hf.LAUNCHES.values()) > 0 and hf.DISPATCHES["matmul"] == 0
    assert c.shape == (B, nx, ny // 2 + 1) and c.dtype == torch.complex64
    assert _rel(c, torch.fft.rfft2(x)) <= 5e-4
    assert _rel(back / (nx * ny), x) <= 5e-4
    assert torch.equal(one.exec_forward(x), c)
    assert torch.equal(one.exec_inverse(c), back)


@pytest.mark.parametrize("transform", ["r2c", "c2c"])
def test_batched_c2c_and_xla_on_the_card(cuda, transform):
    shape = (4, 512, 96)
    x = _randn(shape, 32, cuda) if transform == "r2c" else \
        _crandn(shape, 32, cuda)
    ref = torch.fft.rfft2(x) if transform == "r2c" else torch.fft.fft2(x)
    for be in ("pallas", "xla"):
        plan = dft.Batched2DFFTPlan(*shape, dft.SlabPartition(1),
                                    dft.Config(fft_backend=be),
                                    transform=transform, batch_chunk=2)
        c = plan.exec_forward(x)
        assert _rel(c, ref) <= 5e-4
        assert _rel(plan.exec_inverse(c) / (512 * 96), x) <= 5e-4


def test_batched_executable_on_the_card(cuda, tmp_path, capsys):
    from distributedfft_tpu_torch.cli import batched
    hf.reset_launches()
    rc = batched.main(["-nx", "256", "-ny", "512", "-nz", "6", "-t", "3",
                       "--batch-chunk", "2", "--fft-backend", "pallas",
                       "-b", str(tmp_path)])
    assert rc == 0
    # 3 chunks, a staged and a fused roundtrip: y on kernel 1 and 3, x on
    # kernel 2's column body.
    assert hf.LAUNCHES["rmatmul"] == hf.LAUNCHES["c2r"] == 6
    assert hf.LAUNCHES["cmatmul"] == 12
    line = next(ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("Result (max): "))
    assert float(line.split()[-1]) / (256 * 512) <= 5e-4
    (csv,) = tmp_path.rglob("*.csv")
    assert csv.parent.name == "batched2d_batch_ck2"
    assert csv.name == "test_0_0_0_6_256_512_1_1.csv"


# The Bluestein backend on the card: torch.fft's chirp-z, no kernel.


@pytest.mark.parametrize("n", [127, 1031, 4093])
@pytest.mark.parametrize("fn", ["fft", "ifft", "rfft", "irfft"])
def test_bluestein_on_the_card(cuda, fn, n):
    from distributedfft_tpu_torch.ops import fft as lf
    hf.reset_launches()
    if fn == "irfft":
        x = _crandn((4, n // 2 + 1), 33, cuda)
        got = lf.irfft(x, n=n, axis=-1, backend="bluestein")
        ref = torch.fft.irfft(x.to(torch.complex128), n=n, norm="forward")
    else:
        x = _crandn((4, n), 33, cuda) if fn != "rfft" else \
            _randn((4, n), 33, cuda)
        got = getattr(lf, fn)(x, axis=-1, backend="bluestein")
        ref = getattr(torch.fft, fn)(
            x.to(torch.complex128 if fn != "rfft" else torch.float64),
            norm="forward" if fn == "ifft" else "backward")
    assert _rel(got, ref) <= 5e-4
    assert not any(hf.LAUNCHES.values())
    if fn != "irfft":
        got64 = getattr(lf, fn)(x.to(torch.float64 if fn == "rfft" else
                                     torch.complex128), axis=-1,
                                backend="bluestein")
        assert _rel(got64, ref) <= 1e-10


def test_bluestein_smooth_plan_is_xla_on_the_card(cuda):
    x = _randn((64, 48, 30), 34, cuda)
    g = dft.GlobalSize(64, 48, 30)
    bp = dft.SlabFFTPlan(g, dft.SlabPartition(1),
                         dft.Config(fft_backend="bluestein"))
    xp = dft.SlabFFTPlan(g, dft.SlabPartition(1), dft.Config())
    c = bp.exec_r2c(x)
    assert torch.equal(c, xp.exec_r2c(x))
    assert torch.equal(bp.exec_c2r(c), xp.exec_c2r(c))


# -- the resilience layer on the card ----------------------------------------


@pytest.mark.parametrize("shape", [(6, 12, 15), (16, 10, 12), (64, 32, 1024),
                                   (8, 512, 512)])
@pytest.mark.parametrize("mode", ["check", "enforce"])
def test_guarded_plan_is_the_plan_on_the_card(cuda, shape, mode):
    """Guards on: the unguarded plan's bits and launches, no violation; the
    guard's energies on the card within 1e-6 of the CPU's."""
    from distributedfft_tpu_torch import obs
    from distributedfft_tpu_torch.resilience import guards
    x = _randn(shape, 90, cuda)
    g = dft.GlobalSize(*shape)
    off = dft.SlabFFTPlan(g, dft.SlabPartition(1),
                          dft.Config(fft_backend="pallas"))
    on = dft.SlabFFTPlan(g, dft.SlabPartition(1),
                         dft.Config(fft_backend="pallas", guards=mode))
    hf.reset_launches()
    want = off.exec_r2c(x)
    back_want = off.exec_c2r(want)
    launches = dict(hf.LAUNCHES)
    obs.reset()
    hf.reset_launches()
    got = on.exec_r2c(x)
    back = on.exec_c2r(got)
    assert dict(hf.LAUNCHES) == launches
    assert torch.equal(got, want) and torch.equal(back, back_want)
    assert obs.metrics.counter_value("guard.parseval_violations") == 0
    spec = on._guard_spec("forward")
    reg = guards.region(on, "forward")
    card = guards.parseval_sums(spec, x, got, reg).tolist()
    host = guards.parseval_sums(spec, x.cpu(), got.cpu(), reg).tolist()
    np.testing.assert_allclose(card, host, rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.complex64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("spec", ["wire:nan", "wire:bitflip@seed=11",
                                  "wire:scale:0.3"])
def test_taint_on_the_card_is_the_host_taint(cuda, monkeypatch, spec, dtype):
    """The injector corrupts a device tensor out of place, bit for bit as
    it corrupts the same tensor on the host."""
    from distributedfft_tpu_torch.resilience import inject
    monkeypatch.setenv(inject.ENV_VAR, spec)
    x = _crandn((4, 6, 10), 91, "cpu").to(dtype) if dtype.is_complex \
        else _randn((2, 4, 6, 10), 91, "cpu").to(dtype)
    xd = x.to(cuda)
    got = inject.taint_wire(xd, "test")
    assert got.device.type == "cuda"
    assert torch.equal(xd.cpu(), x)
    want = inject.taint_wire(x, "test")
    view = (lambda t: torch.view_as_real(t).view(torch.int32)) \
        if dtype.is_complex else (lambda t: t.view(
            torch.int16 if dtype == torch.bfloat16 else torch.int32))
    assert torch.equal(view(got.cpu()), view(want))


def test_kernel_error_is_raised_by_a_failing_launch(cuda, monkeypatch):
    """A launch whose entry point returns a CUDA error raises
    ``KernelError``, which the ladder does not step around."""
    from distributedfft_tpu_torch.ops import _build
    assert issubclass(_build.KernelError, RuntimeError)
    lib = _build.load("stage", {f: sig for f, (name, sig)
                                in hf._ENTRIES.items() if name == "stage"})
    with pytest.raises(_build.KernelError, match="CUDA error 1"):
        _build.check(lib, "dfft_cdft", 1)


# -- the solvers on the card ("pallas" against "xla") ------------------------


@pytest.mark.parametrize("n", [32, 96])
def test_poisson_pallas_matches_xla(cuda, n):
    """A periodic Poisson solve on the kernels (the fused path at 32^3,
    the per-axis one at 96^3 too) against the same solve on cuFFT."""
    from distributedfft_tpu_torch.solvers import PoissonSolver
    g = dft.GlobalSize(n, n, n)
    f = _randn((n, n, n), 7, cuda)
    got = PoissonSolver(dft.SlabFFTPlan(g, dft.SlabPartition(1),
                                        dft.Config(fft_backend="pallas")),
                        mode="integer").solve(f)
    ref = PoissonSolver(dft.SlabFFTPlan(g, dft.SlabPartition(1),
                                        dft.Config()),
                        mode="integer").solve(f)
    assert _rel(got, ref) <= 5e-4


def test_navier_stokes_pallas_matches_xla(cuda):
    """Two RK4 steps of NS-3D (slab, fused kernels) and NS-2D (batched)
    on the kernels against cuFFT."""
    from distributedfft_tpu_torch.solvers import (NavierStokes2D,
                                                  NavierStokes3D,
                                                  taylor_green_3d)
    u0 = torch.from_numpy(taylor_green_3d(32, dtype=np.float32)).to(cuda)
    w0 = _randn((2, 64, 64), 3, cuda)
    outs = {}
    for be in ("pallas", "xla"):
        cfg = dft.Config(fft_backend=be)
        p3 = dft.SlabFFTPlan(dft.GlobalSize(32, 32, 32), dft.SlabPartition(1),
                             cfg)
        p2 = dft.Batched2DFFTPlan(2, 64, 64, dft.SlabPartition(1), cfg)
        outs[be] = (NavierStokes3D(p3, 0.01).run(u0, 2, 1e-3),
                    NavierStokes2D(p2, 0.01).run(w0, 2, 1e-3))
    for a, b in zip(outs["pallas"], outs["xla"]):
        assert _rel(a, b) <= 5e-4


def test_convolution_pallas_matches_xla(cuda):
    from distributedfft_tpu_torch.solvers import make_convolver
    img = _randn((3, 100, 90), 5, cuda)
    ker = np.random.default_rng(5).random((9, 7)).astype(np.float32)
    got = make_convolver(ker, (100, 90), batch=3,
                         config=dft.Config(fft_backend="pallas"))(img)
    ref = make_convolver(ker, (100, 90), batch=3, config=dft.Config())(img)
    assert _rel(got, ref) <= 5e-4


def test_pallas_backward_raises_on_the_card(cuda):
    """``forward_fn`` on the kernels is ``exec_fwd`` bit for bit; its
    backward raises, naming the missing VJP."""
    plan = dft.SlabFFTPlan(dft.GlobalSize(32, 32, 32), dft.SlabPartition(1),
                           dft.Config(fft_backend="pallas"))
    x = _randn((32, 32, 32), 9, cuda)
    with torch.no_grad():
        assert torch.equal(plan.forward_fn()(x), plan.exec_fwd(x))
    xl = x.clone().requires_grad_()
    y = plan.inverse_fn()(plan.forward_fn()(xl))
    with pytest.raises(NotImplementedError, match="has no VJP"):
        y.sum().backward()


@pytest.mark.parametrize("n", [1, 65537, (1 << 22) + 3])
def test_crc32c_lanes_on_the_card(cuda, n):
    """The checkpoint checksum's lanes on the card give the table loop's
    answer (CPU lanes beside them)."""
    from distributedfft_tpu_torch.persist import checkpoint as ck
    buf = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    want = ck._raw(buf, ck._MASK, torch.device("cpu")) ^ ck._MASK
    assert ck._raw(buf, ck._MASK, cuda) ^ ck._MASK == want == ck.crc32c(buf)
    if n < 1 << 20:
        assert ck._raw_loop(buf.tobytes(), 0xFFFFFFFF) ^ 0xFFFFFFFF == want


def test_auto_backend_races_once_on_the_card(cuda, tmp_path, monkeypatch):
    """``fft_backend="auto"`` on the card: every candidate measured, the
    winner recorded under the card's name, the second plan a hit."""
    from distributedfft_tpu_torch import obs
    from distributedfft_tpu_torch.utils import wisdom
    monkeypatch.setenv("DFFT_WISDOM_K", "2")
    cfg = dft.Config(fft_backend="auto", wisdom_path=str(tmp_path / "w.json"))
    g = dft.GlobalSize(64, 64, 64)
    plan = dft.SlabFFTPlan(g, dft.SlabPartition(1), cfg)
    key = wisdom.plan_wisdom_key(plan)
    assert torch.cuda.get_device_name(0) in key
    rec = wisdom.WisdomStore(cfg.wisdom_path).lookup(key, "local_fft")
    assert rec["fft_backend"] == plan.config.fft_backend
    c0 = obs.metrics.counter_value("autotune.race_cells")
    again = dft.SlabFFTPlan(g, dft.SlabPartition(1), cfg)
    assert obs.metrics.counter_value("autotune.race_cells") == c0
    assert again.config == plan.config
    x = _randn((64, 64, 64), 3, cuda)
    assert _rel(plan.exec_r2c(x), torch.fft.rfftn(x)) <= 5e-4


@pytest.mark.parametrize("plant", ["over-budget", "hang"])
def test_failed_pallas_cell_raises_on_the_card(cuda, tmp_path, monkeypatch,
                                               plant):
    """A "pallas" race cell that misses the budget "xla" met, or hangs
    past the cell timeout, raises a KernelError out of the "auto" plan
    and records no "xla" winner."""
    from distributedfft_tpu_torch.ops._build import KernelError
    from distributedfft_tpu_torch.testing import autotune as at
    monkeypatch.setenv("DFFT_WISDOM_K", "2")
    real = at._measure

    def measure(shape, backend, *a, **k):
        if backend != "pallas":
            return real(shape, backend, *a, **k)
        if plant == "hang":
            time.sleep(6)   # abandoned at 2 s; never reaches the card
            raise RuntimeError("abandoned cell")
        ms, _, note = real(shape, backend, *a, **k)
        return ms, 0.5, note

    monkeypatch.setattr(at, "_measure", measure)
    if plant == "hang":
        monkeypatch.setenv("DFFT_AUTOTUNE_CELL_TIMEOUT_S", "2")
    store = tmp_path / "w.json"
    cfg = dft.Config(fft_backend="auto", wisdom_path=str(store))
    with pytest.raises(KernelError, match="candidate pallas failed"):
        dft.SlabFFTPlan(dft.GlobalSize(32, 32, 32), dft.SlabPartition(1), cfg)
    assert not store.exists()


def test_resume_is_bit_exact_on_the_card(cuda, tmp_path):
    """NS-3D on the fused kernels: 2 steps, checkpoint, restore, 2 steps
    bit-equal to 4 straight steps."""
    from distributedfft_tpu_torch import persist
    from distributedfft_tpu_torch.solvers import NavierStokes3D
    n = 64
    plan = dft.SlabFFTPlan(dft.GlobalSize(n, n, n), dft.SlabPartition(1),
                           dft.Config(fft_backend="pallas"))
    ns = NavierStokes3D(plan, 1e-3)
    step = ns.step_fn(1e-3)
    store = persist.CheckpointStore(str(tmp_path))
    with torch.no_grad():
        w = step(step(ns.to_spectral(_randn((3, n, n, n), 4, cuda))))
        straight = step(step(w))
        store.save(persist.capture(ns, w, 2, 1e-3))
        back = persist.restore(store.load(
            expect_fingerprint=persist.plan_fingerprint(plan)), ns)
        resumed = step(step(back))
    assert all(torch.equal(a, b) for a, b in zip(resumed, straight))


def test_server_on_the_card(cuda):
    """A one-rank server on the kernels: 256² replies within 5e-4 of
    ``torch.fft``, a coalesced batch bit for bit its single-shot replies,
    the split recorded, and the images' launches kernels 2, 4 or 5 only."""
    from distributedfft_tpu_torch.serve import Server
    imgs = [np.random.default_rng(i).standard_normal((256, 256))
            .astype(np.float32) for i in range(4)]
    with Server(config=dft.Config(fft_backend="pallas"), max_coalesce=1) \
            as s1:
        single = [s1.request(x) for x in imgs]
    with Server(config=dft.Config(fft_backend="pallas"), max_coalesce=8) \
            as s:
        assert s.prewarm((256, 256), directions=("forward", "inverse")) == 4
        hf.reset_launches()
        s.submit(np.zeros((64, 64), np.float32))
        futs = [s.submit(x) for x in imgs]
        got = [f.result(120) for f in futs]
        assert s.health()["counters"]["coalesced"] >= 2
        back = s.request(got[0], "r2c", "inverse", ny=256)
        hist = s.health()["obs_metrics"]["histograms"]
    for a, b in zip(single, got):
        assert np.array_equal(a, b)
    ref = torch.fft.rfft2(torch.from_numpy(imgs[0]).to(cuda)).cpu()
    assert _rel(torch.from_numpy(got[0]), ref) <= 5e-4
    assert _rel(torch.from_numpy(back / 256 ** 2),
                torch.from_numpy(imgs[0])) <= 5e-4
    assert set(k for k, v in hf.LAUNCHES.items() if v) <= {
        "cmatmul", "cmatmul_tw", "rmatmul_tw", "rmatmul", "c2r"}
    assert hf.DISPATCHES["matmul"] == 0
    for name in ("serve.copy_in_ms", "serve.device_ms", "serve.copy_out_ms"):
        assert hist[name]["count"] >= 1


def test_capture_charges_ctypes_kernels_to_their_scopes(cuda):
    """The port's kernels launch through ``ctypes``, outside aten: the
    capture still charges their device time to the stage scope open
    around each launch, and reads the device's idle share."""
    from distributedfft_tpu_torch.obs import profile
    plan = dft.SlabFFTPlan(dft.GlobalSize(128, 128, 128),
                           dft.SlabPartition(1),
                           dft.Config(fft_backend="pallas"))
    prof = profile.capture_stage_profile(plan, "forward", iters=3)
    assert prof["planes"] and prof["planes"][0].startswith("/device:GPU:")
    assert prof["scopes"].get("slab/local_fft:1", 0) > 0
    assert prof["scopes"]["slab/local_fft:1"] >= 0.5 * prof["total_ms"]
    assert 0 <= prof["idle_share"] < 1
