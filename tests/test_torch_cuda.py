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
