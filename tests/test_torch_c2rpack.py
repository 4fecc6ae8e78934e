"""Kernel 3's route past the direct lengths, on the CPU: the C2R of an even
n as the complex inverse of m = n / 2 points of a packed spectrum.

For X the (m + 1)-bin half spectrum, Z[k] = E[k] + i O[k] with E[k] =
X[k] + conj X[m - k] and O[k] = (X[k] - conj X[m - k]) exp(+2 pi i k / n);
the unnormalized m-point inverse of Z is x[2j] + i x[2j + 1]. The inputs
are random half spectra whose bins 0 and m carry imaginary parts, which
the C2R ignores and the packing must drop.

* ``c2r_packed_plain`` (kernel 3's packed body as the packing and a dense
  product) and ``c2r_packed_mirror`` (the packing and the engine's passes
  from ``fft_plan``) against float64 numpy ``irfft`` to 1e-5 (float32
  against float64), at m = 8, 64, 1024 and the mixed lengths 320, 416,
  448 and 480;
* ``c2r_pack_plain`` (the pack pass: Z in the four-step's first-stage
  layout, Z[s n1 + r] at r n2 + s) taken back to natural order and
  inverted in float64, against numpy ``irfft`` (1e-5);
* ``hf.irfft`` against the JAX package's ``pallas_fft.irfft`` (its Pallas
  kernels in interpret mode, outside ``shard_map``) at n in {640, 832,
  896, 1042, 2048, 4096, 4320, 4064} and the odd 1025, last and non-last
  axes, and with the half spectrum cropped and padded, to 5e-4 (the JAX
  package's per-stage bound);
* the card's routing on "meta" tensors, every wrapper check and
  ``_launch`` patched (each launch recorded, none run): the entry points
  each n launches, and that an even n runs no Hermitian extension, no
  ``_swap_last`` and no op that copies a tensor of the rows (only views,
  ``empty`` and the launches touch them);
* the host side of the packed body's schedule (an even row count a batch,
  the block within ``MIXED_SMEM``), the half-step roots and the wrappers'
  checks.
"""

import numpy as np
import pytest
import torch

from distributedfft_tpu.ops import pallas_fft
from distributedfft_tpu_torch.analysis import opscan
from distributedfft_tpu_torch.ops import hopper_fft as hf

ENGINE_M = [8, 64, 1024, 320, 416, 448, 480]
# (m, n1): natural order (n1 = 1), the mixed lengths' layouts, the
# first-stage layouts of the splits irfft meets (2048 = 4 x 512, 2160 = 5 x
# 432, 2032 = 4 x 508), a tile of r that is ragged (45 > 32 points of r),
# and r tiles of 32 (16384 = 32 x 512).
PACK_CASES = [(8, 1), (64, 4), (1024, 2), (320, 5), (416, 13), (448, 7),
              (480, 16), (521, 1), (2048, 4), (2160, 5), (2032, 4),
              (2880, 45), (16384, 32)]
JAX_NS = [640, 832, 896, 1042, 2048, 4096, 4320, 4064, 1025]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def _half(M, k, seed):
    """Random (M, k) half spectra whose first and last bins have non-zero
    imaginary parts."""
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((M, k)) + 1j * rng.standard_normal((M, k))
    assert np.all(np.abs(c[:, [0, k - 1]].imag) > 0)
    return c.astype(np.complex64)


def _irfft64(c, n):
    """The unnormalized C2R in float64 (numpy ignores the imaginary parts
    of bins 0 and n / 2)."""
    return np.fft.irfft(c.astype(np.complex128), n) * n


@pytest.mark.parametrize("M", [1, 5])
@pytest.mark.parametrize("m", ENGINE_M)
def test_packed_body_matches_numpy(m, M):
    n = 2 * m
    c = _half(M, m + 1, 7 * m + M)
    want = _irfft64(c, n)
    got = hf.c2r_packed_plain(torch.from_numpy(c), n)
    assert got.dtype == torch.float32 and got.shape == (M, n)
    assert _rel(got.numpy(), want) <= 1e-5
    assert _rel(hf.c2r_packed_mirror(torch.from_numpy(c), n).numpy(),
                want) <= 1e-5


@pytest.mark.parametrize("m, n1", PACK_CASES)
def test_pack_pass_matches_numpy(m, n1):
    M, n = 3, 2 * m
    c = _half(M, m + 1, m + n1)
    z = hf.c2r_pack_plain(torch.from_numpy(c), n1).numpy()
    assert z.dtype == np.complex64 and z.shape == (M, m)
    n2 = m // n1
    natural = z.reshape(M, n1, n2).transpose(0, 2, 1).reshape(M, m)
    x = np.fft.ifft(natural.astype(np.complex128), axis=-1) * m
    got = np.stack([x.real, x.imag], -1).reshape(M, n)
    assert _rel(got, _irfft64(c, n)) <= 1e-5


@pytest.mark.parametrize("m", [64, 448, 2048])
def test_packing_ignores_the_imaginary_parts_of_bins_0_and_m(m):
    """A half spectrum whose only non-zero values are the imaginary parts
    of bins 0 and m has a C2R of zero: both bodies give exact zeros."""
    c = np.zeros((2, m + 1), np.complex64)
    c[:, 0] = 3j
    c[:, m] = -2j
    ct = torch.from_numpy(c)
    assert not hf._packed_spectrum(ct).any()
    assert not hf.c2r_pack_plain(ct, 4).any()
    if hf._engine_length(m):
        assert not hf.c2r_packed_plain(ct, 2 * m).any()


@pytest.mark.parametrize("where", ["last", "non_last"])
@pytest.mark.parametrize("n", JAX_NS)
def test_irfft_matches_jax(n, where):
    k = n // 2 + 1
    c = _half(3, k, n)
    if where == "last":
        x, axis = c, -1
    else:
        x, axis = np.ascontiguousarray(c.T[:, None, :]), 0   # (k, 1, 3)
    got = hf.irfft(torch.from_numpy(x), n=n, axis=axis).numpy()
    ref = np.asarray(pallas_fft.irfft(x, n=n, axis=axis))
    assert got.shape == ref.shape == ((3, n) if where == "last"
                                      else (n, 1, 3))
    assert _rel(got, ref) <= 5e-4


@pytest.mark.parametrize("fit", ["crop", "pad"])
@pytest.mark.parametrize("n", [896, 1042, 2048, 4096])
def test_irfft_crop_and_pad_match_jax(n, fit):
    """A half spectrum longer (cropped) or shorter (zero-padded) than n/2
    + 1 bins, as numpy's ``n=``."""
    k = n // 2 + 1 + (7 if fit == "crop" else -9)
    c = _half(2, k, n + k)
    got = hf.irfft(torch.from_numpy(c), n=n, axis=-1).numpy()
    ref = np.asarray(pallas_fft.irfft(c, n=n, axis=-1))
    assert got.shape == ref.shape == (2, n)
    assert _rel(got, ref) <= 5e-4
    assert _rel(got, _irfft64(c, n)) <= 5e-4


# ---------------------------------------------------------------------------
# The card's routing on "meta" tensors
# ---------------------------------------------------------------------------

_PACKED = ("c2r", "dfft_c2r_packed")
_PACK = ("c2r", "dfft_c2r_pack")
_TW = ("cmatmul_tw", "dfft_cdft_tw")
_SHORT = ("cmatmul", "dfft_cdft_short")
# n -> the (kernel, entry) launches of irfft along the last axis: an
# engine half (1024, 448, 416, 320) one launch of the packed body; else
# the pack pass, then the complex inverse of n / 2: 2048 = 4 x 512, 2160 =
# 5 x 432 and 640 = 2 x 320 on kernel 4 and the short stage, 2032 = 4 x
# 508 its first stage on kernel 4's tile body, the prime 521 one launch of
# kernel 2's tile body, the prime 1031 past N_MAX the matmul backend.
ROUTES = {2048: [_PACKED], 896: [_PACKED], 832: [_PACKED], 640: [_PACKED],
          4096: [_PACK, _TW, _SHORT], 4320: [_PACK, _TW, _SHORT],
          1280: [_PACK, _TW, _SHORT], 16384: [_PACK, _TW, _SHORT],
          4064: [_PACK, ("cmatmul_tw", "dfft_stage"), _SHORT],
          1042: [_PACK, ("cmatmul", "dfft_stage")], 2062: [_PACK]}
# What may touch a tensor of the rows on an even n's route: views, the
# outputs' allocation, and the launches.
_VIEWS = {"aten.permute.default", "aten.view.default",
          "aten.empty.memory_format", "aten.view_as_real.default",
          "aten._unsafe_view.default", "aten._reshape_alias.default"}


def _route_on_meta(monkeypatch, n, M=6):
    """hf.irfft of (M, n/2 + 1) on "meta" along the last axis with every
    check and ``_launch`` patched: (launches as (kernel, entry, args), the
    recorded op trace, the calls of the Hermitian extension and the swap,
    the matmul backend's dispatches)."""
    log, calls = [], {"_hermitian_extend": 0, "_swap_last": 0}
    for name in ("_check_rows", "_check", "_check_cols", "_check_short",
                 "_check_tw_cols"):
        monkeypatch.setattr(hf, name, lambda *a, **k: False)

    def launch(kernel, fn, *args):
        log.append((kernel, fn, args))
        for hook in hf.LAUNCH_HOOKS:
            hook(kernel, fn, args)

    monkeypatch.setattr(hf, "_launch", launch)

    def counting(module, name):
        orig = getattr(module, name)

        def counted(*a, **k):
            calls[name] += 1
            return orig(*a, **k)
        monkeypatch.setattr(module, name, counted)

    counting(hf.mx, "_hermitian_extend")
    counting(hf, "_swap_last")
    hf.reset_launches()
    x = torch.zeros((M, n // 2 + 1), dtype=torch.complex64, device="meta")
    trace = opscan.record(lambda: hf.irfft(x, n=n, axis=-1))
    assert trace.out_shapes == ((M, n),)
    assert trace.out_dtypes == ("torch.float32",)
    return log, trace, calls, hf.DISPATCHES["matmul"]


@pytest.mark.parametrize("n", list(ROUTES))
def test_even_n_routes(monkeypatch, n):
    """Each even n past the direct lengths launches the entries of
    ``ROUTES``: an engine half one ``dfft_c2r_packed``, any other the pack
    pass and the complex inverse's kernels; none runs the Hermitian
    extension, ``_swap_last`` or an op that copies the rows (splits with a
    short second stage, n1 <= 16)."""
    M = 6
    log, trace, calls, matmul = _route_on_meta(monkeypatch, n, M)
    assert [(k, e) for k, e, _ in log] == ROUTES[n]
    assert calls == {"_hermitian_extend": 0, "_swap_last": 0}
    assert matmul == (1 if n == 2062 else 0)
    for op in trace.ops:          # the dispatch's ops (not the matmul
        if op.where.startswith("ops/hopper_fft.py") and \
                op.name.startswith("aten.") and any(   # backend's products)
                s and s[0] == M for s in op.out_shapes):
            assert op.name in _VIEWS, (op.name, op.out_shapes)
    m = n // 2
    kernel, entry, args = log[0]
    if entry == "dfft_c2r_packed":
        assert args[0].shape == (M, m + 1) and args[3].shape == (M, m)
        assert args[1] is hf._fft_table(m, True, args[0].device)
        assert tuple(args[2].shape) == (2, m)
        assert args[4:] == (M, m, hf._engine_schedule(m, True, packed=True))
    else:
        n1 = (1 if hf._direct(m) or hf._long_prime(m)
              else hf._split_axis(m)[0])
        assert args[0].shape == (M, m + 1) and args[2].shape == (M, m)
        assert tuple(args[1].shape) == (2, m)
        assert args[3:] == (M, m, n1)
        if len(log) > 1:
            assert log[1][2][0]._base is args[2]      # entered as it lies


def test_odd_n_keeps_the_extension(monkeypatch):
    """An odd n (1025 = 5 x 205) has no packing: the Hermitian extension
    and a complex four-step of n points, as the JAX package does."""
    log, _, calls, _ = _route_on_meta(monkeypatch, 1025)
    assert [(k, e) for k, e, _ in log] == [("cmatmul_tw", "dfft_stage"),
                                            _SHORT]
    assert calls == {"_hermitian_extend": 1, "_swap_last": 1}


@pytest.mark.parametrize("m", hf.MIXED_LENGTHS)
def test_packed_schedule_at_every_mixed_length(m):
    """The packed body's batch on the mixed-radix kernel: an even row
    count (every batch 16-byte aligned: 8 rows (m + 1) bytes), the block
    within ``MIXED_SMEM``, the radices ``fft_plan``'s."""
    sched = hf.mixed_schedule(m, True, packed=True)
    rows = sched >> hf.MIXED_ROWS_SHIFT
    assert rows % 2 == 0 and rows * m <= hf.MIXED_POINTS
    assert sched & ((1 << hf.MIXED_ROWS_SHIFT) - 1) == hf.fft_plan(
        m, True).schedule
    assert hf._engine_schedule(m, True, packed=True) == sched
    r0 = hf.fft_plan(m, True).radices[0]
    assert hf.mixed_smem(m, r0, rows, packed=True) <= hf.MIXED_SMEM
    assert hf._stage_bytes(m, rows, packed=True) == 8 * rows * (m + 1)


def test_packed_schedule_of_a_power_of_two_is_the_plans():
    for m in (8, 256, 1024):
        assert hf._engine_schedule(m, True, packed=True) == hf.fft_plan(
            m, True).schedule


@pytest.mark.parametrize("n", [16, 896, 2048, 4320])
def test_half_roots(n):
    w = hf.half_roots(n)
    assert w.dtype == np.float32 and w.shape == (2, n // 2)
    want = np.exp(2j * np.pi * np.arange(n // 2) / n)
    assert np.max(np.abs(w[0] + 1j * w[1] - want)) <= 1e-7
    assert hf._half_roots(n, torch.device("cpu")).shape == (2, n // 2)


def test_packed_wrappers_check_their_arguments():
    c = torch.zeros((4, 513), dtype=torch.complex64)
    with pytest.raises(ValueError):
        hf.irdft_packed(c, 1025)                        # odd n
    with pytest.raises(ValueError):
        hf.irdft_packed(c, 2048)                        # 513 != 1024 + 1
    with pytest.raises(ValueError):                     # 521: no engine length
        hf.irdft_packed(torch.zeros((4, 522), dtype=torch.complex64), 1042)
    with pytest.raises(TypeError):
        hf.irdft_packed(c.real.contiguous(), 1024)
    with pytest.raises(ValueError):
        hf.irdft_packed(c.to("meta"), 1024)             # no kernel
    with pytest.raises(ValueError):
        hf.c2r_pack(c, 3)                               # 3 does not divide 512
    with pytest.raises(ValueError):
        hf.c2r_pack(torch.zeros((5, 4), dtype=torch.complex64).t(), 1)
    with pytest.raises(ValueError):
        hf.c2r_pack(c.to("meta"), 4)                    # no kernel


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    c = torch.from_numpy(_half(3, 1025, 11))
    hf.reset_launches()
    assert torch.equal(hf.irdft_packed(c, 2048), hf.c2r_packed_plain(c, 2048))
    assert torch.equal(hf.c2r_pack(c, 4), hf.c2r_pack_plain(c, 4))
    assert all(v == 0 for v in hf.LAUNCHES.values()), hf.LAUNCHES
