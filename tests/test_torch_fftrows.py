"""The host side of the row FFT engine of kernels 1, 2, 4, 5 and 11
(``csrc/fft_rows.cuh``), on the CPU.

* ``fft_plan(n, inverse)``: the pass schedule and the twiddle table the
  kernel consumes, for every power of two 8..1024 (the mixed lengths:
  ``tests/test_torch_mixedradix.py``).
* ``fft_rows_mirror``: the kernel's passes from that plan in plain PyTorch,
  held against ``torch.fft`` (1e-5, float32 against float64) and against
  the JAX package's ``pallas_fft._stage`` with ``_dft_np`` (its Pallas
  kernel in interpret mode; 5e-4, the JAX per-stage bound), both
  directions.
* Kernel 5's real-row path (``rdft_tw_mirror``: pair packing, the split,
  an odd M, the twiddle by ``r % n1``) against ``stage_plain`` and the JAX
  ``_call_stage`` with the twiddle.
* Kernel 4's complex-row path (``cdft_tw_mirror``: the engine, then the
  twiddle by ``r % n1``), both directions, against ``stage_plain`` and the
  JAX ``_call_stage`` with the twiddle; ``fft`` of a 2048-point axis
  reaching ``cdft_tw``.
* Kernel 2's body (``fft_rows_mirror``) and kernel 1's (``rdft_mirror``:
  pair packing, the split, bins 0..n/2 kept, an odd M) against
  ``stage_plain`` and the JAX ``_call_stage`` without a twiddle, at every
  power of two 8..1024.
* ``_fft_body``'s routing, the per-axis dispatch (a power of two up to
  1024 in one ``cdft`` / ``rdft``, other direct lengths through ``stage``'s
  planes) and the wrappers' argument checks.
"""

import math

import numpy as np
import pytest
import torch

from distributedfft_tpu.ops import mxu_fft as jmx
from distributedfft_tpu.ops import pallas_fft
from distributedfft_tpu_torch.ops import hopper_fft as hf

CPU = torch.device("cpu")
POW2 = [8, 16, 32, 64, 128, 256, 512, 1024]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def _complex(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _real(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("n", POW2)
def test_fft_plan_schedule_and_table(n):
    plan = hf.fft_plan(n, False)
    inv = hf.fft_plan(n, True)
    bits = int(math.log2(n))
    assert plan.radices == inv.radices
    assert math.prod(plan.radices) == n
    assert len(plan.radices) == math.ceil(bits / 4)
    assert all(8 <= r <= 16 for r in plan.radices[:1])
    assert all(2 <= r <= 16 for r in plan.radices)
    assert list(plan.radices) == sorted(plan.radices, reverse=True)
    assert max(plan.radices) <= 2 * min(plan.radices)       # as even as can be
    assert [(plan.schedule >> (5 * p)) & 31 for p in range(len(plan.radices))] \
        == list(plan.radices)
    assert plan.schedule >> (5 * len(plan.radices)) == 0
    # The table, entry by entry, from its documented layout.
    assert plan.table.dtype == np.float32 and plan.table.flags.c_contiguous
    assert plan.table.shape == (2, n - plan.radices[0])
    want, ns = [], plan.radices[0]
    for r in plan.radices[1:]:
        for m in range(1, r):
            for k in range(ns):
                want.append(np.exp(-2j * np.pi * m * k / (ns * r)))
        ns *= r
    want = np.asarray(want, np.complex128)
    got = plan.table[0] + 1j * plan.table[1].astype(np.float64)
    assert np.max(np.abs(got - want), initial=0.0) <= 6e-8
    assert np.array_equal(inv.table[0], plan.table[0])
    assert np.array_equal(inv.table[1], -plan.table[1])


def test_fft_plan_examples_and_refusals():
    assert hf.fft_plan(1024, False).radices == (16, 8, 8)
    assert hf.fft_plan(512, False).radices == (8, 8, 8)
    assert hf.fft_plan(1024, False).schedule == 16 | 8 << 5 | 8 << 10
    assert hf.fft_plan(12, False).radices == (12,)   # a mixed length
    for n in (4, 7, 520, 1000, 2048):
        with pytest.raises(ValueError):
            hf.fft_plan(n, False)


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("n", POW2)
def test_mirror_matches_torch_fft(n, inverse):
    z = torch.from_numpy(_complex((5, n), n))
    got = hf.fft_rows_mirror(z, inverse)
    z64 = z.to(torch.complex128)
    want = (torch.fft.ifft(z64, norm="forward") if inverse
            else torch.fft.fft(z64))
    assert got.dtype == torch.complex64 and got.shape == (5, n)
    assert _rel(got.numpy(), want.numpy()) <= 1e-5


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("n", [8, 32, 128, 512, 1024])
def test_mirror_matches_jax_stage(n, inverse):
    """Against ``pallas_fft._stage`` with the dense DFT, its Pallas kernel
    in interpret mode."""
    z = _complex((3, n), n + 7)
    want = np.asarray(pallas_fft._stage(z, jmx._dft_np(n, inverse, False)))
    got = hf.fft_rows_mirror(torch.from_numpy(z), inverse).numpy()
    assert _rel(got, want) <= 5e-4


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("M, n", [(1, 8), (7, 64), (4, 1024)])
def test_kernel11_mirror_matches_plain(M, n, inverse):
    planes = hf.enc_pack_plain(torch.from_numpy(_complex((M, n), M)))
    got = hf.fft_rows_mirror(hf.dec_unpack_plain(planes), inverse)
    want = hf.dec_cmatmul(planes, inverse)            # CPU: the plain version
    assert _rel(got.numpy(), want.numpy()) <= 1e-5
    assert _rel(want.numpy(), hf.dec_cmatmul_plain(
        planes, *hf._planes("dft", n, inverse, CPU)).numpy()) == 0


@pytest.mark.parametrize("n1, M, n2", [(2, 7, 512), (3, 9, 64), (4, 5, 16),
                                       (8, 17, 8), (2, 1, 1024),
                                       (3, 12, 32)])
def test_kernel5_real_rows_path(n1, M, n2):
    """Pair packing, the split, an odd last row and the twiddle by
    ``r % n1`` against ``stage_plain`` and JAX's ``_call_stage``."""
    x = _real((M, n2), 10 * n1 + M)
    got = hf.rdft_tw_mirror(torch.from_numpy(x), n1)
    assert got.dtype == torch.complex64 and got.shape == (M, n2)
    plain = hf.stage_plain(torch.from_numpy(x),
                           *hf._planes("dft", n2, False, CPU),
                           *hf._twiddle_planes(n1, n2, False, CPU))
    assert _rel(got.numpy(), plain.numpy()) <= 1e-5
    assert torch.equal(hf.rdft_tw(torch.from_numpy(x), n1), plain)
    want = np.asarray(pallas_fft._call_stage(
        x, jmx._dft_np(n2, False, False), (n1, n2, False)))
    assert _rel(got.numpy(), want) <= 5e-4


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("n1, M, n2", [(2, 7, 512), (3, 9, 64), (4, 5, 16),
                                       (2, 1, 1024), (3, 13, 8),
                                       (4, 11, 128)])
def test_kernel4_complex_rows_path(n1, M, n2, inverse):
    """The engine on complex rows and the twiddle by ``r % n1`` (odd M)
    against ``stage_plain`` and JAX's ``_call_stage`` with the twiddle."""
    x = _complex((M, n2), 10 * n1 + M + inverse)
    got = hf.cdft_tw_mirror(torch.from_numpy(x), n1, inverse)
    assert got.dtype == torch.complex64 and got.shape == (M, n2)
    plain = hf.stage_plain(torch.from_numpy(x),
                           *hf._planes("dft", n2, inverse, CPU),
                           *hf._twiddle_planes(n1, n2, inverse, CPU))
    assert _rel(got.numpy(), plain.numpy()) <= 1e-5
    assert torch.equal(hf.cdft_tw(torch.from_numpy(x), n1, inverse), plain)
    want = np.asarray(pallas_fft._call_stage(
        x, jmx._dft_np(n2, inverse, False), (n1, n2, inverse)))
    assert _rel(got.numpy(), want) <= 5e-4


# M: one row, an odd count (the last real row paired with zeros), even.
@pytest.mark.parametrize("M", [1, 5, 6])
@pytest.mark.parametrize("n", POW2)
def test_kernel1_mirror_matches_plain_and_jax(n, M):
    """Kernel 1's FFT body: pair packing, the split and bins 0..n/2 kept,
    against ``stage_plain`` with the R2C planes and JAX's ``_call_stage``
    (its Pallas kernel in interpret mode)."""
    x = _real((M, n), 3 * n + M)
    got = hf.rdft_mirror(torch.from_numpy(x))
    assert got.dtype == torch.complex64 and got.shape == (M, n // 2 + 1)
    plain = hf.stage_plain(torch.from_numpy(x),
                           *hf._planes("rdft", n, False, CPU))
    assert _rel(got.numpy(), plain.numpy()) <= 1e-5
    want = np.asarray(pallas_fft._call_stage(
        x, jmx._dft_np(n, False, False)[:, :n // 2 + 1], None))
    assert _rel(got.numpy(), want) <= 5e-4


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("n", POW2)
def test_kernel2_mirror_matches_plain_and_jax(n, inverse):
    """Kernel 2's FFT body (the engine, no twiddle) against ``stage_plain``
    with the DFT planes and JAX's ``_call_stage``; M cycles through one
    row, an odd and an even count."""
    M = (1, 7, 4)[POW2.index(n) % 3]
    z = _complex((M, n), 5 * n + inverse)
    got = hf.fft_rows_mirror(torch.from_numpy(z), inverse)
    plain = hf.stage_plain(torch.from_numpy(z),
                           *hf._planes("dft", n, inverse, CPU))
    assert _rel(got.numpy(), plain.numpy()) <= 1e-5
    want = np.asarray(pallas_fft._call_stage(
        z, jmx._dft_np(n, inverse, False), None))
    assert _rel(got.numpy(), want) <= 5e-4


@pytest.mark.parametrize("n", POW2 + [2, 12, 257])
def test_cdft_rdft_on_cpu_equal_stage_plain(n):
    """On CPU tensors ``cdft`` / ``rdft`` are their plain versions exactly,
    whichever body ``_fft_body(n)`` names, and launch nothing."""
    hf.reset_launches()
    z = torch.from_numpy(_complex((3, n), n))
    x = torch.from_numpy(_real((5, n), n + 1))
    for inverse in (False, True):
        assert torch.equal(hf.cdft(z, inverse), hf.stage_plain(
            z, *hf._planes("dft", n, inverse, CPU)))
    assert torch.equal(hf.rdft(x), hf.stage_plain(
        x, *hf._planes("rdft", n, False, CPU)))
    assert all(v == 0 for v in hf.LAUNCHES.values()), hf.LAUNCHES


def _count_calls(monkeypatch, *names):
    """Record the calls of the named ``hopper_fft`` functions: name ->
    list of (shape of the first argument, the rest)."""
    calls = {name: [] for name in names}

    def wrap(name, orig):
        def counted(x2, *args):
            calls[name].append((tuple(x2.shape),) + args)
            return orig(x2, *args)
        return counted

    for name in names:
        monkeypatch.setattr(hf, name, wrap(name, getattr(hf, name)))
    return calls


@pytest.mark.parametrize("fn", ["fft", "ifft", "rfft"])
@pytest.mark.parametrize("n", POW2)
def test_power_of_two_axes_take_one_engine_launch(monkeypatch, n, fn):
    """A power of two up to 1024 goes straight to ``cdft`` / ``rdft`` (1024
    included), never to the four-step split, and on its engine body never
    through ``stage``'s planes."""
    calls = _count_calls(monkeypatch, "cdft", "rdft", "cdft_tw", "rdft_tw",
                         "stage")
    if fn == "rfft":
        x = _real((2, 3, n), n)
        want = np.fft.rfft(x.astype(np.float64))
    else:
        x = _complex((2, 3, n), n)
        want = (np.fft.ifft(x.astype(np.complex128)) * n if fn == "ifft"
                else np.fft.fft(x.astype(np.complex128)))
    got = getattr(hf, fn)(torch.from_numpy(x), axis=-1).numpy()
    assert _rel(got, want) <= 1e-5
    wrapper = "rdft" if fn == "rfft" else "cdft"
    args = () if fn == "rfft" else (fn == "ifft",)
    assert calls.pop(wrapper) == [((6, n),) + args]
    assert all(not v for v in calls.values()), calls


@pytest.mark.parametrize("fn", ["fft", "ifft", "rfft"])
@pytest.mark.parametrize("n", [2, 4, 12, 96, 257, 320])
def test_other_direct_axes_take_the_planes(monkeypatch, n, fn):
    """Any other length up to 512 also takes one ``cdft`` / ``rdft``, whose
    body is then ``stage`` with the DFT (or R2C) planes: the tile body, or
    the row body for a few points; ``cdft`` and ``rdft`` at a 13-smooth
    length (12, 96, 320) run the engine's mixed-radix kernel instead, whose
    plain version on the CPU is the product with the same planes, not
    through ``stage``."""
    calls = _count_calls(monkeypatch, "cdft", "rdft", "cdft_tw", "rdft_tw",
                         "stage")
    inverse = fn == "ifft"
    if fn == "rfft":
        x = _real((3, n), n)
        want = np.fft.rfft(x.astype(np.float64))
    else:
        x = _complex((3, n), n)
        want = (np.fft.ifft(x.astype(np.complex128)) * n if inverse
                else np.fft.fft(x.astype(np.complex128)))
    got = getattr(hf, fn)(torch.from_numpy(x), axis=-1).numpy()
    assert _rel(got, want) <= 1e-5
    assert hf._fft_body(n) == "tile"
    wrapper = "rdft" if fn == "rfft" else "cdft"
    assert len(calls.pop(wrapper)) == 1
    if hf._cdft_body(n) == "fft":
        assert n in hf.MIXED_LENGTHS and not calls.pop("stage")
        assert all(not v for v in calls.values()), calls
        return
    (stage_call,) = calls.pop("stage")
    k = n // 2 + 1 if fn == "rfft" else n
    assert stage_call[0] == (3, n) and stage_call[1].shape == (n, k)
    kind = "rdft" if fn == "rfft" else "dft"
    assert torch.equal(stage_call[1], hf._planes(kind, n, inverse, CPU)[0])
    assert all(not v for v in calls.values()), calls


def test_fft_body_routing():
    fft = [n for n in range(1, 2100) if hf._fft_body(n) == "fft"]
    assert fft == POW2
    for n in (1, 2, 4, 12, 257, 320, 520, 1021, 2048):
        assert hf._fft_body(n) == "tile"


def test_wrappers_check_their_arguments():
    with pytest.raises(ValueError):
        hf.rdft_tw(torch.zeros((2, 3, 8)), 2)               # not 2D rows
    with pytest.raises(ValueError):
        hf.rdft_tw(torch.zeros((4, 8)), 0)                  # n1 < 1
    with pytest.raises(TypeError):
        hf.rdft_tw(torch.zeros((4, 8), dtype=torch.float64), 2)
    with pytest.raises(ValueError):
        hf.rdft_tw(torch.zeros((8, 4)).t(), 2)              # not contiguous
    with pytest.raises(ValueError):
        hf.rdft_tw(torch.zeros((4, 8), device="meta"), 2)   # no kernel
    cplx = torch.zeros((4, 8), dtype=torch.complex64)
    with pytest.raises(ValueError):
        hf.cdft_tw(cplx[None], 2, False)                    # not 2D rows
    with pytest.raises(ValueError):
        hf.cdft_tw(cplx, 0, False)                          # n1 < 1
    with pytest.raises(TypeError):
        hf.cdft_tw(cplx.real.contiguous(), 2, False)        # not complex
    with pytest.raises(ValueError):
        hf.cdft_tw(torch.zeros((8, 4), dtype=torch.complex64).t(), 2, True)
    with pytest.raises(ValueError):
        hf.cdft_tw(cplx.to("meta"), 2, False)               # no kernel
    planes = torch.zeros((2, 4, 8), dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        hf.dec_cmatmul(planes.float(), False)
    with pytest.raises(ValueError):
        hf.dec_cmatmul(planes[:1], False)                   # not 2 planes
    raw = torch.zeros(65, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        hf._require_aligned("dec_cmatmul", raw[1:].view(2, 4, 8))
    hf._require_aligned("dec_cmatmul", raw[:64].view(2, 4, 8))


def test_cdft_rdft_check_their_arguments():
    cplx = torch.zeros((4, 8), dtype=torch.complex64)
    with pytest.raises(ValueError):
        hf.cdft(cplx[None], False)                          # not 2D rows
    with pytest.raises(TypeError):
        hf.cdft(cplx.real.contiguous(), False)              # not complex
    with pytest.raises(ValueError):
        hf.cdft(torch.zeros((8, 4), dtype=torch.complex64).t(), True)
    with pytest.raises(ValueError):
        hf.cdft(cplx.to("meta"), False)                     # no kernel
    with pytest.raises(ValueError):
        hf.rdft(torch.zeros((2, 3, 8)))                     # not 2D rows
    with pytest.raises(TypeError):
        hf.rdft(torch.zeros((4, 8), dtype=torch.float64))
    with pytest.raises(ValueError):
        hf.rdft(torch.zeros((8, 4)).t())                    # not contiguous
    with pytest.raises(ValueError):
        hf.rdft(torch.zeros((4, 8), device="meta"))         # no kernel


def test_cpu_wrappers_take_plain_versions_and_launch_nothing():
    hf.reset_launches()
    x = torch.from_numpy(_real((6, 64), 3))
    hf.rdft_tw(x, 3)
    hf.dec_cmatmul(hf.enc_pack_plain(torch.from_numpy(_complex((3, 64), 4))),
                   True)
    hf.cdft_tw(torch.from_numpy(_complex((6, 64), 5)), 2, True)
    assert all(v == 0 for v in hf.LAUNCHES.values()), hf.LAUNCHES


def test_rfft_last_takes_kernel5_through_rdft_tw(monkeypatch):
    """The 2048-point R2C (past the engine's 1024, so still split as 4 x
    512) takes its first four-step stage through ``rdft_tw`` with n1 = 4,
    and the whole axis still matches the JAX package."""
    calls = []
    orig = hf.rdft_tw

    def counted(x2, n1):
        calls.append((tuple(x2.shape), n1))
        return orig(x2, n1)

    monkeypatch.setattr(hf, "rdft_tw", counted)
    x = _real((3, 2048), 5)
    got = hf.rfft(torch.from_numpy(x), axis=-1).numpy()
    assert calls == [((12, 512), 4)]
    assert _rel(got, pallas_fft.rfft(x, axis=-1)) < 5e-4


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_fft_last_takes_kernel4_through_cdft_tw(monkeypatch, inverse):
    """The 2048-point C2C (still split as 4 x 512) takes its first
    four-step stage through ``cdft_tw`` with (rows, 512) and n1 = 4, and
    the whole axis still matches the JAX package."""
    calls = []
    orig = hf.cdft_tw

    def counted(x2, n1, inv):
        calls.append((tuple(x2.shape), n1, inv))
        return orig(x2, n1, inv)

    monkeypatch.setattr(hf, "cdft_tw", counted)
    x = _complex((3, 2048), 6 + inverse)
    if inverse:
        got = hf.ifft(torch.from_numpy(x), axis=-1).numpy()
        want = np.asarray(pallas_fft.ifft(x, axis=-1))
    else:
        got = hf.fft(torch.from_numpy(x), axis=-1).numpy()
        want = np.asarray(pallas_fft.fft(x, axis=-1))
    assert calls == [((12, 512), 4, inverse)]
    assert _rel(got, want) < 5e-4
