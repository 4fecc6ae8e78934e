"""The host side of the row FFT engine of kernels 4, 5 and 11
(``csrc/fft_rows.cuh``), on the CPU.

* ``fft_plan(n, inverse)``: the pass schedule and the twiddle table the
  kernel consumes, for every power of two 8..1024.
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
  JAX ``_call_stage`` with the twiddle; ``fft`` of a 1024-point axis
  reaching ``cdft_tw``.
* ``_fft_body``'s routing and the new wrappers' argument checks.
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
    assert [(plan.schedule >> (4 * p)) & 15 for p in range(len(plan.radices))] \
        == [int(math.log2(r)) for r in plan.radices]
    assert plan.schedule >> (4 * len(plan.radices)) == 0
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
    assert hf.fft_plan(1024, False).schedule == 0x334
    for n in (4, 12, 520, 2048):
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


def test_cpu_wrappers_take_plain_versions_and_launch_nothing():
    hf.reset_launches()
    x = torch.from_numpy(_real((6, 64), 3))
    hf.rdft_tw(x, 3)
    hf.dec_cmatmul(hf.enc_pack_plain(torch.from_numpy(_complex((3, 64), 4))),
                   True)
    hf.cdft_tw(torch.from_numpy(_complex((6, 64), 5)), 2, True)
    assert all(v == 0 for v in hf.LAUNCHES.values()), hf.LAUNCHES


def test_rfft_last_takes_kernel5_through_rdft_tw(monkeypatch):
    """The 1024-point R2C's first four-step stage goes through ``rdft_tw``
    with n1 = 2, and the whole axis still matches the JAX package."""
    calls = []
    orig = hf.rdft_tw

    def counted(x2, n1):
        calls.append((tuple(x2.shape), n1))
        return orig(x2, n1)

    monkeypatch.setattr(hf, "rdft_tw", counted)
    x = _real((3, 1024), 5)
    got = hf.rfft(torch.from_numpy(x), axis=-1).numpy()
    assert calls == [((6, 512), 2)]
    assert _rel(got, pallas_fft.rfft(x, axis=-1)) < 5e-4


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_fft_last_takes_kernel4_through_cdft_tw(monkeypatch, inverse):
    """The 1024-point C2C's first four-step stage goes through ``cdft_tw``
    with (rows, 512) and n1 = 2, and the whole axis still matches the JAX
    package."""
    calls = []
    orig = hf.cdft_tw

    def counted(x2, n1, inv):
        calls.append((tuple(x2.shape), n1, inv))
        return orig(x2, n1, inv)

    monkeypatch.setattr(hf, "cdft_tw", counted)
    x = _complex((3, 1024), 6 + inverse)
    if inverse:
        got = hf.ifft(torch.from_numpy(x), axis=-1).numpy()
        want = np.asarray(pallas_fft.ifft(x, axis=-1))
    else:
        got = hf.fft(torch.from_numpy(x), axis=-1).numpy()
        want = np.asarray(pallas_fft.fft(x, axis=-1))
    assert calls == [((6, 512), 2, inverse)]
    assert _rel(got, want) < 5e-4
