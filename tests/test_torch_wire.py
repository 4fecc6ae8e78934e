"""The port's wire layer and fused-wire kernels 9-11 (through their plain
versions on the CPU) against the JAX package, and the Config and schedule
helpers the ring reads.

* ``wire_encode`` / ``wire_decode`` and kernels 9 and 10
  (``enc_pack_plain`` / ``dec_unpack_plain``) are bit for bit JAX's
  ``wire_encode`` and its ``wire_encode_fused`` / ``wire_decode_fused``,
  called outside ``shard_map`` so that the Pallas kernels run in interpret
  mode, as ``tests/test_overlap.py`` does.
* Kernel 11 (``decode_fft_fused`` through ``dec_cmatmul_plain``) is within
  1e-4 of max of JAX's ``decode_fft_fused`` (the bound of
  ``tests/test_overlap.py``), every axis, both directions, every norm.
* ``fused_wire_for`` / ``fused_wire_active`` / ``resolved_*`` and
  ``ring_schedule`` equal the JAX ones over a grid of settings.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import distributedfft_tpu as jdfft
from distributedfft_tpu.ops import pallas_fft
from distributedfft_tpu.parallel import transpose as jtr

import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch.ops import hopper_fft as hf
from distributedfft_tpu_torch.parallel import transpose as ttr

BLOCK = (3, 32, 8)
DFT_TOL = 1e-4


def _complex_block(seed, shape=BLOCK, edges=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    if edges:
        # bf16 rounding ties, a value near the top of the range, and
        # subnormals.
        x[0, 0, :4] = [1 + 2 ** -8, 1 + 3 * 2 ** -9, -(1 + 2 ** -9), 3e38]
        x[1, 1, :2] = [1e-40, -2.5e-39]
    return x.astype(np.complex64)


def _f32(a):
    """bf16 planes (either package) as a float32 numpy array (exact)."""
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(a, np.float32)


def test_wire_encode_and_kernel9_plain_match_jax_bit_for_bit():
    x = _complex_block(1, edges=True)
    want = _f32(jtr.wire_encode(jnp.asarray(x), "bf16"))
    fused = _f32(pallas_fft.wire_encode_fused(jnp.asarray(x)))
    assert np.array_equal(fused, want)
    for got in (ttr.wire_encode(torch.from_numpy(x), "bf16"),
                hf.enc_pack_plain(torch.from_numpy(x)),
                hf.enc_pack(torch.from_numpy(x)),
                hf.wire_encode_fused(torch.from_numpy(x))):
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2,) + BLOCK
        assert np.array_equal(_f32(got), want)


def test_kernel9_reads_a_strided_chunk():
    """A chunk of the split axis, as the ring sends it: a strided view."""
    x = torch.from_numpy(_complex_block(2, (4, 12, 5)))
    chunk = x.narrow(1, 6, 3)
    assert not chunk.is_contiguous()
    assert torch.equal(hf.enc_pack(chunk), hf.enc_pack_plain(
        chunk.contiguous()))


def test_wire_decode_and_kernel10_plain_match_jax_bit_for_bit():
    x = _complex_block(3, edges=True)
    enc = jtr.wire_encode(jnp.asarray(x), "bf16")
    want = np.asarray(jtr.wire_decode(enc, np.complex64, "bf16"))
    assert np.array_equal(
        np.asarray(pallas_fft.wire_decode_fused(enc, np.complex64)), want)
    planes = torch.from_numpy(_f32(enc)).to(torch.bfloat16)
    for got in (ttr.wire_decode(planes, torch.complex64, "bf16"),
                hf.dec_unpack_plain(planes), hf.dec_unpack(planes),
                hf.wire_decode_fused(planes, torch.complex64)):
        assert got.dtype == torch.complex64 and np.array_equal(got.numpy(),
                                                               want)


def test_native_wire_passes_through():
    x = torch.from_numpy(_complex_block(4))
    assert ttr.wire_encode(x, "native") is x
    assert ttr.wire_decode(x, torch.complex64, "native") is x
    r = torch.ones(3)
    assert ttr.wire_encode(r, "bf16") is r
    with pytest.raises(ValueError):
        ttr.wire_encode(x, "auto")


@pytest.mark.parametrize("norm", ["NONE", "ORTHO", "BACKWARD"])
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_decode_dft_kernel11_plain_matches_jax(axis, inverse, norm):
    x = _complex_block(10 + axis)
    enc = jtr.wire_encode(jnp.asarray(x), "bf16")
    want = np.asarray(pallas_fft.decode_fft_fused(
        enc, np.complex64, axis, inverse=inverse,
        norm=jdfft.FFTNorm[norm]))
    planes = torch.from_numpy(_f32(enc)).to(torch.bfloat16)
    got = hf.decode_fft_fused(planes, torch.complex64, axis, inverse=inverse,
                              norm=tdfft.FFTNorm[norm]).numpy()
    assert got.shape == want.shape == BLOCK
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) <= DFT_TOL


def test_kernel11_plain_is_decode_then_dense_dft():
    planes = torch.from_numpy(_f32(jtr.wire_encode(
        jnp.asarray(_complex_block(5, (7, 6))), "bf16"))).to(torch.bfloat16)
    got = hf.dec_cmatmul(planes, False)
    want = np.fft.fft(hf.dec_unpack_plain(planes).numpy().astype(np.complex128),
                      axis=-1)
    assert np.max(np.abs(got.numpy() - want)) / np.max(np.abs(want)) <= 1e-5


def test_wire_wrappers_reject_what_the_kernels_do_not_take():
    planes = torch.zeros((2, 4, 6), dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        hf.enc_pack(torch.zeros(4, 6))                       # not complex
    with pytest.raises(ValueError):
        hf.enc_pack(torch.zeros((2, 2, 2, 2), dtype=torch.complex64))
    with pytest.raises(TypeError):
        hf.dec_unpack(planes.float())
    with pytest.raises(ValueError):
        hf.dec_unpack(torch.zeros((3, 4), dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        hf.dec_cmatmul(planes.reshape(2, 24), False)         # not (2, M, n)
    with pytest.raises(ValueError):
        hf.dec_cmatmul(planes[:, :, :0], False)              # n = 0
    with pytest.raises(ValueError):
        hf.dec_unpack(planes.transpose(1, 2))                # not contiguous


def test_decode_dft_takes_the_matmul_backend_past_the_kernel():
    """Past ``N_MAX`` points, or into complex128, the fused arrival decodes
    plainly and runs the matmul backend's DFT, as
    ``pallas_fft.decode_fft_fused`` does: no kernel, one dispatch each,
    within 5e-4 (float32) and 1e-11 (complex128) of the JAX package."""
    planes = torch.from_numpy(np.random.default_rng(43).standard_normal(
        (2, 2, 1031)).astype(np.float32)).to(torch.bfloat16)
    jplanes = jnp.asarray(planes.float().numpy()).astype(jnp.bfloat16)
    hf.reset_launches()
    for cut, dtype, jdtype, tol, inverse in (
            (1031, torch.complex64, jnp.complex64, 5e-4, False),
            (8, torch.complex128, jnp.complex128, 1e-11, True)):
        got = hf.decode_fft_fused(planes[:, :, :cut], dtype, 1,
                                  inverse=inverse)
        ref = np.asarray(pallas_fft.decode_fft_fused(
            jplanes[:, :, :cut], jdtype, 1, inverse=inverse))
        assert got.dtype == dtype and got.shape == ref.shape
        err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
        assert err < tol
    assert hf.DISPATCHES == {"matmul": 2}
    assert not any(hf.LAUNCHES.values())


def test_fused_ring_hooks_route_by_setting_and_dtype():
    on = tdfft.Config(send_method=tdfft.SendMethod.RING_OVERLAP,
                      wire_dtype="bf16", fused_wire=True)
    enc_fn, arr_fn = hf.fused_ring_hooks(on)
    assert enc_fn is hf.wire_encode_fused and arr_fn is not None
    x = torch.from_numpy(_complex_block(6))
    assert torch.equal(arr_fn(enc_fn(x)), hf.dec_unpack_plain(
        hf.enc_pack_plain(x)))
    # The plain wire layer: fused wire off, not on a ring, or a
    # double-precision plan (the wire kernels take single precision).
    for cfg in (dataclasses.replace(on, fused_wire=False),
                dataclasses.replace(on, send_method=tdfft.SendMethod.SYNC),
                dataclasses.replace(on, wire_dtype="native"),
                dataclasses.replace(on, double_prec=True)):
        assert hf.fused_ring_hooks(cfg) == (None, None)
    assert hf.fused_ring_hooks(dataclasses.replace(
        on, send_method=tdfft.SendMethod.SYNC),
        snd=tdfft.SendMethod.RING)[0] is hf.wire_encode_fused
    # A double-precision payload takes the plain formulas, by dtype.
    x64 = x.to(torch.complex128)
    assert torch.equal(hf.wire_encode_fused(x64), ttr.wire_encode(x64))
    y = ttr.wire_encode(x64)
    assert torch.equal(hf.wire_decode_fused(y, torch.complex128),
                       ttr.wire_decode(y, torch.complex128))


_GRID = list(itertools.product(
    ["Sync", "Streams", "Ring", "RingOverlap"], [None, "Ring", "Sync"],
    ["native", "bf16"], [False, True], ["auto", 2, 5], [None, 1, 3],
    [None, 0.1]))


@pytest.mark.parametrize("chunk", range(8))
def test_config_helpers_match_jax(chunk):
    for snd, snd2, wire, fused, depth, sub, budget in _GRID[chunk::8]:
        jcfg = jdfft.Config(
            send_method=jdfft.SendMethod(snd),
            send_method2=None if snd2 is None else jdfft.SendMethod(snd2),
            wire_dtype=wire, fused_wire=fused, overlap_depth=depth,
            overlap_subblocks=sub, wire_error_budget=budget)
        tcfg = tdfft.config_from_reference(dataclasses.asdict(jcfg))
        assert tcfg.resolved_snd2().value == jcfg.resolved_snd2().value
        assert tcfg.resolved_overlap_depth() == jcfg.resolved_overlap_depth()
        assert tcfg.resolved_overlap_subblocks() == \
            jcfg.resolved_overlap_subblocks()
        assert tcfg.resolved_wire_budget() == jcfg.resolved_wire_budget()
        for second in (False, True):
            assert tcfg.fused_wire_active(second) == \
                jcfg.fused_wire_active(second)
        for s in tdfft.SendMethod:
            js = jdfft.SendMethod(s.value)
            assert tcfg.fused_wire_for(s) == jcfg.fused_wire_for(js)
            assert s.is_ring == js.is_ring


@pytest.mark.parametrize("shape, dtype, p", [
    ((256, 256, 129), "complex64", 8), ((12, 20, 6), "complex64", 4),
    ((10, 8, 9), "complex128", 4), ((16, 16, 9), "float32", 2),
    ((7, 5, 3), "complex64", 1)])
def test_ring_schedule_matches_jax(shape, dtype, p):
    for wire, overlap, depth, sub in itertools.product(
            ["native", "bf16"], [False, True], [1, 2, 3, 8], [1, 2, 5]):
        want = jtr.ring_schedule(shape, np.dtype(dtype), wire, p,
                                 overlap=overlap, depth=depth, subblocks=sub)
        got = ttr.ring_schedule(shape, getattr(torch, dtype), wire, p,
                                overlap=overlap, depth=depth, subblocks=sub)
        assert got == want, (wire, overlap, depth, sub)
    assert ttr.wire_nbytes(shape, getattr(torch, dtype), "bf16") == \
        jtr.wire_nbytes(shape, np.dtype(dtype), "bf16")


@pytest.mark.parametrize("ext", [1, 2, 5, 9, 64])
def test_chunk_helpers_match_jax(ext):
    for k in (1, 2, 3, 4, 100):
        assert ttr.chunk_slices(ext, k) == jtr.chunk_slices(ext, k)
        assert ttr.ring_subblocks(ext, k) == jtr.ring_subblocks(ext, k)
    x = torch.arange(ext * 3).reshape(3, ext)
    pieces = ttr.split_axis_chunks(x, 1, 3)
    assert torch.equal(ttr.concat_axis_chunks(pieces, 1), x)
    assert ttr.concat_axis_chunks([x], 1) is x


def test_ring_arguments_are_checked():
    x = torch.zeros((4, 4, 4), dtype=torch.complex64)
    for kw in (dict(depth=0), dict(overlap=True, depth=1), dict(subblocks=0)):
        with pytest.raises(ValueError):
            ttr.ring_transpose(x, None, 1, 0, **kw)
    with pytest.raises(ValueError):
        ttr.ring_schedule((4, 4, 4), torch.complex64, "native", 2, depth=0)
