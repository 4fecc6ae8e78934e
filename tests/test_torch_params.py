"""The port's parameter model and DFT constants against the JAX package's.

Config fields and defaults, enum values, validation, the reference-object
conversion (``config_from_reference`` and siblings), the extent
arithmetic, and bit-identity of the numpy DFT constants.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributedfft_tpu import params as jp
from distributedfft_tpu.ops import mxu_fft as jmx
from distributedfft_tpu.utils import native_planner as jnp_planner
from distributedfft_tpu_torch import params as tp
from distributedfft_tpu_torch.ops import mxu_fft as tmx
from distributedfft_tpu_torch.utils import native_planner as tnp_planner


def _plain(v):
    return getattr(v, "value", v)


def _values(cfg):
    return {k: _plain(v) for k, v in dataclasses.asdict(cfg).items()}


def test_config_fields_and_defaults_match():
    jf = [(f.name, _plain(f.default)) for f in dataclasses.fields(jp.Config)]
    tf = [(f.name, _plain(f.default)) for f in dataclasses.fields(tp.Config)]
    assert tf == jf
    assert _values(tp.Config()) == _values(jp.Config())


@pytest.mark.parametrize("enum", ["CommMethod", "SendMethod", "FFTNorm",
                                  "SlabSequence"])
def test_enum_values_match(enum):
    assert ([(m.name, m.value) for m in getattr(tp, enum)]
            == [(m.name, m.value) for m in getattr(jp, enum)])


REFERENCE_CONFIGS = [
    {},
    {"fft_backend": "pallas"},
    {"fft_backend": "xla", "norm": "ORTHO", "double_prec": True},
    {"comm_method": "PEER2PEER", "send_method": "RING_OVERLAP",
     "comm_method2": "ALL2ALL", "send_method2": "STREAMS", "opt": 1},
    {"norm": "BACKWARD", "fft3d_chunk": 4, "overlap_depth": 4,
     "overlap_subblocks": 2, "wire_dtype": "bf16", "wire_error_budget": 0.1,
     "fused_wire": True, "guards": "CHECK", "mxu_precision": "high",
     "mxu_direct_max": 256, "streams_chunks": 3},
]


def _jax_config(kw):
    enums = {"comm_method": jp.CommMethod, "comm_method2": jp.CommMethod,
             "send_method": jp.SendMethod, "send_method2": jp.SendMethod,
             "norm": jp.FFTNorm}
    return jp.Config(**{k: enums[k][v] if k in enums else v
                        for k, v in kw.items()})


@pytest.mark.parametrize("kw", REFERENCE_CONFIGS)
def test_config_from_reference_round_trips(kw):
    jcfg = _jax_config(kw)
    d = dataclasses.asdict(jcfg)
    cfg = tp.config_from_reference(d)
    assert isinstance(cfg, tp.Config)
    assert _values(cfg) == _values(jcfg)
    # enums given as their .value strings convert the same way
    assert tp.config_from_reference({k: _plain(v) for k, v in d.items()}) == cfg
    assert tp.config_from_reference(dataclasses.asdict(cfg)) == cfg


@pytest.mark.parametrize("field", ["fft_backend", "comm_method",
                                   "comm_method2", "wire_dtype"])
def test_config_from_reference_refuses_auto(field):
    d = dataclasses.asdict(jp.Config(**{field: jp.AUTO}))
    with pytest.raises(NotImplementedError):
        tp.config_from_reference(d)


@pytest.mark.parametrize("kw", [
    {"fft_backend": "cufft"}, {"comm_method": "All2All"},
    {"comm_method2": "bogus"}, {"mxu_precision": "fast"},
    {"fft3d_chunk": 0}, {"mxu_direct_max": -1}, {"streams_chunks": 0},
    {"overlap_depth": 1}, {"overlap_depth": "deep"},
    {"overlap_subblocks": 0}, {"wire_dtype": "fp8"},
    {"wire_error_budget": 0}, {"fused_wire": 1}, {"guards": "loud"},
])
def test_config_validation_matches(kw):
    with pytest.raises(ValueError):
        jp.Config(**kw)
    with pytest.raises(ValueError):
        tp.Config(**kw)


def test_sizes_and_partitions_from_reference():
    g = jp.GlobalSize(6, 12, 15)
    tg = tp.global_size_from_reference(dataclasses.asdict(g))
    assert (tg.shape, tg.nz_out, tg.ny_out, tg.n_total) == (
        g.shape, g.nz_out, g.ny_out, g.n_total)
    sp = tp.slab_partition_from_reference(
        dataclasses.asdict(jp.SlabPartition(3)))
    assert sp.num_ranks == 3
    assert tp.PencilPartition(2, 3).num_ranks == 6
    pd, jpd = tp.PartitionDims((3, 2), (5,), (1, 1, 1)), \
        jp.PartitionDims((3, 2), (5,), (1, 1, 1))
    assert (pd.start_x, pd.start_y, pd.start_z) == (
        jpd.start_x, jpd.start_y, jpd.start_z)
    for bad in [dict(nx=0, ny=1, nz=1), dict(nx=1.5, ny=1, nz=1)]:
        with pytest.raises(ValueError):
            tp.GlobalSize(**bad)
    with pytest.raises(ValueError):
        tp.SlabPartition(0)
    with pytest.raises(ValueError):
        tp.PencilPartition(1, 0)


@pytest.mark.parametrize("n, p", [(0, 1), (7, 1), (7, 3), (12, 4), (5, 8),
                                  (257, 8), (513, 6)])
def test_extent_arithmetic_matches(n, p):
    assert tnp_planner.block_sizes(n, p) == jnp_planner.block_sizes(n, p)
    sizes = jnp_planner.block_sizes(n, p)
    assert tnp_planner.block_starts(sizes) == jnp_planner.block_starts(sizes)
    pad = jnp_planner.padded_extent(n, p)
    assert tnp_planner.padded_extent(n, p) == pad
    assert tnp_planner.even_shard_sizes(n, pad, p) == \
        jnp_planner.even_shard_sizes(n, pad, p)


def test_extent_arithmetic_rejects_what_the_reference_rejects():
    for fn, args in [("block_sizes", (4, 0)), ("block_sizes", (-1, 2)),
                     ("padded_extent", (4, 0)),
                     ("even_shard_sizes", (4, 4, 0))]:
        with pytest.raises(ValueError):
            getattr(jnp_planner, fn)(*args)
        with pytest.raises(ValueError):
            getattr(tnp_planner, fn)(*args)


def _same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and \
        np.array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("n", [2, 3, 7, 8, 15, 257, 512])
@pytest.mark.parametrize("double", [False, True])
def test_dft_constants_bit_identical(n, double):
    for inverse in (False, True):
        assert _same_bits(tmx._dft_np(n, inverse, double),
                          jmx._dft_np(n, inverse, double))
    cr, ci = tmx._c2r_np(n, double)
    jcr, jci = jmx._c2r_np(n, double)
    assert _same_bits(cr, jcr) and _same_bits(ci, jci)


@pytest.mark.parametrize("n1, n2", [(2, 3), (4, 128), (8, 512), (5, 7)])
def test_twiddle_constants_bit_identical(n1, n2):
    for inverse in (False, True):
        for double in (False, True):
            assert _same_bits(tmx._twiddle_np(n1, n2, inverse, double),
                              jmx._twiddle_np(n1, n2, inverse, double))


def test_scales_and_direct_max_match():
    assert tmx.DIRECT_MAX == jmx.DIRECT_MAX
    for n in (1, 7, 512):
        for name in ("NONE", "ORTHO", "BACKWARD"):
            assert tmx._fwd_scale(n, tp.FFTNorm[name]) == \
                jmx._fwd_scale(n, jp.FFTNorm[name])
            assert tmx._inv_scale(n, tp.FFTNorm[name]) == \
                jmx._inv_scale(n, jp.FFTNorm[name])
    assert tmx._is_double(torch.float64) and tmx._is_double(torch.complex128)
    assert not tmx._is_double(torch.float32)
    assert not tmx._is_double(torch.complex64)


@pytest.mark.parametrize("axis, n", [(-1, 3), (-1, 9), (0, 2), (1, 7)])
def test_fit_axis_matches(axis, n):
    c = (np.random.default_rng(3).standard_normal((4, 5, 6))
         + 1j).astype(np.complex64)
    got = tmx._fit_axis(torch.from_numpy(c), axis, n).numpy()
    ref = np.asarray(jmx._fit_axis(jnp.asarray(c), axis, n))
    assert got.shape == ref.shape and np.array_equal(got, ref)


@pytest.mark.parametrize("n", [6, 7, 8])
def test_hermitian_extend_matches(n):
    c = (np.random.default_rng(4).standard_normal((3, n // 2 + 1))
         + 1j * np.random.default_rng(5).standard_normal((3, n // 2 + 1))
         ).astype(np.complex64)
    got = tmx._hermitian_extend(torch.from_numpy(c), n).numpy()
    ref = np.asarray(jmx._hermitian_extend(jnp.asarray(c), n))
    assert got.shape == ref.shape and np.array_equal(got, ref)
