"""The port's single-device SlabFFTPlan against the JAX package's, on the
CPU.

Both plans are built from the same JAX objects (the port's through
``config_from_reference`` and its siblings) and fed the same seeded numpy
input. Tolerances: rel <= 5e-4 for ``"pallas"`` (the JAX kernels emulate
HIGH precision with bf16 products, the port computes in float32) and
rel <= 1e-5 for ``"xla"`` (both are float32 FFT libraries, summing in
different orders).
"""

import dataclasses

import numpy as np
import pytest
import torch

import distributedfft_tpu as jdfft
import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch.ops import hopper_fft as hf
from distributedfft_tpu_torch.params import CommMethod, SendMethod

TOL = {"pallas": 5e-4, "xla": 1e-5}
SHAPE = (6, 12, 15)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def _plans(shape, transform="r2c", sequence="ZY_Then_X", **cfg_kw):
    """(JAX plan, port plan) built from the same JAX objects."""
    g, part = jdfft.GlobalSize(*shape), jdfft.SlabPartition(1)
    cfg = jdfft.Config(**cfg_kw)
    jplan = jdfft.SlabFFTPlan(g, part, cfg, transform=transform,
                              sequence=sequence)
    tplan = tdfft.SlabFFTPlan(
        tdfft.global_size_from_reference(dataclasses.asdict(g)),
        tdfft.slab_partition_from_reference(dataclasses.asdict(part)),
        tdfft.config_from_reference(dataclasses.asdict(cfg)),
        transform=transform, device="cpu", sequence=sequence)
    return jplan, tplan


@pytest.mark.parametrize("norm", ["NONE", "ORTHO", "BACKWARD"])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_r2c_forward_and_roundtrip_match_reference(backend, norm):
    jplan, tplan = _plans(SHAPE, fft_backend=backend,
                          norm=jdfft.FFTNorm[norm])
    x = np.random.default_rng(7).standard_normal(SHAPE).astype(np.float32)
    tc = tplan.exec_r2c(x)
    assert tc.dtype == torch.complex64
    assert tuple(tc.shape) == tplan.output_shape == jplan.output_shape
    if norm == "BACKWARD":
        # The forward is NONE's (unnormalized); only the inverse differs,
        # so the reference's forward run is spared here.
        jc = tc.numpy()
    else:
        jc = np.asarray(jplan.exec_r2c(x))
        assert _rel(tc.numpy(), jc) <= TOL[backend]
    jb = np.asarray(jplan.exec_c2r(jc))
    tb = tplan.exec_c2r(tc)
    assert tb.dtype == torch.float32 and tuple(tb.shape) == SHAPE
    assert _rel(tb.numpy(), jb) <= TOL[backend]


@pytest.mark.parametrize("norm", ["NONE", "ORTHO"])
def test_c2c_matches_reference(norm):
    jplan, tplan = _plans(SHAPE, transform="c2c", norm=jdfft.FFTNorm[norm])
    rng = np.random.default_rng(8)
    x = (rng.standard_normal(SHAPE)
         + 1j * rng.standard_normal(SHAPE)).astype(np.complex64)
    jc = np.asarray(jplan.exec_c2c(x))
    tc = tplan.exec_c2c(x)
    assert _rel(tc.numpy(), jc) <= TOL["xla"]
    assert _rel(tplan.exec_c2c_inv(tc).numpy(),
                np.asarray(jplan.exec_c2c_inv(jc))) <= TOL["xla"]


def test_chunked_xla_path_matches_reference():
    jplan, tplan = _plans((8, 6, 10), fft3d_chunk=4)
    x = np.random.default_rng(9).standard_normal((8, 6, 10)).astype(np.float32)
    jc = np.asarray(jplan.exec_r2c(x))
    tc = tplan.exec_r2c(x)
    assert _rel(tc.numpy(), jc) <= TOL["xla"]
    assert _rel(tplan.exec_c2r(tc).numpy(),
                np.asarray(jplan.exec_c2r(jc))) <= TOL["xla"]


def test_shape_queries_and_helpers_match_reference():
    jplan, tplan = _plans(SHAPE)
    for attr in ("input_shape", "output_shape", "input_padded_shape",
                 "output_padded_shape", "transform_axes", "transform_size"):
        assert getattr(tplan, attr) == getattr(jplan, attr), attr
    assert tplan.in_sizes() == jplan.in_sizes()
    assert tplan.out_sizes() == jplan.out_sizes() == tplan.out_sizes("y")
    assert tplan.fft3d and jplan.fft3d
    x = np.random.default_rng(10).standard_normal(SHAPE).astype(np.float32)
    xi = tplan.pad_input(x)
    assert isinstance(xi, torch.Tensor) and xi.dtype == torch.float32
    c = tplan.exec_r2c(xi)
    assert np.array_equal(tplan.crop_spectral(c),
                          jplan.crop_spectral(c.numpy()))
    assert np.array_equal(tplan.crop_spectral(tplan.pad_spectral(c.numpy())),
                          c.numpy())
    r = tplan.exec_c2r(c)
    assert np.array_equal(tplan.crop_real(r), jplan.crop_real(r.numpy()))


def test_shape_and_transform_errors_match_reference():
    jplan, tplan = _plans(SHAPE)
    bad = np.zeros((6, 12, 14), np.float32)
    for plan in (jplan, tplan):
        with pytest.raises(ValueError):
            plan.exec_r2c(bad)
        with pytest.raises(ValueError):
            plan.exec_c2r(np.zeros((6, 12, 9), np.complex64))
        with pytest.raises(TypeError):
            plan.exec_c2c(bad)
        with pytest.raises(ValueError):
            plan.in_sizes("y")
        with pytest.raises(ValueError):
            plan.out_sizes("z")
    with pytest.raises(ValueError):
        tdfft.SlabFFTPlan(tdfft.GlobalSize(*SHAPE), tdfft.SlabPartition(1),
                          transform="c2r", device="cpu")
    _, tc2c = _plans(SHAPE, transform="c2c")
    with pytest.raises(TypeError):
        tc2c.exec_r2c(np.zeros(SHAPE, np.float32))


def _port_plan(shape=(8, 8, 8), p=1, transform="r2c", **kw):
    return tdfft.SlabFFTPlan(tdfft.GlobalSize(*shape), tdfft.SlabPartition(p),
                             tdfft.Config(**kw), transform=transform,
                             device="cpu")


@pytest.mark.parametrize("build, run", [
    (lambda: _port_plan(fft_backend="auto"), None),
    (lambda: _port_plan(fft_backend="matmul"), "r2c"),
    (lambda: _port_plan(fft_backend="bluestein"), "r2c"),
    (lambda: _port_plan(fft_backend="pallas", double_prec=True), "r2c"),
    (lambda: tdfft.SlabFFTPlan(tdfft.GlobalSize(8, 8, 8),
                               tdfft.SlabPartition(1), sequence="Y_Then_ZX",
                               device="cpu"), None),
    (lambda: _port_plan(p=2, opt=1), None),
    (lambda: _port_plan(p=2, comm_method=CommMethod.PEER2PEER,
                        send_method=SendMethod.STREAMS), None),
    (lambda: _port_plan(p=2, send_method=SendMethod.STREAMS), None),
    (lambda: _port_plan(p=2, overlap_subblocks=2), None),
])
def test_not_ported_boundaries_raise(build, run):
    """What the next slices port raises NotImplementedError instead of
    being computed some other way."""
    with pytest.raises(NotImplementedError):
        plan = build()
        if run == "r2c":
            plan.exec_r2c(np.zeros(plan.input_shape, np.float32))


@pytest.mark.parametrize("shape, transform, cfg_kw", [
    ((4, 4, 513), "r2c", {}),
    ((1, 8, 8), "r2c", {}),
    ((8, 8, 8), "r2c", {"fft3d_chunk": 2}),
    ((6, 12, 15), "c2c", {"norm": jdfft.FFTNorm.ORTHO}),
    ((2, 4, 1024), "r2c", {}),
    ((2, 1024, 6), "c2c", {}),
    ((2, 2, 2048), "r2c", {}),
])
def test_pallas_per_axis_cases_match_reference(shape, transform, cfg_kw):
    """Single-device "pallas" plans outside the fused path (an axis above
    512 or below 2, the chunked path, C2C) run the per-axis kernels, as
    the JAX plan does: a 1024-point axis in one launch of the engine where
    the JAX plan splits it, a 2048-point axis split in both."""
    jplan, tplan = _plans(shape, transform=transform, fft_backend="pallas",
                          **cfg_kw)
    rng = np.random.default_rng(11)
    x = rng.standard_normal(shape).astype(np.float32)
    if transform == "c2c":
        x = (x + 1j * rng.standard_normal(shape)).astype(np.complex64)
        jc, tc = np.asarray(jplan.exec_c2c(x)), tplan.exec_c2c(x)
        jb, tb = jplan.exec_c2c_inv(jc), tplan.exec_c2c_inv(tc)
    else:
        jc, tc = np.asarray(jplan.exec_r2c(x)), tplan.exec_r2c(x)
        jb, tb = jplan.exec_c2r(jc), tplan.exec_c2r(tc)
    assert tuple(tc.shape) == jc.shape == jplan.output_shape
    assert _rel(tc.numpy(), jc) <= TOL["pallas"]
    assert tuple(tb.shape) == shape
    assert _rel(tb.numpy(), np.asarray(jb)) <= TOL["pallas"]


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_single_device_z_then_yx_matches_reference(backend):
    """One rank of ``Z_Then_YX`` is the z-halved 3D transform, output
    decomposed over z, as in the JAX plan."""
    jplan, tplan = _plans(SHAPE, sequence="Z_Then_YX", fft_backend=backend)
    for attr in ("output_shape", "output_padded_shape"):
        assert getattr(tplan, attr) == getattr(jplan, attr), attr
    assert tplan.out_sizes("z") == jplan.out_sizes("z")
    x = np.random.default_rng(12).standard_normal(SHAPE).astype(np.float32)
    jc, tc = np.asarray(jplan.exec_r2c(x)), tplan.exec_r2c(x)
    assert _rel(tc.numpy(), jc) <= TOL[backend]
    assert _rel(tplan.exec_c2r(tc).numpy(),
                np.asarray(jplan.exec_c2r(jc))) <= TOL[backend]


def test_distributed_plan_needs_a_process_group():
    with pytest.raises(RuntimeError, match="maybe_initialize"):
        _port_plan(p=2)


def test_pallas_plan_on_cpu_launches_no_kernel():
    plan = _port_plan(fft_backend="pallas")
    hf.reset_launches()
    plan.exec_c2r(plan.exec_r2c(np.ones((8, 8, 8), np.float32)))
    assert all(v == 0 for v in hf.LAUNCHES.values()), hf.LAUNCHES
