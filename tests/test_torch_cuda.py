"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test skips without a CUDA device. On a GPU machine
(which need not have JAX) run them without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Shapes cover the ragged edges of each kernel's tiling: odd and tiny axes,
axes that are not a multiple of any tile, and the 512 limit. Tolerance:
rel <= 5e-4, the JAX package's per-stage bound; kernel and plain version
both compute in float32, with sums taken in another order.
"""

import numpy as np
import pytest
import torch

import distributedfft_tpu_torch as dft
from distributedfft_tpu_torch.ops import hopper_fft as hf

pytestmark = pytest.mark.cuda

SHAPES = [(2, 2, 2), (8, 8, 8), (6, 12, 15), (16, 10, 12), (3, 17, 33),
          (65, 129, 66), (7, 512, 512), (512, 9, 511)]


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


@pytest.mark.parametrize("shape", SHAPES)
def test_zy_fwd_kernel(cuda, shape):
    x = _randn(shape, 1, cuda)
    X, Y, Z = shape
    before = hf.LAUNCHES["zy_fwd"]
    yr, yi = hf.zy_fwd(x)
    torch.cuda.synchronize()
    assert hf.LAUNCHES["zy_fwd"] == before + 1
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


@pytest.mark.parametrize("shape", SHAPES)
def test_yz_inv_kernel(cuda, shape):
    X, Y, Z = shape
    half = (X, Y, Z // 2 + 1)
    er, ei = _randn(half, 4, cuda), _randn(half, 5, cuda)
    y = hf.yz_inv(er, ei, Z)
    torch.cuda.synchronize()
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
    assert hf.LAUNCHES == {"zy_fwd": 1, "x_c2c": 2, "yz_inv": 1}
    assert _rel(c, torch.fft.rfftn(x)) <= 5e-4
    assert _rel(back / float(np.prod(shape)), x) <= 5e-4
