"""Microbenchmarks of the ``reference`` executable — two of the JAX
package's ``testing/microbench.py``: the single-device 3D FFT baseline and
the slab transpose's bandwidth — and the pieces of the matmul backend's
four-step (``matmul_fourstep_ms``). The rest of the JAX module (the
autotuner's races, the fraction chain) is ROADMAP Queue 1 item 11.

On a CUDA device the single-device transform is timed with CUDA events;
the transpose, which spans ranks, with the host clock between barriers,
each rank ending on its own device's synchronize.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from ..ops import fft as lf
from ..parallel.transpose import all_to_all_transpose, peer_to_peer_transpose

def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mean_ms(fn, iterations: int, warmup: int, device: torch.device) -> float:
    """Mean ms of one call of ``fn`` over ``iterations`` back-to-back calls,
    after ``warmup``: CUDA events on a CUDA device, else the host clock."""
    for _ in range(warmup):
        fn()
    _sync(device)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iterations):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iterations
    t0 = time.perf_counter()
    for _ in range(iterations):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iterations


def single_device_fft_ms(shape, iterations: int = 10, warmup: int = 2,
                         dtype=np.float32, backend: str = "xla",
                         device: "str | torch.device" = "cuda") -> float:
    """Reference testcase 0: the full 3D R2C of ``shape = (nx, ny, nz)`` on
    one device through ``ops/fft.rfftn_3d`` under ``backend``, the input
    staged on the device once."""
    lf.validate_backend(backend)
    device = torch.device(device)
    x = torch.from_numpy(np.random.default_rng(0).random(tuple(shape))
                         .astype(dtype)).to(device)
    return _mean_ms(lambda: lf.rfftn_3d(x, backend=backend), iterations,
                    warmup, device)


def transpose_bandwidth(shape, p: int, explicit: bool = True,
                        iterations: int = 10, warmup: int = 2,
                        dtype=np.float32, group=None,
                        device: "str | torch.device" = "cuda") -> Dict:
    """The slab transpose's bandwidth over the ranks of ``group`` (the
    reference's 1D probe, ``tests_reference.hpp:53-96``): each rank holds
    its x-slab of a global ``shape`` of ones and the exchange leaves it a
    y-slab. ``explicit=True`` runs the all-to-all (All2All),
    ``False`` the point-to-point exchange to every peer (Peer2Peer).
    Every rank must call it. Returns the exchanged bytes (the global
    array), the mean seconds of one exchange, the rate and the collective
    calls the rendering makes. The 2D and 3D geometries transpose a pencil
    mesh (ROADMAP Queue 1, item 5)."""
    world = dist.get_world_size(group) if dist.is_initialized() else 1
    if p != world:
        raise ValueError(f"the probe runs over all {world} ranks, got p={p}")
    for ext in shape[:2]:
        if ext % p:
            raise ValueError(
                f"microbench extents must divide the ranks: {ext} % {p} "
                f"!= 0 (the plans pad uneven extents; this probe does not)")
    device = torch.device(device)
    x = torch.from_numpy(np.ones((shape[0] // p,) + tuple(shape[1:]),
                                 dtype=dtype)).to(device)
    exchange = all_to_all_transpose if explicit else peer_to_peer_transpose
    calls = (["all_to_all_single"] if explicit else ["isend", "irecv"])

    def run():
        if p > 1:
            exchange(x, group, 1, 0)

    for _ in range(warmup):
        run()
    _sync(device)
    if p > 1:
        dist.barrier(group)
    t0 = time.perf_counter()
    for _ in range(iterations):
        run()
    _sync(device)
    dt = (time.perf_counter() - t0) / iterations
    nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
    return {"seconds": dt, "bytes": nbytes, "gb_per_s": nbytes / dt / 1e9,
            "geometry": "1d", "collective_ops": calls if p > 1 else []}


def matmul_fourstep_ms(rows: int = 65536, iterations: int = 5,
                       warmup: int = 1,
                       device: "str | torch.device" = "cuda"
                       ) -> Dict[str, float]:
    """Mean ms of the matmul backend's four-step on ``rows`` complex128
    rows of 1024 = 2 x 512 points (1 GiB at the default), whole
    (``mxu_fft._fft_last``) and piece by piece in the two formulations of
    its products: the first (512-point) product over the swapped view, a
    batched product, or over a contiguous copy, one 2D product; the
    2-point second product over the swapped stage (a product of inner size
    2) or contracted where the stage lies (``F1 @ b``), which needs no
    swap back."""
    from ..ops import mxu_fft as mx
    device = torch.device(device)
    x = torch.randn(rows, 1024, dtype=torch.complex128, device=device)
    f512 = mx._const(("dft", 512, False, True), "c", device)
    f2 = mx._const(("dft", 2, False, True), "c", device)
    a = x.reshape(rows, 512, 2).transpose(-1, -2)
    ac = a.contiguous()
    b = torch.matmul(ac, f512)
    bt = b.transpose(-1, -2).contiguous()
    cases = {
        "whole": lambda: mx._fft_last(x, False),
        "first_product_over_the_view": lambda: torch.matmul(a, f512),
        "swap_copy": lambda: a.contiguous(),
        "first_product_2d": lambda: torch.matmul(
            ac.reshape(-1, 512), f512),
        "second_product_inner_2": lambda: torch.matmul(
            bt.reshape(-1, 2), f2),
        "second_product_in_place": lambda: torch.matmul(f2, b)}
    return {k: _mean_ms(fn, iterations, warmup, device)
            for k, fn in cases.items()}
