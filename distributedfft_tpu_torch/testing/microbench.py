"""Microbenchmarks of the ``reference`` executable — two of the JAX
package's ``testing/microbench.py``: the single-device 3D FFT baseline and
a global transpose's bandwidth in the reference's 1D, 2D and 3D exchange
geometries — and the pieces of the matmul backend's
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
                        device: "str | torch.device" = "cuda",
                        geometry: str = "1d") -> Dict:
    """A global transpose's bandwidth in the reference's three exchange
    geometries (``tests_reference.hpp:53-96``), over the ``p`` ranks of
    ``group`` (default: the world), on a global ``shape`` of ones:

    * ``"1d"``: the slab transpose: each rank's x-slab becomes a y-slab;
    * ``"2d"``: one axis of a 1 x p pencil grid: each rank's y-split block
      becomes z-split (the pencil's transpose 1);
    * ``"3d"``: the 2 x p/2 grid, x held split over p1 while y-split
      becomes z-split over p2: the exchange strided in two axes (p even
      and > 2).

    ``explicit=True`` runs the all-to-all (All2All), ``False`` the
    point-to-point exchange to every peer (Peer2Peer). Every rank must call
    it. Returns the exchanged bytes (the global array), the mean seconds
    of one exchange, the rate, the geometry and the collective calls the
    rendering makes."""
    world = dist.get_world_size(group) if dist.is_initialized() else 1
    if geometry == "1d":
        block = (shape[0] // p,) + tuple(shape[1:])
        split, concat, exts, q = 1, 0, shape[:2], p
    elif geometry in ("2d", "3d"):
        if geometry == "3d":
            if p % 2 or p <= 2:
                raise ValueError(
                    f"3d geometry needs an even device count > 2 to doubly "
                    f"shard (got p={p}); with p1=1 it would be the 2d probe "
                    f"mislabeled")
            if shape[0] % 2:
                raise ValueError("3d geometry needs shape[0] % 2 == 0")
        p1 = 2 if geometry == "3d" else 1
        q = p // p1
        block = (shape[0] // p1, shape[1] // q, shape[2])
        split, concat, exts = 2, 1, shape[1:]
    else:
        raise ValueError(f"geometry must be '1d'|'2d'|'3d', got {geometry!r}")
    if p != world:
        raise ValueError(f"the probe runs over all {world} ranks, got p={p}")
    for ext in exts:
        if ext % q:
            raise ValueError(
                f"microbench extents must divide the ranks: {ext} % {q} "
                f"!= 0 (the plans pad uneven extents; this probe does not)")
    xgroup = group
    if geometry != "1d" and p > 1:
        from ..parallel.mesh import make_pencil_groups
        xgroup = make_pencil_groups(p1, q)[0]    # this rank's row group
    device = torch.device(device)
    x = torch.from_numpy(np.ones(block, dtype=dtype)).to(device)
    exchange = all_to_all_transpose if explicit else peer_to_peer_transpose
    calls = (["all_to_all_single"] if explicit else ["isend", "irecv"])

    def run():
        if q > 1:
            exchange(x, xgroup, split, concat)

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
            "geometry": geometry, "collective_ops": calls if q > 1 else []}


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
