"""Chained workload timers for the BASELINE application configs — the JAX
package's ``testing/workloads.py`` on the port.

Each chain is a Python loop of plan executions fenced by ONE scalar
readback, the ``.item()`` of ``torch.sum(torch.abs(v))`` (summed over the
ranks on P ranks), where the JAX package jits a ``lax.fori_loop``:

* ``poisson_chain`` — BASELINE config #5 ("3D Poisson solve,
  FFT-diagonalized Laplacian"): forward R2C -> symbol multiply -> inverse
  C2R per iteration (``solvers/poisson.py``), iterating
  ``v <- solve(v + x)``: the add keeps a loop-carried dependency, and the
  iteration converges to the bounded fixed point ``(I - S)^-1 S x`` of
  the linear solve operator S (spectral radius <= 1 in integer mode);
* ``batched2d_chain`` — BASELINE config #4 ("Batched 2D FFT, 1D mesh"):
  forward + inverse of a ``(batch, nx, ny)`` stack per iteration,
  rescaled by ``1/(nx*ny)``;
* ``ns2d_chain`` — k RK4 Navier-Stokes-2D steps on a vorticity ensemble.

The chains run under ``torch.no_grad()``. Plans take ``device`` where the
JAX package takes ``mesh`` (on P ranks: a ``partition`` of P and the
world group, each rank passing its own block). ``serve_load``, the serve
layer's load generator, comes with the serve layer (ROADMAP Queue 1
item 14).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from .. import params as pm


def _fence(plan, v: torch.Tensor) -> float:
    """The one scalar readback: sum |v| over the whole array."""
    s = torch.sum(torch.abs(v), dtype=torch.float64)
    if not plan.fft3d:
        dist.all_reduce(s, op=dist.ReduceOp.SUM, group=plan.group)
    return s.item()


def poisson_chain(k: int, n: int, backend: str = "matmul",
                  partition: pm.SlabPartition | None = None,
                  device: "str | torch.device" = "cuda"):
    """A scalar-fenced chain of ``k`` Poisson solves at ``n^3`` float32.

    Returns ``(fn, plan)``; ``fn(x)`` takes the forcing as the plan's
    ``exec_r2c`` takes it and returns the float sum |v| after the chain."""
    from ..models.slab import SlabFFTPlan
    from ..solvers.poisson import PoissonSolver

    g = pm.GlobalSize(n, n, n)
    plan = SlabFFTPlan(g, partition or pm.SlabPartition(1),
                       pm.Config(fft_backend=backend), device=device)
    solver = PoissonSolver(plan, mode="integer")

    def fn(x) -> float:
        with torch.no_grad():
            x = torch.as_tensor(x, device=plan.device)
            v = x
            for _ in range(k):
                v = solver.solve(v + x)
            return _fence(plan, v)

    return fn, plan


def batched2d_chain(k: int, batch: int, nx: int, ny: int,
                    backend: str = "matmul",
                    partition: pm.SlabPartition | None = None,
                    shard: str = "batch", batch_chunk=None,
                    device: "str | torch.device" = "cuda"):
    """A scalar-fenced chain of ``k`` batched-2D R2C + C2R roundtrips.

    Returns ``(fn, plan)``; ``fn(x)`` takes a ``(batch, nx, ny)`` float32
    stack (this rank's block on P ranks)."""
    from ..models.batched2d import Batched2DFFTPlan

    plan = Batched2DFFTPlan(batch, nx, ny, partition or pm.SlabPartition(1),
                            pm.Config(fft_backend=backend), shard=shard,
                            batch_chunk=batch_chunk, device=device)
    scale = 1.0 / float(nx * ny)

    def fn(x) -> float:
        with torch.no_grad():
            v = torch.as_tensor(x, device=plan.device)
            for _ in range(k):
                v = plan.exec_inverse(plan.exec_forward(v)) * scale
            return _fence(plan, v)

    return fn, plan


def ns2d_chain(k: int, batch: int, n: int, dt: float = 1e-3,
               viscosity: float = 1e-3, backend: str = "matmul",
               partition: pm.SlabPartition | None = None,
               shard: str = "batch", device: "str | torch.device" = "cuda"):
    """A scalar-fenced chain of ``k`` RK4 Navier-Stokes-2D steps on a
    ``(batch, n, n)`` vorticity ensemble (``solvers/navier_stokes.py``):
    20 forward / inverse transforms a step (4 RHS evaluations x 5).

    Returns ``(fn, solver)`` with ``fn(w0)`` the float sum |ω| after k
    steps."""
    from ..models.batched2d import Batched2DFFTPlan
    from ..solvers.navier_stokes import NavierStokes2D

    plan = Batched2DFFTPlan(batch, n, n, partition or pm.SlabPartition(1),
                            pm.Config(fft_backend=backend), shard=shard,
                            device=device)
    solver = NavierStokes2D(plan, viscosity)

    def fn(w0) -> float:
        return _fence(plan, solver.run(w0, k, dt))

    return fn, solver


def flops_ns2d_step(batch: int, n: int) -> float:
    """Nominal FFT flops of ONE RK4 NS-2D step: 4 RHS evaluations x 5
    transforms, each a 2D transform of the stack (the elementwise work is
    O(N) and omitted)."""
    return 4 * 5 * 2.5 * batch * n * n * math.log2(float(n) * n)


def flops_roundtrip_3d(n: int) -> float:
    """R2C + C2R flops for an ``n^3`` volume: 2.5·N^3·log2(N^3) per
    direction (BASELINE.md §Derived)."""
    return 2 * 2.5 * n**3 * math.log2(float(n) ** 3)


def flops_poisson(n: int) -> float:
    """R2C + C2R per solve (the symbol multiply is O(N^3), negligible)."""
    return flops_roundtrip_3d(n)


def flops_batched2d(batch: int, nx: int, ny: int) -> float:
    """Forward + inverse 2D FFT flops for the whole stack."""
    return 2 * 2.5 * batch * nx * ny * math.log2(float(nx) * ny)


def serve_load(server, **kwargs) -> dict:
    """The serve layer's open-loop load generator: not ported with the
    solvers; it comes with the serve layer."""
    raise NotImplementedError(
        "workloads.serve_load drives the serve layer, which is not ported "
        "yet (ROADMAP Queue 1, item 14)")
