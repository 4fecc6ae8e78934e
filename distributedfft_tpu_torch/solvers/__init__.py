"""``solvers/`` — the spectral applications on the port's plans (the JAX
package's ``solvers/``, without ``driver.py``: ROADMAP Queue 1 item 14).

Every solver drives plans through the solver protocol of
``models/base.py`` (``exec_fwd`` / ``exec_inv``, ``forward_fn`` /
``inverse_fn``, ``transform_axes``, ``spectral_halved_axis``), so it runs
on slab, pencil and batched-2D plans unchanged:

* :class:`PoissonSolver` — FFT-diagonalized ∇²u = f; periodic, Dirichlet
  and Neumann boxes (through the R2R extensions);
* :class:`NavierStokes2D` / :class:`NavierStokes3D` — pseudo-spectral
  incompressible Navier-Stokes (RK4, 2/3-rule dealiasing),
  differentiable end to end;
* :class:`SpectralConvolver` — large-kernel linear convolution /
  correlation (image batches on the batched-2D plan, volumes on slab and
  pencil plans);
* ``dct`` / ``dst`` (``idct`` / ``idst`` / ``dctn`` / ``dstn``) — scipy's
  real-to-real transforms through the R2C layer (``solvers/r2r.py``).

``make_solver(kind, plan, ...)`` is the one entry point. On P ranks every
solver takes and returns this rank's blocks, or global inputs where a
module docstring says so (the port's block convention).
"""

from __future__ import annotations

from . import r2r
from .convolve import SpectralConvolver, conv_shape, make_convolver
from .navier_stokes import (NavierStokes2D, NavierStokes3D, taylor_green_2d,
                            taylor_green_3d)
from .poisson import PoissonSolver
from .r2r import dct, dctn, dst, dstn, idct, idst

_KINDS = ("poisson", "navier_stokes", "convolve")


def make_solver(kind: str, plan, **kwargs):
    """Build a solver of ``kind`` over ``plan``:

    * ``"poisson"`` -> :class:`PoissonSolver` (``lengths``, ``mode``,
      ``bc``);
    * ``"navier_stokes"`` -> :class:`NavierStokes2D` or
      :class:`NavierStokes3D` by the plan's ``transform_axes`` rank
      (``viscosity`` required, ``lengths``);
    * ``"convolve"`` -> :class:`SpectralConvolver` (``kernel`` and
      ``image_shape`` required, ``mode``, ``correlate``)."""
    key = str(kind).strip().lower().replace("-", "_")
    if key == "poisson":
        return PoissonSolver(plan, **kwargs)
    if key in ("navier_stokes", "ns"):
        if "viscosity" not in kwargs:
            raise TypeError("make_solver('navier_stokes', ...) requires "
                            "viscosity=")
        nd = len(tuple(plan.transform_axes))
        cls = {2: NavierStokes2D, 3: NavierStokes3D}.get(nd)
        if cls is None:
            raise ValueError(f"no Navier-Stokes solver for a {nd}D-transform "
                             "plan")
        return cls(plan, **kwargs)
    if key == "convolve":
        if "kernel" not in kwargs or "image_shape" not in kwargs:
            raise TypeError("make_solver('convolve', ...) requires kernel= "
                            "and image_shape=")
        return SpectralConvolver(plan, kwargs.pop("kernel"),
                                 kwargs.pop("image_shape"), **kwargs)
    raise ValueError(f"unknown solver kind {kind!r} (choose from {_KINDS})")


__all__ = [
    "NavierStokes2D", "NavierStokes3D", "PoissonSolver",
    "SpectralConvolver", "conv_shape", "dct", "dctn", "dst", "dstn",
    "idct", "idst", "make_convolver", "make_solver", "taylor_green_2d",
    "taylor_green_3d",
]
