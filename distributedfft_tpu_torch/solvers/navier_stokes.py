"""Pseudo-spectral incompressible Navier-Stokes on the port's plans — the
JAX package's ``solvers/navier_stokes.py`` on ``torch``.

Every right-hand side is a burst of forward / inverse transforms through
the plan's differentiable pipelines (``forward_fn`` / ``inverse_fn``), and
``backward`` through an N-step solve is the strongest check the port can
put on them: its exchanges are autograd Functions whose backward is the
inverse exchange, posted by every rank in one order.

* :class:`NavierStokes2D` — vorticity form on a ``Batched2DFFTPlan`` (the
  batch axis an ensemble of independent flows)::

      dω/dt + u·∇ω = ν ∇²ω,      u = ∂ψ/∂y, v = -∂ψ/∂x, ω = -∇²ψ;

  each RHS is 4 inverse and 1 forward transforms.
* :class:`NavierStokes3D` — rotational (Lamb) velocity form on a slab or
  pencil plan::

      du/dt = u × ω - ∇Π + ν ∇²u,   ω = ∇ × u,   ∇·u = 0,

  the pressure eliminated by the Leray projection P(k) = I - k kᵀ/k²;
  each RHS is 6 inverse and 3 forward transforms.

Both integrate with classic RK4 in spectral space and apply the 2/3-rule
dealiasing mask to the nonlinear term. The wavenumbers and the mask come
from 1D per-axis vectors on the plan's padded spectral grid (zeros in pad
lanes), as in the JAX package; each rank cuts them to its own spectral
block (``plan.local_slices(output=True)``), and the solver keeps, on the
plan's device, the 1D vectors and three dense real arrays of that block
built once: ν k², 1 / k² and the mask (extent 1 along a batch axis).
Where JAX has ``lax.scan`` the port has a Python loop; ``run`` executes
under ``torch.no_grad()``. ``diagnostics`` all-reduces its per-rank sums
(SUM) over the plan's group(s), so every rank reads the same energy and
enstrophy.

On P ranks the physical fields are this rank's padded blocks (the input
``forward_fn`` takes; ``to_spectral`` also cuts a global field with
``plan.pad_input``), the spectra its spectral blocks.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import params as pm
from .poisson import _plan_dtypes, bcast, input_block, local_vectors


def signed_wavenumbers(plan, lengths: Sequence[float]) -> List[np.ndarray]:
    """Per-array-axis SIGNED wavenumber vector k = 2π m / L on the plan's
    padded (global) spectral grid (numpy's fftfreq fold; the halved axis
    carries the non-negative half), zero in pad lanes and along pure batch
    axes."""
    shape = plan.output_padded_shape
    dims = plan.input_shape
    axes = tuple(plan.transform_axes)
    halved = plan.spectral_halved_axis
    rt, _ = _plan_dtypes(plan)
    ks = []
    for ax in range(len(dims)):
        k = np.zeros(shape[ax])
        if ax in axes:
            n = dims[ax]
            scale = 2 * np.pi / float(lengths[ax])
            if ax == halved:
                k[: n // 2 + 1] = np.arange(n // 2 + 1) * scale
            else:
                k[:n] = np.fft.fftfreq(n) * n * scale
        ks.append(k.astype(rt))
    return ks


def dealias_vectors(plan) -> List[np.ndarray]:
    """Per-array-axis 2/3-rule keep-mask vector on the padded spectral
    grid: 1.0 where the integer mode |m| <= n//3, 0.0 above and in the pad
    lanes; all-ones along pure batch axes but their pad lanes."""
    shape = plan.output_padded_shape
    dims = plan.input_shape
    axes = tuple(plan.transform_axes)
    halved = plan.spectral_halved_axis
    rt, _ = _plan_dtypes(plan)
    vecs = []
    for ax in range(len(dims)):
        v = np.zeros(shape[ax])
        n = dims[ax]
        if ax in axes:
            cut = n // 3
            if ax == halved:
                m = np.arange(n // 2 + 1, dtype=np.float64)
                v[: n // 2 + 1] = (m <= cut).astype(np.float64)
            else:
                m = np.abs(np.fft.fftfreq(n) * n)
                v[:n] = (m <= cut).astype(np.float64)
        else:
            v[:n] = 1.0
        vecs.append(v.astype(rt))
    return vecs


def _inv_roundtrip_scale(plan) -> float:
    """s with ``s * inverse(forward(x)) == x`` under the plan's norm."""
    if plan.config.norm is pm.FFTNorm.NONE:
        return 1.0 / float(plan.transform_size)
    return 1.0


def _tmap(fn, *trees):
    """``fn`` over a tensor, or elementwise over tuples of tensors."""
    if isinstance(trees[0], tuple):
        return tuple(fn(*xs) for xs in zip(*trees))
    return fn(*trees)


def _rk4(rhs, w, dt: float):
    """One classic RK4 step over a tensor or tuple state."""
    k1 = rhs(w)
    k2 = rhs(_tmap(lambda a, b: a + 0.5 * dt * b, w, k1))
    k3 = rhs(_tmap(lambda a, b: a + 0.5 * dt * b, w, k2))
    k4 = rhs(_tmap(lambda a, b: a + dt * b, w, k3))

    def comb(a, b1, b2, b3, b4):
        return a + (dt / 6.0) * (b1 + 2.0 * b2 + 2.0 * b3 + b4)

    return _tmap(comb, w, k1, k2, k3, k4)


def _groups(plan) -> tuple:
    """The groups a sum over the whole distributed array reduces over."""
    if plan.fft3d:
        return ()
    return plan.groups if hasattr(plan, "groups") else (plan.group,)


class _NSBase:
    """Shared plumbing: the symbols, the multi-step drivers, the
    physical <-> spectral entry and exit."""

    def __init__(self, plan, viscosity: float,
                 lengths: Optional[Sequence[float]] = None):
        self.plan = plan
        self.viscosity = float(viscosity)
        nd = len(plan.input_shape)
        if lengths is None:
            lengths = (2 * np.pi,) * nd
        if len(lengths) != nd:
            raise ValueError(f"lengths must have {nd} entries, got {lengths}")
        self.lengths = tuple(float(v) for v in lengths)
        self._nd = nd
        self._s = _inv_roundtrip_scale(plan)
        dev, axes = plan.device, tuple(plan.transform_axes)
        ks = local_vectors(plan, signed_wavenumbers(plan, self.lengths))
        masks = local_vectors(plan, dealias_vectors(plan))
        self._kt = [bcast(k, ax, nd, dev) for ax, k in enumerate(ks)]
        self._ikt = [1j * k for k in self._kt]
        k2 = None
        for ax in axes:
            t = self._kt[ax] ** 2
            k2 = t if k2 is None else k2 + t
        self._k2d = k2
        self._nu_k2 = self.viscosity * k2
        self._inv_k2d = torch.where(k2 > 0, 1.0 / torch.where(k2 > 0, k2, 1.0),
                                    0.0)
        mask = None
        for ax in axes:
            v = bcast(masks[ax], ax, nd, dev)
            mask = v if mask is None else mask * v
        self._mask_d = mask
        # A batch axis's vector zeros only its pad planes.
        self._batch_masks = [bcast(masks[ax], ax, nd, dev)
                             for ax in range(nd)
                             if ax not in axes and not bool((masks[ax] == 1).all())]

    def _k(self, axis: int) -> torch.Tensor:
        return self._kt[axis]

    def _mask(self, c: torch.Tensor) -> torch.Tensor:
        c = c * self._mask_d
        for v in self._batch_masks:
            c = c * v
        return c

    def _k2(self) -> torch.Tensor:
        return self._k2d

    def _inv_k2(self) -> torch.Tensor:
        return self._inv_k2d

    def _fields(self, w):
        """A physical field as ``forward_fn`` takes it (a global one cut
        to this rank's block on P ranks)."""
        return input_block(self.plan, w)

    def _allreduce(self, t: torch.Tensor) -> torch.Tensor:
        for g in _groups(self.plan):
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=g)
        return t

    def step_fn(self, dt: float):
        """Single RK4 step over the SPECTRAL state (differentiable)."""
        rhs = self.rhs_fn()

        def step(w):
            return _rk4(rhs, w, dt)

        return step

    def solve_fn(self, steps: int, dt: float):
        """Physical -> physical N-step integrator: forward once, the RK4
        step ``steps`` times (a Python loop), inverse once;
        differentiable end to end."""
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        step = self.step_fn(dt)
        to_spec, to_phys = self.to_spectral, self.to_physical

        def fn(w0):
            wh = to_spec(w0)
            for _ in range(steps):
                wh = step(wh)
            return to_phys(wh)

        return fn

    def run(self, w0, steps: int, dt: float):
        """``solve_fn(steps, dt)(w0)`` with no autograd graph."""
        with torch.no_grad():
            return self.solve_fn(steps, dt)(w0)


class NavierStokes2D(_NSBase):
    """2D vorticity-form pseudo-spectral Navier-Stokes over a batched-2D
    plan: each batch plane an independent flow. The spectral state is the
    vorticity spectrum on the plan's padded spectral block."""

    def __init__(self, plan, viscosity: float,
                 lengths: Optional[Sequence[float]] = None):
        if len(tuple(plan.transform_axes)) != 2:
            raise ValueError(
                "NavierStokes2D needs a 2D-transform plan "
                f"(Batched2DFFTPlan); got transform_axes="
                f"{tuple(plan.transform_axes)} — use NavierStokes3D for "
                "slab/pencil plans")
        super().__init__(plan, viscosity, lengths)

    def to_spectral(self, w):
        """Physical vorticity -> dealiased spectrum."""
        return self._mask(self.plan.forward_fn()(self._fields(w)))

    def to_physical(self, wh):
        return self.plan.inverse_fn()(wh) * self._s

    def velocity_fn(self):
        """Spectral vorticity -> (u, v) physical velocity (through the
        streamfunction ψ: ω = -∇²ψ, u = ψ_y, v = -ψ_x)."""
        ax_x, ax_y = self.plan.transform_axes
        ikx, iky = self._ikt[ax_x], self._ikt[ax_y]
        inv_k2 = self._inv_k2()
        inv = self.plan.inverse_fn()
        s = self._s

        def vel(wh):
            psi = wh * inv_k2
            u = inv(iky * psi) * s
            v = inv(-ikx * psi) * s
            return u, v

        return vel

    def rhs_fn(self):
        """Spectral RHS: dealiased advection plus viscous decay."""
        ax_x, ax_y = self.plan.transform_axes
        ikx, iky = self._ikt[ax_x], self._ikt[ax_y]
        nu_k2 = self._nu_k2
        fwd, inv = self.plan.forward_fn(), self.plan.inverse_fn()
        s = self._s
        vel = self.velocity_fn()
        mask = self._mask

        def rhs(wh):
            u, v = vel(wh)
            wx = inv(ikx * wh) * s
            wy = inv(iky * wh) * s
            adv = fwd(u * wx + v * wy)
            return -mask(adv) - nu_k2 * wh

        return rhs

    def diagnostics(self, wh):
        """{'energy', 'enstrophy'} per batch plane (the means over the
        transformed plane of 0.5|u|² and 0.5ω²), summed over the ranks."""
        plan = self.plan
        with torch.no_grad():
            u, v = self.velocity_fn()(wh)
            w = self.to_physical(wh)
            ax = tuple(plan.transform_axes)
            nvol = float(plan.transform_size)
            e = 0.5 * torch.sum(u.abs() ** 2 + v.abs() ** 2, dim=ax) / nvol
            z = 0.5 * torch.sum(w.abs() ** 2, dim=ax) / nvol
            return {"energy": self._planes(e), "enstrophy": self._planes(z)}

    def _planes(self, t: torch.Tensor) -> torch.Tensor:
        """Per-plane sums of this rank's planes -> every logical plane's,
        on every rank."""
        plan = self.plan
        if plan.fft3d:
            return t
        sl = plan.local_slices()[0]
        full = t.new_zeros(plan.input_padded_shape[0])
        full[sl] = t
        return self._allreduce(full)[: plan.input_shape[0]]


class NavierStokes3D(_NSBase):
    """3D rotational-form pseudo-spectral Navier-Stokes over a slab or
    pencil plan. The physical state is the stacked velocity ``u[3, ...]``
    (this rank's blocks on P ranks); the spectral state is the 3-tuple of
    component spectra, kept divergence-free by the Leray projection."""

    def __init__(self, plan, viscosity: float,
                 lengths: Optional[Sequence[float]] = None):
        if len(tuple(plan.transform_axes)) != 3:
            raise ValueError(
                "NavierStokes3D needs a 3D plan (slab/pencil); got "
                f"transform_axes={tuple(plan.transform_axes)} — use "
                "NavierStokes2D for batched-2D plans")
        super().__init__(plan, viscosity, lengths)

    def _kvec(self):
        return tuple(self._k(a) for a in self.plan.transform_axes)

    def _project(self, ch: Tuple) -> Tuple:
        """Leray projection: ĉ - k (k·ĉ)/k² componentwise."""
        k = self._kvec()
        div = sum(ki * ci for ki, ci in zip(k, ch)) * self._inv_k2()
        return tuple(ci - ki * div for ki, ci in zip(k, ch))

    def to_spectral(self, u) -> Tuple:
        """Stacked physical velocity (3, ...) -> projected, dealiased
        component spectra."""
        fwd = self.plan.forward_fn()
        return self._project(tuple(self._mask(fwd(self._fields(u[i])))
                                   for i in range(3)))

    def to_physical(self, ch: Tuple) -> torch.Tensor:
        inv = self.plan.inverse_fn()
        return torch.stack([inv(c) * self._s for c in ch])

    def _curl(self, ch: Tuple) -> Tuple:
        ikx, iky, ikz = (self._ikt[a] for a in self.plan.transform_axes)
        ux, uy, uz = ch
        return (iky * uz - ikz * uy, ikz * ux - ikx * uz, ikx * uy - iky * ux)

    def rhs_fn(self):
        """du/dt = P(F(u × ω)) - ν k² û, dealiased."""
        nu_k2 = self._nu_k2
        fwd, inv = self.plan.forward_fn(), self.plan.inverse_fn()
        s = self._s
        mask, project, curl = self._mask, self._project, self._curl

        def rhs(ch):
            u = [inv(c) * s for c in ch]
            w = [inv(c) * s for c in curl(ch)]
            lamb = (u[1] * w[2] - u[2] * w[1],
                    u[2] * w[0] - u[0] * w[2],
                    u[0] * w[1] - u[1] * w[0])
            nh = project(tuple(mask(fwd(c)) for c in lamb))
            return tuple(n - nu_k2 * c for n, c in zip(nh, ch))

        return rhs

    def diagnostics(self, ch: Tuple) -> dict:
        """{'energy', 'enstrophy'}: volume means of 0.5|u|² and 0.5|ω|²
        from the physical fields, summed over the ranks."""
        with torch.no_grad():
            inv = self.plan.inverse_fn()
            u = [inv(c) * self._s for c in ch]
            w = [inv(c) * self._s for c in self._curl(ch)]
            nvol = float(self.plan.transform_size)
            sums = torch.stack([sum(torch.sum(c.abs() ** 2) for c in u),
                                sum(torch.sum(c.abs() ** 2) for c in w)])
            e, z = (0.5 * self._allreduce(sums) / nvol).unbind()
            return {"energy": e, "enstrophy": z}


def taylor_green_2d(n: int, batch: int = 1, lengths=(2 * np.pi, 2 * np.pi),
                    dtype=np.float64) -> np.ndarray:
    """Taylor-Green vorticity ω = 2 cos x cos y on an n×n grid, batched."""
    x = np.arange(n) * (lengths[0] / n)
    y = np.arange(n) * (lengths[1] / n)
    w = 2.0 * np.cos(x)[:, None] * np.cos(y)[None, :]
    return np.broadcast_to(w, (batch, n, n)).astype(dtype)


def taylor_green_3d(n: int, lengths=(2 * np.pi,) * 3,
                    dtype=np.float64) -> np.ndarray:
    """Taylor-Green velocity (u, v, w) = (cos x sin y sin z,
    -sin x cos y sin z, 0) stacked as (3, n, n, n), divergence-free."""
    i = np.arange(n) * (lengths[0] / n)
    cx, sx = np.cos(i), np.sin(i)
    u = cx[:, None, None] * sx[None, :, None] * sx[None, None, :]
    v = -sx[:, None, None] * cx[None, :, None] * sx[None, None, :]
    w = np.zeros((n, n, n))
    return np.stack([u, v, w]).astype(dtype)
