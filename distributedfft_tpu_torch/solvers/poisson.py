"""FFT-diagonalized Poisson solver — BASELINE config #5 ("3D Poisson
solve (FFT-diagonalized Laplacian)"), the JAX package's
``solvers/poisson.py`` on the port's plans.

Solves ∇²u = f by forward transform, multiplication by the inverse
Laplacian symbol, inverse transform (the reference's testcase-4
``derivativeCoefficients`` operator, inverted). The solver drives the plan
through the solver protocol (``exec_fwd`` / ``exec_inv``,
``forward_fn`` / ``inverse_fn``, ``transform_axes``,
``spectral_halved_axis``), so it runs on the slab (any sequence), pencil
and batched-2D plans; on the last the batch axis is a pure broadcast axis
and each plane an independent 2D solve.

Wavenumbers (``mode``): ``"physical"``, k_i = 2π m_i / L_i with numpy's
fftfreq fold, or ``"integer"``, the reference's integer convention
(Nyquist zeroed). Boundary conditions (``bc``): ``"periodic"`` (the k = 0
mode set to zero, the zero-mean gauge), ``"dirichlet"`` (u = 0 walls on
the staggered grid: the forcing odd-extended along the axis, the DST-II
extension) and ``"neumann"`` (∂u/∂n = 0: the even, DCT-II extension),
per axis; a non-periodic axis needs the plan built at the EXTENDED extent
2n for an interior of n (``interior_shape``).

**The symbol.** As in the JAX package it comes from 1D wavenumber vectors
on the plan's padded spectral grid (zero in pad lanes). Each rank slices
them to its own spectral block (``plan.local_slices(output=True)``) and
the solver holds ONE dense real inverse symbol of that block on the
plan's device, built once (2.15 GB in float32 at 1024³, a batched plan's
with extent 1 along the batch axis): ``solve`` then costs the plan's two
directions and one multiply in place on the spectrum ``exec_fwd``
returned, with no chain of full-size temporaries. ``solve``, run under
``torch.no_grad()``, builds no autograd graph; ``solve_fn`` is the
differentiable pipeline.

**P > 1 ranks (the port's block convention).** A periodic ``solve``
takes this rank's padded input block (``exec_fwd``'s), or the global array
(cut to the block with ``plan.pad_input``), and returns this rank's padded
real block (``plan.crop_real`` gathers it). An extended ``solve`` takes the
GLOBAL interior forcing on every rank, as ``pad_input`` does: each rank
builds its own block of the extension locally, with no communication (on
a split axis a rank's block of ``[f, ±flip f]`` holds samples of another
rank's part of f), and returns the part of its solution block below the
interior extent (empty on a rank whose block is all mirror);
``gather_interior`` assembles the global interior solution (collective).
The JAX package's global arrays need none of this. ``solve_fn`` of an
extended box takes the global interior on every rank too, behind
``parallel.transpose.replicated``: its backward all-reduces the gradient,
so every rank holds the gradient of the loss summed over the ranks.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import params as pm
from ..parallel.mesh import plan_groups
from ..parallel.transpose import replicated

_BCS = ("periodic", "dirichlet", "neumann")
_CHUNK = 1 << 26      # elements per piece of the symbol's division


def _axis_freqs(n: int, ext: int, halved: bool, integer_mode: bool
                ) -> np.ndarray:
    """Folded wavenumber per spectral index along one PERIODIC axis, zero
    in pad lanes (ext >= logical spectral extent). Integer mode is the
    reference kernel's fold (``random_dist_default.cu:80-88``): k = i for
    i < n//2, k = n - i for i > n//2, 0 at i == n//2; physical mode numpy's
    fftfreq fold (Nyquist kept)."""
    k = np.zeros(ext)
    if halved:
        m = np.arange(n // 2 + 1, dtype=np.float64)
        if integer_mode:
            m[n // 2] = 0.0
        k[: n // 2 + 1] = m
    else:
        if integer_mode:
            m = np.zeros(n)
            for i in range(n):
                if i < n // 2:
                    m[i] = i
                elif i > n // 2:
                    m[i] = n - i
        else:
            m = np.fft.fftfreq(n) * n
        k[:n] = m
    return k


def _extension_freqs(n_ext: int, ext: int, halved: bool) -> np.ndarray:
    """Folded half-integer-grid wavenumber index of a DCT/DST-extended
    axis: bin m of the period-2L extension of length ``n_ext = 2n``
    carries the mode ``fold(m) = min(m, n_ext - m)`` at k = π·fold(m)/L
    (symmetric under m <-> n_ext - m, which keeps the extension's symmetry
    class). Zero in pad lanes."""
    k = np.zeros(ext)
    cnt = n_ext // 2 + 1 if halved else n_ext
    m = np.arange(cnt, dtype=np.float64)
    k[:cnt] = np.minimum(m, n_ext - m)
    return k


def _parse_bc(bc, axes: Tuple[int, ...], ndim: int = 3):
    """Per-array-axis bc tuple from a scalar or per-axis sequence; axes
    outside ``axes`` (a batched-2D plan's batch axis) must stay periodic."""
    if isinstance(bc, str):
        per = ["periodic"] * ndim
        for a in axes:
            per[a] = bc
    else:
        per = [str(b) for b in bc]
        if len(per) != ndim:
            raise ValueError(f"bc must be a string or a length-{ndim} "
                             f"sequence, got {bc!r}")
    for a, b in enumerate(per):
        if b not in _BCS:
            raise ValueError(f"unknown bc {b!r} (choose from {_BCS})")
        if b != "periodic" and a not in axes:
            raise ValueError(f"axis {a} is not transformed by this plan "
                             f"(transform_axes={axes}); only 'periodic' "
                             "is meaningful there")
    return tuple(per)


def _plan_dtypes(plan) -> Tuple[np.dtype, np.dtype]:
    """(real, complex) numpy dtypes of ``plan``'s precision."""
    if plan.config.double_prec:
        return np.dtype(np.float64), np.dtype(np.complex128)
    return np.dtype(np.float32), np.dtype(np.complex64)


def local_vectors(plan, vecs) -> list:
    """Per-axis 1D vectors over the plan's padded spectral grid, cut to
    this rank's spectral block (``plan.local_slices(output=True)``)."""
    sl = plan.local_slices(output=True)
    return [np.ascontiguousarray(v[s]) for v, s in zip(vecs, sl)]


def bcast(vec: np.ndarray, axis: int, nd: int, device) -> torch.Tensor:
    """``vec`` on ``device`` shaped to broadcast along ``axis`` of ``nd``."""
    shape = [1] * nd
    shape[axis] = -1
    return torch.from_numpy(vec).to(device).view(shape)


def input_block(plan, f) -> torch.Tensor:
    """A forward input as ``exec_fwd`` takes it: on P ranks the global
    array (logical or padded) is cut to this rank's block; anything else
    passes as it is (``exec_fwd`` checks it)."""
    shape = tuple(f.shape)
    if not plan.fft3d and shape != tuple(plan.local_input_shape) and \
            shape in (tuple(plan.input_shape),
                      tuple(plan.input_padded_shape)):
        return plan.pad_input(f)
    return f


class PoissonSolver:
    """Poisson solve on top of any plan family of the port."""

    def __init__(self, plan, lengths: Optional[Sequence[float]] = None,
                 mode: str = "physical", bc="periodic"):
        if mode not in ("physical", "integer"):
            raise ValueError(f"mode must be 'physical' or 'integer', got "
                             f"{mode!r}")
        self.plan = plan
        self.mode = mode
        axes = tuple(plan.transform_axes)
        dims = tuple(int(n) for n in plan.input_shape)
        self.bc = _parse_bc(bc, axes, len(dims))
        if mode == "integer" and any(b != "periodic" for b in self.bc):
            raise ValueError("mode='integer' is the reference's periodic "
                             "testcase convention; non-periodic boxes use "
                             "mode='physical'")
        for a, b in enumerate(self.bc):
            if b != "periodic" and dims[a] % 2:
                raise ValueError(
                    f"axis {a} has bc={b!r}: the plan must be built at the "
                    f"even EXTENDED extent 2n (got {dims[a]}) — the solver "
                    "odd/even-extends an interior of n samples")
        if lengths is None:
            lengths = (2 * np.pi,) * len(dims)
        self.lengths = tuple(float(v) for v in lengths)

        shape = plan.output_padded_shape
        halved_axis = self._halved_axis()
        rt, _ = _plan_dtypes(plan)
        ks = []
        for ax in range(len(dims)):
            if ax not in axes:
                k = np.zeros(shape[ax])     # a pure batch axis
            elif self.bc[ax] == "periodic":
                k = _axis_freqs(dims[ax], shape[ax], ax == halved_axis,
                                mode == "integer")
                if mode == "physical":
                    k = k * (2 * np.pi / self.lengths[ax])
            else:
                # The extended axis: plan length 2n over period 2L, so
                # k = π·fold(m)/L with L the INTERIOR length.
                k = _extension_freqs(dims[ax], shape[ax], ax == halved_axis)
                k = k * (np.pi / self.lengths[ax])
            ks.append(k.astype(rt))
        # This rank's block of each 1D vector: the dense symbol is formed
        # from them once, on the device (``_symbol``).
        self._ks = local_vectors(plan, ks)
        # The roundtrip normalization folded into the symbol: the solve is
        # exactly inverse(forward(f) * symbol). ``transform_size`` counts
        # the TRANSFORMED axes only (a batch axis carries no 1/N).
        self._scale = (1.0 / float(plan.transform_size)
                       if plan.config.norm is pm.FFTNorm.NONE else 1.0)
        self._sym: Optional[torch.Tensor] = None
        self._solve_pure = None

    # -- shapes ------------------------------------------------------------

    @property
    def interior_shape(self) -> Tuple[int, ...]:
        """The solve domain: the plan's logical shape with every
        non-periodic axis halved (the plan transforms the 2n extension of
        an n-sample interior)."""
        return tuple(n // 2 if b != "periodic" else n
                     for n, b in zip(self.plan.input_shape, self.bc))

    @property
    def _extended(self) -> bool:
        return any(b != "periodic" for b in self.bc)

    def _halved_axis(self) -> int:
        h = self.plan.spectral_halved_axis
        return -1 if h is None else h

    # -- the spectral symbol ----------------------------------------------

    def _symbol(self) -> torch.Tensor:
        """The dense inverse symbol of this rank's spectral block, -scale /
        k² (0 where k² = 0), built once on the plan's device: the sum of
        squares in place, then the division in pieces of ``_CHUNK``
        elements. Extent 1 along a batch axis."""
        if self._sym is None:
            plan, axes = self.plan, tuple(self.plan.transform_axes)
            nd = len(self._ks)
            shape = [len(k) if ax in axes else 1
                     for ax, k in enumerate(self._ks)]
            sym = torch.zeros(shape, dtype=plan.real_dtype,
                              device=plan.device)
            for ax in axes:
                sym += bcast(self._ks[ax] ** 2, ax, nd, plan.device)
            flat, zero = sym.view(-1), torch.zeros((), dtype=sym.dtype,
                                                   device=sym.device)
            for i in range(0, flat.numel(), _CHUNK):
                part = flat[i:i + _CHUNK]
                part.copy_(torch.where(part > 0, (-self._scale) / part, zero))
            self._sym = sym
        return self._sym

    def _apply(self, c: torch.Tensor) -> torch.Tensor:
        """The symbol multiply of ``solve_fn`` (differentiable)."""
        return c * self._symbol()

    # -- extension / restriction (the R2R boundary-condition machinery) ----

    def _extend(self, f) -> torch.Tensor:
        """The GLOBAL interior forcing -> this rank's padded input block of
        its extension: along each axis, the block's positions j of the
        padded extended axis read the interior at j (j < n) or 2n - 1 - j
        (the mirror, negated for Dirichlet), and zero past the logical
        extent. Index gathers and sign products only (differentiable); on
        one rank it is the JAX package's ``[f, ±flip f]``."""
        plan = self.plan
        dtype = plan.complex_dtype if getattr(
            plan, "transform", "r2c") == "c2c" else plan.real_dtype
        f = torch.as_tensor(f).to(device=plan.device, dtype=dtype)
        if tuple(f.shape) != self.interior_shape:
            raise ValueError(
                f"bc={self.bc}: solve expects the interior shape "
                f"{self.interior_shape}, got {tuple(f.shape)}")
        sl = plan.local_slices()
        for ax, (ext, s) in enumerate(zip(plan.local_input_shape, sl)):
            n, start = self.interior_shape[ax], s.start or 0
            j = torch.arange(start, start + ext)
            if self.bc[ax] == "periodic":
                src, keep = j, j < n
                sign = torch.ones(ext, dtype=torch.float64)
            else:
                src, keep = torch.where(j < n, j, 2 * n - 1 - j), j < 2 * n
                sign = torch.where(
                    (j < n) | torch.tensor(self.bc[ax] == "neumann"),
                    1.0, -1.0).to(torch.float64)
            if start == 0 and ext == n and self.bc[ax] == "periodic":
                continue                    # the whole axis as it is
            f = f.index_select(ax, src.clamp(0, n - 1).to(f.device))
            w = sign * keep
            if not bool((w == 1).all()):
                f = f * bcast(w.numpy().astype(_plan_dtypes(plan)[0]), ax,
                              f.ndim, f.device)
        return f

    def _restrict(self, u: torch.Tensor) -> torch.Tensor:
        """This rank's solution block -> its part below the interior
        extent along every axis."""
        for ax, s in enumerate(self.plan.local_slices()):
            keep = max(0, min(u.shape[ax],
                              self.interior_shape[ax] - (s.start or 0)))
            u = u.narrow(ax, 0, keep)
        return u

    def gather_interior(self, u) -> np.ndarray:
        """The global interior solution on every rank (collective), from
        each rank's ``solve`` result of an extended box."""
        plan = self.plan
        u = torch.as_tensor(u)
        for ax, n in enumerate(plan.local_input_shape):
            if u.shape[ax] < n:
                shape = list(u.shape)
                shape[ax] = n - u.shape[ax]
                u = torch.cat([u, u.new_zeros(shape)], dim=ax)
        full = plan.crop_real(u)
        return full[tuple(slice(0, n) for n in self.interior_shape)]

    # -- execution ---------------------------------------------------------

    def solve_fn(self):
        """The differentiable solve (forward -> symbol multiply -> inverse)
        on ``forward_fn`` / ``inverse_fn``, with no envelope: ``backward``
        flows through the distributed spectral solve. It maps what
        ``forward_fn`` takes to what ``inverse_fn`` returns; for a
        non-periodic box, the global interior to this rank's part of the
        interior, the input's gradient all-reduced over the ranks (see the
        module docstring)."""
        if self._solve_pure is None:
            plan = self.plan
            fwd, inv = plan.forward_fn(), plan.inverse_fn()
            apply = self._apply
            if self._extended:
                ext, restrict = self._extend, self._restrict
                groups = plan_groups(plan)

                def fn(f):
                    f = replicated(torch.as_tensor(f), groups)
                    return restrict(inv(apply(fwd(ext(f)))))
            else:
                def fn(f):
                    return inv(apply(fwd(f)))

            self._solve_pure = fn
        return self._solve_pure

    def solve(self, f) -> torch.Tensor:
        """u with ∇²u = f (under this solver's ``bc``), with no autograd
        graph. Periodic box: the input ``exec_fwd`` takes (on P ranks also
        the global array), the plan's padded real-space result (crop with
        ``plan.crop_real``). Non-periodic box: the global
        ``interior_shape`` forcing, this rank's part of the interior
        solution (``gather_interior``)."""
        plan = self.plan
        with torch.no_grad():
            f = self._extend(f) if self._extended else input_block(plan, f)
            c = plan.exec_fwd(f)
            sym = self._symbol()
            if c.is_complex():
                torch.view_as_real(c).mul_(sym.unsqueeze(-1))
            else:
                c = c * sym
            u = plan.exec_inv(c)
            return self._restrict(u) if self._extended else u
