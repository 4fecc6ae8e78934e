"""Numerical guards: cheap invariants that catch silent corruption — the
port's ``resilience/guards.py``, after the JAX package's.

A production run has no reference to compare against, so a flipped bit on
the wire, a NaN from a bad kernel, or a compressed exchange drifting past
its error budget all produce a silently wrong answer. These guards are the
online complement: invariants of the transform itself, computed on the
device after each execution and checked on the host.

Two checks per pipeline:

* **Parseval / energy conservation** — for an unnormalized forward
  transform of logical volume ``N``, ``||X||^2 == N * ||x||^2`` exactly
  (in exact arithmetic); R2C halves one axis, so the spectral energy is
  reconstructed with the conjugate-symmetry weights (DC and — for even
  extents — Nyquist bins count once, interior bins twice). The check holds
  for ANY input. The C2C inverse satisfies the mirrored identity; the C2R
  inverse does NOT (arbitrary spectral input is not conjugate-symmetric),
  so that direction degrades to a finiteness guard.
* **Wire drift probe** — under a compressed wire, one extra
  encode->decode of the spectral payload measures the ACTUAL max relative
  drift a wire crossing induces on this data, against
  ``Config.wire_error_budget``.

Modes (``Config.guards`` -> ``$DFFT_GUARDS`` -> "off"):

* ``off``     — the plan runs its pipeline as built: no reduction, no
  collective, no readback.
* ``check``   — violations increment ``guard.parseval_violations`` /
  ``guard.wire_drift_violations``, emit ``obs.notice``, and a violating
  compressed wire demotes itself to native for subsequent calls
  (``fallback.demote_wire``).
* ``enforce`` — violations raise ``GuardViolation`` carrying the plan
  fingerprint (kind, shape, rendering, wire, backend, direction).

One process per rank: each rank reduces the part of the global LOGICAL
region its block holds (pad lanes never count: the last rank of an uneven
split holds some), then the partial sums are all-reduced over the plan's
group — energies with SUM, the drift probe's maxima with MAX, at most two
small collectives, posted only when guards are on — so every rank reaches
the same verdict and, under ``enforce``, every rank raises (no rank is
left waiting for a peer in the next exchange). A NaN survives the
reduction: SUM keeps it, and the probe's NaN turns into +inf before its
MAX. The energies are norm reductions of the tensors where they lie (the
halved axis corrected by subtracting its once-counted planes), so the
guard allocates no tensor of the payload's size.

Tolerance is derived from the dtype and wire (``parseval_tolerance``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import obs

# Floor of the relative-residual denominator (an all-zero input has zero
# energy on both sides; 0/tiny -> residual 0, not NaN).
_TINY = 1e-30


class GuardViolation(RuntimeError):
    """A numerical guard fired in ``enforce`` mode. Carries the check
    name, measured value, tolerance and the plan fingerprint so the
    failure is attributable without a debugger."""

    def __init__(self, check: str, value: float, tolerance: float,
                 fingerprint: dict):
        self.check = check
        self.value = value
        self.tolerance = tolerance
        self.fingerprint = dict(fingerprint)
        super().__init__(
            f"guard violation: {check} residual {value:.3e} exceeds "
            f"tolerance {tolerance:.3e} on {fingerprint}")


def resolved_mode(config) -> str:
    """The guard mode a Config selects (field -> $DFFT_GUARDS -> off)."""
    return config.resolved_guards()


def parseval_tolerance(double_prec: bool, wire_dtype: str,
                       n_total: int) -> float:
    """Max acceptable relative Parseval residual for a transform of
    logical volume ``n_total`` in the given precision over the given wire
    (the JAX package's derivation): rounding accumulates like
    ``eps * log2(N)``, with 64x headroom; a bf16 wire adds 0.1 (two
    crossings at its documented per-element bound). Injected faults (NaN,
    exponent bit-flip, 0.5x payload scale) land at inf / >1e30 / ~0.75."""
    eps = 2.3e-16 if double_prec else 1.2e-7
    tol = 64.0 * eps * max(1.0, math.log2(max(2, int(n_total))))
    if wire_dtype != "native":
        tol += 0.1
    return tol


@dataclasses.dataclass(frozen=True)
class GuardSpec:
    """Static description of one direction's guard (built by the plan
    family's ``_guard_spec``): which check applies, the expected
    out/in energy ratio under the plan's norm, the global logical extents
    the padded arrays are cut to before the reduction, and the R2C
    halved-axis weighting of the spectral (output) side."""

    direction: str               # "forward" | "inverse"
    check: str                   # "parseval" | "finite"
    scale: float                 # expected ||out||^2 / ||in||^2
    in_logical: Tuple[int, ...]
    out_logical: Tuple[int, ...]
    halved_axis: Optional[int] = None  # forward R2C only (output side)
    halved_n: int = 0                  # pre-halving logical extent


def transform_spec(direction: str, norm, n: float, c2c: bool,
                   space: Tuple[int, ...], spectrum: Tuple[int, ...],
                   halved_axis: int, halved_n: int) -> GuardSpec:
    """The GuardSpec every plan family builds (the JAX families' shared
    contract) for a transform of logical volume ``n`` between the logical
    ``space`` and ``spectrum`` shapes: the forward checks Parseval, the R2C
    halved axis weighted; the C2C inverse Parseval (exact for any input);
    the C2R inverse finiteness (arbitrary spectral input is not
    conjugate-symmetric, so energy is not its invariant)."""
    from ..params import FFTNorm
    if direction == "forward":
        return GuardSpec(
            direction="forward", check="parseval",
            scale=1.0 if norm is FFTNorm.ORTHO else n,
            in_logical=space, out_logical=spectrum,
            halved_axis=None if c2c else halved_axis,
            halved_n=0 if c2c else halved_n)
    if not c2c:
        return GuardSpec(direction="inverse", check="finite", scale=1.0,
                         in_logical=spectrum, out_logical=space)
    scale = {FFTNorm.NONE: n, FFTNorm.BACKWARD: 1.0 / n,
             FFTNorm.ORTHO: 1.0}[norm]
    return GuardSpec(direction="inverse", check="parseval", scale=scale,
                     in_logical=spectrum, out_logical=space)


@dataclasses.dataclass
class GuardState:
    """Per-(direction, dims) host-side check state stashed on the plan at
    build time, so ``finish`` compares against exactly the tolerances the
    guarded pipeline was built under."""

    spec: GuardSpec
    tolerance: float
    wire_budget: float
    probe: bool                  # wire drift probe in the pipeline


@dataclasses.dataclass(frozen=True)
class Region:
    """Where this rank's blocks lie: the slices of the padded global input
    and output arrays of one direction (``slice(None)`` on one rank), and
    whether partial results are all-reduced over ``group``."""

    in_slices: Tuple[slice, ...]
    out_slices: Tuple[slice, ...]
    reduce: bool = False
    group: object = None


def region(plan, direction: str, dims: int = 3) -> Region:
    """The ``Region`` of ``plan``'s ``direction`` at depth ``dims``: the
    forward reads the input blocks and writes the output blocks, the
    inverse the other way round. A plan on one rank holds the whole
    arrays."""
    if plan.fft3d:
        whole = (slice(None),) * 3
        return Region(whole, whole)
    if hasattr(plan, "local_output_shape_for"):        # the pencil's depth
        real, spec = plan.local_slices(False), plan.local_slices(True, dims)
    else:
        real, spec = plan.local_slices(False), plan.local_slices(True)
    if direction == "forward":
        return Region(real, spec, True, plan.group)
    return Region(spec, real, True, plan.group)


def _halved_weights(padded_ext: int, halved_n: int) -> np.ndarray:
    """Conjugate-symmetry energy weights of an R2C halved axis of padded
    extent ``padded_ext`` (pre-halving logical extent ``halved_n``): DC
    counts once, the Nyquist bin once when ``halved_n`` is even, interior
    bins twice, pad lanes zero."""
    nh = halved_n // 2 + 1
    w = np.zeros(padded_ext, dtype=np.float32)
    w[:nh] = 2.0
    w[0] = 1.0
    if halved_n % 2 == 0:
        w[nh - 1] = 1.0
    return w


def _slice_logical(v: torch.Tensor, slices: Sequence[slice],
                   logical: Sequence[int]) -> torch.Tensor:
    """This rank's block ``v`` (at ``slices`` of the padded global array)
    cut to the part of the global logical region ``logical`` it holds: a
    view, each axis kept from its start up to the logical end."""
    for ax, (sl, n) in enumerate(zip(slices, logical)):
        keep = max(0, min(v.shape[ax], n - (sl.start or 0)))
        if keep != v.shape[ax]:
            v = v.narrow(ax, 0, keep)
    return v


def _sumsq(v: torch.Tensor) -> torch.Tensor:
    """sum |v|^2 as a float64 scalar on ``v``'s device, summed in float64:
    the norm of each row along ``v``'s densest axis (its smallest stride:
    the last one of a contiguous tensor) in ``v``'s own precision, a
    reduction of a few thousand values where ``v`` lies (strided views
    included), then the float64 sum of their squares. The temporaries hold
    one value a row, none of them ``v``'s size. (One float32 norm of the
    whole operand loses ~1e-4 of the sum at 2M elements, and the card and
    the CPU lose different amounts.)"""
    if v.numel() == 0:
        return torch.zeros((), dtype=torch.float64, device=v.device)
    v = v.reshape(1) if v.ndim == 0 else v
    dense = min(range(v.ndim), key=lambda d: (v.shape[d] == 1,
                                              abs(v.stride(d)), -d))
    v = v.movedim(dense, -1)
    r = torch.view_as_real(v) if v.is_complex() else v.unsqueeze(-1)
    rows = torch.linalg.vector_norm(r, dim=(-2, -1)).double()
    return rows.square_().sum()


def _energy(v: torch.Tensor, halved_axis: Optional[int] = None,
            halved_n: int = 0, start: int = 0) -> torch.Tensor:
    """Energy of ``v`` (float64 scalar); with ``halved_axis``, weighted by
    ``_halved_weights`` where ``v`` holds global positions ``start`` on of
    that axis: twice the whole, less each plane of weight 1 once and each
    of weight 0 twice."""
    e = _sumsq(v)
    if halved_axis is None:
        return e
    n = v.shape[halved_axis]
    w = _halved_weights(max(start + n, halved_n // 2 + 1),
                        halved_n)[start:start + n]
    e = 2.0 * e
    for j in np.flatnonzero(w != 2.0):
        e = e - (2.0 - float(w[j])) * _sumsq(v.select(halved_axis, int(j)))
    return e


def _allreduce(t: torch.Tensor, op, reg: Region) -> torch.Tensor:
    if reg.reduce:
        dist.all_reduce(t, op=op, group=reg.group)
    return t


def parseval_sums(spec: GuardSpec, x: torch.Tensor, y: torch.Tensor,
                  reg: Region) -> torch.Tensor:
    """``[in energy, out energy]`` over the global logical regions (float64
    on the device, summed over the ranks)."""
    hax = spec.halved_axis
    start = 0 if hax is None else (reg.out_slices[hax].start or 0)
    sums = torch.stack([
        _energy(_slice_logical(x, reg.in_slices, spec.in_logical)),
        _energy(_slice_logical(y, reg.out_slices, spec.out_logical),
                hax, spec.halved_n, start)])
    return _allreduce(sums, dist.ReduceOp.SUM, reg)


def _max_pair(diff: torch.Tensor, ref: torch.Tensor,
              reg: Region) -> torch.Tensor:
    """``[max |diff|, max |ref|]`` over the ranks (a NaN as +inf, which a
    MAX keeps on every backend)."""
    m = torch.stack([
        diff.abs().max() if diff.numel() else diff.new_zeros(()).abs(),
        ref.abs().max() if ref.numel() else ref.new_zeros(()).abs()])
    m = torch.nan_to_num(m.double(), nan=math.inf)
    return _allreduce(m, dist.ReduceOp.MAX, reg)


def wrap(pure, spec: GuardSpec, wire: str, probe: bool, reg: Region,
         family: str = "plan"):
    """The guarded pipeline: ``x -> (y, stats)`` where ``stats`` is a
    float64 2-vector ``[check_residual, wire_drift]`` on the device, the
    same on every rank (drift -1 when not probed). The guard's reductions
    run under the ``dfft/<family>/guard`` stage scope (the graph's guard
    node in ``obs/profile.py`` attribution)."""

    def run(x: torch.Tensor):
        y = pure(x)
        with obs.profile.stage_scope(family, "guard"):
            return y, _stats(x, y)

    def _stats(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if spec.check == "finite":
            e = _allreduce(_sumsq(y).reshape(1), dist.ReduceOp.SUM, reg)[0]
            resid = torch.where(torch.isfinite(e), 0.0, math.inf)
        else:
            in_e, out_e = parseval_sums(spec, x, y, reg)
            expected = spec.scale * in_e
            resid = (out_e - expected).abs() / expected.abs().clamp(
                min=_TINY)
        if probe:
            # Drift probe on the spectral-side payload (what the wire
            # carried): forward probes the output, inverse the input.
            from ..parallel.transpose import wire_decode, wire_encode
            v = y if spec.direction == "forward" else x
            z = wire_decode(wire_encode(v, wire), v.dtype, wire)
            m = _max_pair(z - v, v, reg)
            drift = m[0] / m[1].clamp(min=_TINY)
        else:
            drift = resid.new_tensor(-1.0)
        return torch.stack([resid.double(), drift.double()])

    return run


def maybe_wrap(plan, pure, direction: str, dims: int = 3):
    """``(pipeline, guarded)``: the guarded wrapper at modes check/enforce
    (stashing the host-side ``GuardState`` on the plan), the pipeline
    unchanged — the same object — at "off"."""
    mode = getattr(plan, "_guard_mode", "off")
    if mode == "off":
        return pure, False
    spec = plan._guard_spec(direction, dims)
    cfg = plan.config
    wire = cfg.wire_dtype
    probe = wire != "native"
    n_total = int(np.prod(spec.in_logical))
    plan._guard_state[(direction, dims)] = GuardState(
        spec=spec,
        tolerance=parseval_tolerance(cfg.double_prec, wire, n_total),
        wire_budget=cfg.resolved_wire_budget(),
        probe=probe)
    return wrap(pure, spec, wire, probe, region(plan, direction, dims),
                family=obs.profile.scope_family(plan)), True


def fingerprint(plan, direction: str) -> dict:
    """The plan identity a violation carries: enough to reproduce the
    failing configuration from a log line alone."""
    cfg = plan.config
    fp = {
        "plan": type(plan).__name__,
        "variant": getattr(plan, "variant_name", None),
        "shape": list(plan.global_size.shape),
        "ranks": plan.partition.num_ranks,
        "transform": getattr(plan, "transform", "r2c"),
        "direction": direction,
        "comm": cfg.comm_method.value,
        "send": cfg.send_method.value,
        "opt": cfg.opt,
        "wire": cfg.wire_dtype,
        "backend": cfg.fft_backend,
        "double_prec": cfg.double_prec,
    }
    seq = getattr(plan, "sequence", None)
    if seq is not None:
        fp["sequence"] = seq.value
    return fp


def finish(plan, out, direction: str, dims: int = 3):
    """Host-side epilogue of a guarded execution: unpack ``(y, stats)``,
    read the stats back (one ``tolist``: the documented cost of
    check/enforce), compare against the build-time tolerances, account
    violations, and enforce the mode. Unguarded executions pass through
    untouched."""
    state = getattr(plan, "_guard_state", {}).get((direction, dims))
    if state is None:
        return out
    y, stats = out
    resid, drift = stats.tolist()
    mode = plan._guard_mode
    fp = fingerprint(plan, direction)
    violations = []
    # NaN residual (corruption reached the reduction itself) must fire:
    # compare via "not <=", which is True for NaN.
    if not resid <= state.tolerance:
        violations.append(("parseval" if state.spec.check == "parseval"
                           else "finite", resid, state.tolerance))
        obs.metrics.inc("guard.parseval_violations")
    if state.probe and drift >= 0 and not drift <= state.wire_budget:
        violations.append(("wire_drift", drift, state.wire_budget))
        obs.metrics.inc("guard.wire_drift_violations")
    if not violations:
        return y
    for check, value, tol in violations:
        obs.notice(
            f"guard[{check}]: residual {value:.3e} exceeds tolerance "
            f"{tol:.3e} ({mode}) on {fp['plan']} {fp['shape']} "
            f"{fp['comm']}/{fp['send']}/opt{fp['opt']}/{fp['wire']} "
            f"{direction}",
            name="guard.violation", check=check, value=value,
            tolerance=tol, mode=mode, **fp)
    if mode == "enforce":
        check, value, tol = violations[0]
        # Dump the last seconds of spans/events/metric deltas BEFORE the
        # violation propagates.
        obs.flightrec.trigger("guard_violation",
                              f"{check} residual {value:.3e} > {tol:.3e}",
                              check=check, value=value, tolerance=tol,
                              plan=fp.get("plan"), shape=fp.get("shape"))
        raise GuardViolation(check, value, tol, fp)
    # check mode: a compressed wire implicated in a violation falls back
    # to native for subsequent calls; the current result is still
    # returned as computed.
    if plan.config.wire_dtype != "native":
        from . import fallback
        fallback.demote_wire(
            plan, reason=f"{violations[0][0]} residual "
                         f"{violations[0][1]:.3e} in check mode")
    return y
