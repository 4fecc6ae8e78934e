"""Plan-time autotuning of the port: the JAX package's
``testing/autotune.py`` on the port's backends and exchanges.

Two races, both on the plan's device:

* the local race (``autotune_local_fft``): a 3D R2C + C2R roundtrip of
  one shape under each local-FFT backend — ``"xla"`` (``torch.fft``,
  cuFFT on the card), ``"pallas"`` (the hand-written kernels),
  ``"matmul"`` / ``"matmul-r2"`` at both precisions and, past the matmul
  backend's ``direct_max``, its all-direct plan, and ``"bluestein"`` only
  where an axis is not 5-smooth (on a smooth shape it IS "xla"). Each
  candidate is gated on its roundtrip error and timed by the chain
  harness (``testing/chaintimer.py``);
* the comm race (``autotune_comm``) and the wire race
  (``autotune_wire``): whole plans built per candidate, forward and
  inverse timed over the plan's ranks, compressed-wire twins gated on
  their forward error against the first native candidate, rank 0's
  ranking agreed over the plan's group(s) so every rank builds the same
  winner.

A candidate that raises, measures degenerately or misses the budget
loses (``ok=False``). A kernel error (``ops._build.KernelError``: a
failed build or launch) is not a losing candidate: it propagates out of
the race, as it does out of the fallback ladder, so a broken kernel can
never quietly make cuFFT win. On the card the same holds for any other
failure of a candidate that runs the hand-written kernels (``"pallas"``
in the local race; a built plan's execution with ``"pallas"`` or a
compressed wire in the comm races): a timeout, an exception other than
running out of memory, a non-finite error, or a roundtrip error over a
budget that cuFFT met is raised as a ``KernelError``.

Each race cell runs under a wall-clock budget
(``$DFFT_AUTOTUNE_CELL_TIMEOUT_S``, default 600 s, 0 disables) in a daemon
thread that is abandoned when it expires. A CUDA cell abandoned that way
keeps launching on the card until it ends by itself: the timeout bounds
the race, not the card's occupancy. As in the JAX package it is off in a
multi-rank world, where abandoning a collective on one rank would hang
its peers.
"""

from __future__ import annotations

import dataclasses as dc
import os
import threading
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import obs
from ..ops._build import KernelError
from ..parallel.mesh import agreement_groups, broadcast_vec, plan_groups
from ..params import OVERLAP_DEPTHS, FFTNorm
from ..resilience import inject
from . import chaintimer


class CellTimeout(RuntimeError):
    """A race cell exceeded its wall-clock budget."""


def _cell_timeout_s() -> Optional[float]:
    """Per-cell wall-clock budget (``$DFFT_AUTOTUNE_CELL_TIMEOUT_S``,
    default 600 s; 0 or negative disables). It stops one wedged candidate
    from stalling the race, not a slow one."""
    raw = os.environ.get("DFFT_AUTOTUNE_CELL_TIMEOUT_S", "").strip()
    try:
        v = float(raw) if raw else 600.0
    except ValueError:
        v = 600.0
    return v if v > 0 else None


def _multi_rank() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def _call_with_timeout(fn, label: str):
    """Run one race cell under the wall-clock budget: in a daemon thread,
    whose expiry raises ``CellTimeout`` (the candidate then fails and the
    others decide). Off in a multi-rank world."""
    timeout = _cell_timeout_s()
    if timeout is None or _multi_rank():
        return fn()
    box = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box["error"] = e

    t = threading.Thread(target=run, daemon=True,
                         name=f"autotune-cell:{label}")
    t.start()
    t.join(timeout)
    if t.is_alive():
        obs.metrics.inc("autotune.cell_timeouts")
        obs.notice(
            f"autotune: cell {label} exceeded {timeout:.0f}s; abandoned "
            "(surviving candidates decide the race)",
            name="autotune.cell_timeout", label=label, timeout_s=timeout)
        raise CellTimeout(f"race cell exceeded {timeout:.0f}s wall clock")
    if "error" in box:
        raise box["error"]
    return box["value"]


def _kernel_candidate(backend: str, device: torch.device) -> bool:
    """True where a local-race candidate launches the hand-written
    kernels: ``"pallas"`` on the card (on the CPU it is their plain
    version)."""
    return backend == "pallas" and device.type == "cuda"


def _plan_runs_kernels(cfg, device: torch.device) -> bool:
    """True where a comm-race candidate's plan launches hand-written
    kernels on the card: the local kernels or the compressed wire's."""
    return device.type == "cuda" and (
        cfg.fft_backend == "pallas"
        or cfg.wire_dtype not in (None, "native"))


def _kernel_fault(label: str, what: str) -> KernelError:
    """The error a failed hand-written-kernel candidate raises instead of
    losing the race."""
    obs.metrics.inc("autotune.kernel_faults")
    return KernelError(
        f"autotune: candidate {label} failed on the card ({what}); a "
        "hand-written kernel's failure is raised, not ranked")


def _resource_limit(e: BaseException) -> bool:
    """Running out of device memory loses a candidate; it is not a fault
    of the kernels."""
    return isinstance(e, torch.cuda.OutOfMemoryError)


def _release(device: torch.device) -> None:
    """Hand a finished candidate's buffers back before the next one."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


@dataclass
class Candidate:
    backend: str
    precision: Optional[str]  # matmul-only: "high" | "highest"
    direct_max: Optional[int] = None  # matmul-only: direct-plan threshold
    per_iter_ms: float = float("nan")
    rel_err: float = float("nan")
    ok: bool = False
    error: Optional[str] = None

    @property
    def label(self) -> str:
        base = self.backend if self.precision is None \
            else f"{self.backend}@{self.precision}"
        if self.direct_max is not None:
            base += f" direct({self.direct_max})"
        return base


def _measure(shape, backend: str, k: int, repeats: int, inner: int,
             x, x_absmax: float,
             settings=None) -> Tuple[float, float, Optional[str]]:
    """(per-iteration ms, roundtrip rel err, degeneracy note) of one
    backend on the device tensor ``x``: both chain lengths are warmed
    before timing (the first "pallas" call may build the kernels, the
    first "xla" call makes a cuFFT plan)."""
    from ..ops import fft as lf

    shape = tuple(int(s) for s in shape)
    scale = 1.0 / float(np.prod(shape))
    kw = dict(norm=FFTNorm.NONE, backend=backend, settings=settings)
    with torch.no_grad():
        y = lf.irfftn_3d(lf.rfftn_3d(x, **kw), shape, **kw)
        rel = float((y * scale - x).abs().max()) / x_absmax
        del y
    fn1 = chaintimer.roundtrip_chain(1, shape, backend, settings=settings)
    fnK = chaintimer.roundtrip_chain(k, shape, backend, settings=settings)
    chaintimer._fence(fn1(x))
    chaintimer._fence(fnK(x))
    per_ms, _ = chaintimer.median_pair_diff_ms(fn1, fnK, x, k, repeats, inner)
    if per_ms <= 0:
        return per_ms, rel, (f"degenerate timing (median t_K-t_1 <= 0 at "
                             f"k={k}; raise k so the work dominates noise)")
    return per_ms, rel, None


def autotune_local_fft(shape: Sequence[int], budget_rel_err: float = 1e-4,
                       k: int = 257, repeats: int = 3, inner: int = 3,
                       backends: Optional[Sequence[str]] = None,
                       double_prec: bool = False, seed: int = 0,
                       verbose: bool = False,
                       device: "str | torch.device" = "cuda"
                       ) -> List[Candidate]:
    """Race the local-FFT backends for a 3D R2C + C2R roundtrip of
    ``shape`` on ``device``. ``double_prec`` races float64 (the matmul
    backend then runs at HIGHEST only: one candidate). Returns the
    candidates fastest first; those over the budget, degenerate or
    failing have ``ok=False`` (``error`` set for the last two) and sort
    last. A ``KernelError`` propagates. Apply the winner with
    ``apply_best``."""
    from ..ops import fft as lf
    from ..ops import mxu_fft
    from ..ops.bluestein import is_smooth

    device = torch.device(device)
    if backends is None:
        backends = lf.BACKENDS
    dt = np.float64 if double_prec else np.float32
    xs = np.random.default_rng(seed).random(tuple(shape)).astype(dt)
    x_absmax = float(np.abs(xs).max()) or 1.0
    x = torch.from_numpy(xs).to(device)
    del xs

    cands: List[Candidate] = []
    n_max = int(max(shape))
    for b in backends:
        if b == "bluestein" and all(is_smooth(int(n)) for n in shape):
            # On a 5-smooth shape "bluestein" makes the exact "xla" calls:
            # it would time the same program twice.
            continue
        if b in ("matmul", "matmul-r2") and not double_prec:
            cands += [Candidate(b, "high"), Candidate(b, "highest")]
            # Past the deployed direct threshold the default plan is the
            # four-step: race the all-direct plan too (matmul only).
            if b == "matmul" and n_max > mxu_fft.current_settings(
                    ).direct_max:
                cands.append(Candidate(b, "high", direct_max=n_max))
        else:
            cands.append(Candidate(b, None))

    if k < 2:
        raise ValueError(f"k must be >= 2 (got {k}): the (t_K - t_1) pair "
                         "difference needs at least one extra iteration")
    for c in cands:
        # Matmul variants race at their own precision (and direct_max)
        # through an explicit MXUSettings on the deployed defaults, so the
        # measurement predicts what apply_best's Config resolves to.
        st = None
        if c.precision is not None:
            st = dc.replace(mxu_fft.current_settings(),
                            precision=mxu_fft.as_precision(c.precision))
            if c.direct_max is not None:
                st = dc.replace(st, direct_max=c.direct_max)
        obs.metrics.inc("autotune.race_cells")
        try:
            with obs.span("autotune.race_cell", race="local_fft",
                          label=c.label):
                def cell(c=c, st=st):
                    # The injected hang runs inside the timed cell, so a
                    # simulated wedge exercises the timeout.
                    inject.maybe_hang_cell(c.label)
                    return _measure(shape, c.backend, k, repeats, inner,
                                    x, x_absmax, settings=st)

                c.per_iter_ms, c.rel_err, c.error = _call_with_timeout(
                    cell, c.label)
            c.ok = (c.error is None and c.rel_err <= budget_rel_err)
        except KernelError:
            raise
        except Exception as e:  # noqa: BLE001 — backend unavailable / timeout
            if _kernel_candidate(c.backend, device) and not _resource_limit(e):
                raise _kernel_fault(c.label,
                                    f"{type(e).__name__}: {e}") from e
            c.error = f"{type(e).__name__}: {e}"
        else:
            if (_kernel_candidate(c.backend, device)
                    and not np.isfinite(c.rel_err)):
                raise _kernel_fault(c.label,
                                    f"roundtrip rel err {c.rel_err}")
        _release(device)
        if verbose:
            print(f"  {c.label:16s} {c.per_iter_ms:8.3f} ms  "
                  f"rel_err {c.rel_err:.2e}  ok={c.ok}"
                  + (f"  ({c.error})" if c.error else ""), flush=True)

    # A kernel over a budget that cuFFT met is wrong, not slow (a budget
    # below the precision's floor fails both and stays a losing race).
    ref = next((c for c in cands if c.backend == "xla"
                and np.isfinite(c.rel_err)), None)
    for c in cands:
        if (_kernel_candidate(c.backend, device) and np.isfinite(c.rel_err)
                and c.rel_err > budget_rel_err
                and (ref is None or ref.rel_err <= budget_rel_err)):
            raise _kernel_fault(
                c.label, f"roundtrip rel err {c.rel_err:.2e} over budget "
                f"{budget_rel_err:.0e}"
                + ("" if ref is None else
                   f", which xla met at {ref.rel_err:.2e}"))

    # A NaN time (failed before timing) must not poison the sort key.
    return sorted(cands, key=lambda c: (
        not c.ok,
        c.per_iter_ms if np.isfinite(c.per_iter_ms) else float("inf")))


def describe_failures(candidates: List[Candidate]) -> str:
    """One reason per failed candidate (failure/degenerate vs accuracy)."""
    parts = []
    for c in candidates:
        if c.ok:
            continue
        parts.append(f"{c.label}: {c.error}" if c.error
                     else f"{c.label}: rel_err {c.rel_err:.2e} over budget")
    return "; ".join(parts)


@dataclass
class CommCandidate:
    """One point of the comm matrix: comm method per transpose x layout
    opt, optionally crossed with the send method (``send``/``chunks``:
    STREAMS pieces, a ring, or SYNC's pipelined all-to-all with
    ``subblocks``), the overlap knobs (``depth``, ``subblocks``) and the
    wire (``wire``; a ``"bf16"`` twin carries its forward error against
    the native reference in ``wire_rel_err`` and is gated on the budget).
    ``None`` on an axis keeps the base Config's value and is never
    folded."""
    comm: object                 # CommMethod for transpose 1
    comm2: Optional[object]      # pencil transpose 2 (None for slab)
    opt: int
    send: object = None          # SendMethod.STREAMS/RING variants only
    chunks: Optional[int] = None  # streams_chunks for send=STREAMS
    wire: Optional[str] = None   # wire dtype; None = base config's (unraced)
    depth: Optional[int] = None  # overlap_depth; None = base's (unraced)
    subblocks: Optional[int] = None  # overlap_subblocks; None = base's
    fwd_ms: float = float("nan")
    inv_ms: float = float("nan")
    wire_rel_err: float = float("nan")  # bf16 only: fwd max rel err vs native
    ok: bool = False
    error: Optional[str] = None

    @property
    def total_ms(self) -> float:
        return self.fwd_ms + self.inv_ms

    @property
    def label(self) -> str:
        c1 = self.comm.value
        tag = c1 if self.comm2 is None else f"{c1}+{self.comm2.value}"
        tag = f"{tag}/opt{self.opt}"
        name = getattr(self.send, "name", None)
        if name == "RING":
            tag += "/ring"
        elif name == "RING_OVERLAP":
            tag += "/ring-ovl"
            if self.depth not in (None, 2):
                tag += f"-d{self.depth}"
        elif name == "STREAMS":
            tag += f"/streams{self.chunks}"
        elif (name in ("SYNC", "MPI_TYPE")
                and self.subblocks not in (None, 1)):
            tag += "/a2a-pipe"
        if self.subblocks not in (None, 1):
            tag += f"/sub{self.subblocks}"
        if self.wire not in (None, "native"):
            tag += f"/{self.wire}"
        return tag


def _time_plan_ms(fn, x, iterations: int, warmup: int) -> float:
    """Mean ms of one call of a plan direction (host clock, fenced by the
    device's synchronize; every rank times the same calls)."""
    from .microbench import _time_fn

    return _time_fn(fn, x, iterations, warmup) * 1e3


def _measure_comm_candidates(cands, kind, global_size, partition, base,
                             sequence, dims, transform, iterations, warmup,
                             seed, budget, verbose, device, group):
    """The comm and wire races' measurement loop: build every candidate's
    plan, time its forward and inverse, and gate compressed-wire twins
    on their forward error against the FIRST successful native
    candidate's output (every native rendering gives the same forward
    output), so lists put natives before twins."""
    from ..resilience import fallback
    from . import testcases as tc
    from .microbench import max_rel_err

    dev = torch.device(device)
    rdt = np.float64 if base.double_prec else np.float32
    xs = np.random.default_rng(seed).random(
        tuple(global_size.shape)).astype(rdt)
    ref_spec = None
    for c in cands:
        obs.metrics.inc("autotune.race_cells")
        try:
            with obs.span("autotune.race_cell", race="comm", label=c.label):
                # guards off: the race times the production program; the
                # ladder suppressed: a failing candidate must lose, not
                # measure its own demotion.
                cfg = dc.replace(base, comm_method=c.comm,
                                 comm_method2=c.comm2, opt=c.opt,
                                 guards="off")
                if c.send is not None:
                    cfg = dc.replace(cfg, send_method=c.send,
                                     send_method2=None,
                                     streams_chunks=c.chunks)
                if c.depth is not None:
                    cfg = dc.replace(cfg, overlap_depth=int(c.depth))
                if c.subblocks is not None:
                    cfg = dc.replace(cfg,
                                     overlap_subblocks=int(c.subblocks))
                if c.wire is not None:
                    cfg = dc.replace(cfg, wire_dtype=c.wire)

                def cell(cfg=cfg, label=c.label):
                    inject.maybe_hang_cell(label)
                    with fallback.suppressed():
                        # A rendering refused here loses; once built, a
                        # plan on the kernels that fails is their fault.
                        plan = tc.make_plan(kind, global_size, partition,
                                            cfg, sequence=sequence,
                                            transform=transform,
                                            device=device, group=group)
                        try:
                            x = plan.pad_input(xs)
                            fwd, inv = tc._fused_fns(plan, dims)
                            fwd_ms = _time_plan_ms(fwd, x, iterations,
                                                   warmup)
                            spec = fwd(x)
                            inv_ms = _time_plan_ms(inv, spec, iterations,
                                                   warmup)
                        except KernelError:
                            raise
                        except Exception as e:  # noqa: BLE001
                            if (_plan_runs_kernels(cfg, dev)
                                    and not _resource_limit(e)):
                                raise _kernel_fault(
                                    label, f"{type(e).__name__}: {e}") from e
                            raise
                    return fwd_ms, spec, inv_ms, plan_groups(plan)

                c.fwd_ms, spec, c.inv_ms, groups = _call_with_timeout(
                    cell, c.label)
                compressed = c.wire not in (None, "native")
                if not compressed and ref_spec is None:
                    ref_spec = spec
                if compressed:
                    # The gate runs before ok is set: a lossy candidate
                    # whose accuracy could not be established never ranks.
                    if ref_spec is None:
                        raise RuntimeError(
                            "no native reference measured before the "
                            "compressed candidate (racer list-order "
                            "contract)")
                    c.wire_rel_err = max_rel_err(spec, ref_spec, groups)
                    if (_plan_runs_kernels(cfg, dev)
                            and not np.isfinite(c.wire_rel_err)):
                        raise _kernel_fault(
                            c.label, f"wire rel err {c.wire_rel_err}")
                    if not c.wire_rel_err <= budget:
                        c.error = (f"wire rel err {c.wire_rel_err:.2e} over "
                                   f"budget {budget:.0e}")
                        obs.metrics.inc("wire.budget_rejections")
                        obs.event("wire.budget_rejected", label=c.label,
                                  rel_err=float(c.wire_rel_err),
                                  budget=float(budget))
                    else:
                        c.ok = True
                else:
                    c.ok = True
                del spec
        except KernelError:
            raise
        except Exception as e:  # noqa: BLE001 — rendering unavailable here
            c.ok = False
            c.error = f"{type(e).__name__}: {e}"
        _release(dev)
        if verbose:
            werr = ("" if not np.isfinite(c.wire_rel_err)
                    else f"  wire_err {c.wire_rel_err:.2e}")
            print(f"  {c.label:28s} fwd {c.fwd_ms:8.3f} ms  "
                  f"inv {c.inv_ms:8.3f} ms  ok={c.ok}{werr}"
                  + (f"  ({c.error})" if c.error else ""), flush=True)
    return ref_spec


def _rank_and_agree(cands, groups=()) -> List[CommCandidate]:
    """Sort the measured candidates fastest first, then agree on rank 0's
    winner over ``groups`` (candidates are often within noise, and ranks
    with different Configs would post different collectives). The
    broadcast is unconditional (-1: nothing ran on rank 0), so a rank
    whose candidates all failed still posts it."""
    ranked = sorted(cands, key=lambda c: (
        not c.ok,
        c.total_ms if np.isfinite(c.total_ms) else float("inf")))
    if groups and ranked:
        idx = (next(i for i, c in enumerate(cands) if c is ranked[0])
               if ranked[0].ok else -1)
        idx = int(broadcast_vec([idx], groups)[0])
        if idx >= 0:
            win = cands[idx]
            ranked.remove(win)
            ranked.insert(0, win)
        else:
            # Rank 0 had no usable strategy: fail the same way everywhere.
            for c in ranked:
                c.ok = False
                c.error = c.error or "process 0 had no usable strategy"
    return ranked


def autotune_comm(kind: str, global_size, partition, base_config=None,
                  sequence=None, iterations: int = 5, warmup: int = 2,
                  race_opt: bool = True, seed: int = 0, dims: int = 3,
                  transform: str = "r2c", race_send: bool = False,
                  streams_chunks: Sequence[int] = (4,),
                  overlap_depths: Sequence[int] = OVERLAP_DEPTHS,
                  overlap_splits: Sequence[int] = (1, 2),
                  race_wire: bool = False,
                  wire_error_budget: Optional[float] = None,
                  verbose: bool = False,
                  device: "str | torch.device" = "cuda",
                  group=None) -> List[CommCandidate]:
    """Race the exchange renderings of a plan over its ranks (every rank
    calls it, in the same order): ALL2ALL vs PEER2PEER per transpose
    (the pencil's 2 x 2 matrix at ``dims`` 3) crossed with opt 0/1.

    ``race_send`` adds, under each ALL2ALL point, STREAMS at every piece
    count of ``streams_chunks``, the pipelined all-to-all per split of
    ``overlap_splits`` > 1, and once (under the first opt) the RING and a
    RING_OVERLAP per depth x split (the rings own the exchange whatever
    the comm method and opt). ``race_wire`` crosses every cell with a
    ``wire="bf16"`` twin gated on ``wire_error_budget`` (None: the base's
    ``resolved_wire_budget``), natives first as the error reference.

    Returns the candidates sorted by forward + inverse ms, rank 0's
    winner first on every rank; apply it with ``apply_best_comm``."""
    from ..params import AUTO, CommMethod, Config, SendMethod

    base = base_config or Config()
    if base.wire_dtype == AUTO or race_wire:
        # Candidates never carry an unresolved marker, and race_wire owns
        # the wire axis: untwinned candidates run native (the reference).
        base = dc.replace(base, wire_dtype="native")
    budget = (wire_error_budget if wire_error_budget is not None
              else base.resolved_wire_budget())
    both = (CommMethod.ALL2ALL, CommMethod.PEER2PEER)
    opts = (0, 1) if race_opt else (base.opt,)
    race_comm2 = kind == "pencil" and dims >= 3
    depth_axis = tuple(dict.fromkeys(
        int(d) for d in overlap_depths if int(d) >= 2)) or (2,)
    split_axis = tuple(dict.fromkeys(
        int(s) for s in overlap_splits if int(s) >= 1)) or (1,)
    cands: List[CommCandidate] = []
    for opt in opts:
        for c1 in both:
            pairs = [(c1, c2) for c2 in both] if race_comm2 else [(c1, None)]
            for cc1, cc2 in pairs:
                cands.append(CommCandidate(cc1, cc2, opt))
                if (race_send and cc1 is CommMethod.ALL2ALL
                        and cc2 in (None, CommMethod.ALL2ALL)):
                    cands += [CommCandidate(cc1, cc2, opt,
                                            send=SendMethod.STREAMS,
                                            chunks=int(k))
                              for k in streams_chunks if k and int(k) > 1]
                    cands += [CommCandidate(cc1, cc2, opt,
                                            send=SendMethod.SYNC,
                                            subblocks=int(s))
                              for s in split_axis if int(s) > 1]
                    if opt == opts[0]:
                        cands.append(CommCandidate(cc1, cc2, opt,
                                                   send=SendMethod.RING))
                        for d in depth_axis:
                            for s in split_axis:
                                cands.append(CommCandidate(
                                    cc1, cc2, opt,
                                    send=SendMethod.RING_OVERLAP,
                                    depth=None if d == 2 else d,
                                    subblocks=None if s == 1 else s))
    if race_wire:
        for c in cands:
            c.wire = "native"
        cands = cands + [dc.replace(c, wire="bf16") for c in cands]

    with obs.span("autotune.race_comm", kind=kind,
                  shape=list(global_size.shape), cells=len(cands),
                  race_wire=bool(race_wire)):
        _measure_comm_candidates(cands, kind, global_size, partition, base,
                                 sequence, dims, transform, iterations,
                                 warmup, seed, budget, verbose, device,
                                 group)
        return _rank_and_agree(
            cands, agreement_groups(kind, partition, group))


def autotune_wire(kind: str, global_size, partition, base_config=None,
                  sequence=None, iterations: int = 5, warmup: int = 2,
                  seed: int = 0, dims: int = 3, transform: str = "r2c",
                  error_budget: Optional[float] = None,
                  verbose: bool = False,
                  device: "str | torch.device" = "cuda",
                  group=None) -> List[CommCandidate]:
    """Race ONLY the wire on the base Config's own rendering (the
    ``wire_dtype="auto"`` path when the comm choice is explicit): the
    rendering at ``"native"`` (the error reference) and at ``"bf16"``,
    gated on ``error_budget`` (None: the base's ``resolved_wire_budget``).
    Fold the winner with ``apply_best_comm``."""
    from ..params import AUTO, Config

    base = base_config or Config()
    if base.wire_dtype == AUTO:
        base = dc.replace(base, wire_dtype="native")
    budget = (error_budget if error_budget is not None
              else base.resolved_wire_budget())
    comm2 = base.comm_method2 if kind == "pencil" else None
    # send stays None: the candidates run the base's send methods as they
    # are (send_method2 included).
    cands = [CommCandidate(base.comm_method, comm2, base.opt, wire=w)
             for w in ("native", "bf16")]
    with obs.span("autotune.race_wire", kind=kind,
                  shape=list(global_size.shape)):
        _measure_comm_candidates(cands, kind, global_size, partition, base,
                                 sequence, dims, transform, iterations,
                                 warmup, seed, budget, verbose, device,
                                 group)
        return _rank_and_agree(
            cands, agreement_groups(kind, partition, group))


def apply_best_comm(candidates: List[CommCandidate], base_config=None):
    """The winning comm matrix point folded into a Config (only the axes
    that were raced). Raises when nothing ran."""
    from ..params import Config

    best = candidates[0]
    if not best.ok:
        errs = "; ".join(f"{c.label}: {c.error}" for c in candidates)
        raise RuntimeError(f"comm autotune: no strategy ran; {errs}")
    cfg = dc.replace(base_config or Config(), comm_method=best.comm,
                     opt=best.opt)
    if best.comm2 is not None:
        # Only where it was raced: an explicit comm_method2 survives.
        cfg = dc.replace(cfg, comm_method2=best.comm2)
    if best.send is not None:
        cfg = dc.replace(cfg, send_method=best.send, send_method2=None,
                         streams_chunks=best.chunks)
    if best.depth is not None:
        cfg = dc.replace(cfg, overlap_depth=int(best.depth))
    if best.subblocks is not None:
        cfg = dc.replace(cfg, overlap_subblocks=int(best.subblocks))
    if best.wire is not None:
        cfg = dc.replace(cfg, wire_dtype=best.wire)
    return cfg


def apply_best(candidates: List[Candidate]):
    """The winning candidate as a ``Config``: the backend and, for the
    matmul variants, the raced precision and direct-plan threshold as
    plan state (``mxu_precision`` / ``mxu_direct_max``). Raises when no
    candidate passed."""
    from ..params import Config

    best = candidates[0]
    if not best.ok:
        raise RuntimeError(
            f"autotune: no usable backend; {describe_failures(candidates)}")
    return Config(fft_backend=best.backend, mxu_precision=best.precision,
                  mxu_direct_max=best.direct_max)
