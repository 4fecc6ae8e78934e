"""Graceful-degradation fallback ladder: demote, don't die — the port's
``resilience/fallback.py``, after the JAX package's.

A resolved rendering can fail AFTER construction: a ring whose
point-to-point transport breaks, a realigned pack that fails at some
shape, a compressed wire whose drift trips the guards. This module turns
such failures into a LADDER: when a plan's pipeline raises, the plan
demotes exactly ONE rung, rebuilds, and retries —

    ring/streams -> opt1 (the realigned all-to-all)
                 -> default layout (opt 0)
                 -> explicit All2All (from Peer2Peer)
    bf16 wire    -> native wire        (also on a check-mode GuardViolation)

until the ladder is exhausted, at which point the last error propagates
(the default SYNC/opt0/All2All/native config has zero rungs, so a plain
plan's errors are NEVER retried or masked). Every demotion is loud: an
``obs.notice``, ``fallback.demotions`` (+ per-rung) metrics and a
flight-recorder dump.

Differences from the JAX package, both deliberate:

* **Kernel errors are not rungs.** ``ops._build.KernelError`` (a kernel
  that does not build, or a launch that returned a CUDA error) is
  re-raised as ``GuardViolation`` is: a failing hand-written kernel is a
  fault to report, never stepped around, and a failed launch can leave
  the CUDA context unusable for every other rung.
* **Rank agreement.** The JAX package walks the ladder in its one
  process; here every rank runs its own ``execute``. On P > 1 ranks, and
  only while the plan has a rung left, each attempt's outcome is agreed
  over the plan's group with a one-element MAX all-reduce, so every rank
  demotes together (a rank whose attempt succeeded while a peer's failed
  demotes too). The default rendering has zero rungs and posts nothing
  extra. Agreement needs every rank to reach it: a rank that fails inside
  an exchange its peers still wait in cannot be saved by it.

The ladder is suppressed inside ``suppressed()`` (a candidate measured in
a race must fail, not measure its own demotion). ``$DFFT_FALLBACK=off``
disables it process-wide.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from .. import obs
from .. import params as pm
from ..ops._build import KernelError
from . import guards

# Rung identifiers, in ladder order (ladder_preview / metrics vocabulary).
RUNG_SEND = "send"    # ring/streams -> SYNC at the realigned (opt1) layout
RUNG_OPT = "opt"      # opt1 -> default layout
RUNG_COMM = "comm"    # Peer2Peer -> explicit All2All
RUNG_WIRE = "wire"    # compressed wire -> native


class _Tls(threading.local):
    def __init__(self):
        self.suppressed = 0


_TLS = _Tls()


class PeerFailed(RuntimeError):
    """This rank's attempt succeeded but a peer's failed: the ranks walk
    the ladder together."""


@contextlib.contextmanager
def suppressed():
    """Disable the ladder for the calling thread (a failing candidate
    must rank as failed, not measure its demotion)."""
    _TLS.suppressed += 1
    try:
        yield
    finally:
        _TLS.suppressed -= 1


def enabled() -> bool:
    if _TLS.suppressed:
        return False
    return os.environ.get("DFFT_FALLBACK", "").strip().lower() != "off"


def next_rung(cfg) -> Tuple[Optional[object], Optional[str]]:
    """``(demoted config, rung name)`` one rung down the ladder, or
    ``(None, None)`` when exhausted. Exactly one axis moves per call."""
    sends = (cfg.send_method, cfg.send_method2)
    if (any(s not in (None, pm.SendMethod.SYNC, pm.SendMethod.MPI_TYPE)
            for s in sends)
            or cfg.resolved_overlap_subblocks() > 1):
        # The pipelined renderings — rings at any overlap depth, sub-
        # block splits, AND the pipelined all-to-all (Sync + subblocks
        # > 1) — demote to the realigned MONOLITHIC exchange (the
        # ladder's "opt1" rung); the overlap knobs reset too, or the
        # "demoted" cell would still be the pipelined all-to-all.
        return dataclasses.replace(
            cfg, send_method=pm.SendMethod.SYNC, send_method2=None,
            streams_chunks=None, overlap_depth=pm.AUTO,
            overlap_subblocks=None, opt=1), RUNG_SEND
    if cfg.opt == 1:
        return dataclasses.replace(cfg, opt=0), RUNG_OPT
    if (cfg.comm_method is pm.CommMethod.PEER2PEER
            or cfg.comm_method2 is pm.CommMethod.PEER2PEER):
        return dataclasses.replace(cfg, comm_method=pm.CommMethod.ALL2ALL,
                                   comm_method2=None), RUNG_COMM
    if cfg.wire_dtype != "native":
        return dataclasses.replace(cfg, wire_dtype="native"), RUNG_WIRE
    return None, None


def _describe_comm(cfg) -> str:
    """Compact human label of a comm/send/opt/wire choice (the JAX
    package's ``utils/wisdom._describe_comm``)."""
    tag = cfg.comm_method.value
    if cfg.comm_method2 is not None:
        tag += f"+{cfg.comm_method2.value}"
    tag += f"/opt{cfg.opt}"
    if cfg.send_method is pm.SendMethod.RING_OVERLAP:
        tag += "/ring-ovl"
        if cfg.resolved_overlap_depth() != 2:
            tag += f"-d{cfg.resolved_overlap_depth()}"
    elif cfg.send_method is pm.SendMethod.RING:
        tag += "/ring"
    elif cfg.send_method is pm.SendMethod.STREAMS:
        tag += f"/streams{cfg.resolved_streams_chunks()}"
    if cfg.resolved_overlap_subblocks() > 1:
        tag += f"/sub{cfg.resolved_overlap_subblocks()}"
    if cfg.wire_dtype != "native":
        tag += f"/{cfg.wire_dtype}"
    return tag


def ladder_preview(cfg) -> list:
    """Human-readable rung sequence that WOULD apply to ``cfg``:
    ``[(rung, label), ...]``."""
    out = []
    cur = cfg
    while True:
        cur, rung = next_rung(cur)
        if cur is None:
            break
        out.append((rung, _describe_comm(cur)))
    return out


# The pipeline caches of the port's plans (slab and base: ``_r2c`` /
# ``_c2r``; batched: ``_fwd`` / ``_inv``; pencil: one per depth; every
# family's ``forward_fn`` / ``inverse_fn`` in ``_pure``), cleared on any
# config change so the next call rebuilds under the demoted rendering.
_CACHE_ATTRS = ("_r2c", "_c2r", "_fwd", "_inv")
_CACHE_DICTS = ("_fwd_d", "_inv_d", "_pure")


def apply_config(plan, cfg) -> None:
    """Install a demoted config on a live plan: swap the config, refresh
    the matmul-settings snapshot, and drop every pipeline cache (and the
    guard states, whose tolerances depend on the wire)."""
    plan.config = cfg
    plan._mxu_st = cfg.mxu_settings()
    for a in _CACHE_ATTRS:
        if hasattr(plan, a):
            setattr(plan, a, None)
    for a in _CACHE_DICTS:
        d = getattr(plan, a, None)
        if isinstance(d, dict):
            d.clear()
    st = getattr(plan, "_guard_state", None)
    if isinstance(st, dict):
        st.clear()


def _stamp_wisdom(plan, rung: str, reason: str) -> None:
    """Best-effort demotion stamp on the plan's wisdom record(s): the
    slot(s) whose recommendation produced the failing rendering. A
    stamped record reads as a miss, so the store stops recommending it
    until a fresh race re-records it. Nothing without a store."""
    from ..utils import wisdom
    try:
        store = wisdom.store_for_config(plan.config)
        if store is None:
            return
        key = wisdom.plan_wisdom_key(plan)
        slots = ("wire", "comm") if rung == RUNG_WIRE else ("comm",)
        for slot in slots:
            wisdom.stamp_demotion(store, key, slot, rung, reason)
    except Exception:  # noqa: BLE001 — stamping degrades, never errors
        pass


def _note_demotion(plan, rung: str, label: str, reason: str) -> None:
    obs.metrics.inc("fallback.demotions")
    obs.metrics.inc(f"fallback.{rung}_demotions")
    fp = guards.fingerprint(plan, "n/a")
    obs.notice(
        f"fallback[{rung}]: demoting {fp['plan']} {fp['shape']} one rung "
        f"-> {label} ({reason})",
        name="fallback.demotion", rung=rung, to=label, reason=reason,
        plan=fp["plan"], shape=fp["shape"], ranks=fp["ranks"])
    # A rung walk means the shipped rendering failed: dump the evidence
    # leading up to it.
    obs.flightrec.trigger("fallback_demotion",
                          f"rung {rung} -> {label}: {reason}"[:200],
                          rung=rung, plan=fp["plan"], shape=fp["shape"])
    _stamp_wisdom(plan, rung, reason)


def demote(plan, err: BaseException) -> bool:
    """Walk the plan one rung down after a pipeline failure; False when
    the ladder is exhausted or disabled (caller re-raises)."""
    if not enabled():
        return False
    cfg, rung = next_rung(plan.config)
    if cfg is None:
        return False
    reason = f"{type(err).__name__}: {err}"[:300]
    _note_demotion(plan, rung, _describe_comm(cfg), reason)
    apply_config(plan, cfg)
    return True


def demote_wire(plan, reason: str) -> None:
    """Check-mode guard response: the compressed wire falls back to
    native for subsequent calls (rendering unchanged)."""
    if plan.config.wire_dtype == "native":
        return
    obs.metrics.inc("fallback.demotions")
    obs.metrics.inc("fallback.wire_demotions")
    fp = guards.fingerprint(plan, "n/a")
    obs.notice(
        f"fallback[wire]: {fp['plan']} {fp['shape']} wire "
        f"{plan.config.wire_dtype} -> native ({reason})",
        name="fallback.demotion", rung=RUNG_WIRE, to="native",
        reason=reason, plan=fp["plan"], shape=fp["shape"])
    obs.flightrec.trigger("fallback_demotion",
                          f"wire -> native: {reason}"[:200],
                          rung=RUNG_WIRE, plan=fp["plan"],
                          shape=fp["shape"])
    _stamp_wisdom(plan, RUNG_WIRE, reason)
    apply_config(plan, dataclasses.replace(plan.config,
                                           wire_dtype="native"))


def _agrees(plan) -> bool:
    """Whether an attempt's outcome must be agreed over the ranks: a
    distributed plan with a rung left on an enabled ladder."""
    return (not getattr(plan, "fft3d", True) and enabled()
            and next_rung(plan.config)[0] is not None)


def _any_rank_failed(plan, failed: bool) -> bool:
    """One-element MAX all-reduce of this rank's failure flag over the
    plan's group (the pencil's: the world), under its own stage scope
    (``dfft/resilience/agree``): a rank waits here for the slowest, and a
    stage profile names that wait instead of leaving it unattributed."""
    with obs.profile.stage_scope("resilience", "agree"):
        flag = torch.tensor([int(failed)], dtype=torch.int32,
                            device=plan.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=plan.group)
        return bool(flag.item())


def execute(plan, direction: str, x, get_runner, dims: int = 3):
    """The resilience envelope around one plan execution: run the (cached,
    possibly guarded) pipeline; on failure walk the ladder one rung
    (rebuild via ``get_runner`` — the plan's builder reads the demoted
    config) and retry; on success run the host-side guard epilogue.

    ``GuardViolation`` (enforce mode) and ``KernelError`` are never
    retried. A default-rendering plan has zero rungs, so its errors
    propagate as they are. On P > 1 ranks with a rung left, the ranks
    agree on each attempt's outcome (module docstring).

    Deadline plumbing: with an ambient cooperative deadline open
    (``resilience.deadline.scope``), the ladder walk is bounded by the
    TIGHTER of it and ``DFFT_FALLBACK_DEADLINE_S``, and the original error
    (not a timeout) propagates."""
    from . import deadline as _dl
    horizon = time.monotonic() + min(
        float(os.environ.get("DFFT_FALLBACK_DEADLINE_S", "600")),
        _dl.remaining_s(float("inf")))
    while True:
        agree = _agrees(plan)
        out, err = None, None
        try:
            out = get_runner()(x)
        except (guards.GuardViolation, KernelError):
            raise
        except Exception as e:  # noqa: BLE001 — the ladder's contract
            err = e
        if agree and _any_rank_failed(plan, err is not None) and err is None:
            err = PeerFailed(f"a peer rank's {direction} attempt failed")
        if err is None:
            return guards.finish(plan, out, direction, dims)
        if time.monotonic() > horizon or not demote(plan, err):
            raise err
