"""Static hazard checker for the revolving-buffer ring schedules — the
JAX package's ``analysis/schedverify.py``, over the port's ring.

``SendMethod.RING_OVERLAP`` (``parallel/transpose._ring_transpose_impl``)
pipelines the ``P-1``-step point-to-point ring with revolving receive
buffers: micro-step ``m + depth - 1``'s ``batch_isend_irecv`` is posted
before block ``m`` is waited on and computed, so transfers stay in flight
under every block's FFTs. That schedule is correct only while the buffer
discipline holds — a block must never be read before its transfer
completes, and a transfer must never be posted into a buffer whose
previous block is still unconsumed. The port's ring posts into
``min(depth, micro-steps)`` revolving buffers (``bufs[m % len(bufs)]``)
and clones an arrival that aliases its buffer; this module proves the
issue order safe at every depth, and the port's tests hold the order the
ring actually issues against ``revolving_schedule``.

A **schedule** is the ordered per-device op list of one ring exchange
(SPMD: every device runs the same program on its own rotation):

* ``issue(t, buf)`` — start step ``t``'s transfer; the received block
  will land in revolving buffer ``buf``. The send operand (chunk ``t``
  of the resident array) is always ready, so the only hazard surface is
  the RECEIVE buffer.
* ``wait(t)``  — block until step ``t``'s transfer completes.
* ``compute(t)`` — consume block ``t`` from its buffer (the per-block
  decode + pipelined FFTs), freeing the buffer.

Hazard classes (``HAZARD_KINDS``; the mutation self-test proves each is
caught):

* ``read-before-arrive``  — ``compute(t)`` with no prior ``wait(t)``:
  the per-block FFT reads a buffer whose DMA has not completed;
* ``write-after-send``    — ``issue`` into a buffer whose previous
  block is issued but not yet computed: the incoming transfer overwrites
  (or races) data still needed;
* ``buffer-overflow``     — a buffer index outside the declared depth;
* ``lost-block``          — a step never issued / waited / computed (a
  hole in the exchange: the assembled output would be missing a peer's
  block);
* ``malformed``           — duplicate or out-of-order ops of one step
  (``wait`` before ``issue``, double ``compute``, ...).

``revolving_schedule(p, depth)`` generates the depth-D generalization of
the shipped schedule: pre-issue ``depth-1`` steps, then inside the loop
issue step ``t+depth-1`` BEFORE computing block ``t`` — at ``depth=2``
this is op-for-op the order ``_ring_transpose_impl`` issues under
``overlap=True`` (post ``t+1``'s transfer, then land block ``t``), and
at ``depth=1`` it degenerates to the plain serial RING. ``describe``
joins the timeline with ``transpose.ring_schedule``'s byte accounting so
one call answers both "is it safe" and "what is in flight".
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

HAZARD_KINDS = ("read-before-arrive", "write-after-send",
                "buffer-overflow", "lost-block", "malformed")

_OPS = ("issue", "wait", "compute")


@dataclasses.dataclass(frozen=True)
class SchedOp:
    """One schedule event: ``op`` in {issue, wait, compute}, ``step`` the
    ring step (1..P-1; step 0 is the local block and never scheduled),
    ``buf`` the revolving receive-buffer index (issue only; -1 = n/a)."""

    op: str
    step: int
    buf: int = -1

    def __post_init__(self) -> None:
        if self.op not in _OPS:
            raise ValueError(f"op must be one of {_OPS}, got {self.op!r}")

    def __str__(self) -> str:
        if self.op == "issue":
            return f"issue(step {self.step} -> buf {self.buf})"
        return f"{self.op}(step {self.step})"


@dataclasses.dataclass(frozen=True)
class Hazard:
    """One detected hazard; ``kind`` is the class the mutation tests
    assert on."""

    kind: str
    step: int
    message: str

    def __str__(self) -> str:
        return f"[schedverify/{self.kind}] step {self.step}: {self.message}"


def revolving_schedule(p: int, depth: int = 2,
                       subblocks: int = 1) -> Tuple[SchedOp, ...]:
    """The depth-D revolving-buffer pipeline of a ``p``-rank ring:
    ``p-1`` steps, up to ``depth`` blocks outstanding, block ``t`` in
    buffer ``(t-1) % depth``. ``depth=2`` reproduces the shipped
    RING_OVERLAP issue order (step ``t+1``'s transfer before block
    ``t``'s compute); ``depth=1`` is the plain serial RING; ``p <= 1``
    (single-peer degenerate) schedules nothing.

    ``subblocks`` > 1 models the block-granularity axis: each peer step
    becomes ``subblocks`` MICRO-steps (sub-block ``(m-1) % S`` of peer
    step ``(m-1) // S + 1`` — the exact linearization
    ``_ring_transpose_impl`` issues), each riding its own transfer into
    its own revolving buffer, so the checker proves the sub-block
    schedule under the same buffer discipline. The effective depth caps
    at ``(p-1) * subblocks``."""
    if p < 1:
        raise ValueError(f"ring size must be >= 1, got {p}")
    if depth < 1:
        raise ValueError(f"buffer depth must be >= 1, got {depth}")
    if subblocks < 1:
        raise ValueError(f"subblocks must be >= 1, got {subblocks}")
    steps = (p - 1) * subblocks
    if steps == 0:
        return ()
    d = min(depth, steps)
    ops: List[SchedOp] = [SchedOp("issue", t, (t - 1) % d)
                          for t in range(1, d)]
    for t in range(1, steps + 1):
        nxt = t + d - 1
        if nxt <= steps:
            ops.append(SchedOp("issue", nxt, (nxt - 1) % d))
        ops.append(SchedOp("wait", t))
        ops.append(SchedOp("compute", t))
    return tuple(ops)


def check_schedule(ops: Any, p: int, depth: int,
                   subblocks: int = 1) -> List[Hazard]:
    """Simulate one device's timeline and report every hazard (empty =
    the schedule is provably safe under the revolving-buffer semantics).
    ``p`` is the ring size (micro-steps 1..(p-1)*subblocks must each be
    issued, waited and computed exactly once), ``depth`` the declared
    buffer count, ``subblocks`` the per-peer block split the schedule
    was generated for."""
    hazards: List[Hazard] = []
    issued: Dict[int, int] = {}    # step -> buffer
    arrived: set = set()
    computed: set = set()
    owner: Dict[int, int] = {}     # buffer -> occupying step
    for op in ops:
        t = op.step
        if op.op == "issue":
            if t in issued:
                hazards.append(Hazard("malformed", t,
                                      "step issued more than once"))
                continue
            if not 0 <= op.buf < depth:
                hazards.append(Hazard(
                    "buffer-overflow", t,
                    f"buffer {op.buf} outside the declared depth {depth}"))
            elif op.buf in owner:
                hazards.append(Hazard(
                    "write-after-send", t,
                    f"issue into buffer {op.buf} while block "
                    f"{owner[op.buf]} is still un-computed there — the "
                    "incoming transfer overwrites live data"))
            owner[op.buf] = t
            issued[t] = op.buf
        elif op.op == "wait":
            if t not in issued:
                hazards.append(Hazard("malformed", t,
                                      "wait before issue"))
            elif t in arrived:
                hazards.append(Hazard("malformed", t,
                                      "step waited more than once"))
            arrived.add(t)
        else:  # compute
            if t in computed:
                hazards.append(Hazard("malformed", t,
                                      "step computed more than once"))
                continue
            if t not in arrived:
                hazards.append(Hazard(
                    "read-before-arrive", t,
                    "compute consumes the buffer before the transfer "
                    "completed (no prior wait)"))
            computed.add(t)
            buf = issued.get(t)
            if buf is not None and owner.get(buf) == t:
                del owner[buf]
    for t in range(1, (p - 1) * max(1, subblocks) + 1):
        missing = [name for name, seen in
                   (("issue", t in issued), ("wait", t in arrived),
                    ("compute", t in computed)) if not seen]
        if missing:
            hazards.append(Hazard(
                "lost-block", t,
                f"step never {'/'.join(missing)}d — the assembled output "
                "would be missing this peer's block"))
    return hazards


def mutated_schedule(kind: str, p: int = 8, depth: int = 2,
                     subblocks: int = 1) -> Tuple[SchedOp, ...]:
    """A synthetic schedule carrying exactly one hazard of ``kind`` —
    the self-test input proving the checker catches that class (the
    schedule analog of ``dfft-torch-verify --mutate``). ``subblocks`` > 1
    mutates the sub-block micro-step schedule, proving the checker's
    coverage extends to the block-granularity axis."""
    ops = list(revolving_schedule(p, depth, subblocks))
    if p < 3:
        raise ValueError("mutations need a ring of >= 3 ranks")
    last = (p - 1) * max(1, subblocks)
    if kind == "read-before-arrive":
        # Swap one wait past its compute: the FFT reads the buffer while
        # the DMA is still in flight.
        i = next(i for i, o in enumerate(ops)
                 if o.op == "wait" and o.step == 2)
        ops[i], ops[i + 1] = ops[i + 1], ops[i]
    elif kind == "write-after-send":
        # Collapse every issue onto buffer 0 while still claiming the
        # declared depth: the second issue lands on a live block.
        ops = [SchedOp("issue", o.step, 0) if o.op == "issue" else o
               for o in ops]
    elif kind == "buffer-overflow":
        ops = [SchedOp("issue", o.step, depth) if o.op == "issue"
               and o.step == 1 else o for o in ops]
    elif kind == "lost-block":
        ops = [o for o in ops if not (o.op == "compute"
                                      and o.step == last)]
    elif kind == "malformed":
        ops.append(SchedOp("compute", 1))
    else:
        raise ValueError(f"unknown hazard kind {kind!r} "
                         f"(known: {HAZARD_KINDS})")
    return tuple(ops)


def describe(p: int, depth: int = 2,
             payload_shape: Optional[Tuple[int, ...]] = None,
             dtype: Any = None, wire: str = "native",
             subblocks: int = 1) -> Dict[str, Any]:
    """One ring exchange, fully described: the byte accounting from
    ``transpose.ring_schedule`` (at this ``depth``/``subblocks``), the
    generated revolving timeline, and its hazard verdict — what
    ``dfft-torch-verify``'s schedule section and ``dfft-torch-explain``'s
    graph section both print."""
    from ..parallel.transpose import ring_schedule

    timeline = revolving_schedule(p, depth, subblocks)
    hazards = check_schedule(timeline, p, depth, subblocks)
    # A ring of p ranks has only (p-1)*subblocks micro-steps, so at
    # most that many buffers can ever be live — revolving_schedule caps
    # there. Report the depth actually exercised so "depth 8 proven" is
    # never claimed on a mesh too small to use an 8th buffer.
    micro = max(0, p - 1) * max(1, subblocks)
    out: Dict[str, Any] = {
        "p": p, "depth": depth, "subblocks": max(1, subblocks),
        "effective_depth": min(depth, micro) if micro else 0,
        "timeline_ops": len(timeline),
        "hazards": [str(h) for h in hazards],
        "ok": not hazards,
    }
    if payload_shape is not None and dtype is not None:
        out["bytes"] = ring_schedule(payload_shape, dtype, wire, p,
                                     overlap=depth > 1, depth=depth,
                                     subblocks=subblocks)
    return out


def verify_shipped_depths(p: int,
                          depths: Tuple[int, ...] = (2, 4, 8),
                          subblock_splits: Tuple[int, ...] = (1, 2)
                          ) -> List[Dict[str, Any]]:
    """The acceptance sweep: the generalized RING_OVERLAP schedule must
    check clean at every autotune-candidate depth x sub-block split for
    this mesh size (plus the plain ring and the single-peer
    degenerate). One row per (depth, split) combo — a missing row in
    the dfft-torch-verify output means a shipped schedule went
    unproven."""
    out = [describe(1, 1), describe(p, 1)]
    for d in depths:
        for s in subblock_splits:
            out.append(describe(p, d, subblocks=s))
    return out
