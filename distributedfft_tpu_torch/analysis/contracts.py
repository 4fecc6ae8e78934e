"""Declarative plan contracts: what each rendering's recorded op trace MUST
contain — the JAX package's ``analysis/contracts.py``, with its rendering
algebra re-derived from the calls the port's renderings make
(``parallel/transpose.py``).

A **contract** is resolved per combo (family x rendering x direction x
wire x guards) from two declarative sources:

* the family's exchange declaration (``models/{slab,pencil,batched2d}.py``
  register an ``exchanges(plan, direction, dims)`` function next to the
  family) — one ``ExchangeDecl`` per global exchange the direction
  stages: its payload shape, participating group size, and rendering;
* the rendering algebra in this module — how each exchange rendering
  contributes to the expected collective census of the op trace:

  ============================  ===========================================
  rendering                     rule in the port
  ============================  ===========================================
  ``a2a``                       exactly one ``all_to_all`` per exchange
                                (``all_to_all_single``, sync)
  ``streams``, ``a2a_pipe``     exactly K ``all_to_all`` (K pieces; the
                                pipelined one's are ``all_to_all_start``:
                                ``async_op=True``)
  ``ring``, ``ring_overlap``    >= (P-1)·S ``send`` and as many ``recv``
                                (S = sub-block split, one
                                ``batch_isend_irecv`` a micro-step), and 0
                                ``all_to_all``
  ``p2p``                       **exact**: P-1 ``send`` and P-1 ``recv``
                                (per piece: K·(P-1) under STREAMS)
  ============================  ===========================================

Where the port is stricter than the JAX package: JAX's ``p2p`` is a GSPMD
reshard whose collectives the partitioner picks, pinned only by a lower
bound and exempt from the payload rule; the port's Peer2Peer posts its
P-1 sends and receives itself (``peer_to_peer_transpose``), so its census
is exact and its payload reconciles: the local chunk never travels, the
same ``(P-1)/P`` discount as a ring. No GSPMD lower bound remains.

Cross-cutting rules resolved from plan state:

* **forbidden ops** — a native-wire trace touches no ``bfloat16`` tensor
  (the structural form of bit identity); a plan with no exchanges (the
  single-device path, batch sharding) issues ZERO exchange collectives,
  and zero all-reduces when guards are off;
* **payload reconciliation** — the trace's summed exchange bytes (this
  rank's ``all_to_all`` inputs and ``send`` payloads, times the ranks)
  equal ``predicted_payload_bytes`` over the declared payload shapes
  (rings and Peer2Peer with the exact ``(P-1)/P`` discount).

``verify_plan`` is the one-call API: build the contract for a live plan,
record one execution of the direction, return the violations (empty =
verified). Each violation names its contract and rule.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import opscan

# Rendering keys of a single exchange (``ExchangeDecl.rendering``), the
# JAX package's. "ring_overlap" is the revolving-buffer ring (RING_OVERLAP
# at any depth, with or without the fused wire kernels); "a2a_pipe" the
# pipelined all-to-all (ALL2ALL + SYNC/MPI_TYPE with overlap_subblocks >
# 1).
RENDERINGS = ("a2a", "streams", "a2a_pipe", "ring", "ring_overlap", "p2p")

# The renderings whose local block never travels (the (P-1)/P discount).
_RING_RENDERINGS = ("ring", "ring_overlap")
_POINT_TO_POINT = _RING_RENDERINGS + ("p2p",)


@dataclasses.dataclass(frozen=True)
class ExchangeDecl:
    """One global exchange a plan direction stages (``label`` names it in
    diagnostics; ``payload_shape`` is the GLOBAL padded payload;
    ``axis_size`` the participating group's size; ``chunks`` the resolved
    STREAMS / a2a_pipe piece count, 1 otherwise; ``subblocks`` the
    resolved ring sub-block split)."""

    label: str
    payload_shape: Tuple[int, ...]
    axis_size: int
    rendering: str
    chunks: int = 1
    subblocks: int = 1

    def __post_init__(self) -> None:
        if self.rendering not in RENDERINGS:
            raise ValueError(
                f"rendering must be one of {RENDERINGS}, "
                f"got {self.rendering!r}")
        if self.subblocks < 1:
            raise ValueError(
                f"subblocks must be >= 1, got {self.subblocks}")


@dataclasses.dataclass(frozen=True)
class Rule:
    """One resolved check. ``kind``:

    * ``census``  — count of census key ``op`` <cmp> value (the sync and
      ``_start`` forms summed);
    * ``forbid``  — ``op`` absent from the trace: ``bf16`` = no bfloat16
      tensor, any other string = no op whose name contains it;
    * ``payload`` — the trace's exchange bytes == value (global).
    """

    kind: str
    op: str
    cmp: str = "=="
    value: int = 0
    why: str = ""

    def describe(self) -> str:
        if self.kind == "forbid":
            return f"forbid {self.op!r} in the op trace"
        if self.kind == "payload":
            return f"exchange payload == {self.value} B"
        return f"census {self.op} {self.cmp} {self.value}"


@dataclasses.dataclass(frozen=True)
class Contract:
    """A fully resolved combo contract: ``name`` is
    ``<family>/<rendering-summary>`` and lands verbatim in diagnostics."""

    name: str
    family: str
    direction: str
    wire: str
    guards: str
    exchanges: Tuple[ExchangeDecl, ...]
    rules: Tuple[Rule, ...]


@dataclasses.dataclass(frozen=True)
class ContractViolation:
    """One broken rule: the contract name, the rule and what the trace
    held."""

    contract: str
    rule: Rule
    got: Any

    def __str__(self) -> str:
        return (f"[{self.contract}] violated: {self.rule.describe()} "
                f"(got {self.got})"
                + (f" — {self.rule.why}" if self.rule.why else ""))


# ---------------------------------------------------------------------------
# family registry (populated by the model modules at import)
# ---------------------------------------------------------------------------

_FAMILIES: Dict[str, Callable[..., Tuple[ExchangeDecl, ...]]] = {}
_FAMILY_OF_CLASS: Dict[str, str] = {}


def register_family(family: str, plan_class_name: str,
                    exchanges: Callable[..., Tuple[ExchangeDecl, ...]]
                    ) -> None:
    """Called by each model module, next to the family it declares:
    ``exchanges(plan, direction, dims)`` returns the direction's
    ``ExchangeDecl`` tuple."""
    _FAMILIES[family] = exchanges
    _FAMILY_OF_CLASS[plan_class_name] = family


def family_of(plan: Any) -> str:
    name = type(plan).__name__
    fam = _FAMILY_OF_CLASS.get(name)
    if fam is None:
        raise KeyError(
            f"no contract family registered for plan class {name!r} "
            f"(known: {sorted(_FAMILY_OF_CLASS)})")
    return fam


def rendering_name(config: Any, second: bool = False) -> str:
    """The rendering key one transpose resolves to from a (concrete)
    Config — the JAX package's classification, which ``dfft-torch-explain``
    prints too."""
    from .. import params as pm

    comm = config.resolved_comm2() if second else config.comm_method
    send = config.resolved_snd2() if second else config.send_method
    if send is pm.SendMethod.RING_OVERLAP:
        return "ring_overlap"
    if send is pm.SendMethod.RING:
        return "ring"
    if send is pm.SendMethod.STREAMS:
        return "p2p" if comm is pm.CommMethod.PEER2PEER else "streams"
    if comm is pm.CommMethod.PEER2PEER:
        return "p2p"
    if config.resolved_overlap_subblocks() > 1:
        return "a2a_pipe"
    return "a2a"


# ---------------------------------------------------------------------------
# resolution
# ---------------------------------------------------------------------------

def _complex_dtype(plan: Any) -> Any:
    import numpy as np

    return np.complex128 if plan.config.double_prec else np.complex64


def contract_for(plan: Any, direction: str = "forward",
                 dims: int = 3) -> Contract:
    """Resolve the declarative contract for one direction of a live plan."""
    family = family_of(plan)
    decls = tuple(_FAMILIES[family](plan, direction, dims))
    return contract_from_decls(family, direction, plan.config.wire_dtype,
                               getattr(plan, "_guard_mode", "off"),
                               _complex_dtype(plan), decls)


def _ring_size(d: ExchangeDecl) -> int:
    return d.axis_size if d.rendering in _POINT_TO_POINT else 0


def contract_from_decls(family: str, direction: str, wire: str,
                        guards: str, complex_dtype: Any,
                        decls: Tuple[ExchangeDecl, ...]) -> Contract:
    """The rendering algebra over an explicit declaration set — the
    resolution core of ``contract_for``, factored out so ``plangraph`` can
    synthesize a contract from a declared stage graph."""
    n_a2a = 0          # all-to-all instances (sync + async)
    ring_steps = 0     # minimum point-to-point micro-steps of the rings
    p2p_steps = 0      # exact point-to-point messages of Peer2Peer
    payload = 0
    for d in decls:
        if d.rendering == "a2a":
            n_a2a += 1
        elif d.rendering in ("streams", "a2a_pipe"):
            n_a2a += max(1, d.chunks)
        elif d.rendering in _RING_RENDERINGS:
            ring_steps += max(0, d.axis_size - 1) * max(1, d.subblocks)
        else:
            p2p_steps += max(0, d.axis_size - 1) * max(1, d.chunks)
        payload += opscan.predicted_payload_bytes(
            d.payload_shape, complex_dtype, wire, ring_size=_ring_size(d))

    rules: List[Rule] = []
    summary = "+".join(sorted({d.rendering for d in decls})) or "none"
    name = f"{family}/{summary}"
    if not decls:
        for op in ("all_to_all", "send", "recv", "all_gather",
                   "reduce_scatter"):
            rules.append(Rule("census", op, "==", 0,
                              why="no-exchange path must stay "
                                  "collective-free"))
        if guards == "off":
            rules.append(Rule("census", "all_reduce", "==", 0,
                              why="guards off: nothing may reduce"))
    else:
        rules.append(Rule("census", "all_to_all", "==", n_a2a,
                          why="monolithic exchanges: one collective each; "
                              "STREAMS/a2a_pipe: one per piece; rings and "
                              "Peer2Peer: none"))
        for op in ("send", "recv"):
            if ring_steps:
                rules.append(Rule(
                    "census", op, ">=", ring_steps + p2p_steps,
                    why="ring micro-steps stay distinct point-to-point "
                        "messages"))
            else:
                rules.append(Rule(
                    "census", op, "==", p2p_steps,
                    why="Peer2Peer: one message per peer (per piece); "
                        "none elsewhere"))
        rules.append(Rule("payload", "exchange", "==", payload,
                          why="exchange bytes must reconcile with "
                              "wire_nbytes over the declared payloads"))
    if wire == "native":
        rules.append(Rule("forbid", "bf16",
                          why="native wire is structurally bf16-free, "
                              "not merely numerically close"))
    return Contract(name=name, family=family, direction=direction,
                    wire=wire, guards=guards, exchanges=decls,
                    rules=tuple(rules))


# ---------------------------------------------------------------------------
# checking
# ---------------------------------------------------------------------------

def _combined(census: Dict[str, int], op: str) -> int:
    """Sync + async-start count of one census key."""
    return census.get(op, 0) + census.get(f"{op}_start", 0)


def _cmp(cmp: str, got: int, want: int) -> bool:
    if cmp == "==":
        return got == want
    if cmp == ">=":
        return got >= want
    if cmp == "<=":
        return got <= want
    raise ValueError(f"unknown comparison {cmp!r}")


def _forbidden_present(op: str, trace: opscan.OpTrace) -> bool:
    if op == "bf16":
        return opscan.contains_bf16(trace)
    return any(op in o.name for o in trace.ops)


def check_contract(contract: Contract, census: Dict[str, int],
                   trace: opscan.OpTrace,
                   staged_total: Optional[int]) -> List[ContractViolation]:
    """Check one resolved contract against the trace's facts; returns the
    violations (empty = the combo verifies). ``staged_total`` None (no
    exchange op in the trace) fails a payload rule with a non-zero value:
    a declared exchange that moved nothing."""
    out: List[ContractViolation] = []
    for rule in contract.rules:
        if rule.kind == "census":
            got = _combined(census, rule.op)
            if not _cmp(rule.cmp, got, rule.value):
                out.append(ContractViolation(contract.name, rule, got))
        elif rule.kind == "forbid":
            if _forbidden_present(rule.op, trace):
                out.append(ContractViolation(contract.name, rule,
                                             f"{rule.op!r} present"))
        elif rule.kind == "payload":
            got = staged_total or 0
            if got != rule.value:
                out.append(ContractViolation(contract.name, rule,
                                             f"{got} B"))
        else:  # pragma: no cover - Rule kinds are closed above
            raise ValueError(f"unknown rule kind {rule.kind!r}")
    return out


def verify_plan(plan: Any, direction: str = "forward", dims: int = 3,
                contract: Optional[Contract] = None,
                trace: Optional[opscan.OpTrace] = None
                ) -> List[ContractViolation]:
    """Record one direction of a live plan (or take ``trace``) and check it
    against its (or an explicitly supplied) contract. Collective on a plan
    over P ranks: every rank calls it."""
    contract = contract or contract_for(plan, direction, dims)
    if trace is None:
        trace = opscan.record_plan(plan, direction, dims)
    census = opscan.collective_census(trace)
    staged = opscan.staged_exchange_total(trace, opscan.plan_ranks(plan))
    return check_contract(contract, census, trace, staged)
