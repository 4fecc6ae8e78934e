"""Op-trace dataflow lints — the JAX package's ``analysis/jaxprlint.py``
over the port's recorded op trace (``analysis/opscan.py``): invariants of
the executed program that neither numerics nor the collective census can
see. The four findings keep JAX's names:

* **unpaired encode/decode** (``wire-pairing``) — every wire encode (a
  ``_to_copy`` to ``bfloat16``, or a launch of kernel 9) must be matched
  by a decode (a ``_to_copy`` from ``bfloat16``, or a launch of kernel 10
  or 11) on the far side of the exchange; a dropped decode leaves the
  payload bfloat16 downstream;
* **bf16 leak** (``wire-pairing``) — a recorded output carrying
  ``bfloat16`` is the terminal form of the same bug;
* **dtype drift across an exchange** (``wire-drift``) — encodes and
  decodes must restore the SAME float widths (a complex128 plan must
  come back complex128, so its decode must land on float64); and an
  exchange op must move its payload dtype unchanged (``exchange-dtype``;
  the port's exchanges move ``uint8`` views, so this holds by
  construction and stays as a pin);
* **guard ops at guards="off"** (``guard-off``) — an off-mode build runs
  no op of ``resilience/guards.py``; a check/enforce build must run some
  (``guard-arity``).

``lint_plan`` records (or takes) a plan direction's trace; the
``lint_*`` functions accept any ``OpTrace`` (the mutation tests feed
them).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

from . import opscan

_GUARDS_MODULE = "resilience/guards.py:"


@dataclasses.dataclass(frozen=True)
class LintFinding:
    """One op-lint diagnostic; ``lint`` names the violated invariant (the
    mutation tests assert on it)."""

    lint: str
    message: str

    def __str__(self) -> str:
        return f"[oplint/{self.lint}] {self.message}"


def _crossings(trace: opscan.OpTrace):
    """``(encodes, decodes)``: the source float dtypes of the converts INTO
    bfloat16 and the destination dtypes of the converts OUT OF it (a wire
    kernel's launch counts as float32 on its side)."""
    encodes: List[str] = []
    decodes: List[str] = []
    for op in trace.ops:
        entry = op.kernel_entry
        if entry in opscan.ENCODE_ENTRIES:
            encodes.append("torch.float32")
            continue
        if entry in opscan.DECODE_ENTRIES:
            decodes.append("torch.float32")
            continue
        ends = opscan._convert_ends(op)
        if ends is None:
            continue
        src, dst = ends
        if dst == opscan.BF16:
            encodes.append(src)
        elif src == opscan.BF16:
            decodes.append(dst)
    return encodes, decodes


def lint_wire_pairing(trace: opscan.OpTrace, expect_crossings: int = 0
                      ) -> List[LintFinding]:
    """Pairing/drift/leak checks over every convert of the trace.
    ``expect_crossings`` is the number of wire crossings the plan's
    exchange declaration predicts for a compressed wire (0 = the wire is
    native and NO bfloat16 conversion may appear at all)."""
    encodes, decodes = _crossings(trace)
    out: List[LintFinding] = []
    if expect_crossings == 0:
        if encodes or decodes:
            out.append(LintFinding(
                "wire-pairing",
                f"0 wire crossings expected but {len(encodes)} bf16 "
                f"encode(s) / {len(decodes)} decode(s) recorded; the wire "
                "layer must be structurally inert here"))
        return out
    if len(encodes) != len(decodes):
        out.append(LintFinding(
            "wire-pairing",
            f"unpaired wire_encode/wire_decode: {len(encodes)} convert(s) "
            f"to bf16 but {len(decodes)} back — a dropped decode leaves "
            "the payload bf16 past the exchange"))
    if len(encodes) < expect_crossings:
        out.append(LintFinding(
            "wire-pairing",
            f"compressed wire declares {expect_crossings} crossing(s) but "
            f"only {len(encodes)} encode(s) recorded — the exchange "
            "payload is travelling unencoded"))
    if len(encodes) == len(decodes) and sorted(encodes) != sorted(decodes):
        out.append(LintFinding(
            "wire-drift",
            f"dtype drift across the exchange: encoded from "
            f"{sorted(set(encodes))} but decoded to {sorted(set(decodes))} "
            "— the wire must restore the pre-encode float width"))
    leaks = [d for d in trace.out_dtypes if d == opscan.BF16]
    if leaks:
        out.append(LintFinding(
            "wire-pairing",
            f"{len(leaks)} recorded output(s) still bf16 — a wire payload "
            "leaked out undecoded"))
    return out


def lint_exchange_dtypes(trace: opscan.OpTrace) -> List[LintFinding]:
    """Every exchange op must move its payload dtype unchanged (both its
    input and output tensors of one dtype)."""
    out: List[LintFinding] = []
    for op in trace.ops:
        if op.c10d not in ("all_to_all", "all_to_all_start", "send",
                           "recv"):
            continue
        ds = set(op.dtypes())
        if len(ds) > 1:
            out.append(LintFinding(
                "exchange-dtype",
                f"{op.name} retypes its payload: {sorted(ds)}"))
    return out


def lint_guard_ops(trace: opscan.OpTrace, guard_mode: str
                   ) -> List[LintFinding]:
    """An off-mode build runs no guard op; a guarded build must run its
    reductions (ops dispatched from ``resilience/guards.py``)."""
    n = sum(1 for op in trace.ops if op.where.startswith(_GUARDS_MODULE)
            and not op.name.startswith("profiler."))
    if guard_mode == "off" and n:
        return [LintFinding(
            "guard-off",
            f"guards=\"off\" build ran {n} guard op(s) — guard ops present "
            "in the default path")]
    if guard_mode != "off" and not n:
        return [LintFinding(
            "guard-arity",
            f"guards=\"{guard_mode}\" build ran no guard op (expected the "
            "residual reductions)")]
    return []


def expected_crossings(plan: Any, direction: str = "forward",
                       dims: int = 3) -> int:
    """The wire crossings a compressed-wire direction must record: a ring
    encodes each travelling block ((P-1)·S), the all-to-all and Peer2Peer
    the whole block once a piece (K), and the guard's drift probe adds
    one. 0 on a native wire."""
    from . import contracts

    if plan.config.wire_dtype == "native":
        return 0
    decls = contracts._FAMILIES[contracts.family_of(plan)](
        plan, direction, dims)
    n = 0
    for d in decls:
        if d.rendering in ("ring", "ring_overlap"):
            n += max(0, d.axis_size - 1) * max(1, d.subblocks)
        else:
            n += max(1, d.chunks)
    if getattr(plan, "_guard_mode", "off") != "off":
        n += 1
    return n


def lint_plan(plan: Any, direction: str = "forward", dims: int = 3,
              trace: Optional[opscan.OpTrace] = None) -> List[LintFinding]:
    """All op lints over one direction of a live plan. ``trace`` lets a
    caller that already recorded the combo (``dfft-torch-verify`` shares
    one recording with the graph pass) skip re-running it; else this
    records, collectively on P ranks."""
    if trace is None:
        trace = opscan.record_plan(plan, direction, dims)
    mode = getattr(plan, "_guard_mode", "off")
    out = lint_wire_pairing(
        trace, expect_crossings=expected_crossings(plan, direction, dims))
    out += lint_exchange_dtypes(trace)
    out += lint_guard_ops(trace, mode)
    return out
