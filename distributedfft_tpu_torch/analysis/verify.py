"""``dfft-torch-verify`` — the plan contract verifier of the port (the JAX
package's ``dfft-verify``).

Runs every rendering x direction x wire x guard combo of the three plan
families ONCE at the gate size and checks the recorded op trace
(``analysis/opscan.py``) against its declarative contract
(``analysis/contracts.py``), plus:

* the PLAN-GRAPH pass per combo (``analysis/plangraph.py``): every family
  must declare a stage graph for every combo (a missing declaration is a
  FAILURE), the graph must be well-formed, reconcile with the family's
  exchange contract, conform to the recorded trace, and every declared
  node must have entered its stage scope (the combo is recorded under a
  CPU-activity profiler, where scopes are entered);
* op-trace lints per combo (``analysis/oplint.py``);
* the schedule hazard sweep (``analysis/schedverify.py``): the revolving
  RING_OVERLAP schedule checks clean at depths 2/4/8 x sub-block splits
  1/2 for this world (plus the serial ring and the single-peer case);
* zero-overhead pins, comparing op-trace fingerprints: obs enabled ==
  disabled, a fault spec set then unset == never set (and the faulted
  guarded build differs from the unfaulted one, so the comparison is not
  vacuous), ``guards="enforce"`` == ``"check"``, and stage scopes on ==
  ``scopes_off()`` under a recording profiler (and the scoped trace did
  enter scopes);
* AST repo-invariant lints (``analysis/srclint.py``) over the port.

**Ranks.** ``--emulate-devices N`` spawns N gloo ranks on the CPU, as the
port's executables do (``cli/common.py``); each rank runs every combo and
records its own trace, the ranks' censuses and violations are gathered,
and a census the ranks disagree on fails the combo. Rank 0 prints and
writes ``--json``. Without ``--emulate-devices`` it runs on the card (one
rank: the single-device combos, whose contract is "no collective"), under
``--fft-backend``, and the kernels each combo launched land in its row.

Prints a pass/fail table; ``--json`` writes the report (``combos``,
``pins``, ``sched``, ``srclint``, ``failures``, ``ok``). Exit code 0 =
everything verified.

Mutation self-test (the verifier verifying itself)::

    dfft-torch-verify --mutate drop-decode --emulate-devices 4
    dfft-torch-verify --mutate all --emulate-devices 4   # rc 0 iff every
                                                         # mutation is
                                                         # CAUGHT and named

Examples::

    dfft-torch-verify --emulate-devices 4 --quick
    dfft-torch-verify --emulate-devices 4 --families slab --wires bf16
    dfft-torch-verify --fft-backend pallas          # on the card
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import tempfile
from typing import Any, Dict, Iterator, List, Optional, Sequence

MUTATIONS = ("drop-decode", "bogus-census", "flip-forbidden",
             "drop-decode-node", "phantom-exchange", "hazard-schedule",
             "hazard-subblock")

MODULE = "distributedfft_tpu_torch.analysis.verify"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="dfft-torch-verify", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--families", default="slab,pencil,batched",
                    help="comma list of plan families to verify")
    ap.add_argument("--renderings",
                    default="a2a,opt1,p2p,streams,ring,ring_ovl,"
                            "ring_ovl_d4,ring_ovl_d8,ring_sub2,a2a_pipe,"
                            "fused",
                    help="comma list of exchange renderings (ring_ovl = "
                         "SendMethod.RING_OVERLAP, the double-buffered "
                         "ring; ring_ovl_d4/d8 = the depth-4/8 revolving-"
                         "buffer variants; ring_sub2 = the overlapped ring "
                         "with each peer block split into 2 sub-blocks; "
                         "a2a_pipe = the pipelined all-to-all, 2 chunked "
                         "collectives on the realigned layout; fused = "
                         "RING_OVERLAP + Config.fused_wire, the fused wire "
                         "kernels — active on the bf16 wire cells, inert "
                         "on native)")
    ap.add_argument("--wires", default="native,bf16",
                    help="comma list of wire dtypes")
    ap.add_argument("--guards", default="off,check",
                    help="comma list of guard modes (enforce records "
                         "identically to check — pinned by the enforce pin "
                         "instead of brute-forced)")
    ap.add_argument("--directions", default="forward,inverse")
    ap.add_argument("--sequences", default="ZY_Then_X",
                    help="comma list of slab sequences to sweep")
    ap.add_argument("--quick", action="store_true",
                    help="native wire + guards off + forward only")
    ap.add_argument("--no-pins", action="store_true",
                    help="skip the zero-overhead fingerprint pins")
    ap.add_argument("--no-srclint", action="store_true",
                    help="skip the AST repo-invariant lints")
    ap.add_argument("--no-jaxprlint", "--no-oplint", dest="no_jaxprlint",
                    action="store_true",
                    help="skip the per-combo op-trace lints (the JAX "
                         "package's flag name, kept)")
    ap.add_argument("--mutate", default=None,
                    choices=MUTATIONS + ("all",),
                    help="break a contract on purpose (verifier self-test)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the full report as JSON (rank 0)")
    ap.add_argument("--emulate-devices", type=int, default=0,
                    help="run as N gloo ranks on the CPU (0 = the card)")
    ap.add_argument("--fft-backend", default="xla",
                    help="the Config's fft_backend of every combo")
    ap.add_argument("--obs", action="store_true",
                    help="print the obs metrics snapshot (ops.* census "
                         "gauges) after the table")
    return ap


def _csv(s: str) -> List[str]:
    return [x.strip() for x in str(s).split(",") if x.strip()]


# ---------------------------------------------------------------------------
# the combo matrix
# ---------------------------------------------------------------------------

def _config(rendering: str, wire: str, guards: str,
            backend: str = "xla") -> Any:
    from .. import params as pm

    kw: Dict[str, Any] = {}
    if rendering == "a2a":
        kw.update(comm_method=pm.CommMethod.ALL2ALL)
    elif rendering == "opt1":
        kw.update(comm_method=pm.CommMethod.ALL2ALL, opt=1)
    elif rendering == "p2p":
        kw.update(comm_method=pm.CommMethod.PEER2PEER)
    elif rendering == "streams":
        kw.update(comm_method=pm.CommMethod.ALL2ALL,
                  send_method=pm.SendMethod.STREAMS, streams_chunks=3)
    elif rendering == "ring":
        kw.update(send_method=pm.SendMethod.RING)
    elif rendering == "ring_ovl":
        kw.update(send_method=pm.SendMethod.RING_OVERLAP)
    elif rendering == "ring_ovl_d4":
        kw.update(send_method=pm.SendMethod.RING_OVERLAP, overlap_depth=4)
    elif rendering == "ring_ovl_d8":
        kw.update(send_method=pm.SendMethod.RING_OVERLAP, overlap_depth=8)
    elif rendering == "ring_sub2":
        kw.update(send_method=pm.SendMethod.RING_OVERLAP,
                  overlap_subblocks=2)
    elif rendering == "a2a_pipe":
        kw.update(comm_method=pm.CommMethod.ALL2ALL, opt=1,
                  overlap_subblocks=2)
    elif rendering == "fused":
        kw.update(send_method=pm.SendMethod.RING_OVERLAP, fused_wire=True)
    else:
        raise ValueError(f"unknown rendering {rendering!r}")
    return pm.Config(wire_dtype=wire, guards=guards, use_wisdom=False,
                     fft_backend=backend, **kw)


def _make_plan(family: str, rendering: str, wire: str, guards: str,
               sequence: str, ndev: int, device: Any = "cuda",
               backend: str = "xla") -> Any:
    """One combo's plan on the uneven-extent gate shape (padding on every
    decomposed axis stays covered). Returns (plan, dims)."""
    from .. import params as pm
    from ..models.batched2d import Batched2DFFTPlan
    from ..models.pencil import PencilFFTPlan
    from ..models.slab import SlabFFTPlan

    cfg = _config(rendering, wire, guards, backend)
    if family == "slab":
        return SlabFFTPlan(pm.GlobalSize(20, 16, 16), pm.SlabPartition(ndev),
                           cfg, sequence=sequence, device=device), 3
    if family == "pencil":
        p1 = 2 if ndev % 2 == 0 else 1
        return PencilFFTPlan(pm.GlobalSize(20, 16, 16),
                             pm.PencilPartition(p1, ndev // p1), cfg,
                             device=device), 3
    if family == "batched":
        return Batched2DFFTPlan(ndev, 20, 16, pm.SlabPartition(ndev), cfg,
                                shard="x", device=device), 2
    raise ValueError(f"unknown family {family!r}")


def iter_combos(args: Any, ndev: int) -> Iterator[Dict[str, Any]]:
    """The JAX package's matrix; on one rank only the no-exchange and
    Bluestein combos (every rendering degenerates to the single-device
    path there)."""
    families = _csv(args.families)
    renderings = _csv(args.renderings) if ndev > 1 else []
    wires = ["native"] if args.quick else _csv(args.wires)
    guards = ["off"] if args.quick else _csv(args.guards)
    directions = ["forward"] if args.quick else _csv(args.directions)
    sequences = _csv(args.sequences)
    for family in families:
        seqs = sequences if family == "slab" else [""]
        for rendering in renderings:
            for seq in seqs:
                for wire in wires:
                    for gm in guards:
                        for d in directions:
                            yield dict(family=family, rendering=rendering,
                                       sequence=seq, wire=wire, guards=gm,
                                       direction=d)
    # The no-exchange contracts (single device, batch sharding) and the
    # Bluestein combo: a PRIME r2c axis through the chirp-z backend, whose
    # exchange must keep its census, bf16-freedom and payload.
    if "slab" in families:
        yield dict(family="slab", rendering="none", sequence="ZY_Then_X",
                   wire="native", guards="off", direction="forward",
                   single=True)
        yield dict(family="slab", rendering="bluestn", sequence="ZY_Then_X",
                   wire="native", guards="off", direction="forward",
                   bluestein=True)
    if "batched" in families:
        yield dict(family="batched", rendering="none", sequence="",
                   wire="native", guards="off", direction="forward",
                   batch_shard=True)


def combo_plan(combo: Dict[str, Any], ndev: int, device: Any = "cuda",
               backend: str = "xla"):
    """``(plan, dims)`` of one combo."""
    from .. import params as pm
    from ..models.batched2d import Batched2DFFTPlan
    from ..models.slab import SlabFFTPlan

    if combo.get("bluestein"):
        return SlabFFTPlan(pm.GlobalSize(20, 16, 19), pm.SlabPartition(ndev),
                           pm.Config(fft_backend="bluestein",
                                     use_wisdom=False), device=device), 3
    if combo.get("single"):
        return SlabFFTPlan(pm.GlobalSize(16, 16, 16), pm.SlabPartition(1),
                           pm.Config(use_wisdom=False, fft_backend=backend),
                           device=device), 3
    if combo.get("batch_shard"):
        return Batched2DFFTPlan(ndev, 20, 16, pm.SlabPartition(ndev),
                                pm.Config(use_wisdom=False,
                                          fft_backend=backend),
                                shard="batch", device=device), 2
    return _make_plan(combo["family"], combo["rendering"], combo["wire"],
                      combo["guards"], combo["sequence"] or "ZY_Then_X",
                      ndev, device, backend)


def _gather(obj: Any) -> List[Any]:
    """Every rank's ``obj`` (this rank's alone outside a world)."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return [obj]
    out: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def run_combo(combo: Dict[str, Any], ndev: int, device: Any = "cuda",
              backend: str = "xla", no_jaxprlint: bool = False
              ) -> Dict[str, Any]:
    """Build, record and check one combo (collective: every rank calls it
    with the same combo). Returns rank 0's row, with every rank's
    violations."""
    from ..ops import hopper_fft as hf
    from . import contracts, opscan, oplint, plangraph

    plan, dims = combo_plan(combo, ndev, device, backend)
    direction = combo["direction"]
    contract = contracts.contract_for(plan, direction, dims)
    before = dict(hf.ENTRIES)
    trace = plangraph.record_scoped(plan, direction, dims)
    launched = {k: v - before.get(k, 0) for k, v in hf.ENTRIES.items()
                if v != before.get(k, 0)}
    census = opscan.collective_census(trace)
    staged = opscan.staged_exchange_total(trace, opscan.plan_ranks(plan))
    violations = [str(v) for v in
                  contracts.check_contract(contract, census, trace, staged)]
    if launched != trace.kernels():
        violations.append(f"[opscan] the trace holds launches "
                          f"{trace.kernels()} but the kernels counted "
                          f"{launched}")
    graph_summary = None
    try:
        graph = plangraph.graph_for(plan, direction, dims)
    except plangraph.MissingGraph as e:
        violations.append(f"[plangraph] no stage graph declared for "
                          f"this combo: {e}")
    else:
        graph_summary = dict(name=graph.name, nodes=len(graph.nodes),
                             edges=len(graph.edges),
                             exchanges=len(graph.exchanges()))
        violations += [str(v) for v in plangraph.check_graph(graph)]
        violations += [str(v) for v in
                       plangraph.check_graph_contract(graph, contract)]
        violations += [str(v) for v in plangraph.check_graph_trace(
            plan, graph, direction, dims, trace=trace)]
        violations += [str(v) for v in
                       plangraph.check_graph_scopes(graph, trace)]
    if not no_jaxprlint:
        violations += [str(f) for f in
                       oplint.lint_plan(plan, direction, dims, trace=trace)]
    nonzero = {k: v for k, v in census.items() if v}
    # The ranks must agree on the collectives; the converts may differ (a
    # guard's rank whose block is all pad reduces nothing).
    colls = {k: v for k, v in nonzero.items() if k != "convert"}
    rows = _gather((colls, violations))
    merged: List[str] = []
    for r, (c, vs) in enumerate(rows):
        merged += [f"rank {r}: {v}" if len(rows) > 1 else v for v in vs]
        if c != rows[0][0]:
            merged.append(f"rank {r}'s census {c} differs from rank 0's "
                          f"{rows[0][0]}")
    return dict(combo, contract=contract.name, census=nonzero,
                graph=graph_summary, kernels=trace.kernels(),
                violations=merged, ok=not merged)


# ---------------------------------------------------------------------------
# zero-overhead fingerprint pins
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _env(key: str, value: Optional[str]) -> Iterator[None]:
    old = os.environ.get(key)
    try:
        if value is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = value
        yield
    finally:
        if old is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = old


def run_pins(ndev: int, families: Sequence[str], device: Any = "cuda",
             backend: str = "xla") -> List[Dict[str, Any]]:
    """The fingerprint pins, one per family x {obs, inject, enforce,
    scope} (collective: every rank runs them):

    * obs     — op trace with observability enabled == disabled;
    * inject  — a build after setting THEN UNSETTING ``$DFFT_FAULT_SPEC``
      == the never-faulted build, and the faulted guarded build differs
      from the unfaulted guarded one (a dead injector would make them
      equal); skipped on one rank, where no wire exists to fault;
    * enforce — ``guards="enforce"`` records the op graph of ``"check"``
      (the difference is host-side policy);
    * scope   — stage scopes on == ``scopes_off()``, both under a
      recording profiler (scopes never add ops), and the scoped trace
      entered ``dfft/...`` scopes.
    """
    from .. import obs
    from ..obs import profile as _profile
    from ..resilience import inject
    from . import opscan, plangraph

    out = []
    for family in families:
        def plan_of(wire: str = "native", guards: str = "off"):
            return _make_plan(family, "a2a", wire, guards, "ZY_Then_X",
                              ndev, device, backend)

        def fp(wire: str = "native", guards: str = "off") -> str:
            # The second of two runs: the first builds what a plan builds
            # once (the kernels' DFT constants, cached per shape).
            plan, dims = plan_of(wire, guards)
            opscan.record_plan(plan, "forward", dims)
            return opscan.plan_fingerprint(plan, "forward", dims)

        try:
            obs.disable()
            base = fp()
            with tempfile.TemporaryDirectory() as td:
                obs.enable(td)
                on = fp()
        finally:
            obs.reset_enablement()
        out.append(dict(pin=f"{family}/obs-zero-overhead", ok=on == base,
                        detail="op trace obs-on == obs-off"))
        checked = fp(guards="check")
        if ndev > 1:
            with _env(inject.ENV_VAR, "wire:bitflip"):
                faulted = fp(guards="check")
            after = fp()
            out.append(dict(
                pin=f"{family}/inject-zero-overhead",
                ok=(after == base) and (faulted != checked),
                detail="fault spec set-then-unset leaves the op graph "
                       "identical (faulted guarded build differs from the "
                       "unfaulted guarded one)"))
        out.append(dict(
            pin=f"{family}/enforce-eq-check",
            ok=fp(guards="enforce") == checked,
            detail="guards=enforce records the op graph of guards=check"))
        plan, dims = plan_of()
        scoped = plangraph.record_scoped(plan, "forward", dims)
        with _profile.scopes_off():
            bare = plangraph.record_scoped(plan, "forward", dims)
        entered = any(s.startswith(_profile.SCOPE_PREFIX + "/")
                      for s in opscan.scope_labels(scoped))
        out.append(dict(
            pin=f"{family}/scope-zero-overhead",
            ok=entered and (opscan.op_graph_fingerprint(scoped)
                            == opscan.op_graph_fingerprint(bare)),
            detail="stage scopes on == off under a recording profiler "
                   "(scopes never add ops; the scoped run entered them)"))
    return out


# ---------------------------------------------------------------------------
# mutations (the verifier verifying itself)
# ---------------------------------------------------------------------------

def run_mutation(name: str, ndev: int, device: Any = "cuda"
                 ) -> Dict[str, Any]:
    """Break one contract on purpose and run the focused combo (collective
    where it records). The result's ``violations`` MUST be non-empty and
    name the right contract/lint — asserted by ``--mutate all`` and the
    tests."""
    import torch

    from .. import params as pm
    from ..models.slab import SlabFFTPlan
    from ..parallel import transpose as tr
    from . import contracts, oplint

    if name == "drop-decode":
        # Drop the wire decode: reinterpret the bf16 planes as int16 and
        # widen those, so NO convert-from-bf16 remains (shapes and dtypes
        # stay valid; the payload silently lost its restoration).
        real_decode = tr.wire_decode

        def broken_decode(y, dtype, wire=tr.WIRE_BF16):
            if wire == tr.WIRE_NATIVE:
                return real_decode(y, dtype, wire)
            f = (torch.float64 if dtype == torch.complex128
                 else torch.float32)
            z = y.view(torch.int16).to(f)
            return torch.complex(z[0], z[1])

        tr.wire_decode = broken_decode
        try:
            plan = SlabFFTPlan(pm.GlobalSize(16, 16, 16),
                               pm.SlabPartition(ndev),
                               pm.Config(wire_dtype="bf16",
                                         use_wisdom=False), device=device)
            violations = [str(f) for f in
                          oplint.lint_plan(plan, "forward")]
        finally:
            tr.wire_decode = real_decode
        return dict(mutation=name, violations=violations,
                    expect="unpaired wire_encode/wire_decode")
    if name in ("drop-decode-node", "phantom-exchange", "hazard-schedule",
                "hazard-subblock"):
        return _run_graph_mutation(name, ndev, device)
    plan, dims = _make_plan("slab", "opt1", "native", "off", "ZY_Then_X",
                            ndev, device)
    contract = contracts.contract_for(plan, "forward", dims)
    if name == "bogus-census":
        # Expect 2 all-to-alls where the realigned rendering runs exactly 1.
        rules = tuple(
            dataclasses.replace(r, value=2)
            if r.kind == "census" and r.op == "all_to_all" else r
            for r in contract.rules)
        expect = "census all_to_all == 2"
    elif name == "flip-forbidden":
        # Forbid the very collective the rendering legitimately runs.
        rules = contract.rules + (contracts.Rule(
            "forbid", "alltoall", why="mutated: forbidden on purpose"),)
        expect = "forbid 'alltoall'"
    else:
        raise ValueError(f"unknown mutation {name!r}")
    mutated = dataclasses.replace(contract, rules=rules)
    violations = [str(v) for v in
                  contracts.verify_plan(plan, "forward", dims,
                                        contract=mutated)]
    return dict(mutation=name, violations=violations, expect=expect)


def _run_graph_mutation(name: str, ndev: int, device: Any = "cuda"
                        ) -> Dict[str, Any]:
    """The plan-graph defect mutations: break a DECLARED graph (or a
    schedule) on purpose and prove the graph pass catches it."""
    from .. import params as pm
    from ..models.slab import SlabFFTPlan
    from . import plangraph, schedverify

    if name in ("hazard-schedule", "hazard-subblock"):
        # Every issue funnelled into buffer 0 while claiming depth 2 (on
        # whole blocks, or on the sub-block micro-steps).
        sub = 2 if name == "hazard-subblock" else 1
        bad = schedverify.mutated_schedule("write-after-send",
                                           p=max(3, ndev), depth=2,
                                           subblocks=sub)
        hazards = schedverify.check_schedule(bad, max(3, ndev), 2,
                                             subblocks=sub)
        return dict(mutation=name, violations=[str(h) for h in hazards],
                    expect="write-after-send")
    if name == "drop-decode-node":
        # Delete the decode stage of a declared compressed graph,
        # reconnecting the exchange straight to the next stage.
        plan = SlabFFTPlan(pm.GlobalSize(16, 16, 16), pm.SlabPartition(ndev),
                           pm.Config(wire_dtype="bf16", use_wisdom=False),
                           device=device)
        g = plangraph.graph_for(plan, "forward")
        dec = next((n for n in g.nodes if n.decodes()), None)
        if dec is None:
            return dict(mutation=name, violations=[],
                        expect="unpaired encode/decode")
        (in_e,) = g.in_edges(dec.id)
        (out_e,) = g.out_edges(dec.id)
        nodes = tuple(n for n in g.nodes if n.id != dec.id)
        edges = tuple(e for e in g.edges if e not in (in_e, out_e)) \
            + (dataclasses.replace(in_e, dst=out_e.dst),)
        bad_graph = dataclasses.replace(g, nodes=nodes, edges=edges)
        return dict(mutation=name,
                    violations=[str(v) for v in
                                plangraph.check_graph(bad_graph)],
                    expect="unpaired encode/decode")
    # phantom-exchange: a second all-to-all exchange the build never runs.
    plan, dims = _make_plan("slab", "opt1", "native", "off", "ZY_Then_X",
                            ndev, device)
    g = plangraph.graph_for(plan, "forward", dims)
    x = next((n for n in g.nodes if n.kind == "exchange"), None)
    if x is None:
        return dict(mutation=name, violations=[], expect="phantom exchange")
    phantom = dataclasses.replace(x, id="exchange:phantom", label="phantom")
    (out_e,) = g.out_edges(x.id)
    edges = tuple(e for e in g.edges if e is not out_e) + (
        dataclasses.replace(out_e, dst="exchange:phantom"),
        dataclasses.replace(out_e, src="exchange:phantom"))
    bad_graph = dataclasses.replace(g, nodes=g.nodes + (phantom,),
                                    edges=edges)
    violations = [str(v) for v in plangraph.check_graph_trace(
        plan, bad_graph, "forward", dims)]
    return dict(mutation=name, violations=violations,
                expect="phantom exchange")


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def _combo_label(r: Dict[str, Any]) -> str:
    seq = r.get("sequence") or "-"
    return (f"{r['family']:<8} {r['rendering']:<8} {seq:<10} "
            f"{r['direction'][:3]:<4} {r['wire']:<7} {r['guards']:<6}")


def _world(args) -> tuple:
    """``(rank, ranks, device)`` of this process, after joining a world
    when the card's run is one (``cli.common.setup_backend``)."""
    from ..cli.common import setup_backend
    from ..parallel import multihost

    device = setup_backend(args)
    rank, n = multihost.world()
    return rank, n, device


def _say(rank: int, *a: Any) -> None:
    if rank == 0:
        print(*a, flush=True)


def _body(args) -> int:
    """One rank's verification (every rank of the world runs it)."""
    import torch

    rank, ndev, device = _world(args)
    backend = args.fft_backend
    if args.mutate:
        names = MUTATIONS if args.mutate == "all" else (args.mutate,)
        all_caught = True
        res: Dict[str, Any] = {}
        for name in names:
            res = run_mutation(name, ndev, device)
            caught = any(res["expect"] in v for v in res["violations"])
            all_caught &= caught
            _say(rank, f"mutation {name}: "
                 + ("CAUGHT" if caught else "NOT CAUGHT (verifier bug!)"))
            for v in res["violations"]:
                _say(rank, f"  {v}")
        if args.mutate == "all":
            _say(rank, "mutation self-test: "
                 + ("PASS" if all_caught else "FAIL"))
            return 0 if all_caught else 1
        return 1 if res["violations"] else 0

    platform = torch.device(device).type
    report: Dict[str, Any] = {
        "devices": ndev, "platform": platform, "backend": backend,
        "combos": [], "pins": [], "sched": [], "srclint": [],
    }
    failures = 0
    _say(rank, f"dfft-torch-verify: {ndev} rank(s) on {platform} "
               f"(fft_backend {backend})")
    _say(rank, f"{'family':<8} {'render':<8} {'sequence':<10} {'dir':<4} "
               f"{'wire':<7} {'guards':<6} {'contract':<18} result")
    for combo in iter_combos(args, ndev):
        res = run_combo(combo, ndev, device, backend,
                        no_jaxprlint=args.no_jaxprlint)
        report["combos"].append(res)
        if not res["ok"]:
            failures += 1
        _say(rank, f"{_combo_label(res)} {res['contract']:<18} "
                   f"{'PASS' if res['ok'] else 'FAIL'}")
        for v in res["violations"]:
            _say(rank, f"    {v}")

    if not args.no_pins:
        for pin in run_pins(ndev, _csv(args.families), device, backend):
            report["pins"].append(pin)
            if not pin["ok"]:
                failures += 1
            _say(rank, f"pin  {pin['pin']:<38} "
                       f"{'PASS' if pin['ok'] else 'FAIL'}  "
                       f"({pin['detail']})")

    from . import schedverify
    for sched in schedverify.verify_shipped_depths(ndev):
        report["sched"].append(sched)
        if not sched["ok"]:
            failures += 1
        eff = sched.get("effective_depth", sched["depth"])
        cap = f" (effective {eff})" if eff != sched["depth"] else ""
        _say(rank, f"sched ring p={sched['p']:<3} depth={sched['depth']:<3}"
                   f"sub={sched.get('subblocks', 1):<3}{cap} "
                   f"({sched['timeline_ops']} op(s)) "
                   f"{'PASS' if sched['ok'] else 'FAIL'}")
        for h in sched["hazards"]:
            _say(rank, f"    {h}")

    if not args.no_srclint:
        from . import srclint
        findings = srclint.lint_repo()
        for f in findings:
            report["srclint"].append(str(f))
            failures += 1
            _say(rank, f"srclint FAIL {f}")
        if not findings:
            _say(rank, "srclint: clean "
                       "(traced-host-io, host-only-jnp, wisdom-flock)")

    verdict = "PASS" if failures == 0 else f"FAIL ({failures} failure(s))"
    _say(rank, f"dfft-torch-verify: {len(report['combos'])} combo(s), "
               f"{len(report['pins'])} pin(s), {len(report['sched'])} "
               f"schedule(s), srclint "
               f"{'skipped' if args.no_srclint else 'ran'} -> {verdict}")
    report["failures"] = failures
    report["ok"] = failures == 0
    if args.json and rank == 0:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=1, sort_keys=True, default=str)
        print(f"report written to {args.json}")
    if args.obs and rank == 0:
        from .. import obs
        print("obs metrics: "
              + json.dumps(obs.metrics.snapshot(), sort_keys=True))
    return 0 if failures == 0 else 1


def main(argv: Optional[Sequence[str]] = None) -> int:
    from ..cli.common import run

    args = build_parser().parse_args(argv)
    return run(MODULE, args, None if argv is None else list(argv))


if __name__ == "__main__":
    sys.exit(main())
