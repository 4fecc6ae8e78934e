"""Declared stage-graph IR: every plan family emits a typed graph of the
pipeline it builds, and this module proves the graph sound — and proves
the BUILD actually implements it. The JAX package's
``analysis/plangraph.py``, with the trace checks read off the port's
recorded op trace (``analysis/opscan.py``) instead of a jaxpr and an HLO
module.

Each family registers ``_declare_graph(plan, direction, dims) ->
PlanGraph`` beside its ``_contract_exchanges``: a DAG of **stage nodes**

=================  =====================================================
kind               meaning
=================  =====================================================
``input``          the pipeline source (one per graph)
``local_fft``      one local FFT stage; ``axes`` = global axes it
                   transforms, in application order
``exchange``       one global exchange; carries the rendering key,
                   participating group size, GLOBAL padded payload
                   shape, resolved STREAMS/a2a_pipe chunk count, the
                   ring sub-block split and the schedule depth (0 = no
                   pipelined schedule, 1 = serial ring, >= 2 =
                   revolving-buffer overlap / pipelined-a2a window)
``encode``         the wire encode (complex -> planar bf16 pair)
``decode``         the wire decode (planar pair -> complex)
``fused_kernel``   a fused wire kernel (``csrc/wire.cu``); ``fuses``
                   names what it replaces (("encode","pack") /
                   ("decode",) / ("decode","fft"))
``guard``          the numerical guard wrapper (modes check/enforce)
``output``         the pipeline sink (one per graph)
=================  =====================================================

and **edges** carrying the payload that flows between stages: global
padded shape, dtype, sharding spec (the JAX package's spec strings, kept
so the two graphs compare equal), and — on the edges touching an
exchange — the wire bytes that cross the mesh (ring-discounted; a
Peer2Peer edge carries the whole payload as in the JAX package, whose
Peer2Peer is a GSPMD reshard — the port's contract discounts it, since
its own messages never carry the local chunk).

Checker layers, all consumed per combo by ``dfft-torch-verify``:

* ``check_graph``          — well-formedness: dataflow soundness, encode/
  decode pairing, dtype flow across exchanges, payload conservation,
  guard arity and a hazard pass over every pipelined schedule;
* ``check_graph_contract`` — the graph's exchange nodes reconcile 1:1
  with the family's ``_contract_exchanges``;
* ``check_graph_trace``    — the declared graph against the recorded op
  trace: the trace must hold at least the declared collectives (a
  declared exchange the build never runs, a "phantom", fails here), and
  a contract SYNTHESIZED from the graph's exchange nodes must pass
  against the trace's census, forbidden ops and payload;
* ``check_graph_scopes``   — every declared node's ``dfft/<family>/<id>``
  stage scope was entered (a trace recorded under a profiler).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from . import contracts, opscan, schedverify

NODE_KINDS = ("input", "local_fft", "exchange", "encode", "decode",
              "fused_kernel", "guard", "output")


@dataclasses.dataclass(frozen=True)
class StageNode:
    """One pipeline stage. Only the fields meaningful for the ``kind``
    are populated (an ``exchange`` carries rendering/axis_size/payload;
    a ``local_fft`` carries axes; a ``fused_kernel`` names what it
    fuses)."""

    id: str
    kind: str
    label: str = ""
    axes: Tuple[int, ...] = ()
    rendering: str = ""
    axis_size: int = 0
    chunks: int = 1
    subblocks: int = 1
    payload_shape: Tuple[int, ...] = ()
    schedule_depth: int = 0
    fuses: Tuple[str, ...] = ()

    def __post_init__(self) -> None:
        if self.kind not in NODE_KINDS:
            raise ValueError(
                f"node kind must be one of {NODE_KINDS}, got {self.kind!r}")

    def encodes(self) -> bool:
        return self.kind == "encode" or (self.kind == "fused_kernel"
                                         and "encode" in self.fuses)

    def decodes(self) -> bool:
        return self.kind == "decode" or (self.kind == "fused_kernel"
                                         and "decode" in self.fuses)


@dataclasses.dataclass(frozen=True)
class StageEdge:
    """The payload flowing from stage ``src`` to stage ``dst``:
    ``shape``/``dtype`` of the GLOBAL (padded) array, its sharding spec
    (best-effort string), and ``wire_bytes`` — the bytes this payload
    puts on the mesh wire, non-zero only on the edges into/out of an
    exchange (ring-discounted there)."""

    src: str
    dst: str
    shape: Tuple[int, ...]
    dtype: str
    spec: str = ""
    wire_bytes: int = 0


@dataclasses.dataclass(frozen=True)
class PlanGraph:
    """One direction of one plan, as declared data. ``wire``/``guards``
    are the resolved plan state the checks interpret the graph under;
    ``complex_dtype`` the spectral payload dtype every exchange moves."""

    family: str
    direction: str
    wire: str
    guards: str
    complex_dtype: str
    nodes: Tuple[StageNode, ...]
    edges: Tuple[StageEdge, ...]

    @property
    def name(self) -> str:
        return f"{self.family}/{self.direction}"

    def node(self, node_id: str) -> StageNode:
        for n in self.nodes:
            if n.id == node_id:
                return n
        raise KeyError(node_id)

    def exchanges(self) -> Tuple[StageNode, ...]:
        return tuple(n for n in self.nodes if n.kind == "exchange")

    def in_edges(self, node_id: str) -> Tuple[StageEdge, ...]:
        return tuple(e for e in self.edges if e.dst == node_id)

    def out_edges(self, node_id: str) -> Tuple[StageEdge, ...]:
        return tuple(e for e in self.edges if e.src == node_id)


@dataclasses.dataclass(frozen=True)
class GraphViolation:
    """One broken graph invariant; ``check`` names the checker layer and
    rule (what the mutation tests assert on)."""

    graph: str
    check: str
    message: str

    def __str__(self) -> str:
        return f"[plangraph/{self.graph}] {self.check}: {self.message}"


class GraphBuilder:
    """Linear pipeline builder — the families' declaration helper. The
    payload set by ``payload(...)`` rides the NEXT edge (i.e. it
    describes what the most recent node emits); ``node(...)`` appends a
    stage and connects it from the previous one."""

    def __init__(self, family: str, direction: str, wire: str,
                 guards: str, complex_dtype: str) -> None:
        self._family = family
        self._direction = direction
        self._wire = wire
        self._guards = guards
        self._cdt = complex_dtype
        self._nodes: List[StageNode] = []
        self._edges: List[StageEdge] = []
        self._counts: Dict[str, int] = {}
        self._shape: Tuple[int, ...] = ()
        self._dtype: str = ""
        self._spec: str = ""
        self._wire_bytes: int = 0

    def payload(self, shape: Iterable[int], dtype: str, spec: Any = "",
                wire_bytes: int = 0) -> None:
        self._shape = tuple(int(s) for s in shape)
        self._dtype = str(dtype)
        self._spec = str(spec)
        self._wire_bytes = int(wire_bytes)

    def node(self, kind: str, **fields: Any) -> str:
        n = self._counts.get(kind, 0) + 1
        self._counts[kind] = n
        node_id = kind if kind in ("input", "output", "guard") \
            else f"{kind}:{n}"
        self._nodes.append(StageNode(id=node_id, kind=kind, **fields))
        if len(self._nodes) > 1:
            prev = self._nodes[-2]
            self._edges.append(StageEdge(
                prev.id, node_id, self._shape, self._dtype, self._spec,
                self._wire_bytes))
        return node_id

    def exchange(self, label: str, payload_shape: Iterable[int],
                 axis_size: int, rendering: str, *, chunks: int = 1,
                 subblocks: int = 1, schedule_depth: int = 0,
                 wire_spec: Any = "", decoded_spec: Any = "",
                 fused_encode: bool = False,
                 decode_fuses: Optional[Tuple[str, ...]] = None) -> str:
        """Append one declared exchange as its full stage group —
        ``(encode ->) exchange (-> decode)`` under a compressed wire,
        the bare exchange under native — with the wire-byte bookkeeping
        (ring discount included) applied to every edge touching it.

        Under a compressed wire the decode node is appended here and the
        payload is reset to the decoded complex form (``decoded_spec``).
        Under a native wire the exchange's OUT edge is the one the NEXT
        family-added node creates, so the caller must set its own
        payload only after appending that node."""
        shape = tuple(int(s) for s in payload_shape)
        ring = rendering in contracts._RING_RENDERINGS
        pred = opscan.predicted_payload_bytes(
            shape, self._cdt, self._wire,
            ring_size=axis_size if ring else 0)
        compressed = self._wire != "native"
        if compressed:
            # The edge into the encode carries the complex payload the
            # wire is about to compress (what the decode must restore).
            self.payload(shape, self._cdt, wire_spec, 0)
            if fused_encode:
                self.node("fused_kernel", fuses=("encode", "pack"),
                          label=f"{label} encode")
            else:
                self.node("encode", label=f"{label} encode")
            self.payload((2,) + shape, "bfloat16", wire_spec, pred)
        else:
            self.payload(shape, self._cdt, wire_spec, pred)
        xid = self.node("exchange", label=label, rendering=rendering,
                        axis_size=axis_size, chunks=chunks,
                        subblocks=subblocks, payload_shape=shape,
                        schedule_depth=schedule_depth)
        if compressed:
            if decode_fuses:
                self.node("fused_kernel", fuses=decode_fuses,
                          label=f"{label} decode")
            else:
                self.node("decode", label=f"{label} decode")
            self.payload(shape, self._cdt, decoded_spec, 0)
        return xid

    def graph(self) -> PlanGraph:
        return PlanGraph(self._family, self._direction, self._wire,
                         self._guards, self._cdt,
                         tuple(self._nodes), tuple(self._edges))


def shipped_schedule_depth(rendering: str, config: Any = None) -> int:
    """The pipelined-schedule depth a rendering ships with under
    ``config``: the resolved ``Config.overlap_depth`` for the
    revolving-buffer RING_OVERLAP pipeline and the pipelined a2a's
    issue-ahead window ("auto" -> 2, the shipped double-buffered
    schedule), 1 for the serial RING, 0 for every other rendering.
    ``config=None`` keeps the pre-autotune defaults. The single source
    the three family ``_declare_graph`` hooks share."""
    if rendering == "ring":
        return 1
    if rendering not in ("ring_overlap", "a2a_pipe"):
        return 0
    if config is None:
        return 2
    return int(config.resolved_overlap_depth())


def split_spec(*axes_groups: Any, ndim: int = 3) -> str:
    """A spec string of how a padded global array lies over the ranks:
    ``split_spec(0)`` -> ``"p,-,-"`` (axis 0 split over the plan's ranks);
    pencil-style pairs ``split_spec((0, "p1"), (1, "p2"))`` -> ``"p1,p2,-"``.
    Descriptive only: no check reads it."""
    names = ["-"] * ndim
    for a in axes_groups:
        ax, name = (a, "p") if isinstance(a, int) else a
        names[ax] = name
    return ",".join(names)


def payload_dtypes(config: Any, transform: str) -> Tuple[str, str]:
    """``(complex_dtype, real_side_dtype)`` of a plan's payloads under
    its config: the spectral dtype every exchange moves, and the dtype
    of the real-side boundary (equal to the complex dtype for c2c
    plans). Shared by the family ``_declare_graph`` hooks."""
    cdt = "complex128" if config.double_prec else "complex64"
    if transform == "c2c":
        return cdt, cdt
    return cdt, "float64" if config.double_prec else "float32"


# ---------------------------------------------------------------------------
# family registry (populated by the model modules at import, next to the
# contracts registration — one import, two declarative surfaces)
# ---------------------------------------------------------------------------

_GRAPH_FAMILIES: Dict[str, Callable[..., PlanGraph]] = {}


def register_graph_family(family: str,
                          declare: Callable[..., PlanGraph]) -> None:
    """Called by each model module: ``declare(plan, direction, dims)``
    returns the direction's ``PlanGraph``. Families are keyed like the
    contract registry (``contracts.register_family``)."""
    _GRAPH_FAMILIES[family] = declare


class MissingGraph(KeyError):
    """No stage graph declared for a plan family — a verify-matrix
    failure, never a silent skip."""


def graph_for(plan: Any, direction: str = "forward",
              dims: int = 3) -> PlanGraph:
    """Resolve the declared stage graph for one direction of a live
    plan. Raises ``MissingGraph`` when the family never registered a
    declaration (``dfft-torch-verify`` turns that into a combo FAILURE)."""
    family = contracts.family_of(plan)
    declare = _GRAPH_FAMILIES.get(family)
    if declare is None:
        raise MissingGraph(
            f"family {family!r} registered no _declare_graph "
            f"(known: {sorted(_GRAPH_FAMILIES)})")
    return declare(plan, direction, dims)


# ---------------------------------------------------------------------------
# (a) well-formedness
# ---------------------------------------------------------------------------

def _viol(graph: PlanGraph, check: str, message: str) -> GraphViolation:
    return GraphViolation(graph.name, check, message)


def _check_dataflow(graph: PlanGraph) -> List[GraphViolation]:
    """Single-source/single-sink DAG with every node on an
    input->output path — no orphan stages, no dead ends, no cycles."""
    out: List[GraphViolation] = []
    ids = [n.id for n in graph.nodes]
    if len(set(ids)) != len(ids):
        out.append(_viol(graph, "dataflow", "duplicate node ids"))
        return out
    idset = set(ids)
    for e in graph.edges:
        for end in (e.src, e.dst):
            if end not in idset:
                out.append(_viol(graph, "dataflow",
                                 f"edge references unknown node {end!r}"))
                return out
    sources = [n.id for n in graph.nodes if n.kind == "input"]
    sinks = [n.id for n in graph.nodes if n.kind == "output"]
    if len(sources) != 1 or len(sinks) != 1:
        out.append(_viol(
            graph, "dataflow",
            f"expected exactly one input and one output node, got "
            f"{len(sources)} input(s) / {len(sinks)} output(s)"))
        return out
    succ: Dict[str, List[str]] = {i: [] for i in ids}
    pred: Dict[str, List[str]] = {i: [] for i in ids}
    for e in graph.edges:
        succ[e.src].append(e.dst)
        pred[e.dst].append(e.src)
    # Reachability both ways: forward from input, backward from output.
    def closure(start: str, adj: Dict[str, List[str]]) -> set:
        seen = {start}
        stack = [start]
        while stack:
            for nxt in adj[stack.pop()]:
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append(nxt)
        return seen

    fwd = closure(sources[0], succ)
    bwd = closure(sinks[0], pred)
    for n in graph.nodes:
        if n.id not in fwd or n.id not in bwd:
            out.append(_viol(
                graph, "dataflow",
                f"node {n.id!r} is not on an input->output path "
                "(orphan or dead-end stage)"))
    # Cycle check: Kahn's topological sort must consume every node.
    indeg = {i: len(pred[i]) for i in ids}
    queue = [i for i in ids if indeg[i] == 0]
    seen = 0
    while queue:
        cur = queue.pop()
        seen += 1
        for nxt in succ[cur]:
            indeg[nxt] -= 1
            if indeg[nxt] == 0:
                queue.append(nxt)
    if seen != len(ids):
        out.append(_viol(graph, "dataflow", "graph contains a cycle"))
    return out


def _check_wire_pairing(graph: PlanGraph) -> List[GraphViolation]:
    out: List[GraphViolation] = []
    encoders = [n for n in graph.nodes if n.encodes()]
    decoders = [n for n in graph.nodes if n.decodes()]
    if graph.wire == "native":
        for n in encoders + decoders:
            out.append(_viol(
                graph, "wire-pairing",
                f"native wire but graph declares {n.kind} node "
                f"{n.id!r} — the wire layer must be structurally inert"))
        return out
    if len(encoders) != len(decoders):
        out.append(_viol(
            graph, "wire-pairing",
            f"unpaired encode/decode nodes: {len(encoders)} encode(s) "
            f"but {len(decoders)} decode(s) — a dropped decode leaves "
            "the payload bf16 past the exchange"))
    for x in graph.exchanges():
        preds = [graph.node(e.src) for e in graph.in_edges(x.id)]
        succs = [graph.node(e.dst) for e in graph.out_edges(x.id)]
        if not any(p.encodes() for p in preds):
            out.append(_viol(
                graph, "wire-pairing",
                f"compressed exchange {x.id!r} has no encode stage "
                "immediately upstream"))
        if not any(s.decodes() for s in succs):
            out.append(_viol(
                graph, "wire-pairing",
                f"compressed exchange {x.id!r} has no decode stage "
                "immediately downstream"))
    for n in encoders:
        succs = [graph.node(e.dst) for e in graph.out_edges(n.id)]
        if not any(s.kind == "exchange" for s in succs):
            out.append(_viol(
                graph, "wire-pairing",
                f"encode node {n.id!r} does not feed an exchange"))
    for n in decoders:
        preds = [graph.node(e.src) for e in graph.in_edges(n.id)]
        if not any(p.kind == "exchange" for p in preds):
            out.append(_viol(
                graph, "wire-pairing",
                f"decode node {n.id!r} is not fed by an exchange"))
    return out


def _check_dtype_flow(graph: PlanGraph) -> List[GraphViolation]:
    """An exchange moves its payload dtype unchanged, and the stage pair
    around a compressed exchange restores the pre-encode dtype."""
    out: List[GraphViolation] = []
    for x in graph.exchanges():
        ins = graph.in_edges(x.id)
        outs = graph.out_edges(x.id)
        din = {e.dtype for e in ins}
        dout = {e.dtype for e in outs}
        if din != dout:
            out.append(_viol(
                graph, "dtype-flow",
                f"exchange {x.id!r} retypes its payload: "
                f"{sorted(din)} -> {sorted(dout)}"))
        for e in ins:
            src = graph.node(e.src)
            if src.encodes():
                enc_in = {i.dtype for i in graph.in_edges(src.id)}
                for o in outs:
                    dst = graph.node(o.dst)
                    if dst.decodes():
                        dec_out = {d.dtype
                                   for d in graph.out_edges(dst.id)}
                        if enc_in != dec_out:
                            out.append(_viol(
                                graph, "dtype-flow",
                                f"decode after {x.id!r} restores "
                                f"{sorted(dec_out)} but the encode "
                                f"consumed {sorted(enc_in)} — the wire "
                                "must restore the pre-encode width"))
    return out


def _check_payload(graph: PlanGraph) -> List[GraphViolation]:
    """Payload conservation: the wire bytes on every edge touching an
    exchange equal ``wire_nbytes`` over the node's declared GLOBAL
    payload under the graph's wire encoding, with the exact ``(P-1)/P``
    discount for ring renderings — and in == out (the exchange moves
    bytes, it does not create or lose them)."""
    out: List[GraphViolation] = []
    for x in graph.exchanges():
        ring = x.rendering in contracts._RING_RENDERINGS
        want = opscan.predicted_payload_bytes(
            x.payload_shape, graph.complex_dtype, graph.wire,
            ring_size=x.axis_size if ring else 0)
        got_in = {e.wire_bytes for e in graph.in_edges(x.id)}
        got_out = {e.wire_bytes for e in graph.out_edges(x.id)}
        if got_in != got_out:
            out.append(_viol(
                graph, "payload",
                f"exchange {x.id!r} does not conserve wire bytes: "
                f"{sorted(got_in)} in vs {sorted(got_out)} out"))
        for got in sorted(got_in | got_out):
            if got != want:
                out.append(_viol(
                    graph, "payload",
                    f"exchange {x.id!r} edge carries {got} wire B but "
                    f"the declared payload {x.payload_shape} predicts "
                    f"{want} B"
                    + (" (with the (P-1)/P ring discount)" if ring
                       else "")))
    return out


def _check_guard_arity(graph: PlanGraph) -> List[GraphViolation]:
    guards = [n for n in graph.nodes if n.kind == "guard"]
    if graph.guards == "off":
        if guards:
            return [_viol(graph, "guard-arity",
                          f"guards=\"off\" but {len(guards)} guard "
                          "node(s) declared — guard stages may not "
                          "exist in the default path")]
        return []
    if len(guards) != 1:
        return [_viol(graph, "guard-arity",
                      f"guards=\"{graph.guards}\" expects exactly one "
                      f"guard node, got {len(guards)}")]
    succs = [graph.node(e.dst) for e in graph.out_edges(guards[0].id)]
    if not any(s.kind == "output" for s in succs):
        return [_viol(graph, "guard-arity",
                      "the guard node must wrap the pipeline result "
                      "(feed the output node)")]
    return []


def _check_schedules(graph: PlanGraph) -> List[GraphViolation]:
    """Every pipelined exchange schedule must prove hazard-free at its
    declared depth/sub-block split (``analysis/schedverify.py``): the
    ring renderings' revolving-buffer micro-step schedule, and the
    pipelined all_to_all's issue-ahead window (verified as the
    equivalent K-step revolving discipline — K chunk collectives, the
    same issue/wait/compute semantics)."""
    out: List[GraphViolation] = []
    for x in graph.exchanges():
        if x.rendering == "a2a_pipe":
            depth = x.schedule_depth
            if depth < 1:
                out.append(_viol(
                    graph, "schedule",
                    f"pipelined exchange {x.id!r} declares no schedule "
                    f"depth"))
                continue
            k = max(1, x.chunks)
            timeline = schedverify.revolving_schedule(k + 1, depth)
            for h in schedverify.check_schedule(timeline, k + 1, depth):
                out.append(_viol(graph, "schedule",
                                 f"exchange {x.id!r}: {h}"))
            continue
        if x.rendering not in contracts._RING_RENDERINGS:
            if x.schedule_depth:
                out.append(_viol(
                    graph, "schedule",
                    f"non-pipelined exchange {x.id!r} declares schedule "
                    f"depth {x.schedule_depth}"))
            continue
        depth = x.schedule_depth
        if depth < 1:
            out.append(_viol(
                graph, "schedule",
                f"ring exchange {x.id!r} declares no schedule depth"))
            continue
        if x.rendering == "ring_overlap" and depth < 2:
            out.append(_viol(
                graph, "schedule",
                f"ring_overlap exchange {x.id!r} declares depth "
                f"{depth} — the revolving pipeline needs >= 2 buffers"))
        timeline = schedverify.revolving_schedule(x.axis_size, depth,
                                                  x.subblocks)
        for h in schedverify.check_schedule(timeline, x.axis_size, depth,
                                            x.subblocks):
            out.append(_viol(graph, "schedule",
                             f"exchange {x.id!r}: {h}"))
    return out


def check_graph(graph: PlanGraph) -> List[GraphViolation]:
    """All well-formedness checks over one declared graph (empty = the
    graph is internally sound; conformance against the contract and the
    traced/compiled program are separate layers)."""
    out = _check_dataflow(graph)
    if out:
        # Structural breakage makes the local checks meaningless (and
        # possibly crashy — missing endpoints); report it alone.
        return out
    out += _check_wire_pairing(graph)
    out += _check_dtype_flow(graph)
    out += _check_payload(graph)
    out += _check_guard_arity(graph)
    out += _check_schedules(graph)
    return out


# ---------------------------------------------------------------------------
# (a2) stage-scope conformance (obs/profile.py attribution)
# ---------------------------------------------------------------------------

def _scoped_nodes(graph: PlanGraph) -> List[Tuple[StageNode, str]]:
    """``(node, expected scope string)`` for every declared node whose ops
    the build runs under a stage scope. Exempt: input/output (structural)
    and guard nodes under ``guards="off"`` (none declared). Unlike the JAX
    package, a Peer2Peer exchange is scoped: the port posts its messages
    itself."""
    from ..obs import profile

    out: List[Tuple[StageNode, str]] = []
    for n in graph.nodes:
        if n.kind in ("input", "output"):
            continue
        if n.kind in ("exchange", "local_fft", "guard"):
            out.append((n, profile.scope_name(graph.family, n.id)))
        elif n.encodes():
            out.append((n, profile.scope_name("wire", "encode")))
        elif n.decodes():
            out.append((n, profile.scope_name("wire", "decode")))
    return out


def check_graph_scopes(graph: PlanGraph,
                       trace: opscan.OpTrace) -> List[GraphViolation]:
    """Every declared node with an op region must have entered its
    ``dfft/<family>/<node-id>`` stage scope in ``trace`` (recorded under a
    profiler, where scopes are entered: ``obs/profile.stage_scope``), so
    ``obs/profile.py`` attribution can never silently drop a stage.
    Skipped when scopes are disabled (``profile.disable_scopes()`` /
    ``$DFFT_NO_STAGE_SCOPES`` — the pins' comparison side)."""
    from ..obs import profile

    if not profile.scopes_enabled():
        return []
    entered = set(opscan.scope_labels(trace))
    out: List[GraphViolation] = []
    for node, scope in _scoped_nodes(graph):
        if scope not in entered:
            out.append(_viol(
                graph, "scope-conformance",
                f"declared node {node.id!r} entered no stage scope "
                f"{scope!r} in the recorded trace — its device time would "
                "be unattributable"))
    return out


# ---------------------------------------------------------------------------
# (b) graph <-> contract and graph <-> trace conformance
# ---------------------------------------------------------------------------

def graph_decls(graph: PlanGraph) -> Tuple[contracts.ExchangeDecl, ...]:
    """The graph's exchange nodes as ``ExchangeDecl``s — the common
    currency of the contract registry."""
    return tuple(contracts.ExchangeDecl(
        label=x.label or x.id, payload_shape=x.payload_shape,
        axis_size=x.axis_size, rendering=x.rendering, chunks=x.chunks,
        subblocks=x.subblocks)
        for x in graph.exchanges())


def check_graph_contract(graph: PlanGraph,
                         contract: contracts.Contract
                         ) -> List[GraphViolation]:
    """The graph's exchanges must reconcile 1:1 with the family's
    ``_contract_exchanges`` declaration — two declarative surfaces, one
    truth."""
    def key(d: contracts.ExchangeDecl) -> Tuple[Any, ...]:
        return (d.rendering, tuple(d.payload_shape), d.axis_size,
                max(1, d.chunks), max(1, d.subblocks))

    out: List[GraphViolation] = []
    got = sorted(key(d) for d in graph_decls(graph))
    want = sorted(key(d) for d in contract.exchanges)
    if got != want:
        out.append(_viol(
            graph, "contract-conformance",
            f"graph exchanges {got} do not reconcile with the family's "
            f"contract declaration {want}"))
    return out


def check_graph_trace(plan: Any, graph: PlanGraph,
                      direction: str = "forward", dims: int = 3,
                      trace: Optional[opscan.OpTrace] = None
                      ) -> List[GraphViolation]:
    """Graph <-> trace conformance: the execution the build records must
    implement the declared graph.

    * census side — the trace must contain AT LEAST the declared
      collectives: one ``all_to_all`` per declared a2a piece, ``(P-1)·S``
      ``send`` per declared ring and ``(P-1)·K`` per declared Peer2Peer
      (a declared exchange the build never runs — a phantom — fails
      here), and no ``send`` where no point-to-point exchange is
      declared;
    * contract side — a contract synthesized from the GRAPH's exchange
      nodes (``contracts.contract_from_decls``) must pass against the
      trace's census, forbidden ops and payload.

    ``trace`` lets a caller that already recorded the combo share it.
    Collective when it records: every rank calls it.
    """
    out: List[GraphViolation] = []
    decls = graph_decls(graph)
    if trace is None:
        trace = opscan.record_plan(plan, direction, dims)
    census = opscan.collective_census(trace)
    traced_a2a = contracts._combined(census, "all_to_all")
    traced_send = census["send"]
    want_a2a = sum(max(1, d.chunks) for d in decls
                   if d.rendering in ("a2a", "streams", "a2a_pipe"))
    want_send = sum(max(0, d.axis_size - 1) * max(1, d.subblocks)
                    for d in decls
                    if d.rendering in contracts._RING_RENDERINGS)
    want_send += sum(max(0, d.axis_size - 1) * max(1, d.chunks)
                     for d in decls if d.rendering == "p2p")
    if traced_a2a < want_a2a:
        out.append(_viol(
            graph, "trace-conformance",
            f"graph declares {want_a2a} all-to-all piece(s) but the build "
            f"recorded {traced_a2a} — a declared exchange the build does "
            "not implement (phantom exchange)"))
    if traced_send < want_send:
        out.append(_viol(
            graph, "trace-conformance",
            f"graph declares point-to-point exchange(s) needing >= "
            f"{want_send} send(s) but the build recorded {traced_send} "
            "(phantom exchange)"))
    if want_send == 0 and traced_send > 0:
        out.append(_viol(
            graph, "trace-conformance",
            f"build recorded {traced_send} send(s) but the graph declares "
            "no point-to-point exchange"))
    synth = contracts.contract_from_decls(
        graph.family, direction, graph.wire, graph.guards,
        graph.complex_dtype, decls)
    staged = opscan.staged_exchange_total(trace, opscan.plan_ranks(plan))
    for v in contracts.check_contract(synth, census, trace, staged):
        out.append(_viol(graph, "trace-conformance", str(v)))
    return out


def verify_graph(plan: Any, direction: str = "forward",
                 dims: int = 3) -> List[GraphViolation]:
    """The one-call graph pass over a live plan: resolve the declared
    graph, run well-formedness, contract conformance, trace conformance
    and stage-scope conformance on one execution recorded under a
    profiler. Collective: every rank calls it."""
    graph = graph_for(plan, direction, dims)
    out = check_graph(graph)
    out += check_graph_contract(
        graph, contracts.contract_for(plan, direction, dims))
    trace = record_scoped(plan, direction, dims)
    out += check_graph_trace(plan, graph, direction, dims, trace=trace)
    out += check_graph_scopes(graph, trace)
    return out


def record_scoped(plan: Any, direction: str = "forward",
                  dims: int = 3) -> opscan.OpTrace:
    """``opscan.record_plan`` under a CPU-activity ``torch.profiler``, so
    the stage scopes (entered only while a profiler records) show in the
    trace as ``profiler.*`` ops."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        return opscan.record_plan(plan, direction, dims)


# ---------------------------------------------------------------------------
# presentation (shared by dfft-torch-verify and dfft-torch-explain)
# ---------------------------------------------------------------------------

def _fmt_bytes(n: int) -> str:
    if n >= 1 << 30:
        return f"{n / (1 << 30):.2f} GiB"
    if n >= 1 << 20:
        return f"{n / (1 << 20):.2f} MiB"
    if n >= 1 << 10:
        return f"{n / (1 << 10):.2f} KiB"
    return f"{n} B"


def _node_brief(n: StageNode) -> str:
    if n.kind == "local_fft":
        axes = ",".join("xyz"[a] if 0 <= a <= 2 else str(a)
                        for a in n.axes)
        return f"local_fft[{axes}]"
    if n.kind == "exchange":
        extra = f" depth={n.schedule_depth}" if n.schedule_depth else ""
        k = f" k={n.chunks}" if n.chunks > 1 else ""
        s = f" sub={n.subblocks}" if n.subblocks > 1 else ""
        return f"exchange[{n.rendering} P={n.axis_size}{k}{s}{extra}]"
    if n.kind == "fused_kernel":
        return f"fused[{'+'.join(n.fuses)}]"
    return n.kind


def format_graph(graph: PlanGraph) -> List[str]:
    """Human-readable graph lines — the ``graph:`` section of
    ``dfft-torch-explain``, printed from the SAME registry the verifier
    checks so explain cannot disagree with it."""
    order = {n.id: i for i, n in enumerate(graph.nodes)}
    chain = " -> ".join(_node_brief(n) for n in
                        sorted(graph.nodes, key=lambda n: order[n.id]))
    lines = [f"  {graph.name} ({len(graph.nodes)} nodes / "
             f"{len(graph.edges)} edges, wire {graph.wire}, guards "
             f"{graph.guards}): {chain}"]
    for x in graph.exchanges():
        ins = graph.in_edges(x.id)
        wb = ins[0].wire_bytes if ins else 0
        sched = ""
        if x.schedule_depth:
            sched = f" (schedule depth {x.schedule_depth}"
            if x.subblocks > 1:
                sched += f", {x.subblocks} sub-blocks"
            sched += ")"
        lines.append(
            f"  {x.label or x.id}: payload {x.payload_shape} "
            f"{graph.complex_dtype} -> {_fmt_bytes(wb)} on the wire"
            + sched)
    return lines
