"""The port's declared stage graphs and exchange declarations against the
JAX package's, combo by combo over ``dfft-torch-verify``'s default
matrix (slab at P = 4, the 2 x 2 pencil, batched ``shard="x"`` at P = 4,
every rendering x wire x guards x direction, plus the single-device,
Bluestein and batch-shard combos).

One 4-rank gloo world is spawned for the whole file (a module fixture):
the ranks build each combo's port plan (the pencil's groups need the
world) and rank 0 returns, per combo, ``plangraph.graph_for``,
``_contract_exchanges`` and the port's ``predicted_payload_bytes`` of
each declared exchange. This process builds the JAX plan of the same
Config and shape on 4 of the conftest's virtual devices and compares:
node ids, kinds, labels, axes, renderings, group sizes, chunks,
sub-blocks, payload shapes, schedule depths and fused stages; edge
endpoints, shapes, dtypes and wire bytes; the graph's printed lines; the
declarations; the payload arithmetic. The sharding spec strings are each
package's own vocabulary and are not compared. Nothing here traces a JAX
plan: ``graph_for`` and ``_contract_exchanges`` are declarations."""

import os
import pickle
import sys
import traceback

import pytest
import torch

from distributedfft_tpu_torch.analysis import verify as tverify
from distributedfft_tpu_torch.parallel import multihost

P = 4
FORBIDDEN = ("jax", "jaxlib", "distributedfft_tpu")
COMBOS = list(tverify.iter_combos(tverify.build_parser().parse_args([]), P))


def _combo_id(c):
    if c.get("single"):
        return "single"
    if c.get("bluestein"):
        return "bluestein"
    if c.get("batch_shard"):
        return "batch_shard"
    return "-".join((c["family"], c["rendering"], c["wire"], c["guards"],
                     c["direction"][:3]))


IDS = [_combo_id(c) for c in COMBOS]


# ---------------------------------------------------------------------------
# the world (no JAX here)
# ---------------------------------------------------------------------------

def _declared(combo):
    from distributedfft_tpu_torch.analysis import contracts, opscan, plangraph
    plan, dims = tverify.combo_plan(combo, P, device="cpu")
    d = combo["direction"]
    graph = plangraph.graph_for(plan, d, dims)
    decls = contracts._FAMILIES[contracts.family_of(plan)](plan, d, dims)
    cdt = contracts._complex_dtype(plan)
    return {"graph": graph, "decls": decls, "wire": plan.config.wire_dtype,
            "lines": plangraph.format_graph(graph),
            "violations": [str(v) for v in plangraph.check_graph(graph)],
            "predicted": [opscan.predicted_payload_bytes(
                x.payload_shape, cdt, plan.config.wire_dtype,
                ring_size=(x.axis_size if x.rendering
                           in contracts._RING_RENDERINGS else 0))
                for x in decls]}


def _rank_main(rank, addr, outdir):
    multihost.maybe_initialize(addr, P, rank, backend="gloo", timeout_s=180)
    torch.set_num_threads(1)
    results = {}
    for cid, combo in zip(IDS, COMBOS):
        try:
            results[cid] = _declared(combo)
        except Exception:  # noqa: BLE001 — reported by that combo's test
            results[cid] = {"error": traceback.format_exc()}
    results["modules"] = sorted(m for m in sys.modules
                                if m.split(".")[0] in FORBIDDEN)
    if rank == 0:
        with open(os.path.join(outdir, "rank0.pkl"), "wb") as f:
            pickle.dump(results, f)
    multihost.shutdown()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("plangraph")
    torch.multiprocessing.start_processes(
        _rank_main, args=(multihost.local_coordinator(), str(outdir)),
        nprocs=P, start_method="spawn")
    with open(outdir / "rank0.pkl", "rb") as f:
        return pickle.load(f)


def _jax_declared(combo, devices):
    """The JAX package's graph and declarations of the same combo."""
    import distributedfft_tpu as dfft
    from distributedfft_tpu import params as pm
    from distributedfft_tpu.analysis import contracts as jc
    from distributedfft_tpu.analysis import plangraph as jpg
    from distributedfft_tpu.analysis import verify as jv

    if combo.get("bluestein"):
        plan, dims = dfft.SlabFFTPlan(
            dfft.GlobalSize(20, 16, 19), pm.SlabPartition(P),
            dfft.Config(fft_backend="bluestein", use_wisdom=False)), 3
    elif combo.get("single"):
        plan, dims = dfft.SlabFFTPlan(dfft.GlobalSize(16, 16, 16),
                                      pm.SlabPartition(1),
                                      dfft.Config(use_wisdom=False)), 3
    elif combo.get("batch_shard"):
        plan, dims = dfft.Batched2DFFTPlan(
            P, 20, 16, pm.SlabPartition(P), dfft.Config(use_wisdom=False),
            shard="batch"), 2
    else:
        plan, dims = jv._make_plan(combo["family"], combo["rendering"],
                                   combo["wire"], combo["guards"],
                                   combo["sequence"] or "ZY_Then_X", P)
    d = combo["direction"]
    return (jpg.graph_for(plan, d, dims),
            jc._FAMILIES[jc.family_of(plan)](plan, d, dims), plan)


def _nodes(g):
    return [(n.id, n.kind, n.label, tuple(n.axes), n.rendering, n.axis_size,
             n.chunks, n.subblocks, tuple(n.payload_shape),
             n.schedule_depth, tuple(n.fuses)) for n in g.nodes]


def _edges(g):
    return [(e.src, e.dst, tuple(e.shape), str(e.dtype), e.wire_bytes)
            for e in g.edges]


def _decls(ds):
    return [(d.label, tuple(d.payload_shape), d.axis_size, d.rendering,
             d.chunks, d.subblocks) for d in ds]


def test_ranks_import_no_jax(world):
    assert world["modules"] == []


@pytest.mark.parametrize("combo", COMBOS, ids=IDS)
def test_graph_and_declarations_equal_jax(world, devices, combo):
    from distributedfft_tpu.analysis import hloscan
    from distributedfft_tpu.analysis import plangraph as jpg

    mine = world[_combo_id(combo)]
    if "error" in mine:
        pytest.fail(mine["error"])
    graph, decls, jplan = _jax_declared(combo, devices)
    g = mine["graph"]
    assert (g.family, g.direction, g.wire, g.guards, g.complex_dtype) == (
        graph.family, graph.direction, graph.wire, graph.guards,
        graph.complex_dtype)
    assert _nodes(g) == _nodes(graph)
    assert _edges(g) == _edges(graph)
    assert mine["lines"] == jpg.format_graph(graph)
    assert mine["violations"] == []
    assert _decls(mine["decls"]) == _decls(decls)
    cdt = "complex128" if jplan.config.double_prec else "complex64"
    assert mine["predicted"] == [hloscan.predicted_payload_bytes(
        d.payload_shape, cdt, mine["wire"],
        ring_size=(d.axis_size if d.rendering in ("ring", "ring_overlap")
                   else 0)) for d in decls]
