"""The rest of the port's ``testing/microbench.py`` against the JAX
package's: the fraction chain (reference testcase 4) and the pure
exchange's bandwidth over one 4-rank gloo world, held to the JAX gate's
contract and the JAX result's shape on a 4-device mesh; the wire layer's
error metric against JAX's on the same arrays; the realigned pack shape
and the executable's testcase 4 over the world."""

import os
import pickle
import sys
import traceback

import numpy as np
import pytest
import torch

import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch.parallel import multihost
from distributedfft_tpu_torch.testing import microbench as mb

P = 4
FORBIDDEN = ("jax", "jaxlib", "distributedfft_tpu")
GATE_KEYS = {"fraction", "fraction_spread", "fraction_range", "gate_phase",
             "gate_note", "variant", "variants", "pipe_gb_per_s",
             "raw_gb_per_s", "k", "repeats", "iterations"}
DEGENERATE_KEYS = {"degenerate", "k", "repeats", "dropped", "phase"}


def _slab_prexpose_spec(n: int, **cfg):
    """(plan, this rank's pre-transpose spectral block): the chain's
    operands, as the reference executable's testcase 4 builds them."""
    g = tdfft.GlobalSize(n, n, n)
    plan = tdfft.SlabFFTPlan(g, tdfft.SlabPartition(P),
                             tdfft.Config(comm_method=tdfft.CommMethod.ALL2ALL,
                                          use_wisdom=False, **cfg),
                             device="cpu")
    x = plan.pad_input(np.random.default_rng(0).random(g.shape)
                       .astype(np.float32))
    return plan, plan.forward_stages()[0][1](x)


def _gate():
    plan, spec = _slab_prexpose_spec(32)
    return mb.transpose_fraction_chain(plan, spec, k=6, repeats=3)


def _gate_streams():
    plan, spec = _slab_prexpose_spec(32)
    return mb.transpose_fraction_chain(plan, spec, k=4, repeats=2,
                                       streams_variants=(2,),
                                       publication_repeats=3,
                                       publication_iterations=2)


def _bad_divisibility():
    plan, spec = _slab_prexpose_spec(8)   # local leading extent 2 over 4
    try:
        mb.transpose_fraction_chain(plan, spec, k=2, repeats=1)
    except ValueError as e:
        return str(e)
    return None


def _wire():
    ok = mb.wire_bandwidth((64, 16, 16), P, iterations=2, warmup=1,
                           windows=2, device="cpu")
    try:
        mb.wire_bandwidth((24, 16, 16), P, device="cpu")
        bad = None
    except ValueError as e:
        bad = str(e)
    return {"ok": ok, "bad": bad}


def _max_rel_err_over_ranks(rank):
    """The gate's error metric over the ranks: each rank's block, every
    rank the global figure."""
    rng = np.random.default_rng(4)
    a = rng.standard_normal((8, 6)) + 1j * rng.standard_normal((8, 6))
    b = a + 1e-3 * rng.standard_normal((8, 6))
    b[5, 2] += 0.5
    return {"local": mb.max_rel_err(torch.from_numpy(a[2 * rank:2 * rank + 2]),
                                    torch.from_numpy(b[2 * rank:2 * rank + 2]),
                                    (None,)),
            "a": a, "b": b}


def _reference_t4():
    import contextlib
    import io
    from distributedfft_tpu_torch.cli import reference as tref
    out = {}
    for flags in ([], ["--streams-chunks", "2"], ["-nx", "8"]):
        buf = io.StringIO()
        argv = ["-nx", "32", "-ny", "16", "-nz", "16", "-t", "4", "-i", "3",
                "--emulate-devices", str(P)]
        argv = (argv[:1] + flags[1:] + argv[2:]) if flags[:1] == ["-nx"] \
            else argv + flags
        with contextlib.redirect_stdout(buf):
            rc = tref.main(argv)
        out[" ".join(flags) or "default"] = {"rc": rc,
                                             "text": buf.getvalue()}
    return out


def _rank_main(rank, addr, outdir):
    multihost.maybe_initialize(addr, P, rank, backend="gloo", timeout_s=180)
    torch.set_num_threads(1)    # four ranks on the host's cores, no more
    results = {}
    for name, fn in (("gate", _gate), ("streams", _gate_streams),
                     ("bad", _bad_divisibility), ("wire", _wire),
                     ("err", lambda: _max_rel_err_over_ranks(rank)),
                     ("t4", _reference_t4)):
        try:
            results[name] = fn()
        except Exception:  # noqa: BLE001 — reported by that case's test
            results[name] = {"error": traceback.format_exc()}
    results["modules"] = sorted(m for m in sys.modules
                                if m.split(".")[0] in FORBIDDEN)
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    multihost.shutdown()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("microbench")
    torch.multiprocessing.start_processes(
        _rank_main, args=(multihost.local_coordinator(), str(outdir)),
        nprocs=P, start_method="spawn")
    out = []
    for r in range(P):
        with open(outdir / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _result(world, rank, key):
    res = world[rank][key]
    if isinstance(res, dict) and "error" in res:
        pytest.fail(f"rank {rank} failed {key}:\n{res['error']}")
    return res


def _held_to_the_gate(r, variants):
    """The JAX gate's contract: a fraction in (0, 5) inside its spread,
    positive rates, the winner among the raced variants; or, on a host
    where every repeat drowned in noise, a degenerate result saying so."""
    if r.get("degenerate"):
        assert DEGENERATE_KEYS <= set(r) and r["dropped"] == r["repeats"]
        return
    assert set(r) - {"dropped"} == GATE_KEYS
    assert 0.0 < r["fraction"] < 5.0
    lo, hi = r["fraction_spread"]
    assert lo <= r["fraction"] <= hi
    rlo, rhi = r["fraction_range"]
    assert rlo <= lo and hi <= rhi
    assert r["pipe_gb_per_s"] > 0 and r["raw_gb_per_s"] > 0
    assert r["variant"] in r["variants"] and set(r["variants"]) <= variants
    # Selection-phase fractions rank the variants (a few short pairs on
    # ranks sharing a loaded CPU); only the published median is the gate.
    for v in r["variants"].values():
        assert 0.0 < v["fraction"] < float("inf")


def test_transpose_fraction_chain_is_a_gate(world, devices):
    """Every rank's result holds the gate's contract, with one winner on
    every rank (rank 0's pick, agreed); JAX's gate on a 4-device mesh at
    the same shape has the same keys and variants."""
    import distributedfft_tpu as jdfft
    from distributedfft_tpu.parallel.mesh import make_slab_mesh
    from distributedfft_tpu.testing import microbench as jmb
    rows = [_result(world, r, "gate") for r in range(P)]
    for r in rows:
        _held_to_the_gate(r, {"opt0", "opt1"})
    if not rows[0].get("degenerate"):
        assert len({r["variant"] for r in rows}) == 1
        assert all(r["k"] == 6 and r["repeats"] == 3 and
                   r["iterations"] == 6 for r in rows)
    g = jdfft.GlobalSize(32, 32, 32)
    jplan = jdfft.SlabFFTPlan(g, jdfft.SlabPartition(P),
                              jdfft.Config(comm_method=jdfft.CommMethod.ALL2ALL,
                                           use_wisdom=False),
                              mesh=make_slab_mesh(P, devices))
    x = jplan.pad_input(np.random.default_rng(0).random(g.shape)
                        .astype(np.float32))
    jr = jmb.transpose_fraction_chain(jplan, jplan.forward_stages()[0][1](x),
                                      k=6, repeats=3)
    _held_to_the_gate(jr, {"opt0", "opt1"})
    if not (jr.get("degenerate") or rows[0].get("degenerate")):
        assert set(jr) - {"dropped"} == set(rows[0]) - {"dropped"}


def test_fraction_chain_races_the_pieced_exchange(world):
    rows = [_result(world, r, "streams") for r in range(P)]
    for r in rows:
        _held_to_the_gate(r, {"opt0", "opt1", "opt1s2"})
        if not r.get("degenerate"):
            assert r["repeats"] == 3 and r["iterations"] == 2


def test_transpose_fraction_chain_rejects_bad_divisibility(world):
    assert all("divisible" in _result(world, r, "bad") for r in range(P))


def test_wire_bandwidth_pure_exchange(world):
    for r in range(P):
        w = _result(world, r, "wire")
        assert w["ok"]["gb_per_s"] > 0 and w["ok"]["seconds"] > 0
        assert w["ok"]["collective_ops"] == ["all_to_all"]
        assert w["ok"]["bytes"] == 64 * 16 * 16 * 4
        assert "wire probe" in w["bad"]


def test_max_rel_err_over_ranks_is_jax(world):
    """Every rank's blockwise figure is the global one, JAX's on the
    whole arrays."""
    import jax
    from distributedfft_tpu.testing import microbench as jmb
    r0 = _result(world, 0, "err")
    want = jmb.max_rel_err(jax.device_put(r0["a"]), jax.device_put(r0["b"]))
    for r in range(P):
        assert _result(world, r, "err")["local"] == pytest.approx(want,
                                                                  rel=1e-12)


def test_max_rel_err_one_process_is_jax(rng):
    import jax
    from distributedfft_tpu.testing import microbench as jmb
    a = rng.standard_normal((5, 7)).astype(np.complex64)
    b = a + rng.standard_normal((5, 7)).astype(np.float32) * 1e-2
    assert mb.max_rel_err(torch.from_numpy(a), torch.from_numpy(b)) == \
        pytest.approx(jmb.max_rel_err(jax.device_put(a), jax.device_put(b)),
                      rel=1e-6)


def test_realigned_pack_shape_matches_transpose():
    from distributedfft_tpu.parallel.transpose import \
        realigned_pack_shape as jshape
    from distributedfft_tpu_torch.parallel.transpose import \
        realigned_pack_shape
    for args in (((4, 16, 5), 1, 8), ((4, 7, 16), 2, 8), ((16, 3, 3), 0, 8)):
        assert realigned_pack_shape(*args) == jshape(*args)
    with pytest.raises(ValueError, match="divisible"):
        realigned_pack_shape((4, 9, 5), 1, 8)


def test_reference_cli_fraction_gate(world):
    """``dfft-torch-reference -t 4`` over the world (rank 0 prints):
    exit 0 with the gate's line (1 only where every repeat drowned in
    noise); a shape the chain cannot take exits 2."""
    out = _result(world, 0, "t4")
    for name in ("default", "--streams-chunks 2"):
        assert out[name]["rc"] in (0, 1)
        if out[name]["rc"] == 0:
            assert "All2All fraction:" in out[name]["text"]
            assert "ceiling" in out[name]["text"]
    assert out["-nx 8"]["rc"] == 2
    for r in range(1, P):
        assert _result(world, r, "t4")["default"]["text"] == ""


def test_ranks_import_no_jax(world):
    assert all(w["modules"] == [] for w in world)
