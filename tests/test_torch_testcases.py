"""The port's testcases, phase Timer, staged plan surface and Peer2Peer
exchange against the JAX package, on the CPU.

One 4-rank gloo world is spawned for the whole file (a module fixture) and
runs every P = 4 case of the port; the ranks import this module to find
``_rank_main``, so it imports neither JAX nor the JAX package at its top.
The JAX side runs in this process on the conftest's 8 virtual CPU devices
(a P = 4 plan on the first four).

Bounds: the JAX package's own (``tests/test_testcases.py``) in double
precision under "xla": testcase 1 residual < 1e-6, testcase 3 max < 1e-8,
testcase 4 max < 1e-9, for the port and JAX alike, and the two within that
bound of each other; in float32 under "pallas" (the kernels' plain
versions on the CPU) the result over its reference magnitude (the asum of
the truth, N, 3·sqrt(N)) <= 5e-4. The exchange renderings and the staged
surface are held bit for bit (``torch.equal``).
"""

import os
import pickle
import sys
import traceback
import types

import numpy as np
import pytest
import torch

import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch.parallel import multihost
from distributedfft_tpu_torch.parallel.transpose import (
    all_to_all_transpose, peer_to_peer_transpose)
from distributedfft_tpu_torch.testing import sharded
from distributedfft_tpu_torch.testing import testcases as ttc
from distributedfft_tpu_torch.utils import timer as ttimer

P = 4
SHAPES = [(16, 16, 16), (12, 20, 14)]
SEQS = ["ZY_Then_X", "Z_Then_YX", "Y_Then_ZX"]
JAX_BOUND = {1: 1e-6, 3: 1e-8, 4: 1e-9}
REL_TOL = 5e-4
# id -> (shape, sequence, testcase): the testcases held against JAX.
TC_CASES = {f"{'x'.join(map(str, sh))}-{seq}-t{tc}": (sh, seq, tc)
            for sh in SHAPES for seq in ("ZY_Then_X", "Y_Then_ZX")
            for tc in (1, 3, 4)}
# Exchange pairs (split, concat) of the three sequences' two directions.
AXIS_PAIRS = [(1, 0), (0, 1), (2, 0), (0, 2)]
XPOSE_SHAPES = [(8, 12, 20), (12, 8, 4)]
FORBIDDEN = ("jax", "jaxlib", "distributedfft_tpu")


def _cfg(backend="xla", double=False, **kw):
    return tdfft.Config(fft_backend=backend, double_prec=double, **kw)


def _port_tc(plan, tc):
    if tc == 1:
        return ttc.testcase1(plan, write_csv=False)["residual_sum"]
    fn = ttc.testcase3 if tc == 3 else ttc.testcase4
    return fn(plan, write_csv=False)["max_error"]


def _magnitude(shape, seq, tc):
    """A testcase's reference magnitude: the asum of the host truth (1), N
    (3), 3·sqrt(N) (4)."""
    n = int(np.prod(shape))
    if tc == 3:
        return float(n)
    if tc == 4:
        return 3.0 * np.sqrt(n)
    x = np.random.default_rng(0).random(shape)
    layout = types.SimpleNamespace(sequence=tdfft.SlabSequence.parse(seq))
    return float(np.abs(ttc.reference_spectrum(layout, x)).sum())


# ---------------------------------------------------------------------------
# The ranks (no JAX here)
# ---------------------------------------------------------------------------


def _plan(shape, seq, cfg, transform="r2c", p=P):
    return tdfft.SlabFFTPlan(tdfft.GlobalSize(*shape), tdfft.SlabPartition(p),
                             cfg, transform=transform, device="cpu",
                             sequence=seq)


def _global(shape, transform, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if transform == "c2c":
        x = x + 1j * rng.standard_normal(shape)
        return x.astype(np.complex64)
    return x.astype(np.float32)


def _staged_equal(plan, transform):
    """(forward, inverse) of the staged surface equal to exec_* bit for bit."""
    x = plan.pad_input(_global(plan.input_shape, transform))
    fwd, inv = ttc._fused_fns(plan)
    y = x
    for _, fn in plan.forward_stages():
        y = fn(y)
    c = fwd(x)
    z = c
    for _, fn in plan.inverse_stages():
        z = fn(z)
    return torch.equal(y, c), torch.equal(z, inv(c))


def _run_staged(case):
    shape, seq, transform, backend = case
    return _staged_equal(_plan(shape, seq, _cfg(backend), transform),
                         transform)


def _run_tc(case):
    shape, seq, backend, double, tc = case
    return _port_tc(_plan(shape, seq, _cfg(backend, double)), tc)


def _run_xpose(case):
    shape, split, concat, wire = case
    rank = torch.distributed.get_rank()
    x = torch.from_numpy(_global(shape, "c2c", 11))
    b = shape[concat] // P
    block = x.narrow(concat, rank * b, b).contiguous()
    a = all_to_all_transpose(block, None, split, concat, wire=wire)
    p = peer_to_peer_transpose(block, None, split, concat, wire=wire)
    return a.dtype == p.dtype and torch.equal(a, p)


def _run_renderings(case):
    """PEER2PEER + SYNC and ALL2ALL + MPI_TYPE against ALL2ALL + SYNC."""
    shape, seq, transform, wire, backend = case
    base = dict(wire_dtype=wire, fft_backend=backend)
    outs = {}
    for rid, comm, snd in (("a2a", "All2All", "Sync"),
                           ("p2p", "Peer2Peer", "Sync"),
                           ("p2p_type", "Peer2Peer", "MPI_Type"),
                           ("a2a_type", "All2All", "MPI_Type")):
        cfg = tdfft.Config(comm_method=tdfft.CommMethod.parse(comm),
                           send_method=tdfft.SendMethod.parse(snd), **base)
        plan = _plan(shape, seq, cfg, transform)
        fwd, inv = ttc._fused_fns(plan)
        x = plan.pad_input(_global(shape, transform))
        c = fwd(x)
        outs[rid] = (c, inv(c))
    return {rid: all(torch.equal(g, w) for g, w in zip(o, outs["a2a"]))
            for rid, o in outs.items() if rid != "a2a"}


def _run_sections(_):
    out = {}
    for seq in SEQS:
        for comm in ("All2All", "Peer2Peer"):
            plan = _plan((8, 8, 8), seq, tdfft.Config(
                comm_method=tdfft.CommMethod.parse(comm)))
            out[(seq, comm)] = (plan.section_descriptions, plan.variant_name,
                                plan._xpose_desc(),
                                [d for d, _ in plan.forward_stages()],
                                [d for d, _ in plan.inverse_stages()])
    return out


def _run_gather(path):
    """Timer.gather over the world: each rank's own durations in its
    column, rank 0 alone writing."""
    rank = torch.distributed.get_rank()
    t = ttimer.Timer(["a", "b", "Run complete"], P, path,
                     process_index=rank, num_processes=P)
    for it in range(2):
        t._durations = {"a": 1.5 * rank + it, "Run complete": 10.0 + rank}
        t.gather()
    return None


def _rank_main(rank, addr, cases, outdir):
    multihost.maybe_initialize(addr, P, rank, backend="gloo", timeout_s=120)
    results = {}
    for cid, (kind, case) in cases.items():
        try:
            run = {"staged": _run_staged, "tc": _run_tc, "xpose": _run_xpose,
                   "renderings": _run_renderings, "sections": _run_sections,
                   "gather": _run_gather}[kind]
            results[cid] = run(case)
        except Exception:  # noqa: BLE001 — reported by that case's test
            results[cid] = {"error": traceback.format_exc()}
    results["modules"] = sorted(m for m in sys.modules
                                if m.split(".")[0] in FORBIDDEN)
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    multihost.shutdown()


# id -> (sequence, transform, backend)
STAGED_CASES = {f"{seq}-{tr}-{be}": ((12, 20, 14), seq, tr, be)
                for seq in SEQS for tr in ("r2c", "c2c")
                for be in ("xla", "pallas")}
RENDER_CASES = {f"{seq}-{tr}-{wire}": ((12, 20, 14), seq, tr, wire, "pallas")
                for seq in SEQS for tr in ("r2c", "c2c")
                for wire in ("native", "bf16")}
XPOSE_CASES = {f"{'x'.join(map(str, sh))}-s{s}c{c}-{w}": (sh, s, c, w)
               for sh in XPOSE_SHAPES for s, c in AXIS_PAIRS
               for w in ("native", "bf16")}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("testcases_world")
    cases = {f"staged-{k}": ("staged", v) for k, v in STAGED_CASES.items()}
    cases.update({f"render-{k}": ("renderings", v)
                  for k, v in RENDER_CASES.items()})
    cases.update({f"xpose-{k}": ("xpose", v) for k, v in XPOSE_CASES.items()})
    for cid, (sh, seq, tc) in TC_CASES.items():
        cases[f"tc-f64-{cid}"] = ("tc", (sh, seq, "xla", True, tc))
        cases[f"tc-f32-{cid}"] = ("tc", (sh, seq, "pallas", False, tc))
    cases["sections"] = ("sections", None)
    cases["gather"] = ("gather", str(outdir / "gather.csv"))
    torch.multiprocessing.start_processes(
        _rank_main, args=(multihost.local_coordinator(), cases, str(outdir)),
        nprocs=P, start_method="spawn")
    out = []
    for r in range(P):
        with open(outdir / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out, outdir


def _result(world, rank, cid):
    res = world[0][rank][cid]
    if isinstance(res, dict) and "error" in res:
        pytest.fail(f"rank {rank} failed case {cid}:\n{res['error']}")
    return res


def _all_ranks(world, cid):
    return [_result(world, r, cid) for r in range(P)]


# ---------------------------------------------------------------------------
# The Timer and its CSVs
# ---------------------------------------------------------------------------


def _jax_python_writer(monkeypatch):
    """The JAX Timer with its native CSV writer switched off, so the
    Python writer (the format both share) runs."""
    from distributedfft_tpu.utils import native_planner as jnp_planner
    monkeypatch.setattr(jnp_planner, "timer_csv_append", lambda *a: None)
    monkeypatch.setattr(jnp_planner, "timer_csv_append_cols",
                        lambda *a: None)
    from distributedfft_tpu.utils.timer import Timer
    return Timer


DURATIONS = [{"a": 0.1, "Run complete": 1.0 / 3.0},
             {"a": 2.5e-7, "b": 123456.789, "Run complete": 7.0}]


@pytest.mark.parametrize("pcnt", [1, 4])
def test_timer_csv_bytes_match_jax(monkeypatch, tmp_path, pcnt):
    JTimer = _jax_python_writer(monkeypatch)
    descs = ["a", "b", "Run complete"]
    for i, (mine, theirs) in enumerate(
            ((ttimer.Timer(descs, pcnt, str(tmp_path / "p.csv")),
              JTimer(descs, pcnt, str(tmp_path / "j.csv"))),
             (ttimer.Timer(descs, pcnt, str(tmp_path / "pc.csv"),
                           num_processes=pcnt,
                           allgather_fn=lambda v: [[x * (r + 1) for x in v]
                                                   for r in range(pcnt)]),
              JTimer(descs, pcnt, str(tmp_path / "jc.csv"),
                     num_processes=pcnt,
                     allgather_fn=lambda v: np.stack(
                         [np.asarray(v) * (r + 1) for r in range(pcnt)]))))):
        for d in DURATIONS:
            mine._durations = dict(d)
            theirs._durations = dict(d)
            mine.gather()
            theirs.gather()
        assert (open(mine.filename, "rb").read()
                == open(theirs.filename, "rb").read()), i


@pytest.mark.parametrize("pcnt", [1, 4])
@pytest.mark.parametrize("opt", [0, 1])
def test_benchmark_filename_matches_jax(opt, pcnt):
    import distributedfft_tpu as jdfft
    from distributedfft_tpu.utils.timer import benchmark_filename
    for comm in ("Peer2Peer", "All2All"):
        for snd in ("Sync", "Streams", "MPI_Type", "Ring", "RingOverlap"):
            for wire in ("native", "bf16"):
                for extra in ({}, {"overlap_depth": 4},
                              {"overlap_subblocks": 2}):
                    kw = dict(comm_method=comm, send_method=snd, opt=opt,
                              wire_dtype=wire, cuda_aware=bool(opt),
                              **extra)
                    mine = ttimer.benchmark_filename(
                        "bench", "slab_default",
                        tdfft.config_from_reference(kw),
                        tdfft.GlobalSize(256, 128, 64), pcnt)
                    jkw = dict(kw, comm_method=jdfft.CommMethod(comm),
                               send_method=jdfft.SendMethod(snd))
                    theirs = benchmark_filename(
                        "bench", "slab_default", jdfft.Config(**jkw),
                        jdfft.GlobalSize(256, 128, 64), pcnt)
                    assert mine == theirs, kw


def test_jax_readers_read_a_port_csv(tmp_path):
    from distributedfft_tpu.evalkit.evaluate import _fused_ms, _run_complete
    from distributedfft_tpu.utils.timer import read_timer_csv
    plan = _plan((8, 8, 8), "ZY_Then_X",
                 _cfg(benchmark_dir=str(tmp_path)), p=1)
    r = ttc.testcase0(plan, iterations=3, warmup=1)
    path = ttimer.benchmark_filename(str(tmp_path), "slab_default",
                                     plan.config, plan.global_size, 1)
    assert os.path.basename(path) == "test_0_1_0_8_8_8_1_1.csv"
    blocks = read_timer_csv(path)
    assert blocks == ttimer.read_timer_csv(path)
    assert len(blocks) == 3 and list(blocks[0]) == plan.section_descriptions
    assert np.allclose(_run_complete(blocks), r["times_ms"])
    assert np.allclose(_fused_ms(blocks), r["fused_times_ms"])


def test_timer_gather_writes_each_ranks_column(world):
    assert all(v is None for v in _all_ranks(world, "gather"))
    blocks = ttimer.read_timer_csv(str(world[1] / "gather.csv"))
    assert len(blocks) == 2
    for it, b in enumerate(blocks):
        assert b["a"] == [1.5 * r + it for r in range(P)]
        assert b["b"] == [0.0] * P
        assert b["Run complete"] == [10.0 + r for r in range(P)]


def test_timer_fences_nothing_on_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: pytest.fail("a CPU timer fenced a card"))
    t = ttimer.Timer(["x"], 1, None)
    t.start()
    assert t.stop_store("x") >= 0.0
    with pytest.raises(ValueError, match="unknown timer section"):
        t.stop_store("y")


# ---------------------------------------------------------------------------
# The staged surface
# ---------------------------------------------------------------------------


def test_sections_and_variant_match_jax(world, devices):
    import distributedfft_tpu as jdfft
    from distributedfft_tpu.parallel.mesh import make_slab_mesh
    got = _result(world, 0, "sections")
    for seq in SEQS:
        for comm in ("All2All", "Peer2Peer"):
            jplan = jdfft.SlabFFTPlan(
                jdfft.GlobalSize(8, 8, 8), jdfft.SlabPartition(P),
                jdfft.Config(comm_method=jdfft.CommMethod(comm)),
                mesh=make_slab_mesh(P, devices), sequence=seq)
            sec, var, xd, fwd, inv = got[(seq, comm)]
            assert sec == jplan.section_descriptions
            assert var == jplan.variant_name
            assert xd == jplan._xpose_desc()
            assert fwd == [d for d, _ in jplan.forward_stages()]
            assert inv == [d for d, _ in jplan.inverse_stages()]


@pytest.mark.parametrize("cid", list(STAGED_CASES))
def test_staged_equals_exec_at_p4(world, cid):
    assert all(r == (True, True) for r in _all_ranks(world, f"staged-{cid}"))


@pytest.mark.parametrize("transform", ["r2c", "c2c"])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_staged_equals_exec_at_p1(transform, backend):
    plan = _plan((12, 20, 14), "ZY_Then_X", _cfg(backend), transform, p=1)
    assert [d for d, _ in plan.forward_stages()] == [None]
    assert _staged_equal(plan, transform) == (True, True)


# ---------------------------------------------------------------------------
# Peer2Peer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cid", list(XPOSE_CASES))
def test_peer_to_peer_transpose_bit_equals_all_to_all(world, cid):
    assert all(_all_ranks(world, f"xpose-{cid}"))


@pytest.mark.parametrize("cid", list(RENDER_CASES))
def test_renderings_bit_equal_all2all_sync(world, cid):
    for r in range(P):
        assert _result(world, r, f"render-{cid}") == {
            "p2p": True, "p2p_type": True, "a2a_type": True}, r


def test_ranks_import_no_jax(world):
    assert all(w["modules"] == [] for w in world[0])


# ---------------------------------------------------------------------------
# The testcases against JAX
# ---------------------------------------------------------------------------


def _jax_tc(devices, shape, seq, p, tc):
    import distributedfft_tpu as jdfft
    from distributedfft_tpu.parallel.mesh import make_slab_mesh
    from distributedfft_tpu.testing import testcases as jtc
    plan = jtc.make_plan("slab", jdfft.GlobalSize(*shape),
                         jdfft.SlabPartition(p),
                         jdfft.Config(double_prec=True), sequence=seq,
                         mesh=make_slab_mesh(p, devices))
    if tc == 1:
        return jtc.testcase1(plan, write_csv=False)["residual_sum"]
    fn = jtc.testcase3 if tc == 3 else jtc.testcase4
    return fn(plan, write_csv=False)["max_error"]


@pytest.mark.parametrize("cid", list(TC_CASES))
def test_testcases_at_p4_match_jax(world, devices, cid):
    shape, seq, tc = TC_CASES[cid]
    bound = JAX_BOUND[tc]
    mine = _all_ranks(world, f"tc-f64-{cid}")
    assert all(v == mine[0] for v in mine)      # reduced over the ranks
    theirs = _jax_tc(devices, shape, seq, P, tc)
    assert mine[0] < bound and theirs < bound
    assert abs(mine[0] - theirs) < bound
    f32 = _all_ranks(world, f"tc-f32-{cid}")
    assert f32[0] / _magnitude(shape, seq, tc) <= REL_TOL, f32[0]


@pytest.mark.parametrize("tc", [1, 3, 4])
@pytest.mark.parametrize("shape", SHAPES)
def test_testcases_at_p1_match_jax(devices, shape, tc, capsys):
    bound = JAX_BOUND[tc]
    mine = _port_tc(_plan(shape, "ZY_Then_X", _cfg("xla", True), p=1), tc)
    theirs = _jax_tc(devices, shape, "ZY_Then_X", 1, tc)
    assert mine < bound and theirs < bound and abs(mine - theirs) < bound
    plan = _plan(shape, "ZY_Then_X", _cfg("pallas"), p=1)
    f32 = _port_tc(plan, tc)
    assert f32 / _magnitude(shape, "ZY_Then_X", tc) <= REL_TOL, f32
    out = capsys.readouterr().out
    assert ("Result " if tc == 1 else "Result (max): ") in out


def test_tc1_analytic_truth_and_sharded_helpers():
    """The analytic truth is the float64 np.fft of the sine field, and the
    Laplacian symbol is the reference's folded wavenumbers."""
    import numpy.testing as npt
    for seq in ("ZY_Then_X", "Z_Then_YX"):
        plan = _plan((12, 20, 14), seq, _cfg(double=True), p=1)
        u = sharded.sine_input(plan).numpy()
        npt.assert_allclose(sharded.sine_spectrum_ref(plan).numpy(),
                            ttc.reference_spectrum(plan, u), atol=1e-9)
        r = ttc.testcase1(plan, write_csv=False, truth="analytic")
        assert r["residual_sum"] < JAX_BOUND[1]
    from distributedfft_tpu.solvers.poisson import _axis_freqs
    for n in (1, 2, 7, 8, 14):
        for halved in (False, True):
            npt.assert_array_equal(
                sharded.axis_freqs(n, n + 3, halved),
                _axis_freqs(n, n + 3, halved, integer_mode=True))
    with pytest.raises(ValueError):
        ttc.testcase1(plan, write_csv=False, truth="bogus")


def test_random_inputs_match_jax(monkeypatch):
    """The chunked draws equal the JAX package's one-shot draws."""
    import distributedfft_tpu as jdfft
    from distributedfft_tpu.testing import testcases as jtc
    monkeypatch.setattr(ttc, "_CHUNK", 1000)
    for double in (False, True):
        plan = _plan((12, 20, 14), "ZY_Then_X", _cfg(double=double), p=1)
        jplan = jtc.make_plan("slab", jdfft.GlobalSize(12, 20, 14),
                              jdfft.SlabPartition(1),
                              jdfft.Config(double_prec=double))
        for seed in (0, 3):
            mine = ttc.random_real_input(plan, seed)
            theirs = jtc.random_real_input(jplan, seed)
            assert mine.dtype == theirs.dtype
            assert np.array_equal(mine, theirs)
            rng = np.random.default_rng(seed)
            want = (rng.random(plan.output_shape)
                    + 1j * rng.random(plan.output_shape)).astype(
                        np.complex128 if double else np.complex64)
            assert np.array_equal(ttc.random_spectral_input(plan, seed)
                                  .numpy(), want)


def test_other_plan_kinds_name_their_items():
    """The batched-2D plan (item 6), which raised until it was ported, and
    the pencil plan (item 5) are made; the batched plan reads the size's
    slots as (batch, nx, ny) and splits x, as the JAX package's does."""
    plan = ttc.make_plan("batched2d", tdfft.GlobalSize(8, 6, 4),
                         tdfft.SlabPartition(1), tdfft.Config(), device="cpu")
    assert isinstance(plan, tdfft.Batched2DFFTPlan) and plan.fft3d
    assert (plan.batch, plan.nx, plan.ny, plan.shard) == (8, 6, 4, "x")
    assert plan.global_size.shape == (8, 6, 4)
    plan = ttc.make_plan("pencil", tdfft.GlobalSize(8, 8, 8),
                         tdfft.PencilPartition(1, 1), tdfft.Config(),
                         device="cpu")
    assert isinstance(plan, tdfft.PencilFFTPlan) and plan.fft3d


def test_config_parsers_match_jax():
    from distributedfft_tpu import params as jpm
    from distributedfft_tpu_torch import params as tpm
    for s in ("Peer2Peer", "p2p", "PEER", "All2All", "a2a", "all-to-all"):
        assert tpm.CommMethod.parse(s).value == jpm.CommMethod.parse(s).value
    for s in ("Sync", "Streams", "MPI_Type", "mpit", "type", "Ring",
              "RingOverlap", "overlap"):
        assert tpm.SendMethod.parse(s).value == jpm.SendMethod.parse(s).value
    for s in ("ZY_Then_X", "default", "2d_1d", "Z_Then_YX", "1d-2d",
              "Y_Then_ZX", "1d_2d_y"):
        assert tpm.SlabSequence.parse(s).value == \
            jpm.SlabSequence.parse(s).value
    assert tpm.parse_comm_method(" Auto ") == jpm.parse_comm_method("auto")
    for s in ("native", "BF16", "auto"):
        assert tpm.parse_wire_dtype(s) == jpm.parse_wire_dtype(s)
    for bad in ((tpm.CommMethod.parse, "x"), (tpm.SendMethod.parse, "x"),
                (tpm.SlabSequence.parse, "x"), (tpm.parse_wire_dtype, "x")):
        with pytest.raises(ValueError):
            bad[0](bad[1])
