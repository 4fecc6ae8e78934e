"""The port's pencil executable, its testcases and the reference
executable's 2D and 3D geometries against the JAX package's, on the CPU.

One 4-rank gloo world (a 2 x 2 grid) is spawned for the whole file (a
module fixture); inside it each rank calls ``main`` with
``--emulate-devices 4``, finds the world joined and runs the body itself,
and calls the testcases as library functions. The JAX side runs in this
process on the conftest's 8 virtual CPU devices (the 2 x 2 mesh on the
first four). The world also runs every pencil path of ``chip_smoke.py``
at 32^3 with the wrappers' checks and ``_launch`` patched, so that each
wrapper takes its CUDA route on CPU tensors and each launch is only
counted: the launches and C entry points each rank makes per direction
are held against the script's expectations before the card runs them.

Bounds: the JAX package's own (``tests/test_testcases.py``) in double
precision: testcase 1 residual < 1e-6, testcase 3 max < 1e-8, testcase 4
max < 1e-9, the port and JAX alike and within that bound of each other.
"""

import contextlib
import importlib.util
import io
import os
import pathlib
import pickle
import subprocess
import sys
import traceback

import numpy as np
import pytest
import torch

import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch.cli import pencil as tpencil
from distributedfft_tpu_torch.cli import reference as tref
from distributedfft_tpu_torch.ops import hopper_fft as hf
from distributedfft_tpu_torch.parallel import multihost
from distributedfft_tpu_torch.testing import sharded
from distributedfft_tpu_torch.testing import testcases as ttc
from distributedfft_tpu_torch.utils import timer as ttimer

P = 4
GRID = ["-p1", "2", "-p2", "2"]
ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPES = {"16": (16, 16, 16), "12x20x14": (12, 20, 14)}
JAX_BOUND = {1: 1e-6, 3: 1e-8, 4: 1e-9}
FORBIDDEN = ("jax", "jaxlib", "distributedfft_tpu")
ITERS = ["-i", "2", "-w", "1"]
# Executable runs: id -> argv (double precision, 2 x 2).
RUNS = {}
for _sid, _sh in SHAPES.items():
    _size = ["-nx", str(_sh[0]), "-ny", str(_sh[1]), "-nz", str(_sh[2])]
    for _f in (1, 2, 3):
        RUNS[f"{_sid}-t1-f{_f}"] = _size + ["-t", "1", "-f", str(_f), "-d"]
        RUNS[f"{_sid}-t3-f{_f}"] = _size + ["-t", "3", "-f", str(_f), "-d"]
    RUNS[f"{_sid}-t4"] = _size + ["-t", "4", "-d"] + ITERS
_S16 = ["-nx", "16", "-ny", "16", "-nz", "16"]
for _t in (0, 2):
    for _f in (1, 3):
        RUNS[f"16-t{_t}-f{_f}"] = _S16 + ["-t", str(_t), "-f", str(_f)] + ITERS
RUNS["16-t1-analytic"] = _S16 + ["-t", "1", "--tc1-truth", "analytic", "-d"]
# Renderings through the executable (testcase 3 over N, float32).
RENDER = {
    "a2a-opt1": ["-comm1", "All2All", "-comm2", "All2All", "-o", "1"],
    "a2a-p2p": ["-comm1", "All2All", "-comm2", "Peer2Peer"],
    "streams": ["-comm1", "All2All", "-snd1", "Streams",
                "--streams-chunks", "3", "-snd2", "Streams"],
    "ring-wire16": ["-snd1", "Ring", "-snd2", "RingOverlap", "-wire",
                    "bf16"],
    "a2a-pipelined": ["-comm1", "All2All", "--overlap-subblocks", "2"],
}
for _r, _flags in RENDER.items():
    RUNS[f"render-{_r}"] = _S16 + ["-t", "3"] + _flags
# The reference executable's geometries over the world.
REFS = {f"t{t}-o{o}": _S16 + ["-t", str(t), "-o", str(o), "-i", "2"]
        for t in (1, 2, 3) for o in (0, 1)}
# Flags of a later ROADMAP item: (flags, the item named).
# ``--profile-dir`` runs since item 12's first part
# (tests/test_torch_profile.py).
LATER = [(["--profile-stages"], "item 12")]
# Flags of ROADMAP items 9 and 11 and item 12's host core, which raised
# until they were ported; each now runs.
FORMER = [["--guards", "check"], ["--selftest"], ["--obs"],
          ["--autotune-comm"], ["--wisdom", "w.json"], ["-comm1", "auto"],
          ["-comm2", "auto"], ["--fft-backend", "auto"]]
COMMS = [("All2All", None), ("Peer2Peer", None), ("All2All", "Peer2Peer"),
         ("Peer2Peer", "All2All")]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _smoke()
ENTRY_PATHS = {f"512-{k}": v for k, v in SMOKE.PENCIL_PATHS.items()}
ENTRY_PATHS.update({f"1024-{k}": (fields, 3, *SMOKE.PENCIL_DEPTHS[3])
                    for k, (fields, _) in SMOKE.PENCIL_FULL.items()})


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _printed(text, key):
    line = next(ln for ln in text.splitlines() if ln.startswith(key))
    return float(line[len(key):].split()[0])


def _csvs(bdir):
    out = {}
    for p in sorted(pathlib.Path(bdir).rglob("*.csv")):
        out[str(p.relative_to(bdir))] = [list(b) for b in
                                         ttimer.read_timer_csv(str(p))]
    return out


# ---------------------------------------------------------------------------
# The ranks (no JAX here)
# ---------------------------------------------------------------------------


def _plan(shape=(16, 16, 16), **kw):
    return tdfft.PencilFFTPlan(tdfft.GlobalSize(*shape),
                               tdfft.PencilPartition(2, 2),
                               tdfft.Config(double_prec=True, **kw),
                               device="cpu")


@contextlib.contextmanager
def _counting_launches():
    """Every wrapper takes its CUDA route and each launch is only counted
    (in ``hf.LAUNCHES`` and, per C entry point, in the yielded dict)."""
    names = ("_check_rows", "_check_cols", "_check_wire", "_check")
    saved = {n: getattr(hf, n) for n in names + ("_launch",)}
    seen = {}
    for n in names:
        setattr(hf, n, lambda *a, **k: False)
    hf._launch = lambda kernel, fn, *args: (
        hf.LAUNCHES.__setitem__(kernel, hf.LAUNCHES[kernel] + 1),
        seen.__setitem__(fn, seen.get(fn, 0) + 1))
    try:
        yield seen
    finally:
        for n, f in saved.items():
            setattr(hf, n, f)


def _run_entries(pid):
    fields, d = ENTRY_PATHS[pid][:2]
    plan = tdfft.PencilFFTPlan(tdfft.GlobalSize(32, 32, 32),
                               tdfft.PencilPartition(2, 2),
                               SMOKE.pencil_config(tdfft, fields),
                               device="cpu")
    x = plan.pad_input(torch.zeros(32, 32, 32))
    out = []
    for run in (lambda t: plan.exec_r2c(t, d), lambda t: plan.exec_c2r(t, d)):
        hf.reset_launches()
        with _counting_launches() as seen:
            x = run(x)
        out.append((dict(hf.LAUNCHES), dict(seen)))
    return out


def _run_exe(argv, outdir, cid, main=tpencil.main, grid=GRID):
    bdir = os.path.join(outdir, cid)
    return _run(main, argv + grid + ["-b", bdir, "--emulate-devices", str(P)])


def _run_library():
    """The pencil cases of ``tests/test_testcases.py`` through the port's
    testcases as library calls, on 2 x 2 in double precision."""
    plan = _plan()
    out = {"tc1": [ttc.testcase1(plan, write_csv=False, dims=d)
                   ["residual_sum"] for d in (1, 2, 3)],
           "tc1_analytic": [ttc.testcase1(plan, write_csv=False, dims=d,
                                          truth="analytic")["residual_sum"]
                            for d in (1, 2, 3)],
           "tc2": ttc.testcase2(plan, iterations=1, write_csv=False)
           ["mean_ms"],
           "tc3_dims2": ttc.testcase3(plan, write_csv=False, dims=2)
           ["max_error"],
           "tc4": ttc.testcase4(plan, write_csv=False)["max_error"]}
    # The analytic spectrum against the dense transform of the sine field.
    u = plan.crop_real(sharded.sine_input(plan))
    out["sine_vs_dense"] = [
        float(np.abs(plan.crop_spectral(sharded.sine_spectrum_ref(plan, d), d)
                     - ttc.reference_spectrum(plan, u, d)).max())
        for d in (1, 2, 3)]
    # Residuals of random padded blocks against the host's.
    rng = np.random.default_rng(5)
    y = rng.random(plan.input_padded_shape)
    ref = rng.random(plan.input_padded_shape)
    out["residuals"] = sharded.residuals(plan, plan.pad_input(y),
                                         plan.pad_input(ref), "real",
                                         ref_scale=2.5)
    d = np.abs(y - 2.5 * ref)[:16, :16, :16]
    out["residuals_host"] = (float(d.sum()), float(d.max()))
    return out


def _run_local_blocks():
    """``plan_local_input`` and ``plan_local_spectral`` at every depth: this
    rank's random block (multi-host testcases 0 and 2)."""
    plan = _plan((12, 20, 14))
    return {"input": (plan.local_input_shape,
                      multihost.plan_local_input(plan, 3).numpy()),
            "spectral": {d: (plan.local_output_shape_for(d),
                             multihost.plan_local_spectral(plan, 3, d).numpy())
                         for d in (1, 2, 3)}}


def _run_staged():
    """The staged surface bit for bit the plan's exec_* at every depth, for
    the all-to-all, Peer2Peer, STREAMS under ALL2ALL and the ring."""
    out = {}
    x = np.random.default_rng(3).random((12, 20, 14))
    for rid, kw in (("a2a", dict(comm_method=tdfft.CommMethod.ALL2ALL)),
                    ("p2p", {}),
                    ("streams", dict(comm_method=tdfft.CommMethod.ALL2ALL,
                                     send_method=tdfft.SendMethod.STREAMS)),
                    ("ring", dict(send_method=tdfft.SendMethod.RING))):
        plan = _plan((12, 20, 14), **kw)
        xl = plan.pad_input(x)
        for d in (1, 2, 3):
            y = xl
            for _, fn in plan.forward_stages(d):
                y = fn(y)
            c = plan.exec_r2c(xl, d)
            z = c
            for _, fn in plan.inverse_stages(d):
                z = fn(z)
            out[rid, d] = (torch.equal(y, c), torch.equal(z, plan.exec_c2r(c, d)))
    return out


def _run_sections():
    out = {}
    for c1, c2 in COMMS:
        plan = tdfft.PencilFFTPlan(
            tdfft.GlobalSize(8, 8, 8), tdfft.PencilPartition(2, 2),
            tdfft.Config(comm_method=tdfft.CommMethod.parse(c1),
                         comm_method2=(tdfft.CommMethod.parse(c2) if c2
                                       else None)), device="cpu")
        out[c1, c2] = (plan.section_descriptions, plan.variant_name,
                       {d: ([s for s, _ in plan.forward_stages(d)],
                            [s for s, _ in plan.inverse_stages(d)])
                        for d in (1, 2, 3)})
    return out


def _rank_main(rank, addr, outdir):
    multihost.maybe_initialize(addr, P, rank, backend="gloo", timeout_s=120)
    jobs = {f"entries-{pid}": lambda p=pid: _run_entries(p)
            for pid in ENTRY_PATHS}
    jobs.update({f"run-{cid}": lambda c=cid: _run_exe(RUNS[c], outdir, c)
                 for cid in RUNS})
    jobs.update({f"ref-{cid}": lambda c=cid: _run_exe(
        REFS[c], outdir, "ref", tref.main, []) for cid in REFS})
    jobs.update(library=_run_library, staged=_run_staged,
                sections=_run_sections, local_blocks=_run_local_blocks)
    res = {}
    for cid, fn in jobs.items():
        try:
            res[cid] = fn()
        except Exception:  # noqa: BLE001 — reported by that case's test
            res[cid] = {"error": traceback.format_exc()}
    res["modules"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in FORBIDDEN)
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    multihost.shutdown()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("pencil_cli")
    torch.multiprocessing.start_processes(
        _rank_main, args=(multihost.local_coordinator(), str(outdir)),
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


def _jax_pencil(argv, bdir):
    from distributedfft_tpu.cli.pencil import main
    rc, text = _run(main, argv + GRID + ["-b", str(bdir),
                                         "--emulate-devices", "8"])
    assert rc == 0, text
    return text, _csvs(bdir)


# ---------------------------------------------------------------------------
# The flag surface
# ---------------------------------------------------------------------------


def _surface(ap):
    return {tuple(a.option_strings): (a.dest, a.default, a.choices,
                                      type(a).__name__, a.required)
            for a in ap._actions if a.option_strings != ["-h", "--help"]}


def test_flag_surface_matches_jax():
    from distributedfft_tpu.cli.pencil import build_parser
    assert _surface(tpencil.build_parser()) == _surface(build_parser())


@pytest.mark.parametrize("flags,item", LATER,
                         ids=["".join(f) for f, _ in LATER])
def test_later_item_flags_raise_naming_their_item(flags, item):
    with pytest.raises(NotImplementedError, match=item):
        tpencil.main(_S16 + GRID + flags + ["--emulate-devices", "1"])


@pytest.mark.parametrize("flags", FORMER, ids=["".join(f) for f in FORMER])
def test_former_later_item_flags_run(tmp_path, monkeypatch, flags):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DFFT_WISDOM_K", "2")
    rc, text = _run(tpencil.main, _S16 + ["-t", "3", "-p1", "1", "-p2", "1",
                                          "-b", str(tmp_path)] + flags
                    + ["--emulate-devices", "1"])
    assert rc == 0 and _printed(text, "Result (max): ") < 1e-2
    if "--selftest" in flags:
        assert "selftest: PASS" in text


def test_one_rank_pencil_writes_jax_csv(devices, tmp_path):
    """-p1 1 -p2 1 on one process: the single-rank path, the JAX
    executable's CSV path and sections."""
    argv = _S16 + ["-t", "3", "-p1", "1", "-p2", "1", "-d"]
    rc, text = _run(tpencil.main, argv + ["-b", str(tmp_path / "port"),
                                          "--emulate-devices", "1"])
    assert rc == 0 and _printed(text, "Result (max): ") < 1e-8
    from distributedfft_tpu.cli.pencil import main
    jrc, _ = _run(main, argv + ["-b", str(tmp_path / "jax"),
                                "--emulate-devices", "8"])
    assert jrc == 0
    mine = _csvs(tmp_path / "port")
    assert len(mine) == 1 and mine == _csvs(tmp_path / "jax")


# ---------------------------------------------------------------------------
# The executables against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cid", [c for c in RUNS if not c.startswith("render")])
def test_pencil_testcases_through_the_executable(world, devices, tmp_path,
                                                 cid):
    """Testcases 0-4 at 16^3 and 12 x 20 x 14 with ``-f 1|2|3`` on 2 x 2:
    rank 0 prints, the result within the JAX package's bound and the JAX
    executable's, and the CSV at the JAX executable's path with its
    sections."""
    argv = RUNS[cid]
    texts = [_result(world, r, f"run-{cid}") for r in range(P)]
    assert all(rc == 0 for rc, _ in texts)
    assert all(text == "" for _, text in texts[1:])
    text = texts[0][1]
    jtext, theirs = _jax_pencil(argv, tmp_path)
    mine = _csvs(world[1] / cid)
    assert mine == theirs and len(mine) == 1
    tc = int(argv[argv.index("-t") + 1])
    if tc in (1, 3, 4):
        key = "Result " if tc == 1 else "Result (max): "
        mine_v, theirs_v = _printed(text, key), _printed(jtext, key)
        bound = JAX_BOUND[tc]
        assert mine_v < bound and theirs_v < bound
        assert abs(mine_v - theirs_v) < bound
    else:
        assert _printed(text, "Run complete: ") > 0


@pytest.mark.parametrize("rid", list(RENDER))
def test_renderings_run_through_the_executable(world, rid):
    """``-comm1/-snd1/-comm2/-snd2`` reach the plan: testcase 3 over N
    within the float32 bound (the bf16 wire's on a wire), the CSV named as
    the JAX package names it."""
    import distributedfft_tpu as jdfft
    from distributedfft_tpu.cli.common import (overlap_config_kwargs,
                                               wire_config_kwargs)
    from distributedfft_tpu.cli.pencil import build_parser
    from distributedfft_tpu.utils.timer import benchmark_filename
    rc, text = _result(world, 0, f"run-render-{rid}")
    assert rc == 0
    bound = 2e-2 if "bf16" in RENDER[rid] else 5e-4
    assert _printed(text, "Result (max): ") / 16 ** 3 <= bound
    args = build_parser().parse_args(RUNS[f"render-{rid}"] + GRID)
    cfg = jdfft.Config(
        comm_method=jdfft.CommMethod.parse(args.comm_method1),
        send_method=jdfft.SendMethod.parse(args.send_method1),
        comm_method2=(jdfft.CommMethod.parse(args.comm_method2)
                      if args.comm_method2 else None),
        send_method2=(jdfft.SendMethod.parse(args.send_method2)
                      if args.send_method2 else None),
        benchmark_dir="b", opt=args.opt, streams_chunks=args.streams_chunks,
        **overlap_config_kwargs(args), **wire_config_kwargs(args))
    want = os.path.relpath(benchmark_filename(
        "b", "pencil", cfg, jdfft.GlobalSize(16, 16, 16), 4,
        pencil_grid=(2, 2)), "b")
    assert list(_csvs(world[1] / f"render-{rid}")) == [want]


@pytest.mark.parametrize("cid", list(REFS))
def test_reference_geometries_over_the_world(world, devices, cid):
    """``dfft-torch-reference -t 1|2|3``: the bandwidth line of each
    geometry over four ranks, the collective the exchange posts, and the
    JAX probe's geometry and bytes."""
    from distributedfft_tpu.testing import microbench as jmb
    argv = REFS[cid]
    t, o = int(argv[argv.index("-t") + 1]), argv[argv.index("-o") + 1]
    geometry = {1: "1d", 2: "2d", 3: "3d"}[t]
    rc, text = _result(world, 0, f"ref-{cid}")
    assert rc == 0
    kind = "Peer2Peer" if o == "0" else "All2All"
    calls = "['isend', 'irecv']" if o == "0" else "['all_to_all_single']"
    assert text.startswith("Bandwidth: ") and \
        f"[{kind}, {geometry}, 4 devices" in text and \
        f"collectives={calls}" in text, text
    assert _printed(text, "Bandwidth: ") > 0
    r = jmb.transpose_bandwidth((16, 16, 16), 4, explicit=o == "1",
                                iterations=1, warmup=0, geometry=geometry)
    assert r["geometry"] == geometry
    assert f"{r['bytes'] / 1e6:.1f} MB moved" in text


def test_transpose_bandwidth_validation():
    """The JAX probe's refusals (``tests/test_microbench.py``), on one
    process."""
    from distributedfft_tpu_torch.testing import microbench as mb
    with pytest.raises(ValueError, match="even device count > 2"):
        mb.transpose_bandwidth((16, 16, 16), 2, geometry="3d", device="cpu")
    with pytest.raises(ValueError, match="3d geometry"):
        mb.transpose_bandwidth((15, 16, 16), 4, geometry="3d", device="cpu")
    with pytest.raises(ValueError, match="geometry must be"):
        mb.transpose_bandwidth((16, 16, 16), 1, geometry="4d", device="cpu")
    r = mb.transpose_bandwidth((16, 16, 16), 1, geometry="2d", iterations=1,
                               warmup=0, device="cpu")
    assert r["geometry"] == "2d" and r["collective_ops"] == []


# ---------------------------------------------------------------------------
# The testcases as library calls, the staged surface, the Timer
# ---------------------------------------------------------------------------


def test_pencil_testcases_match_jax(world, devices):
    """``test_tc1_pencil_partial``, ``test_tc1_analytic_truth``,
    ``test_tc2_inverse_perf``, ``test_tc3_pencil_partial_dims``,
    ``test_tc4_pencil``, ``test_sine_spectrum_ref_matches_npfft`` and
    ``test_residuals_match_dense_host`` on 2 x 2: every rank reduces the
    same value, within the JAX bound and of the JAX testcases."""
    import distributedfft_tpu as jdfft
    from distributedfft_tpu.testing import testcases as jtc
    mine = [_result(world, r, "library") for r in range(P)]
    for k in ("tc1", "tc1_analytic", "tc3_dims2", "tc4", "residuals"):
        assert all(m[k] == mine[0][k] for m in mine), k
    m = mine[0]
    jplan = jtc.make_plan("pencil", jdfft.GlobalSize(16, 16, 16),
                          jdfft.PencilPartition(2, 2),
                          jdfft.Config(double_prec=True))
    for d in (1, 2, 3):
        theirs = jtc.testcase1(jplan, write_csv=False, dims=d)["residual_sum"]
        assert m["tc1"][d - 1] < JAX_BOUND[1] and theirs < JAX_BOUND[1]
        assert abs(m["tc1"][d - 1] - theirs) < JAX_BOUND[1]
        assert m["tc1_analytic"][d - 1] < JAX_BOUND[1]
        assert m["sine_vs_dense"][d - 1] < 1e-9
    assert m["tc2"] > 0
    theirs = jtc.testcase3(jplan, write_csv=False, dims=2)["max_error"]
    assert m["tc3_dims2"] < JAX_BOUND[3] and theirs < JAX_BOUND[3]
    theirs = jtc.testcase4(jplan, write_csv=False)["max_error"]
    assert m["tc4"] < JAX_BOUND[4] and theirs < JAX_BOUND[4]
    np.testing.assert_allclose(m["residuals"], m["residuals_host"],
                               rtol=1e-12)


def test_local_blocks_per_rank(world):
    """Each rank draws its own block from ``default_rng(seed + rank)``, in
    the plan's precision, shaped as its pencil at each depth."""
    for r in range(P):
        res = _result(world, r, "local_blocks")
        shape, x = res["input"]
        want = np.random.default_rng(3 + r).random(shape)
        assert x.shape == shape and np.array_equal(x, want)
        for d, (shape, c) in res["spectral"].items():
            rng = np.random.default_rng(3 + r)
            want = rng.random(shape) + 1j * rng.random(shape)
            assert c.shape == shape and c.dtype == np.complex128
            assert np.array_equal(c, want), d


def test_staged_equals_exec(world):
    for r in range(P):
        res = _result(world, r, "staged")
        assert all(v == (True, True) for v in res.values()), (r, res)


def test_sections_and_stages_match_jax(world, devices):
    import distributedfft_tpu as jdfft
    got = _result(world, 0, "sections")
    for c1, c2 in COMMS:
        jplan = jdfft.PencilFFTPlan(
            jdfft.GlobalSize(8, 8, 8), jdfft.PencilPartition(2, 2),
            jdfft.Config(comm_method=jdfft.CommMethod.parse(c1),
                         comm_method2=(jdfft.CommMethod.parse(c2) if c2
                                       else None)))
        sec, var, stages = got[c1, c2]
        assert sec == jplan.section_descriptions and len(sec) == 25
        assert var == jplan.variant_name == "pencil"
        for d in (1, 2, 3):
            assert stages[d] == ([s for s, _ in jplan.forward_stages(d)],
                                 [s for s, _ in jplan.inverse_stages(d)]), d


def test_timer_csv_bytes_match_jax(monkeypatch, tmp_path):
    """The pencil's 25 sections through both Timers' Python writers, four
    rank columns: the same bytes."""
    from distributedfft_tpu.utils import native_planner as jnp_planner
    monkeypatch.setattr(jnp_planner, "timer_csv_append", lambda *a: None)
    monkeypatch.setattr(jnp_planner, "timer_csv_append_cols",
                        lambda *a: None)
    from distributedfft_tpu.utils.timer import Timer
    descs = tdfft.PencilFFTPlan(tdfft.GlobalSize(8, 8, 8),
                                tdfft.PencilPartition(1, 1),
                                device="cpu").section_descriptions
    mine = ttimer.Timer(descs, 4, str(tmp_path / "p.csv"), num_processes=4,
                        allgather_fn=lambda v: [[x * (r + 1) for x in v]
                                                for r in range(4)])
    theirs = Timer(descs, 4, str(tmp_path / "j.csv"), num_processes=4,
                   allgather_fn=lambda v: np.stack(
                       [np.asarray(v) * (r + 1) for r in range(4)]))
    for i in range(2):
        d = {"1D FFT Z-Direction": 0.25 + i,
             "First Transpose (Finished Receive)": 1.0 / 3.0,
             "Second Transpose (Finished All2All)": 7.5e-7,
             "Run complete": 12.0 + i, "Run complete (fused)": 20.0}
        mine._durations = dict(d)
        theirs._durations = dict(d)
        mine.gather()
        theirs.gather()
    assert open(mine.filename, "rb").read() == \
        open(theirs.filename, "rb").read()


@pytest.mark.parametrize("opt", [0, 1])
def test_pencil_benchmark_filename_matches_jax(opt):
    import distributedfft_tpu as jdfft
    from distributedfft_tpu.utils.timer import benchmark_filename
    for c1, c2 in COMMS:
        for s1, s2 in (("Sync", None), ("Streams", "Sync"),
                       ("Ring", "RingOverlap"), ("MPI_Type", None)):
            for wire in ("native", "bf16"):
                kw = dict(comm_method=c1, comm_method2=c2, send_method=s1,
                          send_method2=s2, opt=opt, wire_dtype=wire)
                mine = ttimer.benchmark_filename(
                    "bench", "pencil", tdfft.config_from_reference(kw),
                    tdfft.GlobalSize(64, 32, 16), 8, pencil_grid=(2, 4))
                jkw = dict(kw, comm_method=jdfft.CommMethod.parse(c1),
                           comm_method2=(jdfft.CommMethod.parse(c2) if c2
                                         else None),
                           send_method=jdfft.SendMethod.parse(s1),
                           send_method2=(jdfft.SendMethod.parse(s2) if s2
                                         else None))
                theirs = benchmark_filename(
                    "bench", "pencil", jdfft.Config(**jkw),
                    jdfft.GlobalSize(64, 32, 16), 8, pencil_grid=(2, 4))
                assert mine == theirs, kw


# ---------------------------------------------------------------------------
# What chip_smoke.py expects each rank to launch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pid", list(ENTRY_PATHS))
def test_rank_launches_what_chip_smoke_expects(world, pid):
    """Every rank of the 2 x 2 pencil launches each kernel, through each C
    entry point, as many times per direction as ``chip_smoke.py``'s
    ``PENCIL_PATHS`` and ``PENCIL_FULL`` require on the card."""
    _, d, want_f, want_i, ent_f, ent_i = ENTRY_PATHS[pid]
    for rank in range(P):
        (fwd, got_f), (inv, got_i) = _result(world, rank, f"entries-{pid}")
        assert fwd == SMOKE.expect(hf, **want_f), (rank, fwd)
        assert inv == SMOKE.expect(hf, **want_i), (rank, inv)
        assert (got_f, got_i) == (ent_f, ent_i), (rank, got_f, got_i)


@pytest.mark.parametrize("dims", [1, 2, 3])
def test_single_rank_launches_what_chip_smoke_expects(dims):
    """The 1 x 1 pencil runs per axis (kernels 1, 2 and 3), never the fused
    3D kernels of the single-card slab plan."""
    plan = tdfft.PencilFFTPlan(tdfft.GlobalSize(32, 32, 32),
                               tdfft.PencilPartition(1, 1),
                               tdfft.Config(fft_backend="pallas"),
                               device="cpu")
    want_f, want_i, ent_f, ent_i = SMOKE.PENCIL_DEPTHS[dims]
    x = torch.zeros(32, 32, 32)
    for run, want, ent in ((lambda t: plan.exec_r2c(t, dims), want_f, ent_f),
                           (lambda t: plan.exec_c2r(t, dims), want_i, ent_i)):
        hf.reset_launches()
        with _counting_launches() as seen:
            x = run(x)
        assert dict(hf.LAUNCHES) == SMOKE.expect(hf, **want)
        assert seen == ent


def test_ranks_import_no_jax(world):
    assert all(w["modules"] == [] for w in world[0])


def test_module_entry_point_spawns_its_ranks(tmp_path):
    """The executable as a user runs it on the CPU: four spawned gloo
    ranks on 2 x 2, double precision, the Laplacian testcase."""
    import distributedfft_tpu as jdfft
    from distributedfft_tpu.utils.timer import benchmark_filename
    cmd = [sys.executable, "-m", "distributedfft_tpu_torch.cli.pencil",
           *_S16, *GRID, "-t", "4", "--emulate-devices", "4", "-d", "-b",
           str(tmp_path)]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert _printed(proc.stdout, "Result (max): ") < 1e-9
    want = benchmark_filename(str(tmp_path), "pencil", jdfft.Config(
        comm_method=jdfft.CommMethod.PEER2PEER),
        jdfft.GlobalSize(16, 16, 16), 4, pencil_grid=(2, 2))
    assert [str(p) for p in tmp_path.rglob("*.csv")] == [want]
