"""The port's ``slab`` and ``reference`` executables against the JAX
package's, on the CPU.

One 4-rank gloo world is spawned for the whole file (a module fixture);
inside it each rank calls ``main`` with ``--emulate-devices 4``, finds the
world joined and runs the body itself. The JAX executables run in this
process on the conftest's 8 virtual CPU devices (``--emulate-devices 8``
with ``-p`` set: the CSV path depends on ``-p``, not on the device count).
One test runs the port's executable as a user would, in a subprocess that
spawns its own four ranks.
"""

import contextlib
import io
import os
import pathlib
import pickle
import subprocess
import sys
import traceback

import pytest
import torch

from distributedfft_tpu_torch.cli import reference as tref
from distributedfft_tpu_torch.cli import slab as tslab
from distributedfft_tpu_torch.parallel import multihost
from distributedfft_tpu_torch.utils.timer import read_timer_csv

P = 4
ROOT = pathlib.Path(__file__).resolve().parent.parent
SIZE = ["-nx", "16", "-ny", "16", "-nz", "16"]
ITERS = {0: ["-i", "2", "-w", "1"], 1: [], 2: ["-i", "2", "-w", "1"],
         3: ["-i", "2", "-w", "1"], 4: ["-i", "2", "-w", "1"]}
# Renderings the port already has, run through the executable at P = 4:
# id -> (flags, testcase-3 max error bound over N).
RENDERINGS = {
    "ring": (["-snd", "Ring"], 5e-4),
    "ring-overlap-wire16": (["-snd", "RingOverlap", "--overlap-depth", "3",
                             "--overlap-subblocks", "2", "-wire", "bf16"],
                            2e-2),
    "z-then-yx": (["-s", "Z_Then_YX"], 5e-4),
    "y-then-zx": (["-s", "Y_Then_ZX", "-snd", "MPI_Type"], 5e-4),
    "p2p-subblocks-inert": (["--overlap-subblocks", "2"], 5e-4),
    "opt1": (["-o", "1"], 5e-4),
    "streams-p2p": (["-snd", "Streams"], 5e-4),
    "streams-a2a": (["-comm", "All2All", "-snd", "Streams",
                     "--streams-chunks", "3"], 5e-4),
    "a2a-pipelined": (["-comm", "All2All", "--overlap-subblocks", "2"], 5e-4),
    "a2a-pipelined-opt1-d3": (["-comm", "All2All", "-o", "1",
                               "--overlap-depth", "3",
                               "--overlap-subblocks", "3", "-wire", "bf16"],
                              2e-2),
    "f64-pallas": (["-d", "--fft-backend", "pallas"], 1e-10),
    "matmul": (["--fft-backend", "matmul"], 5e-4),
}
# Flags of a later ROADMAP item: (executable, flags, the item named).
# ``--profile-dir`` runs since item 12's first part
# (tests/test_torch_profile.py).
LATER = [
    ("slab", ["--profile-stages", "-t", "1"], "item 12"),
    ("slab", ["--profile-stages"], "item 12"),
    ("reference", ["--profile-stages"], "item 12"),
]
# Flags of ROADMAP item 11 (autotune and wisdom), which raised until it was
# ported: (executable, flags, a line the run prints). Each now runs.
ITEM11 = [
    ("slab", ["--autotune-comm"], "best: "),
    ("slab", ["--wisdom", "w.json"], "Run complete: "),
    ("slab", ["-comm", "auto"], "Run complete: "),
    ("slab", ["--fft-backend", "auto"], "Run complete: "),
    ("slab", ["-wire", "auto"], "Run complete: "),
    ("reference", ["--autotune"], "best: "),
    ("reference", ["-t", "4"], None),
    ("reference", ["--wisdom", "w.json"], "Run complete: "),
]
# Flags of ROADMAP items 2, 3, 7, 8, 9 and 12's host core, which raised
# until those items were ported: (executable, flags). Each now runs, on one
# rank.
FORMER = [
    ("slab", ["-o", "1"]),
    ("slab", ["-snd", "Streams"]),
    ("slab", ["-comm", "All2All", "--overlap-subblocks", "2"]),
    ("slab", ["-comm", "All2All", "-snd", "MPI_Type",
              "--overlap-subblocks", "3"]),
    ("slab", ["-d", "--fft-backend", "pallas"]),
    ("slab", ["--fft-backend", "matmul"]),
    ("slab", ["--fft-backend", "bluestein"]),
    ("reference", ["-d", "--fft-backend", "pallas"]),
    ("slab", ["--guards", "check"]),
    ("slab", ["--guards", "enforce"]),
    ("slab", ["--selftest"]),
    ("slab", ["--obs"]),
]


def _run(main, argv):
    """(exit code, printed text) of ``main(argv)`` in this process."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _printed(text, key):
    line = next(ln for ln in text.splitlines() if ln.startswith(key))
    return float(line[len(key):].split()[0])


def _csvs(bdir):
    """{path under bdir: [sections of each block]} of every CSV written."""
    out = {}
    for p in sorted(pathlib.Path(bdir).rglob("*.csv")):
        out[str(p.relative_to(bdir))] = [list(b) for b in
                                         read_timer_csv(str(p))]
    return out


# ---------------------------------------------------------------------------
# The ranks (no JAX here)
# ---------------------------------------------------------------------------


def _rank_main(rank, addr, outdir):
    multihost.maybe_initialize(addr, P, rank, backend="gloo", timeout_s=120)
    res = {}
    cases = {f"slab-t{t}": (tslab.main, SIZE + ["-t", str(t)] + ITERS[t]
                            + ["-b", os.path.join(outdir, f"t{t}")])
             for t in range(5)}
    cases.update({f"render-{k}": (tslab.main, SIZE + ["-t", "3"] + flags
                                  + ["-b", os.path.join(outdir, k)])
                  for k, (flags, _) in RENDERINGS.items()})
    cases.update({f"reference-o{o}": (tref.main, SIZE + ["-t", "1", "-o", o,
                                                         "-i", "2"])
                  for o in ("0", "1")})
    for cid, (main, argv) in cases.items():
        try:
            res[cid] = _run(main, argv + ["--emulate-devices", str(P)])
        except Exception:  # noqa: BLE001 — reported by that case's test
            res[cid] = {"error": traceback.format_exc()}
    res["modules"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "distributedfft_tpu"))
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    multihost.shutdown()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("cli_world")
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


def _jax_slab(argv, bdir):
    from distributedfft_tpu.cli.slab import main
    rc, text = _run(main, argv + ["-b", str(bdir), "--emulate-devices", "8"])
    assert rc == 0, text
    return _csvs(bdir)


# ---------------------------------------------------------------------------
# The flag surface
# ---------------------------------------------------------------------------


def _surface(ap):
    return {tuple(a.option_strings): (a.dest, a.default, a.choices,
                                      type(a).__name__, a.required)
            for a in ap._actions if a.option_strings != ["-h", "--help"]}


@pytest.mark.parametrize("name", ["slab", "reference", "batched"])
def test_flag_surface_matches_jax(name):
    import importlib
    mine = importlib.import_module(f"distributedfft_tpu_torch.cli.{name}")
    theirs = importlib.import_module(f"distributedfft_tpu.cli.{name}")
    assert _surface(mine.build_parser()) == _surface(theirs.build_parser())


@pytest.mark.parametrize("exe,flags,item", LATER,
                         ids=[f"{e}{''.join(f)}" for e, f, _ in LATER])
def test_later_item_flags_raise_naming_their_item(exe, flags, item):
    main = tslab.main if exe == "slab" else tref.main
    with pytest.raises(NotImplementedError, match=item):
        main(SIZE + flags + ["--emulate-devices", "1"])


@pytest.mark.parametrize("exe,flags,line", ITEM11,
                         ids=[f"{e}{''.join(f)}" for e, f, _ in ITEM11])
def test_item11_flags_run(tmp_path, monkeypatch, exe, flags, line):
    """The flags that raised naming item 11 now run: the "auto" fields
    resolve (a store under ``tmp_path``), ``--autotune-comm`` and
    ``--autotune`` print their winner, testcase 4 runs over four spawned
    ranks (their output is theirs, so only the exit code is held)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DFFT_WISDOM_K", "2")
    main = tslab.main if exe == "slab" else tref.main
    argv = SIZE + flags + ["-b", str(tmp_path / "b")] * (exe == "slab")
    if exe == "reference" and "--autotune" in flags:
        # Long enough that a loaded host's noise cannot swamp every pair.
        argv += ["--autotune-k", "33"]
    n = "4" if line is None else "1"
    rc, text = _run(main, argv + ["--emulate-devices", n])
    assert rc == 0
    if line is not None:
        assert line in text, text


@pytest.mark.parametrize("exe,flags", FORMER,
                         ids=[f"{e}{''.join(f)}" for e, f in FORMER])
def test_former_later_item_flags_run(devices, tmp_path, exe, flags):
    """The same call as before, now run: the slab executable writes the
    JAX executable's CSV path and sections; the reference executable
    prints its testcase-0 line as the JAX one does."""
    argv = SIZE + flags
    if exe == "reference":
        from distributedfft_tpu.cli.reference import main as jmain
        rc, text = _run(tref.main, argv + ["--emulate-devices", "1"])
        jrc, jtext = _run(jmain, argv + ["--emulate-devices", "8"])
        assert rc == jrc == 0
        tail = "(single-device 3D R2C, 16x16x16)"
        assert text.startswith("Run complete: ") and tail in text
        assert jtext.startswith("Run complete: ") and tail in jtext
        return
    rc, text = _run(tslab.main, argv + ["-b", str(tmp_path / "port"),
                                        "--emulate-devices", "1"])
    assert rc == 0 and _printed(text, "Run complete: ") > 0
    mine = _csvs(tmp_path / "port")
    assert len(mine) == 1
    assert mine == _jax_slab(argv + ["-p", "1"], tmp_path / "jax")


def test_reference_selftest_gates_its_testcase(monkeypatch):
    """The reference executable's ``--selftest``: the single-device
    roundtrip at its shape (with the host reference), PASS, then its
    testcase; exit 1 on FAIL, as the JAX executable."""
    rc, text = _run(tref.main, SIZE + ["--selftest", "--emulate-devices",
                                       "1"])
    assert rc == 0
    lines = text.splitlines()
    assert lines[0].startswith("selftest: PASS") and "reference" in lines[0]
    assert lines[1].startswith("Run complete: ")
    from distributedfft_tpu_torch.models import slab as slab_mod
    real = slab_mod.SlabFFTPlan._fft3d_r2c
    monkeypatch.setattr(slab_mod.SlabFFTPlan, "_fft3d_r2c",
                        lambda self: (lambda x: 2 * real(self)(x)))
    rc, text = _run(tref.main, SIZE + ["--selftest", "--emulate-devices",
                                       "1"])
    assert rc == 1 and text.startswith("selftest: FAIL")


def test_obs_dir_writes_the_event_log(tmp_path):
    """``--obs-dir``: the event log of the run, accepted by the port's and
    the JAX package's validators, with the plan's build spans in it."""
    import json
    from distributedfft_tpu.obs import tracing as jtracing
    from distributedfft_tpu_torch import obs
    d = tmp_path / "obs"
    try:
        rc, _ = _run(tslab.main, SIZE + ["--obs-dir", str(d), "-b",
                                         str(tmp_path / "b"),
                                         "--emulate-devices", "1"])
    finally:
        obs.reset_enablement()
    assert rc == 0
    logs = sorted(d.glob("events-*.jsonl"))
    assert len(logs) == 1
    n = obs.validate_events_file(str(logs[0]))
    assert n > 0 and jtracing.validate_events_file(str(logs[0])) == n
    names = {json.loads(ln)["name"] for ln in logs[0].read_text().splitlines()}
    assert {"plan.created", "plan.build"} <= names


def test_multihost_needs_a_world():
    with pytest.raises(SystemExit):
        tslab.main(SIZE + ["--multihost", "--emulate-devices", "2"])
    with pytest.raises(SystemExit):
        tslab._body(tslab.build_parser().parse_args(SIZE + ["--multihost"]))


def test_unknown_testcase_exits_2(capsys):
    assert tslab.main(SIZE + ["-t", "9", "--emulate-devices", "1"]) == 2
    assert tref.main(SIZE + ["-t", "9", "--emulate-devices", "1"]) == 2


# ---------------------------------------------------------------------------
# The executables against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t", range(5))
def test_slab_p1_writes_jax_csv(devices, tmp_path, t):
    argv = SIZE + ["-t", str(t)] + ITERS[t]
    rc, text = _run(tslab.main, argv + ["-b", str(tmp_path / "port"),
                                        "--emulate-devices", "1"])
    assert rc == 0
    mine = _csvs(tmp_path / "port")
    assert list(mine) == ["slab_default/test_0_0_0_16_16_16_1_1.csv"]
    assert mine == _jax_slab(argv + ["-p", "1"], tmp_path / "jax")
    if t in (0, 2):
        assert _printed(text, "Run complete: ") > 0


@pytest.mark.parametrize("t", range(5))
def test_slab_p4_writes_jax_csv(world, devices, tmp_path, t):
    texts = [_result(world, r, f"slab-t{t}") for r in range(P)]
    assert all(rc == 0 for rc, _ in texts)
    assert all(text == "" for _, text in texts[1:])     # rank 0 prints
    mine = _csvs(world[1] / f"t{t}")
    assert list(mine) == ["slab_default/test_0_0_0_16_16_16_1_4.csv"]
    assert mine == _jax_slab(SIZE + ["-t", str(t), "-p", "4"] + ITERS[t],
                             tmp_path)
    text = texts[0][1]
    if t == 3:
        assert _printed(text, "Result (max): ") / 16 ** 3 <= 5e-4
    if t == 4:
        assert _printed(text, "Result (max): ") / (3 * 64) <= 5e-4


@pytest.mark.parametrize("cid", list(RENDERINGS))
def test_renderings_run_through_the_executable(world, cid):
    import distributedfft_tpu as jdfft
    from distributedfft_tpu.cli.slab import build_parser
    from distributedfft_tpu.cli.common import (overlap_config_kwargs,
                                               wire_config_kwargs)
    from distributedfft_tpu.utils.timer import benchmark_filename
    flags, bound = RENDERINGS[cid]
    rc, text = _result(world, 0, f"render-{cid}")
    assert rc == 0
    assert _printed(text, "Result (max): ") / 16 ** 3 <= bound
    args = build_parser().parse_args(SIZE + flags + ["-b", "b", "-p", "4"])
    cfg = jdfft.Config(comm_method=jdfft.CommMethod.parse(args.comm_method),
                       send_method=jdfft.SendMethod.parse(args.send_method),
                       benchmark_dir="b", opt=args.opt,
                       double_prec=args.double_prec,
                       fft_backend=args.fft_backend,
                       **overlap_config_kwargs(args),
                       **wire_config_kwargs(args))
    variant = {"ZY_Then_X": "slab_default", "Z_Then_YX": "slab_z_then_yx",
               "Y_Then_ZX": "slab_y_then_zx"}[args.sequence]
    want = os.path.relpath(benchmark_filename(
        "b", variant, cfg, jdfft.GlobalSize(16, 16, 16), 4), "b")
    assert list(_csvs(world[1] / cid)) == [want]


def test_reference_bandwidth_over_the_world(world):
    for o, calls in (("0", "['isend', 'irecv']"),
                     ("1", "['all_to_all_single']")):
        rc, text = _result(world, 0, f"reference-o{o}")
        assert rc == 0
        kind = "Peer2Peer" if o == "0" else "All2All"
        assert text.startswith("Bandwidth: ") and f"[{kind}, 1d, 4 devices" \
            in text and f"collectives={calls}" in text, text


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_reference_t0_runs(backend):
    rc, text = _run(tref.main, SIZE + ["-t", "0", "-i", "2", "--fft-backend",
                                       backend, "--emulate-devices", "1"])
    assert rc == 0
    assert text.startswith("Run complete: ") and \
        "(single-device 3D R2C, 16x16x16)" in text
    assert _printed(text, "Run complete: ") > 0


def test_ranks_import_no_jax(world):
    assert all(w["modules"] == [] for w in world[0])


def test_module_entry_point_spawns_its_ranks(tmp_path):
    """The executable as a user runs it on the CPU: four spawned gloo
    ranks, double precision, the Laplacian testcase."""
    import distributedfft_tpu as jdfft
    from distributedfft_tpu.utils.timer import benchmark_filename
    cmd = [sys.executable, "-m", "distributedfft_tpu_torch.cli.slab", *SIZE,
           "-t", "4", "-p", "4", "-comm", "Peer2Peer", "--emulate-devices",
           "4", "-d", "-b", str(tmp_path)]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert _printed(proc.stdout, "Result (max): ") < 1e-9
    want = benchmark_filename(
        str(tmp_path), "slab_default",
        jdfft.Config(comm_method=jdfft.CommMethod.PEER2PEER),
        jdfft.GlobalSize(16, 16, 16), 4)
    assert want == str(tmp_path / "slab_default"
                       / "test_0_0_0_16_16_16_1_4.csv")
    assert [str(p) for p in tmp_path.rglob("*.csv")] == [want]
