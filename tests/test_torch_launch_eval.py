"""The port's job launcher (``distributedfft_tpu_torch/launch.py``,
``dfft-torch-launch``) and reducer (``evalkit/evaluate.py``,
``dfft-torch-eval``) against the JAX package's ``launch.py`` and
``evalkit/evaluate.py``: every case of ``tests/test_launch_eval.py``.

* the launcher keeps the job schema and the ``$``-key rule, and its
  ``--dry-run`` argv is JAX's with the module names mapped to the port's;
  a multi-card job (``"cards": N``) prints torchrun lines; every H100 job
  spec under ``distributedfft_tpu_torch/jobs/`` dry-runs;
* the reducer's output files are byte for byte JAX ``dfft-eval``'s on
  the same prefix: CSVs the port's ``Timer`` wrote, and CSVs the port's
  slab executable wrote under ``--emulate-devices 1``;
* ``--profile-dir`` writes a ``torch.profiler`` trace."""

import filecmp
import json
import os
import sys

import numpy as np
import pytest

from distributedfft_tpu_torch import launch
from distributedfft_tpu_torch.evalkit import evaluate
from distributedfft_tpu_torch.utils.timer import Timer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOB_SPECS = sorted(
    os.path.relpath(os.path.join(d, f), launch.JOBS)
    for d, _, fs in os.walk(launch.JOBS) for f in fs if f.endswith(".json"))


def _jax_launch():
    sys.path.insert(0, ROOT)
    try:
        import launch as jlaunch
    finally:
        sys.path.remove(ROOT)
    return jlaunch


class TestLauncher:
    def test_merge_flags_precedence(self):
        job = {"global_test_settings": {"-i": 5, "$-t": 4}}
        test = {"name": "Slab", "-comm": "All2All"}
        gp = {"-i": "20", "-t": "0"}
        merged = launch.merge_flags(job, test, gp)
        assert merged["-i"] == "20"
        assert merged["-t"] == 4
        assert merged["-comm"] == "All2All"
        assert merged == _jax_launch().merge_flags(job, test, gp)

    def test_size_flags(self):
        assert launch.size_flags(128) == ["-nx", "128", "-ny", "128",
                                          "-nz", "128"]
        assert launch.size_flags([128, 256, 512]) == [
            "-nx", "128", "-ny", "256", "-nz", "512"]

    def test_parse_param_string(self):
        got = launch.parse_param_string("-i 5 -c -b dir")
        assert got == {"-i": "5", "-c": True, "-b": "dir"}
        assert got == _jax_launch().parse_param_string("-i 5 -c -b dir")

    def test_exe_selection(self):
        assert launch.exe_for_test({"name": "Pencil"}) == "pencil"
        assert launch.exe_for_test({"name": "Reference"}) == "reference"
        assert launch.exe_for_test({"name": "Slab"}) == "slab"
        assert launch.exe_for_test({"name": "Batched"}) == "batched"
        jl = _jax_launch()
        assert {k: v.replace("distributedfft_tpu_torch.",
                             "distributedfft_tpu.")
                for k, v in launch.EXES.items()} == jl.EXES

    def test_dry_run_end_to_end(self, tmp_path, capsys):
        job = {"size": [16, [16, 16, 32]],
               "global_test_settings": {"-i": 1, "$-t": 0},
               "tests": [{"name": "Slab", "-comm": "All2All"},
                         {"name": "Pencil", "-p1": 2, "-p2": 2},
                         {"name": "Batched", "--shard": "x"},
                         {"name": "Reference"}]}
        path = tmp_path / "job.json"
        path.write_text(json.dumps(job))
        argv = ["--jobs", str(path), "--dry-run", "--emulate-devices", "4",
                "--global_params", "-i 3 -t 2 -c"]
        assert launch.main(argv) == 0
        mine = capsys.readouterr().out
        assert _jax_launch().main(argv) == 0
        theirs = capsys.readouterr().out
        assert "distributedfft_tpu_torch.cli.slab" in mine
        assert "-nx 16 -ny 16 -nz 16" in mine
        assert mine.replace("distributedfft_tpu_torch.cli.",
                            "distributedfft_tpu.cli.") == theirs

    def test_cards_job_prints_torchrun_lines(self, tmp_path, capsys):
        job = {"cards": 4, "size": [256],
               "tests": [{"name": "Slab", "-p": 4}]}
        path = tmp_path / "cards.json"
        path.write_text(json.dumps(job))
        assert launch.main(["--jobs", str(path), "--dry-run"]) == 0
        out = capsys.readouterr().out.strip()
        assert out == ("+ torchrun --standalone --nproc-per-node=4 -m "
                       "distributedfft_tpu_torch.cli.slab -nx 256 -ny 256 "
                       "-nz 256 -p 4")
        # emulated, a multi-card job runs as gloo ranks of one process
        assert launch.main(["--jobs", str(path), "--dry-run",
                            "--emulate-devices", "4"]) == 0
        assert sys.executable in capsys.readouterr().out

    @pytest.mark.parametrize("spec", JOB_SPECS)
    def test_h100_job_specs_dry_run(self, spec, capsys):
        """Every shipped job parses, names a port executable, and sizes
        each run for the cards it asks for (P = 1 on one card)."""
        path = os.path.join(launch.JOBS, spec)
        with open(path) as f:
            job = json.load(f)
        assert launch.main(["--jobs", path, "--dry-run"]) == 0
        lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("+ ")]
        assert len(lines) == len(job["size"]) * len(job["tests"])
        cards = job.get("cards", 1)
        for ln in lines:
            assert "distributedfft_tpu_torch.cli." in ln
            assert ("torchrun" in ln) == (cards > 1)


def _write_fake_csvs(bench_dir, variant, combos, sizes, iters=3, seed=0,
                     p=8, time_scale=1.0):
    rng = np.random.default_rng(seed)
    descs = ["init", "first", "xpose", "last", "Run complete"]
    for (opt, comm, snd) in combos:
        for (nx, ny, nz) in sizes:
            fname = f"test_{opt}_{comm}_{snd}_{nx}_{ny}_{nz}_0_{p}.csv"
            t = Timer(descs, p, os.path.join(bench_dir, variant, fname))
            for _ in range(iters):
                t.start()
                base = (1.0 + rng.random()) * time_scale
                t._durations = {"first": base, "xpose": base * 2,
                                "last": base * 3, "Run complete": base * 3.1}
                t.gather()


def _same_tree(a, b):
    """Every file under ``a`` and ``b``: the same names, the same bytes."""
    fa = sorted(os.path.relpath(os.path.join(d, f), a)
                for d, _, fs in os.walk(a) for f in fs)
    fb = sorted(os.path.relpath(os.path.join(d, f), b)
                for d, _, fs in os.walk(b) for f in fs)
    assert fa == fb and fa
    for rel in fa:
        assert filecmp.cmp(os.path.join(a, rel), os.path.join(b, rel),
                           shallow=False), rel
    return fa


def _jax_reduce(prefix, out, **kw):
    from distributedfft_tpu.evalkit import evaluate as jev
    return jev.reduce_prefix(prefix, out, **kw)


class TestEvalKit:
    def test_reduce_outputs(self, tmp_path):
        bench = str(tmp_path / "bench")
        _write_fake_csvs(bench, "slab_default",
                         [(0, 0, 0), (0, 1, 0), (1, 1, 0)],
                         [(16, 16, 16), (16, 16, 32)])
        out = str(tmp_path / "eval")
        evaluate.reduce_prefix(bench, out)
        runs = open(os.path.join(out, "slab_default", "runs",
                                 "runs_0_8_0.csv")).read().splitlines()
        assert runs[0] == ",,16_16_16,16_16_32"
        assert runs[1].startswith("Peer2Peer,Sync,")
        assert runs[2].startswith("All2All,Sync,")
        results = open(os.path.join(out, "results_8.csv")).read().splitlines()
        assert len(results) == 7
        assert results[1].startswith("Slab,2D-1D,Default,")
        assert results[4].startswith("Slab,2D-1D,Realigned,")
        lo, m, hi = (float(results[i].split(",")[3]) for i in (1, 2, 3))
        assert lo <= m <= hi
        props = open(os.path.join(out, "proportions_8_0.csv")).read()
        assert "first," in props and "xpose," in props
        jout = str(tmp_path / "jeval")
        _jax_reduce(bench, jout)
        _same_tree(out, jout)

    def test_phase_durations_from_cumulative_marks(self):
        blocks = [{"first": [2.0], "xpose": [5.0], "last": [6.0],
                   "Run complete": [6.1]}]
        d = evaluate._phase_durations(blocks)
        assert d["first"] == 2.0
        assert d["xpose"] == 3.0
        assert d["last"] == 1.0

    def test_reduce_with_plots_writes_pngs(self, tmp_path):
        pytest.importorskip("matplotlib")
        bench = str(tmp_path / "bench")
        _write_fake_csvs(bench, "slab_default", [(0, 0, 0), (0, 1, 0)],
                         [(16, 16, 16), (16, 16, 32)])
        out = str(tmp_path / "eval")
        evaluate.reduce_prefix(bench, out, make_plots=True)
        assert os.path.exists(os.path.join(out, "comparison_8.png"))
        assert os.path.exists(os.path.join(out, "proportions_8_0.png"))

    def test_scalability(self, tmp_path):
        bench = str(tmp_path / "bench")
        _write_fake_csvs(bench, "slab_default", [(0, 0, 0)],
                         [(16, 16, 16)], seed=5, p=4, time_scale=1.0)
        _write_fake_csvs(bench, "slab_default", [(0, 0, 0)],
                         [(16, 16, 16)], seed=5, p=8, time_scale=0.5)
        out = str(tmp_path / "eval")
        evaluate.reduce_prefix(bench, out)
        rows = evaluate.scalability(out, "16_16_16")
        assert [(p, round(t, 6)) for _, _, p, t in rows] == \
            sorted((p, round(t, 6)) for _, _, p, t in rows)
        lines = open(os.path.join(out, "scalability_16_16_16.csv")
                     ).read().splitlines()
        assert lines[0] == "size,16_16_16"
        assert lines[1] == "variant,opt,cuda,P,best_ms,speedup,efficiency"
        recs = [ln.split(",") for ln in lines[2:]]
        assert [r[3] for r in recs] == ["4", "8"]
        effs = [float(r[6]) for r in recs]
        assert effs[0] == 1.0 and abs(effs[1] - 1.0) < 1e-9
        from distributedfft_tpu.evalkit import evaluate as jev
        jout = str(tmp_path / "jeval")
        jev.reduce_prefix(bench, jout)
        assert jev.scalability(jout, "16_16_16") == rows
        _same_tree(out, jout)

    def test_scalability_stages_classification(self, tmp_path):
        bench = str(tmp_path / "bench")
        descs = ["init", "1D FFT Z-Direction",
                 "Transpose (Finished All2All)", "1D FFT X-Direction",
                 "Run complete"]
        for p, scale in ((4, 1.0), (8, 2.0)):
            vdir = os.path.join(bench, "slab_default")
            fname = f"test_0_1_0_16_16_16_0_{p}.csv"
            t = Timer(descs, p, os.path.join(vdir, fname))
            for _ in range(3):
                t.start()
                t._durations = {
                    "1D FFT Z-Direction": 2.0 * scale,
                    "Transpose (Finished All2All)": 5.0 * scale,
                    "1D FFT X-Direction": 11.0 * scale,
                    "Run complete": 11.0 * scale}
                t.gather()
        rows = evaluate.scalability_stages(bench, "16_16_16",
                                           str(tmp_path / "stages.csv"))
        by_p = {p: (fft, xp) for _, _, p, _, fft, xp in rows}
        assert by_p[4] == (8.0, 3.0)
        assert by_p[8] == (16.0, 6.0)
        lines = open(str(tmp_path / "stages.csv")).read().splitlines()
        assert lines[1] == ("variant,opt,cuda,P,total_ms,fft_ms,xpose_ms,"
                            "fft_vs_P0,xpose_vs_P0")
        rec8 = [ln for ln in lines
                if ln.startswith("slab_default_default,0,0,8")]
        assert rec8 and rec8[0].endswith("2.000,2.000")

    def test_committed_stage_scalability_is_current(self, tmp_path):
        """The port's reducer reproduces the committed cpumesh8
        stage-decomposition CSV from the committed raw Timer data."""
        prefix = os.path.join(ROOT, "eval", "benchmarks", "cpumesh8")
        committed = os.path.join(prefix, "eval",
                                 "scalability_stages_256_256_256.csv")
        got = tmp_path / "stages.csv"
        evaluate.scalability_stages(prefix, "256_256_256", str(got))
        assert got.read_text() == open(committed).read()

    def test_numerical_results(self, tmp_path):
        log = tmp_path / "run.out"
        log.write_text(
            "+ python -m distributedfft_tpu_torch.cli.slab -nx 16 -t 4\n"
            "Result (avg): 1e-12\nResult (max): 3e-12\n"
            "+ python -m distributedfft_tpu.cli.slab -nx 16 -t 4\n"
            "Result (max): 4e-12\n")
        out = str(tmp_path / "num.csv")
        n = evaluate.numerical_results(str(tmp_path), out)
        assert n == 3
        assert "Result (avg)" in open(out).read()

    def test_byte_equal_to_jax_on_the_port_executables_csvs(self, tmp_path):
        """CSVs the port's slab and batched executables wrote under
        ``--emulate-devices 1`` (two sizes, both exchanges and both opts,
        a batched stack): ``dfft-torch-eval`` writes the same files, byte
        for byte, as JAX ``dfft-eval`` on that prefix."""
        from distributedfft_tpu.evalkit import evaluate as jev
        from distributedfft_tpu_torch.cli import batched, slab
        bench = str(tmp_path / "bench")
        for n in (16, 24):
            for extra in (["-comm", "Peer2Peer", "-o", "0"],
                          ["-comm", "All2All", "-o", "0"],
                          ["-comm", "All2All", "-o", "1"]):
                assert slab.main(["-nx", str(n), "-ny", str(n), "-nz",
                                  str(n), "-t", "0", "-i", "3", "-w", "1",
                                  "--emulate-devices", "1", "-b", bench]
                                 + extra) == 0
        assert batched.main(["-nx", "16", "-ny", "16", "-nz", "4", "-t",
                             "0", "-i", "3", "--emulate-devices", "1",
                             "-b", bench]) == 0
        out, jout = str(tmp_path / "eval"), str(tmp_path / "jeval")
        assert evaluate.main(["--prefix", bench, "--out", out]) == 0
        assert jev.main(["--prefix", bench, "--out", jout]) == 0
        files = _same_tree(out, jout)
        assert "results_1.csv" in files


class TestProfileDir:
    def test_slab_cli_writes_profiler_trace(self, tmp_path, monkeypatch):
        """--profile-dir writes a torch.profiler trace of the testcase."""
        from distributedfft_tpu_torch.cli import slab as slab_cli
        from distributedfft_tpu_torch.obs import profile
        monkeypatch.chdir(tmp_path)
        rc = slab_cli.main(["-nx", "16", "-ny", "16", "-nz", "16", "-t", "3",
                            "-i", "1", "--emulate-devices", "1",
                            "--profile-dir", str(tmp_path / "trace")])
        assert rc == 0
        assert profile.find_trace_files(str(tmp_path / "trace"))
