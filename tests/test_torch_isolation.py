"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points refuse to run on a missing card instead of falling back
to the CPU."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch.models import base
from distributedfft_tpu_torch.parallel import multihost

PORT = pathlib.Path(tdfft.__file__).resolve().parent
ROOT = PORT.parent
FORBIDDEN = ("jax", "jaxlib", "distributedfft_tpu")


# Every module of the port, as an import name.
MODULES = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                 .removesuffix(".__init__") for p in PORT.rglob("*.py"))


def test_import_pulls_in_no_jax():
    code = (f"import sys, importlib; [importlib.import_module(m) for m in "
            f"{MODULES!r}]; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}); print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert "distributedfft_tpu_torch.parallel.multihost" in MODULES
    assert {f"distributedfft_tpu_torch.{m}" for m in (
        "obs", "obs.flightrec", "obs.metrics", "obs.tracing", "resilience",
        "resilience.circuit", "resilience.deadline", "resilience.fallback",
        "resilience.guards", "resilience.inject", "resilience.selftest",
        "solvers", "solvers.convolve", "solvers.navier_stokes",
        "solvers.poisson", "solvers.r2r", "testing.workloads",
        "testing.autotune", "testing.chaintimer", "utils.wisdom", "persist",
        "persist.checkpoint", "persist.policy", "persist.state",
        "obs.promexp", "obs.profile", "serve", "serve.cli",
        "serve.plancache", "serve.resident", "serve.router", "serve.server",
        "solvers.driver", "analysis", "analysis.contracts", "analysis.opscan",
        "analysis.oplint", "analysis.plangraph", "analysis.schedverify",
        "analysis.srclint", "analysis.verify", "obs.explain")
    } <= set(MODULES)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _rank_modules(rank, addr, outdir):
    """A spawned rank: join a 2-rank gloo world, run a distributed plan,
    and record which forbidden modules it holds."""
    multihost.maybe_initialize(addr, 2, rank, backend="gloo", timeout_s=60)
    plan = tdfft.SlabFFTPlan(tdfft.GlobalSize(4, 4, 4), tdfft.SlabPartition(2),
                             tdfft.Config(fft_backend="pallas"), device="cpu")
    plan.exec_c2r(plan.exec_r2c(multihost.plan_local_input(plan)))
    bad = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    (pathlib.Path(outdir) / f"rank{rank}.txt").write_text(repr(bad))
    multihost.shutdown()


def test_spawned_ranks_import_no_jax(tmp_path):
    torch.multiprocessing.start_processes(
        _rank_modules, args=(multihost.local_coordinator(), str(tmp_path)),
        nprocs=2, start_method="spawn")
    for r in range(2):
        assert (tmp_path / f"rank{r}.txt").read_text() == "[]"


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")) + ["chip_smoke.py"])
def test_sources_name_no_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_entry_points_default_to_cuda_and_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdfft.SlabFFTPlan(tdfft.GlobalSize(8, 8, 8), tdfft.SlabPartition(1))
    with pytest.raises(RuntimeError):
        base.resolve_device("cuda:0")
    plan = tdfft.SlabFFTPlan(tdfft.GlobalSize(8, 8, 8), tdfft.SlabPartition(1),
                             device="cpu")
    assert plan.device.type == "cpu"
