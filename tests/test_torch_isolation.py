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

PORT = pathlib.Path(tdfft.__file__).resolve().parent
ROOT = PORT.parent
FORBIDDEN = ("jax", "jaxlib", "distributedfft_tpu")


def test_import_pulls_in_no_jax():
    code = ("import sys, distributedfft_tpu_torch, "
            "distributedfft_tpu_torch.ops.fft, "
            "distributedfft_tpu_torch.ops.hopper_fft; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}); print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


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
