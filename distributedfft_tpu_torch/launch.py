"""``dfft-torch-launch`` — the job launcher of the port, the JAX package's
``launch.py`` (the analog of the reference's ``launch.py``, L6) over the
port's executables.

Reads the same JSON job schema (``size`` sweep, ``global_test_settings``
merged into per-test flags, ``$``-prefixed keys that resist CLI override,
reference ``launch.py:343-347``) and runs each configuration through the
port's executables: ``python -m distributedfft_tpu_torch.cli.<exe>
<flags>``. ``--emulate-devices N`` runs each as N gloo ranks on the CPU;
without it the executables run on the card. A job whose ``cards`` key
asks for N > 1 cards launches each configuration as ``torchrun
--standalone --nproc-per-node N -m ...`` (one rank a card, NCCL): those
lines need a machine with N cards. The H100 job specs live under
``distributedfft_tpu_torch/jobs/`` (sizes one 80 GB card holds, and the
multi-card sweeps).

Usage:
    dfft-torch-launch --jobs distributedfft_tpu_torch/jobs/slab/benchmarks_h100.json \\
        [--global_params "-i 5 -w 2"] [--emulate-devices 4] [--dry-run]
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import subprocess
import sys
from typing import Dict, List


EXES = {"batched": "distributedfft_tpu_torch.cli.batched",
        "pencil": "distributedfft_tpu_torch.cli.pencil",
        "reference": "distributedfft_tpu_torch.cli.reference",
        "slab": "distributedfft_tpu_torch.cli.slab"}

JOBS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "jobs")


def exe_for_test(test: Dict) -> str:
    name = str(test.get("name", "slab")).lower()
    for key in EXES:
        if key in name:
            return key
    return "slab"


def merge_flags(job: Dict, test: Dict, global_params: Dict[str, str]) -> Dict[str, str]:
    """global_test_settings < test < --global_params, except ``$``-escaped
    keys which survive CLI override (reference launch.py:343-347)."""
    flags: Dict[str, str] = {}
    for src in (job.get("global_test_settings", {}), test):
        for k, v in src.items():
            if k == "name":
                continue
            flags[k.lstrip("$")] = v
    for k, v in global_params.items():
        protected = any(kk.startswith("$") and kk.lstrip("$") == k
                        for src in (job.get("global_test_settings", {}), test)
                        for kk in src)
        if not protected:
            flags[k] = v
    return flags


def flags_to_argv(flags: Dict[str, str]) -> List[str]:
    argv: List[str] = []
    for k, v in flags.items():
        if isinstance(v, bool):
            if v:
                argv.append(k)
        else:
            argv += [k, str(v)]
    return argv


def size_flags(size) -> List[str]:
    if isinstance(size, (list, tuple)):
        nx, ny, nz = size
    else:
        nx = ny = nz = size
    return ["-nx", str(nx), "-ny", str(ny), "-nz", str(nz)]


def parse_param_string(s: str) -> Dict[str, str]:
    toks = shlex.split(s or "")
    out: Dict[str, str] = {}
    i = 0
    while i < len(toks):
        k = toks[i]
        if i + 1 < len(toks) and not toks[i + 1].startswith("-"):
            out[k] = toks[i + 1]
            i += 2
        else:
            out[k] = True
            i += 1
    return out


def launcher_argv(module: str, cards: int, emulate: int) -> List[str]:
    """``python -m module``, or the torchrun line of a multi-card job
    (one rank a card) when it is not emulated."""
    if cards > 1 and not emulate:
        return ["torchrun", "--standalone", f"--nproc-per-node={cards}",
                "-m", module]
    return [sys.executable, "-m", module]


def run_job(path: str, global_params: Dict[str, str], emulate: int,
            dry_run: bool) -> int:
    with open(path) as f:
        job = json.load(f)
    cards = int(job.get("cards", 1))
    failures = 0
    for size in job.get("size", []):
        for test in job.get("tests", []):
            flags = merge_flags(job, test, global_params)
            argv = launcher_argv(EXES[exe_for_test(test)], cards, emulate)
            argv += size_flags(size)
            argv += flags_to_argv(flags)
            if emulate:
                argv += ["--emulate-devices", str(emulate)]
            print("+", " ".join(argv), flush=True)
            if dry_run:
                continue
            rc = subprocess.call(argv)
            if rc != 0:
                print(f"  -> exit {rc}", flush=True)
                failures += 1
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dfft-torch-launch",
                                 description=__doc__)
    ap.add_argument("--jobs", nargs="+", required=True,
                    help="job JSON file(s), reference schema")
    ap.add_argument("--global_params", default="",
                    help="extra CLI flags merged into every test "
                         "(overridden by $-escaped job keys)")
    ap.add_argument("--emulate-devices", type=int,
                    default=int(os.environ.get("DFFT_EMULATE_DEVICES", "0")))
    ap.add_argument("--dry-run", action="store_true")
    args = ap.parse_args(argv)
    gp = parse_param_string(args.global_params)
    failures = 0
    for path in args.jobs:
        failures += run_job(path, gp, args.emulate_devices, args.dry_run)
    if failures:
        print(f"{failures} test invocation(s) failed", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
