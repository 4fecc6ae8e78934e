"""Shared CLI plumbing of the port's executables — the JAX package's
``cli/common.py`` flag surface, with the same names, short forms and
defaults (the reference's ``getValueOfParam`` / ``checkFlag`` parsers,
``tests/src/slab/main.cpp:76-118``).

Devices: without ``--emulate-devices`` a plan runs on the CUDA device, and
``maybe_initialize()`` joins a ``torch.distributed`` world when ``torchrun``
or the ``DFFT_*`` variables configure one (one rank per card: NCCL).
``--emulate-devices N`` runs on the CPU instead, as N gloo ranks that this
process spawns (``torch.multiprocessing``), each running the executable's
body; rank 0 prints. A process that is already one rank of an N-rank world
runs the body itself.

A flag whose feature the port does not have yet raises
``NotImplementedError`` naming its ROADMAP Queue 1 item whenever it is
given a value other than its default (``refuse_later_items``); none is
ignored.
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys
from typing import List, Optional

import torch

from .. import params as pm
from ..ops.fft import _NOT_PORTED, BACKENDS
from ..parallel import multihost

LATER_ITEMS = {
    2: "ROADMAP Queue 1, item 2 (opt 1, the realigned exchange)",
    3: "ROADMAP Queue 1, item 3 (the matmul backend, which runs the JAX "
       "package's f64 'pallas' path)",
    7: "ROADMAP Queue 1, item 7 (exchange renderings: STREAMS and the "
       "pipelined all-to-all)",
    9: "ROADMAP Queue 1, item 9 (resilience: guards and selftest)",
    11: "ROADMAP Queue 1, item 11 (autotune and wisdom)",
    12: "ROADMAP Queue 1, item 12 (observability)",
}

# Seconds a collective of an emulated (spawned, CPU) world waits before it
# fails: a rank that died leaves the others waiting on it.
EMULATED_TIMEOUT_S = 300


def add_common_args(ap: argparse.ArgumentParser,
                    comm_tunable: bool = False) -> None:
    """The JAX package's ``add_common_args`` surface (slab and reference:
    one ``-comm`` / ``-snd`` pair)."""
    ap.add_argument("--input-dim-x", "-nx", type=int, required=True,
                    help="size of the input data in x-direction")
    ap.add_argument("--input-dim-y", "-ny", type=int, required=True,
                    help="size of the input data in y-direction")
    ap.add_argument("--input-dim-z", "-nz", type=int, required=True,
                    help="size of the input data in z-direction")
    ap.add_argument("--testcase", "-t", type=int, default=0,
                    help="which testcase to execute (0-4)")
    ap.add_argument("--opt", "-o", type=int, default=0, choices=(0, 1),
                    help="0: default layout; 1: realigned (coordinate "
                         "transform) layout")
    ap.add_argument("--iterations", "-i", type=int, default=1)
    ap.add_argument("--warmup-rounds", "-w", type=int, default=0)
    ap.add_argument("--cuda_aware", "-c", action="store_true", default=True,
                    help="device-resident exchange (the default; cuda=1 in "
                         "CSV names)")
    ap.add_argument("--host-staged", dest="cuda_aware", action="store_false",
                    help="label this run as host-staged (cuda=0 in CSV names)")
    ap.add_argument("--double_prec", "-d", action="store_true",
                    help="use float64/complex128 (under --fft-backend xla)")
    ap.add_argument("--benchmark_dir", "-b", default="benchmarks",
                    help="prefix for the benchmark directory")
    ap.add_argument("--fft-backend", default="xla",
                    choices=BACKENDS + ("auto",),
                    help="local transform implementation: torch.fft (cuFFT "
                         "on the card; 'xla', the default) or the "
                         "hand-written CUDA kernels ('pallas')")
    ap.add_argument("--wisdom", default=None, metavar="PATH",
                    help="persistent plan-wisdom store (not ported yet)")
    ap.add_argument("--no-wisdom", action="store_true",
                    help="never consult or write the wisdom store")
    ap.add_argument("--emulate-devices", type=int,
                    default=int(os.environ.get("DFFT_EMULATE_DEVICES", "0")),
                    help="run as N gloo ranks on the CPU (0 = the CUDA "
                         "device)")
    ap.add_argument("--profile-dir", default=None,
                    help="profiler trace directory (not ported yet)")
    ap.add_argument("--profile-stages", action="store_true",
                    help="stage-attributed device profile (not ported yet)")
    ap.add_argument("--obs", action="store_true",
                    help="observability console (not ported yet)")
    ap.add_argument("--obs-dir", default=None, metavar="DIR",
                    help="structured event log directory (not ported yet)")
    ap.add_argument("--multihost", action="store_true",
                    help="require a torch.distributed world (torchrun, or "
                         "DFFT_COORDINATOR / DFFT_NUM_PROCESSES / "
                         "DFFT_PROCESS_ID)")
    if comm_tunable:
        ap.add_argument("--autotune-comm", action="store_true",
                        help="race the comm-strategy matrix (not ported yet)")
    ap.add_argument("--comm-method", "-comm", default="Peer2Peer",
                    help='"Peer2Peer" (a send and a receive to every peer) '
                         'or "All2All" (one all-to-all)')
    ap.add_argument("--send-method", "-snd", default="Sync",
                    help="Sync (monolithic exchange) | Ring (point-to-point "
                         "ring with per-block FFTs between steps; owns the "
                         "rendering regardless of comm method) | "
                         "RingOverlap (the ring with transfers issued ahead "
                         "of the compute; bit-identical output) | "
                         "MPI_Type (alias of Sync)")
    ap.add_argument("--streams-chunks", type=int, default=None,
                    help="piece count for the Streams transpose (ignored "
                         "unless the send method is Streams)")
    ap.add_argument("--overlap-depth", default="auto",
                    help="revolving receive-buffer depth of RingOverlap "
                         "(2 | 4 | 8 | 'auto' = 2)")
    ap.add_argument("--overlap-subblocks", type=int, default=None,
                    help="split every exchanged ring block into this many "
                         "sub-blocks (default 1)")
    ap.add_argument("--wire-dtype", "-wire",
                    default=os.environ.get("DFFT_WIRE", "native"),
                    choices=("native", "bf16", "auto"),
                    help="wire encoding of the exchanges (default $DFFT_WIRE "
                         "or 'native'): 'bf16' = opt-in lossy planar bf16 "
                         "pair, half the bytes of complex64")
    ap.add_argument("--wire-error-budget", type=float, default=None,
                    help="max rel error the 'auto' wire race accepts")
    ap.add_argument("--guards", default=None,
                    choices=("off", "check", "enforce"),
                    help="in-graph numerical guards (not ported yet)")
    ap.add_argument("--selftest", action="store_true",
                    help="guarded roundtrip before the timed loop (not "
                         "ported yet)")
    ap.add_argument("--tc1-truth", choices=("host", "analytic"),
                    default="host",
                    help="testcase-1 ground truth: 'host' = dense random "
                         "input vs full np.fft on the host; 'analytic' = "
                         "sine field vs its closed-form spectrum, both "
                         "built on the device")


def refuse_later_items(args, kind: str = "slab") -> None:
    """Raise ``NotImplementedError`` for the first flag that asks for a
    feature of a later ROADMAP item. ``kind`` is "slab" or "reference" (on
    the reference executable ``-o 1`` selects the all-to-all probe)."""
    comm = str(args.comm_method).strip().lower()
    snd = pm.SendMethod.parse(args.send_method)
    for flag, item, on in (
            ("--autotune-comm", 11, getattr(args, "autotune_comm", False)),
            ("--autotune", 11, getattr(args, "autotune", False)),
            ("--wisdom", 11, args.wisdom is not None),
            ("-comm auto", 11, comm == pm.AUTO),
            ("--fft-backend auto", 11, args.fft_backend == pm.AUTO),
            ("-wire auto", 11, args.wire_dtype == pm.AUTO),
            ("--guards", 9, args.guards not in (None, "off")),
            ("--selftest", 9, args.selftest),
            ("--obs", 12, args.obs),
            ("--obs-dir", 12, args.obs_dir is not None),
            ("--profile-dir", 12, args.profile_dir is not None),
            ("--profile-stages", 12, args.profile_stages),
            ("-o 1", 2, kind == "slab" and args.opt == 1),
            ("-d under --fft-backend pallas", 3,
             args.double_prec and args.fft_backend == "pallas"),
            ("-snd Streams", 7, snd is pm.SendMethod.STREAMS),
            ("--overlap-subblocks > 1 with All2All + Sync (the pipelined "
             "all-to-all)", 7,
             comm != pm.AUTO and (args.overlap_subblocks or 1) > 1
             and pm.CommMethod.parse(comm) is pm.CommMethod.ALL2ALL
             and snd in (pm.SendMethod.SYNC, pm.SendMethod.MPI_TYPE))):
        if on:
            raise NotImplementedError(
                f"{flag} is not ported yet ({LATER_ITEMS[item]})")
    if args.fft_backend in _NOT_PORTED:
        raise NotImplementedError(
            f"--fft-backend {args.fft_backend} is not ported yet "
            f"({_NOT_PORTED[args.fft_backend]})")


def setup_backend(args) -> torch.device:
    """The device the executable runs on, after joining a world: the CPU
    under ``--emulate-devices`` (the caller is one emulated rank, or the
    only one), else the CUDA device, with ``maybe_initialize()`` joining a
    configured world and each rank on its own card."""
    if args.emulate_devices:
        _, n = multihost.world()
        if n not in (1, args.emulate_devices):
            raise ValueError(f"--emulate-devices {args.emulate_devices} in a "
                             f"world of {n} ranks")
        return torch.device("cpu")
    rank, n = multihost.maybe_initialize()
    if args.multihost and n == 1:
        raise SystemExit("--multihost needs a torch.distributed world: start "
                         "the ranks with torchrun, or set DFFT_COORDINATOR, "
                         "DFFT_NUM_PROCESSES and DFFT_PROCESS_ID")
    if n > 1 and torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    return torch.device("cuda")


def config_kwargs(args) -> dict:
    """Config fields of the flags every executable shares."""
    return dict(
        opt=args.opt, cuda_aware=args.cuda_aware,
        warmup_rounds=args.warmup_rounds, iterations=args.iterations,
        double_prec=args.double_prec, benchmark_dir=args.benchmark_dir,
        fft_backend=args.fft_backend, streams_chunks=args.streams_chunks,
        overlap_depth=pm.parse_overlap_depth(args.overlap_depth),
        overlap_subblocks=args.overlap_subblocks,
        wire_dtype=pm.parse_wire_dtype(args.wire_dtype),
        wire_error_budget=args.wire_error_budget,
        wisdom_path=args.wisdom, use_wisdom=not args.no_wisdom,
        guards=args.guards)


def run_testcase(plan, args) -> int:
    """Dispatch ``-t N`` to the testcases and print the perf summary."""
    from ..testing import testcases as tc

    fn = {0: tc.testcase0, 1: tc.testcase1, 2: tc.testcase2,
          3: tc.testcase3, 4: tc.testcase4}.get(args.testcase)
    if fn is None:
        print(f"unknown testcase {args.testcase}", file=sys.stderr)
        return 2
    kwargs = {}
    if args.testcase in (0, 2, 3, 4):
        kwargs.update(iterations=args.iterations, warmup=args.warmup_rounds)
    if args.testcase == 1:
        kwargs["truth"] = args.tc1_truth
    result = fn(plan, **kwargs)
    if "mean_ms" in result:
        tc.say(f"Run complete: {result['mean_ms']:.4f} ms "
               f"(mean over {args.iterations} iterations)")
    return 0


def run(module: str, args, argv: Optional[List[str]]) -> int:
    """Run ``module._body(args)``. Under ``--emulate-devices N`` with N > 1
    outside a world, spawn N gloo ranks on the CPU, each parsing ``argv``
    and running the body; the exit code is the first failing rank's."""
    n = args.emulate_devices
    if n and args.multihost:
        raise SystemExit("--multihost and --emulate-devices are mutually "
                         "exclusive (emulation spawns its own ranks)")
    if n > 1 and multihost.world()[1] == 1:
        argv = list(sys.argv[1:] if argv is None else argv)
        try:
            torch.multiprocessing.start_processes(
                _emulated_rank,
                args=(module, argv, multihost.local_coordinator(), n),
                nprocs=n, start_method="spawn")
        except torch.multiprocessing.ProcessExitedException as e:
            return e.exit_code or 1
        return 0
    return importlib.import_module(module)._body(args)


def _emulated_rank(rank: int, module: str, argv: List[str], addr: str,
                   n: int) -> None:
    """One spawned CPU rank of ``--emulate-devices``."""
    multihost.maybe_initialize(addr, n, rank, backend="gloo",
                               timeout_s=EMULATED_TIMEOUT_S)
    try:
        mod = importlib.import_module(module)
        rc = mod._body(mod.build_parser().parse_args(argv))
    finally:
        multihost.shutdown()
    if rc:
        sys.exit(rc)
