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

``--guards`` sets ``Config.guards``; ``--selftest`` runs one roundtrip
of the plan before the testcase and exits 1 on FAIL; ``--obs`` prints
notices and a metrics snapshot, ``--obs-dir`` writes the event log.
``--fft-backend auto``, ``-comm auto`` and ``-wire auto`` are resolved
by measurement when the plan is built, through the wisdom store of
``--wisdom`` / ``$DFFT_WISDOM`` (``--no-wisdom``: none);
``--autotune-comm`` races the comm matrix first, prints it and runs (and
records) the winner. ``--profile-stages`` ends the run with the stage
profile of the plan's forward direction (``print_stage_profile``: device
ms per declared plan-graph node beside its H100 ideal).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import os
import sys
from typing import List, Optional

import torch

from .. import obs
from .. import params as pm
from ..ops.fft import BACKENDS
from ..parallel import multihost

# Seconds a collective of an emulated (spawned, CPU) world waits before it
# fails: a rank that died leaves the others waiting on it.
EMULATED_TIMEOUT_S = 300


def add_common_args(ap: argparse.ArgumentParser, pencil: bool = False,
                    comm_tunable: bool = False) -> None:
    """The JAX package's ``add_common_args`` surface: slab and reference
    take one ``-comm`` / ``-snd`` pair, pencil one pair per transpose
    (``-comm1/-snd1``, ``-comm2/-snd2``; the second defaults to the
    first)."""
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
                    help="use float64/complex128 (under 'pallas' the "
                         "matmul backend runs it, as in the JAX package)")
    ap.add_argument("--benchmark_dir", "-b", default="benchmarks",
                    help="prefix for the benchmark directory")
    ap.add_argument("--fft-backend", default="xla",
                    choices=BACKENDS + ("auto",),
                    help="local transform implementation: torch.fft (cuFFT "
                         "on the card; 'xla', the default), DFT products "
                         "('matmul', 'matmul-r2'), the hand-written CUDA "
                         "kernels ('pallas') or the chirp-z transform for "
                         "any axis length ('bluestein')")
    ap.add_argument("--wisdom", default=None, metavar="PATH",
                    help="persistent plan-wisdom store of the 'auto' "
                         "races (default $DFFT_WISDOM)")
    ap.add_argument("--no-wisdom", action="store_true",
                    help="never consult or write the wisdom store")
    ap.add_argument("--emulate-devices", type=int,
                    default=int(os.environ.get("DFFT_EMULATE_DEVICES", "0")),
                    help="run as N gloo ranks on the CPU (0 = the CUDA "
                         "device)")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler chrome trace of the timed "
                         "runs to this directory")
    ap.add_argument("--profile-stages", action="store_true",
                    help="stage-attributed device profile (not ported yet)")
    ap.add_argument("--obs", action="store_true",
                    help="print notices (guard violations, demotions) "
                         "and a metrics snapshot after the run")
    ap.add_argument("--obs-dir", default=None, metavar="DIR",
                    help="write the structured JSONL event log (and "
                         "flight-recorder dumps) under DIR "
                         "($DFFT_OBS_DIR)")
    ap.add_argument("--multihost", action="store_true",
                    help="require a torch.distributed world (torchrun, or "
                         "DFFT_COORDINATOR / DFFT_NUM_PROCESSES / "
                         "DFFT_PROCESS_ID)")
    if comm_tunable:
        ap.add_argument("--autotune-comm", action="store_true",
                        help="race the comm-strategy matrix (comm method x "
                             "send method x opt x wire) on this shape, "
                             "print it and run the winner (recorded in "
                             "the wisdom store when one is configured)")
    snd_help = ("Sync (monolithic exchange) | Streams (the exchange in "
                "pieces of the free axis) | Ring (point-to-point ring; owns "
                "the rendering regardless of comm method) | RingOverlap "
                "(the ring with transfers issued ahead of the compute; "
                "bit-identical output) | MPI_Type (alias of Sync)")
    if pencil:
        ap.add_argument("--comm-method1", "-comm1", default="Peer2Peer",
                        help='"Peer2Peer" (a send and a receive to every '
                             'peer) or "All2All" (one all-to-all), '
                             'transpose 1')
        ap.add_argument("--send-method1", "-snd1", default="Sync",
                        help=snd_help)
        ap.add_argument("--comm-method2", "-comm2", default=None,
                        help="same as --comm-method1 for transpose 2 "
                             "(default: transpose 1's)")
        ap.add_argument("--send-method2", "-snd2", default=None)
    else:
        ap.add_argument("--comm-method", "-comm", default="Peer2Peer",
                        help='"Peer2Peer" (a send and a receive to every '
                             'peer) or "All2All" (one all-to-all)')
        ap.add_argument("--send-method", "-snd", default="Sync",
                        help=snd_help)
    ap.add_argument("--streams-chunks", type=int, default=None,
                    help="piece count for the Streams transpose (ignored "
                         "unless the send method is Streams)")
    ap.add_argument("--overlap-depth", default="auto",
                    help="revolving receive-buffer depth of RingOverlap "
                         "(2 | 4 | 8 | 'auto' = 2)")
    ap.add_argument("--overlap-subblocks", type=int, default=None,
                    help="split every exchanged ring block into this many "
                         "sub-blocks, or, under All2All + Sync, pipeline "
                         "the all-to-all in this many pieces (default 1)")
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
                    help="numerical guards after every execution: Parseval "
                         "and wire drift; 'check' counts violations, "
                         "'enforce' raises (default $DFFT_GUARDS or off)")
    ap.add_argument("--selftest", action="store_true",
                    help="one roundtrip of the plan before the timed loop; "
                         "exit 1 on FAIL")
    ap.add_argument("--tc1-truth", choices=("host", "analytic"),
                    default="host",
                    help="testcase-1 ground truth: 'host' = dense random "
                         "input vs full np.fft on the host; 'analytic' = "
                         "sine field vs its closed-form spectrum, both "
                         "built on the device")


def maybe_autotune_comm(args, kind: str, global_size, partition, cfg,
                        sequence=None, dims: int = 3,
                        variant: Optional[str] = None,
                        transform: str = "r2c",
                        device: "str | torch.device" = "cuda"):
    """--autotune-comm: race the comm matrix for this shape over the ranks,
    print the table and return the winning Config (``cfg`` itself when the
    flag is off). ``dims`` (the pencil's depth) and ``transform`` make the
    race time the program the run executes. The winner is recorded in the
    wisdom store when one is configured, so ``-comm auto`` reuses it."""
    if not getattr(args, "autotune_comm", False):
        return cfg
    from ..testing import autotune as at
    from ..testing.testcases import say
    from ..utils import wisdom

    if dims < 2:
        say("autotune-comm: dims=1 performs no transpose; nothing to tune")
        return cfg
    say(f"autotuning comm strategies for {global_size.shape} "
        f"({kind}, {partition.num_ranks} ranks, dims={dims}):")
    base = cfg  # the config the send=None candidates are timed on
    if pm.AUTO in (base.comm_method, base.comm_method2):
        base = dataclasses.replace(
            base, comm_method=pm.CommMethod.ALL2ALL,
            comm_method2=(None if base.comm_method2 == pm.AUTO
                          else base.comm_method2))
    ranked = at.autotune_comm(kind, global_size, partition, base,
                              sequence=sequence, dims=dims,
                              transform=transform,
                              iterations=max(args.iterations, 3),
                              warmup=max(args.warmup_rounds, 1),
                              race_send=True,
                              # -wire auto hands the wire axis to this race;
                              # an explicit -wire is kept, not re-raced.
                              race_wire=cfg.wire_dtype == pm.AUTO,
                              verbose=multihost.world()[0] == 0,
                              device=device)
    best = ranked[0]
    cfg = at.apply_best_comm(ranked, base)
    runner = ranked[1] if len(ranked) > 1 and ranked[1].ok else None
    delta = (f", {runner.total_ms - best.total_ms:+.3f} ms vs next "
             f"({runner.label})" if runner else "")
    say(f"best: {best.label} ({best.total_ms:.3f} ms roundtrip{delta})")
    store = wisdom.store_for_config(cfg)
    if store is not None and best.ok:
        key = wisdom.plan_key(kind, global_size.shape, cfg.double_prec,
                              partition, cfg.norm, sequence=sequence,
                              variant=variant, transform=transform,
                              dims=dims, device=device)
        if store.record(key, "comm", wisdom.comm_record(best, base)):
            say(f"wisdom: comm winner recorded -> {store.path}")
    return cfg


def setup_obs(args) -> None:
    """Apply the observability flags (--obs / --obs-dir) before any plan is
    constructed, so the first build's spans are captured."""
    if getattr(args, "obs_dir", None):
        obs.enable(args.obs_dir)
    if getattr(args, "obs", False):
        obs.enable_console()


def print_obs_snapshot(args) -> None:
    """The --obs epilogue: one compact JSON line of the metrics registry
    (rank 0's)."""
    if getattr(args, "obs", False) and multihost.world()[0] == 0:
        print("obs metrics: " + json.dumps(obs.metrics.snapshot(),
                                           sort_keys=True), flush=True)


def maybe_profile(args, device: "str | torch.device" = "cuda"):
    """Context manager: a ``torch.profiler`` trace of the block written to
    ``--profile-dir`` (one chrome trace per rank), a no-op without it."""
    return obs.profile.maybe_profile(getattr(args, "profile_dir", None),
                                     device)


def print_stage_profile(plan, args, dims: Optional[int] = None) -> None:
    """The ``--profile-stages`` epilogue (all four executables): a short
    profiled window of the plan's forward direction, printed as device
    time per declared plan-graph node with each stage's H100 ideal
    (``obs/profile.stage_profile``), on rank 0. Collective: every rank
    runs the window. A plan family with no declared graph prints why; a
    kernel or collective that fails in the window raises, as it would in
    the timed loop."""
    if not getattr(args, "profile_stages", False):
        return
    from ..analysis.plangraph import MissingGraph
    from ..testing.testcases import say

    say("stage profile (measured device time per declared plan-graph "
        "node):")
    try:
        prof = obs.profile.stage_profile(plan, "forward",
                                         3 if dims is None else dims)
    except MissingGraph as e:
        say(f"  unavailable: {e}")
        return
    say("\n".join(obs.profile.format_stage_profile(prof)))


def maybe_selftest(plan, args, dims: Optional[int] = None) -> bool:
    """--selftest: one roundtrip of the exact plan before the timed loop
    (``resilience/selftest.py``); False — abort with exit code 1 — on
    FAIL."""
    if not getattr(args, "selftest", False):
        return True
    from ..resilience.selftest import run_selftest
    return bool(run_selftest(plan, dims=dims)["ok"])


def setup_backend(args) -> torch.device:
    """The device the executable runs on, after joining a world: the CPU
    under ``--emulate-devices`` (the caller is one emulated rank, or the
    only one), else the CUDA device, with ``maybe_initialize()`` joining a
    configured world and each rank on its own card. The observability
    flags apply first."""
    setup_obs(args)
    if args.emulate_devices:
        _, n = multihost.world()
        if n not in (1, args.emulate_devices):
            raise ValueError(f"--emulate-devices {args.emulate_devices} in a "
                             f"world of {n} ranks")
        return torch.device("cpu")
    rank, n = multihost.maybe_initialize()
    if getattr(args, "multihost", False) and n == 1:
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


def run_testcase(plan, args, dims: Optional[int] = None) -> int:
    """Dispatch ``-t N`` to the testcases and print the perf summary;
    ``dims`` is the pencil executable's ``--fft-dim`` (testcase 4 always
    runs the whole transform)."""
    from ..testing import testcases as tc

    fn = {0: tc.testcase0, 1: tc.testcase1, 2: tc.testcase2,
          3: tc.testcase3, 4: tc.testcase4}.get(args.testcase)
    if fn is None:
        print(f"unknown testcase {args.testcase}", file=sys.stderr)
        return 2
    if not maybe_selftest(plan, args, dims=dims):
        print("selftest FAILED; aborting before the timed loop",
              file=sys.stderr)
        return 1
    kwargs = {}
    if args.testcase in (0, 2, 3, 4):
        kwargs.update(iterations=args.iterations, warmup=args.warmup_rounds)
    if args.testcase == 1:
        kwargs["truth"] = args.tc1_truth
    if dims is not None and args.testcase != 4:
        kwargs["dims"] = dims
    with maybe_profile(args, plan.device):
        result = fn(plan, **kwargs)
    if "mean_ms" in result:
        tc.say(f"Run complete: {result['mean_ms']:.4f} ms "
               f"(mean over {args.iterations} iterations)")
    print_obs_snapshot(args)
    print_stage_profile(plan, args, dims=dims)
    return 0


def run(module: str, args, argv: Optional[List[str]]) -> int:
    """Run ``module._body(args)``. Under ``--emulate-devices N`` with N > 1
    outside a world, spawn N gloo ranks on the CPU, each parsing ``argv``
    and running the body; the exit code is the first failing rank's."""
    n = args.emulate_devices
    if n and getattr(args, "multihost", False):
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
