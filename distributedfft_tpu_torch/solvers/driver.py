"""``dfft-torch-solve`` — a pseudo-spectral solver run as a standalone,
SIGTERM-drainable, crash-resumable process (the JAX package's
``dfft-solve``).

Run a Navier–Stokes simulation with crash-consistent checkpointing
(``distributedfft_tpu_torch/persist``), drain a final generation on
SIGTERM/SIGINT, and ``--resume`` a later invocation from the newest
valid generation — continuing **bit-exactly**: a run stopped at step k
and resumed to step n writes the same ``--out`` bytes as an
uninterrupted n-step run.

The stepping engine is the serve layer's :class:`ResidentSolver`
(``serve/resident.py``) — one step function applied stepwise — so
``dfft-torch-solve`` and a ``dfft-torch-serve`` resident share one
durability path and one bit-exactness argument. ``--double`` runs the
state in float64 (the port needs no switch for it).

Devices: the card by default; ``--emulate-devices N`` runs N gloo ranks on
the CPU (``-p N`` decomposes the plan over them; rank 0 prints and
writes ``--out``, the global physical field).

Examples::

    dfft-torch-solve --kind ns2d --n 4096 --batch 16 --steps 20 \\
        --fft-backend pallas --checkpoint-dir /tmp/ck \\
        --checkpoint-policy steps:10
    dfft-torch-solve --kind ns3d --n 32 --steps 100 --emulate-devices 4 \\
        -p 4 --checkpoint-dir /tmp/ck3 --resume --out final.npy
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="dfft-torch-solve", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--kind", default="ns2d", choices=("ns2d", "ns3d"),
                    help="ns2d: vorticity NS on a batched-2D plan; "
                         "ns3d: rotational NS on a slab plan")
    ap.add_argument("--n", type=int, default=32,
                    help="grid extent per transformed axis")
    ap.add_argument("--batch", type=int, default=1,
                    help="ns2d ensemble size (independent flows)")
    ap.add_argument("--partitions", "-p", type=int, default=1,
                    help="ranks the plan decomposes over")
    ap.add_argument("--shard", default="batch", choices=("batch", "x"),
                    help="ns2d decomposition: 'x' exercises a real "
                         "exchange")
    ap.add_argument("--steps", type=int, default=50,
                    help="target step count (resume continues toward "
                         "the SAME target)")
    ap.add_argument("--dt", type=float, default=1e-3)
    ap.add_argument("--viscosity", type=float, default=1e-2)
    ap.add_argument("--double", "-d", action="store_true",
                    help="float64 state")
    ap.add_argument("--fft-backend", default="xla")
    ap.add_argument("--step-interval-ms", type=float, default=0.0,
                    help="pause between steps (chaos drills use this to "
                         "widen the SIGTERM window)")
    ap.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                    help="two-generation checkpoint store (same as "
                         "$DFFT_CKPT_DIR; unset = no durability)")
    ap.add_argument("--checkpoint-policy", default=None,
                    metavar="steps:N[,secs:T][,drain:on|off]",
                    help="checkpoint cadence (same as $DFFT_CKPT_POLICY; "
                         "default drain-only)")
    ap.add_argument("--resume", action="store_true",
                    help="REQUIRE a restorable checkpoint and continue "
                         "from it (refuses to start fresh)")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="write the final PHYSICAL field as .npy (the "
                         "bit-exact comparison artifact)")
    ap.add_argument("--seed", type=int, default=0,
                    help="recorded as the RNG/forcing phase provenance")
    ap.add_argument("--emulate-devices", type=int,
                    default=int(os.environ.get("DFFT_EMULATE_DEVICES",
                                               "0")))
    ap.add_argument("--obs", action="store_true")
    ap.add_argument("--obs-dir", default=None, metavar="DIR")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ..cli.common import run
    return run("distributedfft_tpu_torch.solvers.driver", args, argv)


def physical_field(res) -> "object":
    """The resident's state as the GLOBAL physical field on the host
    (collective on P ranks: every rank calls it)."""
    import numpy as np
    import torch

    plan = res.solver.plan
    with torch.no_grad():
        phys = res.solver.to_physical(res.state)
    if phys.dim() == len(plan.input_shape):
        return plan.crop_real(phys)
    return np.stack([plan.crop_real(c) for c in phys])


def _body(args) -> int:
    """The executable on one rank (or the only process)."""
    import numpy as np

    from .. import obs
    from .. import persist
    from ..cli.common import setup_backend
    from ..parallel import multihost
    from ..serve.resident import ResidentSolver

    device = setup_backend(args)
    rank, world = multihost.world()
    if world > 1 and args.partitions != world:
        raise SystemExit(f"--partitions {args.partitions} in a world of "
                         f"{world} ranks: the plan spans the world")
    try:
        ckdir, policy = persist.resolve_env(args.checkpoint_dir,
                                            args.checkpoint_policy)
    except ValueError as e:
        raise SystemExit(f"--checkpoint-policy: {e}") from None
    if args.resume and not ckdir:
        raise SystemExit("--resume needs --checkpoint-dir (or "
                         f"${persist.ENV_DIR})")
    spec = {"kind": args.kind, "n": args.n, "batch": args.batch,
            "partitions": args.partitions, "shard": args.shard,
            "double": args.double, "fft_backend": args.fft_backend,
            "viscosity": args.viscosity, "dt": args.dt,
            "dir": ckdir, "device": str(device),
            "policy": policy, "rng": {"seed": args.seed, "draws": 0},
            "step_interval_ms": args.step_interval_ms,
            "max_steps": args.steps, "name": "dfft-solve"}
    try:
        res = ResidentSolver.build(spec)
    except persist.CheckpointMismatch as e:
        # The documented operator error: a usage message, not a traceback.
        raise SystemExit(f"dfft-torch-solve: checkpoint in {ckdir} was "
                         f"written by a different configuration — "
                         f"{e}") from None
    if args.resume and res.restored_from is None:
        raise SystemExit(f"--resume: no restorable checkpoint in {ckdir}")

    stop = threading.Event()

    def _graceful(signum, frame):  # noqa: ARG001 — signal contract
        print(f"dfft-torch-solve: signal {signum} -> drain checkpoint + "
              "exit", flush=True)
        stop.set()

    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, _graceful)
        signal.signal(signal.SIGINT, _graceful)

    interrupted = False
    res.start()
    while res.step < args.steps:
        if stop.wait(0.02):
            interrupted = True
            # The ranks agree on the stop after the step in flight.
            res._stop.set()
            break
        if not res.running:  # cheap liveness — no store I/O in the poll
            break
    # stop() drains through the policy's on-drain checkpoint — the
    # SIGTERM contract: durable state lands BEFORE the process exits 0.
    res.stop(checkpoint=True)

    out_path = None
    if args.out and not interrupted and res.error is None:
        phys = physical_field(res)
        if rank == 0:
            np.save(args.out, phys, allow_pickle=False)
            out_path = args.out
    summary = {"kind": args.kind, "n": args.n, "steps_target": args.steps,
               "step": res.step, "restored_from": res.restored_from,
               "checkpoints": res.checkpoints,
               "interrupted": interrupted, "error": res.error,
               "sim_time": round(res.sim_time, 9), "out": out_path}
    if rank == 0:
        print(json.dumps(summary, sort_keys=True), flush=True)
        if args.obs:
            print("obs metrics: "
                  + json.dumps(obs.metrics.snapshot(), sort_keys=True))
    # A stepping-thread failure is a loud failure: the run did NOT reach
    # its target and no later checkpoint will land.
    return 0 if res.error is None else 1


if __name__ == "__main__":
    sys.exit(main())
