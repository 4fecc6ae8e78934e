"""``batched`` executable of the port — BASELINE config #4 ("Batched 2D
FFT 4096^2 x 64") through the testcases, the phase Timer and its CSVs,
after the JAX package's ``cli/batched.py``.

``-nx`` / ``-ny`` are the image and ``-nz`` the batch. On the card:

    python -m distributedfft_tpu_torch.cli.batched -nx 4096 -ny 4096 \\
        -nz 64 --shard batch -t 0 --fft-backend pallas

``--shard batch`` (the default) splits the batch over the ranks, no
exchange; ``--shard x`` splits x (1D FFT y, the exchange, 1D FFT x) with
the slab plan's comm and send methods. ``--batch-chunk N`` runs a rank's
batch N images at a time (0: the whole stack). The CSV name's slots are
``<batch>_<nx>_<ny>``, under ``batched2d_<shard>[_ck<N>]``. Testcases 0-3;
4 (the 3D Laplacian) exits 2. One rank per card: ``torchrun
--nproc-per-node 4 -m distributedfft_tpu_torch.cli.batched ...``; on the
CPU, as four gloo ranks: add ``--emulate-devices 4``.
"""

from __future__ import annotations

import argparse
import sys

from .common import (add_common_args, config_kwargs, maybe_autotune_comm,
                     run, run_testcase, setup_backend)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="batched", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(ap, pencil=False, comm_tunable=True)
    ap.add_argument("--shard", default="batch", choices=("batch", "x"),
                    help="decomposed axis: 'batch' (no exchange) or 'x' "
                         "(the slab-style exchange)")
    ap.add_argument("--batch-chunk", type=int, default=None,
                    help="transform a rank's batch in slices of this many "
                         "images, one after another; must divide the local "
                         "padded batch (0 = the whole stack)")
    ap.add_argument("--partitions", "-p", type=int, default=0,
                    help="number of ranks (default: the world size)")
    ap.add_argument("--c2c", action="store_true",
                    help="complex-to-complex transform instead of R2C/C2R")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.testcase == 4:
        print("testcase 4 (3D Laplacian) is not defined for the batched-2D "
              "plan; use testcases 0-3", file=sys.stderr)
        return 2
    return run("distributedfft_tpu_torch.cli.batched", args, argv)


def _body(args) -> int:
    """The executable on one rank (or the only process)."""
    from .. import params as pm
    from ..models.batched2d import Batched2DFFTPlan
    from ..parallel import multihost
    from ..testing.testcases import say

    device = setup_backend(args)
    p = args.partitions or multihost.world()[1]
    cfg = pm.Config(comm_method=pm.parse_comm_method(args.comm_method),
                    send_method=pm.SendMethod.parse(args.send_method),
                    **config_kwargs(args))
    transform = "c2c" if args.c2c else "r2c"
    if getattr(args, "autotune_comm", False):
        if args.shard != "x":
            say("autotune-comm: shard='batch' issues no collectives; "
                "nothing to tune")
        else:
            g = pm.GlobalSize(args.input_dim_z, args.input_dim_x,
                              args.input_dim_y)  # (batch, nx, ny) slots
            cfg = maybe_autotune_comm(args, "batched2d", g,
                                      pm.SlabPartition(p), cfg, dims=2,
                                      variant="x", transform=transform,
                                      device=device)
    plan = Batched2DFFTPlan(
        batch=args.input_dim_z, nx=args.input_dim_x, ny=args.input_dim_y,
        partition=pm.SlabPartition(p), config=cfg, shard=args.shard,
        transform=transform, batch_chunk=args.batch_chunk, device=device)
    # dims=2: the unnormalized roundtrip's factor is nx * ny.
    return run_testcase(plan, args, dims=2)


if __name__ == "__main__":
    sys.exit(main())
