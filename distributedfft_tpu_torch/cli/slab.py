"""``slab`` executable of the port — the reference's CLI surface
(``tests/src/slab/main.cpp``) after the JAX package's ``cli/slab.py``.

On the card (one process; ``-p`` defaults to the world size, 1 here):

    python -m distributedfft_tpu_torch.cli.slab -nx 512 -ny 512 -nz 512 \\
        -t 3 -i 10 --fft-backend pallas -b /tmp/bench

One rank per card: ``torchrun --nproc-per-node 4 -m
distributedfft_tpu_torch.cli.slab ...``. On the CPU, as four gloo ranks:
add ``--emulate-devices 4``.
"""

from __future__ import annotations

import argparse
import sys

from .common import (add_common_args, config_kwargs, refuse_later_items, run,
                     run_testcase, setup_backend)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="slab", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(ap, comm_tunable=True)
    ap.add_argument("--sequence", "-s", default="ZY_Then_X",
                    help='"ZY_Then_X" (default), "Z_Then_YX" or "Y_Then_ZX"')
    ap.add_argument("--partitions", "-p", type=int, default=0,
                    help="number of slabs (default: the world size)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    refuse_later_items(args, "slab")
    return run("distributedfft_tpu_torch.cli.slab", args, argv)


def _body(args) -> int:
    """The executable on one rank (or the only process)."""
    from .. import params as pm
    from ..parallel import multihost
    from ..testing import testcases as tc

    device = setup_backend(args)
    p = args.partitions or multihost.world()[1]
    g = pm.GlobalSize(args.input_dim_x, args.input_dim_y, args.input_dim_z)
    cfg = pm.Config(comm_method=pm.CommMethod.parse(args.comm_method),
                    send_method=pm.SendMethod.parse(args.send_method),
                    **config_kwargs(args))
    plan = tc.make_plan("slab", g, pm.SlabPartition(p), cfg,
                        sequence=args.sequence, device=device)
    return run_testcase(plan, args)


if __name__ == "__main__":
    sys.exit(main())
