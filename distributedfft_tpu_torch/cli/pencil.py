"""``pencil`` executable of the port — the reference's CLI surface
(``tests/src/pencil/main.cpp``) after the JAX package's ``cli/pencil.py``.

One rank per card, a 2 x 2 grid (``-p1 * -p2`` must be the world size):

    torchrun --nproc-per-node 4 -m distributedfft_tpu_torch.cli.pencil \\
        -nx 1024 -ny 1024 -nz 1024 -p1 2 -p2 2 -t 3 --fft-backend pallas

``-f 1|2`` stops after the z (or z and y) transforms, the reference's
partial-dimension runs. On the CPU, as four gloo ranks: add
``--emulate-devices 4``.
"""

from __future__ import annotations

import argparse
import sys

from .common import (add_common_args, config_kwargs, maybe_autotune_comm,
                     run, run_testcase, setup_backend)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="pencil", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(ap, pencil=True, comm_tunable=True)
    ap.add_argument("--partition1", "-p1", type=int, required=True,
                    help="partitions in x-direction")
    ap.add_argument("--partition2", "-p2", type=int, required=True,
                    help="partitions in y-direction")
    ap.add_argument("--fft-dim", "-f", type=int, default=3, choices=(1, 2, 3),
                    help="number of transform dimensions (partial-dim exec)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return run("distributedfft_tpu_torch.cli.pencil", args, argv)


def _body(args) -> int:
    """The executable on one rank (or the only process)."""
    from .. import params as pm
    from ..testing import testcases as tc

    device = setup_backend(args)
    g = pm.GlobalSize(args.input_dim_x, args.input_dim_y, args.input_dim_z)
    cfg = pm.Config(
        comm_method=pm.parse_comm_method(args.comm_method1),
        send_method=pm.SendMethod.parse(args.send_method1),
        comm_method2=(pm.parse_comm_method(args.comm_method2)
                      if args.comm_method2 else None),
        send_method2=(pm.SendMethod.parse(args.send_method2)
                      if args.send_method2 else None),
        **config_kwargs(args))
    part = pm.PencilPartition(args.partition1, args.partition2)
    cfg = maybe_autotune_comm(args, "pencil", g, part, cfg,
                              dims=args.fft_dim, device=device)
    plan = tc.make_plan("pencil", g, part, cfg, device=device,
                        dims=args.fft_dim)
    return run_testcase(plan, args, dims=args.fft_dim)


if __name__ == "__main__":
    sys.exit(main())
