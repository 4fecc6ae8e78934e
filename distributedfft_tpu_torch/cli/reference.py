"""``reference`` executable of the port — the single-device baseline and
the slab transpose's bandwidth (reference ``tests/src/reference/main.cpp``,
``tests/include/tests_reference.hpp:42-96``), after the JAX package's
``cli/reference.py``.

Testcases (``-o`` picks the exchange: 0 = Peer2Peer, 1 = All2All):
  0: the full 3D R2C on one device (the reference's gather ->
     ``cufftMakePlan3d`` baseline);
  1: the 1D geometry: the slab transpose over every rank of the world.
The 2D and 3D geometries (testcases 2, 3) transpose a pencil mesh, ROADMAP
Queue 1 item 5; the fraction chain (testcase 4) and ``--autotune`` are
item 11. Each raises ``NotImplementedError`` naming its item.
"""

from __future__ import annotations

import argparse
import sys

from .common import (LATER_ITEMS, add_common_args, refuse_later_items,
                     run, setup_backend)

_LATER_TESTCASES = {
    2: "ROADMAP Queue 1, item 5 (the pencil plan: the 2D geometry)",
    3: "ROADMAP Queue 1, item 5 (the pencil plan: the 3D geometry)",
    4: LATER_ITEMS[11] + ": the fraction chain",
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="reference", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(ap)
    ap.add_argument("--partition1", "-p1", type=int, default=0)
    ap.add_argument("--partition2", "-p2", type=int, default=0)
    ap.add_argument("--autotune", action="store_true",
                    help="race the local-FFT backends (not ported yet)")
    ap.add_argument("--autotune-budget", type=float, default=1e-4,
                    help="max roundtrip rel. error a backend may incur")
    ap.add_argument("--autotune-k", type=int, default=257,
                    help="chained roundtrips per timing sample")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    refuse_later_items(args, "reference")
    if args.testcase in _LATER_TESTCASES:
        raise NotImplementedError(
            f"reference testcase {args.testcase} is not ported yet "
            f"({_LATER_TESTCASES[args.testcase]})")
    return run("distributedfft_tpu_torch.cli.reference", args, argv)


def _body(args) -> int:
    """The executable on one rank (or the only process)."""
    import numpy as np

    from ..parallel import multihost
    from ..testing import microbench as mb
    from ..testing.testcases import say

    device = setup_backend(args)
    shape = (args.input_dim_x, args.input_dim_y, args.input_dim_z)
    dtype = np.float64 if args.double_prec else np.float32
    it, wu = args.iterations, args.warmup_rounds
    if args.testcase == 0:
        ms = mb.single_device_fft_ms(shape, it, wu, dtype,
                                     backend=args.fft_backend, device=device)
        say(f"Run complete: {ms:.4f} ms (single-device 3D R2C, "
            f"{shape[0]}x{shape[1]}x{shape[2]})")
        return 0
    if args.testcase == 1:
        p = multihost.world()[1]
        explicit = args.opt != 0     # opt 0: Peer2Peer, opt 1: All2All
        r = mb.transpose_bandwidth(shape, p, explicit=explicit,
                                   iterations=it or 1, warmup=wu,
                                   dtype=dtype, device=device)
        kind = "All2All" if explicit else "Peer2Peer"
        say(f"Bandwidth: {r['gb_per_s'] * 1e3:.2f} MB/s "
            f"[{kind}, 1d, {p} devices, {r['bytes'] / 1e6:.1f} MB moved in "
            f"{r['seconds'] * 1e3:.3f} ms, collectives={r['collective_ops']}]")
        return 0
    print(f"unknown testcase {args.testcase}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
