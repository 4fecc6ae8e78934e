"""``reference`` executable of the port — the single-device baseline and
the global transpose's bandwidth (reference
``tests/src/reference/main.cpp``, ``tests/include/tests_reference.hpp:
42-96``), after the JAX package's ``cli/reference.py``.

Testcases (``-o`` picks the exchange: 0 = Peer2Peer, 1 = All2All):
  0: the full 3D R2C on one device (the reference's gather ->
     ``cufftMakePlan3d`` baseline);
  1: the 1D geometry: the slab transpose over every rank of the world;
  2: the 2D geometry: a pencil transpose over one axis of a 1 x P grid;
  3: the 3D geometry: the 2 x P/2 grid, x held split while y becomes
     z-split (P even and > 2).
The fraction chain (testcase 4) and ``--autotune`` are ROADMAP Queue 1
item 11; each raises ``NotImplementedError`` naming it.
"""

from __future__ import annotations

import argparse
import sys

from .common import (LATER_ITEMS, add_common_args, refuse_later_items,
                     run, setup_backend)

_LATER_TESTCASES = {4: LATER_ITEMS[11] + ": the fraction chain"}


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
    refuse_later_items(args)
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
    if args.selftest:
        # The reference executable has no distributed plan; its selftest
        # is the single-device roundtrip at this shape.
        from .. import params as pm
        from ..models.slab import SlabFFTPlan
        from ..resilience.selftest import run_selftest
        plan = SlabFFTPlan(pm.GlobalSize(*shape), pm.SlabPartition(1),
                           pm.Config(double_prec=args.double_prec,
                                     fft_backend=args.fft_backend,
                                     guards=args.guards), device=device)
        if not run_selftest(plan)["ok"]:
            print("selftest FAILED; aborting", file=sys.stderr)
            return 1
    if args.testcase == 0:
        ms = mb.single_device_fft_ms(shape, it, wu, dtype,
                                     backend=args.fft_backend, device=device)
        say(f"Run complete: {ms:.4f} ms (single-device 3D R2C, "
            f"{shape[0]}x{shape[1]}x{shape[2]})")
        return 0
    if args.testcase in (1, 2, 3):
        p = multihost.world()[1]
        explicit = args.opt != 0     # opt 0: Peer2Peer, opt 1: All2All
        geometry = {1: "1d", 2: "2d", 3: "3d"}[args.testcase]
        r = mb.transpose_bandwidth(shape, p, explicit=explicit,
                                   iterations=it or 1, warmup=wu,
                                   dtype=dtype, device=device,
                                   geometry=geometry)
        kind = "All2All" if explicit else "Peer2Peer"
        say(f"Bandwidth: {r['gb_per_s'] * 1e3:.2f} MB/s "
            f"[{kind}, {geometry}, {p} devices, {r['bytes'] / 1e6:.1f} MB "
            f"moved in "
            f"{r['seconds'] * 1e3:.3f} ms, collectives={r['collective_ops']}]")
        return 0
    print(f"unknown testcase {args.testcase}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
