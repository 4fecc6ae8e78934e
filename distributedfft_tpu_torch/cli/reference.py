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
     z-split (P even and > 2);
  4: the slab transpose's achieved fraction of the pure all-to-all's
     ceiling (``microbench.transpose_fraction_chain``), over every rank.
``--autotune`` races the local-FFT backends on this shape, prints the
table and records the winner in the wisdom store (``--wisdom`` /
``$DFFT_WISDOM``); testcase 0 with ``--fft-backend auto`` takes the
recorded winner (or races and records one).
"""

from __future__ import annotations

import argparse
import sys

from .common import (add_common_args, maybe_profile, print_obs_snapshot,
                     refuse_later_items,
                     run, setup_backend)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="reference", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(ap)
    ap.add_argument("--partition1", "-p1", type=int, default=0)
    ap.add_argument("--partition2", "-p2", type=int, default=0)
    ap.add_argument("--autotune", action="store_true",
                    help="race the local-FFT backends (xla / matmul / "
                         "pallas ...) for this shape on the device and "
                         "report the fastest within the accuracy budget")
    ap.add_argument("--autotune-budget", type=float, default=1e-4,
                    help="max roundtrip rel. error a backend may incur")
    ap.add_argument("--autotune-k", type=int, default=257,
                    help="chained roundtrips per timing sample")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    refuse_later_items(args)
    return run("distributedfft_tpu_torch.cli.reference", args, argv)


def _body(args) -> int:
    """The executable on one rank (or the only process)."""
    import numpy as np

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
        be = args.fft_backend if args.fft_backend != pm.AUTO else "xla"
        plan = SlabFFTPlan(pm.GlobalSize(*shape), pm.SlabPartition(1),
                           pm.Config(double_prec=args.double_prec,
                                     fft_backend=be, guards=args.guards),
                           device=device)
        if not run_selftest(plan)["ok"]:
            print("selftest FAILED; aborting", file=sys.stderr)
            return 1
    with maybe_profile(args, device):
        return _dispatch(args, shape, dtype, it, wu, device)


def _dispatch(args, shape, dtype, it, wu, device) -> int:
    """The work of ``-t`` / ``--autotune`` (under ``--profile-dir``'s
    trace when one is asked for)."""
    from ..parallel import multihost
    from ..testing import microbench as mb
    from ..testing.testcases import say

    if args.autotune:
        return _autotune(args, shape, device)
    if args.testcase == 0:
        backend = args.fft_backend
        if backend == "auto":
            # A bare single-device transform: the wisdom store's local
            # record (a miss races and records), as the plans resolve
            # Config(fft_backend="auto").
            from ..utils import wisdom
            backend, rec = wisdom.resolve_local_backend(
                shape, args.double_prec, path=args.wisdom,
                enabled=not args.no_wisdom, device=device)
            say(f"fft-backend auto -> {backend} "
                f"({'wisdom' if rec is not None else 'fallback'})")
        ms = mb.single_device_fft_ms(shape, it, wu, dtype,
                                     backend=backend, device=device)
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
    if args.testcase == 4:
        return _fraction(args, shape, dtype, it, wu, device)
    print(f"unknown testcase {args.testcase}", file=sys.stderr)
    return 2


def _autotune(args, shape, device) -> int:
    """--autotune: race, print, record the winner."""
    from ..testing import autotune as at
    from ..testing.testcases import say
    from ..utils import wisdom

    prec = "f64" if args.double_prec else "f32"
    say(f"autotuning local FFT backends for {shape} {prec} on "
        f"{device.type}:")
    ranked = at.autotune_local_fft(shape, args.autotune_budget,
                                   k=args.autotune_k,
                                   double_prec=args.double_prec,
                                   verbose=True, device=device)
    best = ranked[0]
    if not best.ok:
        print(f"no usable backend: {at.describe_failures(ranked)}",
              file=sys.stderr)
        return 1
    say(f"best: {best.label} ({best.per_iter_ms:.3f} ms/roundtrip, "
        f"rel_err {best.rel_err:.2e})")
    # The explicit "tune once": later --fft-backend auto runs of this
    # shape reuse the recorded winner.
    store = wisdom.open_store(args.wisdom, not args.no_wisdom)
    if store is not None:
        key = wisdom.local_key(shape, args.double_prec, device)
        if store.record(key, "local_fft", wisdom.local_fft_record(best)):
            say(f"wisdom: winner recorded -> {store.path}")
    print_obs_snapshot(args)
    return 0


def _fraction(args, shape, dtype, it, wu, device) -> int:
    """Testcase 4: the fraction gate over every rank."""
    import numpy as np

    from .. import params as pm
    from ..models.slab import SlabFFTPlan
    from ..parallel import multihost
    from ..testing import microbench as mb
    from ..testing.testcases import say

    p = multihost.world()[1]
    g = pm.GlobalSize(*shape)
    plan = SlabFFTPlan(g, pm.SlabPartition(p),
                       pm.Config(comm_method=pm.CommMethod.ALL2ALL,
                                 double_prec=args.double_prec,
                                 guards=args.guards,
                                 overlap_depth=pm.parse_overlap_depth(
                                     args.overlap_depth),
                                 overlap_subblocks=args.overlap_subblocks,
                                 use_wisdom=False),
                       device=device)
    x = plan.pad_input(np.random.default_rng(0).random(g.shape)
                       .astype(dtype))
    spec = plan.forward_stages()[0][1](x)
    # --streams-chunks N > 1 adds the pieced exchange (opt1sN) to the
    # selection race.
    sc = args.streams_chunks
    sv = (sc,) if sc and sc > 1 else ()
    try:
        r = mb.transpose_fraction_chain(plan, spec, repeats=max(it or 1, 3),
                                        warmup=max(wu, 1),
                                        streams_variants=sv)
    except ValueError as e:     # shape / divisibility precondition
        print(f"fraction gate unavailable for this shape: {e}",
              file=sys.stderr)
        return 2
    if r.get("degenerate"):
        print(f"fraction chain degenerate ({r['dropped']} repeats "
              "noise-swamped; raise -i or use a bigger size)",
              file=sys.stderr)
        return 1
    lo, hi = r["fraction_spread"]
    rlo, rhi = r.get("fraction_range", (lo, hi))
    say(f"All2All fraction: {r['fraction']:.3f} "
        f"[{r.get('variant', 'opt0')}, IQR {lo:.3f}-{hi:.3f}, "
        f"range {rlo:.3f}-{rhi:.3f}, "
        f"pipeline {r['pipe_gb_per_s']:.3f} GB/s vs ceiling "
        f"{r['raw_gb_per_s']:.3f} GB/s, k={r['k']}, "
        f"{p} devices]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
