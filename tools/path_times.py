#!/usr/bin/env python3
"""Time kernel launches and "pallas" paths of the port on one
card in two trees of the repo, alternated in one call (A, B, B, A), so
that a change and its parent are compared on the same card under the same
power limit:

* kernel 6 (``zy_fwd``) at (512, 480, 480), (512, 448, 448) and (512,
  442, 442), kernel 7 (``x_cols``) at (480, 480, 241) and (448, 448, 225),
  the 480^3 and 448^3 plans' shapes, and at (512, 512, 257), the 512^3
  plan's (the power-of-two column kernel), on the inverse's layouts
  (complex64 in, planes out) and the forward's (planes in, complex64
  out), kernel 8 (``yz_inv``) at (512, 480, 480), (512, 448, 448) and
  (512, 442, 442), kernel 1 (``rdft``) on 131072 rows of 480 and 442,
  kernel 4 (``cdft_tw``, forward) on 410880 rows of 320 points, n1 2
  (the 640 split's first stage), on 155592 rows of 480, n1 9 (the 4320
  split's), and on 410880 rows of 448, 416 and 408, n1 2 (the 896, 832
  and 816 splits'), and kernel 2 (``cdft``, forward) on 131072
  rows of 480, 448, 440 and 442, kernel 3 (``irdft``) on 131072 half
  rows to 480 and to 442 points, and kernel 5 (``rdft_tw``) on 819200
  rows of 320 and 408, n1 2 (the 640 and 816 splits' first stage), and on
  311040 rows of 480, n1 9 (the 4320 rfft's), each beside its plain
  version;
* the 480^3 and 448^3 P = 1 slab plans, forward and inverse (kernels 6,
  7 and 8), with the entry points of each direction;
* the 256 x 480^2, 64 x 896^2, 64 x 832^2 and 256 x 440^2 batched-2D
  plans, forward and inverse (kernels 1, 2 and 3 at 480 and 440, kernel 4
  at 448 and 416);
* the 4320 convolution: 8 images of 4096^2 with a 225^2 kernel, "same",
  whose plan pads each axis to good_size 4320 = 9 x 480 (kernels 4 and 5
  on its first stages);
* the 8 x 4320^2 batched-2D plan, forward and inverse;
* the C2R past the direct lengths (``hf.irfft`` along the last axis) on
  524288 half rows to 2048 points (the 2048 x 256 x 2048 plan's z),
  262144 to 4096 (the 64 x 4096^2 stack's y), 57344 to 896, 53248 to 832
  (the 64 x 896^2 and 64 x 832^2 stacks' y) and 34560 to 4320 (the 4320
  convolution's y), each with its entry points, beside
  ``torch.fft.irfft`` on the same rows, the bound of kernel 3's body on
  them (bytes: 8 (n/2 + 1) in, 4 n out: the packed body's real rows, or
  the pack pass's n/2 complex) and, where the tree has it, that body's
  own time;
* the 2048 x 256 x 2048 per-axis slab plan and the 64 x 4096^2, 64 x
  896^2 and 64 x 832^2 batched stacks, forward and inverse, with the
  entry points of each direction.

    python3 tools/path_times.py TREE_A TREE_B     # e.g. build/parent .
    python3 tools/path_times.py --one TREE        # one tree, one process

Each tree runs in a process of its own that imports that tree's package,
so each builds its own kernels (``build/kernels/`` under the tree). Every
time is the median of CUDA-event times after a warm-up call. Prints one
JSON line a run (tree, the C entry points each path launched, ms) and,
first, the card's name and power limit as ``nvidia-smi`` gives them.
"""

import json
import os
import statistics
import subprocess
import sys

SEED = 20261016
SLABS = ((480, 480, 480), (448, 448, 448))
CONV = (8, 4096, 225)       # images, extent, kernel side
BATCHED = (8, 4320, 4320)
REPS = 5
ZYS = ((512, 480, 480), (512, 448, 448), (512, 442, 442))
XCS = ((480, 480, 241), (448, 448, 225), (512, 512, 257))  # X, Ky, Zo
YZS = ((512, 480, 480), (512, 448, 448), (512, 442, 442))
RDFT = ((131072, 480), (131072, 442))                 # rows, n
TW = ((410880, 320, 2), (155592, 480, 9), (410880, 448, 2),
      (410880, 416, 2), (410880, 408, 2))             # rows, n2, n1
CDFT = ((131072, 480), (131072, 448), (131072, 440), (131072, 442))  # rows, n
C2R = ((131072, 480), (131072, 442))                  # rows, n
RDFT_TW = ((819200, 320, 2), (819200, 408, 2), (311040, 480, 9))  # rows, n2, n1
STACKS = ((256, 480, 480), (64, 896, 896), (64, 832, 832), (256, 440, 440),
          (64, 4096, 4096))
SPLIT = (2048, 256, 2048)
C2R_SPLIT = ((524288, 2048), (262144, 4096), (57344, 896), (53248, 832),
             (34560, 4320))                           # rows, n
HBM = 3.35e12


def median_ms(torch, fn, reps=REPS):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


def entries(torch, hf, fn):
    """The C entry points one call of fn launches."""
    hf.reset_launches()
    fn()
    torch.cuda.synchronize()
    return dict(sorted(hf.ENTRIES.items()))


def one(tree):
    """Time the kernels and paths with the package of ``tree``; one JSON
    line."""
    root = os.path.abspath(tree)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import distributedfft_tpu_torch as dft
    from distributedfft_tpu_torch.ops import hopper_fft as hf
    from distributedfft_tpu_torch.solvers import make_convolver
    if not hf.__file__.startswith(root + os.sep):
        raise SystemExit(f"imported {hf.__file__}, not the tree {root}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    pallas = dft.Config(fft_backend="pallas")
    row = {"tree": tree}
    dev = torch.device("cuda")

    for zy in ZYS:
        x = torch.randn(zy, generator=gen, device="cuda")
        yr, yi = hf.zy_fwd(x)
        pr, pi = hf.zy_fwd_plain(x, *hf._planes("rdft", zy[2], False, dev),
                                 *hf._planes("dft", zy[1], False, dev))
        row[f"kernel6_{zy[1]}"] = dict(
            shape=list(zy), entries=entries(torch, hf, lambda: hf.zy_fwd(x)),
            max_rel_err=max(max_rel(yr, pr), max_rel(yi, pi)),
            ms=median_ms(torch, lambda: hf.zy_fwd(x)))
        del x, yr, yi, pr, pi
    for xc in XCS:
        X = xc[0]
        ar, ai = (torch.randn(xc, generator=gen, device="cuda")
                  for _ in range(2))
        c = torch.complex(ar, ai)
        for inverse in (True, False):
            ref = hf.x_c2c_plain(ar, ai, *hf._planes("dft", X, inverse, dev))
            if inverse:
                def run():
                    return hf.x_cols(c, True, complex_out=False)
            else:
                def run():
                    return hf.x_cols((ar, ai), False, complex_out=True)
            got = run()
            if not inverse:
                got = (got.real, got.imag)
            row[f"kernel7_{X}_{'inverse' if inverse else 'forward'}"] = dict(
                shape=list(xc), entries=entries(torch, hf, run),
                max_rel_err=max(max_rel(g, r) for g, r in zip(got, ref)),
                ms=median_ms(torch, run))
            del ref, got
        del ar, ai, c
    for yz in YZS:
        X, Y, Z = yz
        er, ei = (torch.randn((X, Y, Z // 2 + 1), generator=gen,
                              device="cuda") for _ in range(2))
        ref = hf.yz_inv_plain(er, ei, *hf._planes("dft", Y, True, dev),
                              *hf._planes("c2r", Z, False, dev))

        def run():
            return hf.yz_inv(er, ei, Z)

        row[f"kernel8_{Y}"] = dict(
            shape=list(yz), entries=entries(torch, hf, run),
            max_rel_err=max_rel(run(), ref), ms=median_ms(torch, run))
        del er, ei, ref
    for m, n in RDFT:
        x = torch.randn((m, n), generator=gen, device="cuda")
        ref = hf.stage_plain(x, *hf._planes("rdft", n, False, dev))

        def run():
            return hf.rdft(x)

        row[f"kernel1_{n}"] = dict(
            rows=m, entries=entries(torch, hf, run),
            max_rel_err=max_rel(run(), ref), ms=median_ms(torch, run))
        del x, ref
    for m, n2, n1 in TW:
        x = torch.randn((m, n2), generator=gen, device="cuda",
                        dtype=torch.complex64)
        ref = hf.stage_plain(x, *hf._planes("dft", n2, False, dev),
                             *hf._twiddle_planes(n1, n2, False, dev))

        def run():
            return hf.cdft_tw(x, n1, False)

        row[f"kernel4_{n2}_n1_{n1}"] = dict(
            rows=m, entries=entries(torch, hf, run),
            max_rel_err=max_rel(run(), ref), ms=median_ms(torch, run))
        del x, ref
    for m, n in CDFT:
        x = torch.randn((m, n), generator=gen, device="cuda",
                        dtype=torch.complex64)
        ref = hf.stage_plain(x, *hf._planes("dft", n, False, dev))

        def run():
            return hf.cdft(x, False)

        row[f"kernel2_{n}"] = dict(
            rows=m, entries=entries(torch, hf, run),
            max_rel_err=max_rel(run(), ref), ms=median_ms(torch, run))
        del x, ref
    for m, n in C2R:
        c = torch.randn((m, n // 2 + 1), generator=gen, device="cuda",
                        dtype=torch.complex64)
        ref = hf.c2r_plain(c, *hf._planes("c2r", n, False, dev))

        def run():
            return hf.irdft(c, n)

        row[f"kernel3_{n}"] = dict(
            rows=m, entries=entries(torch, hf, run),
            max_rel_err=max_rel(run(), ref), ms=median_ms(torch, run))
        del c, ref
    for m, n2, n1 in RDFT_TW:
        x = torch.randn((m, n2), generator=gen, device="cuda")
        ref = hf.stage_plain(x, *hf._planes("dft", n2, False, dev),
                             *hf._twiddle_planes(n1, n2, False, dev))

        def run():
            return hf.rdft_tw(x, n1)

        row[f"kernel5_{n2}_n1_{n1}"] = dict(
            rows=m, entries=entries(torch, hf, run),
            max_rel_err=max_rel(run(), ref), ms=median_ms(torch, run))
        del x, ref
    torch.cuda.empty_cache()

    for m, n in C2R_SPLIT:
        k = n // 2 + 1
        c = torch.randn((m, k), generator=gen, device="cuda",
                        dtype=torch.complex64)
        c[:, 0] = c[:, 0].real.clone()      # the library keeps these
        c[:, -1] = c[:, -1].real.clone()    # imaginary parts at some sizes
        ref = torch.fft.irfft(c, n=n, norm="forward")

        def run():
            return hf.irfft(c, n=n, axis=-1)

        packed = hf._engine_length(n // 2)
        r = dict(rows=m, entries=entries(torch, hf, run),
                 max_rel_err=max_rel(run(), ref), ms=median_ms(torch, run),
                 irfft_ms=median_ms(torch, lambda: torch.fft.irfft(
                     c, n=n, norm="forward")),
                 body_bound_ms=1e3 * m * (8 * k + 4 * n) / HBM)
        if hasattr(hf, "irdft_packed"):     # the body alone, where it exists
            if packed:
                r["body_ms"] = median_ms(torch, lambda: hf.irdft_packed(c, n))
            else:
                n1 = hf._split_axis(n // 2)[0]
                r["body_ms"] = median_ms(torch, lambda: hf.c2r_pack(c, n1))
        row[f"c2r_{n}"] = r
        del c, ref
        torch.cuda.empty_cache()

    x = torch.randn(SPLIT, generator=gen, device="cuda")
    plan = dft.SlabFFTPlan(dft.GlobalSize(*SPLIT), dft.SlabPartition(1),
                           pallas)
    c = plan.exec_r2c(x)
    row["slab{}x{}x{}".format(*SPLIT)] = dict(
        entries_forward=entries(torch, hf, lambda: plan.exec_r2c(x)),
        entries_inverse=entries(torch, hf, lambda: plan.exec_c2r(c)),
        forward_vs_rfftn=max_rel(c, torch.fft.rfftn(x)),
        roundtrip_vs_input=max_rel(plan.exec_c2r(c) / float(x.numel()), x),
        forward_ms=median_ms(torch, lambda: plan.exec_r2c(x)),
        inverse_ms=median_ms(torch, lambda: plan.exec_c2r(c)),
        irfftn_ms=median_ms(torch, lambda: torch.fft.irfftn(c, s=SPLIT)))
    del x, c, plan
    torch.cuda.empty_cache()

    for slab in SLABS:
        x = torch.randn(slab, generator=gen, device="cuda")
        plan = dft.SlabFFTPlan(dft.GlobalSize(*slab), dft.SlabPartition(1),
                               pallas)
        c = plan.exec_r2c(x)
        row[f"slab{slab[0]}"] = dict(
            entries_forward=entries(torch, hf, lambda: plan.exec_r2c(x)),
            entries_inverse=entries(torch, hf, lambda: plan.exec_c2r(c)),
            forward_vs_rfftn=max_rel(c, torch.fft.rfftn(x)),
            roundtrip_vs_input=max_rel(plan.exec_c2r(c) / float(x.numel()),
                                       x),
            forward_ms=median_ms(torch, lambda: plan.exec_r2c(x)),
            inverse_ms=median_ms(torch, lambda: plan.exec_c2r(c)))
        del x, c, plan
        torch.cuda.empty_cache()

    b, n, k = CONV
    img = torch.rand((b, n, n), generator=gen, device="cuda")
    ker = np.random.default_rng(SEED).random((k, k)).astype(np.float32)
    cv = make_convolver(ker, (n, n), batch=b, mode="same", config=pallas)
    row["conv4320"] = dict(plan_shape=list(cv.plan.input_shape),
                           entries=entries(torch, hf, lambda: cv(img)),
                           call_ms=median_ms(torch, lambda: cv(img)))
    del img, cv

    for shape in (BATCHED,) + STACKS:
        x = torch.rand(shape, generator=gen, device="cuda")
        p = dft.Batched2DFFTPlan(*shape, dft.SlabPartition(1), pallas)
        spec = p.exec_forward(x)
        row["batched{}x{}".format(*shape)] = dict(
            entries_forward=entries(torch, hf, lambda: p.exec_forward(x)),
            entries_inverse=entries(torch, hf, lambda: p.exec_inverse(spec)),
            forward_vs_rfft2=max_rel(spec, torch.fft.rfft2(x)),
            roundtrip_vs_input=max_rel(
                p.exec_inverse(spec) / float(shape[1] * shape[2]), x),
            forward_ms=median_ms(torch, lambda: p.exec_forward(x)),
            inverse_ms=median_ms(torch, lambda: p.exec_inverse(spec)),
            irfft2_ms=median_ms(torch, lambda: torch.fft.irfft2(
                spec, s=shape[1:])))
        del x, p, spec
        torch.cuda.empty_cache()
    print(json.dumps(row), flush=True)


def main(argv):
    if argv[:1] == ["--one"] and len(argv) == 2:
        one(argv[1])
        return 0
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)
    a, b = argv
    for tree in (a, b, b, a):
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--one", tree]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
