#!/usr/bin/env python3
"""Check kernel 3's route past the direct lengths on one card: its packed
body (``hf.irdft_packed``) and pack pass (``hf.c2r_pack``) against their
plain versions and ``torch.fft.irfft``, and ``hf.irfft`` of even and odd
n past the direct lengths with the C entry points each launches.

    python3 tools/c2r_probe.py        # from the root of a checkout

Builds ``csrc/stage.cu`` first (``ops/_build.py``). The packed body runs
at m = 1024 (the 2048 x 256 x 2048 plan's z rows), 448 and 416 (the 64 x
896^2 and 64 x 832^2 stacks' y rows), at odd and small row counts and at
m 320, 480, 8 and 512; the pack pass at m = 2048, n1 4 (the 64 x 4096^2
stack's y rows) and at every kind of first-stage layout (n1 1, 4, 5, 45,
64). Where the rows are many it times each (median of 5 CUDA-event runs)
beside ``torch.fft.irfft`` and the bound of the bytes it moves at 3.35
TB/s. The half spectra are random, bins 0 and m included: the library
does not ignore their imaginary parts at every size (its error against
the port there is no fault of the port's), the plain versions do. Prints
the card's name and power limit, then one JSON line a case.
"""

import json
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, ".")

from distributedfft_tpu_torch.ops import _build  # noqa: E402
from distributedfft_tpu_torch.ops import hopper_fft as hf  # noqa: E402

HBM = 3.35e12
PACKED = ((524288, 1024), (57344, 448), (53248, 416), (4097, 320),
          (777, 480), (1001, 8), (3, 512))                 # rows, m
PACK = ((262144, 2048, 4), (3000, 2160, 5), (5000, 521, 1), (4001, 2032, 4),
        (33, 32768, 64), (17, 2880, 45), (9, 32768, 1), (3, 4096, 8))
ROUTES = ((64, 2048), (64, 4096), (8, 4320), (8, 4064), (32, 896),
          (32, 832), (32, 640), (32, 1042), (8, 8192), (4, 16384),
          (16, 1025), (3, 2062), (5, 1280))                # rows, n


def ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    t0 = time.time()
    print("build", _build.build(["stage"]), time.time() - t0, flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)

    def cr(M, k):
        return torch.complex(torch.randn((M, k), generator=g, device=dev),
                             torch.randn((M, k), generator=g, device=dev))

    for M, m in PACKED:
        n = 2 * m
        c = cr(M, m + 1)
        got = hf.irdft_packed(c, n)
        torch.cuda.synchronize()
        row = dict(body="packed", M=M, m=m, entries=dict(hf.ENTRIES),
                   vs_plain=rel(got, hf.c2r_packed_plain(c, n)),
                   vs_irfft=rel(got, torch.fft.irfft(c, n, norm="forward")))
        if M > 10000:
            row.update(ms=ms(lambda: hf.irdft_packed(c, n)),
                       irfft_ms=ms(lambda: torch.fft.irfft(
                           c, n, norm="forward")),
                       bound_ms=1e3 * M * (8 * (m + 1) + 4 * n) / HBM)
        print(json.dumps(row), flush=True)
        hf.reset_launches()
        del c, got
    for M, m, n1 in PACK:
        c = cr(M, m + 1)
        got = hf.c2r_pack(c, n1)
        torch.cuda.synchronize()
        row = dict(body="pack", M=M, m=m, n1=n1,
                   vs_plain=rel(got, hf.c2r_pack_plain(c, n1)))
        if M > 10000:
            row.update(ms=ms(lambda: hf.c2r_pack(c, n1)),
                       bound_ms=1e3 * M * (8 * (m + 1) + 8 * m) / HBM)
        print(json.dumps(row), flush=True)
        del c, got
    for M, n in ROUTES:
        c = cr(M, n // 2 + 1)
        hf.reset_launches()
        got = hf.irfft(c, n, axis=-1)
        torch.cuda.synchronize()
        print(json.dumps(dict(
            route="irfft", M=M, n=n, entries=dict(hf.ENTRIES),
            matmul=hf.DISPATCHES["matmul"],
            vs_irfft=rel(got, torch.fft.irfft(c, n, norm="forward")))),
            flush=True)
    for M, n in ((262144, 4096), (524288, 2048)):
        c = cr(M, n // 2 + 1)
        print(json.dumps(dict(
            route=f"irfft_{n}_rows", ms=ms(lambda: hf.irfft(c, n, axis=-1)),
            irfft_ms=ms(lambda: torch.fft.irfft(c, n, norm="forward")))),
            flush=True)
        del c
    return 0


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("c2r_probe: no CUDA device available")
    sys.exit(main())
