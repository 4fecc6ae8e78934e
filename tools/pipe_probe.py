#!/usr/bin/env python3
"""Time a numpy array's round trip through a duplex ``multiprocessing``
pipe (a Unix socket pair), as the serving fleet sends requests and
replies, with the sockets' default buffers and with the fleet's
``PIPE_BUFFER_BYTES``.

    python3 tools/pipe_probe.py [MiB ...]     # default: 64

Prints one JSON line per (size, buffer): the median of three round trips
in ms and the one-way rate it implies, beside the host's memcpy rate and,
where ``nvidia-smi`` answers, the card's name and power limit.
"""

import json
import multiprocessing as mp
import os
import statistics
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _echo(conn):
    while True:
        try:
            msg = conn.recv()
        except EOFError:
            return
        conn.send(msg)


def round_trip_ms(x, buffer_bytes=None, reps=3):
    from distributedfft_tpu_torch.serve import fleet
    ctx = mp.get_context("spawn")
    a, b = ctx.Pipe(duplex=True)
    if buffer_bytes is not None:
        fleet._size_pipe(a, b)
    p = ctx.Process(target=_echo, args=(b,), daemon=True)
    p.start()
    times = []
    try:
        for _ in range(reps):
            t0 = time.perf_counter()
            a.send(x)
            a.recv()
            times.append((time.perf_counter() - t0) * 1e3)
    finally:
        a.close()
        p.join(10)
    return statistics.median(times)


def main(argv) -> int:
    from distributedfft_tpu_torch.serve import fleet
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except OSError:
        card = None
    sizes = [int(a) for a in argv] or [64]
    for mib in sizes:
        x = np.zeros(mib << 18, np.float32)
        t0 = time.perf_counter()
        x.copy()
        memcpy_gbps = x.nbytes / (time.perf_counter() - t0) / 1e9
        for buf in (None, fleet.PIPE_BUFFER_BYTES):
            ms = round_trip_ms(x, buf)
            print(json.dumps({"mib": mib, "socket_buffer": buf or "default",
                              "round_trip_ms": ms,
                              "one_way_mb_s": 2 * x.nbytes / ms / 1e3,
                              "memcpy_gb_s": memcpy_gbps, "card": card}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
