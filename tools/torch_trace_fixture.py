#!/usr/bin/env python3
"""Write ``tests/data/torch_gpu_trace_fixture.json``: a trimmed
``torch.profiler`` chrome trace of the port's slab plan on a CUDA card,
the committed fixture of ``tests/test_torch_profile.py``.

    python3 tools/torch_trace_fixture.py [OUT]

Run from the root of a checkout on a machine with a CUDA card and nvcc (it
builds the kernels). It captures two forward calls of the 64^3 single-card
slab plan under ``fft_backend="pallas"`` (the fused kernels 6 and 7,
launched through ``ctypes``: no aten op is their parent) with guards in
check mode (aten ops under the guard scope), keeps the events the trace
reader reads (kernels, memcpys and memsets, the runtime calls that
launched them, the ``record_function`` ranges on the host and on the
device, the aten ops), and adds an ``expected`` block computed here by
brute force, independently of ``obs/profile.py``: each device op's
scope is the innermost ``dfft/...`` host range around the runtime call
with its correlation id; the device's busy time is the union of its ops'
intervals; the port's kernels are those whose runtime call no aten op
encloses.
"""

from __future__ import annotations

import json
import os
import re
import sys
import tempfile

KEEP = ("kernel", "gpu_memcpy", "gpu_memset", "cuda_runtime", "cuda_driver",
        "user_annotation", "gpu_user_annotation", "cpu_op")
SCOPE = re.compile(r"dfft/([A-Za-z0-9_.-]+/[A-Za-z0-9_.:-]+)")


def expected(events):
    host = [e for e in events if e.get("cat") == "user_annotation"
            and SCOPE.search(e["name"])]
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    launch, outside = {}, {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            outside[corr] = not any(
                (o["pid"], o["tid"]) == (e["pid"], e["tid"])
                and o["ts"] <= e["ts"]
                and e["ts"] + e["dur"] <= o["ts"] + o["dur"] for o in ops)
            best = None
            for r in host:
                if (r["pid"], r["tid"]) != (e["pid"], e["tid"]):
                    continue
                if r["ts"] <= e["ts"] and \
                        e["ts"] + e["dur"] <= r["ts"] + r["dur"]:
                    if best is None or r["ts"] >= best["ts"]:
                        best = r
            launch[corr] = (SCOPE.findall(best["name"])[-1]
                            if best else None)
    dev = [e for e in events if e.get("cat") in KEEP[:3]]
    scopes, unattributed = {}, 0.0
    for e in dev:
        s = launch.get(e["args"].get("correlation"))
        if s is None:
            unattributed += e["dur"]
        else:
            scopes[s] = scopes.get(s, 0.0) + e["dur"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in dev if e["dur"])
    busy, end = 0.0, None
    for s, t in spans:
        if end is None or s >= end:
            busy, end = busy + t - s, t
        elif t > end:
            busy, end = busy + t - end, t
    port = sum(1 for e in dev if e["cat"] == "kernel" and e["dur"]
               and outside.get(e["args"].get("correlation"), False))
    return {"device_events": len(dev), "port_kernel_events": port,
            "scopes_ms": {k: v / 1e3 for k, v in sorted(scopes.items())},
            "unattributed_ms": unattributed / 1e3, "busy_ms": busy / 1e3}


def main(argv) -> int:
    # Run as a script, this file's directory leads sys.path: put the
    # checkout's root (the port's parent) in front of it.
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch
    from torch.profiler import ProfilerActivity, profile

    import distributedfft_tpu_torch as dft
    if not torch.cuda.is_available():
        print("torch_trace_fixture: needs a CUDA device", file=sys.stderr)
        return 1
    out = argv[1] if len(argv) > 1 else os.path.join(
        "tests", "data", "torch_gpu_trace_fixture.json")
    plan = dft.SlabFFTPlan(dft.GlobalSize(64, 64, 64), dft.SlabPartition(1),
                           dft.Config(fft_backend="pallas", guards="check"))
    x = torch.randn(64, 64, 64, device="cuda")
    plan.exec_r2c(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            plan.exec_r2c(x)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "t.pt.trace.json")
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            trace = json.load(f)
    events = [e for e in trace["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") in KEEP]
    t0 = min(e["ts"] for e in events)
    slim = []
    for e in events:
        args = {k: v for k, v in (e.get("args") or {}).items()
                if k in ("correlation", "device", "stream", "External id")}
        slim.append({"ph": "X", "cat": e["cat"], "name": e["name"],
                     "pid": e["pid"], "tid": e["tid"],
                     "ts": round(float(e["ts"]) - t0, 3),
                     "dur": round(float(e.get("dur", 0)), 3),
                     "args": args})
    doc = {"comment": "Trimmed torch.profiler chrome trace of two forward "
                      "calls of the 64^3 slab plan (fft_backend='pallas', "
                      "guards='check') on "
                      + torch.cuda.get_device_name(0)
                      + ", written by tools/torch_trace_fixture.py; "
                      "'expected' is that script's brute-force reading.",
           "traceEvents": slim, "expected": expected(slim)}
    with open(out, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=0, sort_keys=True)
    print(json.dumps(doc["expected"], sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
