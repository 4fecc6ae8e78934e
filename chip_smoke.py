#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
It builds the port's CUDA kernels from the checkout, holds each kernel
against its plain PyTorch version at the main path's shapes, runs the
single-card slab plan at 512^3 under ``Config(fft_backend="pallas")``
(``exec_r2c`` then ``exec_c2r``), checks the result against ``torch.fft``
and the roundtrip against the input, shows from the launch counts that the
plan went through every kernel, and times each kernel, its plain version,
the same function through ``torch.fft``, and both plans.

Phases print JSON lines. Before the last line come one ``{"kernels": ...}``
line and the card's name and power limit as ``nvidia-smi`` gives them; the
last line is ``{"ok": true, "device": {...}}``. Any failed phase raises, so
the script exits non-zero with no result line; so does a machine without a
CUDA device, or a directory without the port.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 20261016
N = 512            # the cube: the largest size on the fused single-card path
TOL = 5e-4         # max relative error, the JAX package's per-stage bound
SMALL = (6, 12, 15)
REPS = 10
WARMUP = 2
# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3 rate.
FP32_FLOPS = 67e12
HBM_BYTES = 3.35e12


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def rel_err(got, ref):
    """(max abs error, max abs error relative to max |ref|)."""
    abs_err = float((got - ref).abs().max())
    return abs_err, abs_err / max(float(ref.abs().max()), 1e-30)


def median_ms(torch, fn) -> float:
    """Median over REPS runs of fn's device time (CUDA events), after
    WARMUP runs."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    try:
        import distributedfft_tpu_torch as dft
        from distributedfft_tpu_torch.ops import _build
        from distributedfft_tpu_torch.ops import hopper_fft as hf
    except ImportError as err:
        print(f"chip_smoke: the port is not importable ({err}); run from the "
              "root of a checkout", file=sys.stderr)
        return 1

    # -- 1. device -----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    emit(phase="device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=card,
         torch=torch.__version__, cuda=torch.version.cuda)

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    per_lib = _build.build(sources)
    emit(phase="build", sources=sources, seconds=time.perf_counter() - t0,
         per_library_s=per_lib)

    # -- 3. each kernel against its plain version at the 512^3 shapes -------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    Zo = N // 2 + 1

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32)

    x = randn(N, N, N)
    pr, pi = randn(N, N, Zo), randn(N, N, Zo)
    fzr, fzi = hf._planes("rdft", N, False, dev)
    fyr, fyi = hf._planes("dft", N, False, dev)
    fxr, fxi = hf._planes("dft", N, True, dev)
    fyir, fyii = hf._planes("dft", N, True, dev)
    cr, ci = hf._planes("c2r", N, False, dev)
    pc = torch.complex(pr, pi)
    X = Y = Z = N
    kernels = [
        dict(name="zy_fwd", replaces="distributedfft_tpu/ops/pallas_fft.py:427",
             run=lambda: hf.zy_fwd(x),
             plain=lambda: hf.zy_fwd_plain(x, fzr, fzi, fyr, fyi),
             library=lambda: torch.fft.rfft2(x),
             flops=4 * X * Y * Z * Zo + 8 * X * Y * Y * Zo,
             bytes=4 * (X * Y * Z + 2 * Z * Zo + 2 * Y * Y + 2 * X * Y * Zo)),
        dict(name="x_c2c", replaces="distributedfft_tpu/ops/pallas_fft.py:443",
             run=lambda: hf.x_c2c(pr, pi, inverse=True),
             plain=lambda: hf.x_c2c_plain(pr, pi, fxr, fxi),
             library=lambda: torch.fft.ifft(pc, dim=0, norm="forward"),
             flops=8 * X * X * Y * Zo,
             bytes=4 * (4 * X * Y * Zo + 2 * X * X)),
        dict(name="yz_inv", replaces="distributedfft_tpu/ops/pallas_fft.py:452",
             run=lambda: hf.yz_inv(pr, pi, Z),
             plain=lambda: hf.yz_inv_plain(pr, pi, fyir, fyii, cr, ci),
             library=lambda: torch.fft.irfft2(pc, s=(Y, Z), norm="forward"),
             flops=8 * X * Y * Y * Zo + 4 * X * Y * Zo * Z,
             bytes=4 * (2 * X * Y * Zo + 2 * Y * Y + 2 * Zo * Z + X * Y * Z)),
    ]
    for k in kernels:
        got, ref = k["run"](), k["plain"]()
        torch.cuda.synchronize()
        if not isinstance(got, tuple):
            got, ref = (got,), (ref,)
        errs = [rel_err(g, r) for g, r in zip(got, ref)]
        k["max_abs_err"] = max(e[0] for e in errs)
        k["max_rel_err"] = max(e[1] for e in errs)
        emit(phase="kernel_check", name=k["name"],
             max_abs_err=k["max_abs_err"], max_rel_err=k["max_rel_err"],
             tol=TOL)
        if not k["max_rel_err"] <= TOL:
            fail(f"kernel {k['name']} disagrees with its plain version: "
                 f"rel {k['max_rel_err']:.3e} > {TOL}")
        del got, ref

    # -- 4. the main path ----------------------------------------------------
    pallas = dft.Config(fft_backend="pallas")
    # A small cube on the card against numpy's float64 transform.
    small = dft.SlabFFTPlan(dft.GlobalSize(*SMALL), dft.SlabPartition(1),
                            pallas)
    xs = torch.randn(SMALL, generator=gen, device=dev, dtype=torch.float32)
    ref_small = torch.from_numpy(np.fft.rfftn(xs.cpu().double().numpy()))
    _, small_rel = rel_err(small.exec_r2c(xs).cpu().to(torch.complex128),
                           ref_small)
    emit(phase="small_vs_numpy", shape=list(SMALL), max_rel_err=small_rel)
    if not small_rel <= TOL:
        fail(f"{SMALL} forward disagrees with numpy: rel {small_rel:.3e}")

    plan = dft.SlabFFTPlan(dft.GlobalSize(N, N, N), dft.SlabPartition(1),
                           pallas)
    hf.reset_launches()
    c = plan.exec_r2c(x)
    torch.cuda.synchronize()
    fwd = dict(hf.LAUNCHES)
    back = plan.exec_c2r(c)
    torch.cuda.synchronize()
    launches = dict(hf.LAUNCHES)
    inv = {k: launches[k] - fwd[k] for k in launches}
    emit(phase="main_path", launches_forward=fwd, launches_inverse=inv)
    if fwd != {"zy_fwd": 1, "x_c2c": 1, "yz_inv": 0} or \
            inv != {"zy_fwd": 0, "x_c2c": 1, "yz_inv": 1}:
        fail(f"main path did not launch each kernel as expected: forward "
             f"{fwd}, inverse {inv}")
    if tuple(c.shape) != (N, N, Zo) or c.dtype != torch.complex64 or \
            tuple(back.shape) != (N, N, N) or back.dtype != torch.float32:
        fail(f"unexpected outputs {tuple(c.shape)} {c.dtype}, "
             f"{tuple(back.shape)} {back.dtype}")
    if not (bool(torch.isfinite(c).all()) and bool(torch.isfinite(back).all())):
        fail("non-finite values on the main path")
    _, fwd_rel = rel_err(c, torch.fft.rfftn(x))
    _, rt_rel = rel_err(back / float(N ** 3), x)
    emit(phase="main_path_check", forward_vs_torch_fft=fwd_rel,
         roundtrip_vs_input=rt_rel, tol=TOL)
    if not (fwd_rel <= TOL and rt_rel <= TOL):
        fail(f"main path wrong: forward rel {fwd_rel:.3e}, roundtrip rel "
             f"{rt_rel:.3e} (tol {TOL})")
    del c, back

    # -- 5. timing -----------------------------------------------------------
    for k in kernels:
        k["kernel_ms"] = median_ms(torch, k["run"])
        k["plain_ms"] = median_ms(torch, k["plain"])
        k["library_ms"] = median_ms(torch, k["library"])
        t_ops, t_bytes = k["flops"] / FP32_FLOPS, k["bytes"] / HBM_BYTES
        k["bound_ms"] = 1e3 * max(t_ops, t_bytes)
        k["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        emit(phase="kernel_time", name=k["name"], kernel_ms=k["kernel_ms"],
             plain_ms=k["plain_ms"], library_ms=k["library_ms"],
             bound_ms=k["bound_ms"])
    xla = dft.SlabFFTPlan(dft.GlobalSize(N, N, N), dft.SlabPartition(1),
                          dft.Config())
    cp, cx = plan.exec_r2c(x), xla.exec_r2c(x)
    emit(phase="plan_time", shape=[N, N, N],
         pallas_forward_ms=median_ms(torch, lambda: plan.exec_r2c(x)),
         pallas_inverse_ms=median_ms(torch, lambda: plan.exec_c2r(cp)),
         xla_forward_ms=median_ms(torch, lambda: xla.exec_r2c(x)),
         xla_inverse_ms=median_ms(torch, lambda: xla.exec_c2r(cx)))

    print(json.dumps({"kernels": [{
        "name": k["name"], "route": "cuda",
        "source": "distributedfft_tpu_torch/csrc/fused3d.cu",
        "replaces": k["replaces"], "launches": launches[k["name"]],
        "max_abs_err": k["max_abs_err"], "max_rel_err": k["max_rel_err"],
        "ms": k["kernel_ms"], "kernel_ms": k["kernel_ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": k["library_ms"],
        "flops": k["flops"], "bytes": k["bytes"]} for k in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
