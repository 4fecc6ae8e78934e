"""Roofline model of the port on an NVIDIA H100 — the JAX package's
``evalkit/roofline.py`` with the card's peaks in place of its chip's.

Peaks (NVIDIA's H100 SXM data sheet, 700 W; ``PERF.md`` §2): 67 TFLOP/s
float32 on the CUDA cores, 989 TFLOP/s bfloat16 on the tensor cores
(dense), 3.35 TB/s of HBM3.

**The bound of a transform** (every backend but the matmul family, and
every hand-written kernel, ``chip_smoke.py``'s ``bound``): the larger of
the FFT-nominal work — 5 n log2 n flop a complex row of n points, half
that with real input or output (:func:`fft_flops`) — over 67 TFLOP/s,
and the bytes the function must move — each input read once, each
output written once — over 3.35 TB/s (:func:`bound`). For a whole plan
(:func:`ideal_time_ms`) the bytes are one read of the input and one
write of the output a direction, float32 (complex64 spectra).

**The matmul backend** (``"matmul"`` / ``"matmul-r2"``,
``ops/mxu_fft.py``): the model counts the multiply-adds the backend
ACTUALLY issues, mirroring its dispatch (direct vs four-step vs
radix-2, the R2C/C2R real-product fast paths, a complex product as 4
real products, or 3 in Karatsuba form: the two counts bracket the
truth), at the effective peak of what the backend issues at each
``MXUSettings.precision`` in float32 (:func:`effective_peak_tflops`):

* ``DEFAULT`` — one bfloat16 pass: ``torch.mm(..., out_dtype=float32)``
  on the tensor cores, 989 TFLOP/s;
* ``HIGH`` (the default) — three bfloat16 passes (``hi Fhi + hi Flo +
  lo Fhi``) on the tensor cores, 989 / 3 TFLOP/s;
* ``HIGHEST`` — IEEE float32 products (TF32 off) on the CUDA cores, 67
  TFLOP/s.

Where ``torch.mm`` takes no ``out_dtype`` the bfloat16 passes run as
float32 products of the rounded operands (``mxu_fft.MM16_ROUTE``), on
the CUDA cores: the model's ``DEFAULT`` / ``HIGH`` peaks are then
optimistic. The multiply-add counts are the JAX package's, from the
port's own constants (``DIRECT_MAX``, ``_R2_BASE``, ``_split_for``).

DEFAULT-SETTINGS ASSUMPTION: two non-default toggles change the
products issued — ``karatsuba=True`` and ``fourstep_einsum=True`` —
and neither is recorded in a measured CSV, so ``_BACKENDS`` maps only
default-settings backend labels.

The port ships no measured CSV: ``dfft-torch-roofline --csv PATH`` renders
a table of one (``size,transform,backend,per_iter_ms,gflops,chain_k,
measured`` rows, as ``chip_smoke.py`` writes them from its chain-timed
runs on the card).
"""

from __future__ import annotations

import math
import re
from typing import Optional, Tuple

from ..ops.bluestein import chirp_length, is_smooth
from ..ops.mxu_fft import DIRECT_MAX, _R2_BASE, _split_for

# NVIDIA H100 SXM data sheet (700 W).
H100_FP32_TFLOPS = 67.0
H100_BF16_TFLOPS = 989.0
H100_HBM_TBPS = 3.35
FP32_FLOPS = H100_FP32_TFLOPS * 1e12
BF16_FLOPS = H100_BF16_TFLOPS * 1e12
HBM_BYTES = H100_HBM_TBPS * 1e12

# (bfloat16 tensor-core passes, or None for float32 on the CUDA cores) of
# one float32 product at each precision.
_PREC_PASSES = {"default": 1, "high": 3, "highest": None}


def effective_peak_tflops(precision: str = "high") -> float:
    """The matmul backend's effective float32 peak at ``precision`` (the
    module docstring's mapping)."""
    passes = _PREC_PASSES[precision]
    if passes is None:
        return H100_FP32_TFLOPS
    return H100_BF16_TFLOPS / passes


def fft_flops(rows: int, n: int, real: bool = False) -> float:
    """The FFT-nominal work of ``rows`` rows of n points: 5 n log2 n flop a
    complex row, 2.5 n log2 n with real input or output."""
    return (2.5 if real else 5.0) * rows * n * math.log2(n)


def bound(flops: float, nbytes: float, rate: float = FP32_FLOPS):
    """``(bound ms, "operations" | "bytes")``: the least time the card
    could take for ``flops`` at ``rate`` flop/s and ``nbytes`` at the HBM
    rate."""
    t_ops, t_bytes = flops / rate, nbytes / HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


# ---------------------------------------------------------------------------
# Per-element multiply-add counts, mirroring ops/mxu_fft.py dispatch
# ---------------------------------------------------------------------------


def macs_c2c_axis(n: int, direct_max: int = DIRECT_MAX, *,
                  radix2: bool = False, complex_mults: int = 4) -> float:
    """Multiply-adds per element for one C2C pass along an axis of length
    ``n`` (``_fft_last``): direct = one complex product lowered to
    ``complex_mults`` real depth-n products; four-step recurses on both
    factors; radix-2 DIF halves the depth per level down to ``_R2_BASE``
    = 128 (butterflies and twiddles are elementwise work, not products).
    ``complex_mults`` 4 is the textbook complex product, 3 its Karatsuba
    form: the two bracket the truth."""
    if radix2 and n > _R2_BASE and n % 2 == 0:
        return macs_c2c_axis(n // 2, direct_max, radix2=radix2,
                             complex_mults=complex_mults)
    if n <= direct_max:
        return float(complex_mults) * n
    n1, n2 = _split_for(n, direct_max)
    if n1 == 1:
        return float(complex_mults) * n
    return (macs_c2c_axis(n2, direct_max, radix2=radix2,
                          complex_mults=complex_mults)
            + macs_c2c_axis(n1, direct_max, radix2=radix2,
                            complex_mults=complex_mults))


def macs_r2c_axis(n: int, direct_max: int = DIRECT_MAX, *,
                  complex_mults: int = 4) -> float:
    """Multiply-adds per INPUT element for the R2C first pass
    (``_rfft_last``): direct = 2 real n -> n_out products; four-step = a
    real depth-n2 pair + a complex depth-n1 pass on the FULL volume (the
    crop to n_out follows the transform)."""
    n_out = n // 2 + 1
    if n <= direct_max:
        return 2.0 * n_out
    n1, n2 = _split_for(n, direct_max)
    if n1 == 1:
        return 2.0 * n_out
    return 2.0 * n2 + macs_c2c_axis(n1, direct_max,
                                    complex_mults=complex_mults)


def macs_c2r_axis(n: int, direct_max: int = DIRECT_MAX, *,
                  radix2: bool = False, complex_mults: int = 4) -> float:
    """Multiply-adds per OUTPUT element for the C2R last pass (``irfft``):
    direct = 2 real depth-n_out products with the conjugate symmetry
    folded in; past ``direct_max`` the Hermitian extension's full complex
    inverse (the ``_fft_last`` cost, radix-2 setting included)."""
    n_out = n // 2 + 1
    if n <= direct_max:
        return 2.0 * n_out
    return macs_c2c_axis(n, direct_max, radix2=radix2,
                         complex_mults=complex_mults)


# ---------------------------------------------------------------------------
# Bluestein (chirp-z): non-smooth axes
# ---------------------------------------------------------------------------


def nominal_flops_axis(n: int) -> float:
    """Textbook per-element flops of ONE smooth-length-n axis pass
    (2.5 log2 n per element, the CSVs' nominal convention)."""
    return 2.5 * math.log2(float(n))


def bluestein_flops_axis(n: int) -> float:
    """Per-element flops one chirp-z pass of a non-smooth length-n axis
    needs: two length-m smooth FFTs amortized over n elements (the kernel
    spectrum is precomputed) plus three complex multiplies per element."""
    m = chirp_length(n)
    return 2.0 * 2.5 * m * math.log2(float(m)) / float(n) + 3.0 * 6.0


def bluestein_axis_report(n: int) -> Tuple[int, float]:
    """(padded chirp length m, flop overhead factor against a smooth axis
    of the same length); smooth lengths report (n, 1.0)."""
    if is_smooth(n):
        return n, 1.0
    return chirp_length(n), bluestein_flops_axis(n) / nominal_flops_axis(n)


def nonsmooth_axes(shape) -> list:
    """The distinct non-5-smooth axis lengths of a shape (sorted)."""
    return sorted({int(n) for n in shape if not is_smooth(int(n))})


# ---------------------------------------------------------------------------
# Whole-workload product flops (2 flops per multiply-add)
# ---------------------------------------------------------------------------


def mxu_flops_roundtrip_3d(n: int, direct_max: int = DIRECT_MAX,
                           radix2: bool = False,
                           complex_mults: int = 4) -> float:
    """Product flops the matmul backend executes for one R2C+C2R roundtrip
    of an ``n^3`` float32 cube: the z R2C pass on the full cube, two C2C
    passes each way on the halved volume, the z C2R pass back. Radix-2
    applies to the C2C stages only."""
    n_out = n // 2 + 1
    v_half = n * n * n_out
    macs = (n ** 3 * macs_r2c_axis(n, direct_max,
                                   complex_mults=complex_mults)
            + 4 * v_half * macs_c2c_axis(n, direct_max, radix2=radix2,
                                         complex_mults=complex_mults)
            + n ** 3 * macs_c2r_axis(n, direct_max, radix2=radix2,
                                     complex_mults=complex_mults))
    return 2.0 * macs


def mxu_flops_batched2d(batch: int, m: int, direct_max: int = DIRECT_MAX,
                        complex_mults: int = 4,
                        radix2: bool = False) -> float:
    """Product flops for one batched-2D R2C+C2R roundtrip of ``batch``
    m x m planes: per plane, an R2C pass over m rows, one C2C pass each
    way on the halved plane, and a C2R pass back."""
    m_out = m // 2 + 1
    v_half = m * m_out
    macs_plane = (m * m * macs_r2c_axis(m, direct_max,
                                        complex_mults=complex_mults)
                  + 2 * v_half * macs_c2c_axis(m, direct_max, radix2=radix2,
                                               complex_mults=complex_mults)
                  + m * m * macs_c2r_axis(m, direct_max, radix2=radix2,
                                          complex_mults=complex_mults))
    return 2.0 * batch * macs_plane


# ---------------------------------------------------------------------------
# roofline_fraction: a measured row against the model
# ---------------------------------------------------------------------------
#
# ``roofline_fraction = ideal_ms / measured_ms``: the fraction of the
# model's time a measured row achieved, divided over the devices for
# distributed rows (the exchange is deliberately NOT in the model, so
# communication shows up as lost fraction).


def _parse_size(shape):
    """Normalize a workload size to ``("cube", n)`` / ``("b2d", (b, m))``
    or None: an int (cube edge), a ``"256^3"`` / ``"4096^2x64"`` string (a
    trailing ``:inverse``-style mode tag is ignored), or a shape tuple —
    (n, n, n) cubes and (b, m, m) batched planes."""
    if isinstance(shape, str):
        s = shape.split(":")[0]
        m = re.fullmatch(r"(\d+)(\^3)?", s)
        if m:
            return "cube", int(m.group(1))
        m = re.fullmatch(r"(\d+)\^2x(\d+)", s)
        if m:
            return "b2d", (int(m.group(2)), int(m.group(1)))
        return None
    if isinstance(shape, int):
        return "cube", int(shape)
    t = tuple(int(v) for v in shape)
    if len(t) == 3 and t[0] == t[1] == t[2]:
        return "cube", t[0]
    if len(t) == 3 and t[1] == t[2]:
        return "b2d", (t[0], t[1])
    return None


def _backend_model(backend: str):
    """(counts products, precision, radix2) for a backend label — bare
    names ("matmul") and CSV forms ("matmul@high") both resolve; other
    backends take the nominal rule."""
    base = str(backend).split()[0]
    name, _, prec = base.partition("@")
    if name in ("matmul", "matmul-planes"):
        return True, (prec or "high"), False
    if name == "matmul-r2":
        return True, (prec or "high"), True
    return False, "high", False


def _roundtrip_bytes(kind: str, dims) -> float:
    """One read of the float32 input and one write of the complex64
    output, each way (forward and inverse)."""
    if kind == "cube":
        n = dims
        real, half = n ** 3, n * n * (n // 2 + 1)
    else:
        b, m = dims
        real, half = b * m * m, b * m * (m // 2 + 1)
    return 2.0 * (4 * real + 8 * half)


def _ideal(shape, backend: str, devices: int, mode: str,
           direct_max: "Optional[int]"):
    """(ideal ms, what bounds it) or None."""
    parsed = _parse_size(shape)
    if parsed is None or devices < 1:
        return None
    kind, dims = parsed
    mxu, precision, r2 = _backend_model(backend)
    dmax = DIRECT_MAX if direct_max is None else int(direct_max)
    share = (1.0 if mode == "roundtrip" else 0.5) / float(devices)
    if mxu:
        flops = (mxu_flops_roundtrip_3d(dims, dmax, radix2=r2)
                 if kind == "cube"
                 else mxu_flops_batched2d(dims[0], dims[1], dmax,
                                          radix2=r2))
        peak = effective_peak_tflops(precision) * 1e12
        return 1e3 * flops * share / peak, "operations"
    from ..testing.workloads import flops_batched2d, flops_roundtrip_3d
    flops = (flops_roundtrip_3d(dims) if kind == "cube"
             else flops_batched2d(dims[0], dims[1], dims[1]))
    return bound(flops * share, _roundtrip_bytes(kind, dims) * share)


def ideal_time_ms(shape, backend: str, *, devices: int = 1,
                  mode: str = "roundtrip",
                  direct_max: "Optional[int]" = None) -> Optional[float]:
    """The least time ``mode`` of this workload could take on the card:
    the matmul family's counted products at its effective peak, the
    module's bound rule for every other backend. None when the shape is
    outside the model (non-cube / non-square-batched). ``devices``
    divides the work; ``direct_max`` overrides the direct threshold (a
    ``direct(N)`` plan note)."""
    got = _ideal(shape, backend, devices, mode, direct_max)
    return None if got is None else got[0]


def _mesh_devices(mesh) -> int:
    """Device count of None (one card), an int, or a plan-like object with
    ``partition.num_ranks``."""
    if mesh is None:
        return 1
    if isinstance(mesh, int):
        return max(1, mesh)
    part = getattr(mesh, "partition", None)
    return int(getattr(part, "num_ranks", 1)) if part is not None else 1


def roofline_row(measured_ms: float, shape, backend: str, mesh=None, *,
                 mode: str = "roundtrip",
                 direct_max: "Optional[int]" = None) -> Optional[dict]:
    """The roofline record of one measured row: the model's ideal time,
    the achieved ``roofline_fraction``, which model produced it and what
    bounds it. None when unmodelable (bad shape / degenerate time)."""
    if not measured_ms or measured_ms <= 0:
        return None
    devices = _mesh_devices(mesh)
    got = _ideal(shape, backend, devices, mode, direct_max)
    if got is None:
        return None
    ideal, by = got
    mxu, precision, _ = _backend_model(backend)
    return {
        "ideal_ms": float(f"{ideal:.4g}"),
        "roofline_fraction": float(f"{ideal / measured_ms:.4g}"),
        "model": (f"matmul-4mm@{precision}" if mxu else "nominal+bytes"),
        "bound_by": by,
        "mode": mode,
        "devices": devices,
    }


def roofline_fraction(measured_ms: float, shape, backend: str,
                      mesh=None, *, mode: str = "roundtrip",
                      direct_max: "Optional[int]" = None
                      ) -> Optional[float]:
    """``ideal_time_ms / measured_ms`` of a measurement."""
    row = roofline_row(measured_ms, shape, backend, mesh, mode=mode,
                       direct_max=direct_max)
    return None if row is None else row["roofline_fraction"]


def tracked_fractions(path: Optional[str] = None) -> dict:
    """The ``"roofline"`` rows (row key -> record) of the JSON file at
    ``path``, or {} without one (the port commits no such file)."""
    import json
    if not path:
        return {}
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        rows = data.get("roofline", {}).get("rows", {})
        return rows if isinstance(rows, dict) else {}
    except (OSError, ValueError):
        return {}


# ---------------------------------------------------------------------------
# Roofline table from a measured CSV
# ---------------------------------------------------------------------------

# backend label -> (precision, radix2). "matmul-planes" issues the same
# products on split (re, im) planes; "xla" (cuFFT) and "pallas" (the
# kernels) are no dense-product pipelines: their rows are skipped here
# (the bound rule covers them).
_BACKENDS = {
    "matmul@high": ("high", False),
    "matmul@highest": ("highest", False),
    "matmul-r2@high": ("high", True),
    "matmul-planes": ("high", False),
}

# Plan suffix on the backend column: direct(N) -> direct_max = N;
# four-step(AxB) -> direct_max = max(A, B); ck=N / chunked re-order work
# without changing the products -> no override.
_SUFFIX_DIRECT = re.compile(r"direct\((\d+)\)")
_SUFFIX_FOURSTEP = re.compile(r"four-step\((\d+)x(\d+)\)")


def _parse_backend(label: str):
    """Split a CSV backend label into (base, direct_max override or None).
    Returns ``None`` for labels whose products the model cannot count."""
    parts = label.split()
    if not parts or parts[0] not in _BACKENDS:
        return None
    base = parts[0]
    dmax = None
    for tok in parts[1:]:
        m = _SUFFIX_DIRECT.fullmatch(tok)
        if m:
            dmax = int(m.group(1))
            continue
        m = _SUFFIX_FOURSTEP.fullmatch(tok)
        if m:
            dmax = max(int(m.group(1)), int(m.group(2)))
            continue
        if tok.startswith("ck=") or tok == "chunked":
            continue
        return None  # unknown suffix: skip the row rather than miscount
    return base, dmax


CSV_HEADER = "size,transform,backend,per_iter_ms,gflops,chain_k,measured"


def roofline_rows(csv_path: str) -> list:
    """Parse a measured CSV (``CSV_HEADER``) and return a roofline dict for
    every roundtrip row whose backend has an exact product count."""
    out = []
    with open(csv_path) as f:
        header = f.readline().strip().split(",")
        idx = {k: i for i, k in enumerate(header)}
        for line in f:
            parts = line.rstrip("\n").split(",")
            if len(parts) < 5:
                continue
            size, transform = parts[idx["size"]], parts[idx["transform"]]
            backend = parts[idx["backend"]]
            per_ms = float(parts[idx["per_iter_ms"]])
            nominal = float(parts[idx["gflops"]])
            parsed = _parse_backend(backend)
            if parsed is None or "roundtrip" not in transform:
                continue
            base, dmax_override = parsed
            precision, r2 = _BACKENDS[base]
            dmax = DIRECT_MAX if dmax_override is None else dmax_override
            m_cube = re.fullmatch(r"(\d+)\^3", size)
            m_b2d = re.fullmatch(r"(\d+)\^2x(\d+)", size)
            if m_cube:
                n = int(m_cube.group(1))
                f4 = mxu_flops_roundtrip_3d(n, dmax, radix2=r2)
                f3 = mxu_flops_roundtrip_3d(n, dmax, radix2=r2,
                                            complex_mults=3)
            elif m_b2d:
                m, b = int(m_b2d.group(1)), int(m_b2d.group(2))
                f4 = mxu_flops_batched2d(b, m, dmax, radix2=r2)
                f3 = mxu_flops_batched2d(b, m, dmax, complex_mults=3,
                                         radix2=r2)
            else:
                continue
            peak = effective_peak_tflops(precision)
            t4 = f4 / (per_ms * 1e-3) / 1e12
            t3 = f3 / (per_ms * 1e-3) / 1e12
            out.append({
                "size": size, "backend": backend,
                "per_iter_ms": per_ms, "nominal_gflops": nominal,
                "tflops_4mm": round(t4, 1),
                "tflops_3mm": round(t3, 1),
                "peak_tflops": round(peak, 1),
                "util_4mm": round(t4 / peak, 3),
                "util_3mm": round(t3 / peak, 3),
            })
    return out


def render_markdown(rows, path: Optional[str] = None) -> str:
    lines = [
        "# Matmul-backend roofline (NVIDIA H100)",
        "",
        "Measured roundtrip rows, with the product flops the matmul",
        "backend ACTUALLY executes (counted by `evalkit/roofline.py`,",
        "mirroring `ops/mxu_fft.py` dispatch) against the H100's effective",
        f"float32 peak: `DEFAULT` one bfloat16 pass "
        f"({effective_peak_tflops('default'):.1f} TFLOP/s), `HIGH` three",
        f"({effective_peak_tflops('high'):.1f}), `HIGHEST` IEEE float32 on",
        f"the CUDA cores ({effective_peak_tflops('highest'):.1f}).",
        "",
        "| size | backend | ms/iter | nominal GFLOPS | TFLOPS "
        "(3mm-4mm) | eff. peak | utilization (3mm-4mm) |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['size']} | {r['backend']} | {r['per_iter_ms']:.4f} | "
            f"{r['nominal_gflops']:.1f} | "
            f"{r['tflops_3mm']:.1f}-{r['tflops_4mm']:.1f} | "
            f"{r['peak_tflops']:.1f} | "
            f"{100 * r['util_3mm']:.1f}-{100 * r['util_4mm']:.1f}% |")
    lines += [
        "",
        "The two bounds bracket the complex product: `4mm` = four real",
        "products, `3mm` = the Karatsuba form (R2C/C2R passes are exact in",
        "both: explicit real-product pairs). NOMINAL GFLOPS (2.5 N log2 N)",
        "falls with size because the backend spends O(n) multiply-adds an",
        "element an axis where an FFT spends O(log n).",
    ]
    text = "\n".join(lines) + "\n"
    if path:
        with open(path, "w") as f:
            f.write(text)
    return text


def main(argv=None) -> int:
    import argparse
    import os
    ap = argparse.ArgumentParser(
        "dfft-torch-roofline", description="Render the matmul-backend "
        "roofline table (H100 peaks) from a measured CSV.")
    ap.add_argument("--csv", required=True,
                    help=f"measured rows ({CSV_HEADER})")
    ap.add_argument("--out", default=None,
                    help="write markdown here (default: print)")
    a = ap.parse_args(argv)
    if not os.path.exists(a.csv):
        ap.error(f"measurement CSV not found: {a.csv}")
    text = render_markdown(roofline_rows(a.csv), a.out)
    if not a.out:
        print(text, end="")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
