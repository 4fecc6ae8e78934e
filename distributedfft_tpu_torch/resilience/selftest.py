"""``--selftest``: one forward+inverse roundtrip of the plan before the run
— the port's ``resilience/selftest.py``, after the JAX package's.

A misconfigured production run (a broken backend, a lossy wire on data it
cannot represent) burns its whole timed loop before anyone notices.
``--selftest`` (every executable) runs ONE roundtrip of the plan's actual
shape and rendering first and prints a PASS/FAIL line:

* **Parseval** — the forward output's energy against the guard invariant
  (the family's ``guards.GuardSpec``, checked here so the selftest works
  at any ``Config.guards`` mode, "off" included);
* **roundtrip** — max rel error of forward∘inverse against the scaled
  input (testcase 3's identity), on the device with one scalar readback;
* **reference** — max rel error of the forward output against the host's
  ``np.fft`` (testcase 1's truth); only in a world of one rank and at
  most ``--selftest-ref-max`` elements (default 2^21), as the JAX
  package's single-controller rule.

On P > 1 ranks every rank runs the roundtrip on its block, the energies
are summed and the roundtrip's maxima maximized over the plan's group, so
every rank prints the same verdict. FAIL aborts the executable with exit
code 1. Tolerances follow the guard derivation.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .. import obs
from ..parallel import multihost
from . import guards

# Elements above which the host np.fft reference sub-check is skipped.
DEFAULT_REF_MAX = 1 << 21


def _roundtrip_tol(config, crossings: int) -> float:
    """Max rel error a healthy roundtrip may show: backend rounding (1e-4;
    1e-12 in float64) plus the compressed wire's documented per-crossing
    bound over every crossing of the forward+inverse pipeline."""
    tol = 1e-12 if config.double_prec else 1e-4
    if config.wire_dtype != "native":
        tol += 2e-2 * max(2, crossings)
    return tol


def _crossings(plan, dims: int) -> int:
    """Wire crossings of one roundtrip (forward + inverse exchanges)."""
    from ..models.pencil import PencilFFTPlan
    if getattr(plan, "fft3d", False):
        return 0
    if isinstance(plan, PencilFFTPlan):
        return 2 * max(0, dims - 1)
    return 2


def run_selftest(plan, dims: Optional[int] = None, seed: int = 0,
                 ref_max: int = DEFAULT_REF_MAX) -> dict:
    """Run the roundtrip; prints the PASS/FAIL line (every rank) and
    returns ``{"ok", "parseval", "parseval_tol", "roundtrip",
    "roundtrip_tol", "reference" (None when skipped), "checks"}``."""
    from ..models.batched2d import Batched2DFFTPlan
    from ..models.pencil import PencilFFTPlan
    from ..testing import testcases as tc

    obs.metrics.inc("selftest.runs")
    cfg = plan.config
    if dims is None:
        dims = 2 if isinstance(plan, Batched2DFFTPlan) else 3
    with obs.span("selftest", plan=type(plan).__name__,
                  shape=list(plan.global_size.shape), dims=dims):
        rdt = np.float64 if cfg.double_prec else np.float32
        cdt = np.complex128 if cfg.double_prec else np.complex64
        complex_in = getattr(plan, "transform", "r2c") == "c2c"
        rng = np.random.default_rng(seed)
        xh = tc._uniform(rng, plan.input_shape, rdt)
        if complex_in:
            xh = (xh + 1j * tc._uniform(rng, plan.input_shape, rdt)
                  ).astype(cdt)
        x = plan.pad_input(xh)
        fwd, inv = tc._fused_fns(plan, dims)
        spec = fwd(x)
        y = inv(spec)

        checks = {}
        # Parseval: the guard invariant over the global logical regions.
        gspec = plan._guard_spec("forward", dims)
        in_e, out_e = guards.parseval_sums(
            gspec, x, spec, guards.region(plan, "forward", dims)).tolist()
        expected = gspec.scale * in_e
        parseval = abs(out_e - expected) / max(abs(expected), guards._TINY)
        ptol = guards.parseval_tolerance(
            cfg.double_prec, cfg.wire_dtype,
            int(np.prod(gspec.in_logical)))
        checks["parseval"] = (parseval, ptol)

        # Roundtrip vs the scaled input (testcase 3's identity), on the
        # logical region only.
        scale = tc._roundtrip_scale(plan, dims)
        back = guards.region(plan, "inverse", dims)
        yl = guards._slice_logical(y, back.out_slices, plan.input_shape)
        xl = guards._slice_logical(x, back.out_slices, plan.input_shape)
        diff, ref_max_abs = guards._max_pair(yl - xl * scale, xl * scale,
                                             back).tolist()
        roundtrip = diff / ref_max_abs if ref_max_abs else diff
        rtol = _roundtrip_tol(cfg, _crossings(plan, dims))
        checks["roundtrip"] = (roundtrip, rtol)

        # The host's reference (one rank, small enough; the non-batched
        # C2C reference is the full fftn, so partial pencil C2C depths
        # skip it).
        ref = None
        if plan.global_size.n_total <= ref_max and multihost.world()[1] == 1:
            if complex_in and not isinstance(plan, Batched2DFFTPlan):
                if dims == 3:
                    ref = np.fft.fftn(np.asarray(xh, np.complex128))
            else:
                ref = tc.reference_spectrum(plan, xh.astype(np.float64),
                                            dims)
        reference = None
        if ref is not None:
            got = (plan.crop_spectral(spec, dims)
                   if isinstance(plan, PencilFFTPlan)
                   else plan.crop_spectral(spec))
            denom = float(np.abs(ref).max()) or 1.0
            reference = float(np.abs(got - ref.astype(got.dtype)).max()
                              / denom)
            checks["reference"] = (reference, rtol)

        ok = all(v <= tol for v, tol in checks.values())
        detail = "  ".join(f"{k} {v:.3e} (tol {tol:.0e})"
                           for k, (v, tol) in checks.items())
        fp = guards.fingerprint(plan, "roundtrip")
        line = (f"selftest: {'PASS' if ok else 'FAIL'}  {detail}  "
                f"[{fp['plan']} {fp['shape']} {fp['comm']}/{fp['send']}"
                f"/opt{fp['opt']}/{fp['wire']} backend={fp['backend']}]")
        print(line, flush=True)
        if not ok:
            obs.metrics.inc("selftest.failures")
            obs.notice(line, name="selftest.failure", **{
                k: float(v) for k, (v, _) in checks.items()})
        return {"ok": ok, "parseval": parseval, "parseval_tol": ptol,
                "roundtrip": roundtrip, "roundtrip_tol": rtol,
                "reference": reference, "checks": {
                    k: {"value": float(v), "tol": float(t)}
                    for k, (v, t) in checks.items()}}
