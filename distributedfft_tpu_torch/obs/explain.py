"""``dfft-torch-explain`` — resolved-plan diagnostics of the port (the
JAX package's ``dfft-explain``).

After wisdom ("auto" resolution), the ring rendering and the wire layer,
a plan's actual shape — which exchanges it runs, how many bytes cross the
wire, where its config values came from — is decided at construction.
This executable answers "why did the plan do X" for a given config and
shape:

* decomposition: kind, ranks, padded shapes, how each side lies over the
  ranks;
* the per-axis FFT sequence each pipeline stage runs;
* the resolved exchange rendering per transpose (all-to-all, pipelined
  all-to-all, STREAMS, Peer2Peer, ring);
* wire dtype and wire bytes per exchange (``wire_nbytes`` over the exact
  padded payload);
* wisdom provenance: store path, on-disk version, hit/miss per consulted
  slot (lookup only — a miss is REPORTED, never raced);
* resilience posture, the serving key, the checkpoint registry
  (``--checkpoint-dir`` / ``$DFFT_CKPT_DIR``);
* the declared stage graph (``analysis/plangraph.py``) and, for ring
  exchanges, the overlap schedule;
* the collective census and the contract line: **the one place explain
  executes** — one forward execution of the plan, recorded op by op
  (``analysis/opscan.py``) and checked against the plan's contract
  (``analysis/contracts.py``); ``--no-compile`` (the JAX package's name)
  skips it;
* the roofline expectation on an H100 (``evalkit/roofline.py``): the
  FFT-nominal work and the bound rule's ideal, the matmul backend's
  products;
* ``--profile``: the stage profile (``obs/profile.stage_profile``) of
  the forward direction — a second execution, measured.

``--emulate-devices N`` builds the plan on N gloo ranks on the CPU (each
rank builds, rank 0 prints); without it the plan lives on the card.

Examples::

    dfft-torch-explain --kind slab -nx 1024 -ny 1024 -nz 1024 \\
        --fft-backend pallas
    dfft-torch-explain --kind pencil -nx 64 -ny 64 -nz 64 -p1 2 -p2 2 \\
        -snd1 Ring --emulate-devices 4
    dfft-torch-explain --kind batched -nx 512 -ny 512 -nz 16 --shard x \\
        -p 4 -wire bf16 --emulate-devices 4
"""

from __future__ import annotations

import argparse
import sys

from ..analysis.plangraph import _fmt_bytes

MODULE = "distributedfft_tpu_torch.obs.explain"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="dfft-torch-explain", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--kind", choices=("slab", "pencil", "batched"),
                    default="slab", help="plan family to explain")
    ap.add_argument("--input-dim-x", "-nx", type=int, required=True)
    ap.add_argument("--input-dim-y", "-ny", type=int, required=True)
    ap.add_argument("--input-dim-z", "-nz", type=int, required=True,
                    help="(batched: the batch count, like dfft-torch-batched)")
    ap.add_argument("--partitions", "-p", type=int, default=0,
                    help="slab/batched ranks (default: the world size)")
    ap.add_argument("--partition1", "-p1", type=int, default=0,
                    help="pencil grid rows")
    ap.add_argument("--partition2", "-p2", type=int, default=0,
                    help="pencil grid cols")
    ap.add_argument("--sequence", "-s", default="ZY_Then_X",
                    help="slab sequence")
    ap.add_argument("--shard", default="batch", choices=("batch", "x"),
                    help="batched2d decomposed axis")
    ap.add_argument("--fft-dim", "-f", type=int, default=3,
                    choices=(1, 2, 3), help="pencil partial-transform depth")
    ap.add_argument("--comm-method", "-comm", "-comm1", dest="comm_method",
                    default="All2All")
    ap.add_argument("--comm-method2", "-comm2", default=None)
    ap.add_argument("--send-method", "-snd", "-snd1", dest="send_method",
                    default="Sync")
    ap.add_argument("--send-method2", "-snd2", default=None)
    ap.add_argument("--opt", "-o", type=int, default=0, choices=(0, 1))
    ap.add_argument("--streams-chunks", type=int, default=None)
    ap.add_argument("--overlap-depth", default="auto",
                    help="revolving-buffer depth for RingOverlap (2|4|8 or "
                         "'auto'; capped at ranks-1 micro-steps — the "
                         "schedule block reports the effective depth)")
    ap.add_argument("--overlap-subblocks", type=int, default=None,
                    help="split each peer block into this many sub-blocks "
                         "(rings) / pipeline the all-to-all in this many "
                         "chunks (All2All + Sync/MpiType)")
    ap.add_argument("--wire-dtype", "-wire", default="native",
                    choices=("native", "bf16", "auto"))
    ap.add_argument("--wire-error-budget", type=float, default=None)
    ap.add_argument("--fused-wire", action="store_true",
                    help="explain the fused wire-kernel rendering (active "
                         "on Ring/RingOverlap + bf16 wire only)")
    ap.add_argument("--guards", default=None,
                    choices=("off", "check", "enforce"),
                    help="explain the plan's resilience posture under this "
                         "guard mode (default: $DFFT_GUARDS -> off)")
    ap.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                    help="explain the persist/ checkpoint store here "
                         "(default $DFFT_CKPT_DIR): generations, age, "
                         "step, fingerprint-match verdict vs THIS plan")
    ap.add_argument("--checkpoint-policy", default=None,
                    metavar="steps:N[,secs:T][,drain:on|off]",
                    help="resolve the checkpoint cadence shown in the "
                         "checkpoint: section (default $DFFT_CKPT_POLICY)")
    ap.add_argument("--fft-backend", default="xla")
    ap.add_argument("--double_prec", "-d", action="store_true")
    ap.add_argument("--c2c", action="store_true",
                    help="explain the C2C transform instead of R2C")
    ap.add_argument("--wisdom", default=None, metavar="PATH")
    ap.add_argument("--no-wisdom", action="store_true")
    ap.add_argument("--emulate-devices", type=int, default=0,
                    help="build the plan on N gloo ranks on the CPU (0 = "
                         "the card)")
    ap.add_argument("--no-compile", action="store_true",
                    help="skip the recorded forward execution (the "
                         "collective census and the contract line; "
                         "everything else is bookkeeping)")
    ap.add_argument("--obs", action="store_true",
                    help="print the obs metrics snapshot after the report")
    ap.add_argument("--obs-dir", default=None,
                    help="write the obs event log here (same as "
                         "$DFFT_OBS_DIR)")
    ap.add_argument("--profile", action="store_true",
                    help="measure a stage-attributed profile: run the "
                         "forward plan under torch.profiler and join its "
                         "device time onto the declared plan graph "
                         "(obs/profile.py)")
    ap.add_argument("--profile-iters", type=int, default=3,
                    help="profiled iterations for --profile (default 3; "
                         "one warmup run precedes the captured window)")
    return ap


def _rendering(comm, send, opt, p: int, fused_wire: bool = False,
               depth: int = 2, subblocks: int = 1) -> str:
    """One-line resolved rendering of a single transpose: the JAX
    package's classification (up to the first " — "), then what the
    port's rendering calls (``parallel/transpose.py``)."""
    from .. import params as pm
    sub = (f", each peer block split into {subblocks} sub-blocks"
           if subblocks > 1 else "")
    steps = f"{p - 1} distinct point-to-point step" + ("s" if p > 2 else "")
    if send is pm.SendMethod.RING_OVERLAP:
        fused = (", fused wire kernels (encode-pack / decode+FFT)"
                 if fused_wire else "")
        micro = max(0, p - 1) * max(1, subblocks)
        buffers = min(depth, micro) if micro else 0
        if depth == 2 and subblocks == 1:
            return (f"ring-overlap — {steps} (batch_isend_irecv) on the "
                    "DOUBLE-BUFFERED schedule (step t+1's transfer posted "
                    "before block t's FFT; bit-identical to Ring, "
                    f"reordered issue{fused})")
        cap = (f" — depth {depth} capped at {buffers} by the "
               f"{micro}-micro-step schedule" if buffers < depth else "")
        return (f"ring-overlap — {steps} (batch_isend_irecv) on the "
                f"depth-{depth} REVOLVING-BUFFER schedule ({buffers} "
                f"receive buffer{'s' if buffers != 1 else ''} in flight"
                f"{cap}{sub}; bit-identical to Ring, reordered "
                f"issue{fused})")
    if send is pm.SendMethod.RING:
        return (f"ring — {steps} (batch_isend_irecv; owns the rendering "
                f"regardless of comm; per-block FFTs pipelined where axis "
                f"roles allow{sub})")
    layout = "realigned (opt1 pack, pure exchange)" if opt == 1 \
        else "default layout"
    if comm is pm.CommMethod.ALL2ALL:
        base = f"all_to_all_single of the packed block, {layout}"
        if send is pm.SendMethod.STREAMS:
            return base + " — STREAMS: chunked into independent piece chains"
        if subblocks > 1:
            return (f"pipelined all-to-all — {subblocks} asynchronous "
                    f"all_to_all_single pieces, piece k+1 issued while "
                    f"piece k lands (revolving depth {depth}), {layout}; "
                    "bit-identical to the monolithic exchange")
        return base
    base = ("Peer2Peer: every isend / irecv to the peers posted at once, "
            + layout)
    if send is pm.SendMethod.STREAMS:
        return base + " — STREAMS: the exchange of each piece in turn"
    return base


def _wire_lines(shapes, cdt, cfg) -> list:
    """Wire block: per-exchange payload shape + wire bytes."""
    import numpy as np

    from ..parallel.transpose import wire_itemsize, wire_nbytes
    wire = cfg.wire_dtype
    lines = [f"  dtype: {wire}  "
             f"({wire_itemsize(cdt, wire)} B/elem on the wire vs "
             f"{np.dtype(cdt).itemsize} B logical)"]
    for label, shape in shapes:
        wb = wire_nbytes(shape, cdt, wire)
        lb = wire_nbytes(shape, cdt, "native")
        extra = "" if wire == "native" else \
            f" (native would be {_fmt_bytes(lb)})"
        lines.append(f"  {label}: payload {tuple(shape)} -> "
                     f"wire_nbytes {_fmt_bytes(wb)}{extra}")
    if wire == "bf16":
        lines.append(f"  lossy: ~2e-3 max rel err per crossing; budget "
                     f"{cfg.resolved_wire_budget():.0e} "
                     "(README 'wire dtype')")
    return lines


def _schedule_lines(xmeta, cdt, cfg) -> list:
    """Overlap-schedule block for ring-rendered exchanges:
    blocks (= ring steps), sub-block split, EFFECTIVE revolving buffers
    (the requested depth under the micro-step cap — depth 8 on 8 ranks
    holds 7 and this block says so), and the per-device wire bytes in
    flight for the chosen split — ``transpose.ring_schedule`` over the
    exact padded payload each exchange moves. Empty when no exchange is
    a ring."""
    from .. import params as pm
    from ..parallel.transpose import ring_schedule
    depth = cfg.resolved_overlap_depth()
    subblocks = cfg.resolved_overlap_subblocks()
    lines = []
    for label, shape, p, snd in xmeta:
        if not snd.is_ring:
            continue
        overlap = snd is pm.SendMethod.RING_OVERLAP
        sch = ring_schedule(shape, cdt, cfg.wire_dtype, p,
                            overlap=overlap, depth=depth,
                            subblocks=subblocks)
        split = ("" if sch["subblocks"] == 1 else
                 f" split into {sch['subblocks']} sub-blocks of "
                 f"{_fmt_bytes(sch['subblock_wire_bytes'])} "
                 f"({sch['permutes']} permutes),")
        cap = (f" (depth {depth} capped by the schedule)"
               if overlap and sch["effective_depth"] < depth else "")
        lines.append(
            f"  {label}: {sch['steps']} block(s) of "
            f"{_fmt_bytes(sch['block_wire_bytes'])} on the wire,{split} "
            f"{sch['buffers']} revolving buffer(s){cap}, "
            f"{_fmt_bytes(sch['bytes_in_flight'])} in flight per device "
            f"(mesh total {_fmt_bytes(sch['total_wire_bytes'])}, the "
            f"(P-1)/P ring discount)")
    return lines


def _wisdom_lines(prov) -> list:
    lines = []
    if prov["store_path"] is None:
        lines.append("  store: none configured (--wisdom / $DFFT_WISDOM "
                     "unset, or --no-wisdom)")
    else:
        v = prov["store_version"]
        vs = "absent on disk" if v is None else f"on-disk version {v}"
        lines.append(f"  store: {prov['store_path']} ({vs})")
    if not prov["slots"]:
        lines.append("  slots: none consulted (no 'auto' Config fields)")
        return lines
    for slot, info in prov["slots"].items():
        status = info["status"]
        if status == "hit":
            rec = info.get("record") or {}
            when = rec.get("recorded_at", "recorded_at unknown")
            detail = ", ".join(f"{k}={rec[k]}" for k in sorted(rec)
                               if k != "recorded_at")
            lines.append(f"  {slot}: hit ({detail}) [{when}]")
        elif status == "miss":
            lines.append(f"  {slot}: miss ({info.get('reason')}) — a real "
                         "run would race and record; defaults shown below")
        else:
            lines.append(f"  {slot}: {status}")
    return lines


def _resilience_lines(plan, cfg, prov) -> list:
    """Resilience posture: guard mode + derived tolerances, the fallback
    ladder that WOULD apply to this rendering, and any wisdom demotion
    stamps on the resolved cell (all static — nothing executes)."""
    import numpy as np

    from ..resilience import fallback, guards
    from ..utils import wisdom

    mode = plan._guard_mode
    src = ("Config.guards" if cfg.guards is not None
           else ("$DFFT_GUARDS" if mode != "off" else "default"))
    lines = [f"  guards: {mode} ({src})"]
    fwd = plan._guard_spec("forward")
    inv = plan._guard_spec("inverse")
    n = int(np.prod(fwd.in_logical))
    tol = guards.parseval_tolerance(cfg.double_prec, cfg.wire_dtype, n)
    dt = "f64" if cfg.double_prec else "f32"
    lines.append(f"  forward check: parseval, tolerance {tol:.2e} "
                 f"(dtype {dt}, wire {cfg.wire_dtype}, N={n})")
    lines.append(f"  inverse check: {inv.check}"
                 + ("" if inv.check == "parseval" else
                    " (C2R: arbitrary spectral input is not conjugate-"
                    "symmetric, so energy is not an invariant there)"))
    if cfg.wire_dtype != "native":
        lines.append(f"  wire drift probe: budget "
                     f"{cfg.resolved_wire_budget():.0e} "
                     "(one extra encode/decode of the spectral payload)")
    ladder = fallback.ladder_preview(cfg)
    if ladder:
        steps = " -> ".join(f"[{r}] {lbl}" for r, lbl in ladder)
        lines.append(f"  fallback ladder: {steps} -> error propagates")
    else:
        lines.append("  fallback ladder: none (default rendering — "
                     "failures propagate, never retried)")
    store = wisdom.store_for_config(cfg)
    stamps = []
    if store is not None:
        for slot in ("comm", "wire"):
            rec = store.lookup(prov["key"], slot)
            if rec and rec.get("demoted"):
                in_force = wisdom.demotion_active(rec)
                verdict = ("record reads as a miss; next race re-records"
                           if in_force else
                           "EXPIRED ($DFFT_DEMOTION_TTL_S) — record "
                           "re-admitted, stamp kept as history")
                stamps.append(
                    f"  demotion stamp [{slot}]: rung "
                    f"{rec.get('demoted_rung')} at "
                    f"{rec.get('demoted_at', '?')} — "
                    f"{rec.get('demoted_reason', '')[:80]} ({verdict})")
    lines += stamps if stamps else ["  demotion stamps: none"]
    return lines


def _checkpoint_lines(args, plan) -> list:
    """The ``checkpoint:`` section: the persist store's
    generation registry, the plan-fingerprint verdict for THIS plan, and
    the next scheduled write under the resolved policy. Built from the
    SAME ``CheckpointStore.describe``/``fingerprint_mismatch`` surface
    the restore path runs — explain cannot disagree with restore about
    which generation would load or why it would refuse."""
    import os as _os
    import time as _time

    from .. import persist
    ckdir = args.checkpoint_dir or _os.environ.get(persist.ENV_DIR, "")
    if not ckdir:
        return ["  store: none configured (--checkpoint-dir / "
                "$DFFT_CKPT_DIR unset)"]
    store = persist.CheckpointStore(ckdir)
    fp = persist.plan_fingerprint(plan)
    d = store.describe(expect_fingerprint=fp)
    lines = [f"  store: {d['directory']} "
             f"({len(persist.GENERATION_SLOTS)} generation slots)"]
    for g in d["generations"]:
        name = _os.path.basename(g["path"])
        if not g["exists"]:
            lines.append(f"  {name}: absent")
        elif g["valid"]:
            age = ("age unknown" if g["age_s"] is None
                   else f"age {g['age_s']:.1f} s")
            lines.append(f"  {name}: step {g['step']}, {age}, valid")
        else:
            lines.append(f"  {name}: INVALID ({g['reason']}) — restore "
                         "skips it (one-generation fallback)")
    lines.append(f"  plan fingerprint: {d['fingerprint_verdict']}")
    try:
        policy = persist.CheckpointPolicy.parse(
            args.checkpoint_policy
            or _os.environ.get(persist.ENV_POLICY))
    except ValueError as e:
        return lines + [f"  policy: INVALID spec ({e})"]
    latest = d["latest"]
    step = latest["step"] if latest else 0
    age = latest["age_s"] if latest and latest["age_s"] is not None else 0.0
    now = _time.monotonic()
    lines.append(f"  policy: {policy} — next write "
                 + policy.describe_next(step, step, now - age, now))
    return lines


def _serve_lines(args, kind: str, plan, cfg) -> list:
    """The ``serve:`` section: how a 2D request of this plane shape would
    be served by ``dfft-torch-serve`` — the plan-cache key it would occupy,
    coalescing eligibility, and the circuit/ladder policy that would wrap
    it. Static (reuses the resolved plan/config; nothing executes)."""
    from .. import serve
    if kind == "batched":
        nx, ny = args.input_dim_x, args.input_dim_y
        shard = args.shard
        transform = plan.transform
        lead = []
    else:
        # The serving layer's unit of traffic is a single 2D image; for a
        # 3D plan, explain the (nx x ny) front-plane request a client
        # WOULD send (3D volumes go through the CLI/batch path).
        nx, ny = args.input_dim_x, args.input_dim_y
        shard = "batch"
        transform = "c2c" if args.c2c else "r2c"
        lead = ["  (dfft-torch-serve serves single 2D images; this 3D plan runs "
                "through the CLI/batch path — below: the nx x ny 2D "
                "request a client would send)"]
    return lead + serve.describe_request(
        nx, ny, double=cfg.double_prec, transform=transform, shard=shard,
        config=cfg)


def _roofline_lines(args, kind: str, backend: str, ranks: int) -> list:
    """Roofline expectation on an H100 (``evalkit/roofline.py``) for the
    explained workload (cubes and square batched planes — the shapes the
    model covers). Non-smooth axes get the Bluestein accounting (padded
    chirp length and overhead factor)."""
    from ..evalkit import roofline as rl
    from ..testing.workloads import flops_batched2d, flops_roundtrip_3d
    nx, ny, nz = args.input_dim_x, args.input_dim_y, args.input_dim_z
    lines = []
    tshape = (nx, ny) if kind == "batched" else (nx, ny, nz)
    rough = rl.nonsmooth_axes(tshape)
    for n in rough:
        m, over = rl.bluestein_axis_report(n)
        lines.append(
            f"  non-smooth axis {n}: no fast path of its own — bluestein "
            f"chirp length {m} (padded), ~{over:.1f}x the flops of a "
            f"smooth axis per pass"
            + ("" if backend == "bluestein" else
               f"; backend {backend} runs it "
               + ("as a dense O(n^2) product"
                  if backend.startswith("matmul") or backend == "pallas"
                  else "through cuFFT's own algorithm")
               + " (fft_backend='bluestein' takes the chirp path)"))
    if rough:
        lines.append("  (the nominal 2.5·N·log2 N model below assumes "
                     "smooth axes; scale by the factors above)")
    if kind == "batched":
        if nx != ny:
            return lines + ["  (batched roofline model needs square "
                            "planes; skipped)"]
        nominal = flops_batched2d(nz, nx, ny)
        mxu4 = rl.mxu_flops_batched2d(nz, nx)
        mxu3 = rl.mxu_flops_batched2d(nz, nx, complex_mults=3)
        what, shape = f"{nx}^2 x {nz} roundtrip", f"{nx}^2x{nz}"
    elif nx == ny == nz:
        nominal = flops_roundtrip_3d(nx)
        mxu4 = rl.mxu_flops_roundtrip_3d(nx)
        mxu3 = rl.mxu_flops_roundtrip_3d(nx, complex_mults=3)
        what, shape = f"{nx}^3 roundtrip", str(nx)
    else:
        return lines + ["  (the model covers cubes and square batched "
                        "planes only; skipped for this shape)"]
    lines.append(f"  nominal FFT flops ({what}): {nominal / 1e9:.2f} GF "
                 "(2.5·N·log2 N per direction)")
    ideal = rl.ideal_time_ms(shape, backend, devices=max(1, ranks))
    if ideal is not None:
        lines.append(
            f"  H100 ideal ({backend}, {max(1, ranks)} card(s)): >= "
            f"{ideal:.4g} ms a roundtrip (the larger of the work over "
            f"{rl.H100_FP32_TFLOPS:g} TFLOP/s and one read and write of "
            f"the data over {rl.H100_HBM_TBPS:g} TB/s; the matmul family "
            "at its products' effective peak)")
    peak = rl.effective_peak_tflops("high")
    lines.append(f"  matmul-backend products: {mxu3 / 1e9:.2f}-"
                 f"{mxu4 / 1e9:.2f} GF (3mm-4mm complex-product bracket) "
                 f"-> >= {mxu4 / (peak * 1e12) * 1e3:.4g} ms at "
                 f"{peak:.1f} TFLOP/s (three bfloat16 passes)")
    return lines


def _graph_lines(plan, dims: int) -> list:
    """The ``graph:`` section: the declared stage graph from the SAME
    registry ``dfft-torch-verify`` checks. Declarative (nothing runs); a
    family without a declaration is reported — the condition the verify
    matrix fails on."""
    from ..analysis import plangraph
    try:
        graph = plangraph.graph_for(plan, "forward", dims)
    except plangraph.MissingGraph as e:
        return [f"  none declared ({e}) — dfft-torch-verify fails this "
                "combo"]
    lines = plangraph.format_graph(graph)
    findings = plangraph.check_graph(graph)
    if findings:
        lines += [f"  WELL-FORMEDNESS VIOLATION: {v}" for v in findings]
    else:
        lines.append(
            f"  well-formed: {len(graph.nodes)} node(s) checked "
            "(dataflow, wire pairing, dtype flow, payload, guard "
            "arity, ring-schedule hazards)")
    return lines


def _census_lines(trace) -> list:
    from ..analysis.opscan import collective_census
    c = collective_census(trace)
    order = ("all_to_all", "all_to_all_start", "send", "recv", "all_reduce",
             "async_total", "convert")
    kernels = trace.kernels()
    out = ["  " + "  ".join(f"{k}: {c[k]}" for k in order)]
    if kernels:
        out.append("  kernels: " + "  ".join(f"{k}: {v}" for k, v in
                                             sorted(kernels.items())))
    return out


def _contract_line(plan, trace, dims: int) -> str:
    """The one-line contract verdict, from the SAME registry and checker
    ``dfft-torch-verify`` runs (``analysis/contracts.py``)."""
    from ..analysis import contracts, opscan
    try:
        contract = contracts.contract_for(plan, "forward", dims)
    except KeyError:
        return "  contract: unverified (no contract registered for this " \
               "plan family)"
    census = opscan.collective_census(trace)
    staged = opscan.staged_exchange_total(trace, opscan.plan_ranks(plan))
    violations = contracts.check_contract(contract, census, trace, staged)
    if violations:
        return (f"  contract: VIOLATED [{contract.name}] — "
                + "; ".join(str(v) for v in violations))
    return (f"  contract: PASS ({contract.name}, {len(contract.rules)} "
            "rule(s); dfft-torch-verify runs the full matrix)")


def _specs(plan, kind: str, dims: int):
    """(input spec, output spec) strings of how each side lies over the
    ranks (the families' graph declarations' spec strings)."""
    if plan.fft3d:
        return "—", "—"
    if kind == "slab":
        from ..models.slab import _spec
        return _spec(plan, False), _spec(plan, True)
    if kind == "pencil":
        from ..models.pencil import _stage_spec
        return _stage_spec(plan, 1), _stage_spec(plan, dims)
    from ..analysis.plangraph import split_spec
    if plan.shard == "batch":
        return split_spec(0), split_spec(0)
    return split_spec(1), split_spec(2)


def _body(args) -> int:
    """One rank's explain (every rank builds the plan; rank 0 prints)."""
    import numpy as np
    import torch

    from .. import obs
    from .. import params as pm
    from ..cli.common import setup_backend
    from ..parallel import multihost
    from ..testing import testcases as tc
    from ..utils import wisdom

    device = setup_backend(args)
    rank, ndev = multihost.world()
    kind = args.kind
    transform = "c2c" if args.c2c else "r2c"
    nx, ny, nz = args.input_dim_x, args.input_dim_y, args.input_dim_z
    cfg = pm.Config(
        comm_method=pm.parse_comm_method(args.comm_method),
        send_method=pm.SendMethod.parse(args.send_method),
        comm_method2=(pm.parse_comm_method(args.comm_method2)
                      if args.comm_method2 else None),
        send_method2=(pm.SendMethod.parse(args.send_method2)
                      if args.send_method2 else None),
        opt=args.opt, double_prec=args.double_prec,
        fft_backend=args.fft_backend,
        streams_chunks=args.streams_chunks,
        overlap_depth=pm.parse_overlap_depth(args.overlap_depth),
        overlap_subblocks=args.overlap_subblocks,
        wire_dtype=pm.parse_wire_dtype(args.wire_dtype),
        wire_error_budget=args.wire_error_budget,
        fused_wire=bool(args.fused_wire),
        guards=args.guards,
        wisdom_path=args.wisdom, use_wisdom=not args.no_wisdom)

    if kind == "pencil":
        p1 = args.partition1 or 2
        p2 = args.partition2 or max(1, ndev // p1)
        partition = pm.PencilPartition(p1, p2)
        g = pm.GlobalSize(nx, ny, nz)
        mk_kind, variant, dims = "pencil", None, args.fft_dim
    elif kind == "batched":
        partition = pm.SlabPartition(args.partitions or ndev)
        # Batched size-slot convention: (batch, nx, ny) with -nz = batch.
        g = pm.GlobalSize(nz, nx, ny)
        mk_kind, variant, dims = "batched2d", args.shard, 2
    else:
        partition = pm.SlabPartition(args.partitions or ndev)
        g = pm.GlobalSize(nx, ny, nz)
        mk_kind, variant, dims = "slab", None, 3

    def say(line: str) -> None:
        if rank == 0:
            print(line, flush=True)

    with obs.span("explain", kind=mk_kind, shape=list(g.shape)):
        # LOOKUP-ONLY resolution: a miss is reported, never raced.
        cfg, prov = wisdom.peek_config(
            mk_kind, g, partition, cfg,
            sequence=args.sequence if kind == "slab" else None,
            transform=transform, dims=dims, variant=variant,
            device=device)
        if kind == "batched":
            from ..models.batched2d import Batched2DFFTPlan
            plan = Batched2DFFTPlan(nz, nx, ny, partition, cfg,
                                    shard=args.shard, transform=transform,
                                    device=device)
        else:
            plan = tc.make_plan(mk_kind, g, partition, cfg,
                                sequence=args.sequence, transform=transform,
                                dims=dims, device=device)
        cfg = plan.config

        platform = torch.device(device).type
        cdt = np.complex128 if args.double_prec else np.complex64
        ranks = partition.num_ranks
        if plan.fft3d:
            mesh_desc = "single-device (fft3d fallback)"
        elif kind == "pencil":
            mesh_desc = {"p1": plan.p1, "p2": plan.p2}
        else:
            mesh_desc = {"p": ranks}

        out = []
        out.append(f"dfft-torch-explain: {mk_kind} {g.nx}x{g.ny}x{g.nz} "
                   f"{transform} over {ranks} rank(s) on {platform} "
                   f"(mesh {mesh_desc})")
        out.append("decomposition:")
        out.append(f"  kind: {mk_kind}"
                   + (f"  sequence: {plan.sequence.value}"
                      if kind == "slab" else "")
                   + (f"  shard: {args.shard}" if kind == "batched" else "")
                   + (f"  dims: {dims}" if kind == "pencil" else ""))
        in_spec, out_spec = _specs(plan, kind, dims)
        out.append(f"  input : logical {tuple(plan.input_shape)}  padded "
                   f"{tuple(plan.input_padded_shape)}  spec {in_spec}")
        out.append(f"  output: logical {tuple(plan.output_shape)}  padded "
                   f"{tuple(plan.output_padded_shape)}  spec {out_spec}")

        out.append("fft sequence:")
        xshapes = []  # (label, exchanged global payload shape)
        xmeta = []    # (label, payload shape, group size, send method)
        if kind == "slab":
            s = plan._seq
            first = ("C2C" if transform == "c2c" else "R2C") \
                + f" axis {'xyz'[s.r2c_axis]}"
            if s.pre_axes:
                first += " + C2C " + ",".join("xyz"[a] for a in s.pre_axes)
            out.append(f"  stage 1: {first}")
            if ranks > 1:
                out.append(f"  exchange: scatter {'xyz'[s.split_axis]} -> "
                           "gather x")
                xshapes.append(("transpose", plan.output_padded_shape))
                xmeta.append(("transpose", plan.output_padded_shape, ranks,
                              cfg.send_method))
            out.append("  stage 2: C2C "
                       + ",".join("xyz"[a] for a in s.post_axes))
        elif kind == "pencil":
            out.append("  stage 1: " + ("C2C z" if transform == "c2c"
                                        else "R2C z"))
            if dims >= 2 and ranks > 1:
                t1_shape = (plan._nx_p1, plan._ny_p2, plan._nzc_p2)
                out.append("  exchange 1 (p2 axis): scatter z -> gather y")
                xshapes.append(("transpose 1", t1_shape))
                xmeta.append(("transpose 1", t1_shape, plan.p2,
                              cfg.send_method))
            if dims >= 2:
                out.append("  stage 2: C2C y")
            if dims >= 3 and ranks > 1:
                t2_shape = (plan._nx_p1, plan._ny_p1, plan._nzc_p2)
                out.append("  exchange 2 (p1 axis): scatter y -> gather x")
                xshapes.append(("transpose 2", t2_shape))
                xmeta.append(("transpose 2", t2_shape, plan.p1,
                              cfg.resolved_snd2()))
            if dims >= 3:
                out.append("  stage 3: C2C x")
        else:
            out.append("  stage 1: " + ("C2C y" if transform == "c2c"
                                        else "R2C y") + " (per plane)")
            if args.shard == "x" and ranks > 1:
                out.append("  exchange: scatter spectral y -> gather x")
                bshape = (plan._batch_pad, plan._nx_pad, plan._nys_pad)
                xshapes.append(("transpose", bshape))
                xmeta.append(("transpose", bshape, ranks, cfg.send_method))
                out.append("  stage 2: C2C x (per plane)")
            else:
                out.append("  stage 2: C2C x (per plane; batch sharding "
                           "issues no collectives)")

        out.append("rendering:")
        depth = cfg.resolved_overlap_depth()
        sub = cfg.resolved_overlap_subblocks()
        if ranks == 1 or (kind == "batched" and args.shard == "batch"):
            out.append("  no exchange: "
                       + ("single-device fft3d fallback" if ranks == 1
                          else "embarrassingly parallel batch sharding "
                               "(zero collectives)"))
        elif kind == "pencil":
            out.append(f"  transpose 1: comm {cfg.comm_method.value} snd "
                       f"{cfg.send_method.value} -> "
                       + _rendering(cfg.comm_method, cfg.send_method,
                                    cfg.opt, plan.p2,
                                    cfg.fused_wire_active(),
                                    depth=depth, subblocks=sub))
            if dims >= 3:
                out.append(f"  transpose 2: comm "
                           f"{cfg.resolved_comm2().value} snd "
                           f"{cfg.resolved_snd2().value} -> "
                           + _rendering(cfg.resolved_comm2(),
                                        cfg.resolved_snd2(), cfg.opt,
                                        plan.p1,
                                        cfg.fused_wire_active(True),
                                        depth=depth, subblocks=sub))
        else:
            out.append(f"  comm {cfg.comm_method.value} snd "
                       f"{cfg.send_method.value} opt {cfg.opt} -> "
                       + _rendering(cfg.comm_method, cfg.send_method,
                                    cfg.opt, ranks,
                                    cfg.fused_wire_active(),
                                    depth=depth, subblocks=sub))
        out.append(f"  local FFT backend: {cfg.fft_backend}"
                   + (f" (mxu_precision={cfg.mxu_precision}, "
                      f"mxu_direct_max={cfg.mxu_direct_max})"
                      if cfg.fft_backend.startswith("matmul") else ""))

        out.append("graph (declared stage graph, plangraph registry):")
        out.extend(_graph_lines(plan, dims))

        sched = _schedule_lines(xmeta, cdt, cfg)
        if sched:
            out.append("overlap schedule (ring exchange, per device):")
            out.extend(sched)

        out.append("wire:")
        if xshapes:
            out.extend(_wire_lines(xshapes, cdt, cfg))
        else:
            out.append("  no exchange -> nothing on the wire")

        out.append("wisdom:")
        out.extend(_wisdom_lines(prov))

        out.append("resilience:")
        out.extend(_resilience_lines(plan, cfg, prov))

        out.append("serve:")
        out.extend(_serve_lines(args, kind, plan, cfg))

        out.append("checkpoint:")
        out.extend(_checkpoint_lines(args, plan))

        if not args.no_compile:
            # The one place explain executes: a recorded forward run.
            from ..analysis import opscan
            out.append("op census (one forward execution, recorded):")
            with obs.span("explain.record", kind=mk_kind):
                trace = opscan.record_plan(plan, "forward", dims)
            out.extend(_census_lines(trace))
            out.append(_contract_line(plan, trace, dims))
        else:
            out.append("op census: skipped (--no-compile)")
            out.append("  contract: unverified (needs the recorded "
                       "execution — drop --no-compile or run "
                       "dfft-torch-verify)")

        out.append("roofline (evalkit/roofline.py, H100):")
        out.extend(_roofline_lines(args, kind, cfg.fft_backend, ranks))

        if args.profile:
            from . import profile as prof_mod
            out.append("stage profile (MEASURED — torch.profiler trace of "
                       f"{max(1, args.profile_iters)} forward "
                       "iteration(s), device time joined onto the "
                       "declared graph):")
            with obs.span("explain.profile", kind=mk_kind):
                prof = prof_mod.stage_profile(
                    plan, "forward", dims,
                    iters=max(1, args.profile_iters))
            out.extend(prof_mod.format_stage_profile(prof))

        say("\n".join(out))

    if args.obs and rank == 0:
        import json
        print("obs metrics: "
              + json.dumps(obs.metrics.snapshot(), sort_keys=True))
    return 0


def main(argv=None) -> int:
    from ..cli.common import run

    args = build_parser().parse_args(argv)
    return run(MODULE, args, None if argv is None else list(argv))


if __name__ == "__main__":
    sys.exit(main())
