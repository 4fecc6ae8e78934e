"""Chained workload timers for the BASELINE application configs — the JAX
package's ``testing/workloads.py`` on the port.

Each chain is a Python loop of plan executions fenced by ONE scalar
readback, the ``.item()`` of ``torch.sum(torch.abs(v))`` (summed over the
ranks on P ranks), where the JAX package jits a ``lax.fori_loop``:

* ``poisson_chain`` — BASELINE config #5 ("3D Poisson solve,
  FFT-diagonalized Laplacian"): forward R2C -> symbol multiply -> inverse
  C2R per iteration (``solvers/poisson.py``), iterating
  ``v <- solve(v + x)``: the add keeps a loop-carried dependency, and the
  iteration converges to the bounded fixed point ``(I - S)^-1 S x`` of
  the linear solve operator S (spectral radius <= 1 in integer mode);
* ``batched2d_chain`` — BASELINE config #4 ("Batched 2D FFT, 1D mesh"):
  forward + inverse of a ``(batch, nx, ny)`` stack per iteration,
  rescaled by ``1/(nx*ny)``;
* ``ns2d_chain`` — k RK4 Navier-Stokes-2D steps on a vorticity ensemble.

The chains run under ``torch.no_grad()``. Plans take ``device`` where the
JAX package takes ``mesh`` (on P ranks: a ``partition`` of P and the
world group, each rank passing its own block).

``serve_load`` is the serve layer's open-loop load generator (Poisson
arrivals against a live ``serve.Server``).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from .. import params as pm


def _fence(plan, v: torch.Tensor) -> float:
    """The one scalar readback: sum |v| over the whole array."""
    s = torch.sum(torch.abs(v), dtype=torch.float64)
    if not plan.fft3d:
        dist.all_reduce(s, op=dist.ReduceOp.SUM, group=plan.group)
    return s.item()


def poisson_chain(k: int, n: int, backend: str = "matmul",
                  partition: pm.SlabPartition | None = None,
                  device: "str | torch.device" = "cuda"):
    """A scalar-fenced chain of ``k`` Poisson solves at ``n^3`` float32.

    Returns ``(fn, plan)``; ``fn(x)`` takes the forcing as the plan's
    ``exec_r2c`` takes it and returns the float sum |v| after the chain."""
    from ..models.slab import SlabFFTPlan
    from ..solvers.poisson import PoissonSolver

    g = pm.GlobalSize(n, n, n)
    plan = SlabFFTPlan(g, partition or pm.SlabPartition(1),
                       pm.Config(fft_backend=backend), device=device)
    solver = PoissonSolver(plan, mode="integer")

    def fn(x) -> float:
        with torch.no_grad():
            x = torch.as_tensor(x, device=plan.device)
            v = x
            for _ in range(k):
                v = solver.solve(v + x)
            return _fence(plan, v)

    return fn, plan


def batched2d_chain(k: int, batch: int, nx: int, ny: int,
                    backend: str = "matmul",
                    partition: pm.SlabPartition | None = None,
                    shard: str = "batch", batch_chunk=None,
                    device: "str | torch.device" = "cuda"):
    """A scalar-fenced chain of ``k`` batched-2D R2C + C2R roundtrips.

    Returns ``(fn, plan)``; ``fn(x)`` takes a ``(batch, nx, ny)`` float32
    stack (this rank's block on P ranks)."""
    from ..models.batched2d import Batched2DFFTPlan

    plan = Batched2DFFTPlan(batch, nx, ny, partition or pm.SlabPartition(1),
                            pm.Config(fft_backend=backend), shard=shard,
                            batch_chunk=batch_chunk, device=device)
    scale = 1.0 / float(nx * ny)

    def fn(x) -> float:
        with torch.no_grad():
            v = torch.as_tensor(x, device=plan.device)
            for _ in range(k):
                v = plan.exec_inverse(plan.exec_forward(v)) * scale
            return _fence(plan, v)

    return fn, plan


def ns2d_chain(k: int, batch: int, n: int, dt: float = 1e-3,
               viscosity: float = 1e-3, backend: str = "matmul",
               partition: pm.SlabPartition | None = None,
               shard: str = "batch", device: "str | torch.device" = "cuda"):
    """A scalar-fenced chain of ``k`` RK4 Navier-Stokes-2D steps on a
    ``(batch, n, n)`` vorticity ensemble (``solvers/navier_stokes.py``):
    20 forward / inverse transforms a step (4 RHS evaluations x 5).

    Returns ``(fn, solver)`` with ``fn(w0)`` the float sum |ω| after k
    steps."""
    from ..models.batched2d import Batched2DFFTPlan
    from ..solvers.navier_stokes import NavierStokes2D

    plan = Batched2DFFTPlan(batch, n, n, partition or pm.SlabPartition(1),
                            pm.Config(fft_backend=backend), shard=shard,
                            device=device)
    solver = NavierStokes2D(plan, viscosity)

    def fn(w0) -> float:
        return _fence(plan, solver.run(w0, k, dt))

    return fn, solver


def flops_ns2d_step(batch: int, n: int) -> float:
    """Nominal FFT flops of ONE RK4 NS-2D step: 4 RHS evaluations x 5
    transforms, each a 2D transform of the stack (the elementwise work is
    O(N) and omitted)."""
    return 4 * 5 * 2.5 * batch * n * n * math.log2(float(n) * n)


def flops_roundtrip_3d(n: int) -> float:
    """R2C + C2R flops for an ``n^3`` volume: 2.5·N^3·log2(N^3) per
    direction (BASELINE.md §Derived)."""
    return 2 * 2.5 * n**3 * math.log2(float(n) ** 3)


def flops_poisson(n: int) -> float:
    """R2C + C2R per solve (the symbol multiply is O(N^3), negligible)."""
    return flops_roundtrip_3d(n)


def flops_batched2d(batch: int, nx: int, ny: int) -> float:
    """Forward + inverse 2D FFT flops for the whole stack."""
    return 2 * 2.5 * batch * nx * ny * math.log2(float(nx) * ny)


# ---------------------------------------------------------------------------
# open-loop load generation against the serving layer
# ---------------------------------------------------------------------------

def serve_load(server, *, rate_hz: float, duration_s: float | None = None,
               n_requests: int | None = None,
               shapes=((256, 256),), dtypes=("f32",),
               transforms=("r2c",), deadline_ms: float | None = None,
               seed: int = 0, warmup: int = 1, stop=None,
               tenants=None) -> dict:
    """Open-loop load generator: Poisson arrivals against a live
    :class:`~distributedfft_tpu_torch.serve.server.Server` (the JAX
    package's ``serve_load``, the same schedule from the same seed).

    OPEN loop means the arrival schedule is fixed in advance
    (exponential inter-arrival gaps at ``rate_hz``) and never slows down
    because the server is slow — the honest way to measure a serving
    system under saturation (a closed loop self-throttles and hides the
    latency cliff). Traffic mixes uniformly over ``shapes``
    (``(nx, ny)`` image pairs and/or ``(nx, ny, nz)`` volume triples),
    ``dtypes``
    (``"f32"``/``"f64"``) and ``transforms`` (``"r2c"``/``"c2c"``),
    seed-keyed so a chaos run is reproducible.

    Every submission outcome is tallied: completed requests contribute
    their end-to-end latency (submit -> result materialized), rejections
    count by class (``shed`` / ``circuit_open`` / ``deadline_expired`` /
    ``closed`` / ``failed``). Returns the measurement dict: p50/p99/mean
    latency ms, achieved FFTs/sec vs offered, and the outcome counts.

    ``warmup`` synchronous requests per (shape, dtype, transform) cell
    pre-build the plans OUTSIDE the measured window (set ``warmup=0`` to
    measure cold-start behavior). ``stop`` (a ``threading.Event``-like
    object) aborts the submission schedule early — the CLI's
    SIGTERM/SIGINT handler sets it so a long drive drains gracefully
    instead of running its full window; already-submitted requests are
    still collected into the summary.

    ``server`` may equally be a :class:`~..serve.fleet.Fleet` (same
    submit surface). ``tenants`` (a sequence of names, fleet mode only)
    mixes the traffic uniformly over tenant identities and adds a
    ``by_tenant`` outcome/latency breakdown to the summary — the surface
    the per-tenant fairness drills assert on."""
    import numpy as np
    if (duration_s is None) == (n_requests is None):
        raise ValueError("pass exactly one of duration_s / n_requests")
    rng = np.random.default_rng(seed)
    cells = [(tuple(int(n) for n in shape), d, t) for shape in shapes
             for d in dtypes for t in transforms]

    def _payload(shape, d, t):
        real = rng.random(shape,
                          dtype=np.float64 if d == "f64" else np.float32)
        if t == "c2c":
            return real.astype(np.complex128 if d == "f64"
                               else np.complex64)
        return real

    # Pre-build every coalescing bucket per cell (the rolling-restart
    # pattern) — but only when the plan cache can actually HOLD the
    # result: prewarming more plans than capacity just thrashes the LRU
    # and leaves the measured window cold anyway. A Fleet has no single
    # cache (each worker owns one); prewarm unconditionally there.
    from ..serve.plancache import bucket_for
    buckets_per_cell = bucket_for(server.max_coalesce,
                                  server.max_coalesce).bit_length()
    cache_cap = getattr(getattr(server, "cache", None), "capacity", None)
    full_prewarm = (cache_cap is None
                    or len(cells) * buckets_per_cell <= cache_cap)
    for shape, d, t in (cells if warmup else []):
        if full_prewarm:
            try:
                server.prewarm(shape,
                               dtype="float64" if d == "f64" else "float32",
                               transform=t)
            except Exception:  # noqa: BLE001 — warmup failures are the
                pass           # run's own evidence (chaos drills inject)
        for _ in range(warmup):
            try:
                server.request(_payload(shape, d, t), t)
            except Exception:  # noqa: BLE001
                pass

    # Pre-draw the whole open-loop schedule (arrival offsets + traffic
    # mix), so generator overhead never back-pressures the schedule.
    # Payloads come from a small per-cell POOL reused round-robin —
    # pre-materializing one array per arrival would be O(rate x duration
    # x image bytes) of memory for no measurement benefit.
    if n_requests is None:
        gaps, total = [], 0.0
        while total < duration_s:
            g = rng.exponential(1.0 / rate_hz)
            total += g
            gaps.append(g)
    else:
        gaps = list(rng.exponential(1.0 / rate_hz, size=n_requests))
    arrivals = np.cumsum(gaps)
    mix = [cells[rng.integers(len(cells))] for _ in arrivals]
    pool = {c: [_payload(*c) for _ in range(4)] for c in cells}
    payloads = [pool[c][i % 4] for i, c in enumerate(mix)]
    tenant_mix = ([str(tenants[rng.integers(len(tenants))])
                   for _ in arrivals] if tenants else [None] * len(mix))

    import time as _time
    _OUTCOME0 = {"ok": 0, "shed": 0, "circuit_open": 0,
                 "deadline_expired": 0, "closed": 0, "failed": 0}
    outcomes = dict(_OUTCOME0)
    by_tenant: dict = {str(t): {"outcomes": dict(_OUTCOME0),
                                "latencies": []}
                       for t in (tenants or [])}

    def _tally(outcome, tenant):
        outcomes[outcome] += 1
        if tenant is not None:
            by_tenant[tenant]["outcomes"][outcome] += 1

    latencies: list = []
    inflight: list = []
    t0 = _time.perf_counter()
    aborted = False
    for at, cell, x, tn in zip(arrivals, mix, payloads, tenant_mix):
        if stop is not None and stop.is_set():
            aborted = True
            break
        while True:  # sliced sleep so a stop signal lands within ~0.2 s
            gap = at - (_time.perf_counter() - t0)
            if gap <= 0:
                break
            _time.sleep(min(gap, 0.2))
            if stop is not None and stop.is_set():
                break
        if stop is not None and stop.is_set():
            aborted = True
            break
        sub = _time.perf_counter()
        try:
            kw = {"deadline_ms": deadline_ms}
            if tn is not None:
                kw["tenant"] = tn
            fut = server.submit(x, cell[2], **kw)
        except Exception as e:  # noqa: BLE001 — classify the rejection
            _tally(_classify(e), tn)
            continue
        # End-to-end latency must stamp when the future RESOLVES (the
        # worker's set_result), not when this open-loop harness gets
        # around to reading it after the submission schedule finishes.
        rec = {"sub": sub}
        fut.add_done_callback(
            lambda f, rec=rec: rec.__setitem__("done",
                                               _time.perf_counter()))
        inflight.append((rec, fut, tn))
    for rec, fut, tn in inflight:
        try:
            fut.result()
        except Exception as e:  # noqa: BLE001
            _tally(_classify(e), tn)
            continue
        _tally("ok", tn)
        # Future.set_result wakes result() waiters BEFORE running done
        # callbacks, so the stamp can lag a just-resolved future by a
        # hair — fall back to "now", which is within that same hair.
        done = rec.get("done") or _time.perf_counter()
        latencies.append((done - rec["sub"]) * 1e3)
        if tn is not None:
            by_tenant[tn]["latencies"].append(latencies[-1])
    wall_s = _time.perf_counter() - t0
    lat = np.asarray(latencies, dtype=np.float64)
    # offered = arrivals actually driven; an aborted (stop-signalled) run
    # offered only what it got through before the signal.
    offered = sum(outcomes.values())
    tenant_block = {}
    for t, rec in by_tenant.items():
        tl = np.asarray(rec["latencies"], dtype=np.float64)
        tenant_block[t] = {
            "outcomes": rec["outcomes"],
            "p50_ms": round(float(np.percentile(tl, 50)), 3)
            if len(tl) else None,
            "p99_ms": round(float(np.percentile(tl, 99)), 3)
            if len(tl) else None,
        }
    return ({"by_tenant": tenant_block} if tenant_block else {}) | {
        "offered": offered,
        "aborted": aborted,
        "offered_rate_hz": round(offered / wall_s, 3),
        "target_rate_hz": rate_hz,
        "wall_s": round(wall_s, 3),
        "outcomes": outcomes,
        "completed": int(outcomes["ok"]),
        "achieved_fps": round(outcomes["ok"] / wall_s, 3),
        "p50_ms": round(float(np.percentile(lat, 50)), 3) if len(lat) else None,
        "p99_ms": round(float(np.percentile(lat, 99)), 3) if len(lat) else None,
        "mean_ms": round(float(lat.mean()), 3) if len(lat) else None,
        "max_ms": round(float(lat.max()), 3) if len(lat) else None,
    }


def _classify(e: BaseException) -> str:
    """Map a serve rejection/failure to its outcome bucket."""
    from ..resilience.circuit import CircuitOpen
    from ..resilience.deadline import DeadlineExceeded
    from ..serve.server import Overloaded, ServerClosed
    if isinstance(e, Overloaded):
        return "shed"
    if isinstance(e, CircuitOpen):
        return "circuit_open"
    if isinstance(e, DeadlineExceeded):
        return "deadline_expired"
    if isinstance(e, ServerClosed):
        return "closed"
    return "failed"
