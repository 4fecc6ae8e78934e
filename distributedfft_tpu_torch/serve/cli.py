"""``dfft-torch-serve`` — the long-lived FFT server as an executable
(the JAX package's ``dfft-serve``, but the fleet).

Two complementary surfaces over one in-process :class:`Server`:

* ``--drive`` runs the open-loop load generator
  (``testing/workloads.serve_load``: Poisson arrivals, mixed
  shape/dtype traffic) against the server and prints ONE final JSON
  summary line. ``--health-out`` additionally writes the final health
  snapshot.
* ``--http PORT`` serves the request/health API over stdlib HTTP on
  127.0.0.1: ``GET /healthz`` returns the health snapshot JSON,
  ``GET /readyz`` answers 200 only while the server admits work (503
  when draining/stopped), ``GET /metrics`` the Prometheus exposition of
  the cumulative metrics (``obs/promexp.py``), and ``POST /fft`` executes
  one request: body is an ``.npy`` payload (2D image or 3D volume),
  headers ``X-DFFT-Transform`` (r2c|c2c), ``X-DFFT-Direction``
  (forward|inverse), ``X-DFFT-Ny`` (inverse r2c logical width of the
  halved last axis), ``X-DFFT-Decomp`` (slab|pencil — volume payloads
  only) and ``X-DFFT-Deadline-Ms`` select the work; rejections map to
  structured status codes (429 Overloaded, 503 circuit open / closed,
  504 deadline exceeded).

SIGTERM/SIGINT trigger a GRACEFUL DRAIN: in-flight and queued work
finishes, new admissions are rejected with ``ServerClosed``, the obs
event log is already flushed, and the process exits 0.

Devices: the card by default (``maybe_initialize()`` joins a torchrun /
``DFFT_*`` world, one rank per card); ``--emulate-devices N`` runs N gloo
ranks on the CPU. Over P > 1 ranks (``-p P`` in a P-rank world) rank 0
leads — it admits, drives and serves HTTP — and the others follow it
(``serve/server.py``, "Ranks").

The fleet flags (``--workers``, ``--worker-devices``,
``--worker-backend``, ``--worker-inflight``, ``--heartbeat-*``,
``--autoscale``, ``--scale-cooldown-s``, ``--tenants``,
``--tenant-weights``) raise ``NotImplementedError`` naming ROADMAP Queue
1 item 14's second part.

Examples::

    dfft-torch-serve --drive --rate 50 --duration 10 \\
        --shapes 256x256,128x128 --deadline-ms 500 --fft-backend pallas
    dfft-torch-serve --http 8080 --emulate-devices 4 -p 4 --shard x
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading

from .server import LATER_FLEET


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="dfft-torch-serve", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--partitions", "-p", type=int, default=1,
                    help="ranks the served plans decompose over "
                         "(default 1 = single device)")
    ap.add_argument("--shard", default="batch", choices=("batch", "x"),
                    help="batched2d decomposition of served plans: "
                         "'batch' (embarrassingly parallel, default) or "
                         "'x' (slab-style with a real exchange — the "
                         "decomposition chaos drills target)")
    ap.add_argument("--max-queue", type=int, default=64,
                    help="admission queue bound (beyond it: Overloaded)")
    ap.add_argument("--latency-budget-ms", type=float, default=1000.0,
                    help="shed when estimated queue delay exceeds this")
    ap.add_argument("--max-coalesce", type=int, default=8,
                    help="max same-shape requests stacked into one "
                         "batched execution")
    ap.add_argument("--batch-chunk", type=int, default=1,
                    help="batched2d batch_chunk of served plans "
                         "(shard=batch only; 0 = whole stack fused)")
    ap.add_argument("--cache-capacity", type=int, default=8,
                    help="LRU plan cache slots")
    ap.add_argument("--circuit-k", type=int, default=3,
                    help="consecutive failures that open a plan key's "
                         "circuit")
    ap.add_argument("--circuit-cooldown-s", type=float, default=5.0,
                    help="open-circuit cooldown before the half-open probe")
    ap.add_argument("--guards", default=None,
                    choices=("off", "check", "enforce"),
                    help="in-graph numerical guards of served plans "
                         "(default $DFFT_GUARDS -> off)")
    ap.add_argument("--wire-dtype", "-wire", default="native",
                    choices=("native", "bf16"),
                    help="wire encoding of served plans' exchanges "
                         "(shard=x; no 'auto' — a serving process must "
                         "not race)")
    ap.add_argument("--comm-method", "-comm", default="All2All",
                    help="comm method of served plans (shard=x)")
    ap.add_argument("--opt", "-o", type=int, default=0, choices=(0, 1))
    ap.add_argument("--fft-backend", default="xla")
    ap.add_argument("--wisdom", default=None, metavar="PATH")
    ap.add_argument("--no-wisdom", action="store_true")
    ap.add_argument("--emulate-devices", type=int,
                    default=int(os.environ.get("DFFT_EMULATE_DEVICES", "0")))
    ap.add_argument("--obs", action="store_true",
                    help="print obs notices + the metrics snapshot")
    ap.add_argument("--obs-dir", default=None, metavar="DIR",
                    help="write the structured JSONL event log here "
                         "(same as $DFFT_OBS_DIR)")
    # fleet mode: N shared-nothing subprocess workers behind the plan-key
    # router (ROADMAP Queue 1 item 14's second part; refused until then);
    # 0 = the single-process Server.
    ap.add_argument("--workers", type=int, default=0,
                    help="run a fleet of N subprocess workers behind the "
                         "plan-key router (0 = single in-process server)")
    ap.add_argument("--worker-devices", default=None, metavar="D0,D1,...",
                    help="per-worker device counts, e.g. "
                         "'8,0,0' = worker 0 is an 8-rank worker "
                         "(serves fft3d/* volume keys), the rest fall "
                         "back to --emulate-devices (fleet mode)")
    ap.add_argument("--volume-decomp", default="slab",
                    choices=("slab", "pencil"),
                    help="default 3D decomposition of served volume "
                         "requests (per-request override: submit "
                         "decomp= / X-DFFT-Decomp)")
    ap.add_argument("--worker-backend", default="server",
                    choices=("server", "stub"),
                    help="fleet worker core: the real Server, or the "
                         "np.fft stub with a fixed service time (routing/"
                         "chaos experiments without compiles)")
    ap.add_argument("--heartbeat-interval-s", type=float, default=0.5,
                    help="fleet heartbeat period; a worker silent for "
                         "K intervals is declared dead")
    ap.add_argument("--heartbeat-k", type=int, default=3,
                    help="missed heartbeats that declare a worker dead")
    ap.add_argument("--worker-inflight", type=int, default=4,
                    help="router dispatch window per worker (the "
                         "tenant-fairness lever)")
    ap.add_argument("--tenant-weights", default=None, metavar="T=W,...",
                    help="per-tenant admission weights, e.g. "
                         "'gold=3,free=1' (fleet mode; unknown tenants "
                         "weigh 1)")
    ap.add_argument("--tenants", default=None, metavar="A,B,...",
                    help="mix the --drive traffic over these tenant "
                         "identities (fleet mode; adds a by_tenant "
                         "summary block)")
    ap.add_argument("--autoscale", default=None, metavar="MIN:MAX",
                    help="attach the metrics-driven worker-count "
                         "controller, bounded to [MIN, MAX] workers "
                         "(fleet mode)")
    ap.add_argument("--scale-cooldown-s", type=float, default=5.0,
                    help="minimum seconds between scale decisions")
    # Resident solver tenant + durable state: a standing simulation
    # stepping inside the serving process, checkpointed crash-consistently
    # so drain/SIGTERM cannot destroy its progress.
    ap.add_argument("--resident", default=None, metavar="KIND:N[:BATCH]",
                    help="host a resident solver (ns2d:64, ns2d:64:4, "
                         "ns3d:32) stepping alongside request traffic")
    ap.add_argument("--resident-dt", type=float, default=1e-3,
                    help="resident integrator dt")
    ap.add_argument("--resident-interval-ms", type=float, default=5.0,
                    help="pause between resident steps (keeps the "
                         "simulation from starving request traffic)")
    ap.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                    help="two-generation checkpoint store for the "
                         "resident's state (same as $DFFT_CKPT_DIR; "
                         "unset = the resident runs without durability)")
    ap.add_argument("--checkpoint-policy", default=None,
                    metavar="steps:N[,secs:T][,drain:on|off]",
                    help="when the resident checkpoints (same as "
                         "$DFFT_CKPT_POLICY; default drain-only)")
    ap.add_argument("--http", type=int, default=0, metavar="PORT",
                    help="serve GET /healthz, GET /readyz and POST /fft "
                         "on this port (0 = off)")
    ap.add_argument("--health-out", default=None, metavar="PATH",
                    help="write the final health snapshot JSON here on "
                         "exit (the CI assertion surface)")
    # --drive: the open-loop load generator
    ap.add_argument("--drive", action="store_true",
                    help="drive the built-in open-loop load generator "
                         "against this server, print a JSON summary, "
                         "drain and exit (chaos-CI / bench surface)")
    ap.add_argument("--rate", type=float, default=20.0,
                    help="offered load, requests/sec (Poisson arrivals)")
    ap.add_argument("--duration", type=float, default=5.0,
                    help="drive window, seconds")
    ap.add_argument("--requests", type=int, default=0,
                    help="drive a fixed request count instead of "
                         "--duration")
    ap.add_argument("--shapes", default="256x256",
                    help="comma-separated NXxNY (image) or NXxNYxNZ "
                         "(volume) request shapes the traffic mixes "
                         "over")
    ap.add_argument("--dtypes", default="f32",
                    help="comma-separated payload dtypes (f32,f64)")
    ap.add_argument("--transforms", default="r2c",
                    help="comma-separated transforms (r2c,c2c)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline of the driven traffic")
    ap.add_argument("--warmup", type=int, default=1,
                    help="synchronous warmup requests per traffic cell "
                         "before the measured window (0 = cold)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def _parse_resident(args):
    """``--resident KIND:N[:BATCH]`` -> the picklable resident spec dict
    ``serve.resident.ResidentSolver.build`` consumes (None when the flag
    is absent)."""
    if not args.resident:
        if args.checkpoint_dir or args.checkpoint_policy:
            raise SystemExit("--checkpoint-dir/--checkpoint-policy "
                             "configure the resident solver's durable "
                             "state; add --resident KIND:N")
        return None
    parts = args.resident.strip().lower().split(":")
    if (len(parts) not in (2, 3) or parts[0] not in ("ns2d", "ns3d")
            or (parts[0] == "ns3d" and len(parts) == 3)):
        # ns3d has no ensemble axis — silently dropping a BATCH the
        # operator asked for would fingerprint-bind checkpoints to an
        # unintended configuration.
        raise SystemExit(f"--resident wants ns2d:N[:BATCH] or ns3d:N, "
                         f"got {args.resident!r}")
    try:
        spec = {"kind": parts[0], "n": int(parts[1]),
                "batch": int(parts[2]) if len(parts) == 3 else 1}
    except ValueError:
        raise SystemExit(f"--resident sizes must be integers, got "
                         f"{args.resident!r}") from None
    if spec["n"] < 4 or spec["batch"] < 1:
        # A degenerate grid would fail later, inside the stepping
        # thread; refuse at startup instead.
        raise SystemExit(f"--resident needs N >= 4 and BATCH >= 1, got "
                         f"{args.resident!r}")
    from .. import persist
    try:
        ckdir, policy = persist.resolve_env(args.checkpoint_dir,
                                            args.checkpoint_policy)
    except ValueError as e:  # fail loudly at startup
        raise SystemExit(f"--checkpoint-policy: {e}") from None
    spec.update(dt=args.resident_dt,
                step_interval_ms=args.resident_interval_ms,
                dir=ckdir, policy=policy)
    return spec


def _parse_shapes(s: str):
    """``NXxNY`` image and ``NXxNYxNZ`` volume entries, mixed freely;
    a bare ``N`` means ``NxN``."""
    out = []
    for part in s.split(","):
        part = part.strip().lower()
        if not part:
            continue
        dims = [tok for tok in part.split("x") if tok]
        if len(dims) not in (1, 2, 3):
            raise SystemExit(f"--shapes wants NXxNY or NXxNYxNZ, got "
                             f"{part!r}")
        try:
            shape = tuple(int(d) for d in dims)
        except ValueError:
            raise SystemExit(f"--shapes sizes must be integers, got "
                             f"{part!r}") from None
        out.append(shape * 2 if len(shape) == 1 else shape)
    if not out:
        raise SystemExit("--shapes needs at least one NXxNY entry")
    return out


def _make_http(server, port: int):
    """Stdlib HTTP front end; returns the started ThreadingHTTPServer."""
    import io
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    import numpy as np

    from ..resilience.circuit import CircuitOpen
    from ..resilience.deadline import DeadlineExceeded
    from .server import Overloaded, ServerClosed

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet: obs is the log surface
            pass

        def _json(self, code: int, payload: dict) -> None:
            body = json.dumps(payload, sort_keys=True).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, server.health())
            elif self.path == "/readyz":
                ready = server.state == "running"
                self._json(200 if ready else 503,
                           {"ready": ready, "state": server.state})
            elif self.path == "/metrics":
                # Prometheus exposition of the CUMULATIVE metrics view
                # (obs/promexp.py) — the autoscaling scrape surface.
                from ..obs import promexp
                body = promexp.render().encode()
                self.send_response(200)
                self.send_header("Content-Type", promexp.CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/fft":
                self._json(404, {"error": "unknown path"})
                return
            trace_id = None
            try:
                n = int(self.headers.get("Content-Length", "0"))
                x = np.load(io.BytesIO(self.rfile.read(n)),
                            allow_pickle=False)
                transform = self.headers.get("X-DFFT-Transform", "r2c")
                direction = self.headers.get("X-DFFT-Direction", "forward")
                ny = self.headers.get("X-DFFT-Ny")
                decomp = self.headers.get("X-DFFT-Decomp")
                ddl = self.headers.get("X-DFFT-Deadline-Ms")
                fut = server.submit(
                    x, transform, direction,
                    ny=int(ny) if ny else None,
                    decomp=decomp or None,
                    deadline_ms=float(ddl) if ddl else None)
                # The admission trace id: one request's whole path
                # (admit -> coalesce -> execute -> reply) is
                # reconstructable from the event log by this id, and the
                # client gets it back as X-DFFT-Trace.
                trace_id = getattr(fut, "trace_id", None)
                out = fut.result()
            except Overloaded as e:
                self._json(429, {"error": "overloaded", "reason": e.reason,
                                 "queue_depth": e.queue_depth,
                                 "est_delay_ms": e.est_delay_ms})
            except CircuitOpen as e:
                self._json(503, {"error": "circuit_open", "key": e.key,
                                 "retry_after_s": e.retry_after_s})
            except ServerClosed:
                self._json(503, {"error": "closed"})
            except DeadlineExceeded as e:
                self._json(504, {"error": "deadline_exceeded",
                                 "detail": e.detail,
                                 "overrun_ms": e.overrun_ms})
            except (ValueError, OSError) as e:
                self._json(400, {"error": "bad_request", "detail": str(e)})
            except Exception as e:  # noqa: BLE001 — the envelope's edge
                self._json(500, {"error": type(e).__name__,
                                 "detail": str(e)[:300]})
            else:
                buf = io.BytesIO()
                np.save(buf, out, allow_pickle=False)
                body = buf.getvalue()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "application/octet-stream")
                self.send_header("Content-Length", str(len(body)))
                if trace_id:
                    self.send_header("X-DFFT-Trace", trace_id)
                self.end_headers()
                self.wfile.write(body)

    httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True,
                     name="dfft-serve-http").start()
    return httpd



# The fleet's flags with their defaults: any other value raises.
FLEET_FLAGS = (("--workers", "workers", 0),
               ("--worker-devices", "worker_devices", None),
               ("--worker-backend", "worker_backend", "server"),
               ("--heartbeat-interval-s", "heartbeat_interval_s", 0.5),
               ("--heartbeat-k", "heartbeat_k", 3),
               ("--worker-inflight", "worker_inflight", 4),
               ("--tenant-weights", "tenant_weights", None),
               ("--tenants", "tenants", None),
               ("--autoscale", "autoscale", None),
               ("--scale-cooldown-s", "scale_cooldown_s", 5.0))


def refuse_fleet(args) -> None:
    """Raise ``NotImplementedError`` for the first fleet flag given a
    value other than its default."""
    for flag, dest, default in FLEET_FLAGS:
        if getattr(args, dest) != default:
            raise NotImplementedError(
                f"{flag} is not ported yet ({LATER_FLEET})")


def _make_http(server, port: int):
    """Stdlib HTTP front end on 127.0.0.1 (``port`` 0: an ephemeral one,
    read back from ``server_address``); returns the started
    ThreadingHTTPServer."""
    import io
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    import numpy as np

    from ..resilience.circuit import CircuitOpen
    from ..resilience.deadline import DeadlineExceeded
    from .server import Overloaded, ServerClosed

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet: obs is the log surface
            pass

        def _json(self, code: int, payload: dict) -> None:
            body = json.dumps(payload, sort_keys=True).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, server.health())
            elif self.path == "/readyz":
                ready = server.state == "running"
                self._json(200 if ready else 503,
                           {"ready": ready, "state": server.state})
            elif self.path == "/metrics":
                # Prometheus exposition of the CUMULATIVE metrics view
                # (obs/promexp.py).
                from ..obs import promexp
                body = promexp.render().encode()
                self.send_response(200)
                self.send_header("Content-Type", promexp.CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/fft":
                self._json(404, {"error": "unknown path"})
                return
            trace_id = None
            try:
                n = int(self.headers.get("Content-Length", "0"))
                x = np.load(io.BytesIO(self.rfile.read(n)),
                            allow_pickle=False)
                transform = self.headers.get("X-DFFT-Transform", "r2c")
                direction = self.headers.get("X-DFFT-Direction", "forward")
                ny = self.headers.get("X-DFFT-Ny")
                decomp = self.headers.get("X-DFFT-Decomp")
                ddl = self.headers.get("X-DFFT-Deadline-Ms")
                fut = server.submit(
                    x, transform, direction,
                    ny=int(ny) if ny else None,
                    decomp=decomp or None,
                    deadline_ms=float(ddl) if ddl else None)
                # The admission trace id rides back as X-DFFT-Trace.
                trace_id = getattr(fut, "trace_id", None)
                out = fut.result()
            except Overloaded as e:
                self._json(429, {"error": "overloaded", "reason": e.reason,
                                 "queue_depth": e.queue_depth,
                                 "est_delay_ms": e.est_delay_ms})
            except CircuitOpen as e:
                self._json(503, {"error": "circuit_open", "key": e.key,
                                 "retry_after_s": e.retry_after_s})
            except ServerClosed:
                self._json(503, {"error": "closed"})
            except DeadlineExceeded as e:
                self._json(504, {"error": "deadline_exceeded",
                                 "detail": e.detail,
                                 "overrun_ms": e.overrun_ms})
            except (ValueError, OSError) as e:
                self._json(400, {"error": "bad_request", "detail": str(e)})
            except Exception as e:  # noqa: BLE001 — the envelope's edge
                self._json(500, {"error": type(e).__name__,
                                 "detail": str(e)[:300]})
            else:
                buf = io.BytesIO()
                np.save(buf, out, allow_pickle=False)
                body = buf.getvalue()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "application/octet-stream")
                self.send_header("Content-Length", str(len(body)))
                if trace_id:
                    self.send_header("X-DFFT-Trace", trace_id)
                self.end_headers()
                self.wfile.write(body)

    httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True,
                     name="dfft-serve-http").start()
    return httpd


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    refuse_fleet(args)
    _parse_resident(args)       # fail loudly at startup, before spawning
    from ..cli.common import run
    return run("distributedfft_tpu_torch.serve.cli", args, argv)


def _body(args) -> int:
    """The executable on one rank (or the only process)."""
    from .. import obs
    from .. import params as pm
    from ..cli.common import setup_backend
    from ..parallel import multihost
    from .server import Server

    if args.obs_dir:
        # Export too: a subprocess the run starts sees only the
        # environment.
        os.environ["DFFT_OBS_DIR"] = args.obs_dir
    device = setup_backend(args)
    rank, world = multihost.world()
    if world > 1 and args.partitions != world:
        raise SystemExit(f"--partitions {args.partitions} in a world of "
                         f"{world} ranks: a served plan spans the world")
    cfg = pm.Config(
        comm_method=pm.parse_comm_method(args.comm_method),
        opt=args.opt, fft_backend=args.fft_backend,
        wire_dtype=args.wire_dtype, guards=args.guards,
        wisdom_path=args.wisdom, use_wisdom=not args.no_wisdom)
    resident_spec = _parse_resident(args)
    server = Server(pm.SlabPartition(args.partitions), cfg,
                    shard=args.shard, volume_decomp=args.volume_decomp,
                    max_queue=args.max_queue,
                    latency_budget_ms=args.latency_budget_ms,
                    max_coalesce=args.max_coalesce,
                    batch_chunk=args.batch_chunk or None,
                    cache_capacity=args.cache_capacity,
                    circuit_k=args.circuit_k,
                    circuit_cooldown_s=args.circuit_cooldown_s,
                    device=device)
    if not server.leader:
        server.close()          # follows the leader until its stop
        return 0
    if resident_spec is not None:
        from .. import persist
        from .resident import ResidentSolver
        try:
            server.attach_resident(ResidentSolver.build(
                dict(resident_spec, name="resident",
                     fft_backend=args.fft_backend, device=str(device))))
        except persist.CheckpointMismatch as e:
            server.close(drain=False)
            raise SystemExit(
                "dfft-torch-serve: checkpoint store was written by a "
                f"different configuration — {e}") from None

    httpd = _make_http(server, args.http) if args.http else None
    stop = threading.Event()

    def _graceful(signum, frame):  # noqa: ARG001 — signal contract
        print(f"dfft-torch-serve: signal {signum} -> graceful drain",
              flush=True)
        stop.set()

    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, _graceful)
        signal.signal(signal.SIGINT, _graceful)
        # SIGUSR2 -> flight-recorder dump (kill -USR2 <pid>).
        obs.flightrec.install_signal_handler()

    rc = 0
    summary = None
    health = None
    try:
        if args.drive:
            from ..testing.workloads import serve_load
            kw = dict(rate_hz=args.rate,
                      shapes=_parse_shapes(args.shapes),
                      dtypes=[d.strip() for d in args.dtypes.split(",")
                              if d.strip()],
                      transforms=[t.strip() for t in
                                  args.transforms.split(",") if t.strip()],
                      deadline_ms=args.deadline_ms, seed=args.seed,
                      warmup=args.warmup, stop=stop)
            if args.requests:
                kw["n_requests"] = args.requests
            else:
                kw["duration_s"] = args.duration
            summary = serve_load(server, **kw)
            health = server.health()  # LIVE state before the drain
        else:
            print(f"dfft-torch-serve: serving (state {server.state}"
                  + (f", http :{httpd.server_address[1]}" if httpd else "")
                  + "); SIGTERM drains", flush=True)
            while not stop.is_set():
                stop.wait(0.2)
    finally:
        server.close(drain=True)
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if health is None:
            health = server.health()
        if args.health_out:
            try:
                with open(args.health_out, "w", encoding="utf-8") as f:
                    json.dump(health, f, indent=1, sort_keys=True)
            except OSError as e:
                print(f"dfft-torch-serve: health-out failed: {e}",
                      file=sys.stderr)
                rc = 1
        if summary is not None:
            summary["health_status"] = health["status"]
            if resident_spec is not None:
                summary["resident"] = health.get("resident")
            print(json.dumps(summary, sort_keys=True), flush=True)
        if args.obs:
            print("obs metrics: "
                  + json.dumps(obs.metrics.snapshot(), sort_keys=True))
    return rc


if __name__ == "__main__":
    sys.exit(main())
