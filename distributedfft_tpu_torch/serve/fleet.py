"""Shared-nothing serving fleet: N worker processes behind a plan-key
router — the JAX package's ``serve/fleet.py``, with the same names,
defaults, protocol and behaviour.

One ``Server`` process is one failure domain: a crash, hang or hot
tenant takes down 100% of capacity. The :class:`Fleet` splits that
domain into N **subprocess workers** (``multiprocessing`` spawn — no
shared torch state, no fork-after-init hazards, no CUDA context crossing
a fork), each running the hardened ``Server`` core, behind a router
that:

* **routes on the plan key** (``plancache.request_key``) with rendezvous
  hashing (``router.RendezvousRing``), so each worker's plan cache and
  circuit state stay hot and membership changes move the minimum of key
  space — a worker death moves ONLY its keys, a join at most ~1/N;
* **detects worker death** three ways — K missed heartbeats (a hung
  worker), a broken/EOF pipe (a crashed worker), a reaped exit code —
  then reroutes the dead worker's key range, **resubmits its admitted
  in-flight requests** (idempotent by trace id: the same id rides the
  retry, and an FFT is pure so re-execution cannot double-apply;
  requests whose deadline passed answer ``DeadlineExceeded`` — nothing
  silently vanishes), and **restarts** a replacement that ``prewarm()``s
  the fleet's hot shapes BEFORE rejoining the ring;
* **admits per tenant** (``router.TenantPolicy`` weighted quotas +
  ``router.FairQueue`` stride-fair dispatch), so a saturating tenant
  degrades to *their* budget — structured
  ``Overloaded(reason="tenant_quota")`` — not the fleet's p99;
* **scales on the scrape surface**: :class:`ScaleController` reads the
  shed/queue-depth/EMA signals from the SAME Prometheus exposition
  ``GET /metrics`` serves (``obs.promexp.render``), emits an auditable
  ``fleet.scale_decision`` record (event + flight-recorder trigger +
  ``health()["scale_decisions"]``), and grows/drains workers through
  the same join/leave path the failure detector uses.

Worker protocol (pickled tuples over a duplex pipe; payloads are numpy
arrays, never a CUDA tensor)::

    parent -> worker   ("req", tid, {...})
                       ("prewarm", [(nx, ny, dtype, transform) |
                                    (nx, ny, nz, dtype, transform,
                                     decomp), ...])
                       ("counts", seq, reset)
                       ("drain",)  ("stop",)
    worker -> parent   ("ready", pid, generation, info)
                       ("res", tid, "ok", array | "err", encoded)
                       ("prewarmed", n)  ("counts", seq, rows)
                       ("drained", stats)

and, on a second pipe of its own, the heartbeat: ``("ping", seq)`` ->
``("pong", seq, stats)``, answered by a thread of the worker that
neither waits for a payload's transfer (a 4096^2 reply is 67 MB) nor
takes ``DEVICE_LOCK``: a busy worker is never declared dead.

``info`` names the worker's ranks, its followers' pids, its device and
whether JAX is among its modules (it never is). ``stats`` (the heartbeat)
carries the worker's kernel launches (``hopper_fft.LAUNCHES``), its C
entry points (``hopper_fft.ENTRIES``) and its matmul dispatches, so the
parent can tell which kernels served a request launched in another
process; ``("counts", ...)`` gathers them from every rank of the worker
(and resets them when asked) through the server's own protocol.

**Worker groups** (the port's form of JAX's per-worker device mesh): a
worker spec carries a per-worker ``devices=D`` size (``worker_devices=
[2, 0]`` sizes worker 0 to two ranks and leaves the rest at the fleet
default, ``emulate_devices``). A worker with D > 1 is a D-rank
``torch.distributed`` group: its LEADER is the spawned process that owns
the pipe; it starts D-1 followers (subprocesses in its own process group,
each killed with it — ``PR_SET_PDEATHSIG`` and a parent watch) on a
fresh gloo coordinator of its own, and all D construct the same
``Server(partition=SlabPartition(D), ...)``: the followers serve through
the server's leader/follower protocol (``serve/server.py``, "Ranks").
Under ``emulate_devices`` the groups run on the CPU; otherwise on the
fleet's ``device`` (the card by default), D ranks sharing it over gloo
(NCCL refuses two ranks on one GPU). Killing a worker kills its whole
group (``os.killpg``).

Routing is CAPABILITY-AWARE — ``fft3d/*`` volume keys rendezvous-hash
over the volume-capable workers only (a second ``RendezvousRing``), 2D
keys over everyone. A worker sized to D > 1 ranks is capable, as in the
JAX package. On the card, where every one-rank worker holds the whole
card and serves volumes on the fused 3D kernels, every worker is capable
while no worker is sized to a group (JAX's rule would refuse every
volume there). Each worker's heartbeat carries its live rank count into
the ``dfft_fleet_worker_devices{worker=...}`` gauge, ``health()``
reports ``degraded`` while any worker runs short of its spec'd size,
and the ``fleet.capacity`` gauge weights workers by acquired/spec'd
ranks.

Chaos hooks: ``$DFFT_FAULT_SPEC`` ``worker:crash[:K]`` /
``worker:hang[:MS]`` (``resilience/inject.py``) fault the victim
worker's FIRST incarnation from inside its message loop, driving the
broken-pipe and missed-beats detector paths respectively; the fleet
must complete the drive with zero lost requests. ``worker:devloss[:D]``
kills the victim like a crash AND makes every respawn come up D ranks
short (``inject.devloss_cut``, read here when sizing the replacement):
the replacement rebuilds its hot plans on the smaller group and restores
a resident solver across the rank-count change
(``persist.load(allow_mesh_change=True)`` → ``persist.degraded_restore``
evidence).

A ``KernelError`` in a worker reaches the caller as
:class:`RemoteWorkerError` naming it: a failure, never a death the
router would retry elsewhere.

``worker_backend="stub"`` swaps the real ``Server`` core for a
protocol-identical ``np.fft`` stub with a fixed service time — the
deterministic core the routing/fairness/failure tests drive (same
pipes, same detector, same injectors; only the FFT engine differs).
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
import pickle
import signal
import socket
import subprocess
import sys
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .. import obs
from ..resilience import inject
from ..resilience.deadline import Deadline, DeadlineExceeded
from . import plancache
from .router import (DEFAULT_TENANT, FairQueue, RendezvousRing,
                     TenantPolicy)
from .server import (Overloaded, ServerClosed, _new_trace_id, local_counts,
                     normalize_request, settle_future)

HEARTBEAT_INTERVAL_S = 0.5
HEARTBEAT_K = 3
SPAWN_TIMEOUT_S = 120.0
MAX_RESUBMITS = 3
HOT_KEYS_TRACKED = 16

# Seconds a worker group's collectives wait for a rank (the leader posts a
# keep-alive every ``server.KEEPALIVE_S`` while idle).
GROUP_TIMEOUT_S = 300

# Socket buffer of each direction of a worker's pipe (a duplex
# ``multiprocessing.Pipe`` is a Unix socket pair). The default (~208 KiB)
# moved a 64 MiB array at ~25 MB/s on an H100 host, ~2.5 s each way: a
# 4096^2 request and its reply outlasted the heartbeat window.
PIPE_BUFFER_BYTES = 8 << 20


def _size_pipe(*conns: Any) -> None:
    """Ask for ``PIPE_BUFFER_BYTES`` in each direction of each
    connection's socket (the kernel may grant less)."""
    for c in conns:
        s = socket.socket(fileno=os.dup(c.fileno()))
        try:
            for opt in (socket.SO_SNDBUF, socket.SO_RCVBUF):
                s.setsockopt(socket.SOL_SOCKET, opt, PIPE_BUFFER_BYTES)
        except OSError:
            pass
        finally:
            s.close()


# ---------------------------------------------------------------------------
# error transport (structured exceptions across the pipe)
# ---------------------------------------------------------------------------

class RemoteWorkerError(RuntimeError):
    """A worker-side failure with no structured twin on the router side
    (``GuardViolation``, ``KernelError``, plan-build errors, ...);
    carries the original type name so load-generator classification and
    logs stay honest."""

    def __init__(self, type_name: str, msg: str):
        super().__init__(f"{type_name}: {msg}")
        self.type_name = type_name


def _encode_error(e: BaseException) -> Dict[str, Any]:
    d: Dict[str, Any] = {"type": type(e).__name__, "msg": str(e)[:500]}
    for attr in ("reason", "queue_depth", "est_delay_ms", "budget_ms",
                 "key", "retry_after_s", "detail", "overrun_ms"):
        if hasattr(e, attr):
            v = getattr(e, attr)
            if isinstance(v, (bool, int, float, str)):
                d[attr] = v
    return d


def _decode_error(d: Dict[str, Any]) -> BaseException:
    t, msg = d.get("type", "RuntimeError"), d.get("msg", "")
    if t == "Overloaded":
        return Overloaded(d.get("reason", "queue_full"),
                          d.get("queue_depth", 0),
                          d.get("est_delay_ms", 0.0),
                          d.get("budget_ms", 0.0))
    if t == "DeadlineExceeded":
        return DeadlineExceeded(msg, detail=d.get("detail", "expired"),
                                overrun_ms=d.get("overrun_ms", 0.0))
    if t == "CircuitOpen":
        from ..resilience.circuit import CircuitOpen
        return CircuitOpen(d.get("key", "?"), d.get("retry_after_s", 0.0))
    if t == "ServerClosed":
        return ServerClosed(msg)
    if t in ("ValueError", "TypeError"):
        return ValueError(msg)
    return RemoteWorkerError(t, msg)


# ---------------------------------------------------------------------------
# the worker process
# ---------------------------------------------------------------------------

class _StubCore:
    """Protocol twin of ``Server`` with a deterministic ``np.fft`` engine
    and a fixed per-request service time — no plans, no kernels, so the
    routing/fairness/failure tests measure the FLEET, not the FFT."""

    def __init__(self, service_ms: float = 5.0, max_queue: int = 64,
                 max_coalesce: int = 8):
        self.service_ms = float(service_ms)
        self.max_queue = int(max_queue)
        self.max_coalesce = int(max_coalesce)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._pending: List[Tuple[Any, Future]] = []
        self._state = "running"
        self._counts = {"served": 0, "shed": 0, "deadline_expired": 0}
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def submit(self, x: Any, transform: str = "r2c",
               direction: str = "forward", *, ny: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               decomp: Optional[str] = None) -> Future:
        # decomp only picks the served plan family; the np.fft twin has
        # no ranks, so it is validated-and-ignored (routing happens on
        # the PARENT side — the stub exists to test exactly that).
        x, shape, _ = normalize_request(x, transform, direction, ny)
        dl = Deadline.after_ms(deadline_ms) if deadline_ms else None
        fut: Future = Future()
        with self._lock:
            if self._state != "running":
                raise ServerClosed(f"stub is {self._state}")
            if len(self._pending) >= self.max_queue:
                self._counts["shed"] += 1
                raise Overloaded("queue_full", len(self._pending), 0.0,
                                 float(self.max_queue))
            self._pending.append(((x, transform, direction, shape, dl),
                                  fut))
            self._cv.notify()
        return fut

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._pending and self._state == "running":
                    self._cv.wait(0.05)
                if not self._pending:
                    return
                (x, transform, direction, shape, dl), fut = \
                    self._pending.pop(0)
            if dl is not None and dl.expired():
                with self._lock:
                    self._counts["deadline_expired"] += 1
                fut.set_exception(DeadlineExceeded(
                    "stub deadline expired", detail="queued",
                    overrun_ms=-dl.remaining_ms()))
                continue
            time.sleep(self.service_ms / 1e3)
            try:
                # n-dimensional: rfftn == rfft2 on a 2D image, and the
                # same dispatch serves 3D volumes (unnormalized inverse,
                # Server-style).
                if direction == "forward":
                    out = (np.fft.rfftn(x) if transform == "r2c"
                           else np.fft.fftn(x))
                elif transform == "r2c":
                    out = np.fft.irfftn(x, s=shape) \
                        * float(np.prod(shape))
                else:
                    out = np.fft.ifftn(x) * x.size
                with self._lock:
                    self._counts["served"] += 1
                fut.set_result(np.ascontiguousarray(out))
            except Exception as e:  # noqa: BLE001 — worker loop ships it
                fut.set_exception(e)

    def prewarm(self, shape: Tuple[int, ...], dtype: Any = None,
                transform: str = "r2c", **kw: Any) -> int:
        return 0

    def health(self) -> Dict[str, Any]:
        with self._lock:
            return {"status": self._state, "queue_depth": len(self._pending),
                    "ema_ms": self.service_ms, "counters": dict(self._counts)}

    beat = health

    def rank_counts(self, reset: bool = False) -> List[Dict[str, Any]]:
        return [local_counts(reset)]

    def close(self, drain: bool = True, timeout_s: float = 30.0) -> None:
        with self._cv:
            if self._state == "stopped":
                return
            self._state = "draining"
            if not drain:
                for _, fut in self._pending:
                    fut.set_exception(ServerClosed("stub closed"))
                self._pending.clear()
            self._cv.notify_all()
        self._worker.join(timeout_s)
        with self._lock:
            self._state = "stopped"


def _stats_lite(core: Any, devices: Optional[int] = None
                ) -> Dict[str, Any]:
    """The heartbeat payload: the queue/EMA/shed signals the router folds
    into its ``/metrics`` surface for the scale controller, the worker's
    LIVE rank count (after a devloss respawn smaller than the spec: the
    ``dfft_fleet_worker_devices`` gauge dips), and this process's kernel
    launches, entry points and matmul dispatches. Built from
    ``core.beat()``, which takes no lock that device work holds: the
    heartbeat answers while the server thread holds ``DEVICE_LOCK`` or
    waits on the card."""
    h = core.beat()
    c = h.get("counters", {})
    out = {"status": h.get("status"),
           "queue_depth": h.get("queue_depth", 0),
           "ema_ms": h.get("ema_ms"),
           "served": c.get("served", 0), "shed": c.get("shed", 0),
           "deadline_expired": c.get("deadline_expired", 0),
           "batch_failures": c.get("batch_failures", 0)}
    if devices is not None:
        out["devices"] = int(devices)
    counts = local_counts()
    out["launches"] = counts["launches"]
    out["entries"] = counts["entries"]
    out["matmul"] = counts["matmul"]
    res = h.get("resident")
    if res:
        # The resident's progress rides the heartbeat so the ROUTER's
        # health/summary can report the standing tenant without an
        # extra round trip.
        out["resident"] = {"name": res.get("name"),
                           "step": res.get("step"),
                           "restored_from": res.get("restored_from"),
                           "checkpoints": res.get("checkpoints"),
                           "running": res.get("running")}
    return out


def _apply_env(spec: Dict[str, Any]) -> None:
    """Worker-env overrides (before any device is touched); an
    ``OMP_NUM_THREADS`` override also sets torch's intra-op threads (torch
    read the variable when it was imported, before the spec arrived)."""
    for k, v in (spec.get("env") or {}).items():
        os.environ[str(k)] = str(v)
    threads = (spec.get("env") or {}).get("OMP_NUM_THREADS")
    if threads:
        import torch
        torch.set_num_threads(int(threads))


def _die_with_parent() -> None:
    """Exit when the parent process does: ``PR_SET_PDEATHSIG`` (Linux;
    the follower is started from its leader's main thread, which lives
    as long as the leader) and a watch thread on the parent's pid for
    the window before the signal was armed."""
    ppid = os.getppid()
    try:
        import ctypes
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL, 0, 0, 0)
    except (OSError, AttributeError):
        pass

    def watch() -> None:
        while os.getppid() == ppid:
            time.sleep(0.5)
        os._exit(1)

    threading.Thread(target=watch, daemon=True,
                     name="dfft-follower-watch").start()


def _build_core(spec: Dict[str, Any], devices: int) -> Any:
    """The worker's serving core on this rank: the resident (built, and
    restored from its store, BEFORE the server, so its collectives precede
    the followers' protocol), then the ``Server`` over the group."""
    from .. import params as pm
    from .server import Server
    resident = None
    res_spec = spec.get("resident")
    if res_spec:
        from .resident import ResidentSolver
        resident = ResidentSolver.build(
            dict(res_spec, name=f"{spec['name']}-resident"))
    part = spec.get("partition") or pm.SlabPartition(1)
    if devices > 1:
        # A sized worker partitions over EVERY rank it acquired —
        # including the smaller count a devloss replacement came back
        # with (the replan half of shrink-and-replan).
        part = pm.SlabPartition(devices)
    core = Server(part, spec.get("config") or pm.Config(),
                  shard=spec.get("shard", "batch"), name=spec["name"],
                  device=spec.get("device", "cuda"),
                  **spec.get("server_kwargs", {}))
    if resident is not None:
        core.attach_resident(resident)
    return core


def _join_group(addr: str, devices: int, rank: int,
                spec: Dict[str, Any]) -> None:
    from ..parallel import multihost
    multihost.maybe_initialize(addr, devices, rank, backend="gloo",
                               timeout_s=GROUP_TIMEOUT_S)
    if str(spec.get("device", "cuda")).startswith("cuda"):
        import torch
        torch.cuda.set_device(torch.device(spec["device"]).index or 0)


def _start_followers(spec: Dict[str, Any], devices: int,
                     addr: str) -> List[subprocess.Popen]:
    """Ranks 1..D-1 of a worker group: subprocesses of this leader, in its
    process group, each handed ``(addr, D, spec)`` on its standard
    input."""
    payload = pickle.dumps((addr, devices, spec))
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    code = ("from distributedfft_tpu_torch.serve.fleet import "
            "_follower_entry; _follower_entry()")
    procs = []
    for rank in range(1, devices):
        p = subprocess.Popen([sys.executable, "-c", code, str(rank)],
                             stdin=subprocess.PIPE, env=env)
        p.stdin.write(payload)
        p.stdin.close()
        procs.append(p)
    return procs


def _follower_entry() -> None:
    """``python -c`` entry of a follower rank: argv[1] is the rank, the
    standard input ``pickle((addr, D, spec))``."""
    _die_with_parent()
    rank = int(sys.argv[1])
    addr, devices, spec = pickle.load(sys.stdin.buffer)
    os.environ["DFFT_WORKER_INDEX"] = str(spec["index"])
    _apply_env(spec)
    _join_group(addr, devices, rank, spec)
    from ..parallel import multihost
    try:
        core = _build_core(spec, devices)
        core.close()            # follows the leader until its stop
    finally:
        multihost.shutdown()


def _stop_followers(procs: List[subprocess.Popen]) -> None:
    deadline = time.monotonic() + 10.0
    for p in procs:
        try:
            p.wait(max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _beats(beat: Any, core: Any, ndev: int, index: int,
           generation: int) -> None:
    """The worker's heartbeat thread: a pong for each ping, stats from
    ``_stats_lite``. ``worker:hang`` stops it too."""
    while True:
        try:
            msg = beat.recv()
        except (EOFError, OSError):
            return
        inject.maybe_hang_worker(index, generation)
        try:
            beat.send(("pong", msg[1], _stats_lite(core, devices=ndev)))
        except (OSError, ValueError, BrokenPipeError):
            return


def _worker_main(conn: Any, spec: Dict[str, Any], beat: Any = None) -> None:
    """Entry point of one spawned worker process (module-level so the
    spawn context can pickle it): ``conn`` carries the requests and
    control, ``beat`` the heartbeat. It leads a process group of its own,
    so the router can kill it and its followers at once."""
    os.setpgrp()
    os.environ["DFFT_WORKER_INDEX"] = str(spec["index"])
    _apply_env(spec)
    # Group sizing: a per-worker ``devices`` spec (the capability-aware
    # fleet's lever — and, after a devloss, the SHRUNKEN size the parent
    # computed).
    devices = int(spec.get("devices") or 0)
    index, generation = int(spec["index"]), int(spec["generation"])
    followers: List[subprocess.Popen] = []
    if spec.get("backend") == "stub":
        core: Any = _StubCore(
            service_ms=float(spec.get("stub_service_ms", 5.0)),
            max_queue=int(spec.get("server_kwargs", {})
                          .get("max_queue", 64)))
    else:
        if devices > 1:
            from ..parallel import multihost
            addr = multihost.local_coordinator()
            followers = _start_followers(spec, devices, addr)
            _join_group(addr, devices, 0, spec)
        elif str(spec.get("device", "cuda")).startswith("cuda"):
            import torch
            torch.cuda.set_device(torch.device(spec["device"]).index or 0)
        # Resident solver tenant: built — and, when its checkpoint store
        # already holds a generation, RESTORED — BEFORE announcing ready,
        # so a replacement worker rejoins the ring with the simulation
        # already back at step k: persist.restore precedes
        # fleet.worker_join in the event log.
        core = _build_core(spec, devices)
    ndev = max(devices, 1)

    send_lock = threading.Lock()

    def send(msg: Tuple[Any, ...]) -> None:
        with send_lock:
            try:
                conn.send(msg)
            except (OSError, ValueError, BrokenPipeError):
                pass  # parent gone; the recv loop will exit on EOF

    def _prewarm(shapes: List[Tuple[Any, ...]]) -> int:
        built = 0
        for item in shapes:
            try:
                if len(item) == 6:  # (nx, ny, nz, code, transform, decomp)
                    nx, ny, nz, code, transform, dec = item
                    built += core.prewarm(
                        (int(nx), int(ny), int(nz)),
                        dtype="float64" if code == "f64" else "float32",
                        transform=transform, decomp=dec)
                else:
                    nx, ny, code, transform = item
                    built += core.prewarm(
                        (int(nx), int(ny)),
                        dtype="float64" if code == "f64" else "float32",
                        transform=transform)
            except Exception:  # noqa: BLE001 — a failed prewarm is a
                pass           # cold first request, not a dead worker
        return built

    def _reply(tid: str, fut: Future) -> None:
        try:
            send(("res", tid, "ok", np.asarray(fut.result())))
        except Exception as e:  # noqa: BLE001 — ship every outcome
            send(("res", tid, "err", _encode_error(e)))

    def _counts(seq: int, reset: bool) -> None:
        try:
            rows = core.rank_counts(reset)
        except Exception as e:  # noqa: BLE001 — reported, not fatal
            rows = [{"error": f"{type(e).__name__}: {e}"[:300]}]
        send(("counts", seq, rows))

    # A replacement worker prewarms the fleet's hot shapes BEFORE
    # announcing ready — it rejoins the ring hot, not cold.
    prewarmed = _prewarm(spec.get("prewarm", []))
    if beat is not None:
        threading.Thread(target=_beats,
                         args=(beat, core, ndev, index, generation),
                         daemon=True, name="dfft-worker-beats").start()
    send(("ready", os.getpid(), generation,
          {"ranks": ndev, "followers": [p.pid for p in followers],
           "device": str(spec.get("device", "cuda")),
           "jax": "jax" in sys.modules}))
    if prewarmed:
        obs.event("fleet.worker_prewarmed", worker=spec["name"],
                  built=prewarmed)
    drain = False
    try:
        while True:
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                break  # router died; nothing left to serve for
            inject.maybe_hang_worker(index, generation)
            kind = msg[0]
            if kind == "req":
                inject.maybe_crash_worker(index, generation)
                inject.maybe_devloss_worker(index, generation)
                tid, req = msg[1], msg[2]
                try:
                    fut = core.submit(req["x"], req["transform"],
                                      req["direction"], ny=req.get("ny"),
                                      deadline_ms=req.get("deadline_ms"),
                                      decomp=req.get("decomp"))
                except Exception as e:  # noqa: BLE001 — structured
                    send(("res", tid, "err", _encode_error(e)))
                else:
                    fut.add_done_callback(
                        lambda f, tid=tid: _reply(tid, f))
            elif kind in ("prewarm", "counts"):
                # OFF the pipe loop: a prewarm builds for seconds and a
                # count gather waits for DEVICE_LOCK; the requests behind
                # them keep flowing.
                target = ((lambda shapes=msg[1]:
                           send(("prewarmed", _prewarm(shapes))))
                          if kind == "prewarm" else
                          (lambda seq=msg[1], reset=msg[2]:
                           _counts(seq, reset)))
                threading.Thread(target=target, daemon=True).start()
            elif kind == "drain":
                drain = True
                core.close(drain=True)
                send(("drained", _stats_lite(core, devices=ndev)))
                break
            elif kind == "stop":
                break
    finally:
        if not drain:
            core.close(drain=False)
        if followers:
            from ..parallel import multihost
            multihost.shutdown()
            _stop_followers(followers)
        try:
            conn.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# router-side request / worker records
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _FleetRequest:
    x: np.ndarray
    transform: str
    direction: str
    ny: int  # logical extent of the (possibly halved) LAST axis
    key: str
    tenant: str
    deadline: Optional[Deadline]
    future: Future
    trace_id: str
    submitted_at: float
    attempts: int = 0
    decomp: Optional[str] = None  # volumes only: slab | pencil


class _Worker:
    """Router-side handle of one worker process."""

    def __init__(self, name: str, index: int, generation: int,
                 proc: Any, conn: Any, beat: Any, policy: TenantPolicy,
                 devices: int = 0, full_devices: int = 0):
        self.name = name
        self.index = index
        self.generation = generation
        # devices: the rank count this incarnation was spawned at;
        # full_devices: the spec'd size. devices < full_devices means a
        # devloss replacement running short — health() reports degraded
        # and fleet.capacity weights it fractionally until a full-size
        # replacement rejoins.
        self.devices = int(devices)
        self.full_devices = int(full_devices)
        self.proc = proc
        self.conn = conn
        self.beat = beat    # the heartbeat pipe (monitor thread only)
        self.lock = threading.Lock()
        # Serializes pipe WRITES (dispatch, prewarm/counts/drain control
        # all send from different threads; Connection.send is not
        # thread-safe). Always acquired AFTER self.lock when both are
        # held.
        self.send_lock = threading.Lock()
        self.state = "starting"  # starting | ready | draining | dead
        self.pending = FairQueue(policy)
        self.inflight: Dict[str, _FleetRequest] = {}
        self.last_pong = time.monotonic()
        self.ping_seq = 0
        self.stats: Dict[str, Any] = {}
        self.ready_event = threading.Event()
        self.drained_event = threading.Event()
        self.prewarmed_event = threading.Event()
        self.prewarm_built = 0
        # The ready message's info: ranks, followers' pids, device, and
        # whether JAX is among the worker's modules.
        self.info: Dict[str, Any] = {}
        self.counts_seq = 0
        self.counts: Optional[List[Dict[str, Any]]] = None
        self.counts_event = threading.Event()
        self.reader: Optional[threading.Thread] = None
        self.dispatcher: Optional[threading.Thread] = None
        # Wakes the dispatcher thread: set by admission/responses, so
        # the (potentially BLOCKING) pipe send never runs on a caller's
        # thread — a full pipe to one busy worker must stall only that
        # worker's dispatcher, not every submitter (head-of-line
        # convoying).
        self.kick = threading.Event()

    def send(self, msg: Tuple[Any, ...]) -> None:
        """Raises on a broken pipe — callers treat that as death."""
        with self.send_lock:
            self.conn.send(msg)

    def kill(self) -> None:
        """Stop the worker and its whole group: the leader first, then
        whatever of its process group is left (the followers)."""
        try:
            if self.proc.is_alive():
                self.proc.terminate()
                self.proc.join(2.0)
                if self.proc.is_alive():
                    self.proc.kill()
                    self.proc.join(1.0)
        except Exception:  # noqa: BLE001 — teardown is best-effort
            pass
        if self.proc.pid is not None:
            try:
                # The worker leads a group of its own (os.setpgrp in
                # _worker_main): its followers are in it.
                os.killpg(self.proc.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
        for c in (self.conn, self.beat):
            try:
                c.close()
            except OSError:
                pass


def _wait_ready(w: _Worker, deadline: float,
                stop: Optional[threading.Event] = None) -> bool:
    """Wait for a spawned worker's ready message until ``deadline``
    (monotonic); False at once when the worker exits first or ``stop`` is
    set (the fleet closed meanwhile)."""
    while not w.ready_event.wait(min(0.25, max(0.0, deadline
                                                - time.monotonic()))):
        if (w.proc.exitcode is not None or time.monotonic() >= deadline
                or (stop is not None and stop.is_set())):
            return w.ready_event.is_set()
    return True


class Fleet:
    """N-worker shared-nothing serving pool (see module docstring).

    The submit/request surface mirrors :class:`~.server.Server` (the
    load generator drives either), plus ``tenant=`` — the admission
    identity the quota/fairness machinery meters."""

    def __init__(self, n_workers: int = 2, *, partition: Any = None,
                 config: Any = None, shard: str = "batch",
                 emulate_devices: int = 0,
                 worker_devices: Optional[List[int]] = None,
                 volume_decomp: str = "slab",
                 worker_backend: str = "server",
                 stub_service_ms: float = 5.0,
                 heartbeat_interval_s: float = HEARTBEAT_INTERVAL_S,
                 heartbeat_k: int = HEARTBEAT_K,
                 worker_inflight: int = 4, worker_pending: int = 64,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 admission_capacity: Optional[int] = None,
                 max_resubmits: int = MAX_RESUBMITS,
                 spawn_timeout_s: float = SPAWN_TIMEOUT_S,
                 name: str = "dfft-fleet",
                 worker_env: Optional[Dict[str, str]] = None,
                 resident: Optional[Dict[str, Any]] = None,
                 resident_index: int = 0,
                 device: str = "cuda",
                 **server_kwargs: Any):
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        if worker_backend not in ("server", "stub"):
            raise ValueError("worker_backend must be 'server' or 'stub'")
        if volume_decomp not in plancache.VOLUME_DECOMPS:
            raise ValueError(f"volume_decomp must be one of "
                             f"{plancache.VOLUME_DECOMPS}, "
                             f"got {volume_decomp!r}")
        self.name = name
        self.shard = shard
        self.volume_decomp = volume_decomp
        # Per-worker-INDEX group sizes (0 = the fleet-wide default); an
        # index past the list (scale-up mints new indices) gets the
        # default too. devices > 1 makes a worker MESH-CAPABLE: it joins
        # the volume routing ring and serves fft3d/* keys.
        self._worker_devices = [int(d) for d in (worker_devices or [])]
        self._emulate_devices = int(emulate_devices)
        # The workers' device: the CPU under emulation (gloo groups, as
        # the JAX package's emulated meshes), else the fleet's.
        self.device = "cpu" if self._emulate_devices else str(device)
        sized = (self._emulate_devices > 1
                 or any(d > 1 for d in self._worker_devices))
        # On the card, a one-rank worker holds the whole card and serves
        # volumes on the fused 3D kernels: while no worker is sized to a
        # group, every worker is volume-capable.
        self._card_volumes = (worker_backend == "server" and not sized
                              and self.device.startswith("cuda"))
        self._volume_capable = sized or self._card_volumes
        self.worker_inflight = max(1, int(worker_inflight))
        self.worker_pending = max(1, int(worker_pending))
        self.max_resubmits = int(max_resubmits)
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self.heartbeat_k = max(1, int(heartbeat_k))
        self.spawn_timeout_s = float(spawn_timeout_s)
        self.max_coalesce = int(server_kwargs.get("max_coalesce", 8))
        cap = (int(admission_capacity) if admission_capacity
               else n_workers * self.worker_pending)
        self.policy = TenantPolicy(cap, tenant_weights)
        self.ring = RendezvousRing()
        # The capability ring: fft3d/* volume keys rendezvous-hash over
        # the mesh-capable members ONLY (2D keys over self.ring — every
        # worker). Same minimum-movement stability, per capability
        # class.
        self.mesh_ring = RendezvousRing()
        if worker_backend == "server":
            server_kwargs = dict(server_kwargs,
                                 volume_decomp=volume_decomp)
        self._spec_base = {
            "partition": partition, "config": config, "shard": shard,
            "emulate_devices": int(emulate_devices), "device": self.device,
            "backend": worker_backend,
            "stub_service_ms": float(stub_service_ms),
            "server_kwargs": dict(server_kwargs),
            "env": dict(worker_env or {}),
        }
        # Resident solver tenant: hosted by ONE worker slot
        # (default index 0). The slot is stable across respawns — a
        # replacement worker keeps its index — so the replacement gets
        # the resident spec too and restores from the checkpoint store
        # before rejoining the ring.
        if resident is not None and worker_backend == "stub":
            raise ValueError("a resident solver needs the real Server "
                             "worker backend (worker_backend='server')")
        self._resident_spec = (dict({"device": self.device}, **resident)
                               if resident else None)
        self._resident_index = int(resident_index)
        self._ctx = multiprocessing.get_context("spawn")
        self._lock = threading.Lock()
        self._workers: Dict[str, _Worker] = {}
        self._next_index = 0
        self._state = "running"  # running | draining | stopped
        self._started_at = time.monotonic()
        self._stop = threading.Event()
        self._orphans: List[_FleetRequest] = []
        self._gauges_at = 0.0
        self._label_tenants: set = set()
        self._tenant_gauge_labels: set = set()
        self._hot_keys: "Dict[str, float]" = {}
        self._scale_decisions: List[Dict[str, Any]] = []
        self._controller: Optional["ScaleController"] = None
        # Every pid this fleet's workers ran as: leaders and followers.
        self._pids: set = set()
        self._spawners: List[threading.Thread] = []
        self._counts = {"admitted": 0, "served": 0, "shed": 0,
                        "failed": 0, "deadline_expired": 0,
                        "resubmitted": 0, "abandoned": 0,
                        "worker_deaths": 0, "worker_restarts": 0,
                        "rejected_closed": 0}
        obs.event("fleet.start", fleet=name, workers=n_workers,
                  backend=worker_backend, shard=shard,
                  heartbeat_interval_s=self.heartbeat_interval_s,
                  heartbeat_k=self.heartbeat_k,
                  admission_capacity=cap)
        started = [self._spawn(self._take_index(), generation=0)
                   for _ in range(n_workers)]
        deadline = time.monotonic() + self.spawn_timeout_s
        for w in started:
            if not _wait_ready(w, deadline):
                for ww in started:
                    ww.kill()
                raise RuntimeError(
                    f"fleet worker {w.name} not ready within "
                    f"{self.spawn_timeout_s:.0f} s (exit code "
                    f"{w.proc.exitcode})")
            self._join_ring(w)
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         daemon=True,
                                         name=f"{name}-monitor")
        self._monitor.start()

    # -- lifecycle helpers -------------------------------------------------

    def __enter__(self) -> "Fleet":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close(drain=True)

    def _take_index(self) -> int:
        with self._lock:
            i = self._next_index
            self._next_index += 1
            return i

    def _devices_for(self, index: int) -> int:
        """The spec'd (full-size) mesh of worker ``index``: its
        ``worker_devices`` entry when one exists and is nonzero, else
        the fleet-wide ``emulate_devices`` default (0 = unsized)."""
        if 0 <= index < len(self._worker_devices) \
                and self._worker_devices[index]:
            return self._worker_devices[index]
        return self._emulate_devices

    def _capable(self, full: int, devices: int) -> bool:
        """Whether a worker of this spec'd / acquired size serves volume
        keys (the module docstring's capability rule)."""
        return max(full, devices) > 1 or self._card_volumes

    def _prewarm_shapes(self, volumes: bool = True
                        ) -> List[Tuple[Any, ...]]:
        with self._lock:
            keys = sorted(self._hot_keys,
                          key=lambda k: -self._hot_keys[k])
        shapes: List[Tuple[Any, ...]] = []
        for k in keys[:HOT_KEYS_TRACKED]:
            try:
                d = plancache.parse_request_key(k)
            except ValueError:
                continue
            if "nz" in d:
                # Hot VOLUME shapes go only to mesh-capable workers —
                # a replacement rebuilds them on whatever mesh it
                # actually acquired.
                if volumes:
                    shapes.append((d["nx"], d["ny"], d["nz"], d["dtype"],
                                   d["transform"], d["decomp"]))
            else:
                shapes.append((d["nx"], d["ny"], d["dtype"],
                               d["transform"]))
        return shapes

    def _spawn(self, index: int, generation: int,
               prewarm: Optional[List[Tuple[Any, ...]]] = None
               ) -> _Worker:
        name = f"worker-{index}"
        full = self._devices_for(index)
        cut = inject.devloss_cut(index, generation) if full else 0
        devices = max(1, full - cut) if cut else full
        resident = (self._resident_spec
                    if index == self._resident_index else None)
        if (resident is not None and max(devices, full) > 1
                and (devices < full or not resident.get("partitions"))):
            # Shrink-and-replan (devloss respawn, down to one rank) and
            # the unpinned default on a sized group worker: build the
            # resident at the partition count the group it ACTUALLY
            # acquired can carry,
            # and let persist restore across the rank-count fingerprint
            # diff (two-tier contract: allclose + a structured
            # persist.degraded_restore event, never silent). A spec
            # that pins ``partitions`` keeps it while the worker is
            # full-size (strict bit-exact restore).
            resident = dict(resident, partitions=max(devices, 1),
                            allow_mesh_change=True)
        if devices and devices < full:
            obs.event("fleet.worker_shrunk", worker=name,
                      generation=generation, devices=devices,
                      full_devices=full, lost=cut)
        prewarm = [t for t in (prewarm or [])
                   if len(t) == 4 or self._capable(full, devices)]
        spec = dict(self._spec_base, name=name, index=index,
                    generation=generation, prewarm=prewarm,
                    devices=devices, resident=resident)
        parent_conn, child_conn = self._ctx.Pipe(duplex=True)
        _size_pipe(parent_conn, child_conn)
        parent_beat, child_beat = self._ctx.Pipe(duplex=True)
        proc = self._ctx.Process(target=_worker_main,
                                 args=(child_conn, spec, child_beat),
                                 name=name, daemon=True)
        proc.start()
        child_conn.close()
        child_beat.close()
        with self._lock:
            self._pids.add(proc.pid)
        w = _Worker(name, index, generation, proc, parent_conn, parent_beat,
                    self.policy, devices=devices, full_devices=full)
        w.reader = threading.Thread(target=self._reader_loop, args=(w,),
                                    daemon=True, name=f"{name}-reader")
        w.reader.start()
        threading.Thread(target=self._beat_loop, args=(w,), daemon=True,
                         name=f"{name}-beats").start()
        w.dispatcher = threading.Thread(target=self._dispatch_loop,
                                        args=(w,), daemon=True,
                                        name=f"{name}-dispatch")
        w.dispatcher.start()
        with self._lock:
            self._workers[name] = w
        return w

    def _join_ring(self, w: _Worker) -> None:
        """Promote a ready worker into the routing ring and drain any
        parked (orphaned) requests through routing again."""
        with self._lock:
            if self._state == "stopped":
                # close() already swept self._workers (or this worker
                # registered into the post-sweep dict): nobody else will
                # ever reap it, so a plain return here leaks a live
                # subprocess plus its reader/dispatcher threads — a
                # _respawn/scale-up racing close() must die right here.
                self._workers.pop(w.name, None)
                stopped = True
            else:
                stopped = False
                w.state = "ready"
                w.last_pong = time.monotonic()
                self.ring.add(w.name)
                if self._capable(w.full_devices, w.devices):
                    self.mesh_ring.add(w.name)
                if w.generation > 0:
                    self._counts["worker_restarts"] += 1
                orphans, self._orphans = self._orphans, []
        if stopped:
            w.kill()
            return
        obs.metrics.gauge("fleet.workers", len(self.ring))
        if w.generation > 0:
            obs.metrics.inc("fleet.worker_restarts")
        obs.event("fleet.worker_join", worker=w.name, pid=w.proc.pid,
                  generation=w.generation, devices=w.devices,
                  ring=list(self.ring.members()),
                  mesh_ring=list(self.mesh_ring.members()))
        for req in orphans:
            self._route(req)
        self._pump(w)

    # -- admission / routing ----------------------------------------------

    def submit(self, x: Any, transform: str = "r2c",
               direction: str = "forward", *, ny: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               decomp: Optional[str] = None,
               tenant: str = DEFAULT_TENANT) -> Future:
        """Admit one request — a 2D image (routed over every worker) or
        a 3D volume (``fft3d/*`` key, routed over the mesh-capable ring
        only; ``decomp`` overrides the fleet's ``volume_decomp``
        default). Returns a ``Future``. Raises the structured rejection
        at submit: ``Overloaded`` (``tenant_quota`` when the tenant is
        over its weighted share, ``queue_full`` when its worker's
        router queue is full, ``no_workers`` when the whole ring is
        down and the parking lot is full), ``ServerClosed``, or
        ``ValueError`` for a volume on a fleet with no mesh-capable
        worker configured."""
        x, shape, double = normalize_request(x, transform, direction, ny)
        code = "f64" if double else "f32"
        if len(shape) == 3:
            if not self._volume_capable:
                raise ValueError(
                    "3D volume request but no mesh-capable worker is "
                    "configured (give one a worker_devices / "
                    "emulate_devices mesh of >= 2 devices)")
            dec = decomp or self.volume_decomp
            key = plancache.request_key3d(shape[0], shape[1], shape[2],
                                          code, transform, dec)
        else:
            if decomp is not None:
                raise ValueError("decomp applies to 3D volume requests "
                                 "only")
            dec = None
            key = plancache.request_key(shape[0], shape[1], code,
                                        transform, self.shard)
        with self._lock:
            if self._state != "running":
                self._counts["rejected_closed"] += 1
                raise ServerClosed(f"fleet is {self._state}; "
                                   "not admitting new requests")
            self._hot_keys[key] = time.monotonic()
            if len(self._hot_keys) > 4 * HOT_KEYS_TRACKED:
                for k in sorted(self._hot_keys,
                                key=lambda k: self._hot_keys[k])[
                                    :len(self._hot_keys) // 2]:
                    del self._hot_keys[k]
        try:
            self.policy.admit(tenant)
        except Overloaded as e:
            self._shed(e, tenant, key)
            raise
        dl = (Deadline.after_ms(deadline_ms)
              if deadline_ms is not None else None)
        tid = _new_trace_id()
        fut: Future = Future()
        fut.trace_id = tid  # type: ignore[attr-defined]
        req = _FleetRequest(x=x, transform=transform, direction=direction,
                            ny=shape[-1], key=key, tenant=tenant,
                            deadline=dl, future=fut, trace_id=tid,
                            submitted_at=time.monotonic(), decomp=dec)
        try:
            self._route(req, admitting=True)
        except Overloaded as e:
            self.policy.release(tenant)
            self._shed(e, tenant, key)
            raise
        with self._lock:
            self._counts["admitted"] += 1
        obs.metrics.inc("fleet.admitted")
        self._refresh_gauges()
        return fut

    def request(self, x: Any, transform: str = "r2c",
                direction: str = "forward", *, ny: Optional[int] = None,
                deadline_ms: Optional[float] = None,
                decomp: Optional[str] = None,
                tenant: str = DEFAULT_TENANT,
                timeout_s: Optional[float] = None) -> np.ndarray:
        """Blocking convenience wrapper over :meth:`submit`."""
        return self.submit(x, transform, direction, ny=ny,
                           deadline_ms=deadline_ms, decomp=decomp,
                           tenant=tenant).result(timeout_s)

    def _tenant_label(self, tenant: str) -> str:
        """Bounded label cardinality (the Server._breakers lesson: an
        adversarial name sweep must not grow the metrics registry — or
        the /metrics payload — without limit): configured tenants and
        the first 32 ad-hoc names keep their own series, the rest fold
        into ``other``."""
        if tenant in self.policy.weights or tenant == DEFAULT_TENANT:
            return tenant
        with self._lock:
            if (tenant in self._label_tenants
                    or len(self._label_tenants) < 32):
                self._label_tenants.add(tenant)
                return tenant
        return "other"

    def _shed(self, e: Overloaded, tenant: str, key: str) -> None:
        with self._lock:
            self._counts["shed"] += 1
        obs.metrics.inc("fleet.shed")
        obs.metrics.inc(obs.metrics.labeled(
            "fleet.tenant.shed", tenant=self._tenant_label(tenant)))
        obs.event("fleet.shed", reason=e.reason, tenant=tenant, key=key,
                  queue_depth=e.queue_depth, budget=e.budget_ms)

    def _route(self, req: _FleetRequest, admitting: bool = False) -> None:
        """Enqueue ``req`` at its key's owner (or the parking lot while
        the ring is empty) and pump. ``admitting`` enforces the router
        queue bound — a RESUBMITTED request (a worker died under it) is
        never shed here: zero lost requests beats a tidy bound."""
        worker = None
        owner = self._ring_for(req.key).owner(req.key)
        if owner is not None:
            with self._lock:
                worker = self._workers.get(owner)
        if worker is None:
            with self._lock:
                stopped = self._state == "stopped"
                if not stopped:
                    if (admitting
                            and len(self._orphans)
                            >= self.policy.capacity):
                        raise Overloaded("no_workers", len(self._orphans),
                                         0.0, float(self.policy.capacity))
                    self._orphans.append(req)
            if stopped:
                # A late reroute (a scale-down _finish racing close())
                # must not park work in an orphan list nobody will ever
                # drain: answer structurally, release the quota slot.
                self.policy.release(req.tenant)
                settle_future(req.future, exc=ServerClosed(
                    "fleet stopped before execution"))
            return
        with worker.lock:
            # Re-check under the WORKER lock: the failure handler sets
            # state dead (fleet lock) BEFORE draining pending (worker
            # lock), so a push seen here with state still 'ready' is
            # either pre-drain (the drain will sweep it) or the worker
            # is live — a push into an already-drained queue of a dead
            # worker (a forever-unresolved future) cannot happen.
            if worker.state == "ready":
                if (admitting
                        and len(worker.pending) >= self.worker_pending):
                    raise Overloaded("queue_full", len(worker.pending),
                                     0.0, float(self.worker_pending))
                worker.pending.push(req.tenant, req)
                pushed = True
            else:
                pushed = False
        if not pushed:
            # The owner died between the ring lookup and the push: the
            # ring has (or is about to have) new ownership — re-resolve.
            self._route(req, admitting)
            return
        self._pump(worker)

    def _ring_for(self, key: str) -> RendezvousRing:
        """Capability-aware ring choice: fft3d volume keys hash over the
        mesh-capable members only; everything else over the full ring.
        Both rings keep the minimum-movement property WITHIN their
        capability class (a 2D worker's death never moves a volume
        key; a mesh worker's death moves only ITS keys in each ring)."""
        return (self.mesh_ring if key.startswith("fft3d/")
                else self.ring)

    def _pump(self, worker: _Worker) -> None:
        """Wake the worker's dispatcher (cheap, non-blocking — safe on
        admission and reader threads)."""
        worker.kick.set()

    def _dispatch_loop(self, worker: _Worker) -> None:
        """Per-worker dispatcher: pops the fair queue while the
        in-flight window has room and performs the pipe sends. The
        window (``worker_inflight``) is the fleet's fairness lever:
        small enough that a backlogged tenant cannot monopolize the
        worker's own FIFO, large enough to keep the pipe busy; the fair
        queue picks WHICH tenant refills a freed slot. Sends live on
        THIS thread because a pipe to a busy worker can block when its
        buffer fills — that back-pressure must stall only this worker's
        dispatch, never the submitters or the other workers."""
        while True:
            worker.kick.wait(0.5)
            worker.kick.clear()
            if worker.state in ("dead", "draining"):
                return
            while True:
                with worker.lock:
                    if (worker.state != "ready"
                            or len(worker.inflight)
                            >= self.worker_inflight):
                        break
                    req = worker.pending.pop()
                    if req is None:
                        break
                    if (req.deadline is not None
                            and req.deadline.expired()):
                        expired = req
                    else:
                        worker.inflight[req.trace_id] = req
                        expired = None
                        payload = {"x": req.x,
                                   "transform": req.transform,
                                   "direction": req.direction,
                                   "ny": req.ny}
                        if req.decomp is not None:
                            payload["decomp"] = req.decomp
                        if req.deadline is not None:
                            payload["deadline_ms"] = \
                                req.deadline.remaining_ms()
                if expired is not None:
                    self._expire(expired, "queued")
                    continue
                try:
                    worker.send(("req", req.trace_id, payload))
                except (OSError, ValueError, BrokenPipeError) as e:
                    self._on_worker_failure(
                        worker, f"pipe send failed: {e}")
                    return

    def _expire(self, req: _FleetRequest, detail: str) -> None:
        with self._lock:
            self._counts["deadline_expired"] += 1
        self.policy.release(req.tenant)
        over = -req.deadline.remaining_ms() if req.deadline else 0.0
        obs.event("fleet.reply", trace=req.trace_id,
                  outcome="deadline_expired", detail=detail)
        settle_future(req.future, exc=DeadlineExceeded(
            f"deadline exceeded by {over:.1f} ms ({detail})",
            detail=detail, overrun_ms=over))

    def _refresh_gauges(self, force: bool = False) -> None:
        """Fold queue occupancy into the ``/metrics`` gauges. Sweeping
        every worker's lock is O(workers), so the hot paths (submit /
        per-result) are throttled to one sweep per 0.2 s — the scrape
        and controller cadences are slower than that anyway; the
        monitor tick forces a fresh sweep."""
        now = time.monotonic()
        if not force and now - self._gauges_at < 0.2:
            return
        self._gauges_at = now
        with self._lock:
            workers = list(self._workers.values())
            orphans = len(self._orphans)
        pending = orphans
        inflight = 0
        capacity = 0.0
        for w in workers:
            with w.lock:
                pending += len(w.pending)
                inflight += len(w.inflight)
            if w.state == "ready":
                # Capacity-weighted worker count: a worker running at
                # 4 of its spec'd 8 devices contributes 0.5 — the
                # controller's signal that "2 workers" may be less than
                # two workers' worth of capacity.
                capacity += (w.devices / w.full_devices
                             if w.full_devices else 1.0)
        obs.metrics.gauge("fleet.pending", pending)
        obs.metrics.gauge("fleet.outstanding", pending + inflight)
        obs.metrics.gauge("fleet.capacity", round(capacity, 4))
        # Per-tenant quota occupancy, folded through the same bounded
        # label vocabulary as fleet.tenant.shed; a tenant that goes
        # idle keeps its series pinned at 0 rather than freezing at the
        # last nonzero sample.
        snap: Dict[str, int] = {}
        for t, d in self.policy.snapshot().items():
            lab = self._tenant_label(t)
            snap[lab] = snap.get(lab, 0) + int(d["outstanding"])
        with self._lock:
            self._tenant_gauge_labels |= set(snap)
            labels = set(self._tenant_gauge_labels)
        for t in labels:
            obs.metrics.gauge(
                obs.metrics.labeled("fleet.tenant.outstanding", tenant=t),
                snap.get(t, 0))

    # -- worker I/O --------------------------------------------------------

    def _reader_loop(self, worker: _Worker) -> None:
        while True:
            try:
                msg = worker.conn.recv()
            except (EOFError, OSError):
                with self._lock:
                    benign = (worker.state in ("draining", "dead")
                              or self._state == "stopped")
                if not benign:
                    self._on_worker_failure(worker, "pipe closed")
                return
            kind = msg[0]
            if kind == "res":
                self._on_result(worker, msg[1], msg[2], msg[3])
            elif kind == "ready":
                worker.info = dict(msg[3]) if len(msg) > 3 else {}
                with self._lock:
                    self._pids.update([msg[1]]
                                      + list(worker.info.get("followers",
                                                             [])))
                worker.ready_event.set()
            elif kind == "counts":
                if msg[1] == worker.counts_seq:
                    worker.counts = msg[2]
                    worker.counts_event.set()
            elif kind == "prewarmed":
                worker.prewarm_built = int(msg[1])
                worker.prewarmed_event.set()
            elif kind == "drained":
                worker.stats = msg[1]
                worker.drained_event.set()

    def _beat_loop(self, worker: _Worker) -> None:
        """The worker's pongs (the heartbeat pipe); its end is the data
        reader's business."""
        while True:
            try:
                msg = worker.beat.recv()
            except (EOFError, OSError):
                return
            worker.last_pong = time.monotonic()
            worker.stats = msg[2]
            self._fold_worker_stats(worker)

    def _on_result(self, worker: _Worker, tid: str, status: str,
                   payload: Any) -> None:
        with worker.lock:
            req = worker.inflight.pop(tid, None)
        if req is None:
            return  # late duplicate (the request was rerouted) — drop
        self.policy.release(req.tenant)
        if status == "ok":
            with self._lock:
                self._counts["served"] += 1
            obs.metrics.inc("fleet.served")
            obs.metrics.observe(
                "serve.e2e_ms",
                (time.monotonic() - req.submitted_at) * 1e3)
            obs.event("fleet.reply", trace=tid, outcome="ok",
                      worker=worker.name, attempts=req.attempts)
            settle_future(req.future, result=payload)
        else:
            err = _decode_error(payload)
            if isinstance(err, DeadlineExceeded):
                with self._lock:
                    self._counts["deadline_expired"] += 1
            else:
                with self._lock:
                    self._counts["failed"] += 1
            obs.event("fleet.reply", trace=tid, outcome="error",
                      worker=worker.name, error=type(err).__name__)
            settle_future(req.future, exc=err)
        self._pump(worker)
        self._refresh_gauges()

    def _drop_worker_gauges(self, worker: _Worker) -> None:
        """Retire a departed worker's labeled gauges: a frozen
        queue_depth from a dead slot would read as phantom load to the
        scale controller (and grow /metrics forever as indices are
        never reused)."""
        lab = obs.metrics.labeled
        for g in ("fleet.worker.queue_depth", "fleet.worker.ema_ms",
                  "fleet.worker.shed", "fleet.worker.inflight",
                  "fleet.worker.devices"):
            obs.metrics.drop_gauge(lab(g, worker=worker.name))

    def _fold_worker_stats(self, worker: _Worker) -> None:
        """Heartbeat stats -> labeled gauges on the router's OWN metrics
        registry, so the ``/metrics`` exposition carries per-worker
        queue depth / EMA / shed — the controller (and any external
        autoscaler) reads THIS surface, not fleet internals."""
        s = worker.stats
        lab = obs.metrics.labeled
        obs.metrics.gauge(lab("fleet.worker.queue_depth",
                              worker=worker.name),
                          s.get("queue_depth", 0))
        if s.get("ema_ms") is not None:
            obs.metrics.gauge(lab("fleet.worker.ema_ms",
                                  worker=worker.name), s["ema_ms"])
        obs.metrics.gauge(lab("fleet.worker.shed", worker=worker.name),
                          s.get("shed", 0))
        if s.get("devices") is not None:
            # The capacity surface: after a devloss respawn this series
            # dips to the shrunken group size, as scraped off /metrics.
            obs.metrics.gauge(lab("fleet.worker.devices",
                                  worker=worker.name), s["devices"])
        with worker.lock:
            obs.metrics.gauge(lab("fleet.worker.inflight",
                                  worker=worker.name),
                              len(worker.inflight))

    # -- failure detection / recovery --------------------------------------

    def _monitor_loop(self) -> None:
        last_scale = 0.0
        while not self._stop.wait(self.heartbeat_interval_s):
            now = time.monotonic()
            with self._lock:
                workers = [w for w in self._workers.values()
                           if w.state == "ready"]
            for w in workers:
                if w.proc.exitcode is not None:
                    self._on_worker_failure(
                        w, f"exited rc {w.proc.exitcode}")
                    continue
                if (now - w.last_pong
                        > self.heartbeat_k * self.heartbeat_interval_s):
                    self._on_worker_failure(
                        w, f"{self.heartbeat_k} missed heartbeats "
                           f"({now - w.last_pong:.2f} s silent)")
                    continue
                w.ping_seq += 1
                try:
                    w.beat.send(("ping", w.ping_seq))
                except (OSError, ValueError, BrokenPipeError) as e:
                    self._on_worker_failure(w, f"ping failed: {e}")
            self._refresh_gauges(force=True)
            ctl = self._controller
            if ctl is not None and now - last_scale >= ctl.interval_s:
                last_scale = now
                try:
                    ctl.step()
                except Exception as e:  # noqa: BLE001 — the controller
                    # must never take down the failure detector
                    obs.notice(f"fleet: scale controller error "
                               f"({type(e).__name__}: {e})"[:300],
                               name="fleet.scale_error")

    def _on_worker_failure(self, worker: _Worker, why: str) -> None:
        with self._lock:
            if worker.state == "dead" or self._state == "stopped":
                return
            if worker.state == "starting":
                # The spawn path (_respawn / __init__) owns a
                # never-became-ready worker: its kill() closes the pipe
                # and lands the reader here, but counting a death and
                # respawning would DUPLICATE the spawn loop's own retry
                # (two workers minting the same name, orphan processes).
                worker.state = "dead"
                if self._workers.get(worker.name) is worker:
                    self._workers.pop(worker.name)
                return
            worker.state = "dead"
            self.ring.remove(worker.name)
            self.mesh_ring.remove(worker.name)
            self._counts["worker_deaths"] += 1
            respawn = self._state == "running"
            if self._workers.get(worker.name) is worker:
                self._workers.pop(worker.name)
        worker.kick.set()  # release the dispatcher thread
        obs.metrics.inc("fleet.worker_deaths")
        obs.metrics.gauge("fleet.workers", len(self.ring))
        with worker.lock:
            moved = list(worker.inflight.values())
            worker.inflight.clear()
            moved += worker.pending.drain()
        obs.event("fleet.worker_death", worker=worker.name, why=why,
                  generation=worker.generation, moved=len(moved),
                  ring=list(self.ring.members()))
        obs.notice(f"fleet: worker {worker.name} dead ({why}); "
                   f"rerouting {len(moved)} request(s)",
                   name="fleet.worker_death_notice")
        from ..obs import flightrec
        flightrec.trigger("worker_death", f"{worker.name}: {why}",
                          worker=worker.name, moved=len(moved))
        worker.kill()
        self._drop_worker_gauges(worker)
        obs.event("fleet.reroute", worker=worker.name, moved=len(moved),
                  keys=sorted({r.key for r in moved}))
        self._reroute_moved(moved)
        self._refresh_gauges()
        if respawn:
            obs.event("fleet.worker_restart", worker=worker.name,
                      generation=worker.generation + 1)
            self._start_spawner(worker.index, worker.generation + 1,
                                f"{worker.name}-respawn")

    def _reroute_moved(self, moved: List[_FleetRequest]) -> None:
        """Re-home requests stranded by a worker's departure — the ONE
        reroute policy (death and scale-down paths share it): expired
        deadlines answer ``DeadlineExceeded``; a request that already
        rode ``max_resubmits`` departures answers a structured
        ``RemoteWorkerError`` instead of bouncing forever; the rest are
        resubmitted idempotently under their original trace ids."""
        for req in moved:
            if req.deadline is not None and req.deadline.expired():
                self._expire(req, "rerouted")
            elif req.attempts >= self.max_resubmits:
                with self._lock:
                    self._counts["abandoned"] += 1
                self.policy.release(req.tenant)
                obs.event("fleet.reply", trace=req.trace_id,
                          outcome="abandoned", attempts=req.attempts)
                settle_future(req.future, exc=RemoteWorkerError(
                    "WorkerDied",
                    f"request {req.trace_id} abandoned after "
                    f"{req.attempts} worker deaths"))
            else:
                req.attempts += 1
                with self._lock:
                    self._counts["resubmitted"] += 1
                obs.metrics.inc("fleet.resubmitted")
                self._route(req)

    def _start_spawner(self, index: int, generation: int,
                       name: str) -> None:
        """Respawn or scale up on a thread of its own, which ``close()``
        joins: no worker outlives the fleet."""
        t = threading.Thread(target=self._respawn, args=(index, generation),
                             daemon=True, name=name)
        with self._lock:
            self._spawners = [s for s in self._spawners if s.is_alive()]
            t.start()       # under the lock: close() joins started threads
            self._spawners.append(t)

    def _respawn(self, index: int, generation: int) -> None:
        for attempt in range(3):
            with self._lock:
                if self._state != "running":
                    return
            w = self._spawn(index, generation + attempt,
                            prewarm=self._prewarm_shapes())
            if _wait_ready(w, time.monotonic() + self.spawn_timeout_s,
                           self._stop):
                self._join_ring(w)
                return
            w.kill()
            with self._lock:
                self._workers.pop(w.name, None)
            if self._stop.is_set():
                return
            obs.event("fleet.worker_spawn_failed", worker=w.name,
                      generation=w.generation, attempt=attempt + 1)

    # -- scaling -----------------------------------------------------------

    def attach_controller(self, controller: "ScaleController") -> None:
        self._controller = controller

    def scale_to(self, n: int) -> None:
        """Grow or shrink the ready worker set to ``n`` through the same
        join/leave machinery the failure detector uses (a drained-away
        worker's pending reroutes; its in-flight completes normally)."""
        n = max(1, int(n))
        with self._lock:
            ready = sorted((w for w in self._workers.values()
                            if w.state == "ready"),
                           key=lambda w: w.index)
            starting = sum(1 for w in self._workers.values()
                           if w.state == "starting")
        # Count STARTING workers toward the target: a repeated up
        # decision during the multi-second spawn window must not
        # over-provision past it.
        if len(ready) + starting < n:
            for _ in range(n - len(ready) - starting):
                i = self._take_index()
                self._start_spawner(i, 0, f"worker-{i}-spawn")
        elif len(ready) > n:
            for w in ready[n:]:
                self._drain_worker(w)

    def _drain_worker(self, worker: _Worker) -> None:
        """Scale-down leave: out of the ring first (new keys reroute),
        pending requests rerouted, in-flight left to finish, then a
        graceful drain message."""
        with self._lock:
            if worker.state != "ready":
                return
            worker.state = "draining"
            self.ring.remove(worker.name)
            self.mesh_ring.remove(worker.name)
        worker.kick.set()  # release the dispatcher thread
        obs.metrics.gauge("fleet.workers", len(self.ring))
        with worker.lock:
            moved = worker.pending.drain()
        obs.event("fleet.worker_leave", worker=worker.name,
                  moved=len(moved), ring=list(self.ring.members()))
        for req in moved:
            self._route(req)

        def _finish() -> None:
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                with worker.lock:
                    if not worker.inflight:
                        break
                if worker.proc.exitcode is not None:
                    break  # died mid-drain; reroute below, don't wait
                time.sleep(0.02)
            try:
                worker.send(("drain",))
                worker.drained_event.wait(10.0)
            except (OSError, ValueError, BrokenPipeError):
                pass
            worker.kill()
            self._drop_worker_gauges(worker)
            with self._lock:
                if self._workers.get(worker.name) is worker:
                    self._workers.pop(worker.name)
            # Anything STILL in flight (the worker crashed or timed out
            # mid-drain) is rerouted exactly like a death — a scale-down
            # must never be the place requests and tenant quota slots
            # silently leak.
            with worker.lock:
                leftovers = list(worker.inflight.values())
                worker.inflight.clear()
                leftovers += worker.pending.drain()
            self._reroute_moved(leftovers)

        threading.Thread(target=_finish, daemon=True,
                         name=f"{worker.name}-leave").start()

    # -- health / lifecycle ------------------------------------------------

    def health(self) -> Dict[str, Any]:
        """The fleet readiness snapshot (the ``/healthz`` payload in
        fleet mode): per-worker state/beat age/load, ring membership,
        per-tenant quota accounting, the scale-decision audit trail and
        the flight recorder's last dump path."""
        now = time.monotonic()
        with self._lock:
            state = self._state
            counts = dict(self._counts)
            workers = dict(self._workers)
            orphans = len(self._orphans)
            decisions = list(self._scale_decisions[-16:])
        wsnap = {}
        for name, w in sorted(workers.items()):
            with w.lock:
                wsnap[name] = {
                    "state": w.state, "pid": w.proc.pid,
                    "followers": list(w.info.get("followers", [])),
                    "generation": w.generation,
                    "devices": w.devices,
                    "full_devices": w.full_devices,
                    "inflight": len(w.inflight),
                    "pending": len(w.pending),
                    "pending_by_tenant": w.pending.depths(),
                    "last_pong_age_s": round(now - w.last_pong, 3),
                    "stats": dict(w.stats),
                }
        # Degraded while any worker runs SHORT of its spec'd mesh (a
        # devloss replacement serving at reduced capacity) — the fleet
        # is up, but an operator watching /healthz must see that it is
        # not whole until a full-size replacement rejoins.
        degraded = (len(self.ring) < len(workers)
                    or any(s["state"] != "ready" for s in wsnap.values())
                    or any(s["devices"] < s["full_devices"]
                           for s in wsnap.values()))
        status = (state if state != "running"
                  else ("degraded" if degraded else "ok"))
        # The standing resident's progress as folded from its host
        # worker's latest heartbeat (None when no resident configured
        # or its worker has not ponged yet).
        resident = None
        for s in wsnap.values():
            if s["stats"].get("resident"):
                resident = dict(s["stats"]["resident"])
                break
        from ..obs import flightrec
        return {
            "status": status,
            "resident": resident,
            "uptime_s": round(now - self._started_at, 3),
            "workers": wsnap,
            "ring": list(self.ring.members()),
            "mesh_ring": list(self.mesh_ring.members()),
            "orphaned": orphans,
            "tenants": self.policy.snapshot(),
            "counters": counts,
            "scale_decisions": decisions,
            "flight_recorder": dict(flightrec.stats(),
                                    last_dump=flightrec.last_dump()),
            "obs_metrics": obs.snapshot(),
        }

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def prewarm(self, shape: Tuple[int, ...], dtype: Any = None,
                transform: str = "r2c", *,
                decomp: Optional[str] = None, **kw: Any) -> int:
        """Broadcast ``Server.prewarm`` to every ready worker (each only
        serves its own key range, but prewarming all keeps a future
        reroute hot too) and wait for the acknowledgements in parallel;
        returns the total plans NEWLY BUILT across workers (0 when
        every bucket was already hot — same contract as
        ``Server.prewarm``). A 3D ``shape`` prewarms the single-shot
        volume plan on the MESH-CAPABLE workers only (the ones the
        fft3d ring routes to)."""
        code = ("f64" if dtype is not None
                and np.dtype(dtype) in (np.float64, np.complex128)
                else "f32")
        if len(shape) == 3:
            nx, ny, nz = int(shape[0]), int(shape[1]), int(shape[2])
            dec = decomp or self.volume_decomp
            key = plancache.request_key3d(nx, ny, nz, code, transform,
                                          dec)
            wire: Tuple[Any, ...] = (nx, ny, nz, code, transform, dec)
        else:
            nx, ny = int(shape[0]), int(shape[1])
            key = plancache.request_key(nx, ny, code, transform,
                                        self.shard)
            wire = (nx, ny, code, transform)
        with self._lock:
            self._hot_keys[key] = time.monotonic()
            workers = [w for w in self._workers.values()
                       if w.state == "ready"
                       and (len(wire) == 4
                            or self._capable(w.full_devices, w.devices))]
        # Clear-all THEN send-all: acks arrive concurrently, and a
        # stale ack from a previous (timed-out) prewarm cannot set an
        # event that was cleared after it landed.
        for w in workers:
            w.prewarmed_event.clear()
        sent = []
        for w in workers:
            try:
                w.send(("prewarm", [wire]))
                sent.append(w)
            except (OSError, ValueError, BrokenPipeError):
                continue
        total = 0
        deadline = time.monotonic() + self.spawn_timeout_s
        for w in sent:
            if w.prewarmed_event.wait(max(0.1,
                                          deadline - time.monotonic())):
                total += w.prewarm_built
        return total

    def kernel_counts(self, reset: bool = False,
                      timeout_s: float = 60.0) -> Dict[str, Any]:
        """Every ready worker's kernel counts, rank by rank (``{worker:
        [{"rank", "pid", "launches", "entries", "matmul", "jax"}, ...]}``),
        gathered through each worker's own server protocol; ``reset``
        sets them to 0 after reading. A worker that does not answer
        within ``timeout_s`` maps to None."""
        with self._lock:
            workers = [w for w in self._workers.values()
                       if w.state == "ready"]
        for w in workers:
            w.counts_seq += 1
            w.counts = None
            w.counts_event.clear()
            try:
                w.send(("counts", w.counts_seq, bool(reset)))
            except (OSError, ValueError, BrokenPipeError):
                continue
        deadline = time.monotonic() + timeout_s
        out: Dict[str, Any] = {}
        for w in workers:
            w.counts_event.wait(max(0.1, deadline - time.monotonic()))
            out[w.name] = w.counts
        return out

    def process_ids(self) -> List[int]:
        """Every pid this fleet's workers ran as (leaders and their
        followers, every generation)."""
        with self._lock:
            return sorted(self._pids)

    def close(self, drain: bool = True, timeout_s: float = 60.0) -> None:
        """Stop the fleet. ``drain=True``: reject new admissions, let
        every admitted request resolve (workers finish their queues;
        responses keep pumping the router queues), then stop workers.
        Leftovers after the timeout answer ``ServerClosed`` — the fleet
        inherits the single-process loss-proof close contract."""
        with self._lock:
            if self._state == "stopped":
                return
            already = self._state == "draining"
            self._state = "draining"
        if not already:
            obs.notice(f"fleet: draining (drain={drain})",
                       name="fleet.drain", drain=drain)
        deadline = time.monotonic() + timeout_s
        if drain:
            while time.monotonic() < deadline:
                with self._lock:
                    workers = list(self._workers.values())
                    left = len(self._orphans)
                for w in workers:
                    with w.lock:
                        left += len(w.pending) + len(w.inflight)
                if left == 0:
                    break
                time.sleep(0.02)
        self._stop.set()
        with self._lock:
            workers = list(self._workers.values())
            self._workers = {}
            leftovers = self._orphans
            self._orphans = []
            self._state = "stopped"
        for w in workers:
            w.state = "draining"
            w.kick.set()  # release the dispatcher thread
            self.ring.remove(w.name)
            self.mesh_ring.remove(w.name)
            with w.lock:
                leftovers += list(w.inflight.values())
                w.inflight.clear()
                leftovers += w.pending.drain()

            # Fire-and-forget from a disposable thread: a hung worker's
            # full pipe (or a dispatcher blocked mid-send holding the
            # send lock) must not wedge close() past its timeout — the
            # monitor that would have broken the pipe was just stopped,
            # and the join+kill below reaps the worker either way.
            def _goodbye(w=w):
                try:
                    w.send(("drain" if drain else "stop",))
                except (OSError, ValueError, BrokenPipeError):
                    pass

            threading.Thread(target=_goodbye, daemon=True,
                             name=f"{w.name}-goodbye").start()
        for w in workers:
            w.proc.join(max(0.1, min(5.0, deadline - time.monotonic())))
            w.kill()
            self._drop_worker_gauges(w)
        # A respawn or scale-up in flight sees the stop and kills what it
        # spawned; wait for it, so no worker outlives the fleet.
        with self._lock:
            spawners = list(self._spawners)
        for t in spawners:
            t.join(max(0.1, deadline - time.monotonic()) + 10.0)
        for req in leftovers:
            self.policy.release(req.tenant)
            settle_future(req.future, exc=ServerClosed(
                "fleet stopped before execution"))
        obs.metrics.gauge("fleet.workers", 0)
        with self._lock:
            counts = dict(self._counts)
        obs.notice(f"fleet: stopped ({counts['served']} served, "
                   f"{counts['shed']} shed, "
                   f"{counts['worker_deaths']} worker deaths)",
                   name="fleet.stop", counters=counts)


# ---------------------------------------------------------------------------
# metrics-driven worker-count controller
# ---------------------------------------------------------------------------

def parse_exposition_signals(text: str) -> Dict[str, float]:
    """Extract the controller's input signals from a Prometheus
    exposition body (the literal ``GET /metrics`` surface): live worker
    count, router pending, total shed (router + per-worker), summed
    worker queue depth, max worker EMA, capacity-weighted worker count
    (``dfft_fleet_capacity`` — devloss-shrunken workers count
    fractionally) and total acquired devices. Unknown/missing series
    read 0."""
    sig = {"workers": 0.0, "pending": 0.0, "shed_total": 0.0,
           "queue_depth": 0.0, "ema_ms": 0.0, "capacity": 0.0,
           "devices_total": 0.0}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name, _, rest = line.partition(" ")
        base = name.partition("{")[0]
        try:
            value = float(rest.split()[0])
        except (ValueError, IndexError):
            continue
        if base == "dfft_fleet_workers":
            sig["workers"] = value
        elif base == "dfft_fleet_pending":
            sig["pending"] = value
        elif base in ("dfft_fleet_shed_total",
                      "dfft_fleet_worker_shed"):
            sig["shed_total"] += value
        elif base in ("dfft_fleet_worker_queue_depth",
                      "dfft_serve_queue_depth"):
            sig["queue_depth"] += value
        elif base in ("dfft_fleet_worker_ema_ms", "dfft_serve_ema_ms"):
            sig["ema_ms"] = max(sig["ema_ms"], value)
        elif base == "dfft_fleet_capacity":
            sig["capacity"] = value
        elif base == "dfft_fleet_worker_devices":
            sig["devices_total"] += value
    return sig


class ScaleController:
    """Worker-count controller over the ``/metrics`` exposition.

    Policy (deliberately simple and fully audited): scale UP one worker
    when the scrape shows new shed since the last step or total queue
    depth above ``queue_high`` per worker; scale DOWN one worker after
    ``down_idle_steps`` consecutive idle steps (no shed growth, empty
    queues); both within ``[min_workers, max_workers]`` and separated by
    ``cooldown_s``. Every ACTED decision (up/down) emits an auditable
    record through ``obs.event`` (``fleet.scale_decision``), the flight
    recorder (``scale_decision`` trigger, per-kind cooldown) and
    ``health()["scale_decisions"]``; ``hold`` steps return their record
    (with the signal snapshot and reason) from :meth:`step` but are not
    persisted — at one step per ``interval_s`` they would flood the
    audit trail with non-events."""

    def __init__(self, fleet: Fleet, min_workers: int, max_workers: int,
                 *, interval_s: float = 1.0, cooldown_s: float = 5.0,
                 queue_high: float = 4.0, down_idle_steps: int = 8,
                 render: Any = None):
        if min_workers < 1 or max_workers < min_workers:
            raise ValueError("need 1 <= min_workers <= max_workers")
        self.fleet = fleet
        self.min_workers = int(min_workers)
        self.max_workers = int(max_workers)
        self.interval_s = float(interval_s)
        self.cooldown_s = float(cooldown_s)
        self.queue_high = float(queue_high)
        self.down_idle_steps = int(down_idle_steps)
        self._render = render  # injectable exposition source (tests)
        self._last_shed: Optional[float] = None
        self._idle_steps = 0
        # None until the first act: a cooldown runs from an act, never
        # from the clock's origin (a host up for less than cooldown_s
        # would otherwise hold its first decision).
        self._last_action_at: Optional[float] = None

    def read_signals(self) -> Dict[str, float]:
        if self._render is not None:
            text = self._render()
        else:
            from ..obs import promexp
            text = promexp.render()
        return parse_exposition_signals(text)

    def step(self) -> Dict[str, Any]:
        """One control step; returns (and records) the decision."""
        sig = self.read_signals()
        now = time.monotonic()
        shed = sig["shed_total"]
        shed_delta = (0.0 if self._last_shed is None
                      else max(0.0, shed - self._last_shed))
        workers = int(sig["workers"])
        # Capacity-weighted worker count: a devloss-shrunken
        # worker counts fractionally, so the queue-pressure threshold
        # tightens while the fleet runs short — 4-of-8 devices is half
        # a worker, not a worker. Absent series (pre-scrape) falls back
        # to the raw count.
        capacity = sig["capacity"] if sig["capacity"] > 0 else workers
        queue_total = sig["queue_depth"] + sig["pending"]
        cooling = (self._last_action_at is not None
                   and now - self._last_action_at < self.cooldown_s)
        if self._last_shed is None or not cooling:
            # A cooldown hold must NOT consume observed shed growth:
            # rejections during the window (clients backing off leave
            # the queues empty) still demand the post-cooldown up.
            self._last_shed = shed
        # CONSECUTIVE quiet steps drive scale-down: any step that saw
        # shed growth or queued work zeroes the streak, whatever branch
        # it lands in (a cooldown hold under load must not count).
        quiet = shed_delta == 0 and queue_total == 0
        self._idle_steps = self._idle_steps + 1 if quiet else 0
        action, reason = "hold", "signals nominal"
        if workers < self.min_workers:
            action = "up"
            reason = f"below min_workers {self.min_workers}"
        elif cooling:
            reason = "cooldown"
        elif shed_delta > 0 and workers < self.max_workers:
            action = "up"
            reason = f"shed grew by {shed_delta:g} since last step"
        elif (queue_total > self.queue_high * max(capacity, 1.0)
                and workers < self.max_workers):
            action = "up"
            reason = (f"queue depth {queue_total:g} > "
                      f"{self.queue_high:g}/worker"
                      + (f" (capacity-weighted: {capacity:g} of "
                         f"{workers} workers)"
                         if capacity < workers else ""))
        elif (quiet and self._idle_steps >= self.down_idle_steps
                and workers > self.min_workers):
            action = "down"
            reason = f"{self._idle_steps} idle steps"
        if action != "hold":
            self._idle_steps = 0
            self._last_action_at = now
        target = workers + (1 if action == "up" else
                            -1 if action == "down" else 0)
        target = min(max(target, self.min_workers), self.max_workers)
        record = {"ts": round(time.time(), 3), "action": action,
                  "reason": reason, "workers": workers, "target": target,
                  "signals": {k: round(v, 4) for k, v in sig.items()}}
        if action != "hold":
            with self.fleet._lock:
                self.fleet._scale_decisions.append(record)
                del self.fleet._scale_decisions[:-64]
            obs.metrics.inc("fleet.scale_decisions")
            obs.event("fleet.scale_decision", **record)
            obs.notice(f"fleet: scale {action} {workers} -> {target} "
                       f"({reason})", name="fleet.scale_notice")
            from ..obs import flightrec
            flightrec.trigger("scale_decision",
                              f"{action} {workers} -> {target}: {reason}",
                              **record["signals"])
            self.fleet.scale_to(target)
        return record
