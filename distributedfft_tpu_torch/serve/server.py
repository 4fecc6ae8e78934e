"""The long-lived FFT server: admission control, coalescing, circuits —
the JAX package's ``serve/server.py`` over ``torch.distributed``.

``Server`` is one resident process (one rank per process: see "Ranks"
below) that keeps built plans hot and answers 2D image AND 3D volume FFT
requests under an explicit robustness envelope. Images coalesce into
batched-2D stacked execution; volumes execute SINGLE-SHOT through the
slab/pencil plan families (no batch axis to stack along), under the same
admission, deadline, circuit-breaker and drain envelope. The request
path:

1. **Admission** (``submit``; caller's thread, microseconds): a closed or
   draining server rejects with :class:`ServerClosed`; a key whose
   circuit is open rejects with ``CircuitOpen``; then the BOUNDED queue
   sheds load — queue full, estimated queue delay (depth x per-request
   EMA) over the latency budget, or over the request's own deadline —
   with a structured :class:`Overloaded` carrying the numbers the client
   needs to back off. Queueing is never unbounded latency.
2. **Coalescing** (worker thread): the queue head is batched with every
   queued request that shares its coalescing key (shape/dtype/transform,
   ``plancache.request_key``) and direction, up to ``max_coalesce``; the
   stack executes as ONE ``Batched2DFFTPlan`` call from the LRU plan
   cache (power-of-two batch buckets; ``batch_chunk=1`` by default, one
   image after another — bit-identical to single-shot execution).
3. **Execution envelope**: per-request deadlines propagate cooperatively
   (``resilience.deadline.scope``) into the fallback ladder, an expired
   request is answered ``DeadlineExceeded`` WITHOUT executing, and the
   whole batch runs inside the per-key circuit breaker — K consecutive
   failures open the circuit (fast structured rejection, plan-cache
   entries invalidated so the half-open probe rebuilds), transitions land
   in the event log as ``serve.circuit.*``.
4. **Data path**: requests and replies are numpy arrays. The worker
   stacks a batch on the host (``serve.stack_ms``), copies it to the
   server's device (``serve.copy_in_ms``), executes and waits for the
   device (``serve.device_ms``) and copies the reply back with ``.cpu()``
   (``serve.copy_out_ms``); ``serve.exec_ms`` spans all four, so it never
   stops before the device has finished. All device work runs under
   ``parallel.mesh.DEVICE_LOCK``.
5. **Observability**: ``health()`` is the readiness snapshot (status,
   queue depth, shed counts, per-circuit state, plan-cache hit rate, the
   metrics registry); every decision is an ``obs`` event/metric.
6. **Drain** (``close(drain=True)`` — the CLI's SIGTERM handler): stop
   admitting (new submits get ``ServerClosed``), finish everything
   already admitted, then stop the worker and emit ``serve.drain`` /
   ``serve.stop``.

**Ranks.** The JAX server is one process driving a device mesh. Here a
server over P > 1 ranks is P processes, each constructing the same
``Server`` in one ``torch.distributed`` world. Group rank 0 is the
LEADER: it alone admits, queues, coalesces, keeps the breakers and the
futures, and takes every host decision (deadline expiry, breaker state,
the injected ``server:slow``). Ranks 1..P-1 run a FOLLOWER loop: for each
batch the leader broadcasts what it decided (the job: shape, dtype,
transform, direction, bucket, decomposition, whether it built the plan;
or stop / invalidate / keep-alive); every rank builds or looks up the
same plan, the leader scatters the padded stack (a pencil volume is
broadcast whole), every rank executes its block, and the reply is
gathered. A batch the leader expires or rejects is never posted. After
the build and after the execution every rank posts a one-element MAX
all-reduce of its failure flag, so a failure on any rank fails the batch
on every rank with one verdict (``RankFailed`` on a rank that did not
fail itself).
"""

from __future__ import annotations

import collections
import dataclasses
import os
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import obs
from .. import params as pm
from ..cli.common import LATER_ITEMS
from ..parallel import mesh as pmesh
from ..resilience import deadline as dl
from ..resilience import inject
from ..resilience.circuit import CircuitBreaker
from ..resilience.deadline import Deadline, DeadlineExceeded
from ..utils.native_planner import padded_extent
from . import plancache

LATER_FLEET = LATER_ITEMS[14]


class Overloaded(RuntimeError):
    """Structured load-shed rejection: the request was NOT admitted.
    ``reason`` is ``queue_full`` | ``latency_budget`` | ``deadline`` —
    the queue would have held it longer than the budget (or its own
    deadline) allows."""

    def __init__(self, reason: str, queue_depth: int, est_delay_ms: float,
                 budget_ms: float):
        super().__init__(
            f"overloaded ({reason}): queue depth {queue_depth}, estimated "
            f"delay {est_delay_ms:.1f} ms, budget {budget_ms:.1f} ms")
        self.reason = reason
        self.queue_depth = int(queue_depth)
        self.est_delay_ms = float(est_delay_ms)
        self.budget_ms = float(budget_ms)


class ServerClosed(RuntimeError):
    """The server is draining or stopped; no new work is admitted."""


class RankFailed(RuntimeError):
    """Another rank of a multi-rank server failed the batch (this rank
    did not fail itself): the one verdict every rank reaches."""


@dataclasses.dataclass
class _Request:
    x: np.ndarray
    nx: int
    ny: int
    transform: str
    double: bool
    direction: str
    base_key: str
    deadline: Optional[Deadline]
    future: Future
    submitted_at: float
    trace_id: str = ""
    nz: Optional[int] = None        # 3D volumes only
    decomp: Optional[str] = None    # slab | pencil, volumes only

    @property
    def volume(self) -> bool:
        return self.nz is not None

    def coalesce_key(self) -> Tuple[str, str]:
        return (self.base_key, self.direction)


def normalize_request(x: Any, transform: str, direction: str,
                      ny: Optional[int]
                      ) -> Tuple[np.ndarray, Tuple[int, ...], bool]:
    """Validate one request payload; returns ``(x, shape, double)`` with
    ``shape`` the LOGICAL extents — ``(nx, ny)`` for a 2D image,
    ``(nx, ny, nz)`` for a 3D volume. ``ny`` names the logical extent of
    the HALVED LAST axis (y for images, z for volumes), needed to
    key/construct the plan — a spectral r2c payload alone cannot
    distinguish an even/odd last extent, so inverse r2c callers may pass
    it; default assumes even. Module-level so a router validates and keys
    requests with EXACTLY the vocabulary each ``Server`` uses."""
    if transform not in ("r2c", "c2c"):
        raise ValueError(f"transform must be r2c|c2c, got {transform!r}")
    if direction not in ("forward", "inverse"):
        raise ValueError(
            f"direction must be forward|inverse, got {direction!r}")
    x = np.asarray(x)
    if x.ndim not in (2, 3):
        raise ValueError(
            f"serve requests are single 2D images or 3D volumes, got "
            f"shape {x.shape} (batching is the server's job — submit "
            "images concurrently and they coalesce; volumes execute "
            "single-shot)")
    complex_in = (transform == "c2c") or (direction == "inverse")
    if complex_in != np.iscomplexobj(x):
        raise ValueError(
            f"{transform} {direction} expects a "
            f"{'complex' if complex_in else 'real'} payload, got "
            f"dtype {x.dtype}")
    double = x.dtype in (np.float64, np.complex128)
    if transform == "c2c" or direction == "forward":
        shape = tuple(int(s) for s in x.shape)
        if ny is not None and int(ny) != shape[-1]:
            raise ValueError(f"ny {ny} disagrees with payload {x.shape}")
        return x, shape, double
    # inverse r2c: the LAST axis is spectral (n_last//2 + 1)
    ns = int(x.shape[-1])
    n_last = int(ny) if ny is not None else 2 * (ns - 1)
    if n_last // 2 + 1 != ns:
        raise ValueError(
            f"ny {n_last} inconsistent with spectral payload {x.shape} "
            f"(expects ny//2+1 == {ns})")
    return x, tuple(int(s) for s in x.shape[:-1]) + (n_last,), double


_EMA_ALPHA = 0.2

# Per-process trace-id counter: ids are ``<pid hex>-<seq hex>``.
_TRACE_SEQ = [0]
_TRACE_LOCK = threading.Lock()

# Shed-burst detection window for the flight-recorder trigger: this many
# sheds inside SHED_BURST_WINDOW_S seconds dump the ring once per
# cooldown ($DFFT_FLIGHTREC_SHED_BURST overrides the count).
SHED_BURST_WINDOW_S = 2.0
SHED_BURST_DEFAULT = 10

# Seconds an idle leader waits before it posts a keep-alive to its
# followers, whose broadcast would otherwise reach the group's timeout.
KEEPALIVE_S = 10.0

# The leader's posts (the first slot of the broadcast header).
_OP_STOP, _OP_EXEC, _OP_INVALIDATE, _OP_NOOP = 0, 1, 2, 3


def _new_trace_id() -> str:
    with _TRACE_LOCK:
        _TRACE_SEQ[0] += 1
        return f"{os.getpid():x}-{_TRACE_SEQ[0]:06x}"


def settle_future(fut: Future, *, result: Any = None,
                  exc: Optional[BaseException] = None) -> bool:
    """Resolve ``fut`` exactly once against a CONCURRENT resolver: the
    loser of a race between close() and a slow worker reports False
    instead of raising ``InvalidStateError``."""
    if fut.done():
        return False
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
    except InvalidStateError:
        return False
    return True


@dataclasses.dataclass(frozen=True)
class _Job:
    """What one execution needs on every rank: the plan's identity and
    the direction (the leader's broadcast header carries exactly this)."""

    volume: bool
    nx: int
    ny: int
    nz: int
    transform: str
    double: bool
    direction: str
    bucket: int = 1
    decomp: str = "slab"

    def base_key(self, shard: str) -> str:
        code = "f64" if self.double else "f32"
        if self.volume:
            return plancache.request_key3d(self.nx, self.ny, self.nz, code,
                                           self.transform, self.decomp)
        return plancache.request_key(self.nx, self.ny, code,
                                     self.transform, shard)

    def cache_key(self, shard: str) -> str:
        base = self.base_key(shard)
        return base if self.volume else plancache.cache_key(base,
                                                            self.bucket)

    def header(self, op: int, built: bool) -> List[int]:
        return [op, int(self.volume), self.nx, self.ny, self.nz,
                int(self.transform == "c2c"), int(self.double),
                int(self.direction == "inverse"), self.bucket,
                int(self.decomp == "pencil"), int(built)]

    @staticmethod
    def from_header(h: List[int]) -> Tuple[int, "_Job", bool]:
        job = _Job(volume=bool(h[1]), nx=h[2], ny=h[3], nz=h[4],
                   transform="c2c" if h[5] else "r2c", double=bool(h[6]),
                   direction="inverse" if h[7] else "forward", bucket=h[8],
                   decomp="pencil" if h[9] else "slab")
        return h[0], job, bool(h[10])


_HEADER_LEN = 11


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def inherit_threads() -> None:
    """Give the calling (new) thread the process's intra-op thread count:
    OpenMP keeps that count per thread, so a thread the server starts
    would otherwise run host ops on every core, which four CPU ranks on
    one host oversubscribe."""
    torch.set_num_threads(torch.get_num_threads())


class Server:
    """In-process FFT-as-a-service core (see module docstring).

    Parameters mirror a production serving config: ``max_queue`` bounds
    the admission queue, ``latency_budget_ms`` is the shed threshold on
    estimated queue delay, ``max_coalesce`` caps the stacked batch,
    ``circuit_k``/``circuit_cooldown_s`` parameterize the per-key
    breaker, and ``config`` is the Config TEMPLATE every served plan is
    built from (wire/guards/comm surface; ``double_prec`` is overridden
    per request from the payload dtype). ``shard`` picks the batched-2D
    decomposition: ``"batch"`` (default) or ``"x"`` (slab-style with a
    real exchange). ``volume_decomp`` is the default 3D decomposition
    (``slab`` | ``pencil``) of a volume request that names none.
    ``group`` is the process group of a server over P > 1 ranks (None:
    the world, which must then hold P ranks); ``device`` the device the
    plans run on (the card by default; tests pass ``"cpu"``)."""

    def __init__(self, partition: Optional[pm.SlabPartition] = None,
                 config: Optional[pm.Config] = None, group: Any = None,
                 shard: str = "batch", *, max_queue: int = 64,
                 latency_budget_ms: float = 1000.0, max_coalesce: int = 8,
                 batch_chunk: Optional[int] = 1, cache_capacity: int = 8,
                 circuit_k: int = 3, circuit_cooldown_s: float = 5.0,
                 volume_decomp: str = "slab", name: str = "dfft-serve",
                 device: "str | torch.device" = "cuda"):
        if shard not in ("batch", "x"):
            raise ValueError(f"shard must be 'batch' or 'x', got {shard!r}")
        if volume_decomp not in plancache.VOLUME_DECOMPS:
            raise ValueError(
                f"volume_decomp must be slab|pencil, got {volume_decomp!r}")
        if max_queue < 1 or max_coalesce < 1:
            raise ValueError("max_queue and max_coalesce must be >= 1")
        from ..models.base import resolve_device
        self.device = resolve_device(device)
        self.partition = partition or pm.SlabPartition(1)
        self.config = config or pm.Config()
        self.group = group
        self.shard = shard
        self.volume_decomp = volume_decomp
        self.max_queue = int(max_queue)
        self.latency_budget_ms = float(latency_budget_ms)
        self.max_coalesce = int(max_coalesce)
        self.batch_chunk = batch_chunk if shard == "batch" else None
        self.circuit_k = int(circuit_k)
        self.circuit_cooldown_s = float(circuit_cooldown_s)
        self.name = name
        self.cache = plancache.PlanCache(cache_capacity)
        self._P = self.partition.p
        self.rank, self._src = 0, 0
        self._comm_dev = torch.device("cpu")
        if self._P > 1:
            if not dist.is_initialized():
                raise RuntimeError(
                    "a server over P > 1 ranks needs a torch.distributed "
                    "world: start one rank per process and call "
                    "distributedfft_tpu_torch.maybe_initialize() first")
            size = dist.get_world_size(group)
            if size != self._P:
                raise ValueError(f"the process group has {size} ranks but "
                                 f"the partition asks for {self._P}")
            self.rank = dist.get_rank(group)
            self._src = (dist.get_global_rank(group, 0)
                         if group is not None else 0)
            if dist.get_backend(group) == "nccl":
                self._comm_dev = torch.device("cuda",
                                              torch.cuda.current_device())
        self.leader = self.rank == 0
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._pending: List[_Request] = []
        self._inflight_reqs: List[_Request] = []
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._ema_ms: Optional[float] = None
        self._state = "running"  # running | draining | stopped
        self._started_at = time.monotonic()
        self._counts = {"admitted": 0, "served": 0, "shed": 0,
                        "rejected_closed": 0, "rejected_circuit": 0,
                        "deadline_expired": 0, "batches": 0,
                        "batch_failures": 0, "coalesced": 0}
        self._inflight = 0
        self._shed_times: collections.deque = collections.deque()
        self._resident: Optional[Any] = None  # attach_resident()
        self._last_post = time.monotonic()
        self._stop_posted = False
        obs.event("serve.start", server=name, shard=shard,
                  ranks=self.partition.num_ranks, max_queue=max_queue,
                  latency_budget_ms=latency_budget_ms,
                  max_coalesce=max_coalesce, circuit_k=circuit_k,
                  rank=self.rank)
        target = self._run if self.leader else self._follow
        self._worker = threading.Thread(
            target=target, daemon=True,
            name=f"{name}-{'worker' if self.leader else 'follower'}")
        self._worker.start()

    # -- context manager ---------------------------------------------------

    def __enter__(self) -> "Server":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close(drain=True)

    # -- admission ---------------------------------------------------------

    def _normalize(self, x: Any, transform: str, direction: str,
                   ny: Optional[int]
                   ) -> Tuple[np.ndarray, Tuple[int, ...], bool]:
        return normalize_request(x, transform, direction, ny)

    def _breaker(self, key: str) -> CircuitBreaker:
        """Caller holds the lock. The map is BOUNDED like the plan cache:
        over the cap, idle breakers (closed, zero consecutive failures)
        are pruned; open/half-open/failing ones always survive."""
        b = self._breakers.get(key)
        if b is None:
            cap = max(64, 8 * self.cache.capacity)
            if len(self._breakers) >= cap:
                for k in [k for k, v in self._breakers.items()
                          if v.state == "closed"
                          and v.snapshot()["consecutive_failures"] == 0]:
                    del self._breakers[k]
            b = CircuitBreaker(key, self.circuit_k, self.circuit_cooldown_s,
                               metrics_prefix="serve.circuit")
            self._breakers[key] = b
        return b

    def _shed(self, reason: str, depth: int, est_ms: float,
              budget_ms: float) -> Overloaded:
        self._counts["shed"] += 1
        obs.metrics.inc("serve.shed")
        obs.event("serve.shed", reason=reason, queue_depth=depth,
                  est_delay_ms=round(est_ms, 2),
                  budget_ms=round(budget_ms, 2))
        # Shed-burst flight-recorder trigger: a sustained rejection storm
        # dumps the ring once per cooldown window.
        now = time.monotonic()
        self._shed_times.append(now)
        while self._shed_times and now - self._shed_times[0] \
                > SHED_BURST_WINDOW_S:
            self._shed_times.popleft()
        try:
            burst = int(os.environ.get("DFFT_FLIGHTREC_SHED_BURST",
                                       str(SHED_BURST_DEFAULT)))
        except ValueError:
            burst = SHED_BURST_DEFAULT
        if burst > 0 and len(self._shed_times) >= burst:
            from ..obs import flightrec
            flightrec.trigger(
                "shed_burst",
                f"{len(self._shed_times)} sheds in "
                f"{SHED_BURST_WINDOW_S:.0f}s (last: {reason})",
                queue_depth=depth, budget_ms=budget_ms)
        return Overloaded(reason, depth, est_ms, budget_ms)

    def submit(self, x: Any, transform: str = "r2c",
               direction: str = "forward", *, ny: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               decomp: Optional[str] = None) -> Future:
        """Admit one FFT request — a single 2D image (coalescing-
        eligible) or a 3D volume (keyed ``fft3d/...``, executed
        SINGLE-SHOT through the slab/pencil plan families; ``decomp``
        overrides the server's ``volume_decomp`` default). Returns a
        ``Future`` resolving to the result array, or raising the
        structured rejection (:class:`Overloaded` / ``CircuitOpen`` /
        :class:`ServerClosed` / ``DeadlineExceeded``). Admission itself
        raises — a rejected request never occupies the queue. Only the
        leader (group rank 0) admits."""
        if not self.leader:
            raise RuntimeError(
                f"rank {self.rank} follows the leader: submit requests on "
                "group rank 0")
        x, shape, double = self._normalize(x, transform, direction, ny)
        code = "f64" if double else "f32"
        if len(shape) == 3:
            dec = decomp or self.volume_decomp
            key = plancache.request_key3d(
                shape[0], shape[1], shape[2], code, transform, dec)
            nz: Optional[int] = shape[2]
        else:
            if decomp is not None:
                raise ValueError("decomp applies to 3D volume requests "
                                 f"only, got a {len(shape)}D payload")
            key = plancache.request_key(
                shape[0], shape[1], code, transform, self.shard)
            dec, nz = None, None
        deadline = (Deadline.after_ms(deadline_ms)
                    if deadline_ms is not None else None)
        with self._lock:
            if self._state != "running":
                self._counts["rejected_closed"] += 1
                obs.metrics.inc("serve.rejected_closed")
                raise ServerClosed(f"server is {self._state}; "
                                   "not admitting new requests")
            breaker = self._breaker(key)
            if (breaker.state == "open"
                    and breaker.retry_after_s() > 0):
                self._counts["rejected_circuit"] += 1
                raise breaker.reject()
            depth = len(self._pending) + self._inflight
            est_ms = (depth * self._ema_ms) if self._ema_ms else 0.0
            if len(self._pending) >= self.max_queue:
                # est_ms (not inf): the rejection must serialize as
                # strict JSON in the HTTP 429 body and the event log.
                raise self._shed("queue_full", depth, est_ms,
                                 self.latency_budget_ms)
            if est_ms > self.latency_budget_ms:
                raise self._shed("latency_budget", depth, est_ms,
                                 self.latency_budget_ms)
            if deadline is not None and est_ms >= deadline.remaining_ms():
                raise self._shed("deadline", depth, est_ms,
                                 deadline.remaining_ms())
            fut: Future = Future()
            tid = _new_trace_id()
            req = _Request(x=x, nx=shape[0], ny=shape[1],
                           transform=transform, double=double,
                           direction=direction, base_key=key,
                           deadline=deadline, future=fut,
                           submitted_at=time.monotonic(), trace_id=tid,
                           nz=nz, decomp=dec)
            # The id rides the future so callers (the HTTP front end's
            # X-DFFT-Trace header) can hand it back to the client.
            fut.trace_id = tid  # type: ignore[attr-defined]
            self._pending.append(req)
            self._counts["admitted"] += 1
            obs.metrics.inc("serve.requests")
            obs.metrics.gauge("serve.queue_depth", len(self._pending))
            obs.event("serve.admit", trace=tid, key=key,
                      direction=direction,
                      queue_depth=len(self._pending))
            self._cv.notify()
            return fut

    def request(self, x: Any, transform: str = "r2c",
                direction: str = "forward", *, ny: Optional[int] = None,
                deadline_ms: Optional[float] = None,
                decomp: Optional[str] = None,
                timeout_s: Optional[float] = None) -> np.ndarray:
        """Blocking convenience wrapper over :meth:`submit`."""
        return self.submit(x, transform, direction, ny=ny,
                           deadline_ms=deadline_ms,
                           decomp=decomp).result(timeout_s)

    # -- worker (the leader) -----------------------------------------------

    def _take_batch(self) -> List[_Request]:
        """Caller holds the lock: pop the queue head plus every queued
        request sharing its coalescing key and direction (FIFO order
        within the key), up to ``max_coalesce``."""
        head = self._pending.pop(0)
        batch = [head]
        # Volumes execute SINGLE-SHOT: a volume head takes the worker
        # alone and every other queued request stays put.
        if self.max_coalesce > 1 and not head.volume:
            keep: List[_Request] = []
            for r in self._pending:
                if (len(batch) < self.max_coalesce
                        and r.coalesce_key() == head.coalesce_key()):
                    batch.append(r)
                else:
                    keep.append(r)
            self._pending = keep
        obs.metrics.gauge("serve.queue_depth", len(self._pending))
        self._inflight = len(batch)
        # Held until the worker clears it after execution (deliberately
        # NO finally in _run) so close() can answer these futures too if
        # the worker thread dies mid-execution.
        self._inflight_reqs = batch
        obs.event("serve.coalesce", key=head.base_key, n=len(batch),
                  traces=[r.trace_id for r in batch])
        return batch

    def _run(self) -> None:
        inherit_threads()
        while True:
            with self._cv:
                while not self._pending and self._state == "running":
                    self._cv.wait(0.05)
                    if (self._P > 1 and not self._pending
                            and time.monotonic() - self._last_post
                            > KEEPALIVE_S):
                        break
                if not self._pending and self._state == "running":
                    batch = None        # an idle leader's keep-alive
                elif not self._pending:
                    break  # draining/stopped and drained
                else:
                    batch = self._take_batch()
            if batch is None:
                with pmesh.DEVICE_LOCK:
                    self._post([_OP_NOOP] + [0] * (_HEADER_LEN - 1))
                continue
            try:
                self._execute(batch)
            except Exception as err:  # noqa: BLE001 — the worker is the
                # only serving thread: ANY escape must fail THIS batch
                # loudly and keep serving, never die silently with
                # futures dangling and close() left to hang.
                obs.metrics.inc("serve.batch_failures")
                obs.notice(
                    f"serve: worker error outside the execution envelope "
                    f"({type(err).__name__}: {err})"[:300],
                    name="serve.worker_error")
                for r in batch:
                    settle_future(r.future, exc=err)
            # Deliberately NOT a finally: on a BaseException killing the
            # thread itself the popped batch must STAY in _inflight_reqs
            # so close() can answer its futures with ServerClosed.
            with self._lock:
                self._inflight = 0
                self._inflight_reqs = []

    def _expire(self, req: _Request, detail: str) -> None:
        self._counts["deadline_expired"] += 1
        obs.metrics.inc("serve.deadline_expired")
        over = -req.deadline.remaining_ms() if req.deadline else 0.0
        obs.event("serve.deadline_expired", key=req.base_key, detail=detail,
                  overrun_ms=round(over, 2), trace=req.trace_id)
        obs.event("serve.reply", trace=req.trace_id,
                  outcome="deadline_expired")
        settle_future(req.future, exc=DeadlineExceeded(
            f"deadline exceeded by {over:.1f} ms ({detail})",
            detail=detail, overrun_ms=over))

    # -- plans -------------------------------------------------------------

    def _make_plan(self, nx: int, ny: int, transform: str, double: bool,
                   bucket: int) -> Any:
        from ..models.batched2d import Batched2DFFTPlan
        cfg = dataclasses.replace(self.config, double_prec=double)
        ck = self.batch_chunk
        if ck:
            # batch_chunk must divide the plan's LOCAL padded batch; a
            # configured chunk larger than a small bucket's local batch
            # clamps to its largest divisor — an uncoalesced request must
            # not be unbuildable under --batch-chunk > 1.
            P = self.partition.p
            local_b = bucket if P <= 1 else padded_extent(bucket, P) // P
            ck = max(d for d in range(1, min(ck, local_b) + 1)
                     if local_b % d == 0)
        return Batched2DFFTPlan(
            bucket, nx, ny, self.partition, cfg, shard=self.shard,
            transform=transform, batch_chunk=ck, device=self.device,
            group=self.group)

    def _make_volume_plan(self, nx: int, ny: int, nz: int, transform: str,
                          double: bool, decomp: str) -> Any:
        """Build the single-shot 3D plan a volume request executes on:
        the server's partition width spread over the slab x-axis, or its
        most-square (p1, p2) pencil factorization."""
        from ..models.pencil import PencilFFTPlan
        from ..models.slab import SlabFFTPlan
        from ..parallel.mesh import best_pencil_grid
        cfg = dataclasses.replace(self.config, double_prec=double)
        g = pm.GlobalSize(nx, ny, nz)
        p = self.partition.p
        if decomp == "slab":
            return SlabFFTPlan(g, pm.SlabPartition(p), cfg,
                               transform=transform, device=self.device,
                               group=self.group)
        if p > 1 and self.group not in (None, dist.group.WORLD):
            raise ValueError("a pencil volume spans the world's row and "
                             "column groups; serve it from a server over "
                             "the world group")
        p1, p2 = best_pencil_grid(p)
        return PencilFFTPlan(g, pm.PencilPartition(p1, p2), cfg,
                             transform=transform, device=self.device)

    def _job_plan(self, job: _Job) -> Any:
        if job.volume:
            return self._make_volume_plan(job.nx, job.ny, job.nz,
                                          job.transform, job.double,
                                          job.decomp)
        return self._make_plan(job.nx, job.ny, job.transform, job.double,
                               job.bucket)

    # -- execution (every rank) ----------------------------------------------

    @staticmethod
    def _exec(plan: Any, job: _Job, x: torch.Tensor) -> torch.Tensor:
        fwd = job.direction == "forward"
        if not job.volume:
            return plan.exec_forward(x) if fwd else plan.exec_inverse(x)
        if job.transform == "r2c":
            return plan.exec_r2c(x) if fwd else plan.exec_c2r(x)
        return plan.exec_c2c(x) if fwd else plan.exec_c2c_inv(x)

    @staticmethod
    def _crop(plan: Any, job: _Job, out: torch.Tensor) -> np.ndarray:
        """The reply on the host: ``.cpu()`` of the stack on one rank; on
        P ranks the plan's crop, which gathers every rank's block
        (collective) and crops the pad lanes."""
        if plan.fft3d and not job.volume:
            return out.cpu().numpy()
        fwd = job.direction == "forward"
        return plan.crop_spectral(out) if fwd else plan.crop_real(out)

    def _run_job(self, job: _Job, payload: np.ndarray
                 ) -> Tuple[np.ndarray, bool, Dict[str, float]]:
        """Execute one job under ``DEVICE_LOCK``: ``(reply, cache hit,
        {copy_in_ms, device_ms, copy_out_ms})``. On P > 1 ranks the
        leader posts the job to its followers first."""
        ckey = job.cache_key(self.shard)
        with pmesh.DEVICE_LOCK:
            if self._P == 1:
                plan, hit = self.cache.get_or_build(
                    ckey, lambda: self._job_plan(job))
                t0 = time.perf_counter()
                x = torch.from_numpy(np.ascontiguousarray(payload)).to(
                    self.device)
                _sync(self.device)
                t1 = time.perf_counter()
                out = self._exec(plan, job, x)
                _sync(self.device)
                t2 = time.perf_counter()
                res = self._crop(plan, job, out)
                t3 = time.perf_counter()
                return res, hit, {"copy_in_ms": (t1 - t0) * 1e3,
                                  "device_ms": (t2 - t1) * 1e3,
                                  "copy_out_ms": (t3 - t2) * 1e3}
            hit = self.cache.peek(ckey)
            self._post(job.header(_OP_EXEC, not hit))
            return self._rank_exec(job, not hit, payload)

    def _rank_exec(self, job: _Job, built: bool,
                   payload: Optional[np.ndarray]
                   ) -> Tuple[Optional[np.ndarray], bool, Dict[str, float]]:
        """One posted job on this rank (leader: ``payload`` is the global
        stack; follower: None): build or look up the plan, agree, take
        this rank's block, execute, agree, gather the reply."""
        ckey = job.cache_key(self.shard)
        err: Optional[BaseException] = None
        plan, hit = None, False
        try:
            if built and self.cache.peek(ckey):
                self.cache.invalidate_key(ckey)
            plan, hit = self.cache.get_or_build(ckey,
                                                lambda: self._job_plan(job))
        except Exception as e:  # noqa: BLE001 — agreed below
            err = e
        self._agree(err, "building the plan")
        t0 = time.perf_counter()
        x = self._distribute(plan, job, payload)
        _sync(self.device)
        t1 = time.perf_counter()
        out = None
        try:
            out = self._exec(plan, job, x)
            _sync(self.device)
        except Exception as e:  # noqa: BLE001 — agreed below
            err = e
        self._agree(err, "executing the batch")
        t2 = time.perf_counter()
        res = self._crop(plan, job, out)
        t3 = time.perf_counter()
        return res, hit, {"copy_in_ms": (t1 - t0) * 1e3,
                          "device_ms": (t2 - t1) * 1e3,
                          "copy_out_ms": (t3 - t2) * 1e3}

    def _agree(self, err: Optional[BaseException], what: str) -> None:
        """One verdict on every rank: a MAX all-reduce of the failure
        flag; this rank's own error re-raises, a rank that did not fail
        raises ``RankFailed``."""
        flag = torch.tensor([1 if err is not None else 0],
                            dtype=torch.int32, device=self._comm_dev)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.group)
        if err is not None:
            raise err
        if int(flag.item()):
            raise RankFailed(f"another rank failed {what}")

    def _post(self, header: List[int]) -> None:
        """The leader's broadcast of one header to its followers (caller
        holds ``DEVICE_LOCK``)."""
        h = torch.tensor(header, dtype=torch.int64, device=self._comm_dev)
        dist.broadcast(h, src=self._src, group=self.group)
        self._last_post = time.monotonic()

    def _distribute(self, plan: Any, job: _Job,
                    payload: Optional[np.ndarray]) -> torch.Tensor:
        """This rank's block of the leader's global payload on the plan's
        device: scattered along the plan's split axis (slab, batched-2D),
        or broadcast whole and cut by the plan (pencil)."""
        fwd = job.direction == "forward"
        c2c_or_inv = job.transform == "c2c" or not fwd
        dtype = plan.complex_dtype if c2c_or_inv else plan.real_dtype
        if hasattr(plan, "local_output_shape_for"):      # pencil
            shape = plan.input_shape if fwd else plan.output_shape
            full = (torch.from_numpy(np.ascontiguousarray(payload)).to(
                self._comm_dev, dtype) if self.leader
                else torch.empty(shape, dtype=dtype, device=self._comm_dev))
            self._bcast(full)
            return plan.pad_input(full) if fwd else plan.pad_spectral(full)
        if hasattr(plan, "_in_axis"):                      # batched-2D
            axis = plan._in_axis if fwd else plan._out_axis
        else:                                              # slab
            axis = 0 if fwd else plan._seq.split_axis
        padded = plan.input_padded_shape if fwd else \
            plan.output_padded_shape
        local = list(padded)
        local[axis] //= self._P
        recv = torch.empty(local, dtype=dtype, device=self._comm_dev)
        blocks = None
        if self.leader:
            a = np.asarray(payload)
            a = np.pad(a, [(0, p - s) for p, s in zip(padded, a.shape)])
            blocks = [torch.from_numpy(np.ascontiguousarray(b)).to(
                self._comm_dev, dtype) for b in np.split(a, self._P, axis)]
        self._scatter(recv, blocks)
        return recv.to(self.device)

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        return torch.view_as_real(t) if t.is_complex() else t

    def _bcast(self, t: torch.Tensor) -> None:
        dist.broadcast(self._wire(t), src=self._src, group=self.group)

    def _scatter(self, recv: torch.Tensor,
                 blocks: Optional[List[torch.Tensor]]) -> None:
        dist.scatter(self._wire(recv),
                     [self._wire(b) for b in blocks] if blocks else None,
                     src=self._src, group=self.group)

    def _follow(self) -> None:
        """A follower's loop: receive each posted header and run it, until
        the leader's stop. A failed job is counted and logged; the loop
        goes on (the leader answered its futures with the verdict)."""
        inherit_threads()
        h = torch.zeros(_HEADER_LEN, dtype=torch.int64, device=self._comm_dev)
        while True:
            try:
                dist.broadcast(h, src=self._src, group=self.group)
            except Exception as err:  # noqa: BLE001 — the leader is gone
                obs.notice(f"serve: follower rank {self.rank} lost its "
                           f"leader ({type(err).__name__}: {err})"[:300],
                           name="serve.follower_lost")
                break
            op, job, built = _Job.from_header([int(v) for v in h.tolist()])
            if op == _OP_STOP:
                break
            if op == _OP_NOOP:
                continue
            if op == _OP_INVALIDATE:
                self.cache.invalidate_prefix(job.base_key(self.shard))
                continue
            with pmesh.DEVICE_LOCK:
                try:
                    self._rank_exec(job, built, None)
                except Exception as err:  # noqa: BLE001 — the verdict
                    with self._lock:
                        self._counts["batch_failures"] += 1
                    obs.event("serve.batch_failed",
                              key=job.cache_key(self.shard), rank=self.rank,
                              error=f"{type(err).__name__}: {err}"[:300])
                    continue
            with self._lock:
                self._counts["batches"] += 1
        with self._lock:
            self._state = "stopped"

    # -- prewarm -----------------------------------------------------------

    def prewarm(self, shape: Tuple[int, ...], dtype: Any = None,
                transform: str = "r2c", *,
                directions: Tuple[str, ...] = ("forward",),
                decomp: Optional[str] = None) -> int:
        """Build the plan-cache slots one traffic shape needs — every
        power-of-two coalescing bucket up to ``max_coalesce`` for a 2D
        image shape, the ONE single-shot slab/pencil plan for a 3D volume
        shape — and run each once per direction on zeros, BEFORE traffic
        arrives, so no request stalls behind a lazy build (or, on the
        card, a first launch). Runs in the caller's thread against the
        shared cache; call it before serving traffic. Returns the number
        of plans newly built; on a follower rank 0 (the leader's prewarm
        drives every rank)."""
        if not self.leader:
            return 0
        if len(shape) == 3:
            return self._prewarm_volume(shape, dtype, transform,
                                        directions=directions,
                                        decomp=decomp)
        nx, ny = int(shape[0]), int(shape[1])
        dt = np.dtype(dtype) if dtype is not None else np.dtype(np.float32)
        double = dt in (np.float64, np.complex128)
        key = plancache.request_key(nx, ny, "f64" if double else "f32",
                                    transform, self.shard)
        cdt = np.complex128 if double else np.complex64
        rdt = np.float64 if double else np.float32
        built = 0
        # Enumerate exactly the buckets bucket_for can produce (powers of
        # two through the pow2 CEILING of max_coalesce).
        top = plancache.bucket_for(self.max_coalesce, self.max_coalesce)
        b = 1
        while b <= top:
            for d in ("forward", "inverse"):
                if d not in directions:
                    continue
                job = _Job(False, nx, ny, 0, transform, double, d, b)
                if d == "forward":
                    x = np.zeros((b, nx, ny),
                                 cdt if transform == "c2c" else rdt)
                else:
                    x = np.zeros((b, nx, ny if transform == "c2c"
                                  else ny // 2 + 1), cdt)
                _, hit, _ = self._run_job(job, x)
                built += 0 if hit else 1
            b <<= 1
        obs.event("serve.prewarm", key=key, built=built,
                  directions=list(directions))
        return built

    def _prewarm_volume(self, shape: Tuple[int, ...], dtype: Any,
                        transform: str, *, directions: Tuple[str, ...],
                        decomp: Optional[str]) -> int:
        nx, ny, nz = (int(s) for s in shape)
        dt = np.dtype(dtype) if dtype is not None else np.dtype(np.float32)
        double = dt in (np.float64, np.complex128)
        dec = decomp or self.volume_decomp
        key = plancache.request_key3d(nx, ny, nz,
                                      "f64" if double else "f32",
                                      transform, dec)
        cdt = np.complex128 if double else np.complex64
        rdt = np.float64 if double else np.float32
        built = 0
        for d in ("forward", "inverse"):
            if d not in directions:
                continue
            job = _Job(True, nx, ny, nz, transform, double, d, 1, dec)
            if d == "forward":
                x = np.zeros((nx, ny, nz), cdt if transform == "c2c"
                             else rdt)
            else:
                x = np.zeros((nx, ny, nz if transform == "c2c"
                              else nz // 2 + 1), cdt)
            _, hit, _ = self._run_job(job, x)
            built += 0 if hit else 1
        obs.event("serve.prewarm", key=key, built=min(built, 1),
                  directions=list(directions))
        return min(built, 1)

    # -- one batch (the leader) ----------------------------------------------

    def _execute(self, batch: List[_Request]) -> None:
        key = batch[0].base_key
        with self._lock:
            breaker = self._breaker(key)
        if not breaker.allow():
            with self._lock:
                self._counts["rejected_circuit"] += len(batch)
            for r in batch:
                settle_future(r.future, exc=breaker.reject())
            return
        try:
            # The injected straggler (server:slow) ages the batch BEFORE
            # the expiry check, exactly like a slow host would — expired
            # requests then never execute. Leader only: a follower never
            # sees an expired request.
            inject.maybe_slow_server("serve.execute")
            alive = []
            for r in batch:
                if r.deadline is not None and r.deadline.expired():
                    self._expire(r, "queued")
                else:
                    alive.append(r)
        except Exception:
            # An escape BETWEEN a successful allow() and the execution
            # envelope must release the probe slot without a verdict — a
            # leaked slot would wedge a half-open circuit forever.
            breaker.release()
            raise  # _run's guard fails the batch and keeps serving
        if not alive:
            breaker.release()
            return
        # Queue-wait distribution (admission -> execution start), per
        # surviving request.
        now_mono = time.monotonic()
        for r in alive:
            obs.metrics.observe("serve.queue_wait_ms",
                                (now_mono - r.submitted_at) * 1e3)
        t0 = time.perf_counter()
        head = alive[0]
        volume = head.volume
        n = len(alive)
        split: Dict[str, float] = {}
        try:
            if volume:
                bucket, ckey = 1, key
                stack = head.x
            else:
                bucket = plancache.bucket_for(n, self.max_coalesce)
                ckey = plancache.cache_key(key, bucket)
                stack = np.stack([r.x for r in alive])
                if bucket > n:
                    pad = np.zeros((bucket - n,) + stack.shape[1:],
                                   stack.dtype)
                    stack = np.concatenate([stack, pad])
            split["stack_ms"] = (time.perf_counter() - t0) * 1e3
            job = _Job(volume, head.nx, head.ny, head.nz or 0,
                       head.transform, head.double, head.direction, bucket,
                       head.decomp or "slab")
            # The ladder scope gets the LOOSEST member deadline: expiry is
            # enforced per request before and after execution, so the
            # ambient deadline exists only to bound fallback retries.
            batch_dl: Optional[Deadline] = None
            if all(r.deadline is not None for r in alive):
                batch_dl = max((r.deadline for r in alive),
                               key=lambda d: d.expires_at)
            # DEVICE_LOCK (taken in _run_job): a resident solver stepping
            # on its own thread shares this worker's device. Lock wait
            # counts into the request's measured latency.
            with obs.span("serve.execute", key=ckey, n=n, bucket=bucket,
                          direction=head.direction,
                          traces=[r.trace_id for r in alive]), \
                    dl.scope(batch_dl):
                res, hit, times = self._run_job(job, stack)
            split.update(times)
        except Exception as err:  # noqa: BLE001 — every failure is a verdict
            opened = breaker.record_failure(err)
            if opened:
                self.cache.invalidate_prefix(key)
                if self._P > 1:
                    # The followers drop the key's plans too, so every
                    # rank's cache holds the same slots.
                    named = _Job(volume, head.nx, head.ny, head.nz or 0,
                                 head.transform, head.double,
                                 head.direction, 1, head.decomp or "slab")
                    with pmesh.DEVICE_LOCK:
                        self._post(named.header(_OP_INVALIDATE, False))
                from ..obs import flightrec
                flightrec.trigger(
                    "circuit_open", f"{type(err).__name__}: {err}"[:200],
                    key=key)
            with self._lock:
                self._counts["batch_failures"] += 1
            obs.metrics.inc("serve.batch_failures")
            obs.event("serve.batch_failed", key=key, n=len(alive),
                      error=f"{type(err).__name__}: {err}"[:300])
            for r in alive:
                obs.event("serve.reply", trace=r.trace_id,
                          outcome="error", error=type(err).__name__)
                settle_future(r.future, exc=err)
            return
        ms = (time.perf_counter() - t0) * 1e3
        breaker.record_success()
        if hit:
            # Warm (cache-hit) per-request execution distribution and the
            # batch's split; cold batches are build-dominated.
            obs.metrics.observe("serve.exec_ms", ms / n)
            for k, v in split.items():
                obs.metrics.observe(f"serve.{k}", v)
        if not volume:
            if head.direction == "forward":
                res = res[:n, :head.nx, :(head.ny if head.transform == "c2c"
                                          else head.ny // 2 + 1)]
            else:
                res = res[:n, :head.nx, :head.ny]
        with self._lock:
            if hit:
                # Only warm (cache-hit) executions feed the queue-delay
                # estimator: a cold batch's latency is dominated by the
                # one-time plan build.
                per_req = ms / n
                self._ema_ms = (per_req if self._ema_ms is None else
                                (1 - _EMA_ALPHA) * self._ema_ms
                                + _EMA_ALPHA * per_req)
                obs.metrics.gauge("serve.ema_ms", round(self._ema_ms, 4))
            self._counts["batches"] += 1
            self._counts["served"] += n
            if n > 1:
                self._counts["coalesced"] += n
        obs.metrics.inc("serve.batches")
        obs.metrics.inc("serve.requests_served", n)
        if n > 1:
            obs.metrics.inc("serve.coalesced_requests", n)
        obs.event("serve.batch", key=ckey, n=n, bucket=bucket,
                  ms=round(ms, 3), cache_hit=hit,
                  **{k: round(v, 3) for k, v in split.items()})
        done_mono = time.monotonic()
        for i, r in enumerate(alive):
            if r.deadline is not None and r.deadline.expired():
                # The result exists but arrived too late: a deadline is a
                # promise, and a late success is reported as expiry.
                self._expire(r, "executing")
            else:
                obs.metrics.observe("serve.e2e_ms",
                                    (done_mono - r.submitted_at) * 1e3)
                obs.event("serve.reply", trace=r.trace_id, outcome="ok",
                          coalesced_n=n)
                settle_future(r.future,
                              result=res if volume else np.array(res[i]))

    # -- resident solver tenant ----------------------------------------------

    def attach_resident(self, resident: Any) -> None:
        """Host a :class:`~.resident.ResidentSolver`: start its stepping
        thread and own its lifecycle — ``close(drain=True)`` stops it
        THROUGH its drain-checkpoint path; ``health()`` gains a
        ``resident`` block. One rank only: a resident beside a multi-rank
        server would post its own collectives between the leader's."""
        if self._P > 1:
            raise NotImplementedError(
                "a resident solver on a multi-rank server is not ported "
                f"yet ({LATER_FLEET}: worker rank groups)")
        with self._lock:
            if self._resident is not None:
                raise RuntimeError("a resident solver is already attached")
            self._resident = resident
        resident.start()

    @property
    def resident(self) -> Optional[Any]:
        return self._resident

    # -- health / lifecycle ------------------------------------------------

    def health(self) -> Dict[str, Any]:
        """The readiness snapshot (the ``/healthz`` payload): overall
        status (``ok`` | ``degraded`` — any circuit not closed — |
        ``draining`` | ``stopped``), queue occupancy, shed/expiry
        counters, per-circuit state, plan-cache hit rate, and the
        metrics registry."""
        with self._lock:
            circuits = {k: b.snapshot() for k, b in self._breakers.items()}
            degraded = any(c["state"] != "closed"
                           for c in circuits.values())
            status = (self._state if self._state != "running"
                      else ("degraded" if degraded else "ok"))
            snap = {
                "status": status,
                "uptime_s": round(time.monotonic() - self._started_at, 3),
                "queue_depth": len(self._pending),
                "inflight": self._inflight,
                "max_queue": self.max_queue,
                "latency_budget_ms": self.latency_budget_ms,
                "max_coalesce": self.max_coalesce,
                "ema_ms": (round(self._ema_ms, 4)
                           if self._ema_ms is not None else None),
                "counters": dict(self._counts),
                "circuits": circuits,
                "rank": self.rank,
                "role": "leader" if self.leader else "follower",
            }
        snap["plan_cache"] = self.cache.snapshot()
        snap["obs_metrics"] = obs.snapshot()
        res = self._resident
        if res is not None:
            snap["resident"] = res.status()
        from ..obs import flightrec
        snap["flight_recorder"] = dict(flightrec.stats(),
                                       last_dump=flightrec.last_dump())
        return snap

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def close(self, drain: bool = True, timeout_s: float = 60.0) -> None:
        """Stop the server. ``drain=True`` (the SIGTERM path): reject new
        submits, FINISH everything already admitted, then stop.
        ``drain=False``: stop now; queued requests fail with
        :class:`ServerClosed`. Idempotent. On P > 1 ranks the leader then
        posts the stop its followers wait for; a follower's close waits
        for it."""
        res = self._resident
        if res is not None:
            res.stop(checkpoint=drain)
        if not self.leader:
            self._worker.join()
            with self._cv:
                self._state = "stopped"
            return
        with self._cv:
            if self._state == "stopped":
                return
            already_draining = self._state == "draining"
            self._state = "draining"
            pending = len(self._pending)
            if not already_draining:
                obs.notice(f"serve: draining ({pending} queued, "
                           f"drain={drain})", name="serve.drain",
                           drain=drain, pending=pending)
            if not drain:
                for r in self._pending:
                    settle_future(r.future, exc=ServerClosed(
                        "server closed before execution"))
                self._pending.clear()
            self._cv.notify_all()
        self._worker.join(timeout_s)
        if self._P > 1 and not self._stop_posted:
            self._stop_posted = True
            with pmesh.DEVICE_LOCK:
                self._post([_OP_STOP] + [0] * (_HEADER_LEN - 1))
        with self._cv:
            self._state = "stopped"
            # Worker died/timed out: everything it left behind — queued
            # requests AND the batch it had already popped — is answered
            # with a structured ServerClosed, never dropped.
            leftovers = self._pending + self._inflight_reqs
            self._pending = []
            self._inflight_reqs = []
        for r in leftovers:
            settle_future(r.future, exc=ServerClosed(
                "server stopped before execution"))
        obs.notice(f"serve: stopped ({self._counts['served']} served, "
                   f"{self._counts['shed']} shed)", name="serve.stop",
                   counters=dict(self._counts))
