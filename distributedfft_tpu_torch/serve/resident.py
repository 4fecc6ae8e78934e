"""Resident solver tenant: a long-running simulation living INSIDE a
serving process, with durable state — the JAX package's
``serve/resident.py``.

A background thread steps a pseudo-spectral Navier–Stokes run while the
same process serves FFT request traffic. The persistence contract runs
through ``distributedfft_tpu_torch/persist``:

* the resident **checkpoints** per :class:`~..persist.CheckpointPolicy`
  (every-N-steps / every-T-seconds) into a two-generation
  :class:`~..persist.CheckpointStore`;
* a **graceful drain** (``Server.close(drain=True)`` — the SIGTERM path)
  writes a final generation (``drain`` reason) when the policy says
  ``drain:on``;
* :meth:`ResidentSolver.build` **restores before ready**: it loads the
  newest valid generation — falling back one generation on corruption —
  and continues the simulation from step k instead of restarting at 0.

Bit-exactness: the loop applies ONE step function (the solver's
``step_fn``, as it is) repeatedly, and restore lays the spectral state
out as it was captured — so interrupted-and-resumed runs are
bit-identical to uninterrupted ones (``tests/test_torch_serve.py`` and
the ``dfft-torch-solve`` driver, which shares :func:`advance_steps`).

A fresh start (no checkpoint) is normal; an UNUSABLE store (every
generation corrupt) degrades to a fresh start with
``persist.restore_failures`` evidence, while a fingerprint MISMATCH
propagates: silently discarding hours of state is worse than refusing.

On P > 1 ranks (``dfft-torch-solve -p``) every rank runs its own resident
over the same plan; the ranks agree after every step, in one MAX
all-reduce over the plan's group, whether to stop and whether a
checkpoint is due (a time trigger or a signal is one rank's view), and
only group rank 0 writes the store. On a multi-rank SERVER (a fleet
worker's rank group) the ranks' residents do not step on their own: the
leader's thread posts each step through the server's protocol
(``start(post=...)``; the followers' residents ``follow()``), and every
rank runs :meth:`ResidentSolver.step_once` for it, whose one MAX
all-reduce agrees stop, checkpoint and failure.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import obs
from .. import persist
from ..parallel import mesh


def _block(state: Any) -> None:
    """Wait for the device that holds ``state`` (nothing on the CPU)."""
    leaves = state if isinstance(state, (tuple, list)) else (state,)
    for dev in {t.device for t in leaves if isinstance(t, torch.Tensor)}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def advance_steps(step_fn: Callable[[Any], Any], state: Any,
                  steps: int) -> Any:
    """Apply one step function ``steps`` times, waiting for the device
    after each step — the ONE stepping idiom the resident, the
    ``dfft-torch-solve`` driver and the bit-exact tests share, so an
    interrupted run and its resume execute literally the same sequence."""
    with torch.no_grad():
        for _ in range(steps):
            state = step_fn(state)
            _block(state)
    return state


def build_ns_solver(spec: Dict[str, Any]) -> Any:
    """Construct the resident's solver from a picklable spec dict
    (``kind``: ``ns2d`` | ``ns3d``, ``n``, ``batch``, ``viscosity``,
    ``partitions``, ``shard``, ``double``, ``fft_backend``, ``device``)."""
    from .. import params as pm
    from ..solvers import NavierStokes2D, NavierStokes3D
    kind = str(spec.get("kind", "ns2d"))
    n = int(spec.get("n", 32))
    p = int(spec.get("partitions", 1))
    device = spec.get("device", "cuda")
    cfg = pm.Config(double_prec=bool(spec.get("double", False)),
                    fft_backend=str(spec.get("fft_backend", "xla")))
    nu = float(spec.get("viscosity", 1e-2))
    if kind == "ns2d":
        from ..models.batched2d import Batched2DFFTPlan
        batch = int(spec.get("batch", 1))
        plan = Batched2DFFTPlan(batch, n, n, pm.SlabPartition(p), cfg,
                                shard=str(spec.get("shard", "batch")),
                                device=device)
        return NavierStokes2D(plan, nu)
    if kind == "ns3d":
        from ..models.slab import SlabFFTPlan
        plan = SlabFFTPlan(pm.GlobalSize(n, n, n), pm.SlabPartition(p),
                           cfg, device=device)
        return NavierStokes3D(plan, nu)
    raise ValueError(f"unknown resident solver kind {kind!r} "
                     "(choose from ns2d, ns3d)")


def initial_state(solver: Any, spec: Dict[str, Any]) -> Any:
    """The fresh-start spectral state: Taylor–Green at the spec's grid,
    in the plan's input dtype (this rank's block on P ranks)."""
    from ..solvers import taylor_green_2d, taylor_green_3d
    n = int(spec.get("n", 32))
    dt = np.float64 if spec.get("double") else np.float32
    if str(spec.get("kind", "ns2d")) == "ns2d":
        w0 = taylor_green_2d(n, batch=int(spec.get("batch", 1)), dtype=dt)
    else:
        w0 = taylor_green_3d(n, dtype=dt)
    with torch.no_grad():
        return solver.to_spectral(w0)


def _ranks(solver: Any) -> int:
    return int(getattr(solver.plan.partition, "num_ranks", 1))


class ResidentSolver:
    """One resident simulation: a solver + spectral state + checkpoint
    store/policy, stepped by a daemon thread (see module docstring)."""

    def __init__(self, name: str, solver: Any, state: Any, dt: float,
                 store: Optional[persist.CheckpointStore],
                 policy: Optional[persist.CheckpointPolicy] = None, *,
                 step: int = 0, sim_time: float = 0.0,
                 rng: Optional[Dict[str, Any]] = None,
                 restored_from: Optional[int] = None,
                 step_interval_s: float = 0.0,
                 max_steps: Optional[int] = None):
        self.name = name
        self.solver = solver
        self.state = state
        self.dt = float(dt)
        self.store = store
        self.policy = policy or persist.CheckpointPolicy()
        self.step = int(step)
        self.sim_time = float(sim_time)
        self.rng = rng
        self.restored_from = restored_from
        self.step_interval_s = float(step_interval_s)
        self.max_steps = max_steps
        self.checkpoints = 0
        self._last_saved_step = int(step)
        self._last_saved_time = time.monotonic()
        self.error: Optional[str] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._step_fn = None  # built lazily on the stepping thread
        self._ranks = _ranks(solver)
        self._group = getattr(solver.plan, "group", None)
        self._writer = (self._ranks == 1
                        or dist.get_rank(self._group) == 0)
        self._stopped_agreed = self._ranks == 1
        # A resident on a multi-rank server: the leader's post callable
        # (start(post=...)), or follow() on a follower rank.
        self._post: Optional[Callable[[bool, bool], None]] = None
        self._posted = False
        self._drain = True
        # describe() cache: (monotonic stamp, result); checkpoint()
        # invalidates it.
        self._describe_at = 0.0
        self._describe_cache: Optional[Dict[str, Any]] = None

    # -- construction ------------------------------------------------------

    @classmethod
    def build(cls, spec: Dict[str, Any]) -> "ResidentSolver":
        """Build (and, when the store holds a checkpoint, RESTORE) a
        resident from a picklable spec dict. Spec keys: the solver keys
        of :func:`build_ns_solver` plus ``name``, ``dt``, ``dir``
        (checkpoint directory; absent = no persistence), ``policy``
        (:class:`CheckpointPolicy` spec string), ``step_interval_ms``,
        ``max_steps``, ``rng``, ``allow_mesh_change``."""
        name = str(spec.get("name", "resident"))
        solver = build_ns_solver(spec)
        dt = float(spec.get("dt", 1e-3))
        policy = persist.CheckpointPolicy.parse(spec.get("policy"))
        store = (persist.CheckpointStore(str(spec["dir"]))
                 if spec.get("dir") else None)
        step = 0
        sim_time = 0.0
        rng = spec.get("rng")
        restored_from: Optional[int] = None
        state: Any = None
        if store is not None:
            fp = persist.plan_fingerprint(solver.plan)
            try:
                sim = store.load(expect_fingerprint=fp,
                                 allow_mesh_change=bool(
                                     spec.get("allow_mesh_change")))
            except persist.CheckpointMissing:
                pass  # fresh start — the normal first boot
            except persist.CheckpointUnusable as e:
                # Zero loadable generations: the resident still comes up
                # (fresh), with the failure on the record.
                obs.notice(f"resident {name}: checkpoint store unusable "
                           f"({e}); starting fresh",
                           name="persist.fresh_after_failure")
            else:
                state = persist.restore(sim, solver)
                step = sim.step
                sim_time = sim.sim_time
                rng = sim.rng or rng
                restored_from = sim.step
                obs.notice(f"resident {name}: restored step {sim.step} "
                           f"(sim_time {sim.sim_time:g})",
                           name="persist.resident_restored", step=sim.step)
        if state is None:
            state = initial_state(solver, spec)
        return cls(name, solver, state, dt, store, policy, step=step,
                   sim_time=sim_time, rng=rng, restored_from=restored_from,
                   step_interval_s=float(spec.get("step_interval_ms",
                                                  0.0)) / 1e3,
                   max_steps=(int(spec["max_steps"])
                              if spec.get("max_steps") else None))

    # -- lifecycle ---------------------------------------------------------

    def start(self, post: Optional[Callable[[bool, bool], None]] = None
              ) -> None:
        """Start the stepping thread (idempotent). ``post(stop, drain)``
        (a multi-rank server's leader) posts each step to the followers
        before this rank runs it (:meth:`step_once`)."""
        if self._thread is not None:
            return
        if post is not None:
            self._post, self._posted = post, True
        self._thread = threading.Thread(
            target=self._served_loop if post is not None else self._loop,
            daemon=True, name=f"{self.name}-steps")
        obs.event("resident.start", resident=self.name, step=self.step,
                  restored_from=self.restored_from,
                  policy=str(self.policy))
        self._thread.start()

    def follow(self) -> None:
        """A follower rank of a multi-rank server: no thread; the
        server runs :meth:`step_once` for each step its leader posts."""
        self._posted = True
        obs.event("resident.start", resident=self.name, step=self.step,
                  restored_from=self.restored_from,
                  policy=str(self.policy), role="follower")

    def _served_loop(self) -> None:
        """The leader's stepping thread on a multi-rank server: each step
        is posted, then run, under ``DEVICE_LOCK``, so every rank steps in
        the same collective order between the server's batches. After
        ``max_steps`` it idles until stopped; the last post carries the
        stop (and the drain checkpoint, when asked for)."""
        from .server import inherit_threads
        inherit_threads()
        try:
            while not self._stop.is_set():
                if (self.max_steps is not None
                        and self.step >= self.max_steps):
                    self._stop.wait(0.05)
                    continue
                with mesh.DEVICE_LOCK:
                    self._post(False, False)
                    if self.step_once(False, False):
                        return
                if self.step_interval_s:
                    self._stop.wait(self.step_interval_s)
            with mesh.DEVICE_LOCK:
                self._post(True, self._drain)
                self.step_once(True, self._drain)
        except Exception as e:  # noqa: BLE001 — a lost group, a post
            self._record_error(e)  # that failed: never die silently

    def step_once(self, stop: bool, drain: bool) -> bool:
        """One posted step on this rank (caller holds ``DEVICE_LOCK``):
        unless ``stop``, one step; then one MAX all-reduce of (stop,
        checkpoint due, failed); then the agreed checkpoint (``drain`` on
        the stopping post, when the policy says ``drain:on``), written by
        rank 0. Returns whether the resident stopped (stop agreed, or a
        rank failed: every rank then records the failure)."""
        err: Optional[BaseException] = None
        if not stop:
            try:
                if self._step_fn is None:
                    self._step_fn = self.solver.step_fn(self.dt)
                state = advance_steps(self._step_fn, self.state, 1)
                with self._lock:
                    self.state = state
                    self.step += 1
                    self.sim_time += self.dt
            except Exception as e:  # noqa: BLE001 — agreed below
                err = e
        due = None if stop else self.policy.due(
            self.step, self._last_saved_step, self._last_saved_time,
            time.monotonic())
        stop_all, due_any, failed = self._agree_flags(
            stop, due is not None, err is not None)
        if failed:
            self._record_error(err if err is not None else RuntimeError(
                "another rank's resident step failed"))
            self._stopped_agreed = True
            return True
        if stop_all:
            reason = ("drain" if drain and self.policy.on_drain else None)
        else:
            reason = (due or "agreed") if due_any else None
        if reason is not None:
            self._checkpoint_stepping_on(reason)
        if stop_all:
            self._stopped_agreed = True
        return stop_all

    def _checkpoint_stepping_on(self, reason: str) -> None:
        """A checkpoint the ranks agreed on. A TRANSIENT write failure
        (ENOSPC, an NFS blip) must not kill the simulation: the loss is
        one checkpoint window, counted and noticed."""
        if self.store is None:
            return
        try:
            self.checkpoint(reason)
        except OSError as e:
            obs.metrics.inc("persist.checkpoint_failures")
            obs.notice(f"resident {self.name}: checkpoint write failed at "
                       f"step {self.step} ({type(e).__name__}: {e}); "
                       "stepping on", name="persist.checkpoint_failed",
                       step=self.step)

    def _agree_flags(self, *flags: bool):
        """The flags MAX-reduced over the plan's group (as they are on
        one rank): one all-reduce agrees what one rank decided alone (a
        time trigger, a signal, a failure)."""
        if self._ranks == 1:
            return tuple(bool(f) for f in flags)
        dev = (self.solver.plan.device
               if dist.get_backend(self._group) == "nccl" else "cpu")
        v = torch.tensor([int(f) for f in flags], dtype=torch.int32,
                         device=dev)
        dist.all_reduce(v, op=dist.ReduceOp.MAX, group=self._group)
        return tuple(bool(x) for x in v.tolist())

    def _record_error(self, e: BaseException) -> None:
        with self._lock:
            self.error = f"{type(e).__name__}: {e}"[:300]
        obs.metrics.inc("persist.resident_errors")
        obs.notice(f"resident {self.name}: stepping thread died at "
                   f"step {self.step} ({self.error})",
                   name="resident.error", step=self.step)
        from ..obs import flightrec
        flightrec.dump(f"resident {self.name} stepping error: "
                       f"{self.error}")

    def _loop(self) -> None:
        # The whole loop is guarded: a stepping thread that dies SILENTLY
        # is the quiet-data-loss mode this layer exists to remove. The
        # failure lands in status()["error"], the obs log, a metric, and
        # a flight-recorder dump.
        from .server import inherit_threads
        inherit_threads()
        try:
            step_fn = self.solver.step_fn(self.dt)
            self._step_fn = step_fn
            while True:
                if (self.max_steps is not None
                        and self.step >= self.max_steps):
                    break
                (stop,) = self._agree_flags(self._stop.is_set())
                if stop:
                    break
                # THE shared stepping idiom (advance_steps). DEVICE_LOCK:
                # the serving thread executes plans on THIS device.
                with mesh.DEVICE_LOCK:
                    state = advance_steps(step_fn, self.state, 1)
                with self._lock:
                    self.state = state
                    self.step += 1
                    self.sim_time += self.dt
                due = self.policy.due(
                    self.step, self._last_saved_step,
                    self._last_saved_time, time.monotonic())
                (due_any,) = self._agree_flags(due is not None)
                if due_any:
                    self._checkpoint_stepping_on(due or "agreed")
                if self.step_interval_s:
                    self._stop.wait(self.step_interval_s)
            self._stopped_agreed = True
        except Exception as e:  # noqa: BLE001 — must never die silently
            self._record_error(e)

    def checkpoint(self, reason: str) -> Optional[str]:
        """Capture + save one generation now; returns the path written
        (None without a store, and on a rank other than group rank 0 of
        a multi-rank resident: the capture is collective, the write is
        rank 0's)."""
        if self.store is None:
            return None
        with self._lock:
            sim = persist.capture(self.solver, self.state, self.step,
                                  self.dt, sim_time=self.sim_time,
                                  rng=self.rng,
                                  meta={"resident": self.name,
                                        "reason": reason})
        path = self.store.save(sim) if self._writer else None
        with self._lock:
            self._last_saved_step = sim.step
            self._last_saved_time = time.monotonic()
            self.checkpoints += 1
            self._describe_cache = None  # registry changed
        return path

    def stop(self, checkpoint: bool = True) -> None:
        """Stop stepping; ``checkpoint=True`` (the drain path) writes
        the final generation when the policy says ``drain:on``.
        Idempotent."""
        first = not self._stop.is_set()
        self._drain = bool(checkpoint)
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(None if self._ranks > 1 else 30.0)
        if first:
            # A posted resident checkpointed on its stopping post.
            if (checkpoint and self.policy.on_drain and not self._posted
                    and self.store is not None
                    and (self._stopped_agreed or t is None)):
                self.checkpoint("drain")
            obs.event("resident.stop", resident=self.name, step=self.step,
                      checkpoints=self.checkpoints)

    # -- observability -----------------------------------------------------

    def progress(self) -> Dict[str, Any]:
        """Name, step, restore provenance, checkpoints and liveness, read
        without the lock (the heartbeat's view: a checkpoint holds the
        lock across its capture)."""
        return {"name": self.name, "step": self.step,
                "restored_from": self.restored_from,
                "checkpoints": self.checkpoints, "running": self.running}

    @property
    def running(self) -> bool:
        """Cheap liveness (no store I/O) — what poll loops should read."""
        return (self._thread is not None and self._thread.is_alive()
                and not self._stop.is_set())

    def status(self) -> Dict[str, Any]:
        """The resident block of serve ``health()``: step/sim-time
        progress, restore provenance, and the store's generation
        registry."""
        with self._lock:
            out: Dict[str, Any] = {
                "name": self.name,
                "solver": type(self.solver).__name__,
                "step": self.step,
                "sim_time": round(self.sim_time, 9),
                "restored_from": self.restored_from,
                "checkpoints": self.checkpoints,
                "policy": str(self.policy),
                "error": self.error,
                "running": self.running,
            }
        if self.store is not None:
            # ONE registry scan serves the report and the age gauge,
            # throttled to one scan per 2 s.
            now = time.monotonic()
            with self._lock:
                d = (self._describe_cache
                     if (self._describe_cache is not None
                         and now - self._describe_at < 2.0) else None)
            if d is None:
                d = self.store.describe(full=False)
                with self._lock:
                    self._describe_cache = d
                    self._describe_at = now
            latest = d["latest"]
            if latest and latest.get("age_s") is not None:
                obs.metrics.gauge("persist.last_checkpoint_age_s",
                                  latest["age_s"])
            out["store"] = {"directory": d["directory"],
                            "latest": latest,
                            "verdict": d["fingerprint_verdict"]}
        else:
            out["store"] = None
        return out
