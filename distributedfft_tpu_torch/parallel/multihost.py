"""Multi-process runtime — the port's counterpart of the JAX package's
``parallel/multihost.py``.

The reference runs one MPI rank per GPU. The port runs one process per
rank in a ``torch.distributed`` world:

* ``maybe_initialize()`` joins the world from arguments or the
  environment, and does nothing in a single process (the analog of the
  reference's guarded ``MPI_Init``). ``torchrun`` sets ``MASTER_ADDR``,
  ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE``; a launcher of its own sets
  ``DFFT_COORDINATOR`` (``host:port`` of rank 0), ``DFFT_NUM_PROCESSES``
  and ``DFFT_PROCESS_ID``. The ``backend`` argument picks the backend
  (default: NCCL when the process sees a CUDA device, else gloo). The
  connect runs under a bounded exponential backoff with jitter
  (``_connect_with_backoff``), as in the JAX package.
* ``process_local_slices`` / ``plan_local_input`` / ``plan_local_spectral``
  give each rank its block of a plan's padded global array, the block a
  distributed plan's ``exec_*`` take and return (each reference rank
  fills only its own partition,
  ``tests/src/slab/random_dist_default.cu:174-190``).
"""

from __future__ import annotations

import datetime
import os
import random
import socket
import time
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import obs
from ..resilience import inject
from . import mesh

_INITIALIZED = False

ENV_COORD = "DFFT_COORDINATOR"
ENV_NPROCS = "DFFT_NUM_PROCESSES"
ENV_PROCID = "DFFT_PROCESS_ID"
_TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def local_coordinator() -> str:
    """``127.0.0.1:<free port>``: a rendezvous address for ranks started on
    this host."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def _connect_with_backoff(connect, what: str):
    """Bounded exponential backoff with jitter around the coordinator
    connect: joining fails outright when the coordinator is not yet
    listening, routine when ranks start seconds apart. Up to
    ``$DFFT_COORD_RETRIES`` attempts (default 5), delays
    ``$DFFT_COORD_BACKOFF_S`` * 2^attempt (default 0.5 s base) capped at
    ``$DFFT_COORD_BACKOFF_CAP_S`` (default 30 s), each with +-25% jitter.
    The final failure propagates (``coordinator:down`` in
    ``$DFFT_FAULT_SPEC`` simulates exactly this). Only connection-shaped
    failures retry (``ConnectionError``, ``OSError``, ``TimeoutError``,
    and ``RuntimeError``, which torch's rendezvous errors derive from);
    configuration errors (``ValueError``, ``TypeError``) propagate at
    once. Retries count into ``multihost.connect_retries``."""
    attempts = max(1, int(os.environ.get("DFFT_COORD_RETRIES", "5")))
    base = float(os.environ.get("DFFT_COORD_BACKOFF_S", "0.5"))
    cap = float(os.environ.get("DFFT_COORD_BACKOFF_CAP_S", "30"))
    last = None
    for attempt in range(attempts):
        try:
            inject.maybe_fail_coordinator(attempt)
            return connect()
        except (ConnectionError, OSError, TimeoutError, RuntimeError) as e:
            last = e
            if attempt == attempts - 1:
                break
            delay = min(cap, base * (2 ** attempt))
            delay *= 0.75 + 0.5 * random.random()  # +-25% jitter
            obs.metrics.inc("multihost.connect_retries")
            obs.notice(
                f"multihost: {what} failed ({type(e).__name__}: {e}); "
                f"retry {attempt + 2}/{attempts} in {delay:.2f}s",
                name="multihost.connect_retry", attempt=attempt + 1,
                attempts=attempts, delay_s=round(delay, 3))
            time.sleep(delay)
    raise last


def maybe_initialize(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     timeout_s: Optional[float] = None) -> Tuple[int, int]:
    """Join the ``torch.distributed`` world if one is configured; returns
    ``(rank, world_size)``.

    Resolution order: explicit arguments, then the ``DFFT_*`` variables,
    then ``torchrun``'s. With none of them this stays single-process and
    returns ``(0, 1)``. A count or id without a coordinator raises rather
    than silently running one rank. Calling it again in a joined process
    returns the world it is in."""
    global _INITIALIZED
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    coordinator_address = coordinator_address or os.environ.get(ENV_COORD)
    if num_processes is None and os.environ.get(ENV_NPROCS):
        num_processes = int(os.environ[ENV_NPROCS])
    if process_id is None and os.environ.get(ENV_PROCID):
        process_id = int(os.environ[ENV_PROCID])
    torchrun = all(os.environ.get(k) for k in _TORCHRUN_ENV)
    if not (coordinator_address or torchrun):
        if (num_processes, process_id) in ((None, None), (1, None), (1, 0)):
            return 0, 1
        raise ValueError(
            f"{ENV_NPROCS}/{ENV_PROCID} are set but {ENV_COORD} is not; "
            f"set the coordinator address (host:port of rank 0)")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    if coordinator_address:
        if num_processes is None or process_id is None:
            raise ValueError(
                f"{ENV_COORD} needs the world size and this process's rank "
                f"({ENV_NPROCS}, {ENV_PROCID})")
        init = f"tcp://{coordinator_address}"
        _connect_with_backoff(
            lambda: dist.init_process_group(
                backend, init_method=init, world_size=num_processes,
                rank=process_id, **kw),
            f"joining the world at {coordinator_address}")
    else:
        _connect_with_backoff(
            lambda: dist.init_process_group(backend, init_method="env://",
                                            **kw),
            "joining the torchrun world")
    _INITIALIZED = True
    return dist.get_rank(), dist.get_world_size()


def world() -> Tuple[int, int]:
    """(rank, world size) of this process; (0, 1) outside a world."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shutdown() -> None:
    """Leave the world joined by ``maybe_initialize`` (``MPI_Finalize``)."""
    global _INITIALIZED
    if _INITIALIZED and dist.is_initialized():
        mesh.forget_groups()
        dist.destroy_process_group()
    _INITIALIZED = False


# ---------------------------------------------------------------------------
# Per-rank data plumbing
# ---------------------------------------------------------------------------


def process_local_slices(plan, output: bool = False) -> List[Tuple[slice, ...]]:
    """Index tuples of the plan's padded global input (or, with
    ``output=True``, spectral output) that this rank holds: one per
    device, and a rank drives one device."""
    return [plan.local_slices(output)]


def plan_local_input(plan, seed: int = 0) -> torch.Tensor:
    """This rank's block of a random padded input for ``plan``, in the
    plan's precision, on its device (multi-host testcase 0: each rank
    fills only its own block; the seed is offset by the rank as in the
    JAX package)."""
    shape = plan.local_input_shape
    if plan.fft3d:
        rng = np.random.default_rng(seed)
    else:
        rng = np.random.default_rng(seed + dist.get_rank())
    local = rng.random(shape).astype(np.float64 if plan.config.double_prec
                                     else np.float32)
    return torch.from_numpy(local).to(plan.device)


def plan_local_spectral(plan, seed: int = 0, dims: int = 3) -> torch.Tensor:
    """This rank's block of a random padded spectrum for ``plan``
    (multi-host testcase 2), in the plan's precision, on its device; a
    pencil plan's block at depth ``dims`` (the reference's ``--fft-dim``),
    which a slab plan ignores."""
    if hasattr(plan, "local_output_shape_for"):
        shape = plan.local_output_shape_for(dims)
    else:
        shape = plan.local_output_shape
    seed = seed if plan.fft3d else seed + dist.get_rank()
    rng = np.random.default_rng(seed)
    local = (rng.random(shape) + 1j * rng.random(shape)).astype(
        np.complex128 if plan.config.double_prec else np.complex64)
    return torch.from_numpy(local).to(plan.device)
