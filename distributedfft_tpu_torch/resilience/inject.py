"""Deterministic fault injection — the chaos half of the resilience layer
(the port's copy of the JAX package's ``resilience/inject.py``: the same
grammar, hooks and seed keying).

A resilience layer that is never exercised is a liability: the guards
(``guards.py``), fallback ladder (``fallback.py``) and the host-side
retry/timeout machinery (wisdom lock breaking, coordinator backoff,
autotune cell timeouts) all need a way to fail ON DEMAND, deterministically,
in CI. This module is that switch: seed-keyed injectors activated ONLY by
``$DFFT_FAULT_SPEC`` — with the variable unset every hook returns its input
unchanged (the same tensor object) and launches nothing.

Fault-spec grammar (one fault per spec; comma-separate to run several
fault CLASSES concurrently — the serve chaos drill injects
``wire:bitflip,server:slow:40`` so wire corruption and stragglers hit the
same live server)::

    kind:mode[:param][@seed=N][,kind:mode...]

    wire:nan                 # one payload element of every exchange -> NaN
    wire:bitflip             # XOR the top exponent bit of one element
    wire:scale[:F]           # scale the whole exchange payload by F (0.5)
    server:slow[:MS]         # host-side straggler: sleep MS milliseconds
                             # (50 default) inside the serve execution path
                             # (exercises deadline expiry + load shedding)
    worker:crash[:K]         # fleet worker @seed=I (its worker INDEX,
                             # default 0) exits abruptly (os._exit) on
                             # RECEIPT of its K-th request (default 1,
                             # i.e. before answering it; K-1 answered) —
                             # the kill-a-worker chaos drill; the failure
                             # detector must declare it dead, reroute its
                             # keys and resubmit its in-flight requests
    worker:hang[:MS]         # fleet worker @seed=I stops responding for
                             # MS milliseconds (default 60000) per message
                             # — exercises the K-missed-heartbeats path
                             # (vs crash's broken-pipe path)
    worker:devloss[:D]       # fleet worker @seed=I dies abruptly (like
                             # crash) AND its replacement can only
                             # acquire D fewer devices (default 1) — the
                             # accelerator really is gone, so the
                             # replacement must come back on a SHRUNKEN
                             # mesh, rebuild its hot plans there, and
                             # restore residents across the mesh change
                             # (the shrink-and-replan drill). The kill
                             # fires on receipt of the
                             # $DFFT_DEVLOSS_AFTER-th request (default
                             # 1); the parent fleet reads the same spec
                             # via devloss_cut() when sizing respawns
    checkpoint:torn[:BYTES]  # every landed checkpoint write loses its
                             # last BYTES bytes (default 64) — a torn
                             # write the filesystem lost mid-rename; the
                             # restore path must detect it (section CRC /
                             # length) and fall back one generation
    checkpoint:corrupt       # one byte of every landed checkpoint is
                             # bit-flipped (offset keyed by @seed=) —
                             # bitrot; caught by the CRC32C pass before
                             # any byte reaches a device array
    checkpoint:stale         # every landed checkpoint is re-stamped with
                             # schema version 0 (checksums recomputed, so
                             # ONLY schema validation can catch it) — an
                             # ancient-format file a downgrade left behind
    coordinator:down[:K]     # coordinator connect fails (first K attempts;
                             # no K = every attempt)
    wisdom:stale-lock        # the wisdom advisory flock reads as held by a
                             # hung process (exercises stale-break/timeout)
    autotune:hang[:S]        # every autotune race cell sleeps S seconds
                             # (3600 default) before measuring

At most one fault per KIND — duplicates are rejected at parse (two wire
faults in one process would make the corrupted image ambiguous).

``seed`` (default 0) keys the corrupted element index, so a chaos run is
reproducible bit for bit; for the ``worker:*`` faults the seed instead
selects the VICTIM worker index (the fleet numbers its workers), and only
the worker's FIRST incarnation is faulted — the replacement the fleet
respawns is clean, so a chaos drill kills each worker slot once instead
of crash-looping it. The wire injectors corrupt the payload at the
``wire_encode``/``wire_decode`` boundary in ``parallel/transpose.py`` —
AFTER the encode, so what travels (and what the guards must catch) is the
corrupted wire image, exactly like a real link fault. They corrupt OUT OF
PLACE: the caller's tensor (which a ring stage or the caller may still
read) is never written. Injection sites count into ``obs.metrics``
(``inject.wire_faults``, once per executed injection where the JAX package
counts once per trace) and emit ``inject.*`` events so a chaos run's event
log shows what was injected where.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import torch

from .. import obs

ENV_VAR = "DFFT_FAULT_SPEC"

_WIRE_MODES = ("nan", "bitflip", "scale")
_KINDS = {
    "wire": _WIRE_MODES,
    "server": ("slow",),
    "worker": ("crash", "hang", "devloss"),
    "checkpoint": ("torn", "corrupt", "stale"),
    "coordinator": ("down",),
    "wisdom": ("stale-lock",),
    "autotune": ("hang",),
}


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One parsed ``$DFFT_FAULT_SPEC`` entry."""

    kind: str
    mode: str
    param: Optional[float] = None
    seed: int = 0

    def __str__(self) -> str:  # round-trips through parse_fault_spec
        s = f"{self.kind}:{self.mode}"
        if self.param is not None:
            s += f":{self.param:g}"
        if self.seed:
            s += f"@seed={self.seed}"
        return s


def parse_fault_spec(s: str) -> FaultSpec:
    """Parse the grammar above; raises ``ValueError`` on a malformed spec.
    Unlike every other resilience surface this FAILS LOUDLY: a chaos run
    whose fault spec silently parsed as "no fault" would pass vacuously."""
    text = str(s).strip()
    seed = 0
    if "@" in text:
        text, _, tail = text.partition("@")
        key, _, val = tail.partition("=")
        if key.strip() != "seed":
            raise ValueError(f"unknown fault-spec attribute {key!r} "
                             f"(only @seed=N is defined)")
        seed = int(val)
    parts = [p.strip() for p in text.split(":")]
    if len(parts) < 2 or len(parts) > 3 or not all(parts[:2]):
        raise ValueError(
            f"fault spec must be kind:mode[:param][@seed=N], got {s!r}")
    kind, mode = parts[0].lower(), parts[1].lower()
    if kind not in _KINDS:
        raise ValueError(f"unknown fault kind {kind!r} "
                         f"(choose from {sorted(_KINDS)})")
    if mode not in _KINDS[kind]:
        raise ValueError(f"unknown {kind} fault mode {mode!r} "
                         f"(choose from {_KINDS[kind]})")
    param = float(parts[2]) if len(parts) == 3 else None
    return FaultSpec(kind, mode, param, seed)


def parse_fault_specs(s: str) -> tuple:
    """Parse a (possibly comma-separated) multi-fault spec into a tuple of
    :class:`FaultSpec`, strictly: every element must parse, an empty
    element (``wire:nan,,``) is malformed. At most one spec per KIND —
    duplicates would make the injected image ambiguous."""
    parts = [p.strip() for p in str(s).split(",")]
    if not all(parts):
        raise ValueError(f"empty element in multi-fault spec {s!r}")
    specs = tuple(parse_fault_spec(p) for p in parts)
    kinds = [sp.kind for sp in specs]
    if len(set(kinds)) != len(kinds):
        raise ValueError(f"duplicate fault kind in {s!r} "
                         "(at most one fault per kind)")
    return specs


def active_specs() -> tuple:
    """Every active fault spec (empty tuple when ``$DFFT_FAULT_SPEC`` is
    unset). Read from the environment on every call (at every
    executed call for the wire hooks), so a test can flip faults on/off between plan builds
    without touching module state."""
    raw = os.environ.get(ENV_VAR, "").strip()
    if not raw:
        return ()
    return parse_fault_specs(raw)


def active() -> Optional[FaultSpec]:
    """The process's first fault spec, or None (legacy single-fault
    accessor; prefer :func:`active_specs`)."""
    specs = active_specs()
    return specs[0] if specs else None


def _spec_of(kind: str) -> Optional[FaultSpec]:
    for spec in active_specs():
        if spec.kind == kind:
            return spec
    return None


# ---------------------------------------------------------------------------
# wire payload corruption (out of place; identity when inactive)
# ---------------------------------------------------------------------------

_INT_OF = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def taint_wire(x: torch.Tensor, where: str) -> torch.Tensor:
    """Corrupt an exchange payload per the active wire fault (identity —
    the same tensor, nothing launched — when no wire fault is active).
    Called with the payload exactly as it travels: the planar bf16 planes
    under a compressed wire, the native block otherwise. The corrupted
    image is a new tensor; ``x`` is never written.

    * ``nan``: flat element ``seed % size`` (row-major) becomes NaN (a
      complex element NaN + 0j);
    * ``bitflip``: that element (its real part, for complex) has bit
      ``nbits - 2``, the top exponent bit, XORed;
    * ``scale[:F]``: the whole payload times F (0.5), in the wire dtype:
      F is first rounded to the payload's precision, as the JAX package's
      weak-typed scalar is."""
    spec = _spec_of("wire")
    if spec is None:
        return x
    obs.metrics.inc("inject.wire_faults")
    obs.event("inject.wire_fault", mode=spec.mode, where=where,
              seed=spec.seed, shape=list(x.shape),
              dtype=_dtype_name(x.dtype))
    idx = spec.seed % (x.numel() or 1)
    if spec.mode == "scale":
        factor = 0.5 if spec.param is None else float(spec.param)
        real = x.real.dtype if x.is_complex() else x.dtype
        return x * torch.tensor(factor, dtype=real).item()
    y = x.clone(memory_format=torch.contiguous_format)
    if y.numel() == 0:
        return y
    if spec.mode == "nan":
        y.view(-1)[idx] = float("nan")
        return y
    # bitflip: the real part of a complex element is the even float of
    # its interleaved (real, imag) pair.
    flat = torch.view_as_real(y).view(-1) if y.is_complex() else y.view(-1)
    pos = 2 * idx if y.is_complex() else idx
    bits = flat.view(_INT_OF[flat.element_size()])
    bits[pos] ^= 1 << (8 * flat.element_size() - 2)
    return y


# ---------------------------------------------------------------------------
# host-side simulators (coordinator / lock / autotune)
# ---------------------------------------------------------------------------

class SimulatedFault(ConnectionError):
    """Raised by the host-side simulators; carries the spec for logs."""


def maybe_fail_coordinator(attempt: int) -> None:
    """Simulate coordinator unavailability: raise on connect attempt
    ``attempt`` (0-based) while it is below the spec's failure count
    (``coordinator:down:K``; no K = fail every attempt)."""
    spec = _spec_of("coordinator")
    if spec is None:
        return
    fails = float("inf") if spec.param is None else int(spec.param)
    if attempt < fails:
        obs.metrics.inc("inject.coordinator_failures")
        raise SimulatedFault(
            f"injected coordinator unavailability (attempt {attempt + 1} "
            f"of {fails if fails != float('inf') else 'unbounded'} failures)")


def lock_contended() -> bool:
    """Whether the wisdom advisory flock should read as held by a hung
    process (``wisdom:stale-lock``) — drives ``utils/wisdom.py`` through
    its stale-break and acquisition-timeout paths without needing a real
    suspended holder in CI."""
    if _spec_of("wisdom") is None:
        return False
    obs.metrics.inc("inject.lock_contentions")
    return True


def maybe_slow_server(where: str) -> None:
    """Simulate a host-side straggler in the serving execution path
    (``server:slow[:MS]``, default 50 ms): sleep before the batch
    executes, so queued requests age — the chaos harness's lever for
    deadline expiry and load shedding. Host-side only: nothing touches
    the device."""
    spec = _spec_of("server")
    if spec is None:
        return
    delay_ms = 50.0 if spec.param is None else float(spec.param)
    obs.metrics.inc("inject.server_slow")
    obs.event("inject.server_slow", where=where, ms=delay_ms)
    time.sleep(delay_ms / 1e3)


# Requests handled by THIS process's worker loop (worker:crash counts
# them; fresh per spawned worker process by construction).
_WORKER_REQS = [0]


def maybe_crash_worker(index: int, generation: int = 0) -> None:
    """Simulate an abrupt fleet-worker death (``worker:crash[:K]``): the
    worker whose index matches the spec's seed calls ``os._exit`` on
    RECEIPT of its K-th request (default 1), before answering it — so
    K-1 requests are answered and the K-th dies with the worker, no
    drain, no goodbye message, exactly like an OOM-kill. Only
    generation 0 (the original spawn) is faulted: the replacement worker
    must come back clean so the fleet's death -> reroute -> restart ->
    rejoin chain is observable once."""
    spec = _spec_of("worker")
    if spec is None or spec.mode != "crash":
        return
    if generation != 0 or int(index) != spec.seed:
        return
    _WORKER_REQS[0] += 1
    k = 1 if spec.param is None else max(1, int(spec.param))
    if _WORKER_REQS[0] >= k:
        obs.metrics.inc("inject.worker_crashes")
        obs.event("inject.worker_crash", worker=int(index), after=k)
        os._exit(17)


def maybe_devloss_worker(index: int, generation: int = 0) -> None:
    """Worker-side half of ``worker:devloss[:D]``: the victim (index ==
    seed, generation 0 only — same gating as ``worker:crash``) exits
    abruptly on receipt of its ``$DFFT_DEVLOSS_AFTER``-th request
    (default 1, i.e. the first), exactly like a crash. The spec's param
    D is NOT consumed here — it is the number of devices the
    REPLACEMENT comes up short, read by the parent fleet through
    :func:`devloss_cut` when it sizes the respawn. The env knob (rather
    than a second grammar param) lets a chaos drive let a few requests —
    and the resident's first checkpoint — land before the loss."""
    spec = _spec_of("worker")
    if spec is None or spec.mode != "devloss":
        return
    if generation != 0 or int(index) != spec.seed:
        return
    _WORKER_REQS[0] += 1
    after = max(1, int(os.environ.get("DFFT_DEVLOSS_AFTER", "1")))
    if _WORKER_REQS[0] >= after:
        obs.metrics.inc("inject.worker_devlosses")
        obs.event("inject.worker_devloss", worker=int(index), after=after,
                  devices_lost=1 if spec.param is None
                  else max(1, int(spec.param)))
        os._exit(18)


def devloss_cut(index: int, generation: int = 0) -> int:
    """Parent-side half of ``worker:devloss[:D]``: how many devices the
    generation-``generation`` incarnation of worker ``index`` must come
    up SHORT (0 when no devloss fault targets it). Generation 0 — the
    victim — spawns at full size; every respawn while the spec is
    active acquires D fewer devices, emulating a host whose accelerator
    is physically gone. Clearing ``$DFFT_FAULT_SPEC`` 'repairs' the
    host: the next (re)spawn is full-size again and rejoins through the
    normal join path."""
    spec = _spec_of("worker")
    if spec is None or spec.mode != "devloss":
        return 0
    if int(index) != spec.seed or generation < 1:
        return 0
    return 1 if spec.param is None else max(1, int(spec.param))


def maybe_hang_worker(index: int, generation: int = 0) -> None:
    """Simulate a hung fleet worker (``worker:hang[:MS]``, default
    60000 ms): the victim worker sleeps before processing each pipe
    message, so it stops answering heartbeats while its process stays
    alive — the failure detector must declare it dead on K missed beats
    (not a broken pipe) and the fleet must terminate + replace it."""
    spec = _spec_of("worker")
    if spec is None or spec.mode != "hang":
        return
    if generation != 0 or int(index) != spec.seed:
        return
    delay_ms = 60000.0 if spec.param is None else float(spec.param)
    obs.metrics.inc("inject.worker_hangs")
    obs.event("inject.worker_hang", worker=int(index), ms=delay_ms)
    time.sleep(delay_ms / 1e3)


def maybe_taint_checkpoint(path: str) -> None:
    """Damage a checkpoint file that just LANDED on disk
    (``checkpoint:torn|corrupt|stale``) — called by
    ``persist/checkpoint.py`` after its atomic replace, simulating the
    field faults the restore path's validation exists for:

    * ``torn[:BYTES]`` truncates the final BYTES bytes (default 64) —
      a write the filesystem lost mid-flush;
    * ``corrupt`` XORs one byte at ``@seed= % filesize`` — bitrot;
    * ``stale`` re-stamps the header with schema version 0 and
      RECOMPUTES the header checksum, so only schema validation (not a
      CRC) can refuse it.

    Host-side file surgery only; inactive, the file is untouched.
    """
    spec = _spec_of("checkpoint")
    if spec is None:
        return
    obs.metrics.inc("inject.checkpoint_faults")
    obs.event("inject.checkpoint_fault", mode=spec.mode, path=path,
              seed=spec.seed)
    size = os.path.getsize(path)
    if spec.mode == "torn":
        cut = 64 if spec.param is None else max(1, int(spec.param))
        with open(path, "r+b") as f:
            f.truncate(max(0, size - cut))
        return
    if spec.mode == "corrupt":
        idx = spec.seed % max(1, size)
        with open(path, "r+b") as f:
            f.seek(idx)
            b = f.read(1)
            f.seek(idx)
            f.write(bytes([b[0] ^ 0x40]) if b else b"\x40")
        return
    # stale: rebuild the header with version 0 + a matching checksum
    from ..persist import checkpoint as _ckpt
    import json as _json
    with open(path, "rb") as f:
        blob = f.read()
    nmag = len(_ckpt.MAGIC)
    hlen = int.from_bytes(blob[nmag:nmag + 4], "little")
    header = _json.loads(blob[nmag + 8:nmag + 8 + hlen].decode("utf-8"))
    header["version"] = 0
    hdr = _json.dumps(header, sort_keys=True).encode("utf-8")
    with open(path, "wb") as f:
        f.write(_ckpt.MAGIC + len(hdr).to_bytes(4, "little")
                + _ckpt.crc32c(hdr).to_bytes(4, "little") + hdr
                + blob[nmag + 8 + hlen:])


def maybe_hang_cell(label: str) -> None:
    """Simulate a hung autotune race cell (``autotune:hang[:S]``): sleep
    inside the cell so the per-cell wall-clock timeout
    (``testing/autotune.py``) must fire for the race to proceed."""
    spec = _spec_of("autotune")
    if spec is None:
        return
    delay = 3600.0 if spec.param is None else float(spec.param)
    obs.metrics.inc("inject.cell_hangs")
    obs.event("inject.cell_hang", label=label, seconds=delay)
    time.sleep(delay)
