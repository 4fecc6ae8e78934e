"""Persistent plan "wisdom" of the port: autotune once, reuse everywhere
(the JAX package's ``utils/wisdom.py``; the store's format, keys, records,
folds and agreement vectors are that module's).

Two measured plan choices are stored:

* the local-FFT backend race (``testing/autotune.autotune_local_fft``:
  ``"xla"`` / cuFFT against the hand-written kernels and the matmul
  backend), and
* the comm race (``testing/autotune.autotune_comm``: comm method x send
  method x opt x pieces x overlap depth/split x wire), with the wire-only
  race (``autotune_wire``) in its own slot.

``Config(fft_backend="auto")``, ``comm_method="auto"`` (or
``comm_method2``) and ``wire_dtype="auto"`` are resolved when a plan is
built (``resolve_config``): a hit folds the recorded winner, a miss runs a
bounded race and records it, and no store races without recording.

Store: ONE JSON file::

    {"version": 5,
     "entries": {"<canonical key json>": {"local_fft": {...}, "comm": {...},
                                          "wire": {...}}}}

Keys fold in the device fingerprint (platform ``"cuda"`` or ``"cpu"``, the
CUDA device's name, the torch and CUDA versions), the global shape, dtype,
rank layout, decomposition, norm, transform and depth, so a store written
on the CPU misses on the card. Versions 1-4 migrate: their non-``comm``
records carry over, their ``comm`` records (races without later axes)
read as misses. Any other version, or a damaged file, reads as empty.

Writes are atomic (temp file + ``os.replace``), merge a fresh read of the
file, and hold an advisory ``flock`` on ``<path>.lock`` with a bounded
wait (``$DFFT_WISDOM_LOCK_TIMEOUT_S``) and a stale-lock break
(``$DFFT_WISDOM_LOCK_STALE_S``). A failed write is swallowed: wisdom can
cost a redundant measurement, never an error — except a kernel error
(``ops._build.KernelError``) raised by a race, which propagates: a broken
kernel never resolves quietly to ``"xla"``.

Across ranks: every value a rank takes from its own store or its own
race is agreed from group rank 0 over the plan's group(s) before the
ranks can diverge (the same int64 vectors, in the same field order, as
the JAX package's multihost broadcasts; ``parallel.mesh.broadcast_vec``).

The store path: ``Config.wisdom_path``, else ``$DFFT_WISDOM``, else none.
``Config(use_wisdom=False)`` never touches the disk.
"""

from __future__ import annotations

import contextlib
import dataclasses as dc
import json
import os
import tempfile
import time
import warnings
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

try:
    from .. import obs
    from ..ops._build import KernelError  # srclint: allow(host-only-jnp)
except ImportError:
    # Standalone load (the advisory-lock tests exec this file without the
    # package): observability degrades to no-ops.
    import contextlib as _contextlib

    class _NullObs:  # noqa: D401 — minimal stand-in
        class metrics:
            @staticmethod
            def inc(name: str, n: int = 1) -> None:
                pass

            @staticmethod
            def gauge(name: str, value: Any) -> None:
                pass

        @staticmethod
        def span(name: str, **attrs: Any) -> Any:
            return _contextlib.nullcontext()

        @staticmethod
        def event(name: str, **attrs: Any) -> None:
            pass

        @staticmethod
        def notice(msg: str, **attrs: Any) -> None:
            pass

    obs = _NullObs()

    class KernelError(RuntimeError):  # type: ignore[no-redef]
        pass

try:
    from ..resilience import inject as _inject
except ImportError:
    class _inject:  # noqa: D401 — minimal stand-in
        @staticmethod
        def lock_contended() -> bool:
            return False

WISDOM_VERSION = 5
# Store versions that migrate on load (their non-"comm" slots carry over).
_LEGACY_VERSIONS = (1, 2, 3, 4)
ENV_VAR = "DFFT_WISDOM"
# Wire dtypes a stored record may carry ("auto" never lands on disk).
_WIRE_CONCRETE = ("native", "bf16")

# Bounded construction-time race: chain length ($DFFT_WISDOM_K), pair
# repeats and best-of-inner of the local race; iterations and warmup of
# the comm race.
_RACE_REPEATS = 2
_RACE_INNER = 2
_COMM_ITERATIONS = 3
_COMM_WARMUP = 1
_FALLBACK_BACKEND = "xla"  # when every candidate fails the gate

# (path, legacy version) pairs already announced: one notice per store.
_MIGRATION_SEEN = set()


def _note_migration(path: str, version: int) -> None:
    key = (path, int(version))
    if key in _MIGRATION_SEEN:
        return
    _MIGRATION_SEEN.add(key)
    obs.metrics.inc("wisdom.migrations")
    obs.notice(
        f"wisdom: migrated(v{version}→v{WISDOM_VERSION}) {path} "
        f"(local_fft carries over; comm records re-race as misses)",
        name="wisdom.migration", path=path, from_version=int(version),
        to_version=WISDOM_VERSION)


def _race_k() -> int:
    try:
        return max(2, int(os.environ.get("DFFT_WISDOM_K", "17")))
    except ValueError:
        return 17


def default_path() -> Optional[str]:
    """Store path from ``$DFFT_WISDOM`` (empty/unset: no store)."""
    p = os.environ.get(ENV_VAR, "").strip()
    return p or None


def open_store(path: Optional[str] = None,
               enabled: bool = True) -> Optional["WisdomStore"]:
    """The store at ``path`` (or the env default), or None when disabled
    or no path is configured."""
    if not enabled:
        return None
    p = path or default_path()
    return WisdomStore(p) if p else None


def store_for_config(config: Any) -> Optional["WisdomStore"]:
    """The store a Config selects (``wisdom_path`` / ``use_wisdom``)."""
    return open_store(getattr(config, "wisdom_path", None),
                      getattr(config, "use_wisdom", True))


def _lock_timeout_s() -> float:
    try:
        return float(os.environ.get("DFFT_WISDOM_LOCK_TIMEOUT_S", "10"))
    except ValueError:
        return 10.0


def _lock_stale_s() -> float:
    try:
        return float(os.environ.get("DFFT_WISDOM_LOCK_STALE_S", "60"))
    except ValueError:
        return 60.0


@contextlib.contextmanager
def _advisory_lock(path: str) -> Iterator[None]:
    """Best-effort exclusive ``fcntl.flock`` on ``path + '.lock'`` around
    a read-merge-replace window, polled non-blocking up to
    ``$DFFT_WISDOM_LOCK_TIMEOUT_S`` (default 10 s):

    * a holder that died released its flock with its fd; the leftover
      ``.lock`` file is reused;
    * a lock file older than ``$DFFT_WISDOM_LOCK_STALE_S`` (default 60 s;
      its mtime is touched on every acquisition) is broken once —
      unlinked and re-created — so a hung holder keeps the orphaned inode
      (``wisdom.lock_breaks``);
    * past the timeout the writer proceeds unlocked
      (``wisdom.lock_timeouts``): the replace stays atomic, a concurrent
      update may be lost, never corrupted.

    Without flock (platform or filesystem) it is unlocked at once.
    ``$DFFT_FAULT_SPEC=wisdom:stale-lock`` simulates the hung holder."""
    lock_path = path + ".lock"
    lock = None
    try:
        try:
            import fcntl
        except ImportError:
            fcntl = None
        if fcntl is not None:
            deadline = time.monotonic() + _lock_timeout_s()
            delay, broke = 0.005, False
            while True:
                try:
                    lock = open(lock_path, "a")
                    if _inject.lock_contended():
                        raise BlockingIOError("injected: lock held by a "
                                              "hung holder")
                    fcntl.flock(lock, fcntl.LOCK_EX | fcntl.LOCK_NB)
                    try:
                        os.utime(lock_path)  # acquisition stamp (age base)
                    except OSError:
                        pass
                    break
                except BlockingIOError:
                    if lock is not None:
                        lock.close()
                        lock = None
                    try:
                        age = time.time() - os.path.getmtime(lock_path)
                    except OSError:
                        age = 0.0
                    if not broke and age > _lock_stale_s():
                        broke = True
                        try:
                            os.unlink(lock_path)
                        except OSError:
                            pass
                        obs.metrics.inc("wisdom.lock_breaks")
                        obs.notice(
                            f"wisdom: broke stale lock {lock_path} "
                            f"(age {age:.0f}s > {_lock_stale_s():.0f}s)",
                            name="wisdom.lock_break", path=lock_path,
                            age_s=round(age, 1))
                        continue
                    if time.monotonic() >= deadline:
                        obs.metrics.inc("wisdom.lock_timeouts")
                        obs.notice(
                            f"wisdom: lock {lock_path} not acquired within "
                            f"{_lock_timeout_s():.0f}s; writing unlocked "
                            "(atomic replace; a concurrent update may be "
                            "lost, never corrupted)",
                            name="wisdom.lock_timeout", path=lock_path)
                        break
                    time.sleep(delay)
                    delay = min(0.1, delay * 2)
                except OSError:
                    # Not contention: flock unsupported or the lock path
                    # unwritable. Unlocked at once (polling could never
                    # acquire).
                    if lock is not None:
                        lock.close()
                        lock = None
                    break
        yield
    finally:
        if lock is not None:
            try:
                import fcntl
                fcntl.flock(lock, fcntl.LOCK_UN)
            except (ImportError, OSError, ValueError):
                pass
            lock.close()


class WisdomStore:
    """One JSON wisdom file; every read is tolerant, every write atomic
    (and advisory-locked against concurrent recorders)."""

    def __init__(self, path: str) -> None:
        self.path = os.path.expanduser(str(path))

    @staticmethod
    def _empty() -> Dict[str, Any]:
        return {"version": WISDOM_VERSION, "entries": {}}

    @staticmethod
    def _migrate_legacy(raw: Dict[str, Any]) -> Dict[str, Any]:
        """A v1-v4 store as version 5: non-``comm`` records carry over,
        ``comm`` records (races that lacked a later axis) are dropped and
        re-measure as misses. Written as v5 by the next ``record``."""
        entries = {}
        for k, e in raw["entries"].items():
            if not isinstance(e, dict):
                continue
            kept = {s: r for s, r in e.items() if s != "comm"}
            if kept:
                entries[k] = kept
        return {"version": WISDOM_VERSION, "entries": entries}

    def load(self) -> Dict[str, Any]:
        """The parsed store; any defect reads as the empty store, a legacy
        version migrates."""
        with obs.span("wisdom.load", path=self.path):
            try:
                with open(self.path, "r", encoding="utf-8") as f:
                    raw = json.load(f)
            except (OSError, ValueError):
                return self._empty()
            if (not isinstance(raw, dict)
                    or not isinstance(raw.get("entries"), dict)):
                return self._empty()
            if raw.get("version") in _LEGACY_VERSIONS:
                _note_migration(self.path, raw["version"])
                return self._migrate_legacy(raw)
            if raw.get("version") != WISDOM_VERSION:
                return self._empty()
            return raw

    def raw_version(self) -> Optional[int]:
        """The on-disk schema version (before migration), or None when the
        file is missing or unreadable."""
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                raw = json.load(f)
        except (OSError, ValueError):
            return None
        v = raw.get("version") if isinstance(raw, dict) else None
        return v if isinstance(v, int) else None

    def lookup(self, key: str, slot: str) -> Optional[Dict[str, Any]]:
        """The record under ``entries[key][slot]``, or None."""
        entry = self.load()["entries"].get(key)
        if not isinstance(entry, dict):
            return None
        rec = entry.get(slot)
        return rec if isinstance(rec, dict) else None

    def record(self, key: str, slot: str, rec: Dict[str, Any]) -> bool:
        """Merge ``rec`` into the file atomically under the advisory lock,
        stamped with ``recorded_at`` (UTC ISO-8601). Returns False, never
        raises, when the write cannot land."""
        rec = dict(rec)
        rec.setdefault("recorded_at",
                       time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()))
        try:
            d = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(d, exist_ok=True)
            with obs.span("wisdom.record", path=self.path, slot=slot), \
                    _advisory_lock(self.path):
                data = self.load()  # re-read: merge with concurrent writers
                entry = data["entries"].setdefault(key, {})
                if not isinstance(entry, dict):  # damaged entry: replace
                    entry = data["entries"][key] = {}
                entry[slot] = rec
                fd, tmp = tempfile.mkstemp(prefix=".wisdom.", dir=d)
                try:
                    with os.fdopen(fd, "w", encoding="utf-8") as f:
                        json.dump(data, f, indent=1, sort_keys=True)
                    os.replace(tmp, self.path)
                finally:
                    if os.path.exists(tmp):
                        try:
                            os.unlink(tmp)
                        except OSError:
                            pass
            return True
        except (OSError, TypeError, ValueError):
            return False


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------

def _device_fingerprint(device: Any = "cuda") -> Dict[str, str]:
    """The device part of a key: platform (``"cuda"`` or ``"cpu"``), the
    CUDA device's name, the torch and CUDA versions."""
    import torch
    dev = torch.device(device)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else dev.type)
    return {"platform": dev.type, "device_kind": str(kind),
            "torch": torch.__version__, "cuda": str(torch.version.cuda)}


def _decomp_desc(kind: str, partition: Any, sequence: Any = None,
                 variant: Optional[str] = None) -> str:
    from .. import params as pm
    if isinstance(partition, pm.PencilPartition):
        grid = f"{partition.p1}x{partition.p2}"
    else:
        grid = str(partition.num_ranks)
    desc = f"{kind}:{grid}"
    if sequence is not None:
        desc += f":{pm.SlabSequence.parse(sequence).value}"
    if variant:
        desc += f":{variant}"
    return desc


def plan_key(kind: str, global_shape: Sequence[int], double_prec: bool,
             partition: Any, norm: Any, transform: str = "r2c",
             sequence: Any = None, variant: Optional[str] = None,
             mesh_shape: Optional[Dict[str, int]] = None, dims: int = 3,
             device: Any = "cuda") -> str:
    """Canonical store key of one plan configuration: the device
    fingerprint, global shape, dtype, rank layout (``mesh_shape``, by
    default the one the partition determines), decomposition, norm,
    transform and partial depth ``dims``."""
    parts = dict(_device_fingerprint(device))
    parts.update({
        "shape": list(int(s) for s in global_shape),
        "dtype": "f64" if double_prec else "f32",
        "mesh": (mesh_shape if mesh_shape is not None
                 else _mesh_shape_of(None, partition)),
        "decomp": _decomp_desc(kind, partition, sequence, variant),
        "norm": getattr(norm, "value", str(norm)),
        "transform": transform,
        "dims": int(dims),
    })
    return json.dumps(parts, sort_keys=True, separators=(",", ":"))


def local_key(shape: Sequence[int], double_prec: bool,
              device: Any = "cuda") -> str:
    """Key of a bare single-device local-FFT race (no plan around it):
    what ``dfft-torch-reference --autotune`` records."""
    parts = dict(_device_fingerprint(device))
    parts.update({"shape": list(int(s) for s in shape),
                  "dtype": "f64" if double_prec else "f32",
                  "decomp": "local-fft", "mesh": {}})
    return json.dumps(parts, sort_keys=True, separators=(",", ":"))


def _mesh_shape_of(mesh: Any, partition: Any) -> Dict[str, int]:
    """The rank layout a key names: ``mesh`` (a mapping of axis name to
    size) when given, else the one the partition determines."""
    if mesh is not None:
        return {str(k): int(v) for k, v in dict(mesh).items()}
    from .. import params as pm
    from ..parallel.mesh import PENCIL_AXES, SLAB_AXIS
    if isinstance(partition, pm.PencilPartition):
        return {PENCIL_AXES[0]: partition.p1, PENCIL_AXES[1]: partition.p2}
    if partition.num_ranks > 1:
        return {SLAB_AXIS: partition.num_ranks}
    return {}


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------

def local_fft_record(candidate: Any) -> Dict[str, Any]:
    """A winning ``autotune.Candidate`` as a ``local_fft`` record."""
    import numpy as np
    rec = {"fft_backend": candidate.backend,
           "mxu_precision": candidate.precision,
           "mxu_direct_max": candidate.direct_max}
    if np.isfinite(candidate.per_iter_ms):
        rec["per_iter_ms"] = round(float(candidate.per_iter_ms), 4)
    if np.isfinite(candidate.rel_err):
        rec["rel_err"] = float(f"{candidate.rel_err:.3e}")
    return rec


def comm_record(candidate: Any, base_config: Any = None) -> Dict[str, Any]:
    """A winning ``autotune.CommCandidate`` as a ``comm`` record. A
    ``send=None`` candidate was timed with the base Config's send method,
    which the record then names, so a later fold reproduces the timed
    program. Unraced overlap axes record None; the wire records the raced
    one or the base's (``wire_raced`` says which, ``wire_budget`` the
    budget a raced one ran under)."""
    import numpy as np

    from .. import params as pm
    rec = {"comm_method": candidate.comm.value,
           "comm_method2": (candidate.comm2.value
                            if candidate.comm2 is not None else None),
           "opt": int(candidate.opt),
           "send_method": (candidate.send.value
                           if candidate.send is not None else None),
           "streams_chunks": candidate.chunks}
    if candidate.send is None and base_config is not None:
        sm = getattr(base_config, "send_method", None)
        if isinstance(sm, pm.SendMethod) and sm is not pm.SendMethod.SYNC:
            rec["send_method"] = sm.value
            rec["streams_chunks"] = base_config.streams_chunks
    depth = getattr(candidate, "depth", None)
    subs = getattr(candidate, "subblocks", None)
    rec["overlap_depth"] = None if depth is None else int(depth)
    rec["overlap_subblocks"] = None if subs is None else int(subs)
    w = candidate.wire
    if w is None:
        w = getattr(base_config, "wire_dtype", None)
    rec["wire_dtype"] = w if w in _WIRE_CONCRETE else "native"
    rec["wire_raced"] = candidate.wire is not None
    if rec["wire_raced"] and base_config is not None:
        try:
            rec["wire_budget"] = float(base_config.resolved_wire_budget())
        except AttributeError:
            pass
    if np.isfinite(getattr(candidate, "wire_rel_err", float("nan"))):
        rec["wire_rel_err"] = float(f"{candidate.wire_rel_err:.3e}")
    if np.isfinite(candidate.total_ms):
        rec["total_ms"] = round(float(candidate.total_ms), 4)
    return rec


def wire_record(candidate: Any,
                budget: Optional[float] = None) -> Dict[str, Any]:
    """An ``autotune_wire`` winner as a ``wire`` record, with the budget
    the race ran under."""
    import numpy as np
    rec = {"wire_dtype": candidate.wire or "native"}
    if budget is not None:
        rec["wire_budget"] = float(budget)
    if np.isfinite(getattr(candidate, "wire_rel_err", float("nan"))):
        rec["wire_rel_err"] = float(f"{candidate.wire_rel_err:.3e}")
    if np.isfinite(candidate.total_ms):
        rec["total_ms"] = round(float(candidate.total_ms), 4)
    return rec


def stamp_demotion(store: "WisdomStore", key: str, slot: str, rung: str,
                   reason: str) -> bool:
    """Mark the record under ``entries[key][slot]`` DEMOTED (the fallback
    ladder walked off it at run time). A stamped record reads as a miss
    until a fresh race replaces it or the stamp's TTL
    (``$DFFT_DEMOTION_TTL_S``, default 24 h) runs out; a slot without a
    record gets a bare stamp. Best-effort like every write."""
    rec = store.lookup(key, slot) or {}
    rec.update({
        "demoted": True,
        "demoted_rung": rung,
        "demoted_reason": str(reason)[:300],
        "demoted_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    })
    ok = store.record(key, slot, rec)
    if ok:
        obs.metrics.inc("wisdom.demotion_stamps")
        obs.notice(
            f"wisdom[{slot}]: demotion stamp (rung {rung}) -> {store.path}",
            name="wisdom.demotion", slot=slot, rung=rung,
            store=store.path)
    return ok


DEMOTION_TTL_ENV = "DFFT_DEMOTION_TTL_S"
_DEMOTION_TTL_DEFAULT_S = 86400.0  # 24 h


def _demotion_ttl_s() -> float:
    try:
        return float(os.environ.get(DEMOTION_TTL_ENV,
                                    str(_DEMOTION_TTL_DEFAULT_S)))
    except ValueError:
        return _DEMOTION_TTL_DEFAULT_S


def demotion_active(rec: Optional[Dict[str, Any]]) -> bool:
    """Whether a demotion stamp on ``rec`` is still in force: it ages out
    after ``$DFFT_DEMOTION_TTL_S`` seconds (``<= 0``: never); a stamp
    without a parsable ``demoted_at`` never does."""
    if not rec or not rec.get("demoted"):
        return False
    ttl = _demotion_ttl_s()
    if ttl <= 0:
        return True
    stamped = rec.get("demoted_at")
    if not isinstance(stamped, str):
        return True
    try:
        import calendar
        t = calendar.timegm(time.strptime(stamped, "%Y-%m-%dT%H:%M:%SZ"))
    except ValueError:
        return True
    age = time.time() - t
    if age <= ttl:
        return True
    obs.metrics.inc("wisdom.demotion_expired")
    obs.notice(
        f"wisdom: demotion stamp expired ({age:.0f} s > ttl {ttl:.0f} s, "
        f"rung {rec.get('demoted_rung')}) — record re-admitted",
        name="wisdom.demotion_expired", rung=rec.get("demoted_rung"),
        age_s=round(age, 1), ttl_s=ttl)
    return False


# ---------------------------------------------------------------------------
# folds
# ---------------------------------------------------------------------------

def _valid_local_rec(rec: Dict[str, Any]) -> bool:
    from ..ops.fft import BACKENDS
    if rec.get("fft_backend") not in BACKENDS:
        return False
    prec = rec.get("mxu_precision")
    if prec is not None and str(prec).lower() not in ("default", "high",
                                                      "highest"):
        return False
    dm = rec.get("mxu_direct_max")
    return dm is None or (isinstance(dm, int) and dm >= 1)


def _fold_local_rec(cfg: Any, rec: Dict[str, Any]) -> Any:
    return dc.replace(cfg, fft_backend=rec["fft_backend"],
                      mxu_precision=rec.get("mxu_precision"),
                      mxu_direct_max=rec.get("mxu_direct_max"))


def _fold_comm_rec(cfg: Any, rec: Dict[str, Any]) -> Any:
    """A stored comm record folded into a Config; raises on stale or
    invalid fields (callers read that as a miss)."""
    from .. import params as pm
    comm = pm.CommMethod.parse(rec["comm_method"])
    comm2 = (pm.CommMethod.parse(rec["comm_method2"])
             if rec.get("comm_method2") else None)
    opt = int(rec.get("opt", 0))
    if opt not in (0, 1):
        raise ValueError(f"stale opt {opt}")
    cfg = dc.replace(cfg, comm_method=comm, comm_method2=comm2, opt=opt)
    if rec.get("send_method"):
        chunks = rec.get("streams_chunks")
        if chunks is not None and (not isinstance(chunks, int) or chunks < 1):
            raise ValueError(f"stale streams_chunks {chunks!r}")
        cfg = dc.replace(cfg, send_method=pm.SendMethod.parse(
            rec["send_method"]), send_method2=None, streams_chunks=chunks)
    depth = rec.get("overlap_depth")
    if depth is not None:
        if not isinstance(depth, int) or depth < 2:
            raise ValueError(f"stale overlap_depth {depth!r}")
        cfg = dc.replace(cfg, overlap_depth=depth)
    subs = rec.get("overlap_subblocks")
    if subs is not None:
        if not isinstance(subs, int) or subs < 1:
            raise ValueError(f"stale overlap_subblocks {subs!r}")
        cfg = dc.replace(cfg, overlap_subblocks=subs)
    wire = rec.get("wire_dtype", "native")
    if wire not in _WIRE_CONCRETE:
        raise ValueError(f"stale wire_dtype {wire!r}")
    return dc.replace(cfg, wire_dtype=wire)


def _fold_wire_rec(cfg: Any, rec: Dict[str, Any]) -> Any:
    """A stored ``wire`` record folded into a Config; raises on stale or
    invalid fields."""
    wire = rec.get("wire_dtype")
    if wire not in _WIRE_CONCRETE:
        raise ValueError(f"stale wire_dtype {wire!r}")
    return dc.replace(cfg, wire_dtype=wire)


def _wire_hit_within_budget(rec: Dict[str, Any], budget: float) -> bool:
    """Whether a recorded wire winner satisfies the caller's error budget
    (not part of the key): a bf16 winner if its recorded error is within
    it; a native winner if the budget is no looser than the one it was
    raced under (a record without one hits)."""
    if rec.get("wire_dtype") == "bf16":
        err = rec.get("wire_rel_err")
        return isinstance(err, (int, float)) and err <= budget
    raced = rec.get("wire_budget")
    if not isinstance(raced, (int, float)):
        return True
    return budget <= raced


def _no_collectives(kind: str, partition: Any, variant: Any,
                    dims: int) -> bool:
    """Whether a plan posts no exchange at all (one rank, the batched
    plan's batch split, or depth below 2): its comm and wire markers then
    resolve to the defaults without a store consult or a race."""
    single = partition.num_ranks == 1 or (kind == "batched2d"
                                          and variant == "batch")
    return single or dims < 2


def _comm_hit_fold(norm_base: Any, rec: Dict[str, Any], race_wire: bool,
                   budget: float) -> Any:
    """``(folded Config or None, miss reason or None)`` of a stored
    ``comm`` record — the one hit/miss decision of ``_resolve_comm`` and
    ``peek_config``."""
    if rec is None:
        return None, "no record"
    if demotion_active(rec):
        return None, "record demoted after a runtime failure"
    try:
        folded = _fold_comm_rec(norm_base, rec)
    except (KeyError, TypeError, ValueError):
        return None, "stale record"
    if race_wire and not rec.get("wire_raced"):
        return None, "record predates the wire race"
    if race_wire and not _wire_hit_within_budget(rec, budget):
        return None, "recorded wire winner fails this error budget"
    if not race_wire and folded.wire_dtype != norm_base.wire_dtype:
        return None, "record raced under a different wire encoding"
    return folded, None


def _wire_hit_fold(base: Any, rec: Dict[str, Any], budget: float) -> Any:
    """``(folded Config or None, miss reason or None)`` of a stored
    ``wire`` record."""
    if rec is None:
        return None, "no record"
    if demotion_active(rec):
        return None, "record demoted after a runtime failure"
    try:
        folded = _fold_wire_rec(base, rec)
    except (KeyError, TypeError, ValueError):
        return None, "stale record"
    if not _wire_hit_within_budget(rec, budget):
        return None, "recorded wire winner fails this error budget"
    return folded, None


def _describe_comm(cfg: Any) -> str:
    """Compact label of a resolved comm/send/opt/wire choice."""
    from .. import params as pm
    tag = cfg.comm_method.value
    if cfg.comm_method2 is not None:
        tag += f"+{cfg.comm_method2.value}"
    tag += f"/opt{cfg.opt}"
    if cfg.send_method is pm.SendMethod.RING_OVERLAP:
        tag += "/ring-ovl"
        if cfg.resolved_overlap_depth() != 2:
            tag += f"-d{cfg.resolved_overlap_depth()}"
    elif cfg.send_method is pm.SendMethod.RING:
        tag += "/ring"
    elif cfg.send_method is pm.SendMethod.STREAMS:
        tag += f"/streams{cfg.resolved_streams_chunks()}"
    if cfg.resolved_overlap_subblocks() > 1:
        tag += f"/sub{cfg.resolved_overlap_subblocks()}"
    if cfg.wire_dtype != "native":
        tag += f"/{cfg.wire_dtype}"
    return tag


def _hit_notice(slot: str, detail: str, store: Any) -> None:
    obs.metrics.inc("wisdom.hits")
    src = store.path if store is not None else "no store"
    obs.notice(f"wisdom[{slot}]: hit ({detail}) <- {src}",
               name="wisdom.provenance", slot=slot, status="hit",
               detail=detail, store=getattr(store, "path", None))


def _miss_notice(slot: str, reason: str, store: Any,
                 action: str) -> None:
    obs.metrics.inc("wisdom.misses")
    src = store.path if store is not None else "no store configured"
    obs.notice(f"wisdom[{slot}]: miss ({reason}; {src}) -> {action}",
               name="wisdom.provenance", slot=slot, status="miss",
               reason=reason, store=getattr(store, "path", None))


def _race_failed_notice(slot: str, e: BaseException, action: str) -> None:
    """A race that raised (a kernel error aside): the resolution degrades
    to ``action`` loudly and records nothing."""
    obs.metrics.inc("wisdom.race_failures")
    warnings.warn(f"wisdom[{slot}]: the race failed ({type(e).__name__}: "
                  f"{e}); using {action}, not recorded", RuntimeWarning,
                  stacklevel=3)
    obs.notice(f"wisdom[{slot}]: race failed ({type(e).__name__}: {e}) -> "
               f"{action}, not recorded",
               name="wisdom.race_failed", slot=slot,
               error=f"{type(e).__name__}: {e}")


def resolve_local_backend(shape: Sequence[int], double_prec: bool = False,
                          path: Optional[str] = None, enabled: bool = True,
                          race_on_miss: bool = True,
                          default: str = _FALLBACK_BACKEND,
                          device: Any = "cuda",
                          ) -> Tuple[str, Optional[Dict[str, Any]]]:
    """``(backend, record or None)`` of a BARE single-device transform of
    ``shape`` (``dfft-torch-reference -t 0 --fft-backend auto``): a hit
    gives the recorded winner; a miss races and records when
    ``race_on_miss`` (else ``default``); a race with no usable candidate
    gives ``default``. A kernel error propagates."""
    store = open_store(path, enabled)
    key = local_key(shape, double_prec, device)
    rec = store.lookup(key, "local_fft") if store else None
    if rec is not None and _valid_local_rec(rec):
        _hit_notice("local_fft", rec["fft_backend"], store)
        return rec["fft_backend"], rec
    if not race_on_miss:
        return default, None
    _miss_notice("local_fft",
                 "no record" if rec is None else "stale record", store,
                 "racing local-FFT backends")
    from ..testing import autotune as at
    try:
        ranked = at.autotune_local_fft(shape, k=_race_k(),
                                       repeats=_RACE_REPEATS,
                                       inner=_RACE_INNER,
                                       double_prec=double_prec,
                                       device=device)
    except KernelError:
        raise
    except Exception as e:  # noqa: BLE001 — wisdom degrades, never errors
        _race_failed_notice("local_fft", e, default)
        return default, None
    if not ranked or not ranked[0].ok:
        return default, None
    best = ranked[0]
    rec = local_fft_record(best)
    if store:
        store.record(key, "local_fft", rec)
    return best.backend, rec


# ---------------------------------------------------------------------------
# construction-time resolution of Config "auto" fields
# ---------------------------------------------------------------------------

def unresolved(config: Any) -> bool:
    """True while the Config still carries an "auto" marker."""
    from .. import params as pm
    return pm.AUTO in (config.fft_backend, config.comm_method,
                       config.comm_method2, config.wire_dtype)


def _race_shape(kind: str, global_size: Any, partition: Any,
                variant: Optional[str]) -> Tuple[int, ...]:
    """The per-rank block the plan's local transforms see — what the local
    race times (a batched plan's block too, raced as a 3D roundtrip)."""
    from .. import params as pm
    from .native_planner import padded_extent
    shape = list(global_size.shape)
    if isinstance(partition, pm.PencilPartition):
        shape[0] = max(1, padded_extent(shape[0], partition.p1)
                       // partition.p1)
        shape[1] = max(1, padded_extent(shape[1], partition.p2)
                       // partition.p2)
    elif partition.num_ranks > 1:
        # The slab splits x (slot 0); the batched slots are (batch, nx,
        # ny): shard='batch' splits slot 0, shard='x' slot 1.
        ax = 1 if (kind == "batched2d" and variant == "x") else 0
        p = partition.num_ranks
        shape[ax] = max(1, padded_extent(shape[ax], p) // p)
    return tuple(shape)


def _resolve_local_fft(cfg: Any, store: Any, key: str, kind: str,
                       global_size: Any, partition: Any, variant: Any,
                       device: Any) -> Any:
    rec = store.lookup(key, "local_fft") if store else None
    if rec is not None and _valid_local_rec(rec):
        _hit_notice("local_fft", rec["fft_backend"], store)
        return _fold_local_rec(cfg, rec)
    _miss_notice("local_fft",
                 "no record" if rec is None else "stale record", store,
                 "racing local-FFT backends")
    from ..testing import autotune as at
    shape = _race_shape(kind, global_size, partition, variant)
    best = None
    try:
        ranked = at.autotune_local_fft(shape, k=_race_k(),
                                       repeats=_RACE_REPEATS,
                                       inner=_RACE_INNER,
                                       double_prec=cfg.double_prec,
                                       device=device)
        if ranked and ranked[0].ok:
            best = ranked[0]
    except KernelError:
        raise
    except Exception as e:  # noqa: BLE001 — wisdom degrades, never errors
        _race_failed_notice("local_fft", e, _FALLBACK_BACKEND)
        best = None
    if best is None:
        return dc.replace(cfg, fft_backend=_FALLBACK_BACKEND)
    cfg = dc.replace(cfg, fft_backend=best.backend,
                     mxu_precision=best.precision,
                     mxu_direct_max=best.direct_max)
    if store:
        store.record(key, "local_fft", local_fft_record(best))
    return cfg


def _comm_defaults(cfg: Any) -> Any:
    """The comm/wire markers cleared to the defaults (a plan with no
    exchange, or a race where nothing ran: the wire default is the
    bit-identical native)."""
    from .. import params as pm
    kw = {}
    if cfg.comm_method == pm.AUTO:
        kw["comm_method"] = pm.CommMethod.ALL2ALL
    if cfg.comm_method2 == pm.AUTO:
        kw["comm_method2"] = None
    if cfg.wire_dtype == pm.AUTO:
        kw["wire_dtype"] = "native"
    return dc.replace(cfg, **kw) if kw else cfg


def _send_encoding() -> Tuple[Any, ...]:
    """The SendMethod order of the agreement vectors (enum order)."""
    from .. import params as pm
    return tuple(pm.SendMethod)


def _comm_hit_vec(folded: Any):
    """``_broadcast_comm_hit``'s int64 vector of ``folded`` (None: a
    miss), the JAX package's field order."""
    import numpy as np

    from .. import params as pm
    comms = (pm.CommMethod.ALL2ALL, pm.CommMethod.PEER2PEER)
    sends = _send_encoding()
    if folded is None:
        return np.full(9, -1, dtype=np.int64)
    return np.asarray([
        1,
        comms.index(folded.comm_method),
        (-1 if folded.comm_method2 is None
         else comms.index(folded.comm_method2)),
        int(folded.opt),
        sends.index(folded.send_method),
        (-1 if folded.streams_chunks is None
         else int(folded.streams_chunks)),
        _WIRE_CONCRETE.index(folded.wire_dtype),
        (-1 if folded.overlap_depth == pm.AUTO
         else int(folded.overlap_depth)),
        (-1 if folded.overlap_subblocks is None
         else int(folded.overlap_subblocks)),
    ], dtype=np.int64)


def _comm_hit_from_vec(vec, base: Any) -> Any:
    from .. import params as pm
    if int(vec[0]) != 1:
        return None
    comms = (pm.CommMethod.ALL2ALL, pm.CommMethod.PEER2PEER)
    sends = _send_encoding()
    return dc.replace(
        base,
        comm_method=comms[int(vec[1])],
        comm_method2=None if vec[2] < 0 else comms[int(vec[2])],
        opt=int(vec[3]),
        send_method=sends[int(vec[4])], send_method2=None,
        streams_chunks=None if vec[5] < 0 else int(vec[5]),
        wire_dtype=_WIRE_CONCRETE[int(vec[6])],
        overlap_depth=pm.AUTO if vec[7] < 0 else int(vec[7]),
        overlap_subblocks=None if vec[8] < 0 else int(vec[8]))


def _broadcast_comm_hit(folded: Any, base: Any, groups=()) -> Any:
    """Rank 0's comm hit/miss, agreed over ``groups`` before anyone races
    (a rank that skips the race while its peers time collective plans
    would deadlock them)."""
    from ..parallel.mesh import broadcast_vec
    with obs.span("wisdom.broadcast", what="comm_hit"):
        vec = broadcast_vec(_comm_hit_vec(folded), groups)
    return _comm_hit_from_vec(vec, base)


def _resolve_comm(cfg: Any, store: Any, key: str, kind: str,
                  global_size: Any, partition: Any, sequence: Any,
                  transform: str, dims: int, variant: Any, device: Any,
                  group: Any, groups: tuple) -> Any:
    from .. import params as pm

    if _no_collectives(kind, partition, variant, dims):
        return _comm_defaults(cfg)
    # "auto" owns the whole comm x send x opt x pieces x overlap choice:
    # hits fold and winners apply onto a SYNC-normalized base. A wire
    # "auto" riding along is raced as the same race's wire axis.
    race_wire = cfg.wire_dtype == pm.AUTO
    norm_base = dc.replace(_comm_defaults(cfg),
                           send_method=pm.SendMethod.SYNC,
                           send_method2=None, streams_chunks=None,
                           overlap_depth=pm.AUTO, overlap_subblocks=None)
    rec = store.lookup(key, "comm") if store else None
    folded, reason = _comm_hit_fold(norm_base, rec, race_wire,
                                    cfg.resolved_wire_budget())
    if groups:
        had_local = folded is not None
        folded = _broadcast_comm_hit(folded, norm_base, groups)
        if folded is None and had_local:
            reason = "process 0 missed"
    if folded is not None:
        _hit_notice("comm", _describe_comm(folded), store)
        return folded
    _miss_notice("comm", reason or "no record", store,
                 "racing the comm matrix"
                 + (" (wire axis included)" if race_wire else ""))
    from ..testing import autotune as at
    base = dc.replace(norm_base, comm_method=pm.CommMethod.ALL2ALL,
                      comm_method2=None)
    try:
        ranked = at.autotune_comm(kind, global_size, partition, base,
                                  sequence=sequence,
                                  iterations=_COMM_ITERATIONS,
                                  warmup=_COMM_WARMUP, dims=dims,
                                  transform=transform, race_send=True,
                                  race_wire=race_wire, device=device,
                                  group=group)
        cfg = at.apply_best_comm(ranked, norm_base)
    except KernelError:
        raise
    except Exception as e:  # noqa: BLE001 — degrade to defaults, never error
        _race_failed_notice("comm", e, "the defaults")
        return _comm_defaults(cfg)
    if store:
        store.record(key, "comm", comm_record(ranked[0], base))
    return cfg


def _broadcast_wire_hit(folded: Any, base: Any, groups=()) -> Any:
    """Rank 0's wire hit/miss, agreed over ``groups`` (the wire race
    times collective plans too)."""
    from ..parallel.mesh import broadcast_vec
    code = (-1 if folded is None
            else _WIRE_CONCRETE.index(folded.wire_dtype))
    with obs.span("wisdom.broadcast", what="wire_hit"):
        code = int(broadcast_vec([code], groups)[0])
    if code < 0:
        return None
    return dc.replace(base, wire_dtype=_WIRE_CONCRETE[code])


def _resolve_wire(cfg: Any, store: Any, key: str, kind: str,
                  global_size: Any, partition: Any, sequence: Any,
                  transform: str, dims: int, variant: Any, device: Any,
                  group: Any, groups: tuple) -> Any:
    """``wire_dtype="auto"`` with an EXPLICIT comm choice: a ``wire`` hit
    folds; a miss races native against bf16 on the caller's rendering
    under the error budget and records; no exchange: native."""
    if _no_collectives(kind, partition, variant, dims):
        return dc.replace(cfg, wire_dtype="native")
    base = dc.replace(cfg, wire_dtype="native")
    rec = store.lookup(key, "wire") if store else None
    folded, reason = _wire_hit_fold(base, rec, cfg.resolved_wire_budget())
    if groups:
        had_local = folded is not None
        folded = _broadcast_wire_hit(folded, base, groups)
        if folded is None and had_local:
            reason = "process 0 missed"
    if folded is not None:
        _hit_notice("wire", folded.wire_dtype, store)
        return folded
    _miss_notice("wire", reason or "no record", store,
                 "racing native vs bf16 on the fixed rendering")
    from ..testing import autotune as at
    try:
        ranked = at.autotune_wire(kind, global_size, partition, base,
                                  sequence=sequence,
                                  iterations=_COMM_ITERATIONS,
                                  warmup=_COMM_WARMUP, dims=dims,
                                  transform=transform, device=device,
                                  group=group)
        best = ranked[0]
        if not best.ok:
            return base
        # Fold ONLY the wire axis.
        cfg = dc.replace(base, wire_dtype=best.wire or "native")
    except KernelError:
        raise
    except Exception as e:  # noqa: BLE001 — degrade to native, never error
        _race_failed_notice("wire", e, "native")
        return base
    if store:
        store.record(key, "wire",
                     wire_record(best, base.resolved_wire_budget()))
    return cfg


def _resolved_vec(cfg: Any):
    """``_agree_across_processes``'s int64 vector of a resolved Config
    (the JAX package's field order)."""
    import numpy as np

    from .. import params as pm
    from ..ops.fft import BACKENDS
    precs = (None, "default", "high", "highest")
    comms = (pm.CommMethod.ALL2ALL, pm.CommMethod.PEER2PEER)
    sends = _send_encoding()
    return np.asarray([
        BACKENDS.index(cfg.fft_backend),
        precs.index(cfg.mxu_precision if cfg.mxu_precision is None
                    else str(cfg.mxu_precision).lower()),
        -1 if cfg.mxu_direct_max is None else int(cfg.mxu_direct_max),
        comms.index(cfg.comm_method),
        -1 if cfg.comm_method2 is None else comms.index(cfg.comm_method2),
        int(cfg.opt),
        sends.index(cfg.send_method),
        -1 if cfg.streams_chunks is None else int(cfg.streams_chunks),
        _WIRE_CONCRETE.index(cfg.wire_dtype),
        -1 if cfg.overlap_depth == pm.AUTO else int(cfg.overlap_depth),
        (-1 if cfg.overlap_subblocks is None
         else int(cfg.overlap_subblocks)),
    ], dtype=np.int64)


def _config_from_vec(cfg: Any, vec) -> Any:
    from .. import params as pm
    from ..ops.fft import BACKENDS
    precs = (None, "default", "high", "highest")
    comms = (pm.CommMethod.ALL2ALL, pm.CommMethod.PEER2PEER)
    sends = _send_encoding()
    return dc.replace(
        cfg,
        fft_backend=BACKENDS[int(vec[0])],
        mxu_precision=precs[int(vec[1])],
        mxu_direct_max=None if vec[2] < 0 else int(vec[2]),
        comm_method=comms[int(vec[3])],
        comm_method2=None if vec[4] < 0 else comms[int(vec[4])],
        opt=int(vec[5]),
        send_method=sends[int(vec[6])],
        streams_chunks=None if vec[7] < 0 else int(vec[7]),
        wire_dtype=_WIRE_CONCRETE[int(vec[8])],
        overlap_depth=pm.AUTO if vec[9] < 0 else int(vec[9]),
        overlap_subblocks=None if vec[10] < 0 else int(vec[10]))


def _agree_across_processes(cfg: Any, groups=()) -> Any:
    """Every rank of ``groups`` takes rank 0's resolved Config (measured
    winners differ within noise between ranks, and ranks with different
    Configs would post different collectives)."""
    if not groups:
        return cfg
    from ..parallel.mesh import broadcast_vec
    with obs.span("wisdom.broadcast", what="resolved_config"):
        vec = broadcast_vec(_resolved_vec(cfg), groups)
    return _config_from_vec(cfg, vec)


def resolve_config(kind: str, global_size: Any, partition: Any,
                   config: Any = None, *, sequence: Any = None,
                   transform: str = "r2c", dims: int = 3,
                   variant: Optional[str] = None, device: Any = "cuda",
                   group: Any = None, groups: Any = None) -> Any:
    """Resolve a Config's ``fft_backend`` / ``comm_method`` /
    ``comm_method2`` / ``wire_dtype`` "auto" markers by measurement on
    ``device``: a wisdom hit folds the record; a miss races (bounded,
    accuracy-gated) and records; no store races without recording. A
    Config without a marker passes through untouched. A wire "auto"
    rides the comm race when comm is "auto" too, else runs the wire-only
    race. On P ranks every rank calls it; the result is rank 0's, agreed
    over the plan's ``group`` (slab, batched) or ``groups`` (pencil, as
    ``(row, column)``)."""
    from .. import params as pm
    cfg = config if config is not None else pm.Config()
    wants_fft = cfg.fft_backend == pm.AUTO
    wants_comm = pm.AUTO in (cfg.comm_method, cfg.comm_method2)
    wants_wire = cfg.wire_dtype == pm.AUTO
    if not (wants_fft or wants_comm or wants_wire):
        return cfg
    from ..parallel.mesh import agreement_groups
    agree = agreement_groups(kind, partition, group, groups)
    with obs.span("plan.resolve", kind=kind,
                  shape=list(global_size.shape), transform=transform,
                  dims=dims):
        store = store_for_config(cfg)
        key = plan_key(kind, global_size.shape, cfg.double_prec, partition,
                       cfg.norm, transform=transform, sequence=sequence,
                       variant=variant, dims=dims, device=device)
        if wants_fft:
            cfg = _resolve_local_fft(cfg, store, key, kind, global_size,
                                     partition, variant, device)
        if wants_comm:
            cfg = _resolve_comm(cfg, store, key, kind, global_size,
                                partition, sequence, transform, dims,
                                variant, device, group, agree)
        elif wants_wire:
            cfg = _resolve_wire(cfg, store, key, kind, global_size,
                                partition, sequence, transform, dims,
                                variant, device, group, agree)
        return _agree_across_processes(cfg, agree)


def peek_config(kind: str, global_size: Any, partition: Any,
                config: Any = None, *, sequence: Any = None,
                transform: str = "r2c", dims: int = 3,
                variant: Optional[str] = None, device: Any = "cuda"
                ) -> Tuple[Any, Dict[str, Any]]:
    """LOOKUP-ONLY resolution and its provenance, ``(cfg, provenance)``:
    a miss never races, it folds what a raceless resolution would (the
    "xla" fallback, the comm/wire defaults) and reports the slot as a
    miss, through the same hit/miss helpers as ``resolve_config``.
    ``provenance``: ``{"store_path", "store_version", "key", "slots":
    {slot: {"status", "reason", "record"}}}``, a slot for each field
    that was "auto"."""
    from .. import params as pm
    cfg = config if config is not None else pm.Config()
    store = store_for_config(cfg)
    key = plan_key(kind, global_size.shape, cfg.double_prec, partition,
                   cfg.norm, transform=transform, sequence=sequence,
                   variant=variant, dims=dims, device=device)
    prov = {"store_path": store.path if store else None,
            "store_version": store.raw_version() if store else None,
            "key": key, "slots": {}}
    wants_fft = cfg.fft_backend == pm.AUTO
    wants_comm = pm.AUTO in (cfg.comm_method, cfg.comm_method2)
    wants_wire = cfg.wire_dtype == pm.AUTO
    no_coll = _no_collectives(kind, partition, variant, dims)
    if wants_fft:
        rec = store.lookup(key, "local_fft") if store else None
        if rec is not None and _valid_local_rec(rec):
            cfg = _fold_local_rec(cfg, rec)
            prov["slots"]["local_fft"] = {"status": "hit", "record": rec}
        else:
            cfg = dc.replace(cfg, fft_backend=_FALLBACK_BACKEND)
            prov["slots"]["local_fft"] = {
                "status": "miss",
                "reason": "no record" if rec is None else "stale record"}
    if wants_comm:
        if no_coll:
            cfg = _comm_defaults(cfg)
            prov["slots"]["comm"] = {
                "status": "not consulted (plan issues no collectives)"}
        else:
            race_wire = cfg.wire_dtype == pm.AUTO
            norm_base = dc.replace(_comm_defaults(cfg),
                                   send_method=pm.SendMethod.SYNC,
                                   send_method2=None, streams_chunks=None)
            rec = store.lookup(key, "comm") if store else None
            folded, reason = _comm_hit_fold(norm_base, rec, race_wire,
                                            cfg.resolved_wire_budget())
            if folded is not None:
                cfg = folded
                prov["slots"]["comm"] = {"status": "hit", "record": rec}
            else:
                cfg = norm_base
                prov["slots"]["comm"] = {"status": "miss", "reason": reason,
                                         "record": rec}
    elif wants_wire:
        if no_coll:
            cfg = dc.replace(cfg, wire_dtype="native")
            prov["slots"]["wire"] = {
                "status": "not consulted (plan issues no collectives)"}
        else:
            base = dc.replace(cfg, wire_dtype="native")
            rec = store.lookup(key, "wire") if store else None
            folded, reason = _wire_hit_fold(base, rec,
                                            cfg.resolved_wire_budget())
            if folded is not None:
                cfg = folded
                prov["slots"]["wire"] = {"status": "hit", "record": rec}
            else:
                cfg = base
                prov["slots"]["wire"] = {"status": "miss", "reason": reason,
                                         "record": rec}
    return cfg, prov


def plan_wisdom_key(plan: Any) -> str:
    """The store key a built plan was (or would be) resolved under
    (``_wisdom_key_args`` of its family)."""
    ka = plan._wisdom_key_args()
    return plan_key(ka["kind"], plan.global_size.shape,
                    plan.config.double_prec, plan.partition,
                    plan.config.norm, transform=ka.get("transform", "r2c"),
                    sequence=ka.get("sequence"), variant=ka.get("variant"),
                    dims=ka.get("dims", 3), device=plan.device)
