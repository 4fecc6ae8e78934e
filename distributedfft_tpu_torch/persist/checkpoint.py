"""Crash-consistent checkpoint format and two-generation store of the port
(the JAX package's ``persist/checkpoint.py``; the on-disk bytes are that
module's, so a file written by either package reads in the other).

Checkpoint file format (one generation = one self-describing file)::

    bytes  0..7    magic  b"DFFTCKP1"
    bytes  8..11   header length H (u32 LE)
    bytes 12..15   CRC32C of the H header bytes (u32 LE)
    bytes 16..16+H header JSON (utf-8)
    then the raw C-contiguous array payloads, concatenated

The header carries ``version`` (schema 1), the step counter, ``dt``, the
simulated time, the RNG/forcing phase, the plan fingerprint
(``resilience.guards.fingerprint``), the wisdom provenance, free-form
``meta`` and one section record per array (``name``/``dtype``/``shape``/
``offset``/``nbytes``/``crc32c``). Every section is checksummed on its
own, so one flipped byte anywhere is found before any byte reaches a
tensor.

Crash consistency: the file is written to a temp file in the target
directory, ``fsync``'d, ``os.replace``'d into its slot under the wisdom
store's advisory flock, and the directory entry is ``fsync``'d. The
:class:`CheckpointStore` rotates two slots (``ckpt-a.dfft`` /
``ckpt-b.dfft``) and always overwrites the older, so a damaged newest
generation (``$DFFT_FAULT_SPEC=checkpoint:torn|corrupt|stale``) leaves one
loadable checkpoint: ``load`` falls back exactly one generation and
refuses with a structured error when both are bad, and refuses a plan
whose fingerprint differs (:class:`CheckpointMismatch`, no fallback).

CRC32C at state sizes: the JAX package's checksum is a byte loop in
Python (a few MB/s). Here the buffer is cut into many equal lanes whose
CRCs are computed together, slicing-by-8 over the lanes as tensor
operations (on the CUDA device when there is one, else the CPU), and
joined with the standard CRC combine (the zero-extension operator as a
32 x 32 matrix over GF(2), in a tree). The polynomial, the conditioning
and therefore every checksum are the same; short buffers take the table
loop.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import tempfile
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .. import obs
from ..resilience import inject
from ..utils.wisdom import _advisory_lock

MAGIC = b"DFFTCKP1"
CHECKPOINT_VERSION = 1
_HEADER_FIXED = len(MAGIC) + 8  # magic + u32 header_len + u32 header_crc

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli) — the checksum the format stamps on every section.
# ---------------------------------------------------------------------------

_CRC32C_POLY = 0x82F63B78
_MASK = 0xFFFFFFFF
# Below this many bytes the table loop runs; above, the lanes.
_LANE_MIN_BYTES = 1 << 16
# Bytes a lane holds at least (a pass runs 32 to 64 steps), and the most
# lanes one pass takes.
_LANE_BYTES = 256
_MAX_LANES = 1 << 20
# The bytes one pass of the lanes takes at most: a pass holds about twice
# its chunk on the device, whatever the buffer's size.
_CHUNK_BYTES = 1 << 28


def _build_tables() -> np.ndarray:
    """The slicing-by-8 tables: ``t[0]`` the byte table, ``t[k]`` the
    table of a byte followed by k zero bytes."""
    t = np.zeros((8, 256), dtype=np.uint32)
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ _CRC32C_POLY if c & 1 else c >> 1
        t[0, n] = c
    for k in range(1, 8):
        t[k] = (t[k - 1] >> 8) ^ t[0][t[k - 1] & 0xFF]
    return t


_TABLES = _build_tables()
_TABLE = [int(v) for v in _TABLES[0]]


def _raw_loop(buf, reg: int) -> int:
    """The CRC register after ``buf`` from ``reg`` (no conditioning)."""
    table = _TABLE
    for b in bytes(buf):
        reg = (reg >> 8) ^ table[(reg ^ b) & 0xFF]
    return reg


def _mat_apply(cols: Tuple[int, ...], x: int) -> int:
    """A 32 x 32 GF(2) matrix (its columns) applied to ``x``."""
    out, j = 0, 0
    while x:
        if x & 1:
            out ^= cols[j]
        x >>= 1
        j += 1
    return out


def _mat_mul(a: Tuple[int, ...], b: Tuple[int, ...]) -> Tuple[int, ...]:
    return tuple(_mat_apply(a, c) for c in b)


@functools.lru_cache(maxsize=None)
def _zeros_op(n: int) -> Tuple[int, ...]:
    """The operator taking the CRC register across ``n`` zero bytes, as
    the columns of its GF(2) matrix (squaring from one byte)."""
    if n == 1:
        return tuple((1 << j >> 8) ^ _TABLE[(1 << j) & 0xFF]
                     for j in range(32))
    if n == 0:
        return tuple(1 << j for j in range(32))
    half = _zeros_op(n // 2)
    sq = _mat_mul(half, half)
    return _mat_mul(_zeros_op(1), sq) if n % 2 else sq


def _lanes_device() -> "Any":
    import torch
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _raw_lanes(buf: np.ndarray, lanes: int, device) -> int:
    """The register after ``buf`` (``lanes`` x m bytes, m a multiple of 8)
    from 0: every lane's CRC at once (slicing-by-8 over the lanes), then
    pairs of neighbouring lanes joined level by level, each level's
    zero-extension applied to all pairs at once: every set bit of a lane
    selects its column of the operator, and the selections are XOR-ed
    halves at a time."""
    import torch
    m = buf.size // lanes
    with warnings.catch_warnings():
        # A read-only buffer (bytes read from a file): only read here.
        warnings.simplefilter("ignore", UserWarning)
        words = torch.from_numpy(buf).to(device)
    words = words.view(torch.int32).view(lanes, m // 4).t().contiguous()
    tabs = torch.from_numpy(_TABLES.astype(np.int64)).to(device)
    t0, t1, t2, t3, t4, t5, t6, t7 = tabs
    c = torch.zeros(lanes, dtype=torch.int64, device=device)
    for j in range(0, m // 4, 2):
        c = c ^ (words[j].to(torch.int64) & _MASK)
        w = words[j + 1].to(torch.int64) & _MASK
        c = (t7[c & 0xFF] ^ t6[(c >> 8) & 0xFF] ^ t5[(c >> 16) & 0xFF]
             ^ t4[c >> 24] ^ t3[w & 0xFF] ^ t2[(w >> 8) & 0xFF]
             ^ t1[(w >> 16) & 0xFF] ^ t0[w >> 24])
    del words
    length = m
    bits = torch.arange(32, dtype=torch.int64, device=device)
    while c.numel() > 1:
        cols = torch.tensor(_zeros_op(length), dtype=torch.int64,
                            device=device)
        left, right = c[0::2], c[1::2]
        sel = ((left[:, None] >> bits) & 1) * cols
        while sel.shape[1] > 1:
            half = sel.shape[1] // 2
            sel = sel[:, :half] ^ sel[:, half:]
        c = sel[:, 0] ^ right
        length *= 2
    return int(c[0])


def _raw(buf: np.ndarray, reg: int, device) -> int:
    """The CRC register after the uint8 array ``buf`` from ``reg``, the
    lanes on ``device`` taking it ``_CHUNK_BYTES`` at a time."""
    for off in range(0, buf.size, _CHUNK_BYTES):
        reg = _raw_chunk(buf[off:off + _CHUNK_BYTES], reg, device)
    return reg


def _raw_chunk(buf: np.ndarray, reg: int, device) -> int:
    """One chunk: the lanes over the most of it they cover, joined to
    ``reg`` by the CRC combine, then the rest."""
    n = buf.size
    if n < _LANE_MIN_BYTES:
        return _raw_loop(memoryview(buf), reg)
    lanes = 1
    while lanes * 2 <= _MAX_LANES and lanes * 2 * _LANE_BYTES <= n:
        lanes *= 2
    m = (n // lanes) // 8 * 8
    main = lanes * m
    r0 = _raw_lanes(buf[:main], lanes, device)
    reg = _mat_apply(_zeros_op(main), reg) ^ r0
    return _raw_chunk(buf[main:], reg, device)


def _as_u8(data: Any) -> np.ndarray:
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data).reshape(-1).view(np.uint8)
    return np.frombuffer(memoryview(data).cast("B"), dtype=np.uint8)


def crc32c(data: Any, crc: int = 0) -> int:
    """CRC32C (Castagnoli) of ``data`` (bytes-like or a numpy array's
    bytes), continuing from ``crc`` — the JAX package's checksum, bit for
    bit. Known answer: ``crc32c(b"123456789") == 0xE3069283``. Buffers
    past 64 KiB take the lanes, on the CUDA device when there is one,
    else on the CPU."""
    buf = _as_u8(data)
    device = _lanes_device() if buf.size >= _LANE_MIN_BYTES else None
    return _raw(buf, (crc ^ _MASK) & _MASK, device) ^ _MASK


# ---------------------------------------------------------------------------
# structured failures
# ---------------------------------------------------------------------------

class CheckpointError(RuntimeError):
    """Base of every structured persist failure."""


class CheckpointCorrupt(CheckpointError):
    """One checkpoint file failed validation (bad magic, unsupported
    schema version, short file, or a CRC32C mismatch); carries where and
    why so the generation-fallback path can report what it skipped."""

    def __init__(self, path: str, reason: str):
        super().__init__(f"corrupt checkpoint {path}: {reason}")
        self.path = path
        self.reason = reason


class CheckpointMissing(CheckpointError):
    """No generation file exists at all — a FRESH simulation, not a
    failure (residents start from the initial condition on this)."""

    def __init__(self, directory: str):
        super().__init__(f"no checkpoint generations in {directory}")
        self.directory = directory


class CheckpointMismatch(CheckpointError):
    """The checkpoint was written by a DIFFERENT plan than the one asked
    to resume (fingerprint disagreement) — a configuration error, never
    auto-resolved: loading spectral state into a differently-rendered
    plan would silently change the simulation."""

    def __init__(self, path: str, diffs: Dict[str, Tuple[Any, Any]]):
        detail = ", ".join(f"{k}: checkpoint={a!r} plan={b!r}"
                           for k, (a, b) in sorted(diffs.items()))
        super().__init__(f"checkpoint {path} fingerprint mismatch "
                         f"({detail})")
        self.path = path
        self.diffs = diffs


class CheckpointUnusable(CheckpointError):
    """EVERY generation failed validation — the store has zero loadable
    checkpoints; carries the per-generation reasons."""

    def __init__(self, directory: str, reasons: Dict[str, str]):
        detail = "; ".join(f"{os.path.basename(p)}: {r}"
                           for p, r in sorted(reasons.items()))
        super().__init__(
            f"no loadable checkpoint in {directory} ({detail})")
        self.directory = directory
        self.reasons = reasons


# ---------------------------------------------------------------------------
# the state a checkpoint carries
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SimState:
    """One checkpointable simulation state: named host arrays plus the
    scalar/bookkeeping fields the header records. ``rng`` is the
    RNG/forcing phase (JSON-able dict; e.g. a forcing seed + draw
    counter), ``plan_fingerprint`` the identity restore validates, and
    ``wisdom`` the provenance of the autotuned choices the plan was
    built from."""

    arrays: Dict[str, np.ndarray]
    step: int = 0
    dt: float = 0.0
    sim_time: float = 0.0
    rng: Optional[Dict[str, Any]] = None
    plan_fingerprint: Dict[str, Any] = dataclasses.field(default_factory=dict)
    wisdom: Dict[str, Any] = dataclasses.field(default_factory=dict)
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    written_at: Optional[float] = None  # stamped by write_checkpoint


# ---------------------------------------------------------------------------
# single-file writer / reader
# ---------------------------------------------------------------------------

def _fsync_dir(directory: str) -> None:
    """Best-effort fsync of the directory entry (the rename itself must
    survive the crash, not only the file bytes)."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def write_checkpoint(path: str, state: SimState) -> int:
    """Serialize ``state`` to ``path`` crash-consistently (temp + fsync +
    ``os.replace`` under the advisory flock, directory fsync'd); returns
    the bytes written. Raises ``OSError``/``TypeError`` on an unwritable
    target or a state that does not serialize: a lost checkpoint is the
    failure this module exists to remove. The payloads stream from the
    arrays' own memory (no joined copy of the state)."""
    sections: List[Dict[str, Any]] = []
    payloads: List[np.ndarray] = []
    offset = 0
    for name in sorted(state.arrays):
        arr = np.ascontiguousarray(state.arrays[name])
        raw = arr.reshape(-1).view(np.uint8)
        sections.append({
            "name": name, "dtype": arr.dtype.str,
            "shape": list(arr.shape), "offset": offset,
            "nbytes": int(raw.size), "crc32c": crc32c(raw),
        })
        payloads.append(raw)
        offset += int(raw.size)
    written_at = time.time()
    header = {
        "version": CHECKPOINT_VERSION,
        "step": int(state.step),
        "dt": float(state.dt),
        "sim_time": float(state.sim_time),
        "rng": state.rng,
        "plan_fingerprint": state.plan_fingerprint,
        "wisdom": state.wisdom,
        "meta": state.meta,
        "written_at": written_at,
        "arrays": sections,
    }
    hdr = json.dumps(header, sort_keys=True).encode("utf-8")
    head = (MAGIC + len(hdr).to_bytes(4, "little")
            + crc32c(hdr).to_bytes(4, "little") + hdr)
    nbytes = len(head) + offset
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    with obs.span("persist.write", path=path, step=int(state.step),
                  nbytes=nbytes), _advisory_lock(path):
        fd, tmp = tempfile.mkstemp(prefix=".ckpt.", dir=d)
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(head)
                for raw in payloads:
                    f.write(memoryview(raw))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
        _fsync_dir(d)
    state.written_at = written_at
    # The injected faults tear / corrupt / stale-stamp the LANDED file,
    # as the field would hand it to the restore path.
    inject.maybe_taint_checkpoint(path)
    obs.metrics.inc("persist.writes")
    obs.metrics.inc("persist.bytes_written", nbytes)
    obs.event("persist.checkpoint", path=path, step=int(state.step),
              nbytes=nbytes, arrays=len(sections))
    return nbytes


def _read_validated(path: str, header_only: bool = False
                    ) -> Tuple[Dict[str, Any], Optional[bytes]]:
    """Read + validate one checkpoint file; returns ``(header,
    payload_bytes)`` (payload None when ``header_only``). Raises
    :class:`CheckpointCorrupt` on ANY defect — validation happens before
    a single payload byte is interpreted."""
    try:
        with open(path, "rb") as f:
            head = f.read(_HEADER_FIXED)
            if len(head) < _HEADER_FIXED:
                raise CheckpointCorrupt(path, "short file (no header)")
            if head[:len(MAGIC)] != MAGIC:
                raise CheckpointCorrupt(
                    path, f"bad magic {head[:len(MAGIC)]!r}")
            hlen = int.from_bytes(head[len(MAGIC):len(MAGIC) + 4], "little")
            hcrc = int.from_bytes(head[len(MAGIC) + 4:], "little")
            hdr_bytes = f.read(hlen)
            if len(hdr_bytes) != hlen:
                raise CheckpointCorrupt(path, "truncated header")
            if crc32c(hdr_bytes) != hcrc:
                raise CheckpointCorrupt(path, "header CRC32C mismatch")
            try:
                header = json.loads(hdr_bytes.decode("utf-8"))
            except (ValueError, UnicodeDecodeError) as e:
                raise CheckpointCorrupt(path,
                                        f"unparsable header ({e})") from e
            version = header.get("version")
            if version != CHECKPOINT_VERSION:
                raise CheckpointCorrupt(
                    path, f"unsupported schema version {version!r} "
                          f"(this build reads {CHECKPOINT_VERSION})")
            if not isinstance(header.get("arrays"), list):
                raise CheckpointCorrupt(path, "header carries no array "
                                              "section table")
            if header_only:
                return header, None
            payload = memoryview(f.read())
    except OSError as e:
        raise CheckpointCorrupt(path, f"unreadable ({e})") from e
    for sec in header["arrays"]:
        off, n = int(sec["offset"]), int(sec["nbytes"])
        if off + n > len(payload):
            raise CheckpointCorrupt(
                path, f"torn payload: section {sec['name']!r} wants "
                      f"[{off}:{off + n}] of {len(payload)} byte(s)")
        if crc32c(payload[off:off + n]) != int(sec["crc32c"]):
            raise CheckpointCorrupt(
                path, f"section {sec['name']!r} CRC32C mismatch")
    return header, payload


def read_checkpoint(path: str) -> SimState:
    """Load + fully validate one checkpoint file into a
    :class:`SimState` (host numpy arrays). Raises
    :class:`CheckpointCorrupt` on any defect; no bytes are interpreted
    as array data until every section checksum has passed."""
    header, payload = _read_validated(path)
    assert payload is not None
    arrays: Dict[str, np.ndarray] = {}
    for sec in header["arrays"]:
        off, n = int(sec["offset"]), int(sec["nbytes"])
        arr = np.frombuffer(payload[off:off + n],
                            dtype=np.dtype(sec["dtype"]))
        arrays[sec["name"]] = arr.reshape(tuple(sec["shape"])).copy()
    return SimState(
        arrays=arrays, step=int(header["step"]), dt=float(header["dt"]),
        sim_time=float(header.get("sim_time", 0.0)),
        rng=header.get("rng"),
        plan_fingerprint=dict(header.get("plan_fingerprint") or {}),
        wisdom=dict(header.get("wisdom") or {}),
        meta=dict(header.get("meta") or {}),
        written_at=header.get("written_at"))


# ---------------------------------------------------------------------------
# two-generation store
# ---------------------------------------------------------------------------

GENERATION_SLOTS = ("ckpt-a.dfft", "ckpt-b.dfft")


# The fingerprint fields a MESH CHANGE (and nothing else) flips: rank
# count, the sequence the autotuner picked for the new rank count, and
# the variant label derived from both. An ``allow_mesh_change`` restore
# tolerates diffs confined to this set — shape, transform, dtype, comm
# and backend disagreements remain configuration errors and refuse.
MESH_CHANGE_FIELDS = frozenset({"ranks", "sequence", "variant"})


def fingerprint_mismatch(stored: Dict[str, Any],
                         current: Dict[str, Any]
                         ) -> Dict[str, Tuple[Any, Any]]:
    """Field-wise diff of two plan fingerprints (empty dict = match).
    The RESTORE path and ``dfft-explain``'s ``checkpoint:`` section both
    call this — one comparison, so explain cannot disagree with
    restore."""
    diffs: Dict[str, Tuple[Any, Any]] = {}
    for k in set(stored) | set(current):
        if stored.get(k) != current.get(k):
            diffs[k] = (stored.get(k), current.get(k))
    return diffs


class CheckpointStore:
    """Two-generation rotating checkpoint store over one directory.

    ``save`` always overwrites the OLDER (or invalid) slot, so the
    newest valid generation is never the write target — a torn write can
    cost at most the generation being written. ``load`` returns the
    newest valid generation, falling back exactly one generation on
    corruption; :meth:`describe` is the registry surface
    ``dfft-explain`` and serve ``health()`` read, built from the SAME
    validation the load path runs."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(os.path.expanduser(str(directory)))

    def _slot_paths(self) -> List[str]:
        return [os.path.join(self.directory, s) for s in GENERATION_SLOTS]

    def _scan(self, full: bool = False) -> List[Dict[str, Any]]:
        """Validate every slot: one record per slot with ``path``/
        ``exists``/``valid``/``step``/``written_at``/``reason``.
        Default is header-only (cheap — header CRC; the load path
        re-validates its chosen generation in full anyway); ``full``
        additionally runs every SECTION checksum, so a verdict built on
        it (``describe``) cannot call a payload-corrupt generation
        valid when restore would skip it."""
        out: List[Dict[str, Any]] = []
        for path in self._slot_paths():
            rec: Dict[str, Any] = {"path": path,
                                   "exists": os.path.exists(path),
                                   "valid": False, "step": None,
                                   "written_at": None, "reason": None,
                                   "mtime": None}
            if rec["exists"]:
                try:
                    rec["mtime"] = os.path.getmtime(path)
                except OSError:
                    pass
                try:
                    header, _ = _read_validated(path, header_only=not full)
                    rec.update(valid=True, step=int(header["step"]),
                               written_at=header.get("written_at"),
                               fingerprint=dict(
                                   header.get("plan_fingerprint") or {}))
                except CheckpointCorrupt as e:
                    rec["reason"] = e.reason
            else:
                rec["reason"] = "absent"
            out.append(rec)
        return out

    def _write_target(self) -> str:
        """The slot ``save`` must overwrite: an absent/invalid slot
        first, else the OLDER valid generation — the newest
        fully-loadable checkpoint is never the write target. FULL
        validation (section checksums, not just the header): a
        payload-torn newest generation must read as the invalid slot
        here, or save would overwrite the only generation ``load``
        could actually restore."""
        scan = self._scan(full=True)
        for rec in scan:
            if not rec["valid"]:
                return str(rec["path"])
        oldest = min(scan, key=lambda r: (r["step"], r["written_at"] or 0))
        return str(oldest["path"])

    def save(self, state: SimState) -> str:
        """Write ``state`` into the rotation; returns the generation
        path written."""
        path = self._write_target()
        write_checkpoint(path, state)
        obs.metrics.gauge("persist.last_checkpoint_age_s", 0.0)
        return path

    def load(self, expect_fingerprint: Optional[Dict[str, Any]] = None,
             allow_mesh_change: bool = False) -> SimState:
        """The newest fully-valid generation, newest-step-first with
        exactly-one-generation fallback on corruption
        (``persist.generation_fallbacks`` + the
        ``checkpoint_restore_failure`` flight-recorder trigger document
        every skipped generation). ``expect_fingerprint`` (the CURRENT
        plan's ``persist.plan_fingerprint``) refuses a mismatched
        checkpoint with :class:`CheckpointMismatch` — no fallback: a
        fingerprint disagreement is configuration, not corruption.

        ``allow_mesh_change=True`` is the shrink-and-replan escape
        hatch: a diff confined to :data:`MESH_CHANGE_FIELDS`
        (rank count + the sequence/variant that follow from it) loads
        anyway — the state is re-placed into the CURRENT plan's
        sharding by ``persist.restore`` — with the two-tier numerical
        contract: same mesh stays bit-exact (this branch never fires),
        changed mesh is allclose under the Parseval guard. NEVER
        silent: the tolerated diff is recorded as a structured
        ``persist.degraded_restore`` event + counter. Any diff outside
        the mesh set still raises :class:`CheckpointMismatch`.

        Raises :class:`CheckpointMissing` when no generation file
        exists, :class:`CheckpointUnusable` when all that exist fail
        validation."""
        from ..obs import flightrec
        scan = [r for r in self._scan() if r["exists"]]
        if not scan:
            raise CheckpointMissing(self.directory)

        def _fell_back(path: str, reason: str) -> None:
            obs.metrics.inc("persist.generation_fallbacks")
            obs.notice(
                f"persist: generation {os.path.basename(path)} invalid "
                f"({reason}); falling back one generation",
                name="persist.generation_fallback", path=path)
            flightrec.trigger("checkpoint_restore_failure",
                              f"generation fallback: {reason}", path=path)

        # Candidates: VALID headers ordered by highest step — the same
        # choice describe()/health advertise as "latest" (mtime is wall
        # clock and survives neither cp nor a clock step, so it must
        # not pick the restore target). Header-invalid generations are
        # recorded up front; one NEWER (by write time) than the best
        # valid candidate means the latest write was lost — an honest
        # generation fallback, accounted before the older state loads.
        order = sorted((r for r in scan if r["valid"]),
                       key=lambda r: (r["step"], r["mtime"] or 0),
                       reverse=True)
        reasons: Dict[str, str] = {}
        for rec in scan:
            if not rec["valid"]:
                path = str(rec["path"])
                reasons[path] = str(rec["reason"])
                obs.event("persist.generation_skipped", path=path,
                          reason=str(rec["reason"]))
                if order and (rec["mtime"] or 0) >= \
                        (order[0]["mtime"] or 0):
                    _fell_back(path, str(rec["reason"]))
        for i, rec in enumerate(order):
            path = str(rec["path"])
            try:
                state = read_checkpoint(path)  # full section CRC pass
            except CheckpointCorrupt as e:
                reasons[path] = e.reason
                obs.event("persist.generation_skipped", path=path,
                          reason=e.reason)
                if i + 1 < len(order):
                    _fell_back(path, e.reason)
                continue
            if expect_fingerprint is not None:
                # The stored fingerprint participates even when EMPTY
                # (a hand-rolled writer that skipped capture): restore
                # and describe() must render the same verdict.
                diffs = fingerprint_mismatch(state.plan_fingerprint,
                                             expect_fingerprint)
                if diffs and allow_mesh_change \
                        and set(diffs) <= MESH_CHANGE_FIELDS:
                    obs.metrics.inc("persist.degraded_restores")
                    obs.event(
                        "persist.degraded_restore", path=path,
                        step=int(state.step),
                        diffs={k: list(v) for k, v in sorted(diffs.items())})
                    obs.notice(
                        "persist: restoring across a mesh change "
                        f"({', '.join(f'{k}: {v[0]!r} -> {v[1]!r}' for k, v in sorted(diffs.items()))}) "
                        "— allclose contract, not bit-exact",
                        name="persist.degraded_restore")
                    diffs = {}
                if diffs:
                    obs.metrics.inc("persist.restore_failures")
                    flightrec.trigger(
                        "checkpoint_restore_failure",
                        f"fingerprint mismatch: {sorted(diffs)}",
                        path=path)
                    raise CheckpointMismatch(path, diffs)
            self.touch_age_gauge(state.written_at)
            obs.metrics.inc("persist.restores")
            obs.event("persist.restore", path=path, step=state.step,
                      fallbacks=len(reasons))
            return state
        obs.metrics.inc("persist.restore_failures")
        flightrec.trigger("checkpoint_restore_failure",
                          "all generations unusable",
                          directory=self.directory)
        raise CheckpointUnusable(self.directory, reasons)

    def touch_age_gauge(self, written_at: Optional[float] = None) -> None:
        """Refresh ``persist.last_checkpoint_age_s`` from the newest
        valid generation (or an explicit stamp) — serve ``health()``
        calls this so the scrape surface carries a live age."""
        if written_at is None:
            valid = [r for r in self._scan() if r["valid"]
                     and r["written_at"] is not None]
            if not valid:
                return
            written_at = max(float(r["written_at"]) for r in valid)
        obs.metrics.gauge("persist.last_checkpoint_age_s",
                          round(max(0.0, time.time() - float(written_at)), 3))

    def describe(self, expect_fingerprint: Optional[Dict[str, Any]] = None,
                 full: bool = True) -> Dict[str, Any]:
        """The registry ``dfft-explain``'s ``checkpoint:`` section and
        serve ``health()`` read: per-slot validity/step/age plus the
        verdict of what :meth:`load` would do for
        ``expect_fingerprint`` — computed by the SAME fingerprint
        comparison the restore path uses, over a FULL (every section
        checksum) validation pass by default, so a payload-corrupt
        generation reads invalid here exactly as restore will treat it.
        ``full=False`` is the cheap header-only variant for hot
        liveness surfaces (the resident's heartbeat-cadence
        ``status()``) where re-reading multi-MB states per pong would
        stall the very reply the death detector times."""
        now = time.time()
        scan = self._scan(full=full)
        gens = []
        for rec in scan:
            gens.append({
                "path": str(rec["path"]), "exists": rec["exists"],
                "valid": rec["valid"], "step": rec["step"],
                "age_s": (round(now - float(rec["written_at"]), 3)
                          if rec.get("written_at") else None),
                "reason": rec["reason"],
            })
        valid = [r for r in scan if r["valid"]]
        latest = max(valid, key=lambda r: (r["step"], r["written_at"] or 0),
                     default=None)
        verdict = "no checkpoint (fresh start)"
        latest_out: Optional[Dict[str, Any]] = None
        if latest is not None:
            latest_out = {
                "path": str(latest["path"]), "step": latest["step"],
                "age_s": (round(now - float(latest["written_at"]), 3)
                          if latest.get("written_at") else None),
            }
            if expect_fingerprint is None:
                verdict = f"restorable (step {latest['step']})"
            else:
                diffs = fingerprint_mismatch(
                    dict(latest.get("fingerprint") or {}),
                    expect_fingerprint)
                verdict = (f"MATCH — restore loads step {latest['step']}"
                           if not diffs else
                           "MISMATCH (CheckpointMismatch): " + ", ".join(
                               f"{k}: checkpoint={a!r} plan={b!r}"
                               for k, (a, b) in sorted(diffs.items())))
        elif any(r["exists"] for r in scan):
            verdict = "UNUSABLE: every generation fails validation"
        return {"directory": self.directory, "generations": gens,
                "latest": latest_out, "fingerprint_verdict": verdict}
