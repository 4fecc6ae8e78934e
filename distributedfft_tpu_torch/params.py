"""Parameter / configuration model of the PyTorch port.

The same sizes, partitions, enums and ``Config`` as the JAX package's
``params.py`` — field names, defaults, ``.value`` strings and constructor
validation are identical, so one configuration means the same thing in
both packages. ``config_from_reference`` (and its ``GlobalSize`` /
``SlabPartition`` siblings) turns ``dataclasses.asdict`` of a JAX-package
object into the port's object: a plan's whole state is its Config, size
and partition, so this is how a plan is carried across.

Pure Python; no device is touched here.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, List, Mapping, Optional, Tuple

from .utils import native_planner

_MXU_PRECISIONS = frozenset({"default", "high", "highest"})

GUARD_MODES = ("off", "check", "enforce")

# Marker for measurement-resolved Config fields (wisdom resolution in the
# JAX package; not ported yet, so the port refuses an unresolved marker).
AUTO = "auto"

_WIRE_DTYPES = ("native", "bf16", AUTO)

# Max relative error the wire race accepts from a compressed wire when
# ``Config.wire_error_budget`` is None (the bf16 wire's documented bound).
DEFAULT_WIRE_ERROR_BUDGET = 2e-2


def parse_wire_dtype(s: str) -> str:
    """Canonical wire-dtype name (case-insensitive; 'auto' = measured)."""
    key = str(s).strip().lower()
    if key in _WIRE_DTYPES:
        return key
    raise ValueError(
        f"unknown wire dtype: {s!r} (choose from {_WIRE_DTYPES})")


def parse_guards(s: str) -> str:
    """Canonical guard-mode name (case-insensitive)."""
    key = str(s).strip().lower()
    if key in GUARD_MODES:
        return key
    raise ValueError(f"unknown guards mode: {s!r} (choose from {GUARD_MODES})")


def parse_overlap_depth(s: "str | int") -> "str | int":
    """``"auto"`` or an int >= 2 (the revolving receive-buffer count)."""
    if isinstance(s, str) and s.strip().lower() == AUTO:
        return AUTO
    try:
        v = int(s)
    except (TypeError, ValueError):
        raise ValueError(
            f"overlap depth must be an int >= 2 or {AUTO!r}, got {s!r}")
    if v < 2:
        raise ValueError(f"overlap depth must be >= 2, got {v}")
    return v


def parse_comm_method(s: "str | CommMethod") -> "str | CommMethod":
    """``CommMethod.parse`` that also accepts ``"auto"`` (the
    wisdom-resolved marker)."""
    if isinstance(s, str) and s.strip().lower() == AUTO:
        return AUTO
    return CommMethod.parse(s)


class CommMethod(enum.Enum):
    """Global-redistribution strategy (reference ``params.hpp:83-85``):
    point-to-point sends to every peer, or one all-to-all."""

    PEER2PEER = "Peer2Peer"
    ALL2ALL = "All2All"

    @classmethod
    def parse(cls, s: "str | CommMethod") -> "CommMethod":
        if isinstance(s, CommMethod):
            return s
        key = str(s).strip().lower().replace("_", "").replace("-", "")
        if key in ("peer2peer", "p2p", "peer"):
            return cls.PEER2PEER
        if key in ("all2all", "a2a", "alltoall"):
            return cls.ALL2ALL
        raise ValueError(f"unknown comm method: {s!r}")


class SendMethod(enum.Enum):
    """Packing strategy (reference ``params.hpp:87-89``, plus the rings)."""

    SYNC = "Sync"
    STREAMS = "Streams"
    MPI_TYPE = "MPI_Type"
    RING = "Ring"
    RING_OVERLAP = "RingOverlap"

    @classmethod
    def parse(cls, s: "str | SendMethod") -> "SendMethod":
        if isinstance(s, SendMethod):
            return s
        key = str(s).strip().lower().replace("_", "").replace("-", "")
        if key == "sync":
            return cls.SYNC
        if key == "streams":
            return cls.STREAMS
        if key == "ring":
            return cls.RING
        if key in ("ringoverlap", "overlap", "ringovl"):
            return cls.RING_OVERLAP
        if key in ("mpitype", "mpit", "type"):
            return cls.MPI_TYPE
        raise ValueError(f"unknown send method: {s!r}")

    @property
    def is_ring(self) -> bool:
        """Both ring renderings: RING and its overlapped schedule."""
        return self in (SendMethod.RING, SendMethod.RING_OVERLAP)


class FFTNorm(enum.Enum):
    """Normalization policy. ``NONE`` is cuFFT's (both directions
    unnormalized); ``BACKWARD`` is numpy's default (inverse carries 1/N)."""

    NONE = "none"
    BACKWARD = "backward"
    ORTHO = "ortho"


class SlabSequence(enum.Enum):
    """Which per-axis FFT sequence a slab plan runs."""

    ZY_THEN_X = "ZY_Then_X"
    Z_THEN_YX = "Z_Then_YX"
    Y_THEN_ZX = "Y_Then_ZX"

    @classmethod
    def parse(cls, s: "str | SlabSequence") -> "SlabSequence":
        if isinstance(s, SlabSequence):
            return s
        key = str(s).strip().lower().replace("-", "_")
        table = {
            "zy_then_x": cls.ZY_THEN_X, "default": cls.ZY_THEN_X,
            "2d_1d": cls.ZY_THEN_X,
            "z_then_yx": cls.Z_THEN_YX, "1d_2d": cls.Z_THEN_YX,
            "y_then_zx": cls.Y_THEN_ZX, "1d_2d_y": cls.Y_THEN_ZX,
        }
        if key in table:
            return table[key]
        raise ValueError(f"unknown slab sequence: {s!r}")


@dataclasses.dataclass(frozen=True)
class GlobalSize:
    """Global 3D extent; ``nz_out`` is the R2C halved z extent
    (reference ``params.hpp:30``: ``Nz_out = Nz/2 + 1``)."""

    nx: int
    ny: int
    nz: int

    def __post_init__(self) -> None:
        for name in ("nx", "ny", "nz"):
            v = getattr(self, name)
            if not isinstance(v, int) or v <= 0:
                raise ValueError(f"{name} must be a positive int, got {v!r}")

    @property
    def nz_out(self) -> int:
        return self.nz // 2 + 1

    @property
    def ny_out(self) -> int:
        return self.ny // 2 + 1

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.nx, self.ny, self.nz)

    @property
    def n_total(self) -> int:
        return self.nx * self.ny * self.nz


@dataclasses.dataclass(frozen=True)
class PartitionDims:
    """Per-axis local extents of every rank for one decomposition stage."""

    size_x: Tuple[int, ...]
    size_y: Tuple[int, ...]
    size_z: Tuple[int, ...]

    @property
    def start_x(self) -> List[int]:
        return native_planner.block_starts(list(self.size_x))

    @property
    def start_y(self) -> List[int]:
        return native_planner.block_starts(list(self.size_y))

    @property
    def start_z(self) -> List[int]:
        return native_planner.block_starts(list(self.size_z))


class Partition:
    """Base partition type (reference ``params.hpp:39-43``)."""

    @property
    def num_ranks(self) -> int:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class SlabPartition(Partition):
    """1D decomposition over x (reference ``Slab_Partition``)."""

    p: int

    def __post_init__(self):
        if self.p <= 0:
            raise ValueError(f"slab partition count must be positive, got {self.p}")

    @property
    def num_ranks(self) -> int:
        return self.p


@dataclasses.dataclass(frozen=True)
class PencilPartition(Partition):
    """2D decomposition over (x, y) into a P1 x P2 grid."""

    p1: int
    p2: int

    def __post_init__(self):
        if self.p1 <= 0 or self.p2 <= 0:
            raise ValueError(f"pencil grid must be positive, got {self.p1}x{self.p2}")

    @property
    def num_ranks(self) -> int:
        return self.p1 * self.p2


@dataclasses.dataclass(frozen=True)
class Config:
    """Plan-wide configuration — field for field the JAX package's
    ``Config`` (its docstring documents every knob). In this port,
    ``fft_backend="xla"`` runs ``torch.fft`` (cuFFT on the card) and
    ``"pallas"`` runs the hand-written Hopper kernels of
    ``ops/hopper_fft.py``; the other backends and the distributed-exchange
    knobs are accepted and validated but not ported yet."""

    comm_method: CommMethod = CommMethod.ALL2ALL
    send_method: SendMethod = SendMethod.SYNC
    comm_method2: Optional[CommMethod] = None
    send_method2: Optional[SendMethod] = None
    opt: int = 0
    cuda_aware: bool = True
    warmup_rounds: int = 0
    iterations: int = 1
    double_prec: bool = False
    norm: FFTNorm = FFTNorm.NONE
    benchmark_dir: str = "benchmarks"
    fft_backend: str = "xla"
    mxu_precision: Optional[str] = None
    mxu_karatsuba: Optional[bool] = None
    mxu_fourstep_einsum: Optional[bool] = None
    mxu_direct_max: Optional[int] = None
    fft3d_chunk: Optional[int] = None
    streams_chunks: Optional[int] = None
    overlap_depth: "int | str" = AUTO
    overlap_subblocks: Optional[int] = None
    wire_dtype: str = "native"
    wire_error_budget: Optional[float] = None
    fused_wire: bool = False
    guards: Optional[str] = None
    wisdom_path: Optional[str] = None
    use_wisdom: bool = True

    def __post_init__(self):
        from .ops.fft import validate_backend  # lazy: ops.fft imports params
        if self.fft_backend != AUTO:
            validate_backend(self.fft_backend)
        if not (isinstance(self.comm_method, CommMethod)
                or self.comm_method == AUTO):
            raise ValueError(
                f"comm_method must be a CommMethod or {AUTO!r}, "
                f"got {self.comm_method!r}")
        if not (self.comm_method2 is None
                or isinstance(self.comm_method2, CommMethod)
                or self.comm_method2 == AUTO):
            raise ValueError(
                f"comm_method2 must be a CommMethod, {AUTO!r} or None, "
                f"got {self.comm_method2!r}")
        if self.mxu_precision is not None and \
                str(self.mxu_precision).lower() not in _MXU_PRECISIONS:
            raise ValueError(
                f"mxu_precision must be one of {sorted(_MXU_PRECISIONS)} "
                f"or None, got {self.mxu_precision!r}")
        if self.fft3d_chunk is not None and (
                not isinstance(self.fft3d_chunk, int) or self.fft3d_chunk < 1):
            raise ValueError(
                f"fft3d_chunk must be a positive int or None, "
                f"got {self.fft3d_chunk!r}")
        if self.mxu_direct_max is not None and (
                not isinstance(self.mxu_direct_max, int)
                or self.mxu_direct_max < 1):
            raise ValueError(
                f"mxu_direct_max must be a positive int or None, "
                f"got {self.mxu_direct_max!r}")
        if self.streams_chunks is not None and (
                not isinstance(self.streams_chunks, int)
                or self.streams_chunks < 1):
            raise ValueError(
                f"streams_chunks must be a positive int or None, "
                f"got {self.streams_chunks!r}")
        object.__setattr__(self, "overlap_depth",
                           parse_overlap_depth(self.overlap_depth))
        if self.overlap_subblocks is not None and (
                not isinstance(self.overlap_subblocks, int)
                or self.overlap_subblocks < 1):
            raise ValueError(
                f"overlap_subblocks must be a positive int or None, "
                f"got {self.overlap_subblocks!r}")
        if self.wire_dtype not in _WIRE_DTYPES:
            raise ValueError(
                f"wire_dtype must be one of {_WIRE_DTYPES}, "
                f"got {self.wire_dtype!r}")
        if self.wire_error_budget is not None and (
                not isinstance(self.wire_error_budget, (int, float))
                or not self.wire_error_budget > 0):
            raise ValueError(
                f"wire_error_budget must be a positive number or None, "
                f"got {self.wire_error_budget!r}")
        if not isinstance(self.fused_wire, bool):
            raise ValueError(
                f"fused_wire must be a bool, got {self.fused_wire!r}")
        if self.guards is not None:
            object.__setattr__(self, "guards", parse_guards(self.guards))

    def unresolved(self) -> bool:
        """True while a field still carries the wisdom-resolved ``"auto"``
        marker (the JAX package's ``wisdom.unresolved``)."""
        return AUTO in (self.fft_backend, self.comm_method,
                        self.comm_method2, self.wire_dtype)

    def resolved_snd2(self) -> SendMethod:
        return (self.send_method2 if self.send_method2 is not None
                else self.send_method)

    def resolved_overlap_depth(self) -> int:
        """Revolving receive-buffer depth of the overlapped ring
        (``"auto"`` -> 2, the double-buffered schedule)."""
        return 2 if self.overlap_depth == AUTO else int(self.overlap_depth)

    def resolved_overlap_subblocks(self) -> int:
        """Sub-blocks each travelling ring block is split into (None -> 1)."""
        return (self.overlap_subblocks
                if self.overlap_subblocks is not None else 1)

    def fused_wire_for(self, snd: SendMethod) -> bool:
        """The fused wire is on for an exchange rendered by ``snd``: opt-in
        ``fused_wire`` on a ring with the bf16 wire, inert elsewhere."""
        return bool(self.fused_wire and snd.is_ring
                    and self.wire_dtype == "bf16")

    def fused_wire_active(self, second: bool = False) -> bool:
        """``fused_wire_for`` of this plan's first (or second) transpose."""
        return self.fused_wire_for(self.resolved_snd2() if second
                                   else self.send_method)

    def resolved_wire_budget(self) -> float:
        """Max rel error accepted from a compressed wire (None ->
        ``DEFAULT_WIRE_ERROR_BUDGET``)."""
        return (self.wire_error_budget if self.wire_error_budget is not None
                else DEFAULT_WIRE_ERROR_BUDGET)


# Enum-typed Config fields and their enum classes.
_ENUM_FIELDS = {"comm_method": CommMethod, "send_method": SendMethod,
                "comm_method2": CommMethod, "send_method2": SendMethod,
                "norm": FFTNorm}


def config_from_reference(d: Mapping[str, Any]) -> Config:
    """The port's ``Config`` from ``dataclasses.asdict`` of a JAX-package
    ``Config``. Enum fields may be given as enum members of either package
    or as their ``.value`` strings. A field still set to ``"auto"`` needs
    wisdom resolution, which is not ported: ``NotImplementedError``."""
    kw = {}
    for k, v in d.items():
        v = getattr(v, "value", v)
        if k in _ENUM_FIELDS and v is not None and v != AUTO:
            v = _ENUM_FIELDS[k](v)
        kw[k] = v
    cfg = Config(**kw)
    if cfg.unresolved():
        raise NotImplementedError(
            "Config fields set to 'auto' need wisdom resolution "
            "(utils/wisdom.py), which the port does not have yet "
            "(ROADMAP Queue 1, item 11)")
    return cfg


def global_size_from_reference(d: Mapping[str, Any]) -> GlobalSize:
    """The port's ``GlobalSize`` from ``dataclasses.asdict`` of the JAX one."""
    return GlobalSize(**d)


def slab_partition_from_reference(d: Mapping[str, Any]) -> SlabPartition:
    """The port's ``SlabPartition`` from ``dataclasses.asdict`` of the JAX one."""
    return SlabPartition(**d)
