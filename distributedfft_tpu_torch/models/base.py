"""Plan base class of the port — the analog of the reference's
``MPIcuFFT<T>`` core (``include/mpicufft.hpp:55-79``).

Construct with a global size, a partition and a Config; query the shapes;
execute forward and inverse transforms on tensors of the plan's device.
With one rank a plan takes the single-device path (the reference's
``fft3d = (pcnt == 1)`` fallback, ``src/mpicufft.cpp:65``): one local 3D
transform per direction through ``ops/fft.py``, or per-axis transforms
over leading-axis chunks under ``Config.fft3d_chunk``. The distributed
pipelines live in the subclasses.

The solver protocol (``spectral_halved_axis``, ``exec_fwd`` /
``exec_inv``, ``forward_fn`` / ``inverse_fn``) is the surface the
solvers of ``solvers/`` drive every family through. ``forward_fn`` and
``inverse_fn`` return the pipelines with no envelope and no guard, and
differentiable: each exchange is an autograd Function
(``parallel/transpose.py``), each kernel wrapper a boundary whose
backward raises (``ops/hopper_fft.py``).

Every execution runs inside the resilience envelope
(``resilience.fallback.execute``), as in the JAX package: the guards of
the plan's mode (resolved once here) check each result, and a failing
rendering walks the fallback ladder one rung at a time. A kernel error is
never a rung: it propagates.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import obs
from ..ops import fft as local_fft
from ..params import Config, GlobalSize, Partition
from ..parallel.transpose import pad_axis_to
from ..resilience import fallback, guards

Pipeline = Callable[[torch.Tensor], torch.Tensor]


def notice_axis_smoothness(kind: str, axes_lengths, config) -> None:
    """A one-line notice when an axis length is not 5-smooth under a
    backend whose fast path needs smooth lengths (the matmul backend's
    dense products, the kernels' tile bodies), naming the fix
    (``fft_backend="bluestein"``). "xla" and "bluestein" take every
    length: no notice there."""
    from ..ops.bluestein import is_smooth
    rough = sorted({int(n) for n in axes_lengths if not is_smooth(int(n))})
    if rough and config.fft_backend in ("matmul", "matmul-r2", "pallas"):
        obs.notice(
            f"{kind} plan: non-smooth axis length(s) {rough} fall off the "
            f"{config.fft_backend} fast path (dense O(n^2) per axis); "
            "fft_backend='bluestein' keeps them O(n log n)",
            name="plan.nonsmooth_axes", kind=kind, lengths=rough,
            backend=config.fft_backend)


def resolve_device(device: "str | torch.device") -> torch.device:
    """The plan's device. A CUDA device with no usable card raises: the
    port never carries on silently on the CPU (pass ``device="cpu"`` to run
    the plain versions there)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            f"available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def logical_block(padded_local, logical, sl) -> Tuple[int, ...]:
    """The shape of the logical part of a rank's block: ``padded_local``
    is the block's shape, ``sl`` its place in the padded global array
    (``local_slices``) and ``logical`` the unpadded global shape. Along a
    split axis the block keeps the entries below the logical extent (none
    on a rank whose block is all pad)."""
    return tuple(max(0, min(int(b), int(n) - (s.start or 0)))
                 for b, n, s in zip(padded_local, logical, sl))


def with_pad(pure: Pipeline, logical, padded, convert: Pipeline
             ) -> Pipeline:
    """A pure pipeline that takes a ``logical``-shaped input, zero-padded
    to ``padded`` by a differentiable pad (``pad_axis_to``, whose gradient
    slices the cotangent), or a ``padded``-shaped one as it is; any other
    shape raises, as the ``exec_*`` checks do (the JAX package's
    ``_with_pad``). ``convert`` puts the input on the plan's device and
    dtype first (a no-op on a tensor that is there)."""
    logical, padded = tuple(logical), tuple(padded)

    def fn(x) -> torch.Tensor:
        x = convert(x)
        if tuple(x.shape) == logical:
            for ax, n in enumerate(padded):
                x = pad_axis_to(x, ax, n)
        elif tuple(x.shape) != padded:
            raise ValueError(
                f"input shape {tuple(x.shape)} matches neither the logical "
                f"shape {logical} nor the padded shape {padded}")
        return pure(x)

    return fn


def to_plan(device: torch.device, dtype: torch.dtype) -> Pipeline:
    """``x`` on ``device`` in ``dtype``: the same tensor when it is there
    already, else a differentiable conversion (numpy arrays too)."""
    def convert(x) -> torch.Tensor:
        return torch.as_tensor(x).to(device=device, dtype=dtype)

    return convert


class DistFFTPlan:
    """Base class of the plans; subclasses build the pipelines."""

    def __init__(self, global_size: GlobalSize, partition: Partition,
                 config: Optional[Config] = None,
                 device: "str | torch.device" = "cuda"):
        self.global_size = global_size
        self.partition = partition
        self.config = config or Config()
        if self.config.unresolved():
            # The families resolve "auto" before they get here
            # (utils/wisdom.resolve_config); a bare base plan cannot.
            raise ValueError(
                "Config has unresolved 'auto' fields: build a plan family "
                "(it resolves them), or resolve the Config with "
                "utils.wisdom.resolve_config first")
        self.device = resolve_device(device)
        self.real_dtype, self.complex_dtype = local_fft.dtypes_for(
            self.config.double_prec)
        # The matmul backend's settings, resolved once here: every local
        # FFT of the plan runs under this snapshot (None: the process
        # defaults at each call, when the Config sets no mxu_* knob).
        self._mxu_st = self.config.mxu_settings()
        # The guard mode, resolved once here (field -> $DFFT_GUARDS ->
        # off), so a mid-run env change cannot split a plan's directions
        # across modes; _guard_state holds each direction's tolerances.
        self._guard_mode = guards.resolved_mode(self.config)
        self._guard_state: dict = {}
        # Single-process path, exactly the reference's fft3d = (pcnt == 1).
        self.fft3d = partition.num_ranks == 1
        # The process group the exchanges run over (None: the world group,
        # or no exchange on one rank).
        self.group = None
        self._r2c: Optional[Pipeline] = None
        self._c2r: Optional[Pipeline] = None
        self._pure: dict = {}

    # -- shape queries (reference getInSize/getOutSize family) -------------

    @property
    def input_shape(self) -> Tuple[int, int, int]:
        """Global real-space shape (x, y, z)."""
        return self.global_size.shape

    @property
    def output_shape(self) -> Tuple[int, int, int]:
        g = self.global_size
        return (g.nx, g.ny, g.nz_out)

    @property
    def transform_axes(self) -> Tuple[int, ...]:
        return (0, 1, 2)

    @property
    def transform_size(self) -> int:
        """Product of the logical extents over the transformed axes."""
        out = 1
        for a in self.transform_axes:
            out *= int(self.input_shape[a])
        return out

    # -- the solver protocol (the JAX package's models/base.py) -----------
    # The solvers (``solvers/``) drive every plan family through this
    # surface only; ``Batched2DFFTPlan`` honors it outside the hierarchy.

    @property
    def spectral_halved_axis(self) -> Optional[int]:
        """The ``n//2+1``-halved spectral axis, or None for C2C plans."""
        if getattr(self, "transform", "r2c") == "c2c":
            return None
        return self._halved_axis_index()

    def _halved_axis_index(self) -> int:
        """The R2C axis of this family (the pencil halves z; the slab
        overrides it per sequence)."""
        return 2

    def exec_fwd(self, x) -> torch.Tensor:
        """Forward transform of the plan's own family (r2c: ``exec_r2c``,
        c2c: ``exec_c2c``), inside the resilience envelope."""
        if getattr(self, "transform", "r2c") == "c2c":
            return self.exec_c2c(x)
        return self.exec_r2c(x)

    def exec_inv(self, c) -> torch.Tensor:
        """Inverse transform (see ``exec_fwd``)."""
        if getattr(self, "transform", "r2c") == "c2c":
            return self.exec_c2c_inv(c)
        return self.exec_c2r(c)

    # -- execution ----------------------------------------------------------

    def exec_r2c(self, x: torch.Tensor) -> torch.Tensor:
        """Forward real-to-complex transform (reference ``execR2C``),
        inside the resilience envelope (``fallback.execute``)."""
        return fallback.execute(self, "forward", x, self._get_r2c)

    def exec_c2r(self, c: torch.Tensor) -> torch.Tensor:
        """Inverse complex-to-real transform (reference ``execC2R``)."""
        return fallback.execute(self, "inverse", c, self._get_c2r)

    def _build_attrs(self) -> dict:
        """The ``plan.build`` span's attributes."""
        return {}

    def _get_r2c(self) -> Pipeline:
        if self._r2c is None:
            with obs.span("plan.build", direction="forward",
                          **self._build_attrs()):
                self._r2c, _ = guards.maybe_wrap(self, self._build_r2c(),
                                                 "forward")
        return self._r2c

    def _get_c2r(self) -> Pipeline:
        if self._c2r is None:
            with obs.span("plan.build", direction="inverse",
                          **self._build_attrs()):
                self._c2r, _ = guards.maybe_wrap(self, self._build_c2r(),
                                                 "inverse")
        return self._c2r

    def _build_r2c(self) -> Pipeline:
        raise NotImplementedError

    def _build_c2r(self) -> Pipeline:
        raise NotImplementedError

    def _guard_spec(self, direction: str, dims: int = 3
                    ) -> guards.GuardSpec:
        """The family's ``guards.GuardSpec`` for one direction (only
        consulted at modes check/enforce)."""
        raise NotImplementedError

    # -- single-device path ------------------------------------------------

    def _chunk_for(self, nx: int) -> Optional[int]:
        """Validated ``Config.fft3d_chunk`` for a leading extent of ``nx``
        (None = unchunked path)."""
        ck = self.config.fft3d_chunk
        if not ck or ck <= 1:
            return None
        if nx % ck:
            raise ValueError(f"fft3d_chunk {ck} must divide the x extent "
                             f"{nx}")
        return ck

    def _fft3d_r2c(self) -> Pipeline:
        kw = dict(norm=self.config.norm, backend=self.config.fft_backend,
                  settings=self._mxu_st)
        ck = self._chunk_for(self.input_shape[0])

        def run(x: torch.Tensor) -> torch.Tensor:
            if ck is None:
                return local_fft.rfftn_3d(x, **kw)
            # Memory-bounded large-cube path: z+y stages per leading-axis
            # chunk; the x stage needs the full axis and runs on the
            # already-halved spectrum.
            parts = [local_fft.fft(local_fft.rfft(xs, axis=-1, **kw),
                                   axis=-2, **kw)
                     for xs in torch.chunk(x, ck, dim=0)]
            return local_fft.fft(torch.cat(parts, dim=0), axis=-3, **kw)

        return run

    def _fft3d_c2r(self) -> Pipeline:
        kw = dict(norm=self.config.norm, backend=self.config.fft_backend,
                  settings=self._mxu_st)
        shape = self.input_shape
        ck = self._chunk_for(shape[0])

        def run(c: torch.Tensor) -> torch.Tensor:
            if ck is None:
                return local_fft.irfftn_3d(c, shape, **kw)
            c = local_fft.ifft(c, axis=-3, **kw)
            parts = [local_fft.irfft(local_fft.ifft(cs, axis=-2, **kw),
                                     n=shape[-1], axis=-1, **kw)
                     for cs in torch.chunk(c, ck, dim=0)]
            return torch.cat(parts, dim=0)

        return run

    def _fft3d_c2c(self, forward: bool) -> Pipeline:
        """Single-device full 3D C2C (both directions unnormalized under
        FFTNorm.NONE, like cuFFT's CUFFT_FORWARD/CUFFT_INVERSE)."""
        kw = dict(norm=self.config.norm, backend=self.config.fft_backend,
                  settings=self._mxu_st)
        axes = (-3, -2, -1)

        def run(c: torch.Tensor) -> torch.Tensor:
            if forward:
                return local_fft.fftn(c, axes, **kw)
            return local_fft.ifftn(c, axes, **kw)

        return run


class AxisBlocks:
    """This rank's block of a global array split along one axis over the
    ``_P`` ranks of ``group`` (the slab and batched-2D plans): ``_block``
    cuts it from the logical or padded global array onto the plan's
    device, ``_gather`` puts the padded global array back together on
    every rank (collective), ``_host`` hands it to numpy. One rank
    (``fft3d``) holds the whole array."""

    rank: int
    _P: int
    fft3d: bool
    group = None
    device: torch.device

    def _block(self, a, dtype: torch.dtype, axis: int, logical, padded
               ) -> torch.Tensor:
        t = torch.as_tensor(a)
        if tuple(t.shape) == tuple(logical):
            t = pad_axis_to(t, axis, padded[axis])
        elif tuple(t.shape) != tuple(padded):
            raise ValueError(f"expected the global shape {tuple(logical)} (or "
                             f"padded {tuple(padded)}), got {tuple(t.shape)}")
        b = padded[axis] // self._P
        t = t.narrow(axis, self.rank * b, b)
        return t.to(device=self.device, dtype=dtype).contiguous()

    def _gather(self, t, axis: int):
        """The padded global array from every rank's block (all ranks
        must call it); the block itself on one rank."""
        if self.fft3d:
            return t
        t = torch.as_tensor(t, device=self.device).contiguous()
        parts = [torch.empty_like(t) for _ in range(self._P)]
        if t.is_complex():
            dist.all_gather([torch.view_as_real(q) for q in parts],
                            torch.view_as_real(t), group=self.group)
        else:
            dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim=axis)

    @staticmethod
    def _host(t) -> np.ndarray:
        return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)

    def _fn_shapes(self, output: bool):
        """(logical, padded) input shapes of ``forward_fn`` (or of
        ``inverse_fn``, ``output``): the global shapes on one rank, this
        rank's block and its logical part on P ranks."""
        if output:
            logical, padded, local = (self.output_shape,
                                      self.output_padded_shape,
                                      self.local_output_shape)
        else:
            logical, padded, local = (self.input_shape,
                                      self.input_padded_shape,
                                      self.local_input_shape)
        if self.fft3d:
            return logical, padded
        return logical_block(local, logical, self.local_slices(output)), local

    def _pure_fn(self, forward: bool, build: Callable[[], Pipeline]
                 ) -> Pipeline:
        """``forward_fn`` / ``inverse_fn`` of the slab and batched plans:
        ``build()``'s pipeline behind ``with_pad``, built once."""
        if forward not in self._pure:
            in_dtype = (self.complex_dtype if not forward
                        or self.transform == "c2c" else self.real_dtype)
            self._pure[forward] = with_pad(
                build(), *self._fn_shapes(not forward),
                to_plan(self.device, in_dtype))
        return self._pure[forward]
