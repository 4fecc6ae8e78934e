"""Batched distributed 2D FFT plan of the port — the JAX package's
``models/batched2d.py`` over ``torch.distributed``.

BASELINE config #4 ("Batched 2D FFT 4096^2 x 64, 1D mesh"). Arrays are
``(batch, nx, ny)``; the transform runs over (x, y) with ``batch`` a pure
batch axis (cuFFT's "batched plan"). Two decompositions over P ranks:

* ``shard="batch"``: the batch axis is split over the ranks, each rank
  transforms its images alone, no exchange;
* ``shard="x"``: x is split, as in the slab plan: the 1D FFT along y, one
  exchange that scatters spectral y and gathers x, the 1D FFT along x.
  The exchange takes every rendering of the slab plan: the all-to-all
  (ALL2ALL + SYNC, opt 0 or 1), point to point (PEER2PEER + SYNC;
  MPI_TYPE is SYNC's alias), the pipelined all-to-all (ALL2ALL with
  ``overlap_subblocks`` > 1), STREAMS (K exchanges on pieces of the batch
  axis, the one axis neither the FFTs nor the exchange touch; under
  ALL2ALL each piece runs its x FFT after its own exchange) and the ring
  (RING / RING_OVERLAP, whatever the comm method says). The x FFT runs
  along the gathered axis, so no ring block runs a per-block FFT: under
  ``fused_wire`` the ring's wire is kernel 9's encode and kernel 10's
  unpack-only arrival (``hopper_fft.fused_ring_hooks``).

With one rank (``SlabPartition(1)``) the plan transforms the whole stack
on its device. ``batch_chunk`` (one rank, or ``shard="batch"``) runs the
rank's batch in slices of that many images, one after another, to cap
the intermediates' memory; ``0`` means None, the whole stack at once.

Padded-shape contract (the JAX package's): ``shard="batch"`` pads the
batch to a multiple of P; ``shard="x"`` pads x on the way in and the
spectral y extent (``ny // 2 + 1``, or ``ny`` for c2c) on the way out;
pad lanes of the forward output are exact zeros. Local in, local out, as
in the slab plan: on P > 1 ranks ``exec_forward`` / ``exec_inverse`` take
and return this rank's block (``local_input_shape``,
``local_output_shape``); ``pad_input`` / ``pad_spectral`` cut it from the
logical global array and ``crop_real`` / ``crop_spectral`` gather the
blocks and return the logical global host array on every rank.

The staged surface (``forward_stages`` / ``inverse_stages``,
``section_descriptions``, ``variant_name``) gives the phase ``Timer`` of
the testcases the JAX plan's phases; ``global_size`` maps (batch, nx, ny)
onto the CSV name's three slots.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import obs
from .. import params as pm
from ..ops import fft as lf
from ..ops import hopper_fft as hf
from ..parallel.mesh import make_slab_group
from ..parallel.transpose import (concat_axis_chunks, exchange_body,
                                  pad_axis_to, ring_subblocks, ring_transpose,
                                  slice_axis_to, split_axis_chunks)
from ..utils.native_planner import padded_extent
from ..resilience import fallback, guards
from ..utils import wisdom
from .base import AxisBlocks, Pipeline, notice_axis_smoothness, resolve_device
from .slab import XPOSE_SECTIONS

_BATCH_STAGE = "2D FFT X-Y-Direction"


class Batched2DFFTPlan(AxisBlocks):
    """Distributed batched 2D R2C/C2R (or C2C) FFT over P ranks."""

    def __init__(self, batch: int, nx: int, ny: int,
                 partition: pm.SlabPartition,
                 config: Optional[pm.Config] = None, shard: str = "batch",
                 transform: str = "r2c", batch_chunk: Optional[int] = None,
                 device: "str | torch.device" = "cuda", group=None):
        if shard not in ("batch", "x"):
            raise ValueError(f"shard must be 'batch' or 'x', got {shard!r}")
        if transform not in ("r2c", "c2c"):
            raise ValueError(f"transform must be 'r2c' or 'c2c', got {transform!r}")
        if batch <= 0 or nx <= 0 or ny <= 0:
            raise ValueError("batch/nx/ny must be positive")
        if batch_chunk == 0:
            batch_chunk = None      # 0 = the whole stack at once
        self.device = resolve_device(device)
        # "auto" Config fields are settled here (see SlabFFTPlan);
        # shard='batch' posts no exchange, so its comm "auto" resolves to
        # the defaults without a race.
        self.config = wisdom.resolve_config(
            "batched2d", pm.GlobalSize(batch, nx, ny), partition,
            config or pm.Config(), transform=transform, dims=2,
            variant=shard, device=self.device, group=group)
        self.real_dtype, self.complex_dtype = lf.dtypes_for(
            self.config.double_prec)
        self._mxu_st = self.config.mxu_settings()
        # The guard mode, resolved once (the DistFFTPlan contract: this
        # plan stands outside that hierarchy but honors the same
        # guard/fallback envelope).
        self._guard_mode = guards.resolved_mode(self.config)
        self._guard_state: dict = {}
        self.batch, self.nx, self.ny = batch, nx, ny
        self.partition = partition
        self.shard = shard
        self.transform = transform
        P = partition.p
        self._P = P
        self.fft3d = P == 1
        self._ny_spec = ny if transform == "c2c" else ny // 2 + 1
        self._batch_pad, self._nx_pad, self._nys_pad = batch, nx, self._ny_spec
        if self.fft3d:
            self._in_axis = self._out_axis = 0
        elif shard == "batch":
            self._batch_pad = padded_extent(batch, P)
            self._in_axis = self._out_axis = 0
        else:
            self._nx_pad = padded_extent(nx, P)
            self._nys_pad = padded_extent(self._ny_spec, P)
            self._in_axis, self._out_axis = 1, 2
        self.batch_chunk = batch_chunk
        if batch_chunk is not None:
            if batch_chunk <= 0:
                raise ValueError("batch_chunk must be positive")
            if not (self.fft3d or shard == "batch"):
                raise ValueError("batch_chunk requires shard='batch' (or "
                                 "the single-process fallback): with "
                                 "shard='x' the batch axis is not chunkable "
                                 "independently of the collectives")
            local_b = self._batch_pad // P
            if local_b % batch_chunk:
                raise ValueError(
                    f"batch_chunk {batch_chunk} must divide the local "
                    f"padded batch {local_b}")
        self.group, self.rank = None, 0
        if P > 1:
            if group is None or group is dist.group.WORLD:
                # Held as None (the world group), as in the slab plan.
                make_slab_group(P)
                group = None
            elif dist.get_world_size(group) != P:
                raise ValueError(
                    f"the process group has {dist.get_world_size(group)} "
                    f"ranks but the partition asks for {P}")
            self.group = group
            self.rank = dist.get_rank(group)
        self._fwd: Optional[Pipeline] = None
        self._inv: Optional[Pipeline] = None
        self._pure: dict = {}
        notice_axis_smoothness("batched2d", (nx, ny), self.config)
        obs.event("plan.created", kind="batched2d", shard=shard,
                  transform=transform, shape=[batch, nx, ny], ranks=P,
                  batch_chunk=batch_chunk,
                  comm=self.config.comm_method.value,
                  send=self.config.send_method.value, opt=self.config.opt,
                  wire=self.config.wire_dtype,
                  backend=self.config.fft_backend)

    # -- shapes ---------------------------------------------------------------

    @property
    def input_shape(self) -> Tuple[int, int, int]:
        return (self.batch, self.nx, self.ny)

    @property
    def input_padded_shape(self) -> Tuple[int, int, int]:
        # shard='batch' pads the batch, shard='x' pads x, one rank neither.
        return (self._batch_pad, self._nx_pad, self.ny)

    @property
    def output_shape(self) -> Tuple[int, int, int]:
        return (self.batch, self.nx, self._ny_spec)

    @property
    def output_padded_shape(self) -> Tuple[int, int, int]:
        return (self._batch_pad, self.nx, self._nys_pad)

    @property
    def _input_dtype(self) -> torch.dtype:
        return self.complex_dtype if self.transform == "c2c" else \
            self.real_dtype

    @property
    def local_input_shape(self) -> Tuple[int, int, int]:
        """This rank's block of the padded input."""
        s = list(self.input_padded_shape)
        s[self._in_axis] //= self._P
        return tuple(s)

    @property
    def local_output_shape(self) -> Tuple[int, int, int]:
        """This rank's block of the padded output."""
        s = list(self.output_padded_shape)
        s[self._out_axis] //= self._P
        return tuple(s)

    def local_slices(self, output: bool = False) -> Tuple[slice, ...]:
        """Where this rank's block lies in the padded global input (or
        output)."""
        axis = self._out_axis if output else self._in_axis
        b = (self.local_output_shape if output else self.local_input_shape)[axis]
        sl = [slice(None)] * 3
        sl[axis] = slice(self.rank * b, (self.rank + 1) * b)
        return tuple(sl)

    # -- the solver protocol (the JAX plan's surface) -------------------------

    @property
    def transform_axes(self) -> Tuple[int, ...]:
        """(x, y); axis 0 is a pure batch axis."""
        return (1, 2)

    @property
    def transform_size(self) -> int:
        """N of the per-plane 2D transform (the batch axis carries no
        normalization)."""
        return self.nx * self.ny

    @property
    def spectral_halved_axis(self) -> Optional[int]:
        return None if self.transform == "c2c" else 2

    def exec_fwd(self, x) -> torch.Tensor:
        return self.exec_forward(x)

    def exec_inv(self, c) -> torch.Tensor:
        return self.exec_inverse(c)

    def forward_fn(self) -> Pipeline:
        """The forward pipeline with no resilience envelope and no guard,
        differentiable, built once (``SlabFFTPlan.forward_fn``'s
        contract): the stack on one rank, this rank's padded block (or its
        logical part) on P ranks."""
        return self._pure_fn(True, lambda: self._build(True))

    def inverse_fn(self) -> Pipeline:
        """The inverse pipeline (see ``forward_fn``)."""
        return self._pure_fn(False, lambda: self._build(False))

    # -- logical <-> padded conversion ----------------------------------------

    def pad_input(self, x) -> torch.Tensor:
        """Logical (or padded) global input -> this rank's padded input
        block on the plan's device (real, or complex for c2c plans)."""
        return self._block(x, self._input_dtype, self._in_axis,
                           self.input_shape, self.input_padded_shape)

    def pad_spectral(self, c) -> torch.Tensor:
        """Logical (or padded) global spectrum -> this rank's padded output
        block on the plan's device."""
        return self._block(c, self.complex_dtype, self._out_axis,
                           self.output_shape, self.output_padded_shape)

    def crop_spectral(self, c) -> np.ndarray:
        """Forward output block(s) -> logical (batch, nx, ny_spec) host
        array (collective: every rank calls it)."""
        full = self._gather(c, self._out_axis)
        return self._host(full)[: self.batch, : self.nx, : self._ny_spec]

    def crop_real(self, r) -> np.ndarray:
        """Inverse output block(s) -> logical (batch, nx, ny) host array."""
        full = self._gather(r, self._in_axis)
        return self._host(full)[: self.batch, : self.nx, : self.ny]

    # -- execution -------------------------------------------------------------

    def exec_forward(self, x) -> torch.Tensor:
        """Batched 2D forward transform over (x, y) of the global stack (one
        rank) or of this rank's block."""
        x = self._checked(x, self._input_dtype, self.local_input_shape,
                          "forward")
        return fallback.execute(self, "forward", x, self._get_fwd, dims=2)

    def exec_inverse(self, c) -> torch.Tensor:
        """Batched 2D inverse transform."""
        c = self._checked(c, self.complex_dtype, self.local_output_shape,
                          "inverse")
        return fallback.execute(self, "inverse", c, self._get_inv, dims=2)

    def _get_fwd(self) -> Pipeline:
        if self._fwd is None:
            self._fwd = self._guarded(True)
        return self._fwd

    def _get_inv(self) -> Pipeline:
        if self._inv is None:
            self._inv = self._guarded(False)
        return self._inv

    def _guarded(self, forward: bool) -> Pipeline:
        direction = "forward" if forward else "inverse"
        with obs.span("plan.build", kind="batched2d", shard=self.shard,
                      direction=direction):
            return guards.maybe_wrap(self, self._build(forward), direction,
                                     dims=2)[0]

    # -- resilience hooks (guards + fallback ladder) ----------------------------

    def _guard_spec(self, direction: str, dims: int = 2) -> guards.GuardSpec:
        """GuardSpec of the batched-2D pipelines (the JAX plan's): the
        transform covers (x, y) of every image, so the Parseval volume is
        ``nx * ny`` and the R2C halved axis is the last."""
        return guards.transform_spec(
            direction, self.config.norm, float(self.nx * self.ny),
            self.transform == "c2c", self.input_shape, self.output_shape, 2,
            self.ny)

    def _checked(self, a, dtype: torch.dtype, local, direction: str
                 ) -> torch.Tensor:
        """``a`` on the plan's device in ``dtype``, when it has the shape
        ``local`` of this rank's block (the whole padded stack on one
        rank, where padding changes nothing)."""
        if tuple(a.shape) != tuple(local):
            whose = "the stack" if self.fft3d else "this rank's block"
            raise ValueError(f"{direction} exec expected {whose} "
                             f"{tuple(local)}, got {tuple(a.shape)}")
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def _wisdom_key_args(self) -> dict:
        return {"kind": "batched2d", "variant": self.shard,
                "transform": self.transform, "dims": 2}

    def _whole(self, forward: bool) -> Pipeline:
        return self.exec_forward if forward else self.exec_inverse

    # -- builders --------------------------------------------------------------

    def _fft_kw(self) -> dict:
        cfg = self.config
        return dict(norm=cfg.norm, backend=cfg.fft_backend,
                    settings=self._mxu_st)

    def _fft2(self, x: torch.Tensor, forward: bool) -> torch.Tensor:
        """The per-plane 2D transform of a local stack: y then x forward,
        x then y inverse."""
        kw, c2c = self._fft_kw(), self.transform == "c2c"
        if forward:
            c = lf.fft(x, axis=2, **kw) if c2c else lf.rfft(x, axis=2, **kw)
            return lf.fft(c, axis=1, **kw)
        c = lf.ifft(x, axis=1, **kw)
        if c2c:
            return lf.ifft(c, axis=2, **kw)
        return lf.irfft(c, n=self.ny, axis=2, **kw)

    def _chunked(self, base: Pipeline) -> Pipeline:
        """``base`` over ``batch_chunk``-sized slices of the local batch,
        one after another (the JAX plan's ``lax.map``), each result copied
        into its place in one output."""
        ck = self.batch_chunk
        if not ck:
            return base

        def run(x: torch.Tensor) -> torch.Tensor:
            if x.shape[0] <= ck:
                return base(x)
            out = None
            for i in range(0, x.shape[0], ck):
                y = base(x[i:i + ck])
                if out is None:
                    out = y.new_empty((x.shape[0],) + tuple(y.shape[1:]))
                out[i:i + ck].copy_(y)
                del y
            return out

        return run

    def _build(self, forward: bool) -> Pipeline:
        if self.fft3d or self.shard == "batch":
            # Stage scope (obs/profile.py): the collective-free graph's
            # one local_fft node covers the whole per-plane 2D transform.
            return self._chunked(obs.profile.scoped(
                "batched2d", "local_fft:1",
                lambda x: self._fft2(x, forward)))
        first, xpose, last = self._slab_parts(forward)
        cfg = self.config
        if (cfg.send_method is pm.SendMethod.STREAMS
                and cfg.comm_method is pm.CommMethod.ALL2ALL):
            # K (exchange -> x or y FFT) chains on pieces of the batch.
            one = obs.profile.scoped("batched2d", "exchange:1",
                                     self._exchange(forward, pieces=1))
            k = cfg.resolved_streams_chunks()

            def body(v: torch.Tensor) -> torch.Tensor:
                return concat_axis_chunks(
                    [last(one(p)) for p in split_axis_chunks(first(v), 0, k)],
                    0)

            return body
        return lambda v: last(xpose(first(v)))

    def _slab_parts(self, forward: bool):
        """(first, xpose, last) of the shard='x' pipeline: the 1D FFT before
        the exchange (padding the split axis), the exchange of the Config's
        rendering, the 1D FFT after it (dropping the gathered axis's pad)."""
        kw, c2c = self._fft_kw(), self.transform == "c2c"
        nx, ny, nys = self.nx, self.ny, self._ny_spec
        nx_pad, nys_pad = self._nx_pad, self._nys_pad
        if forward:
            def first(xl: torch.Tensor) -> torch.Tensor:   # (B, nxb, ny)
                c = lf.fft(xl, axis=2, **kw) if c2c else \
                    lf.rfft(xl, axis=2, **kw)
                return pad_axis_to(c, 2, nys_pad)

            def last(c: torch.Tensor) -> torch.Tensor:     # (B, nx_pad, nysb)
                return lf.fft(slice_axis_to(c, 1, nx), axis=1, **kw)
        else:
            def first(cl: torch.Tensor) -> torch.Tensor:   # (B, nx, nysb)
                return pad_axis_to(lf.ifft(cl, axis=1, **kw), 1, nx_pad)

            def last(c: torch.Tensor) -> torch.Tensor:     # (B, nxb, nys_pad)
                c = slice_axis_to(c, 2, nys)
                if c2c:
                    return lf.ifft(c, axis=2, **kw)
                return lf.irfft(c, n=ny, axis=2, **kw)
        # Stage scopes (obs/profile.py): the shard='x' graph's nodes.
        sc = obs.profile.scoped
        return (sc("batched2d", "local_fft:1", first),
                sc("batched2d", "exchange:1", self._exchange(forward)),
                sc("batched2d", "local_fft:2", last))

    def _a2a_pipe_chunks(self) -> int:
        """Pieces of the pipelined all-to-all (ALL2ALL + SYNC / MPI_TYPE
        with ``overlap_subblocks`` > 1) along the batch axis, clamped to its
        extent; 1 wherever another rendering owns the exchange."""
        cfg = self.config
        if (self.fft3d or self.shard == "batch"
                or cfg.comm_method is not pm.CommMethod.ALL2ALL
                or cfg.send_method not in (pm.SendMethod.SYNC,
                                           pm.SendMethod.MPI_TYPE)):
            return 1
        return ring_subblocks(self._batch_pad,
                              cfg.resolved_overlap_subblocks())

    def _exchange(self, forward: bool, pieces: Optional[int] = None
                  ) -> Pipeline:
        """The exchange alone (forward: scatter spectral y, gather x;
        inverse: back), as the Config renders it: a ring (the fused wire's
        hooks when it is on), else ``exchange_body`` — STREAMS' pieced
        exchanges on the batch axis, the pipelined all-to-all, or the whole
        block at once. ``pieces`` = 1 asks for the monolithic exchange of
        the comm method (a STREAMS piece's own)."""
        cfg = self.config
        split, concat = (2, 1) if forward else (1, 2)
        group = self.group
        if cfg.send_method.is_ring:
            enc_fn, arr_fn = hf.fused_ring_hooks(cfg)
            ring_kw = dict(wire=cfg.wire_dtype,
                           overlap=cfg.send_method
                           is pm.SendMethod.RING_OVERLAP,
                           depth=cfg.resolved_overlap_depth(),
                           subblocks=cfg.resolved_overlap_subblocks())

            def ring(c: torch.Tensor) -> torch.Tensor:
                return ring_transpose(c, group, split, concat,
                                      encode_fn=enc_fn, arrive_fn=arr_fn,
                                      **ring_kw)

            return ring
        if pieces is None:
            pieces = (cfg.resolved_streams_chunks()
                      if cfg.send_method is pm.SendMethod.STREAMS else 1)
        return exchange_body(
            group, split, concat,
            all_to_all=cfg.comm_method is pm.CommMethod.ALL2ALL,
            realigned=cfg.opt == 1, wire=cfg.wire_dtype, chunk_axis=0,
            pipe_chunks=self._a2a_pipe_chunks() if pieces == 1 else 1,
            depth=cfg.resolved_overlap_depth(), pieces=pieces)

    # -- per-phase staged execution (the phase Timer's surface) ---------------

    @property
    def global_size(self) -> pm.GlobalSize:
        """(batch, nx, ny) in the three slots of the CSV names and the
        testcases: the halved spectral axis ny rides the last slot."""
        return pm.GlobalSize(self.batch, self.nx, self.ny)

    @property
    def variant_name(self) -> str:
        """Chunked runs get their own benchmark directory: the file name has
        no chunk slot."""
        base = f"batched2d_{self.shard}"
        return f"{base}_ck{self.batch_chunk}" if self.batch_chunk else base

    @property
    def section_descriptions(self) -> List[str]:
        """The JAX plan's phase vocabulary: one fused-2D marker without an
        exchange, the slab transpose markers for shard='x'."""
        if self.fft3d or self.shard == "batch":
            return ["init", _BATCH_STAGE, "Run complete",
                    "Run complete (fused)"]
        return (["init", "1D FFT Y-Direction"] + XPOSE_SECTIONS
                + ["1D FFT X-Direction", "Run complete",
                   "Run complete (fused)"])

    def _xpose_desc(self) -> str:
        return ("Transpose (Finished All2All)"
                if self.config.comm_method is pm.CommMethod.ALL2ALL
                else "Transpose (Finished Receive)")

    def forward_stages(self) -> List[Tuple[str, Pipeline]]:
        """``[(phase, fn)]`` whose composition is the forward transform of a
        local block: the whole transform under one marker without an
        exchange; else the y FFT, the exchange, the x FFT."""
        if self.fft3d or self.shard == "batch":
            return [(_BATCH_STAGE, self.exec_forward)]
        first, xpose, last = self._slab_parts(True)
        return [("1D FFT Y-Direction", first), (self._xpose_desc(), xpose),
                ("1D FFT X-Direction", last)]

    def inverse_stages(self) -> List[Tuple[str, Pipeline]]:
        """``forward_stages`` of the inverse transform."""
        if self.fft3d or self.shard == "batch":
            return [(_BATCH_STAGE, self.exec_inverse)]
        first, xpose, last = self._slab_parts(False)
        return [("1D FFT X-Direction", first), (self._xpose_desc(), xpose),
                ("1D FFT Y-Direction", last)]
