"""Pencil (2D) decomposition plan of the port — the JAX package's
``models/pencil.py`` over ``torch.distributed``.

The reference's pencil family (``src/pencil/mpicufft_pencil.cpp``)
decomposes the global ``Nx x Ny x Nz`` array over a ``P1 x P2`` grid of
ranks (rank = i * P2 + j, ``mpicufft_pencil.cpp:83-85``) and runs

    1D FFT z  ->  transpose 1 (row group: the P2 ranks with this i)
              ->  1D FFT y  ->  transpose 2 (column group: the P1 ranks
                                with this j)
              ->  1D FFT x

The two groups are the reference's two ``MPI_Comm_split`` communicators
(``mpicufft_pencil.cpp:112-123``), made by ``parallel.mesh.
make_pencil_groups``. The three distribution stages
(``Partition_Dimensions``, ``mpicufft_pencil.cpp:87-110``) are the
z-pencils (x over p1, y over p2), the y-pencils (x over p1, z over p2) and
the x-pencils (y over p1, z over p2). ``exec_r2c(x, dims=d)`` for d in
{1, 2, 3} stops after the first d axes, as the reference's
``execR2C(out, in, d)`` does (``mpicufft_pencil.cpp:1665-1668,
1710-1711``), and ``exec_c2r(c, dims=d)`` inverts it.

Each transpose is rendered on its own: transpose 1 by ``comm_method`` /
``send_method``, transpose 2 by ``resolved_comm2()`` / ``resolved_snd2()``
(the reference's ``-comm1/-snd1`` and ``-comm2/-snd2``). The renderings
are those of the slab plan (``parallel.transpose.exchange_body``): the
all-to-all (ALL2ALL + SYNC, opt 0 or 1), point to point (PEER2PEER +
SYNC; MPI_TYPE is SYNC's alias), the pipelined all-to-all (ALL2ALL with
``overlap_subblocks`` > 1), STREAMS (K exchanges on pieces of the axis the
transpose leaves alone, x at transpose 1 and z at transpose 2; under
ALL2ALL each piece's exchange is followed by its own next FFT, as in the
JAX package), and the ring (RING / RING_OVERLAP, whatever the comm method
says). Every FFT after a pencil transpose runs along the gathered axis, so
no ring block runs a per-block FFT: under ``fused_wire`` a ring's wire is
kernel 9's encode and kernel 10's unpack-only arrival. An exchange over a
one-rank group posts nothing.

Padded-shape contract (the JAX package's): x is padded to a multiple of
p1 and y to one of p2 on the way in; on the way out y is padded to a
multiple of p1, and the spectral z extent (``nz // 2 + 1``, or ``nz`` for
c2c) to one of p2 from depth 2 on. Local in, local out: ``exec_*`` take
and return this rank's block of the padded global array
(``local_input_shape``, ``local_output_shape_for(dims)``);
``pad_input`` / ``pad_spectral`` cut it from the logical global array and
``crop_real`` / ``crop_spectral`` gather the blocks over both groups and
return the logical global host array on every rank.

With one rank (``PencilPartition(1, 1)``) the plan runs per axis with
``dims`` on one device (the JAX package's ``_fft3d_r2c_d``): under
``"pallas"`` the row and column kernels 1, 2 and 3, not the fused 3D
kernels of the single-card slab plan.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import obs
from .. import params as pm
from ..ops import fft as lf
from ..ops import hopper_fft as hf
from ..parallel.mesh import make_pencil_groups
from ..parallel.transpose import (concat_axis_chunks, exchange_body,
                                  pad_axis_to, ring_subblocks,
                                  ring_transpose, slice_axis_to,
                                  split_axis_chunks)
from ..utils.native_planner import even_shard_sizes, padded_extent
from ..resilience import fallback, guards
from ..utils import wisdom
from .base import (DistFFTPlan, Pipeline, logical_block, resolve_device,
                   notice_axis_smoothness, to_plan, with_pad)

# (split, concat) of each transpose, forward and inverse: transpose 1
# scatters z and gathers y; transpose 2 scatters y and gathers x.
_AXES = {(1, False): (2, 1), (1, True): (1, 2),
         (2, False): (1, 0), (2, True): (0, 1)}
# The axis each transpose leaves alone (STREAMS' and the pipelined
# all-to-all's pieces): x at transpose 1, z at transpose 2.
_FREE = {1: 0, 2: 2}
# The axes split over (p1, p2) in each stage: the z-pencils of the input
# and of depth 1, the y-pencils of depth 2, the x-pencils of depth 3.
_SPLIT = {1: (0, 1), 2: (0, 2), 3: (1, 2)}


def _compose(steps: List[Pipeline]) -> Pipeline:
    def run(x: torch.Tensor) -> torch.Tensor:
        for f in steps:
            x = f(x)
        return x

    return run


class PencilFFTPlan(DistFFTPlan):
    """3D R2C/C2R (or C2C) FFT plan with 2D (pencil) decomposition over
    (x, y)."""

    def __init__(self, global_size: pm.GlobalSize,
                 partition: pm.PencilPartition,
                 config: Optional[pm.Config] = None, transform: str = "r2c",
                 device: "str | torch.device" = "cuda", groups=None,
                 dims: int = 3):
        if transform not in ("r2c", "c2c"):
            raise ValueError(f"transform must be 'r2c' or 'c2c', got {transform!r}")
        # "auto" Config fields are settled before anything reads the config
        # (see SlabFFTPlan), agreed over the row and column groups (every
        # rank creates all of them first). ``dims`` is a resolution hint
        # only: the depth the run will execute keys the wisdom entry and
        # bounds the comm race (at dims 2 only transpose 1 exists).
        if (wisdom.unresolved(config or pm.Config()) and groups is None
                and partition.num_ranks > 1):
            groups = make_pencil_groups(partition.p1, partition.p2)
        config = wisdom.resolve_config(
            "pencil", global_size, partition, config, transform=transform,
            dims=dims, device=resolve_device(device), groups=groups)
        self._wisdom_dims = int(dims)
        super().__init__(global_size, partition, config, device)
        self.transform = transform
        self.p1, self.p2 = partition.p1, partition.p2
        g = global_size
        self._nz_spec = g.nz if transform == "c2c" else g.nz_out
        self.coords = (0, 0)
        self.row_group = self.col_group = None
        if self.fft3d:
            self._nx_p1, self._ny_p2, self._ny_p1 = g.nx, g.ny, g.ny
            self._nzc_p2 = self._nz_spec
        else:
            if groups is None:
                groups = make_pencil_groups(self.p1, self.p2)
            row, col = groups
            if (dist.get_world_size(row), dist.get_world_size(col)) != \
                    (self.p2, self.p1):
                raise ValueError(
                    f"the row and column groups have "
                    f"{dist.get_world_size(row)} and "
                    f"{dist.get_world_size(col)} ranks but the partition "
                    f"asks for {self.p2} and {self.p1}")
            self.row_group, self.col_group = row, col
            self.coords = (dist.get_rank(col), dist.get_rank(row))
            self._nx_p1 = padded_extent(g.nx, self.p1)
            self._ny_p2 = padded_extent(g.ny, self.p2)
            self._ny_p1 = padded_extent(g.ny, self.p1)
            self._nzc_p2 = padded_extent(self._nz_spec, self.p2)
        self._fwd_d: Dict[int, Pipeline] = {}
        self._inv_d: Dict[int, Pipeline] = {}
        notice_axis_smoothness("pencil", g.shape, self.config)
        obs.event("plan.created", kind="pencil", transform=transform,
                  shape=list(g.shape), grid=[self.p1, self.p2],
                  comm=self.config.comm_method.value,
                  comm2=self.config.resolved_comm2().value,
                  send=self.config.send_method.value,
                  send2=self.config.resolved_snd2().value,
                  opt=self.config.opt, wire=self.config.wire_dtype,
                  backend=self.config.fft_backend)

    def _wisdom_key_args(self) -> dict:
        return {"kind": "pencil", "transform": self.transform,
                "dims": self._wisdom_dims}

    @property
    def groups(self) -> Tuple:
        """The plan's groups, (row, column); none on one rank."""
        return () if self.fft3d else (self.row_group, self.col_group)

    # -- shapes -------------------------------------------------------------

    @property
    def input_padded_shape(self) -> Tuple[int, int, int]:
        return (self._nx_p1, self._ny_p2, self.global_size.nz)

    @property
    def output_shape(self) -> Tuple[int, int, int]:
        g = self.global_size
        return (g.nx, g.ny, self._nz_spec)

    def output_padded_shape_for(self, dims: int = 3) -> Tuple[int, int, int]:
        g = self.global_size
        _check_dims(dims)
        if self.fft3d:
            return self.output_shape
        if dims == 1:
            return (self._nx_p1, self._ny_p2, self._nz_spec)
        if dims == 2:
            return (self._nx_p1, g.ny, self._nzc_p2)
        return (g.nx, self._ny_p1, self._nzc_p2)

    @property
    def output_padded_shape(self) -> Tuple[int, int, int]:
        return self.output_padded_shape_for(3)

    def _local(self, padded, stage: int) -> Tuple[int, int, int]:
        s = list(padded)
        a1, a2 = _SPLIT[stage]
        s[a1] //= self.p1
        s[a2] //= self.p2
        return tuple(s)

    @property
    def local_input_shape(self) -> Tuple[int, int, int]:
        """This rank's z-pencil of the padded input."""
        return self._local(self.input_padded_shape, 1)

    def local_output_shape_for(self, dims: int = 3) -> Tuple[int, int, int]:
        """This rank's block of the padded output at depth ``dims``: a
        z-, y- or x-pencil."""
        return self._local(self.output_padded_shape_for(dims), dims)

    @property
    def local_output_shape(self) -> Tuple[int, int, int]:
        return self.local_output_shape_for(3)

    def local_slices(self, output: bool = False,
                     dims: int = 3) -> Tuple[slice, ...]:
        """Where this rank's block lies in the padded global input (or the
        output at depth ``dims``)."""
        stage = dims if output else 1
        b = self.local_output_shape_for(dims) if output else \
            self.local_input_shape
        sl = [slice(None)] * 3
        for a, c in zip(_SPLIT[stage], self.coords):
            sl[a] = slice(c * b[a], (c + 1) * b[a])
        return tuple(sl)

    # -- per-rank size tables (reference Partition_Dimensions) --------------

    def partition_dims(self, stage: str) -> pm.PartitionDims:
        """Logical sizes per rank along each axis for the 'input' /
        'transposed' / 'output' stages (``mpicufft_pencil.cpp:87-110``);
        pad-only shards report 0."""
        g = self.global_size
        xs = tuple(even_shard_sizes(g.nx, self._nx_p1, self.p1))
        zs = tuple(even_shard_sizes(self._nz_spec, self._nzc_p2, self.p2))
        if stage == "input":
            return pm.PartitionDims(
                xs, tuple(even_shard_sizes(g.ny, self._ny_p2, self.p2)),
                (g.nz,))
        if stage == "transposed":
            return pm.PartitionDims(xs, (g.ny,), zs)
        if stage == "output":
            return pm.PartitionDims(
                (g.nx,), tuple(even_shard_sizes(g.ny, self._ny_p1, self.p1)),
                zs)
        raise ValueError(f"unknown stage {stage!r}")

    def in_sizes(self, axis: str = "x") -> List[int]:
        """Per-rank logical input extents along x (p1) or y (p2)."""
        d = self.partition_dims("input")
        if axis == "x":
            return list(d.size_x)
        if axis == "y":
            return list(d.size_y)
        raise ValueError("pencil input is decomposed over x and y only, "
                         f"not {axis!r}")

    def out_sizes(self, axis: str) -> List[int]:
        """Per-rank logical output extents (depth 3) along y (p1) or z
        (p2)."""
        d = self.partition_dims("output")
        if axis == "y":
            return list(d.size_y)
        if axis == "z":
            return list(d.size_z)
        raise ValueError("pencil output is decomposed over y and z only, "
                         f"not {axis!r}")

    # -- logical <-> padded conversion helpers ------------------------------

    def pad_input(self, x) -> torch.Tensor:
        """Logical (or padded) global input -> this rank's padded z-pencil
        on the plan's device (real, or complex for c2c plans)."""
        dtype = self.complex_dtype if self.transform == "c2c" else \
            self.real_dtype
        return self._block(x, dtype, 1, self.input_shape,
                           self.input_padded_shape)

    def pad_spectral(self, c, dims: int = 3) -> torch.Tensor:
        """Logical (or padded) global spectrum at depth ``dims`` -> this
        rank's padded output block on the plan's device."""
        return self._block(c, self.complex_dtype, dims, self.output_shape,
                           self.output_padded_shape_for(dims))

    def crop_real(self, r) -> np.ndarray:
        """Inverse output blocks -> logical (nx, ny, nz) host array
        (collective: every rank calls it)."""
        g = self.global_size
        return self._host(self._gather(r, 1))[: g.nx, : g.ny]

    def crop_spectral(self, c, dims: int = 3) -> np.ndarray:
        """Forward output blocks at depth ``dims`` -> logical spectral host
        array (collective: every rank calls it)."""
        g = self.global_size
        _check_dims(dims)
        return self._host(self._gather(c, dims))[: g.nx, : g.ny,
                                                 : self._nz_spec]

    def _block(self, a, dtype: torch.dtype, stage: int, logical,
               padded) -> torch.Tensor:
        t = torch.as_tensor(a)
        if tuple(t.shape) == tuple(logical):
            for ax in range(3):
                t = pad_axis_to(t, ax, padded[ax])
        elif tuple(t.shape) != tuple(padded):
            raise ValueError(f"expected the global shape {tuple(logical)} (or "
                             f"padded {tuple(padded)}), got {tuple(t.shape)}")
        b = self._local(padded, stage)
        for ax, c in zip(_SPLIT[stage], self.coords):
            t = t.narrow(ax, c * b[ax], b[ax])
        return t.to(device=self.device, dtype=dtype).contiguous()

    def _gather(self, t, stage: int):
        """The padded global array from every rank's block: over the row
        group along the p2 axis, then over the column group along the p1
        axis (all ranks must call it); the block itself on one rank."""
        if self.fft3d:
            return t
        t = torch.as_tensor(t, device=self.device).contiguous()
        a1, a2 = _SPLIT[stage]
        t = _all_gather(t, self.row_group, a2)
        return _all_gather(t, self.col_group, a1)

    @staticmethod
    def _host(t) -> np.ndarray:
        return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)

    # -- execution ------------------------------------------------------------

    def exec_r2c(self, x, dims: int = 3) -> torch.Tensor:
        """Forward transform of the first ``dims`` axes (z, then y, then
        x), the reference's partial-dimension ``execR2C(out, in, d)``."""
        self._require("r2c")
        return self._exec_fwd(x, dims, self.real_dtype)

    def exec_c2r(self, c, dims: int = 3) -> torch.Tensor:
        """Inverse of ``exec_r2c(..., dims)``."""
        self._require("r2c")
        return self._exec_inv(c, dims)

    def exec_c2c(self, x, dims: int = 3) -> torch.Tensor:
        """Forward 3D (or partial) C2C transform (transform='c2c' plans)."""
        self._require("c2c")
        return self._exec_fwd(x, dims, self.complex_dtype)

    def exec_c2c_inv(self, c, dims: int = 3) -> torch.Tensor:
        """Inverse of ``exec_c2c``."""
        self._require("c2c")
        return self._exec_inv(c, dims)

    def _require(self, transform: str) -> None:
        if self.transform != transform:
            use = ("exec_r2c/exec_c2r" if self.transform == "r2c"
                   else "exec_c2c/exec_c2c_inv")
            raise TypeError(f"this plan was built with "
                            f"transform={self.transform!r}; use {use}")

    def _exec_fwd(self, x, dims: int, dtype: torch.dtype) -> torch.Tensor:
        _check_dims(dims)
        shape = tuple(x.shape)
        if self.fft3d:
            ok, want = shape == self.input_shape, \
                f"global shape {self.input_shape}"
        else:
            ok = shape == self.local_input_shape
            want = f"this rank's input block {self.local_input_shape}"
        if not ok:
            raise ValueError(f"forward exec expects {want}, got {shape}")
        return fallback.execute(
            self, "forward", torch.as_tensor(x, dtype=dtype,
                                             device=self.device),
            lambda: self._get(True, dims), dims)

    def _exec_inv(self, c, dims: int) -> torch.Tensor:
        _check_dims(dims)
        shape = tuple(c.shape)
        if self.fft3d:
            ok, want = shape == self.output_shape, \
                f"global shape {self.output_shape}"
        else:
            want_shape = self.local_output_shape_for(dims)
            ok = shape == want_shape
            want = f"this rank's depth-{dims} output block {want_shape}"
        if not ok:
            raise ValueError(f"inverse exec(dims={dims}) expects {want}, "
                             f"got {shape}")
        return fallback.execute(
            self, "inverse", torch.as_tensor(c, dtype=self.complex_dtype,
                                             device=self.device),
            lambda: self._get(False, dims), dims)

    def forward_fn(self, dims: int = 3) -> Pipeline:
        """The forward pipeline at depth ``dims`` with no resilience
        envelope and no guard (the JAX plan's ``forward_fn``),
        differentiable, built once per depth. It takes what ``exec_r2c``
        (``exec_c2c``) takes: on one rank the global array, on P ranks this
        rank's padded z-pencil, or its logical part, zero-padded by a
        differentiable pad; any other shape raises. Under
        ``torch.no_grad()`` its output is ``exec_fwd``'s bit for bit."""
        return self._pure_fn(True, dims)

    def inverse_fn(self, dims: int = 3) -> Pipeline:
        """The inverse pipeline at depth ``dims`` (see ``forward_fn``)."""
        return self._pure_fn(False, dims)

    def _pure_fn(self, forward: bool, dims: int) -> Pipeline:
        _check_dims(dims)
        key = (forward, dims)
        if key not in self._pure:
            if forward:
                logical, padded = self.input_shape, self.local_input_shape
                sl = self.local_slices()
                dtype = (self.complex_dtype if self.transform == "c2c"
                         else self.real_dtype)
                pure = self._build_fwd(dims)
            else:
                logical = self.output_shape
                padded = self.local_output_shape_for(dims)
                sl = self.local_slices(output=True, dims=dims)
                dtype, pure = self.complex_dtype, self._build_inv(dims)
            if not self.fft3d:
                logical = logical_block(padded, logical, sl)
            self._pure[key] = with_pad(pure, logical, padded,
                                       to_plan(self.device, dtype))
        return self._pure[key]

    def _get(self, forward: bool, dims: int) -> Pipeline:
        """The (possibly guarded) pipeline of one direction at depth
        ``dims``, built once per config."""
        cache = self._fwd_d if forward else self._inv_d
        if dims not in cache:
            direction = "forward" if forward else "inverse"
            with obs.span("plan.build", kind="pencil", direction=direction,
                          dims=dims):
                pure = (self._build_fwd(dims) if forward
                        else self._build_inv(dims))
                cache[dims], _ = guards.maybe_wrap(self, pure, direction,
                                                   dims)
        return cache[dims]

    # -- resilience hooks (guards + fallback ladder) ------------------------

    def _transformed_volume(self, dims: int) -> float:
        """Product of the extents the first ``dims`` axes (z, y, x) cover."""
        g = self.global_size
        return float({1: g.nz, 2: g.ny * g.nz, 3: g.n_total}[dims])

    def _guard_spec(self, direction: str, dims: int = 3) -> guards.GuardSpec:
        """GuardSpec per direction AND depth (the JAX plan's: the
        partial-depth transforms conserve energy over exactly the
        transformed axes)."""
        g = self.global_size
        return guards.transform_spec(
            direction, self.config.norm, self._transformed_volume(dims),
            self.transform == "c2c", self.input_shape,
            (g.nx, g.ny, self._nz_spec), 2, g.nz)

    # -- pipelines ------------------------------------------------------------

    def _fft_kw(self) -> dict:
        cfg = self.config
        return dict(norm=cfg.norm, backend=cfg.fft_backend,
                    settings=self._mxu_st)

    def _fwd_ffts(self, dims: int) -> List[Pipeline]:
        """[s1, s2, s3][:dims]: the z-R2C (or C2C), y and x stages of the
        forward, each with the slicing and padding around it."""
        g, kw = self.global_size, self._fft_kw()
        nzc_p2, ny_p1 = self._nzc_p2, self._ny_p1
        first = lf.fft if self.transform == "c2c" else lf.rfft

        def s1(xl: torch.Tensor) -> torch.Tensor:
            c = first(xl, axis=2, **kw)
            return pad_axis_to(c, 2, nzc_p2) if dims >= 2 else c

        def s2(cl: torch.Tensor) -> torch.Tensor:
            c = lf.fft(slice_axis_to(cl, 1, g.ny), axis=1, **kw)
            return pad_axis_to(c, 1, ny_p1) if dims >= 3 else c

        def s3(cl: torch.Tensor) -> torch.Tensor:
            return lf.fft(slice_axis_to(cl, 0, g.nx), axis=0, **kw)

        return [s1, s2, s3][:dims]

    def _inv_ffts(self) -> Dict[int, Pipeline]:
        """{3: i3, 2: i2, 1: i1}: the inverse stages of x, y and z."""
        g, kw = self.global_size, self._fft_kw()
        nx_p1, ny_p2, nzc = self._nx_p1, self._ny_p2, self._nz_spec
        c2c = self.transform == "c2c"

        def i3(cl: torch.Tensor) -> torch.Tensor:
            return pad_axis_to(lf.ifft(cl, axis=0, **kw), 0, nx_p1)

        def i2(cl: torch.Tensor) -> torch.Tensor:
            c = lf.ifft(slice_axis_to(cl, 1, g.ny), axis=1, **kw)
            return pad_axis_to(c, 1, ny_p2)

        def i1(cl: torch.Tensor) -> torch.Tensor:
            # Drop the z pad lanes; on "pallas" the C2R reads the view's
            # rows into one contiguous copy.
            c = slice_axis_to(cl, 2, nzc)
            if c2c:
                return lf.ifft(c, axis=2, **kw)
            return lf.irfft(c, n=g.nz, axis=2, **kw)

        return {3: i3, 2: i2, 1: i1}

    def _rendering(self, which: int) -> Tuple[pm.CommMethod, pm.SendMethod]:
        cfg = self.config
        if which == 1:
            return cfg.comm_method, cfg.send_method
        return cfg.resolved_comm2(), cfg.resolved_snd2()

    def _xpose(self, which: int, inverse: bool,
               pieces: Optional[int] = None) -> Pipeline:
        """The exchange body of transpose ``which`` (1 over the row group,
        2 over the column group) in one direction, rendered by its own
        comm and send methods; ``pieces`` overrides STREAMS' piece count."""
        cfg = self.config
        comm, snd = self._rendering(which)
        group = self.row_group if which == 1 else self.col_group
        split, concat = _AXES[which, inverse]
        if snd.is_ring:
            enc_fn, arr_fn = hf.fused_ring_hooks(cfg, snd)
            ring_kw = dict(wire=cfg.wire_dtype,
                           overlap=snd is pm.SendMethod.RING_OVERLAP,
                           depth=cfg.resolved_overlap_depth(),
                           subblocks=cfg.resolved_overlap_subblocks(),
                           encode_fn=enc_fn, arrive_fn=arr_fn)
            return lambda c: ring_transpose(c, group, split, concat,
                                            **ring_kw)
        if pieces is None:
            pieces = (cfg.resolved_streams_chunks()
                      if snd is pm.SendMethod.STREAMS else 1)
        return exchange_body(
            group, split, concat,
            all_to_all=comm is pm.CommMethod.ALL2ALL,
            realigned=cfg.opt == 1, wire=cfg.wire_dtype,
            chunk_axis=_FREE[which],
            pipe_chunks=cfg.resolved_overlap_subblocks(),
            depth=cfg.resolved_overlap_depth(), pieces=pieces)

    def _scope_ids(self, direction: str, dims: int) -> Dict[str, str]:
        """Plan-graph node ids per pipeline part (the JAX plan's stage
        scopes, ``obs/profile.py``): local-FFT stages count in pipeline
        order, exchanges only when their group has more than one rank."""
        ids: Dict[str, str] = {}
        n = {"lf": 0, "x": 0}

        def nlf(part: str) -> None:
            n["lf"] += 1
            ids[part] = f"local_fft:{n['lf']}"

        def nx_(part: str, p: int) -> None:
            if p > 1:
                n["x"] += 1
                ids[part] = f"exchange:{n['x']}"

        if direction == "forward":
            nlf("s1")
            if dims >= 2:
                nx_("t1", self.p2)
                nlf("s2")
            if dims >= 3:
                nx_("t2", self.p1)
                nlf("s3")
        else:
            if dims >= 3:
                nlf("i3")
                nx_("t2b", self.p1)
            if dims >= 2:
                nlf("i2")
                nx_("t1b", self.p2)
            nlf("i1")
        return ids

    def _chain(self, which: int, inverse: bool, nxt: Pipeline,
               scope: str = "") -> Pipeline:
        """Transpose ``which`` followed by the FFT stage ``nxt``. Under
        ALL2ALL + STREAMS: K independent (exchange -> ``nxt``) chains on
        pieces of the free axis, reassembled (the JAX package's ``_attach``);
        ``nxt`` never runs along that axis, so the result is SYNC's."""
        comm, snd = self._rendering(which)
        sc = obs.profile.scoped
        if snd is pm.SendMethod.STREAMS and comm is pm.CommMethod.ALL2ALL:
            one = sc("pencil", scope, self._xpose(which, inverse, pieces=1))
            ca, k = _FREE[which], self.config.resolved_streams_chunks()
            return lambda c: concat_axis_chunks(
                [nxt(one(p)) for p in split_axis_chunks(c, ca, k)], ca)
        xpose = sc("pencil", scope, self._xpose(which, inverse))
        return lambda c: nxt(xpose(c))

    def _build_fwd(self, dims: int) -> Pipeline:
        if self.fft3d:
            return self._fft3d_fwd(dims)
        ids = self._scope_ids("forward", dims)
        s = [obs.profile.scoped("pencil", ids[f"s{w + 1}"], f)
             for w, f in enumerate(self._fwd_ffts(dims))]
        return _compose([s[0]] + [self._chain(w, False, s[w],
                                              ids.get(f"t{w}", ""))
                                  for w in range(1, dims)])

    def _build_inv(self, dims: int) -> Pipeline:
        if self.fft3d:
            return self._fft3d_inv(dims)
        ids = self._scope_ids("inverse", dims)
        i = {w: obs.profile.scoped("pencil", ids[f"i{w}"], f)
             for w, f in self._inv_ffts().items() if f"i{w}" in ids}
        return _compose([i[dims]] + [self._chain(w, True, i[w],
                                                 ids.get(f"t{w}b", ""))
                                     for w in range(dims - 1, 0, -1)])

    # -- the single-rank path: per axis, with depth ---------------------------

    def _fft3d_fwd(self, dims: int) -> Pipeline:
        kw = self._fft_kw()
        first = lf.fft if self.transform == "c2c" else lf.rfft

        def run(x: torch.Tensor) -> torch.Tensor:
            c = first(x, axis=2, **kw)
            for a in (1, 0)[:dims - 1]:
                c = lf.fft(c, axis=a, **kw)
            return c

        return obs.profile.scoped("pencil", "local_fft:1", run)

    def _fft3d_inv(self, dims: int) -> Pipeline:
        kw, nz = self._fft_kw(), self.global_size.nz
        c2c = self.transform == "c2c"

        def run(c: torch.Tensor) -> torch.Tensor:
            for a in (0, 1)[3 - dims:]:
                c = lf.ifft(c, axis=a, **kw)
            if c2c:
                return lf.ifft(c, axis=2, **kw)
            return lf.irfft(c, n=nz, axis=2, **kw)

        return obs.profile.scoped("pencil", "local_fft:1", run)

    # -- per-phase staged execution (the phase Timer's surface) -------------

    variant_name = "pencil"

    @property
    def section_descriptions(self) -> List[str]:
        """The reference's pencil phase vocabulary
        (``include/mpicufft_pencil.hpp:263-287``; only the first transpose
        has a "(Send Complete)" marker), plus "Run complete (fused)": the
        mark after one more call of ``exec_*``. Phases the port does not
        time stay 0 in the CSV."""
        def tr(prefix: str, send_complete: bool) -> List[str]:
            xs = ["First Send", "Packing", "Start Local Transpose",
                  "Start Receive", "First Receive", "Finished Receive",
                  "Start All2All", "Finished All2All", "Unpacking"]
            if send_complete:
                xs.append("Send Complete")
            return [f"{prefix} Transpose ({x})" for x in xs]

        return (["init", "1D FFT Z-Direction"] + tr("First", True)
                + ["1D FFT Y-Direction"] + tr("Second", False)
                + ["1D FFT X-Direction", "Run complete",
                   "Run complete (fused)"])

    def _xpose_desc(self, which: int) -> str:
        comm = self._rendering(which)[0]
        prefix = "First" if which == 1 else "Second"
        kind = ("Finished All2All" if comm is pm.CommMethod.ALL2ALL
                else "Finished Receive")
        return f"{prefix} Transpose ({kind})"

    def _whole(self, forward: bool, dims: int = 3) -> Pipeline:
        if self.transform == "c2c":
            fn = self.exec_c2c if forward else self.exec_c2c_inv
        else:
            fn = self.exec_r2c if forward else self.exec_c2r
        return lambda t: fn(t, dims)

    def forward_stages(self, dims: int = 3
                       ) -> List[Tuple[Optional[str], Pipeline]]:
        """``[(phase, fn)]`` whose composition is the forward transform of
        a local block at depth ``dims``: each FFT stage and each exchange
        in its own rendering. One rank: the whole transform, untimed by
        phase."""
        _check_dims(dims)
        if self.fft3d:
            return [(None, self._whole(True, dims))]
        s = self._fwd_ffts(dims)
        out = [("1D FFT Z-Direction", s[0])]
        for w, desc in ((1, "1D FFT Y-Direction"), (2, "1D FFT X-Direction")):
            if dims > w:
                out += [(self._xpose_desc(w), self._xpose(w, False)),
                        (desc, s[w])]
        return out

    def inverse_stages(self, dims: int = 3
                       ) -> List[Tuple[Optional[str], Pipeline]]:
        """``forward_stages`` of the inverse transform."""
        _check_dims(dims)
        if self.fft3d:
            return [(None, self._whole(False, dims))]
        i = self._inv_ffts()
        out = []
        for w, desc in ((2, "1D FFT X-Direction"), (1, "1D FFT Y-Direction")):
            if dims > w:
                out += [(desc, i[w + 1]),
                        (self._xpose_desc(w), self._xpose(w, True))]
        return out + [("1D FFT Z-Direction", i[1])]


def _check_dims(dims: int) -> None:
    if dims not in (1, 2, 3):
        raise ValueError(f"dims must be 1, 2 or 3, got {dims}")


def _all_gather(t: torch.Tensor, group, axis: int) -> torch.Tensor:
    """Every group rank's block of ``t`` concatenated along ``axis`` in
    group-rank order; ``t`` itself on a one-rank group."""
    p = dist.get_world_size(group)
    if p == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(p)]
    if t.is_complex():
        dist.all_gather([torch.view_as_real(q) for q in parts],
                        torch.view_as_real(t), group=group)
    else:
        dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=axis)


# ---------------------------------------------------------------------------
# contract and stage-graph declarations (analysis/contracts.py,
# analysis/plangraph.py) — the exchanges this family stages at each
# partial-transform depth, next to the code that stages them.
# ---------------------------------------------------------------------------

def _stage_spec(plan, stage: int) -> str:
    """How stage ``stage``'s pencils lie over (p1, p2) (``_SPLIT``)."""
    if plan.fft3d:
        return ""
    from ..analysis import plangraph as _pg
    a1, a2 = _SPLIT[stage]
    return _pg.split_spec((a1, "p1"), (a2, "p2"))


def _pieces(cfg, snd, rendering: str, sub: int, free_ext: int) -> int:
    """The resolved piece count of one transpose: STREAMS' pieces (under
    PEER2PEER too: the port posts each piece's messages) and the
    pipelined all-to-all's, both clamped to the free axis's extent."""
    if rendering == "streams" or (rendering == "p2p"
                                  and snd is pm.SendMethod.STREAMS):
        return min(cfg.resolved_streams_chunks(), free_ext)
    if rendering == "a2a_pipe":
        return ring_subblocks(free_ext, sub)
    return 1


def _contract_exchanges(plan, direction, dims=3):
    """Pencil: transpose 1 over p2 (scatter z, gather y; free axis x) from
    dims >= 2, transpose 2 over p1 (scatter y, gather x; free axis z) from
    dims >= 3, each only when its group has more than one rank. Payloads
    are the padded spectral volumes both transposes move. Only the ring
    sub-block split depends on ``direction`` (the concat axis flips)."""
    if plan.fft3d:
        return ()
    from ..analysis import contracts as _c
    cfg = plan.config
    fwd = direction == "forward"
    sub = cfg.resolved_overlap_subblocks()
    out = []
    if dims >= 2 and plan.p2 > 1:
        r1 = _c.rendering_name(cfg)
        k1 = _pieces(cfg, cfg.send_method, r1, sub, plan._nx_p1 // plan.p1)
        s1 = 1
        if r1 in ("ring", "ring_overlap"):
            ext = (plan._ny_p2 // plan.p2 if fwd
                   else plan._nzc_p2 // plan.p2)
            s1 = ring_subblocks(ext, sub)
        out.append(_c.ExchangeDecl(
            "transpose 1", (plan._nx_p1, plan._ny_p2, plan._nzc_p2),
            plan.p2, r1, k1, subblocks=s1))
    if dims >= 3 and plan.p1 > 1:
        r2 = _c.rendering_name(cfg, second=True)
        k2 = _pieces(cfg, cfg.resolved_snd2(), r2, sub,
                     plan._nzc_p2 // plan.p2)
        s2 = 1
        if r2 in ("ring", "ring_overlap"):
            ext = (plan._nx_p1 // plan.p1 if fwd
                   else plan._ny_p1 // plan.p1)
            s2 = ring_subblocks(ext, sub)
        out.append(_c.ExchangeDecl(
            "transpose 2", (plan._nx_p1, plan._ny_p1, plan._nzc_p2),
            plan.p1, r2, k2, subblocks=s2))
    return tuple(out)


def _declare_graph(plan, direction, dims=3):
    """Pencil stage graph: z FFT -> transpose 1 (p2 group, from dims >= 2
    when p2 > 1) -> y FFT -> transpose 2 (p1 group, from dims >= 3 when
    p1 > 1) -> x FFT, mirrored for the inverse; encode/decode around each
    compressed exchange (the fused wire's unpack-only arrival: every
    post-transpose FFT runs along the gathered axis); guard at modes
    check/enforce."""
    from ..analysis import plangraph as _pg
    cfg = plan.config
    cdt, rdt = _pg.payload_dtypes(cfg, plan.transform)
    fwd = direction == "forward"
    b = _pg.GraphBuilder("pencil", direction, wire=cfg.wire_dtype,
                         guards=plan._guard_mode, complex_dtype=cdt)
    decls = {d.label: d for d in _contract_exchanges(plan, direction, dims)}

    def add_exchange(label, spec_after, second=False):
        d = decls.get(label)
        if d is None:
            return
        fused = cfg.fused_wire_active(second)
        b.exchange(d.label, d.payload_shape, d.axis_size, d.rendering,
                   chunks=d.chunks, subblocks=d.subblocks,
                   schedule_depth=_pg.shipped_schedule_depth(d.rendering,
                                                             cfg),
                   decoded_spec=spec_after, fused_encode=fused,
                   decode_fuses=("decode",) if fused else None)

    out_spec = _stage_spec(plan, dims)
    if fwd:
        b.node("input")
        b.payload(plan.input_padded_shape, rdt, _stage_spec(plan, 1))
        if plan.fft3d:
            b.node("local_fft", axes=tuple((2, 1, 0)[:dims]),
                   label="fft3d")
        else:
            b.node("local_fft", axes=(2,), label="z stage")
            if dims >= 2:
                add_exchange("transpose 1", _stage_spec(plan, 2))
                b.node("local_fft", axes=(1,), label="y stage")
            if dims >= 3:
                add_exchange("transpose 2", _stage_spec(plan, 3),
                             second=True)
                b.node("local_fft", axes=(0,), label="x stage")
        b.payload(plan.output_padded_shape_for(dims), cdt, out_spec)
    else:
        b.node("input")
        b.payload(plan.output_padded_shape_for(dims), cdt, out_spec)
        if plan.fft3d:
            b.node("local_fft", axes=tuple(reversed((2, 1, 0)[:dims])),
                   label="fft3d")
        else:
            if dims >= 3:
                b.node("local_fft", axes=(0,), label="x stage")
                add_exchange("transpose 2", _stage_spec(plan, 2),
                             second=True)
            if dims >= 2:
                b.node("local_fft", axes=(1,), label="y stage")
                add_exchange("transpose 1", _stage_spec(plan, 1))
            b.node("local_fft", axes=(2,), label="z stage")
        b.payload(plan.input_padded_shape, rdt, _stage_spec(plan, 1))
    if plan._guard_mode != "off":
        b.node("guard")
    b.node("output")
    return b.graph()


def _register_contracts():
    from ..analysis import contracts as _c
    from ..analysis import plangraph as _pg
    _c.register_family("pencil", "PencilFFTPlan", _contract_exchanges)
    _pg.register_graph_family("pencil", _declare_graph)


_register_contracts()
