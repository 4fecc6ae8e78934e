"""Slab (1D) decomposition plan of the port.

Three per-axis sequences over ``torch.distributed`` (the JAX package's
``_SEQS``): ``ZY_Then_X``, the reference's default
(``src/slab/default/mpicufft_slab.cpp``), ``Z_Then_YX`` and ``Y_Then_ZX``.
Each rank's x-slab runs the transforms before the exchange (the R2C axis,
then the pre axes), pads the split axis to a multiple of P, and one
exchange scatters the split axis and gathers x; then the post axes run.
The inverse runs the same steps backwards.

The exchange is rendered as one all-to-all (ALL2ALL + SYNC, at opt 0 or
the realigned opt 1, which the port packs alike), as a send and a receive
to every peer posted at once (PEER2PEER + SYNC; the same result bit for
bit; MPI_TYPE is SYNC's alias), as the pipelined all-to-all (ALL2ALL +
SYNC with ``overlap_subblocks`` > 1: pieces of the free axis, each issued
ahead of the ones before it are landed), as STREAMS (K exchanges on pieces
of the free axis; under ALL2ALL each piece runs its post-exchange FFTs
before the next piece's exchange, as the JAX package's STREAMS engine
does) or as a ring of point-to-point steps (``SendMethod.RING`` /
``RING_OVERLAP``; the ring owns the exchange whatever ``comm_method``
says, as in the JAX package). On a ring, the post-exchange transforms that
do not run along the gathered axis run on each peer block as it arrives.
Every rendering takes ``wire_dtype="bf16"``; on a ring ``fused_wire``
swaps the wire boundary for the kernels of ``ops/hopper_fft.py`` (encode;
decode, or decode fused with the first per-block DFT). The renderings of
one plan give the same result bit for bit where they run the same FFTs on
the same blocks; a ring's pipelined c2c inverse and STREAMS under ALL2ALL
run them in another order or on narrower blocks, and agree within
rounding, as in the JAX package.

The staged surface (``forward_stages`` / ``inverse_stages``,
``section_descriptions``, ``variant_name``) splits each direction into the
reference's timed phases for the phase ``Timer`` (``utils/timer.py``) of
the testcases.

With one rank (``SlabPartition(1)``) the plan takes the single-device path
instead: one local 3D transform per direction. Under
``Config(fft_backend="pallas")`` the transforms run the hand-written
kernels of ``ops/hopper_fft.py``; under the default ``"xla"`` they run
``torch.fft``.

Padded-shape contract (the JAX package's ``models/slab.py``): every
*decomposed* axis of the global array is zero-padded up to the next
multiple of P; undecomposed axes, including an odd ``nz//2+1``, are never
padded.

* plan input : real, ``input_padded_shape`` (x padded), split over x;
* plan output: complex, ``output_padded_shape`` (the split axis padded),
  split over the split axis (y, or z for ``Z_Then_YX``); pad lanes are
  exact zeros in the forward output and are ignored by the inverse.

Local in, local out: on P > 1 ranks ``exec_*`` take and return this rank's
block of the padded global array (``local_input_shape`` /
``local_output_shape``), the block each reference MPI rank holds.
``pad_input`` / ``pad_spectral`` turn the logical global array into this
rank's block on the plan's device; ``crop_spectral`` / ``crop_real``
gather the blocks over the group and return the logical global host array
on every rank, as ``np.asarray`` of a sharded array does in JAX.
"""

from __future__ import annotations

import dataclasses
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
                                  slice_axis_to, split_axis_chunks,
                                  wire_complex_dtype)
from ..utils.native_planner import even_shard_sizes, padded_extent
from ..resilience.guards import GuardSpec, transform_spec
from ..utils import wisdom
from .base import (AxisBlocks, DistFFTPlan, Pipeline, notice_axis_smoothness,
                   resolve_device)

_ODDITY_ITEM = "ROADMAP Queue 3 (the reference's P=1 Y_Then_ZX oddity)"


@dataclasses.dataclass(frozen=True)
class _SeqDef:
    """Axis roles of one slab sequence."""

    r2c_axis: int                 # axis of the real-to-complex transform
    pre_axes: Tuple[int, ...]     # C2C axes before the exchange
    split_axis: int               # axis scattered by the exchange
    post_axes: Tuple[int, ...]    # C2C axes after the exchange


_SEQS = {
    pm.SlabSequence.ZY_THEN_X: _SeqDef(2, (1,), 1, (0,)),
    pm.SlabSequence.Z_THEN_YX: _SeqDef(2, (), 2, (1, 0)),
    pm.SlabSequence.Y_THEN_ZX: _SeqDef(1, (), 1, (2, 0)),
}


# The reference's transpose phases (``include/mpicufft_slab.hpp:209-223``).
XPOSE_SECTIONS = ["Transpose (First Send)", "Transpose (Packing)",
                  "Transpose (Start Local Transpose)",
                  "Transpose (Start Receive)", "Transpose (First Receive)",
                  "Transpose (Finished Receive)", "Transpose (Start All2All)",
                  "Transpose (Finished All2All)", "Transpose (Unpacking)"]


class SlabFFTPlan(DistFFTPlan, AxisBlocks):
    """3D R2C/C2R (or C2C) FFT plan with 1D (slab) decomposition over x."""

    def __init__(self, global_size: pm.GlobalSize, partition: pm.SlabPartition,
                 config: Optional[pm.Config] = None, transform: str = "r2c",
                 device: "str | torch.device" = "cuda", group=None,
                 sequence: "pm.SlabSequence | str" = pm.SlabSequence.ZY_THEN_X):
        if transform not in ("r2c", "c2c"):
            raise ValueError(f"transform must be 'r2c' or 'c2c', got {transform!r}")
        sequence = pm.SlabSequence.parse(sequence)
        P = partition.p
        if P == 1 and sequence is pm.SlabSequence.Y_THEN_ZX:
            # The JAX plan declares a y-halved output here but its single-
            # device path returns the z-halved rfftn, so its own inverse
            # rejects its forward output: nothing consistent to port.
            raise NotImplementedError(
                f"slab sequence {sequence.value} on one rank is not ported "
                f"({_ODDITY_ITEM})")
        # "auto" Config fields are settled here, before anything reads the
        # config: a wisdom hit folds the record, a miss races and records
        # (utils/wisdom.py); a concrete Config passes through untouched.
        config = wisdom.resolve_config(
            "slab", global_size, partition, config, sequence=sequence,
            transform=transform, device=resolve_device(device), group=group)
        super().__init__(global_size, partition, config, device)
        self.transform = transform
        self.sequence = sequence
        self._seq = s = _SEQS[sequence]
        self._P = P
        self.rank = 0
        if P > 1:
            if group is None or group is dist.group.WORLD:
                # Held as None, which every collective reads as the world
                # group: a plan still holding the world group's object at
                # interpreter exit can abort its gloo rank there.
                make_slab_group(P)
                group = None
            elif dist.get_world_size(group) != P:
                raise ValueError(
                    f"the process group has {dist.get_world_size(group)} "
                    f"ranks but the partition asks for {P}")
            self.group = group
            self.rank = dist.get_rank(group)
        g = global_size
        if transform == "c2c":
            self._spec_shape = g.shape
        elif s.r2c_axis == 2:
            self._spec_shape = (g.nx, g.ny, g.nz_out)
        else:
            self._spec_shape = (g.nx, g.ny_out, g.nz)
        self._split_ext = self._spec_shape[s.split_axis]
        self._nx_pad = padded_extent(g.nx, P)
        self._split_pad = padded_extent(self._split_ext, P)
        notice_axis_smoothness("slab", g.shape, self.config)
        obs.event("plan.created", kind="slab", sequence=sequence.value,
                  transform=transform, shape=list(g.shape), ranks=P,
                  comm=self.config.comm_method.value,
                  send=self.config.send_method.value, opt=self.config.opt,
                  wire=self.config.wire_dtype,
                  backend=self.config.fft_backend)

    # -- shapes & size tables ---------------------------------------------

    def _wisdom_key_args(self) -> dict:
        return {"kind": "slab", "sequence": self.sequence,
                "transform": self.transform, "dims": 3}

    @property
    def output_shape(self) -> Tuple[int, int, int]:
        return self._spec_shape

    @property
    def input_padded_shape(self) -> Tuple[int, int, int]:
        g = self.global_size
        return (self._nx_pad, g.ny, g.nz)

    @property
    def output_padded_shape(self) -> Tuple[int, int, int]:
        s = list(self._spec_shape)
        s[self._seq.split_axis] = self._split_pad
        return tuple(s)

    @property
    def local_input_shape(self) -> Tuple[int, int, int]:
        """This rank's block of the padded input (split over x)."""
        s = self.input_padded_shape
        return (s[0] // self._P, s[1], s[2])

    @property
    def local_output_shape(self) -> Tuple[int, int, int]:
        """This rank's block of the padded output (split over the split
        axis)."""
        s = list(self.output_padded_shape)
        s[self._seq.split_axis] //= self._P
        return tuple(s)

    def local_slices(self, output: bool = False) -> Tuple[slice, ...]:
        """Where this rank's block lies in the padded global input (or
        output)."""
        axis = self._seq.split_axis if output else 0
        b = (self.local_output_shape if output else self.local_input_shape)[axis]
        sl = [slice(None)] * 3
        sl[axis] = slice(self.rank * b, (self.rank + 1) * b)
        return tuple(sl)

    def in_sizes(self, axis: str = "x") -> List[int]:
        if axis != "x":
            raise ValueError("slab input is decomposed over x only")
        return even_shard_sizes(self.global_size.nx, self._nx_pad, self._P)

    def out_sizes(self, axis: Optional[str] = None) -> List[int]:
        """Per-rank extents of the decomposed output axis (y for ZY_Then_X
        and Y_Then_ZX, z for Z_Then_YX), logical extents excluding pad
        lanes."""
        expected = "xyz"[self._seq.split_axis]
        if axis is not None and axis != expected:
            raise ValueError(
                f"{self.sequence.value} output is decomposed over {expected}")
        return even_shard_sizes(self._split_ext, self._split_pad, self._P)

    # -- logical <-> padded conversion helpers ----------------------------

    def pad_input(self, x) -> torch.Tensor:
        """Logical (or padded) global input -> this rank's padded input
        block on the plan's device (real, or complex for c2c plans)."""
        dtype = self.complex_dtype if self.transform == "c2c" else \
            self.real_dtype
        return self._block(x, dtype, 0, self.input_shape,
                           self.input_padded_shape)

    def pad_spectral(self, c) -> torch.Tensor:
        """Logical (or padded) global spectrum -> this rank's padded output
        block on the plan's device."""
        return self._block(c, self.complex_dtype, self._seq.split_axis,
                           self.output_shape, self.output_padded_shape)

    def crop_real(self, r) -> np.ndarray:
        """Inverse output block(s) -> logical (nx, ny, nz) host array."""
        return self._host(self._gather(r, 0))[: self.global_size.nx]

    def crop_spectral(self, c) -> np.ndarray:
        """Forward output block(s) -> logical spectral host array."""
        sa = self._seq.split_axis
        sl = [slice(None)] * 3
        sl[sa] = slice(0, self._split_ext)
        return self._host(self._gather(c, sa))[tuple(sl)]

    # -- execution ----------------------------------------------------------

    def exec_r2c(self, x) -> torch.Tensor:
        if self.transform != "r2c":
            raise TypeError("this plan was built with transform='c2c'; "
                            "use exec_c2c/exec_c2c_inv")
        return super().exec_r2c(self._fwd_input(x, self.real_dtype))

    def exec_c2r(self, c) -> torch.Tensor:
        if self.transform != "r2c":
            raise TypeError("this plan was built with transform='c2c'; "
                            "use exec_c2c/exec_c2c_inv")
        return super().exec_c2r(self._inv_input(c))

    def exec_c2c(self, x) -> torch.Tensor:
        """Forward 3D C2C transform (transform='c2c' plans)."""
        if self.transform != "c2c":
            raise TypeError("this plan was built with transform='r2c'; "
                            "use exec_r2c/exec_c2r")
        return super().exec_r2c(self._fwd_input(x, self.complex_dtype))

    def exec_c2c_inv(self, c) -> torch.Tensor:
        """Inverse 3D C2C transform (transform='c2c' plans)."""
        if self.transform != "c2c":
            raise TypeError("this plan was built with transform='r2c'; "
                            "use exec_r2c/exec_c2r")
        return super().exec_c2r(self._inv_input(c))

    def _fwd_input(self, x, dtype: torch.dtype) -> torch.Tensor:
        shape = tuple(x.shape)
        if self.fft3d:
            ok = shape in (self.input_shape, self.input_padded_shape)
            want = (f"global shape {self.input_shape} (or padded "
                    f"{self.input_padded_shape})")
        else:
            ok = shape == self.local_input_shape
            want = f"this rank's input block {self.local_input_shape}"
        if not ok:
            raise ValueError(f"forward exec expects {want}, got {shape}")
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def _inv_input(self, c) -> torch.Tensor:
        shape = tuple(c.shape)
        if self.fft3d:
            ok = shape in (self.output_shape, self.output_padded_shape)
            want = (f"global shape {self.output_shape} (or padded "
                    f"{self.output_padded_shape})")
        else:
            ok = shape == self.local_output_shape
            want = f"this rank's output block {self.local_output_shape}"
        if not ok:
            raise ValueError(f"inverse exec expects {want}, got {shape}")
        return torch.as_tensor(c, dtype=self.complex_dtype, device=self.device)

    # -- the pure pipelines (the solver protocol) ----------------------------

    def _halved_axis_index(self) -> int:
        return self._seq.r2c_axis

    def forward_fn(self) -> Pipeline:
        """The forward pipeline with no resilience envelope and no guard
        (the JAX plan's ``forward_fn``), differentiable, built once. It
        takes what ``exec_r2c`` (``exec_c2c``) takes: on one rank the
        global array, on P ranks this rank's padded block, or in either
        case its logical part, zero-padded by a differentiable pad; any
        other shape raises. Under ``torch.no_grad()`` its output is
        ``exec_fwd``'s bit for bit."""
        return self._pure_fn(True, self._build_r2c)

    def inverse_fn(self) -> Pipeline:
        """The inverse pipeline (see ``forward_fn``)."""
        return self._pure_fn(False, self._build_c2r)

    # -- resilience hooks (guards + fallback ladder) -------------------------

    def _guard_spec(self, direction: str, dims: int = 3) -> GuardSpec:
        """GuardSpec of the slab pipelines (the JAX plan's): the sequence's
        R2C axis is the halved one."""
        g, ax = self.global_size, self._seq.r2c_axis
        return transform_spec(direction, self.config.norm, float(g.n_total),
                              self.transform == "c2c", self.input_shape,
                              self._spec_shape, ax, g.shape[ax])

    def _build_attrs(self) -> dict:
        return {"kind": "slab", "sequence": self.sequence.value}

    # -- pipelines ----------------------------------------------------------

    def _fft_kw(self) -> dict:
        """The keywords of every local FFT of the plan."""
        cfg = self.config
        return dict(norm=cfg.norm, backend=cfg.fft_backend,
                    settings=self._mxu_st)

    def _exchange_kw(self) -> dict:
        """The ring's schedule knobs from the Config."""
        cfg = self.config
        return dict(wire=cfg.wire_dtype,
                    overlap=cfg.send_method is pm.SendMethod.RING_OVERLAP,
                    depth=cfg.resolved_overlap_depth(),
                    subblocks=cfg.resolved_overlap_subblocks())

    def _streams_chunk_axis(self) -> int:
        """The axis the pieced exchanges cut: the one in neither side of the
        exchange (split axis <-> 0 leaves exactly one of {1, 2} free)."""
        return next(a for a in (1, 2) if a != self._seq.split_axis)

    def _a2a_pipe_chunks(self) -> int:
        """Pieces of the pipelined all-to-all (ALL2ALL + SYNC / MPI_TYPE
        with ``overlap_subblocks`` > 1), clamped to the free axis's
        extent; 1 wherever another rendering owns the exchange."""
        cfg = self.config
        if (self.fft3d or cfg.comm_method is not pm.CommMethod.ALL2ALL
                or cfg.send_method not in (pm.SendMethod.SYNC,
                                           pm.SendMethod.MPI_TYPE)):
            return 1
        return ring_subblocks(
            self.output_padded_shape[self._streams_chunk_axis()],
            cfg.resolved_overlap_subblocks())

    def _xpose_bodies(self, chunks: Optional[int] = None):
        """``(forward, inverse)`` exchange bodies of a plan that no ring
        owns (``exchange_body``): the all-to-all (ALL2ALL, at the Config's
        opt) or Peer2Peer (PEER2PEER), each the whole block at once; the
        pipelined all-to-all where ``_a2a_pipe_chunks`` > 1; with
        ``chunks`` > 1, that many independent exchanges of pieces of the
        free axis (STREAMS' exchanges). Every one gives the monolithic
        result bit for bit."""
        cfg = self.config
        sa = self._seq.split_axis
        kw = dict(all_to_all=cfg.comm_method is pm.CommMethod.ALL2ALL,
                  realigned=cfg.opt == 1, wire=cfg.wire_dtype,
                  chunk_axis=self._streams_chunk_axis(),
                  pipe_chunks=self._a2a_pipe_chunks() if chunks is None else 1,
                  depth=cfg.resolved_overlap_depth(), pieces=chunks or 1)
        # Stage scope (obs/profile.py): the whole exchange — encode,
        # collective, decode — is the graph's exchange:1 node (the wire
        # layer nests its own scopes inside).
        return tuple(obs.profile.scoped(
            "slab", "exchange:1", exchange_body(self.group, a, b, **kw))
            for a, b in ((sa, 0), (0, sa)))

    def _exchange_bodies(self):
        """The exchange pair of the staged surface: ``_xpose_bodies`` of
        this Config, with STREAMS as its K pieced exchanges."""
        if self.config.send_method is pm.SendMethod.STREAMS:
            return self._xpose_bodies(
                chunks=self.config.resolved_streams_chunks())
        return self._xpose_bodies()

    def _ring_pipe(self, axes: Tuple[int, ...], inverse: bool = False):
        """Shape-preserving per-block FFTs over ``axes`` (None when
        empty: the ring then runs no per-block stage)."""
        if not axes:
            return None
        kw = self._fft_kw()
        tf = lf.ifft if inverse else lf.fft

        def pipe(b: torch.Tensor) -> torch.Tensor:
            for a in axes:
                b = tf(b, axis=a, **kw)
            return b

        # The per-block FFTs belong to the stage-2 local-FFT node even
        # though they run inside the ring (innermost scope wins).
        return obs.profile.scoped("slab", "local_fft:2", pipe)

    def _ring_hooks(self, pipe_axes: Tuple[int, ...], inverse: bool = False):
        """``(encode_fn, arrive_fn, pipe)`` of a ring whose arriving blocks
        run per-block FFTs over ``pipe_axes``. Under the fused wire the
        encode is kernel 9 and the arrival is kernel 11 (decode fused with
        the first per-block DFT, then the remaining axes' plain pipe), or
        kernel 10 where there is no per-block FFT; otherwise ``(None, None,
        pipe)`` keeps the plain wire layer. A double-precision plan's
        arrival decodes plainly and runs the matmul backend's DFT
        (``hf.decode_fft_fused``). ``pipe`` is always the whole per-block
        pipeline: the local block never touches the wire."""
        cfg = self.config
        pipe = self._ring_pipe(pipe_axes, inverse)
        if not cfg.fused_wire_active():
            return None, None, pipe
        if not pipe_axes:
            enc_fn, arr_fn = hf.fused_ring_hooks(cfg)
            return enc_fn, arr_fn, pipe
        norm, st = cfg.norm, self._mxu_st
        cdt = wire_complex_dtype(cfg.double_prec)
        first_ax = pipe_axes[0]
        rest_pipe = self._ring_pipe(pipe_axes[1:], inverse)

        def arrive(b: torch.Tensor) -> torch.Tensor:
            b = hf.decode_fft_fused(b, cdt, first_ax, inverse=inverse,
                                    norm=norm, settings=st)
            return rest_pipe(b) if rest_pipe is not None else b

        return hf.wire_encode_fused, arrive, pipe

    def _fwd_parts(self):
        """(first, xpose, last) of the distributed forward: the R2C (or
        C2C) axis and the pre axes of the x-slab, the exchange, the post
        axes. On a ring the post axes other than the gathered x run per
        arriving block inside ``xpose``."""
        s, cfg, kw = self._seq, self.config, self._fft_kw()
        split_pad, nx = self._split_pad, self.global_size.nx
        first_axis = lf.fft if self.transform == "c2c" else lf.rfft
        group, sa = self.group, s.split_axis

        def first(xl: torch.Tensor) -> torch.Tensor:
            c = first_axis(xl, axis=s.r2c_axis, **kw)
            for a in s.pre_axes:
                c = lf.fft(c, axis=a, **kw)
            return pad_axis_to(c, sa, split_pad)

        if cfg.send_method.is_ring:
            enc_fn, arr_fn, pipe = self._ring_hooks(
                tuple(a for a in s.post_axes if a != 0))
            rest = tuple(a for a in s.post_axes if a == 0)
            ring_kw = self._exchange_kw()

            def xpose(cl: torch.Tensor) -> torch.Tensor:
                return ring_transpose(cl, group, sa, 0, pipeline_fn=pipe,
                                      encode_fn=enc_fn, arrive_fn=arr_fn,
                                      **ring_kw)

            xpose = obs.profile.scoped("slab", "exchange:1", xpose)
        else:
            rest, xpose = s.post_axes, self._exchange_bodies()[0]

        def last(cl: torch.Tensor) -> torch.Tensor:
            # Drop the zero pad rows of x before transforming along it.
            c = slice_axis_to(cl, 0, nx)
            for a in rest:
                c = lf.fft(c, axis=a, **kw)
            return c

        sc = obs.profile.scoped
        return (sc("slab", "local_fft:1", first), xpose,
                sc("slab", "local_fft:2", last))

    def _inv_parts(self):
        """(first, xpose, last) of the distributed inverse. On a ring the
        pipelined set is the C2C axes of ``last`` other than the gathered
        split axis; for ``c2c`` that includes the r2c axis, whose IFFT then
        runs per block ahead of the split axis's, as in the JAX package."""
        s, cfg, kw = self._seq, self.config, self._fft_kw()
        nx_pad, split_ext = self._nx_pad, self._split_ext
        real_n = self.global_size.nz if s.r2c_axis == 2 else \
            self.global_size.ny
        c2c = self.transform == "c2c"
        group, sa = self.group, s.split_axis

        def first(cl: torch.Tensor) -> torch.Tensor:
            c = cl
            for a in reversed(s.post_axes):
                c = lf.ifft(c, axis=a, **kw)
            return pad_axis_to(c, 0, nx_pad)

        if cfg.send_method.is_ring:
            pipe_axes = tuple(a for a in reversed(s.pre_axes) if a != sa)
            if c2c and s.r2c_axis != sa:
                pipe_axes += (s.r2c_axis,)
            enc_fn, arr_fn, pipe = self._ring_hooks(pipe_axes, inverse=True)
            after = tuple(a for a in reversed(s.pre_axes) if a == sa)
            r2c_last = not c2c or s.r2c_axis == sa
            ring_kw = self._exchange_kw()

            def xpose(cl: torch.Tensor) -> torch.Tensor:
                return ring_transpose(cl, group, 0, sa, pipeline_fn=pipe,
                                      encode_fn=enc_fn, arrive_fn=arr_fn,
                                      **ring_kw)

            xpose = obs.profile.scoped("slab", "exchange:1", xpose)
        else:
            after, r2c_last = tuple(reversed(s.pre_axes)), True
            xpose = self._exchange_bodies()[1]

        def last(cl: torch.Tensor) -> torch.Tensor:
            # Drop the pad lanes of the split axis before inverting along
            # the remaining axes.
            c = slice_axis_to(cl, sa, split_ext)
            for a in after:
                c = lf.ifft(c, axis=a, **kw)
            if not r2c_last:
                return c
            if c2c:
                return lf.ifft(c, axis=s.r2c_axis, **kw)
            return lf.irfft(c, n=real_n, axis=s.r2c_axis, **kw)

        sc = obs.profile.scoped
        return (sc("slab", "local_fft:1", first), xpose,
                sc("slab", "local_fft:2", last))

    # -- STREAMS under ALL2ALL: K (exchange -> FFT) piece chains ------------
    # The reference's Streams engine (per-peer packs on CUDA streams, a
    # callback thread and MPI_Isend, src/slab/default/mpicufft_slab.cpp:
    # 343-448) as the JAX package renders it: the block splits into K
    # pieces along the free axis, and each piece's exchange is followed by
    # its post-exchange FFTs before the next piece's exchange. FFTs along
    # the free axis itself run once on the reassembled block; separable
    # DFT axes commute, so the result is the SYNC plan's. In the JAX
    # package GSPMD may schedule the K collectives together; here they are
    # K exchanges, one after another, each ending before its FFTs.

    def _streams_split(self):
        """(chunk axis, pieces, per-piece post axes, after-concat post
        axes) of the STREAMS pipeline."""
        ca = self._streams_chunk_axis()
        k = self.config.resolved_streams_chunks()
        per_chunk = tuple(a for a in self._seq.post_axes if a != ca)
        after = tuple(a for a in self._seq.post_axes if a == ca)
        return ca, k, per_chunk, after

    def _streams_fwd_body(self) -> Pipeline:
        """The forward of ALL2ALL + STREAMS: the first stage, then K
        independent (exchange -> post FFTs) piece chains."""
        kw, nx = self._fft_kw(), self.global_size.nx
        ca, k, per_chunk, after = self._streams_split()
        first = self._fwd_parts()[0]
        xpose = self._xpose_bodies()[0]

        def body(xl: torch.Tensor) -> torch.Tensor:
            outs = []
            for piece in split_axis_chunks(first(xl), ca, k):
                y = xpose(piece)
                with obs.profile.stage_scope("slab", "local_fft:2"):
                    y = slice_axis_to(y, 0, nx)
                    for a in per_chunk:
                        y = lf.fft(y, axis=a, **kw)
                outs.append(y)
            with obs.profile.stage_scope("slab", "local_fft:2"):
                c = concat_axis_chunks(outs, ca)
                for a in after:
                    c = lf.fft(c, axis=a, **kw)
            return c

        return body

    def _streams_inv_body(self) -> Pipeline:
        """The inverse of ALL2ALL + STREAMS: the free axis's inverse FFT on
        the whole block, then K independent (inverse FFTs -> exchange back)
        piece chains, then the shared last stage."""
        kw, nx_pad = self._fft_kw(), self._nx_pad
        ca, k, per_chunk, after = self._streams_split()
        xpose_inv = self._xpose_bodies()[1]
        last = self._inv_parts()[2]

        def body(cl: torch.Tensor) -> torch.Tensor:
            c = cl
            with obs.profile.stage_scope("slab", "local_fft:1"):
                for a in after:
                    c = lf.ifft(c, axis=a, **kw)
            outs = []
            for piece in split_axis_chunks(c, ca, k):
                with obs.profile.stage_scope("slab", "local_fft:1"):
                    # A contiguous piece: on the card its FFTs then run on
                    # the column kernel where they lie, as the whole
                    # block's do.
                    y = piece.contiguous()
                    for a in reversed(per_chunk):
                        y = lf.ifft(y, axis=a, **kw)
                    y = pad_axis_to(y, 0, nx_pad)
                outs.append(xpose_inv(y))
            return last(concat_axis_chunks(outs, ca))

        return body

    def _streams_a2a(self) -> bool:
        cfg = self.config
        return (cfg.send_method is pm.SendMethod.STREAMS
                and cfg.comm_method is pm.CommMethod.ALL2ALL)

    def _build_r2c(self) -> Pipeline:
        if self.fft3d:
            return (self._fft3d_c2c(forward=True) if self.transform == "c2c"
                    else self._fft3d_r2c())
        if self._streams_a2a():
            return self._streams_fwd_body()
        first, xpose, last = self._fwd_parts()
        return lambda xl: last(xpose(first(xl)))

    def _build_c2r(self) -> Pipeline:
        if self.fft3d:
            return (self._fft3d_c2c(forward=False) if self.transform == "c2c"
                    else self._fft3d_c2r())
        if self._streams_a2a():
            return self._streams_inv_body()
        first, xpose, last = self._inv_parts()
        return lambda cl: last(xpose(first(cl)))

    # -- per-phase staged execution (the phase Timer's surface) -------------

    @property
    def variant_name(self) -> str:
        """The benchmark directory of this sequence's CSVs."""
        return {
            pm.SlabSequence.ZY_THEN_X: "slab_default",
            pm.SlabSequence.Z_THEN_YX: "slab_z_then_yx",
            pm.SlabSequence.Y_THEN_ZX: "slab_y_then_zx",
        }[self.sequence]

    @property
    def section_descriptions(self) -> List[str]:
        """The reference's phase vocabulary for this sequence (slab default:
        ``include/mpicufft_slab.hpp:209-223``; z_then_yx: ``:121-134``;
        y_then_zx: ``:107-109``), plus "Run complete (fused)": the mark
        after one more call of ``exec_*``, so a CSV carries the staged
        phases and the plan's own time. Phases the port does not time
        (packing, the first send) stay 0 in the CSV."""
        first, last = self._stage_descs()
        xpose = XPOSE_SECTIONS
        if self.sequence is pm.SlabSequence.ZY_THEN_X:
            return ["init", "2D FFT (Sync)", first] + xpose + [
                last, "Run complete", "Run complete (fused)"]
        if self.sequence is pm.SlabSequence.Y_THEN_ZX:
            return ["init", first, "Transpose (First Send)",
                    "Transpose (Packing)", "Transpose (Start Local Transpose)",
                    "Transpose (Start Receive)", "Transpose (Finished Receive)",
                    last, "Run complete", "Run complete (fused)"]
        return ["init", first] + xpose + [last, "Run complete",
                                          "Run complete (fused)"]

    def _stage_descs(self) -> Tuple[str, str]:
        return {
            pm.SlabSequence.ZY_THEN_X: ("2D FFT Y-Z-Direction",
                                        "1D FFT X-Direction"),
            pm.SlabSequence.Z_THEN_YX: ("1D FFT Z-Direction",
                                        "2D FFT Y-X-Direction"),
            pm.SlabSequence.Y_THEN_ZX: ("1D FFT Y-Direction",
                                        "2D FFT Z-X-Direction"),
        }[self.sequence]

    def _xpose_desc(self) -> str:
        # The reference's y_then_zx list has no All2All markers: its
        # exchange time stays under the receive marker for either method.
        if self.sequence is pm.SlabSequence.Y_THEN_ZX:
            return "Transpose (Finished Receive)"
        return ("Transpose (Finished All2All)"
                if self.config.comm_method is pm.CommMethod.ALL2ALL
                else "Transpose (Finished Receive)")

    def _whole(self, forward: bool):
        if self.transform == "c2c":
            return self.exec_c2c if forward else self.exec_c2c_inv
        return self.exec_r2c if forward else self.exec_c2r

    def forward_stages(self) -> List[Tuple[Optional[str], Pipeline]]:
        """``[(phase, fn)]`` whose composition is the forward transform of a
        local block: the pre-exchange FFTs, the exchange, the post-exchange
        FFTs. One rank: the whole transform, untimed by phase."""
        if self.fft3d:
            return [(None, self._whole(True))]
        first, xpose, last = self._fwd_parts()
        d1, d2 = self._stage_descs()
        return [(d1, first), (self._xpose_desc(), xpose), (d2, last)]

    def inverse_stages(self) -> List[Tuple[Optional[str], Pipeline]]:
        """``forward_stages`` of the inverse transform."""
        if self.fft3d:
            return [(None, self._whole(False))]
        first, xpose, last = self._inv_parts()
        d1, d2 = self._stage_descs()
        return [(d2, first), (self._xpose_desc(), xpose), (d1, last)]
