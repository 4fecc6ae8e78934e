"""Slab (1D) decomposition plan of the port.

Three per-axis sequences over ``torch.distributed`` (the JAX package's
``_SEQS``): ``ZY_Then_X``, the reference's default
(``src/slab/default/mpicufft_slab.cpp``), ``Z_Then_YX`` and ``Y_Then_ZX``.
Each rank's x-slab runs the transforms before the exchange (the R2C axis,
then the pre axes), pads the split axis to a multiple of P, and one
exchange scatters the split axis and gathers x; then the post axes run.
The inverse runs the same steps backwards.

The exchange is rendered as one all-to-all (ALL2ALL + SYNC), as a send
and a receive to every peer posted at once (PEER2PEER + SYNC; the same
result bit for bit; MPI_TYPE is SYNC's alias) or as a ring of
point-to-point steps (``SendMethod.RING`` / ``RING_OVERLAP``; the ring
owns the exchange whatever ``comm_method`` says, as in the JAX package).
On a ring, the post-exchange transforms that do not run along the gathered
axis run on each peer block as it arrives. Either rendering takes
``wire_dtype="bf16"``; on a ring ``fused_wire`` swaps the wire boundary
for the kernels of ``ops/hopper_fft.py`` (encode; decode, or decode fused
with the first per-block DFT).

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

from .. import params as pm
from ..ops import fft as lf
from ..ops import hopper_fft as hf
from ..parallel.mesh import make_slab_group
from ..parallel.transpose import (all_to_all_transpose, pad_axis_to,
                                  peer_to_peer_transpose, ring_transpose,
                                  slice_axis_to)
from ..utils.native_planner import even_shard_sizes, padded_extent
from .base import DistFFTPlan, Pipeline

_SLAB_ITEM = "ROADMAP Queue 1, item 2 (the rest of the slab plan)"
_RENDERINGS_ITEM = "ROADMAP Queue 1, item 7 (exchange renderings)"
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


class SlabFFTPlan(DistFFTPlan):
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
        super().__init__(global_size, partition, config, device)
        self.transform = transform
        self.sequence = sequence
        self._seq = s = _SEQS[sequence]
        self._P = P
        self.rank = 0
        if P > 1:
            self._check_rendering()
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

    def _check_rendering(self) -> None:
        """The exchange renderings this slice has: a ring (RING or
        RING_OVERLAP, with depth, sub-blocks and the fused wire), or, at opt
        0, ALL2ALL or PEER2PEER with a SYNC send (MPI_TYPE is its alias);
        any of them with the native or the bf16 wire."""
        cfg = self.config
        if cfg.send_method.is_ring:
            return      # the ring owns the exchange (comm_method, opt inert)
        if cfg.opt != 0:
            raise NotImplementedError(
                f"opt {cfg.opt} (the realigned exchange) is not ported yet "
                f"({_SLAB_ITEM})")
        a2a = cfg.comm_method is pm.CommMethod.ALL2ALL
        for what, ok in (
                (f"send_method {cfg.send_method.value}",
                 cfg.send_method in (pm.SendMethod.SYNC,
                                     pm.SendMethod.MPI_TYPE)),
                (f"overlap_subblocks {cfg.overlap_subblocks} (the pipelined "
                 f"all-to-all)",
                 not a2a or cfg.resolved_overlap_subblocks() <= 1)):
            if not ok:
                raise NotImplementedError(
                    f"{what} is not ported yet ({_RENDERINGS_ITEM}); the "
                    f"port's distributed slab runs RING / RING_OVERLAP, or "
                    f"ALL2ALL / PEER2PEER + SYNC at opt 0")

    # -- shapes & size tables ---------------------------------------------

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

    # -- pipelines ----------------------------------------------------------

    def _exchange_kw(self) -> dict:
        """The ring's schedule knobs from the Config."""
        cfg = self.config
        return dict(wire=cfg.wire_dtype,
                    overlap=cfg.send_method is pm.SendMethod.RING_OVERLAP,
                    depth=cfg.resolved_overlap_depth(),
                    subblocks=cfg.resolved_overlap_subblocks())

    def _exchange(self):
        """The monolithic exchange of a SYNC / MPI_TYPE send: one all-to-all
        (ALL2ALL) or a send and a receive to every peer (PEER2PEER); both
        give the same result bit for bit."""
        if self.config.comm_method is pm.CommMethod.PEER2PEER:
            return peer_to_peer_transpose
        return all_to_all_transpose

    def _ring_pipe(self, axes: Tuple[int, ...], inverse: bool = False):
        """Shape-preserving per-block FFTs over ``axes`` (None when
        empty: the ring then runs no per-block stage)."""
        if not axes:
            return None
        norm, be = self.config.norm, self.config.fft_backend
        tf = lf.ifft if inverse else lf.fft

        def pipe(b: torch.Tensor) -> torch.Tensor:
            for a in axes:
                b = tf(b, axis=a, norm=norm, backend=be)
            return b

        return pipe

    def _ring_hooks(self, pipe_axes: Tuple[int, ...], inverse: bool = False):
        """``(encode_fn, arrive_fn, pipe)`` of a ring whose arriving blocks
        run per-block FFTs over ``pipe_axes``. Under the fused wire the
        encode is kernel 9 and the arrival is kernel 11 (decode fused with
        the first per-block DFT, then the remaining axes' plain pipe), or
        kernel 10 where there is no per-block FFT; otherwise ``(None, None,
        pipe)`` keeps the plain wire layer. ``pipe`` is always the whole
        per-block pipeline: the local block never touches the wire."""
        cfg = self.config
        pipe = self._ring_pipe(pipe_axes, inverse)
        if not cfg.fused_wire_active():
            return None, None, pipe
        if not pipe_axes:
            enc_fn, arr_fn = hf.fused_ring_hooks(cfg)
            return enc_fn, arr_fn, pipe
        if cfg.double_prec:
            raise NotImplementedError(
                "the fused decode + DFT of a double-precision plan runs the "
                "matmul backend in the JAX package; it is not ported yet "
                "(ROADMAP Queue 1, item 3)")
        norm = cfg.norm
        first_ax = pipe_axes[0]
        rest_pipe = self._ring_pipe(pipe_axes[1:], inverse)

        def arrive(b: torch.Tensor) -> torch.Tensor:
            b = hf.decode_fft_fused(b, torch.complex64, first_ax,
                                    inverse=inverse, norm=norm)
            return rest_pipe(b) if rest_pipe is not None else b

        return hf.wire_encode_fused, arrive, pipe

    def _fwd_parts(self):
        """(first, xpose, last) of the distributed forward: the R2C (or
        C2C) axis and the pre axes of the x-slab, the exchange, the post
        axes. On a ring the post axes other than the gathered x run per
        arriving block inside ``xpose``."""
        s, cfg = self._seq, self.config
        norm, be = cfg.norm, cfg.fft_backend
        split_pad, nx = self._split_pad, self.global_size.nx
        first_axis = lf.fft if self.transform == "c2c" else lf.rfft
        group, sa = self.group, s.split_axis

        def first(xl: torch.Tensor) -> torch.Tensor:
            c = first_axis(xl, axis=s.r2c_axis, norm=norm, backend=be)
            for a in s.pre_axes:
                c = lf.fft(c, axis=a, norm=norm, backend=be)
            return pad_axis_to(c, sa, split_pad)

        if cfg.send_method.is_ring:
            enc_fn, arr_fn, pipe = self._ring_hooks(
                tuple(a for a in s.post_axes if a != 0))
            rest = tuple(a for a in s.post_axes if a == 0)
            kw = self._exchange_kw()

            def xpose(cl: torch.Tensor) -> torch.Tensor:
                return ring_transpose(cl, group, sa, 0, pipeline_fn=pipe,
                                      encode_fn=enc_fn, arrive_fn=arr_fn,
                                      **kw)
        else:
            rest, wire, exchange = s.post_axes, cfg.wire_dtype, \
                self._exchange()

            def xpose(cl: torch.Tensor) -> torch.Tensor:
                return exchange(cl, group, sa, 0, wire=wire)

        def last(cl: torch.Tensor) -> torch.Tensor:
            # Drop the zero pad rows of x before transforming along it.
            c = slice_axis_to(cl, 0, nx)
            for a in rest:
                c = lf.fft(c, axis=a, norm=norm, backend=be)
            return c

        return first, xpose, last

    def _inv_parts(self):
        """(first, xpose, last) of the distributed inverse. On a ring the
        pipelined set is the C2C axes of ``last`` other than the gathered
        split axis; for ``c2c`` that includes the r2c axis, whose IFFT then
        runs per block ahead of the split axis's, as in the JAX package."""
        s, cfg = self._seq, self.config
        norm, be = cfg.norm, cfg.fft_backend
        nx_pad, split_ext = self._nx_pad, self._split_ext
        real_n = self.global_size.nz if s.r2c_axis == 2 else \
            self.global_size.ny
        c2c = self.transform == "c2c"
        group, sa = self.group, s.split_axis

        def first(cl: torch.Tensor) -> torch.Tensor:
            c = cl
            for a in reversed(s.post_axes):
                c = lf.ifft(c, axis=a, norm=norm, backend=be)
            return pad_axis_to(c, 0, nx_pad)

        if cfg.send_method.is_ring:
            pipe_axes = tuple(a for a in reversed(s.pre_axes) if a != sa)
            if c2c and s.r2c_axis != sa:
                pipe_axes += (s.r2c_axis,)
            enc_fn, arr_fn, pipe = self._ring_hooks(pipe_axes, inverse=True)
            after = tuple(a for a in reversed(s.pre_axes) if a == sa)
            r2c_last = not c2c or s.r2c_axis == sa
            kw = self._exchange_kw()

            def xpose(cl: torch.Tensor) -> torch.Tensor:
                return ring_transpose(cl, group, 0, sa, pipeline_fn=pipe,
                                      encode_fn=enc_fn, arrive_fn=arr_fn,
                                      **kw)
        else:
            after, r2c_last = tuple(reversed(s.pre_axes)), True
            wire, exchange = cfg.wire_dtype, self._exchange()

            def xpose(cl: torch.Tensor) -> torch.Tensor:
                return exchange(cl, group, 0, sa, wire=wire)

        def last(cl: torch.Tensor) -> torch.Tensor:
            # Drop the pad lanes of the split axis before inverting along
            # the remaining axes.
            c = slice_axis_to(cl, sa, split_ext)
            for a in after:
                c = lf.ifft(c, axis=a, norm=norm, backend=be)
            if not r2c_last:
                return c
            if c2c:
                return lf.ifft(c, axis=s.r2c_axis, norm=norm, backend=be)
            return lf.irfft(c, n=real_n, axis=s.r2c_axis, norm=norm,
                            backend=be)

        return first, xpose, last

    def _build_r2c(self) -> Pipeline:
        if self.fft3d:
            return (self._fft3d_c2c(forward=True) if self.transform == "c2c"
                    else self._fft3d_r2c())
        first, xpose, last = self._fwd_parts()
        return lambda xl: last(xpose(first(xl)))

    def _build_c2r(self) -> Pipeline:
        if self.fft3d:
            return (self._fft3d_c2c(forward=False) if self.transform == "c2c"
                    else self._fft3d_c2r())
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
        xpose = ["Transpose (First Send)", "Transpose (Packing)",
                 "Transpose (Start Local Transpose)",
                 "Transpose (Start Receive)", "Transpose (First Receive)",
                 "Transpose (Finished Receive)", "Transpose (Start All2All)",
                 "Transpose (Finished All2All)", "Transpose (Unpacking)"]
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
