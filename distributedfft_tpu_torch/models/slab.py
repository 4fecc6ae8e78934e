"""Slab (1D) decomposition plan of the port.

Sequence ``ZY_Then_X``, the reference's default
(``src/slab/default/mpicufft_slab.cpp``), over ``torch.distributed``:

* forward: each rank's x-slab runs a z-R2C (a z-C2C for
  ``transform="c2c"``) and a y-C2C, pads y to a multiple of P, and one
  all-to-all scatters y and gathers x; then x runs a C2C;
* inverse: the same steps backwards, ending in a z-C2R.

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
* plan output: complex, ``output_padded_shape`` (y padded), split over y;
  pad lanes are exact zeros in the forward output and are ignored by the
  inverse.

Local in, local out: on P > 1 ranks ``exec_*`` take and return this rank's
block of the padded global array (``local_input_shape`` /
``local_output_shape``), the block each reference MPI rank holds.
``pad_input`` / ``pad_spectral`` turn the logical global array into this
rank's block on the plan's device; ``crop_spectral`` / ``crop_real``
gather the blocks over the group and return the logical global host array
on every rank, as ``np.asarray`` of a sharded array does in JAX.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import params as pm
from ..ops import fft as lf
from ..parallel.mesh import make_slab_group
from ..parallel.transpose import (all_to_all_transpose, pad_axis_to,
                                  slice_axis_to)
from ..utils.native_planner import even_shard_sizes, padded_extent
from .base import DistFFTPlan, Pipeline

_SLAB_ITEM = "ROADMAP Queue 1, item 2 (the rest of the slab plan)"
_RENDERINGS_ITEM = "ROADMAP Queue 1, item 7 (exchange renderings)"


def _parse_sequence(sequence) -> pm.SlabSequence:
    if isinstance(sequence, pm.SlabSequence):
        return sequence
    for s in pm.SlabSequence:
        if sequence in (s.value, s.name):
            return s
    raise ValueError(f"unknown slab sequence: {sequence!r}")


class SlabFFTPlan(DistFFTPlan):
    """3D R2C/C2R (or C2C) FFT plan with 1D (slab) decomposition over x."""

    def __init__(self, global_size: pm.GlobalSize, partition: pm.SlabPartition,
                 config: Optional[pm.Config] = None, transform: str = "r2c",
                 device: "str | torch.device" = "cuda", group=None,
                 sequence: "pm.SlabSequence | str" = pm.SlabSequence.ZY_THEN_X):
        if transform not in ("r2c", "c2c"):
            raise ValueError(f"transform must be 'r2c' or 'c2c', got {transform!r}")
        sequence = _parse_sequence(sequence)
        if sequence is not pm.SlabSequence.ZY_THEN_X:
            raise NotImplementedError(
                f"slab sequence {sequence.value} is not ported yet "
                f"({_SLAB_ITEM})")
        super().__init__(global_size, partition, config, device)
        self.transform = transform
        self.sequence = sequence
        P = self._P = partition.p
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
        self._spec_shape = g.shape if transform == "c2c" else (g.nx, g.ny,
                                                               g.nz_out)
        self._split_ext = self._spec_shape[1]
        self._nx_pad = padded_extent(g.nx, P)
        self._split_pad = padded_extent(self._split_ext, P)

    def _check_rendering(self) -> None:
        """A distributed plan runs ALL2ALL + SYNC, opt 0, native wire."""
        cfg = self.config
        if cfg.opt != 0:
            raise NotImplementedError(
                f"opt {cfg.opt} (the realigned exchange) is not ported yet "
                f"({_SLAB_ITEM})")
        for what, ok in (
                (f"comm_method {cfg.comm_method.value}",
                 cfg.comm_method is pm.CommMethod.ALL2ALL),
                (f"send_method {cfg.send_method.value}",
                 cfg.send_method is pm.SendMethod.SYNC),
                (f"wire_dtype {cfg.wire_dtype!r}", cfg.wire_dtype == "native"),
                (f"overlap_subblocks {cfg.overlap_subblocks} (the pipelined "
                 f"all-to-all)", (cfg.overlap_subblocks or 1) <= 1)):
            if not ok:
                raise NotImplementedError(
                    f"{what} is not ported yet ({_RENDERINGS_ITEM}); the "
                    f"port's distributed slab runs ALL2ALL + SYNC, opt 0, "
                    f"native wire")

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
        s = self._spec_shape
        return (s[0], self._split_pad, s[2])

    @property
    def local_input_shape(self) -> Tuple[int, int, int]:
        """This rank's block of the padded input (split over x)."""
        s = self.input_padded_shape
        return (s[0] // self._P, s[1], s[2])

    @property
    def local_output_shape(self) -> Tuple[int, int, int]:
        """This rank's block of the padded output (split over y)."""
        s = self.output_padded_shape
        return (s[0], s[1] // self._P, s[2])

    def local_slices(self, output: bool = False) -> Tuple[slice, ...]:
        """Where this rank's block lies in the padded global input (or
        output)."""
        axis = 1 if output else 0
        b = (self.local_output_shape if output else self.local_input_shape)[axis]
        sl = [slice(None)] * 3
        sl[axis] = slice(self.rank * b, (self.rank + 1) * b)
        return tuple(sl)

    def in_sizes(self, axis: str = "x") -> List[int]:
        if axis != "x":
            raise ValueError("slab input is decomposed over x only")
        return even_shard_sizes(self.global_size.nx, self._nx_pad, self._P)

    def out_sizes(self, axis: Optional[str] = None) -> List[int]:
        """Per-rank extents of the decomposed output axis (y), logical
        extents excluding pad lanes."""
        if axis is not None and axis != "y":
            raise ValueError("ZY_Then_X output is decomposed over y")
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
        return self._block(c, self.complex_dtype, 1, self.output_shape,
                           self.output_padded_shape)

    def crop_real(self, r) -> np.ndarray:
        """Inverse output block(s) -> logical (nx, ny, nz) host array."""
        return self._host(self._gather(r, 0))[: self.global_size.nx]

    def crop_spectral(self, c) -> np.ndarray:
        """Forward output block(s) -> logical spectral host array."""
        return self._host(self._gather(c, 1))[:, : self._split_ext]

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

    def _fwd_parts(self):
        """(first, xpose, last) of the distributed forward: z and y
        transforms of the x-slab, the exchange, the x transform."""
        norm, be = self.config.norm, self.config.fft_backend
        split_pad, nx = self._split_pad, self.global_size.nx
        first_axis = lf.fft if self.transform == "c2c" else lf.rfft
        group = self.group

        def first(xl: torch.Tensor) -> torch.Tensor:
            c = first_axis(xl, axis=2, norm=norm, backend=be)
            c = lf.fft(c, axis=1, norm=norm, backend=be)
            return pad_axis_to(c, 1, split_pad)

        def xpose(cl: torch.Tensor) -> torch.Tensor:
            return all_to_all_transpose(cl, group, 1, 0)

        def last(cl: torch.Tensor) -> torch.Tensor:
            # Drop the zero pad rows of x before transforming along it.
            return lf.fft(slice_axis_to(cl, 0, nx), axis=0, norm=norm,
                          backend=be)

        return first, xpose, last

    def _inv_parts(self):
        """(first, xpose, last) of the distributed inverse."""
        norm, be = self.config.norm, self.config.fft_backend
        nx_pad, split_ext = self._nx_pad, self._split_ext
        nz = self.global_size.nz
        c2c = self.transform == "c2c"
        group = self.group

        def first(cl: torch.Tensor) -> torch.Tensor:
            return pad_axis_to(lf.ifft(cl, axis=0, norm=norm, backend=be), 0,
                               nx_pad)

        def xpose(cl: torch.Tensor) -> torch.Tensor:
            return all_to_all_transpose(cl, group, 0, 1)

        def last(cl: torch.Tensor) -> torch.Tensor:
            # Drop the pad lanes of y before inverting along it.
            c = lf.ifft(slice_axis_to(cl, 1, split_ext), axis=1, norm=norm,
                        backend=be)
            if c2c:
                return lf.ifft(c, axis=2, norm=norm, backend=be)
            return lf.irfft(c, n=nz, axis=2, norm=norm, backend=be)

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
