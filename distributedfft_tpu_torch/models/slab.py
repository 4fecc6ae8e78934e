"""Slab (1D) decomposition plan of the port.

This slice runs the plan on one device (``SlabPartition(1)``), where the
reference and the JAX package take the single-process 3D path: the forward
is one local 3D R2C, the inverse one local 3D C2R (or C2C both ways for
``transform="c2c"``). Under ``Config(fft_backend="pallas")`` that is the
three hand-written kernels of ``ops/hopper_fft.py``; under the default
``"xla"`` it is ``torch.fft``.

The distributed plan (P > 1: ``ZY_Then_X`` over ``torch.distributed``) is
the next slice. The shape queries and the pad/crop helpers keep the JAX
package's padded-shape contract, which at P = 1 pads nothing.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import params as pm
from ..utils.native_planner import even_shard_sizes
from .base import DistFFTPlan, Pipeline


class SlabFFTPlan(DistFFTPlan):
    """3D R2C/C2R (or C2C) FFT plan with 1D (slab) decomposition over x;
    one device in this slice."""

    def __init__(self, global_size: pm.GlobalSize, partition: pm.SlabPartition,
                 config: Optional[pm.Config] = None, transform: str = "r2c",
                 device: "str | torch.device" = "cuda"):
        if partition.p > 1:
            raise NotImplementedError(
                f"SlabFFTPlan with {partition.p} ranks needs the distributed "
                f"slab (ZY_Then_X over torch.distributed), the next slice of "
                f"the port (ROADMAP Queue 1, item 2); this slice runs P=1")
        if transform not in ("r2c", "c2c"):
            raise ValueError(f"transform must be 'r2c' or 'c2c', got {transform!r}")
        super().__init__(global_size, partition, config, device)
        self.transform = transform
        g = global_size
        self._spec_shape = g.shape if transform == "c2c" else (g.nx, g.ny,
                                                               g.nz_out)

    # -- shapes & size tables ---------------------------------------------

    @property
    def output_shape(self) -> Tuple[int, int, int]:
        return self._spec_shape

    @property
    def input_padded_shape(self) -> Tuple[int, int, int]:
        return self.input_shape

    @property
    def output_padded_shape(self) -> Tuple[int, int, int]:
        return self._spec_shape

    def in_sizes(self, axis: str = "x") -> List[int]:
        if axis != "x":
            raise ValueError("slab input is decomposed over x only")
        nx = self.global_size.nx
        return even_shard_sizes(nx, nx, 1)

    def out_sizes(self, axis: Optional[str] = None) -> List[int]:
        """Per-rank extents of the decomposed output axis (y)."""
        if axis is not None and axis != "y":
            raise ValueError("ZY_Then_X output is decomposed over y")
        ny = self._spec_shape[1]
        return even_shard_sizes(ny, ny, 1)

    # -- logical <-> padded conversion helpers ----------------------------

    def pad_input(self, x) -> torch.Tensor:
        """Logical real input -> the plan's input tensor on its device
        (nothing to pad at P=1)."""
        return torch.as_tensor(x, dtype=self.real_dtype, device=self.device)

    def crop_real(self, r) -> np.ndarray:
        """Inverse output -> logical (nx, ny, nz) host array."""
        return self._host(r)[: self.global_size.nx]

    def pad_spectral(self, c) -> torch.Tensor:
        return torch.as_tensor(c, dtype=self.complex_dtype, device=self.device)

    def crop_spectral(self, c) -> np.ndarray:
        """Forward output -> logical spectral host array."""
        return self._host(c)[:, : self._spec_shape[1]]

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
        if tuple(x.shape) not in (self.input_shape, self.input_padded_shape):
            raise ValueError(
                f"forward exec expects global shape {self.input_shape} (or "
                f"padded {self.input_padded_shape}), got {tuple(x.shape)}")
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def _inv_input(self, c) -> torch.Tensor:
        if tuple(c.shape) not in (self.output_shape, self.output_padded_shape):
            raise ValueError(
                f"inverse exec expects global shape {self.output_shape} (or "
                f"padded {self.output_padded_shape}), got {tuple(c.shape)}")
        return torch.as_tensor(c, dtype=self.complex_dtype, device=self.device)

    def _build_r2c(self) -> Pipeline:
        return (self._fft3d_c2c(forward=True) if self.transform == "c2c"
                else self._fft3d_r2c())

    def _build_c2r(self) -> Pipeline:
        return (self._fft3d_c2c(forward=False) if self.transform == "c2c"
                else self._fft3d_c2r())
