"""Plan base class of the port — the analog of the reference's
``MPIcuFFT<T>`` core (``include/mpicufft.hpp:55-79``).

Construct with a global size, a partition and a Config; query the shapes;
execute forward and inverse transforms on tensors of the plan's device.
This slice has the single-device path only (the reference's
``fft3d = (pcnt == 1)`` fallback, ``src/mpicufft.cpp:65``): one local 3D
transform per direction through ``ops/fft.py``.

A plan's pipelines run as built. The JAX package wraps them in a fallback
ladder that demotes the backend on failure; on the card that would hide a
failing kernel, so the port raises instead.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..ops import fft as local_fft
from ..params import Config, GlobalSize, Partition

Pipeline = Callable[[torch.Tensor], torch.Tensor]


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


class DistFFTPlan:
    """Base class of the plans; subclasses build the pipelines."""

    def __init__(self, global_size: GlobalSize, partition: Partition,
                 config: Optional[Config] = None,
                 device: "str | torch.device" = "cuda"):
        self.global_size = global_size
        self.partition = partition
        self.config = config or Config()
        if self.config.unresolved():
            raise NotImplementedError(
                "Config has unresolved 'auto' fields; wisdom resolution is "
                "not ported yet (ROADMAP Queue 1, item 11)")
        self.device = resolve_device(device)
        self.real_dtype, self.complex_dtype = local_fft.dtypes_for(
            self.config.double_prec)
        # Single-process path, exactly the reference's fft3d = (pcnt == 1).
        self.fft3d = partition.num_ranks == 1
        self._r2c: Optional[Pipeline] = None
        self._c2r: Optional[Pipeline] = None

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

    # -- execution ----------------------------------------------------------

    def exec_r2c(self, x: torch.Tensor) -> torch.Tensor:
        """Forward real-to-complex transform (reference ``execR2C``)."""
        if self._r2c is None:
            self._r2c = self._build_r2c()
        return self._r2c(x)

    def exec_c2r(self, c: torch.Tensor) -> torch.Tensor:
        """Inverse complex-to-real transform (reference ``execC2R``)."""
        if self._c2r is None:
            self._c2r = self._build_c2r()
        return self._c2r(c)

    def _build_r2c(self) -> Pipeline:
        raise NotImplementedError

    def _build_c2r(self) -> Pipeline:
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
        if self.config.fft_backend == "pallas":
            raise NotImplementedError(
                "fft3d_chunk with fft_backend='pallas' runs the per-axis "
                "kernels, which are not ported yet (ROADMAP Queue 1, item 2)")
        return ck

    def _fft3d_r2c(self) -> Pipeline:
        norm, be = self.config.norm, self.config.fft_backend
        ck = self._chunk_for(self.input_shape[0])

        def run(x: torch.Tensor) -> torch.Tensor:
            if ck is None:
                return local_fft.rfftn_3d(x, norm=norm, backend=be)
            # Memory-bounded large-cube path: z+y stages per leading-axis
            # chunk; the x stage needs the full axis and runs on the
            # already-halved spectrum.
            parts = [local_fft.fft(local_fft.rfft(xs, axis=-1, norm=norm,
                                                  backend=be),
                                   axis=-2, norm=norm, backend=be)
                     for xs in torch.chunk(x, ck, dim=0)]
            return local_fft.fft(torch.cat(parts, dim=0), axis=-3, norm=norm,
                                 backend=be)

        return run

    def _fft3d_c2r(self) -> Pipeline:
        norm, be = self.config.norm, self.config.fft_backend
        shape = self.input_shape
        ck = self._chunk_for(shape[0])

        def run(c: torch.Tensor) -> torch.Tensor:
            if ck is None:
                return local_fft.irfftn_3d(c, shape, norm=norm, backend=be)
            c = local_fft.ifft(c, axis=-3, norm=norm, backend=be)
            parts = [local_fft.irfft(local_fft.ifft(cs, axis=-2, norm=norm,
                                                    backend=be),
                                     n=shape[-1], axis=-1, norm=norm,
                                     backend=be)
                     for cs in torch.chunk(c, ck, dim=0)]
            return torch.cat(parts, dim=0)

        return run

    def _fft3d_c2c(self, forward: bool) -> Pipeline:
        """Single-device full 3D C2C (both directions unnormalized under
        FFTNorm.NONE, like cuFFT's CUFFT_FORWARD/CUFFT_INVERSE)."""
        norm, be = self.config.norm, self.config.fft_backend
        axes = (-3, -2, -1)

        def run(c: torch.Tensor) -> torch.Tensor:
            if forward:
                return local_fft.fftn(c, axes, norm=norm, backend=be)
            return local_fft.ifftn(c, axes, norm=norm, backend=be)

        return run
