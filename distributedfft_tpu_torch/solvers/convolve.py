"""Large-kernel spectral convolution / correlation on the port's plans —
the JAX package's ``solvers/convolve.py`` on ``torch``.

FFT convolution with CORRECT zero-padding: images or volumes and the
kernel are embedded in a plan whose logical extent covers the whole
linear-convolution support ``n + k - 1`` per transformed axis (rounded up
to a 5-smooth size by default, ``ops/bluestein.good_size``, so the
transform stays on the fast path; ``pad="exact"`` with
``fft_backend="bluestein"`` transforms the exact support), so the circular
convolution the FFT computes is the linear one:

* ``mode="full"``  — all ``n + k - 1`` samples (np.convolve);
* ``mode="same"``  — the centered ``n`` samples;
* ``mode="valid"`` — the ``n - k + 1`` samples where the kernel fits.

``correlate=True`` flips the kernel along every transformed axis first
(``np.correlate(x, k, "full") == np.convolve(x, k[::-1])``).

Image batches ride the batched-2D plan (BASELINE config #4: 64 images of
4064² against a 33² kernel make a 64 x 4096² plan), volumes a slab or
pencil plan. The kernel spectrum is transformed ONCE at construction, on
the plan's device, in this rank's spectral block (one plane of it on a
batched plan: every plane's is the same); a call then costs one forward,
one multiply in place and one inverse (``forward_fn`` / ``inverse_fn``
under ``torch.no_grad()``), and ``conv_fn`` is the differentiable
pipeline.

**P > 1 ranks (the port's block convention).** ``__call__`` takes the
GLOBAL logical image stack on every rank, as ``pad_input`` does, and
returns this rank's part of the global crop (its block of the inverse
output, cut to the crop; possibly empty); ``gather`` assembles the global
crop on every rank (collective). ``conv_fn`` takes the global image on
every rank and returns this rank's part of the crop, like ``__call__``;
its input sits behind ``parallel.transpose.replicated``, whose backward
all-reduces the gradient, so every rank holds the gradient of the loss
summed over the ranks.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import params as pm
from ..ops.bluestein import good_size
from ..parallel.mesh import plan_groups
from ..parallel.transpose import pad_axis_to, replicated

_MODES = ("full", "same", "valid")


def conv_shape(image_shape: Sequence[int], kernel_shape: Sequence[int],
               pad: str = "smooth") -> Tuple[int, ...]:
    """Per-axis transform extent of a linear convolution: the full support
    ``n + k - 1``, rounded up to the next 5-smooth size (``pad="smooth"``)
    or kept exact (``pad="exact"``)."""
    if len(image_shape) != len(kernel_shape):
        raise ValueError("image and kernel rank differ: "
                         f"{image_shape} vs {kernel_shape}")
    if pad not in ("smooth", "exact"):
        raise ValueError(f"pad must be 'smooth' or 'exact', got {pad!r}")
    out = []
    for n, k in zip(image_shape, kernel_shape):
        full = int(n) + int(k) - 1
        out.append(good_size(full) if pad == "smooth" else full)
    return tuple(out)


def _spectrum_scale(plan) -> float:
    """The convolution theorem's normalization folded into the kernel
    spectrum, so the pipeline is exactly ``inverse(forward(x) * K)``:
    NONE leaves a factor N, BACKWARD is exact, ORTHO leaves 1/sqrt(N)."""
    nvol = float(plan.transform_size)
    norm = plan.config.norm
    if norm is pm.FFTNorm.NONE:
        return 1.0 / nvol
    if norm is pm.FFTNorm.ORTHO:
        return float(np.sqrt(nvol))
    return 1.0


def _overlap(lo: int, hi: int, start: int, ext: int) -> slice:
    """The part of the global range [lo, hi) in the block [start, start +
    ext), in block coordinates."""
    a, b = max(lo, start), min(hi, start + ext)
    return slice(a - start, max(a, b) - start)


class SpectralConvolver:
    """Linear convolution / correlation of images or volumes against one
    FIXED kernel through a plan of the port.

    ``plan`` must be built at the padded transform extent
    (``conv_shape(image_shape, kernel.shape)`` per transformed axis;
    :func:`make_convolver` does both). ``image_shape`` is the LOGICAL
    image extent per transformed axis."""

    def __init__(self, plan, kernel, image_shape: Sequence[int],
                 mode: str = "same", correlate: bool = False):
        if mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
        self.plan = plan
        self.mode = mode
        self.correlate = bool(correlate)
        axes = tuple(plan.transform_axes)
        kernel = np.asarray(kernel)
        if kernel.ndim != len(axes):
            raise ValueError(
                f"kernel rank {kernel.ndim} != transformed rank {len(axes)}")
        self.image_shape = tuple(int(n) for n in image_shape)
        if len(self.image_shape) != len(axes):
            raise ValueError("image_shape must cover the transformed axes")
        self.kernel_shape = tuple(int(k) for k in kernel.shape)
        plan_ext = tuple(plan.input_shape[a] for a in axes)
        want = tuple(n + k - 1 for n, k in zip(self.image_shape,
                                              self.kernel_shape))
        for ext, w in zip(plan_ext, want):
            if ext < w:
                raise ValueError(
                    f"plan extent {plan_ext} cannot hold the linear "
                    f"convolution support {want} (image {self.image_shape} "
                    f"* kernel {self.kernel_shape}); build the plan at "
                    f"conv_shape(...) = "
                    f"{conv_shape(self.image_shape, self.kernel_shape)}")
        if self.mode == "valid" and any(
                n < k for n, k in zip(self.image_shape, self.kernel_shape)):
            raise ValueError("mode='valid' needs image >= kernel per axis")
        if self.correlate:
            kernel = kernel[(slice(None, None, -1),) * kernel.ndim]
        self._c2c = plan.spectral_halved_axis is None
        self._khat = self._kernel_spectrum(kernel)
        self._fn = None

    # -- kernel spectrum (once, on the device, in this rank's block) -------

    def _in_dtype(self) -> torch.dtype:
        plan = self.plan
        return plan.complex_dtype if self._c2c else plan.real_dtype

    def _kernel_spectrum(self, kernel: np.ndarray) -> torch.Tensor:
        """The kernel at the axis origin of every transformed axis (plane 0
        of a batch axis), this rank's block of it transformed by the plan,
        scaled; one plane kept on a batch axis."""
        plan = self.plan
        axes = tuple(plan.transform_axes)
        block = torch.zeros(plan.local_input_shape, dtype=self._in_dtype(),
                            device=plan.device)
        dst = []
        src = []
        ki = iter(range(kernel.ndim))
        for ax, (ext, s) in enumerate(zip(plan.local_input_shape,
                                          plan.local_slices())):
            start = s.start or 0
            if ax in axes:
                k_ext = kernel.shape[next(ki)]
                d = _overlap(0, k_ext, start, ext)
                dst.append(d)
                src.append(slice(d.start + start, d.stop + start))
            else:
                dst.append(slice(0, 1))
        part = np.ascontiguousarray(kernel[tuple(src)])
        if part.size:
            view = block[tuple(dst)]
            view.copy_(torch.from_numpy(part).reshape(view.shape))
        with torch.no_grad():
            khat = plan.forward_fn()(block)
            del block
            khat = khat * _spectrum_scale(plan)
        if len(axes) < khat.ndim:
            sl = tuple(slice(None) if ax in axes else slice(0, 1)
                       for ax in range(khat.ndim))
            khat = khat[sl].clone()
        return khat

    # -- crop offsets ------------------------------------------------------

    def _crop_slices(self) -> Tuple[slice, ...]:
        """The mode's crop of the global (logical) convolution output."""
        plan = self.plan
        axes = tuple(plan.transform_axes)
        sl = [slice(None)] * len(plan.input_shape)
        for i in range(len(sl)):
            if i not in axes:
                sl[i] = slice(0, plan.input_shape[i])
        for a, n, k in zip(axes, self.image_shape, self.kernel_shape):
            if self.mode == "full":
                sl[a] = slice(0, n + k - 1)
            elif self.mode == "same":
                # Correlation centers at k//2 (scipy.signal.correlate),
                # convolution at (k-1)//2 (np.convolve).
                start = k // 2 if self.correlate else (k - 1) // 2
                sl[a] = slice(start, start + n)
            else:  # valid
                sl[a] = slice(k - 1, n)
        return tuple(sl)

    def _local_crop(self) -> Tuple[slice, ...]:
        """The global crop cut to this rank's block of the inverse output,
        in block coordinates."""
        plan = self.plan
        return tuple(
            _overlap(c.start, c.stop, s.start or 0, ext)
            for c, s, ext in zip(self._crop_slices(), plan.local_slices(),
                                 plan.local_input_shape))

    # -- execution ---------------------------------------------------------

    def _embed(self, x) -> torch.Tensor:
        """The logical image stack zero-padded to the plan's extent along
        the transformed axes, as this rank's input block."""
        plan = self.plan
        axes = tuple(plan.transform_axes)
        x = torch.as_tensor(x)
        for a, n in zip(axes, self.image_shape):
            if x.shape[a] != n:
                raise ValueError(
                    f"image extent {tuple(x.shape)} != logical image shape "
                    f"{self.image_shape} on axes {axes}")
        x = x.to(device=plan.device, dtype=self._in_dtype())
        for a in axes:
            x = pad_axis_to(x, a, plan.input_shape[a])
        return plan.pad_input(x) if not plan.fft3d else x

    def _padded_fn(self):
        """Embed -> forward -> kernel multiply -> inverse, the FULL padded
        convolution block (no crop); differentiable."""
        fwd, inv = self.plan.forward_fn(), self.plan.inverse_fn()
        khat, embed = self._khat, self._embed

        def fn(x):
            return inv(fwd(embed(x)) * khat)

        return fn

    def conv_fn(self):
        """The differentiable convolution: the GLOBAL logical image stack
        -> this rank's part of the cropped convolution (the whole crop on
        one rank). On P ranks the input's gradient is all-reduced, so it is
        the gradient of the loss summed over the ranks on every rank."""
        if self._fn is None:
            plan = self.plan
            padded, crop = self._padded_fn(), self._local_crop()
            groups = plan_groups(plan)

            def fn(x):
                return padded(replicated(torch.as_tensor(x), groups))[crop]

            self._fn = fn
        return self._fn

    def __call__(self, x) -> torch.Tensor:
        """Convolve the GLOBAL logical image stack; this rank's part of the
        cropped result (the whole crop on one rank), with no autograd
        graph. The kernel multiply runs in place on the spectrum."""
        plan = self.plan
        with torch.no_grad():
            c = plan.forward_fn()(self._embed(x))
            c.mul_(self._khat)
            return plan.inverse_fn()(c)[self._local_crop()]

    def gather(self, y) -> np.ndarray:
        """The global cropped convolution on every rank (collective), from
        every rank's ``__call__`` result; ``y`` itself on one rank."""
        plan = self.plan
        y = torch.as_tensor(y)
        if plan.fft3d:
            return y.cpu().numpy()
        block = y.new_zeros(plan.local_input_shape)
        block[self._local_crop()] = y.to(block.device)
        return plan.crop_real(block)[self._crop_slices()]


def make_convolver(kernel, image_shape: Sequence[int], *, batch: int = 1,
                   partition=None, config: Optional[pm.Config] = None,
                   family: str = "batched2d", mode: str = "same",
                   correlate: bool = False, pad: str = "smooth",
                   shard: str = "x", batch_chunk: Optional[int] = None,
                   device: "str | torch.device" = "cuda"
                   ) -> SpectralConvolver:
    """Size the plan at the linear-convolution support (``conv_shape``),
    build it in the requested family on ``device``, and wrap it in a
    :class:`SpectralConvolver`.

    * ``family="batched2d"`` — image batches: a ``(batch, nx, ny)`` plan
      (``shard`` and ``batch_chunk`` as ``Batched2DFFTPlan`` takes them);
    * ``family="slab"`` / ``"pencil"`` — 3D volumes (``batch`` ignored)."""
    from ..models.batched2d import Batched2DFFTPlan
    from ..models.pencil import PencilFFTPlan
    from ..models.slab import SlabFFTPlan

    kernel = np.asarray(kernel)
    ext = conv_shape(image_shape, kernel.shape, pad=pad)
    if family == "batched2d":
        if len(ext) != 2:
            raise ValueError("batched2d convolver needs 2D images/kernels")
        partition = partition or pm.SlabPartition(1)
        plan = Batched2DFFTPlan(batch, ext[0], ext[1], partition, config,
                                shard=shard, batch_chunk=batch_chunk,
                                device=device)
    elif family in ("slab", "pencil"):
        if len(ext) != 3:
            raise ValueError(f"{family} convolver needs 3D volumes/kernels")
        g = pm.GlobalSize(*ext)
        if family == "slab":
            plan = SlabFFTPlan(g, partition or pm.SlabPartition(1), config,
                               device=device)
        else:
            plan = PencilFFTPlan(g, partition or pm.PencilPartition(1, 1),
                                 config, device=device)
    else:
        raise ValueError(f"unknown family {family!r}")
    return SpectralConvolver(plan, kernel, image_shape, mode=mode,
                             correlate=correlate)
