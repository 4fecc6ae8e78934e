"""PyTorch / CUDA port of ``distributedfft_tpu`` for NVIDIA Hopper.

A second package beside the JAX one, ported slice by slice. This slice
runs the single-device slab plan: ``SlabFFTPlan(GlobalSize, SlabPartition(1),
Config)`` with ``exec_r2c`` / ``exec_c2r``, on ``torch.fft`` (backend
``"xla"``) or on the hand-written Hopper kernels (backend ``"pallas"``).
Entry points run on ``device="cuda"`` unless the caller asks for the CPU.
"""

from .models.slab import SlabFFTPlan
from .params import (Config, FFTNorm, GlobalSize, SlabPartition,
                     config_from_reference, global_size_from_reference,
                     slab_partition_from_reference)

__all__ = ["Config", "FFTNorm", "GlobalSize", "SlabFFTPlan", "SlabPartition",
           "config_from_reference", "global_size_from_reference",
           "slab_partition_from_reference"]
