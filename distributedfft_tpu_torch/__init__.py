"""PyTorch / CUDA port of ``distributedfft_tpu`` for NVIDIA Hopper.

A second package beside the JAX one, ported slice by slice. It runs the
slab plan: ``SlabFFTPlan(GlobalSize, SlabPartition(P), Config)`` with
``exec_r2c`` / ``exec_c2r``, on one device or over P ranks of a
``torch.distributed`` world (``maybe_initialize``, ``make_slab_group``),
its exchange one all-to-all or a ring of point-to-point steps,
on ``torch.fft`` (backend ``"xla"``) or on the hand-written Hopper kernels
(backend ``"pallas"``). Entry points run on ``device="cuda"`` unless the
caller asks for the CPU.
"""

from .models.slab import SlabFFTPlan
from .parallel.mesh import SLAB_AXIS, make_slab_group
from .parallel.multihost import maybe_initialize, shutdown
from .params import (CommMethod, Config, FFTNorm, GlobalSize, SendMethod,
                     SlabPartition, SlabSequence, config_from_reference,
                     global_size_from_reference, slab_partition_from_reference)

__all__ = ["CommMethod", "Config", "FFTNorm", "GlobalSize", "SLAB_AXIS",
           "SendMethod", "SlabFFTPlan", "SlabPartition", "SlabSequence",
           "config_from_reference",
           "global_size_from_reference", "make_slab_group",
           "maybe_initialize", "shutdown", "slab_partition_from_reference"]
