"""PyTorch / CUDA port of ``distributedfft_tpu`` for NVIDIA Hopper.

A second package beside the JAX one, ported slice by slice. It runs the
slab plan, ``SlabFFTPlan(GlobalSize, SlabPartition(P), Config)``, and the
pencil plan, ``PencilFFTPlan(GlobalSize, PencilPartition(P1, P2),
Config)``, with ``exec_r2c`` / ``exec_c2r`` (the pencil's with the depth
``dims`` of its partial transforms), and the batched-2D plan,
``Batched2DFFTPlan(batch, nx, ny, SlabPartition(P), Config, shard=)``, with
``exec_forward`` / ``exec_inverse``, on one device or over the ranks of a
``torch.distributed`` world (``maybe_initialize``; ``make_slab_group``,
``make_pencil_groups``), each exchange an all-to-all, point to point or a
ring of point-to-point steps, on ``torch.fft`` (backend ``"xla"``) or on
the hand-written Hopper kernels (backend ``"pallas"``), or, for axes of
any length, on the chirp-z transform (``"bluestein"``). The solvers
(``solvers/``: Poisson, Navier-Stokes, convolution, DCT/DST) drive every
plan family through its solver protocol and its differentiable
``forward_fn`` / ``inverse_fn``. Entry points run on ``device="cuda"``
unless the caller asks for the CPU.
"""

from .models.batched2d import Batched2DFFTPlan
from .models.pencil import PencilFFTPlan
from .models.slab import SlabFFTPlan
from .parallel.mesh import (PENCIL_AXES, SLAB_AXIS, best_pencil_grid,
                            make_pencil_groups, make_slab_group)
from .parallel.multihost import maybe_initialize, shutdown
from .solvers import (NavierStokes2D, NavierStokes3D, PoissonSolver,
                      SpectralConvolver, make_convolver, make_solver)
from .params import (CommMethod, Config, FFTNorm, GlobalSize,
                     PencilPartition, SendMethod, SlabPartition, SlabSequence,
                     config_from_reference, global_size_from_reference,
                     slab_partition_from_reference)

__all__ = ["Batched2DFFTPlan", "CommMethod", "Config", "FFTNorm", "GlobalSize",
           "NavierStokes2D", "NavierStokes3D", "PENCIL_AXES",
           "PencilFFTPlan", "PencilPartition", "PoissonSolver", "SLAB_AXIS",
           "SendMethod", "SlabFFTPlan", "SlabPartition", "SlabSequence",
           "SpectralConvolver", "best_pencil_grid", "config_from_reference",
           "global_size_from_reference", "make_convolver",
           "make_pencil_groups", "make_slab_group", "make_solver",
           "maybe_initialize", "shutdown", "slab_partition_from_reference"]
