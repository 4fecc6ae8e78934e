"""Process-group construction — the port's counterpart of the JAX package's
``parallel/mesh.py``.

The reference derives its rank layout from ``MPI_Comm_rank`` /
``MPI_Comm_split`` (``src/mpicufft.cpp:46-51``). The JAX package names a
1D device-mesh axis ``'p'`` for a slab plan; here each rank is one process
of a ``torch.distributed`` world (NCCL across cards, gloo on the CPU), and a
slab plan over P ranks exchanges over a group of exactly P processes.
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist

# Name of the slab decomposition axis (the JAX mesh axis name).
SLAB_AXIS = "p"


def make_slab_group(p: Optional[int] = None):
    """The 1-axis process group of a slab plan over ``p`` ranks (default:
    the whole world) — the counterpart of ``make_slab_mesh``.

    It is the default (world) group, which must hold exactly ``p`` ranks;
    anything else raises. Start the world first (``maybe_initialize``)."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "a distributed slab plan needs a torch.distributed world: start "
            "one rank per process and call "
            "distributedfft_tpu_torch.maybe_initialize() first")
    world = dist.get_world_size()
    if p is None:
        p = world
    if p != world:
        raise ValueError(f"requested {p} slab ranks but the world has "
                         f"{world}; a slab plan uses the whole world")
    return dist.group.WORLD
