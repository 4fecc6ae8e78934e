"""Process-group construction — the port's counterpart of the JAX package's
``parallel/mesh.py``.

The reference derives its rank layout from ``MPI_Comm_rank`` /
``MPI_Comm_split`` (``src/mpicufft.cpp:46-51``). The JAX package names a
1D device-mesh axis ``'p'`` for a slab plan and a 2D mesh ``('p1', 'p2')``
for a pencil plan; here each rank is one process of a
``torch.distributed`` world (NCCL across cards, gloo on the CPU). A slab
plan over P ranks exchanges over a group of exactly P processes; a pencil
plan over a P1 x P2 grid exchanges over two sub-groups of it, the
reference's two ``MPI_Comm_split`` communicators
(``src/pencil/mpicufft_pencil.cpp:112-123``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

# Name of the slab decomposition axis (the JAX mesh axis name).
SLAB_AXIS = "p"
# Names of the pencil grid's axes (the JAX mesh axis names): p1 splits x
# and carries transpose 2, p2 splits y and carries transpose 1.
PENCIL_AXES = ("p1", "p2")

# (p1, p2) -> (row groups, column groups) of this world, every one of them:
# ``dist.new_group`` is collective over the world, so each rank creates
# them all, once, in one order.
_PENCIL_GROUPS: Dict[Tuple[int, int], Tuple[list, list]] = {}


def _require_world(kind: str) -> int:
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"a distributed {kind} plan needs a torch.distributed world: "
            f"start one rank per process and call "
            f"distributedfft_tpu_torch.maybe_initialize() first")
    return dist.get_world_size()


def make_slab_group(p: Optional[int] = None):
    """The 1-axis process group of a slab plan over ``p`` ranks (default:
    the whole world) — the counterpart of ``make_slab_mesh``.

    It is the default (world) group, which must hold exactly ``p`` ranks;
    anything else raises. Start the world first (``maybe_initialize``)."""
    world = _require_world("slab")
    if p is None:
        p = world
    if p != world:
        raise ValueError(f"requested {p} slab ranks but the world has "
                         f"{world}; a slab plan uses the whole world")
    return dist.group.WORLD


def pencil_coords(rank: int, p2: int) -> Tuple[int, int]:
    """Grid coordinate (i, j) of a global rank: rank = i * p2 + j, the
    reference's ``pidx`` (``src/pencil/mpicufft_pencil.cpp:83-85``) and the
    JAX mesh's device order."""
    return divmod(rank, p2)


def make_pencil_groups(p1: int, p2: int):
    """``(row_group, col_group)`` of this rank on a ``p1 x p2`` grid over
    the whole world — the counterpart of ``make_pencil_mesh``.

    The row group holds the p2 ranks with this rank's i and carries
    transpose 1; the column group holds the p1 ranks with its j and carries
    transpose 2. Each group lists its ranks in ascending order, so a
    rank's group rank is its coordinate (j in the row group, i in the
    column group): the exchanges place block d at group rank d. Every rank
    creates all p1 row groups and p2 column groups, in one order, once per
    (p1, p2) and world; a world of another size than p1 * p2 raises."""
    world = _require_world("pencil")
    if p1 <= 0 or p2 <= 0:
        raise ValueError(f"pencil grid must be positive, got {p1}x{p2}")
    if p1 * p2 != world:
        raise ValueError(f"requested a {p1}x{p2} pencil grid but the world "
                         f"has {world} ranks; a pencil plan uses the whole "
                         f"world")
    if (p1, p2) not in _PENCIL_GROUPS:
        rows = [dist.new_group([i * p2 + j for j in range(p2)])
                for i in range(p1)]
        cols = [dist.new_group([i * p2 + j for i in range(p1)])
                for j in range(p2)]
        _PENCIL_GROUPS[(p1, p2)] = (rows, cols)
    rows, cols = _PENCIL_GROUPS[(p1, p2)]
    i, j = pencil_coords(dist.get_rank(), p2)
    return rows[i], cols[j]


def forget_groups() -> None:
    """Drop the cached pencil groups (the world that made them is gone)."""
    _PENCIL_GROUPS.clear()


def best_pencil_grid(n: int) -> Tuple[int, int]:
    """Most-square factorization of ``n`` into (p1, p2), the usual default
    when a job spec gives only a rank count."""
    best = (1, n)
    for p1 in range(1, int(math.isqrt(n)) + 1):
        if n % p1 == 0:
            best = (p1, n // p1)
    return best


def plan_groups(plan) -> tuple:
    """The groups a value reduced or agreed over every rank of a built
    ``plan`` runs over: none on one rank; a pencil plan's column group,
    then its row group (a broadcast from each one's rank 0 reaches every
    rank from rank (0, 0)); else the plan's one group (None: the world)."""
    if getattr(plan, "fft3d", True):
        return ()
    if getattr(plan, "col_group", None) is not None:
        return (plan.col_group, plan.row_group)
    return (plan.group,)


def agreement_groups(kind: str, partition, group=None, groups=None) -> tuple:
    """``plan_groups`` of a ``kind`` plan over ``partition`` before it is
    built: none on one rank or outside a world; a pencil plan's ``groups``
    (``(row, column)``, else ``make_pencil_groups``'s) as column, row;
    else ``group``."""
    if partition.num_ranks <= 1 or not dist.is_initialized():
        return ()
    if kind == "pencil":
        row, col = (groups if groups is not None
                    else make_pencil_groups(partition.p1, partition.p2))
        return (col, row)
    return (group,)


def broadcast_vec(vec, groups) -> np.ndarray:
    """Rank 0's int64 vector on every rank of ``groups``: broadcast over
    each group in turn from its rank 0. No group, or no world, passes
    ``vec`` through. Under gloo it travels as a CPU tensor, under NCCL on
    the current CUDA device."""
    vec = np.asarray(vec, dtype=np.int64)
    if not dist.is_initialized():
        return vec
    for g in groups:
        if dist.get_world_size(g) <= 1:
            continue
        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend(g) == dist.Backend.NCCL
               else torch.device("cpu"))
        t = torch.from_numpy(vec.copy()).to(dev)
        src = 0 if g is None else dist.get_global_rank(g, 0)
        dist.broadcast(t, src=src, group=g)
        vec = t.cpu().numpy()
    return vec
