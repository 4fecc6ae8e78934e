"""Extent arithmetic of the slab/pencil decompositions (pure Python).

The JAX package's ``utils/native_planner`` also binds an optional C++
planner through ctypes; this package keeps only the pure-Python
definitions, which compute the same values.
"""

from __future__ import annotations

import math
from typing import List


def block_sizes(n: int, p: int) -> List[int]:
    """Block distribution of ``n`` over ``p`` with remainder spread over the
    first parts (reference ``src/slab/default/mpicufft_slab.cpp:112-117``)."""
    if p <= 0:
        raise ValueError(f"partition count must be positive, got {p}")
    if n < 0:
        raise ValueError(f"extent must be non-negative, got {n}")
    base, rem = divmod(n, p)
    return [base + 1 if i < rem else base for i in range(p)]


def block_starts(sizes: List[int]) -> List[int]:
    """Exclusive prefix sum (reference ``computeOffsets``)."""
    starts, acc = [], 0
    for s in sizes:
        starts.append(acc)
        acc += s
    return starts


def padded_extent(n: int, p: int) -> int:
    """Smallest multiple of ``p`` >= ``n`` (the even-shard pad target)."""
    if p <= 0:
        raise ValueError(f"partition count must be positive, got {p}")
    return p * math.ceil(n / p)


def even_shard_sizes(n: int, n_pad: int, p: int) -> List[int]:
    """Logical per-rank extents under even padded sharding."""
    if p <= 0:
        raise ValueError(f"partition count must be positive, got {p}")
    b = n_pad // p
    return [max(0, min(b, n - i * b)) for i in range(p)]
