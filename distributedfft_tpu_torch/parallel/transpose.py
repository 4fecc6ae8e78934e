"""Global transposes of the distributed plans — the port's counterpart of
the JAX package's ``parallel/transpose.py``.

This slice has the monolithic exchange of the default configuration
(ALL2ALL + SYNC, opt 0, native wire): one ``all_to_all_single`` per
transpose, the analog of the reference's ``MPI_Alltoall``. The ring,
STREAMS and pipelined renderings, the bf16 wire and opt 1 are ROADMAP
Queue 1 item 7; a plan configured for one of them raises at construction
(``models/slab.py``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def pad_axis_to(x: torch.Tensor, axis: int, target: int) -> torch.Tensor:
    """Zero-pad ``axis`` up to ``target`` extent (no-op when already there)."""
    cur = x.shape[axis]
    if cur == target:
        return x
    if cur > target:
        raise ValueError(f"axis {axis} extent {cur} exceeds pad target {target}")
    shape = list(x.shape)
    shape[axis] = target - cur
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def slice_axis_to(x: torch.Tensor, axis: int, target: int) -> torch.Tensor:
    """Take the leading ``target`` entries along ``axis`` (no-op when equal)."""
    if x.shape[axis] == target:
        return x
    return x.narrow(axis, 0, target)


def all_to_all_transpose(x: torch.Tensor, group, split_axis: int,
                         concat_axis: int) -> torch.Tensor:
    """Scatter ``split_axis`` over the ranks of ``group`` and gather
    ``concat_axis`` from them: the local block of
    ``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``.

    ``all_to_all_single`` scatters and gathers along dim 0, so the sender
    packs the P pieces of the split axis to the front (piece d goes to rank
    d) and the receiver moves the arrived pieces (piece j came from rank j)
    onto the concat axis — the pack/unpack of the JAX package's realigned
    rendering, whose result equals the default one bit for bit. Complex
    data travels as ``torch.view_as_real`` float pairs, so the same code
    serves NCCL (which has no complex type) and gloo."""
    p = dist.get_world_size(group)
    shp = tuple(x.shape)
    s, c = split_axis % x.ndim, concat_axis % x.ndim
    if shp[s] % p:
        raise ValueError(f"split extent {shp[s]} not divisible by the "
                         f"{p} ranks (plans pad before the exchange)")
    send = (x.reshape(shp[:s] + (p, shp[s] // p) + shp[s + 1:])
            .movedim(s, 0).contiguous())
    recv = torch.empty_like(send)
    if send.is_complex():
        dist.all_to_all_single(torch.view_as_real(recv),
                               torch.view_as_real(send), group=group)
    else:
        dist.all_to_all_single(recv, send, group=group)
    # recv: (p, piece...), piece j from rank j -> concatenate along c.
    out = list(recv.shape[1:])
    out[c] *= p
    return recv.movedim(0, c).reshape(out)
