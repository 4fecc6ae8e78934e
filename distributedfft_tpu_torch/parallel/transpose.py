"""Global transposes of the distributed plans — the port's counterpart of
the JAX package's ``parallel/transpose.py``.

Three renderings of one exchange (scatter ``split_axis`` over the ranks,
gather ``concat_axis`` from them):

* ``all_to_all_transpose``: one ``all_to_all_single`` (ALL2ALL + SYNC),
  the analog of the reference's ``MPI_Alltoall``;
* ``peer_to_peer_transpose``: every send and receive posted at once, one
  pair per peer (PEER2PEER + SYNC), the reference's ``MPI_Isend`` /
  ``MPI_Irecv`` to every peer;
* ``ring_transpose``: the exchange as P-1 point-to-point ring steps
  (``SendMethod.RING``), each a ``batch_isend_irecv`` of one send and one
  receive, optionally issued ahead of the per-block compute with revolving
  receive buffers (``RING_OVERLAP``) and split into sub-blocks.

All carry the wire layer: ``wire="bf16"`` sends a complex payload as a
planar (real, imag) bfloat16 pair, half the bytes of complex64. STREAMS
and the pipelined all-to-all are ROADMAP Queue 1 item 7 and raise at plan
construction (``models/slab.py``).

Data travels as bytes (``.view(torch.uint8)`` of a contiguous buffer), so
neither backend sees a complex or bfloat16 type it may lack. Gloo's
point-to-point does not take CUDA tensors (it aborts on a device pointer,
seen on an H100), so a ring over gloo stages each CUDA block through
pinned host memory; NCCL sends device memory as it is.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# Wire encodings of an exchange payload (the JAX package's wire layer).
WIRE_NATIVE = "native"
WIRE_BF16 = "bf16"
WIRE_DTYPES = (WIRE_NATIVE, WIRE_BF16)

Block = Callable[[torch.Tensor], torch.Tensor]


def validate_wire(wire: str) -> str:
    if wire not in WIRE_DTYPES:
        raise ValueError(
            f"wire dtype must be one of {WIRE_DTYPES} (got {wire!r}; "
            f"'auto' must be resolved at plan construction)")
    return wire


def _wire_active(x: torch.Tensor, wire: str) -> bool:
    """Only complex payloads are compressed; a real one passes through."""
    validate_wire(wire)
    return wire != WIRE_NATIVE and x.is_complex()


def wire_encode(x: torch.Tensor, wire: str = WIRE_BF16) -> torch.Tensor:
    """Complex tensor -> planar (real, imag) bfloat16 pair along a new
    leading axis (shape ``(2,) + x.shape``), rounded to nearest even.
    Non-complex input and ``wire="native"`` pass through."""
    if not _wire_active(x, wire):
        return x
    return torch.stack([x.real, x.imag]).to(torch.bfloat16)


def wire_decode(y: torch.Tensor, dtype: torch.dtype,
                wire: str = WIRE_BF16) -> torch.Tensor:
    """Inverse of ``wire_encode``: planar pair -> complex ``dtype`` (the
    payload's dtype before encoding). Exact: bfloat16 widens losslessly."""
    validate_wire(wire)
    if wire == WIRE_NATIVE:
        return y
    f = torch.float64 if dtype == torch.complex128 else torch.float32
    z = y.to(f)
    return torch.complex(z[0], z[1])


def wire_complex_dtype(double_prec: bool) -> torch.dtype:
    """The complex dtype a decode restores: the plan's precision."""
    return torch.complex128 if double_prec else torch.complex64


def wire_itemsize(dtype, wire: str = WIRE_NATIVE) -> int:
    """Bytes one logical element of ``dtype`` occupies on the wire: the
    native itemsize, or 4 for a bfloat16-compressed complex element."""
    validate_wire(wire)
    d = np.dtype(_np_dtype(dtype))
    if wire == WIRE_NATIVE or d.kind != "c":
        return d.itemsize
    return 4  # 2 planes x 2 bytes (bf16)


def wire_nbytes(shape: Sequence[int], dtype, wire: str = WIRE_NATIVE) -> int:
    """Wire bytes of a whole exchange payload of ``shape`` / ``dtype``."""
    return math.prod(int(s) for s in shape) * wire_itemsize(dtype, wire)


def _np_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return dtype


# ---------------------------------------------------------------------------
# Padding and chunk helpers
# ---------------------------------------------------------------------------


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


def chunk_slices(ext: int, k: int) -> List[Tuple[int, int]]:
    """``(start, size)`` pairs splitting an axis of extent ``ext`` into
    ``min(k, ext)`` near-equal pieces, the remainder on the leading ones."""
    k = max(1, min(k, ext))
    q, r = divmod(ext, k)
    out, off = [], 0
    for i in range(k):
        sz = q + (1 if i < r else 0)
        out.append((off, sz))
        off += sz
    return out


def split_axis_chunks(x: torch.Tensor, axis: int, k: int) -> List[torch.Tensor]:
    """``x`` as ``min(k, extent)`` near-equal views along ``axis``."""
    return [x.narrow(axis, off, sz)
            for off, sz in chunk_slices(x.shape[axis], k)]


def concat_axis_chunks(pieces: Sequence[torch.Tensor],
                       axis: int) -> torch.Tensor:
    """Reassemble ``split_axis_chunks`` pieces (one piece passes through)."""
    return pieces[0] if len(pieces) == 1 else torch.cat(list(pieces), dim=axis)


# ---------------------------------------------------------------------------
# The monolithic exchange
# ---------------------------------------------------------------------------


def all_to_all_transpose(x: torch.Tensor, group, split_axis: int,
                         concat_axis: int, *,
                         wire: str = WIRE_NATIVE) -> torch.Tensor:
    """Scatter ``split_axis`` over the ranks of ``group`` and gather
    ``concat_axis`` from them: the local block of
    ``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``.

    Under a compressed wire the planar bfloat16 pair is exchanged with the
    split and concat axes shifted past its plane axis, then decoded.

    ``all_to_all_single`` scatters and gathers along dim 0, so the sender
    packs the P pieces of the split axis to the front (piece d goes to rank
    d) and the receiver moves the arrived pieces (piece j came from rank j)
    onto the concat axis — the pack/unpack of the JAX package's realigned
    rendering, whose result equals the default one bit for bit."""
    if _wire_active(x, wire):
        y = _all_to_all_native(wire_encode(x, wire), group, split_axis % x.ndim
                               + 1, concat_axis % x.ndim + 1)
        return wire_decode(y, x.dtype, wire)
    return _all_to_all_native(x, group, split_axis, concat_axis)


def _all_to_all_native(x: torch.Tensor, group, split_axis: int,
                       concat_axis: int) -> torch.Tensor:
    p = dist.get_world_size(group)
    shp = tuple(x.shape)
    s, c = split_axis % x.ndim, concat_axis % x.ndim
    if shp[s] % p:
        raise ValueError(f"split extent {shp[s]} not divisible by the "
                         f"{p} ranks (plans pad before the exchange)")
    send = (x.reshape(shp[:s] + (p, shp[s] // p) + shp[s + 1:])
            .movedim(s, 0).contiguous())
    recv = torch.empty_like(send)
    dist.all_to_all_single(_bytes(recv), _bytes(send), group=group)
    # recv: (p, piece...), piece j from rank j -> concatenate along c.
    out = list(recv.shape[1:])
    out[c] *= p
    return recv.movedim(0, c).reshape(out)


def peer_to_peer_transpose(x: torch.Tensor, group, split_axis: int,
                           concat_axis: int, *,
                           wire: str = WIRE_NATIVE) -> torch.Tensor:
    """The exchange of ``all_to_all_transpose`` as point-to-point messages:
    chunk d of the split axis is sent to rank d and rank j's chunk is
    received from it, all P-1 sends and receives posted before any is
    waited on; the own chunk stays local. Bit for bit the all-to-all's
    result, the wire included: a compressed wire encodes every chunk (the
    own one too) before the exchange and decodes after it.

    Over gloo a CUDA payload is staged through pinned host memory
    (``_Transport``); NCCL sends device memory as it is."""
    p = dist.get_world_size(group)
    r = dist.get_rank(group)
    dtype, wired = x.dtype, _wire_active(x, wire)
    s, c = split_axis % x.ndim, concat_axis % x.ndim
    if x.shape[s] % p:
        raise ValueError(f"split extent {x.shape[s]} not divisible by the "
                         f"{p} ranks (plans pad before the exchange)")
    ch = x.shape[s] // p
    if wired:   # the planar pair: the split and concat axes shift by one
        x, s, c = wire_encode(x, wire), s + 1, c + 1
    net = _Transport(group, x.device)
    pending = []
    for t in range(1, p):
        dst, src = (r + t) % p, (r - t) % p
        send = x.narrow(s, dst * ch, ch).contiguous()
        recv = torch.empty_like(send)
        pending.append((src, net.post(send, recv, dst, src, t), recv))
    blocks = [x.narrow(s, r * ch, ch)] * p
    for src, handle, recv in pending:
        net.wait(handle)
        blocks[src] = recv
    out = torch.cat(blocks, dim=c)
    return wire_decode(out, dtype, wire) if wired else out


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's memory as a flat uint8 view."""
    return t.reshape(-1).view(torch.uint8)


# ---------------------------------------------------------------------------
# The ring
# ---------------------------------------------------------------------------


def ring_subblocks(concat_extent: int, subblocks: int) -> int:
    """Effective sub-block count of a ring: the request clamped to the
    travelling block's concat-axis extent (``chunk_slices`` semantics)."""
    return len(chunk_slices(max(1, int(concat_extent)), max(1, subblocks)))


def ring_schedule(payload_shape: Sequence[int], dtype, wire: str, p: int,
                  overlap: bool = False, depth: int = 2,
                  subblocks: int = 1) -> dict:
    """Static description of a ring exchange over a GLOBAL padded payload
    of ``payload_shape``, key for key the JAX package's: peer ``steps``
    per rank, point-to-point micro-steps (``permutes``), the effective
    revolving ``buffers``, the travelling block's and sub-block's wire
    bytes, the bytes in flight per rank, and the total wire bytes over all
    ranks (the local block never travels)."""
    if depth < 1:
        raise ValueError(f"buffer depth must be >= 1, got {depth}")
    if subblocks < 1:
        raise ValueError(f"subblocks must be >= 1, got {subblocks}")
    total = wire_nbytes(payload_shape, dtype, wire)
    block = total // (p * p) if p > 1 else total
    steps = max(0, p - 1)
    sub = max(1, subblocks)
    micro = steps * sub
    sub_block = block if sub == 1 else -(-block // sub)
    buffers = (min(depth, micro) if micro else 0) if overlap else 1
    return {
        "steps": steps,
        "subblocks": sub,
        "permutes": micro,
        "buffers": buffers,
        "effective_depth": buffers if overlap else 1,
        "block_wire_bytes": block,
        "subblock_wire_bytes": sub_block,
        "bytes_in_flight": sub_block * buffers,
        "total_wire_bytes": total * steps // p if p > 1 else 0,
    }


class _Transport:
    """Point-to-point of one ring over ``group``: one ``isend`` and one
    ``irecv`` per micro-step in a ``batch_isend_irecv``. Over gloo a CUDA
    block is staged through pinned host memory (gloo's point-to-point reads
    host memory only); each micro-step carries its own tag, so several
    outstanding messages to one peer cannot be matched out of order."""

    def __init__(self, group, device: torch.device):
        self.group = group
        self.staged = (device.type == "cuda"
                       and dist.get_backend(group) == dist.Backend.GLOO)

    def _peer(self, rank: int) -> int:
        return rank if self.group is None else dist.get_global_rank(
            self.group, rank)

    def post(self, send: torch.Tensor, recv: torch.Tensor, dst: int, src: int,
             tag: int):
        """Start one micro-step: send the contiguous ``send`` to ``dst``,
        receive into the contiguous ``recv`` from ``src``. Returns a handle
        for ``wait``."""
        sb, rb = _bytes(send), _bytes(recv)
        if self.staged:
            host = torch.empty(sb.numel(), dtype=torch.uint8, pin_memory=True)
            host.copy_(sb)      # blocking: the block's producers are done
            sb = host
            rb_host = torch.empty(rb.numel(), dtype=torch.uint8,
                                  pin_memory=True)
        else:
            rb_host = rb
        ops = [dist.P2POp(dist.isend, sb, self._peer(dst), self.group, tag),
               dist.P2POp(dist.irecv, rb_host, self._peer(src), self.group,
                          tag)]
        return dist.batch_isend_irecv(ops), sb, rb_host, rb

    def wait(self, handle) -> None:
        """Finish a micro-step: its receive buffer holds the block after
        this, ordered before any later work on the current stream."""
        works, _, rb_host, rb = handle
        for w in works:
            w.wait()
        if rb_host is not rb:
            rb.copy_(rb_host)


def ring_transpose(x: torch.Tensor, group, split_axis: int, concat_axis: int,
                   *, pipeline_fn: Optional[Block] = None,
                   wire: str = WIRE_NATIVE, overlap: bool = False,
                   depth: int = 2, subblocks: int = 1,
                   encode_fn: Optional[Block] = None,
                   arrive_fn: Optional[Block] = None) -> torch.Tensor:
    """The exchange of ``all_to_all_transpose`` as a ring of P-1 peer steps
    plus the local block; the result is bit for bit the monolithic one's
    for a native wire and no ``pipeline_fn``.

    * Step t sends chunk ``(r+t) % p`` of the split axis to rank
      ``(r+t) % p`` and receives the block of rank ``(r-t) % p``. The local
      block (step 0) takes ``pipeline_fn`` and never touches the wire.
    * ``pipeline_fn`` runs on each block as it arrives; it must keep shape
      and dtype and must not mix data across ``concat_axis`` positions.
    * ``wire`` encodes each travelling block before its send and decodes
      it on arrival, before ``pipeline_fn``.
    * ``overlap`` (RING_OVERLAP) keeps ``min(depth - 1, micro-steps)``
      micro-steps in flight ahead of the block being computed, with
      ``min(depth, micro-steps)`` revolving receive buffers. The per-block
      operations are those of the serial ring, so the output is the same
      bit for bit.
    * ``subblocks`` splits each travelling block along ``concat_axis``
      (``chunk_slices``), each piece its own micro-step; micro-step m is
      sub-block ``(m-1) % n`` of peer step ``(m-1) // n + 1``.
    * ``encode_fn`` replaces ``wire_encode`` on travelling blocks when the
      wire is active; ``arrive_fn`` replaces decode + ``pipeline_fn`` on
      arriving ones (the fused wire).

    The split extent must be divisible by the group size (plans pad)."""
    if depth < 1:
        raise ValueError(f"overlap depth must be >= 1, got {depth}")
    if overlap and depth < 2:
        raise ValueError(
            f"the revolving-buffer overlap schedule needs depth >= 2, "
            f"got {depth} (use overlap=False for the serial ring)")
    if subblocks < 1:
        raise ValueError(f"subblocks must be >= 1, got {subblocks}")
    p = dist.get_world_size(group)
    r = dist.get_rank(group)
    wired = _wire_active(x, wire)
    pipe = pipeline_fn if pipeline_fn is not None else (lambda b: b)
    if p == 1:
        return pipe(x)
    s, c = split_axis % x.ndim, concat_axis % x.ndim
    ext = x.shape[s]
    if ext % p:
        raise ValueError(
            f"ring transpose needs split extent {ext} divisible by the "
            f"{p} ranks (plans pad before the exchange)")
    ch = ext // p
    subs = chunk_slices(x.shape[c], max(1, subblocks))
    nsub = len(subs)
    micro = (p - 1) * nsub
    net = _Transport(group, x.device)

    def piece(t: int, j: int) -> torch.Tensor:
        """Sub-block j of the chunk destined for rank (r + t) % p (a view)."""
        b = x.narrow(s, ((r + t) % p) * ch, ch)
        if nsub > 1:
            off, sz = subs[j]
            b = b.narrow(c, off, sz)
        return b

    def encoded(b: torch.Tensor) -> torch.Tensor:
        if wired:
            b = encode_fn(b) if encode_fn is not None else wire_encode(b, wire)
        return b.contiguous()

    # Revolving receive buffers, each the size of the largest sub-block.
    w = min(depth - 1, micro) if overlap else 0
    probe = encoded(piece(1, 0))
    unit = probe.numel()
    bufs = [torch.empty(unit, dtype=probe.dtype, device=x.device)
            for _ in range(min(w + 1, micro))]

    def post(m: int):
        t, j = (m - 1) // nsub + 1, (m - 1) % nsub
        send = probe if m == 1 else encoded(piece(t, j))
        recv = bufs[m % len(bufs)][:send.numel()].view(send.shape)
        return net.post(send, recv, (r + t) % p, (r - t) % p, m), recv

    def arrive(b: torch.Tensor) -> torch.Tensor:
        if arrive_fn is not None:
            out = arrive_fn(b)
        else:
            out = pipe(wire_decode(b, x.dtype, wire) if wired else b)
        # A later micro-step reuses the buffer: keep no view of it.
        if out.untyped_storage().data_ptr() == b.untyped_storage().data_ptr():
            out = out.clone()
        return out

    queue = [post(m) for m in range(1, w + 1)]
    local = pipe(x.narrow(s, r * ch, ch))
    landed = []
    for m in range(1, micro + 1):
        if m + w <= micro:
            queue.append(post(m + w))
        handle, recv = queue.pop(0)
        net.wait(handle)
        landed.append(arrive(recv))
    del probe, bufs, queue
    # Peer order along the concat axis: step t's block came from rank
    # (r - t) % p, so rank j's block is step (r - j) % p's.
    blocks = [local] + [concat_axis_chunks(landed[(t - 1) * nsub:t * nsub], c)
                        for t in range(1, p)]
    return torch.cat([blocks[(r - j) % p] for j in range(p)], dim=c)
