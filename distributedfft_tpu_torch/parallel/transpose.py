"""Global transposes of the distributed plans — the port's counterpart of
the JAX package's ``parallel/transpose.py``.

Four renderings of one exchange (scatter ``split_axis`` over the ranks,
gather ``concat_axis`` from them):

* ``all_to_all_transpose``: one ``all_to_all_single`` (ALL2ALL + SYNC, at
  opt 0 or the realigned opt 1), the analog of the reference's
  ``MPI_Alltoall``;
* ``pipelined_all_to_all``: the same exchange as K asynchronous
  ``all_to_all_single`` calls on pieces of the free axis, each issued
  ahead of the pieces before it are landed (ALL2ALL + SYNC with
  ``overlap_subblocks`` > 1);
* ``peer_to_peer_transpose``: every send and receive posted at once, one
  pair per peer (PEER2PEER + SYNC), the reference's ``MPI_Isend`` /
  ``MPI_Irecv`` to every peer;
* ``ring_transpose``: the exchange as P-1 point-to-point ring steps
  (``SendMethod.RING``), each a ``batch_isend_irecv`` of one send and one
  receive, optionally issued ahead of the per-block compute with revolving
  receive buffers (``RING_OVERLAP``) and split into sub-blocks.

STREAMS (``models/slab.py``) runs K of these exchanges on pieces of the
free axis. All carry the wire layer: ``wire="bf16"`` sends a complex
payload as a planar (real, imag) bfloat16 pair, half the bytes of
complex64.

Data travels as bytes (``.view(torch.uint8)`` of a contiguous buffer), so
neither backend sees a complex or bfloat16 type it may lack.

Each raw exchange of data is a ``torch.autograd.Function`` (``_AllToAll``,
``_AllToAllStart``, ``_PeerToPeer``, ``_RingStep``) whose backward is the
inverse exchange of the cotangent, split and concat axes swapped; the
pad, pack, slice and the bf16 wire's cast around it stay ordinary tensor
ops that torch differentiates itself, so a cotangent crosses the same
wire, rounded. Every rank posts the backward collectives in the order the
autograd engine runs the (identical) graphs of all ranks. A tensor that
requires no gradient takes the same Functions' forwards, with no graph.

Each exchange counts into ``obs.metrics`` (``wire.exchanges_traced`` and
the ``wire.bytes_per_transpose`` gauge, at every executed call where the
JAX package counts once per trace) and runs inside an ``exchange.*`` span.
The fault injector's ``inject.taint_wire`` sits at the wire_encode /
wire_decode boundary of every rendering, on the payload exactly as it
travels (identity, the same tensor, without ``$DFFT_FAULT_SPEC``); over
gloo it runs on the device tensor before it is staged to the host. Gloo's
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

from .. import obs
from ..resilience import inject

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
    with obs.span("exchange.encode", wire=wire), \
            obs.profile.wire_scope("encode"):
        return torch.stack([x.real, x.imag]).to(torch.bfloat16)


def wire_decode(y: torch.Tensor, dtype: torch.dtype,
                wire: str = WIRE_BF16) -> torch.Tensor:
    """Inverse of ``wire_encode``: planar pair -> complex ``dtype`` (the
    payload's dtype before encoding). Exact: bfloat16 widens losslessly."""
    validate_wire(wire)
    if wire == WIRE_NATIVE:
        return y
    with obs.span("exchange.decode", wire=wire), \
            obs.profile.wire_scope("decode"):
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


def _count_exchange(x: torch.Tensor, wire: str) -> None:
    """One exchange run: its count and its payload's wire bytes (this
    rank's block)."""
    obs.metrics.inc("wire.exchanges_traced")
    obs.metrics.gauge("wire.bytes_per_transpose",
                      wire_nbytes(x.shape, x.dtype, wire))


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


def realigned_pack_shape(shape: Sequence[int], split_axis: int,
                         p: int) -> Tuple[int, ...]:
    """Shape of the realigned (opt 1) sender pack: the split axis cut into
    p peer pieces merged into the leading axis, so each peer's piece is a
    contiguous leading chunk (the JAX package's ``realigned_pack_shape``)."""
    s = split_axis
    if shape[s] % p:
        raise ValueError(
            f"split extent {shape[s]} not divisible by mesh size {p}")
    if s == 0:
        return tuple(shape)
    return (p * shape[0],) + tuple(
        shape[i] // p if i == s else shape[i]
        for i in range(1, len(shape)))


def all_to_all_transpose(x: torch.Tensor, group, split_axis: int,
                         concat_axis: int, *, realigned: bool = False,
                         wire: str = WIRE_NATIVE) -> torch.Tensor:
    """Scatter ``split_axis`` over the ranks of ``group`` and gather
    ``concat_axis`` from them: the local block of
    ``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``.

    Under a compressed wire the planar bfloat16 pair is exchanged with the
    split and concat axes shifted past its plane axis, then decoded.

    ``realigned`` is the reference's opt 1 (the coordinate-transformed
    layout, ``include/mpicufft_slab_opt1.hpp:46-54``): the sender packs its
    block so every peer's piece is a contiguous leading chunk
    (``realigned_pack_shape``), the collective is a pure dim-0 exchange,
    and the receiver unpacks onto the concat axis. In the JAX package opt 0
    is ``lax.all_to_all`` with split != concat, whose strided pieces XLA
    gathers itself. ``all_to_all_single`` takes only dim-0 pieces, so the
    port renders opt 0 with that same pack and unpack: both options run
    one code path here and give the same bits."""
    _count_exchange(x, wire)
    with obs.span("exchange.all_to_all", realigned=bool(realigned),
                  wire=wire):
        if _wire_active(x, wire):
            y = inject.taint_wire(wire_encode(x, wire), "all_to_all")
            y = _all_to_all_native(y, group, split_axis % x.ndim + 1,
                                   concat_axis % x.ndim + 1)
            return wire_decode(y, x.dtype, wire)
        return _all_to_all_native(inject.taint_wire(x, "all_to_all"), group,
                                  split_axis, concat_axis)


def _a2a_pack(x: torch.Tensor, p: int, s: int) -> torch.Tensor:
    """The sender pack: (p, piece...) with piece d (for rank d) contiguous,
    the ``realigned_pack_shape`` layout with its leading axis unmerged."""
    shp = tuple(x.shape)
    if shp[s] % p:
        raise ValueError(f"split extent {shp[s]} not divisible by the "
                         f"{p} ranks (plans pad before the exchange)")
    return (x.reshape(shp[:s] + (p, shp[s] // p) + shp[s + 1:])
            .movedim(s, 0).contiguous())


def _a2a_unpack(recv: torch.Tensor, p: int, c: int) -> torch.Tensor:
    """The receiver unpack: (p, piece...), piece j from rank j,
    concatenated along ``c``."""
    out = list(recv.shape[1:])
    out[c] *= p
    return recv.movedim(0, c).reshape(out)


def _a2a_dim0(send: torch.Tensor, group) -> torch.Tensor:
    """The dim-0 all-to-all of a contiguous (p, piece...) buffer: piece d
    goes to rank d, piece j of the result came from rank j."""
    recv = torch.empty_like(send)
    dist.all_to_all_single(_bytes(recv), _bytes(send), group=group)
    return recv


class _AllToAll(torch.autograd.Function):
    """``_a2a_dim0`` with a backward: the adjoint of the dim-0 exchange is
    the same exchange of the cotangent (rank r's piece d went to rank d's
    piece r), so the pack and unpack around it, differentiated by torch,
    make the backward the inverse transpose with split and concat swapped,
    rendered by the all-to-all."""

    @staticmethod
    def forward(ctx, send, group):
        ctx.group = group
        return _a2a_dim0(send, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a_dim0(g.contiguous(), ctx.group), None


class _AllToAllStart(torch.autograd.Function):
    """The asynchronous ``all_to_all_single`` of one piece of the pipelined
    all-to-all: the forward issues it into a fresh receive buffer and
    appends its work to ``pending`` (waited on before the buffer is read);
    the backward is the synchronous exchange of the cotangent, as in
    ``_AllToAll``."""

    @staticmethod
    def forward(ctx, send, group, pending):
        ctx.group = group
        recv = torch.empty_like(send)
        pending.append(dist.all_to_all_single(_bytes(recv), _bytes(send),
                                              group=group, async_op=True))
        return recv

    @staticmethod
    def backward(ctx, g):
        return _a2a_dim0(g.contiguous(), ctx.group), None, None


def _all_to_all_native(x: torch.Tensor, group, split_axis: int,
                       concat_axis: int) -> torch.Tensor:
    p = dist.get_world_size(group)
    if p == 1:      # a one-rank group: the exchange is the identity
        return x
    s, c = split_axis % x.ndim, concat_axis % x.ndim
    recv = _AllToAll.apply(_a2a_pack(x, p, s), group)
    return _a2a_unpack(recv, p, c)


def pipelined_all_to_all(x: torch.Tensor, group, split_axis: int,
                         concat_axis: int, *, chunk_axis: int, chunks: int,
                         depth: int = 2, realigned: bool = False,
                         wire: str = WIRE_NATIVE) -> torch.Tensor:
    """The exchange of ``all_to_all_transpose`` as ``chunks`` pieces along
    ``chunk_axis``, an axis it does not touch (``chunk_slices``: clamped to
    the extent), with an issue-ahead window of ``depth - 1`` pieces: piece
    k + depth - 1's asynchronous ``all_to_all_single`` is issued before
    piece k is waited on and landed (unpacked and decoded), as in the JAX
    package's ``pipelined_all_to_all``. Each piece is the monolithic
    exchange of a slice along an uninvolved axis, so the result is the
    monolithic one bit for bit, wire included. ``realigned`` is accepted
    as in ``all_to_all_transpose`` (one pack for both options).

    Over gloo a CUDA piece travels through the host inside gloo's own
    CUDA all-to-all (its asynchronous form: pinned staging and the host
    collective on gloo's worker thread, the wait on the caller's stream)."""
    s, c, k_ax = (split_axis % x.ndim, concat_axis % x.ndim,
                  chunk_axis % x.ndim)
    if k_ax in (s, c):
        raise ValueError(
            f"pipelined all_to_all needs a chunk axis the exchange does "
            f"not touch, got chunk_axis={chunk_axis} with "
            f"split={split_axis}/concat={concat_axis}")
    if depth < 1:
        raise ValueError(f"overlap depth must be >= 1, got {depth}")
    p = dist.get_world_size(group)
    wired = _wire_active(x, wire)
    shift = 1 if wired else 0

    def issue(piece: torch.Tensor):
        if wired:
            piece = wire_encode(piece, wire)
        piece = inject.taint_wire(piece, "a2a_pipe")
        send = _a2a_pack(piece, p, s + shift)
        if p == 1:  # a one-rank group: nothing to post
            return None, send, send
        work = []
        recv = _AllToAllStart.apply(send, group, work)
        return work[0], send, recv

    def land(pending) -> torch.Tensor:
        work, _, recv = pending
        if work is not None:
            work.wait()
        y = _a2a_unpack(recv, p, c + shift)
        return wire_decode(y, x.dtype, wire) if wired else y

    _count_exchange(x, wire)
    with obs.span("exchange.a2a_pipe", chunks=int(chunks), depth=int(depth),
                  realigned=bool(realigned), wire=wire):
        pieces = split_axis_chunks(x, k_ax, chunks)
        k = len(pieces)
        w = min(depth - 1, k - 1)
        queue = [issue(pieces[i]) for i in range(w)]
        out = []
        for i in range(k):
            if i + w < k:
                queue.append(issue(pieces[i + w]))
            out.append(land(queue.pop(0)))
        return concat_axis_chunks(out, k_ax)


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
    dtype, wired = x.dtype, _wire_active(x, wire)
    s, c = split_axis % x.ndim, concat_axis % x.ndim
    if x.shape[s] % p:
        raise ValueError(f"split extent {x.shape[s]} not divisible by the "
                         f"{p} ranks (plans pad before the exchange)")
    _count_exchange(x, wire)
    with obs.span("exchange.peer_to_peer", wire=wire):
        if wired:   # the planar pair: the split and concat axes shift by one
            x, s, c = wire_encode(x, wire), s + 1, c + 1
        x = inject.taint_wire(x, "peer_to_peer")
        out = _PeerToPeer.apply(x, group, s, c)
        return wire_decode(out, dtype, wire) if wired else out


def _p2p_raw(x: torch.Tensor, group, s: int, c: int) -> torch.Tensor:
    """Peer2Peer's exchange proper on a payload as it travels: chunk d of
    axis ``s`` to rank d, rank j's chunk received into place j along
    ``c``, every send and receive posted before any is waited on."""
    p = dist.get_world_size(group)
    r = dist.get_rank(group)
    ch = x.shape[s] // p
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
    return torch.cat(blocks, dim=c)


class _PeerToPeer(torch.autograd.Function):
    """``_p2p_raw`` with a backward: the inverse exchange of the cotangent,
    ``s`` and ``c`` swapped, rendered point to point as well (out on rank
    r holds, at place j along c, rank j's chunk r along s; so rank j's
    cotangent of chunk r is rank r's cotangent at place j). Over gloo the
    pinned host staging of a CUDA payload stays inside (``_Transport``)."""

    @staticmethod
    def forward(ctx, x, group, s, c):
        ctx.args = (group, s, c)
        return _p2p_raw(x, group, s, c)

    @staticmethod
    def backward(ctx, g):
        group, s, c = ctx.args
        return _p2p_raw(g.contiguous(), group, c, s), None, None, None


def exchange_body(group, split_axis: int, concat_axis: int, *,
                  all_to_all: bool, realigned: bool = False,
                  wire: str = WIRE_NATIVE, chunk_axis: Optional[int] = None,
                  pipe_chunks: int = 1, depth: int = 2,
                  pieces: int = 1) -> Block:
    """The body of one exchange that no ring owns, as the plans render it
    from their Config: with ``pieces`` > 1, that many independent
    exchanges of pieces of ``chunk_axis`` (STREAMS' exchanges); else,
    under ALL2ALL with ``pipe_chunks`` > 1, the pipelined all-to-all in
    that many pieces of ``chunk_axis``; else the whole block at once, by
    the all-to-all (``all_to_all``) or point to point. Every one gives the
    monolithic result bit for bit."""
    def one(x: torch.Tensor) -> torch.Tensor:
        if all_to_all:
            return all_to_all_transpose(x, group, split_axis, concat_axis,
                                        realigned=realigned, wire=wire)
        return peer_to_peer_transpose(x, group, split_axis, concat_axis,
                                      wire=wire)

    if pieces > 1:
        return lambda x: concat_axis_chunks(
            [one(p) for p in split_axis_chunks(x, chunk_axis, pieces)],
            chunk_axis)
    if all_to_all and pipe_chunks > 1:
        return lambda x: pipelined_all_to_all(
            x, group, split_axis, concat_axis, chunk_axis=chunk_axis,
            chunks=pipe_chunks, depth=depth, realigned=realigned, wire=wire)
    return one


class _Replicated(torch.autograd.Function):
    """The autograd boundary of an input every rank holds whole (the
    global image of a convolver, the global interior of an extended
    Poisson box): forward the identity; backward the SUM all-reduce of the
    cotangent over ``groups``, so every rank holds the gradient of the
    loss summed over the ranks. Identical graphs post it in the same order
    on every rank, as the exchanges' backwards. Under gloo a CUDA
    cotangent is reduced through the host."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        for group in ctx.groups:
            if dist.get_world_size(group) <= 1:
                continue
            staged = (g.is_cuda
                      and dist.get_backend(group) == dist.Backend.GLOO)
            t = g.cpu() if staged else g
            flat = torch.view_as_real(t) if t.is_complex() else t
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
            g = t.to(g.device) if staged else t
        return g, None


def replicated(x: torch.Tensor, groups) -> torch.Tensor:
    """``x`` behind ``_Replicated`` over ``groups`` (the plan's group, or
    the pencil's two); ``x`` itself where there is no group to reduce
    over or no gradient to take."""
    groups = tuple(groups)
    if not groups or not torch.is_grad_enabled() or not x.requires_grad:
        return x
    return _Replicated.apply(x, groups)


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
        this, ordered before any later work on the current stream. The
        staging copy lands the data only: autograd records nothing (the
        buffer may be a ``_RingStep`` output)."""
        works, _, rb_host, rb = handle
        for w in works:
            w.wait()
        if rb_host is not rb:
            with torch.no_grad():
                rb.copy_(rb_host)


class _RingStep(torch.autograd.Function):
    """One ring micro-step: send ``send`` to ``dst``, receive a block of
    its shape from ``src`` into ``recv`` (a fresh buffer when None). The
    forward posts it and appends the handle to ``handles``; the caller
    waits (``_Transport.wait``) before it reads the block. The backward is
    the micro-step reversed, posted and waited at once: the cotangent of
    the received block goes back to ``src`` and the cotangent of the sent
    one comes from ``dst``, on the same tag."""

    @staticmethod
    def forward(ctx, send, net, dst, src, tag, recv, handles):
        ctx.args = (net, dst, src, tag)
        if recv is None:
            recv = torch.empty_like(send)
        handles.append(net.post(send, recv, dst, src, tag))
        return recv

    @staticmethod
    def backward(ctx, g):
        net, dst, src, tag = ctx.args
        g = g.contiguous()
        back = torch.empty_like(g)
        net.wait(net.post(g, back, src, dst, tag))
        return back, None, None, None, None, None, None


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
    _count_exchange(x, wire)
    with obs.span("exchange.ring", wire=wire, overlap=bool(overlap),
                  depth=int(depth), subblocks=int(subblocks)):
        return _ring_transpose_impl(
            x, group, split_axis, concat_axis, pipeline_fn=pipeline_fn,
            wire=wire, overlap=overlap, depth=depth, subblocks=subblocks,
            encode_fn=encode_fn, arrive_fn=arrive_fn)


def _ring_transpose_impl(x: torch.Tensor, group, split_axis: int,
                         concat_axis: int, *, pipeline_fn: Optional[Block],
                         wire: str, overlap: bool, depth: int, subblocks: int,
                         encode_fn: Optional[Block],
                         arrive_fn: Optional[Block]) -> torch.Tensor:
    """``ring_transpose`` proper (split out so the span wraps one call)."""
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
        """A travelling block as it goes on the wire: encoded (the fused
        wire's kernel 9 where ``encode_fn`` is given), then tainted."""
        if wired:
            if encode_fn is None:
                b = wire_encode(b, wire)   # carries the wire/encode scope
            else:
                with obs.profile.wire_scope("encode"):
                    b = encode_fn(b)
        return inject.taint_wire(b, "ring").contiguous()

    # Revolving receive buffers, each the size of the largest sub-block;
    # a block that autograd tracks lands in a buffer of its own instead
    # (a later micro-step must not overwrite what its graph holds).
    w = min(depth - 1, micro) if overlap else 0
    probe = encoded(piece(1, 0))
    tracked = torch.is_grad_enabled() and x.requires_grad
    unit = probe.numel()
    bufs = [] if tracked else [
        torch.empty(unit, dtype=probe.dtype, device=x.device)
        for _ in range(min(w + 1, micro))]

    def post(m: int):
        t, j = (m - 1) // nsub + 1, (m - 1) % nsub
        send = probe if m == 1 else encoded(piece(t, j))
        recv = (bufs[m % len(bufs)][:send.numel()].view(send.shape)
                if bufs else None)
        handles = []
        recv = _RingStep.apply(send, net, (r + t) % p, (r - t) % p, m, recv,
                               handles)
        return handles[0], recv

    def arrive(b: torch.Tensor) -> torch.Tensor:
        if arrive_fn is not None:
            # The fused arrival runs under wire/decode; a family's
            # pipelined-FFT scope nested inside wins in attribution.
            with obs.profile.wire_scope("decode"):
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
