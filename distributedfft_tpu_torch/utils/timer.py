"""Named-phase benchmark timer with the reference's CSV schema — the port's
copy of the JAX package's ``utils/timer.py``.

The reference's ``Timer`` (``include/timer.hpp:25-51``, ``src/timer.cpp``)
stores, per pipeline phase, the elapsed ms since ``start()`` (cumulative
timeline marks, not deltas), gathers every rank's values to rank 0 and
appends one CSV block per iteration: a one-time header row ``,0,1,...,P-1,``
then one row per section ``desc,v0,v1,...,`` (``src/timer.cpp:58-102``),
under a deterministic file name
``<benchmark_dir>/<variant>/test_<opt>_<comm>_<snd>_<Nx>_<Ny>_<Nz>_<cuda>_<P>.csv``
(``src/slab/default/mpicufft_slab.cpp:99-103``). The bytes written are the
JAX package's Python writer's, so ``evalkit/evaluate.py`` reads either.

Each rank of the port is one process driving one device. A mark is taken
on the host clock (``time.perf_counter``) after a fence: on a CUDA device
``torch.cuda.synchronize(device)``, on the CPU nothing (the work is done
when the call returns). In a ``torch.distributed`` world ``gather()``
all-gathers every rank's duration vector, so each rank column carries the
value that rank measured; rank 0 alone writes, after every rank has reached
the collective.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..params import CommMethod, Config, GlobalSize, SendMethod

_COMM_CODE = {CommMethod.PEER2PEER: 0, CommMethod.ALL2ALL: 1}
# 0-2 are the reference's send codes (params.hpp:87-89); 3 and 4 extend the
# file-name schema for the rings, as in the JAX package.
_SEND_CODE = {SendMethod.SYNC: 0, SendMethod.STREAMS: 1,
              SendMethod.MPI_TYPE: 2, SendMethod.RING: 3,
              SendMethod.RING_OVERLAP: 4}
# The native wire keeps the reference's file name; a compressed wire
# appends ``_w<code>``, so its runs never land in the native runs' CSV.
_WIRE_CODE = {"native": 0, "bf16": 1}


def _wire_suffix(config: Config) -> str:
    code = _WIRE_CODE[config.wire_dtype]   # KeyError on an unresolved "auto"
    return "" if code == 0 else f"_w{code}"


def _overlap_suffix(config: Config) -> str:
    """``_d<depth>`` for a RING_OVERLAP depth other than 2 and ``_s<k>``
    for a sub-block split: the shipped schedules keep the legacy name."""
    tag = ""
    if config.send_method is SendMethod.RING_OVERLAP:
        depth = config.resolved_overlap_depth()
        if depth != 2:
            tag += f"_d{depth}"
    subs = config.resolved_overlap_subblocks()
    if subs > 1:
        tag += f"_s{subs}"
    return tag


def benchmark_filename(benchmark_dir: str, variant: str, config: Config,
                       global_size: GlobalSize, pcnt: int,
                       pencil_grid=None) -> str:
    """The reference's CSV path of a slab run
    (``mpicufft_slab.cpp:99-103``):
    ``test_<opt>_<comm>_<snd>_<Nx>_<Ny>_<Nz>_<cuda>_<P>.csv`` with the
    overlap and wire suffixes; a pencil run (``pencil_grid=(p1, p2)``)
    adds the second transpose's methods and the grid
    (``mpicufft_pencil.cpp:69-71``):
    ``test_<opt>_<comm1>_<snd1>_<comm2>_<snd2>_<Nx>_<Ny>_<Nz>_<cuda>_<P1>_<P2>.csv``."""
    comm = _COMM_CODE[config.comm_method]
    snd = _SEND_CODE[config.send_method]
    cuda = 1 if config.cuda_aware else 0
    suffix = _overlap_suffix(config) + _wire_suffix(config)
    g = global_size
    d = os.path.join(benchmark_dir, variant)
    if pencil_grid is not None:
        comm2 = _COMM_CODE[config.resolved_comm2()]
        snd2 = _SEND_CODE[config.resolved_snd2()]
        p1, p2 = pencil_grid
        return os.path.join(
            d, f"test_{config.opt}_{comm}_{snd}_{comm2}_{snd2}"
               f"_{g.nx}_{g.ny}_{g.nz}_{cuda}_{p1}_{p2}{suffix}.csv")
    return os.path.join(
        d, f"test_{config.opt}_{comm}_{snd}_{g.nx}_{g.ny}_{g.nz}_{cuda}"
           f"_{pcnt}{suffix}.csv")


def _all_gather_rows(values: Sequence[float],
                     device: torch.device) -> List[List[float]]:
    """Every rank's duration vector, in rank order. The tensor lives on
    ``device`` under NCCL (which carries CUDA tensors only) and on the CPU
    otherwise."""
    if dist.get_backend() != dist.Backend.NCCL:
        device = torch.device("cpu")
    mine = torch.tensor(list(values), dtype=torch.float64, device=device)
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, mine)
    return [p.cpu().tolist() for p in parts]


class Timer:
    """Phase timer: ``start()`` -> ``stop_store(desc)`` marks -> ``gather()``
    appends one CSV block.

    ``device`` is what the fences wait for (a CUDA device: its
    synchronize; the CPU: nothing). ``num_processes`` > 1 makes ``gather()``
    a collective over the ``torch.distributed`` world (every rank must call
    it; process 0 writes); ``allgather_fn(values) -> rows`` replaces that
    collective (tests inject one)."""

    def __init__(self, descs: Sequence[str], pcnt: int,
                 filename: Optional[str], process_index: int = 0,
                 num_processes: int = 1,
                 allgather_fn: Optional[Callable] = None,
                 device: "str | torch.device" = "cpu"):
        self.descs = list(descs)
        self.pcnt = pcnt
        self.filename = filename
        self.process_index = process_index
        self.num_processes = num_processes
        self.allgather_fn = allgather_fn
        self.device = torch.device(device)
        self._tstart = 0.0
        self._durations: Dict[str, float] = {}

    def fence(self) -> None:
        """Wait until the device has finished the work queued so far."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self._durations.clear()
        self.fence()
        self._tstart = time.perf_counter()

    def stop_store(self, desc: str) -> float:
        """Record 'elapsed ms since start()' for the named phase, after the
        fence (the reference's ``store()``, ``src/timer.cpp:41-56``)."""
        if desc not in self.descs:
            raise ValueError(f"unknown timer section {desc!r}; "
                             f"known: {self.descs}")
        self.fence()
        ms = (time.perf_counter() - self._tstart) * 1e3
        self._durations[desc] = ms
        return ms

    def _rank_columns(self) -> List[List[float]]:
        """All-gather every process's duration vector and give each rank
        column its own process's value: a collective."""
        values = [self._durations.get(d, 0.0) for d in self.descs]
        if self.allgather_fn is not None:
            rows = self.allgather_fn(values)
        else:
            rows = _all_gather_rows(values, self.device)
        if len(rows) != self.num_processes or \
                any(len(r) != len(values) for r in rows):
            raise ValueError(
                f"allgather returned {len(rows)} rows, expected "
                f"{self.num_processes} of {len(values)}")
        return [[float(rows[r * self.num_processes // self.pcnt][s])
                 for r in range(self.pcnt)]
                for s in range(len(values))]

    def gather(self) -> None:
        """Append one CSV block: the header once, then a blank line and one
        ``desc,v0,...,v{P-1},`` row per section (0 for a section never
        stopped, as in the reference). With more than one process the
        values are all-gathered first (every process reaches that
        collective; only process 0 writes)."""
        cols = self._rank_columns() if self.num_processes > 1 else None
        if self.filename is None or self.process_index != 0:
            return
        os.makedirs(os.path.dirname(self.filename) or ".", exist_ok=True)
        fresh = not os.path.exists(self.filename)
        with open(self.filename, "a") as f:
            if fresh:
                f.write("," + ",".join(str(i) for i in range(self.pcnt)) + ",")
            f.write("\n")
            for i, desc in enumerate(self.descs):
                if cols is None:
                    v = self._durations.get(desc, 0.0)
                    row = ",".join(repr(v) for _ in range(self.pcnt))
                else:
                    row = ",".join(repr(v) for v in cols[i])
                f.write(f"{desc},{row},\n")


def read_timer_csv(path: str) -> List[Dict[str, List[float]]]:
    """Parse a Timer CSV into its iteration blocks (section -> per-rank
    values)."""
    blocks: List[Dict[str, List[float]]] = []
    cur: Optional[Dict[str, List[float]]] = None
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f]
    for ln in lines[1:]:  # skip the header
        if not ln.strip(","):
            cur = None    # a blank line separates iteration blocks
            continue
        parts = ln.split(",")
        desc = parts[0]
        vals = [float(v) for v in parts[1:] if v != ""]
        if cur is None or desc in cur:
            cur = {}
            blocks.append(cur)
        cur[desc] = vals
    return blocks
