"""Kernel 7's FFT body on the row FFT engine's mixed-radix column kernel
(``fft_mixed_cols_kernel`` in ``csrc/fft_rows.cuh``, ``dfft_x_mixed`` in
``csrc/fused3d.cu``), on the CPU.

* ``fft_cols_mirror`` at a mixed length (batches of ``mixed_cols_width``
  columns, the last group of a ragged inner extent filled out, the
  engine's passes from ``fft_plan(X)``) against ``x_c2c_plain`` (kernel
  7's dense products, 1e-5: float32 on both sides, sums in another order)
  and the JAX package's ``pallas_fft._x_transform`` outside ``shard_map``
  (its Pallas kernel in interpret mode where a tile fits, its einsum past
  that; 5e-4, the JAX package's per-stage bound), both directions, at X =
  9, 12, 20, 60, 96, 120, the odd 375, 416, 440, 448, 480 and 504.
* A replay of the kernel's batch as its threads run it: the strips of W
  columns copied into the batch's buffer (float32 planes or complex64),
  stale columns past a ragged inner extent, thread t's column t mod W and
  butterflies j = jl + q T of every pass, the twiddle index stepped as the
  kernel steps it, the first pass from the strips into the work buffer
  and the next ones back and forth between the two; each pass's stores
  cover every point of its output once, and the result is
  ``fft_rows_mirror`` of the same columns (1e-6).
* The routing: ``_x_body`` for every X in 1..1100; the fused 480^3- and
  448^3-shaped plans (on "meta" tensors, the launch recorded) reach
  ``dfft_x_mixed`` in both directions on the layouts as they are (kernel
  6's planes in, complex64 out; complex64 in, kernel 8's planes out), as
  ``chip_smoke.py``'s ``FUSED_SLABS`` expects; X = 442 still reaches the
  dense ``dfft_x_c2c``.
* The host's batch width, schedule and shared memory against the kernel
  source, and a thread's registers: one butterfly of at most 16 points.
"""

import math
import pathlib
import re

import numpy as np
import pytest
import torch

from distributedfft_tpu.ops import pallas_fft
from distributedfft_tpu_torch.ops import hopper_fft as hf

CPU = torch.device("cpu")
CSRC = pathlib.Path(hf.__file__).resolve().parent.parent / "csrc"
X_MIXED = [9, 12, 20, 60, 96, 120, 375, 416, 440, 448, 480, 504]
# An H100 block's shared memory at most (232,448 bytes of the SM's 256 KB).
BLOCK_SMEM = 232448


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def _complex(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _tail_shape(X):
    """(X, Ky, 5) with Ky * 5 one group of ``mixed_cols_width(X)`` columns
    and a ragged tail of 3 to 7 more."""
    width = hf.mixed_cols_width(X)
    return (X, -(-(width + 3) // 5), 5)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("X", X_MIXED)
def test_mixed_cols_mirror_matches_x_c2c_plain_and_x_transform(X, inverse):
    """Kernel 7's body on the mixed-radix column kernel on (X, Ky, Zo)
    planes: one outer index, a ragged last group of columns."""
    shape = _tail_shape(X)
    assert shape[1] * shape[2] % hf.mixed_cols_width(X)
    c = _complex(shape, X + inverse)
    ar = torch.from_numpy(np.ascontiguousarray(c.real))
    ai = torch.from_numpy(np.ascontiguousarray(c.imag))
    got = hf.fft_cols_mirror(torch.from_numpy(c).reshape(1, X, -1), inverse)
    got = got.reshape(shape)
    assert got.dtype == torch.complex64
    pr, pi = hf.x_c2c_plain(ar, ai, *hf._planes("dft", X, inverse, CPU))
    assert _rel(got.numpy(), torch.complex(pr, pi).numpy()) <= 1e-5
    jr, ji = pallas_fft._x_transform(c.real, c.imag, inverse, frozenset())
    assert _rel(got.numpy(), np.asarray(jr) + 1j * np.asarray(ji)) <= 5e-4


def _replay(x3, inverse, planes):
    """The mixed-radix column kernel on (1, n, inner) complex64 as its
    threads run it (``fft_mixed_cols_kernel``, ``mixed_col_pass``,
    ``Columns``)."""
    _, n, inner = x3.shape
    plan = hf.fft_plan(n, inverse)
    table = torch.from_numpy(plan.table)
    w_tab = torch.complex(table[0], table[1])
    W = hf.mixed_cols_width(n)
    T = hf.COL_THREADS // W
    tid = torch.arange(hf.COL_THREADS)
    c, jl = tid % W, tid // W
    nan = complex(float("nan"), float("nan"))
    out = torch.full_like(x3, nan)
    work = torch.full((n * W,), nan, dtype=torch.complex64)
    for b in range(-(-inner // W)):
        c0 = b * W
        valid = min(W, inner - c0)
        # The strips: point-row i of the batch is W elements, the ones past
        # inner stale (NaN: nothing of them may reach a stored column).
        strips = torch.full((n, W), nan, dtype=torch.complex64)
        strips[:, :valid] = x3[0, :, c0:c0 + valid]
        mem = torch.empty(2 * n * W, dtype=torch.float32)  # the buffer
        if planes:
            mem[:n * W] = strips.real.reshape(-1)
            mem[n * W:] = strips.imag.reshape(-1)
        else:
            mem[:] = torch.view_as_real(strips).reshape(-1)
        own = torch.view_as_complex(mem.view(n * W, 2))     # float2 view

        def landed(i, cols):
            """Point i of columns cols of the landed strips."""
            if planes:
                return torch.complex(mem[i * W + cols],
                                     mem[n * W + i * W + cols])
            return own[i * W + cols]

        src, dst, ns = None, work, 1
        for R in plan.radices:
            S = n // R
            k = jl % ns
            dk = T % ns
            writes = []
            for q in range(-(-S // T)):
                j = jl + q * T
                m_ok = j < S
                c_, j_, k_ = c[m_ok], j[m_ok], k[m_ok]
                a = torch.stack([landed(j_ + m * S, c_) if src is None
                                 else src[(j_ + m * S) * W + c_]
                                 for m in range(R)])
                if ns > 1:
                    t = torch.stack([ns - plan.radices[0] + (m - 1) * ns + k_
                                     for m in range(1, R)])
                    a = torch.cat([a[:1], a[1:] * w_tab[t]])
                o = (j_ - k_) * R + k_
                writes.append((torch.stack([(o + m * ns) * W + c_
                                            for m in range(R)]),
                               hf._dft_small_mirror(a, inverse)))
                k = k + dk
                k = torch.where(k >= ns, k - ns, k)
            dest = torch.cat([d.reshape(-1) for d, _ in writes])
            assert torch.equal(torch.sort(dest).values, torch.arange(n * W))
            for d, a in writes:
                dst[d.reshape(-1)] = a.reshape(-1)
            # The barrier; the next pass reads what this one wrote and
            # writes the other buffer (the first pass's input is the
            # batch's own buffer, read whole).
            src, dst = dst, (own if dst is work else work)
            ns *= R
        out[0, :, c0:c0 + valid] = src.view(n, W)[:, :valid]
    return out


@pytest.mark.parametrize("planes", [False, True])
@pytest.mark.parametrize("X", [12, 20, 120, 375, 480, 507])
def test_replay_of_the_strip_layout_and_ping_pong_passes(X, planes):
    """The kernel's batch, thread by thread, against ``fft_rows_mirror``
    on the same columns and against ``fft_cols_mirror``."""
    W = hf.mixed_cols_width(X)
    inner = 2 * W + 5                       # two groups and a ragged one
    x3 = torch.from_numpy(_complex((1, X, inner), X + planes))
    for inverse in (False, True):
        got = _replay(x3, inverse, planes)
        want = hf.fft_rows_mirror(x3[0].T, inverse).T[None]
        assert not torch.isnan(got).any()
        assert _rel(got.numpy(), want.numpy()) <= 1e-6
        assert _rel(got.numpy(), hf.fft_cols_mirror(x3, inverse).numpy()) \
            <= 1e-6


def test_x_body_routing_at_every_length():
    """``_x_body`` is "fft" for the powers of two in [8, 512] and the
    ``MIXED_LENGTHS``, "dense" for a prime factor past 13 or X < 8; the
    column kernel takes the one, the mixed-radix column kernel the
    other."""
    for X in range(1, 1100):
        pow2 = 8 <= X <= 512 and X & (X - 1) == 0
        smooth = 8 <= X <= 512 and hf._smooth(X, (2, 3, 5, 7, 11, 13))
        assert hf._x_body(X) == ("fft" if smooth else "dense"), X
        assert (X in hf.MIXED_LENGTHS) == (smooth and not pow2), X
    with pytest.raises(ValueError):
        hf.mixed_cols_width(512)
    with pytest.raises(ValueError):
        hf.mixed_cols_width(442)


def _record_launches(monkeypatch):
    """Make every wrapper take its CUDA route, recording each launch as
    (counter, C entry point, arguments) instead of running it (meta tensors
    allocate nothing)."""
    log = []
    for name in ("_check_rows", "_check", "_check_cols", "_check_short",
                 "_check_tw_cols"):
        monkeypatch.setattr(hf, name, lambda *a, **k: False)
    monkeypatch.setattr(hf, "_launch", lambda kernel, fn, *args:
                        log.append((kernel, fn, args)))
    return log


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("pid", ["fused_480", "fused_448"])
def test_fused_slab_plans_reach_the_mixed_column_kernel(monkeypatch, pid):
    """The "pallas" 480^3 and 448^3 P = 1 slab plans (ZY_Then_X, the fused
    path) on "meta" tensors: kernel 7 launches ``dfft_x_mixed`` once a
    direction, on kernel 6's planes with a complex64 spectrum out (the
    forward) and on the spectrum with kernel 8's planes out (the inverse),
    with ``fft_plan``'s table and ``mixed_cols_schedule``; the launches and
    entries ``chip_smoke.py`` counts for the plan."""
    smoke = _chip_smoke()
    from distributedfft_tpu_torch import Config, GlobalSize, SlabFFTPlan
    from distributedfft_tpu_torch import SlabPartition
    shape, (want_f, want_i, ent_f, ent_i) = smoke.FUSED_SLABS[pid]
    X, Y, Z = shape
    log = _record_launches(monkeypatch)
    plan = SlabFFTPlan(GlobalSize(*shape), SlabPartition(1),
                       Config(fft_backend="pallas"), device="cpu")
    c = plan._build_r2c()(torch.zeros(shape, device="meta"))
    fwd = list(log)
    del log[:]
    back = plan._build_c2r()(c)
    inv = list(log)
    assert c.shape == (X, Y, Z // 2 + 1) and back.shape == shape
    for got, launches, entries, inverse in ((fwd, want_f, ent_f, False),
                                            (inv, want_i, ent_i, True)):
        (args,) = [a for k, e, a in got if e == "dfft_x_mixed"]
        ar, ai, table, zr, zi = args[:5]
        if inverse:     # the spectrum in, kernel 8's planes out
            assert ar.dtype == torch.complex64 and ai is None
            assert zr.dtype == zi.dtype == torch.float32
        else:           # kernel 6's planes in, the spectrum out
            assert ar.dtype == ai.dtype == torch.float32
            assert zr.dtype == torch.complex64 and zi is None
        assert ar.shape == (X, Y, Z // 2 + 1)
        assert table is hf._fft_table(X, inverse, torch.device("meta"))
        assert args[5:] == (X, Y * (Z // 2 + 1),
                            hf.mixed_cols_schedule(X, inverse), int(inverse))
        per_kernel, per_entry = {}, {}
        for k, e, _ in got:
            per_kernel[k] = per_kernel.get(k, 0) + 1
            per_entry[e] = per_entry.get(e, 0) + 1
        assert per_kernel == launches and per_entry == entries
        assert "dfft_x_c2c" not in per_entry


@pytest.mark.parametrize("shape, entry", [
    ((442, 16, 16), "dfft_x_c2c"), ((6, 12, 15), "dfft_x_c2c"),
    ((480, 16, 16), "dfft_x_mixed"), ((375, 6, 10), "dfft_x_mixed"),
    ((512, 16, 16), "dfft_x_cols")])
def test_x_cols_entry_by_length(monkeypatch, shape, entry):
    """Both layout pairs of ``x_cols`` launch one entry a call: the dense
    kernel at a factor past 13 (442 = 2 x 13 x 17) or X < 8, the
    mixed-radix column kernel at a mixed length, the column kernel at a
    power of two; no split or join copy around the column kernels."""
    log = _record_launches(monkeypatch)
    ar = torch.zeros(shape, device="meta")
    ai = torch.zeros(shape, device="meta")
    z = hf.x_cols((ar, ai), False, complex_out=True)
    zr, zi = hf.x_cols(z, True, complex_out=False)
    assert [e for _, e, _ in log] == [entry, entry]
    if entry != "dfft_x_c2c":
        (fa, fb, _, fz, fn), (ia, ib, _, ir, ii) = (a[:5] for _, _, a in log)
        assert fa is ar and fb is ai and fz is z and fn is None
        assert ia is z and ib is None and ir is zr and ii is zi


def test_host_arithmetic_agrees_with_the_kernel_source():
    """``mixed_cols_width`` and ``mixed_cols_schedule`` are what
    ``col_plan`` in fft_rows.cuh admits; with them every mixed length's
    block (``mixed_cols_smem``: the ring's barriers, the table's two
    planes, two input buffers and the work buffer) fits an H100's 227 KB;
    a thread of ``mixed_col_pass`` holds one butterfly of at most 16
    points (the largest of ``MIXED_RADICES``); ``dfft_x_mixed`` launches
    the kernel with the signature ``_ENTRIES`` gives it."""
    src = (CSRC / "fft_rows.cuh").read_text()
    fused = (CSRC / "fused3d.cu").read_text()

    def const(name):
        return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)

    assert int(const("COL_THREADS")) == hf.COL_THREADS == 512
    assert int(const("MIXED_COL_STAGES")) == 2
    assert const("COL_POINTS").split("//")[0].strip() == "16 * COL_THREADS"
    assert hf.COL_POINTS == 16 * hf.COL_THREADS
    smem = re.search(r"inline size_t mixed_cols_smem\(const ColPlan& g\) "
                     r"\{(.*?)\n\}", src, re.S).group(1)
    assert re.sub(r"\s+", " ", smem).strip() == (
        "return 128 + 8 * (size_t)g.tld + (MIXED_COL_STAGES + 1) * 8 * "
        "(size_t)g.n * g.width;")
    plan = re.search(r"inline bool col_plan\(int n, int schedule, ColPlan& g\)"
                     r" \{(.*?)\n\}", src, re.S).group(1)
    plan = re.sub(r"\s+", " ", plan)
    assert "const int w = schedule >> MIXED_ROWS_SHIFT;" in plan
    assert ("if (w < 16 || w > COL_THREADS || (w & (w - 1)) || w * n > "
            "COL_POINTS) return false;") in plan
    assert "g.tld = (n - radix[0] + 3) & ~3;" in plan
    assert ("g.radices = schedule & ((1 << MIXED_ROWS_SHIFT) - 1);"
            in plan)
    kernel = src[src.index("void mixed_col_pass("):]
    kernel = kernel[:kernel.index("\n}\n")]
    assert "float2 a[R];" in kernel and max(hf.MIXED_RADICES) == 16
    for n in hf.MIXED_LENGTHS:
        W = hf.mixed_cols_width(n)
        assert 16 <= W <= hf.COL_THREADS and W & (W - 1) == 0
        assert W * n <= hf.COL_POINTS < 2 * W * n or W == hf.COL_THREADS
        assert W == 16 or n <= 256
        r0 = hf.fft_plan(n, False).radices[0]
        assert 128 + 8 * ((n - r0 + 3) & ~3) + 3 * 8 * n * W <= BLOCK_SMEM
        radices = hf.fft_plan(n, False).radices
        for inverse in (False, True):
            s = hf.mixed_cols_schedule(n, inverse)
            assert s >> hf.MIXED_ROWS_SHIFT == W
            assert s & ((1 << hf.MIXED_ROWS_SHIFT) - 1) == \
                hf.fft_plan(n, inverse).schedule
            assert math.prod(radices) == n
    # The entry: five pointers, four ints, the stream; the mixed-radix
    # column kernel on Columns.
    sig = re.search(r"int dfft_x_mixed\((.*?)\) \{", fused, re.S).group(1)
    args = [a.strip() for a in sig.split(",")]
    assert sum("*" in a for a in args[:-1]) == 5
    assert sum(a.startswith("int ") for a in args) == 4
    assert args[-1] == "void* stream"
    assert hf._ENTRIES["dfft_x_mixed"] == ("fused3d", (5, 4))
    entry = fused[fused.index("int dfft_x_mixed("):]
    entry = entry[:entry.index("\n}\n")]
    assert "fft_rows::Columns body{ar, ai, zr, zi, 1, X, inner};" in entry
    assert "fft_rows::launch_mixed_cols(X, schedule, body, table" in entry
