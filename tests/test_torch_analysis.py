"""The port's static analysis (``distributedfft_tpu_torch/analysis/``)
on the CPU, against the JAX package's ``analysis/`` where the two compare
through declared objects: the schedule checker (``schedverify``) and the
payload arithmetic (``predicted_payload_bytes``).

One 4-rank gloo world is spawned for the whole file (a module fixture).
Inside it each rank runs ``dfft-torch-verify`` (the world joined, each
rank runs the body itself): ``--quick``, a bf16-wire slice of the matrix,
``--mutate all`` and one mutation alone; the op traces of a few plans
(census, payload); and ``wire_probe`` / ``overlap_race``. The rest runs in
this process: the order the port's ring posts, waits and computes held
against ``revolving_schedule`` (the ring's transport replaced by a
recording one), the op recorder's kernel-launch hook, the op lints and
the contract algebra on synthetic inputs, and the source lints.

JAX is compared only through declared objects — never ``lower_plan``,
``verify_plan`` or ``lint_plan``, whose compiled-module pins depend on
what else ran in the process."""

import json
import os
import pickle
import sys
import traceback

import numpy as np
import pytest
import torch

from distributedfft_tpu_torch.analysis import (contracts, oplint, opscan,
                                               schedverify, srclint, verify)
from distributedfft_tpu_torch.parallel import multihost

P = 4
FORBIDDEN = ("jax", "jaxlib", "distributedfft_tpu")
WIRE16_SLICE = ["--families", "slab,pencil,batched", "--wires", "bf16",
                "--renderings", "a2a,p2p,ring_ovl,fused,a2a_pipe,streams",
                "--guards", "off,check", "--no-pins", "--no-srclint"]


# ---------------------------------------------------------------------------
# the world (no JAX here)
# ---------------------------------------------------------------------------

def _verify(argv, outdir, name):
    import contextlib
    import io
    path = os.path.join(outdir, f"{name}.json")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = verify.main(argv + ["--emulate-devices", str(P)]
                         + (["--json", path] if "--mutate" not in argv
                            else []))
    report = None
    if os.path.exists(path):
        with open(path, encoding="utf-8") as f:
            report = json.load(f)
    return {"rc": rc, "text": buf.getvalue(), "report": report}


def _traces():
    """Census and payload of a few plans, and what the contracts say."""
    out = {}
    for name, (rendering, wire) in {
            "a2a": ("a2a", "native"), "p2p": ("p2p", "native"),
            "ring_sub2": ("ring_sub2", "native"),
            "a2a_pipe": ("a2a_pipe", "native"),
            "streams": ("streams", "native"),
            "fused16": ("fused", "bf16")}.items():
        plan, dims = verify._make_plan("slab", rendering, wire, "off",
                                       "ZY_Then_X", P, device="cpu")
        tr = opscan.record_plan(plan, "forward", dims)
        out[name] = {
            "census": opscan.collective_census(tr),
            "payload": opscan.staged_exchange_total(tr, P),
            "predicted": sum(r.value for r in contracts.contract_for(
                plan, "forward", dims).rules if r.kind == "payload"),
            "violations": [str(v) for v in contracts.verify_plan(
                plan, "forward", dims, trace=tr)],
            "bf16": opscan.contains_bf16(tr),
            "fingerprint": opscan.op_graph_fingerprint(tr),
            "fingerprint_again": opscan.plan_fingerprint(plan, "forward",
                                                         dims),
        }
    return out


def _mutations():
    return {name: verify.run_mutation(name, P, device="cpu")
            for name in verify.MUTATIONS}


def _microbench():
    from distributedfft_tpu_torch.testing import microbench as mb
    window, info = mb.wire_probe((32, 8, 8), P, device="cpu")
    race = mb.overlap_race((16, 16, 16), P, chunk_counts=(2,), k=2,
                           repeats=2, iterations=1, device="cpu")
    return {"info": info, "window_s": window(2, 1), "race": race}


def _rank_main(rank, addr, outdir):
    multihost.maybe_initialize(addr, P, rank, backend="gloo", timeout_s=180)
    torch.set_num_threads(1)
    results = {}
    for name, fn in (
            ("quick", lambda: _verify(["--quick"], outdir, "quick")),
            ("wire16", lambda: _verify(WIRE16_SLICE, outdir, "wire16")),
            ("mutate_all", lambda: _verify(["--mutate", "all"], outdir,
                                           "mutate_all")),
            ("mutate_one", lambda: _verify(["--mutate", "bogus-census"],
                                           outdir, "mutate_one")),
            ("mutations", _mutations),
            ("traces", _traces),
            ("microbench", _microbench)):
        try:
            results[name] = fn()
        except Exception:  # noqa: BLE001 — reported by that case's test
            results[name] = {"error": traceback.format_exc()}
    results["modules"] = sorted(m for m in sys.modules
                                if m.split(".")[0] in FORBIDDEN)
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    multihost.shutdown()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("analysis")
    torch.multiprocessing.start_processes(
        _rank_main, args=(multihost.local_coordinator(), str(outdir)),
        nprocs=P, start_method="spawn")
    out = []
    for r in range(P):
        with open(outdir / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _result(world, rank, key):
    res = world[rank][key]
    if isinstance(res, dict) and "error" in res:
        pytest.fail(f"rank {rank} failed {key}:\n{res['error']}")
    return res


def test_ranks_import_no_jax(world):
    assert all(w["modules"] == [] for w in world)


def test_verify_quick_exits_zero(world):
    """``dfft-torch-verify --quick --emulate-devices 4``: every combo of
    the three families (native wire, guards off, forward), the pins, the
    schedule sweep and the source lints pass; the report carries JAX's
    keys and every rank exits 0."""
    res = [_result(world, r, "quick") for r in range(P)]
    assert all(x["rc"] == 0 for x in res), res[0]["text"]
    rep = res[0]["report"]
    assert {"combos", "pins", "sched", "srclint", "failures",
            "ok"} <= set(rep)
    assert rep["ok"] and rep["failures"] == 0 and rep["srclint"] == []
    assert len(rep["combos"]) == 3 * 11 + 3
    assert len(rep["pins"]) == 3 * 4 and all(p["ok"] for p in rep["pins"])
    assert {(s["p"], s["depth"], s["subblocks"]) for s in rep["sched"]} == {
        (1, 1, 1), (P, 1, 1)} | {(P, d, s) for d in (2, 4, 8)
                                 for s in (1, 2)}
    assert "-> PASS" in res[0]["text"]


def test_verify_quick_combos_hold_their_census(world):
    """The rendering algebra as the quick matrix recorded it: one
    all-to-all (a2a, opt 1), K pieces (STREAMS: 3, the pipelined one's
    asynchronous), (P-1)·S point-to-point messages on the rings, exactly
    P-1 on Peer2Peer, nothing on the no-exchange combos."""
    rep = _result(world, 0, "quick")["report"]
    by = {(c["family"], c["rendering"]):
          {k: v for k, v in c["census"].items() if k != "convert"}
          for c in rep["combos"]}
    for fam in ("slab", "batched"):
        assert by[fam, "a2a"] == {"all_to_all": 1}
        assert by[fam, "opt1"] == {"all_to_all": 1}
        assert by[fam, "streams"] == {"all_to_all": 3}
        assert by[fam, "a2a_pipe"] == {"all_to_all_start": 2,
                                       "async_total": 2}
        assert by[fam, "p2p"] == {"send": P - 1, "recv": P - 1}
        assert by[fam, "ring"] == {"send": P - 1, "recv": P - 1}
        assert by[fam, "ring_sub2"] == {"send": 2 * (P - 1),
                                        "recv": 2 * (P - 1)}
    # the 2 x 2 pencil: two exchanges over groups of 2
    assert by["pencil", "a2a"] == {"all_to_all": 2}
    assert by["pencil", "ring"] == {"send": 2, "recv": 2}
    assert by["slab", "none"] == {} and by["batched", "none"] == {}
    assert by["slab", "bluestn"] == {"all_to_all": 1}


def test_verify_wire16_slice_exits_zero(world):
    """The bf16 wire (with guards off and check) over the three families:
    the pairing lints, the bf16 payloads and the guards' drift probe."""
    res = _result(world, 0, "wire16")
    assert res["rc"] == 0, res["text"]
    assert len(res["report"]["combos"]) == 3 * 6 * 2 * 2 + 3


def test_verify_mutate_all_exits_zero(world):
    res = [_result(world, r, "mutate_all") for r in range(P)]
    assert all(x["rc"] == 0 for x in res), res[0]["text"]
    assert "mutation self-test: PASS" in res[0]["text"]


def test_single_mutation_fails_the_run(world):
    res = _result(world, 0, "mutate_one")
    assert res["rc"] == 1 and "CAUGHT" in res["text"]


@pytest.mark.parametrize("name", verify.MUTATIONS)
def test_each_mutation_is_caught_and_named(world, name):
    res = _result(world, 0, "mutations")[name]
    assert res["violations"], name
    assert any(res["expect"] in v for v in res["violations"]), res


@pytest.mark.parametrize("name", ["a2a", "p2p", "ring_sub2", "a2a_pipe",
                                  "streams", "fused16"])
def test_trace_payload_reconciles(world, name):
    """The exchange bytes the trace recorded (this rank's c10d inputs,
    times the ranks) equal the contract's prediction: the whole payload
    for the all-to-all forms, the (P-1)/P share for the point-to-point
    ones; the native wire touches no bfloat16 tensor; a re-recording has
    the same fingerprint."""
    for r in range(P):
        t = _result(world, r, "traces")[name]
        assert t["violations"] == []
        assert t["payload"] == t["predicted"] > 0
        assert t["bf16"] == (name == "fused16")
        assert t["fingerprint"] == t["fingerprint_again"]


def test_async_all_to_all_counts_under_start(world):
    t = _result(world, 0, "traces")
    assert t["a2a_pipe"]["census"]["all_to_all_start"] == 2
    assert t["a2a_pipe"]["census"]["all_to_all"] == 0
    assert t["a2a"]["census"]["all_to_all"] == 1
    assert t["a2a"]["census"]["all_to_all_start"] == 0


def test_wire_probe_and_overlap_race(world):
    mbr = _result(world, 0, "microbench")
    assert mbr["info"] == {"bytes": 32 * 8 * 8 * 4,
                           "collective_ops": ["all_to_all"]}
    assert mbr["window_s"] > 0
    race = mbr["race"]
    assert set(race["variants"]) == {"sync", "streams2", "ring",
                                     "ring-overlap"}
    ops = {k: v["ops"] for k, v in race["variants"].items()}
    # one roundtrip: two exchanges each
    assert ops["sync"]["all_to_all"] == 2
    assert ops["streams2"]["all_to_all"] == 4
    assert ops["ring"]["send"] == ops["ring-overlap"]["send"] == 2 * (P - 1)


# ---------------------------------------------------------------------------
# schedules: the JAX checker's output, and the order the port's ring issues
# ---------------------------------------------------------------------------

def _ops(sched):
    return [(o.op, o.step, o.buf) for o in sched]


@pytest.mark.parametrize("p", range(2, 9))
def test_schedverify_matches_jax(p):
    from distributedfft_tpu.analysis import schedverify as jsv
    for depth in (1, 2, 4, 8):
        for sub in (1, 2):
            mine = schedverify.revolving_schedule(p, depth, sub)
            theirs = jsv.revolving_schedule(p, depth, sub)
            assert _ops(mine) == _ops(theirs)
            assert schedverify.check_schedule(mine, p, depth, sub) == []
            d_mine = schedverify.describe(p, depth, (8 * p, 4, 6),
                                          np.complex64, "bf16", sub)
            d_theirs = jsv.describe(p, depth, (8 * p, 4, 6), np.complex64,
                                    "bf16", sub)
            assert d_mine == d_theirs
            if p >= 3:
                for kind in schedverify.HAZARD_KINDS:
                    bad_m = schedverify.mutated_schedule(kind, p, depth, sub)
                    bad_t = jsv.mutated_schedule(kind, p, depth, sub)
                    assert _ops(bad_m) == _ops(bad_t)
                    hm = [str(h) for h in schedverify.check_schedule(
                        bad_m, p, depth, sub)]
                    ht = [str(h) for h in jsv.check_schedule(
                        bad_t, p, depth, sub)]
                    assert hm == ht
                    # At depth 1 every issue lands in buffer 0 anyway.
                    if depth > 1 or kind != "write-after-send":
                        assert any(kind in h for h in hm), (kind, depth)
    assert schedverify.verify_shipped_depths(p) == \
        jsv.verify_shipped_depths(p)


class _RecordingTransport:
    """A ring transport that moves nothing and logs the issue order: each
    post as ``issue`` into the buffer it lands in (numbered by first use),
    each wait."""

    def __init__(self, log):
        self.log = log
        self.bufs = {}

    def __call__(self, group, device):
        return self

    def post(self, send, recv, dst, src, tag):
        ptr = recv.untyped_storage().data_ptr()
        buf = self.bufs.setdefault(ptr, len(self.bufs))
        self.log.append(("issue", tag, buf))
        return tag

    def wait(self, handle):
        self.log.append(("wait", handle, -1))


@pytest.mark.parametrize("depth", (1, 2, 4, 8))
@pytest.mark.parametrize("sub", (1, 2))
def test_ring_issue_order_is_the_revolving_schedule(monkeypatch, depth,
                                                    sub):
    """The order in which the port's ring (``_ring_transpose_impl``) posts
    its micro-steps, waits on them and computes the arrived blocks equals
    ``revolving_schedule(p, depth, sub)`` — buffers included — for every
    ring size 2..8, and checks hazard-free."""
    from distributedfft_tpu_torch.parallel import transpose as tr
    for p in range(2, 9):
        log = []
        monkeypatch.setattr(tr.dist, "get_world_size", lambda g=None: p)
        monkeypatch.setattr(tr.dist, "get_rank", lambda g=None: 1 % p)
        monkeypatch.setattr(tr, "_Transport", _RecordingTransport(log))
        x = torch.zeros(4 * p, 8, 3)
        step = [0]

        def pipe(b, x=x, log=log, step=step):
            if b.untyped_storage().data_ptr() != \
                    x.untyped_storage().data_ptr():
                step[0] += 1
                log.append(("compute", step[0], -1))
            return b

        with torch.no_grad():
            tr._ring_transpose_impl(
                x, None, 0, 1, pipeline_fn=pipe, wire="native",
                overlap=depth > 1, depth=depth, subblocks=sub,
                encode_fn=None, arrive_fn=None)
        want = schedverify.revolving_schedule(p, depth, sub)
        assert log == _ops(want), (p, depth, sub)
        assert schedverify.check_schedule(
            [schedverify.SchedOp(*o) for o in log], p, depth, sub) == []


# ---------------------------------------------------------------------------
# the recorder, the lints and the contract algebra on synthetic inputs
# ---------------------------------------------------------------------------

def test_recorder_sees_kernel_launches(monkeypatch):
    """A ctypes kernel launch dispatches no op; the recorder appends each
    ``hopper_fft._launch`` as ``kernel.<entry>`` through the launch hook,
    in order with the ops around it, and the hook list is empty again
    after recording (no cost outside a recorder)."""
    from distributedfft_tpu_torch.ops import hopper_fft as hf

    class _Lib:
        def __getattr__(self, fn):
            return lambda *a: 0

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(hf._build, "load", lambda name, sigs: _Lib())
    monkeypatch.setattr(hf._build, "check", lambda lib, fn, rc: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: _Stream())
    before = dict(hf.LAUNCHES)
    x = torch.ones(4, 8)

    def run(v):
        y = v * 2
        hf._launch("cmatmul", "dfft_cdft", y, 8)
        return y + 1

    tr = opscan.record(run, x)
    names = [o.name for o in tr.ops]
    k = names.index("kernel.dfft_cdft")
    assert "mul" in names[k - 1] and "add" in names[k + 1]
    op = tr.ops[k]
    assert op.label == "cmatmul" and op.in_shapes == ((4, 8),)
    assert op.where.startswith("tests/") or op.where == "" or \
        op.where.endswith(":run")
    assert tr.kernels() == {"dfft_cdft": 1}
    assert hf.LAUNCH_HOOKS == []
    hf.LAUNCHES.clear()
    hf.LAUNCHES.update(before)


def _synthetic(ops, out_dtypes=("torch.complex64",)):
    return opscan.OpTrace(tuple(ops), tuple(out_dtypes))


def _conv(src, dst):
    return opscan.Op("aten._to_copy.default", ((2, 4),), (src,), ((2, 4),),
                     (dst,))


F32, F64, B16 = "torch.float32", "torch.float64", opscan.BF16


@pytest.mark.parametrize("case,expect", [
    ("paired", []),
    ("dropped", ["unpaired wire_encode/wire_decode"]),
    ("leak", ["leaked out undecoded"]),
    ("drift", ["dtype drift across the exchange"]),
    ("native", ["0 wire crossings expected"]),
    ("unencoded", ["travelling unencoded"]),
])
def test_wire_pairing_lint(case, expect):
    enc, dec = _conv(F32, B16), _conv(B16, F32)
    traces = {
        "paired": (_synthetic([enc, dec]), 1),
        "dropped": (_synthetic([enc]), 1),
        "leak": (_synthetic([enc, dec], (B16,)), 1),
        "drift": (_synthetic([_conv(F64, B16), _conv(B16, F32)]), 1),
        "native": (_synthetic([enc, dec]), 0),
        "unencoded": (_synthetic([enc, dec]), 2),
    }
    trace, crossings = traces[case]
    got = [str(f) for f in oplint.lint_wire_pairing(trace, crossings)]
    for e in expect:
        assert any(e in g for g in got), got
    if not expect:
        assert got == []


def test_wire_kernels_count_as_crossings():
    tr = _synthetic([opscan.Op("kernel.dfft_enc_pack"),
                     opscan.Op("kernel.dfft_dec_cmatmul")])
    assert oplint.lint_wire_pairing(tr, 1) == []


def test_guard_ops_lint():
    g = opscan.Op("aten.sum.default", where="resilience/guards.py:_energy")
    plain = opscan.Op("aten.mul.Tensor", where="ops/fft.py:fft")
    assert oplint.lint_guard_ops(_synthetic([plain]), "off") == []
    assert "guard-off" in str(oplint.lint_guard_ops(_synthetic([plain, g]),
                                                    "off")[0])
    assert "guard-arity" in str(oplint.lint_guard_ops(_synthetic([plain]),
                                                      "check")[0])
    assert oplint.lint_guard_ops(_synthetic([g]), "enforce") == []


def test_exchange_dtype_lint():
    ok = opscan.Op("c10d.send.default", ((8,),), ("torch.uint8",))
    bad = opscan.Op("c10d.alltoall_base_.default", ((8,), (8,)),
                    ("torch.uint8", "torch.float32"))
    assert oplint.lint_exchange_dtypes(_synthetic([ok])) == []
    assert "retypes" in str(oplint.lint_exchange_dtypes(
        _synthetic([bad]))[0])


def _rules(decls, wire="native", guards="off"):
    c = contracts.contract_from_decls("slab", "forward", wire, guards,
                                      np.complex64, tuple(decls))
    return {(r.kind, r.op): (r.cmp, r.value) for r in c.rules}


def test_rendering_algebra():
    """The docstring's table: the rule each rendering adds."""
    shape = (8, 16, 9)
    d = contracts.ExchangeDecl
    full = 8 * 16 * 9 * 8
    a2a = _rules([d("t", shape, 4, "a2a")])
    assert a2a[("census", "all_to_all")] == ("==", 1)
    assert a2a[("census", "send")] == ("==", 0)
    assert a2a[("payload", "exchange")] == ("==", full)
    assert a2a[("forbid", "bf16")] == ("==", 0)
    for r in ("streams", "a2a_pipe"):
        assert _rules([d("t", shape, 4, r, chunks=3)])[
            ("census", "all_to_all")] == ("==", 3)
    ring = _rules([d("t", shape, 4, "ring_overlap", subblocks=2)])
    assert ring[("census", "send")] == (">=", 6)
    assert ring[("census", "recv")] == (">=", 6)
    assert ring[("census", "all_to_all")] == ("==", 0)
    assert ring[("payload", "exchange")] == ("==", full * 3 // 4)
    p2p = _rules([d("t", shape, 4, "p2p")])
    assert p2p[("census", "send")] == ("==", 3)
    assert p2p[("census", "recv")] == ("==", 3)
    assert p2p[("payload", "exchange")] == ("==", full * 3 // 4)
    none = _rules([])
    assert none[("census", "all_reduce")] == ("==", 0)
    assert ("census", "all_reduce") not in _rules([], guards="check")
    assert ("forbid", "bf16") not in _rules([d("t", shape, 4, "a2a")],
                                            wire="bf16")


@pytest.mark.parametrize("wire", ["native", "bf16"])
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_predicted_payload_bytes_matches_jax(wire, dtype):
    from distributedfft_tpu.analysis import hloscan
    for shape in ((20, 16, 9), (8, 8, 5), (4, 24, 16)):
        for ring in (0, 2, 4):
            assert opscan.predicted_payload_bytes(shape, dtype, wire, ring) \
                == hloscan.predicted_payload_bytes(shape, dtype, wire, ring)


def test_rendering_name_matches_jax():
    import distributedfft_tpu as dfft
    from distributedfft_tpu.analysis import contracts as jc
    for r in ("a2a", "opt1", "p2p", "streams", "ring", "ring_ovl",
              "ring_ovl_d4", "ring_sub2", "a2a_pipe", "fused"):
        from distributedfft_tpu.analysis import verify as jv
        mine = verify._config(r, "native", "off")
        theirs = jv._config(r, "native", "off")
        assert isinstance(theirs, dfft.Config)
        assert contracts.rendering_name(mine) == jc.rendering_name(theirs)


# ---------------------------------------------------------------------------
# source lints
# ---------------------------------------------------------------------------

def test_srclint_repo_is_clean():
    assert srclint.lint_repo() == []
    files = srclint.scanned_files()
    for pkg in ("serve", "solvers", "persist", "analysis", "models"):
        assert any(f"/{pkg}/" in f.replace(os.sep, "/") for f in files)


_BODY_ENV = '''
import os
import torch
class _X(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _helper(x)
def _helper(x):
    if os.environ.get("DFFT_X"):
        return x
    return x
def _fwd_parts(self):
    def first(x):
        open("f")
        return x
    return first
def build_time(self):
    return os.environ.get("OK_AT_BUILD")
'''


def test_srclint_traced_host_io():
    got = srclint.lint_source(_BODY_ENV, "models/x.py")
    assert [(f.rule, f.line) for f in got] == [("traced-host-io", 9),
                                               ("traced-host-io", 14)]
    allowed = _BODY_ENV.replace('open("f")',
                                'open("f")  # srclint: allow(traced-host-io)')
    assert [f.line for f in srclint.lint_source(allowed, "models/x.py")] \
        == [9]


def test_srclint_host_only():
    src = ("import torch\nfrom ..ops import hopper_fft\n"
           "N = torch.cuda.device_count()\n")
    got = srclint.lint_source(src, os.path.join("utils", "wisdom.py"))
    assert [(f.rule, f.line) for f in got] == [("host-only-jnp", 2),
                                               ("host-only-jnp", 3)]
    assert srclint.lint_source(src, "models/other.py") == []


def test_srclint_wisdom_flock():
    src = ("import os\nfrom ..utils.wisdom import _advisory_lock\n"
           "def good(p):\n    with _advisory_lock(p):\n"
           "        os.replace('a', p)\n"
           "def bad(p):\n    os.replace('a', p)\n")
    got = srclint.lint_source(src, "persist/x.py")
    assert [(f.rule, f.line) for f in got] == [("wisdom-flock", 7)]
    assert srclint.lint_source(src, "models/x.py") == []
