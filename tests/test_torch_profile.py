"""The port's stage profile (``obs/profile.py``, first part) against the
JAX package's:

* the seven host cases of ``tests/test_profile.py`` on the JAX package's
  committed fixture (``tests/data/stage_trace_fixture.json``), each equal
  to JAX's own result;
* ``torch.profiler``'s chrome-trace layout (``tests/data/
  torch_gpu_trace_fixture.json``, a trimmed capture of the slab plan on an
  H100): a kernel launched through ``ctypes`` (no aten parent) is charged
  to the innermost ``dfft/...`` scope open around its launch, by the
  launch's correlation id; a kernel whose launch the trace lost is
  unattributed; the kernels launched outside aten are counted apart;
  device planes win, and the device's idle share is read from the same
  trace;
* the scope contract: scopes are entered only while a profiler records;
  with scopes off none is entered under a profiler either, and on and
  off give bit-equal outputs and the same launches (the card's route run
  on "meta" tensors, nothing launched);
* a CPU ``capture_stage_profile`` of the slab, pencil and batched-2D plans
  charges every declared node of the single-rank graph (and the guard),
  the attributed sum within 15% of the measured total;
* ``--profile-dir`` writes a trace that ``load_trace`` reads back.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

import distributedfft_tpu_torch as tdfft
from distributedfft_tpu.obs import profile as jprofile
from distributedfft_tpu_torch.obs import profile
from distributedfft_tpu_torch.ops import hopper_fft as hf

DATA = os.path.join(os.path.dirname(__file__), "data")
FIXTURE = os.path.join(DATA, "stage_trace_fixture.json")
GPU_FIXTURE = os.path.join(DATA, "torch_gpu_trace_fixture.json")


# ---------------------------------------------------------------------------
# parser units on the JAX package's fixture (no execution)
# ---------------------------------------------------------------------------

def test_fixture_parse_and_aggregate():
    """The JAX fixture aggregates to its documented numbers, as JAX's:
    nested ops resolved by self time, innermost scope wins, the unscoped
    wrapper's self time lands in the unattributed remainder."""
    planes = profile.load_trace(FIXTURE)
    assert planes == jprofile.load_trace(FIXTURE)
    assert [p["name"] for p in planes] == ["trace-events"]
    agg = profile.aggregate_trace(planes)
    assert agg == jprofile.aggregate_trace(planes)
    assert agg["scopes"] == {"slab/exchange:1": 0.4,
                             "slab/local_fft:1": 0.3,
                             "slab/local_fft:2": 0.15,
                             "wire/encode": 0.1}
    assert agg["unattributed_ms"] == pytest.approx(0.05)
    assert agg["total_ms"] == pytest.approx(1.0)


def test_fixture_event_filtering():
    """Zero-duration and non-X-phase events never reach attribution."""
    events = profile.load_trace(FIXTURE)[0]["lines"][0]["events"]
    assert events == jprofile.load_trace(FIXTURE)[0]["lines"][0]["events"]
    names = [e["name"] for e in events]
    assert "counter-event" not in names          # ph != "X"
    assert "zero-duration" in names              # parsed ...
    zero = [e for e in events if e["name"] == "zero-duration"][0]
    assert zero["dur_ps"] == 0                   # ... but self-time drops it


@pytest.mark.parametrize("strings", [
    ["dfft/slab/exchange:1/dfft/wire/encode"],
    ["dfft/slab/local_fft:1"],
    ["no scope here", ""],
    ["dfft/slab/exchange:1", "dfft/slab/exchange:1/dfft/wire/decode"],
])
def test_extract_scope_innermost_wins(strings):
    want = {0: "wire/encode", 1: "slab/local_fft:1", 2: None,
            3: "wire/decode"}
    got = profile.extract_scope(strings)
    assert got == jprofile.extract_scope(strings)
    assert got in want.values()
    if len(strings) == 2 and strings[1]:
        assert got == "wire/decode"   # the LONGEST string owns the verdict


def test_self_times_sibling_overlap_is_not_nested():
    """An event is a child only when CONTAINED; a sibling that merely
    starts before the previous one ends keeps its full self time."""
    evs = [{"name": "a", "scope": "f/a", "offset_ps": 0, "dur_ps": 100},
           {"name": "b", "scope": "f/b", "offset_ps": 100, "dur_ps": 100}]
    out = dict(profile._self_times(list(evs)))
    assert out == {"f/a": 100.0, "f/b": 100.0}
    assert out == dict(jprofile._self_times(list(evs)))


def test_parse_trace_events_accepts_bare_list():
    evs = [{"ph": "X", "name": "dfft/slab/guard", "ts": 1, "dur": 2}]
    got = profile.parse_trace_events(evs)
    assert got == jprofile.parse_trace_events(evs)
    assert got[0]["scope"] == "slab/guard"
    assert got[0]["dur_ps"] == 2_000_000  # µs -> ps


def test_stage_scope_noops(monkeypatch):
    assert isinstance(profile.stage_scope("slab", ""),
                      contextlib.nullcontext)  # undeclared exchange
    profile.disable_scopes()
    try:
        assert not profile.scopes_enabled()
        assert isinstance(profile.stage_scope("slab", "exchange:1"),
                          contextlib.nullcontext)
    finally:
        profile.enable_scopes()
    monkeypatch.setenv(profile.ENV_NO_SCOPES, "1")
    assert not profile.scopes_enabled()
    assert profile.ENV_NO_SCOPES == jprofile.ENV_NO_SCOPES
    monkeypatch.delenv(profile.ENV_NO_SCOPES)
    assert profile.scopes_enabled()
    # entered only while a profiler records
    assert isinstance(profile.stage_scope("slab", "exchange:1"),
                      contextlib.nullcontext)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert not isinstance(profile.stage_scope("slab", "exchange:1"),
                              contextlib.nullcontext)
    assert profile.scope_name("slab", "exchange:1") == \
        jprofile.scope_name("slab", "exchange:1")


def test_scoped_passes_falsy_node_through():
    fn = lambda x: x + 1  # noqa: E731
    assert profile.scoped("slab", "", fn) is fn
    assert profile.scoped("slab", "exchange:1", None) is None
    assert profile.scoped("slab", "exchange:1", fn)(1) == 2


# ---------------------------------------------------------------------------
# torch.profiler's GPU layout (a trimmed H100 capture)
# ---------------------------------------------------------------------------

def _gpu_fixture():
    with open(GPU_FIXTURE, encoding="utf-8") as f:
        return json.load(f)


def test_gpu_fixture_attributes_ctypes_kernels_by_correlation():
    """Every kernel of the fixture lands under the scope open around its
    ``cudaLaunchKernel`` (none of the port's kernels has an aten parent),
    device planes win over the host's aten ops, and the numbers are the
    fixture's documented ones."""
    obj = _gpu_fixture()
    assert profile.is_torch_trace(obj)
    planes = profile.load_trace(GPU_FIXTURE)
    names = [p["name"] for p in planes]
    assert names[0].startswith("/device:GPU:") and "/host:CPU" in names
    kernels = [e for p in planes if p["name"].startswith("/device:")
               for ln in p["lines"] for e in ln["events"]]
    want = obj["expected"]
    assert len(kernels) == want["device_events"]
    agg = profile.aggregate_trace(planes)
    assert agg["planes"] == [n for n in names if n.startswith("/device:")]
    assert agg["scopes"] == pytest.approx(want["scopes_ms"], abs=1e-6)
    assert agg["unattributed_ms"] == pytest.approx(
        want["unattributed_ms"], abs=1e-6)
    act = profile.device_activity(planes)
    assert act["busy_ms"] == pytest.approx(want["busy_ms"], abs=1e-6)
    assert 0 < act["idle_share"] < 1
    # the fused kernels 6 and 7 (four launches a call, two calls); the
    # guard's aten kernels are not the port's
    assert act["port_kernel_events"] == want["port_kernel_events"] == 8
    assert act["kernel_events"] > act["port_kernel_events"]


def test_kernel_without_its_launch_is_unattributed():
    """A device op whose runtime launch the trace lost has no scope (the
    ``gpu_user_annotation`` ranges Kineto draws on the device are not
    read) and is not counted as the port's."""
    obj = _gpu_fixture()
    stripped = {"traceEvents": [e for e in obj["traceEvents"]
                                if e.get("cat") not in ("cuda_runtime",
                                                        "cuda_driver")]}
    assert any(e.get("cat") == "gpu_user_annotation"
               for e in stripped["traceEvents"])
    planes = profile.parse_torch_trace(stripped)
    dev = [e for p in planes if p["name"].startswith("/device:")
           for ln in p["lines"] for e in ln["events"]]
    assert len(dev) == obj["expected"]["device_events"]
    assert all(e["scope"] is None and not e["outside_aten"] for e in dev)
    agg = profile.aggregate_trace(planes)
    assert agg["scopes"] == {}
    assert profile.device_activity(planes)["port_kernel_events"] == 0


def test_port_kernel_events_count_launches_outside_aten():
    """A kernel launched inside an aten op is aten's; one launched with
    no aten op around it (the port's ``ctypes`` launch) is the port's,
    scoped or not; a memcpy is no kernel."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "dfft/slab/guard",
         "pid": 1, "tid": 7, "ts": 0, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "pid": 1,
         "tid": 7, "ts": 10, "dur": 20},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "pid": 1,
         "tid": 7, "ts": 30, "dur": 10},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 7, "ts": 12, "dur": 3,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 7, "ts": 50, "dur": 3,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 7, "ts": 150, "dur": 3,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 8, "ts": 32, "dur": 3,
         "args": {"correlation": 4}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
         "pid": 1, "tid": 7, "ts": 60, "dur": 3,
         "args": {"correlation": 5}},
    ]
    for corr, name, ts in ((1, "mul", 200), (2, "zy_planes", 210),
                           (3, "fft_rows", 220), (4, "fft_cols", 230)):
        ev.append({"ph": "X", "cat": "kernel", "name": name, "pid": 0,
                   "tid": 7, "ts": ts, "dur": 5,
                   "args": {"correlation": corr, "device": 0,
                            "stream": 7}})
    ev.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
               "pid": 0, "tid": 7, "ts": 240, "dur": 5,
               "args": {"correlation": 5, "device": 0, "stream": 7}})
    planes = profile.parse_torch_trace({"traceEvents": ev})
    dev = {e["name"]: e for p in planes if p["name"].startswith("/device:")
           for ln in p["lines"] for e in ln["events"]}
    assert not dev["mul"]["outside_aten"]
    # tid 8 has no aten op around its launch at 32 (tid 7's copy_ is)
    assert all(dev[k]["outside_aten"]
               for k in ("zy_planes", "fft_rows", "fft_cols"))
    assert dev["zy_planes"]["scope"] == "slab/guard"
    assert dev["fft_rows"]["scope"] is None
    act = profile.device_activity(planes)
    assert act["kernel_events"] == 4 and act["port_kernel_events"] == 3


def test_synthetic_launch_nesting_innermost_scope():
    """A launch inside nested host scopes takes the innermost one; a host
    op inside a scope is charged to it; an unscoped launch is
    unattributed."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "dfft/slab/exchange:1",
         "pid": 1, "tid": 7, "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "dfft/wire/encode",
         "pid": 1, "tid": 7, "ts": 10, "dur": 20},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 7, "ts": 12, "dur": 3,
         "args": {"correlation": 5}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 7, "ts": 50, "dur": 3,
         "args": {"correlation": 6}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 7, "ts": 150, "dur": 3,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "pid": 1,
         "tid": 7, "ts": 60, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "enc_pack_kernel", "pid": 0,
         "tid": 7, "ts": 200, "dur": 40,
         "args": {"correlation": 5, "device": 0, "stream": 7}},
        {"ph": "X", "cat": "kernel", "name": "copy", "pid": 0, "tid": 7,
         "ts": 240, "dur": 10,
         "args": {"correlation": 6, "device": 0, "stream": 7}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "pid": 0,
         "tid": 7, "ts": 300, "dur": 5,
         "args": {"correlation": 7, "device": 0, "stream": 7}},
    ]
    planes = profile.parse_torch_trace({"traceEvents": ev})
    agg = profile.aggregate_trace(planes)
    assert agg["scopes"] == {"wire/encode": 0.04, "slab/exchange:1": 0.01}
    assert agg["unattributed_ms"] == pytest.approx(0.005)
    host = [p for p in planes if p["name"] == "/host:CPU"][0]
    assert host["lines"][0]["events"][0]["scope"] == "slab/exchange:1"
    act = profile.device_activity(planes)
    assert act["busy_ms"] == pytest.approx(0.055)
    assert act["window_ms"] == pytest.approx(0.245)   # 60 us .. 305 us


# ---------------------------------------------------------------------------
# the scope contract
# ---------------------------------------------------------------------------

_CPU = [torch.profiler.ProfilerActivity.CPU]


def _count_scopes(monkeypatch):
    seen = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        seen.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    return seen


def _plans():
    g = tdfft.GlobalSize(16, 16, 16)
    return {
        "slab": tdfft.SlabFFTPlan(g, tdfft.SlabPartition(1),
                                  tdfft.Config(fft_backend="pallas",
                                               guards="check"),
                                  device="cpu"),
        "pencil": tdfft.PencilFFTPlan(g, tdfft.PencilPartition(1, 1),
                                      tdfft.Config(fft_backend="pallas"),
                                      device="cpu"),
        "batched2d": tdfft.Batched2DFFTPlan(
            4, 16, 16, tdfft.SlabPartition(1),
            tdfft.Config(fft_backend="pallas"), batch_chunk=1,
            device="cpu"),
    }


@pytest.mark.parametrize("family", ["slab", "pencil", "batched2d"])
def test_scopes_off_enter_nothing_and_change_nothing(monkeypatch, family):
    plan = _plans()[family]
    run, shape, complex_in = profile._direction_runner(plan, "forward", 3)
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(shape),
                        dtype=plan.real_dtype)
    seen = _count_scopes(monkeypatch)
    with torch.profiler.profile(activities=_CPU):
        on = run(x)
        n_on = len([s for s in seen if s.startswith("dfft/")])
        seen.clear()
        with profile.scopes_off():
            off = run(x)
    assert n_on > 0 and seen == []
    assert torch.equal(on, off)


@pytest.mark.parametrize("family", ["slab", "pencil", "batched2d"])
def test_scopes_enter_nothing_without_a_profiler(monkeypatch, family):
    """Scopes on, no profiler recording: a plan's run enters no
    ``record_function`` and gives the profiled run's result."""
    plan = _plans()[family]
    run, shape, complex_in = profile._direction_runner(plan, "forward", 3)
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(shape),
                        dtype=plan.real_dtype)
    seen = _count_scopes(monkeypatch)
    assert profile.scopes_enabled()
    bare = run(x)
    assert seen == []
    with torch.profiler.profile(activities=_CPU):
        on = run(x)
    assert any(s.startswith("dfft/") for s in seen)
    assert torch.equal(bare, on)


def _record_launches(monkeypatch):
    log = []
    for name in ("_check_rows", "_check", "_check_cols", "_check_short",
                 "_check_tw_cols"):
        monkeypatch.setattr(hf, name, lambda *a, **k: False)
    monkeypatch.setattr(hf, "_launch", lambda kernel, fn, *args:
                        log.append((kernel, fn)))
    return log


@pytest.mark.parametrize("shape", [(32, 32, 32), (16, 2048, 8)])
def test_scopes_on_and_off_launch_the_same(monkeypatch, shape):
    """The card's route of a slab plan's forward and inverse, on "meta"
    tensors: scopes on and off launch the same kernels in the same
    order."""
    plan = tdfft.SlabFFTPlan(tdfft.GlobalSize(*shape), tdfft.SlabPartition(1),
                             tdfft.Config(fft_backend="pallas"), device="cpu")
    log = _record_launches(monkeypatch)
    fwd, inv = plan._build_r2c(), plan._build_c2r()

    def both():
        c = fwd(torch.zeros(shape, device="meta"))
        inv(torch.zeros(tuple(c.shape), dtype=torch.complex64,
                        device="meta"))

    both()
    on = list(log)
    log.clear()
    with profile.scopes_off():
        both()
    assert on and log == on


# ---------------------------------------------------------------------------
# a CPU capture of each family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["slab", "pencil", "batched2d"])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_cpu_capture_attributes_every_node(family, direction):
    plan = _plans()[family]
    prof = profile.capture_stage_profile(plan, direction, iters=2)
    want = {f"{family}/local_fft:1"}
    if family == "slab":
        want.add("slab/guard")
    assert set(prof["scopes"]) == want
    assert all(v > 0 for v in prof["scopes"].values())
    attributed = sum(prof["scopes"].values())
    assert attributed == pytest.approx(prof["total_ms"], rel=0.15)
    assert prof["planes"] == ["/host:CPU"] and prof["idle_share"] is None
    assert prof["iters"] == 2 and prof["direction"] == direction


def test_stage_profile_names_the_later_items():
    with pytest.raises(NotImplementedError, match="item 12's rest"):
        profile.stage_profile(_plans()["slab"])


def test_profile_dir_writes_a_readable_trace(tmp_path, monkeypatch):
    """``--profile-dir``: the slab executable's timed runs land in a
    chrome trace under the directory, whose scopes ``load_trace`` reads
    back."""
    from distributedfft_tpu_torch.cli import slab as tslab
    monkeypatch.chdir(tmp_path)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tslab.main(["-nx", "16", "-ny", "16", "-nz", "16", "-t", "0",
                         "-i", "2", "--fft-backend", "pallas",
                         "--profile-dir", str(tmp_path / "prof"),
                         "-b", str(tmp_path / "b"), "--emulate-devices",
                         "1"])
    assert rc == 0 and "Run complete: " in buf.getvalue()
    files = profile.find_trace_files(str(tmp_path / "prof"))
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    agg = profile.aggregate_trace(profile.load_trace(files[0]))
    assert "slab/local_fft:1" in agg["scopes"]


def test_capture_window_reads_a_server_worker_thread():
    """A served request runs on the server's worker thread: the window
    still charges its ops to the batched plan's scope."""
    from distributedfft_tpu_torch.serve import Server
    with Server(device="cpu") as s:
        s.request(np.zeros((16, 16), np.float32))     # the cold build
        with profile.capture_window("cpu") as win:
            s.request(np.ones((16, 16), np.float32))
    assert win.result["scopes"].get("batched2d/local_fft:1", 0) > 0
    assert win.result["idle_share"] is None      # no device plane
