"""The port's Prometheus exposition (``obs/promexp.py``) against the JAX
package's: every case of ``tests/test_promexp.py``, and on the same
registry contents (the same calls on both packages' registries) the
rendered text equal byte for byte to JAX's, labeled series included."""

import pytest

from distributedfft_tpu.obs import metrics as jmetrics
from distributedfft_tpu.obs import promexp as jpromexp
from distributedfft_tpu_torch import obs
from distributedfft_tpu_torch.obs import metrics, promexp

GOLDEN_SNAPSHOT = {
    "view": "cumulative",
    "counters": {"serve.shed": 3, "wisdom.hits": 2},
    "gauges": {"serve.queue_depth": 4},
    "histograms": {
        "serve.exec_ms": {"buckets": [1.0, 5.0, 25.0],
                          "counts": [2, 1, 0, 1],  # last slot = +Inf
                          "sum": 31.5, "count": 4},
    },
}

GOLDEN_TEXT = """\
# HELP dfft_serve_shed_total obs counter 'serve.shed' (cumulative, monotone across obs.reset())
# TYPE dfft_serve_shed_total counter
dfft_serve_shed_total 3
# HELP dfft_wisdom_hits_total obs counter 'wisdom.hits' (cumulative, monotone across obs.reset())
# TYPE dfft_wisdom_hits_total counter
dfft_wisdom_hits_total 2
# HELP dfft_serve_queue_depth obs gauge 'serve.queue_depth' (last value set)
# TYPE dfft_serve_queue_depth gauge
dfft_serve_queue_depth 4
# HELP dfft_serve_exec_ms obs histogram 'serve.exec_ms' (milliseconds; cumulative)
# TYPE dfft_serve_exec_ms histogram
dfft_serve_exec_ms_bucket{le="1"} 2
dfft_serve_exec_ms_bucket{le="5"} 3
dfft_serve_exec_ms_bucket{le="25"} 3
dfft_serve_exec_ms_bucket{le="+Inf"} 4
dfft_serve_exec_ms_sum 31.5
dfft_serve_exec_ms_count 4
"""


@pytest.fixture(autouse=True)
def _clean_registry():
    metrics.hard_reset()
    jmetrics.hard_reset()
    yield
    metrics.hard_reset()
    jmetrics.hard_reset()


def _both(fn):
    """Apply the same registry calls to both packages' registries."""
    fn(metrics)
    fn(jmetrics)


def test_golden_exposition():
    assert promexp.render(GOLDEN_SNAPSHOT) == GOLDEN_TEXT
    assert promexp.validate_exposition(GOLDEN_TEXT) == 9
    assert promexp.render(GOLDEN_SNAPSHOT) == \
        jpromexp.render(GOLDEN_SNAPSHOT)


def test_live_registry_renders_valid_exposition():
    def calls(m):
        m.inc("wisdom.hits", 2)
        m.gauge("serve.queue_depth", 7)
        for v in (0.3, 2.0, 700.0):
            m.observe("serve.e2e_ms", v)

    _both(calls)
    text = promexp.render()
    assert promexp.validate_exposition(text) > 0
    assert "dfft_wisdom_hits_total 2" in text
    assert "dfft_serve_queue_depth 7" in text
    assert 'dfft_serve_e2e_ms_bucket{le="+Inf"} 3' in text
    assert "dfft_serve_e2e_ms_count 3" in text
    assert text == jpromexp.render()


def test_counters_monotone_across_reset():
    """The scrape surface never sees a counter go backwards: the
    per-plan view resets, the rendered cumulative view only grows."""
    metrics.inc("serve.requests", 5)
    assert "dfft_serve_requests_total 5" in promexp.render()
    obs.reset()
    assert metrics.counter_value("serve.requests") == 0  # per-plan view
    assert "dfft_serve_requests_total 5" in promexp.render()  # scrape view
    metrics.inc("serve.requests")
    assert "dfft_serve_requests_total 6" in promexp.render()
    # Histograms too: reset baselines the plan view, never the scrape.
    metrics.observe("serve.exec_ms", 1.0)
    obs.reset()
    assert "dfft_serve_exec_ms_count 1" in promexp.render()
    assert metrics.snapshot()["histograms"] == {}


def test_name_sanitization():
    assert promexp.sanitize("serve.circuit.opened") == "serve_circuit_opened"
    assert promexp.sanitize("a-b c") == "a_b_c"
    assert promexp.sanitize("0leading") == "_0leading"
    for name in ("serve.circuit.opened", "a-b c", "0leading", "", "x:y",
                 "fleet.tenant.shed[tenant=acme]"):
        assert promexp.sanitize(name) == jpromexp.sanitize(name)
        assert promexp.split_labels(name) == jpromexp.split_labels(name)
    metrics.inc("serve.circuit.opened")
    text = promexp.render()
    assert "dfft_serve_circuit_opened_total 1" in text
    assert "obs counter 'serve.circuit.opened'" in text  # greppable mapping


def test_labeled_series_equal_jax_bytes():
    """Labeled names (the ``[k=v]`` suffix) share one family header, and
    their escapes, floats, infinities and histograms render as JAX's."""
    def calls(m):
        m.inc("fleet.tenant.shed[tenant=acme]", 3)
        m.inc('fleet.tenant.shed[tenant=a"b\\c]')
        m.inc("fleet.tenant.shed[tenant=zed,worker=w1]", 2)
        m.gauge("serve.ema_ms", 0.123456789)
        m.gauge("serve.huge", 1e17)
        m.gauge("serve.inf", float("inf"))
        for v in (0.05, 3.0, 1e6):
            m.observe("serve.queue_wait_ms", v)

    _both(calls)
    text = promexp.render()
    assert text == jpromexp.render()
    assert promexp.validate_exposition(text) == \
        jpromexp.validate_exposition(text)
    assert text.count("# TYPE dfft_fleet_tenant_shed_total counter") == 1


# ---------------------------------------------------------------------------
# validator negatives (one per defect class)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("body,match", [
    ("dfft_x_total 1\n", "before its TYPE"),
    ("# TYPE dfft_x counter\ndfft_x 1\n", "must end _total"),
    ("# TYPE dfft_x counter\n# TYPE dfft_x counter\ndfft_x_total 1\n",
     "duplicate TYPE"),
    ("# TYPE dfft_x gauge\ndfft_x one\n", "malformed value"),
    ("# TYPE dfft_x gauge\ndfft_x{le=oops} 1\n", "malformed label set"),
    ("# TYPE dfft_x gauge\n}bogus{ 1\n", "malformed sample"),
    ("# BOGUS dfft_x gauge\ndfft_x 1\n", "malformed comment"),
    ("# TYPE dfft_h histogram\ndfft_h_sum 1\ndfft_h_count 1\n",
     "no _bucket"),
    ('# TYPE dfft_h histogram\ndfft_h_bucket{le="1"} 1\n'
     "dfft_h_sum 1\ndfft_h_count 1\n", r"missing the \+Inf"),
    ('# TYPE dfft_h histogram\ndfft_h_bucket{le="1"} 2\n'
     'dfft_h_bucket{le="+Inf"} 1\ndfft_h_sum 1\ndfft_h_count 1\n',
     "not cumulative"),
    ('# TYPE dfft_h histogram\ndfft_h_bucket{le="1"} 1\n'
     'dfft_h_bucket{le="+Inf"} 2\ndfft_h_sum 1\ndfft_h_count 3\n',
     "!= _count"),
    ('# TYPE dfft_h histogram\ndfft_h_bucket{le="1"} 1\n'
     'dfft_h_bucket{le="+Inf"} 1\ndfft_h_sum 1\n', "missing _count"),
])
def test_validator_rejects(body, match):
    with pytest.raises(ValueError, match=match):
        promexp.validate_exposition(body)
    with pytest.raises(ValueError, match=match):
        jpromexp.validate_exposition(body)


def test_validator_accepts_labels_and_special_values():
    body = ('# TYPE dfft_g gauge\n'
            'dfft_g{shard="x",key="a\\"b"} NaN\n'
            "dfft_g 1e-3 1722538000\n")
    assert promexp.validate_exposition(body) == 2
