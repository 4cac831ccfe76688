"""The port's profiler (nnstreamer_tpu_torch.utils.profiler): the same
Metrics state renders to byte-identical Prometheus and OpenMetrics text as
the JAX package's ``metrics_text``, ``<stage>.batch_occupancy`` as a real
cumulative histogram; the ``/metrics`` endpoint negotiates OpenMetrics and
shuts down cleanly; ``trace(logdir)`` writes a Chrome trace through
torch.profiler."""

import json
import os
import re
import urllib.request

import numpy as np
import pytest
import torch

import nnstreamer_tpu_torch as ntt
from nnstreamer_tpu.core.log import Metrics as JMetrics
from nnstreamer_tpu.utils import profiler as jax_profiler
from nnstreamer_tpu.utils.profiler import metrics_text as jax_metrics_text
from nnstreamer_tpu_torch.core.log import Metrics, metrics
from nnstreamer_tpu_torch.utils import profiler
from nnstreamer_tpu_torch.utils.profiler import (OPENMETRICS_CONTENT_TYPE,
                                                 metrics_server, metrics_text,
                                                 start_metrics_server,
                                                 stop_metrics_server, trace)

ACC = "accelerator=true:cpu"


@pytest.fixture
def fresh(monkeypatch):
    """A Metrics of its own behind each package's ``metrics_text`` (threads
    left by other tests of this process keep writing the global ones)."""
    port, ref = Metrics(), JMetrics()
    monkeypatch.setattr(profiler, "metrics", port)
    monkeypatch.setattr(jax_profiler, "metrics", ref)
    return port, ref


def _feed(m, seed):
    """One seeded stream of every kind of sample, into a Metrics."""
    rng = np.random.default_rng(seed)
    for i in range(40):
        m.count("f.in")
        m.count("web.requests", 1, tenant=("acme", "a:b", "a/b")[i % 3])
        m.count("f.compiles", 1)
        m.gauge("f.queue_depth", float(i % 5))
        m.gauge("f.queue_depth", float(i % 3), tenant="acme")
        m.gauge("xray.hbm.params", 1024.0 * i)
        m.observe_latency("out.e2e_latency", float(rng.exponential(0.02)),
                          tenant=("acme", "zen")[i % 2])
        m.observe_latency("f.proc", float(rng.exponential(0.004)))
        m.observe_bucketed("f.batch_occupancy", float(rng.integers(1, 40)))
        m.observe("f.batch_pad_waste", float(rng.integers(0, 4)))
    m.count("a.b:c", 2)
    m.count("a.b/c", 3)  # sanitizes to the same name: hashed apart


@pytest.mark.parametrize("openmetrics", [False, True], ids=["prometheus", "openmetrics"])
@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_text_byte_identical_to_jax(fresh, seed, openmetrics):
    _feed(fresh[0], seed)
    _feed(fresh[1], seed)
    port = metrics_text(openmetrics=openmetrics)
    assert port == jax_metrics_text(openmetrics=openmetrics)
    assert port == metrics_text(openmetrics=openmetrics)  # scrape twice
    assert port.endswith("# EOF\n") == openmetrics


def test_batch_occupancy_is_a_cumulative_histogram(fresh):
    _feed(fresh[0], 3)
    text = metrics_text()
    fam = "nnstpu_f_batch_occupancy"
    assert f"# TYPE {fam} histogram" in text
    buckets = [(le, int(n)) for le, n in re.findall(
        re.escape(fam) + r'_bucket\{le="([^"]+)"\} (\d+)', text)]
    counts = [n for _, n in buckets]
    assert counts == sorted(counts) and buckets[-1][0] == "+Inf"
    assert counts[-1] == int(re.search(re.escape(fam) + r"_count (\d+)", text).group(1)) == 40


def test_runner_occupancy_reaches_the_scrape():
    """The batching runner's occupancy stream renders (the JAX package's
    tests/test_batching.py reads the same family)."""
    metrics.reset()
    desc = ("appsrc name=src caps=other/tensors,dimensions=16,types=float32 ! "
            "tensor_filter framework=jax model=scaler custom=scale:2.0,dims:16 "
            f"name=f {ACC} ! tensor_sink name=out")
    p = ntt.Pipeline(desc, queue_capacity=32, batch_max=8)
    with p:
        for i in range(16):
            p.push("src", np.full((16,), float(i), np.float32))
        for _ in range(16):
            p.pull("out", timeout=30)
        p.eos()
        p.wait(timeout=30)
    text = metrics_text()
    assert "# TYPE nnstpu_f_batch_occupancy histogram" in text
    assert 'nnstpu_f_batch_occupancy_bucket{le="+Inf"}' in text


def test_openmetrics_negotiation_and_scrape_twice_identical(fresh):
    m = fresh[0]
    m.count("f.compiles", 2)
    m.count("web.requests", 1, tenant="acme")
    m.gauge("xray.hbm.params", 1024.0)
    m.observe_latency("out.e2e_latency", 0.01, tenant="acme")
    srv = start_metrics_server()
    try:
        url = f"http://127.0.0.1:{srv.server_port}/metrics"
        req = urllib.request.Request(
            url, headers={"Accept": "application/openmetrics-text"})
        with urllib.request.urlopen(req, timeout=10) as r:
            body1 = r.read().decode()
            assert r.headers["Content-Type"] == OPENMETRICS_CONTENT_TYPE
        with urllib.request.urlopen(req, timeout=10) as r:
            body2 = r.read().decode()
        assert body1 == body2 and body1.rstrip().endswith("# EOF")
        assert 'tenant="acme"' in body1 and "nnstpu_xray_hbm_params" in body1
        assert "nnstpu_f_compiles_total 2" in body1
        with urllib.request.urlopen(url, timeout=10) as r:
            plain = r.read().decode()
            assert r.headers["Content-Type"].startswith("text/plain")
        assert "# EOF" not in plain and "nnstpu_f_compiles 2" in plain
        assert "_total" not in plain
    finally:
        stop_metrics_server(srv)
    assert not srv._nns_thread.is_alive()


def test_metrics_server_context_releases_its_port():
    with metrics_server() as srv:
        port = srv.server_port
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=10) as r:
            assert r.status == 200
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope", timeout=10)
    assert not srv._nns_thread.is_alive()


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "prof")) as prof:
        x = torch.randn(64, 64)
        (x @ x).sum()
    assert prof is not None
    with open(tmp_path / "prof" / "trace.json") as f:
        obj = json.load(f)
    names = {e.get("name") for e in obj["traceEvents"]}
    assert any(n and "mm" in n for n in names), sorted(n for n in names if n)[:20]
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
