"""The SLO engine in the port against the JAX package's
(``nnstreamer_tpu/utils/slo.py``, ``core/log.py`` ``fraction_over``,
``Pipeline(slo=)``), on the CPU: the same samples and policy dicts go
into both, and the shares, problems and verdicts must be equal (exact:
they are counts and ratios of counts; percentiles are samples).  The
sink's end-to-end series carries the JAX package's name,
``<sink>.e2e_latency``, which the engine reads."""

import threading
import time

import numpy as np
import pytest

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as ntt
from nnstreamer_tpu.core.log import Metrics as JMetrics
from nnstreamer_tpu.core.log import metrics as jmetrics
from nnstreamer_tpu.utils import slo as jslo
from nnstreamer_tpu.utils import tracing as jtracing
from nnstreamer_tpu_torch.core.log import Metrics, metrics
from nnstreamer_tpu_torch.pipeline.runtime import PipelineError
from nnstreamer_tpu_torch.utils import slo, tracing

DESC = ("appsrc name=src caps=other/tensors,dimensions=16,types=float32 ! "
        "tensor_filter framework=jax model=scaler custom=scale:2.0,dims:16 "
        "{acc} name=f ! tensor_sink name=out")
PORT_DESC = DESC.format(acc="accelerator=true:cpu")
JAX_DESC = DESC.format(acc="")

#: the JAX package's own bad policies (tests/test_slo.py) and a few more
BAD_POLICIES = [
    {},
    {"tenants": [{"p99_ms": 5}]},
    {"tenants": [{"tenant": "a"}, {"tenant": "a"}]},
    {"tenants": [{"tenant": "a", "p99_ms": -1}]},
    {"tenants": [{"tenant": "a", "error_budget": 2}]},
    {"tenants": [{"tenant": "a", "p99ms": 5}]},
    {"tenants": [{"tenant": "a"}], "bogus": 1},
    {"tenants": [{"tenant": "a"}], "sinks": "out"},
    {"tenants": [{"tenant": "a"}], "shed_series": 3},
    {"tenants": ["a"]},
    [],
]


@pytest.fixture(autouse=True)
def _clean_state():
    for m, rec in ((metrics, tracing.recorder), (jmetrics, jtracing.recorder)):
        m.reset()
        rec.configure("off")
        rec.clear()
    yield
    for m, rec in ((metrics, tracing.recorder), (jmetrics, jtracing.recorder)):
        rec.configure("off")
        rec.clear()
        m.reset()


def _run(pkg, desc, n, **kw):
    p = pkg.Pipeline(desc, **kw)
    with p:
        for i in range(n):
            p.push("src", pkg.Buffer([np.full((16,), float(i), np.float32)], pts=i))
        outs = [p.pull("out", timeout=60) for _ in range(n)]
        rep = p.slo_report() if kw.get("slo") is not None else None
        p.eos()
        p.wait(timeout=60)
    return outs, rep


def _samples(seed=0, n=64):
    rng = np.random.default_rng(seed)
    return [float(v) for v in rng.lognormal(mean=-4.0, sigma=1.5, size=n)]


# -- the series name ---------------------------------------------------------------

def test_sink_series_names_equal_jax():
    """One traced pipeline through each package, the same tenant: the
    latency histograms, plain and tenant-labelled, that each records for
    the sink are the same names (``out.e2e_latency``, the engine's)."""
    _run(nt, JAX_DESC, 3, trace_mode="ring", tenant="acme")
    _run(ntt, PORT_DESC, 3, trace_mode="ring", tenant="acme")

    def sink_series(m):
        return ({n for n in m.histograms() if n.startswith("out.")},
                {k for k in m.labeled_histograms() if k[0].startswith("out.")})

    assert sink_series(metrics) == sink_series(jmetrics)
    assert "out.e2e_latency" in sink_series(metrics)[0]
    assert ("out.e2e_latency", "acme") in sink_series(metrics)[1]
    assert metrics.labeled_histograms()[("out.e2e_latency", "acme")][2] == 3


# -- the queue sampler (Queue C 1) ---------------------------------------------------

GAUGE_KINDS = (".queue_depth", ".inflight_window", ".staleness_s", ".watermark_pts")


def _sampler_gauges(m):
    return ({n for n in m.gauges() if n.endswith(GAUGE_KINDS)},
            {k: v for k, v in m.labeled_gauges().items() if k[0].endswith(GAUGE_KINDS)})


def _tenanted(pkg, tr, i, tenant):
    b = pkg.Buffer([np.full((16,), float(i), np.float32)], pts=i)
    if tenant is not None:
        b.meta[tr.META_TENANT] = tenant
    return b


@pytest.mark.parametrize("tenants", [("a", "a", "b", None), ("b", None, None, "a", "a", "a")])
def test_queue_depth_gauges_per_tenant_equal_jax(tenants):
    """The same queue contents in each package's filter stage, sampled
    twice: the plain and per-tenant ``f.queue_depth`` gauges are equal,
    and a tenant that has left the queue reads 0 on the second tick."""
    got = {}
    for name, pkg, m, tr, desc in (("jax", nt, jmetrics, jtracing, JAX_DESC),
                                   ("port", ntt, metrics, tracing, PORT_DESC)):
        kw = {"data_parallel": 1} if pkg is nt else {}
        p = pkg.Pipeline(desc, trace_mode="ring", batch_max=4, dispatch_depth=2,
                         queue_capacity=16, **kw)
        [runner] = [r for r in {id(r): r for r in p._runners.values()}.values()
                    if r.element.name == "f"]
        for i, ten in enumerate(tenants):
            runner.queue.put(("sink", _tenanted(pkg, tr, i, ten)))
        p.sample_queues()
        first = _sampler_gauges(m)
        while runner.queue.get_nowait() is not None:
            pass
        runner.queue.put(("sink", _tenanted(pkg, tr, 9, "a")))
        p.sample_queues()
        got[name] = (first, _sampler_gauges(m))
        p.stop()
    assert got["port"] == got["jax"]
    first, second = got["port"]
    assert first[1][("f.queue_depth", "a")] == tenants.count("a")
    assert second[1][("f.queue_depth", "b")] == 0.0  # idle: zeroed
    assert second[1][("f.queue_depth", "a")] == 1.0
    assert "f.inflight_window" in first[0]


def _gate(el, gate):
    """Hold ``el``'s work until ``gate`` is set (both packages' runners
    call process or process_batch)."""
    for meth in ("process", "process_batch"):
        real = getattr(el, meth)

        def held(*a, _real=real, **k):
            gate.wait(30)
            return _real(*a, **k)

        setattr(el, meth, held)


def test_traced_run_samples_the_same_gauges_as_jax():
    """One traced pipeline with two tenants and a dispatch window of 2
    through each package, the filter held while 8 frames queue: each
    tick's per-tenant depths are the queue's own, the sampler thread runs
    and stop() joins it, and after the drain the gauge names and the
    per-tenant depths (an idle tenant zeroed) are equal to the JAX
    package's."""
    got = {}
    for name, pkg, m, tr, desc in (("jax", nt, jmetrics, jtracing, JAX_DESC),
                                   ("port", ntt, metrics, tracing, PORT_DESC)):
        kw = {"data_parallel": 1} if pkg is nt else {}
        p = pkg.Pipeline(desc, trace_mode="ring", batch_max=4, dispatch_depth=2,
                         queue_capacity=16, **kw)
        [runner] = [r for r in {id(r): r for r in p._runners.values()}.values()
                    if r.element.name == "f"]
        gate = threading.Event()
        _gate(p.element("f"), gate)
        with p:
            for i in range(8):
                p.push("src", _tenanted(pkg, tr, i, "ab"[i % 2]))
            deadline = time.monotonic() + 30
            while (runner.queue.qsize() + runner._proc_n != 8
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            p.sample_queues()
            queued = runner.queue.tenant_depths()
            held = {k[1]: v for k, v in m.labeled_gauges().items() if k[0] == "f.queue_depth"}
            assert held == {t: float(n) for t, n in queued.items()}
            assert set(held) == {"a", "b"}
            gate.set()
            outs = [p.pull("out", timeout=60) for _ in range(8)]
            deadline = time.monotonic() + 30
            while runner.queue.qsize() and time.monotonic() < deadline:
                time.sleep(0.01)
            p.sample_queues()
            got[name] = _sampler_gauges(m)
            sampler = p._sampler
            assert sampler.is_alive()
            p.eos()
            p.wait(timeout=60)
        assert not sampler.is_alive()
        assert [float(o.tensors[0][0]) for o in outs] == [2.0 * i for i in range(8)]
    assert got["port"][0] == got["jax"][0]
    assert {"f.queue_depth", "f.inflight_window", "out.staleness_s",
            "out.watermark_pts"} <= got["port"][0]
    assert metrics.gauges()["out.watermark_pts"] == 7.0
    assert got["port"][1] == got["jax"][1] == {("f.queue_depth", "a"): 0.0,
                                               ("f.queue_depth", "b"): 0.0}


def test_untraced_pipeline_starts_no_sampler():
    p = ntt.Pipeline(PORT_DESC)
    with p:
        p.eos()
        p.wait(timeout=30)
    assert getattr(p, "_sampler", None) is None
    assert not {n for n in metrics.gauges() if n.endswith(GAUGE_KINDS)}


# -- fraction_over -------------------------------------------------------------------

@pytest.mark.parametrize("threshold", [0.0, 1e-4, 0.004, 0.025, 0.3, 20.0])
@pytest.mark.parametrize("tenant", [None, "a", "ghost"])
def test_fraction_over_equals_jax(threshold, tenant):
    m, jm = Metrics(), JMetrics()
    for i, v in enumerate(_samples()):
        ten = "a" if i % 2 else None
        m.observe_latency("s.e2e_latency", v, tenant=ten)
        jm.observe_latency("s.e2e_latency", v, tenant=ten)
    assert m.fraction_over("s.e2e_latency", threshold, tenant=tenant) == \
        jm.fraction_over("s.e2e_latency", threshold, tenant=tenant)


def test_fraction_over_counts_whole_buckets():
    m = Metrics()
    for v in (0.001, 0.002, 0.040, 0.900):
        m.observe_latency("s.e2e_latency", v, tenant="a")
    assert m.fraction_over("s.e2e_latency", 0.025, tenant="a") == (0.5, 4)
    assert m.fraction_over("s.e2e_latency", 0.025, tenant="ghost") == (0.0, 0)


# -- policy ---------------------------------------------------------------------------

@pytest.mark.parametrize("bad", BAD_POLICIES)
def test_policy_problems_equal_jax(bad):
    assert slo.validate_policy(bad) == jslo.validate_policy(bad)
    assert slo.validate_policy(bad)
    with pytest.raises(ValueError, match="invalid SLO policy|slo policy must be"):
        slo.load_policy(bad)


def test_policy_load(tmp_path):
    good = {"tenants": [{"tenant": "a", "p99_ms": 50, "min_fps": 5,
                         "ttft_p99_ms": 200}], "sinks": ["out"]}
    assert slo.validate_policy(good) == jslo.validate_policy(good) == []
    pol = slo.load_policy(good)
    assert pol.to_dict() == jslo.load_policy(good).to_dict()
    path = tmp_path / "slo.json"
    path.write_text(__import__("json").dumps(good))
    assert slo.load_policy(str(path)).for_tenant("a").min_fps == 5
    assert slo.load_policy(None).tenants == []
    assert slo.load_policy(pol) is pol


# -- the engine ------------------------------------------------------------------------

def _fed(cls, sink="out"):
    """The same samples for three tenants, sheds and TTFTs into one
    registry of ``cls``."""
    m = cls()
    rng = np.random.default_rng(5)
    for tenant, n_ok, n_bad, sheds in (("a", 8, 2, 10), ("b", 20, 0, 0),
                                       ("stranger", 3, 1, 0)):
        for v in rng.uniform(0.001, 0.004, n_ok):
            m.observe_latency(f"{sink}.e2e_latency", float(v), tenant=tenant)
        for v in rng.uniform(0.5, 0.9, n_bad):
            m.observe_latency(f"{sink}.e2e_latency", float(v), tenant=tenant)
        if sheds:
            m.count("query_server.shed", sheds, tenant=tenant)
        for v in rng.uniform(10.0, 300.0, 5):
            m.observe_latency("llm.serve.ttft_ms", float(v), tenant=tenant)
    return m


POLICY = {"tenants": [{"tenant": "a", "p99_ms": 50.0, "error_budget": 0.1},
                      {"tenant": "b", "p50_ms": 1e-3, "ttft_p99_ms": 100.0},
                      {"tenant": "idle", "p99_ms": 1e9, "min_fps": 1e9}]}
TIMING = ("fps", "window_s")


def _strip(rep):
    out = {k: v for k, v in rep.items() if k not in TIMING}
    out["tenants"] = {t: {k: v for k, v in vd.items() if k not in TIMING
                          and not (k == "violations")}
                      for t, vd in rep["tenants"].items()}
    out["violations"] = {t: [x for x in vd["violations"] if "throughput" not in x]
                         for t, vd in rep["tenants"].items()}
    return out


def test_engine_report_equals_jax():
    """The same samples, sheds and policy: the same verdict per tenant
    (burn rates, percentiles, requests, breaches, violations) and the same
    gauges published; throughput, a rate over the wall clock, is left
    out of the comparison."""
    m, jm = _fed(Metrics), _fed(JMetrics)
    rec, jrec = tracing.FlightRecorder("ring", 64), jtracing.FlightRecorder("ring", 64)
    for r in (rec, jrec):
        r.record("queue", "f", 1, 0, int(5e6), tenant="a")
        r.record("stage", "f", 1, int(5e6), int(30e6), tenant="a")
        r.record("stage", "f", 2, 0, int(40e6), trace_ids=[1, 2], rows=2,
                 tenants=["b", "b"])
    got = slo.SLOEngine(slo.load_policy(POLICY), sinks=["out"], metrics=m,
                        recorder=rec).report()
    want = jslo.SLOEngine(jslo.load_policy(POLICY), sinks=["out"], metrics=jm,
                          recorder=jrec).report()
    assert _strip(got) == _strip(want)
    assert got["tenants"]["a"]["burn_rate"] == pytest.approx((12 / 20) / 0.1)
    assert got["tenants"]["a"]["dominant_span_kind"] == "stage"
    assert {k: v for k, v in m.labeled_gauges().items() if k[0].startswith("slo.")} == \
        {k: v for k, v in jm.labeled_gauges().items() if k[0].startswith("slo.")}


def test_dominant_span_equals_jax():
    rec, jrec = tracing.FlightRecorder("ring", 64), jtracing.FlightRecorder("ring", 64)
    for r in (rec, jrec):
        r.record("queue", "f", 1, 0, int(5e6), tenant="a")
        r.record("stage", "f", 1, int(5e6), int(30e6), tenant="a")
        r.record("stage", "f", 2, 0, int(99e6), tenant="b")
        r.record("e2e", "out", 1, 0, int(40e6), tenant="a")
        r.record("stage", "f", 3, 0, int(40e6), trace_ids=[1, 2, 3, 4], rows=4,
                 tenants=["a", "a", "b", None])
    for tenant in ("a", "b", "ghost"):
        assert slo.dominant_span(tenant, rec) == jslo.dominant_span(tenant, jrec)


def test_engine_fps_window_never_near_zero():
    m = _fed(Metrics)
    eng = slo.SLOEngine(slo.SLOPolicy(tenants=[slo.TenantSLO("b", min_fps=0.1)]),
                        sinks=["out"], metrics=m)
    eng._t0 = time.monotonic() - 10.0
    first = eng.evaluate()
    second = eng.evaluate()
    assert second["window_s"] >= slo.SLOEngine.MIN_RATE_WINDOW_S
    assert second["tenants"]["b"]["ok"]
    assert first["tenants"]["b"]["fps"] == pytest.approx(2.0, rel=0.2)


# -- the pipeline ------------------------------------------------------------------

def test_pipeline_slo_report_breaches_as_jax():
    """``Pipeline(slo=)`` on a traced pipeline: the tenant over its
    objective breaches in both packages, the idle one does not, and the
    breaching tenant's dominant span is one the port recorded."""
    pol = {"tenants": [{"tenant": "acme", "p99_ms": 1e-6},
                       {"tenant": "idle", "p99_ms": 1e9}]}
    _, want = _run(nt, JAX_DESC, 6, trace_mode="ring", tenant="acme", slo=pol)
    outs, got = _run(ntt, PORT_DESC, 6, trace_mode="ring", tenant="acme", slo=pol)
    assert got["breaches"] == want["breaches"] == ["acme"]
    assert got["tenants"]["acme"]["requests"] == want["tenants"]["acme"]["requests"] == 6
    assert got["tenants"]["acme"]["burn_rate"] == want["tenants"]["acme"]["burn_rate"]
    kind = got["tenants"]["acme"]["dominant_span_kind"]
    assert kind in slo.ATTRIBUTABLE_KINDS
    assert any(e.kind == kind and (e.args or {}).get("tenant") == "acme"
               for e in tracing.recorder.events())
    assert all(o.meta[tracing.META_TENANT] == "acme" for o in outs)


def test_pipeline_runs_and_stops_its_engine():
    pol = {"tenants": [{"tenant": "acme", "p99_ms": 1e9}]}
    p = ntt.Pipeline(PORT_DESC, trace_mode="ring", tenant="acme", slo=pol)
    assert p._slo_engine is None  # built at start
    with p:
        thread = p._slo_engine._thread
        assert thread is not None and thread.is_alive()
        for i in range(4):
            p.push("src", ntt.Buffer([np.full((16,), float(i), np.float32)], pts=i))
        for _ in range(4):
            p.pull("out", timeout=60)
        deadline = time.monotonic() + 10
        while ("slo.breach", "acme") not in metrics.labeled_gauges():
            assert time.monotonic() < deadline, "the engine published nothing"
            time.sleep(0.05)
        p.eos()
        p.wait(timeout=60)
    thread.join(timeout=5)
    assert not thread.is_alive() and p._slo_engine._thread is None
    assert metrics.labeled_gauges()[("slo.breach", "acme")] == 0.0


def test_bad_policy_rejected_at_construction():
    with pytest.raises(PipelineError, match="unknown keys"):
        ntt.Pipeline(PORT_DESC, slo={"tenants": [{"tenant": "a", "p99ms": 5}]})
