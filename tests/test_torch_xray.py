"""xray in the port (nnstreamer_tpu_torch.utils.xray): with
``Pipeline(xray=True)`` every captured step registers with the program
census against the deep lint's budget, the same bucket ladder giving the
JAX package's budgets; an unpredicted capture fires ``census-drift`` with
the signature diff; replays are timed (wall time on the CPU, CUDA events
on the card) and costed from the step's warm-up (the kernel entries'
analytic counts: a llama decode step against its hand count); the memory
ledger holds the port's structures to the estimate; with xray off no hook
runs, and every pipeline thread stops on ``stop()``."""

import json
import logging
import threading
import time

import numpy as np
import pytest
import torch

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as ntt
from nnstreamer_tpu_torch.core.log import metrics
from nnstreamer_tpu_torch.pipeline.graphs import Census
from nnstreamer_tpu_torch.utils import tracing, xray
from nnstreamer_tpu_torch.utils.profiler import metrics_text
from nnstreamer_tpu_torch.utils.tracing import recorder
from nnstreamer_tpu_torch.utils.xray import (ProgramRegistry, TrackedStep,
                                             explain_signature_drift, registry)

ACC = "accelerator=true:cpu"
DIMS = 16
DESC = (
    f"appsrc name=src caps=other/tensors,dimensions={DIMS},types=float32 ! "
    f"tensor_filter framework=jax model=scaler custom=scale:2.0,dims:{DIMS} "
    "name=f {acc}! tensor_sink name=out")


@pytest.fixture(autouse=True)
def _clean_state():
    from nnstreamer_tpu.utils import xray as jxray

    for reg in (registry, jxray.registry):
        reg.reset()
    metrics.reset()
    recorder.configure("off")
    recorder.clear()
    yield
    for reg in (registry, jxray.registry):
        reg.reset()
    metrics.reset()
    recorder.configure("off")
    recorder.clear()


def _frames(n, dims=DIMS):
    return [np.full((dims,), float(i % 7), np.float32) for i in range(n)]


def _run(desc, frames, mod=ntt, timeout=60, explain=False, before_stop=None, **kw):
    p = mod.Pipeline(desc, **kw)
    outs, rep = [], None
    try:
        p.start()
        for i, x in enumerate(frames):
            p.push("src", mod.Buffer([x], pts=i))
        for _ in frames:
            outs.append(p.pull("out", timeout=timeout))
        p.eos()
        p.wait(timeout=timeout)
        if explain:
            rep = p.explain()
        if before_stop is not None:
            before_stop()
    finally:
        p.stop()
    return (outs, rep) if explain else outs


# -- signatures ---------------------------------------------------------------

def test_signature_drift_diff_names_the_field():
    base = ("continuous", 8, "bfloat16", False)
    assert explain_signature_drift(("continuous", 8, "bfloat16", True), base) \
        == "arg 3: True ⊄ predicted False"
    assert explain_signature_drift((4, ((2, 16), "torch.float32")),
                                   (8, ((2, 16), "torch.float32"))) \
        == "arg 0: 4 ⊄ predicted 8"
    assert "arity" in explain_signature_drift(base, base + base)
    assert explain_signature_drift(base, None) == \
        "no predicted signature to diff against"


# -- the census of captured steps ---------------------------------------------

def _matmul_step(n):
    w = torch.randn(32, 8)
    x = torch.randn(n, 32)
    out = {}

    def fn():
        out["y"] = x @ w

    return fn


def test_census_capture_registers_and_costs_its_warm_up():
    reg = ProgramRegistry()
    census = Census("cpu")
    census.attach_xray(reg, "s1")
    a = census.capture(("stage", 4), _matmul_step(4))
    a.replay()
    a.replay()
    census.capture(("stage", 8), _matmul_step(8))
    e = reg.census()["s1/stage"]
    assert e["live_compiles"] == 2 and len(e["live_signatures"]) == 2
    assert metrics.snapshot().get("s1.compiles") == 2
    assert a.track.flops == 2 * 4 * 32 * 8  # the warm-up's matmul formula
    assert a.track.bytes_ == (4 * 32 + 32 * 8 + 4 * 8) * 4
    assert a.track.disp_n == 2 and a.track.disp_ns > 0
    st = reg.stage_stats()["s1"]
    assert st["dispatches"] == 2 and st["flops_total"] == 2 * a.track.flops


def test_budget_overflow_fires_census_drift_with_diff(caplog):
    reg = ProgramRegistry()
    reg.expect("llm.serve", "continuous", budget=1)
    census = Census("cpu")
    census.attach_xray(reg, "llm.serve")
    census.capture(("continuous", 8, "bfloat16", False), _matmul_step(2))
    assert reg.drift_count() == 0
    with caplog.at_level(logging.WARNING):
        census.capture(("continuous", 8, "bfloat16", True), _matmul_step(2))
    assert reg.drift_count() == 1
    d = reg.drifts()[0]
    assert d["stage"] == "llm.serve" and d["kind"] == "continuous"
    assert "exceed the predicted census of 1" in d["reason"]
    assert "True" in d["diff"] and "False" in d["diff"]
    assert metrics.snapshot().get("xray.census_drifts") == 1
    assert any("census-drift" in r.message for r in caplog.records)
    with caplog.at_level(logging.WARNING):  # a storm warns once per key
        caplog.clear()
        census.capture(("continuous", 4, "bfloat16", True), _matmul_step(2))
    assert reg.drift_count() == 2
    assert not any(r.levelno >= logging.WARNING for r in caplog.records)


def test_ladder_allow_set_fires_drift_on_unpredicted_bucket():
    reg = ProgramRegistry()
    reg.expect("f", "batch", budget=3, allow={1, 2, 4})
    census = Census("cpu")
    census.attach_xray(reg, "f")
    census.capture((3, ()), _matmul_step(3), kind="batch", rows=3)
    assert reg.drift_count() == 1
    assert "not in the predicted bucket ladder" in reg.drifts()[0]["reason"]


def test_reinstalled_expectation_retires_stale_drift():
    reg = ProgramRegistry()
    reg.expect("s", "stage", budget=1)
    census = Census("cpu")
    census.attach_xray(reg, "s")
    census.capture(("stage", 2), _matmul_step(2))
    census.capture(("stage", 3), _matmul_step(3))
    assert reg.drift_count() == 1
    reg.expect("s", "stage", budget=1)
    assert reg.drift_count() == 0
    assert reg.census()["s/stage"]["live_compiles"] == 0


def test_drift_dumps_ring_and_records_span():
    recorder.configure("ring")
    recorder.record("stage", "ctx", 1, time.monotonic_ns(), 1000)
    reg = ProgramRegistry()
    reg.expect("s", "stage", budget=1)
    census = Census("cpu")
    census.attach_xray(reg, "s")
    census.capture(("stage", 2), _matmul_step(2))
    census.capture(("stage", 3), _matmul_step(3))
    assert "xray.drift" in {e.kind for e in recorder.events()}


# -- pipelines ------------------------------------------------------------------

def test_clean_pipeline_census_budgets_equal_jax():
    # the gauges are published while the pipeline's steps (which the
    # registry holds weakly) are alive
    outs, rep = _run(DESC.format(acc=ACC + " "), _frames(32), queue_capacity=32,
                     batch_max=4, xray=True, trace_mode="ring", explain=True,
                     before_stop=registry.publish)
    assert len(outs) == 32
    assert rep["census"]["drift_total"] == 0
    e = rep["census"]["programs"]["f/batch"]
    _, ref = _run(DESC.format(acc=""), _frames(32), mod=nt, queue_capacity=32,
                  batch_max=4, data_parallel=1, xray=True, explain=True)
    want = ref["census"]["programs"]["f/batch"]
    assert (e["predicted"], e["allow"]) == (want["predicted"], want["allow"]) == (3, [1, 2, 4])
    assert e["within"] and e["live_compiles"] >= 1
    # the JAX package also budgets the single-buffer program of a batching
    # stage; here a batching stage's one buffer is bucket 1's step
    assert "f/stage" in ref["census"]["programs"]
    assert "f/stage" not in rep["census"]["programs"]
    text = metrics_text()
    assert "nnstpu_f_mfu" in text and "nnstpu_f_roofline_fraction" in text
    assert "nnstpu_xray_census_drift 0" in text
    json.dumps(rep)
    assert rep["ok"] is True and rep["plan"]["batch_max"] == 4
    assert rep["device_time"]["f"]["dispatches"] >= 1


def test_adaptive_ladder_budget_equals_jax():
    kw = dict(queue_capacity=32, batch_max=8, adaptive_buckets=True, xray=True,
              explain=True)
    _, rep = _run(DESC.format(acc=ACC + " "), _frames(24), **kw)
    _, ref = _run(DESC.format(acc=""), _frames(24), mod=nt, data_parallel=1, **kw)
    assert rep["census"]["programs"]["f/batch"]["predicted"] == \
        ref["census"]["programs"]["f/batch"]["predicted"]
    assert rep["census"]["drift_total"] == 0


def test_lone_filter_without_batching_is_noted_eager():
    _, rep = _run(DESC.format(acc=ACC + " "), _frames(4), xray=True, explain=True)
    assert rep["census"]["programs"] == {}
    assert rep["census"]["eager"] == [
        {"stage": "f", "what": "invoke (uncaptured single stage)"}]


def test_fused_stage_census_within_budget():
    desc = (f"appsrc name=src caps=other/tensors,dimensions={DIMS},types=float32 ! "
            "tensor_transform mode=arithmetic option=mul:2.0 name=t ! "
            f"tensor_filter framework=jax model=scaler custom=scale:2.0,dims:{DIMS} "
            f"name=f {ACC} ! tensor_sink name=out")
    outs, rep = _run(desc, _frames(6), xray=True, explain=True)
    assert len(outs) == 6
    e = rep["census"]["programs"]["t+f/stage"]
    assert e["predicted"] == 2 and e["live_compiles"] == 1 and e["within"]


def test_pad_waste_flops_counts_padded_rows():
    outs = _run(DESC.format(acc=ACC + " "), _frames(3), queue_capacity=16,
                batch_max=4, batch_linger_ms=150.0, xray=True)
    assert len(outs) == 3
    snap = metrics.snapshot()
    if snap.get("f.batch_pad_waste", 0) > 0:
        assert snap.get("f.pad_waste_flops", 0) > 0


def test_device_track_in_chrome_trace(tmp_path):
    _run(DESC.format(acc=ACC + " "), _frames(24), queue_capacity=32, batch_max=4,
         xray=True, trace_mode="ring")
    out = tmp_path / "trace.json"
    tracing.dump_chrome(recorder.events(), str(out))
    with open(out) as f:
        obj = json.load(f)
    assert not tracing.validate_chrome(obj)
    names = {e["args"]["name"] for e in obj["traceEvents"]
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert any(n.startswith("device:") for n in names)
    assert any(e.get("name") == "device" for e in obj["traceEvents"])


def test_hbm_ledger_params_match_deep_estimate():
    _, rep = _run(DESC.format(acc=ACC + " "), _frames(8), queue_capacity=16,
                  batch_max=4, xray=True, explain=True)
    params = rep["hbm"]["categories"]["params"]
    assert params["predicted"] and params["measured"] == params["predicted"]
    for cat in ("kv_pool", "agg_rings", "activations"):
        assert rep["hbm"]["categories"][cat]["ok"]


def test_second_pipeline_same_stage_names_no_false_drift():
    for _ in range(2):
        _, rep = _run(DESC.format(acc=ACC + " "), _frames(12), queue_capacity=16,
                      batch_max=4, xray=True, explain=True)
        assert rep["census"]["drift_total"] == 0
        assert rep["census"]["programs"]["f/batch"]["within"]
    assert registry.drift_count() == 0


def test_explain_works_without_xray():
    _, rep = _run(DESC.format(acc=ACC + " "), _frames(4), queue_capacity=8,
                  explain=True)
    assert rep["xray"] is False and rep["census"]["programs"] == {}
    assert rep["ok"] is True
    json.dumps(rep)


def test_explain_after_stop_does_not_reload_frameworks():
    p = ntt.Pipeline(DESC.format(acc=ACC + " "), queue_capacity=8, xray=True)
    with p:
        p.push("src", ntt.Buffer([_frames(1)[0]]))
        p.pull("out", timeout=60)
        p.eos()
        p.wait(timeout=60)
    assert p.element("f").fw is None
    rep = p.explain()
    assert p.element("f").fw is None
    assert rep["hbm"]["categories"]["params"]["measured"] == 0


def test_xray_off_structural_pin(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("xray hook ran with xray off")

    for name in ("register", "expect", "note_eager"):
        monkeypatch.setattr(ProgramRegistry, name, boom)
    for name in ("begin", "end", "add_time", "add_work"):
        monkeypatch.setattr(TrackedStep, name, boom)
    monkeypatch.setattr(Census, "attach_xray", boom)
    outs = _run(DESC.format(acc=ACC + " "), _frames(12), queue_capacity=16,
                batch_max=4, trace_mode="ring")
    assert len(outs) == 12
    assert registry.drift_count() == 0
    assert "compiles" not in metrics_text()


# -- the llm loop, the aggregator, the trainer ----------------------------------

LLM = ("appsrc name=src ! tensor_filter name=f framework=llm model=llama_tiny "
       "custom=max_new:4,stream_chunk:2,dtype:float32,serve:continuous,slots:2,"
       f"block_size:8{{extra}} {ACC} invoke-dynamic=true ! tensor_sink name=out")


def _serve(desc, prompts, **kw):
    p = ntt.Pipeline(desc, xray=True, **kw)
    with p:
        for t in prompts:
            p.push("src", np.arange(1, t + 1, dtype=np.int32))
        bufs = [p.pull("out", timeout=120) for _ in range(4 * len(prompts))]
        rep = p.explain()
        loop = p.element("f").fw._serve
        fw = p.element("f").fw
        extra = fw.census.capture  # for the drift test, while the loop lives
        p.eos("src")
        p.wait(timeout=120)
    return bufs, rep, loop, extra


def test_llm_serve_loop_census_as_serving_plan_predicts():
    from nnstreamer_tpu_torch.filters.llm import serving_plan
    from nnstreamer_tpu_torch.models import llama

    bufs, rep, loop, _ = _serve(LLM.format(extra=""), (3, 6, 9, 4))
    assert sum(bool(b.meta.get("stream_last")) for b in bufs) == 4
    progs = rep["census"]["programs"]
    plan = serving_plan(llama.resolve_config("llama_tiny", {}), slots=2,
                        block_size=8, dtype="float32")
    e = progs["f.serve/continuous"]
    assert e["predicted"] == plan["programs"] == 1 and e["live_compiles"] == 1
    assert rep["census"]["drift_total"] == 0
    assert {"stage": "f.serve", "what": "prefill chunks (uncaptured)"} in \
        rep["census"]["eager"]
    cats = rep["hbm"]["categories"]
    assert cats["params"]["measured"] == cats["params"]["predicted"] > 0
    # the pool carries one write-sink block past the priced ones
    assert cats["kv_pool"]["measured"] == \
        cats["kv_pool"]["predicted"] * (loop.n_blocks + 1) // loop.n_blocks
    assert rep["ok"] is True


def test_llm_unpredicted_capture_fires_drift_in_pipeline():
    _, rep, loop, capture = _serve(LLM.format(extra=""), (5,))
    assert rep["census"]["drift_total"] == 0
    # a second decode signature captured into the live loop's census
    capture(("continuous", 3, "float32", False), lambda: None)
    assert registry.drift_count() == 1
    d = registry.drifts()[0]
    assert d["stage"] == "f.serve" and d["kind"] == "continuous"
    assert "arg 1: 3 ⊄ predicted 2" in d["diff"]


def test_llm_spec_loop_census_is_propose_and_verify():
    _, rep, _, _ = _serve(LLM.format(extra=",draft:llama_tiny,spec_k:2"), (4, 7))
    progs = rep["census"]["programs"]
    assert {k for k in progs if k.startswith("f.serve/")} == \
        {"f.serve/propose", "f.serve/verify"}
    assert all(progs[k]["live_compiles"] == 1 for k in progs if k.startswith("f.serve/"))
    assert rep["census"]["drift_total"] == 0


def test_decode_step_flops_against_the_hand_count():
    """The decode step's static FLOPs (its warm-up's count, the int4
    kernel entry reporting its own) against the hand count of every
    projection and the lm_head at 2 rows, within 1% (the norms' and
    rope's elementwise work is not counted)."""
    from nnstreamer_tpu_torch.models import llama

    _, rep, _, _ = _serve(LLM.format(extra=",quant:int4"), (4, 6))
    cfg = llama.resolve_config("llama_tiny", {})
    L, D, H, Hkv, F = cfg.n_layers, cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.ffn_hidden
    hd = cfg.head_dim
    hand = 2.0 * 2 * (L * (D * H * hd + 2 * D * Hkv * hd + H * hd * D + 3 * D * F)
                      + D * cfg.vocab)
    st = rep["device_time"]["f.serve"]
    assert abs(st["static_flops"] - hand) <= 0.01 * hand
    # the int4 weights are read once a step, and the live contexts' K/V
    # rows on top (Step.add_work)
    assert st["static_bytes"] >= hand / 8
    assert st["flops_total"] / st["dispatches"] > st["static_flops"]


def test_aggregator_ring_in_the_ledger():
    desc = ("appsrc name=src caps=other/tensors,dimensions=8,types=float32 ! "
            "tensor_aggregator frames_in=1 frames_out=4 frames_dim=0 device=true "
            "name=agg ! tensor_sink name=out")
    p = ntt.Pipeline(desc, xray=True)
    with p:
        p.element("agg").ring_device = torch.device("cpu")
        for i in range(8):
            p.push("src", np.full((8,), float(i), np.float32))
        wins = [p.pull("out", timeout=60) for _ in range(2)]
        rep = p.explain()
        p.eos()
        p.wait(timeout=60)
    assert len(wins) == 2
    rings = rep["hbm"]["categories"]["agg_rings"]
    assert rings["measured"] == rings["predicted"] == 2 * (4 + 1) * 8 * 4
    assert rep["census"]["programs"] == {} and rep["census"]["drift_total"] == 0


def test_trainer_census_and_train_state(tmp_path):
    rng = np.random.default_rng(0)
    data, meta = tmp_path / "d.bin", tmp_path / "d.json"
    with open(data, "wb") as f:
        for _ in range(16):
            f.write(rng.standard_normal(4).astype(np.float32).tobytes())
            f.write(np.int32(rng.integers(0, 3)).tobytes())
    json.dump({"dims": "4,1", "types": "float32,int32", "total_samples": 16,
               "sample_size": 20}, open(meta, "w"))
    p = ntt.Pipeline(
        f"datareposrc location={data} json={meta} epochs=2 ! "
        "tensor_trainer framework=jax model=mlp:4:8:3 name=learn "
        "num-training-samples=12 num-validation-samples=4 epochs=2 "
        f"batch-size=4 {ACC} ! tensor_sink name=stats", xray=True)
    with p:
        for _ in range(2):
            p.pull("stats", timeout=60)
        rep = p.explain()
        p.wait(timeout=60)
    progs = rep["census"]["programs"]
    assert progs["learn.learn/step"]["live_compiles"] == 1
    assert progs["learn.learn/eval"]["live_compiles"] == 1
    assert rep["census"]["drift_total"] == 0
    ts = rep["hbm"]["categories"]["train_state"]
    assert ts["measured"] == ts["predicted"] > 0


def test_all_pipeline_threads_stop_on_stop():
    slo = {"tenants": [{"tenant": "t", "p99_ms": 10000.0}]}
    kw = dict(queue_capacity=8, batch_max=2, xray=True, trace_mode="ring",
              slo=slo, tenant="t")
    _run(DESC.format(acc=ACC + " "), _frames(4), **kw)
    before = set(threading.enumerate())
    _run(DESC.format(acc=ACC + " "), _frames(4), **kw)
    deadline = time.monotonic() + 3.0
    while time.monotonic() < deadline:
        leaked = [t for t in threading.enumerate() if t not in before and t.is_alive()]
        if not leaked:
            break
        time.sleep(0.05)
    assert not leaked, f"threads leaked past stop(): {leaked}"
    names = {t.name for t in threading.enumerate()}
    for prefix in ("nns-sampler", "nns-xray", "nns-slo"):
        assert not any(n.startswith(prefix) for n in names), names


def test_peaks_are_the_cards_and_config_overrides():
    from nnstreamer_tpu_torch.core.config import Config, get_config, set_config

    assert xray._PEAKS_BY_NAME[0] == ("H100", 989.0, 3350.0)
    old = get_config()
    try:
        set_config(Config(peak_tflops=123.0))
        assert xray.peak_flops() == 123.0e12
    finally:
        set_config(old)


def test_chip_smoke_xray_quickstart_rehearses_on_the_cpu():
    """The xray phase's quick-start part (mobilenet_v1 through the batching
    runner, a burst of frames, xray on) and its scrape, at 32x32 on the
    CPU: bucket drift 0, every category ok, the occupancy histogram
    parsed."""
    import chip_smoke

    q = chip_smoke.xray_quickstart(torch.device("cpu"), size=32, acc=ACC, frames_n=21)
    assert q["drift_total"] == 0
    batch = next(v for k, v in q["census"].items() if k.endswith("/batch"))
    assert batch["allow"] == [1, 2, 4, 8] and 1 <= batch["live"] <= 4
    assert q["scrape"]["count"] >= 1 and q["scrape"]["buckets"][-1][0] == "+Inf"
    assert q["pad_waste_flops"] >= 0 and q["device_time"]["dispatches"] >= 1
