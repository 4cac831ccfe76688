"""Training in a pipeline and train-while-serve in the port, against the
JAX package's (``nnstreamer_tpu/elements/trainer.py``,
``Pipeline.swap_params``, ``TensorFilter.swap_params``,
``LLMFramework.swap_params``; ``tests/test_learn.py``), on the CPU.

Tolerances: the element's stats against the JAX pipeline's within 2e-5 at
float32 (``tests/test_torch_trainer.py``); everything the port holds
against itself (a no-op swap, a swap back, served outputs against a fresh
model over the trainer's exported tree) bitwise.  Every path is a
``tmp_path``, every pull and wait has a timeout, every loop started is
closed.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as ntt
from nnstreamer_tpu_torch.filters.base import FrameworkError, tree_map
from nnstreamer_tpu_torch.models import llama, mobilenet as tmob
from nnstreamer_tpu_torch.models.zoo import ModelBundle
from nnstreamer_tpu_torch.core.types import TensorsSpec
from nnstreamer_tpu_torch.filters import llm as tllm
from nnstreamer_tpu_torch.filters.device_fw import DeviceFramework
from nnstreamer_tpu_torch.pipeline.runtime import PipelineError
from nnstreamer_tpu_torch.trainer.checkpoint import load_checkpoint
from nnstreamer_tpu_torch.trainer.subplugin import Trainer, _build_mlp
from nnstreamer_tpu_torch.utils import tracing

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
ACC = "accelerator=true:cpu"
TOL = 2e-5


def _toy(n=24, in_dim=4, classes=3, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((in_dim, classes)).astype(np.float32)
    xs = rng.standard_normal((n, in_dim)).astype(np.float32)
    ys = np.argmax(xs @ w, axis=1).astype(np.int32)[:, None]
    return xs, ys


def _write_dataset(tmp_path, n=24, seed=0, name="data"):
    xs, ys = _toy(n, seed=seed)
    data, meta = tmp_path / f"{name}.bin", tmp_path / f"{name}.json"
    with open(data, "wb") as f:
        for i in range(n):
            f.write(xs[i].tobytes())
            f.write(ys[i].tobytes())
    json.dump({"dims": "4,1", "types": "float32,int32", "total_samples": n,
               "sample_size": 20}, open(meta, "w"))
    return str(data), str(meta), xs, ys


def _trainer(props):
    tr = Trainer()
    tr.open({**props, "accelerator": "true:cpu"})
    return tr


def _train(tr, xs, ys):
    for i in range(len(xs)):
        tr.push_data([xs[i]], [ys[i]], False)
    return tr.train_epoch()


def _pull_stats(p, n):
    return [np.asarray(p.pull("stats", timeout=60).tensors[0]) for _ in range(n)]


# -- tensor_trainer --------------------------------------------------------------

def test_element_epochs_against_jax(tmp_path):
    """datareposrc ! tensor_trainer ! tensor_sink, 3 epochs of 20 training
    and 4 validation samples: the port's stats buffers (float64 [4]) within
    2e-5 of the JAX pipeline's, epoch by epoch; the JAX package's pipeline
    string runs as written plus ``accelerator=``."""
    data, meta, _, _ = _write_dataset(tmp_path)
    desc = (f"datareposrc location={data} json={meta} epochs=3 ! "
            "tensor_trainer framework=jax model=mlp:4:16:3 optimizer=adam "
            "learning-rate=0.05 num-training-samples=20 num-validation-samples=4 "
            "epochs=3 batch-size=8 {acc}! tensor_sink name=stats")
    got = []
    for mod, acc in ((nt, ""), (ntt, ACC + " ")):
        p = mod.Pipeline(desc.format(acc=acc))
        with p:
            got.append(_pull_stats(p, 3))
            p.wait(timeout=30)
    for a, b in zip(*got):
        assert b.dtype == np.float64 and b.shape == (4,)
        np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)


def test_stats_buffer_rides_trace_and_tenant_rails(tmp_path):
    """Stats buffers inherit the triggering sample's trace id and tenant,
    and every epoch records a ``learn.step`` span, which the Chrome dump
    carries."""
    data, meta, _, _ = _write_dataset(tmp_path, n=8)
    p = ntt.Pipeline(
        f"datareposrc location={data} json={meta} epochs=2 ! "
        "tensor_trainer framework=jax model=mlp:4:8:3 name=learn "
        "num-training-samples=8 epochs=2 batch-size=8 "
        f"learning-rate=0.05 {ACC} ! tensor_sink name=stats",
        trace_mode="ring", tenant="lab")
    with p:
        bufs = [p.pull("stats", timeout=60) for _ in range(2)]
        p.wait(timeout=30)
    for b in bufs:
        assert b.meta.get(tracing.META_TRACE_ID) is not None
        assert b.meta.get(tracing.META_TENANT) == "lab"
    steps = [e for e in tracing.recorder.events()
             if e.kind == "learn.step" and e.stage == "learn"]
    assert len(steps) == 2
    assert all(e.args.get("tenant") == "lab" and e.tid is not None for e in steps)
    out = str(tmp_path / "trace.json")
    assert p.dump_trace(out) > 0
    assert any(e["name"] == "learn.step"
               for e in json.load(open(out))["traceEvents"] if e.get("ph") == "X")


def test_element_periodic_step_versioned_checkpoints(tmp_path):
    """``checkpoint-every=1`` writes the checkpoint and a step-versioned
    sibling per epoch (``learn.ckpt`` spans); ``model-load-path`` through
    the element continues where the killed pipeline stopped."""
    data, meta, _, _ = _write_dataset(tmp_path, n=16)
    ck = str(tmp_path / "m.ckpt")
    p = ntt.Pipeline(
        f"datareposrc location={data} json={meta} epochs=2 ! "
        "tensor_trainer framework=jax model=mlp:4:8:3 num-training-samples=16 "
        f"epochs=2 batch-size=8 learning-rate=0.05 checkpoint-every=1 "
        f"model-save-path={ck} {ACC} ! tensor_sink name=stats", trace_mode="ring")
    with p:
        _pull_stats(p, 2)
        p.wait(timeout=30)
    assert sorted(f for f in os.listdir(tmp_path) if ".step" in f) == ["m.ckpt.step2"]
    kinds = {e.kind for e in tracing.recorder.events()}
    assert "learn.ckpt" in kinds and "learn.step" in kinds
    params, opt, step = load_checkpoint(ck)
    assert step == 4 and opt["optimizer"] == "adam" and opt["count"] == 4
    resumed = ntt.Pipeline(
        f"datareposrc location={data} json={meta} epochs=1 ! "
        "tensor_trainer framework=jax model=mlp:4:8:3 num-training-samples=16 "
        f"epochs=1 batch-size=8 learning-rate=0.05 model-load-path={ck} "
        f"model-save-path={ck}.more {ACC} ! tensor_sink name=stats")
    with resumed:
        _pull_stats(resumed, 1)
        resumed.wait(timeout=30)
    assert load_checkpoint(f"{ck}.more")[2] == step + 2  # continued, not restarted


def test_finalize_trains_the_partial_epoch(tmp_path):
    """At EOS a partial epoch trains on what arrived (20 samples against
    epochs of 16: one full epoch, then 4 samples through one masked step of
    the same capture), emits its stats and saves."""
    data, meta, _, _ = _write_dataset(tmp_path, n=20)
    ck = str(tmp_path / "p.ckpt")
    p = ntt.Pipeline(
        f"datareposrc location={data} json={meta} ! "
        "tensor_trainer framework=jax model=mlp:4:8:3 name=learn "
        "num-training-samples=16 epochs=2 batch-size=8 learning-rate=0.05 "
        f"model-save-path={ck} {ACC} ! tensor_sink name=stats")
    with p:
        stats = _pull_stats(p, 2)
        p.wait(timeout=30)
    assert all(np.isfinite(s[0]) for s in stats)
    assert load_checkpoint(ck)[2] == 3
    tr = p.element("learn").trainer
    assert tr.compile_counts() == {"step": 1}


def test_sink_capture_manifest_replays(tmp_path):
    """datareposink manifest=true capture -> datareposrc replay by json=
    alone -> tensor_trainer learns from it."""
    xs, ys = _toy(16)
    data, meta = str(tmp_path / "cap.bin"), str(tmp_path / "cap.json")
    cap = ntt.Pipeline(f"appsrc name=src ! datareposink location={data} "
                       f"json={meta} manifest=true")
    with cap:
        for i in range(16):
            cap.push("src", [xs[i], ys[i]])
        cap.eos()
        cap.wait(timeout=30)
    p = ntt.Pipeline(
        f"datareposrc json={meta} epochs=2 is-shuffle=true ! "
        "tensor_trainer framework=jax model=mlp:4:8:3 num-training-samples=16 "
        f"epochs=2 batch-size=8 learning-rate=0.1 {ACC} ! tensor_sink name=stats")
    with p:
        s = _pull_stats(p, 2)
        p.wait(timeout=30)
    assert s[1][0] < s[0][0]


def test_training_example_runs_on_the_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, str(REPO / "examples" / "torch_training.py"), "--cpu",
         "--dir", str(tmp_path)], cwd=str(REPO),
        env=dict(os.environ, PYTHONPATH=str(REPO)),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.count("epoch ") == 3
    assert "checkpoint written: True" in out.stdout


# -- train-while-serve ----------------------------------------------------------

def serve_mlp_bundle(opts=None, device="cpu"):
    """A serving model with the tree of ``model=mlp:4:8:3``'s trainer,
    applied per vector."""
    params, apply = _build_mlp([4, 8, 3], 0, device)
    return ModelBundle(apply_fn=lambda p, x: apply(p, x[None])[0], params=params,
                       in_spec=TensorsSpec.from_string("4", "float32"),
                       out_spec=TensorsSpec.from_string("3", "float32"))


SERVE_MODEL = "tests.test_torch_learn:serve_mlp_bundle"
SERVE_DESC = ("appsrc name=in ! other/tensors,dimensions=4,types=float32 ! "
              f"tensor_filter framework=jax model={SERVE_MODEL} name=serve {ACC} ! "
              "tensor_sink name=out")


def _served(p, x):
    p.push("in", [x])
    return np.asarray(p.pull("out", timeout=10).tensors[0])


def test_noop_swap_bit_identity_then_update():
    """A no-op swap leaves the outputs bitwise unchanged; a trained tree is
    served from the next dispatch, bitwise the trainer's apply; the live
    tensors keep their storage."""
    p = ntt.Pipeline(SERVE_DESC, trace_mode="ring")
    with p:
        x = np.arange(4, dtype=np.float32)
        o1 = _served(p, x)
        fw = p.element("serve").fw
        ptrs = [t.data_ptr() for t in (fw.bundle.params[0]["w"], fw.bundle.params[1]["b"])]
        clone = tree_map(lambda a: a.numpy().copy(), fw.bundle.params)
        v1 = p.swap_params("serve", clone)
        np.testing.assert_array_equal(o1, _served(p, x))
        tr = _trainer({"model": "mlp:4:8:3", "learning_rate": 0.5, "batch_size": 4})
        xs, ys = _toy(8)
        _train(tr, xs, ys)
        v2 = p.swap_params("serve", tr.export_params())
        o3 = _served(p, x)
        assert not np.array_equal(o1, o3)
        with torch.no_grad():
            want = fw.bundle.apply_fn(tr.export_params(), torch.from_numpy(x))
        np.testing.assert_array_equal(o3, want.numpy())
        assert ptrs == [t.data_ptr() for t in (fw.bundle.params[0]["w"],
                                                fw.bundle.params[1]["b"])]
        # the swap copied: training on does not change what is served
        _train(tr, xs, ys)
        np.testing.assert_array_equal(o3, _served(p, x))
        p.eos()
        p.wait(timeout=10)
    assert (v1, v2) == (1, 2) and p.element("serve")._param_version == 2
    assert sum(e.kind == "learn.swap" for e in tracing.recorder.events()) >= 2


def test_swap_mismatch_raises_named():
    p = ntt.Pipeline(SERVE_DESC)
    with p:
        with pytest.raises(PipelineError, match="mismatch"):
            p.swap_params("serve", {"wrong": np.zeros(3, np.float32)})
        tr = _trainer({"model": "mlp:4:16:3"})  # wrong hidden width
        with pytest.raises(PipelineError, match="leaf 0 mismatch"):
            p.swap_params("serve", tr.export_params())
        bad = tree_map(lambda a: a.numpy().astype(np.float64),
                       p.element("serve").fw.bundle.params)
        with pytest.raises(PipelineError, match="float64"):
            p.swap_params("serve", bad)
        assert p.element("serve")._param_version == 0
        p.eos()
        p.wait(timeout=10)


def test_framework_without_swap_raises_named():
    from nnstreamer_tpu_torch.filters.base import Framework

    with pytest.raises(FrameworkError, match="does not support param hot-swap"):
        Framework().swap_params({})


def test_swap_on_fused_stage_raises_named():
    desc = ("appsrc name=in ! other/tensors,dimensions=4,types=float32 ! "
            "tensor_transform mode=arithmetic option=mul:2.0 ! "
            f"tensor_filter framework=jax model={SERVE_MODEL} name=serve {ACC} ! "
            "tensor_sink name=out")
    p = ntt.Pipeline(desc)
    with p:
        with pytest.raises(PipelineError, match="fused"):
            p.swap_params("serve", {})
        p.eos()
        p.wait(timeout=10)


def test_swap_on_batched_stage_raises_named():
    p = ntt.Pipeline(SERVE_DESC, batch_max=4)
    with p:
        with pytest.raises(PipelineError, match="micro-batched"):
            p.swap_params("serve", {})
        p.eos()
        p.wait(timeout=10)


def test_filter_refuses_while_it_holds_bucket_steps():
    """The element's own guard: bucket steps close over the weights they
    were built with."""
    p = ntt.Pipeline(SERVE_DESC)
    el = p.element("serve")
    with p:
        el._batchers = {1: (None, None)}
        with pytest.raises(FrameworkError, match="micro-batched"):
            el.swap_params({})
        el._batchers = {}
        p.eos()
        p.wait(timeout=10)


def test_swap_from_checkpoint_path(tmp_path):
    xs, ys = _toy(8)
    tr = _trainer({"model": "mlp:4:8:3", "learning_rate": 0.5, "batch_size": 4})
    _train(tr, xs, ys)
    ck = tr.save(str(tmp_path / "swap.ckpt"))
    p = ntt.Pipeline(SERVE_DESC)
    with p:
        x = np.arange(4, dtype=np.float32)
        o1 = _served(p, x)
        assert p.swap_params("serve", ck) == 1
        o2 = _served(p, x)
        assert not np.array_equal(o1, o2)
        with torch.no_grad():
            want = p.element("serve").fw.bundle.apply_fn(tr.export_params(),
                                                          torch.from_numpy(x))
        np.testing.assert_array_equal(o2, want.numpy())
        p.eos()
        p.wait(timeout=10)


def test_train_while_serve_e2e():
    """Live traffic tee'd into a trainer (inputs and labels from the stream;
    the serving filter takes the input through input-combination), whose
    ``swap-to`` copies each epoch's parameters into the serving stage:
    3 swaps under live traffic, each served output bitwise the trainer's
    exported tree applied afresh, ``learn.swap`` and ``learn.step``
    spans."""
    desc = ("appsrc name=in ! other/tensors,dimensions=4.1,types=float32.int32 ! "
            "tee name=t "
            f"t. ! tensor_filter framework=jax model={SERVE_MODEL} name=serve "
            f"input-combination=0 {ACC} ! tensor_sink name=out "
            "t. ! tensor_trainer framework=jax model=mlp:4:8:3 name=learn "
            "num-training-samples=8 epochs=3 batch-size=8 learning-rate=0.5 "
            f"swap-to=serve {ACC} ! tensor_sink name=stats")
    xs, ys = _toy(24, seed=3)
    p = ntt.Pipeline(desc, trace_mode="ring")
    serve_el = p.element("serve")
    with p:
        tr = p.element("learn").trainer
        fw = serve_el.fw
        x0 = np.arange(4, dtype=np.float32)
        outs = []
        for epoch in range(3):
            for i in range(8):
                p.push("in", [xs[epoch * 8 + i], ys[epoch * 8 + i]])
            _pull_stats(p, 1)  # the epoch's swap has landed
            for i in range(8):  # the served training samples
                p.pull("out", timeout=30)
            # live traffic between epochs: the probe (the tee banks it into
            # the trainer's next epoch too)
            p.push("in", [x0, np.asarray([0], np.int32)])
            outs.append(np.asarray(p.pull("out", timeout=30).tensors[0]))
            with torch.no_grad():
                want = fw.bundle.apply_fn(tr.export_params(), torch.from_numpy(x0))
            np.testing.assert_array_equal(outs[-1], want.numpy())
        p.eos()
        p.wait(timeout=60)
    assert serve_el._param_version >= 2
    assert not np.array_equal(outs[0], outs[-1])
    kinds = [e.kind for e in tracing.recorder.events()]
    assert "learn.swap" in kinds and "learn.step" in kinds


def test_device_fw_swap_of_a_float32_tree_equals_a_fresh_bundle():
    """The vision filter takes the model's float32 tree (what a trainer
    exports) and copies it into its bf16 channels_last params: the served
    logits are bitwise those of a bundle built from that tree."""
    fw = DeviceFramework()
    opts = "width:0.25,size:32,classes:4"
    fw.open({"model": "mobilenet_v1", "custom": opts, "accelerator": "true:cpu"})
    live = fw.bundle.params["block3"]["pw"]
    tr = _trainer({"model": "mobilenet_v1", "width": "0.25", "size": "32",
                   "classes": "4", "batch_size": 2, "learning_rate": 0.01})
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    before = fw.invoke([x])[0]
    fw.swap_params(tr.export_params())  # the same seed: a no-op swap
    torch.testing.assert_close(fw.invoke([x])[0], before, rtol=0, atol=0)
    for i in range(2):
        tr.push_data([x], [np.asarray([i], np.int32)], False)
    tr.train_epoch()
    fw.swap_params(tr.export_params())
    assert fw.bundle.params["block3"]["pw"] is live
    assert live.dtype == torch.bfloat16 and live.is_contiguous(
        memory_format=torch.channels_last)
    fresh = tmob.build_bundle(tree_map(lambda t: t.detach(), tr.export_params()),
                              {"width": "0.25", "size": "32", "classes": "4"}, "fresh")
    with torch.no_grad():
        want = fresh.apply_fn(fresh.params, torch.from_numpy(x))
    got = fw.invoke([x])[0]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not torch.equal(got, before)
    with pytest.raises(FrameworkError, match="mismatch"):
        fw.swap_params(tmob.init_params(width=0.5, classes=4))


# -- the llm filter: the continuous loop and the static path --------------------

LLM_OPTS = "max_new:10,temperature:0.0,dtype:float32,"
LOOP = (LLM_OPTS + "serve:continuous,slots:2,stream_chunk:2,block_size:8,"
        "prefill_chunk:8")


def _llm(custom):
    fw = tllm.LLMFramework()
    fw.open({"model": "llama_tiny", "custom": custom, "accelerator": "true:cpu"})
    return fw


class _Collector:
    def __init__(self):
        import threading

        self.ids = []
        self.done = threading.Event()

    def __call__(self, tensors, meta):
        self.ids.append(int(np.asarray(tensors[0])[0]))
        if meta.get("stream_last"):
            self.done.set()


def _stream(fw, prompt):
    c = _Collector()
    fw.submit([np.asarray(prompt, np.int32)], {}, c)
    assert c.done.wait(60)
    return c.ids


def test_llm_serve_loop_swap_census():
    """A swap into a LIVE continuous loop runs at a chunk boundary: a no-op
    swap keeps the greedy stream bitwise; a swap to another tree (seed 1)
    changes it; a swap back gives the first stream again; the loop keeps
    its one captured decode step throughout (no recapture), and the
    version, counter and gauge follow."""
    from nnstreamer_tpu_torch.core.log import metrics

    fw = _llm(LOOP)
    try:
        prompt = [3, 5, 7, 11, 13, 17, 19, 23, 29]
        a_ids = _stream(fw, prompt)
        loop = fw._serve
        assert fw.census.captures == 1
        tree_a = tree_map(lambda t: t.clone(), fw.bundle.params)
        swaps = metrics.snapshot().get("llm.serve.param_swaps", 0.0)
        assert fw.swap_params(tree_a) == 1
        assert _stream(fw, prompt) == a_ids
        tree_b = llama.init_params(fw.cfg, seed=1, dtype="float32", device="cpu")
        assert fw.swap_params(tree_b) == 2
        assert not loop._prefix_index  # K/V of the old weights is not reused
        b_ids = _stream(fw, prompt)
        assert b_ids != a_ids
        assert fw.swap_params(tree_a) == 3
        assert _stream(fw, prompt) == a_ids
        assert fw.census.captures == 1 and len(fw.census.signatures) == 1
        assert loop.param_version == 3
        assert metrics.snapshot()["llm.serve.param_swaps"] == swaps + 3
        assert metrics.gauges()["llm.serve.param_version"] == 3.0
        with pytest.raises(FrameworkError, match="mismatch"):
            fw.swap_params({"nope": np.zeros(2, np.float32)})
        half = tree_map(lambda t: t.to(torch.bfloat16), tree_a)
        with pytest.raises(FrameworkError, match="mismatch"):
            fw.swap_params(half)
        assert _stream(fw, prompt) == a_ids
    finally:
        fw.close()


def test_llm_static_swap_between_requests():
    """The static path copies in place between requests: each decode set
    captured its step over the live tensors, and an idle set is reused
    after the swap, serving the new weights."""
    fw = _llm(LLM_OPTS)
    try:
        prompt = np.asarray([3, 5, 7], np.int32)
        a_ids = fw.invoke([prompt])[0]
        tree_a = tree_map(lambda t: t.clone(), fw.bundle.params)
        assert fw.swap_params(llama.init_params(fw.cfg, seed=1, device="cpu")) is None
        b_ids = fw.invoke([prompt])[0]
        assert not np.array_equal(a_ids, b_ids)
        assert fw.census.captures == 1  # the idle set was reused
        fw.swap_params(tree_a)
        np.testing.assert_array_equal(fw.invoke([prompt])[0], a_ids)
        gen = fw.invoke_stream([prompt])
        next(gen)  # a request in flight: a swap waits for it, then times out
        with pytest.raises(FrameworkError, match="still running"):
            fw.swap_params(tree_a, timeout=0.2)
        gen.close()
        fw.swap_params(tree_a, timeout=5)
    finally:
        fw.close()


def test_chip_smoke_learn_phase_rehearsal(tmp_path):
    """``chip_smoke.py``'s learn phase on the CPU at a rehearsal size: the
    straight run, the resume bitwise, the first replay against an eager
    step, the trainer's mesh against mesh-less, train-while-serve with its
    bitwise checks."""
    import chip_smoke

    r = chip_smoke.phase_learn(
        torch.device("cpu"), size=32, classes=4, batch=4, n_train=8, n_valid=4, tail=3,
        acc=ACC, model_opts={"width": "0.25", "dtype": "float32"},
        files_dir=str(tmp_path), timed=2)
    assert r["resume_bitwise"] and r["step_check"]["bitwise"]
    assert r["census"] == {"step": 1, "eval": 1, "captures": 2, "replays": 5, "steps": 5}
    assert r["serve"]["swaps"] == 3
    # the trainer's mesh: data:2 over two slots, its first summed
    # gradient held to mesh-less and data:1 bitwise in the phase; the
    # faults it would catch read far above the tolerance
    m = r["mesh"]
    assert m["census"] == {"step": 1, "captures": 3, "replays": 9, "steps": 4}
    assert m["grad_gap"] <= chip_smoke.LEARN_MESH_GRAD_TOL
    assert min(m["faults"].values()) > 1e3 * chip_smoke.LEARN_MESH_GRAD_TOL
    assert not [f for f in os.listdir(tmp_path) if f.startswith("learn.")]
