"""The port's ``trace``, ``slo`` and ``convert`` CLIs against the JAX
package's on the same inputs: exit codes, stdout and output bytes
(``trace merge`` over a port ring, a JAX ring and an unaligned one, a
non-ring file; ``validate`` and ``summary``; ``slo validate`` and
``report --text`` met and breached; a seeded checkpoint the JAX package
wrote, converted to ``.gguf``, ``.safetensors`` and ``.npz`` at f32, f16
and bf16, and loaded back by the port).  ``trace run`` of a CPU pipeline
writes a clean trace, and ``chip_smoke.py``'s ``weave`` phase rehearses
on the CPU: llama_tiny behind a traced query server, its client in a
child process."""

import json
import os

import numpy as np
import pytest
import torch

import jax

from nnstreamer_tpu.models import checkpoint as jckpt
from nnstreamer_tpu.models import llama as jl
from nnstreamer_tpu.tools import convert as jconvert
from nnstreamer_tpu.tools import slo as jslo
from nnstreamer_tpu.tools import trace as jtrace
from nnstreamer_tpu.utils import tracing as jtracing
from nnstreamer_tpu_torch.core.log import metrics
from nnstreamer_tpu_torch.models import llama as tl
from nnstreamer_tpu_torch.tools import convert as tconvert
from nnstreamer_tpu_torch.tools import slo as tslo
from nnstreamer_tpu_torch.tools import trace as ttrace
from nnstreamer_tpu_torch.utils import profiler
from nnstreamer_tpu_torch.utils import tracing as ttracing
from tests.test_torch_checkpoint import _bits, _flat, _to_hf, _write_config

torch.set_num_threads(2)

SRV_EP, CLI_EP, STRAY_EP = 222, 111, 999


def _cli(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _ring(tracing, path, epoch, proc, spans, clock, monkeypatch):
    """One ring dump by ``tracing`` (either package's module) under the
    trace epoch ``epoch``."""
    rec = tracing.FlightRecorder("ring")
    for pe, (off, unc) in clock.items():
        rec.note_clock(pe, off, unc)
    for kind, stage, tid, ts, dur in spans:
        rec.record(kind, stage, tid, ts, dur)
    monkeypatch.setattr(tracing, "_PROCESS_EPOCH", epoch)
    tracing.dump_ring(str(path), rec=rec, proc=proc)
    monkeypatch.undo()
    return str(path)


@pytest.fixture
def rings(tmp_path, monkeypatch):
    """A server ring dumped by the port, a client ring dumped by the JAX
    package (its clock 0.5 ms behind the server's), a stray ring with no
    clock path, and a file that is not a ring."""
    offset, srv, cli = 500_000, [], []
    for k in range(3):
        tid = (CLI_EP << 32) | (k + 1)
        s = 1_000_000 + k * 100_000
        cli += [("ingress", "src", tid, s - offset - 5_000, 0),
                ("query.send", "qc", tid, s - offset, 0),
                ("query.recv", "qc", tid, s + 60_000 - offset, 0)]
        srv += [("ingress", "ssrc", tid, s + 20_000, 10_000),
                ("query.reply", "ssink", tid, s + 40_000, 0)]
    out = {
        "server": _ring(ttracing, tmp_path / "server.ring", SRV_EP, "server", srv, {},
                        monkeypatch),
        "client": _ring(jtracing, tmp_path / "client.ring", CLI_EP, "client", cli,
                        {SRV_EP: (offset, 2_000)}, monkeypatch),
        "stray": _ring(ttracing, tmp_path / "stray.ring", STRAY_EP, "stray",
                       [("ingress", "s", None, 10, 0)], {}, monkeypatch),
        "notring": str(tmp_path / "notring.ring"),
    }
    with open(out["notring"], "wb") as f:
        f.write(b"definitely not a wire frame")
    return out


@pytest.mark.parametrize("which", [("server", "client"), ("client", "server"),
                                   ("server", "client", "stray"), ("server", "notring")],
                         ids=["port-jax", "jax-port", "unaligned", "not-a-ring"])
def test_trace_merge_equals_the_jax_cli(which, rings, tmp_path, capsys):
    out = str(tmp_path / "merged.json")
    argv = ["merge", *[rings[w] for w in which], "--out", out]
    got = _cli(ttrace.main, argv, capsys)
    got_bytes = open(out, "rb").read() if os.path.exists(out) else None
    if os.path.exists(out):
        os.remove(out)
    want = _cli(jtrace.main, argv, capsys)
    want_bytes = open(out, "rb").read() if os.path.exists(out) else None
    assert got == want and got_bytes == want_bytes
    if "notring" in which:
        assert got[0] == 1 and got_bytes is None and "merge:" in got[2]
        return
    assert got[0] == 0 and "cross-wire arrows" in got[1]
    merged = json.loads(got_bytes)
    assert ttracing.validate_chrome(merged) == []
    align = {a["proc"]: a for a in merged["otherData"]["weave"]}
    assert align["client"]["aligned"] and align["server"]["aligned"]
    if "stray" in which:
        assert "UNALIGNED (no clock path): stray" in got[1]
        assert not align["stray"]["aligned"]
    arrows = [e for e in merged["traceEvents"] if e.get("ph") == "s"]
    assert len(arrows) == 6  # one send -> ingress and one reply -> recv a request


def _merged(rings, tmp_path, capsys):
    out = str(tmp_path / "merged.json")
    assert ttrace.main(["merge", rings["server"], rings["client"], "--out", out]) == 0
    capsys.readouterr()
    return out


def _files(rings, tmp_path, capsys):
    """validate / summary inputs: a merged trace, an empty one, a schema
    violation and an unreadable file."""
    merged = _merged(rings, tmp_path, capsys)
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"traceEvents": []}))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [{"ph": "X", "name": "x", "ts": 5},
                                               {"ph": "X", "name": "y"}]}))
    junk = tmp_path / "junk.json"
    junk.write_text("{not json")
    return dict(merged=merged, empty=str(empty), bad=str(bad), junk=str(junk))


@pytest.mark.parametrize("cmd", ["validate", "summary"])
@pytest.mark.parametrize("which", ["merged", "empty", "bad", "junk"])
def test_trace_validate_and_summary_equal_the_jax_cli(cmd, which, rings, tmp_path, capsys):
    path = _files(rings, tmp_path, capsys)[which]
    got = _cli(ttrace.main, [cmd, path], capsys)
    want = _cli(jtrace.main, [cmd, path], capsys)
    assert got == want
    if which == "merged":
        assert got[0] == 0
        assert got[1].startswith("OK:" if cmd == "validate" else "stage")
    if which == "junk":
        assert got[0] == 1 and "unreadable" in got[2]


def test_trace_run_writes_a_clean_trace(tmp_path, capsys):
    out = str(tmp_path / "run.json")
    rc = ttrace.main(["run", "videotestsrc num-buffers=8 width=16 height=16 ! "
                      "tensor_converter ! tensor_sink", "--out", out, "--timeout", "60"])
    assert rc == 0 and "spans" in capsys.readouterr().out
    with open(out) as f:
        obj = json.load(f)
    assert ttracing.validate_chrome(obj) == []
    assert any(e.get("ph") == "X" for e in obj["traceEvents"])
    assert ttrace.main(["validate", out]) == 0


@pytest.fixture
def exposition(tmp_path):
    """A ``/metrics`` text of two tenants' sink latencies and a shed
    count, rendered by the port (``metrics_text`` is byte-identical to
    the JAX package's)."""
    metrics.reset()
    rng = np.random.default_rng(3)
    for s in rng.uniform(0.001, 0.040, 50):
        metrics.observe_latency("out.e2e_latency", float(s), tenant="gold")
    for s in rng.uniform(0.010, 0.400, 30):
        metrics.observe_latency("out.e2e_latency", float(s), tenant="bronze")
    metrics.count("query_server.shed", 4, tenant="bronze")
    path = tmp_path / "scrape.txt"
    path.write_text(profiler.metrics_text())
    metrics.reset()
    return str(path)


def _policy(tmp_path, name, doc):
    path = tmp_path / name
    path.write_text(json.dumps(doc))
    return str(path)


POLICIES = {
    "met": {"tenants": [{"tenant": "gold", "p50_ms": 100, "p99_ms": 250},
                        {"tenant": "bronze", "p99_ms": 1000}], "sinks": ["out"]},
    "breached": {"tenants": [{"tenant": "gold", "p99_ms": 5},
                             {"tenant": "bronze", "p50_ms": 1}], "sinks": ["out"]},
    "default-sink": {"tenants": [{"tenant": "gold", "p50_ms": 100}]},
    "invalid": {"tenants": [{"tenant": "gold", "p50_ms": -1, "colour": "red"}],
                "extra": 1},
}


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_slo_validate_equals_the_jax_cli(name, tmp_path, capsys):
    path = _policy(tmp_path, "policy.json", POLICIES[name])
    got = _cli(tslo.main, ["validate", path], capsys)
    assert got == _cli(jslo.main, ["validate", path], capsys)
    assert got[0] == (1 if name == "invalid" else 0)


@pytest.mark.parametrize("json_out", [False, True], ids=["table", "json"])
@pytest.mark.parametrize("name", ["met", "breached", "default-sink"])
def test_slo_report_text_equals_the_jax_cli(name, json_out, exposition, tmp_path, capsys):
    path = _policy(tmp_path, "policy.json", POLICIES[name])
    argv = ["report", path, "--text", exposition] + (["--json"] if json_out else [])
    got = _cli(tslo.main, argv, capsys)
    assert got == _cli(jslo.main, argv, capsys)
    assert got[0] == (1 if name == "breached" else 0)
    if not json_out:
        assert ("BREACH" in got[1]) == (name == "breached")


def test_slo_quantile_estimate_is_conservative(exposition):
    """Each bucket estimate is at or above the exact quantile of the
    series it was rendered from."""
    metrics.reset()
    rng = np.random.default_rng(3)
    for s in rng.uniform(0.001, 0.040, 50):
        metrics.observe_latency("out.e2e_latency", float(s), tenant="gold")
    hists, _ = tslo.parse_exposition(profiler.metrics_text())
    for q in (50.0, 99.0):
        est = tslo.quantile_from_buckets(hists[("out_e2e_latency", "gold")], q)
        assert est >= metrics.percentile("out.e2e_latency", q, tenant="gold") * 1e3
    metrics.reset()


CFG = jl.LlamaConfig(vocab=96, dim=32, n_layers=2, n_heads=2, n_kv_heads=1,
                     ffn_hidden=48, max_seq=64)


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """One seeded checkpoint written by the JAX package as a HF
    ``.safetensors`` with its config.json, and the JAX converter's
    ``.npz`` and ``.gguf`` of it (each in a directory of its own)."""
    root = tmp_path_factory.mktemp("ckpt")
    params = jax.tree_util.tree_map(np.asarray, jl.init_params(CFG, seed=7))
    (root / "hf").mkdir()
    jckpt.write_safetensors(str(root / "hf" / "model.safetensors"), _to_hf(params, CFG))
    _write_config(root / "hf", CFG)
    out = {"safetensors": str(root / "hf" / "model.safetensors")}
    for ext in ("npz", "gguf"):
        (root / ext).mkdir()
        out[ext] = str(root / ext / f"model.{ext}")
        jconvert.convert(out["safetensors"], out[ext], "float32")
    return out


def _convert_both(src, tmp_path, ext, dtype, capsys):
    outs = []
    for tag, main in (("jax", jconvert.main), ("port", tconvert.main)):
        d = tmp_path / tag
        d.mkdir()
        dst = str(d / f"out.{ext}")
        rc, so, se = _cli(main, [src, dst, "--dtype", dtype], capsys)
        files = {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}
        outs.append((rc, so.replace(str(d), "<dir>"), se.replace(str(d), "<dir>"), files))
    return outs


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("ext", ["gguf", "safetensors", "npz"])
def test_convert_bytes_equal_the_jax_cli(ext, dtype, sources, tmp_path, capsys):
    got, want = _convert_both(sources["safetensors"], tmp_path, ext, dtype, capsys)
    assert got == want
    if ext == "npz" and dtype == "bfloat16":
        assert got[0] == 1 and "npz cannot represent bfloat16" in got[2] and not got[3]
        return
    assert got[0] == 0 and f"out.{ext}" in got[3]
    # the converted file loads back in the port to the source's tensors
    path = str(tmp_path / "port" / f"out.{ext}")
    back, cfg = tl.load_checkpoint(path, dtype=dtype, device="cpu")
    src, _ = tl.load_checkpoint(sources["safetensors"], dtype=dtype, device="cpu")
    for f in CFG.__dataclass_fields__:  # a GGUF stores norm_eps as float32
        assert np.float32(getattr(cfg, f)) == np.float32(getattr(CFG, f)), f
    b, s = dict(_flat(back)), dict(_flat(src))
    assert b.keys() == s.keys()
    for k in s:
        np.testing.assert_array_equal(_bits(b[k]), _bits(s[k]), err_msg=k)


@pytest.mark.parametrize("ext", ["gguf", "safetensors", "npz"])
@pytest.mark.parametrize("src", ["npz", "gguf"])
def test_convert_from_other_sources_equals_the_jax_cli(src, ext, sources, tmp_path, capsys):
    got, want = _convert_both(sources[src], tmp_path, ext, "float32", capsys)
    assert got == want and got[0] == 0


def test_convert_rejects_an_unknown_format_like_the_jax_cli(sources, tmp_path, capsys):
    got, want = _convert_both(sources["safetensors"], tmp_path, "onnx", "float32", capsys)
    assert got == want and got[0] == 1 and "unsupported output format" in got[2]


def test_weave_phase_rehearses_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's ``weave`` phase at llama_tiny size: the child
    client (one OpenMP thread), its streams bitwise equal to an
    in-process client's, its tsan report clean, the merge of the two
    rings (aligned, an arrow each way a request) and the SLO report
    against this process's ``/metrics``."""
    import chip_smoke

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    srv = chip_smoke.query_server(
        "max_new:4,dtype:float32,param_dtype:float32,serve:continuous,slots:2,"
        "block_size:8,prefill_chunk:8,stream_chunk:2", 93, trace_mode="ring",
        model="llama_tiny", acc="accelerator=true:cpu")
    gen = np.random.default_rng(5)
    prompts = [gen.integers(3, 512, n).astype(np.int32) for n in (5, 9, 12)]
    metrics.reset()
    srv.start()
    try:
        ref = []  # the same prompts from an in-process client, one by one
        for p in prompts:
            c = chip_smoke.QueryClient(srv.element("ssrc").bound_port).start()
            c.push(p, 4)
            ref.append([int(b.tensors[0][0]) for b in c.join()])
            c.close()
        w = chip_smoke.phase_weave(torch.device("cpu"), srv, prompts, ref,
                                   files_dir=str(tmp_path))
    finally:
        srv.stop()
        ttracing.recorder.configure("off")
        ttracing.recorder.clear()
        metrics.reset()
    assert w["streams"] == 3 and w["tokens"] == 12 and w["tok_s"] > 0
    assert w["tsan"]["inversions"] == 0 and w["tsan"]["acquisitions"] > 0
    m = w["merged"]
    assert m["rings"] == 2 and m["requests"] == 3 and m["arrows"] >= 6
    assert m["spans"] == w["server_spans"] + w["client_spans"]
    assert w["slo"]["met_rc"] == 0 and w["slo"]["breached_rc"] == 1
    assert w["slo"]["p99_ms"] >= w["slo"]["exact_p99_ms"]
    assert os.listdir(tmp_path) == []
