"""The query front door of the port: ``tensor_query_serversrc !
tensor_filter framework=llm ! tensor_query_serversink`` serving
``tensor_query_client`` pipelines over loopback TCP, on llama_tiny at f32
on the CPU, held against the JAX package: a JAX client served by a port
server and a port client by a JAX server, the continuous loop and the
static path over the wire against the same prompts served in process
and against the JAX model, dynamic batching, a dead client's stream
reaped back into the pool, the loop's cancel contract, the runtime's
trace and quarantine hooks, appsrc admission, and the port-side
examples.  Every server takes its own ``id=`` and ``port=0``."""

import contextlib
import functools
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as ntt
from nnstreamer_tpu.models import llama as jl
from nnstreamer_tpu_torch.core.log import metrics
from nnstreamer_tpu_torch.filters import llm as tllm
from nnstreamer_tpu_torch.models import llama as tl
from nnstreamer_tpu_torch.models import zoo as tzoo
from nnstreamer_tpu_torch.utils import elastic
from nnstreamer_tpu_torch.utils import tracing as ptracing

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
CFG = jl.PRESETS["llama_tiny"]
#: the port's zoo name for llama_tiny built from the JAX package's weights
REF_MODEL = "llama_tiny_jax_weights_query"
#: logit gap under which a greedy step is a near tie (f32 dense logits)
TIE = 1e-4
MAX_NEW = 6
SERVE = (f"max_new:{MAX_NEW},stream_chunk:2,temperature:0.0,dtype:float32,"
         "serve:continuous,slots:3,block_size:8,prefill_chunk:8")


@functools.lru_cache(maxsize=None)
def _jax_tree():
    return jax.tree_util.tree_map(np.asarray, jl.init_params(CFG, seed=0))


def _ref_builder(opts, device):
    cfg = tl.resolve_config("llama_tiny", opts)
    params = tl.params_from_jax(_jax_tree(), device=device)
    return tl.make_bundle(cfg, params, opts.get("dtype", "bfloat16"), REF_MODEL)


tzoo.register_model(REF_MODEL, _ref_builder)


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, CFG.vocab, (t,)).astype(np.int32) for t in lens]


def _server(sid, custom, *, name="f", src_props="", model=REF_MODEL, **kw):
    return ntt.Pipeline(
        f"tensor_query_serversrc name=ssrc port=0 id={sid} {src_props} ! "
        f"tensor_filter name={name} framework=llm model={model} "
        f"custom={custom} accelerator=true:cpu invoke-dynamic=true ! "
        f"tensor_query_serversink id={sid}", **kw)


def _client(port, mod=ntt, props="", **kw):
    return mod.Pipeline(f"appsrc name=src ! tensor_query_client port={port} "
                        f"timeout=60 {props} ! tensor_sink name=out", **kw)


def _pull_stream(client, n, timeout=60):
    return [client.pull("out", timeout=timeout) for _ in range(n)]


def _ids(bufs):
    return [int(np.asarray(b.tensors[0]).ravel()[0]) for b in bufs]


def _assert_whole(bufs, n=MAX_NEW, start=0):
    assert [b.meta["stream_index"] for b in bufs] == list(range(start, n))
    assert [bool(b.meta.get("stream_last")) for b in bufs] == \
        [i == n - 1 for i in range(start, n)]
    assert not any(b.meta.get("stream_aborted") for b in bufs)


def _port_fw(custom):
    fw = tllm.LLMFramework()
    fw.open({"model": REF_MODEL, "custom": custom, "accelerator": "true:cpu"})
    return fw


def _in_process(prompts, custom=SERVE):
    """The port's loop serving the same prompts in process (submitted
    together): ``index -> token ids``."""
    fw = _port_fw(custom)
    got = {i: [] for i in range(len(prompts))}
    try:
        for i, p in enumerate(prompts):
            fw.submit([p], {}, lambda t, m, i=i: got[i].append(int(t[0][0])))
        assert fw.drain(timeout=120)
    finally:
        fw.close()
    return got


def _wait_for(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def _pool_free(loop):
    return (sorted(loop._free) == list(range(loop.n_blocks))
            and (loop._tables == loop.sentinel).all()
            and (loop._pos == loop.park).all()
            and all(not b for b in loop._slot_blocks))


@functools.lru_cache(maxsize=None)
def _jax_forward_paged():
    return jax.jit(functools.partial(jl.forward_paged, cfg=CFG,
                                     compute_dtype="float32"))


def _assert_paged_greedy(prompt, ids, block_size=8, chunk=8):
    """Every token is the JAX paged model's greedy choice on the same
    prefix, teacher-forced on the port's own tokens (a near tie may go
    either way)."""
    T = len(prompt)
    P = -(-T // chunk) * chunk
    n_blocks = -(-(P + len(ids)) // block_size)
    pool = jl.init_paged_cache(CFG, n_blocks, block_size, dtype="float32")
    tables = jnp.arange(n_blocks, dtype=jnp.int32)[None]
    toks = np.zeros((1, P), np.int32)
    toks[0, :T] = prompt
    fwd, tree = _jax_forward_paged(), _jax_tree()
    for p in range(0, P, chunk):
        logits, pool = fwd(tree, jnp.asarray(toks[:, p:p + chunk]), pool,
                           tables, jnp.asarray([p], jnp.int32),
                           logit_off=jnp.int32(T - 1 - p if p + chunk >= P
                                               else 0))
    rows = [np.asarray(logits)[0, -1]]
    for i, tok in enumerate(ids[:-1]):
        logits, pool = fwd(tree, jnp.asarray([[tok]], jnp.int32), pool,
                           tables, jnp.asarray([T + i], jnp.int32))
        rows.append(np.asarray(logits)[0, -1])
    for i, (g, row) in enumerate(zip(ids, rows)):
        top2 = np.sort(row)[-2:]
        if top2[1] - top2[0] < TIE:
            assert row[g] >= top2[1] - 2 * TIE, (i, ids)
        else:
            assert g == int(np.argmax(row)), (i, ids)


# -- interop with the JAX package over loopback --------------------------------

def test_jax_client_is_served_by_a_port_continuous_server():
    prompts = _prompts(0, (5, 11))
    want = _in_process(prompts)
    with _server(7101, SERVE) as srv, contextlib.ExitStack() as stack:
        port = srv.element("ssrc").bound_port
        clients = [stack.enter_context(_client(port, nt)) for _ in prompts]
        for c, p in zip(clients, prompts):
            c.push("src", p)
        for i, c in enumerate(clients):
            bufs = _pull_stream(c, MAX_NEW)
            _assert_whole(bufs)
            assert _ids(bufs) == want[i]
            assert len({b.meta["stream_id"] for b in bufs}) == 1
        for c in clients:
            c.eos("src")
            c.wait(timeout=30)


def test_port_client_is_served_by_a_jax_server():
    prompt = np.array([1, 17, 42, 9, 300], np.int32)
    custom = f"max_new:{MAX_NEW},stream_chunk:2,dtype:float32"
    local = nt.Pipeline("appsrc name=src ! tensor_filter framework=llm "
                        f"model=llama_tiny custom={custom} ! "
                        "tensor_sink name=out")
    with local:
        local.push("src", prompt)
        want = _ids(_pull_stream(local, MAX_NEW))
        local.eos("src")
        local.wait(timeout=60)
    srv = nt.Pipeline("tensor_query_serversrc name=ssrc port=0 id=7102 ! "
                      f"tensor_filter framework=llm model=llama_tiny "
                      f"custom={custom} invoke-dynamic=true ! "
                      "tensor_query_serversink id=7102")
    with srv:
        with _client(srv.element("ssrc").bound_port) as c:
            c.push("src", prompt)
            bufs = _pull_stream(c, MAX_NEW)
            c.eos("src")
            c.wait(timeout=30)
    _assert_whole(bufs)
    assert _ids(bufs) == want
    assert all(b.tensors[1].dtype == np.uint8 for b in bufs)


# -- the continuous loop over the wire -------------------------------------

def test_continuous_serving_behind_the_query_server():
    """Three clients, staggered: 1 and 2 join while stream 0 decodes.
    Each stream over the wire is whole, ordered and equal to the same
    prompt served in process; stream 1 is held teacher-forced against
    the JAX paged model."""
    prompts = _prompts(1, (4, 13, 7))
    want = _in_process(prompts)
    with _server(7103, SERVE) as srv, contextlib.ExitStack() as stack:
        port = srv.element("ssrc").bound_port
        clients = [stack.enter_context(_client(port)) for _ in range(3)]
        clients[0].push("src", prompts[0])
        head = clients[0].pull("out", timeout=60)  # stream 0 is live
        clients[1].push("src", prompts[1])
        clients[2].push("src", prompts[2])
        streams = [[head] + _pull_stream(clients[0], MAX_NEW - 1)]
        streams += [_pull_stream(c, MAX_NEW) for c in clients[1:]]
        for c in clients:
            c.eos("src")
            c.wait(timeout=30)
        loop = srv.element("f").fw.serve_loop()
        assert _wait_for(lambda: _pool_free(loop))
    for i, bufs in enumerate(streams):
        _assert_whole(bufs)
        assert _ids(bufs) == want[i], i
        stamps = [b.meta["emit_t"] for b in bufs]
        assert stamps == sorted(stamps)
    assert len({b.meta["stream_id"] for s in streams for b in s}) == 3
    _assert_paged_greedy(prompts[1], _ids(streams[1]))


def test_client_sent_stream_id_is_replaced_by_the_servers():
    with _server(7104, SERVE) as srv:
        with _client(srv.element("ssrc").bound_port) as c:
            c.push("src", ntt.Buffer([_prompts(2, (5,))[0]],
                                     meta={"stream_id": 123}))
            bufs = _pull_stream(c, MAX_NEW)
            c.eos("src")
            c.wait(timeout=30)
    _assert_whole(bufs)
    sid = bufs[0].meta["stream_id"]
    assert sid != 123 and sid >> 32 == ptracing.trace_epoch()


# -- the static path over the wire ---------------------------------------------

def _jax_static_ids(prompt, max_new, custom):
    p = nt.Pipeline("appsrc name=src ! tensor_filter framework=llm "
                    f"model=llama_tiny custom={custom} ! tensor_sink name=out")
    with p:
        p.push("src", prompt)
        ids = _ids(_pull_stream(p, max_new))
        p.eos("src")
        p.wait(timeout=60)
    return ids


def test_static_stream_over_the_wire_equals_jax():
    """``examples/llm_query_stream.py``'s shape at f32: the greedy
    tokens a remote client receives are the JAX static path's."""
    prompt = np.array([1, 17, 42, 9, 300], np.int32)
    custom = "max_new:8,stream_chunk:4,dtype:float32"
    want = _jax_static_ids(prompt, 8, custom)
    with _server(7105, custom) as srv:
        with _client(srv.element("ssrc").bound_port) as c:
            c.push("src", prompt)
            bufs = _pull_stream(c, 8)
            c.eos("src")
            c.wait(timeout=30)
    _assert_whole(bufs, n=8)
    assert _ids(bufs) == want
    assert "stream_id" not in bufs[0].meta  # the static path mints none


def test_batched_llm_streaming():
    """``max-batch=2``: two same-length prompts decode as one [2, T]
    request and each client gets its own row of every token, equal to
    ``invoke_stream`` on the stacked prompts."""
    max_new = 4
    custom = f"max_new:{max_new},stream_chunk:2,dtype:float32"
    prompts = [np.array([1, 5, 9, 2], np.int32),
               np.array([3, 3, 7, 8], np.int32)]
    with _server(7106, custom,
                 src_props="max-batch=2 batch-window-ms=5000") as srv, \
            contextlib.ExitStack() as stack:
        port = srv.element("ssrc").bound_port
        clients = [stack.enter_context(_client(port)) for _ in prompts]
        for c, p in zip(clients, prompts):
            c.push("src", p)
        streams = []
        for c in clients:
            bufs = _pull_stream(c, max_new)
            _assert_whole(bufs, n=max_new)
            assert len(bufs[0].tensors) == 1  # ids only when batched
            streams.append(_ids(bufs))
        for c in clients:
            c.eos("src")
            c.wait(timeout=30)
    fw = _port_fw(custom)
    try:
        rows = [outs[0] for outs in fw.invoke_stream([np.stack(prompts)])]
    finally:
        fw.close()
    assert streams == [[int(r[i]) for r in rows] for i in range(2)]


def test_client_disconnect_mid_batched_stream_isolated():
    """One of two clients sharing a batched static stream vanishes after
    one token: the survivor still gets its whole stream, from the one
    filter invoke that served both."""
    max_new = 6
    custom = f"max_new:{max_new},stream_chunk:1,dtype:float32"
    with _server(7107, custom,
                 src_props="max-batch=2 batch-window-ms=5000") as srv, \
            contextlib.ExitStack() as stack:
        n0 = metrics.snapshot().get("f.invoke.n", 0.0)
        port = srv.element("ssrc").bound_port
        doomed = stack.enter_context(_client(port))
        survivor = stack.enter_context(_client(port))
        doomed.push("src", np.array([1, 5, 9, 2], np.int32))
        survivor.push("src", np.array([3, 3, 7, 8], np.int32))
        doomed.pull("out", timeout=60)
        doomed.stop()
        bufs = _pull_stream(survivor, max_new)
        _assert_whole(bufs, n=max_new)
        survivor.eos("src")
        survivor.wait(timeout=30)
        assert _wait_for(
            lambda: metrics.snapshot().get("f.invoke.n", 0.0) >= n0 + 1, 5)
        assert metrics.snapshot().get("f.invoke.n", 0.0) == n0 + 1


# -- a dead client's stream is reaped ------------------------------------------

def test_dead_client_stream_is_reaped_back_into_the_pool():
    """Continuous loop, ``stream_idle_timeout:0.2``: a client that stops
    after one token has its stream cancelled by the serversink's failed
    send and reaped once; its slot and blocks return to the free list,
    and the client beside it gets its whole stream."""
    max_new = 200
    custom = (f"max_new:{max_new},stream_chunk:2,temperature:0.0,"
              "dtype:float32,serve:continuous,slots:2,block_size:8,"
              "prefill_chunk:8,stream_idle_timeout:0.2")
    with _server(7108, custom) as srv, contextlib.ExitStack() as stack:
        el = srv.element("f")
        seen = []
        emit = el._emit_serve_token

        def spy(src_buf, tensors, meta):
            seen.append(dict(meta))
            emit(src_buf, tensors, meta)

        el._emit_serve_token = spy
        base = metrics.snapshot()
        port = srv.element("ssrc").bound_port
        doomed = stack.enter_context(_client(port))
        doomed.push("src", _prompts(3, (40,))[0])
        first = doomed.pull("out", timeout=60)
        doomed.stop()
        survivor = stack.enter_context(_client(port))
        survivor.push("src", _prompts(4, (9,))[0])
        bufs = _pull_stream(survivor, max_new, timeout=120)
        _assert_whole(bufs, n=max_new)
        survivor.eos("src")
        survivor.wait(timeout=30)
        loop = el.fw.serve_loop()
        assert _wait_for(lambda: _pool_free(loop))
        snap = metrics.snapshot()
    dead = first.meta["stream_id"]
    mine = [m for m in seen if m["stream_id"] == dead]
    tokens = [m for m in mine if not m.get("stream_aborted")]
    assert len(tokens) < max_new
    assert mine[-1].get("stream_aborted") and mine[-1]["stream_last"]
    assert mine[-1]["abort_reason"] == "dead-connection"
    assert snap.get("llm.serve.reaped", 0) == base.get("llm.serve.reaped", 0) + 1
    assert snap.get("llm.serve.cancelled", 0) >= \
        base.get("llm.serve.cancelled", 0) + 1
    assert snap.get("llm.serve.reaped_blocks", 0) > \
        base.get("llm.serve.reaped_blocks", 0)
    assert snap.get("f.invoke.n", 0) == base.get("f.invoke.n", 0)
    assert dead not in elastic.live_stream_ids()


class _Collector:
    def __init__(self):
        self.toks = []
        self.done = threading.Event()
        self.first = threading.Event()

    def __call__(self, tensors, meta):
        self.toks.append(dict(meta))
        self.first.set()
        if meta.get("stream_last"):
            self.done.set()


def test_force_cancel_reaps_blocks_and_terminates():
    fw = _port_fw(SERVE.replace(f"max_new:{MAX_NEW}", "max_new:200"))
    try:
        got = _Collector()
        sid = fw.submit([np.asarray([1, 2, 3], np.int32)], {}, got)
        assert got.first.wait(60)
        base = metrics.snapshot().get("llm.serve.reaped", 0.0)
        assert elastic.cancel_stream(sid, "test-reap", force=True)
        assert got.done.wait(30)
        last = got.toks[-1]
        assert last.get("stream_aborted") is True
        assert last.get("abort_reason") == "test-reap"
        assert last["stream_index"] == len(got.toks) - 1 < 200
        loop = fw._serve
        assert _wait_for(lambda: _pool_free(loop))
        assert metrics.snapshot().get("llm.serve.reaped", 0.0) == base + 1
        assert elastic.cancel_stream(sid) is False  # unregistered
    finally:
        fw.close()


def test_cancel_unknown_stream_is_noop():
    assert elastic.cancel_stream(999999999) is False
    assert elastic.cancel_stream(None) is False


def test_cancel_within_the_grace_waits_for_the_deadline():
    fw = _port_fw(SERVE.replace(f"max_new:{MAX_NEW}", "max_new:250")
                  + ",stream_idle_timeout:0.25")
    try:
        got = _Collector()
        sid = fw.submit([np.asarray([4, 5, 6], np.int32)], {}, got)
        assert got.first.wait(60)
        t0 = time.monotonic()
        assert elastic.cancel_stream(sid, "dead-connection")
        assert not got.done.wait(0.1)  # inside the grace: still decoding
        assert got.done.wait(30)
        assert time.monotonic() - t0 >= 0.25
        assert got.toks[-1]["abort_reason"] == "dead-connection"
        assert len(got.toks) < 250
    finally:
        fw.close()


def test_cancel_of_a_queued_stream_never_admits_it():
    fw = _port_fw(SERVE.replace("slots:3", "slots:1")
                  .replace(f"max_new:{MAX_NEW}", "max_new:60"))
    try:
        running, queued = _Collector(), _Collector()
        fw.submit([np.asarray([1, 2, 3], np.int32)], {}, running)
        assert running.first.wait(60)
        sid = fw.submit([np.asarray([7, 8, 9], np.int32)], {}, queued)
        assert elastic.cancel_stream(sid, "gone", force=True)
        assert queued.done.wait(30)
        assert [(m["stream_index"], m.get("stream_aborted"))
                for m in queued.toks] == [(0, True)]
        assert running.done.wait(60)
        assert len(running.toks) == 60
        assert not running.toks[-1].get("stream_aborted")
    finally:
        fw.close()


def test_slot_reusable_after_reap():
    fw = _port_fw(SERVE.replace("slots:3", "slots:1")
                  .replace(f"max_new:{MAX_NEW}", "max_new:200"))
    try:
        got = _Collector()
        sid = fw.submit([np.asarray([1, 2, 3], np.int32)], {}, got)
        assert got.first.wait(60)
        elastic.cancel_stream(sid, force=True)
        assert got.done.wait(30)
        nxt = _Collector()
        fw.submit([np.asarray([1, 2, 3], np.int32)], {}, nxt)
        assert nxt.done.wait(60)
        assert len(nxt.toks) == 200 and not nxt.toks[-1].get("stream_aborted")
        # the same prompt, greedy: the reaped stream's tokens are a prefix
        assert [m["stream_index"] for m in nxt.toks] == list(range(200))
    finally:
        fw.close()


# -- runtime hooks: trace, quarantine, appsrc admission ------------------------

def test_traced_query_round_trip_records_spans():
    try:
        with _server(7109, SERVE, trace_mode="ring") as srv:
            with _client(srv.element("ssrc").bound_port,
                         trace_mode="ring") as c:
                c.push("src", _prompts(5, (6,))[0])
                bufs = _pull_stream(c, MAX_NEW)
                c.eos("src")
                c.wait(timeout=30)
        kinds = {e.kind for e in ptracing.recorder.events()}
        assert {"ingress", "queue", "stage", "e2e", "query.send",
                "query.reply", "query.recv"} <= kinds
        # the client's trace id rode the wire and came back on every token
        tids = {b.meta.get("_tparent") for b in bufs}
        assert len(tids) == 1 and None not in tids
        assert "_enqueue_ns" not in bufs[0].meta
    finally:
        ptracing.recorder.configure("off")
        ptracing.recorder.clear()


def test_quarantined_request_is_answered_with_poison(tmp_path):
    """A request whose invoke raises (a 3-D prompt) is quarantined to the
    DLQ and its client answered with ``abort_reason=poison``; the server
    serves the next request."""
    custom = "max_new:3,dtype:float32"
    with _server(7110, custom, quarantine=str(tmp_path)) as srv:
        with _client(srv.element("ssrc").bound_port) as c:
            c.push("src", np.ones((1, 2, 3), np.int32))
            bad = c.pull("out", timeout=60)
            c.push("src", np.array([1, 2, 3], np.int32))
            good = _pull_stream(c, 3)
            c.eos("src")
            c.wait(timeout=30)
    assert bad.meta.get("abort_reason") == "poison"
    assert len(os.listdir(tmp_path)) == 1
    _assert_whole(good, n=3)


def test_tenant_rides_the_wire():
    with _server(7111, SERVE) as srv:
        base = metrics.labeled_counters().get(("query_server.in", "blue"), 0)
        with ntt.Pipeline("appsrc name=src tenant=blue ! tensor_query_client "
                          f"port={srv.element('ssrc').bound_port} timeout=60 "
                          "! tensor_sink name=out") as c:
            c.push("src", _prompts(6, (5,))[0])
            bufs = _pull_stream(c, MAX_NEW)
            c.eos("src")
            c.wait(timeout=30)
    assert {b.meta.get("_tenant") for b in bufs} == {"blue"}
    assert metrics.labeled_counters()[("query_server.in", "blue")] == base + 1


def test_appsrc_max_inflight_blocks_until_delivery():
    p = ntt.Pipeline("appsrc name=src max-inflight=1 ! tensor_sink name=out")
    with p:
        p.push("src", np.arange(3, dtype=np.int32))
        pushed = threading.Event()
        t = threading.Thread(target=lambda: (
            p.push("src", np.arange(4, dtype=np.int32)), pushed.set()))
        t.start()
        assert not pushed.wait(0.3)  # the first buffer holds the credit
        assert p.pull("out", timeout=10).tensors[0].shape == (3,)
        assert pushed.wait(10)
        assert p.pull("out", timeout=10).tensors[0].shape == (4,)
        t.join(timeout=10)
        p.eos("src")
        p.wait(timeout=10)


# -- jax-free serving and the examples -----------------------------------------

def test_query_serving_runs_without_jax():
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import nnstreamer_tpu_torch as ntt\n"
        "srv = ntt.Pipeline('tensor_query_serversrc name=ssrc port=0 id=1 ! "
        "tensor_filter framework=llm model=llama_tiny custom=max_new:3,"
        "dtype:float32,serve:continuous,slots:2,block_size:8,"
        "prefill_chunk:8,stream_idle_timeout:1 accelerator=true:cpu "
        "invoke-dynamic=true ! tensor_query_serversink id=1')\n"
        "with srv:\n"
        "    port = srv.element('ssrc').bound_port\n"
        "    c = ntt.Pipeline(f'appsrc name=src ! tensor_query_client "
        "port={port} timeout=60 ! tensor_sink name=out')\n"
        "    with c:\n"
        "        c.push('src', np.arange(1, 6, dtype=np.int32))\n"
        "        bufs = [c.pull('out', timeout=60) for _ in range(3)]\n"
        "        c.eos('src')\n"
        "        c.wait(timeout=60)\n"
        "assert bufs[-1].meta.get('stream_last') is True\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'jaxlib', 'nnstreamer_tpu.')) or m == 'nnstreamer_tpu')\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("script,expect", [
    ("torch_llm_query_stream.py", "decoded bytes:"),
    ("torch_llm_continuous_serving.py", "late client's first token"),
])
def test_port_example_runs_on_the_cpu(script, expect):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, str(REPO / "examples" / script), "--cpu"],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert expect in out.stdout
    assert "token[15]" in out.stdout or "16 tokens" in out.stdout
