"""The port's remote transports against the JAX package's: edgesink /
edgesrc, the MQTT-lite broker with mqttsink / mqttsrc, and the gRPC pair.

The same buffers give the same wire bytes in both packages; a publisher
of either package feeds a subscriber of the other over loopback, and a
broker of either serves the other's clients, retained messages and
``+`` / ``#`` filters included; a port subscriber survives a broker
restart.  Every server listens on port 0, every pull and wait has a
timeout, and every pipeline and broker stops in a ``with`` block.
"""

import queue
import sys
import time

import numpy as np
import pytest
import torch

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as ntt
from nnstreamer_tpu.utils import broker as jbroker
from nnstreamer_tpu.utils import wire as jwire
from nnstreamer_tpu_torch.elements.base import ElementError
from nnstreamer_tpu_torch.utils import broker as tbroker
from nnstreamer_tpu_torch.utils import wire as twire

PKGS = {"jax": nt, "torch": ntt}
BROKERS = {"jax": jbroker.MqttLiteBroker, "torch": tbroker.MqttLiteBroker}
WAIT = 10.0


def _buffers(pkg, n=3, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        buf = pkg.Buffer([rng.standard_normal((2, 3)).astype(np.float32),
                          rng.integers(-9, 9, (4,), dtype=np.int16)],
                         pts=1000 + i, seqno=50 + i)
        buf.meta["label"] = f"frame{i}"
        out.append(buf)
    return out


def _same(got, want):
    assert got.pts == want.pts
    assert got.meta["label"] == want.meta["label"]
    for a, b in zip(got.tensors, want.tensors):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def _wait_until(cond, what):
    deadline = time.monotonic() + WAIT
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError(what)
        time.sleep(0.005)


@pytest.mark.parametrize("pattern,topic", [
    ("a/b", "a/b"), ("a/b", "a/c"), ("a/+/c", "a/x/c"), ("a/+/c", "a/x/y"),
    ("a/#", "a/x/y"), ("#", "anything/at/all"), ("", "x"), ("a/b/c", "a/b"),
    ("+", "a"), ("+", "a/b"), ("a/+", "a"), ("a/#", "a")])
def test_topic_matches_as_the_jax_broker(pattern, topic):
    assert tbroker.topic_matches(pattern, topic) == jbroker.topic_matches(pattern, topic)


def test_edge_and_broker_frames_are_the_jax_bytes():
    for tb, jb in zip(_buffers(ntt), _buffers(nt)):
        payload = twire.encode_buffer(tb)
        assert payload == jwire.encode_buffer(jb)
        assert twire.frame_bytes(payload) == jwire.frame_bytes(jwire.encode_buffer(jb))
        tb.meta["topic"] = jb.meta["topic"] = "cam/0"
        assert twire.encode_buffer(tb) == jwire.encode_buffer(jb)


def test_bf16_card_payload_crosses_as_its_words():
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4).to(torch.bfloat16)
    buf, _ = twire.decode_buffer(twire.encode_buffer(ntt.Buffer([x], pts=3)))
    assert buf.tensors[0].dtype == torch.bfloat16
    assert torch.equal(buf.tensors[0], x)


@pytest.mark.parametrize("pub_pkg,sub_pkg", [("jax", "torch"), ("torch", "jax"),
                                             ("torch", "torch")])
def test_edgesink_feeds_edgesrc(pub_pkg, sub_pkg):
    pub_mod, sub_mod = PKGS[pub_pkg], PKGS[sub_pkg]
    want = _buffers(pub_mod)
    with pub_mod.Pipeline("appsrc name=src ! edgesink name=pub port=0 topic=cam") as pub:
        edge = pub.element("pub")
        sub = sub_mod.Pipeline(f"edgesrc port={edge.bound_port} topic=cam "
                               f"num-buffers={len(want)} ! tensor_sink name=out")
        with sub:
            _wait_until(lambda: edge._subs, "the subscriber never registered")
            for b in want:
                pub.push("src", b)
            got = [sub.pull("out", timeout=WAIT) for _ in want]
            sub.wait(timeout=WAIT)
        pub.eos("src")
        pub.wait(timeout=WAIT)
    for g, w in zip(got, want):
        _same(g, w)


def test_edgesrc_ends_at_the_publishers_eos():
    with ntt.Pipeline("appsrc name=src ! edgesink name=pub port=0") as pub:
        edge = pub.element("pub")
        with ntt.Pipeline(f"edgesrc port={edge.bound_port} ! tensor_sink name=out") as sub:
            _wait_until(lambda: edge._subs, "the subscriber never registered")
            pub.push("src", np.arange(4, dtype=np.int32))
            got = sub.pull("out", timeout=WAIT)
            pub.eos("src")
            pub.wait(timeout=WAIT)
            sub.wait(timeout=WAIT)  # the publisher's EOS ended the stream
    assert np.array_equal(got.tensors[0], np.arange(4, dtype=np.int32))


def test_edgesrc_without_a_publisher_raises():
    with pytest.raises(Exception, match="port property required"):
        with ntt.Pipeline("edgesrc ! tensor_sink name=out"):
            pass


@pytest.mark.parametrize("broker_pkg,client_pkg", [("jax", "torch"), ("torch", "jax"),
                                                   ("torch", "torch")])
def test_broker_serves_the_other_packages_clients(broker_pkg, client_pkg):
    """Retained messages reach a late subscriber; ``+`` takes one level,
    ``#`` any suffix, other topics are filtered out."""
    mod = PKGS[client_pkg]
    with BROKERS[broker_pkg]() as broker:
        port = broker.port
        with mod.Pipeline(f"appsrc name=src ! mqttsink port={port} topic=cam/0 "
                          "debug-epoch=false") as pub:
            pub.push("src", np.full((2,), 7, np.int16))
            _wait_until(lambda: broker._retained.get("cam/0"), "nothing retained")
            plus = mod.Pipeline(f"mqttsrc port={port} topic=cam/+ num-buffers=2 ! "
                                "tensor_sink name=out")
            deep = mod.Pipeline(f"mqttsrc port={port} topic=dev/# num-buffers=1 ! "
                                "tensor_sink name=out")
            with plus, deep:
                _wait_until(lambda: broker.subscriber_count("cam/1") == 1
                            and broker.subscriber_count("dev/a/b") == 1,
                            "the subscribers never registered")
                retained = plus.pull("out", timeout=WAIT)
                with mod.Pipeline(f"appsrc name=src ! mqttsink port={port} "
                                  "topic=cam/1") as cam1, \
                        mod.Pipeline(f"appsrc name=src ! mqttsink port={port} "
                                     "topic=dev/a/b") as dev:
                    dev.push("src", np.full((3,), 2, np.float32))
                    cam1.push("src", np.full((2,), 8, np.int16))
                    fresh = plus.pull("out", timeout=WAIT)
                    nested = deep.pull("out", timeout=WAIT)
                    for p in (cam1, dev):
                        p.eos("src")
                        p.wait(timeout=WAIT)
                plus.wait(timeout=WAIT)
                deep.wait(timeout=WAIT)
            pub.eos("src")
            pub.wait(timeout=WAIT)
    assert retained.meta["topic"] == "cam/0" and retained.tensors[0].tolist() == [7, 7]
    assert "epoch_ns" not in retained.meta
    assert fresh.meta["topic"] == "cam/1" and fresh.tensors[0].tolist() == [8, 8]
    assert "epoch_ns" in fresh.meta and "mono_ns" in fresh.meta
    assert nested.meta["topic"] == "dev/a/b"
    assert np.array_equal(nested.tensors[0], np.full((3,), 2, np.float32))


def test_qos0_drops_the_oldest_for_a_full_subscriber():
    broker = tbroker.MqttLiteBroker(max_queue=2)
    q = queue.Queue(maxsize=2)
    for i in range(4):
        broker._offer(q, i)
    assert [q.get_nowait() for _ in range(2)] == [2, 3]


def test_mqttsrc_rebase_moves_pts_onto_this_host():
    with tbroker.MqttLiteBroker(retain=False) as broker:
        with ntt.Pipeline(f"mqttsrc port={broker.port} topic=t num-buffers=1 "
                          "sync=rebase ! tensor_sink name=out") as sub:
            with ntt.Pipeline(f"appsrc name=src ! mqttsink port={broker.port} "
                              "topic=t") as pub:
                _wait_until(lambda: broker.subscriber_count("t"), "no subscriber")
                pub.push("src", ntt.Buffer([np.zeros(2, np.uint8)], pts=100))
                got = sub.pull("out", timeout=WAIT)
                pub.eos("src")
                pub.wait(timeout=WAIT)
            sub.wait(timeout=WAIT)
    assert got.meta["transit_ns"] >= 0
    assert got.pts == 100 + got.meta["transit_ns"]


def test_broker_rejects_an_old_protocol_without_retrying():
    from nnstreamer_tpu_torch.elements import mqtt
    from nnstreamer_tpu_torch.utils import net

    with jbroker.MqttLiteBroker() as broker:  # its own protocol version
        old = net.PROTOCOL_VERSION
        net.PROTOCOL_VERSION = old - 1  # the client's hello carries it
        try:
            t0 = time.monotonic()
            with pytest.raises(mqtt.BrokerRejected):
                mqtt._connect("127.0.0.1", broker.port, "sub", "t", timeout=5.0)
            assert time.monotonic() - t0 < 4.0
        finally:
            net.PROTOCOL_VERSION = old


@pytest.mark.parametrize("broker_pkg", ["jax", "torch"])
def test_mqttsrc_survives_a_broker_restart(broker_pkg):
    """The broker dies and comes back on its port: a ``reconnect=true``
    subscriber of the port keeps receiving (as ``tests/test_mqtt.py``
    ``TestReconnect`` holds the JAX one to)."""
    cls = BROKERS[broker_pkg]
    broker = cls().start()
    port = broker.port
    broker2 = None
    try:
        with ntt.Pipeline(f"mqttsrc port={port} topic=t num-buffers=2 reconnect=true "
                          "connect-timeout=10 ! tensor_sink name=out") as sub:
            with ntt.Pipeline(f"appsrc name=src ! mqttsink port={port} topic=t") as pub:
                _wait_until(lambda: broker.subscriber_count("t"), "no subscriber")
                pub.push("src", np.array([1], np.uint8))
                first = sub.pull("out", timeout=WAIT)
                pub.eos("src")
                pub.wait(timeout=WAIT)
            broker.stop()
            for _ in range(50):  # the port's release can lag the close
                try:
                    broker2 = cls(port=port, retain=False).start()
                    break
                except OSError:
                    time.sleep(0.1)
            assert broker2 is not None, "could not rebind the broker's port"
            second = None
            with ntt.Pipeline(f"appsrc name=src ! mqttsink port={port} topic=t") as pub2:
                for _ in range(100):
                    pub2.push("src", np.array([2], np.uint8))
                    try:
                        second = sub.pull("out", timeout=0.3)
                        break
                    except TimeoutError:
                        time.sleep(0.1)
                pub2.eos("src")
                pub2.wait(timeout=WAIT)
            assert second is not None, "no buffer after the broker's restart"
            sub.wait(timeout=WAIT)
    finally:
        broker.stop()
        if broker2 is not None:
            broker2.stop()
    assert first.tensors[0][0] == 1 and second.tensors[0][0] == 2


def test_mqttsrc_ends_when_the_broker_goes_without_reconnect():
    broker = tbroker.MqttLiteBroker().start()
    try:
        with ntt.Pipeline(f"mqttsrc port={broker.port} topic=t ! "
                          "tensor_sink name=out") as sub:
            _wait_until(lambda: broker.subscriber_count("t"), "no subscriber")
            broker.stop()
            sub.wait(timeout=WAIT)  # EOS, no stall
    finally:
        broker.stop()


def test_grpc_elements_raise_the_jax_error_without_grpcio(monkeypatch):
    from nnstreamer_tpu.elements import grpc_io as jgrpc
    from nnstreamer_tpu_torch.elements import grpc_io as tgrpc

    monkeypatch.setitem(sys.modules, "grpc", None)
    for name in ("TensorSinkGrpc", "TensorSrcGrpc"):
        with pytest.raises(ElementError) as te:
            getattr(tgrpc, name)({})
        with pytest.raises(Exception) as je:
            getattr(jgrpc, name)({})
        assert str(te.value) == str(je.value)
        assert "grpcio is not installed" in str(te.value)


def test_grpc_sink_refuses_the_server_role():
    pytest.importorskip("grpc")
    with pytest.raises(ElementError, match="client side"):
        ntt.Pipeline("appsrc name=src ! tensor_sink_grpc server=true")


@pytest.mark.parametrize("sender", ["jax", "torch"])
def test_grpc_stream_into_the_port(sender):
    pytest.importorskip("grpc")
    want = _buffers(PKGS[sender], n=2, seed=1)
    with ntt.Pipeline("tensor_src_grpc name=rx host=127.0.0.1 port=0 num-buffers=2 ! "
                      "tensor_sink name=out") as src:
        port = src.element("rx").bound_port
        with PKGS[sender].Pipeline(f"appsrc name=src ! tensor_sink_grpc "
                                   f"host=127.0.0.1 port={port}") as snd:
            for b in want:
                snd.push("src", b)
            got = [src.pull("out", timeout=WAIT) for _ in want]
            snd.eos("src")
            snd.wait(timeout=WAIT)
        src.wait(timeout=WAIT)
    for g, w in zip(got, want):
        _same(g, w)


def test_grpc_bf16_round_trip_is_bitwise():
    pytest.importorskip("grpc")
    gen = torch.Generator().manual_seed(0)
    xs = [torch.randn(2, 8, generator=gen).to(torch.bfloat16) for _ in range(3)]
    with ntt.Pipeline("tensor_src_grpc name=rx host=127.0.0.1 port=0 num-buffers=3 ! "
                      "tensor_sink name=out to-host=false") as src:
        port = src.element("rx").bound_port
        with ntt.Pipeline(f"appsrc name=src ! tensor_sink_grpc host=127.0.0.1 "
                          f"port={port}") as snd:
            for x in xs:
                snd.push("src", x)
            got = [src.pull("out", timeout=WAIT).tensors[0] for _ in xs]
            snd.eos("src")
            snd.wait(timeout=WAIT)
        src.wait(timeout=WAIT)
    assert all(g.dtype == torch.bfloat16 and torch.equal(g, x) for g, x in zip(got, xs))
