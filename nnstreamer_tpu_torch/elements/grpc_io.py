"""tensor_src_grpc / tensor_sink_grpc: tensor streams over gRPC.

Port of ``nnstreamer_tpu/elements/grpc_io.py``: the same service name and
frames, so either package's sink streams to the other's source, and the
same clear error at construction where ``grpcio`` is missing.  A buffer
on the card is copied to the host once, as the wire encodes it (bf16 as
its 2-byte words, decoded back to bf16).

Reference analog (SURVEY §2.7): ``ext/nnstreamer/extra/nnstreamer_grpc*.cc``
— tensor streams over gRPC in client or server mode with protobuf/flatbuf
payloads, as an alternative transport to nnstreamer-edge TCP.

The elements run a genuine gRPC bidi stream carrying wire-format frames
(no .proto compilation needed: gRPC's generic bytes methods).  Where
``grpcio`` is absent they fail construction with a clear pointer to the
equivalent in-repo transports (edgesrc/edgesink for pub/sub fan-out,
tensor_query_* for request/response) — the reference gates its gRPC
sub-plugin behind meson options the same way.
"""

from __future__ import annotations

from typing import Iterator

from ..core.buffer import Buffer
from ..core.caps import Caps
from ..core.log import logger, metrics
from ..core.registry import register_element
from ..utils import wire
from .base import ElementError, SinkElement, SourceElement

log = logger(__name__)

_SERVICE = "/nnstreamer_tpu.TensorStream/Stream"


def _require_grpc():
    try:
        import grpc

        return grpc
    except ImportError as e:
        raise ElementError(
            "grpcio is not installed in this environment; use edgesrc/"
            "edgesink (pub/sub) or tensor_query_client/serversrc "
            "(request/response) — same tensor wire format over TCP"
        ) from e


@register_element("tensor_sink_grpc")
class TensorSinkGrpc(SinkElement):
    """Stream buffers out over a gRPC bidi call (client side; the paired
    ``tensor_src_grpc`` is the server).  Props: ``host``, ``port``."""

    kind = "tensor_sink_grpc"

    def __init__(self, props=None, name=None):
        super().__init__(props, name)
        self.grpc = _require_grpc()
        if self.props.get("server"):
            raise ElementError(
                "tensor_sink_grpc is the stream's client side; run "
                "tensor_src_grpc as the server instead"
            )
        self.host = str(self.props.get("host", "127.0.0.1"))
        self.port = int(self.props.get("port", 55115))
        self._channel = None
        self._queue = None
        self._call = None

    def start(self) -> None:
        grpc = self.grpc
        import queue as _q

        self._queue = _q.SimpleQueue()
        self._channel = grpc.insecure_channel(f"{self.host}:{self.port}")
        send = self._channel.stream_stream(
            _SERVICE,
            request_serializer=lambda b: b,
            response_deserializer=lambda b: b,
        )

        def frames():
            while True:
                item = self._queue.get()
                if item is None:
                    return
                yield item

        self._call = send(frames())

    def process(self, pad, buf: Buffer):
        if self._queue is None:
            raise ElementError(f"{self.name}: stream already finalized")
        self._queue.put(bytes(wire.encode_buffer(buf.resolve())))
        metrics.count(f"{self.name}.sent")
        return []

    def finalize(self):
        self._drain()
        return []

    def _drain(self) -> None:
        """End the request stream and wait for the RPC to finish so queued
        tail frames reach the server before the channel drops."""
        if self._queue is not None:
            self._queue.put(None)
            self._queue = None
        if self._call is not None:
            try:
                for _ in self._call:  # response stream ends when server done
                    pass
            except self.grpc.RpcError as e:
                log.warning("%s: stream ended with %s", self.name, e)
            self._call = None

    def stop(self) -> None:
        self._drain()
        if self._channel is not None:
            self._channel.close()
            self._channel = None


@register_element("tensor_src_grpc")
class TensorSrcGrpc(SourceElement):
    """Receive a tensor stream over gRPC.  Props: ``host``, ``port`` (0:
    the OS picks one, read back as ``bound_port``), ``num-buffers``."""

    kind = "tensor_src_grpc"

    def __init__(self, props=None, name=None):
        super().__init__(props, name)
        self.grpc = _require_grpc()
        self.host = str(self.props.get("host", "0.0.0.0"))
        self.port = int(self.props.get("port", 55115))
        self.num_buffers = int(self.props.get("num_buffers", -1))
        self._server = None
        self._rx = None

    def configure(self, in_caps, out_pads):
        self.out_caps = {p: Caps.any() for p in out_pads}
        return self.out_caps

    def start(self) -> None:
        grpc = self.grpc
        import queue as _q
        from concurrent import futures

        self._rx = _q.SimpleQueue()
        rx = self._rx

        class Handler(grpc.GenericRpcHandler):
            def service(self, handler_call_details):
                if handler_call_details.method != _SERVICE:
                    return None

                def stream(request_iterator, context):
                    for frame in request_iterator:
                        rx.put(frame)
                    rx.put(None)
                    return iter(())

                return grpc.stream_stream_rpc_method_handler(
                    stream,
                    request_deserializer=lambda b: b,
                    response_serializer=lambda b: b,
                )

        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
        self._server.add_generic_rpc_handlers((Handler(),))
        #: the port the server listens on (``port=0``: the OS picks it)
        self.bound_port = self._server.add_insecure_port(f"{self.host}:{self.port}")
        self._server.start()

    def stop(self) -> None:
        if self._server is not None:
            self._server.stop(grace=0.5)
            self._server = None

    def generate(self) -> Iterator[Buffer]:
        import queue as _q

        n = 0
        stop = getattr(self, "_stop_event", None)
        while self.num_buffers < 0 or n < self.num_buffers:
            try:
                frame = self._rx.get(timeout=0.2)
            except _q.Empty:
                if stop is not None and stop.is_set():
                    return
                continue
            if frame is None:
                return
            buf, _flags = wire.decode_buffer(frame)
            metrics.count(f"{self.name}.frames")
            n += 1
            yield buf
