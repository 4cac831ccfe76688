"""tensor_filter: run a model as a stream element.

Port of ``nnstreamer_tpu/elements/filter.py`` (reference:
``gsttensor_filter.c`` + ``tensor_filter_common.c``): framework selection
(``auto`` walks the configured priority list), model load at READY,
input/output specs from the framework, per-invoke latency, and
``invoke-dynamic`` flexible output.  A streaming framework (the llm
filter) emits one buffer per generated token, marked with
``stream_index`` and, on the last one, ``stream_last``.  A continuous-
serving framework (``serve:continuous``) takes each input into its
standing loop and emits the tokens from the loop's thread (async emit).
"""

from __future__ import annotations

import functools
import time
from typing import Dict, Optional

from ..core.buffer import Buffer
from ..core.caps import Caps
from ..core.config import get_config
from ..core.log import metrics
from ..core.meta_keys import META_STREAM_INDEX, META_STREAM_LAST
from ..core.registry import KIND_FILTER, lookup, register_element
from ..core.types import TensorFormat, TensorsSpec
from ..filters.base import Framework, FrameworkError
from .base import Element, ElementError, SRC


def _load_framework(props: Dict[str, object]) -> Framework:
    """framework= name or 'auto' (priority list from config)."""
    fw_name = str(props.get("framework", "auto")).lower()
    candidates = (
        get_config().filter_priority if fw_name in ("auto", "") else [fw_name]
    )
    last_err: Optional[Exception] = None
    for cand in candidates:
        cls = lookup(KIND_FILTER, cand)
        if cls is None:
            last_err = KeyError(f"framework {cand!r} not registered")
            continue
        fw: Framework = cls()
        try:
            fw.open(props)
            return fw
        except FrameworkError as e:
            last_err = e
            continue
    raise ElementError(
        f"no framework could open model {props.get('model')!r} "
        f"(tried {candidates}): {last_err}"
    )


@register_element("tensor_filter")
class TensorFilter(Element):
    """Props: ``framework``, ``model``, ``custom`` (framework options),
    ``accelerator`` (read by the framework: ``true:cpu`` or ``true:gpu``),
    ``invoke-dynamic`` (flexible output), ``latency`` (record per-invoke
    latency)."""

    kind = "tensor_filter"
    #: set at negotiation for a continuous-serving framework: the runner
    #: then injects ``_async_emit``
    wants_async_emit = False

    def __init__(self, props=None, name=None):
        super().__init__(props, name)
        self.fw: Optional[Framework] = None
        self.invoke_dynamic = bool(self.props.get("invoke_dynamic", False))
        self.latency_report = bool(self.props.get("latency", get_config().enable_latency))
        self._out_spec: Optional[TensorsSpec] = None
        self._async_emit = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self._ensure_fw()

    def _ensure_fw(self) -> Framework:
        if self.fw is None:
            self.fw = _load_framework(self.props)
        return self.fw

    def stop(self) -> None:
        if self.fw is not None:
            self.fw.close()
            self.fw = None

    # -- negotiation -------------------------------------------------------
    def configure(self, in_caps, out_pads):
        self.in_caps = dict(in_caps)
        fw = self._ensure_fw()
        if getattr(fw, "continuous", False):
            self.wants_async_emit = True
        fw_in, fw_out = fw.get_model_info()
        src = next(iter(in_caps.values()), Caps.any())
        up_spec = src.spec
        if fw_in is None:
            fw_in = up_spec
        elif up_spec is not None and not up_spec.is_flexible:
            if len(up_spec) != len(fw_in) or not all(
                a.is_compatible(b) for a, b in zip(up_spec, fw_in)
            ):
                raise ElementError(
                    f"{self.name}: upstream spec {up_spec} does not match model "
                    f"input {fw_in}"
                )
        if fw_in is not None:
            fw.set_input_spec(fw_in)
        self._out_spec = fw_out
        fmt = TensorFormat.FLEXIBLE if self.invoke_dynamic else TensorFormat.STATIC
        caps = Caps.tensors(fw_out.replace(format=fmt) if fw_out is not None else None)
        self.out_caps = {p: caps for p in out_pads}
        return self.out_caps

    # -- streaming ---------------------------------------------------------
    def process(self, pad, buf: Buffer):
        fw = self._ensure_fw()
        if getattr(fw, "continuous", False):
            # the standing serve loop takes the request (its meta rides
            # along) and emits one buffer per token from its own thread
            fw.submit(list(buf.tensors), dict(buf.meta),
                      functools.partial(self._emit_serve_token, buf))
            return []
        if fw.streaming:
            return self._stream(fw, buf)
        t0 = time.perf_counter()
        outs = fw.invoke(list(buf.tensors))
        self._record(time.perf_counter() - t0)
        spec = None if self.invoke_dynamic else self._out_spec
        return [(SRC, buf.with_tensors(list(outs), spec=spec))]

    def _stream(self, fw: Framework, buf: Buffer):
        """Many buffers per input: the runner iterates this generator, so
        each token flows downstream while the next is still decoding.  A
        one-step lookahead lets the FINAL buffer carry ``stream_last``."""
        t0 = time.perf_counter()
        prev = None
        for i, outs in enumerate(fw.invoke_stream(list(buf.tensors))):
            if prev is not None:
                yield (SRC, prev)
            prev = buf.with_tensors(list(outs), spec=None)
            prev.meta[META_STREAM_INDEX] = i
        if prev is not None:
            prev.meta[META_STREAM_LAST] = True
            yield (SRC, prev)
        self._record(time.perf_counter() - t0)

    def _emit_serve_token(self, src_buf: Buffer, tensors, meta) -> None:
        """Serve-thread callback: one generated token -> one buffer derived
        from the originating one (pts survives); the loop's meta wins."""
        emit = self._async_emit
        if emit is None:
            raise ElementError(f"{self.name}: not attached to a pipeline")
        out = src_buf.with_tensors(list(tensors), spec=None)
        out.meta = dict(meta)
        emit([(SRC, out)])

    def finalize(self):
        fw = self.fw
        if fw is not None and getattr(fw, "continuous", False):
            # EOS reached the element: every admitted stream finishes (and
            # emits its stream_last) before EOS goes downstream
            if not fw.drain(timeout=600):
                raise ElementError(
                    f"{self.name}: continuous serve loop failed to drain")
        return []

    def _record(self, dt: float) -> None:
        if self.latency_report:
            metrics.observe_latency(f"{self.name}.invoke", dt)
