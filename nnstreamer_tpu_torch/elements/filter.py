"""tensor_filter: run a model as a stream element.

Port of ``nnstreamer_tpu/elements/filter.py`` (reference:
``gsttensor_filter.c`` + ``tensor_filter_common.c``): framework selection
(``auto`` walks the configured priority list), model load at READY,
input/output specs from the framework, per-invoke latency,
``invoke-dynamic`` flexible output and ``input-combination`` /
``output-combination`` remapping.  A framework with a pure torch
callable (``framework=jax``) offers it as :meth:`TensorFilter.device_fn`,
so the planner fuses the filter with its neighbours.  A streaming framework (the llm
filter) emits one buffer per generated token, marked with
``stream_index`` and, on the last one, ``stream_last``.  A continuous-
serving framework (``serve:continuous``) takes each input into its
standing loop and emits the tokens from the loop's thread (async emit).
"""

from __future__ import annotations

import functools
import time
from typing import Dict, List, Optional, Tuple

from ..core.buffer import Buffer
from ..core.caps import Caps
from ..core.config import get_config
from ..core.log import logger, metrics
from ..core.meta_keys import META_STREAM_INDEX, META_STREAM_LAST
from ..core.registry import KIND_FILTER, lookup, register_element
from ..core.types import TensorFormat, TensorsSpec
from ..filters.base import Framework, FrameworkError
from .base import Element, ElementError, SRC

log = logger(__name__)


def _parse_input_combination(s: str) -> Optional[List[int]]:
    """``input-combination=0,2`` — indices of the incoming buffer's tensors
    fed to the model (reference: tensor_filter_common.c input-combination)."""
    s = s.strip()
    if not s:
        return None
    return [int(v) for v in s.split(",")]


def _parse_output_combination(s: str) -> Optional[List[Tuple[str, int]]]:
    """``output-combination=i0,o0`` — compose the output buffer from input
    tensors (``iN``, pass-through) and model outputs (``oN``); bare digits
    mean ``oN`` (reference: tensor_filter_common.c output-combination)."""
    s = s.strip()
    if not s:
        return None
    combo: List[Tuple[str, int]] = []
    for tok in s.split(","):
        tok = tok.strip().lower()
        if tok.startswith(("i", "o")):
            combo.append((tok[0], int(tok[1:])))
        else:
            combo.append(("o", int(tok)))
    return combo


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
    latency), ``input-combination`` / ``output-combination``."""

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
        self._up_spec: Optional[TensorsSpec] = None
        self._async_emit = None
        #: set by the residency planner (``pipeline/residency.py``) before
        #: negotiation when every consumer below admits reduced output
        #: geometry; configure() then asks the framework to switch
        self._reduced_admissible = False
        #: what reduced output the planner selected (None: the full one)
        self.reduced_output_selected: Optional[str] = None
        self.input_combination = _parse_input_combination(
            str(self.props.get("input_combination", "")))
        self.output_combination = _parse_output_combination(
            str(self.props.get("output_combination", "")))

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

    @property
    def device(self):
        """The device the framework runs on (None when it has none)."""
        return getattr(self._ensure_fw(), "device", None)

    # -- negotiation -------------------------------------------------------
    def configure(self, in_caps, out_pads):
        self.in_caps = dict(in_caps)
        fw = self._ensure_fw()
        if getattr(fw, "continuous", False):
            self.wants_async_emit = True
        if (self._reduced_admissible
                and self.reduced_output_selected is None
                and not self.props.get("output")):
            # residency planner: every consumer below admits any geometry
            # and no output= pins it, so the model switches to its reduced
            # variant (none: no-op) before the spec propagates
            desc = fw.select_reduced_output()
            if desc:
                self.reduced_output_selected = desc
                log.info("%s: residency planner selected reduced output: %s",
                         self.name, desc)
        fw_in, fw_out = fw.get_model_info()
        src = next(iter(in_caps.values()), Caps.any())
        up_spec = self._up_spec = src.spec
        # input-combination selects which upstream tensors feed the model:
        # the spec check applies to the selected subset
        model_up = up_spec
        if up_spec is not None and self.input_combination is not None:
            if any(i >= len(up_spec) for i in self.input_combination):
                raise ElementError(
                    f"{self.name}: input-combination {self.input_combination} "
                    f"out of range for upstream spec {up_spec}")
            model_up = TensorsSpec(
                tuple(up_spec[i] for i in self.input_combination),
                rate=up_spec.rate)
        if fw_in is None:
            fw_in = model_up
        elif model_up is not None and not model_up.is_flexible:
            if len(model_up) != len(fw_in) or not all(
                a.is_compatible(b) for a, b in zip(model_up, fw_in)
            ):
                raise ElementError(
                    f"{self.name}: upstream spec {model_up} does not match model "
                    f"input {fw_in}"
                )
        if fw_in is not None:
            fw.set_input_spec(fw_in)
        self._out_spec = fw_out
        final_out = self._combined_out_spec(fw_out)
        fmt = TensorFormat.FLEXIBLE if self.invoke_dynamic else TensorFormat.STATIC
        caps = Caps.tensors(final_out.replace(format=fmt)
                            if final_out is not None else None)
        self.out_caps = {p: caps for p in out_pads}
        return self.out_caps

    def _combined_out_spec(self, fw_out):
        """Output spec after output-combination (iN = upstream tensor,
        oN = model output); None when not known statically."""
        if self.output_combination is None:
            return fw_out
        parts = []
        for tag, i in self.output_combination:
            pool = self._up_spec if tag == "i" else fw_out
            if pool is None or i >= len(pool):
                return None  # derived per buffer
            parts.append(pool[i])
        return TensorsSpec(tuple(parts))

    def _select_inputs(self, tensors):
        if self.input_combination is None:
            return list(tensors)
        if any(i >= len(tensors) for i in self.input_combination):
            raise ElementError(
                f"{self.name}: input-combination {self.input_combination} "
                f"out of range (buffer has {len(tensors)} tensors)")
        return [tensors[i] for i in self.input_combination]

    def _compose_outputs(self, in_tensors, outs):
        if self.output_combination is None:
            return list(outs)
        final = []
        for tag, i in self.output_combination:
            pool = in_tensors if tag == "i" else outs
            if i >= len(pool):
                raise ElementError(
                    f"{self.name}: output-combination {tag}{i} out of range")
            final.append(pool[i])
        return final

    # -- streaming ---------------------------------------------------------
    def process(self, pad, buf: Buffer):
        fw = self._ensure_fw()
        if getattr(fw, "continuous", False):
            # the standing serve loop takes the request (its meta rides
            # along) and emits one buffer per token from its own thread
            fw.submit(self._select_inputs(buf.tensors), dict(buf.meta),
                      functools.partial(self._emit_serve_token, buf))
            return []
        if fw.streaming:
            return self._stream(fw, buf)
        t0 = time.perf_counter()
        outs = fw.invoke(self._select_inputs(buf.tensors))
        self._record(time.perf_counter() - t0)
        final = self._compose_outputs(buf.tensors, list(outs))
        spec = (None if self.invoke_dynamic
                else self._combined_out_spec(self._out_spec))
        return [(SRC, buf.with_tensors(final, spec=spec))]

    def _stream(self, fw: Framework, buf: Buffer):
        """Many buffers per input: the runner iterates this generator, so
        each token flows downstream while the next is still decoding.  A
        one-step lookahead lets the FINAL buffer carry ``stream_last``."""
        t0 = time.perf_counter()
        prev = None
        ins = self._select_inputs(buf.tensors)
        for i, outs in enumerate(fw.invoke_stream(ins)):
            if prev is not None:
                yield (SRC, prev)
            prev = buf.with_tensors(
                self._compose_outputs(buf.tensors, list(outs)), spec=None)
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

    # -- fusion ------------------------------------------------------------
    def device_fn(self, in_spec: TensorsSpec):
        """The framework's pure callable with the combinations around it;
        None for ``invoke-dynamic``, a streaming or continuous framework
        (the llm filter keeps its own stage) or one without a callable."""
        fw = self._ensure_fw()
        if (self.invoke_dynamic or fw.streaming
                or getattr(fw, "continuous", False)):
            return None
        fn = fw.pure_fn()
        if fn is None:
            return None
        out_spec = self._out_spec
        if out_spec is None:
            _, out_spec = fw.get_model_info()
        if out_spec is None:
            return None
        if self.input_combination is None and self.output_combination is None:
            return fn, out_spec
        combined = self._combined_out_spec(out_spec)
        if combined is None:
            return None  # statically unknown output: the host path handles it
        combo_in, combo_out = self.input_combination, self.output_combination

        def wrapped(arrays):
            model_in = (tuple(arrays[i] for i in combo_in)
                        if combo_in is not None else arrays)
            outs = fn(model_in)
            if combo_out is None:
                return outs
            return tuple(
                (arrays if tag == "i" else outs)[i] for tag, i in combo_out)

        return wrapped, combined

    def _record(self, dt: float) -> None:
        if self.latency_report:
            metrics.observe_latency(f"{self.name}.invoke", dt)
