"""tensor_filter: run a model as a stream element.

Port of ``nnstreamer_tpu/elements/filter.py`` (reference:
``gsttensor_filter.c`` + ``tensor_filter_common.c``): framework selection
(``auto`` walks the configured priority list), model load at READY,
input/output specs from the framework (``input=`` / ``output=`` with
``inputtype=`` / ``outputtype=`` override them), per-invoke latency,
``invoke-dynamic`` flexible output and ``input-combination`` /
``output-combination`` remapping.  A framework with a pure torch
callable (``framework=jax``) offers it as :meth:`TensorFilter.device_fn`,
so the planner fuses the filter with its neighbours.  A streaming framework (the llm
filter) emits one buffer per generated token, marked with
``stream_index`` and, on the last one, ``stream_last``.  A continuous-
serving framework (``serve:continuous``) takes each input into its
standing loop and emits the tokens from the loop's thread (async emit);
its live streams drain off the loop and are adopted by another
(:meth:`TensorFilter.drain_serve_stream`, :meth:`adopt_serve_stream`).
A filter with a pure callable runs a micro-batch drained from its queue
as one bucketed step (:meth:`TensorFilter.process_batch`,
``pipeline/batching.py``).  :meth:`TensorFilter.reload_model` swaps the
model in place, :meth:`TensorFilter.swap_params` only its weights
(train-while-serve); :class:`SingleShot` invokes a framework without a
pipeline.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.buffer import Buffer, host_value
from ..core.caps import Caps, MediaType
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


def _load_framework(props: Dict[str, object],
                    mesh_provider=None) -> Framework:
    """framework= name or 'auto' (priority list from config).
    ``mesh_provider`` (the pipeline's ``_model_mesh``) is handed to the
    framework before its open(), so a tensor-parallel framework (the llm
    filter) opens on the pipeline's mesh."""
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
        if mesh_provider is not None:
            fw._mesh_provider = mesh_provider
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
    PAD_TEMPLATES = {"sink": Caps.new(MediaType.TENSORS)}
    #: set at negotiation for a continuous-serving framework: the runner
    #: then injects ``_async_emit``
    wants_async_emit = False

    def __init__(self, props=None, name=None):
        super().__init__(props, name)
        self.fw: Optional[Framework] = None
        self.invoke_dynamic = bool(self.props.get("invoke_dynamic", False))
        self.latency_report = bool(self.props.get("latency", get_config().enable_latency))
        self._in_spec: Optional[TensorsSpec] = None
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
        # read now: inputtype/outputtype are legal without input/output dims
        self.props.get("inputtype")
        self.props.get("outputtype")
        #: id(framework) -> (framework, BatchRunner): one entry, for the
        #: framework now loaded (a new one drops the old bucket steps)
        self._batchers: Dict[int, tuple] = {}
        #: moving average of the seconds per invoke (``latency`` prop)
        self._lat_ema: Optional[float] = None
        #: held across a host invoke and around reload_model's and
        #: swap_params' swaps
        self._fw_lock = threading.Lock()
        #: swaps that landed (the ``<name>.param_version`` gauge)
        self._param_version = 0

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self._ensure_fw()

    def _ensure_fw(self) -> Framework:
        if self.fw is None:
            self.fw = _load_framework(
                self.props, mesh_provider=getattr(self, "_mesh_provider", None))
        # the pipeline's armor (Pipeline(quarantine=...)), through which the
        # llm serve loop's nan_guard quarantines a poisoned prompt
        self.fw._armor = getattr(self, "_armor", None)
        # xray: the framework's captured steps count under this element's
        # name (None = off: the framework never learns xray exists)
        xr = getattr(self, "_xray", None)
        if xr is not None and getattr(self.fw, "_xray", None) is not xr:
            self.fw.attach_xray(xr, self.name,
                                rec=lambda: getattr(self, "_trace_rec", None))
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
        # explicit props override / fill in what the framework does not know
        if self.props.get("input"):
            fw_in = TensorsSpec.from_string(
                str(self.props["input"]), str(self.props.get("inputtype", "float32")))
        if self.props.get("output"):
            fw_out = TensorsSpec.from_string(
                str(self.props["output"]), str(self.props.get("outputtype", "float32")))
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
        self._in_spec = fw_in
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
            # along) and emits one buffer per token from its own thread;
            # its serve.* spans follow THIS pipeline's trace_mode (the
            # element's recorder, None when tracing is off)
            fw._trace_rec = getattr(self, "_trace_rec", None)
            fw.submit(self._select_inputs(buf.tensors), dict(buf.meta),
                      functools.partial(self._emit_serve_token, buf))
            return []
        if fw.streaming:
            return self._stream(fw, buf)
        t0 = time.perf_counter()
        with self._fw_lock:
            # held across the invoke so that reload_model cannot close the
            # framework under an in-flight call; a reload may have swapped
            # it since the peek above
            outs = self._ensure_fw().invoke(self._select_inputs(buf.tensors))
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

    # -- elastic serving: drain / adopt ---------------------------------------
    def serve_streams(self) -> Dict[int, dict]:
        """Live, mid-prefill and queued streams of this element's
        continuous loop (empty for any other filter)."""
        fw = self.fw
        if fw is None or not getattr(fw, "continuous", False):
            return {}
        return fw.serve_streams()

    def _continuous_fw(self) -> Framework:
        fw = self._ensure_fw()
        if not getattr(fw, "continuous", False):
            raise ElementError(f"{self.name}: not a continuous-serving filter")
        return fw

    def drain_serve_stream(self, stream_id: int, timeout: float = 30.0) -> dict:
        """Take one stream off the standing loop as a host snapshot (the
        :meth:`Pipeline.drain_stream` element hop)."""
        return self._continuous_fw().drain_stream(stream_id, timeout)

    def adopt_serve_stream(self, snapshot: dict, timeout: float = 30.0) -> int:
        """Re-admit a drained stream into this element's loop; its
        remaining tokens flow downstream as a local stream's do (the same
        async emit, the loop's meta winning), and its spans follow this
        pipeline's trace mode."""
        fw = self._continuous_fw()
        fw._trace_rec = getattr(self, "_trace_rec", None)
        prompt = snapshot.get("prompt")
        src_buf = Buffer([np.asarray(prompt, np.int32) if prompt is not None
                          else np.zeros((1, 0), np.int32)])
        return fw.adopt_stream(
            snapshot, functools.partial(self._emit_serve_token, src_buf),
            timeout)

    def finalize(self):
        fw = self.fw
        if fw is not None and getattr(fw, "continuous", False):
            # EOS reached the element: every admitted stream finishes (and
            # emits its stream_last) before EOS goes downstream
            if not fw.drain(timeout=600):
                raise ElementError(
                    f"{self.name}: continuous serve loop failed to drain")
        return []

    # -- micro-batching ----------------------------------------------------
    def _batchable_fn(self, fw):
        """The batchability predicate, shared by the planner's probe and
        the dispatch: the framework's pure callable when one vmapped
        bucket step may replace N invokes, else None (a streaming or
        continuous framework emits per request, and ``invoke-dynamic``
        output shapes vary per buffer)."""
        if (self.invoke_dynamic or fw.streaming
                or getattr(fw, "continuous", False)):
            return None
        return fw.pure_fn()

    def batch_capable(self) -> bool:
        try:
            return self._batchable_fn(self._ensure_fw()) is not None
        except Exception:  # noqa: BLE001 - capability probe only
            return False

    # -- train-while-serve: param hot-swap ------------------------------------
    def swap_params(self, tree) -> int:
        """Hot-swap the live model weights by value: delegates to the
        framework's ``swap_params`` under ``_fw_lock``, so the swap lands
        between invokes (a continuous framework further defers to its own
        chunk boundary).  Bumps and returns the stage's param version
        (``<name>.param_version`` gauge, ``<name>.param_swaps``,
        ``learn.swap`` span).  Raises while the stage holds micro-batch
        bucket steps: they close over the weights they were built with."""
        t0 = time.monotonic_ns()
        with self._fw_lock:
            if self._batchers:
                raise FrameworkError(
                    f"{self.name}: micro-batched dispatch captures "
                    "params at build time — hot-swap needs batch_max=1")
            self._ensure_fw().swap_params(tree)
            self._param_version += 1
            version = self._param_version
        metrics.count(f"{self.name}.param_swaps")
        metrics.gauge(f"{self.name}.param_version", float(version))
        rec = getattr(self, "_trace_rec", None)
        if rec is not None and rec.active:
            rec.record("learn.swap", self.name, None, t0,
                       time.monotonic_ns() - t0, version=version)
        return version

    def process_batch(self, pad, bufs):
        """N same-signature buffers -> one bucketed step of the
        framework's pure callable (``pipeline/batching.py``); each output
        keeps its buffer's pts and meta, in order.  A framework that no
        longer offers a callable takes the per-buffer loop.  ``.invoke``
        is observed per buffer (the batch's time over n), so the series
        keeps one meaning whether batching is on or off."""
        t0 = time.perf_counter()
        fw = self._ensure_fw()
        fn = self._batchable_fn(fw)
        if fn is None:
            return super().process_batch(pad, bufs)
        # keyed by framework identity: pure_fn() is a fresh closure per
        # call, and a reloaded framework's weights must not meet the old
        # bucket steps
        entry = self._batchers.get(id(fw))
        if entry is None:
            from ..pipeline.batching import BatchRunner
            from ..pipeline.graphs import Census

            dev = getattr(fw, "device", None)
            census = Census(dev) if dev is not None else None
            xr = getattr(self, "_xray", None)
            if xr is not None and census is not None:
                census.attach_xray(xr, self.name,
                                   lambda: getattr(self, "_trace_rec", None))
            mesh = getattr(self, "_shard_mesh", None)
            prep = None
            if mesh is not None:
                # this framework's params placed once, then each slot's
                # callable over its view of them (a reloaded framework
                # gets a runner, and a placement, of its own)
                def prep(m, fw=fw):
                    self._place_fw_params(fw, m)
                    return fw.slot_fn
            entry = (fw, BatchRunner(
                fn, getattr(self, "_batch_buckets", None), name=self.name,
                ladder=getattr(self, "_batch_ladder", None), census=census,
                mesh=mesh, prepare=prep))
            self._batchers = {id(fw): entry}
        rows = entry[1].run([tuple(self._select_inputs(b.tensors)) for b in bufs])
        self._record((time.perf_counter() - t0) / len(bufs))
        spec = (None if self.invoke_dynamic
                else self._combined_out_spec(self._out_spec))
        return [(SRC, b.with_tensors(
                    self._compose_outputs(b.tensors, list(row)), spec=spec))
                for b, row in zip(bufs, rows)]

    # -- the pipeline mesh ---------------------------------------------------
    def place_params(self, mesh) -> bool:
        """Place the framework's params onto ``mesh`` once (the sharded
        runner's prepare), as the framework's ``place_params`` does."""
        return self._place_fw_params(self._ensure_fw(), mesh)

    def _place_fw_params(self, fw, mesh) -> bool:
        place = getattr(fw, "place_params", None)
        if place is None:
            return False
        split = place(mesh)
        if split is None:
            return False
        n_shard, n_rep = split
        from ..parallel.mesh import mesh_axis_size

        if mesh_axis_size(mesh, "model") > 1 and n_shard + n_rep:
            # the shard / replica split, beside .param_replications
            metrics.count(f"{self.name}.param_shards", n_shard)
            metrics.count(f"{self.name}.param_replicas", n_rep)
        metrics.count(f"{self.name}.param_replications")
        return True

    def _slot_fn(self, fw, slot):
        """One mesh slot's callable: the framework's over the slot's copy
        of its placed params, the combinations around it."""
        return self._combined(fw.slot_fn(slot))

    def slot_device_fn(self, in_spec: TensorsSpec, slot):
        fw = self._ensure_fw()
        if getattr(fw, "slot_fn", None) is None:
            return super().slot_device_fn(in_spec, slot)
        return self._slot_fn(fw, slot)

    def _combined(self, fn):
        """``fn`` with the input / output combinations around it."""
        if self.input_combination is None and self.output_combination is None:
            return fn
        combo_in, combo_out = self.input_combination, self.output_combination

        def wrapped(arrays):
            model_in = (tuple(arrays[i] for i in combo_in)
                        if combo_in is not None else arrays)
            outs = fn(model_in)
            if combo_out is None:
                return outs
            return tuple(
                (arrays if tag == "i" else outs)[i] for tag, i in combo_out)

        return wrapped

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
        return self._combined(fn), combined

    # -- abstract execution (lint --deep) -----------------------------------
    def abstract_invoke(self, in_spec: TensorsSpec):
        """The model core through the framework's ``abstract_invoke`` (on
        meta tensors), with the input/output combinations applied to the
        meta lists as :meth:`device_fn` applies them."""
        fw = self._ensure_fw()
        if self.invoke_dynamic or fw.streaming or getattr(fw, "continuous", False):
            return None  # per-buffer or asynchronous shapes: nothing static
        specs = list(in_spec)
        model_in = ([specs[i] for i in self.input_combination]
                    if self.input_combination is not None else specs)
        model_out = fw.abstract_invoke(model_in)
        if model_out is None:
            return None
        if self.output_combination is None:
            outs = list(model_out)
        else:
            from .base import meta_inputs

            ins = meta_inputs(specs)
            outs = [(ins if tag == "i" else list(model_out))[i]
                    for tag, i in self.output_combination]
        out_spec = self._out_spec
        if out_spec is None:
            _, out_spec = fw.get_model_info()
        declared = (self._combined_out_spec(out_spec)
                    if out_spec is not None else None)
        return outs, declared

    def param_bytes(self) -> int:
        """The framework's resident weights (0 when it reports none)."""
        try:
            return int(self._ensure_fw().param_bytes())
        except Exception:  # noqa: BLE001 - accounting probe only
            return 0

    def _record(self, dt: float) -> None:
        if self.latency_report:
            metrics.observe_latency(f"{self.name}.invoke", dt)
            self._lat_ema = dt if self._lat_ema is None else 0.9 * self._lat_ema + 0.1 * dt

    # -- model reload (reference: tensor_filter_common.c ReloadModel) ------
    def reload_model(self, model: Optional[object] = None) -> None:
        """Swap the model without rebuilding the pipeline.

        Builds a fresh framework from the element's props (``model``
        overridden when given), checks that the new model's I/O spec still
        matches what was negotiated, then swaps it in; an invoke in flight
        finishes on the old framework.  A filter already captured into a
        FUSED stage keeps running the captured program (the planner traced
        it at plan time): the reload applies to the element's own invoke
        path, as in the reference."""
        props = dict(self.props)
        if model is not None:
            props["model"] = model
        new_fw = _load_framework(
            props, mesh_provider=getattr(self, "_mesh_provider", None))
        new_in, new_out = new_fw.get_model_info()
        for have, new, what in ((self._in_spec, new_in, "input"),
                                (self._out_spec, new_out, "output")):
            if have is not None and new is not None and not have.is_flexible:
                if len(have) != len(new) or not all(
                        a.is_compatible(b) for a, b in zip(have, new)):
                    new_fw.close()
                    raise ElementError(
                        f"{self.name}: reload {what} spec {new} does not "
                        f"match negotiated {have}")
        if new_in is not None:
            new_fw.set_input_spec(self._in_spec or new_in)
        with self._fw_lock:
            old, self.fw = self.fw, new_fw
            # a streaming framework may still be decoding on the old
            # instance: dropping the reference frees it when that ends
            if old is not None and not old.streaming:
                old.close()
        if model is not None:
            self.props["model"] = model
        log.info("%s: model reloaded (%s)", self.name, props.get("model"))

    # -- introspection (reference: latency/throughput read-only props) -----
    @property
    def latency(self) -> Optional[float]:
        """Moving-average seconds per invoke (recorded with ``latency=1``)."""
        return self._lat_ema

    @property
    def throughput(self) -> Optional[float]:
        return (1.0 / self._lat_ema) if self._lat_ema else None


class SingleShot:
    """Invoke a filter without a pipeline.

    Reference analog: ``gsttensor_filter_single.c``, the basis of the ML
    C-API's ``ml_single_open``/``ml_single_invoke``.  The framework runs
    where its ``accelerator=`` says, the card by default; outputs come
    back as host numpy arrays (bf16 as CPU torch tensors).

    >>> s = SingleShot(framework="jax", model="mobilenet_v1")
    >>> out = s.invoke(np.zeros((1, 224, 224, 3), np.float32))
    """

    def __init__(self, framework: str = "auto", model: object = "", **props):
        p = dict(props)
        p["framework"] = framework
        p["model"] = model
        self.fw = _load_framework(p)
        self.in_spec, self.out_spec = self.fw.get_model_info()

    def invoke(self, *arrays) -> List:
        if len(arrays) == 1 and isinstance(arrays[0], (list, tuple)):
            arrays = tuple(arrays[0])
        outs = self.fw.invoke(list(arrays))
        return [host_value(o) for o in outs]

    def close(self) -> None:
        self.fw.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
