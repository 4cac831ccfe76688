"""Element base classes.

Port of ``nnstreamer_tpu/elements/base.py`` (reference: GstElement /
GstBaseTransform and the per-element chain functions).  An element has:

* **negotiation** — :meth:`Element.configure` maps input :class:`Caps` to
  output Caps once, before streaming starts;
* **streaming** — :meth:`Element.process` handles one buffer push and
  returns downstream pushes (a list, or a generator that the runner
  iterates, so a streaming element emits many buffers per input);
* **fusion** — :meth:`Element.device_fn` offers the element's streaming
  math as a torch callable, which the planner composes with its
  neighbours' into one fused stage (``pipeline/plan.py``), and
  ``host_post`` pairs it with a mapping that finishes on the host;
* **micro-batching** — :meth:`Element.process_batch` handles a batch
  drained from the stage's queue (``pipeline/batching.py``);
* **collation** — an element with ``sync_policy = "all"`` and more than
  one sink pad gets one buffer per pad at a time in
  :meth:`Element.process_group` (the runtime pairs them).

* **abstract execution** — :meth:`Element.abstract_invoke` runs the device
  callable on meta tensors and :meth:`Element.param_bytes` reports the
  weights it keeps, for the deep analyzer (``analysis/tracecheck.py``);
  ``PAD_TEMPLATES`` are the caps its sink pads admit, read offline.

* **the pipeline mesh** — :meth:`Element.place_params` places the
  element's parameters on the mesh before its first sharded dispatch
  and :meth:`Element.slot_device_fn` gives a slot's callable over them
  (``parallel/``, ``pipeline/batching.py``).
"""

from __future__ import annotations

from typing import (Callable, Dict, Iterable, Iterator, List, Optional,
                    Tuple, Union)

from ..core.buffer import Buffer, Event
from ..core.caps import Caps
from ..core.types import TensorsSpec

#: (out_pad, payload) pairs returned from process/finalize.
Out = Iterable[Tuple[str, Union[Buffer, Event]]]

SRC = "src"
SINK = "sink"


class ElementError(RuntimeError):
    pass


def meta_inputs(specs) -> Tuple:
    """One meta tensor per spec (shape and dtype, no storage)."""
    import torch

    from ..core.types import dtype_name

    return tuple(torch.empty(s.shape, dtype=getattr(torch, dtype_name(s.dtype)),
                             device="meta") for s in specs)


class _TrackedProps(dict):
    """Property dict recording which keys the element consulted, so the
    pipeline can reject unknown (typo'd) properties at startup the way
    ``gst_parse_launch`` errors on "no property 'foo' in element"."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.accessed = set()

    def get(self, key, default=None):
        self.accessed.add(key)
        return super().get(key, default)

    def __getitem__(self, key):
        self.accessed.add(key)
        return super().__getitem__(key)

    def __contains__(self, key) -> bool:
        self.accessed.add(key)
        return super().__contains__(key)

    def pop(self, key, *a):
        self.accessed.add(key)
        return super().pop(key, *a)

    # Enumerating the dict counts as consuming every key.
    def _touch_all(self):
        self.accessed.update(super().keys())

    def items(self):
        self._touch_all()
        return super().items()

    def keys(self):
        self._touch_all()
        return super().keys()

    def __iter__(self):
        self._touch_all()
        return super().__iter__()


class Element:
    """Base streaming element."""

    #: registered kind name, set by subclass
    kind: str = "element"
    #: multi-input collation: "all" waits for a buffer on every connected
    #: sink pad and hands the group to :meth:`process_group` (mux, merge,
    #: crop: slowest-pad sync); "any" processes buffers as they arrive
    sync_policy: str = "any"
    #: class-level flags the static analyzer reads without instantiating
    is_source = False
    is_sink = False
    #: sink pad templates: pad name (or ``sink_%u`` request pattern) -> Caps
    #: the pad admits; pads not listed take ANY (``analysis/capsflow.py``
    #: intersects every edge's caps with them, offline)
    PAD_TEMPLATES: Dict[str, object] = {}

    @classmethod
    def pad_template(cls, pad: str):
        """The template for ``pad``: exact name, then the ``%u`` request-pad
        pattern (``sink_3`` -> ``sink_%u``), then the always-pad
        (``sink``/``src``), then ANY."""
        t = cls.PAD_TEMPLATES.get(pad)
        if t is not None:
            return t
        base, sep, idx = pad.rpartition("_")
        if sep and idx.isdigit():
            t = cls.PAD_TEMPLATES.get(f"{base}_%u")
            if t is None:
                t = cls.PAD_TEMPLATES.get(base)
            if t is not None:
                return t
        return Caps.any()

    def __init__(self, props: Optional[Dict[str, object]] = None, name: Optional[str] = None):
        self.props: Dict[str, object] = _TrackedProps(props or {})
        self.name = name or self.kind
        self.in_caps: Dict[str, Caps] = {}
        self.out_caps: Dict[str, Caps] = {}

    def unknown_props(self) -> set:
        """Property keys never consulted by the element (typos).  Checked
        by the pipeline after startup, once every lazy reader has run."""
        p = self.props
        if not isinstance(p, _TrackedProps):
            return set()
        return set(dict.keys(p)) - p.accessed

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        """NULL->READY: open resources."""

    def stop(self) -> None:
        """READY->NULL: release resources."""

    # -- negotiation -------------------------------------------------------
    def configure(self, in_caps: Dict[str, Caps], out_pads: List[str]) -> Dict[str, Caps]:
        """Map input caps to output caps for each connected out pad.
        Default: passthrough of the (single) input caps."""
        self.in_caps = dict(in_caps)
        src = next(iter(in_caps.values()), Caps.any())
        caps = {p: src for p in out_pads}
        self.out_caps = caps
        return caps

    # -- streaming ---------------------------------------------------------
    def process(self, pad: str, buf: Buffer) -> Out:
        """Handle one input buffer; return downstream pushes."""
        raise NotImplementedError

    def process_batch(self, pad: str, bufs: List[Buffer]) -> Out:
        """Handle a micro-batch drained from this stage's queue in one
        call; outputs in input order.  Default: ``process`` per buffer.
        Device stages (a fused chain, a pure tensor_filter) override it
        with one bucketed step.  Called only on a stage planned batchable
        (:meth:`batch_capable`) in a pipeline with ``batch_max > 1``."""
        outs: List = []
        for buf in bufs:
            outs.extend(self.process(pad, buf))
        return outs

    def process_group(self, bufs: Dict[str, Buffer]) -> Out:
        """Handle one collated group, a buffer per sink pad
        (``sync_policy == "all"``)."""
        raise NotImplementedError

    def on_event(self, pad: str, event: Event) -> Out:
        """Non-EOS in-band events; default forwards to all out pads."""
        return [(SRC, event)]

    def finalize(self) -> Out:
        """All input pads reached EOS: flush buffered state."""
        return []

    def batch_capable(self) -> bool:
        """True when this element's work is one pure device callable per
        buffer (a pure tensor_filter): what micro-batching vmaps, and what
        the planner marks batchable and restartable.  Default: False."""
        return False

    def place_params(self, mesh) -> bool:
        """Place this element's device parameters onto ``mesh``, once per
        stage before its first sharded dispatch (``pipeline/batching.py``).
        True when anything was placed.  Default: no parameters."""
        return False

    def slot_device_fn(self, in_spec: TensorsSpec, slot):
        """One mesh slot's callable after :meth:`place_params`, over the
        slot's copy of the placed parameters.  Default: :meth:`device_fn`'s
        callable, which holds no parameters."""
        df = self.device_fn(in_spec)
        return None if df is None else df[0]

    # -- fusion ------------------------------------------------------------
    def device_fn(
        self, in_spec: TensorsSpec
    ) -> Optional[Tuple[Callable, TensorsSpec]]:
        """``(fn, out_spec)`` when this element's streaming math can run
        inside a fused stage: ``fn`` maps a tuple of torch tensors to a
        tuple of torch tensors on the same device, with no host read and no
        host-to-device copy (the fused stage captures it as a CUDA graph).
        None => host-only element."""
        return None

    #: deferred host mapping paired with :meth:`device_fn`: called as
    #: ``host_post(host_arrays, buf)`` at the pipeline edge on the fused
    #: stage's (small) outputs; None => the device outputs are the payload
    host_post = None

    # -- abstract execution (lint --deep) -----------------------------------
    def abstract_invoke(
        self, in_spec: TensorsSpec
    ) -> Optional[Tuple[List, Optional[TensorsSpec]]]:
        """Run :meth:`device_fn`'s callable on meta tensors built from
        ``in_spec``: shapes and dtypes only, no data and no device work.
        Returns ``(output meta tensors, declared out spec)``, or None when
        the element has no device path for this spec.  Errors propagate
        (``.item()`` on a meta tensor, a data-dependent shape): the deep
        analyzer (``analysis/tracecheck.py``) reports them."""
        df = self.device_fn(in_spec)
        if df is None:
            return None
        fn, declared = df
        out = fn(meta_inputs(in_spec))
        if not isinstance(out, (tuple, list)):
            out = (out,)
        return list(out), declared

    def param_bytes(self) -> int:
        """Bytes of device-resident parameters this element keeps for the
        pipeline's life (model weights), for the deep analyzer's estimate
        and xray's ledger.  Default: none."""
        return 0

    def __repr__(self):  # pragma: no cover
        return f"<{type(self).__name__} {self.name!r}>"


class SourceElement(Element):
    """Element with no input pads; drives the pipeline (GstBaseSrc)."""

    is_source = True

    def generate(self) -> Iterator[Union[Buffer, Event]]:
        """Yield buffers; return to signal EOS."""
        raise NotImplementedError


class SinkElement(Element):
    """Terminal element (GstBaseSink / tensor_sink)."""

    is_sink = True
