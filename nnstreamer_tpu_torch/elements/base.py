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
  ``host_post`` pairs it with a mapping that finishes on the host.

``process_batch`` (micro-batching) and ``place_params`` (meshes) are
not ported yet.
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

    def on_event(self, pad: str, event: Event) -> Out:
        """Non-EOS in-band events; default forwards to all out pads."""
        return [(SRC, event)]

    def finalize(self) -> Out:
        """All input pads reached EOS: flush buffered state."""
        return []

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

    def __repr__(self):  # pragma: no cover
        return f"<{type(self).__name__} {self.name!r}>"


class SourceElement(Element):
    """Element with no input pads; drives the pipeline (GstBaseSrc)."""

    def generate(self) -> Iterator[Union[Buffer, Event]]:
        """Yield buffers; return to signal EOS."""
        raise NotImplementedError


class SinkElement(Element):
    """Terminal element (GstBaseSink / tensor_sink)."""
