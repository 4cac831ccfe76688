"""custom-easy framework: register a Python callable as a model.

Port of ``nnstreamer_tpu/filters/custom_easy.py`` (reference analog:
``tensor_filter_custom_easy.c`` — "register a C callback as a model,
in-process, no .so — heavily used by tests as a fake framework").  Tests
drive the whole filter machinery through it with passthrough or scale
callables and no real model.

API::

    from nnstreamer_tpu_torch.filters.custom_easy import register_custom_easy

    register_custom_easy(
        "scale2", lambda ins: [ins[0] * 2],
        in_spec=TensorsSpec.from_string("3:4:4:1", "float32"),
        out_spec=TensorsSpec.from_string("3:4:4:1", "float32"),
        jax_traceable=True,   # a pure torch callable: the planner may fuse it
    )
    ... tensor_filter framework=custom-easy model=scale2 ...

``jax_traceable`` keeps the JAX package's name: here it declares the
callable a pure ``tensors -> tensors`` torch function that a fused stage
may capture.  ``param_bytes`` declares the weight bytes the callable
closes over, for the deep analyzer's estimate and xray's ledger.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..core.registry import register_filter
from ..core.types import TensorsSpec
from .base import Framework, FrameworkError

#: name -> (fn, in_spec, out_spec, traceable, param_bytes)
_models: Dict[str, Tuple[Callable, Optional[TensorsSpec],
                         Optional[TensorsSpec], bool, int]] = {}
_lock = threading.Lock()


def register_custom_easy(
    name: str,
    fn: Callable[[Sequence], List],
    in_spec: Optional[TensorsSpec] = None,
    out_spec: Optional[TensorsSpec] = None,
    jax_traceable: bool = False,
    param_bytes: int = 0,
) -> None:
    """Register ``fn(list_of_arrays) -> list_of_arrays`` as model ``name``;
    ``param_bytes`` declares the device-resident weight bytes it closes
    over (0 = none or unknown)."""
    with _lock:
        _models[name] = (fn, in_spec, out_spec, bool(jax_traceable),
                         int(param_bytes))


def unregister_custom_easy(name: str) -> bool:
    with _lock:
        return _models.pop(name, None) is not None


@register_filter("custom-easy")
class CustomEasyFramework(Framework):
    name = "custom-easy"

    def __init__(self):
        super().__init__()
        self._fn: Optional[Callable] = None
        self._in: Optional[TensorsSpec] = None
        self._out: Optional[TensorsSpec] = None
        self._traceable = False
        self._param_bytes = 0

    def open(self, props):
        super().open(props)
        model = props.get("model")
        with _lock:
            entry = _models.get(str(model))
        if entry is None:
            if callable(model):  # the callable passed directly
                self._fn, self._in, self._out, self._traceable = \
                    model, None, None, False
                return
            raise FrameworkError(f"no custom-easy model registered as {str(model)!r}")
        (self._fn, self._in, self._out, self._traceable,
         self._param_bytes) = entry

    def get_model_info(self):
        return self._in, self._out

    def set_input_spec(self, spec: TensorsSpec) -> None:
        if self._in is None:
            self._in = spec

    def param_bytes(self) -> int:
        return self._param_bytes

    def invoke(self, inputs):
        return list(self._fn(list(inputs)))

    def pure_fn(self):
        if not self._traceable:
            return None
        fn = self._fn
        return lambda arrays: tuple(fn(list(arrays)))
