"""python3 framework: user script as a model.

Port of ``nnstreamer_tpu/filters/python3.py``: a script written for the
JAX package runs here unchanged.  It gets host numpy arrays (a tensor
on the card is copied to the host first; bf16, which numpy lacks, comes
as a CPU torch tensor) and its outputs go downstream as it returns them.

Reference analog: ``tensor_filter_python3.cc`` + helper (SURVEY §2.4):
embedded CPython running a user class with ``invoke``/``getInputDimension``.
Here the script is named ``model=module.path:attr`` where attr is either

* a class: instantiated; must provide ``invoke(list) -> list`` and may
  provide ``in_spec``/``out_spec`` attributes (TensorsSpec) or
  ``get_spec() -> (in_spec, out_spec)``;
* a plain callable: ``fn(list_of_arrays) -> list_of_arrays``.

(No GIL gymnastics needed: we *are* Python; numpy bridging is the native
data model.)
"""

from __future__ import annotations

import importlib
from typing import Optional

from ..core.buffer import host_value
from ..core.registry import register_filter
from ..core.types import TensorsSpec
from .base import Framework, FrameworkError


@register_filter("python3", aliases=("python",))
class Python3Framework(Framework):
    name = "python3"

    def __init__(self):
        super().__init__()
        self._obj = None
        self._in: Optional[TensorsSpec] = None
        self._out: Optional[TensorsSpec] = None

    def open(self, props):
        super().open(props)
        target = str(props.get("model", ""))
        if ":" not in target:
            raise FrameworkError("python3 framework needs model=module.path:attr")
        mod_name, attr = target.split(":", 1)
        try:
            mod = importlib.import_module(mod_name)
        except ImportError as e:
            raise FrameworkError(f"cannot import {mod_name!r}: {e}") from e
        try:
            obj = getattr(mod, attr)
        except AttributeError as e:
            raise FrameworkError(str(e)) from e
        if isinstance(obj, type):
            obj = obj()
        if not callable(obj) and not hasattr(obj, "invoke"):
            raise FrameworkError(f"{target} is neither callable nor has .invoke")
        self._obj = obj
        if hasattr(obj, "get_spec"):
            self._in, self._out = obj.get_spec()
        else:
            self._in = getattr(obj, "in_spec", None)
            self._out = getattr(obj, "out_spec", None)

    def get_model_info(self):
        return self._in, self._out

    def set_input_spec(self, spec):
        if self._in is None:
            self._in = spec
        if hasattr(self._obj, "set_input_spec"):
            self._obj.set_input_spec(spec)

    def invoke(self, inputs):
        arrays = [host_value(a) for a in inputs]
        if hasattr(self._obj, "invoke"):
            return list(self._obj.invoke(arrays))
        return list(self._obj(arrays))
