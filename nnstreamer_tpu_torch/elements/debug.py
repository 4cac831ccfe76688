"""tensor_debug: passthrough that logs caps/shape/timing metadata.

Port of ``nnstreamer_tpu/elements/debug.py`` (reference:
``gsttensor_debug.c``).  A tensor is described by its shape and dtype, so
a card tensor is never fetched.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.log import logger
from ..core.registry import register_element
from .base import Element, SRC

log = logger(__name__)


def describe(t) -> str:
    """``(shape):dtype`` of a tensor, as the JAX package prints it."""
    if isinstance(t, torch.Tensor):
        return f"{tuple(t.shape)}:{str(t.dtype).replace('torch.', '')}"
    a = np.asarray(t)
    return f"{tuple(a.shape)}:{a.dtype}"


@register_element("tensor_debug")
class TensorDebug(Element):
    kind = "tensor_debug"

    def __init__(self, props=None, name=None):
        super().__init__(props, name)
        self.console = bool(self.props.get("console", False))
        self.count = 0

    def process(self, pad, buf):
        self.count += 1
        desc = ", ".join(describe(t) for t in buf.tensors)
        msg = f"[{self.name}] #{self.count} pts={buf.pts} tensors=[{desc}] meta={list(buf.meta)}"
        if self.console:
            print(msg)
        else:
            log.info("%s", msg)
        return [(SRC, buf)]
