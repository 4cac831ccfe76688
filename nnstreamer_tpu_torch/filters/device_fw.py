"""The fusable device framework for tensor_filter: zoo models on the card.

The counterpart of ``nnstreamer_tpu/filters/jax_fw.py``.  It is
registered as ``jax`` (with the JAX package's aliases) so that the JAX
package's pipeline strings (``tensor_filter framework=jax
model=mobilenet_v1 ...``) run here as written; the names ``torch`` and
``pytorch`` stay free for the counterpart of the JAX package's
``filters/torch_fw.py``, a host-CPU TorchScript filter.

* The model is a zoo bundle built on the filter's device
  (:func:`~.base.resolve_device`: the card unless ``accelerator=true:cpu``;
  no card and no explicit CPU raises).
* :meth:`DeviceFramework.invoke` runs it unfused: inputs are uploaded to
  the device (host arrays through pinned memory), outputs stay there.
* :meth:`DeviceFramework.pure_fn` closes over the params, for the
  planner's fused stages (``pipeline/plan.py``), which capture it as a
  CUDA graph on the card.

* :meth:`DeviceFramework.select_reduced_output` swaps in the bundle's
  reduced output variant for the residency planner (its params shared).

Not ported yet: the ``mesh=data:N`` batch sharding (the mesh slice) and
``swap_params`` (with train-while-serve).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from ..core.buffer import upload
from ..core.registry import register_filter
from ..models.zoo import ModelBundle, build as build_model
from .base import Framework, FrameworkError, parse_custom_options, resolve_device


@register_filter("jax", aliases=("tpu-xla", "xla", "pjrt"))
class DeviceFramework(Framework):
    name = "jax"

    def __init__(self):
        super().__init__()
        self.bundle: Optional[ModelBundle] = None
        self.device: Optional[torch.device] = None

    def open(self, props):
        super().open(props)
        model = props.get("model")
        if model in (None, ""):
            raise FrameworkError("jax framework needs model=<zoo name>")
        opts = parse_custom_options(str(props.get("custom", "")))
        if props.get("mesh") or opts.get("mesh"):
            raise FrameworkError("mesh= is not yet ported")
        self.device = resolve_device(str(props.get("accelerator", "")))
        try:
            self.bundle = build_model(model, opts, device=self.device)
        except KeyError as e:
            raise FrameworkError(str(e)) from e

    def close(self):
        self.bundle = None

    def get_model_info(self):
        if self.bundle is None:
            return None, None
        return self.bundle.in_spec, self.bundle.out_spec

    def select_reduced_output(self) -> Optional[str]:
        b = self.bundle
        if b is None or b.reduced_variant is None:
            return None
        self.bundle = b.reduced_variant()
        return b.reduced_desc or "reduced output"

    def invoke(self, inputs) -> List:
        arrays = tuple(x if isinstance(x, torch.Tensor) and x.device == self.device
                       else upload(x, self.device) for x in inputs)
        return list(self.pure_fn()(arrays))

    def pure_fn(self) -> Optional[Callable]:
        if self.bundle is None:
            return None
        apply_fn = self.bundle.apply_fn
        params = self.bundle.params

        def fn(arrays):
            out = apply_fn(params, *arrays)
            return tuple(out) if isinstance(out, (tuple, list)) else (out,)

        return fn
