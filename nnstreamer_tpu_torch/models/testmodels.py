"""Tiny deterministic zoo models for tests and examples.

Port of ``nnstreamer_tpu/models/testmodels.py`` (reference analog: the
custom example models of the reference's test suites,
``custom_example_passthrough/scaler/average``).  Each is built on the
filter's device, so ``tensor_filter framework=jax model=scaler`` runs and
fuses on the card as the other zoo models do.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..core.types import TensorsSpec
from .zoo import ModelBundle, register_model


@register_model("passthrough")
def _passthrough(opts: Dict[str, str], device) -> ModelBundle:
    spec = TensorsSpec.from_string(opts.get("dims", "3:4:4:1"),
                                   opts.get("dtype", "float32"))
    return ModelBundle(apply_fn=lambda params, *xs: tuple(xs), params=(),
                       in_spec=spec, out_spec=spec, name="passthrough")


@register_model("scaler")
def _scaler(opts: Dict[str, str], device) -> ModelBundle:
    spec = TensorsSpec.from_string(opts.get("dims", "3:4:4:1"), "float32")
    # made at build, on the device: a captured stage reads it in place
    scale = torch.tensor(float(opts.get("scale", 2.0)), dtype=torch.float32,
                         device=device)
    return ModelBundle(apply_fn=lambda params, x: x * params["scale"],
                       params={"scale": scale}, in_spec=spec, out_spec=spec,
                       name="scaler")


@register_model("average")
def _average(opts: Dict[str, str], device) -> ModelBundle:
    """Mean over all non-batch axes, in float32 -> one scalar per batch
    item."""
    in_spec = TensorsSpec.from_string(opts.get("dims", "3:4:4:1"), "float32")
    n = in_spec[0].dims[-1]

    def apply_fn(params, x):
        return torch.mean(x.to(torch.float32),
                          dim=tuple(range(1, x.ndim))).reshape(n, 1)

    return ModelBundle(apply_fn=apply_fn, params=(), in_spec=in_spec,
                       out_spec=TensorsSpec.from_string(f"1:{n}", "float32"),
                       name="average")
