"""nnstreamer_tpu_torch — the PyTorch/CUDA port of nnstreamer_tpu.

The same gst-launch ``!`` pipeline DSL, element vocabulary and
``Element`` / ``Framework`` / ``Buffer`` contracts as ``nnstreamer_tpu``,
on PyTorch, with the kernels on the main path written by hand in CUDA C++
for Hopper (``csrc/``).  This package imports ``torch`` and never
``jax``; the JAX package stays the reference it is tested against.

What runs so far is the LLM serving path: the static stream path::

    import nnstreamer_tpu_torch as ntt

    p = ntt.Pipeline(
        "appsrc name=src ! tensor_filter framework=llm model=llama2_7b "
        "custom=quant:int4,param_dtype:bfloat16,max_new:64 ! "
        "tensor_sink name=out")
    with p:
        p.push("src", prompt_ids)       # int32 token ids, or text bytes
        token = p.pull("out")           # one buffer per generated token

the continuous serving loop (``custom=serve:continuous``), the query
front door in front of either (``tensor_query_serversrc ! tensor_filter
! tensor_query_serversink`` serving ``tensor_query_client`` pipelines
over TCP), and the vision path: ``tensor_transform ! tensor_filter
framework=jax model=mobilenet_v1|ssd_mobilenet ! tensor_decoder
mode=image_labeling|bounding_boxes``, each such chain fused into one
stage that runs as a captured CUDA graph (``Pipeline(fuse=True)``, the
default).  Filters run on the CUDA card unless ``accelerator=true:cpu``
is set on the tensor_filter.

``analyze(desc, deep=True)`` lints a pipeline without running it (the
deep pass on meta tensors predicts its census and device memory), and
``Pipeline(desc, xray=True)`` then holds the running pipeline to that
prediction (``Pipeline.explain()``).
"""

from .core.types import (  # noqa: F401
    TensorFormat,
    TensorSpec,
    TensorsSpec,
    dtype_from_name,
    dtype_name,
    parse_dims,
)
from .core.buffer import Buffer, Event  # noqa: F401
from .core.caps import Caps, MediaType  # noqa: F401
from .core import registry  # noqa: F401
from .core.registry import register_element, register_filter  # noqa: F401
from .pipeline.parser import ParseError  # noqa: F401
from .pipeline.parser import parse as parse_launch  # noqa: F401
from .pipeline.graph import PipelineGraph  # noqa: F401
from .pipeline.runtime import Pipeline, PipelineError  # noqa: F401
from .elements.filter import SingleShot  # noqa: F401
from .analysis import PipelineLintError, analyze  # noqa: F401

__version__ = "0.1.0"
