"""Framework sub-plugin API for tensor_filter.

Port of ``nnstreamer_tpu/filters/base.py`` (reference:
``GstTensorFilterFramework`` in ``nnstreamer_plugin_api_filter.h`` —
open/close/invoke/getModelInfo/setInputDimension).

Contract:

* :meth:`Framework.open` loads the model named by ``props['model']``.
* :meth:`Framework.invoke` maps input arrays -> output arrays.
* :meth:`Framework.pure_fn` optionally returns a pure torch callable
  ``tuple(tensors) -> tuple(tensors)``; :meth:`Framework.abstract_invoke`
  runs it on meta tensors (shapes and dtypes only, no data, no device).
* Streaming frameworks set ``streaming = True`` and implement
  ``invoke_stream``, a generator of output lists.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..core.types import TensorsSpec, dtype_name


class FrameworkError(RuntimeError):
    pass


class Framework:
    """Base class for tensor_filter framework sub-plugins."""

    #: registered name, e.g. "llm"
    name: str = "base"
    #: emits many output buffers per input through invoke_stream
    streaming: bool = False

    def __init__(self):
        self.props: Dict[str, object] = {}

    # -- lifecycle ---------------------------------------------------------
    def open(self, props: Dict[str, object]) -> None:
        """Load the model; raise FrameworkError when the model prop is
        unusable (framework=auto falls through the priority list)."""
        # Keep the element's own (tracked) dict: reads here count toward
        # the pipeline's unknown-property check.
        self.props = props if isinstance(props, dict) else dict(props)

    def close(self) -> None:
        pass

    # -- model metadata ----------------------------------------------------
    def get_model_info(self) -> Tuple[Optional[TensorsSpec], Optional[TensorsSpec]]:
        """(input spec, output spec); either may be None when unknown."""
        return None, None

    def set_input_spec(self, spec: TensorsSpec) -> None:
        """Reference setInputDimension: reconfigure for a new input shape."""

    # -- execution ---------------------------------------------------------
    def invoke(self, inputs: Sequence) -> List:
        raise NotImplementedError

    def pure_fn(self) -> Optional[Callable]:
        """Optional pure torch callable ``tuple(tensors) -> tuple(tensors)``."""
        return None

    def select_reduced_output(self) -> Optional[str]:
        """Switch the loaded model to its reduced output variant when it
        has one (``ModelBundle.reduced_variant``), and say what it is.
        tensor_filter calls this during negotiation, only after the
        residency planner found that every consumer below admits the
        reduced geometry (``pipeline/residency.py``).  Default: none."""
        return None

    def abstract_invoke(self, in_specs: Sequence[TensorsSpec]) -> Optional[List]:
        """Run :meth:`pure_fn` on meta tensors built from ``in_specs``
        (one :class:`~..core.types.TensorSpec` per input) and return the
        output meta tensors: shapes and dtypes with no data and no device
        work.  None when the framework has no pure callable."""
        fn = self.pure_fn()
        if fn is None:
            return None
        ins = tuple(
            torch.empty(s.shape, dtype=getattr(torch, dtype_name(s.dtype)),
                        device="meta")
            for s in in_specs)
        out = fn(ins)
        if not isinstance(out, (tuple, list)):
            out = (out,)
        return list(out)


def parse_custom_options(custom: str) -> Dict[str, str]:
    """Parse the tensor_filter ``custom=key:val,key2:val2`` option string."""
    out: Dict[str, str] = {}
    for part in str(custom or "").split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            k, v = part.split(":", 1)
            out[k.strip()] = v.strip()
        else:
            out[part] = "true"
    return out


def parse_accelerator(acc: str) -> List[str]:
    """Parse ``accelerator=true:gpu`` into the listed devices
    (reference: hw accel string in tensor_filter_common.c)."""
    s = str(acc or "").strip()
    if not s or s.lower() in ("false", "none"):
        return []
    if ":" in s:
        flag, devs = s.split(":", 1)
        if flag.lower() == "false":
            return []
        return [d.strip().lower() for d in devs.split(",") if d.strip()]
    return []


def resolve_device(acc: str) -> torch.device:
    """The device a filter runs on, from its ``accelerator=`` property.

    ``true:cpu`` selects the CPU.  Absent, ``true:gpu`` or ``true:cuda``
    selects the card, and raises when there is none: the filter never
    carries on on the CPU by itself.  A preference list (``true:gpu,cpu``)
    raises too, because a list would make the CPU a silent fallback."""
    devs = parse_accelerator(acc)
    if len(devs) > 1:
        raise FrameworkError(
            f"accelerator={acc!r} lists {devs}: name exactly one device "
            "(true:gpu or true:cpu); a preference list is not supported")
    dev = devs[0] if devs else "gpu"
    if dev == "cpu":
        return torch.device("cpu")
    if dev not in ("gpu", "cuda"):
        raise FrameworkError(
            f"accelerator={acc!r}: unknown device {dev!r} (gpu, cuda, cpu)")
    if not torch.cuda.is_available():
        raise FrameworkError(
            "no CUDA device is available; set accelerator=true:cpu to run "
            "this filter on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
