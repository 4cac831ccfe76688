"""Gated framework sub-plugins for runtimes absent in this environment.

Port of ``nnstreamer_tpu/filters/gated.py``: the same names, the same
clear "not installed" error, and the same marshalling when the runtime
imports.  These runtimes run on the host: a tensor on the card is copied
to the host before it is fed.

Reference analog: the reference gates every vendor sub-plugin behind meson
build options (SURVEY §5.6); a framework that wasn't built simply isn't on
disk.  The TPU build registers the names so ``framework=onnxruntime`` etc.
resolve to a clear "runtime not installed" error — or work, when the
import succeeds (these wrappers are complete, just environment-gated).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..core.registry import register_filter
from .base import Framework, FrameworkError


def _host(a) -> np.ndarray:
    """A contiguous host array of a numpy array or a torch tensor."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(a)


@register_filter("onnxruntime")
@register_filter("onnx")
class OnnxRuntimeFramework(Framework):
    """ONNX Runtime wrapper (reference: tensor_filter_onnxruntime.cc)."""

    name = "onnxruntime"

    def __init__(self):
        super().__init__()
        self._sess = None
        self._in_names: List[str] = []

    def open(self, props: Dict[str, object]) -> None:
        super().open(props)
        try:
            import onnxruntime as ort
        except ImportError as e:
            raise FrameworkError(
                "onnxruntime is not installed in this environment; convert "
                "the model to a zoo model (framework=jax) or install onnxruntime"
            ) from e
        model = str(props.get("model", ""))
        try:
            self._sess = ort.InferenceSession(model, providers=["CPUExecutionProvider"])
        except Exception as e:  # noqa: BLE001 - ort raises its own hierarchy
            raise FrameworkError(f"cannot load ONNX model {model!r}: {e}") from e
        self._in_names = [i.name for i in self._sess.get_inputs()]

    def invoke(self, inputs: Sequence[np.ndarray]) -> List[np.ndarray]:
        feed = {n: _host(a) for n, a in zip(self._in_names, inputs)}
        return list(self._sess.run(None, feed))

    def close(self) -> None:
        self._sess = None


@register_filter("tensorflow-lite")
@register_filter("tensorflow1-lite")
@register_filter("tensorflow2-lite")
class TFLiteFramework(Framework):
    """TFLite interpreter wrapper (reference: tensor_filter_tensorflow_lite.cc,
    the reference's default benchmark path)."""

    name = "tensorflow-lite"

    def __init__(self):
        super().__init__()
        self._interp = None

    def open(self, props: Dict[str, object]) -> None:
        super().open(props)
        interp_cls = None
        try:
            from tflite_runtime.interpreter import Interpreter as interp_cls  # noqa: N813
        except ImportError:
            try:
                from tensorflow.lite import Interpreter as interp_cls  # noqa: N813
            except ImportError:
                pass
        if interp_cls is None:
            raise FrameworkError(
                "no TFLite runtime in this environment; convert the model to a "
                "zoo model (framework=jax) or install tflite_runtime/tensorflow"
            )
        model = str(props.get("model", ""))
        try:
            self._interp = interp_cls(model_path=model)
            self._interp.allocate_tensors()
        except (OSError, ValueError, RuntimeError) as e:
            raise FrameworkError(f"cannot load TFLite model {model!r}: {e}") from e

    def invoke(self, inputs: Sequence[np.ndarray]) -> List[np.ndarray]:
        interp = self._interp
        for detail, a in zip(interp.get_input_details(), inputs):
            interp.set_tensor(detail["index"], _host(a))
        interp.invoke()
        return [interp.get_tensor(d["index"]) for d in interp.get_output_details()]

    def get_model_info(self):
        if self._interp is None:
            return None, None
        from ..core.types import TensorSpec, TensorsSpec

        def spec_of(details):
            return TensorsSpec(
                tuple(
                    TensorSpec.from_shape(tuple(d["shape"]), d["dtype"], d.get("name", ""))
                    for d in details
                )
            )

        return (
            spec_of(self._interp.get_input_details()),
            spec_of(self._interp.get_output_details()),
        )

    def close(self) -> None:
        self._interp = None
