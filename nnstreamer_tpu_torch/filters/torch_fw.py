"""PyTorch framework sub-plugin: a user's ``nn.Module`` or TorchScript file
as a filter, on the filter's device.

Port of ``nnstreamer_tpu/filters/torch_fw.py`` (reference:
``ext/nnstreamer/tensor_filter/tensor_filter_pytorch.cc``, which wraps
libtorch TorchScript models).  The JAX package runs the model on the host
CPU; here it runs on the device the filter's ``accelerator=`` names, the
CUDA card by default (``true:cpu`` for the CPU): a module is moved there,
a TorchScript file is loaded there (``torch.jit.load(map_location=...)``),
inputs are uploaded and outputs stay there.  The filter runs unfused: the
user's module is called once per buffer, eagerly.

Props:

* ``model`` — path to a TorchScript ``.pt``/``.pth``/``.ts`` file, a
  registered object name (see :func:`register_torch_module`), or an
  ``nn.Module`` / callable passed programmatically;
* ``input``/``inputtype`` on the element supply specs (TorchScript does not
  expose shapes).

:func:`state_dict_to_tree` converts a torch ``state_dict`` to the JAX
package's weight layouts, as it does there.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.buffer import upload
from ..core.registry import register_filter
from .base import Framework, FrameworkError, resolve_device

_registered: Dict[str, object] = {}


def register_torch_module(name: str, module) -> None:
    """Expose an ``nn.Module``/callable to pipelines as ``model=<name>``."""
    _registered[name] = module


@register_filter("torch")
@register_filter("pytorch")
class TorchFramework(Framework):
    name = "torch"

    def __init__(self):
        super().__init__()
        self._mod = None
        self.device: Optional[torch.device] = None

    def open(self, props: Dict[str, object]) -> None:
        super().open(props)
        model = props.get("model")
        self.device = resolve_device(str(props.get("accelerator", "")))
        if callable(model) or hasattr(model, "forward"):
            mod = model
        elif isinstance(model, str) and model in _registered:
            mod = _registered[model]
        elif isinstance(model, str) and model.endswith((".pt", ".pth", ".ts")):
            try:
                mod = torch.jit.load(model, map_location=self.device)
            except (OSError, RuntimeError, ValueError) as e:
                raise FrameworkError(f"cannot load TorchScript {model!r}: {e}") from e
        else:
            raise FrameworkError(
                f"torch framework: model {model!r} is neither a TorchScript "
                f"path, a registered module {sorted(_registered)}, nor a Module"
            )
        if isinstance(mod, torch.nn.Module):
            mod = mod.to(self.device)
        if hasattr(mod, "eval"):
            mod.eval()
        self._mod = mod

    def invoke(self, inputs: Sequence) -> List[torch.Tensor]:
        tins = [x if isinstance(x, torch.Tensor) and x.device == self.device
                else upload(x, self.device) for x in inputs]
        with torch.no_grad():
            out = self._mod(*tins)
        return [o.detach() for o in out] if isinstance(out, (list, tuple)) \
            else [out.detach()]

    def pure_fn(self) -> Optional[Callable]:
        return None  # the user's module runs eagerly, per buffer

    def get_model_info(self):
        return None, None  # TorchScript carries no shape metadata

    def close(self) -> None:
        self._mod = None


# -- torch state_dict -> the JAX package's layouts ---------------------------

_EMBED_SEGMENTS = frozenset(
    {"embed", "embedding", "embeddings", "embed_tokens", "tok_embeddings",
     "wte", "wpe"}
)


def state_dict_to_tree(
    state_dict,
    *,
    transpose_linear: bool = True,
    embed_keys: Sequence[str] = (),
) -> Dict[str, np.ndarray]:
    """Convert a torch ``state_dict`` into a flat {name: numpy} tree with
    JAX-conventional layouts: 4-D (conv) weights OIHW -> HWIO, 2-D linear
    weights [out, in] -> [in, out].  Embedding tables ([vocab, dim]) keep
    their layout — transposing them would break token-indexed lookup.
    Embeddings are recognized by EXACT dotted-path segments (``embed``,
    ``embed_tokens``, ``wte``, ...; extend via ``embed_keys``) so linear
    layers that merely contain the substring (GPT-NeoX's ``embed_out`` LM
    head) are still transposed.  The caller maps the flat names onto its
    model's pytree structure.
    """
    embed_names = _EMBED_SEGMENTS | {str(k).lower() for k in embed_keys}
    out: Dict[str, np.ndarray] = {}
    for key, tensor in state_dict.items():
        a = tensor.detach().cpu().numpy() if hasattr(tensor, "detach") else np.asarray(tensor)
        segments = {s for s in key.lower().split(".")}
        if a.ndim == 4:
            a = np.transpose(a, (2, 3, 1, 0))  # OIHW -> HWIO
        elif (
            a.ndim == 2
            and transpose_linear
            and key.endswith(("weight", "w"))
            and not (segments & embed_names)
        ):
            a = a.T
        out[key] = a
    return out
