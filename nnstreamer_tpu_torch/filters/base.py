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
* :meth:`Framework.param_bytes` reports the resident weights and
  :meth:`Framework.attach_xray` hands over xray's registry; inside
  :func:`abstract_build` a framework builds on the meta device.
* :meth:`Framework.swap_params` replaces the live weights by value
  (train-while-serve); :func:`place_swapped_params` is the walk every
  framework's swap shares.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

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

    def param_bytes(self) -> int:
        """Bytes of model parameters resident on the device while the
        pipeline runs (0 = none or unknown): the deep pass's estimate and
        xray's measured ledger both read it."""
        return 0

    # -- xray (utils/xray.py) ------------------------------------------------
    def attach_xray(self, registry, stage: str, rec=None) -> None:
        """Hand the framework the pipeline's program registry: ``stage`` is
        the name its captured steps are counted under, ``rec`` the flight
        recorder for the device track.  Frameworks with a census attach it
        here (the llm filter's serve loop installs its expectations).
        Never called with xray off."""
        self._xray = registry
        self._xray_stage = stage
        self._xray_rec = rec
        census = getattr(self, "census", None)
        if census is not None:
            census.attach_xray(registry, stage, rec)

    # -- train-while-serve: param hot-swap ----------------------------------
    def swap_params(self, tree) -> Optional[int]:
        """Replace the live weights with ``tree``'s values, in place (see
        :func:`place_swapped_params`): the same structure and per-leaf
        shapes, so every captured step goes on reading the same tensors.
        Raises :class:`FrameworkError` when this framework cannot swap or
        the tree does not match."""
        raise FrameworkError(
            f"{self.name} framework does not support param hot-swap")


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves, structure) of a parameter tree: dicts (in sorted key order,
    as ``jax.tree_util`` flattens them), lists and tuples; anything else is
    a leaf.  Two trees of one shape have equal structures."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [tree_flatten(tree[k]) for k in keys]
        return ([x for leaves, _ in parts for x in leaves],
                ("dict", tuple(keys), tuple(s for _, s in parts)))
    if isinstance(tree, (list, tuple)):
        parts = [tree_flatten(v) for v in tree]
        return ([x for leaves, _ in parts for x in leaves],
                (type(tree).__name__, tuple(s for _, s in parts)))
    return [tree], "*"


def tree_param_bytes(tree) -> int:
    """Total bytes of a parameter tree's tensor leaves (meta leaves count
    their shape times their itemsize): the one walk the frameworks'
    ``param_bytes`` and xray's ledger share."""
    leaves, _ = tree_flatten(tree)
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


def tree_map(fn: Callable, tree):
    """``tree`` with ``fn`` applied to every leaf; containers keep their
    type."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def place_swapped_params(current, tree, master_dtype: Optional[torch.dtype] = None):
    """Copy ``tree``'s values into the LIVE parameter tree ``current`` (the
    one walk every :meth:`Framework.swap_params` shares) and return it.

    The structure and every leaf's shape and dtype must match, or a
    :class:`FrameworkError` names the first leaf that differs (nothing is
    copied then).  ``master_dtype`` (float32) may also stand for a live
    floating leaf of another dtype: the copy rounds to it, as the serving
    bundle's own cast of its float32 tree did.  New leaves are torch
    tensors on any device or numpy arrays.

    The JAX package binds a fresh buffer per leaf.  Here every live tensor
    keeps its storage: a captured step reads its weights at fixed
    addresses (the int4 and paged kernels bake TMA maps into the graph),
    so a rebound tree would leave it serving the old weights without an
    error.  The copy never aliases ``tree``, so a trainer stepping its own
    tensors later cannot change what is served.  On the card the device is
    synchronised before the copy (every step queued on any stream has read
    the old weights) and after it (no step, on any stream, reads a
    half-written one)."""
    from ..trainer.checkpoint import host_tensor

    cur_leaves, cur_def = tree_flatten(current)
    new_leaves, new_def = tree_flatten(tree)
    if cur_def != new_def:
        raise FrameworkError(
            f"swap_params tree structure mismatch: got {new_def}, "
            f"serving {cur_def}")
    pairs = []
    for i, (c, n) in enumerate(zip(cur_leaves, new_leaves)):
        if not isinstance(c, torch.Tensor):
            raise FrameworkError(
                f"swap_params leaf {i}: the serving leaf is a "
                f"{type(c).__name__}, not a tensor that can be copied into")
        n = n if isinstance(n, torch.Tensor) else host_tensor(n)
        dtype_ok = n.dtype == c.dtype or (
            master_dtype is not None and n.dtype == master_dtype
            and c.is_floating_point())
        if tuple(n.shape) != tuple(c.shape) or not dtype_ok:
            raise FrameworkError(
                f"swap_params leaf {i} mismatch: got {list(n.shape)}"
                f"{str(n.dtype)[6:]}, serving {list(c.shape)}"
                f"{str(c.dtype)[6:]} — hot-swap is a value move, "
                "shapes/dtypes are frozen")
        pairs.append((c, n))
    cards = {c.device for c, _ in pairs if c.is_cuda}
    with torch.no_grad():
        for d in cards:
            torch.cuda.synchronize(d)
        for c, n in pairs:
            c.copy_(n)
        for d in cards:
            torch.cuda.synchronize(d)
    return current


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


_abstract = threading.local()


@contextlib.contextmanager
def abstract_build():
    """Frameworks opened on this thread inside the block build on the meta
    device (:func:`resolve_device` gives ``meta``): shapes and dtypes, no
    storage, so the deep analyzer prices a model without allocating it."""
    prev = getattr(_abstract, "on", False)
    _abstract.on = True
    try:
        yield
    finally:
        _abstract.on = prev


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
    if dev not in ("gpu", "cuda", "cpu"):
        raise FrameworkError(
            f"accelerator={acc!r}: unknown device {dev!r} (gpu, cuda, cpu)")
    if getattr(_abstract, "on", False):
        return torch.device("meta")
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
