"""The fusable device framework for tensor_filter: zoo models on the card.

The counterpart of ``nnstreamer_tpu/filters/jax_fw.py``.  It is
registered as ``jax`` (with the JAX package's aliases) so that the JAX
package's pipeline strings (``tensor_filter framework=jax
model=mobilenet_v1 ...``) run here as written; the names ``torch`` and
``pytorch`` belong to ``filters/torch_fw.py``, which runs a user's
``nn.Module`` or TorchScript file.

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
* :meth:`DeviceFramework.swap_params` copies a new float32 tree into the
  live params (train-while-serve).
* :meth:`DeviceFramework.param_bytes` counts the live tree; opened inside
  :func:`~.base.abstract_build` the bundle is built on the meta device,
  and ``abstract_invoke`` runs ``pure_fn`` there on meta inputs.
* ``mesh=data:N`` (the element property, or ``custom=mesh:data:N``)
  splits the batch dim of every input over N mesh slots
  (``parallel/mesh.py``) of the filter's device kind, the params
  replicated once; the errors are the JAX package's (a non-``data``
  axis, a bad spec, more slots than there are).  Each slot runs its rows
  and the outputs are joined on the root slot in slot order.  With the
  slots on one device the fused stage captures the split step as one
  graph; over distinct cards the filter stays out of fusion and runs
  each slot eagerly on its own device (not yet run on such a machine).
* :meth:`DeviceFramework.place_params` and :meth:`slot_fn` serve the
  pipeline mesh's sharded micro-batching (``pipeline/batching.py``):
  the params whole on every device (one copy per card), each slot's
  forward over its rows, a ``model`` axis splitting rows as ``data``
  does.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from ..core.buffer import upload
from ..core.registry import register_filter
from ..parallel.sharding import check_pspecs, replicate, slot_tree
from ..models.zoo import ModelBundle, build as build_model
from .base import (Framework, FrameworkError, parse_custom_options,
                   place_swapped_params, resolve_device)


@register_filter("jax", aliases=("tpu-xla", "xla", "pjrt"))
class DeviceFramework(Framework):
    name = "jax"

    def __init__(self):
        super().__init__()
        self.bundle: Optional[ModelBundle] = None
        self.device: Optional[torch.device] = None
        #: ``mesh=data:N``: the filter's own data mesh, and its replicated
        #: params (one tree per device)
        self.mesh = None
        self._mesh_params = None
        #: the pipeline mesh's placement of the params (``place_params``)
        self._placed = None

    def open(self, props):
        super().open(props)
        model = props.get("model")
        if model in (None, ""):
            raise FrameworkError("jax framework needs model=<zoo name>")
        opts = parse_custom_options(str(props.get("custom", "")))
        mesh_spec = str(props.get("mesh") or opts.pop("mesh", "") or "")
        self.device = resolve_device(str(props.get("accelerator", "")))
        try:
            self.bundle = build_model(model, opts, device=self.device)
        except KeyError as e:
            raise FrameworkError(str(e)) from e
        if mesh_spec:
            self._setup_mesh(mesh_spec)

    def _setup_mesh(self, spec: str) -> None:
        """``data:N``: the batch dim split over N slots, params replicated
        once."""
        from ..parallel.mesh import local_devices, make_mesh

        parts = spec.split(":")
        axis = parts[0] or "data"
        if axis != "data":
            raise FrameworkError(
                f"jax framework shards the batch dim only (mesh=data:N); "
                f"got axis {axis!r} — model/tensor parallel belongs to the "
                "llm framework (custom=tp:N)"
            )
        if self.device.type == "meta":
            return  # abstract build: no slots to place on
        slots = local_devices(self.device.type)
        try:
            n = int(parts[1]) if len(parts) > 1 else len(slots)
        except ValueError:
            raise FrameworkError(
                f"bad mesh spec {spec!r}: expected data:N") from None
        if len(slots) < n:
            raise FrameworkError(
                f"mesh=data:{n} needs {n} devices, have {len(slots)}")
        if n <= 1:
            return
        self.mesh = make_mesh(data=n, devices=slots[:n])
        rep = replicate(self.mesh, self.bundle.params)
        self._mesh_params = [slot_tree(rep, s) for s in self.mesh.flat]

    def close(self):
        self.bundle = None
        self.mesh = self._mesh_params = self._placed = None

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

    def swap_params(self, tree) -> None:
        """Hot-swap the live weights (train-while-serve).  ``tree`` is the
        model's float32 tree, as ``init_params`` gives it and a trainer
        exports it; each leaf is copied into the live prepared one, which
        rounds it to the compute dtype in the live layout (channels_last
        kernels), as ``open``'s cast did (``models/backbone.py``
        ``prepare``).  The structure and the shapes must match (a
        ``FrameworkError`` names the first leaf that differs).  The live
        tensors keep their storage, so a stage that captured them reads the
        new values.  Callers serialise against in-flight invokes (the
        element holds ``_fw_lock``)."""
        if self.bundle is None:
            raise FrameworkError("framework is not open")
        place_swapped_params(self.bundle.params, tree, master_dtype=torch.float32)

    def param_bytes(self) -> int:
        if self.bundle is None:
            return 0
        from .base import tree_param_bytes

        return tree_param_bytes(self.bundle.params)

    def invoke(self, inputs) -> List:
        arrays = tuple(x if isinstance(x, torch.Tensor) and x.device == self.device
                       else upload(x, self.device) for x in inputs)
        if self.mesh is not None:
            return list(self._split_fn()(arrays))
        return list(self.pure_fn()(arrays))

    def _fn_over(self, params, device=None) -> Callable:
        """The bundle's forward over ``params``; on ``device`` (a mesh
        slot's card other than the bundle's) with the tensors its
        ``functools.partial`` binds (ssd's anchors, yolo's decode tables)
        copied there once."""
        apply_fn = self.bundle.apply_fn
        if device is not None and torch.device(device) != self.device:
            apply_fn = _bound_on(apply_fn, torch.device(device))

        def fn(arrays):
            out = apply_fn(params, *arrays)
            return tuple(out) if isinstance(out, (tuple, list)) else (out,)

        return fn

    def _split_fn(self) -> Callable:
        """``mesh=data:N``: each input's dim 0 in contiguous runs over the
        slots (the first ones a row longer where N does not divide it),
        each slot's rows through the model with its replica of the
        params, the outputs joined on the root slot in slot order."""
        from ..pipeline.batching import split_runs

        slots = self.mesh.flat
        fns = [self._fn_over(p, s.device) for p, s in zip(self._mesh_params, slots)]
        root = self.device
        distinct = not self.mesh.one_device()

        def fn(arrays):
            runs = split_runs(int(arrays[0].shape[0]), len(slots))
            outs, start = [], 0
            for slot, f, k in zip(slots, fns, runs):
                if k:
                    part = tuple(a[start:start + k] for a in arrays)
                    if distinct:
                        with torch.cuda.device(slot.device):
                            got = f(tuple(a.to(slot.device) for a in part))
                        got = tuple(o.to(root) for o in got)
                    else:
                        got = f(part)
                    outs.append(got)
                start += k
            return tuple(torch.cat([o[t] for o in outs], dim=0)
                         for t in range(len(outs[0])))

        return fn

    def pure_fn(self) -> Optional[Callable]:
        if self.bundle is None:
            return None
        if self.mesh is not None:
            # one device: the split step captures as one graph; distinct
            # cards: no fused stage (each slot runs on its own device)
            return self._split_fn() if self.mesh.one_device() else None
        return self._fn_over(self.bundle.params)

    # -- the pipeline mesh -----------------------------------------------
    def place_params(self, mesh):
        """Place the params over ``mesh`` once, whole on every device:
        each slot runs the bundle's whole forward over its rows, so a
        ``model`` axis splits the rows, not the weights (a forward that
        computes on a cut is the llm filter's, ``models/llama.place_tp``).
        Under a ``model`` axis over 1 the bundle's ``param_pspecs`` are
        checked as the JAX package's placement checks them (an axis the
        mesh lacks or a dim that does not divide raises ``ValueError``).
        Returns ``(leaves cut over model, leaves replicated)``: ``(0,
        leaves)`` under a model axis, else ``(0, 0)``; None when there is
        nothing to place."""
        from ..parallel.mesh import mesh_axis_size

        if self.bundle is None or self.bundle.params is None:
            return None
        params = self.bundle.params
        split = (0, 0)
        if mesh_axis_size(mesh, "model") > 1:
            split = (0, check_pspecs(mesh, params, self.bundle.param_pspecs))
        self._placed = replicate(mesh, params)
        return split

    def slot_fn(self, slot):
        """The forward of one slot over its copy of the placed params."""
        return self._fn_over(slot_tree(self._placed if self._placed is not None
                                       else self.bundle.params, slot), slot.device)


def _bound_on(fn, device: torch.device):
    """``fn`` with the tensors a ``functools.partial`` binds (alone or in
    tuples, lists and dicts) copied to ``device``; any other callable as
    it is."""
    import functools

    if not isinstance(fn, functools.partial):
        return fn

    def move(v):
        if isinstance(v, torch.Tensor):
            return v.to(device)
        if isinstance(v, (tuple, list)):
            return type(v)(move(x) for x in v)
        if isinstance(v, dict):
            return {k: move(x) for k, x in v.items()}
        return v

    return functools.partial(fn.func, *move(fn.args), **move(fn.keywords))
