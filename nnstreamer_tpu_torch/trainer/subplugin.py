"""Trainer sub-plugin API and the port's trainer (``torch.optim``).

Port of ``nnstreamer_tpu/trainer/subplugin.py`` (reference: the trainer
sub-plugin vtable, ``nnstreamer_plugin_api_trainer.h``, and
``tensor_trainer_nntrainer.cc``).  The JAX package trains with jitted
optax steps; here :class:`Trainer` is registered under the same name,
``jax``, so that the JAX package's pipeline strings (``tensor_trainer
framework=jax model=mlp:4:16:3 ...``) run as written.

* **Card-resident state.**  The parameters (float32 master copies), their
  gradients, the optimizer's moments and the sample window live on the
  trainer's device for its lifetime (``accelerator=``: the card unless
  ``true:cpu``).
* **The window.**  Samples stream into a fixed ``[batch_size, ...]`` window
  allocated once on the device: each one is a single pinned host-to-card
  ``copy_`` into its row, not a program.  A full window dispatches one
  update step; the host never holds an epoch of samples.
  ``host-accumulate=true`` keeps the JAX package's stack-the-epoch path:
  each minibatch is copied into the same window and runs the same step.
* **A closed census.**  The update step (forward, backward, the optimizer
  step and the masked loss and accuracy) is one CUDA graph, captured
  through ``pipeline/graphs.py``'s :class:`~..pipeline.graphs.Census` on
  the first full window, whose warm-up run is that window's real step;
  the validation eval is one more.  ``count`` (the window's live rows)
  goes in by a fill of a card tensor, so a partial tail window replays
  the same step with a masked loss: :data:`TRAINER_PROGRAMS` captures for
  the trainer's life (:meth:`Trainer.compile_counts`).  The gradients
  keep their storage (zeroed in place inside the step, never set to
  None), Adam's state is created by the warm-up, before the capture, and
  nothing inside the step reads the card from the host.  A capture that
  fails raises: nothing reverts to eager steps on the card.  On the CPU
  the same step runs eagerly, as every census does there.

* **A mesh.**  ``mesh=data:N`` (or ``data:N,model:M``) trains over the
  process's own slots (``parallel/mesh.local_devices``), as the JAX
  package's trains over an ICI mesh: the window's rows split over every
  slot of the mesh in contiguous runs, each slot computes its rows'
  masked loss and its gradients (one step captured per slot on the
  slot's stream, its gradient buffers written in place), the gradients
  are summed in slot order (``parallel/sharding.fixed_order_sum``) and
  one optimizer step updates the parameters every slot reads (slots on
  one device share them; on distinct cards each card's copy is
  refreshed from the root's).  The vision forwards are whole-model
  functions, so a ``model`` axis keeps the weights whole and splits rows
  as ``data`` does (``trainer.param_shards`` 0), as the serving stages
  under one do.  A mesh of one slot is the mesh-less trainer.

:func:`train_plan` prices a trainer without allocating it (the deep
lint's ``train_state``), and :meth:`Trainer.attach_xray` counts its two
captures under xray.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.log import logger, metrics
from ..core.registry import register_trainer
from ..filters.base import (FrameworkError, place_swapped_params, resolve_device,
                            tree_flatten, tree_map)
from ..pipeline.graphs import Census

log = logger(__name__)

#: captured programs one trainer runs for its LIFETIME: the update step
#: and the validation eval (the JAX package's third, the window append,
#: is a copy here)
TRAINER_PROGRAMS = 2

#: the per-parameter optimizer state a checkpoint carries, by optimizer
_OPT_SLOTS = {"sgd": (), "momentum": ("momentum_buffer",),
              "adam": ("exp_avg", "exp_avg_sq")}


class TrainerError(RuntimeError):
    pass


class TrainerSubplugin:
    """Base class for tensor_trainer sub-plugins.

    Lifecycle (driven by the tensor_trainer element):
    ``open(props)`` → N× ``push_data(inputs, labels, is_validation)`` →
    ``train_epoch()`` per completed epoch → ``save(path)`` → ``close()``.
    """

    name: str = "base"

    def __init__(self):
        self.props: Dict[str, object] = {}

    def open(self, props: Dict[str, object]) -> None:
        # Keep the element's own (tracked) dict — see filters/base.py.
        self.props = props if isinstance(props, dict) else dict(props)

    def push_data(self, inputs: Sequence, labels: Sequence,
                  is_validation: bool) -> None:
        raise NotImplementedError

    def train_epoch(self) -> Dict[str, float]:
        """Consume the queued epoch of samples; returns stats:
        training_loss / training_accuracy / validation_loss /
        validation_accuracy (NaN where not applicable)."""
        raise NotImplementedError

    def save(self, path: str) -> str:
        raise NotImplementedError

    def load(self, path: str) -> None:
        raise NotImplementedError

    def queued(self) -> Tuple[int, int]:
        """(n_train, n_valid) samples awaiting train_epoch; the element uses
        this at EOS to decide whether a partial epoch remains."""
        return (0, 0)

    def close(self) -> None:
        pass


def _build_mlp(layer_sizes: List[int], seed: int, device):
    """Tiny trainable MLP used when no zoo model is named: the JAX
    package's draws (``np.random.default_rng(seed)``), so both packages
    start from the same values.  Returns (params, apply)."""
    rng = np.random.default_rng(seed)
    params = []
    for fan_in, fan_out in zip(layer_sizes[:-1], layer_sizes[1:]):
        w = (rng.standard_normal((fan_in, fan_out)) * np.sqrt(2.0 / fan_in)
             ).astype(np.float32)
        params.append({"w": torch.from_numpy(w).to(device),
                       "b": torch.zeros(fan_out, device=device)})

    def apply(params, x):
        h = x.reshape(x.shape[0], -1).float()
        for i, layer in enumerate(params):
            h = h @ layer["w"] + layer["b"]
            if i < len(params) - 1:
                h = torch.relu(h)
        return h

    return params, apply


def _zoo_model(model: str, props: Dict[str, object], device):
    """A zoo model's float32 parameter tree, its apply function (computing
    in the bundle's compute dtype, ``dtype=``, bfloat16 by default) and the
    rank of its input.  A serving bundle's params are already cast to the
    compute dtype (``models/backbone.py`` ``prepare``); the trainer keeps
    float32 masters, as the JAX package's does, so it takes them from the
    model built at ``dtype:float32`` (the same draws: ``prepare`` at
    float32 changes only the kernels' memory layout to channels_last) and
    the apply function from the model at the compute dtype, whose convs
    cast their weights inside."""
    from ..models import zoo

    opts = {k: str(v) for k, v in props.items()
            if k in ("classes", "width", "size", "seed", "dtype")}
    master = zoo.build(model, {**opts, "dtype": "float32"}, device=device)
    bundle = master if opts.get("dtype", "bfloat16") == "float32" else \
        zoo.build(model, opts, device=device)
    rank = len(bundle.in_spec[0].shape) if bundle.in_spec is not None else None
    return master.params, bundle.apply_fn, rank


def _make_optimizer(opt: str, lr: float, leaves, capturable: bool):
    """optax's optimizers of the same names, as ``torch.optim`` runs them
    with its defaults.  ``adam``: optax.adam's b1 0.9, b2 0.999 and eps
    1e-8 added after the square root of the bias-corrected second moment
    (eps_root 0), both moments bias-corrected by the step count — torch's
    Adam computes ``lr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) + eps)``,
    the same value.  ``momentum``: optax.sgd(lr, momentum=0.9)'s trace
    ``t = g + 0.9 t`` from zeros, so its first trace is the gradient, as
    torch's first momentum buffer is (dampening 0, no Nesterov).  ``sgd``:
    ``p - lr g`` in both.  ``capturable`` keeps Adam's step count on the
    card, which a captured step needs."""
    if opt == "sgd":
        return torch.optim.SGD(leaves, lr=lr)
    if opt == "momentum":
        return torch.optim.SGD(leaves, lr=lr, momentum=0.9)
    return torch.optim.Adam(leaves, lr=lr, capturable=capturable)


def mesh_sizes(spec: str, n_devices: int) -> Dict[str, int]:
    """``data:N`` / ``data:N,model:M`` as axis sizes (a size left out is
    every device), with the JAX package's message for a bad axis."""
    sizes = {"data": 1, "model": 1}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, n = part.partition(":")
        name = name.strip() or "data"
        if name not in sizes:
            raise TrainerError(
                f"bad mesh spec {spec!r}: axis {name!r} (valid: data, model)")
        sizes[name] = int(n) if n else n_devices
    return sizes


def train_plan(props: Dict[str, object]) -> Optional[Dict[str, object]]:
    """Static plan of one trainer stage, without allocating it: the deep
    lint's pricing of its training state (``analysis/tracecheck.py``) and
    the arithmetic :meth:`Trainer.train_state_bytes` measures.  The JAX
    package's ``train_plan`` with the same keys::

        {"param_bytes", "opt_bytes", "grad_bytes", "window_bytes",
         "programs", "batch_size", "pspecs", "params"}

    The model is built on the meta device (``zoo.build(device="meta")``);
    ``opt_bytes`` is the optimizer's per-parameter state as
    ``torch.optim`` keeps it (Adam: two float32 moments and a step count
    per leaf, on the card when capturable; momentum: one buffer; sgd:
    none); ``grad_bytes`` the gradient tree the captured step zeroes in
    place; ``window_bytes`` the card-resident window, ``batch_size`` rows
    of input plus an int32 class id (the input again for ``mse``).  None
    when the model cannot be resolved statically."""
    model = str(props.get("model", props.get("model_config", "mlp:4:16:3")))
    bs = int(props.get("batch_size", props.get("batch-size", 16)))
    opt = str(props.get("optimizer", "adam"))
    if model.startswith("mlp:"):
        try:
            sizes = [int(v) for v in model.split(":")[1:]]
        except ValueError:
            return None
        if len(sizes) < 2:
            return None
        shapes = []
        for fi, fo in zip(sizes[:-1], sizes[1:]):
            shapes += [(fi, fo), (fo,)]
        leaves = [torch.empty(sh, dtype=torch.float32, device="meta")
                  for sh in shapes]
        in_bytes = sizes[0] * 4
    else:
        from ..models import zoo

        try:
            opts = {k: str(v) for k, v in props.items()
                    if k in ("classes", "width", "size", "seed")}
            bundle = zoo.build(model, {**opts, "dtype": "float32"},
                               device="meta")
        except Exception:  # noqa: BLE001 - unpriceable, caller diagnoses
            return None
        leaves = [t for t in tree_flatten(bundle.params)[0]
                  if isinstance(t, torch.Tensor)]
        in_bytes = (int(bundle.in_spec.nbytes)
                    if bundle.in_spec is not None else 0)
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    slots = len(_OPT_SLOTS.get(opt if opt in ("sgd", "momentum") else "adam"))
    # Adam keeps exp_avg, exp_avg_sq and a float32 step count per leaf
    steps = 4 * len(leaves) if slots == 2 else 0
    label_bytes = in_bytes if str(props.get("loss", "softmax_ce")) == "mse" \
        else 4
    return {
        "param_bytes": param_bytes,
        "opt_bytes": slots * param_bytes + steps,
        "grad_bytes": param_bytes,
        "window_bytes": bs * (in_bytes + label_bytes),
        "programs": TRAINER_PROGRAMS,
        "batch_size": bs,
        "pspecs": None,
        "params": None,
    }


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, np_dtype)).dtype


@register_trainer("jax")
class Trainer(TrainerSubplugin):
    """The port's streaming trainer (see the module docstring).

    Props (via tensor_trainer's element props, forwarded verbatim):

    * ``model`` — ``mlp:IN:HIDDEN:...:OUT`` or a zoo name (``mobilenet_v1``)
      whose builder takes ``classes``/``width``/``size``/``seed`` and the
      compute ``dtype``;
    * ``optimizer`` — ``sgd`` | ``momentum`` | ``adam`` (default);
    * ``learning-rate`` — float, default 1e-3;
    * ``loss`` — ``softmax_ce`` (labels are int class ids or one-hot) |
      ``mse``;
    * ``batch-size`` — the window's rows (default 16);
    * ``seed`` — param init seed;
    * ``accelerator`` — ``true:cpu`` trains on the CPU; the card otherwise;
    * ``model-load-path`` — checkpoint to resume from (params, optimizer
      moments and step count: the continuation is bitwise the straight
      run's);
    * ``host-accumulate`` — ``true`` stacks the whole epoch on the host and
      copies each minibatch into the window;
    * ``mesh`` — ``data:N`` / ``data:N,model:M`` over the process's own
      slots (see the module docstring); more slots than the process owns
      raise :class:`TrainerError`.

    A sample whose leading dimension is the model's batch of one (``[1, H,
    W, C]`` for a zoo model whose input is ``[1, H, W, C]``, as a serving
    filter beside the trainer takes it) trains as one row.
    """

    name = "jax"

    def __init__(self):
        super().__init__()
        self._valid: List[Tuple[List, List]] = []
        self._host_train: List[Tuple[List, List]] = []
        self._lock = threading.Lock()
        self.params = None
        self.apply_fn: Optional[Callable] = None
        self.device: Optional[torch.device] = None
        self.step = 0
        self.census: Optional[Census] = None
        # the window and the step's other static tensors (on the device
        # once the first sample's shape is known)
        self._wx = self._wy = None
        self._row: Optional[Tuple[int, ...]] = None
        self._fill = 0  # samples in the window not yet stepped
        self._pending = 0  # samples pushed since the last train_epoch
        self._losses: List[torch.Tensor] = []
        self._accs: List[torch.Tensor] = []
        self._step = self._eval = None
        self._captures = {"step": 0, "eval": 0}
        self._mesh = None
        #: per-slot steps under a mesh of more than one slot (the update,
        #: ``_step``, sums their gradients)
        self._slot_steps = None
        self._slot_fns = None
        #: per slot, the gradient buffers its step writes (in leaf order)
        self._slot_grads = None

    # -- lifecycle ---------------------------------------------------------
    def open(self, props: Dict[str, object]) -> None:
        super().open(props)
        try:
            self.device = resolve_device(str(props.get("accelerator", "")))
        except FrameworkError as e:
            raise TrainerError(str(e)) from e
        mesh_prop = str(props.get("mesh", "") or "")
        self._mesh = self._setup_mesh(mesh_prop) if mesh_prop else None
        model = str(props.get("model", "mlp:4:16:3"))
        seed = int(props.get("seed", 0))
        if model.startswith("mlp:"):
            sizes = [int(s) for s in model.split(":")[1:]]
            tree, self.apply_fn = _build_mlp(sizes, seed, self.device)
            self._in_rank = None
        else:
            tree, self.apply_fn, self._in_rank = _zoo_model(model, props, self.device)
        self.params = tree_map(lambda t: t.requires_grad_(True), tree)
        self._leaves = tree_flatten(self.params)[0]
        for p in self._leaves:
            # allocated once: the captured step zeroes them in place
            p.grad = torch.zeros_like(p)

        lr = float(props.get("learning_rate", props.get("learning-rate", 1e-3)))
        opt = str(props.get("optimizer", "adam"))
        self._opt_name = opt if opt in ("sgd", "momentum") else "adam"
        self._opt = _make_optimizer(self._opt_name, lr, self._leaves,
                                    capturable=self.device.type == "cuda")

        self.loss_kind = str(props.get("loss", "softmax_ce"))
        self.batch_size = int(props.get("batch_size", props.get("batch-size", 16)))
        self.host_accumulate = str(
            props.get("host_accumulate", props.get("host-accumulate", "false"))
        ).lower() in ("true", "1", "yes")
        self.census = Census(self.device)
        dev = self.device
        self._count = torch.zeros((), dtype=torch.int32, device=dev)
        self._loss = torch.zeros((), dtype=torch.float32, device=dev)
        self._acc = torch.zeros((), dtype=torch.float32, device=dev)

        # A checkpoint's params, moments and step count win over the
        # fresh init.
        load = props.get("model_load_path") or props.get("model-load-path")
        if load:
            self.load(str(load))
        if self._mesh is not None:
            self._place_on_mesh()

    def close(self) -> None:
        self._step = self._eval = None
        self._slot_steps = None

    # -- the mesh ----------------------------------------------------------
    def _setup_mesh(self, spec: str):
        """The ``(data, model)`` mesh of ``mesh=`` over the process's own
        slots on the trainer's device kind (the JAX package's
        ``_setup_mesh`` over ``jax.devices()``)."""
        from ..parallel.distributed import global_device_count, is_initialized
        from ..parallel.mesh import local_devices, make_mesh

        slots = local_devices(self.device.type)
        sizes = mesh_sizes(spec, len(slots))
        need = sizes["data"] * sizes["model"]
        if len(slots) < need:
            if is_initialized() and global_device_count() >= need:
                raise TrainerError(
                    f"mesh {spec!r} needs {need} devices, have {len(slots)} in "
                    "this process: the trainer feeds its own slots, not "
                    "another rank's")
            raise TrainerError(
                f"mesh {spec!r} needs {need} devices, have {len(slots)}")
        if slots[0].device != self.device:
            raise TrainerError(f"the mesh's first slot is on {slots[0].device}, "
                               f"the trainer on {self.device}")
        kw = {"data": sizes["data"]}
        if sizes["model"] > 1:
            kw["model"] = sizes["model"]
        return make_mesh(devices=slots[:need], **kw)

    def _place_on_mesh(self) -> None:
        """The parameters on every device of the mesh: the master tree on
        the root's, a copy (requiring grad, refreshed after every update)
        on each other card; slots on one device share one.  The counters
        say what is placed: whole on every device, so under a ``model``
        axis no leaf is cut (``param_shards`` 0)."""
        from ..parallel.mesh import mesh_axis_size

        slots = self._mesh.flat
        self._replicas = {str(self.device): self.params}
        for s in slots:
            if str(s.device) not in self._replicas:
                self._replicas[str(s.device)] = tree_map(
                    lambda t, d=s.device: t.detach().to(d).requires_grad_(True),
                    self.params)
        if len(slots) > 1 and len(self._replicas) > 1:
            # one stream cannot capture a step over several cards
            self.census.eager = True
        n = len(self._leaves)
        if mesh_axis_size(self._mesh, "model") > 1:
            metrics.count("trainer.param_shards", 0)
            metrics.count("trainer.param_replicas", n)
        metrics.count("trainer.param_replications")

    # -- data --------------------------------------------------------------
    def push_data(self, inputs, labels, is_validation: bool) -> None:
        if len(inputs) != 1 or len(labels) != 1:
            # Silently training on inputs[0] would corrupt multi-input runs.
            raise TrainerError(
                f"{self.name} trains single-input/single-label models; got "
                f"{len(inputs)} inputs, {len(labels)} labels"
            )
        sample = (list(inputs), list(labels))
        if is_validation:
            with self._lock:
                self._valid.append(sample)
            return
        if self.host_accumulate:
            with self._lock:
                self._host_train.append(sample)
                self._pending += 1
            return
        with self._lock:
            self._append_sample(inputs[0], labels[0])
            self._pending += 1
            if self._fill >= self.batch_size:
                self._dispatch_step(self._fill)
                self._fill = 0

    def queued(self) -> Tuple[int, int]:
        """Samples not yet consumed by a ``train_epoch`` (streamed samples
        already stepped still count: their epoch stats await collection)."""
        with self._lock:
            return self._pending, len(self._valid)

    # -- the device window --------------------------------------------------
    def _ensure_window(self, x, y) -> None:
        if self._wx is not None:
            return
        row = tuple(x.shape)
        if self._in_rank == len(row) and row[0] == 1:
            row = row[1:]  # the model's batch of one: one row
        self._row = row
        bs = max(1, self.batch_size)
        dt = (lambda a: a.dtype if isinstance(a, torch.Tensor)
              else _torch_dtype(np.asarray(a).dtype))
        self._wx = torch.zeros((bs,) + row, dtype=dt(x), device=self.device)
        self._wy = torch.zeros((bs,) + tuple(y.shape), dtype=dt(y),
                               device=self.device)
        self._build_steps()

    def _host_rows(self, window, rows: Sequence, pad: bool) -> torch.Tensor:
        """``rows`` (host arrays or tensors) as one fresh host tensor of the
        window's row shape, pinned when the window is on the card; with
        ``pad`` it has the window's rows, those past ``rows`` zero (the
        mask hides them)."""
        shape = ((window.shape[0] if pad else len(rows)),) + tuple(window.shape[1:])
        out = torch.zeros(shape, dtype=window.dtype, pin_memory=window.is_cuda)
        for i, r in enumerate(rows):
            if isinstance(r, torch.Tensor):
                out[i].copy_(r.reshape(shape[1:]))
            else:
                out[i].numpy()[...] = np.asarray(r).reshape(shape[1:])
        return out

    def _append_sample(self, x, y) -> None:
        self._ensure_window(x, y)
        i = self._fill
        for window, v in ((self._wx, x), (self._wy, y)):
            if isinstance(v, torch.Tensor) and v.device == window.device:
                window[i].copy_(v.reshape(window.shape[1:]))
            else:
                window[i].copy_(self._host_rows(window, [v], pad=False)[0],
                                non_blocking=True)
        self._fill += 1

    def _load_window(self, samples) -> int:
        """A minibatch (host-accumulated or validation samples) copied into
        the window, zero-padded; returns its row count."""
        self._ensure_window(samples[0][0][0], samples[0][1][0])
        for window, k in ((self._wx, 0), (self._wy, 1)):
            window.copy_(self._host_rows(window, [s[k][0] for s in samples],
                                         pad=True), non_blocking=True)
        return len(samples)

    def _dispatch_step(self, count: int) -> None:
        """One update step over the window's first ``count`` rows (masked
        loss: a partial window replays the same captured step; ``count``
        is a value, never a shape)."""
        self._count.fill_(count)
        if self._slot_fns is not None:
            self._dispatch_slots()
        elif self._step is None:
            # the capture's warm-up run IS this window's step: no step is
            # applied twice, none is lost
            self._step = self.census.capture(self._signature("step"), self._step_fn)
            self._captures["step"] += 1
        else:
            self._step.replay()
        self._losses.append(self._loss.clone())
        self._accs.append(self._acc.clone())
        self.step += 1

    def _dispatch_slots(self) -> None:
        """One update step over the mesh: every slot's gradient step
        launched on its stream before any is waited for, then the update
        (the slot-order sum and the optimizer step) on the trainer's."""
        if self._slot_steps is None:
            self._slot_steps = [
                self.census.capture(self._signature("step") + (s.id,), fn,
                                    stream=s.stream)
                for s, fn in zip(self._mesh.flat, self._slot_fns)]
            self._step = self.census.capture(self._signature("update"),
                                             self._step_fn)
            self._captures["step"] += 1
            return
        for st in self._slot_steps:
            st.launch()
        for st in self._slot_steps:
            st.join()
        self._step.replay()

    def _evaluate(self, count: int) -> Tuple[float, float]:
        self._count.fill_(count)
        if self._eval is None:
            self._eval = self.census.capture(self._signature("eval"), self._eval_fn)
            self._captures["eval"] += 1
        else:
            self._eval.replay()
        return float(self._loss), float(self._acc)

    def _signature(self, kind: str):
        return (kind, tuple(self._wx.shape), str(self._wx.dtype),
                tuple(self._wy.shape), str(self._wy.dtype))

    # -- math --------------------------------------------------------------
    def _per_example_loss(self, params, x, y):
        """Per-row (loss, correct) — shared by the masked step and the
        validation eval so both paths compute the same math."""
        logits = self.apply_fn(params, x)
        if isinstance(logits, (tuple, list)):
            logits = logits[0]
        if self.loss_kind == "mse":
            per = torch.mean((logits - y.reshape(logits.shape)) ** 2,
                             dim=tuple(range(1, logits.ndim)))
            correct = torch.full_like(per, float("nan"))
        else:
            if y.ndim >= 2 and y.shape[-1] == logits.shape[-1]:
                labels = torch.argmax(y.reshape(y.shape[0], -1), dim=-1)
            else:
                labels = y.reshape(y.shape[0]).long()
            logp = torch.log_softmax(logits, dim=-1)
            per = -logp.gather(1, labels[:, None])[:, 0]
            correct = (torch.argmax(logits, dim=-1) == labels).to(torch.float32)
        return per, correct

    def _masked_stats(self, params, x, y, count):
        per, correct = self._per_example_loss(params, x, y)
        mask = (torch.arange(per.shape[0], device=per.device) < count).to(per.dtype)
        cf = count.to(per.dtype)
        return torch.sum(per * mask) / cf, torch.sum(correct * mask) / cf

    def _build_steps(self) -> None:
        """The step and eval functions over the trainer's static tensors:
        each reads the window, ``count`` and the parameters in place and
        writes ``_loss`` / ``_acc`` (and the step, the parameters, their
        gradients and the optimizer's state)."""
        leaves, opt, params = self._leaves, self._opt, self.params
        wx, wy, count, loss_out, acc_out = (self._wx, self._wy, self._count,
                                            self._loss, self._acc)
        stats = self._masked_stats

        def step() -> None:
            for p in leaves:
                p.grad.zero_()
            loss, acc = stats(params, wx, wy, count)
            loss.backward()
            opt.step()
            loss_out.copy_(loss.detach())
            acc_out.copy_(acc)

        def evaluate() -> None:
            # the step's masked math over the step's window: validation runs
            # in window-sized chunks, so the eval signature is fixed
            # whatever the validation set's size
            with torch.no_grad():
                loss, acc = stats(params, wx, wy, count)
                loss_out.copy_(loss)
                acc_out.copy_(acc)

        self._step_fn, self._eval_fn = step, evaluate
        self._slot_fns = None
        if self._mesh is not None and len(self._mesh.flat) > 1:
            self._build_slot_steps()

    def _build_slot_steps(self) -> None:
        """The mesh's steps: per slot, its contiguous run of the window's
        rows (its share of the masked loss's sum, over the global count),
        its gradients into buffers of its own and its loss and accuracy
        sums; then the update: each leaf's gradient the slot-order sum of
        the slots' (the masked mean's gradient), one optimizer step, the
        other cards' copies refreshed, the loss and accuracy the sums'.
        A slot's step reads only its run of the window (a view; a copy
        on another card), the rows past ``count`` masked out."""
        from ..parallel.sharding import fixed_order_sum
        from ..pipeline.batching import split_runs

        slots = self._mesh.flat
        wx, wy, count = self._wx, self._wy, self._count
        leaves, opt, dev = self._leaves, self._opt, self.device
        per_example = self._per_example_loss
        runs, start = [], 0
        for k in split_runs(wx.shape[0], len(slots)):
            runs.append((start, start + k))
            start += k
        grads, sums, fns = [], [], []
        for s, (a, b) in zip(slots, runs):
            tree = self._replicas[str(s.device)]
            mine = tree_flatten(tree)[0]
            g = [torch.zeros_like(p, requires_grad=False) for p in mine]
            out = torch.zeros(2, dtype=torch.float32, device=s.device)
            grads.append(g)
            sums.append(out)

            def fn(tree=tree, mine=mine, g=g, out=out, a=a, b=b, d=s.device):
                x, y = wx[a:b], wy[a:b]
                if x.device != d:
                    x, y = x.to(d), y.to(d)
                c = count if count.device == d else count.to(d)
                per, correct = per_example(tree, x, y)
                rows = torch.arange(a, b, device=d)
                mask = (rows < c).to(per.dtype)
                cf = c.to(per.dtype)
                loss = torch.sum(per * mask) / cf
                for dst, gi in zip(g, torch.autograd.grad(loss, mine)):
                    dst.copy_(gi)
                out[0].copy_(loss.detach())
                out[1].copy_(torch.sum(correct * mask) / cf)

            fns.append(fn)
        others = [tree_flatten(t)[0] for k, t in self._replicas.items()
                  if k != str(dev)]
        loss_out, acc_out = self._loss, self._acc

        def update() -> None:
            for j, p in enumerate(leaves):
                p.grad.copy_(fixed_order_sum([g[j] for g in grads], dev))
            opt.step()
            with torch.no_grad():
                for copy in others:
                    for q, p in zip(copy, leaves):
                        q.copy_(p)
            both = fixed_order_sum(sums, dev)
            loss_out.copy_(both[0])
            acc_out.copy_(both[1])

        self._slot_fns, self._step_fn, self._slot_grads = fns, update, grads

    def compile_counts(self) -> Dict[str, int]:
        """Captures per program — the census pin tests read (step and eval
        must each stay at 1 across epoch churn, partial windows and
        host-accumulate).  Under a mesh the step is one capture per slot
        and the update; they count as the one step program (the census
        holds them all: ``census.captures``)."""
        return {k: n for k, n in self._captures.items() if n}

    # -- epochs ------------------------------------------------------------
    def train_epoch(self) -> Dict[str, float]:
        with self._lock:
            if self.host_accumulate:
                train, self._host_train = self._host_train, []
                if not train:
                    raise TrainerError(
                        "train_epoch called with no queued samples")
                self._train_host(train)
            else:
                if self._pending == 0:
                    raise TrainerError(
                        "train_epoch called with no queued samples")
                if self._fill:
                    # partial tail window: masked step through the SAME
                    # capture — count is a value, the census stays closed
                    self._dispatch_step(self._fill)
                    self._fill = 0
            losses, self._losses = self._losses, []
            accs, self._accs = self._accs, []
            valid, self._valid = self._valid, []
            self._pending = 0

            stats = {
                "training_loss": float(np.mean(torch.stack(losses).tolist()))
                if losses else float("nan"),
                "training_accuracy": float(np.mean(torch.stack(accs).tolist()))
                if accs else float("nan"),
                "validation_loss": float("nan"),
                "validation_accuracy": float("nan"),
            }
            if valid:
                bs = max(1, self.batch_size)
                tot_l = tot_a = 0.0
                for off in range(0, len(valid), bs):
                    n = self._load_window(valid[off:off + bs])
                    vl, va = self._evaluate(n)
                    tot_l += vl * n
                    tot_a += va * n
                stats["validation_loss"] = tot_l / len(valid)
                stats["validation_accuracy"] = tot_a / len(valid)
        log.debug("epoch stats %s", stats)
        return stats

    def _train_host(self, train) -> None:
        """The host-accumulated epoch (``host-accumulate=true``): minibatches
        of the stacked epoch, each copied into the window and stepped by the
        streaming path's captured step."""
        bs = max(1, self.batch_size)
        for off in range(0, len(train), bs):
            self._dispatch_step(self._load_window(train[off:off + bs]))

    # -- accounting --------------------------------------------------------
    def attach_xray(self, registry, stage: str, rec=None) -> None:
        """xray: the update step and the eval, one capture each
        (:data:`TRAINER_PROGRAMS`), count under ``<stage>.learn``."""
        learn = f"{stage}.learn"
        for kind in ("step", "eval"):
            registry.expect(learn, kind, budget=1,
                            note="train_plan captured step")
        self.census.attach_xray(registry, learn, rec)

    def param_nbytes(self) -> int:
        return sum(p.nbytes for p in self._leaves) if self.params is not None else 0

    def train_state_bytes(self) -> int:
        """Device-resident training state: the optimizer's moments, the
        sample window and, under a mesh, each slot's gradient tree (the
        parameters' own gradients are counted with the parameters)."""
        total = sum(t.nbytes for st in self._opt.state.values()
                    for t in st.values() if isinstance(t, torch.Tensor))
        total += sum(g.nbytes for grads in self._slot_grads or () for g in grads)
        return total + sum(w.nbytes for w in (self._wx, self._wy) if w is not None)

    def export_params(self):
        """The LIVE parameter tree — what ``Pipeline.swap_params`` copies
        into a serving stage (the copy never aliases it)."""
        return self.params

    # -- persistence -------------------------------------------------------
    def opt_state(self) -> Dict[str, object]:
        """The optimizer's state as a checkpoint carries it: its name, the
        step count and, per slot, one tensor per parameter leaf."""
        state = {"optimizer": self._opt_name, "count": int(self.step)}
        for slot in _OPT_SLOTS[self._opt_name]:
            if all(slot in self._opt.state[p] for p in self._leaves):
                state[slot] = [self._opt.state[p][slot] for p in self._leaves]
        return state

    def save(self, path: str) -> str:
        from .checkpoint import save_checkpoint

        got = save_checkpoint(path, self.params, self.opt_state(), self.step,
                              fsync=True)
        metrics.count("trainer.ckpt_writes")
        return got

    def load(self, path: str) -> None:
        """Resume from a checkpoint: its values are copied into the live
        parameters (structure, shapes and dtypes checked), and its moments
        and step count, where it has them, become the optimizer's state,
        laid out as a fresh init would lay them out."""
        from .checkpoint import host_tensor, load_checkpoint

        params, opt_state, step = load_checkpoint(path)
        try:
            place_swapped_params(self.params, params)
        except FrameworkError as e:
            raise TrainerError(f"checkpoint {path}: {e}") from e
        self.step = int(step)
        if opt_state is None:
            return
        if opt_state.get("optimizer") != self._opt_name:
            raise TrainerError(
                f"checkpoint {path} holds {opt_state.get('optimizer')!r} "
                f"optimizer state; this trainer runs {self._opt_name!r}")
        with torch.no_grad():
            for slot in _OPT_SLOTS[self._opt_name]:
                for p, v in zip(self._leaves, opt_state.get(slot) or ()):
                    self._opt.state[p][slot] = torch.zeros_like(p).copy_(
                        host_tensor(v))
            if self._opt_name == "adam" and opt_state.get("exp_avg") is not None:
                on = self.device if self.device.type == "cuda" else "cpu"
                for p in self._leaves:
                    self._opt.state[p]["step"] = torch.tensor(
                        float(opt_state["count"]), dtype=torch.float32, device=on)
