"""tensor_trainer: training as a pipeline element.

Port of ``nnstreamer_tpu/elements/trainer.py`` (reference:
``gst/nnstreamer/elements/gsttensor_trainer.c``): receives (input, label)
tensor pairs from the stream, drives a trainer sub-plugin
(``trainer/subplugin.py``, ``framework=jax``) through push_data /
train_epoch / save, and emits per-epoch training stats downstream.

Element semantics kept: ``num-inputs``/``num-labels`` split each incoming
buffer's tensors; ``num-training-samples``+``num-validation-samples`` define
an epoch; each completed epoch runs a training pass and pushes ONE stats
buffer (float64 [4]: training_loss, training_acc, val_loss, val_acc);
``model-save-path`` is written at EOS (and on explicit ``ready-to-complete``);
at EOS a partial epoch trains on what arrived.

As in the JAX package: samples stream into the sub-plugin's card-resident
window, whose update step is one captured graph for the stage's life;
``checkpoint-every=N`` writes an fsync'd checkpoint and a step-versioned
sibling every N epochs, so a killed pipeline resumes bitwise through
``model-load-path``; ``swap-to=<stage>`` copies each epoch's parameters into
a live serving stage (``Pipeline.swap_params``) — train-while-serve;
``watchdog-timeout`` bounds an epoch.  Stats buffers ride the
flight-recorder and tenant rails: they inherit the triggering sample's
trace id and tenant, and each epoch records a ``learn.step`` span
(``learn.ckpt`` per checkpoint write).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from ..core.buffer import Buffer, Event
from ..core.caps import Caps
from ..core.log import metrics
from ..core.registry import get as registry_get, register_element, KIND_TRAINER
from ..core.types import TensorSpec, TensorsSpec
from ..utils import tracing
from .base import Element, ElementError, Out, SRC

STATS_SPEC = TensorsSpec((TensorSpec(dims=(4,), dtype="float64", name="stats"),))


@register_element("tensor_trainer")
class TensorTrainer(Element):
    """Training element.

    Props: ``framework`` (trainer sub-plugin, default ``jax``), ``model``
    (model-config passed to the sub-plugin), ``model-save-path``,
    ``model-load-path`` (resume), ``num-inputs`` (default 1), ``num-labels``
    (default 1), ``num-training-samples``, ``num-validation-samples``,
    ``epochs`` (stop after N epochs; further data is ignored),
    ``checkpoint-every`` (write a step-versioned fsync'd checkpoint to
    ``model-save-path`` every N completed epochs; 0 = only at EOS),
    ``swap-to`` (serving stage name: hot-swap refreshed params into it
    after every epoch — requires the pipeline-attached swap callback),
    plus sub-plugin props (``optimizer``, ``learning-rate``, ``loss``,
    ``batch-size``, ``mesh``, ``host-accumulate``...) forwarded verbatim.
    """

    kind = "tensor_trainer"
    #: inputs and labels may arrive muxed in one buffer or on separate sink
    #: pads (``in.sink_0`` data, ``in.sink_1`` labels) — collate when multi.
    sync_policy = "all"

    def __init__(self, props=None, name=None):
        super().__init__(props, name)
        self.num_inputs = int(self.props.get("num_inputs", 1))
        self.num_labels = int(self.props.get("num_labels", 1))
        self.n_train = int(self.props.get("num_training_samples", 0))
        self.n_valid = int(self.props.get("num_validation_samples", 0))
        self.epochs = int(self.props.get("epochs", 1))
        self.save_path = str(self.props.get("model_save_path", "") or "")
        self.fw_name = str(self.props.get("framework", "jax"))
        self.checkpoint_every = int(self.props.get("checkpoint_every", 0))
        self.swap_to = str(self.props.get("swap_to", "") or "")
        # Reference: tensor_trainer arms nnstreamer_watchdog around the
        # sub-plugin; a wedged train step must surface, not hang the stage.
        self.wd_timeout = float(self.props.get("watchdog_timeout", 0.0))
        self.trainer = None
        self._pushed = 0
        self._epochs_done = 0
        self._stats_pts = 0
        self._hung: Optional[str] = None
        #: the most recent input buffer's trace identity (trace id,
        #: ingress ns, tenant): stamped onto emitted stats buffers so
        #: learn.* activity joins the request timeline (nns-trace)
        self._last_tid = None
        self._last_ingress = None
        self._last_tenant = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        cls = registry_get(KIND_TRAINER, self.fw_name)
        self.trainer = cls()
        self.trainer.open(self.props)
        xr = getattr(self, "_xray", None)
        attach = getattr(self.trainer, "attach_xray", None)
        if xr is not None and attach is not None:
            # xray: the update step and the eval count under <name>.learn
            attach(xr, self.name, rec=lambda: getattr(self, "_trace_rec", None))

    def stop(self) -> None:
        if self.trainer is not None:
            self.trainer.close()

    # -- xray's ledger -------------------------------------------------------
    def param_bytes(self) -> int:
        fn = getattr(self.trainer, "param_nbytes", None)
        return int(fn()) if fn is not None else 0

    def train_state_bytes(self) -> int:
        fn = getattr(self.trainer, "train_state_bytes", None)
        return int(fn()) if fn is not None else 0

    def configure(self, in_caps, out_pads):
        self.in_caps = dict(in_caps)
        caps = Caps.tensors(STATS_SPEC)
        self.out_caps = {p: caps for p in out_pads}
        return self.out_caps

    # -- streaming ---------------------------------------------------------
    def _epoch_size(self) -> int:
        if self.n_train <= 0:
            raise ElementError(
                "tensor_trainer requires num-training-samples > 0"
            )
        return self.n_train + self.n_valid

    def process(self, pad: str, buf: Buffer) -> Out:
        if self._epochs_done >= self.epochs:
            return []  # training complete; drain remaining pushes
        want = self.num_inputs + self.num_labels
        if len(buf.tensors) != want:
            raise ElementError(
                f"tensor_trainer expects {want} tensors/buffer "
                f"(num-inputs={self.num_inputs} + num-labels={self.num_labels}), "
                f"got {len(buf.tensors)}"
            )
        # remember the triggering request's identity for the stats
        # buffer + learn.step span (written only when tracing stamped
        # the meta — the off path stays stamp-free)
        tid = buf.meta.get(tracing.META_TRACE_ID)
        if tid is not None:
            self._last_tid = tid
            self._last_ingress = buf.meta.get(tracing.META_INGRESS_NS)
        ten = buf.meta.get(tracing.META_TENANT)
        if ten is not None:
            self._last_tenant = ten
        inputs = buf.tensors[: self.num_inputs]
        labels = buf.tensors[self.num_inputs :]
        pos = self._pushed % self._epoch_size()
        is_validation = pos >= self.n_train
        self.trainer.push_data(inputs, labels, is_validation)
        self._pushed += 1

        out: Out = []
        if self._pushed % self._epoch_size() == 0:
            out.extend(self._run_epoch())
        return out

    def process_group(self, bufs: Dict[str, Buffer]) -> Out:
        tensors: List = []
        pads = sorted(bufs)
        for pad in pads:
            tensors.extend(bufs[pad].tensors)
        # pts/meta (trace id, tenant) from the SAME sorted-first pad the
        # tensor order starts with — dict insertion order could name a
        # different pad and misattribute learn.* spans
        first = bufs[pads[0]]
        merged = Buffer(tensors, pts=first.pts, meta=dict(first.meta))
        return self.process("sink", merged)

    def _run_epoch(self) -> Out:
        if self._hung:
            raise ElementError(self._hung)
        t0 = time.monotonic_ns()
        if self.wd_timeout > 0:
            from ..utils.watchdog import call_with_watchdog

            try:
                stats = call_with_watchdog(
                    self.trainer.train_epoch, self.wd_timeout,
                    what=f"{self.name} trainer epoch",
                )
            except TimeoutError as e:
                self._hung = str(e)
                raise ElementError(self._hung) from e
        else:
            stats = self.trainer.train_epoch()
        self._epochs_done += 1
        metrics.count(f"{self.name}.epochs")
        rec = getattr(self, "_trace_rec", None)
        if rec is not None and rec.active:
            # learn.step: one span per trained epoch on the trainer's
            # own track, joined to the LAST contributing request's trace
            # id (the batch-span linkage convention) + tenant
            args = {"epoch": self._epochs_done,
                    "step": getattr(self.trainer, "step", 0),
                    "loss": stats.get("training_loss")}
            if self._last_tenant is not None:
                args["tenant"] = self._last_tenant
            rec.record("learn.step", self.name, self._last_tid, t0,
                       time.monotonic_ns() - t0, **args)
        arr = np.array(
            [
                stats.get("training_loss", np.nan),
                stats.get("training_accuracy", np.nan),
                stats.get("validation_loss", np.nan),
                stats.get("validation_accuracy", np.nan),
            ],
            dtype=np.float64,
        )
        self._stats_pts += 1
        stats_buf = Buffer([arr], spec=STATS_SPEC, pts=self._stats_pts)
        # the stats buffer rides the flight-recorder/tenant rails: it
        # inherits the triggering sample's identity so downstream sinks'
        # e2e spans and per-tenant histograms see trainer emissions
        # (satellite: trainer stats were invisible to nns-trace)
        if self._last_tid is not None:
            stats_buf.meta[tracing.META_TRACE_ID] = self._last_tid
            if self._last_ingress is not None:
                stats_buf.meta[tracing.META_INGRESS_NS] = self._last_ingress
        if self._last_tenant is not None:
            stats_buf.meta[tracing.META_TENANT] = self._last_tenant
        out: Out = [(SRC, stats_buf)]
        if self.checkpoint_every > 0 and self.save_path \
                and self._epochs_done % self.checkpoint_every == 0 \
                and self._epochs_done < self.epochs:
            self._checkpoint(versioned=True)
        if self.swap_to:
            self._swap_into_serving()
        if self._epochs_done >= self.epochs:
            self._save()
        return out

    def _swap_into_serving(self) -> None:
        """Train-while-serve: push the refreshed param tree into the
        ``swap-to`` serving stage through the pipeline-attached swap
        callback (``Pipeline.swap_params``: a copy into the serving
        stage's live tensors at its dispatch boundary, no recapture)."""
        cb = getattr(self, "_swap_cb", None)
        if cb is None:
            raise ElementError(
                f"{self.name}: swap-to={self.swap_to!r} needs the "
                "pipeline swap callback (run inside a Pipeline)")
        export = getattr(self.trainer, "export_params", None)
        tree = export() if export is not None else self.trainer.params
        version = cb(self.swap_to, tree)
        metrics.gauge(f"{self.name}.swap_version", float(version))

    def _checkpoint(self, versioned: bool = False) -> None:
        """One fsync'd checkpoint write (+ a step-versioned sibling so a
        rollback target survives the next overwrite), span-stamped
        ``learn.ckpt``."""
        t0 = time.monotonic_ns()
        path = self.trainer.save(self.save_path)
        if versioned:
            step = int(getattr(self.trainer, "step", 0))
            self.trainer.save(f"{self.save_path}.step{step}")
        metrics.count(f"{self.name}.ckpt_writes")
        rec = getattr(self, "_trace_rec", None)
        if rec is not None and rec.active:
            rec.record("learn.ckpt", self.name, self._last_tid, t0,
                       time.monotonic_ns() - t0,
                       step=int(getattr(self.trainer, "step", 0)),
                       path=path)

    def _save(self) -> None:
        if self.save_path and self.trainer is not None:
            self._checkpoint()
            self._saved_at_epoch = self._epochs_done

    def finalize(self) -> Out:
        out: Out = []
        # Partial epoch at EOS: train on what arrived (reference flushes the
        # queue into the sub-plugin and stops).
        if self._epochs_done < self.epochs and self.trainer is not None:
            n_train, n_valid = self.trainer.queued()
            if n_train:
                out.extend(self._run_epoch())
        if getattr(self, "_saved_at_epoch", None) != self._epochs_done:
            self._save()
        return out

    def on_event(self, pad: str, event: Event) -> Out:
        if event.kind == "ready-to-complete":
            self._save()
            return []
        return super().on_event(pad, event)
