"""image_labeling decoder: scores -> text label.

Port of ``nnstreamer_tpu/decoders/image_labeling.py`` (reference:
``tensordec-imagelabel.c``, BASELINE config #1): argmax over the
class-scores tensor, mapped through a labels file, emitted as
``text/x-raw`` (uint8 bytes) with index/label/score in buffer meta.

Both paths: :meth:`ImageLabeling.decode` on the host, and
:meth:`ImageLabeling.device_fn` (argmax and score on the device, inside a
fused stage) with :meth:`ImageLabeling.host_post` (the label text, at the
pipeline edge), so only ``[B]`` ids and scores cross to the host.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core.buffer import Buffer, _to_numpy
from ..core.caps import Caps, MediaType
from ..core.registry import register_decoder
from ..core.types import TensorSpec, TensorsSpec
from .base import Decoder, load_labels


@register_decoder("image_labeling")
class ImageLabeling(Decoder):
    mode = "image_labeling"

    def __init__(self, props):
        super().__init__(props)
        # read both prop spellings unconditionally (property-check safe)
        opt1 = self.option(1)
        labels_prop = str(props.get("labels", ""))
        labels = opt1 or labels_prop or "imagenet-mini"
        self.labels = load_labels(labels)

    def out_caps(self, in_spec: Optional[TensorsSpec]) -> Caps:
        return Caps.new(MediaType.TEXT)

    def _name(self, i: int) -> str:
        return self.labels[i] if i < len(self.labels) else str(i)

    def decode(self, tensors: List, buf: Buffer) -> Buffer:
        scores = _to_numpy(tensors[0])
        if scores.ndim >= 2 and scores.shape[0] > 1:
            # batched scores [B, C]: one label per row
            flat = scores.reshape(scores.shape[0], -1)
            idxs = np.argmax(flat, axis=1)
            names = [self._name(i) for i in idxs]
            new = buf.with_tensors(
                [np.frombuffer("\n".join(names).encode("utf-8"), np.uint8)],
                spec=None)
            new.meta.update(
                label=names,
                label_index=idxs,
                score=flat[np.arange(len(idxs)), idxs].astype(np.float32),
            )
            return new
        scores = scores.reshape(-1)
        idx = int(np.argmax(scores))
        label = self._name(idx)
        new = buf.with_tensors(
            [np.frombuffer(label.encode("utf-8"), np.uint8)], spec=None)
        new.meta.update(label=label, label_index=idx, score=float(scores[idx]))
        return new

    def device_fn(self, in_spec: TensorsSpec):
        shape = in_spec[0].shape
        batch = shape[0] if len(shape) >= 2 else 1

        def fn(arrays):
            scores = arrays[0]
            # batch from the runtime shape: a truncated tail batch has its
            # own leading dim
            b = scores.shape[0] if scores.ndim >= 2 else 1
            flat = scores.reshape(b, -1)
            idx = torch.argmax(flat, dim=1)  # the first of equal maxima
            score = torch.gather(flat, 1, idx[:, None])[:, 0]
            return (idx.to(torch.int32), score.float())

        out_spec = TensorsSpec((
            TensorSpec.from_shape((batch,), np.int32),
            TensorSpec.from_shape((batch,), np.float32),
        ))
        return fn, out_spec

    def host_post(self, arrays, buf: Buffer) -> Buffer:
        idxs = np.asarray(arrays[0]).reshape(-1)
        scores = np.asarray(arrays[1]).reshape(-1)
        names = [self._name(i) for i in idxs]
        if len(idxs) > 1:
            new = buf.with_tensors(
                [np.frombuffer("\n".join(names).encode("utf-8"), np.uint8)],
                spec=None)
            new.meta.update(
                label=names, label_index=idxs, score=scores.astype(np.float32))
            return new
        new = buf.with_tensors(
            [np.frombuffer(names[0].encode("utf-8"), np.uint8)], spec=None)
        new.meta.update(
            label=names[0], label_index=int(idxs[0]), score=float(scores[0]))
        return new
