"""bounding_boxes decoder: detections -> overlay video + meta.

Port of ``nnstreamer_tpu/decoders/bounding_boxes.py`` (reference:
``tensordec-boundingbox.c`` + mobilenetssd.cc, BASELINE config #2):
model output -> threshold -> NMS -> ``video/x-raw`` RGBA overlay with box
rectangles; labels via option properties.

Input contracts (``option1``):

* ``ssd`` (default): two tensors, boxes (N,4) corner-format normalized
  [0,1] and scores (N,C) per class, as ``models/ssd.py`` emits them;
* ``yolov5`` (or ``yolo``): one tensor (N, 5+C): cx, cy, w, h
  (normalized), objectness, class scores (``models/yolo.py``);
* ``yolov8``: one channels-first tensor (4+C, N), anchor-free, the class
  scores are the confidence; ``option8=W[:H]`` (the model's input size)
  when the boxes are in pixels.

Options (reference numbering): option1=format, option2=labels,
option3=score threshold (default 0.5), option4=WIDTH:HEIGHT of the
output overlay (default 640:480), option5=iou threshold (default 0.5),
option6=max detections, option7=NMS placement (host|device),
option8=model input size for pixel-coordinate boxes,
option9=output form (overlay|tensors).

Fused (``device_fn``): per-anchor class argmax and top-k run on the
device, ties broken by the lower anchor index as ``lax.top_k`` does (a
stable descending sort, then a slice).  With ``option7=host`` only the
``[B, K]`` candidates cross to the host, and threshold, NMS and overlay
resolve in ``host_post``; with ``option7=device`` threshold and NMS run
on the device too (:func:`~..ops.nms.nms_torch`), and only the final
detections cross: a packed ``[B, M, 7]`` tensor (x1 y1 x2 y2 score class
valid) with ``option9=tensors``.  Unfused, batched inputs decode per
frame and emit one buffer per frame, after the same top-k on the device
where the tensors lie (ssd formats; the yolo formats fetch the frame's
predictions as they are, as in the JAX package).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core.buffer import Buffer, _to_numpy
from ..core.caps import Caps, MediaType
from ..core.registry import register_decoder
from ..core.types import TensorSpec, TensorsSpec
from ..ops.nms import center_to_corner, nms_numpy, nms_torch
from .base import Decoder, load_labels

_SSD_FORMATS = ("ssd", "mobilenet-ssd", "mobilenetv2-ssd")
_YOLO_FORMATS = ("yolov5", "yolov8", "yolo")


def _topk(boxes: torch.Tensor, sc: torch.Tensor, cls: torch.Tensor, k: int):
    """The ``k`` best-scoring rows of boxes [B,N,4], scores [B,N] and
    classes [B,N] -> ([B,K,4] f32, [B,K] f32, [B,K] i32).  Equal scores keep
    the lower index first, as ``lax.top_k``: ``torch.topk`` promises no
    order for ties on the card, a stable sort does."""
    top_sc, idx = torch.sort(sc, dim=1, descending=True, stable=True)
    top_sc, idx = top_sc[:, :k], idx[:, :k]
    top_b = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    return top_b.float(), top_sc.float(), torch.gather(cls, 1, idx)


def _ssd_topk(boxes: torch.Tensor, scores: torch.Tensor, k: int):
    """SSD prefilter shared by the fused ``device_fn`` and the unfused
    path: per-anchor class argmax + top-k.  boxes [B,N,4], scores [B,N,C]
    -> ([B,K,4] f32, [B,K] f32, [B,K] i32)."""
    b, n = scores.shape[0], scores.shape[1]
    s = scores.reshape(b, n, -1)
    return _topk(boxes.reshape(b, -1, 4), torch.amax(s, dim=-1),
                 torch.argmax(s, dim=-1).to(torch.int32), k)


def _yolo_topk(pred: torch.Tensor, k: int, v8: bool, box_scale):
    """The yolo prefilter: per-prediction class argmax (objectness times
    class score for v5) + top-k, the kept boxes in corner form.  pred
    [B,N,5+C] (v8: [B,4+C,N]) -> ([B,K,4] f32, [B,K] f32, [B,K] i32)."""
    pred = pred.float()
    if v8:
        pred = pred.transpose(1, 2)  # -> (B, N, 4+C)
        xywh = pred[..., :4] / box_scale
        sc_all = pred[..., 4:]
    else:
        xywh, obj, cls = pred[..., :4], pred[..., 4], pred[..., 5:]
        sc_all = obj[..., None] * cls if cls.shape[-1] else obj[..., None]
    cx, cy = xywh[..., 0], xywh[..., 1]
    w2, h2 = xywh[..., 2] / 2, xywh[..., 3] / 2
    boxes = torch.stack([cx - w2, cy - h2, cx + w2, cy + h2], dim=-1)
    return _topk(boxes, torch.amax(sc_all, dim=-1),
                 torch.argmax(sc_all, dim=-1).to(torch.int32), k)


_PALETTE = np.array(
    [
        [230, 25, 75, 255], [60, 180, 75, 255], [255, 225, 25, 255],
        [0, 130, 200, 255], [245, 130, 48, 255], [145, 30, 180, 255],
        [70, 240, 240, 255], [240, 50, 230, 255], [210, 245, 60, 255],
        [250, 190, 190, 255],
    ],
    np.uint8,
)


@register_decoder("bounding_boxes")
class BoundingBoxes(Decoder):
    mode = "bounding_boxes"

    def __init__(self, props):
        super().__init__(props)
        self.format = (self.option(1) or "ssd").lower()
        if self.format not in _SSD_FORMATS + _YOLO_FORMATS:
            raise ValueError(f"unknown bounding-box format {self.format!r}")
        labels = self.option(2) or "coco-mini"
        self.labels = load_labels(labels)
        self.threshold = float(self.option(3) or 0.5)
        size = self.option(4) or "640:480"
        w, h = size.split(":")
        self.out_w, self.out_h = int(w), int(h)
        self.iou_threshold = float(self.option(5) or 0.5)
        self.max_detections = int(self.option(6) or 100)
        nms_opt = (self.option(7) or "host").lower()
        if nms_opt.startswith("nms:"):
            nms_opt = nms_opt[4:]
        if nms_opt not in ("host", "device"):
            raise ValueError(f"option7 (nms placement) must be host|device, "
                             f"got {nms_opt!r}")
        self.nms_mode = nms_opt
        # option8 (yolov8): the model's input WIDTH[:HEIGHT] when the
        # tensor carries pixel-coordinate boxes; unset = normalized
        o8 = self.option(8)
        if o8:
            wh = [int(v) for v in str(o8).split(":")]
            mw, mh = (wh[0], wh[0]) if len(wh) == 1 else (wh[0], wh[1])
            self.box_scale = np.asarray([mw, mh, mw, mh], np.float32)
        else:
            self.box_scale = np.float32(1.0)
        out_mode = (self.option(9) or "overlay").lower()
        if out_mode not in ("overlay", "tensors"):
            raise ValueError(f"option9 (output form) must be "
                             f"overlay|tensors, got {out_mode!r}")
        self.out_mode = out_mode

    def out_caps(self, in_spec: Optional[TensorsSpec]) -> Caps:
        if self.out_mode == "tensors":
            return Caps.tensors()
        return Caps.new(
            MediaType.VIDEO, format="RGBA", width=self.out_w, height=self.out_h
        )

    def _label(self, ci: int) -> str:
        return self.labels[ci] if ci < len(self.labels) else str(ci)

    # -- decode ------------------------------------------------------------
    def decode(self, tensors: List, buf: Buffer):
        # Batched buffers ([B, N, ...] per tensor) decode per frame and go
        # out as B buffers: NMS never mixes boxes of different frames.
        if tensors[0].ndim >= 3:
            outs = []
            for b, frame in enumerate(self._split_frames(tensors)):
                dets = self._decode_dets(frame)
                if self.out_mode == "tensors":
                    o = buf.with_tensors(self._det_tensors(dets), spec=None)
                else:
                    o = buf.with_tensors([self._draw(dets)], spec=None)
                o.meta["detections"] = dets
                o.meta["batch_index"] = b
                outs.append(o)
            return outs
        detections = self._decode_dets(
            ("raw", [_to_numpy(t) for t in tensors]))
        if self.out_mode == "tensors":
            out = buf.with_tensors(self._det_tensors(detections), spec=None)
        else:
            out = buf.with_tensors([self._draw(detections)], spec=None)
        out.meta["detections"] = detections
        return out

    @staticmethod
    def _det_tensors(dets) -> List[np.ndarray]:
        """detections list -> (boxes f32 [M,4], scores f32 [M],
        classes i32 [M]) — the option9=tensors output contract."""
        m = len(dets)
        boxes = np.zeros((m, 4), np.float32)
        scores = np.zeros((m,), np.float32)
        classes = np.zeros((m,), np.int32)
        for i, d in enumerate(dets):
            boxes[i] = d["box"]
            scores[i] = d["score"]
            classes[i] = d["class_index"]
        return [boxes, scores, classes]

    def _split_frames(self, tensors):
        """Per-frame inputs of a batched buffer: the top-k prefilter first
        (on the device the tensors lie on), so only K = 4 * max_detections
        candidates per frame cross to the host."""
        n = tensors[0].shape[1]
        k = 4 * self.max_detections
        if self.format in _SSD_FORMATS and n > k:
            tb, ts, tc = (_to_numpy(t) for t in _ssd_topk(
                torch.as_tensor(tensors[0]), torch.as_tensor(tensors[1]), k))
            return [("triple", (tb[b], ts[b], tc[b]))
                    for b in range(tb.shape[0])]
        host = [_to_numpy(t) for t in tensors]
        return [("raw", [t[b] for t in host]) for b in range(host[0].shape[0])]

    def _decode_dets(self, frame):
        kind, data = frame
        if kind == "triple":
            boxes, scores, classes = data
            m = scores >= self.threshold
            boxes, scores, classes = boxes[m], scores[m], classes[m]
        elif self.format in _SSD_FORMATS:
            boxes, scores, classes = self._decode_ssd(data)
        elif self.format == "yolov8":
            boxes, scores, classes = self._decode_yolov8(data)
        else:
            boxes, scores, classes = self._decode_yolo(data)
        keep = nms_numpy(boxes, scores, self.iou_threshold, self.max_detections)
        detections = []
        for i in keep:
            x1, y1, x2, y2 = boxes[i]
            ci = int(classes[i])
            detections.append({
                "box": [float(x1), float(y1), float(x2), float(y2)],
                "score": float(scores[i]),
                "class_index": ci,
                "label": self._label(ci),
            })
        return detections

    def _decode_ssd(self, tensors):
        boxes = np.asarray(tensors[0], np.float32).reshape(-1, 4)
        scores_all = np.asarray(tensors[1], np.float32)
        scores_all = scores_all.reshape(boxes.shape[0], -1)
        classes = scores_all.argmax(axis=1)
        scores = scores_all.max(axis=1)
        m = scores >= self.threshold
        return boxes[m], scores[m], classes[m]

    def _decode_yolo(self, tensors):
        pred = np.asarray(tensors[0], np.float32)
        pred = pred.reshape(-1, pred.shape[-1])
        xywh, obj, cls = pred[:, :4], pred[:, 4], pred[:, 5:]
        scores_all = obj[:, None] * cls if cls.size else obj[:, None]
        classes = scores_all.argmax(axis=1)
        scores = scores_all.max(axis=1)
        boxes = center_to_corner(xywh)
        m = scores >= self.threshold
        return boxes[m], scores[m], classes[m]

    def _decode_yolov8(self, tensors):
        # channels-first (4+C, N) a frame, anchor-free: the class scores
        # are the confidence (no objectness)
        pred = np.asarray(tensors[0], np.float32)
        if pred.ndim == 3:
            pred = pred.reshape(pred.shape[-2], pred.shape[-1])
        pred = pred.T  # (N, 4+C)
        xywh, cls = pred[:, :4], pred[:, 4:]
        classes = cls.argmax(axis=1)
        scores = cls.max(axis=1)
        boxes = center_to_corner(xywh / self.box_scale)
        m = scores >= self.threshold
        return boxes[m], scores[m], classes[m]

    # -- fusion ------------------------------------------------------------
    def device_fn(self, in_spec: TensorsSpec):
        if self.format in _SSD_FORMATS:
            if len(in_spec) < 2 or len(in_spec[0].shape) != 3:
                return None
            batch, n = in_spec[0].shape[0], in_spec[0].shape[1]
            k = min(4 * self.max_detections, n)

            def topk(arrays):
                return _ssd_topk(arrays[0], arrays[1], k)
        else:
            if len(in_spec) != 1 or len(in_spec[0].shape) != 3:
                return None
            v8 = self.format == "yolov8"
            if v8:
                batch, c4, n = in_spec[0].shape  # channels-first (B,4+C,N)
                if c4 < 5:
                    return None
            else:
                batch, n, width = in_spec[0].shape
                if width < 5:
                    return None
            k = min(4 * self.max_detections, n)
            scale_np = np.asarray(self.box_scale, np.float32)
            scale_vals = [float(v) for v in scale_np.reshape(-1)]
            scale_shape = scale_np.shape
            scales = {}

            def topk(arrays):
                # option8's scale is made on the input's device on the
                # first (eager warm-up) call, by fills: a capture cannot
                # copy from the host
                dev = arrays[0].device
                if dev not in scales:
                    scales[dev] = torch.stack([
                        torch.full((), v, dtype=torch.float32, device=dev)
                        for v in scale_vals]).reshape(scale_shape)
                return _yolo_topk(arrays[0], k, v8, scales[dev])

        if self.nms_mode == "host":
            return topk, TensorsSpec((
                TensorSpec.from_shape((batch, k, 4), np.float32),
                TensorSpec.from_shape((batch, k), np.float32),
                TensorSpec.from_shape((batch, k), np.int32),
            ))

        m = self.max_detections
        thr, iou_thr = self.threshold, self.iou_threshold
        pack = self.out_mode == "tensors"

        def fn_nms(arrays):
            tb, ts, tc = topk(arrays)
            masked = torch.where(ts >= thr, ts, -torch.inf)
            kidx, kv = nms_torch(tb, masked, iou_thr, m)
            kidx = kidx.long()
            kb = torch.gather(tb, 1, kidx[..., None].expand(-1, -1, 4))
            ks = torch.where(kv, torch.gather(masked, 1, kidx), 0.0)
            kc = torch.gather(tc, 1, kidx)
            if pack:
                # ONE [B, M, 7] tensor (x1 y1 x2 y2 score class valid): a
                # single copy to the host
                return (torch.cat(
                    [kb, ks[..., None], kc.float()[..., None],
                     kv.float()[..., None]], dim=-1),)
            return (kb, ks, kc, kv.to(torch.uint8))

        if pack:
            out_spec = TensorsSpec((
                TensorSpec.from_shape((batch, m, 7), np.float32),))
        else:
            out_spec = TensorsSpec((
                TensorSpec.from_shape((batch, m, 4), np.float32),
                TensorSpec.from_shape((batch, m), np.float32),
                TensorSpec.from_shape((batch, m), np.int32),
                TensorSpec.from_shape((batch, m), np.uint8),
            ))
        return fn_nms, out_spec

    def host_post(self, arrays, buf: Buffer) -> Buffer:
        if self.out_mode == "tensors":
            return self._host_post_tensors(arrays, buf)
        tb = np.asarray(arrays[0], np.float32)
        ts = np.asarray(arrays[1], np.float32)
        tc = np.asarray(arrays[2])
        valid = np.asarray(arrays[3]).astype(bool) if len(arrays) > 3 else None
        b = tb.shape[0]
        canvas = np.zeros((b, self.out_h, self.out_w, 4), np.uint8)
        dets = []
        for i in range(b):
            if valid is not None:
                # device-NMS path: the arrays ARE the final detections
                d = [
                    {
                        "box": [float(v) for v in tb[i, j]],
                        "score": float(ts[i, j]),
                        "class_index": int(tc[i, j]),
                        "label": self._label(int(tc[i, j])),
                    }
                    for j in range(tb.shape[1]) if valid[i, j]
                ]
            else:
                d = self._decode_dets(("triple", (tb[i], ts[i], tc[i])))
            self._draw_into(canvas[i], d)
            dets.append(d)
        if b == 1:
            new = buf.with_tensors([canvas[0]], spec=None)
            new.meta["detections"] = dets[0]
            return new
        new = buf.with_tensors([canvas], spec=None)
        new.meta["detections"] = dets
        return new

    def _host_post_tensors(self, arrays, buf: Buffer) -> Buffer:
        """option9=tensors at the sink edge: no canvas, no per-detection
        dicts.  Device NMS sent one packed [B,M,7] array, unpacked here
        into (boxes [B,M,4], scores, classes, valid); host NMS runs the
        greedy pass here and pads into the same layout."""
        if len(arrays) == 1:  # device NMS emitted packed [B, M, 7]
            p = np.asarray(arrays[0], np.float32)
            return buf.with_tensors(
                [np.ascontiguousarray(p[..., :4]),
                 np.ascontiguousarray(p[..., 4]),
                 p[..., 5].astype(np.int32),
                 p[..., 6].astype(np.uint8)], spec=None)
        tb = np.asarray(arrays[0], np.float32)
        ts = np.asarray(arrays[1], np.float32)
        tc = np.asarray(arrays[2])
        b, m = tb.shape[0], self.max_detections
        boxes = np.zeros((b, m, 4), np.float32)
        scores = np.zeros((b, m), np.float32)
        classes = np.zeros((b, m), np.int32)
        valid = np.zeros((b, m), np.uint8)
        for i in range(b):
            d = self._decode_dets(("triple", (tb[i], ts[i], tc[i])))
            for j, det in enumerate(d[:m]):
                boxes[i, j] = det["box"]
                scores[i, j] = det["score"]
                classes[i, j] = det["class_index"]
                valid[i, j] = 1
        return buf.with_tensors([boxes, scores, classes, valid], spec=None)

    def _draw(self, detections) -> np.ndarray:
        overlay = np.zeros((self.out_h, self.out_w, 4), np.uint8)
        self._draw_into(overlay, detections)
        return overlay

    def _draw_into(self, overlay: np.ndarray, detections) -> np.ndarray:
        """Draw in place (the batched host_post draws each frame into its
        row of one [B, H, W, 4] canvas)."""
        t = 2  # line thickness
        for d in detections:
            x1, y1, x2, y2 = d["box"]
            color = _PALETTE[d["class_index"] % len(_PALETTE)]
            px1 = int(np.clip(x1 * self.out_w, 0, self.out_w - 1))
            px2 = int(np.clip(x2 * self.out_w, 0, self.out_w - 1))
            py1 = int(np.clip(y1 * self.out_h, 0, self.out_h - 1))
            py2 = int(np.clip(y2 * self.out_h, 0, self.out_h - 1))
            overlay[py1 : py1 + t, px1:px2] = color
            overlay[max(0, py2 - t) : py2, px1:px2] = color
            overlay[py1:py2, px1 : px1 + t] = color
            overlay[py1:py2, max(0, px2 - t) : px2] = color
        return overlay
