"""Non-maximum suppression + box utilities.

Port of ``nnstreamer_tpu/ops/nms.py`` (reference: the NMS inside
``tensordec-boundingbox.c``).  Two implementations with the same
semantics:

* :func:`nms_numpy` — greedy IoU NMS on the host (the decoder's default
  path), copied from the JAX package;
* :func:`nms_torch` — the counterpart of its ``nms_jax``: fixed size,
  ``max_out`` iterations over a precomputed IoU matrix, static shapes and
  no host read, so it runs inside a captured CUDA graph.  It is batched
  over frames where the JAX package ``vmap``s its single-frame function.

Boxes are corner-format [x1, y1, x2, y2].
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _box_areas(boxes: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, boxes[..., 2] - boxes[..., 0]) * np.maximum(
        0.0, boxes[..., 3] - boxes[..., 1]
    )


def iou_row(box: np.ndarray, box_area: float, boxes: np.ndarray,
            areas: np.ndarray) -> np.ndarray:
    """IoU of one corner-format box against (N,4) boxes — the single
    implementation of the IoU convention (degenerate boxes -> 0, eps-guarded
    divide) shared by :func:`iou_matrix` and :func:`nms_numpy`."""
    ix1 = np.maximum(box[0], boxes[:, 0])
    iy1 = np.maximum(box[1], boxes[:, 1])
    ix2 = np.minimum(box[2], boxes[:, 2])
    iy2 = np.minimum(box[3], boxes[:, 3])
    inter = np.maximum(0.0, ix2 - ix1) * np.maximum(0.0, iy2 - iy1)
    union = box_area + areas - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-9), 0.0)


def iou_matrix(boxes: np.ndarray) -> np.ndarray:
    """Pairwise IoU for corner-format boxes (N,4) -> (N,N)."""
    boxes = boxes.astype(np.float64)
    areas = _box_areas(boxes)
    return np.stack(
        [iou_row(boxes[i], areas[i], boxes, areas) for i in range(len(boxes))]
    ) if len(boxes) else np.zeros((0, 0))


def nms_numpy(
    boxes: np.ndarray,
    scores: np.ndarray,
    iou_threshold: float = 0.5,
    max_out: int = 100,
) -> np.ndarray:
    """Greedy NMS; returns indices of kept boxes, best-first.

    O(K·N) memory/work (one IoU row per kept box) — never materializes the
    N×N matrix, so large candidate sets (batched streams) stay cheap."""
    boxes = boxes.astype(np.float64)
    areas = _box_areas(boxes)
    order = np.argsort(-scores)
    keep = []
    suppressed = np.zeros(len(boxes), bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        if len(keep) >= max_out:
            break
        iou = iou_row(boxes[i], areas[i], boxes, areas)
        suppressed |= iou > iou_threshold
        suppressed[i] = True
    return np.asarray(keep, np.int64)


def nms_torch(boxes: torch.Tensor, scores: torch.Tensor,
              iou_threshold: float = 0.5,
              max_out: int = 100) -> Tuple[torch.Tensor, torch.Tensor]:
    """Branch-free NMS over a batch of frames: boxes [B, N, 4], scores
    [B, N] (-inf = not a candidate) -> (indices [B, max_out] int32, valid
    [B, max_out] bool).

    Each of ``max_out`` iterations picks every frame's best live score
    (``argmax``: the lowest index among equal scores, as ``jnp.argmax``)
    and suppresses its overlaps, itself included; a frame with no live
    score left marks the pick invalid.  The IoU is computed in float32
    with ``nms_jax``'s operations in its order."""
    boxes = boxes.float()
    n = boxes.shape[1]
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = torch.clamp(x2 - x1, min=0.0) * torch.clamp(y2 - y1, min=0.0)
    ix1 = torch.maximum(x1[:, :, None], x1[:, None, :])
    iy1 = torch.maximum(y1[:, :, None], y1[:, None, :])
    ix2 = torch.minimum(x2[:, :, None], x2[:, None, :])
    iy2 = torch.minimum(y2[:, :, None], y2[:, None, :])
    inter = torch.clamp(ix2 - ix1, min=0.0) * torch.clamp(iy2 - iy1, min=0.0)
    union = area[:, :, None] + area[:, None, :] - inter
    iou = torch.where(union > 0, inter / torch.clamp(union, min=1e-9), 0.0)

    live = torch.where(torch.isfinite(scores), scores.float(), -torch.inf)
    cols = torch.arange(n, device=boxes.device)
    picks, valids = [], []
    for _ in range(max_out):
        best = torch.argmax(live, dim=1)                       # [B]
        valid = torch.gather(live, 1, best[:, None])[:, 0] > -torch.inf
        row = torch.gather(iou, 1, best[:, None, None].expand(-1, 1, n))[:, 0]
        kill = (row > iou_threshold) | (cols[None, :] == best[:, None])
        live = torch.where(valid[:, None] & kill, -torch.inf, live)
        picks.append(best.to(torch.int32))
        valids.append(valid)
    return torch.stack(picks, dim=1), torch.stack(valids, dim=1)


def center_to_corner(boxes_cxcywh):
    """[cx, cy, w, h] -> [x1, y1, x2, y2] (numpy arrays or torch tensors)."""
    cx, cy, w, h = (
        boxes_cxcywh[..., 0],
        boxes_cxcywh[..., 1],
        boxes_cxcywh[..., 2],
        boxes_cxcywh[..., 3],
    )
    stack = np.stack if isinstance(boxes_cxcywh, np.ndarray) else torch.stack
    return stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], axis=-1)
