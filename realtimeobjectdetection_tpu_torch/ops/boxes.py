"""Box geometry ops on tensors.

IoU keeps the Darknet "+1" convention of the reference
(src/util.py:144-149): both intersection extents and areas use
``x2 - x1 + 1``.  NMS parity depends on it, and on the order of the fp32
operations, which follows the JAX package's ``ops/boxes.py``.
"""

from __future__ import annotations

import torch

__all__ = ["iou_xyxy", "iou_matrix"]


def iou_xyxy(box1: torch.Tensor, box2: torch.Tensor,
             plus_one: bool = True) -> torch.Tensor:
    """Elementwise IoU of broadcastable corner-format boxes [..., 4]."""
    e = 1.0 if plus_one else 0.0
    ix1 = torch.maximum(box1[..., 0], box2[..., 0])
    iy1 = torch.maximum(box1[..., 1], box2[..., 1])
    ix2 = torch.minimum(box1[..., 2], box2[..., 2])
    iy2 = torch.minimum(box1[..., 3], box2[..., 3])
    inter = (ix2 - ix1 + e).clamp(min=0) * (iy2 - iy1 + e).clamp(min=0)
    a1 = (box1[..., 2] - box1[..., 0] + e) * (box1[..., 3] - box1[..., 1] + e)
    a2 = (box2[..., 2] - box2[..., 0] + e) * (box2[..., 3] - box2[..., 1] + e)
    return inter / (a1 + a2 - inter)


def iou_matrix(boxes1: torch.Tensor, boxes2: torch.Tensor,
               plus_one: bool = True) -> torch.Tensor:
    """[..., N, 4] x [..., M, 4] -> [..., N, M] dense IoU matrix."""
    return iou_xyxy(boxes1[..., :, None, :], boxes2[..., None, :, :],
                    plus_one=plus_one)
