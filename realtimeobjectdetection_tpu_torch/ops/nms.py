"""Fixed-shape, class-aware NMS — the port of the JAX package's ``ops/nms.py``.

The reference (src/util.py:242-346) is a per-image, per-class Python loop:
confidence-mask, center->corner, max class conf/id, then greedy O(n^2)
suppression over boxes sorted by objectness, keeping ``iou < nms_conf``
(strict), with the "+1" IoU convention.  Output rows are grouped by class
id ascending, within a class by objectness descending, as
``[x1, y1, x2, y2, objectness, class_conf, class_id]``.

This port keeps the JAX package's static shapes, with the batch as an
explicit leading dimension:

1. top-K candidates by objectness (valid = obj > confidence, strict), by a
   stable descending sort (``lax.top_k``'s order under ties);
2. greedy same-class suppression: the hand-written CUDA kernel on the card
   (:mod:`.cuda.nms_kernel`), its plain PyTorch version on the CPU;
3. survivors re-ordered by (class asc, objectness desc) with a stable
   argsort, and a validity mask in place of the ``return 0`` sentinel.
"""

from __future__ import annotations

import torch

from .cuda.nms_kernel import nms_suppress

__all__ = ["nms_image", "nms_batch", "nms_candidates"]


def nms_candidates(pred: torch.Tensor, num_classes: int, confidence: float,
                   top_k: int):
    """The top-k candidates of ``[B, N, 5+C]`` decoded rows, as the
    suppression takes them: ``(cand [B, K, 5+C], corners [B, K, 4],
    cls_conf [B, K], cls_id [B, K] int64, cand_valid [B, K],
    n_candidates [B] int32)``, objectness-descending per image."""
    b, n, _ = pred.shape
    k = min(top_k, n)

    obj = pred[..., 4]
    valid = obj > confidence
    n_candidates = valid.sum(dim=1, dtype=torch.int32)

    # invalid rows sink below zero; sigmoid objectness is always > 0
    score = torch.where(valid, obj, torch.full_like(obj, -1.0))
    srt = torch.sort(score, dim=1, descending=True, stable=True)
    top_scores, top_idx = srt.values[:, :k], srt.indices[:, :k]
    cand = torch.gather(pred, 1, top_idx[..., None].expand(b, k,
                                                           pred.shape[2]))
    cand_valid = top_scores > confidence

    # corner transform (src/util.py:263-268)
    cx, cy, w, h = cand[..., 0], cand[..., 1], cand[..., 2], cand[..., 3]
    corners = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                          dim=-1)

    cls_scores = cand[..., 5:5 + num_classes]
    cls_conf = cls_scores.amax(dim=-1)
    cls_id = cls_scores.argmax(dim=-1)  # first maximum, as jnp.argmax
    return cand, corners, cls_conf, cls_id, cand_valid, n_candidates


def nms_batch(pred: torch.Tensor, num_classes: int, confidence: float,
              nms_thresh: float, top_k: int = 256,
              plus_one_iou: bool = True, with_stats: bool = False):
    """Batched NMS: ``[B, N, 5+C] -> ([B, top_k, 7], [B, top_k])``.

    Args:
      pred: ``[B, N, 5+C]`` decoded boxes (cx, cy, w, h, obj, C class
        scores), float32.
      confidence: objectness threshold (strict ``>``, src/util.py:106-117).
      nms_thresh: suppress when ``iou >= nms_thresh`` (the reference keeps
        ``iou < nms_conf``, src/util.py:324).
      top_k: static candidate budget (also the max number of outputs).
      with_stats: also return the ``[B]`` int32 count of rows passing the
        confidence gate (saturated where ``count > top_k``: the static
        budget then dropped the lowest-objectness extras).

    Returns ``boxes [B, top_k, 7]`` (valid rows first in reference order),
    ``valid [B, top_k]`` bool and, with ``with_stats``, the counts.
    """
    cand, corners, cls_conf, cls_id, cand_valid, n_candidates = \
        nms_candidates(pred, num_classes, confidence, top_k)
    keep = nms_suppress(corners, cls_id.to(torch.int32), cand_valid,
                        nms_thresh, plus_one=plus_one_iou, ge=True)
    b, k = keep.shape

    # reference row order: class ascending, objectness descending within
    # class; rows are already obj-descending, and the argsort is stable
    sort_key = torch.where(keep, cls_id, torch.full_like(cls_id,
                                                         num_classes + 1))
    order = torch.argsort(sort_key, dim=1, stable=True)

    out = torch.cat([corners, cand[..., 4:5], cls_conf[..., None],
                     cls_id.to(pred.dtype)[..., None]], dim=-1)
    out = torch.gather(out, 1, order[..., None].expand(b, k, 7))
    keep = torch.gather(keep, 1, order)
    if with_stats:
        return out, keep, n_candidates
    return out, keep


def nms_image(pred: torch.Tensor, num_classes: int, confidence: float,
              nms_thresh: float, top_k: int = 256,
              plus_one_iou: bool = True, with_stats: bool = False):
    """NMS for one image: ``[N, 5+C] -> ([top_k, 7], [top_k])`` (and the
    scalar candidate count with ``with_stats``); see :func:`nms_batch`."""
    res = nms_batch(pred[None], num_classes, confidence, nms_thresh,
                    top_k=top_k, plus_one_iou=plus_one_iou,
                    with_stats=with_stats)
    return tuple(r[0] for r in res)
