"""YOLO head decode — the port of the JAX package's ``ops/decode.py``.

Reference semantics (src/util.py:175-239):

* reshape ``[B, A*(5+C), G, G]`` -> ``[B, G*G*A, 5+C]`` — rows ordered
  cell-major (row-major over the grid), anchor-minor;
* sigmoid on x, y and on columns 4: (objectness + classes);
* inference adds grid-cell offsets, ``wh = exp(raw) * anchor`` (anchor in
  input pixels), and scales xy by the stride;
* TRAIN mode skips the geometric decode (raw grid-space wh, no offsets).

Heads are NHWC ``[B, H, W, A*(5+C)]``; the channel axis carries the
anchor-major packing of torch's channel dim, so
``reshape(B, H*W, A, 5+C)`` reproduces the row order exactly.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..cfg_parser import GraphSpec

__all__ = ["decode_head", "decode_heads", "decode_topk"]


def decode_head(head: torch.Tensor, anchors: Sequence[Tuple[int, int]],
                num_classes: int, input_dim: int,
                train: bool = False) -> torch.Tensor:
    """Decode one raw head ``[B, H, W, A*(5+C)]`` -> ``[B, H*W*A, 5+C]``."""
    b, h, w, _ = head.shape
    a = len(anchors)
    c = 5 + num_classes
    stride = input_dim // h
    p = head.reshape(b, h * w, a, c)

    xy = torch.sigmoid(p[..., 0:2])
    wh = p[..., 2:4]
    objcls = torch.sigmoid(p[..., 4:])

    if not train:
        # cell offsets: x = column index, y = row index (row-major cells)
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=head.dtype, device=head.device),
            torch.arange(w, dtype=head.dtype, device=head.device),
            indexing="ij")
        offs = torch.stack([gx, gy], dim=-1).reshape(1, h * w, 1, 2)
        anc = torch.tensor(anchors, dtype=head.dtype,
                           device=head.device).reshape(1, 1, a, 2)
        xy = (xy + offs) * stride
        wh = torch.exp(wh) * anc
    out = torch.cat([xy, wh, objcls], dim=-1)
    return out.reshape(b, h * w * a, c)


def decode_heads(heads: List[torch.Tensor], spec: GraphSpec, input_dim: int,
                 train: bool = False) -> torch.Tensor:
    """Decode + concat all heads along the box axis (detection order).

    Matches the forward interpreter's scale-by-scale concat
    (src/darknet.py:238-244).
    """
    yolos = spec.yolo_nodes
    if len(heads) != len(yolos):
        raise ValueError(f"{len(heads)} heads for {len(yolos)} yolo nodes")
    return torch.cat([
        decode_head(head, y.anchors, y.num_classes, input_dim, train=train)
        for head, y in zip(heads, yolos)], dim=1)


@functools.lru_cache(maxsize=8)
def _row_constants(grids, input_dim: int, device) -> torch.Tensor:
    """Per-row decode constants ``[N, 5]`` on ``device``: cell x, cell y,
    anchor w, anchor h, stride — in the row order of :func:`decode_heads`.
    ``grids`` holds ``(h, w, anchors)`` per head.  Cached, so the serving
    loop uploads them once."""
    cols = []
    for h, w, anchors in grids:
        a = len(anchors)
        gx, gy = np.meshgrid(np.arange(w), np.arange(h))  # [h, w]
        anc = np.asarray(anchors, np.float32)
        cols.append(np.stack([
            np.repeat(gx.reshape(-1), a).astype(np.float32),
            np.repeat(gy.reshape(-1), a).astype(np.float32),
            np.tile(anc[:, 0], h * w), np.tile(anc[:, 1], h * w),
            np.full(h * w * a, input_dim // h, np.float32)], axis=1))
    return torch.from_numpy(np.concatenate(cols, axis=0)).to(device)


def decode_topk(heads: List[torch.Tensor], spec: GraphSpec, input_dim: int,
                top_k: int, confidence: float = 0.0, approx: bool = False):
    """Fused objectness-first selection: decode only the top-k rows.

    Takes a global top-k over the raw objectness *logits* (sigmoid is
    monotonic, so logit order == probability order) and decodes only the
    K gathered rows.  The top-k is a stable descending sort, which keeps
    ``lax.top_k``'s lower-index-first order under ties.

    Returns ``(pred [B, K, 5+C] decoded rows in objectness-descending
    order, n_candidates [B] int32 rows with obj > confidence)`` — feed
    straight into ``nms_batch(..., top_k=K)``.

    ``approx=True`` (the TPU's ``lax.approx_max_k``) is not ported and
    raises.
    """
    if approx:
        raise NotImplementedError(
            "decode_topk(approx=True) is not ported (ROADMAP.md)")
    yolos = spec.yolo_nodes
    if len(heads) != len(yolos):
        raise ValueError(f"{len(heads)} heads for {len(yolos)} yolo nodes")
    b = heads[0].shape[0]
    c = 5 + yolos[0].num_classes
    dev = heads[0].device

    raw = torch.cat([hd.reshape(b, -1, c) for hd in heads], dim=1)
    # heads may arrive bf16; select on f32 logits, decode the gathered
    # K rows in f32
    obj_logits = raw[..., 4].float()
    n = raw.shape[1]
    k = min(top_k, n)
    # strict > on probabilities == strict > on logits (both monotonic)
    if confidence > 0.0:
        logit_thresh = float(np.log(confidence / (1.0 - confidence)))
        n_cand = (obj_logits > logit_thresh).sum(dim=1, dtype=torch.int32)
    else:
        n_cand = torch.full((b,), n, dtype=torch.int32, device=dev)

    idx = torch.sort(obj_logits, dim=1, descending=True,
                     stable=True).indices[:, :k]                # [B, K]
    rows = torch.gather(raw, 1, idx[..., None].expand(b, k, c)).float()
    grids = tuple((hd.shape[1], hd.shape[2], y.anchors)
                  for hd, y in zip(heads, yolos))
    cst = _row_constants(grids, input_dim, dev)[idx]            # [B, K, 5]

    xy = (torch.sigmoid(rows[..., 0:2]) + cst[..., 0:2]) * cst[..., 4:5]
    wh = torch.exp(rows[..., 2:4]) * cst[..., 2:4]
    objcls = torch.sigmoid(rows[..., 4:])
    return torch.cat([xy, wh, objcls], dim=-1), n_cand
