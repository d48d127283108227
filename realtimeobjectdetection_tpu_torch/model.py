"""GraphSpec -> a forward function of PyTorch ops.

The port's counterpart of the JAX package's ``model.py``.  The public
layout is the JAX package's: the input batch is NHWC and each head comes
back NHWC ``[B, H, W, A*(5+C)]``.  Inside, activations are NCHW tensors
as PyTorch expects, held in the channels-last memory format (the NHWC
input permuted to NCHW already has it), and kernels are OIHW.  Convs go
to ``F.conv2d`` (cuDNN on the card), as the JAX package leaves them to XLA.

BatchNorm modes
---------------
``fold``     BN folded into conv weights at load time — the fast inference
             path (identical numerics to ``running`` up to fp rounding).
``running``  eval-style BN with stored running statistics.
``batch``    per-batch statistics *even at inference* — this reproduces the
             reference detector, which never calls ``model.eval()``
             (detect.py:62-63 runs the module in training mode), so the
             golden ``det/metrics.json`` was produced with batch stats.

For fp32 parity on the card, turn TF32 off for cuDNN
(``torch.backends.cudnn.allow_tf32 = False``), the counterpart of the JAX
package's ``precision="highest"``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .cfg_parser import (ConvSpec, GraphSpec, MaxPoolSpec, RouteSpec,
                         ShortcutSpec, UpsampleSpec, YoloSpec)

__all__ = ["BN_EPS", "fold_batchnorm", "make_forward", "head_shapes"]

BN_EPS = 1e-5  # torch.nn.BatchNorm2d default (src/darknet.py:494)


def fold_batchnorm(spec: GraphSpec, params: Dict) -> Dict:
    """Fold BN affine+stats into conv kernel/bias (inference fast path)."""
    out = {}
    for node in spec.conv_nodes:
        key = f"node_{node.index}"
        entry = params[key]
        if node.batch_normalize:
            scale = entry["bn_gamma"] * torch.rsqrt(entry["bn_var"] + BN_EPS)
            out[key] = {
                "w": entry["w"] * scale[:, None, None, None],
                "b": entry["bn_beta"] - entry["bn_mean"] * scale,
            }
        else:
            out[key] = {"w": entry["w"], "b": entry["b"]}
    return out


def _conv(x, w, stride: int, pad: int, compute_dtype, out_dtype):
    y = F.conv2d(x.to(compute_dtype), w.to(compute_dtype),
                 stride=stride, padding=pad)
    return y.to(out_dtype)


def _batch_stats_bn(y, gamma, beta):
    # biased variance over (N, H, W) in fp32, matching torch train-mode BN
    mean = y.mean(dim=(0, 2, 3))[None, :, None, None]
    var = torch.square(y - mean).mean(dim=(0, 2, 3))
    inv = torch.rsqrt(var + BN_EPS)
    return (y - mean) * (gamma * inv)[None, :, None, None] \
        + beta[None, :, None, None]


def _maxpool(x, node: MaxPoolSpec):
    k, s = node.kernel_size, node.stride
    if s != 1:
        return F.max_pool2d(x, k, s)
    # stride-1 cfg variant: replicate-pad right/bottom by k-1, pool with
    # stride k-1 (reference MaxPoolStride1, src/darknet.py:17-46 — note it
    # constructs MaxPool2d(kernel, stride=k-1)).
    p = k - 1
    return F.max_pool2d(F.pad(x, (0, p, 0, p), mode="replicate"), k, p)


def _upsample_bilinear(x, stride: int):
    # half-pixel-centres bilinear == nn.Upsample(align_corners=False)
    # (src/darknet.py:591-592)
    return F.interpolate(x, scale_factor=stride, mode="bilinear",
                         align_corners=False)


def head_shapes(spec: GraphSpec, batch: int, height: Optional[int] = None,
                width: Optional[int] = None) -> List[Tuple[int, int, int, int]]:
    """Static NHWC output shape of each yolo head for a given input size."""
    h = height or spec.net.height
    w = width or spec.net.width
    shapes = []
    cur_h, cur_w = h, w
    sizes: List[Tuple[int, int]] = []
    for node in spec.nodes:
        if isinstance(node, ConvSpec):
            cur_h = (cur_h + 2 * node.pad - node.kernel_size) // node.stride + 1
            cur_w = (cur_w + 2 * node.pad - node.kernel_size) // node.stride + 1
        elif isinstance(node, MaxPoolSpec):
            if node.stride != 1:
                cur_h = (cur_h - node.kernel_size) // node.stride + 1
                cur_w = (cur_w - node.kernel_size) // node.stride + 1
            elif node.kernel_size != 2:
                # replicate-pad variant pools with stride k-1 (see
                # _maxpool); only k=2 is shape-preserving
                p = node.kernel_size - 1
                cur_h = (cur_h + p - node.kernel_size) // p + 1
                cur_w = (cur_w + p - node.kernel_size) // p + 1
        elif isinstance(node, UpsampleSpec):
            cur_h *= node.stride
            cur_w *= node.stride
        elif isinstance(node, RouteSpec):
            cur_h, cur_w = sizes[node.sources[0]]
        elif isinstance(node, YoloSpec):
            a = len(node.anchors)
            shapes.append((batch, cur_h, cur_w, a * (5 + node.num_classes)))
        sizes.append((cur_h, cur_w))
    return shapes


def make_forward(spec: GraphSpec, bn_mode: str = "fold",
                 compute_dtype=torch.float32, activation_dtype=None,
                 head_dtype=None, *, return_stats: bool = False,
                 scan_ladders: bool = False, s2d_stem: bool = False,
                 stage_range: Optional[Tuple[int, int]] = None,
                 quantize: Optional[str] = None):
    """Build ``forward(params, x) -> [head0, head1, ...]`` (raw heads, NHWC).

    ``x`` is an NHWC float batch.  ``compute_dtype`` is the conv input
    dtype; ``activation_dtype`` (None = fp32) the dtype inter-layer
    activations are kept in; ``head_dtype`` (None = fp32) the dtype heads
    are returned in.  In ``batch``/``running`` BN the conv output, the
    statistics and the normalisation stay fp32 and only the
    post-activation tensor is cast, as in the JAX package.

    ``return_stats``, ``scan_ladders``, ``s2d_stem``, ``stage_range`` and
    ``quantize`` belong to slices not ported yet (ROADMAP.md) and raise.
    """
    if bn_mode not in ("fold", "running", "batch"):
        raise ValueError(f"unknown bn_mode {bn_mode!r}")
    unported = {"return_stats": return_stats, "scan_ladders": scan_ladders,
                "s2d_stem": s2d_stem, "stage_range": stage_range,
                "quantize": quantize}
    asked = sorted(k for k, v in unported.items() if v)
    if asked:
        raise NotImplementedError(
            f"make_forward options {asked} are not ported (ROADMAP.md)")
    act_dtype = activation_dtype or torch.float32
    head_dtype = head_dtype or torch.float32
    live = spec.live_after()

    def forward(params, x):
        outputs: Dict[int, torch.Tensor] = {}
        heads: List[torch.Tensor] = []
        prev = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view (channels-last)
        for node in spec.nodes:
            i = node.index
            if isinstance(node, ConvSpec):
                entry = params[f"node_{i}"]
                # batch/running BN keeps the conv output fp32 so the
                # statistics and the normalisation stay fp32; fold and
                # no-BN convs materialise act_dtype directly
                conv_dt = act_dtype if (bn_mode == "fold"
                                        or not node.batch_normalize) \
                    else torch.float32
                y = _conv(prev, entry["w"], node.stride, node.pad,
                          compute_dtype, conv_dt)
                if node.batch_normalize and bn_mode != "fold":
                    if bn_mode == "batch":
                        y = _batch_stats_bn(y, entry["bn_gamma"],
                                            entry["bn_beta"])
                    else:
                        inv = torch.rsqrt(entry["bn_var"] + BN_EPS)
                        y = ((y - entry["bn_mean"][None, :, None, None])
                             * (entry["bn_gamma"] * inv)[None, :, None, None]
                             + entry["bn_beta"][None, :, None, None])
                else:
                    y = y + entry["b"].to(y.dtype)[None, :, None, None]
                if node.activation == "leaky":
                    y = F.leaky_relu(y, 0.1)
                out = y.to(act_dtype)
            elif isinstance(node, MaxPoolSpec):
                out = _maxpool(prev, node)
            elif isinstance(node, UpsampleSpec):
                out = _upsample_bilinear(prev, node.stride)
            elif isinstance(node, RouteSpec):
                out = (outputs[node.sources[0]] if len(node.sources) == 1
                       else torch.cat([outputs[s] for s in node.sources],
                                      dim=1))
            elif isinstance(node, ShortcutSpec):
                out = prev + outputs[node.source]
            elif isinstance(node, YoloSpec):
                heads.append(prev.permute(0, 2, 3, 1).to(head_dtype)
                             .contiguous())
                out = prev  # reference: outputs[i] = outputs[i-1]
            else:  # pragma: no cover
                raise TypeError(node)
            outputs[i] = out
            prev = out
            # free dead activations as the walk proceeds
            for j in list(outputs):
                if live[j] <= i:
                    del outputs[j]
        return heads

    return forward
