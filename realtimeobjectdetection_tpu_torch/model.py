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

Int8 inference (``quantize=``) runs over the params of
``ops.quantize.quantize_folded_int8``: ``"w8"`` and ``"w8a8"`` in the walk
below, ``"w8a8_pallas"`` in :mod:`.model_int8` over the hand-written
tap-matmul kernel.

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
from .ops.quantize import conv_w8, conv_w8a8

__all__ = ["BN_EPS", "fold_batchnorm", "make_forward", "head_shapes"]

QUANTIZE_MODES = ("w8", "w8a8", "w8a8_pallas")

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


def _find_ladders(spec: GraphSpec) -> Dict[int, int]:
    """Find residual ladders: maximal runs of identical
    [conv 1x1 c->c/2, conv 3x3 c/2->c, shortcut] triples.

    Returns {start_node_index: repetitions}.  The int8 forward
    (:mod:`.model_int8`) fuses each ladder's shortcut into its 3x3 conv.
    A ladder is only eligible if no route/shortcut outside it taps an
    interior node (only the final output may be read).
    """
    nodes = spec.nodes
    # (referrer, source) pairs so interior taps can be attributed
    ref_pairs = []
    for n in nodes:
        if isinstance(n, RouteSpec):
            ref_pairs.extend((n.index, s) for s in n.sources)
        elif isinstance(n, ShortcutSpec):
            ref_pairs.append((n.index, n.source))

    def is_triple(i, proto=None):
        if i + 2 >= len(nodes):
            return False
        a, b, c = nodes[i], nodes[i + 1], nodes[i + 2]
        ok = (isinstance(a, ConvSpec) and isinstance(b, ConvSpec)
              and isinstance(c, ShortcutSpec)
              and c.source == i - 1
              and a.kernel_size == 1 and b.kernel_size == 3
              and a.stride == 1 and b.stride == 1
              and a.batch_normalize and b.batch_normalize
              and a.activation == "leaky" and b.activation == "leaky"
              and b.out_channels == a.in_channels
              and b.in_channels == a.out_channels)
        if not ok:
            return False
        if proto is not None:
            pa, _ = proto
            ok = (a.in_channels == pa.in_channels
                  and a.out_channels == pa.out_channels)
        return ok

    ladders: Dict[int, int] = {}
    i = 0
    while i < len(nodes):
        if is_triple(i):
            proto = (nodes[i], nodes[i + 1])
            reps = 1
            while is_triple(i + 3 * reps, proto):
                reps += 1
            # trim reps while any node interior to the region is
            # referenced by anything other than the ladder's own shortcut
            # nodes (a route into a mid-ladder output would need that
            # intermediate activation)
            while reps > 1:
                interior = set(range(i, i + 3 * reps - 1))
                own_shortcut_nodes = {i + 3 * t + 2 for t in range(reps)}
                external = [
                    (ref, src) for ref, src in ref_pairs
                    if src in interior and ref not in own_shortcut_nodes]
                if external:
                    reps -= 1
                else:
                    break
            if reps > 1:
                ladders[i] = reps
            i += 3 * reps
        else:
            i += 1
    return ladders


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

    ``quantize``: ``"w8"`` or ``"w8a8"`` int8 inference over params
    produced by :func:`.ops.quantize.quantize_folded_int8` (requires
    ``bn_mode="fold"``), in this walk; ``"w8a8_pallas"`` returns
    :func:`.model_int8.make_forward_int8` instead, whose flat activations
    are ``activation_dtype``, bf16 when it is None (whatever
    ``compute_dtype`` says, as in the JAX package).

    ``return_stats``, ``scan_ladders``, ``s2d_stem`` and ``stage_range``
    belong to slices not ported yet (ROADMAP.md) and raise.
    """
    if bn_mode not in ("fold", "running", "batch"):
        raise ValueError(f"unknown bn_mode {bn_mode!r}")
    if quantize is not None and quantize not in QUANTIZE_MODES:
        raise ValueError(f"unknown quantize mode {quantize!r}")
    if quantize and bn_mode != "fold":
        raise ValueError("int8 paths consume BN-folded params: quantize "
                         "requires bn_mode='fold'")
    unported = {"return_stats": return_stats, "scan_ladders": scan_ladders,
                "s2d_stem": s2d_stem, "stage_range": stage_range}
    asked = sorted(k for k, v in unported.items() if v)
    if asked:
        raise NotImplementedError(
            f"make_forward options {asked} are not ported (ROADMAP.md)")
    if quantize == "w8a8_pallas":
        from .model_int8 import make_forward_int8
        return make_forward_int8(
            spec, compute_dtype=activation_dtype or torch.bfloat16,
            head_dtype=head_dtype)
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
                if quantize == "w8":
                    y = conv_w8(prev, entry["w_q"], entry["scale"],
                                node.stride, node.pad, compute_dtype)
                elif quantize == "w8a8":
                    y = conv_w8a8(prev, entry["w_q"], entry["scale"],
                                  node.stride, node.pad)
                else:
                    # batch/running BN keeps the conv output fp32 so the
                    # statistics and the normalisation stay fp32; fold
                    # and no-BN convs materialise act_dtype directly
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
