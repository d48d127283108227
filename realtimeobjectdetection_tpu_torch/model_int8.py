"""GraphSpec -> int8 inference forward over the tap-matmul kernel.

The port of the JAX package's ``model_int8.py``, the ``w8a8_pallas``
inference mode: every *eligible* conv (stride 1, kernel 1x1/3x3,
min(C_in, C_out) >= ``min_channels``) runs through the w8a8 tap-matmul
conv (``ops/cuda/conv_int8.conv_flat_int8``: the hand-written kernel on
the card, its plain version on the CPU) over the flat padded row layout;
everything else (stem, stride-2 downsamples, maxpool, upsample, route, an
unfused shortcut) is the NHWC fallback, run on the port's torch ops in
channels-last NCHW.  Consecutive eligible convs chain in the flat layout
with no re-padding: the conv's zeroed non-content rows are the next conv's
padding, so a whole residual ladder and the head conv towers never leave
the layout.

Residual ladders (``model._find_ladders``) fuse each shortcut into the
epilogue of their 3x3 conv, as the JAX package's ladder scans do; here a
ladder is a Python loop.  Fusion changes the rounding (an fp32 add and
one cast against an add in the activation dtype), so ``scan_ladders=True``
and ``False`` compute different numbers, as they do in the JAX package.

Params: the ``ops.quantize.quantize_folded_int8`` dict
({"w_q" OIHW int8, "scale" [O] f32, "b" [O] f32} per conv), shared with
the w8/w8a8 modes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .cfg_parser import (ConvSpec, GraphSpec, MaxPoolSpec, RouteSpec,
                         ShortcutSpec, UpsampleSpec, YoloSpec)
from .model import _find_ladders, _maxpool, _upsample_bilinear
from .ops.conv_int8 import (FlatLayout, from_flat, make_layout,
                            pack_conv_int8, to_flat)
from .ops.cuda.conv_int8 import conv_flat_int8

__all__ = ["make_forward_int8", "flat_layouts"]

# The rule that picks the row-block height tm.  The per-block activation
# scales depend on tm and gr, so this rule is part of the function the
# forward computes: it is the JAX package's (model_int8.py:41-61), whose
# constant is a 12 MB budget of the TPU's VMEM, kept so that the port
# computes the same numbers.  It says nothing about this card's memory.
_VMEM_BUDGET = 12 * 1024 * 1024


def _vmem_estimate(tm: int, gr: int, cin: int, cout: int, k: int) -> int:
    halo = tm + 2 * gr if k == 3 else tm
    return (halo * cin * 3            # bf16 input + int8 quantized copy
            + k * k * cin * cout      # int8 weights
            + tm * cout * 4           # int32/f32 accumulator
            + tm * cout * 2)          # bf16 output block


def _pick_tm(gr: int, pairs: List[Tuple[int, int, int]]) -> int:
    """Largest tm (multiple of gr, <=1024) with every (cin, cout, k) conv
    at this resolution under the budget."""
    for tm in (1024, 768, 512, 384, 256, 128):
        if tm % gr or tm < gr:
            continue
        if all(_vmem_estimate(tm, gr, ci, co, k) < _VMEM_BUDGET
               for ci, co, k in pairs):
            return tm
    return gr


def _eligible(n, min_channels: int) -> bool:
    """A conv the tap-matmul kernel runs: stride 1, 1x1 or 3x3, and at
    least ``min_channels`` channels in and out."""
    return (isinstance(n, ConvSpec) and n.stride == 1
            and n.kernel_size in (1, 3)
            and min(n.in_channels, n.out_channels) >= min_channels)


def _resolutions(spec: GraphSpec) -> Dict[int, Tuple[int, int]]:
    """Node index -> its output (H, W) at the spec's input size (mirrors
    ``model.head_shapes``)."""
    out, sizes = {}, []
    cur = (spec.net.height, spec.net.width)
    for n in spec.nodes:
        if isinstance(n, ConvSpec):
            cur = ((cur[0] + 2 * n.pad - n.kernel_size) // n.stride + 1,
                   (cur[1] + 2 * n.pad - n.kernel_size) // n.stride + 1)
        elif isinstance(n, MaxPoolSpec):
            if n.stride != 1:
                cur = ((cur[0] - n.kernel_size) // n.stride + 1,
                       (cur[1] - n.kernel_size) // n.stride + 1)
            elif n.kernel_size != 2:
                p = n.kernel_size - 1
                cur = ((cur[0] + p - n.kernel_size) // p + 1,
                       (cur[1] + p - n.kernel_size) // p + 1)
        elif isinstance(n, UpsampleSpec):
            cur = (cur[0] * n.stride, cur[1] * n.stride)
        elif isinstance(n, RouteSpec):
            cur = sizes[n.sources[0]]
        out[n.index] = cur
        sizes.append(cur)
    return out


def flat_layouts(spec: GraphSpec, batch: int, min_channels: int = 64
                 ) -> Dict[Tuple[int, int], FlatLayout]:
    """The flat layout of each resolution that has an eligible conv, with
    tm picked by :func:`_pick_tm` over that resolution's convs."""
    res_of = _resolutions(spec)
    pairs: Dict[Tuple[int, int], List[Tuple[int, int, int]]] = {}
    for n in spec.nodes:
        if _eligible(n, min_channels):
            # input resolution == output resolution for stride-1 convs
            pairs.setdefault(res_of[n.index], []).append(
                (n.in_channels, n.out_channels, n.kernel_size))
    out = {}
    for (h, w), prs in pairs.items():
        gr = make_layout(batch, h, w, tm=128).gr
        out[(h, w)] = make_layout(batch, h, w, tm=_pick_tm(gr, prs))
    return out


def make_forward_int8(spec: GraphSpec, compute_dtype=torch.bfloat16,
                      head_dtype=None, min_channels: int = 64,
                      scan_ladders: bool = True):
    """Build ``forward(params_q, x) -> [head0, ...]`` (raw NHWC heads).

    ``x`` is an NHWC float batch at the spec's input size.
    ``compute_dtype`` is the fallback conv dtype *and* the flat activation
    dtype; ``head_dtype`` defaults to fp32 (decode parity).  The device of
    ``x`` and the params picks the conv: the CUDA kernel on the card, its
    plain version on the CPU.
    """
    head_dtype = head_dtype or torch.float32
    live = spec.live_after()
    nodes = spec.nodes
    res_of = _resolutions(spec)

    def eligible(n) -> bool:
        return _eligible(n, min_channels)

    ladders = {
        start: reps for start, reps in
        (_find_ladders(spec) if scan_ladders else {}).items()
        if eligible(nodes[start]) and eligible(nodes[start + 1])
    }

    flat_nodes = [n.index for n in nodes if eligible(n)]
    # the kernels of the params last seen, packed once for the flat convs
    # (a detector's params never change once loaded), and the layouts of
    # each batch size
    packed: Dict[str, object] = {"params": None}
    layouts_of: Dict[int, Dict[Tuple[int, int], FlatLayout]] = {}

    def pack(params) -> Dict[int, torch.Tensor]:
        if packed["params"] is not params:
            packed.update(params=params, w={
                i: pack_conv_int8(params[f"node_{i}"]["w_q"])
                for i in flat_nodes})
        return packed["w"]

    def forward(params, x):
        b = x.shape[0]
        if b not in layouts_of:
            layouts_of[b] = flat_layouts(spec, b, min_channels)
        layouts = layouts_of[b]
        w_packed = pack(params)
        outputs: Dict[int, torch.Tensor] = {}     # NCHW, channels-last
        flats: Dict[int, Tuple[torch.Tensor, Tuple[int, int]]] = {}
        heads: List[torch.Tensor] = []

        def conv(i: int, xflat, lay, skip=None):
            n, e = nodes[i], params[f"node_{i}"]
            act = "leaky" if n.activation == "leaky" else "linear"
            return conv_flat_int8(xflat, w_packed[i], e["scale"], e["b"],
                                  lay, k=n.kernel_size, act=act, skip=skip,
                                  out_dtype=compute_dtype)

        def nchw(f, hw):
            return from_flat(f, layouts[hw]).permute(0, 3, 1, 2)

        def as_nchw(i: int) -> torch.Tensor:
            if i not in outputs:
                f, hw = flats[i]
                outputs[i] = nchw(f, hw)
            return outputs[i]

        def flat_of(t, lay):
            return to_flat(t.to(compute_dtype).permute(0, 2, 3, 1), lay)

        def gc(upto: int):
            for j in list(outputs):
                if live[j] <= upto:
                    del outputs[j]
            for j in list(flats):
                if live[j] <= upto:
                    del flats[j]

        prev = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view (channels-last)
        prev_flat: Optional[torch.Tensor] = None
        prev_hw = (x.shape[1], x.shape[2])

        idx = 0
        while idx < len(nodes):
            node = nodes[idx]
            i = node.index
            if i in ladders:
                reps = ladders[i]
                hw = res_of[i]
                lay = layouts[hw]
                if prev_flat is None:
                    prev_flat = flat_of(prev, lay)
                h = prev_flat
                for t in range(reps):
                    y = conv(i + 3 * t, h, lay)
                    h = conv(i + 3 * t + 1, y, lay, skip=h)
                last = i + 3 * reps - 1
                flats[last] = (h, hw)
                prev, prev_flat, prev_hw = None, h, hw
                idx += 3 * reps
                gc(last)
                continue

            if eligible(node):
                hw = res_of[i]
                lay = layouts[hw]
                if prev_flat is None:
                    prev_flat = flat_of(prev, lay)
                # fuse a following shortcut into the kernel epilogue when
                # this conv's raw output has no other consumer
                skip = None
                consumed = 1
                if (node.kernel_size == 3 and idx + 1 < len(nodes)
                        and isinstance(nodes[idx + 1], ShortcutSpec)
                        and nodes[idx + 1].source in flats
                        and flats[nodes[idx + 1].source][1] == hw
                        and node.activation == "leaky"
                        and live[i] <= i + 1):
                    skip = flats[nodes[idx + 1].source][0]
                    consumed = 2
                y_f = conv(i, prev_flat, lay, skip=skip)
                out_i = i + consumed - 1
                flats[out_i] = (y_f, hw)
                prev, prev_flat, prev_hw = None, y_f, hw
                idx += consumed
                gc(out_i)
                continue

            # ---- NHWC fallback path (channels-last NCHW tensors)
            if prev is None:
                prev = nchw(prev_flat, prev_hw)
            if isinstance(node, ConvSpec):
                e = params[f"node_{i}"]
                # weight-only int8: cast the int8 kernel up, conv, then
                # rescale per channel and add the bias in fp32
                y = F.conv2d(prev.to(compute_dtype), e["w_q"].to(
                    compute_dtype), stride=node.stride, padding=node.pad)
                y = (y.float() * e["scale"][None, :, None, None]
                     + e["b"][None, :, None, None])
                if node.activation == "leaky":
                    y = torch.where(y > 0, y, 0.1 * y)
                out = y.to(compute_dtype)
            elif isinstance(node, MaxPoolSpec):
                out = _maxpool(prev, node)
            elif isinstance(node, UpsampleSpec):
                out = _upsample_bilinear(prev, node.stride)
            elif isinstance(node, RouteSpec):
                out = (as_nchw(node.sources[0]) if len(node.sources) == 1
                       else torch.cat([as_nchw(s) for s in node.sources],
                                      dim=1))
            elif isinstance(node, ShortcutSpec):
                out = prev + as_nchw(node.source)
            elif isinstance(node, YoloSpec):
                heads.append(prev.permute(0, 2, 3, 1).to(head_dtype)
                             .contiguous())
                out = prev
            else:  # pragma: no cover
                raise TypeError(node)
            outputs[i] = out
            prev, prev_flat = out, None
            prev_hw = res_of[i]
            idx += 1
            gc(i)
        return heads

    return forward
