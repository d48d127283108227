"""Native model zoo: YOLOv3 / YOLOv3-tiny defined programmatically.

The reference distributes architectures only as Darknet ``.cfg`` files
(cfg/yolov3.cfg: 108 blocks, cfg/yolov3-tiny.cfg: 25 blocks).  This zoo
builds the identical :class:`GraphSpec` graphs from structured Python —
Darknet-53's residual ladder is three nested loops, not 790 lines of cfg —
so the framework is self-contained without shipping copied cfg data.
``to_cfg_text`` serializes a spec back to the cfg DSL (parser round-trip
tested), and specs built from the reference cfg files are asserted equal
to these definitions when the reference is mounted.

Structural fidelity is checked against the parsed reference cfgs in
tests/test_cfg_parser.py::test_zoo_matches_reference_cfgs
(node-for-node).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..cfg_parser import (ConvSpec, GraphSpec, MaxPoolSpec, RouteSpec,
                          ShortcutSpec, UpsampleSpec, YoloSpec,
                          build_graph_spec)

__all__ = ["yolov3_spec", "yolov3_tiny_spec", "get_spec", "to_cfg_text"]

# COCO anchor priors (cfg/yolov3*.cfg [yolo] blocks)
V3_ANCHORS = ((10, 13), (16, 30), (33, 23), (30, 61), (62, 45), (59, 119),
              (116, 90), (156, 198), (373, 326))
TINY_ANCHORS = ((10, 14), (23, 27), (37, 58), (81, 82), (135, 169),
                (344, 319))


class _Builder:
    """Accumulates raw block dicts, then resolves via build_graph_spec."""

    def __init__(self, width=416, height=416, channels=3):
        self.blocks: List[Dict[str, str]] = [{
            "type": "net", "width": str(width), "height": str(height),
            "channels": str(channels), "batch": "1", "subdivisions": "1",
        }]

    @property
    def last(self) -> int:
        return len(self.blocks) - 2  # node index of the last layer

    def conv(self, filters: int, size: int = 3, stride: int = 1,
             bn: bool = True, activation: str = "leaky") -> int:
        blk = {"type": "convolutional", "filters": str(filters),
               "size": str(size), "stride": str(stride), "pad": "1",
               "activation": activation}
        if bn:
            blk["batch_normalize"] = "1"
        self.blocks.append(blk)
        return self.last

    def maxpool(self, size: int = 2, stride: int = 2) -> int:
        self.blocks.append({"type": "maxpool", "size": str(size),
                            "stride": str(stride)})
        return self.last

    def shortcut(self, frm: int) -> int:
        self.blocks.append({"type": "shortcut", "from": str(frm - self.last - 1),
                            "activation": "linear"})
        return self.last

    def route(self, *layers: int) -> int:
        rel = ",".join(str(l - self.last - 1) for l in layers)
        self.blocks.append({"type": "route", "layers": rel})
        return self.last

    def upsample(self, stride: int = 2) -> int:
        self.blocks.append({"type": "upsample", "stride": str(stride)})
        return self.last

    def yolo(self, anchors: Sequence[Tuple[int, int]], mask: Sequence[int],
             classes: int) -> int:
        flat = ",".join(f"{a},{b}" for a, b in anchors)
        self.blocks.append({
            "type": "yolo", "mask": ",".join(map(str, mask)),
            "anchors": flat, "classes": str(classes),
            "num": str(len(anchors)), "jitter": ".3",
            "ignore_thresh": ".7", "truth_thresh": "1", "random": "1",
        })
        return self.last

    def build(self) -> GraphSpec:
        return build_graph_spec(self.blocks)


def yolov3_tiny_spec(num_classes: int = 80, width: int = 416,
                     height: int = 416) -> GraphSpec:
    """YOLOv3-tiny: 13 convs, 6 maxpools, 2 detection scales."""
    b = _Builder(width, height)
    head_filters = 3 * (5 + num_classes)
    for f in (16, 32, 64, 128, 256):
        b.conv(f)
        b.maxpool(2, 2)
    b.conv(512)
    b.maxpool(2, 1)            # the stride-1 replicate-pad pool
    b.conv(1024)
    c13 = b.conv(256, size=1)  # node 13: route source for the second scale
    b.conv(512)
    b.conv(head_filters, size=1, bn=False, activation="linear")
    b.yolo(TINY_ANCHORS, (3, 4, 5), num_classes)
    b.route(c13)
    b.conv(128, size=1)
    b.upsample()
    b.route(b.last, 8)         # concat with the 256-ch backbone feature
    b.conv(256)
    b.conv(head_filters, size=1, bn=False, activation="linear")
    b.yolo(TINY_ANCHORS, (0, 1, 2), num_classes)
    return b.build()


def yolov3_spec(num_classes: int = 80, width: int = 416,
                height: int = 416) -> GraphSpec:
    """YOLOv3: Darknet-53 backbone + FPN-style 3-scale head."""
    b = _Builder(width, height)
    head_filters = 3 * (5 + num_classes)

    def residual(ch: int):
        entry = b.last
        b.conv(ch // 2, size=1)
        b.conv(ch)
        b.shortcut(entry)

    # Darknet-53: stem + (1, 2, 8, 8, 4) residual stages
    b.conv(32)
    stage_out = {}
    for ch, reps in ((64, 1), (128, 2), (256, 8), (512, 8), (1024, 4)):
        b.conv(ch, stride=2)
        for _ in range(reps):
            residual(ch)
        stage_out[ch] = b.last

    def head_tower(ch: int, concat_src: Optional[int]):
        """5-conv tower + detection conv; returns route point (4th conv)."""
        for i in range(3):
            b.conv(ch, size=1)
            route_pt = b.last if i == 2 else None
            b.conv(ch * 2)
        b.conv(head_filters, size=1, bn=False, activation="linear")
        return route_pt

    # scale 1 (13x13, large objects)
    rp = head_tower(512, None)
    b.yolo(V3_ANCHORS, (6, 7, 8), num_classes)
    # scale 2 (26x26)
    b.route(rp)
    b.conv(256, size=1)
    b.upsample()
    b.route(b.last, stage_out[512])
    rp = head_tower(256, None)
    b.yolo(V3_ANCHORS, (3, 4, 5), num_classes)
    # scale 3 (52x52, small objects)
    b.route(rp)
    b.conv(128, size=1)
    b.upsample()
    b.route(b.last, stage_out[256])
    head_tower(128, None)
    b.yolo(V3_ANCHORS, (0, 1, 2), num_classes)
    return b.build()


_ZOO = {
    "yolov3": yolov3_spec,
    "yolov3-tiny": yolov3_tiny_spec,
}


def resolve_spec(cfg_path_or_name: str, **kw) -> GraphSpec:
    """A ``.cfg`` file path or a zoo name -> GraphSpec (shared by every
    CLI and pipeline entry point)."""
    import os
    from ..cfg_parser import load_graph_spec
    if os.path.isfile(cfg_path_or_name):
        return load_graph_spec(cfg_path_or_name)
    return get_spec(cfg_path_or_name, **kw)


def get_spec(name: str, **kw) -> GraphSpec:
    """Look up a zoo model by name (accepts cfg-style paths too)."""
    key = name
    if key.endswith(".cfg"):
        key = key.rsplit("/", 1)[-1][:-4]
    if key not in _ZOO:
        raise KeyError(f"unknown model {name!r}; zoo has {sorted(_ZOO)}")
    return _ZOO[key](**kw)


def to_cfg_text(spec: GraphSpec) -> str:
    """Serialize a GraphSpec to Darknet cfg text (parser round-trip)."""
    lines: List[str] = ["[net]"]
    for k, v in spec.net.raw.items():
        if k != "type":
            lines.append(f"{k}={v}")
    for node in spec.nodes:
        lines.append("")
        if isinstance(node, ConvSpec):
            lines.append("[convolutional]")
            if node.batch_normalize:
                lines.append("batch_normalize=1")
            lines.append(f"filters={node.out_channels}")
            lines.append(f"size={node.kernel_size}")
            lines.append(f"stride={node.stride}")
            lines.append(f"pad={1 if node.pad else 0}")
            lines.append(f"activation={node.activation}")
        elif isinstance(node, MaxPoolSpec):
            lines.append("[maxpool]")
            lines.append(f"size={node.kernel_size}")
            lines.append(f"stride={node.stride}")
        elif isinstance(node, UpsampleSpec):
            lines.append("[upsample]")
            lines.append(f"stride={node.stride}")
        elif isinstance(node, RouteSpec):
            lines.append("[route]")
            rel = ",".join(str(s - node.index) for s in node.sources)
            lines.append(f"layers={rel}")
        elif isinstance(node, ShortcutSpec):
            lines.append("[shortcut]")
            lines.append(f"from={node.source - node.index}")
            lines.append(f"activation={node.activation}")
        elif isinstance(node, YoloSpec):
            lines.append("[yolo]")
            # emit the node's own anchors with an identity mask — parses to
            # the same resolved anchor set
            flat = ",".join(f"{a},{b}" for a, b in node.anchors)
            lines.append(f"mask={','.join(str(i) for i in range(len(node.anchors)))}")
            lines.append(f"anchors={flat}")
            lines.append(f"classes={node.num_classes}")
            lines.append(f"num={len(node.anchors)}")
    return "\n".join(lines) + "\n"
