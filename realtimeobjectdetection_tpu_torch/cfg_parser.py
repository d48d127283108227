"""Darknet ``.cfg`` DSL -> typed, framework-free graph specification.

The reference builds an ``nn.ModuleList`` directly while parsing
(src/darknet.py:412-533).  Here we instead compile the cfg
into a pure-data :class:`GraphSpec` with static shapes and channel counts
fully resolved at parse time.  A separate compiler (:mod:`..model`) walks
the spec into a forward function of PyTorch ops.  This module is a copy of
the JAX package's ``cfg_parser`` so that the port imports nothing of it.

Semantics matched against the reference (file:line cited per node type):

* ``[convolutional]`` — conv (+ optional BatchNorm + LeakyReLU(0.1));
  pad = (k-1)//2 when ``pad=1``; bias only when no BN
  (src/darknet.py:467-501).
* ``[upsample]``      — bilinear x2, ``align_corners=False``
  (src/darknet.py:587-593; the nearest-neighbour class there is dead code).
* ``[route]``         — channel concat of one or two earlier outputs
  (src/darknet.py:562-585).
* ``[shortcut]``      — elementwise add with ``from`` output
  (src/darknet.py:557-560, 263-268).
* ``[maxpool]``       — stride!=1: plain maxpool; stride==1: replicate-pad
  right/bottom by k-1 then pool with stride k-1 (src/darknet.py:17-46,
  547-555 — note the reference pools with stride ``k-1``, not 1).
* ``[yolo]``          — anchor subset selected by ``mask``
  (src/darknet.py:535-545).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

__all__ = [
    "ConvSpec",
    "UpsampleSpec",
    "RouteSpec",
    "ShortcutSpec",
    "MaxPoolSpec",
    "YoloSpec",
    "NetInfo",
    "GraphSpec",
    "parse_cfg_blocks",
    "build_graph_spec",
    "load_graph_spec",
]


# ---------------------------------------------------------------------------
# Raw block parsing
# ---------------------------------------------------------------------------

def parse_cfg_blocks(text: str) -> List[Dict[str, str]]:
    """Parse cfg text into a list of ``{"type": ..., key: value}`` dicts.

    Mirrors the tolerant line handling of the reference parser
    (src/darknet.py:428-447): blank lines and ``#`` comment lines are
    dropped, keys/values are stripped of surrounding whitespace.
    """
    blocks: List[Dict[str, str]] = []
    block: Dict[str, str] = {}
    for raw in text.split("\n"):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("["):
            if block:
                blocks.append(block)
            block = {"type": line[1:-1].strip()}
        else:
            key, _, value = line.partition("=")
            block[key.strip()] = value.strip()
    if block:
        blocks.append(block)
    return blocks


# ---------------------------------------------------------------------------
# Typed node specs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ConvSpec:
    index: int
    in_channels: int
    out_channels: int
    kernel_size: int
    stride: int
    pad: int
    batch_normalize: bool
    activation: str  # "leaky" | "linear"

    @property
    def has_bias(self) -> bool:
        return not self.batch_normalize

    @property
    def num_params(self) -> int:
        k = self.kernel_size
        n = self.out_channels * self.in_channels * k * k
        n += self.out_channels * (4 if self.batch_normalize else 1)
        return n


@dataclasses.dataclass(frozen=True)
class UpsampleSpec:
    index: int
    channels: int
    stride: int = 2
    mode: str = "bilinear"  # parity with nn.Upsample(align_corners=False)


@dataclasses.dataclass(frozen=True)
class RouteSpec:
    index: int
    sources: Tuple[int, ...]  # absolute node indices to concat (channel axis)
    channels: int


@dataclasses.dataclass(frozen=True)
class ShortcutSpec:
    index: int
    source: int  # absolute node index added to previous output
    channels: int
    activation: str = "linear"


@dataclasses.dataclass(frozen=True)
class MaxPoolSpec:
    index: int
    channels: int
    kernel_size: int
    stride: int  # cfg stride; stride==1 triggers the replicate-pad variant


@dataclasses.dataclass(frozen=True)
class YoloSpec:
    index: int
    anchors: Tuple[Tuple[int, int], ...]  # mask-selected anchor subset
    num_classes: int
    channels: int


Node = object  # union of the specs above


@dataclasses.dataclass(frozen=True)
class NetInfo:
    width: int
    height: int
    channels: int
    raw: Dict[str, str]


@dataclasses.dataclass(frozen=True)
class GraphSpec:
    """A fully-resolved Darknet graph: nodes in topological (cfg) order."""

    net: NetInfo
    nodes: Tuple[Node, ...]

    @property
    def yolo_nodes(self) -> List[YoloSpec]:
        return [n for n in self.nodes if isinstance(n, YoloSpec)]

    @property
    def conv_nodes(self) -> List[ConvSpec]:
        return [n for n in self.nodes if isinstance(n, ConvSpec)]

    @property
    def num_classes(self) -> int:
        yolos = self.yolo_nodes
        return yolos[0].num_classes if yolos else 0

    @property
    def anchors_in_detection_order(self) -> List[Tuple[int, int]]:
        """Anchors concatenated in yolo-node order.

        Matches ``Darknet.forward`` capturing ``self.anchors`` scale by
        scale (src/darknet.py:239,243) — the trainer consumes this order.
        """
        out: List[Tuple[int, int]] = []
        for y in self.yolo_nodes:
            out.extend(y.anchors)
        return out

    def live_after(self) -> List[int]:
        """For each node i, the last node index that reads output i.

        Used by the model compiler to free intermediate activations as the
        traced walk proceeds (the reference instead caches *every* layer
        output in a dict: src/darknet.py:199-303).
        """
        last_use = [i for i in range(len(self.nodes))]
        for n in self.nodes:
            srcs: Sequence[int]
            if isinstance(n, RouteSpec):
                srcs = n.sources
            elif isinstance(n, ShortcutSpec):
                srcs = (n.source, n.index - 1)
            else:
                srcs = (n.index - 1,) if n.index > 0 else ()
            for s in srcs:
                if s >= 0:
                    last_use[s] = max(last_use[s], n.index)
        return last_use


# ---------------------------------------------------------------------------
# Spec builder (channel inference)
# ---------------------------------------------------------------------------

def build_graph_spec(blocks: List[Dict[str, str]]) -> GraphSpec:
    """Resolve a raw block list into a typed GraphSpec.

    One-pass channel inference replaces the reference's build-time
    ``prev_filters``/``output_filters`` bookkeeping (src/darknet.py:449-533).
    """
    if not blocks or blocks[0]["type"] not in ("net", "network"):
        raise ValueError("cfg must start with a [net] block")

    netblk = blocks[0]
    net = NetInfo(
        width=int(netblk.get("width", 416)),
        height=int(netblk.get("height", 416)),
        channels=int(netblk.get("channels", 3)),
        raw=dict(netblk),
    )

    nodes: List[Node] = []
    out_channels: List[int] = []  # per node
    prev = net.channels

    for i, blk in enumerate(blocks[1:]):
        btype = blk["type"]
        if btype == "convolutional":
            bn = bool(int(blk.get("batch_normalize", 0)))
            filters = int(blk["filters"])
            k = int(blk["size"])
            stride = int(blk["stride"])
            pad = (k - 1) // 2 if int(blk.get("pad", 0)) else 0
            node: Node = ConvSpec(
                index=i,
                in_channels=prev,
                out_channels=filters,
                kernel_size=k,
                stride=stride,
                pad=pad,
                batch_normalize=bn,
                activation=blk.get("activation", "linear"),
            )
            ch = filters
        elif btype == "upsample":
            node = UpsampleSpec(index=i, channels=prev,
                                stride=int(blk.get("stride", 2)))
            ch = prev
        elif btype == "route":
            layers = [int(x) for x in blk["layers"].split(",")]
            sources = tuple(l if l >= 0 else i + l for l in layers)
            for s in sources:
                if not 0 <= s < i:
                    raise ValueError(f"route at node {i} references {s}")
            ch = sum(out_channels[s] for s in sources)
            node = RouteSpec(index=i, sources=sources, channels=ch)
        elif btype == "shortcut":
            frm = int(blk["from"])
            src = frm if frm >= 0 else i + frm
            if not 0 <= src < i:
                raise ValueError(f"shortcut at node {i} references {src}")
            ch = prev
            node = ShortcutSpec(index=i, source=src, channels=ch,
                                activation=blk.get("activation", "linear"))
        elif btype == "maxpool":
            node = MaxPoolSpec(index=i, channels=prev,
                               kernel_size=int(blk["size"]),
                               stride=int(blk["stride"]))
            ch = prev
        elif btype == "yolo":
            mask = [int(x) for x in blk["mask"].split(",")]
            flat = [int(a) for a in blk["anchors"].split(",")]
            pairs = [(flat[j], flat[j + 1]) for j in range(0, len(flat), 2)]
            anchors = tuple(pairs[m] for m in mask)
            node = YoloSpec(index=i, anchors=anchors,
                            num_classes=int(blk["classes"]), channels=prev)
            ch = prev  # reference: outputs[i] = outputs[i-1] (darknet.py:247)
        else:
            raise ValueError(f"unknown block type {btype!r} at node {i}")

        nodes.append(node)
        out_channels.append(ch)
        prev = ch

    return GraphSpec(net=net, nodes=tuple(nodes))


def load_graph_spec(cfg_path: str) -> GraphSpec:
    with open(cfg_path, "r") as f:
        return build_graph_spec(parse_cfg_blocks(f.read()))
