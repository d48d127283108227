"""Built-in class-name tables (COCO-80, VOC-20) + names-file loader.

The reference ships these as ``data/coco.names`` / ``data/voc.names`` and
loads them with ``load_classes`` (src/util.py:400-411).
The tables are public dataset metadata; embedding them makes the package
self-contained, and ``load_classes`` keeps file-based parity.
"""

from __future__ import annotations

from typing import List

__all__ = ["COCO80", "VOC20", "load_classes"]

COCO80: List[str] = [
    "person", "bicycle", "car", "motorbike", "aeroplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep",
    "cow", "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "sofa", "pottedplant", "bed", "diningtable", "toilet", "tvmonitor",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush",
]

VOC20: List[str] = [
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]


def load_classes(names_file_path: str) -> List[str]:
    """Newline-split names file, dropping the trailing empty entry
    (parity: src/util.py:400-411)."""
    with open(names_file_path, "r") as fp:
        return fp.read().split("\n")[:-1]
