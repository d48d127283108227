"""Box rendering on original images (cv2), reference-style.

Replicates the drawing protocol of ``Darknetv3Detector.box_write``
(detect.py:196-216): 1px rectangle, filled label bar,
``"{class} {conf:.4}"`` text.  Colors come from a deterministic generated
palette instead of the reference's ``weights/pallete`` pickle +
``random.choice`` (detect.py:112, 208) — same visual protocol, stable
output (documented quirk-compat deviation; only rendered JPEGs differ).
A copy of the JAX package's module; cv2 is imported where it is used.
"""

from __future__ import annotations

import colorsys
from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["make_palette", "draw_detection"]


def make_palette(n: int = 100) -> List[Tuple[int, int, int]]:
    """n visually-spread BGR color tuples (golden-ratio hue walk)."""
    colors = []
    h = 0.0
    for i in range(n):
        h = (h + 0.61803398875) % 1.0
        s = 0.65 + 0.35 * ((i // 7) % 2)
        v = 0.8 + 0.2 * ((i // 3) % 2)
        r, g, b = colorsys.hsv_to_rgb(h, s, v)
        colors.append((int(b * 255), int(g * 255), int(r * 255)))
    return colors


def draw_detection(img: np.ndarray, box: Sequence[float], class_name: str,
                   class_conf: float, color: Tuple[int, int, int]) -> np.ndarray:
    """Draw one detection (in-place) following the reference protocol."""
    import cv2
    c1 = (int(box[0]), int(box[1]))
    c2 = (int(box[2]), int(box[3]))
    label = "{0} {1:.4}".format(class_name, float(class_conf))
    cv2.rectangle(img, c1, c2, color, 1)
    t_size = cv2.getTextSize(label, cv2.FONT_HERSHEY_PLAIN, 1, 1)[0]
    c2b = (c1[0] + t_size[0] + 3, c1[1] + t_size[1] + 4)
    cv2.rectangle(img, c1, c2b, color, -1)
    cv2.putText(img, label, (c1[0], c1[1] + t_size[1] + 4),
                cv2.FONT_HERSHEY_DUPLEX, 0.5, [225, 255, 255], 1)
    return img
