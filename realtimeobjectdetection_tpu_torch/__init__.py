"""realtimeobjectdetection_tpu_torch — the PyTorch / CUDA port of
:mod:`realtimeobjectdetection_tpu` for an NVIDIA H100.

The JAX package stays the reference; this package imports nothing of it
and nothing of JAX.  Layer map of the ported slice (YOLOv3 folder
detection):

* :mod:`.cfg_parser`, :mod:`.models` — Darknet ``.cfg`` -> GraphSpec
* :mod:`.weights`    — ``.weights`` / state dicts -> OIHW tensors
* :mod:`.model`      — GraphSpec -> forward function of torch ops (NCHW)
* :mod:`.ops`        — decode, fixed-shape NMS (greedy suppression is the
  hand-written CUDA kernel in ``csrc/nms_kernel.cu``), letterbox
* :mod:`.native`     — the C++ host letterbox, built with g++ on first use
* :mod:`.pipeline`   — the folder detector, rendering, ``metrics.json``
* :mod:`.cli`        — ``python -m realtimeobjectdetection_tpu_torch detect``
"""

__version__ = "0.1.0"

from .device import resolve_device  # noqa: F401
