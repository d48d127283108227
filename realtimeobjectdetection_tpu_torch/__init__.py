"""realtimeobjectdetection_tpu_torch — the PyTorch / CUDA port of
:mod:`realtimeobjectdetection_tpu` for an NVIDIA H100.

The JAX package stays the reference; this package imports nothing of it
and nothing of JAX.  Layer map of the ported slices (YOLOv3 folder
detection, in fp32/bf16 and in int8):

* :mod:`.cfg_parser`, :mod:`.models` — Darknet ``.cfg`` -> GraphSpec
* :mod:`.weights`    — ``.weights`` / state dicts -> OIHW tensors
* :mod:`.model`      — GraphSpec -> forward function of torch ops (NCHW);
  ``quantize="w8"``/``"w8a8"`` int8 convs in the same walk
* :mod:`.model_int8` — the ``quantize="w8a8_pallas"`` forward: eligible
  convs in the flat padded row layout through the w8a8 tap-matmul conv
* :mod:`.ops`        — decode, fixed-shape NMS (greedy suppression is the
  hand-written CUDA kernel in ``csrc/nms_kernel.cu``), letterbox;
  ``ops.quantize`` (int8 weights, the w8/w8a8 convs), ``ops.conv_int8``
  (the flat layout and the plain tap-matmul conv) and
  ``ops.cuda.conv_int8`` (its CUDA kernel, ``csrc/conv_int8.cu``)
* :mod:`.native`     — the C++ host letterbox, built with g++ on first use
* :mod:`.pipeline`   — the folder detector, rendering, ``metrics.json``
* :mod:`.cli`        — ``python -m realtimeobjectdetection_tpu_torch detect``
"""

__version__ = "0.1.0"

from .device import resolve_device  # noqa: F401
