"""Int8 quantization of BN-folded conv kernels, and the two XLA-free int8
conv modes of ``make_forward(quantize=...)``.

The port of the JAX package's ``ops/quantize.py``, over OIHW kernels:

* :func:`quantize_folded_int8` — per-output-channel symmetric int8
  quantization of BN-folded kernels (fold first: quantizing raw kernels
  and then folding would bake the BN scale into the int8 grid twice);
* ``"w8"`` (:func:`conv_w8`) weight-only int8: the int8 kernel is cast to
  the compute dtype inside the conv and the per-channel scale is applied
  to the conv *output*.  Numerics drift = weight rounding only.
* ``"w8a8"`` (:func:`conv_w8a8`) full int8: activations are quantized
  per tensor (symmetric, abs-max), the conv sums the int8 products
  exactly, and the output is rescaled by ``s_x * s_w``.

The third mode, ``"w8a8_pallas"``, is :mod:`..model_int8` over the
hand-written tap-matmul kernel.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..cfg_parser import GraphSpec

__all__ = ["quantize_folded_int8", "conv_w8", "conv_w8a8"]


def quantize_folded_int8(spec: GraphSpec, folded: Dict) -> Dict:
    """Quantize BN-folded conv params to per-output-channel int8.

    Args:
      spec: the graph spec (conv traversal order).
      folded: ``fold_batchnorm`` output — {node_i: {"w": OIHW f32,
        "b": [O] f32}}.

    Returns:
      {node_i: {"w_q": OIHW int8, "scale": [O] f32, "b": [O] f32}}.
    """
    out = {}
    for node in spec.conv_nodes:
        key = f"node_{node.index}"
        w = folded[key]["w"].float()
        amax = w.abs().amax(dim=(1, 2, 3))
        # a tensor divisor: a true division on every device (on CUDA,
        # torch turns a division by a Python number into a product)
        scale = torch.clamp(amax, min=1e-12) / torch.full_like(amax, 127.0)
        # torch.round rounds half to even, as jnp.round does
        w_q = torch.clamp(torch.round(w / scale[:, None, None, None]),
                          -127, 127).to(torch.int8)
        out[key] = {"w_q": w_q, "scale": scale,
                    "b": folded[key]["b"].float()}
    return out


def conv_w8(x, w_q, scale, stride: int, pad: int, compute_dtype):
    """Weight-only int8 conv (NCHW): int8 kernel cast to the compute
    dtype, fp32 output rescaled per channel."""
    y = F.conv2d(x.to(compute_dtype), w_q.to(compute_dtype),
                 stride=stride, padding=pad)
    return y.float() * scale[None, :, None, None]


def conv_w8a8(x, w_q, scale, stride: int, pad: int):
    """Full int8 conv (NCHW): dynamic per-tensor activation quantization,
    exact integer accumulation, fp32 rescale.

    This mode is for parity with the JAX package, not for speed: the
    int8 products are summed by a float64 conv, which is exact because
    every partial sum is an integer far below 2**53 (fp32 is not:
    9 * 1024 * 127**2 is above 2**24).  The fast int8 path is
    ``quantize="w8a8_pallas"``.
    """
    amax = torch.clamp(x.abs().amax(), min=1e-12)
    s_x = amax / torch.full_like(amax, 127.0)
    x_q = torch.clamp(torch.round(x / s_x), -127, 127).to(torch.int8)
    acc = F.conv2d(x_q.double(), w_q.double(), stride=stride, padding=pad)
    return acc.float() * (s_x * scale)[None, :, None, None]
