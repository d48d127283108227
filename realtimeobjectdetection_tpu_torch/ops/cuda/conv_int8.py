"""The w8a8 tap-matmul conv: the CUDA kernel's wrapper.

The kernel (``csrc/conv_int8.cu``) replaces the JAX package's TPU kernel
``ops/pallas/conv_int8.py:conv_flat_int8``.  :func:`conv_flat_int8`
launches it for CUDA tensors and takes the plain version
(``ops/conv_int8.conv_flat_int8_plain``) only for tensors on the CPU.  The
tests hold the plain version against the JAX package on the CPU and
``chip_smoke.py`` holds the kernel against it on the card, bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ...buildlib import load_library, nvcc_command
from ..conv_int8 import FlatLayout, conv_flat_int8_plain

__all__ = ["conv_flat_int8", "build"]

# -fmad=false: no product may contract into an FMA, so the fp32 epilogue
# rounds where the plain version rounds
_FLAGS = ("-fmad=false",)
_TYPES = (torch.bfloat16, torch.float32)


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile (first use) and load the kernel library, once a process."""
    lib = load_library("conv_int8", ["csrc/conv_int8.cu"],
                       nvcc_command(*_FLAGS))
    lib.conv_int8_launch.restype = ctypes.c_int
    lib.conv_int8_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 12 + [ctypes.c_void_p])
    lib.conv_int8_row_tile.restype = ctypes.c_int
    lib.conv_int8_row_tile.argtypes = []
    return lib


def conv_flat_int8(x_flat: torch.Tensor, w_packed: torch.Tensor,
                   s_w: torch.Tensor, bias: torch.Tensor, lay: FlatLayout,
                   k: int = 3, act: str = "leaky",
                   skip: Optional[torch.Tensor] = None,
                   out_dtype=torch.bfloat16) -> torch.Tensor:
    """One w8a8 stride-1 conv over the flat layout (arguments as
    :func:`..conv_int8.conv_flat_int8_plain`).

    On CUDA tensors this launches the kernel or raises: ``x_flat`` bf16
    (out bf16 or fp32) or fp32 (out fp32), ``skip`` of ``x_flat``'s type,
    every tensor contiguous, ``lay.tm`` a multiple of the kernel's 128-row
    tile.
    ``conv_flat_int8.launches`` counts the launches.
    """
    if x_flat.device.type == "cpu":
        return conv_flat_int8_plain(x_flat, w_packed, s_w, bias, lay, k=k,
                                    act=act, skip=skip, out_dtype=out_dtype)
    if x_flat.device.type != "cuda":
        raise ValueError(f"conv_flat_int8: unsupported device "
                         f"{x_flat.device}")
    if k not in (1, 3) or act not in ("leaky", "linear"):
        raise ValueError(f"k must be 1 or 3 and act leaky or linear, got "
                         f"k={k}, act={act!r}")
    if x_flat.dtype not in _TYPES or out_dtype not in _TYPES \
            or (x_flat.dtype, out_dtype) == (torch.float32, torch.bfloat16):
        raise ValueError(f"conv_flat_int8 takes bf16 -> bf16 or fp32, or "
                         f"fp32 -> fp32, got {x_flat.dtype} -> {out_dtype}")
    if x_flat.dim() != 2 or w_packed.dim() != 3:
        raise ValueError("x_flat must be [R, C_in] and w_packed "
                         "[k*k, C_out, C_in]")
    rows, cin = x_flat.shape
    taps, cout, wcin = w_packed.shape
    if taps != k * k or wcin != cin or rows != lay.rows:
        raise ValueError(f"conv_flat_int8: x {tuple(x_flat.shape)}, w "
                         f"{tuple(w_packed.shape)} do not fit k={k}, {lay}")
    checks = [("x_flat", x_flat, x_flat.dtype, (rows, cin)),
              ("w_packed", w_packed, torch.int8, (taps, cout, cin)),
              ("s_w", s_w, torch.float32, (cout,)),
              ("bias", bias, torch.float32, (cout,))]
    if skip is not None:
        checks.append(("skip", skip, x_flat.dtype, (rows, cout)))
    for name, t, dt, shape in checks:
        if t.device != x_flat.device or t.dtype != dt \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous {dt} tensor of shape {shape} "
                f"on {x_flat.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    lib = build()
    tile = lib.conv_int8_row_tile()
    if lay.tm % tile or lay.tm % lay.gr:
        raise ValueError(f"conv_flat_int8 kernel needs tm a multiple of "
                         f"{tile} and of gr, got {lay}")
    y = torch.empty((rows, cout), dtype=out_dtype, device=x_flat.device)
    chunk_max = torch.empty((rows // lay.gr,), dtype=torch.float32,
                            device=x_flat.device)
    with torch.cuda.device(x_flat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.conv_int8_launch(
            x_flat.data_ptr(), w_packed.data_ptr(), s_w.data_ptr(),
            bias.data_ptr(), skip.data_ptr() if skip is not None else None,
            chunk_max.data_ptr(), y.data_ptr(), rows, cin, cout, k,
            int(act == "leaky"), lay.b, lay.h, lay.w, lay.tm, lay.gr,
            int(x_flat.dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"conv_flat_int8 kernel launch failed: CUDA "
                           f"error {err}")
    conv_flat_int8.launches += 1
    return y


conv_flat_int8.launches = 0
