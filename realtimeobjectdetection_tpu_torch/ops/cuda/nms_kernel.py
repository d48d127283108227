"""Greedy same-class NMS suppression: the CUDA kernel and its plain version.

The kernel (``csrc/nms_kernel.cu``) replaces the JAX package's TPU kernel
``ops/pallas/nms_kernel.py:nms_suppress_pallas``.  :func:`nms_suppress`
launches it for CUDA tensors and takes :func:`nms_suppress_plain` only for
tensors on the CPU.  The plain version is the port of the JAX package's
``_greedy_suppress(algorithm="scan")``: the tests hold it against JAX on
the CPU and ``chip_smoke.py`` holds the kernel against it on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...buildlib import load_library, nvcc_command
from ..boxes import iou_matrix

__all__ = ["nms_suppress", "nms_suppress_plain", "build"]

# -fmad=false: no product may contract into an FMA, or IoUs that sit
# exactly at the threshold could round the other way than the reference
_FLAGS = ("-fmad=false",)


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile (first use) and load the kernel library, once a process."""
    lib = load_library("nms_kernel", ["csrc/nms_kernel.cu"],
                       nvcc_command(*_FLAGS))
    lib.nms_suppress_launch.restype = ctypes.c_int
    lib.nms_suppress_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.nms_suppress_max_k.restype = ctypes.c_int
    lib.nms_suppress_max_k.argtypes = []
    return lib


def nms_suppress_plain(corners: torch.Tensor, cls_id: torch.Tensor,
                       valid: torch.Tensor, thresh: float,
                       plus_one: bool = True, ge: bool = True) -> torch.Tensor:
    """Greedy suppression as a K-step masked loop over a dense
    ``[B, K, K]`` suppression matrix (the JAX package's scan oracle)."""
    k = corners.shape[-2]
    ious = iou_matrix(corners, corners, plus_one=plus_one)
    t = torch.tensor(thresh, dtype=torch.float32, device=corners.device)
    hit = (ious >= t) if ge else (ious > t)
    same_class = cls_id[..., :, None] == cls_id[..., None, :]
    later = torch.triu(torch.ones(k, k, dtype=torch.bool,
                                  device=corners.device), diagonal=1)
    suppress = hit & same_class & later
    keep = valid.clone()
    for i in range(k):
        keep &= ~(suppress[..., i, :] & keep[..., i:i + 1])
    return keep


def nms_suppress(corners: torch.Tensor, cls_id: torch.Tensor,
                 valid: torch.Tensor, thresh: float, plus_one: bool = True,
                 ge: bool = True) -> torch.Tensor:
    """Greedy same-class suppression over ``[B, K]`` candidates.

    Args:
      corners: [B, K, 4] float32 xyxy, objectness-descending per image.
      cls_id:  [B, K] int32 class ids.
      valid:   [B, K] bool candidate validity.
    Returns:
      keep: [B, K] bool survivors.

    On CUDA tensors this launches the kernel (K <= 1024) or raises;
    ``nms_suppress.launches`` counts the launches.
    """
    if corners.device.type == "cpu":
        return nms_suppress_plain(corners, cls_id, valid, thresh,
                                  plus_one=plus_one, ge=ge)
    if corners.device.type != "cuda":
        raise ValueError(f"nms_suppress: unsupported device {corners.device}")
    if corners.dim() != 3 or corners.shape[-1] != 4:
        raise ValueError(
            f"corners must be [B, K, 4], got {tuple(corners.shape)}")
    b, k = corners.shape[:2]
    for name, t, dt in (("corners", corners, torch.float32),
                        ("cls_id", cls_id, torch.int32),
                        ("valid", valid, torch.bool)):
        if t.device != corners.device or t.dtype != dt \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} tensor on "
                             f"{corners.device}, got {t.dtype} on {t.device}")
    if cls_id.shape != (b, k) or valid.shape != (b, k):
        raise ValueError("cls_id and valid must be [B, K]")
    lib = build()
    if not 1 <= k <= lib.nms_suppress_max_k():
        raise ValueError(f"nms_suppress kernel takes 1 <= K <= "
                         f"{lib.nms_suppress_max_k()}, got K={k}")
    keep = torch.empty((b, k), dtype=torch.bool, device=corners.device)
    if b == 0:
        return keep
    with torch.cuda.device(corners.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.nms_suppress_launch(
            corners.data_ptr(), cls_id.data_ptr(), valid.data_ptr(),
            keep.data_ptr(), b, k, float(thresh), int(plus_one), int(ge),
            stream)
    if err != 0:
        raise RuntimeError(f"nms_suppress kernel launch failed: CUDA error "
                           f"{err}")
    nms_suppress.launches += 1
    return keep


nms_suppress.launches = 0
