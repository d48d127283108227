"""Native (C++) host letterbox, loaded with ctypes.

``letterbox.cpp`` is the port's copy of the JAX package's fixed-point
bicubic letterbox (cv2 INTER_CUBIC-compatible, threaded over images).  It
is built with g++ into ``build/torch_kernels/`` at first use.  A failed
build raises: ``host_prep="native"`` never falls back to cv2.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from ..buildlib import gxx_command, load_library

__all__ = ["load", "letterbox_batch_native", "resize_cubic_native"]

_U8P = ctypes.POINTER(ctypes.c_uint8)


def load() -> ctypes.CDLL:
    """ctypes handle to the native library, building it on first use."""
    lib = load_library("letterbox", ["native/letterbox.cpp"],
                       gxx_command("-pthread"))
    lib.letterbox_u8_batch.restype = None
    lib.letterbox_u8_batch.argtypes = [
        ctypes.POINTER(_U8P), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, _U8P, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.resize_cubic_u8_c.restype = None
    lib.resize_cubic_u8_c.argtypes = [
        _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _U8P, ctypes.c_int,
        ctypes.c_int]
    return lib


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


def resize_cubic_native(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """INTER_CUBIC-compatible u8 resize (HWC or HW)."""
    lib = load()
    img = np.ascontiguousarray(img, np.uint8)
    c = 1 if img.ndim == 2 else img.shape[2]
    out = np.empty((dh, dw, c) if img.ndim == 3 else (dh, dw), np.uint8)
    lib.resize_cubic_u8_c(_u8p(img), img.shape[0], img.shape[1], c,
                          _u8p(out), dh, dw)
    return out


def letterbox_batch_native(imgs, size: int, pad_value: int = 128,
                           swap_rb: bool = True,
                           round_extents: bool = False,
                           nthreads: Optional[int] = None) -> np.ndarray:
    """Letterbox a list of u8 BGR HWC images -> [N, size, size, 3] RGB
    (when ``swap_rb``) uint8, threaded across images."""
    lib = load()
    imgs = [np.ascontiguousarray(im, np.uint8) for im in imgs]
    for im in imgs:
        # letterbox_u8 assumes 3 interleaved channels; anything else would
        # read out of bounds in native code
        if im.ndim != 3 or im.shape[2] != 3:
            raise ValueError(
                f"letterbox_batch_native needs HWC 3-channel u8 images, "
                f"got shape {im.shape}")
    n = len(imgs)
    out = np.empty((n, size, size, 3), np.uint8)
    ptrs = (_U8P * n)(*[_u8p(im) for im in imgs])
    shs = (ctypes.c_int * n)(*[im.shape[0] for im in imgs])
    sws = (ctypes.c_int * n)(*[im.shape[1] for im in imgs])
    if nthreads is None:
        nthreads = min(n, os.cpu_count() or 1)
    lib.letterbox_u8_batch(ptrs, shs, sws, n, _u8p(out), size,
                           pad_value, 1 if swap_rb else 0,
                           1 if round_extents else 0, nthreads)
    return out
