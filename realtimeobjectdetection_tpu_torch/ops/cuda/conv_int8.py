"""The w8a8 tap-matmul conv: the CUDA kernel's wrapper and launch plan.

The kernel (``csrc/conv_int8.cu``) replaces the JAX package's TPU kernel
``ops/pallas/conv_int8.py:conv_flat_int8``.  :func:`conv_flat_int8`
launches it for CUDA tensors and takes the plain version
(``ops/conv_int8.conv_flat_int8_plain``) only for tensors on the CPU.  The
tests hold the plain version against the JAX package on the CPU and
``chip_smoke.py`` holds the kernel against it on the card, bit for bit.

:func:`plan` picks the kernel's tiling from the shapes alone (the C_in
slice per pipeline stage, the number of stages, the split of the
(tap, slice) loop, the scratch buffer), so the CPU tests can check it.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ...buildlib import load_library, nvcc_command
from ..conv_int8 import FlatLayout, conv_flat_int8_plain

__all__ = ["conv_flat_int8", "build", "plan", "ConvPlan", "ring_bytes",
           "smem_bytes"]

# -fmad=false: no product may contract into an FMA, so the fp32 epilogue
# rounds where the plain version rounds; -Xptxas -v: registers, shared
# memory and spills of each kernel into the build log
_FLAGS = ("-fmad=false", "-Xptxas", "-v")
_TYPES = (torch.bfloat16, torch.float32)

# The kernel's geometry (conv_int8_geometry in the source)
ROW_TILE = 128                # output rows per tile
COL_TILE = 128                # output channels per tile
SMEM_LIMIT = 232448           # shared memory a block may use on Hopper
SMEM_EXTRA = 1024 + 1536      # alignment, s_w and bias, barriers
MAX_STAGES = 10
MAX_PARTS = 8                 # chunk max parts per gr-row chunk
_ALIGN = 256


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def ring_bytes(x_bytes: int, y_bytes: int) -> int:
    """The pipeline ring: the 32 KB steps that fit beside the output and
    skip tiles (128 x 128 of the output's and the input's type)."""
    tiles = ROW_TILE * COL_TILE * (x_bytes + y_bytes)
    return (SMEM_LIMIT - SMEM_EXTRA - tiles) // 32768 * 32768


def smem_bytes(x_bytes: int, y_bytes: int) -> int:
    """The conv kernel's dynamic shared memory."""
    return ring_bytes(x_bytes, y_bytes) \
        + ROW_TILE * COL_TILE * (x_bytes + y_bytes) + SMEM_EXTRA


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """How the kernel runs one conv (all sizes from the shapes)."""
    cq: int            # channels of Q and of the weight rows (C_in to 16)
    bk: int            # bytes of C_in per stage: 64 or 128
    slices: int        # C_in slices per tap
    iters: int         # (tap, slice) steps: k*k*slices
    stages: int        # ring stages
    splits: int        # parts of the (tap, slice) loop
    parts: int         # chunk max parts per gr-row chunk
    blocks: int        # persistent blocks of the conv kernel
    row_tiles: int     # 128-row tiles over all R rows
    col_tiles: int     # 128-channel tiles
    work_tiles: int    # tiles with a content row, times col_tiles
    halo: int          # rows of halo on each side of a Q window
    q_rows: int        # rows of Q: (nb - 2) windows of tm + 2*halo
    offsets: Tuple[int, ...]  # chunk_max, blk_amax, counters, q, ws
    scratch_bytes: int

    @property
    def n_tiles(self) -> int:
        return self.row_tiles * self.col_tiles

    def split_range(self, s: int) -> Tuple[int, int]:
        """The (tap, slice) steps ``[lo, hi)`` of split ``s``, as the kernel
        computes them."""
        return self.iters * s // self.splits, \
            self.iters * (s + 1) // self.splits


@functools.lru_cache(maxsize=None)
def plan(lay: FlatLayout, k: int, cin: int, cout: int, sms: int = 132,
         x_bytes: int = 2, y_bytes: int = 2) -> ConvPlan:
    """The kernel's plan for one conv on a card with ``sms`` SMs, for
    inputs and outputs of ``x_bytes`` and ``y_bytes`` an element.

    128-byte C_in slices (64-byte where C_in <= 64) fill the ring
    (:func:`ring_bytes`).  Where the tiles that hold content are fewer than
    the SMs, the
    (tap, slice) loop is halved while that leaves each part at least two
    steps: the split parts of a tile run on other SMs and the last to
    finish adds them up.  One persistent block per SM walks the units
    (tile, split).  The chunk max runs in up to 8 parts per chunk where
    the chunks are fewer than two per SM."""
    cq = _round_up(cin, 16)
    bk = 64 if cq <= 64 else 128
    slices = -(-cq // bk)
    iters = k * k * slices
    stages = ring_bytes(x_bytes, y_bytes) // ((ROW_TILE + COL_TILE) * bk)
    row_tiles = lay.rows // ROW_TILE
    col_tiles = -(-cout // COL_TILE)
    content = -(-(lay.tm + lay.p) // ROW_TILE) - lay.tm // ROW_TILE
    work = content * col_tiles
    splits = 1
    while work * splits < sms and iters // (2 * splits) >= 2:
        splits *= 2
    chunks = lay.rows // lay.gr
    parts = max(1, min(MAX_PARTS, -(-2 * sms // chunks),
                       lay.gr * cin // 2048))
    halo = lay.gr if k == 3 else 0
    q_rows = (lay.nb - 2) * (lay.tm + 2 * halo)
    n_tiles = row_tiles * col_tiles
    sizes = [4 * chunks * parts, 4 * (lay.nb - 2),
             4 * n_tiles if splits > 1 else 0, q_rows * cq,
             4 * splits * n_tiles * ROW_TILE * COL_TILE if splits > 1 else 0]
    offsets, at = [], 0
    for size in sizes:
        offsets.append(at)
        at += _round_up(size, _ALIGN)
    return ConvPlan(cq=cq, bk=bk, slices=slices, iters=iters, stages=stages,
                    splits=splits, parts=parts,
                    blocks=min(work * splits, sms), row_tiles=row_tiles,
                    col_tiles=col_tiles, work_tiles=work,
                    halo=halo, q_rows=q_rows,
                    offsets=tuple(offsets), scratch_bytes=at)


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile (first use) and load the kernel library, once a process."""
    lib = load_library("conv_int8", ["csrc/conv_int8.cu"],
                       nvcc_command(*_FLAGS))
    lib.conv_int8_launch.restype = ctypes.c_int
    lib.conv_int8_launch.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 17 + [ctypes.c_void_p])
    lib.conv_int8_geometry.restype = ctypes.c_int
    lib.conv_int8_geometry.argtypes = [ctypes.c_int]
    geometry = [lib.conv_int8_geometry(i) for i in range(8)]
    pairs = ((2, 2), (2, 4), (4, 4))
    if geometry != [ROW_TILE, COL_TILE] + [ring_bytes(*t) for t in pairs] \
            + [smem_bytes(*t) for t in pairs]:
        raise RuntimeError(f"conv_int8: the library's geometry {geometry} "
                           f"is not the plan's")
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    dev = x_flat.device
    if dev.type == "cpu":
        return conv_flat_int8_plain(x_flat, w_packed, s_w, bias, lay, k=k,
                                    act=act, skip=skip, out_dtype=out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"conv_flat_int8: unsupported device {dev}")
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
    # device indices and torch.Size compare without building objects: the
    # checks run on every call, 67 a forward
    index = x_flat.get_device()
    for name, t, dt, shape in checks:
        if t.get_device() != index or t.dtype != dt or t.shape != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous {dt} tensor of shape {shape} "
                f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if lay.tm % ROW_TILE or lay.tm % lay.gr or (k == 3 and lay.gr < lay.g):
        raise ValueError(f"conv_flat_int8 kernel needs tm a multiple of "
                         f"{ROW_TILE} and of gr, gr >= W + 3, got {lay}")
    lib = build()
    pl = plan(lay, k, cin, cout, _sm_count(index), x_flat.element_size(),
              2 if out_dtype == torch.bfloat16 else 4)
    if pl.cq != cin:  # TMA rows are multiples of 16 bytes
        w_packed = F.pad(w_packed, (0, pl.cq - cin))
    y = torch.empty((rows, cout), dtype=out_dtype, device=dev)
    scratch = torch.empty((pl.scratch_bytes,), dtype=torch.uint8, device=dev)
    base = scratch.data_ptr()
    # entering the device's context costs about as much as a launch: only
    # where the tensors are not on the current device
    with (contextlib.nullcontext() if torch.cuda.current_device() == index
          else torch.cuda.device(index)):
        err = lib.conv_int8_launch(
            x_flat.data_ptr(), w_packed.data_ptr(), s_w.data_ptr(),
            bias.data_ptr(), skip.data_ptr() if skip is not None else None,
            *[base + o for o in pl.offsets[:4]],
            base + pl.offsets[4] if pl.splits > 1 else None, y.data_ptr(),
            rows, cin, cout, k, int(act == "leaky"), lay.b, lay.h, lay.w,
            lay.tm, lay.gr, int(x_flat.dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16), pl.cq, pl.bk, pl.splits,
            pl.parts, pl.blocks, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv_flat_int8 kernel launch failed: CUDA "
                           f"error {err}")
    conv_flat_int8.launches += 1
    return y


conv_flat_int8.launches = 0
