"""The flat padded row layout of the int8 tap-matmul conv, and the plain
PyTorch version of that conv.

The port of the JAX package's ``ops/pallas/conv_int8.py`` minus Pallas.
A stride-1 conv is a sum of tap matmuls,

    conv3x3(x, w)[p] = sum_t  x[p + o_t] @ w[t]      (9 taps)

over a **flat padded row layout**: NHWC activations are zero-padded to
[B, H+2, W+2, C] and flattened to rows of C channels, so a spatial tap
(dy, dx) is the constant row offset ``o_t = dy*(W+2) + dx``.  Rows
0..R-1 with R = nb*tm; content pixels sit at rows [tm, tm + B*(H+2)*(W+2));
one full guard block above and below keeps every tap read of a content
row inside the array.  The conv writes zeros to every non-content row,
which are the next conv's zero padding, so stride-1 convs chain in this
layout with no re-padding.

Quantization is w8a8: weights per output channel (``ops.quantize``),
activations dynamically per block of ``tm`` rows (abs-max over the block
and a ``gr``-row halo each side).  The output therefore depends on the
block partition: ``tm`` and ``gr`` are part of the function, and the
port picks them as the JAX package does (``model_int8._pick_tm``).

:func:`conv_flat_int8_plain` is the plain version of the hand-written
kernel (``ops/cuda/conv_int8.py`` + ``csrc/conv_int8.cu``): the same
per-block scales, integer products summed exactly in float64, and an
fp32 epilogue of separate roundings in the order of the JAX package's
bit-matched emulation ``conv_flat_int8_reference``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["FlatLayout", "make_layout", "to_flat", "from_flat",
           "pack_conv_int8", "content_mask", "quantize_blocks",
           "conv_flat_int8_plain"]


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """Flat padded row layout for one (batch, resolution) segment."""
    b: int        # batch
    h: int        # content height
    w: int        # content width
    tm: int       # row-block height
    gr: int       # halo height (>= g, divides tm)

    @property
    def wp(self) -> int:          # padded width
        return self.w + 2

    @property
    def hp(self) -> int:          # padded height
        return self.h + 2

    @property
    def g(self) -> int:           # max |tap row offset| = wp + 1
        return self.wp + 1

    @property
    def p(self) -> int:           # content rows (all padded pixels)
        return self.b * self.hp * self.wp

    @property
    def nb(self) -> int:          # row blocks (1 guard block each side)
        return -(-self.p // self.tm) + 2

    @property
    def rows(self) -> int:
        return self.nb * self.tm


def make_layout(b: int, h: int, w: int, tm: int = 1024) -> FlatLayout:
    """Pick a layout: gr = g rounded up to 128 rows, tm a multiple of gr
    (so halo blocks tile the row axis)."""
    g = (w + 2) + 1
    gr = _round_up(g, 128)
    tm = max(_round_up(tm, gr), gr)
    return FlatLayout(b=b, h=h, w=w, tm=tm, gr=gr)


def to_flat(x: torch.Tensor, lay: FlatLayout) -> torch.Tensor:
    """[B, H, W, C] -> [R, C] flat padded rows (zeros elsewhere)."""
    b, h, w, c = x.shape
    if (b, h, w) != (lay.b, lay.h, lay.w):
        raise ValueError(f"to_flat: shape {tuple(x.shape)} does not fit "
                         f"{lay}")
    flat = x.new_zeros((lay.rows, c))
    flat[lay.tm:lay.tm + lay.p].view(b, lay.hp, lay.wp, c)[
        :, 1:1 + h, 1:1 + w] = x
    return flat


def from_flat(y: torch.Tensor, lay: FlatLayout) -> torch.Tensor:
    """[R, C] -> [B, H, W, C] (content crop, a view)."""
    c = y.shape[-1]
    xp = y[lay.tm:lay.tm + lay.p].view(lay.b, lay.hp, lay.wp, c)
    return xp[:, 1:1 + lay.h, 1:1 + lay.w, :]


def pack_conv_int8(w_q: torch.Tensor) -> torch.Tensor:
    """OIHW int8 kernel -> ``[k*k, C_out, C_in]``, contiguous.

    Tap ``t = (dy+1)*k + (dx+1)`` as in the JAX package's tap-major
    ``[k*k*C_in, C_out]`` stack (``w_jax.reshape(k*k, C_in, C_out)`` is
    this array with its last two dims swapped); within a tap each output
    channel's C_in weights are contiguous, the order the kernel's matrix
    unit reads its second operand in."""
    cout, cin, kh, kw = w_q.shape
    return w_q.permute(2, 3, 0, 1).reshape(kh * kw, cout, cin).contiguous()


def content_mask(lay: FlatLayout, device=None) -> torch.Tensor:
    """[R] bool: the rows that hold a content pixel."""
    q = torch.arange(lay.rows, device=device) - lay.tm
    wi = q % lay.wp
    hi = torch.div(q, lay.wp, rounding_mode="floor") % lay.hp
    return ((q >= 0) & (q < lay.p) & (wi >= 1) & (wi <= lay.w)
            & (hi >= 1) & (hi <= lay.h))


def _halo_rows(lay: FlatLayout, k: int, device) -> torch.Tensor:
    """[nb, tm + 2*gr] (k=3) or [nb, tm] (k=1) row indices of each block's
    input: the block plus its halos, clamped at both ends as the JAX
    kernel's BlockSpec index maps clamp them."""
    i = torch.arange(lay.nb, device=device)[:, None]
    cur = i * lay.tm + torch.arange(lay.tm, device=device)[None]
    if k == 1:
        return cur
    tmb = lay.tm // lay.gr
    nbot = lay.rows // lay.gr - 1
    ar = torch.arange(lay.gr, device=device)[None]
    top = torch.clamp(i * tmb - 1, min=0) * lay.gr + ar
    bot = torch.clamp((i + 1) * tmb, max=nbot) * lay.gr + ar
    return torch.cat([top, cur, bot], dim=1)


def _c127(like: torch.Tensor) -> torch.Tensor:
    """127 as a tensor like ``like``: a division by it, or of it, is a
    true fp32 division.  With a Python number torch computes
    ``127 / t`` as ``127 * (1 / t)``, and ``t / 127`` on CUDA as
    ``t * (1 / 127)``, which round differently."""
    return torch.full_like(like, 127.0)


def quantize_blocks(xin: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-block activation quantization of the JAX kernel's
    ``_quantize``, batched: ``xin`` [nb, rows, C] (each block's input with
    its halos) -> ``(q [nb, rows, C] int8, amax [nb] f32)``.

    ``amax = max(max|x|, 1e-6)``; ``q = clip(rint(x * (127 / amax)), ±127)``
    (``torch.round`` rounds half to even, as ``jnp.round`` does)."""
    xf = xin.float()
    amax = torch.clamp(xf.abs().amax(dim=(1, 2)), min=1e-6)
    q = torch.clamp(torch.round(xf * (_c127(amax) / amax)[:, None, None]),
                    -127, 127)
    return q.to(torch.int8), amax


def conv_flat_int8_plain(x_flat: torch.Tensor, w_packed: torch.Tensor,
                         s_w: torch.Tensor, bias: torch.Tensor,
                         lay: FlatLayout, k: int = 3, act: str = "leaky",
                         skip: Optional[torch.Tensor] = None,
                         out_dtype=torch.bfloat16) -> torch.Tensor:
    """One w8a8 stride-1 conv over the flat layout, in plain PyTorch.

    Args:
      x_flat:   [R, C_in] activations (bf16/f32), flat padded layout.
      w_packed: [k*k, C_out, C_in] int8 (:func:`pack_conv_int8`).
      s_w:      [C_out] f32 per-channel weight scales.
      bias:     [C_out] f32 folded bias.
      k:        1 or 3 (pad = (k-1)//2).
      act:      "leaky" (slope 0.1) or "linear".
      skip:     optional [R, C_out] residual, added after the activation
                (the darknet shortcut).
    Returns:
      [R, C_out] ``out_dtype``, non-content rows zeroed.

    Per block i: ``acc = sum_t q[r + o_t] @ W_t`` in float64 (exact: every
    partial sum is an integer below 2**53), then
    ``y = float(acc) * (amax_i / 127) * s_w + b``, leaky, ``+ skip``, mask,
    cast — each a separate fp32 rounding.
    """
    if k not in (1, 3) or act not in ("leaky", "linear"):
        raise ValueError(f"k must be 1 or 3 and act leaky or linear, got "
                         f"k={k}, act={act!r}")
    taps, cout, cin = w_packed.shape
    if taps != k * k or x_flat.shape != (lay.rows, cin):
        raise ValueError(f"conv_flat_int8: x {tuple(x_flat.shape)}, w "
                         f"{tuple(w_packed.shape)} do not fit k={k}, {lay}")
    dev = x_flat.device
    idx = _halo_rows(lay, k, dev)
    q, amax = quantize_blocks(x_flat[idx])
    q = q.double()
    w = w_packed.double()
    acc = torch.zeros((lay.nb, lay.tm, cout), dtype=torch.float64,
                      device=dev)
    t = 0
    for dy in ((-1, 0, 1) if k == 3 else (0,)):
        for dx in ((-1, 0, 1) if k == 3 else (0,)):
            start = (lay.gr + dy * lay.wp + dx) if k == 3 else 0
            acc += q[:, start:start + lay.tm] @ w[t].T
            t += 1
    y = acc.float() * (amax / _c127(amax))[:, None, None]
    y = y * s_w.float()
    y = y + bias.float()
    if act == "leaky":
        y = torch.where(y > 0, y, 0.1 * y)
    y = y.reshape(lay.rows, cout)
    if skip is not None:
        y = y + skip.float()
    y = torch.where(content_mask(lay, dev)[:, None], y, 0.0)
    return y.to(out_dtype)
