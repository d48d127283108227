"""K2's quantize-once layout and launch plan, on the CPU.

* ``quantize_once_plain`` (the int8 activations ``Q`` the kernel reads, one
  window per content block, and each block's amax) is bit-equal to JAX's
  ``_quantize`` over each block with its halos, clamped as the Pallas
  kernel's index maps clamp them, for k in {1, 3}, bf16 and fp32 input.
* ``plan`` gives a valid plan for every conv configuration of the yolov3
  int8 forward at batch 16 and for small layouts: every row tile lies in
  one row block, the shared memory fits, the ring has at least 3 stages,
  the splits cover every (tap, slice) step exactly once, a Q window's
  halo covers every tap's row offset, and the scratch regions do not
  overlap.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtimeobjectdetection_tpu.ops.pallas import conv_int8 as jconv
from realtimeobjectdetection_tpu_torch import model_int8 as tmodel_int8
from realtimeobjectdetection_tpu_torch.models import zoo as tzoo
from realtimeobjectdetection_tpu_torch.ops import conv_int8 as tconv
from realtimeobjectdetection_tpu_torch.ops.cuda import conv_int8 as tcuda


def _yolov3_configs():
    """(layout, k, C_in, C_out) of every tap-matmul conv of the yolov3 int8
    forward at 416, batch 16 (act and skip do not change the plan)."""
    spec = tzoo.get_spec("yolov3")
    lays = tmodel_int8.flat_layouts(spec, 16)
    res = tmodel_int8._resolutions(spec)
    return sorted({(lays[res[n.index]], n.kernel_size, n.in_channels,
                    n.out_channels) for n in spec.conv_nodes
                   if tmodel_int8._eligible(n, 64)},
                  key=lambda c: (-c[0].h, c[1], c[2], c[3]))


SMALL = [(tconv.make_layout(2, 13, 13, tm=256), k, cin, cout)
         for k, cin, cout in ((3, 64, 64), (1, 96, 255), (3, 32, 128),
                              (1, 1024, 512))] \
    + [(tconv.make_layout(1, 7, 9, tm=128), 3, 64, 72)]
CONFIGS = _yolov3_configs() + SMALL


def test_yolov3_configurations():
    configs = _yolov3_configs()
    # the 18 configurations of the forward, less the three 3x3 convs
    # that come with and without a skip
    assert len(configs) == 15
    assert {(c[0].h, c[0].tm) for c in configs} == {
        (104, 1024), (52, 1024), (26, 1024), (13, 768)}
    plans = [tcuda.plan(*c) for c in configs]
    assert any(p.splits > 1 for p in plans)
    assert any(p.splits == 1 for p in plans)
    assert {p.bk for p in plans} == {64, 128}


@pytest.mark.parametrize("lay,k,cin,cout", CONFIGS,
                         ids=[f"{c[0].b}x{c[0].h}-tm{c[0].tm}-k{c[1]}-"
                              f"{c[2]}to{c[3]}" for c in CONFIGS])
def test_plan_is_valid(lay, k, cin, cout):
    for sms, x_bytes, y_bytes in ((132, 2, 2), (132, 2, 4), (132, 4, 4),
                                  (1000, 2, 2)):
        pl = tcuda.plan(lay, k, cin, cout, sms, x_bytes, y_bytes)
        # tiles: every 128-row tile lies inside one row block
        assert lay.tm % tcuda.ROW_TILE == 0
        assert lay.rows % tcuda.ROW_TILE == 0
        assert pl.row_tiles * tcuda.ROW_TILE == lay.rows
        assert pl.col_tiles * tcuda.COL_TILE >= cout
        # shared memory: a ring of at least 3 stages beside the output and
        # skip tiles
        stage = (tcuda.ROW_TILE + tcuda.COL_TILE) * pl.bk
        ring = tcuda.ring_bytes(x_bytes, y_bytes)
        assert 3 <= pl.stages <= tcuda.MAX_STAGES
        assert pl.stages * stage <= ring
        assert tcuda.smem_bytes(x_bytes, y_bytes) <= tcuda.SMEM_LIMIT
        # slices and splits: every (tap, slice) step exactly once
        assert pl.cq % 16 == 0 and cin <= pl.cq < cin + 16
        assert pl.bk in (64, 128) and pl.slices * pl.bk >= pl.cq
        assert pl.iters == k * k * pl.slices
        steps = []
        for s in range(pl.splits):
            lo, hi = pl.split_range(s)
            assert hi > lo
            steps += range(lo, hi)
        assert steps == list(range(pl.iters))
        if pl.splits > 1:
            assert pl.work_tiles * pl.splits // 2 < sms
            assert pl.iters // pl.splits >= 2
        # Q: one window per content block, its halo as deep as the
        # largest tap row offset (W + 3)
        assert pl.halo == (lay.gr if k == 3 else 0)
        assert k == 1 or pl.halo >= lay.g
        assert pl.q_rows == (lay.nb - 2) * (lay.tm + 2 * pl.halo)
        # scratch regions: aligned, in order, inside the buffer
        assert 1 <= pl.blocks <= min(sms, pl.work_tiles * pl.splits)
        assert 1 <= pl.parts <= tcuda.MAX_PARTS
        sizes = [4 * (lay.rows // lay.gr) * pl.parts, 4 * (lay.nb - 2),
                 4 * pl.n_tiles if pl.splits > 1 else 0, pl.q_rows * pl.cq,
                 4 * pl.splits * pl.n_tiles * tcuda.ROW_TILE
                 * tcuda.COL_TILE if pl.splits > 1 else 0]
        ends = [o + s for o, s in zip(pl.offsets, sizes)]
        assert all(o % 256 == 0 for o in pl.offsets)
        assert all(e <= o for e, o in zip(ends, pl.offsets[1:]))
        assert ends[-1] <= pl.scratch_bytes


def _case(seed, lay, cin, cout, k, dtype):
    rng = np.random.RandomState(seed)
    x = rng.randn(lay.b, lay.h, lay.w, cin) \
        * rng.uniform(0.1, 8, (lay.b, 1, 1, 1))
    to = torch.bfloat16 if dtype == "bf16" else torch.float32
    xf = tconv.to_flat(torch.from_numpy(x.astype(np.float32)).to(to), lay)
    w = torch.from_numpy(rng.randint(-127, 128, (cout, cin, k, k))
                         .astype(np.int8))
    s_w = torch.from_numpy((rng.uniform(0.5, 2, cout) / 127 / cin ** 0.5)
                           .astype(np.float32))
    bias = torch.from_numpy((rng.randn(cout) * 0.5).astype(np.float32))
    skip = tconv.to_flat(torch.from_numpy(
        rng.randn(lay.b, lay.h, lay.w, cout).astype(np.float32)).to(to), lay)
    return xf, tconv.pack_conv_int8(w), s_w, bias, skip


def test_plan_splits_only_where_tiles_are_few():
    for lay, k, cin, cout in CONFIGS:
        pl = tcuda.plan(lay, k, cin, cout)
        if pl.work_tiles >= 132 or pl.iters < 4:
            assert pl.splits == 1
        else:  # halved while the units are fewer than the SMs
            assert pl.splits > 1
            assert pl.work_tiles * pl.splits >= 132 \
                or pl.iters // pl.splits < 4
        one = tcuda.plan(lay, k, cin, cout, sms=1)
        assert (one.splits, one.blocks) == (1, 1)


@pytest.mark.parametrize("lay,cin", [
    (tconv.make_layout(3, 13, 13, tm=256), 48),
    (tconv.make_layout(2, 7, 9, tm=128), 40)], ids=["3x13-tm256",
                                                    "2x7x9-tm128"])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_quantize_once_matches_jax(lay, cin, k, dtype):
    xf = _case(5, lay, cin, 8, k, dtype)[0]
    q, amax = tconv.quantize_once_plain(xf, lay, k)
    halo = lay.gr if k == 3 else 0
    assert q.shape == (lay.nb - 2, lay.tm + 2 * halo, cin)
    assert q.dtype == torch.int8 and amax.shape == (lay.nb - 2,)
    jx = jnp.asarray(xf.float().numpy()).astype(
        jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tmb, nbot = lay.tm // lay.gr, lay.rows // lay.gr - 1
    for i in range(1, lay.nb - 1):
        cur = jx[i * lay.tm:(i + 1) * lay.tm]
        if k == 3:  # the Pallas kernel's clamped halo index maps
            ti, bi = max(i * tmb - 1, 0), min((i + 1) * tmb, nbot)
            cur = jnp.concatenate([jx[ti * lay.gr:(ti + 1) * lay.gr], cur,
                                   jx[bi * lay.gr:(bi + 1) * lay.gr]])
        jq, jamax = jconv._quantize(cur)
        np.testing.assert_array_equal(q[i - 1].numpy(), np.asarray(jq))
        assert amax[i - 1].item() == float(jamax)
