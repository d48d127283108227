"""The port's int8 tap-matmul conv (K2) against the JAX package's.

* Layout: ``FlatLayout`` fields, ``to_flat``/``from_flat`` arrays and the
  packed kernel equal JAX's; the block size rule (``_pick_tm``) and the
  layouts the int8 forward uses equal JAX's for yolov3 and yolov3-tiny at
  batches 1 and 16.
* The per-block quantization ``(q, amax)`` is bit-equal to JAX's
  ``_quantize``.
* The plain K2 is bit-equal to JAX's ``conv_flat_int8_reference`` (run
  op by op, so each fp32 operation rounds on its own) in fp32 and bf16,
  for k in {1, 3}, leaky and linear, with and without skip, with
  C_out = 255, an all-zero block and values at exactly n + 0.5 after
  scaling.
* Against the interpret-mode Pallas kernel it agrees to 2e-5, the JAX
  package's own tolerance (tests/test_conv_int8.py): XLA on the CPU
  contracts that kernel's ``acc * scale * s_w + b`` into an FMA and it
  multiplies by f32(1/127) where the reference divides by 127, so the
  two JAX versions already differ by about one fp32 ulp.
* The wrapper takes the plain version for CPU tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtimeobjectdetection_tpu import model_int8 as jmodel_int8
from realtimeobjectdetection_tpu.models import zoo as jzoo
from realtimeobjectdetection_tpu.ops.pallas import conv_int8 as jconv
from realtimeobjectdetection_tpu_torch import model_int8 as tmodel_int8
from realtimeobjectdetection_tpu_torch.models import zoo as tzoo
from realtimeobjectdetection_tpu_torch.ops import conv_int8 as tconv
from realtimeobjectdetection_tpu_torch.ops.cuda import conv_int8 as tcuda

LAYOUTS = [(2, 13, 13, 256), (3, 26, 26, 512), (1, 104, 104, 1024),
           (16, 13, 13, 768), (1, 7, 9, 100)]


@pytest.mark.parametrize("b,h,w,tm", LAYOUTS)
def test_layout_matches_jax(b, h, w, tm):
    jl, tl = jconv.make_layout(b, h, w, tm=tm), tconv.make_layout(b, h, w,
                                                                  tm=tm)
    fields = ("b", "h", "w", "tm", "gr", "wp", "hp", "g", "p", "nb", "rows")
    assert [getattr(tl, f) for f in fields] == \
        [getattr(jl, f) for f in fields]
    x = np.random.RandomState(0).randn(b, h, w, 5).astype(np.float32)
    jf = np.asarray(jconv.to_flat(jnp.asarray(x), jl))
    tf = tconv.to_flat(torch.from_numpy(x), tl)
    np.testing.assert_array_equal(tf.numpy(), jf)
    np.testing.assert_array_equal(tconv.from_flat(tf, tl).numpy(),
                                  np.asarray(jconv.from_flat(jnp.asarray(jf),
                                                             jl)))
    content = np.zeros(tl.rows, bool)
    content[tl.tm:tl.tm + tl.p] = True
    mask = tconv.content_mask(tl).numpy()
    assert not (mask & ~content).any()
    assert mask.sum() == b * h * w


def test_pack_matches_jax():
    rng = np.random.RandomState(1)
    for k in (1, 3):
        w = rng.randint(-127, 128, (k, k, 24, 40)).astype(np.int8)  # HWIO
        jp = np.asarray(jconv.pack_conv_int8(jnp.asarray(w)))
        tp = tconv.pack_conv_int8(torch.from_numpy(
            np.ascontiguousarray(w.transpose(3, 2, 0, 1)))).numpy()
        np.testing.assert_array_equal(
            tp, jp.reshape(k * k, 24, 40).transpose(0, 2, 1))


def _jax_layouts(spec, batch):
    """The layouts JAX's int8 forward hands its conv, by tracing it
    abstractly with a recorder in front of the conv."""
    seen = {}
    orig = jmodel_int8.conv_flat_int8

    def record(x, w, s, b, lay, **kw):
        seen[(lay.h, lay.w)] = lay
        return orig(x, w, s, b, lay, **kw)

    params = {}
    for n in spec.conv_nodes:
        k, ci, co = n.kernel_size, n.in_channels, n.out_channels
        params[f"node_{n.index}"] = {
            "w_q": jax.ShapeDtypeStruct((k, k, ci, co), jnp.int8),
            "scale": jax.ShapeDtypeStruct((co,), jnp.float32),
            "b": jax.ShapeDtypeStruct((co,), jnp.float32)}
    x = jax.ShapeDtypeStruct((batch, spec.net.height, spec.net.width, 3),
                             jnp.float32)
    jmodel_int8.conv_flat_int8 = record
    try:
        jax.eval_shape(jmodel_int8.make_forward_int8(spec), params, x)
    finally:
        jmodel_int8.conv_flat_int8 = orig
    return seen


@pytest.mark.parametrize("name", ["yolov3", "yolov3-tiny"])
def test_block_size_rule_matches_jax(name):
    spec_j, spec_t = jzoo.get_spec(name), tzoo.get_spec(name)
    for batch in (1, 16):
        want = _jax_layouts(spec_j, batch)
        got = tmodel_int8.flat_layouts(spec_t, batch)
        assert got == {hw: tconv.FlatLayout(**vars(lay))
                       for hw, lay in want.items()}
        for hw, lay in got.items():
            pairs = [(n.in_channels, n.out_channels, n.kernel_size)
                     for n in spec_t.conv_nodes
                     if tmodel_int8._eligible(n, 64)
                     and tmodel_int8._resolutions(spec_t)[n.index] == hw]
            assert tmodel_int8._pick_tm(lay.gr, pairs) \
                == jmodel_int8._pick_tm(lay.gr, pairs) == lay.tm
    # yolov3 at 416, batch 16: tm 1024 at 104, 52, 26 and 768 at 13
    if name == "yolov3":
        got = tmodel_int8.flat_layouts(spec_t, 16)
        assert {hw[0]: (lay.gr, lay.tm, lay.nb) for hw, lay in got.items()} \
            == {104: (128, 1024, 178), 52: (128, 1024, 48),
                26: (128, 1024, 15), 13: (128, 768, 7)}


def _flat_case(seed, b, h, w, cin, cout, k, tm, dtype, zero_images=(),
               halves=False):
    """Seeded numpy inputs for one conv: NHWC activations (per-image
    scales, so blocks get different amax), int8 packed weights, scales,
    bias and a skip, as numpy f32 arrays exactly representable in
    ``dtype``."""
    rng = np.random.RandomState(seed)
    lay = tconv.make_layout(b, h, w, tm=tm)
    if halves:
        # amax is 127 in every block, so x * (127 / amax) is x itself:
        # n + 0.5 values land exactly on the rounding tie
        x = rng.randint(-127, 127, (b, h, w, cin)) + 0.5
        x[..., 0] = 127.0
    else:
        x = rng.randn(b, h, w, cin) * rng.uniform(0.1, 8, (b, 1, 1, 1))
    x[list(zero_images)] = 0.0
    to = torch.bfloat16 if dtype == "bf16" else torch.float32
    x = torch.from_numpy(x.astype(np.float32)).to(to).float().numpy()
    xf = tconv.to_flat(torch.from_numpy(x), lay).numpy()
    w_hwio = rng.randint(-127, 128, (k, k, cin, cout)).astype(np.int8)
    s_w = (rng.uniform(0.5, 2, cout) / 127 / cin ** 0.5).astype(np.float32)
    bias = (rng.randn(cout) * 0.5).astype(np.float32)
    skip = tconv.to_flat(torch.from_numpy(
        rng.randn(b, h, w, cout).astype(np.float32)).to(to).float(),
        lay).numpy()
    return lay, xf, w_hwio, s_w, bias, skip


def _run_both(case, k, act, with_skip, dtype, out_dtype):
    lay, xf, w_hwio, s_w, bias, skip = case
    jdt = {"bf16": jnp.bfloat16, "f32": jnp.float32}
    tdt = {"bf16": torch.bfloat16, "f32": torch.float32}
    jl = jconv.make_layout(lay.b, lay.h, lay.w, tm=lay.tm)
    want = jconv.conv_flat_int8_reference(
        jnp.asarray(xf).astype(jdt[dtype]),
        jconv.pack_conv_int8(jnp.asarray(w_hwio)), jnp.asarray(s_w),
        jnp.asarray(bias), jl, k=k, act=act,
        skip=jnp.asarray(skip).astype(jdt[dtype]) if with_skip else None,
        out_dtype=jdt[out_dtype])
    w_oihw = torch.from_numpy(np.ascontiguousarray(
        w_hwio.transpose(3, 2, 0, 1)))
    got = tconv.conv_flat_int8_plain(
        torch.from_numpy(xf).to(tdt[dtype]), tconv.pack_conv_int8(w_oihw),
        torch.from_numpy(s_w), torch.from_numpy(bias), lay, k=k, act=act,
        skip=torch.from_numpy(skip).to(tdt[dtype]) if with_skip else None,
        out_dtype=tdt[out_dtype])
    assert got.dtype == tdt[out_dtype]
    return got.float().numpy(), np.asarray(want).astype(np.float32)


# (k, act, skip, in dtype, out dtype, C_in, C_out, case)
PLAIN_CASES = [
    (3, "leaky", False, "f32", "f32", 64, 64, "random"),
    (3, "leaky", True, "f32", "f32", 64, 96, "random"),
    (1, "leaky", False, "f32", "f32", 96, 64, "random"),
    (1, "linear", False, "f32", "f32", 64, 255, "random"),
    (3, "leaky", True, "bf16", "bf16", 64, 64, "random"),
    (1, "leaky", False, "bf16", "bf16", 128, 64, "random"),
    (1, "linear", False, "bf16", "bf16", 64, 255, "random"),
    (3, "leaky", False, "bf16", "f32", 64, 128, "random"),
    (3, "leaky", True, "bf16", "bf16", 64, 64, "zero_block"),
    (1, "leaky", False, "f32", "f32", 64, 64, "zero_block"),
    (3, "linear", False, "f32", "f32", 64, 64, "halves"),
    (1, "leaky", True, "bf16", "bf16", 64, 64, "halves"),
]


@pytest.mark.parametrize("k,act,with_skip,dtype,out_dtype,cin,cout,kind",
                         PLAIN_CASES)
def test_plain_matches_reference_bit_for_bit(k, act, with_skip, dtype,
                                             out_dtype, cin, cout, kind):
    # zero_block: images 0 and 1 are zero, so blocks 1 and 2 (and their
    # halos) hold only zeros: amax clamps to 1e-6 and q is 0
    b = 3 if kind == "zero_block" else 2
    case = _flat_case(k * 10 + cout, b, 13, 13, cin, cout, k, 128, dtype,
                      zero_images=(0, 1) if kind == "zero_block" else (),
                      halves=kind == "halves")
    lay, xf = case[0], case[1]
    if kind == "zero_block":
        assert not xf[:3 * lay.tm + lay.gr].any()
    if kind == "halves":
        content = tconv.content_mask(lay).numpy()
        ties = np.abs(xf[content]) % 1 == 0.5
        assert ties.mean() > 0.9
    got, want = _run_both(case, k, act, with_skip, dtype, out_dtype)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


def test_quantize_step_matches_jax():
    for dtype in ("f32", "bf16"):
        lay, xf = _flat_case(3, 2, 13, 13, 64, 64, 3, 128, dtype)[:2]
        tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
        jx = jnp.asarray(xf).astype(jnp.bfloat16 if dtype == "bf16"
                                    else jnp.float32)
        for k in (1, 3):
            idx = tconv._halo_rows(lay, k, "cpu")
            q, amax = tconv.quantize_blocks(torch.from_numpy(xf).to(tdt)[idx])
            assert q.dtype == torch.int8 and amax.shape == (lay.nb,)
            tmb, nbot = lay.tm // lay.gr, lay.rows // lay.gr - 1
            for i in range(lay.nb):
                cur = jx[i * lay.tm:(i + 1) * lay.tm]
                if k == 3:
                    ti, bi = max(i * tmb - 1, 0), min((i + 1) * tmb, nbot)
                    cur = jnp.concatenate(
                        [jx[ti * lay.gr:(ti + 1) * lay.gr], cur,
                         jx[bi * lay.gr:(bi + 1) * lay.gr]])
                jq, jamax = jconv._quantize(cur)
                np.testing.assert_array_equal(q[i].numpy(), np.asarray(jq))
                assert amax[i].item() == float(jamax)
    # the epilogue's scale amax / 127 rounds as JAX's does, over many amax
    a = (np.random.RandomState(4).rand(100000) * 50).astype(np.float32)
    np.testing.assert_array_equal(
        (torch.from_numpy(a) / 127.0).numpy(), np.asarray(jnp.asarray(a)
                                                          / 127.0))


@pytest.mark.parametrize("k,with_skip", [(3, False), (3, True), (1, False)])
def test_plain_within_tolerance_of_interpret_kernel(k, with_skip):
    lay, xf, w_hwio, s_w, bias, skip = _flat_case(
        7 + k, 2, 13, 13, 32, 64, k, 256, "f32")
    jl = jconv.make_layout(lay.b, lay.h, lay.w, tm=lay.tm)
    want = jconv.conv_flat_int8(
        jnp.asarray(xf), jconv.pack_conv_int8(jnp.asarray(w_hwio)),
        jnp.asarray(s_w), jnp.asarray(bias), jl, k=k,
        skip=jnp.asarray(skip) if with_skip else None,
        out_dtype=jnp.float32, interpret=True)
    got = tconv.conv_flat_int8_plain(
        torch.from_numpy(xf), tconv.pack_conv_int8(torch.from_numpy(
            np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))),
        torch.from_numpy(s_w), torch.from_numpy(bias), lay, k=k,
        skip=torch.from_numpy(skip) if with_skip else None,
        out_dtype=torch.float32)
    ref = np.asarray(jconv.conv_flat_int8_reference(
        jnp.asarray(xf), jconv.pack_conv_int8(jnp.asarray(w_hwio)),
        jnp.asarray(s_w), jnp.asarray(bias), jl, k=k,
        skip=jnp.asarray(skip) if with_skip else None,
        out_dtype=jnp.float32))
    got, want = got.numpy(), np.asarray(want)
    # shown with -s: how far JAX's two versions are apart, and the port
    print(f"\nk={k} skip={with_skip}: interpret kernel vs reference "
          f"{int((want != ref).sum())} of {ref.size} outputs differ, at "
          f"most {np.abs(want - ref).max():.3g}; plain vs interpret at "
          f"most {np.abs(got - want).max():.3g}")
    np.testing.assert_array_equal(got, ref)
    # the interpret kernel's FMA and its f32(1/127) put it about 1 ulp
    # from the reference; the JAX package's own tolerance
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_wrapper_takes_plain_version_on_cpu():
    lay, xf, w_hwio, s_w, bias, skip = _flat_case(9, 2, 13, 13, 64, 64, 3,
                                                  128, "f32")
    args = (torch.from_numpy(xf), tconv.pack_conv_int8(torch.from_numpy(
        np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))),
        torch.from_numpy(s_w), torch.from_numpy(bias), lay)
    before = tcuda.conv_flat_int8.launches
    got = tcuda.conv_flat_int8(*args, k=3, skip=torch.from_numpy(skip))
    want = tconv.conv_flat_int8_plain(*args, k=3,
                                      skip=torch.from_numpy(skip))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)
    assert tcuda.conv_flat_int8.launches == before
    with pytest.raises(ValueError):
        tcuda.conv_flat_int8(*[a.to("meta") if torch.is_tensor(a) else a
                               for a in args])
    with pytest.raises(ValueError):
        tconv.conv_flat_int8_plain(*args, k=3, act="relu")
    with pytest.raises(ValueError):
        tconv.conv_flat_int8_plain(*args, k=1)
