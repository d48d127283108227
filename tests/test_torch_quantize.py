"""The port's int8 inference (``quantize=``) against the JAX package's.

* ``quantize_folded_int8`` is bit-equal to JAX's on the same folded
  kernels, after the OIHW <-> HWIO transpose; ``params_from_jax`` carries a
  quantized tree across (int8 kernels stay int8).
* yolov3-tiny at 416 on the golden dog input, from one quantized tree,
  heads against JAX's as a share of their largest value (about 5):
  - ``w8``: within 2e-5 (fp32 convs that sum in another order; 2.4e-6
    seen);
  - ``w8a8``, and ``w8a8_pallas`` with fp32 activations against JAX's
    interpret-mode kernel: within 5%.  A sum that lands one fp32 ulp away
    can flip one activation's int8 rounding; the step it makes flips
    others in the next quantized conv, and the cascade grows towards the
    size of the quantization noise (each int8 mode is 3-4% from the fp32
    forward): 1.2% and 2.2% seen, where a wiring fault gives O(1);
  and the drift gates of tests/test_quantize.py hold between each of the
  port's int8 modes and its own fp32 folded forward.
* The full yolov3 graph at 96x96, batch 1 (ladders, fused skips, route
  concats, the 255-channel heads), fp32 activations, against JAX's int8
  forward with its conv swapped for ``conv_flat_int8_reference`` inside
  the test (no JAX file changes): the same tap-matmul convs in the same
  configurations, and heads within 10% of their largest value.  The two
  fp32 fallback convs (stem, downsamples) sum in another order; the
  first last-bit difference that flips an int8 rounding cascades through
  the 67 quantized convs to the size of the quantization noise itself:
  the heads differ by 4-6% of their largest value (synthetic weights
  drive them to 3e5), as much as each int8 forward differs from its fp32
  one, and as much as JAX's own jitted forward differs from its
  interpret-mode one; a wiring fault gives O(1).  The full-yolov3 drift
  gates of tests/test_quantize.py hold against the port's own fp32
  folded heads.
Run with ``-s``, the tests print these differences.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtimeobjectdetection_tpu import model as jmodel
from realtimeobjectdetection_tpu import model_int8 as jmodel_int8
from realtimeobjectdetection_tpu.models import zoo as jzoo
from realtimeobjectdetection_tpu.ops import quantize as jquant
from realtimeobjectdetection_tpu.ops.pallas import conv_int8 as jconv
from realtimeobjectdetection_tpu_torch import model as tmodel
from realtimeobjectdetection_tpu_torch import model_int8 as tmodel_int8
from realtimeobjectdetection_tpu_torch import testing as ttesting
from realtimeobjectdetection_tpu_torch import weights as tweights
from realtimeobjectdetection_tpu_torch.models import zoo as tzoo
from realtimeobjectdetection_tpu_torch.ops import decode as tdecode
from realtimeobjectdetection_tpu_torch.ops import quantize as tquant

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _np_tree(tree):
    return {k: {n: np.asarray(v) for n, v in e.items()}
            for k, e in tree.items()}


def _hwio(tree):
    """A port tree (OIHW tensors) as a JAX tree (HWIO numpy arrays)."""
    return {k: {n: v.numpy().transpose(2, 3, 1, 0) if v.dim() == 4
                else v.numpy() for n, v in e.items()}
            for k, e in tree.items()}


def _trees(name, seed, reso=None, jax_quantizer=True):
    """Synthetic darknet weights folded by the port, as a JAX tree, and
    their int8 quantization (JAX's, run op by op as its detector runs
    it, or the port's, which equals it): one model for both packages."""
    kw = {"width": reso, "height": reso} if reso else {}
    spec_j, spec_t = jzoo.get_spec(name, **kw), tzoo.get_spec(name, **kw)
    params, _ = tweights.load_darknet_weights(
        spec_t, ttesting.synthetic_darknet_weights(spec_t, seed))
    folded = tmodel.fold_batchnorm(spec_t, params)
    q = (_np_tree(jquant.quantize_folded_int8(spec_j, _hwio(folded)))
         if jax_quantizer else
         _hwio(tquant.quantize_folded_int8(spec_t, folded)))
    return spec_j, spec_t, _hwio(folded), q


@pytest.fixture(scope="module")
def tiny():
    spec_j, spec_t, folded, q = _trees("yolov3-tiny", 0)
    d = np.load(os.path.join(GOLDEN, "yolov3-tiny_dog.npz"))
    x = np.ascontiguousarray(d["input_nchw"].transpose(0, 2, 3, 1))
    return spec_j, spec_t, folded, q, x


def test_quantizer_matches_jax(tiny):
    spec_j, spec_t, folded, q, _ = tiny
    got = tquant.quantize_folded_int8(spec_t,
                                      tweights.params_from_jax(folded))
    for node in spec_t.conv_nodes:
        key = f"node_{node.index}"
        assert got[key]["w_q"].dtype == torch.int8
        np.testing.assert_array_equal(
            got[key]["w_q"].numpy(), q[key]["w_q"].transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(got[key]["scale"].numpy(),
                                      q[key]["scale"])
        np.testing.assert_array_equal(got[key]["b"].numpy(), q[key]["b"])


def test_params_from_jax_carries_a_quantized_tree(tiny):
    _, spec_t, _, q, _ = tiny
    got = tweights.params_from_jax(q)
    for node in spec_t.conv_nodes:
        e, want = got[f"node_{node.index}"], q[f"node_{node.index}"]
        assert set(e) == {"w_q", "scale", "b"}
        assert e["w_q"].dtype == torch.int8 and e["w_q"].is_contiguous()
        assert e["w_q"].shape == (node.out_channels, node.in_channels,
                                  node.kernel_size, node.kernel_size)
        np.testing.assert_array_equal(e["w_q"].numpy(),
                                      want["w_q"].transpose(3, 2, 0, 1))
        assert e["scale"].dtype == e["b"].dtype == torch.float32
        np.testing.assert_array_equal(e["scale"].numpy(), want["scale"])


def _rel(a, b) -> float:
    """Largest |a - b| as a share of the largest |a|."""
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(a).max())


def _drift_gates(got, ref, prob, rel_wh, agree):
    """The gates of tests/test_quantize.py on decoded predictions."""
    assert np.isfinite(got).all()
    assert np.abs(got[..., 4:] - ref[..., 4:]).max() < prob
    cand = ref[..., 4] > 0.6
    rel = np.abs(got[..., 2:4] / np.maximum(ref[..., 2:4], 1e-3) - 1)
    assert rel[cand].max() < rel_wh
    assert ((got[..., 4] > 0.6) == (ref[..., 4] > 0.6)).mean() > agree


# mode, JAX forward options, tolerance on heads as a share of their
# largest value, port drift gates
MODES = [("w8", {"quantize": "w8"}, 2e-5, (0.05, 0.08, 0.995)),
         ("w8a8", {"quantize": "w8a8"}, 0.05, (0.10, 0.20, 0.99)),
         ("w8a8_pallas", None, 0.05, (0.10, 0.20, 0.99))]


@pytest.mark.parametrize("mode,jax_kw,rel,gates", MODES)
def test_tiny_int8_heads_match_jax(tiny, mode, jax_kw, rel, gates):
    spec_j, spec_t, folded, q, x = tiny
    if jax_kw is None:
        jfwd = jmodel_int8.make_forward_int8(
            spec_j, compute_dtype=jnp.float32, interpret=True)
    else:
        jfwd = jax.jit(jmodel.make_forward(spec_j, bn_mode="fold", **jax_kw))
    want = jfwd(q, jnp.asarray(x))
    tq = tweights.params_from_jax(q)
    with torch.inference_mode():
        got = tmodel.make_forward(spec_t, bn_mode="fold", quantize=mode,
                                  activation_dtype=torch.float32)(
            tq, torch.from_numpy(x))
        ref = tmodel.make_forward(spec_t, bn_mode="fold")(
            tweights.params_from_jax(folded), torch.from_numpy(x))
    # shown with -s: each head's largest difference from JAX's, and from
    # the port's fp32 forward, as a share of the head's largest value
    print(f"\n{mode}: port vs JAX "
          f"{[_rel(a, b.numpy()) for a, b in zip(want, got)]}, "
          f"port vs its fp32 "
          f"{[_rel(r.numpy(), b.numpy()) for r, b in zip(ref, got)]}")
    for a, b in zip(want, got):
        a = np.asarray(a)
        assert b.dtype == torch.float32 and b.shape == a.shape
        np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                   atol=rel * np.abs(a).max())
    _drift_gates(tdecode.decode_heads(got, spec_t, 416).numpy(),
                 tdecode.decode_heads(ref, spec_t, 416).numpy(), *gates)


def test_w8a8_pallas_defaults_to_bf16_activations(tiny):
    """As in the JAX package, the int8 forward ignores ``compute_dtype``:
    its flat activations are bf16 unless ``activation_dtype`` is given,
    and its heads fp32 unless ``head_dtype`` is."""
    _, spec_t, _, q, x = tiny
    tq = tweights.params_from_jax(q)
    x = torch.from_numpy(x)
    with torch.inference_mode():
        bf = tmodel.make_forward(spec_t, bn_mode="fold",
                                 compute_dtype=torch.float32,
                                 quantize="w8a8_pallas")(tq, x)
        f32 = tmodel.make_forward(spec_t, bn_mode="fold",
                                  quantize="w8a8_pallas",
                                  activation_dtype=torch.float32)(tq, x)
    for a, b in zip(bf, f32):
        assert a.dtype == b.dtype == torch.float32
        assert not torch.equal(a, b)
        assert (a - b).abs().max() < 0.05 * b.abs().max()


def test_full_yolov3_graph_matches_jax(monkeypatch):
    reso = 96
    spec_j, spec_t, folded, q = _trees("yolov3", 1, reso,
                                       jax_quantizer=False)
    x = np.random.RandomState(0).rand(1, reso, reso, 3).astype(np.float32)

    def config(lay, w, kw):
        return (lay.h, kw["k"], kw.get("act", "leaky"),
                kw.get("skip") is not None, tuple(w.shape))

    # JAX's own two int8 forwards: interpret-mode kernel and reference
    interp = jmodel_int8.make_forward_int8(
        spec_j, compute_dtype=jnp.float32, interpret=True)(q, jnp.asarray(x))
    jax_configs = set()

    def reference(x_flat, w, s_w, b, lay, interpret=False, **kw):
        # traced once per ladder scan, not once per rep
        jax_configs.add(config(lay, w.reshape(-1, w.shape[-1]), kw))
        return jconv.conv_flat_int8_reference(x_flat, w, s_w, b, lay, **kw)

    monkeypatch.setattr(jmodel_int8, "conv_flat_int8", reference)
    want = jax.jit(jmodel_int8.make_forward_int8(
        spec_j, compute_dtype=jnp.float32))(q, jnp.asarray(x))

    calls = []
    kernel = tmodel_int8.conv_flat_int8

    def record(x_flat, w, s_w, b, lay, **kw):
        # the port packs [k*k, C_out, C_in]; JAX [k*k*C_in, C_out]
        calls.append(config(lay, torch.empty(w.shape[0] * w.shape[2],
                                             w.shape[1]), kw))
        return kernel(x_flat, w, s_w, b, lay, **kw)

    monkeypatch.setattr(tmodel_int8, "conv_flat_int8", record)
    tq = tweights.params_from_jax(q)
    with torch.inference_mode():
        got = tmodel.make_forward(spec_t, bn_mode="fold",
                                  quantize="w8a8_pallas",
                                  activation_dtype=torch.float32)(
            tq, torch.from_numpy(x))
        ref = tmodel.make_forward(spec_t, bn_mode="fold")(
            tweights.params_from_jax(folded), torch.from_numpy(x))
    # the plan: the convs of the JAX forward, 67 calls in 18
    # configurations, 22 of them with the ladder's shortcut fused, three
    # 255-channel heads
    assert set(calls) == jax_configs and len(jax_configs) == 18
    assert len(calls) == 67 and sum(c[3] for c in calls) == 22
    assert sum(c[4][1] == 255 for c in calls) == 3
    # shown with -s, each head as a share of its largest value
    print(f"\nyolov3 {reso}: port vs JAX "
          f"{[_rel(a, b.numpy()) for a, b in zip(want, got)]}, JAX "
          f"interpret vs reference "
          f"{[_rel(a, i) for a, i in zip(want, interp)]}, port vs its fp32 "
          f"{[_rel(r.numpy(), b.numpy()) for r, b in zip(ref, got)]}")
    for a, i in zip(want, interp):
        # the tolerance below is no wider than JAX's own spread
        assert np.abs(a - np.asarray(i)).max() < 0.1 * np.abs(a).max()
    for a, b, r in zip(want, got, ref):
        a, b, r = np.asarray(a), b.numpy(), r.numpy()
        assert b.shape == a.shape and np.isfinite(b).all()
        assert np.abs(a - b).max() < 0.1 * np.abs(a).max()
        # full-yolov3 drift gate of tests/test_quantize.py
        assert np.abs(r - b).max() / (np.abs(r).max() + 1e-9) < 0.15
    got_d = tdecode.decode_heads(got, spec_t, reso).numpy()
    ref_d = tdecode.decode_heads(ref, spec_t, reso).numpy()
    assert ((got_d[..., 4] > 0.6) == (ref_d[..., 4] > 0.6)).mean() > 0.9
