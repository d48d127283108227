"""The port's forward and decode against the JAX package and the goldens.

* yolov3-tiny at 160x160, batch 2, in all three BN modes, fp32: heads
  within 1e-4 of JAX's (sums run in another order; heads are O(5)).
* bf16 convs and activations (the serving setting): within 0.1 of JAX's
  bf16 heads — three bf16 ulps at the heads' magnitude (< 8), for
  roundings at other places in the two frameworks.
* full width (yolov3 and yolov3-tiny at 416): the port's decoded
  predictions against the reference's goldens with the tolerances of
  tests/test_forward_parity.py (coords 0.35 px, probabilities 2e-4).
  Torch only: JAX runs no full yolov3 here.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtimeobjectdetection_tpu import model as jmodel
from realtimeobjectdetection_tpu import testing as jtesting
from realtimeobjectdetection_tpu import weights as jweights
from realtimeobjectdetection_tpu.models import zoo as jzoo
from realtimeobjectdetection_tpu.ops import decode as jdecode
from realtimeobjectdetection_tpu_torch import model as tmodel
from realtimeobjectdetection_tpu_torch import testing as ttesting
from realtimeobjectdetection_tpu_torch import weights as tweights
from realtimeobjectdetection_tpu_torch.models import zoo as tzoo
from realtimeobjectdetection_tpu_torch.ops import decode as tdecode

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
RESO = 160


@pytest.fixture(scope="module")
def tiny():
    spec_j = jzoo.get_spec("yolov3-tiny", width=RESO, height=RESO)
    spec_t = tzoo.get_spec("yolov3-tiny", width=RESO, height=RESO)
    blob = jtesting.synthetic_darknet_weights(spec_j, 0)
    jp, _ = jweights.load_darknet_weights(spec_j, blob)
    tp, _ = tweights.load_darknet_weights(spec_t, blob)
    x = np.random.RandomState(0).rand(2, RESO, RESO, 3).astype(np.float32)
    return spec_j, spec_t, jp, tp, x


@pytest.mark.parametrize("bn_mode", ["fold", "running", "batch"])
def test_tiny_heads_match_jax(tiny, bn_mode):
    spec_j, spec_t, jp, tp, x = tiny
    if bn_mode == "fold":
        jp = jmodel.fold_batchnorm(spec_j, jp)
        tp = tmodel.fold_batchnorm(spec_t, tp)
    jh = jax.jit(jmodel.make_forward(spec_j, bn_mode=bn_mode))(
        jp, jnp.asarray(x))
    th = tmodel.make_forward(spec_t, bn_mode=bn_mode)(tp, torch.from_numpy(x))
    assert [tuple(h.shape) for h in th] == tmodel.head_shapes(spec_t, 2) \
        == jmodel.head_shapes(spec_j, 2)
    for a, b in zip(jh, th):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4)
    jd = np.asarray(jdecode.decode_heads(jh, spec_j, RESO))
    td = tdecode.decode_heads(th, spec_t, RESO).numpy()
    np.testing.assert_allclose(td[..., 4:], jd[..., 4:], atol=1e-4)
    np.testing.assert_allclose(td[..., :4], jd[..., :4], rtol=1e-3, atol=0.05)
    np.testing.assert_allclose(
        tdecode.decode_heads(th, spec_t, RESO, train=True).numpy(),
        np.asarray(jdecode.decode_heads(jh, spec_j, RESO, train=True)),
        atol=1e-4)


def test_tiny_bf16_heads_match_jax(tiny):
    spec_j, spec_t, jp, tp, x = tiny
    bf_j, bf_t = jnp.bfloat16, torch.bfloat16
    jh = jax.jit(jmodel.make_forward(
        spec_j, bn_mode="fold", compute_dtype=bf_j, activation_dtype=bf_j,
        head_dtype=bf_j))(jmodel.fold_batchnorm(spec_j, jp), jnp.asarray(x))
    th = tmodel.make_forward(
        spec_t, bn_mode="fold", compute_dtype=bf_t, activation_dtype=bf_t,
        head_dtype=bf_t)(tmodel.fold_batchnorm(spec_t, tp),
                         torch.from_numpy(x))
    for a, b in zip(jh, th):
        assert b.dtype == torch.bfloat16
        np.testing.assert_allclose(b.float().numpy(),
                                   np.asarray(a).astype(np.float32), atol=0.1)


def test_make_forward_rejects_unported_options():
    spec = tzoo.get_spec("yolov3-tiny")
    for kw in ({"scan_ladders": True}, {"s2d_stem": True},
               {"stage_range": (0, 4)}, {"return_stats": True}):
        with pytest.raises(NotImplementedError):
            tmodel.make_forward(spec, **kw)
    with pytest.raises(ValueError):
        tmodel.make_forward(spec, bn_mode="batch1p")
    # int8 needs folded BN (an assert in the JAX package); an unknown
    # mode fails
    for bn_mode in ("batch", "running"):
        with pytest.raises(ValueError, match="fold"):
            tmodel.make_forward(spec, bn_mode=bn_mode,
                                quantize="w8a8_pallas")
    with pytest.raises(ValueError):
        tmodel.make_forward(spec, quantize="int4")


@pytest.mark.parametrize("name", ["yolov3-tiny", "yolov3"])
def test_full_width_forward_matches_goldens(name):
    d = np.load(os.path.join(GOLDEN, f"{name}_dog.npz"))
    spec = tzoo.get_spec(name)
    params, _ = tweights.load_darknet_weights(
        spec, ttesting.synthetic_darknet_weights(spec, 0))
    x = torch.from_numpy(d["input_nchw"].transpose(0, 2, 3, 1).copy())
    with torch.inference_mode():
        heads = tmodel.make_forward(spec, bn_mode="batch")(params, x)
        pred = tdecode.decode_heads(heads, spec, 416).numpy()
    ref = d["pred"]
    assert pred.shape == ref.shape
    np.testing.assert_allclose(pred[..., :4], ref[..., :4], atol=0.35)
    np.testing.assert_allclose(pred[..., 4:], ref[..., 4:], atol=2e-4)
    np.testing.assert_array_equal(
        np.array(spec.anchors_in_detection_order, np.float32), d["anchors"])
