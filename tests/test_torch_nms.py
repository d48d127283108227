"""The port's NMS against the JAX package: suppression, rows and order.

Survivors, row order and validity must be identical (integer and mask
outputs); box columns are computed by the same fp32 operations from the
same inputs and must be identical too.  The plain suppressor is what the
port runs on the CPU, and what chip_smoke.py holds the CUDA kernel
against on the card.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtimeobjectdetection_tpu.ops import decode as jdecode
from realtimeobjectdetection_tpu.ops import nms as jnms
from realtimeobjectdetection_tpu.models import zoo as jzoo
from realtimeobjectdetection_tpu_torch import model as tmodel
from realtimeobjectdetection_tpu_torch import testing as ttesting
from realtimeobjectdetection_tpu_torch import weights as tweights
from realtimeobjectdetection_tpu_torch.models import zoo as tzoo
from realtimeobjectdetection_tpu_torch.ops import decode as tdecode
from realtimeobjectdetection_tpu_torch.ops import nms as tnms
from realtimeobjectdetection_tpu_torch.ops.cuda.nms_kernel import (
    nms_suppress, nms_suppress_plain)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
SETTINGS = [(True, True), (False, False)]  # (plus_one, ge): v3 and v5


def dense_candidates(k, plus_one, seed):
    """Random dense boxes with exact-threshold pairs at the front: a box
    and one twice its height from the same corner have IoU 0.5 exactly."""
    rng = np.random.RandomState(seed)
    cx, cy = rng.uniform(50, 350, (2, k))
    w, h = rng.uniform(20, 120, (2, k))
    corners = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], 1)
    cls = rng.randint(0, 6, k)
    valid = rng.rand(k) > 0.15
    side = 9.0 if plus_one else 10.0
    for p in range(6):
        x0, y0 = 40.0 * p, float(rng.randint(0, 300))
        corners[2 * p] = [x0, y0, x0 + side, y0 + side]
        corners[2 * p + 1] = [x0, y0, x0 + side,
                              y0 + 2 * side + (1 if plus_one else 0)]
        cls[2 * p:2 * p + 2] = 10 + p
        valid[2 * p:2 * p + 2] = True
    return (corners.astype(np.float32), cls.astype(np.int32), valid)


@pytest.mark.parametrize("k", [160, 300])
@pytest.mark.parametrize("plus_one,ge", SETTINGS)
def test_plain_suppressor_matches_pallas_and_scan(k, plus_one, ge):
    corners, cls, valid = dense_candidates(k, plus_one, seed=k)
    j_args = (jnp.asarray(corners), jnp.asarray(cls), jnp.asarray(valid),
              0.5, plus_one, ge)
    scan = np.asarray(jnms._greedy_suppress(*j_args, use_pallas=False,
                                            algorithm="scan"))
    pallas = np.asarray(jnms._greedy_suppress(*j_args, use_pallas=True,
                                              interpret=True))
    got = nms_suppress(torch.from_numpy(corners)[None],
                       torch.from_numpy(cls)[None],
                       torch.from_numpy(valid)[None], 0.5, plus_one, ge)
    assert got.dtype == torch.bool and got.shape == (1, k)
    np.testing.assert_array_equal(got[0].numpy(), scan)
    np.testing.assert_array_equal(got[0].numpy(), pallas)
    # exact-threshold pairs: the second box survives only under strict >
    assert (got[0, 1:12:2] == (not ge)).all()
    assert 0 < int(got.sum()) < int(valid.sum())  # real suppression


def test_plain_suppressor_batches_images_independently():
    sets = [dense_candidates(96, True, seed=s) for s in range(3)]
    corners, cls, valid = (torch.from_numpy(np.stack(a)) for a in zip(*sets))
    batched = nms_suppress_plain(corners, cls, valid, 0.45)
    for i in range(3):
        one = nms_suppress_plain(corners[i:i + 1], cls[i:i + 1],
                                 valid[i:i + 1], 0.45)
        assert torch.equal(batched[i:i + 1], one)


def test_suppressor_rejects_other_devices():
    corners = torch.zeros(1, 8, 4, device="meta")
    cls = torch.zeros(1, 8, dtype=torch.int32, device="meta")
    valid = torch.zeros(1, 8, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="device"):
        nms_suppress(corners, cls, valid, 0.5)


@pytest.mark.parametrize("name", ["yolov3-tiny", "yolov3"])
@pytest.mark.parametrize("conf_key,rows_key,top_k", [
    ("nms_confidence", "nms_rows", 512),
    ("nms_confidence_dense", "nms_rows_dense", 1024)])
def test_nms_batch_matches_jax_and_goldens(name, conf_key, rows_key, top_k):
    d = np.load(os.path.join(GOLDEN, f"{name}_dog.npz"))
    pred, conf = d["pred"], float(d[conf_key])
    jb, jv, jc = (np.asarray(a) for a in jnms.nms_batch(
        jnp.asarray(pred), 80, conf, 0.5, top_k=top_k, with_stats=True))
    tb, tv, tc = (a.numpy() for a in tnms.nms_batch(
        torch.from_numpy(pred), 80, conf, 0.5, top_k=top_k, with_stats=True))
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tb[tv], jb[jv])
    ref = d[rows_key]
    got = tb[0][tv[0]]
    assert got.shape[0] == ref.shape[0]
    np.testing.assert_array_equal(got[:, 6], ref[:, 7])
    np.testing.assert_allclose(got[:, 4:6], ref[:, 5:7], atol=1e-5)
    np.testing.assert_allclose(got[:, :4], ref[:, 1:5], atol=1e-2)


def test_nms_tiebreak_golden():
    pred = ttesting.nms_tiebreak_pred()
    ref = np.load(os.path.join(GOLDEN, "nms_tiebreak.npz"))["rows"]
    boxes, valid = tnms.nms_image(torch.from_numpy(pred), 4, confidence=0.6,
                                  nms_thresh=0.5, top_k=16)
    jboxes, jvalid = jnms.nms_image(jnp.asarray(pred), 4, confidence=0.6,
                                    nms_thresh=0.5, top_k=16)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    got = boxes.numpy()[valid.numpy()]
    np.testing.assert_array_equal(got, np.asarray(jboxes)[np.asarray(jvalid)])
    assert got.shape[0] == ref.shape[0]
    np.testing.assert_array_equal(got[:, 6], ref[:, 7])
    np.testing.assert_allclose(got[:, 4], ref[:, 5], atol=1e-6)
    np.testing.assert_allclose(got[:, :4], ref[:, 1:5], atol=1e-4)


def test_decode_topk_survivors_equal_full_decode():
    """The fused top-k decode feeds NMS the same survivors as the full
    decode, and selects the same rows and counts as JAX's decode_topk."""
    d = np.load(os.path.join(GOLDEN, "yolov3-tiny_dog.npz"))
    spec = tzoo.get_spec("yolov3-tiny")
    params, _ = tweights.load_darknet_weights(
        spec, ttesting.synthetic_darknet_weights(spec, 0))
    x = torch.from_numpy(d["input_nchw"].transpose(0, 2, 3, 1).copy())
    heads = tmodel.make_forward(spec, bn_mode="batch")(params, x)
    conf, k = float(d["nms_confidence_dense"]), 512
    full_b, full_v = tnms.nms_batch(tdecode.decode_heads(heads, spec, 416),
                                    80, conf, 0.5, top_k=k)
    pred, n_cand = tdecode.decode_topk(heads, spec, 416, k, confidence=conf)
    top_b, top_v = tnms.nms_batch(pred, 80, conf, 0.5, top_k=k)
    assert torch.equal(full_v, top_v)
    np.testing.assert_allclose(top_b[top_v].numpy(), full_b[full_v].numpy(),
                               atol=1e-4)
    jpred, jn = jdecode.decode_topk([jnp.asarray(h.numpy()) for h in heads],
                                    jzoo.get_spec("yolov3-tiny"), 416, k,
                                    confidence=conf)
    np.testing.assert_array_equal(n_cand.numpy(), np.asarray(jn))
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), atol=1e-4)
    with pytest.raises(NotImplementedError):
        tdecode.decode_topk(heads, spec, 416, k, approx=True)
