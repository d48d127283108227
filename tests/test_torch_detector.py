"""The port's host prep, folder detector and CLI against the JAX package.

* letterbox: the port's cv2 path equals JAX's bit for bit; its native C++
  letterbox equals JAX's native one bit for bit, and cv2 within one u8
  step (the fixed-point pipeline's documented bound).
* DetectorV3 on yolov3-tiny at batch 1 over synthetic COCO JPEGs: equal
  ``metrics.json`` keys, row counts, class ids, image indices and int-0
  sentinels; objectness and class confidence within 1e-3, box corners
  within 0.01 px.  The two forwards sum in another order, and a head
  difference of 1e-5 grows by exp(raw wh) * anchor (anchors up to 344 px)
  into the corners: the largest corner difference seen here is 0.0088 px
  (1, 2, 6 and 8 CPU threads), the largest score difference 8.5e-6.
* entry points without CUDA raise unless the caller asks for the CPU.
"""

import json
import os
import runpy
import sys

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from realtimeobjectdetection_tpu import native as jnative
from realtimeobjectdetection_tpu.ops import letterbox as jlb
from realtimeobjectdetection_tpu.pipeline.detector import \
    DetectorV3 as JDetectorV3
from realtimeobjectdetection_tpu.testing import make_synthetic_coco
from realtimeobjectdetection_tpu_torch import native as tnative
from realtimeobjectdetection_tpu_torch.models import get_spec
from realtimeobjectdetection_tpu_torch.ops import letterbox as tlb
from realtimeobjectdetection_tpu_torch.pipeline.detector import DetectorV3
from realtimeobjectdetection_tpu_torch.testing import synthetic_darknet_weights

SIZES = [(480, 640), (600, 400), (416, 416), (123, 457)]


def test_host_letterbox_matches_jax():
    rng = np.random.RandomState(1)
    imgs = [rng.randint(0, 256, (h, w, 3), np.uint8) for h, w in SIZES]
    for img in imgs:
        np.testing.assert_array_equal(tlb.prep_image_host_u8(img, 416),
                                      jlb.prep_image_host_u8(img, 416))
        np.testing.assert_array_equal(tlb.prep_image_host(img, 320, "RGB"),
                                      jlb.prep_image_host(img, 320, "RGB"))
        for fn in ("letterbox_params", "letterbox_params_round"):
            assert getattr(tlb, fn)(img.shape[1], img.shape[0], 416) \
                == getattr(jlb, fn)(img.shape[1], img.shape[0], 416)
    rows = rng.uniform(0, 416, (5, 7)).astype(np.float32)
    np.testing.assert_array_equal(tlb.unletterbox_boxes(rows, 640, 480, 416),
                                  jlb.unletterbox_boxes(rows, 640, 480, 416))
    got = tnative.letterbox_batch_native(imgs, 416)
    np.testing.assert_array_equal(got, jnative.letterbox_batch_native(imgs,
                                                                      416))
    for img, a in zip(imgs, got):
        b = tlb.prep_image_host_u8(img, 416)[0]
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    np.testing.assert_array_equal(tnative.resize_cubic_native(imgs[0], 77, 91),
                                  jnative.resize_cubic_native(imgs[0], 77, 91))
    with pytest.raises(ValueError):
        tnative.letterbox_batch_native([imgs[0][..., 0]], 416)


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    _, img_dir = make_synthetic_coco(root, n_images=3, img_size=(200, 300))
    blob = synthetic_darknet_weights(get_spec("yolov3-tiny"), 0)
    wpath = root / "tiny.weights"
    wpath.write_bytes(blob)
    return img_dir, str(wpath), root


def _match_rows(g, w):
    """``w`` reordered to pair each row of ``g`` with the row of the same
    class and the nearest corners (a one-to-one match)."""
    dist = np.abs(g[:, None, 1:5] - w[None, :, 1:5]).max(-1)
    dist[g[:, None, 7] != w[None, :, 7]] = np.inf
    pick = dist.argmin(1)
    assert len(set(pick.tolist())) == len(pick)
    return w[pick]


def _compare_metrics(got, want, any_order=False):
    assert set(got) == set(want)
    for k in want:
        g, w = got[k], want[k]
        assert isinstance(g, int) == isinstance(w, int), k
        if isinstance(w, int):
            assert g == w == 0
            continue
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (k, g.shape, w.shape)
        if any_order:
            w = _match_rows(g, w)
        np.testing.assert_array_equal(g[:, 0], w[:, 0])  # image index
        np.testing.assert_array_equal(g[:, 7], w[:, 7])  # class ids
        np.testing.assert_allclose(g[:, 1:5], w[:, 1:5], atol=0.01)
        np.testing.assert_allclose(g[:, 5:7], w[:, 5:7], atol=1e-3)


@pytest.mark.parametrize("confidence,host_prep", [(0.6, "cv2"),
                                                  (0.6, "native"),
                                                  (0.9999, "cv2")])
def test_detector_matches_jax(coco, tmp_path, confidence, host_prep):
    img_dir, wpath, _ = coco
    kw = dict(images=img_dir, cfg_path="yolov3-tiny", weights_path=wpath,
              resolution=416, confidence=confidence, nms_thresh=0.5,
              top_k=512, host_prep=host_prep)
    want = JDetectorV3(destination=str(tmp_path / "jax"), precision="highest",
                       **kw)(verbose=False)
    det = DetectorV3(destination=str(tmp_path / "torch"), device="cpu", **kw)
    got = det(verbose=False)
    _compare_metrics(got, want)
    saved = json.load(open(tmp_path / "torch" / "metrics.json"))
    assert saved == json.loads(json.dumps(got))
    if confidence < 0.9:
        assert any(not isinstance(v, int) for v in got.values())
        name = next(k for k, v in got.items() if not isinstance(v, int))
        assert os.path.exists(tmp_path / "torch" / f"det_yolov3-tiny_{name}")
    else:
        assert all(v == 0 for v in got.values())


def test_detector_batched_fused_fold_path(coco, tmp_path):
    """Batch 2 over 3 images (padded trailing batch), folded BN, fused
    top-k decode: the same rows as the full decode at batch 1.  Rows of
    one class with equal fp32 objectness may come in either order: the
    full decode orders them by row index, the fused one by raw logit
    (the JAX package's documented corner case)."""
    img_dir, wpath, _ = coco
    kw = dict(images=img_dir, cfg_path="yolov3-tiny", weights_path=wpath,
              confidence=0.6, top_k=512, bn_mode="fold", device="cpu")
    one = DetectorV3(destination=str(tmp_path / "a"), **kw)(verbose=False)
    two = DetectorV3(destination=str(tmp_path / "b"), batch_size=2,
                     fused_decode=True, **kw)
    got = two(verbose=False)
    _compare_metrics(got, one, any_order=True)
    x = torch.from_numpy(np.zeros((2, 416, 416, 3), np.uint8))
    boxes, valid, counts = two.detect_batch(x)
    assert boxes.shape == (2, 512, 7) and valid.shape == (2, 512)
    assert counts.dtype == torch.int32


def test_detector_rejects_unported_options(coco, tmp_path):
    img_dir, wpath, root = coco
    kw = dict(images=img_dir, destination=str(tmp_path),
              cfg_path="yolov3-tiny", weights_path=wpath, device="cpu")
    for extra in ({"quantize": "w8a8_pallas"}, {"pipeline_stages": 2},
                  {"mesh": True}, {"scan_ladders": True}):
        with pytest.raises(NotImplementedError):
            DetectorV3(**kw, **extra)
    with pytest.raises(NotImplementedError):
        DetectorV3(**dict(kw, weights_path=str(root)))
    with pytest.raises(ValueError):
        DetectorV3(**kw, resolution=400)
    with pytest.raises(TypeError):  # the device picks the suppressor
        DetectorV3(**kw, use_pallas_nms=True)
    with pytest.raises(ValueError):
        DetectorV3(**kw, precision="medium")


def test_detector_precision_sets_tf32(coco, tmp_path):
    img_dir, wpath, _ = coco
    kw = dict(images=img_dir, destination=str(tmp_path),
              cfg_path="yolov3-tiny", weights_path=wpath, device="cpu")
    old = torch.backends.cudnn.allow_tf32
    try:
        for precision, tf32 in (("highest", False), ("high", True),
                                ("default", True), (None, "unchanged")):
            for start in (False, True):
                torch.backends.cudnn.allow_tf32 = start
                with DetectorV3(**kw, precision=precision)._precision():
                    assert torch.backends.cudnn.allow_tf32 == (
                        start if tf32 == "unchanged" else tf32)
                assert torch.backends.cudnn.allow_tf32 == start
    finally:
        torch.backends.cudnn.allow_tf32 = old


def test_entry_points_need_cuda_unless_cpu_is_asked(coco, tmp_path,
                                                    monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    img_dir, wpath, _ = coco
    from realtimeobjectdetection_tpu_torch import cli
    with pytest.raises(RuntimeError, match="CUDA"):
        DetectorV3(img_dir, str(tmp_path), "yolov3-tiny", wpath)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["detect", "--images", img_dir, "--det", str(tmp_path),
                  "--cfg", "yolov3-tiny", "--weights", wpath])
    with pytest.raises(NotImplementedError):
        cli.main(["train"])
    # the module entry point runs the detect CLI on the CPU when asked
    dest = tmp_path / "cli"
    monkeypatch.setattr(sys, "argv", [
        "realtimeobjectdetection_tpu_torch", "detect", "--images", img_dir,
        "--det", str(dest), "--cfg", "yolov3-tiny", "--weights", wpath,
        "--confidence", "0.6", "--device", "cpu"])
    with pytest.raises(SystemExit) as done:
        runpy.run_module("realtimeobjectdetection_tpu_torch",
                         run_name="__main__")
    assert not done.value.code
    assert len(json.load(open(dest / "metrics.json"))) == 3
