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
from realtimeobjectdetection_tpu_torch.testing import (bench_params,
                                                       synthetic_darknet_weights)
from realtimeobjectdetection_tpu_torch.weights import export_darknet_weights

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


def _match_rows(g, w, same_class=True):
    """``w`` reordered to pair each row of ``g`` with the row of the
    nearest corners (and the same class, unless ``same_class`` is False):
    a one-to-one match."""
    dist = np.abs(g[:, None, 1:5] - w[None, :, 1:5]).max(-1)
    if same_class:
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
    for extra in ({"pipeline_stages": 2}, {"mesh": True},
                  {"scan_ladders": True}):
        with pytest.raises(NotImplementedError):
            DetectorV3(**kw, **extra)
    # int8 needs folded BN, as in the JAX package; an unknown mode fails
    jkw = {k: v for k, v in kw.items() if k != "device"}
    for bn_mode in ("batch", "running"):
        with pytest.raises(ValueError, match="fold"):
            DetectorV3(**kw, quantize="w8a8_pallas", bn_mode=bn_mode)
        with pytest.raises(ValueError, match="fold"):
            JDetectorV3(**jkw, quantize="w8", bn_mode=bn_mode)
    with pytest.raises(ValueError):
        DetectorV3(**kw, quantize="int4", bn_mode="fold")
    with pytest.raises(NotImplementedError):
        DetectorV3(**dict(kw, weights_path=str(root)))
    with pytest.raises(ValueError):
        DetectorV3(**kw, resolution=400)
    with pytest.raises(TypeError):  # the device picks the suppressor
        DetectorV3(**kw, use_pallas_nms=True)
    with pytest.raises(ValueError):
        DetectorV3(**kw, precision="medium")


@pytest.fixture(scope="module")
def bench_weights(coco):
    """yolov3-tiny with the benchmark weights: with folded BN the
    synthetic weights saturate every image (over 1500 candidates past
    confidence 0.6, so the top-k cut decides the rows), these give 17
    rows an image at confidence 0.7."""
    _, _, root = coco
    spec = get_spec("yolov3-tiny")
    wpath = root / "tiny_bench.weights"
    wpath.write_bytes(export_darknet_weights(
        spec, bench_params(spec, "yolov3-tiny")))
    return str(wpath)


@pytest.mark.parametrize("quantize", ["w8", "w8a8", "w8a8_pallas"])
def test_int8_detector_matches_jax(coco, bench_weights, tmp_path,
                                   monkeypatch, quantize):
    """``quantize`` in both detectors (folded BN; for w8a8_pallas JAX's
    conv is ``conv_flat_int8_reference`` and both run bf16 activations).

    w8 keeps fp32 activations: rows as ``_compare_metrics`` compares
    them.  With int8 activations a last-bit difference can flip an int8
    rounding, and the flips cascade (tests/test_torch_quantize.py): the
    same boxes, in an order that may differ, corners within 0.01 px and
    scores within 0.02 (0.0041 px and 0.0088 seen).  The benchmark
    weights give every class a confidence within 0.001 of 0.5, so the
    arg-max class of a box can flip too: classes agree on at least 90% of
    the rows (all but one of 51 seen).  Run with ``-s``, the test prints
    these differences."""
    from realtimeobjectdetection_tpu import model_int8 as jmodel_int8
    from realtimeobjectdetection_tpu.ops.pallas import conv_int8 as jconv
    img_dir, _, _ = coco

    def reference(*args, interpret=False, **kw):
        return jconv.conv_flat_int8_reference(*args, **kw)

    monkeypatch.setattr(jmodel_int8, "conv_flat_int8", reference)
    kw = dict(images=img_dir, cfg_path="yolov3-tiny",
              weights_path=bench_weights, resolution=416, confidence=0.7,
              nms_thresh=0.5, top_k=512, bn_mode="fold", quantize=quantize)
    want = JDetectorV3(destination=str(tmp_path / "jax"),
                       precision="highest", **kw)(verbose=False)
    if quantize == "w8":
        # through the CLI: --quantize reaches the detector
        from realtimeobjectdetection_tpu_torch import cli
        cli.main(["detect", "--images", img_dir, "--det",
                  str(tmp_path / "torch"), "--cfg", "yolov3-tiny",
                  "--weights", bench_weights, "--confidence", "0.7",
                  "--top_k", "512", "--bn_mode", "fold", "--quantize",
                  "w8", "--device", "cpu"])
        got = json.load(open(tmp_path / "torch" / "metrics.json"))
        _compare_metrics(got, want)
        return
    det = DetectorV3(destination=str(tmp_path / "torch"), device="cpu",
                     **kw)
    assert det.params["node_0"]["w_q"].dtype == torch.int8
    got = det(verbose=False)
    assert set(got) == set(want)
    pairs = []
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape and g.shape[0] > 0, k
        pairs.append((g, _match_rows(g, w, same_class=False)))
    n_rows = sum(g.shape[0] for g, _ in pairs)
    n_same = sum(int((g[:, 7] == w[:, 7]).sum()) for g, w in pairs)
    # shown with -s
    print(f"\n{quantize}: {n_rows} rows, corners at most "
          f"{max(np.abs(g[:, 1:5] - w[:, 1:5]).max() for g, w in pairs):.3g}"
          f" px, scores at most "
          f"{max(np.abs(g[:, 5:7] - w[:, 5:7]).max() for g, w in pairs):.3g}"
          f", {n_rows - n_same} class flips")
    for g, w in pairs:
        np.testing.assert_array_equal(g[:, 0], w[:, 0])
        np.testing.assert_allclose(g[:, 1:5], w[:, 1:5], atol=0.01)
        np.testing.assert_allclose(g[:, 5:7], w[:, 5:7], atol=0.02)
    assert n_same >= 0.9 * n_rows


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
