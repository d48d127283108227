"""Folder detection pipeline — the port of the JAX package's ``DetectorV3``.

Pipeline (reference: detect.py:22-252):
  read folder -> host letterbox (cv2 INTER_CUBIC parity path, or the
  native C++ letterbox) -> ONE device program per batch (``/255``,
  forward, decode, fixed-shape NMS with the CUDA suppression kernel) ->
  host: un-letterbox to original pixels, clamp, render, ``metrics.json``.

Observable-protocol parity at batch_size=1 (the reference hardcodes it,
detect.py:27):

* ``metrics.json``: ``{img_name: [[batch_idx, x1,y1,x2,y2, obj, cls_conf,
  cls_id], ...]}`` with boxes in *letterbox input space* (detect.py:155
  dumps before rescaling) and the int ``0`` sentinel when nothing is
  detected (detect.py:164).
* box rescale to original pixels hardcodes 416 in the scaling factor
  (detect.py:130) regardless of ``--reso``; ``parity_scale_416`` keeps
  that, off by default for non-416 resolutions.
* rendered files named ``det_<cfg-stem>_<img-name>`` (detect.py:114-117).

Deviations (documented): partial trailing batches are processed, not
dropped; box colors are deterministic per class.
"""

from __future__ import annotations

import contextlib
import json
import os
import queue
import sys
import threading
import time
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.classnames import COCO80, load_classes
from ..device import resolve_device
from ..model import QUANTIZE_MODES, fold_batchnorm, make_forward
from ..models.zoo import resolve_spec
from ..ops.decode import decode_heads, decode_topk
from ..ops.letterbox import prep_image_host_u8
from ..ops.nms import nms_batch
from ..ops.quantize import quantize_folded_int8
from ..weights import (init_params, load_darknet_weights,
                       params_from_torch_state_dict)
from .render import draw_detection, make_palette

__all__ = ["DetectorV3"]

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".ppm", ".webp")


class DetectorV3:
    """YOLOv3/v3-tiny folder detector.

    Args mirror the JAX package's constructor, with its defaults.  The
    port adds ``device`` (``"cuda"`` unless the caller asks for the CPU;
    raises when CUDA is absent) and ``activation_dtype`` (inter-layer
    activations and heads, e.g. ``torch.bfloat16``; None keeps fp32).
    ``precision`` sets TF32 for the fp32 convs: ``"highest"`` turns it
    off, ``"default"`` and ``"high"`` turn it on (the counterparts of the
    JAX package's reduced-precision passes), None leaves the process's
    setting.  The port has no ``use_pallas_nms``: the suppression follows
    the device (the CUDA kernel on the card, its plain version on the
    CPU).  ``quantize`` (``"w8"``, ``"w8a8"`` or ``"w8a8_pallas"``, with
    ``bn_mode="fold"``) folds BN and then quantizes the kernels to int8
    (``ops.quantize``); ``"w8a8_pallas"`` runs the tap-matmul kernel,
    with bf16 activations unless ``activation_dtype`` says otherwise, as
    in the JAX package.  ``scan_ladders``, ``mesh``, ``pipeline_stages``
    and checkpoint directories are not ported and raise.
    """

    def __init__(self, images: str, destination: str, cfg_path: str,
                 weights_path: Optional[str], resolution: int = 416,
                 confidence: float = 0.6, nms_thresh: float = 0.5,
                 use_torch_weights: bool = False,
                 batch_size: int = 1, bn_mode: str = "batch",
                 compute_dtype=torch.float32, top_k: int = 256,
                 num_classes: int = 80,
                 class_names: Optional[Sequence[str]] = None,
                 names_file: Optional[str] = None,
                 parity_scale_416: Optional[bool] = None,
                 precision: Optional[str] = None,
                 scan_ladders: Optional[bool] = None,
                 quantize: Optional[str] = None,
                 fused_decode: bool = False,
                 mesh=None,
                 pipeline_stages: Optional[int] = None,
                 prefetch: int = 4,
                 host_prep: str = "cv2",
                 activation_dtype=None,
                 device="cuda"):
        unported = {"scan_ladders": scan_ladders, "mesh": mesh,
                    "pipeline_stages": pipeline_stages}
        asked = sorted(k for k, v in unported.items() if v)
        if asked:
            raise NotImplementedError(
                f"DetectorV3 options {asked} are not ported (ROADMAP.md)")
        if quantize is not None and quantize not in QUANTIZE_MODES:
            raise ValueError(f"unknown quantize mode {quantize!r}")
        if quantize and bn_mode != "fold":
            raise ValueError("quantize requires bn_mode='fold'")
        if resolution % 32 != 0 or resolution <= 32:  # detect.py:51-52
            raise ValueError(f"resolution must be a multiple of 32 above 32,"
                             f" got {resolution}")
        # host_prep: "cv2" = INTER_CUBIC via OpenCV (bit-parity with the
        # reference goldens); "native" = the in-repo C++ fixed-point
        # bicubic (native/letterbox.cpp, threaded across the batch)
        if host_prep not in ("cv2", "native"):
            raise ValueError(f"host_prep must be cv2 or native, got "
                             f"{host_prep!r}")
        if precision not in (None, "default", "high", "highest"):
            raise ValueError(f"unknown precision {precision!r}")
        self.device = resolve_device(device)
        self.host_prep = host_prep
        self.images = images
        self.destination = destination
        self.cfg_path = cfg_path
        self.resolution = int(resolution)
        self.confidence = float(confidence)
        self.nms_thresh = float(nms_thresh)
        self.batch_size = int(batch_size)
        self.top_k = top_k
        self.num_classes = num_classes
        self.prefetch = prefetch
        self.precision = precision
        self.fused_decode = fused_decode
        self.metrics: Dict[str, object] = {}
        # img_name -> candidate count, for images where more boxes
        # passed confidence than the static top_k budget could keep
        self.saturated: Dict[str, int] = {}
        if class_names is not None:
            self.classes = list(class_names)
        elif names_file:
            self.classes = load_classes(names_file)
        else:
            self.classes = COCO80
        if bn_mode == "batch" and self.batch_size > 1:
            warnings.warn(
                "bn_mode='batch' computes BatchNorm statistics across the "
                "whole device batch, coupling images (and differing from "
                "the reference's bs=1 behavior); use bn_mode='fold' or "
                "'running' for batched throughput runs")
        # reference behavior: scaling factor uses literal 416 (detect.py:130)
        if parity_scale_416 is None:
            parity_scale_416 = (self.resolution == 416)
        self.parity_scale_416 = parity_scale_416

        self.spec = resolve_spec(cfg_path)
        self.bn_mode = bn_mode
        params = self._load_params(weights_path, use_torch_weights)
        if quantize:
            # int8 inference (ops/quantize.py): fold first, then quantize
            params = quantize_folded_int8(
                self.spec, fold_batchnorm(self.spec, params))
        elif bn_mode == "fold":
            params = fold_batchnorm(self.spec, params)
        self.quantize = quantize
        # only float kernels take the compute dtype: int8 kernels, their
        # scales and the biases keep theirs
        self.params = {
            key: {name: (t.to(self.device, compute_dtype) if name == "w"
                         else t.to(self.device))
                  for name, t in entry.items()}
            for key, entry in params.items()}
        self._forward = make_forward(self.spec, bn_mode=bn_mode,
                                     compute_dtype=compute_dtype,
                                     activation_dtype=activation_dtype,
                                     head_dtype=activation_dtype,
                                     quantize=quantize)

    # ------------------------------------------------------------------
    def _load_params(self, weights_path, use_torch_weights):
        if weights_path is None:
            return init_params(self.spec)
        if use_torch_weights:
            sd = torch.load(weights_path, map_location="cpu")
            return params_from_torch_state_dict(self.spec, sd)
        if os.path.isdir(weights_path):
            raise NotImplementedError(
                "loading trainer checkpoint directories is not ported "
                "(ROADMAP.md)")
        params, _ = load_darknet_weights(self.spec, weights_path)
        return params

    @contextlib.contextmanager
    def _precision(self):
        """cuDNN's TF32 as ``precision`` asks, for the program's span."""
        old = torch.backends.cudnn.allow_tf32
        if self.precision is not None:
            torch.backends.cudnn.allow_tf32 = self.precision != "highest"
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32 = old

    def detect_batch(self, x: torch.Tensor):
        """The per-batch device program: a uint8 letterboxed RGB NHWC batch
        on ``self.device`` -> ``(boxes [B, top_k, 7], valid [B, top_k],
        n_candidates [B])`` on the device, without a host sync."""
        spec, reso = self.spec, self.resolution
        conf, nms_t, top_k = self.confidence, self.nms_thresh, self.top_k
        with torch.inference_mode(), self._precision():
            # normalise on the device: uploading uint8 quarters the
            # host->device traffic; values identical
            heads = self._forward(self.params, x.float() / 255.0)
            if self.fused_decode:
                # serving fast path: decode only the top_k objectness
                # rows; n_candidates still counts over all N rows
                pred, n_cand = decode_topk(heads, spec, reso, top_k,
                                           confidence=conf)
                boxes, valid = nms_batch(pred, self.num_classes, conf, nms_t,
                                         top_k=top_k)
                return boxes, valid, n_cand
            pred = decode_heads(heads, spec, reso)
            return nms_batch(pred, self.num_classes, conf, nms_t,
                             top_k=top_k, with_stats=True)

    # ------------------------------------------------------------------
    def _read_directory(self) -> List[str]:
        d = self.images
        if os.path.isdir(d):
            return [f for f in os.listdir(d) if f.lower().endswith(_IMG_EXTS)]
        if os.path.isfile(d):
            self.images, name = os.path.split(d)
            return [name]
        raise FileNotFoundError(
            "No file or directory with the name {}".format(d))

    def _loader_thread(self, names: List[str], q: "queue.Queue"):
        # per-image decode+letterbox fans out over a small thread pool
        # (cv2 releases the GIL)
        import cv2
        workers = max(1, min(4, os.cpu_count() or 1))
        pool = None
        if workers > 1:
            from concurrent.futures import ThreadPoolExecutor
            pool = ThreadPoolExecutor(workers,
                                      thread_name_prefix="rodtorch-det")

        def _load_one(n):
            img = cv2.imread(os.path.join(self.images, n))
            if img is None:
                raise FileNotFoundError(os.path.join(self.images, n))
            prep = (prep_image_host_u8(img, self.resolution)
                    if self.host_prep != "native" else None)
            return img, (img.shape[1], img.shape[0]), prep

        try:
            bs = self.batch_size
            for start in range(0, len(names), bs):
                chunk = names[start:start + bs]
                loaded = (list(pool.map(_load_one, chunk)) if pool
                          else [_load_one(n) for n in chunk])
                imgs = [l[0] for l in loaded]
                dims = [l[1] for l in loaded]
                if self.host_prep == "native":
                    from ..native import letterbox_batch_native
                    batch = letterbox_batch_native(imgs, self.resolution)
                else:
                    batch = np.concatenate([l[2] for l in loaded], axis=0)
                if len(chunk) < bs:
                    # pad the trailing batch to the static shape by
                    # repeating the last real image: zero frames would
                    # pollute batch-statistics BN for the real images
                    pad = np.repeat(batch[-1:], bs - len(chunk), axis=0)
                    batch = np.concatenate([batch, pad], axis=0)
                q.put((start, chunk, imgs, dims, batch))
            q.put(None)
        except BaseException as e:  # surface loader errors to the consumer
            q.put(e)
        finally:
            if pool is not None:
                pool.shutdown(wait=False, cancel_futures=True)

    # ------------------------------------------------------------------
    def __call__(self, verbose: bool = True) -> Dict[str, object]:
        os.makedirs(self.destination, exist_ok=True)
        names = self._read_directory()
        if verbose:
            print("Number of Images= ", len(names))
        palette = make_palette(100)
        cfg_stem = os.path.basename(self.cfg_path)
        if cfg_stem.endswith(".cfg"):
            cfg_stem = cfg_stem[:-4]

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        t = threading.Thread(target=self._loader_thread, args=(names, q),
                             daemon=True)
        t.start()

        # one batch of device work kept in flight: enqueue batch i+1
        # before reading batch i back, so host render/IO and the
        # host<->device round trip overlap device compute
        pending = None
        while True:
            item = q.get()
            if isinstance(item, BaseException):
                raise item
            if item is not None:
                start_idx, chunk, imgs, dims, batch = item
                t0 = time.time()
                x = torch.from_numpy(batch).to(self.device, non_blocking=True)
                item = (start_idx, chunk, imgs, dims, t0,
                        self.detect_batch(x))
            if pending is not None:
                self._drain(pending, palette, cfg_stem, verbose)
            if item is None:
                break
            pending = item
        t.join()

        metrics_file = os.path.join(self.destination, "metrics.json")
        with open(metrics_file, "w") as f:
            json.dump(self.metrics, f)
        return self.metrics

    def _drain(self, pending, palette, cfg_stem, verbose):
        start_idx, chunk, imgs, dims, t0, (boxes, valid, counts) = pending
        boxes = boxes.cpu().numpy()  # the readback waits for the device
        valid = valid.cpu().numpy()
        counts = counts.cpu().numpy()
        t1 = time.time()
        for j, img_name in enumerate(chunk):
            rows = boxes[j][valid[j]]
            if counts[j] > self.top_k:
                # the static top_k budget dropped the lowest-objectness
                # candidates; the reference NMS (src/util.py:242-346)
                # would have processed all of them — never lose boxes
                # silently
                self.saturated[img_name] = int(counts[j])
                print("WARNING: {}: {} boxes passed confidence but top_k={}"
                      " — raise --top_k to match the reference exactly"
                      .format(img_name, int(counts[j]), self.top_k),
                      file=sys.stderr)
            self._record_and_render(
                start_idx + j, img_name, rows, imgs[j], dims[j],
                palette, cfg_stem, (t1 - t0) / len(chunk), verbose)

    # ------------------------------------------------------------------
    def _record_and_render(self, img_idx, img_name, rows, img, dims,
                           palette, cfg_stem, dt, verbose):
        import cv2
        orig_w, orig_h = dims
        if verbose:
            objs = [self.classes[int(r[6])] for r in rows]
            print("{0:20s} predicted in {1:6.3f} seconds".format(
                img_name, dt))
            print("{0:20s} {1:s}".format("Objects Detected:", " ".join(objs)))
            print("----------------o----------------")
        if rows.shape[0] == 0:
            # the reference stores the int 0 sentinel (detect.py:164)
            self.metrics[img_name] = 0
            return
        # metrics rows in letterbox space, batch_idx first (detect.py:155
        # dumps before rescale; transform_from_batch_to_imlist already
        # bumped column 0 by the global image index, detect.py:101-102)
        metric_rows = np.concatenate(
            [np.full((rows.shape[0], 1), float(img_idx), rows.dtype), rows],
            axis=1)
        self.metrics[img_name] = metric_rows.tolist()

        rescaled = self._unletterbox(rows, orig_w, orig_h)
        for r in rescaled:
            cls = int(r[6])
            draw_detection(img, r[:4], self.classes[cls], float(r[5]),
                           palette[cls % len(palette)])
        out_path = os.path.join(self.destination,
                                "det_{}_{}".format(cfg_stem, img_name))
        cv2.imwrite(out_path, img)

    def _unletterbox(self, rows: np.ndarray, orig_w: int, orig_h: int):
        """Undo letterboxing -> original-image pixel coords, clamped.

        Parity with detect.py:120-136 including the literal 416 in the
        scaling factor (detect.py:130) when ``parity_scale_416`` is set.
        """
        base = 416.0 if self.parity_scale_416 else float(self.resolution)
        scaling = min(base / orig_w, base / orig_h)
        out = rows.copy()
        out[:, [0, 2]] -= (self.resolution - scaling * orig_w) / 2
        out[:, [1, 3]] -= (self.resolution - scaling * orig_h) / 2
        out[:, :4] /= scaling
        out[:, [0, 2]] = np.clip(out[:, [0, 2]], 0.0, orig_w)
        out[:, [1, 3]] = np.clip(out[:, [1, 3]], 0.0, orig_h)
        return out
