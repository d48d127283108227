#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds every kernel of the port from the sources in this checkout, holds
each against its plain PyTorch version on the card, and drives the port's
main path (YOLOv3 folder detection through ``DetectorV3``) at full width:

1. kernel phase: the greedy NMS suppression kernel against its plain
   version at B=64, K in {256, 512, 1024}, under both (plus_one, ge)
   settings, on random dense boxes and on pairs whose IoU is exactly the
   threshold; prints both times;
2. parity phase: full yolov3 at 416x416, batch-statistics BN, fp32 with
   TF32 off, on the golden input of ``tests/golden/yolov3_dog.npz``;
   decoded predictions and NMS rows (through the kernel) against the
   goldens;
3. serving phase: ``DetectorV3`` over a folder of 64 synthetic JPEGs at
   batch 16 (folded BN, bf16, fused top-512 decode, confidence 0.6, dense
   benchmark weights); the kernel's launch count over that run, its
   survivors against the plain version on one batch's candidates, and the
   device program's time per batch.

Prints each number on its own line, then one JSON line of the kernels,
then the card's name and power limit, then as the last line
``{"ok": true, "device": {...}}``.  Exits non-zero, without that line,
when a phase fails, when no CUDA card is visible, or when the port is not
beside this script.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12   # HBM3, NVIDIA data sheet (SXM)
H100_F32_FLOPS = 67e12       # fp32 outside the tensor cores
NMS_FLOPS_PER_PAIR = 14      # IoU of one same-class pair and its compare
NMS_FLOPS_PER_BOX = 5        # one box area


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events around ``iters``
    back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nms_bound_ms(corners, cls_id, valid, keep):
    """Least time for the suppression on this card: each input byte read
    and each output byte written once, against the fp32 work these inputs
    need.  Greedy suppression needs one area per valid candidate and one
    IoU for each same-class pair (i, j), i < j, of valid candidates where
    i survives (``keep``, the plain version's result): a removed or
    invalid i clears nothing.  Returns ``(ms, "bytes" | "operations")``."""
    import torch
    b, k = valid.shape
    nbytes = b * k * (16 + 4 + 1) + b * k
    idx = torch.arange(k, device=valid.device)
    pairs = (cls_id[:, :, None] == cls_id[:, None, :]) \
        & keep[:, :, None] & valid[:, None, :] \
        & (idx[:, None] < idx[None, :])[None]
    flops = int(pairs.sum()) * NMS_FLOPS_PER_PAIR \
        + int(valid.sum()) * NMS_FLOPS_PER_BOX
    bytes_s, ops_s = nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS
    return 1e3 * max(bytes_s, ops_s), \
        "bytes" if bytes_s >= ops_s else "operations"


def nms_inputs(b: int, k: int, plus_one: bool, seed: int, device):
    """Dense random candidates with exact-threshold pairs at the front.

    Each pair is one box and a box twice its height from the same corner:
    intersection = the smaller box, union = the larger, so the IoU is 0.5
    exactly and only ``ge`` decides the pair."""
    import torch
    rng = np.random.RandomState(seed)
    cx, cy = rng.uniform(0, 416, (2, b, k))
    w, h = rng.uniform(20, 150, (2, b, k))
    corners = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    cls = rng.randint(0, 4, (b, k))
    valid = rng.rand(b, k) > 0.1
    side = 9.0 if plus_one else 10.0  # + 1 makes extents of 10 and 20
    for p in range(8):
        x0 = 60.0 * p
        y0 = float(rng.randint(0, 200))
        corners[:, 2 * p] = [x0, y0, x0 + side, y0 + side]
        corners[:, 2 * p + 1] = [x0, y0, x0 + side, y0 + 2 * side
                                 + (1 if plus_one else 0)]
        cls[:, 2 * p:2 * p + 2] = 100 + p  # a class of their own
        valid[:, 2 * p:2 * p + 2] = True
    to = dict(device=device)
    return (torch.tensor(corners, dtype=torch.float32, **to),
            torch.tensor(cls, dtype=torch.int32, **to),
            torch.tensor(valid, dtype=torch.bool, **to))


def kernel_phase(device, batch: int = 64, ks=(256, 512, 1024)):
    """K1 against its plain version; returns the rows printed."""
    from realtimeobjectdetection_tpu_torch.ops.cuda.nms_kernel import (
        nms_suppress, nms_suppress_plain)
    rows = []
    for k in ks:
        for plus_one, ge in ((True, True), (False, False)):
            corners, cls, valid = nms_inputs(batch, k, plus_one, k, device)
            got = nms_suppress(corners, cls, valid, 0.5, plus_one, ge)
            want = nms_suppress_plain(corners, cls, valid, 0.5, plus_one, ge)
            mismatches = int((got != want).sum())
            # the second box of each exact pair survives only under strict >
            pairs_ok = bool((got[:, 1:16:2] == (not ge)).all())
            if mismatches or not pairs_ok:
                raise AssertionError(
                    f"nms_suppress K={k} plus_one={plus_one} ge={ge}: "
                    f"{mismatches} keep mismatches, exact pairs ok={pairs_ok}")
            row = {"k": k, "plus_one": plus_one, "ge": ge,
                   "mismatches": mismatches}
            if device.type == "cuda":
                row["ms"] = cuda_ms(lambda: nms_suppress(
                    corners, cls, valid, 0.5, plus_one, ge))
                row["plain_ms"] = cuda_ms(lambda: nms_suppress_plain(
                    corners, cls, valid, 0.5, plus_one, ge), iters=3,
                    warmup=1)
                row["bound_ms"], row["bound_by"] = nms_bound_ms(
                    corners, cls, valid, want)
            rows.append(row)
    return rows


def nms_timing(pred, confidence: float, top_k: int) -> dict:
    """K1, its plain version and its bound on the candidates that
    ``nms_batch`` makes from ``pred``."""
    from realtimeobjectdetection_tpu_torch.ops.cuda.nms_kernel import (
        nms_suppress, nms_suppress_plain)
    from realtimeobjectdetection_tpu_torch.ops.nms import nms_candidates
    _, corners, _, cls_id, valid, _ = nms_candidates(pred, 80, confidence,
                                                     top_k)
    cls_id = cls_id.int()
    keep = nms_suppress_plain(corners, cls_id, valid, 0.5)
    out = {"shape": list(valid.shape),
           "ms": cuda_ms(lambda: nms_suppress(corners, cls_id, valid, 0.5)),
           "plain_ms": cuda_ms(lambda: nms_suppress_plain(
               corners, cls_id, valid, 0.5), iters=3, warmup=1)}
    out["bound_ms"], out["bound_by"] = nms_bound_ms(corners, cls_id, valid,
                                                    keep)
    return out


def profile_program(fn, iters: int = 5) -> dict:
    """Device time per call of ``fn`` by kernel, from torch.profiler:
    the top kernels and sums for convolutions, NMS suppression and sorts.
    Empty when the profiler records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = {}
    for evt in prof.key_averages():
        # kernel rows only: operator rows repeat their kernels' time
        if evt.device_type == DeviceType.CUDA \
                and evt.self_device_time_total > 0:
            kernels[evt.key] = evt.self_device_time_total / iters / 1e3
    groups = {"conv": ("conv", "xmma", "gemm", "cutlass", "sm90", "cudnn"),
              "nms_suppress": ("nms_suppress",), "sort": ("sort", "radix")}
    out = {"device_ms": sum(kernels.values())}
    for g, keys in groups.items():
        out[f"{g}_ms"] = sum(v for k, v in kernels.items()
                             if any(s in k.lower() for s in keys))
    out["other_ms"] = out["device_ms"] - sum(out[f"{g}_ms"] for g in groups)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    out["top"] = [[k[:80], v] for k, v in top]
    return out if kernels else {}


def parity_phase(device):
    """Full yolov3 at 416, batch BN, fp32, against the goldens."""
    import torch
    from realtimeobjectdetection_tpu_torch.model import make_forward
    from realtimeobjectdetection_tpu_torch.models import get_spec
    from realtimeobjectdetection_tpu_torch.ops.decode import decode_heads
    from realtimeobjectdetection_tpu_torch.ops.nms import nms_batch
    from realtimeobjectdetection_tpu_torch.testing import \
        synthetic_darknet_weights
    from realtimeobjectdetection_tpu_torch.weights import load_darknet_weights

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    d = np.load(os.path.join(HERE, "tests", "golden", "yolov3_dog.npz"))
    spec = get_spec("yolov3")
    params, _ = load_darknet_weights(spec, synthetic_darknet_weights(spec, 0))
    params = {k: {n: t.to(device) for n, t in e.items()}
              for k, e in params.items()}
    x = torch.from_numpy(d["input_nchw"].transpose(0, 2, 3, 1).copy()) \
        .to(device)
    with torch.inference_mode():
        pred = decode_heads(make_forward(spec, bn_mode="batch")(params, x),
                            spec, 416)
        ref = torch.from_numpy(d["pred"]).to(device)
        if pred.shape != ref.shape or not torch.isfinite(pred).all():
            raise AssertionError(f"parity pred shape {tuple(pred.shape)}")
        coord_err = float((pred[..., :4] - ref[..., :4]).abs().max())
        prob_err = float((pred[..., 4:] - ref[..., 4:]).abs().max())
        # tolerances of tests/test_forward_parity.py
        if coord_err > 0.35 or prob_err > 2e-4:
            raise AssertionError(f"parity: coord err {coord_err}, "
                                 f"prob err {prob_err}")
        out = {"coord_err": coord_err, "prob_err": prob_err}
        for conf_key, rows_key, top_k in (
                ("nms_confidence", "nms_rows", 512),
                ("nms_confidence_dense", "nms_rows_dense", 1024)):
            boxes, valid = nms_batch(pred, 80, float(d[conf_key]), 0.5,
                                     top_k=top_k)
            got = boxes[0][valid[0]].cpu().numpy()
            want = d[rows_key]
            if got.shape[0] != want.shape[0] \
                    or not np.array_equal(got[:, 6], want[:, 7]):
                raise AssertionError(
                    f"parity {rows_key}: {got.shape[0]} rows, golden "
                    f"{want.shape[0]}")
            out[rows_key] = int(got.shape[0])
            if device.type == "cuda":
                out[f"{rows_key}_nms"] = nms_timing(pred, float(d[conf_key]),
                                                    top_k)
    torch.backends.cudnn.allow_tf32 = True
    return out


def write_images(folder: str, n: int, seed: int = 0):
    """``n`` random 416x416 JPEGs: the letterboxed canvas is all image and
    unresampled noise, a dense scene for the benchmark weights."""
    import cv2
    rng = np.random.RandomState(seed)
    os.makedirs(folder, exist_ok=True)
    for i in range(n):
        h = w = 416
        img = rng.randint(0, 256, (h, w, 3), np.uint8)
        cv2.imwrite(os.path.join(folder, f"img_{i:04d}.jpg"), img)


def serving_phase(device, workdir: str, n_images: int = 64,
                  batch: int = 16, model: str = "yolov3"):
    """DetectorV3 over a folder: the main path."""
    import torch
    from realtimeobjectdetection_tpu_torch.models import get_spec
    from realtimeobjectdetection_tpu_torch.ops.cuda.nms_kernel import (
        nms_suppress, nms_suppress_plain)
    from realtimeobjectdetection_tpu_torch.ops.decode import decode_topk
    from realtimeobjectdetection_tpu_torch.ops.letterbox import \
        prep_image_host_u8
    from realtimeobjectdetection_tpu_torch.ops.nms import nms_candidates
    from realtimeobjectdetection_tpu_torch.pipeline.detector import DetectorV3
    from realtimeobjectdetection_tpu_torch.testing import bench_params
    from realtimeobjectdetection_tpu_torch.weights import \
        export_darknet_weights
    import cv2

    spec = get_spec(model)
    wpath = os.path.join(workdir, f"{model}_bench.weights")
    with open(wpath, "wb") as f:
        f.write(export_darknet_weights(spec, bench_params(spec, model)))
    imgs = os.path.join(workdir, "images")
    write_images(imgs, n_images)
    det = DetectorV3(imgs, os.path.join(workdir, "det"), model, wpath,
                     resolution=416, confidence=0.6, nms_thresh=0.5,
                     batch_size=batch, bn_mode="fold",
                     compute_dtype=torch.bfloat16,
                     activation_dtype=torch.bfloat16, top_k=512,
                     fused_decode=True, host_prep="cv2", device=device)

    # a first call over the folder pays for the first bf16 forward
    # (cuDNN picks its kernels), the loader thread and its pool; the
    # timed call after it reads the same files from a warm page cache
    t0 = time.perf_counter()
    det(verbose=False)
    if device.type == "cuda":
        torch.cuda.synchronize()
    first_wall_s = time.perf_counter() - t0

    nms_suppress.launches = 0
    t0 = time.perf_counter()
    metrics = det(verbose=False)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = nms_suppress.launches

    if len(metrics) != n_images:
        raise AssertionError(f"serving: {len(metrics)} of {n_images} images")
    n_rows = 0
    for name, rows in metrics.items():
        if rows == 0:
            continue
        arr = np.asarray(rows, np.float64)
        if arr.ndim != 2 or arr.shape[1] != 8 or not np.isfinite(arr).all():
            raise AssertionError(f"serving: bad rows for {name}")
        n_rows += arr.shape[0]
    if device.type == "cuda" and launches < 1:
        raise AssertionError("serving: the NMS kernel was never launched")

    # one batch's candidates, the kernel against the plain version
    names = sorted(os.listdir(imgs))[:batch]
    x = torch.from_numpy(np.concatenate(
        [prep_image_host_u8(cv2.imread(os.path.join(imgs, n)), 416)
         for n in names])).to(device)
    with torch.inference_mode():
        heads = det._forward(det.params, x.float() / 255.0)
        pred, n_cand = decode_topk(heads, spec, 416, 512, confidence=0.6)
        _, corners, _, cls_id, valid, _ = nms_candidates(pred, 80, 0.6, 512)
        cls_id = cls_id.to(torch.int32)
        got = nms_suppress(corners, cls_id, valid, 0.5)
        want = nms_suppress_plain(corners, cls_id, valid, 0.5)
    mismatches = int((got != want).sum())
    if mismatches:
        raise AssertionError(f"serving: {mismatches} keep mismatches")
    out = {"launches": launches, "first_wall_s": first_wall_s,
           "wall_s": wall_s, "wall_images_per_s": n_images / wall_s,
           "rows": n_rows,
           "mean_candidates": float(n_cand.float().mean()),
           "mean_survivors": float(got.sum(dim=1).float().mean()),
           "mismatches": mismatches}
    if device.type == "cuda":
        out["program_ms_per_batch"] = cuda_ms(lambda: det.detect_batch(x))
        out["program_images_per_s"] = batch / out["program_ms_per_batch"] \
            * 1e3
        out["nms_ms"] = cuda_ms(lambda: nms_suppress(corners, cls_id,
                                                     valid, 0.5))
        out["nms_plain_ms"] = cuda_ms(lambda: nms_suppress_plain(
            corners, cls_id, valid, 0.5), iters=3, warmup=1)
        out["nms_bound_ms"], out["nms_bound_by"] = nms_bound_ms(
            corners, cls_id, valid, want)
        out["program_profile"] = profile_program(lambda: det.detect_batch(x))
        out["host_stages"] = host_stages(det, imgs, names, x)
    return out


def host_stages(det, folder: str, names, x) -> dict:
    """Each stage of the folder loop alone, one thread, warm page cache:
    JPEG decode and letterbox per image (the loader runs them on a pool of
    up to 4 threads), the upload, the host's side of ``detect_batch`` (its
    Python dispatch, up to the call's return) and the readback per batch,
    and unletterbox + draw + JPEG write per image (on the main thread)."""
    import cv2
    import torch
    from realtimeobjectdetection_tpu_torch.ops.letterbox import \
        prep_image_host_u8
    from realtimeobjectdetection_tpu_torch.pipeline.render import \
        make_palette

    clock = time.perf_counter
    paths = [os.path.join(folder, n) for n in names]
    t0 = clock()
    imgs = [cv2.imread(p) for p in paths]
    decode_s = clock() - t0
    t0 = clock()
    batch = np.concatenate([prep_image_host_u8(im, det.resolution)
                            for im in imgs])
    letterbox_s = clock() - t0
    reps = 10
    torch.cuda.synchronize()
    t0 = clock()
    for _ in range(reps):
        torch.from_numpy(batch).to(x.device)
    torch.cuda.synchronize()
    upload_s = (clock() - t0) / reps
    dispatch_s = readback_s = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = clock()
        boxes, valid, counts = det.detect_batch(x)
        dispatch_s += clock() - t0
        torch.cuda.synchronize()
        t0 = clock()
        boxes, valid = boxes.cpu().numpy(), valid.cpu().numpy()
        counts.cpu()
        readback_s += clock() - t0
    palette, n_rows = make_palette(100), 0
    t0 = clock()
    for j, (name, img) in enumerate(zip(names, imgs)):
        rows = boxes[j][valid[j]]
        n_rows += rows.shape[0]
        det._record_and_render(j, name, rows, img, (img.shape[1],
                               img.shape[0]), palette, "stages", 0.0, False)
    render_s = clock() - t0
    n = len(names)
    return {"images": n, "rows": n_rows,
            "decode_ms_per_image": 1e3 * decode_s / n,
            "letterbox_ms_per_image": 1e3 * letterbox_s / n,
            "upload_ms_per_batch": 1e3 * upload_s,
            "dispatch_ms_per_batch": 1e3 * dispatch_s / reps,
            "readback_ms_per_batch": 1e3 * readback_s / reps,
            "render_write_ms_per_image": 1e3 * render_s / n}


def main() -> int:
    if not os.path.isdir(os.path.join(HERE,
                                      "realtimeobjectdetection_tpu_torch")):
        print("chip_smoke: the port is not beside this script",
              file=sys.stderr)
        return 1
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        from realtimeobjectdetection_tpu_torch.ops.cuda import nms_kernel
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    t0 = time.perf_counter()
    nms_kernel.build()
    print(f"build nms_kernel s {time.perf_counter() - t0:.3f}")

    rows = kernel_phase(device)
    for r in rows:
        print("kernel nms_suppress " + json.dumps(r))

    par = parity_phase(device)
    for key, val in par.items():
        print(f"parity {key} {val}")

    with tempfile.TemporaryDirectory() as workdir:
        srv = serving_phase(device, workdir)
    for key, val in srv.items():
        print(f"serving {key} {val}")

    max_err = max([r["mismatches"] for r in rows] + [srv["mismatches"]])
    print(json.dumps({"kernels": [{
        "name": "nms_suppress", "route": "cuda",
        "source": "realtimeobjectdetection_tpu_torch/csrc/nms_kernel.cu",
        "replaces": "realtimeobjectdetection_tpu/ops/pallas/nms_kernel.py:75",
        "launches": srv["launches"], "max_abs_err": float(max_err),
        "ms": srv["nms_ms"], "plain_ms": srv["nms_plain_ms"],
        "bound_ms": srv["nms_bound_ms"], "bound_by": srv["nms_bound_by"],
        "library_ms": None}]}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else "nvidia-smi unavailable")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
