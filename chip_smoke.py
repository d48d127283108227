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
   device program's time per batch;
4. int8 kernel phase: the w8a8 tap-matmul conv kernel against its plain
   version in each configuration the int8 yolov3 forward runs at 416x416,
   batch 16 (bf16 in and out; bf16 in and fp32 out for two, fp32 in and
   out for one; a small layout, batch 2 at 13x13 with tm 256; inputs on
   the rounding tie, all-zero blocks), bit for bit; per configuration the
   kernel's device time (CUDA-graph replay of back-to-back calls), the time
   of back-to-back calls from Python (host dispatch included), the host's
   time to issue one call, the plain version's time, the bound, the
   achieved int8 TOP/s, the share of the bound, the device time of each
   of the kernel's three passes (torch.profiler), and a bf16 cuDNN conv of
   the same shape for context, timed the same three ways;
5. int8 serving phase: ``DetectorV3(quantize="w8a8_pallas")`` over the
   same folder and weights; the kernel's launches per batch, the program's
   time per batch, the kernel's share of the device time, the warm folder
   time; one batch's heads against the same program with the plain conv
   (bit for bit) and against the fp32 folded forward with TF32 off (the
   JAX package's full-yolov3 drift gates).

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
H100_INT8_OPS = 1979e12      # dense int8 tensor cores, NVIDIA data sheet
NMS_FLOPS_PER_PAIR = 14      # IoU of one same-class pair and its compare
NMS_FLOPS_PER_BOX = 5        # one box area


def graph_ms(fn, calls: int = 10, iters: int = 5) -> float:
    """Device time of one ``fn`` call in ms: ``calls`` calls captured in a
    CUDA graph, replayed ``iters`` times between CUDA events, so the host's
    dispatch does not gap the card."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # allocations and lazy set-up first
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = cuda_ms(graph.replay, iters=iters, warmup=2) / calls
    del graph
    return ms


def host_ms(fn, iters: int = 20) -> float:
    """Host time of one ``fn`` call in ms: the wall time of issuing
    ``iters`` calls back to back, with the card synchronised before and
    after, outside the timed span (the card runs behind the host)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * t / iters


def ptxas_report(log: str) -> dict:
    """Registers, spills and static shared memory of each kernel from the
    ``-Xptxas -v`` lines of a build log."""
    import re
    short = {"I13__nv_bfloat16S1_E": "<bf16,bf16>",
             "I13__nv_bfloat16fE": "<bf16,f32>", "IffE": "<f32,f32>",
             "I13__nv_bfloat16E": "<bf16>", "IfE": "<f32>"}
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            base = re.search(r"(conv_int8_kernel|conv_int8_quantize_kernel|"
                             r"chunk_absmax_kernel|nms\w*kernel)(I\w+?E)?",
                             name)
            if base:
                name = base.group(1) + short.get(base.group(2) or "", "")
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[name]["static_smem"] = int(sm.group(1)) if sm else 0
    return out


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
    # each kernel counts in the first group that names it
    groups = {"conv_int8": ("conv_int8", "chunk_absmax"),
              "nms_suppress": ("nms_suppress",), "sort": ("sort", "radix"),
              "conv": ("conv", "xmma", "gemm", "cutlass", "sm90", "cudnn")}
    out = {"device_ms": sum(kernels.values())}
    for g in groups:
        out[f"{g}_ms"] = 0.0
    for k, v in kernels.items():
        g = next((g for g, keys in groups.items()
                  if any(s in k.lower() for s in keys)), None)
        if g is not None:
            out[f"{g}_ms"] += v
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


def int8_plan(forward, params, x) -> list:
    """The tap-matmul conv calls of one int8 forward, in order: per call
    ``(layout, k, C_in, C_out, act, skip?)``."""
    import torch
    from realtimeobjectdetection_tpu_torch import model_int8
    calls, kernel = [], model_int8.conv_flat_int8

    def record(x_flat, w, s_w, b, lay, k=3, act="leaky", skip=None,
               out_dtype=None):
        calls.append((lay, k, w.shape[2], w.shape[1], act,
                      skip is not None))
        return kernel(x_flat, w, s_w, b, lay, k=k, act=act, skip=skip,
                      out_dtype=out_dtype)

    model_int8.conv_flat_int8 = record
    try:
        with torch.inference_mode():
            forward(params, x)
    finally:
        model_int8.conv_flat_int8 = kernel
    return calls


def int8_bound_ms(lay, k, cin, cout, skip, in_bytes, out_bytes):
    """Least time for one tap-matmul conv on this card: the int8 products
    of the content rows, 2*B*H*W*k*k*C_in*C_out operations, at the dense
    int8 tensor rate, against the bytes the function needs at the memory
    rate: the input rows that reach an output (the content blocks, plus
    for k=3 the halo of gr rows that each end takes from a guard block),
    the weights, scales and bias, the skip at the content rows (elsewhere
    the output is 0) read once, and all R output rows written once.
    Returns ``(ms, "bytes" | "operations")``."""
    content = lay.b * lay.h * lay.w
    ops = 2 * content * k * k * cin * cout
    x_rows = (lay.nb - 2) * lay.tm + (2 * lay.gr if k == 3 else 0)
    nbytes = (x_rows * cin * in_bytes + k * k * cin * cout + 8 * cout
              + (content * cout * in_bytes if skip else 0)
              + lay.rows * cout * out_bytes)
    bytes_s, ops_s = nbytes / H100_BYTES_PER_S, ops / H100_INT8_OPS
    return 1e3 * max(bytes_s, ops_s), \
        "bytes" if bytes_s >= ops_s else "operations"


def int8_inputs(lay, k, cin, cout, skip, seed, device, kind="random",
                dtype=None):
    """Seeded inputs of one conv at ``lay``: activations of ``dtype`` (bf16
    by default) in the flat layout, packed int8 weights, scales, bias and a
    skip of the same type.  ``kind``
    "halves" puts every scaled value on a rounding tie (amax 127, values
    n + 0.5); "zero_blocks" zeroes the first two images, so whole row
    blocks and their halos hold only zeros."""
    import torch
    from realtimeobjectdetection_tpu_torch.ops.conv_int8 import (
        pack_conv_int8, to_flat)
    dtype = dtype or torch.bfloat16
    g = torch.Generator(device="cpu").manual_seed(seed)
    shape = (lay.b, lay.h, lay.w, cin)
    if kind == "halves":
        x = torch.randint(-127, 127, shape, generator=g) + 0.5
        x[..., 0] = 127.0
    else:
        x = torch.randn(shape, generator=g) * 2.0
        if kind == "zero_blocks":
            x[:2] = 0.0
    x_flat = to_flat(x.to(device, dtype), lay)
    w = torch.randint(-127, 128, (cout, cin, k, k), generator=g,
                      dtype=torch.int8)
    s_w = (torch.rand(cout, generator=g) + 0.5) / 127 / (k * k * cin) ** 0.5
    bias = torch.randn(cout, generator=g) * 0.5
    sk = None
    if skip:
        sk = to_flat(torch.randn((lay.b, lay.h, lay.w, cout), generator=g)
                     .to(device, dtype), lay)
    return (x_flat, pack_conv_int8(w).to(device), s_w.to(device),
            bias.to(device), sk)


def int8_kernel_phase(device, plan) -> list:
    """K2 against its plain version in each configuration of ``plan``,
    bf16 in and out, with its device time, the time of back-to-back calls,
    the host's time per call, its three passes' device times, the plain
    version's time, the bound, the achieved int8 TOP/s and a bf16 cuDNN
    conv of the same shape timed the same three ways (context: not the
    same function);
    then bf16 in and fp32 out for two configurations, fp32 in and out for
    one, a small layout and the edge cases."""
    import torch
    import torch.nn.functional as F
    from realtimeobjectdetection_tpu_torch.ops.conv_int8 import (
        conv_flat_int8_plain, make_layout)
    from realtimeobjectdetection_tpu_torch.ops.cuda.conv_int8 import (
        conv_flat_int8, plan as k2_plan)

    bf16, f32 = torch.bfloat16, torch.float32
    configs = sorted(set(plan), key=lambda c: (-c[0].h, c[1], c[2], c[3],
                                               c[4], c[5]))
    cases = [(c, bf16, bf16, "random", True) for c in configs]
    fp32 = [c for c in configs if c[1] == 3 and c[5]][:1] \
        + [c for c in configs if c[3] == 255][:1]
    cases += [(c, bf16, f32, "random", False) for c in fp32]
    cases += [(fp32[0], f32, f32, "random", False)]
    small = make_layout(2, 13, 13, tm=256)
    cases += [((small, 3, 64, 64, "leaky", True), bf16, bf16, "random",
               False),
              ((small, 1, 96, 255, "linear", False), f32, f32, "random",
               False)]
    # edge cases at the two largest resolutions, where blocks are many
    res = sorted({c[0].h for c in configs}, reverse=True)
    edge = [c for c in configs if c[0].h == res[0]][:2] \
        + [c for c in configs if c[0].h == res[1] and c[1] == 3][:1]
    cases += [(c, bf16, bf16, kind, False) for c in edge
              for kind in ("halves", "zero_blocks")]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows = []
    for n, ((lay, k, cin, cout, act, skip), x_dtype, out_dtype, kind,
            timed) in enumerate(cases):
        x_flat, w, s_w, bias, sk = int8_inputs(lay, k, cin, cout, skip, n,
                                               device, kind, x_dtype)
        args = (x_flat, w, s_w, bias, lay)
        kw = dict(k=k, act=act, skip=sk, out_dtype=out_dtype)
        got = conv_flat_int8(*args, **kw)
        want = conv_flat_int8_plain(*args, **kw)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        pl = k2_plan(lay, k, cin, cout, sms, x_flat.element_size(),
                     got.element_size())
        row = {"h": lay.h, "b": lay.b, "tm": lay.tm, "nb": lay.nb, "k": k,
               "cin": cin, "cout": cout, "act": act, "skip": skip,
               "kind": kind, "x": str(x_dtype).replace("torch.", ""),
               "out": str(out_dtype).replace("torch.", ""),
               "bk": pl.bk, "stages": pl.stages, "splits": pl.splits,
               "mismatches": int((got.float() != want.float()).sum()),
               "max_abs_err": float(diff.max()),
               "finite": bool(torch.isfinite(got.float()).all())}
        if row["mismatches"] or not row["finite"]:
            raise AssertionError(f"conv_flat_int8 against plain: {row}")
        if timed:
            row["ms"] = graph_ms(lambda: conv_flat_int8(*args, **kw))
            row["call_ms"] = cuda_ms(lambda: conv_flat_int8(*args, **kw))
            row["host_ms"] = host_ms(lambda: conv_flat_int8(*args, **kw))
            # the device time of K2's three kernels, one call
            for _ in range(3):  # the profiler now and then records none
                top = profile_program(lambda: conv_flat_int8(*args, **kw),
                                      iters=10).get("top", [])
                if top:
                    break
            row["kernel_ms"] = {
                part: sum(v for name, v in top if key in name)
                for part, key in (("chunk_absmax", "chunk_absmax"),
                                  ("quantize", "conv_int8_quantize"),
                                  ("conv", "conv_int8_kernel"))}
            row["plain_ms"] = cuda_ms(lambda: conv_flat_int8_plain(
                *args, **kw), iters=3, warmup=1)
            xc = torch.randn((lay.b, cin, lay.h, lay.w), device=device,
                             dtype=torch.bfloat16).to(
                memory_format=torch.channels_last)
            wc = torch.randn((cout, cin, k, k), device=device,
                             dtype=torch.bfloat16).to(
                memory_format=torch.channels_last)
            def cudnn():
                return F.conv2d(xc, wc, padding=(k - 1) // 2)
            row["cudnn_bf16_ms"] = graph_ms(cudnn)
            row["cudnn_call_ms"] = cuda_ms(cudnn)
            row["cudnn_host_ms"] = host_ms(cudnn)
            row["bound_ms"], row["bound_by"] = int8_bound_ms(
                lay, k, cin, cout, skip, 2, 2)
            ops = 2 * lay.b * lay.h * lay.w * k * k * cin * cout
            row["tops"] = ops / (row["ms"] * 1e-3) / 1e12
            row["bound_share"] = row["bound_ms"] / row["ms"]
            row["ratio_to_cudnn"] = row["ms"] / row["cudnn_bf16_ms"]
            row["call_ratio_to_cudnn"] = (row["call_ms"]
                                          / row["cudnn_call_ms"])
            row["calls_per_forward"] = plan.count(
                (lay, k, cin, cout, act, skip))
        rows.append(row)
    return rows


def int8_serving_phase(device, workdir: str, n_images: int = 64,
                       batch: int = 16, model: str = "yolov3"):
    """``DetectorV3(quantize="w8a8_pallas")`` over the serving folder; the
    conv plan of one forward, K2's launches, times and drift."""
    import torch
    from realtimeobjectdetection_tpu_torch import model_int8
    from realtimeobjectdetection_tpu_torch.model import (fold_batchnorm,
                                                         make_forward)
    from realtimeobjectdetection_tpu_torch.models import get_spec
    from realtimeobjectdetection_tpu_torch.ops.conv_int8 import \
        conv_flat_int8_plain
    from realtimeobjectdetection_tpu_torch.ops.cuda.conv_int8 import \
        conv_flat_int8
    from realtimeobjectdetection_tpu_torch.ops.decode import decode_heads
    from realtimeobjectdetection_tpu_torch.ops.letterbox import \
        prep_image_host_u8
    from realtimeobjectdetection_tpu_torch.pipeline.detector import DetectorV3
    from realtimeobjectdetection_tpu_torch.weights import load_darknet_weights
    import cv2

    spec = get_spec(model)
    wpath = os.path.join(workdir, f"{model}_bench.weights")
    imgs = os.path.join(workdir, "images")
    det = DetectorV3(imgs, os.path.join(workdir, "det_int8"), model, wpath,
                     resolution=416, confidence=0.6, nms_thresh=0.5,
                     batch_size=batch, bn_mode="fold",
                     quantize="w8a8_pallas", top_k=512, fused_decode=True,
                     host_prep="cv2", device=device)
    t0 = time.perf_counter()
    det(verbose=False)
    torch.cuda.synchronize()
    first_wall_s = time.perf_counter() - t0

    conv_flat_int8.launches = 0
    t0 = time.perf_counter()
    metrics = det(verbose=False)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = conv_flat_int8.launches
    n_batches = -(-n_images // batch)
    if len(metrics) != n_images:
        raise AssertionError(f"int8 serving: {len(metrics)} of {n_images} "
                             f"images")
    n_rows = sum(len(r) for r in metrics.values() if r != 0)

    names = sorted(os.listdir(imgs))[:batch]
    x = torch.from_numpy(np.concatenate(
        [prep_image_host_u8(cv2.imread(os.path.join(imgs, n)), 416)
         for n in names])).to(device)
    xf = x.float() / 255.0
    plan = int8_plan(det._forward, det.params, xf)
    if launches != len(plan) * n_batches or len(plan) != 67:
        raise AssertionError(f"int8 serving: {launches} kernel launches "
                             f"over {n_batches} batches, {len(plan)} convs "
                             f"in a forward (67 expected)")

    with torch.inference_mode():
        heads = det._forward(det.params, xf)
        model_int8.conv_flat_int8 = conv_flat_int8_plain
        try:
            heads_plain = det._forward(det.params, xf)
        finally:
            model_int8.conv_flat_int8 = conv_flat_int8
        mism = sum(int((a != b).sum()) for a, b in zip(heads, heads_plain))
        plain_err = max(float((a - b).abs().max())
                        for a, b in zip(heads, heads_plain))
        if mism:
            raise AssertionError(f"int8 serving: heads with the kernel "
                                 f"differ from the plain conv's in {mism} "
                                 f"values (max {plain_err})")
        # the JAX package's full-yolov3 gates (tests/test_quantize.py)
        params, _ = load_darknet_weights(spec, wpath)
        folded = {k: {n: t.to(device) for n, t in e.items()}
                  for k, e in fold_batchnorm(spec, params).items()}
        old = (torch.backends.cudnn.allow_tf32,
               torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            ref = make_forward(spec, bn_mode="fold")(folded, xf)
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = old
        rel = [float((a - b).abs().max() / (a.abs().max() + 1e-9))
               for a, b in zip(ref, heads)]
        got_d = decode_heads(heads, spec, 416)
        ref_d = decode_heads(ref, spec, 416)
        agree = float(((got_d[..., 4] > 0.6) == (ref_d[..., 4] > 0.6))
                      .float().mean())
    if not (max(rel) < 0.15 and agree > 0.9):
        raise AssertionError(f"int8 serving drift: head error {rel}, "
                             f"objectness agreement {agree}")
    out = {"launches": launches, "launches_per_batch": launches / n_batches,
           "convs_per_forward": len(plan),
           "configurations": len(set(plan)),
           "first_wall_s": first_wall_s, "wall_s": wall_s,
           "wall_images_per_s": n_images / wall_s, "rows": n_rows,
           "heads_vs_plain_mismatches": mism,
           "head_rel_err_vs_fp32": rel, "objectness_agreement": agree}
    out["program_ms_per_batch"] = cuda_ms(lambda: det.detect_batch(x))
    out["program_images_per_s"] = batch / out["program_ms_per_batch"] * 1e3
    out["program_profile"] = profile_program(lambda: det.detect_batch(x))
    prof = out["program_profile"]
    if prof:
        out["conv_int8_share"] = prof["conv_int8_ms"] / prof["device_ms"]
    out["host_stages"] = host_stages(det, imgs, names, x)
    return out, plan


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
    from realtimeobjectdetection_tpu_torch.ops.cuda import conv_int8
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    # every kernel library builds at once, one nvcc each
    from concurrent.futures import ThreadPoolExecutor

    def timed_build(mod):
        t0 = time.perf_counter()
        mod.build()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(2) as pool:
        builds = {name: pool.submit(timed_build, mod) for name, mod in
                  (("nms_kernel", nms_kernel), ("conv_int8", conv_int8))}
        for name, fut in builds.items():
            print(f"build {name} s {fut.result():.3f}")
    # K2's registers, spills and shared memory (dynamic: the conv kernel's
    # for bf16 -> bf16, bf16 -> fp32, fp32 -> fp32)
    from realtimeobjectdetection_tpu_torch.buildlib import build_log
    print("build conv_int8 ptxas " + json.dumps({
        "kernels": ptxas_report(build_log(conv_int8.build())),
        "dynamic_smem": [conv_int8.smem_bytes(*t)
                         for t in ((2, 2), (2, 4), (4, 4))]}))

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
        int8_srv, plan = int8_serving_phase(device, workdir)

    int8_rows = int8_kernel_phase(device, plan)
    print(f"int8kernel peaks int8_ops_per_s {H100_INT8_OPS:.4g} "
          f"bytes_per_s {H100_BYTES_PER_S:.4g}")
    for r in int8_rows:
        print("int8kernel conv_flat_int8 " + json.dumps(r))
    for key, val in int8_srv.items():
        print(f"int8serving {key} {val}")

    max_err = max([r["mismatches"] for r in rows] + [srv["mismatches"]])
    # K2 over one forward: each configuration's numbers times its calls
    timed = [r for r in int8_rows if "ms" in r]
    k2 = {key: sum(r[key] * r["calls_per_forward"] for r in timed)
          for key in ("ms", "call_ms", "host_ms", "plain_ms", "bound_ms",
                      "cudnn_bf16_ms", "cudnn_call_ms", "cudnn_host_ms")}
    k2["ratio_to_cudnn"] = k2["ms"] / k2["cudnn_bf16_ms"]
    k2["call_ratio_to_cudnn"] = k2["call_ms"] / k2["cudnn_call_ms"]
    k2["bound_share"] = k2["bound_ms"] / k2["ms"]
    by_ops = sum(r["bound_ms"] * r["calls_per_forward"] for r in timed
                 if r["bound_by"] == "operations")
    print(f"int8kernel per_forward {json.dumps(k2)}")
    print(json.dumps({"kernels": [{
        "name": "nms_suppress", "route": "cuda",
        "source": "realtimeobjectdetection_tpu_torch/csrc/nms_kernel.cu",
        "replaces": "realtimeobjectdetection_tpu/ops/pallas/nms_kernel.py:75",
        "launches": srv["launches"], "max_abs_err": float(max_err),
        "ms": srv["nms_ms"], "plain_ms": srv["nms_plain_ms"],
        "bound_ms": srv["nms_bound_ms"], "bound_by": srv["nms_bound_by"],
        "library_ms": None}, {
        "name": "conv_flat_int8", "route": "cuda",
        "source": "realtimeobjectdetection_tpu_torch/csrc/conv_int8.cu",
        "replaces": "realtimeobjectdetection_tpu/ops/pallas/conv_int8.py:206",
        "launches": int8_srv["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in int8_rows),
        "ms": k2["ms"], "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": "operations" if by_ops >= k2["bound_ms"] / 2
        else "bytes",
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
