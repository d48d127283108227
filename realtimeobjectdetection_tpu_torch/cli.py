"""Command-line surface of the port: the ``detect`` subset.

``python -m realtimeobjectdetection_tpu_torch detect [params.json]`` is the
port's ``python main.py detect``; ``detect --images ... --cfg ...`` takes
the argparse flags of the JAX package's ``detect`` (YOLOv3 only) plus
``--device``.  Other subcommands are not ported (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import sys

from .config import fetch_parameters

__all__ = ["main", "run_detect", "detect_arg_parser", "detect_cli"]

_V5_KEYS = ("yolov5_size", "yolov5_input_size", "yolov5_confidence",
            "yolov5_nms", "yolov5_rect", "act_bf16")


def run_detect(detector_params: dict, device="cuda"):
    """Run :class:`DetectorV3` on ``fetch_parameters``-style kwargs."""
    from .pipeline.detector import DetectorV3
    params = dict(detector_params)
    version = params.pop("yolo_version", 3)
    if version != 3:
        raise NotImplementedError(
            f"YOLO version {version} is not ported (ROADMAP.md)")
    for k in _V5_KEYS:
        params.pop(k, None)
    return DetectorV3(**params, device=device)()


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print("usage: python -m realtimeobjectdetection_tpu_torch detect "
              "[params.json | flags]", file=sys.stderr)
        return 2
    command, rest = argv[0], argv[1:]
    if command != "detect":
        raise NotImplementedError(
            f"subcommand {command!r} is not ported (ROADMAP.md)")
    if not rest or rest[0].endswith(".json"):
        detector_params, _, _, _ = fetch_parameters(
            rest[0] if rest else "params.json")
        run_detect(detector_params)
    else:
        detect_cli(rest)
    return 0


def detect_arg_parser() -> argparse.ArgumentParser:
    """The JAX package's ``detect`` flags (detect.py:288-322), YOLOv3."""
    p = argparse.ArgumentParser(description="YOLO v3 Detection Module "
                                            "(PyTorch / CUDA)")
    p.add_argument("--images", default="imgs", type=str,
                   help="Image / Directory containing images")
    p.add_argument("--det", dest="det", default="det", type=str,
                   help="Image / Directory to store detections to")
    p.add_argument("--confidence", default=0.6, type=float,
                   help="Object confidence to filter predictions")
    p.add_argument("--nms_thresh", default=0.5, type=float,
                   help="NMS threshold")
    p.add_argument("--cfg", dest="cfg_file", default="yolov3-tiny", type=str,
                   help="Config file path or zoo name")
    p.add_argument("--weights", dest="weights_file", default=None, type=str,
                   help="Darknet .weights file (or torch checkpoint with "
                        "--trained)")
    p.add_argument("--reso", default=416, type=int,
                   help="Input resolution (multiple of 32)")
    p.add_argument("--trained", dest="use_torch_weights", action="store_true",
                   help="Load a torch state_dict checkpoint")
    p.add_argument("--batch_size", default=1, type=int,
                   help="Device batch size")
    p.add_argument("--bn_mode", default="batch",
                   choices=["batch", "running", "fold"],
                   help="BatchNorm mode; 'batch' reproduces the reference "
                        "detector exactly")
    p.add_argument("--precision", default=None,
                   choices=["default", "high", "highest"],
                   help="TF32 for the fp32 convs: 'highest' turns it "
                   "off, 'default' and 'high' turn it on")
    p.add_argument("--top_k", default=256, type=int,
                   help="static NMS candidate budget per image")
    p.add_argument("--host_prep", default="cv2", choices=["cv2", "native"],
                   help="host letterbox backend: cv2 (golden bit-parity) "
                        "or the in-repo C++ bicubic (native/letterbox.cpp)")
    p.add_argument("--fused_decode", action="store_true",
                   help="serving fast path: decode only the top_k "
                        "objectness rows (ops/decode.decode_topk)")
    p.add_argument("--quantize", default=None,
                   choices=["w8", "w8a8", "w8a8_pallas"],
                   help="int8 inference (needs --bn_mode fold): w8 = "
                        "int8 weights, w8a8 = int8 weights and "
                        "activations, w8a8_pallas = the w8a8 tap-matmul "
                        "kernel (ops/cuda/conv_int8)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain versions of "
                        "the kernels")
    return p


def detect_cli(argv=None):
    a = detect_arg_parser().parse_args(argv)
    params = {
        "images": a.images, "destination": a.det,
        "cfg_path": a.cfg_file, "weights_path": a.weights_file,
        "resolution": a.reso, "confidence": a.confidence,
        "nms_thresh": a.nms_thresh,
        "use_torch_weights": a.use_torch_weights,
        "batch_size": a.batch_size, "bn_mode": a.bn_mode,
        "precision": a.precision, "top_k": a.top_k,
        "fused_decode": a.fused_decode, "host_prep": a.host_prep,
        "quantize": a.quantize,
    }
    return run_detect(params, device=a.device)


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
