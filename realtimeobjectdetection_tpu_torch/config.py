"""params.json config layer — tolerant parse + key schema parity.

Reference: main.py:7-50.  The tolerant reader strips
tabs/newlines and trailing commas before ``json.loads``; the key schema
maps ``detector_params`` / ``training_params`` onto constructor kwargs.
"""

from __future__ import annotations

import json
from typing import Dict, Tuple

__all__ = ["configure_json", "fetch_parameters"]


def configure_json(json_path: str) -> Dict:
    """Tolerant JSON read (parity: main.py:7-14)."""
    with open(json_path, "r") as f:
        s = f.read()
    s = s.replace("\t", "").replace("\n", "")
    s = s.replace(",}", "}").replace(",]", "]")
    return json.loads(s)


def fetch_parameters(json_path: str = "params.json"
                     ) -> Tuple[Dict, Dict, Dict, Dict]:
    """params.json -> (detector, trainer, validator, train) kwarg dicts.

    Key schema parity with main.py:17-50; extra optional keys (batch_size,
    bn_mode, top_k, dataset types) extend the surface without breaking
    reference param files.
    """
    params = configure_json(json_path)
    det = params["detector_params"]
    trn = params.get("training_params", {})

    detector_params = {
        "images": det["images_path"],
        "destination": det["destination_path"],
        "yolo_version": det.get("yolo_version", 3),
        "yolov5_size": det.get("yolov5_size", "L"),
        "cfg_path": det["cfg_file_path"],
        "weights_path": det["weights_file_path"] or None,
        "resolution": det["resolution"],
        "confidence": det["confidence"],
        "nms_thresh": det["nms_threshold"],
        "use_torch_weights": det.get("use_torch_weights", False),
        # extensions beyond the reference (optional keys)
        "batch_size": det.get("batch_size", 1),
        "bn_mode": det.get("bn_mode", "batch"),
        "top_k": det.get("top_k", 256),
        "precision": det.get("precision", None),
        "yolov5_input_size": det.get("yolov5_input_size", 640),
        "yolov5_confidence": det.get("yolov5_confidence", 0.25),
        "yolov5_nms": det.get("yolov5_nms", 0.45),
    }
    trainer_params = {
        "cfg_path": det["cfg_file_path"],
        "weights_path": det["weights_file_path"] or None,
        "epochs": trn.get("number_of_epoch", 10),
        "batch_size": trn.get("batch_size", 16),
        "resolution": det["resolution"],
        "confidence": det["confidence"],
        "resume": trn.get("start_from_checkpoint", False),
    }
    validator_params = {
        "annotation_dir": trn.get("valid_annot_dir", ""),
        "img_dir": trn.get("valid_img_dir", ""),
    }
    train_params = {
        "annotation_dir": trn.get("train_annot_dir", ""),
        "img_dir": trn.get("train_img_dir", ""),
        "dataset_type": trn.get("train_dataset_type", "COCO"),
    }
    return detector_params, trainer_params, validator_params, train_params
