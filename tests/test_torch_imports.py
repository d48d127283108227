"""The port stands alone: it imports neither JAX nor the JAX package.

* In a subprocess where ``import jax`` and ``import
  realtimeobjectdetection_tpu`` fail, every module of the port imports and
  a tiny forward + decode + NMS runs on the CPU.
* A scan of the port's sources and of chip_smoke.py finds no import of
  either.
* chip_smoke.py exits non-zero, printing no result, without a CUDA card
  and in a directory that holds nothing else of the repo.
"""

import ast
import os
import shutil
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "realtimeobjectdetection_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "realtimeobjectdetection_tpu")

RUN_WITHOUT_JAX = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["realtimeobjectdetection_tpu"] = None
import numpy as np, torch
import realtimeobjectdetection_tpu_torch as port
for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    if not m.name.endswith("__main__"):
        importlib.import_module(m.name)
from realtimeobjectdetection_tpu_torch.models import get_spec
from realtimeobjectdetection_tpu_torch.model import make_forward
from realtimeobjectdetection_tpu_torch.ops.decode import decode_heads
from realtimeobjectdetection_tpu_torch.ops.nms import nms_batch
from realtimeobjectdetection_tpu_torch.testing import synthetic_darknet_weights
from realtimeobjectdetection_tpu_torch.weights import load_darknet_weights
spec = get_spec("yolov3-tiny", width=64, height=64)
params, _ = load_darknet_weights(spec, synthetic_darknet_weights(spec, 0))
x = torch.from_numpy(np.random.RandomState(0).rand(1, 64, 64, 3)
                     .astype(np.float32))
boxes, valid = nms_batch(decode_heads(make_forward(spec, "batch")(params, x),
                                      spec, 64), 80, 0.5, 0.5, top_k=32)
assert boxes.shape == (1, 32, 7) and torch.isfinite(boxes[valid]).all()
assert not any(k == "jax" or k.startswith(("jax.", "jaxlib"))
               for k, v in sys.modules.items() if v is not None)
print("ok")
"""


def test_port_runs_without_jax():
    res = subprocess.run([sys.executable, "-c", RUN_WITHOUT_JAX], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_imports_in_port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in FORBIDDEN, (path, mod)


def test_chip_smoke_fails_without_card_or_port(tmp_path, capsys):
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=alone,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    if not torch.cuda.is_available():
        # beside the port, in this process: torch is already imported
        sys.path.insert(0, REPO)
        try:
            import chip_smoke
        finally:
            sys.path.remove(REPO)
        assert chip_smoke.main() != 0
        assert '"ok"' not in capsys.readouterr().out
