"""Darknet ``.weights`` binary -> OIHW float32 tensors.

Replicates the traversal and per-layer slice order of the reference
loader (src/darknet.py:316-410):

* 5 x int32 header (major, minor, subversion, seen, pad),
* flat float32 array,
* walked over conv nodes in cfg order; per conv:
    - with BN:   [bn_bias(beta), bn_weight(gamma), running_mean, running_var]
    - without:   [conv_bias]
  then conv weights in OIHW order (``view_as(conv.weight)``).

The port runs NCHW, so kernels stay OIHW as the file stores them (the JAX
package transposes to HWIO).  ``params_from_jax`` carries a JAX parameter
tree across; ``export_darknet_weights`` inverts the loader bit-exactly.

Parameters are ``{"node_<i>": {"w": [O,I,k,k], "b" | "bn_*": [O]}}`` with
CPU float32 tensors; callers move them to their device.
"""

from __future__ import annotations

import io
from typing import Dict, Tuple

import numpy as np
import torch

from .cfg_parser import GraphSpec

__all__ = [
    "load_darknet_weights",
    "export_darknet_weights",
    "init_params",
    "params_from_torch_state_dict",
    "params_from_jax",
    "param_count",
]

Params = Dict[str, Dict[str, torch.Tensor]]

_BN_KEYS = ("bn_beta", "bn_gamma", "bn_mean", "bn_var")


def _conv_key(i: int) -> str:
    return f"node_{i}"


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float32)


def param_count(spec: GraphSpec) -> int:
    return sum(n.num_params for n in spec.conv_nodes)


def load_darknet_weights(spec: GraphSpec, path_or_bytes
                         ) -> Tuple[Params, Dict[str, int]]:
    """Read a raw Darknet .weights file into OIHW float32 tensors.

    Returns ``(params, header)`` where header carries the version fields and
    the ``seen`` image counter (src/darknet.py:397-410).
    """
    if isinstance(path_or_bytes, (bytes, bytearray)):
        buf = io.BytesIO(path_or_bytes)
    else:
        buf = open(path_or_bytes, "rb")
    try:
        raw_header = buf.read(5 * 4)
        if len(raw_header) < 5 * 4:
            raise ValueError("weights file too short for the 5-int32 header")
        header = np.frombuffer(raw_header, dtype=np.int32)
        payload = buf.read()
        flat = np.frombuffer(payload[:len(payload) - len(payload) % 4],
                             dtype=np.float32)
    finally:
        buf.close()

    params: Params = {}
    ptr = 0
    for node in spec.conv_nodes:
        o, i, k = node.out_channels, node.in_channels, node.kernel_size
        entry: Dict[str, torch.Tensor] = {}
        keys = _BN_KEYS if node.batch_normalize else ("b",)
        for key in keys:
            entry[key] = _tensor(flat[ptr:ptr + o])
            ptr += o
        n_w = o * i * k * k
        w = flat[ptr:ptr + n_w]
        ptr += n_w
        if w.size != n_w:
            raise ValueError(
                f"weights file exhausted at node {node.index}: "
                f"wanted {n_w} floats, got {w.size}")
        entry["w"] = _tensor(w.reshape(o, i, k, k))
        params[_conv_key(node.index)] = entry

    if ptr != flat.size:
        raise ValueError(
            f"weights file has {flat.size - ptr} unread floats "
            f"(consumed {ptr}); cfg/weights mismatch")
    hdr = {
        "major": int(header[0]), "minor": int(header[1]),
        "subversion": int(header[2]), "seen": int(header[3]),
    }
    return params, hdr


def export_darknet_weights(spec: GraphSpec, params, seen: int = 0) -> bytes:
    """Serialize OIHW params (tensors or arrays) to the Darknet binary
    format (round-trip of :func:`load_darknet_weights`)."""
    out = [np.array([0, 2, 0, seen, 0], dtype=np.int32).tobytes()]
    for node in spec.conv_nodes:
        entry = params[_conv_key(node.index)]
        keys = _BN_KEYS if node.batch_normalize else ("b",)
        for key in keys + ("w",):
            out.append(np.ascontiguousarray(_numpy(entry[key])).tobytes())
    return b"".join(out)


def init_params(spec: GraphSpec, seed: int = 0) -> Params:
    """He-style random init (fan-in scaled), BN at identity.

    Draws the same numbers as the JAX package's ``init_params`` for the
    same seed (in its HWIO order), so both packages start from one model.
    """
    rng = np.random.RandomState(seed)
    params: Params = {}
    for node in spec.conv_nodes:
        o, i, k = node.out_channels, node.in_channels, node.kernel_size
        fan_in = i * k * k
        w = rng.normal(0.0, np.sqrt(2.0 / fan_in), size=(k, k, i, o))
        entry = {"w": _tensor(w.astype(np.float32).transpose(3, 2, 0, 1))}
        if node.batch_normalize:
            entry["bn_gamma"] = torch.ones(o)
            entry["bn_beta"] = torch.zeros(o)
            entry["bn_mean"] = torch.zeros(o)
            entry["bn_var"] = torch.ones(o)
        else:
            entry["b"] = torch.zeros(o)
        params[_conv_key(node.index)] = entry
    return params


def params_from_torch_state_dict(spec: GraphSpec, state_dict) -> Params:
    """Convert a reference torch ``state_dict`` into the port's params.

    Reference key schema (src/darknet.py:449-533):
      ``module_list.{i}.conv_{i}.weight|bias``
      ``module_list.{i}.batch_norm_{i}.weight|bias|running_mean|running_var``
    Handles an optional ``module.`` prefix (``nn.DataParallel``
    checkpoints, train.py:71-72).
    """
    sd = {}
    for k, v in state_dict.items():
        if k.startswith("module."):
            k = k[len("module."):]
        sd[k] = v

    params: Params = {}
    for node in spec.conv_nodes:
        i = node.index
        base = f"module_list.{i}"
        entry = {"w": _tensor(_numpy(sd[f"{base}.conv_{i}.weight"]))}
        if node.batch_normalize:
            bn = f"{base}.batch_norm_{i}"
            entry["bn_gamma"] = _tensor(_numpy(sd[f"{bn}.weight"]))
            entry["bn_beta"] = _tensor(_numpy(sd[f"{bn}.bias"]))
            entry["bn_mean"] = _tensor(_numpy(sd[f"{bn}.running_mean"]))
            entry["bn_var"] = _tensor(_numpy(sd[f"{bn}.running_var"]))
        else:
            entry["b"] = _tensor(_numpy(sd[f"{base}.conv_{i}.bias"]))
        params[_conv_key(i)] = entry
    return params


def params_from_jax(params_np) -> Params:
    """The JAX package's parameter tree (numpy arrays, HWIO kernels) ->
    the port's params (OIHW tensors).  Float kernels ``"w"`` become fp32
    OIHW, int8 kernels ``"w_q"`` of a quantized tree int8 OIHW; the other
    entries copy as fp32."""
    out: Params = {}
    for key, entry in params_np.items():
        out[key] = {}
        for name, v in entry.items():
            if name == "w_q":
                out[key][name] = torch.from_numpy(np.ascontiguousarray(
                    np.asarray(v, np.int8).transpose(3, 2, 0, 1)))
            else:
                out[key][name] = _tensor(
                    np.asarray(v).transpose(3, 2, 0, 1) if name == "w"
                    else v)
    return out
