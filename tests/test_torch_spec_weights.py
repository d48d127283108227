"""The port's framework-free layer against the JAX package: GraphSpecs,
Darknet weights, params.json, class names and the numpy test helpers.

Everything here is exact: specs node for node, weights bit for bit."""

import json
import os

import numpy as np
import pytest
import torch

from realtimeobjectdetection_tpu import config as jconfig
from realtimeobjectdetection_tpu import testing as jtesting
from realtimeobjectdetection_tpu import weights as jweights
from realtimeobjectdetection_tpu.cfg_parser import \
    build_graph_spec as j_build_graph_spec
from realtimeobjectdetection_tpu.data import classnames as jnames
from realtimeobjectdetection_tpu.models import zoo as jzoo
from realtimeobjectdetection_tpu_torch import config as tconfig
from realtimeobjectdetection_tpu_torch import testing as ttesting
from realtimeobjectdetection_tpu_torch import weights as tweights
from realtimeobjectdetection_tpu_torch.cfg_parser import (load_graph_spec,
                                                          parse_cfg_blocks)
from realtimeobjectdetection_tpu_torch.data import classnames as tnames
from realtimeobjectdetection_tpu_torch.models import zoo as tzoo

MODELS = ["yolov3", "yolov3-tiny"]
PARAMS_JSON = os.path.join(os.path.dirname(__file__), "..", "params.json")


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("reso", [416, 608])
def test_spec_equals_jax_node_for_node(name, reso):
    j = jzoo.get_spec(name, width=reso, height=reso)
    t = tzoo.get_spec(name, width=reso, height=reso)
    assert len(t.nodes) == len(j.nodes)
    for a, b in zip(j.nodes, t.nodes):
        assert type(a).__name__ == type(b).__name__
        assert a.__dict__ == b.__dict__
    assert t.net.__dict__ == j.net.__dict__
    assert t.live_after() == j.live_after()
    assert t.anchors_in_detection_order == j.anchors_in_detection_order


@pytest.mark.parametrize("name", MODELS)
def test_cfg_text_round_trip(name, tmp_path):
    spec = tzoo.get_spec(name)
    text = tzoo.to_cfg_text(spec)
    assert text == jzoo.to_cfg_text(jzoo.get_spec(name))
    path = tmp_path / f"{name}.cfg"
    path.write_text(text)
    assert tzoo.resolve_spec(str(path)).nodes == spec.nodes
    assert load_graph_spec(str(path)).nodes == spec.nodes
    assert repr(j_build_graph_spec(parse_cfg_blocks(text)).nodes) \
        == repr(spec.nodes)


@pytest.mark.parametrize("name", ["yolov3-tiny"])
def test_loaded_weights_equal_jax_after_transpose(name):
    spec_j, spec_t = jzoo.get_spec(name), tzoo.get_spec(name)
    blob = jtesting.synthetic_darknet_weights(spec_j, 0)
    assert ttesting.synthetic_darknet_weights(spec_t, 0) == blob
    jp, jhdr = jweights.load_darknet_weights(spec_j, blob)
    tp, thdr = tweights.load_darknet_weights(spec_t, blob)
    assert thdr == jhdr
    assert set(tp) == set(jp)
    for key in jp:
        assert set(tp[key]) == set(jp[key])
        for name_, arr in jp[key].items():
            got = tp[key][name_]
            assert got.dtype == torch.float32
            want = arr.transpose(3, 2, 0, 1) if name_ == "w" else arr
            np.testing.assert_array_equal(got.numpy(), want)
    # the export round trip is byte-equal, and params_from_jax carries the
    # JAX tree across to exactly what the port's loader reads
    assert tweights.export_darknet_weights(spec_t, tp, seen=32013312) == blob
    from_jax = tweights.params_from_jax(jp)
    for key in tp:
        for name_ in tp[key]:
            assert torch.equal(from_jax[key][name_], tp[key][name_])


def test_weights_loader_rejects_mismatch():
    spec = tzoo.get_spec("yolov3-tiny")
    blob = ttesting.synthetic_darknet_weights(spec, 0)
    with pytest.raises(ValueError, match="exhausted"):
        tweights.load_darknet_weights(spec, blob[:-8])
    with pytest.raises(ValueError, match="unread"):
        tweights.load_darknet_weights(spec, blob + b"\0" * 8)
    with pytest.raises(ValueError, match="header"):
        tweights.load_darknet_weights(spec, b"\0" * 8)


@pytest.mark.parametrize("name", MODELS)
def test_init_and_bench_params_equal_jax(name):
    """bench_params (He init from ``init_params``, then the objectness
    tweak of each model) draws the same numbers in both packages."""
    spec_j, spec_t = jzoo.get_spec(name), tzoo.get_spec(name)
    pairs = [(jtesting.bench_params(spec_j, name),
              ttesting.bench_params(spec_t, name))]
    if name == "yolov3-tiny":
        pairs.append((jweights.init_params(spec_j, 3),
                      tweights.init_params(spec_t, 3)))
    for jp, tp in pairs:
        conv = tweights.params_from_jax(
            {k: {n: np.asarray(v) for n, v in e.items()}
             for k, e in jp.items()})
        for key in conv:
            for n in conv[key]:
                assert torch.equal(conv[key][n], tp[key][n]), (key, n)
    assert tweights.param_count(spec_t) == jweights.param_count(spec_j)


def test_state_dict_import_matches_loader():
    spec = tzoo.get_spec("yolov3-tiny")
    tp, _ = tweights.load_darknet_weights(
        spec, ttesting.synthetic_darknet_weights(spec, 1))
    sd = {}
    for node in spec.conv_nodes:
        i, e = node.index, tp[f"node_{node.index}"]
        sd[f"module.module_list.{i}.conv_{i}.weight"] = e["w"]
        if node.batch_normalize:
            bn = f"module.module_list.{i}.batch_norm_{i}"
            sd[f"{bn}.weight"], sd[f"{bn}.bias"] = e["bn_gamma"], e["bn_beta"]
            sd[f"{bn}.running_mean"] = e["bn_mean"]
            sd[f"{bn}.running_var"] = e["bn_var"]
        else:
            sd[f"module.module_list.{i}.conv_{i}.bias"] = e["b"]
    got = tweights.params_from_torch_state_dict(spec, sd)
    jgot = jweights.params_from_torch_state_dict(jzoo.get_spec("yolov3-tiny"),
                                                 sd)
    for key in tp:
        for n in tp[key]:
            assert torch.equal(got[key][n], tp[key][n])
            want = jgot[key][n].transpose(3, 2, 0, 1) if n == "w" \
                else jgot[key][n]
            np.testing.assert_array_equal(got[key][n].numpy(), want)


def test_config_classnames_and_tiebreak_pred_equal_jax(tmp_path):
    p = tmp_path / "params.json"
    p.write_text(open(PARAMS_JSON).read().replace("\n", "\t\n"))
    assert tconfig.fetch_parameters(str(p)) == jconfig.fetch_parameters(str(p))
    assert tconfig.configure_json(str(p)) == json.loads(
        open(PARAMS_JSON).read())
    assert tnames.COCO80 == jnames.COCO80 and tnames.VOC20 == jnames.VOC20
    names = tmp_path / "x.names"
    names.write_text("a\nb\n")
    assert tnames.load_classes(str(names)) == ["a", "b"]
    np.testing.assert_array_equal(ttesting.nms_tiebreak_pred(),
                                  jtesting.nms_tiebreak_pred())
    assert ttesting.BENCH_OBJ_TWEAK == jtesting.BENCH_OBJ_TWEAK
