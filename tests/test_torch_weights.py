"""The weight bridge (``fsnet_tpu_torch.models.flax_convert``): every leaf of
the flagship's flax variables maps to exactly one port tensor, every port
tensor is filled, and layouts agree."""
import numpy as np
import pytest
import torch

import jax

import __graft_entry__ as ge
from fsnet_tpu_torch.entry import flagship_model
from fsnet_tpu_torch.models.flax_convert import (
    flax_to_state_dict, load_flax_variables, torch_key)

torch.set_num_threads(1)

H, W = 64, 96


def _leaves(tree, path=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def _as_dicts(tree):
    return {k: _as_dicts(v) if hasattr(v, "items") else np.asarray(v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def variables():
    model = ge._flagship_model(H, W)
    img = np.zeros((1, H, W, 3), np.float32)
    v = jax.jit(lambda: model.init({"params": jax.random.PRNGKey(0)}, img,
                                   method=model.dummy_forward))()
    return _as_dicts(v)


@pytest.fixture(scope="module")
def port():
    return flagship_model(H, W, device="cpu")


def test_bridge_consumes_every_leaf_once(variables, port):
    leaves = [(c, p) for c in variables for p, _ in _leaves(variables[c])]
    keys = [torch_key(c, p) for c, p in leaves]
    assert len(set(keys)) == len(keys)
    sd = flax_to_state_dict(port, variables)
    assert set(sd) == set(keys) == set(port.state_dict())
    for k, t in port.state_dict().items():
        assert sd[k].shape == t.shape and sd[k].dtype == t.dtype, k


def test_bridge_layouts(variables, port):
    load_flax_variables(port, variables)
    p, s = variables["params"], variables["batch_stats"]
    bb = p["depth_backbone"]
    # encoder convs: HWIO -> OIHW
    np.testing.assert_array_equal(
        port.depth_backbone.conv1.weight.detach().numpy(),
        bb["conv1"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        port.depth_backbone.layer2_0.downsample_conv.weight.detach().numpy(),
        bb["layer2_0"]["downsample_conv"]["kernel"].transpose(3, 2, 0, 1))
    # decoder convs keep HWIO, the kernel's layout
    dec = p["head"]["depth_decoder"]
    np.testing.assert_array_equal(
        port.head.depth_decoder.trunk.upconv_1_1.conv.weight.detach().numpy(),
        dec["trunk"]["upconv_1_1"]["conv"]["kernel"])
    np.testing.assert_array_equal(
        port.head.depth_decoder.dispconv_3.conv.bias.detach().numpy(),
        dec["dispconv_3"]["conv"]["bias"])
    # BN: scale/bias params, mean/var stats
    bn = port.depth_backbone.layer3_1.bn2
    ref = bb["layer3_1"]["bn2"]["bn"]
    np.testing.assert_array_equal(bn.weight.detach().numpy(), ref["scale"])
    np.testing.assert_array_equal(bn.bias.detach().numpy(), ref["bias"])
    refs = s["depth_backbone"]["layer3_1"]["bn2"]["bn"]
    np.testing.assert_array_equal(bn.running_mean.numpy(), refs["mean"])
    np.testing.assert_array_equal(bn.running_var.numpy(), refs["var"])


@pytest.mark.parametrize("path,key", [
    (("params", ("depth_backbone", "conv1", "kernel")),
     "depth_backbone.conv1.weight"),
    (("params", ("depth_backbone", "bn1", "bn", "scale")),
     "depth_backbone.bn1.weight"),
    (("batch_stats", ("head", "depth_decoder", "trunk", "upconv_0_1", "norm",
                      "bn", "var")),
     "head.depth_decoder.trunk.upconv_0_1.norm.running_var"),
])
def test_torch_key(path, key):
    assert torch_key(*path) == key


def test_bridge_rejects_extra_leaf(variables, port):
    v = _as_dicts(variables)
    v["params"]["head"]["depth_decoder"]["dispconv_5"] = {
        "conv": {"bias": np.zeros(16, np.float32)}}
    with pytest.raises(KeyError):
        flax_to_state_dict(port, v)


def test_bridge_rejects_missing_leaf(variables, port):
    v = _as_dicts(variables)
    del v["batch_stats"]["depth_backbone"]["layer4_1"]["bn1"]["bn"]["var"]
    with pytest.raises(KeyError):
        flax_to_state_dict(port, v)


def test_bridge_rejects_wrong_shape(variables, port):
    v = _as_dicts(variables)
    k = v["params"]["head"]["depth_decoder"]["trunk"]["upconv_2_0"]["conv"]
    k["kernel"] = k["kernel"].transpose(3, 2, 0, 1)
    with pytest.raises(ValueError):
        flax_to_state_dict(port, v)
