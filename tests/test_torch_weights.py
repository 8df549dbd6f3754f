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


def test_learned_pose_round_trip():
    """``MonoDepthMeta``: the pose encoder (conv1 [7, 7, 6, 64]) and the
    ``PoseDecoder``'s four convs with their biases map both ways; flax ->
    port -> flax gives back every leaf bitwise, and no leaf is left out or
    doubled."""
    from test_torch_train_step import jax_init, jax_model

    from fsnet_tpu_torch.entry import learned_pose_model
    from fsnet_tpu_torch.models.flax_convert import to_flax

    img = np.zeros((1, H, W, 3), np.float32)
    v = _as_dicts(jax_init("meta", jax_model("meta", H, W), img))
    rng = np.random.RandomState(0)
    for c in v:
        for path, a in _leaves(v[c]):
            node = v[c]
            for k in path[:-1]:
                node = node[k]
            node[path[-1]] = rng.rand(*a.shape).astype(np.float32)
    assert v["params"]["pose_backbone"]["conv1"]["kernel"].shape == \
        (7, 7, 6, 64)
    dec = v["params"]["head"]["pose_decoder"]
    assert sorted(dec) == ["pose_0", "pose_1", "pose_2", "squeeze"]
    assert dec["pose_2"]["kernel"].shape == (1, 1, 256, 12)
    model = learned_pose_model(H, W, device="cpu")
    load_flax_variables(model, v)
    np.testing.assert_array_equal(
        model.head.pose_decoder.pose_0.weight.detach().numpy(),
        dec["pose_0"]["kernel"].transpose(3, 2, 0, 1))
    back = to_flax(model, model.state_dict())
    flat_v = {(c,) + p: a for c in v for p, a in _leaves(v[c])}
    flat_b = {(c,) + p: a for c in back for p, a in _leaves(back[c])}
    assert sorted(flat_b) == sorted(flat_v)
    for k, a in flat_v.items():
        np.testing.assert_array_equal(flat_b[k], a, err_msg=str(k))


def test_to_flax_arrays_own_their_memory():
    """``to_flax`` returns copies: no later in-place update of the module
    (here of every parameter and BN statistic, as a train-mode forward
    updates the running statistics) changes a tree it returned. JAX on the
    CPU may read a numpy input after its call has returned, so a view of
    the module's tensors would let the update reach a JAX computation
    dispatched before it."""
    from fsnet_tpu_torch.models.flax_convert import to_flax

    model = flagship_model(H, W, device="cpu")
    state = model.state_dict()
    tree = to_flax(model, state)
    before = {(c,) + p: a.copy() for c in tree for p, a in _leaves(tree[c])}
    with torch.no_grad():
        for t in state.values():
            if t.is_floating_point():
                t.add_(1.0)
    assert any(k[0] == "batch_stats" for k in before)
    for c in tree:
        for p, a in _leaves(tree[c]):
            assert a.flags.owndata, (c,) + p
            np.testing.assert_array_equal(a, before[(c,) + p],
                                          err_msg=str((c,) + p))
