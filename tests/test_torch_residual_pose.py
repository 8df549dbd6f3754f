"""The residual-pose branch of ``MonoDepthWPose``
(``entry.residual_pose_model``: the flagship with a ResNet-18 pose net on
frame pairs whose residual refines each GT pose, the translation rescaled
to the GT norm per sample) on the CPU against the JAX package, from the
same bridged weights.

* The train step at 64x96 in float64 against the JAX package's on its
  XLA route (both take the grid route: the poses carry gradients), as
  ``tests/test_torch_train_step.py`` holds ``meta_xla``: loss within
  1e-10 rel (measured 4.3e-16), every gradient leaf within 1e-4 rel-L2
  (9.9e-14; the decoder's BN-cancelled conv biases held to 1e-6 of the
  gradient norm on both sides instead), the clip's global norm within
  1e-10 rel, the BN statistics after the step within 1e-6 (the pose net's
  BN takes one update per source frame on both sides). The bf16 step is
  ``tests/test_torch_bf16_models.py``'s.
* The weight bridge both ways, strictly: flax -> port -> flax gives back
  every leaf bitwise, the pose net's conv1 [7, 7, 6, 64] and the
  ``PoseDecoder``'s convs included.
* The frozen prefixes and the pretrained graft name ``pose_backbone`` on
  this model as on ``MonoDepthMeta`` and the JAX package.
"""
import numpy as np
import pytest
import torch

import jax
import optax

from fsnet_tpu_torch.entry import (flagship_optimizer, residual_pose_config,
                                   residual_pose_model)
from fsnet_tpu_torch.models.flax_convert import load_flax_variables, to_flax
from fsnet_tpu_torch.ops import conv3x3 as tc
from fsnet_tpu_torch.ops import photo_loss as tpl
from fsnet_tpu_torch.ops import warp_depth as twd
from fsnet_tpu_torch.ops import warp_fast as twf
from fsnet_tpu_torch.runtime.state import make_train_step

from test_torch_train_step import (_batch, _bn_cancelled, _flat, _jax_names,
                                   _randomise, _rel_l2, _to_dicts, jax_init)

torch.set_num_threads(1)
H, W = 64, 96


def _jax_model():
    from fsnet_tpu.utils.builder import build

    return build(**_jax_names(residual_pose_config(H, W)))


def test_residual_pose_step_matches_jax_f64(monkeypatch):
    from fsnet_tpu.runtime.optim import build_optimizer

    batch = _batch(H, W, np.float64)
    model = _jax_model()
    jax.config.update("jax_enable_x64", True)
    try:
        with jax.default_matmul_precision("highest"):
            v = jax_init("meta", model, batch["image/0"])
            v = jax.tree.map(lambda a: np.asarray(a, np.float64), _to_dicts(
                _randomise(v, np.random.RandomState(0))))

            def loss_fn(params):
                out, mutated = model.apply(
                    {"params": params, "batch_stats": v["batch_stats"]},
                    batch, {"is_training": True}, mutable=["batch_stats"])
                return out["loss"], mutated

            (loss, mutated), grads = jax.jit(jax.value_and_grad(
                loss_fn, has_aux=True))(v["params"])
            tx, _ = build_optimizer(dict(name="adam", lr=1e-4),
                                    dict(name="StepLR", step_size=8),
                                    steps_per_epoch=1000, clip_gradients=1.0)
            ref_norm = float(optax.global_norm(grads))
    finally:
        jax.config.update("jax_enable_x64", False)
    ref_g = dict(_flat(_to_dicts(grads)))
    ref_s = dict(_flat(_to_dicts(mutated["batch_stats"])))

    port = residual_pose_model(H, W, device="cpu").double()
    load_flax_variables(port, v)
    opt, _ = flagship_optimizer(port)
    monkeypatch.setitem(tc._DTYPES, torch.float64, -1)
    for mod in (twd, twf, tpl):
        monkeypatch.setattr(mod, "_DTYPES", (torch.float64,))
    warps = []
    monkeypatch.setattr(twf, "grid_band_plain",
                        lambda *a, _o=twf.grid_band_plain, **k:
                        (warps.append(1), _o(*a, **k))[1])
    met = make_train_step("cpu", with_grads=True)(port, opt, batch)
    assert warps, "the residual-pose step did not take the grid route"
    got_g = dict(_flat(to_flax(port, met["_grads"])["params"]))
    got_s = dict(_flat(to_flax(port, {
        k: t for k, t in port.state_dict().items()
        if k.endswith(("running_mean", "running_var"))})["batch_stats"]))

    assert abs(float(met["loss"]) - float(loss)) <= 1e-10 * abs(float(loss))
    assert abs(float(met["grad_norm"]) - ref_norm) <= 1e-10 * ref_norm
    assert sorted(got_g) == sorted(ref_g)
    assert any(p[0] == "pose_backbone" for p in ref_g)
    kept = [p for p in ref_g if not _bn_cancelled(p)]
    g_norm = np.sqrt(sum(float(np.sum(np.square(ref_g[p]))) for p in kept))
    errs = {}
    for path, r in ref_g.items():
        if _bn_cancelled(path):
            assert np.abs(r).max() <= 1e-6 * g_norm, path
            assert np.abs(got_g[path]).max() <= 1e-6 * g_norm, path
        else:
            errs[path] = _rel_l2(got_g[path], r)
    worst = max(errs, key=errs.get)
    print(f"residual pose f64: loss rel "
          f"{abs(float(met['loss']) - float(loss)) / abs(float(loss)):.2e}; "
          f"worst leaf {'/'.join(worst)} {errs[worst]:.2e}")
    assert errs[worst] <= 1e-4
    assert sorted(got_s) == sorted(ref_s)
    for path, r in ref_s.items():
        assert np.all(np.abs(got_s[path] - r)
                      <= 1e-6 * np.maximum(1.0, np.abs(r))), path


def test_residual_pose_bridge_round_trip():
    v = _to_dicts(jax_init("meta", _jax_model(),
                           np.zeros((1, H, W, 3), np.float32)))
    rng = np.random.RandomState(0)
    leaves = {(c,) + p: a for c in v for p, a in _flat(v[c])}
    for (c, *path), a in leaves.items():
        node = v[c]
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = rng.rand(*np.shape(a)).astype(np.float32)
    assert v["params"]["pose_backbone"]["conv1"]["kernel"].shape == \
        (7, 7, 6, 64)
    assert sorted(v["params"]["head"]["pose_decoder"]) == [
        "pose_0", "pose_1", "pose_2", "squeeze"]
    model = residual_pose_model(H, W, device="cpu")
    load_flax_variables(model, v)
    back = to_flax(model, model.state_dict())
    flat_v = {(c,) + p: a for c in v for p, a in _flat(v[c])}
    flat_b = {(c,) + p: a for c in back for p, a in _flat(back[c])}
    assert sorted(flat_b) == sorted(flat_v)
    for k, a in flat_v.items():
        np.testing.assert_array_equal(flat_b[k], a, err_msg=str(k))
    extra = dict(v)
    extra["params"] = dict(v["params"], pose_extra={"kernel": np.zeros(1)})
    with pytest.raises(KeyError):
        load_flax_variables(model, extra)


def test_residual_pose_frozen_and_pretrained_prefixes(tmp_path, monkeypatch):
    """``runtime.optim.frozen_param_prefixes`` freezes the pose net's stages
    as the JAX package's does, and ``runtime.pretrained`` grafts a ResNet
    state_dict into ``pose_backbone`` (six input channels) on this model."""
    from fsnet_tpu.runtime.optim import \
        frozen_param_prefixes as jax_prefixes
    from fsnet_tpu_torch.runtime import optim as topt
    from fsnet_tpu_torch.runtime.pretrained import graft_pretrained_backbones

    from test_torch_train_loop import _fake_resnet18

    cfg = residual_pose_config(H, W)
    cfg["pose_backbone_cfg"]["frozen_stages"] = 1
    prefixes = topt.frozen_param_prefixes(cfg)
    assert prefixes == list(jax_prefixes(_jax_names(cfg)))
    assert ("pose_backbone", "layer1_") in prefixes
    model = residual_pose_model(H, W, device="cpu")
    mask = topt.build_frozen_mask(model, prefixes)
    frozen = [n for n, f in mask.items() if f]
    assert frozen and all(n.startswith("pose_backbone.") for n in frozen)

    torch.save(_fake_resnet18(np.random.RandomState(0)),
               tmp_path / "resnet18.pth")
    cfg["pose_backbone_cfg"]["pretrained_path"] = str(tmp_path /
                                                      "resnet18.pth")
    before = model.pose_backbone.conv1.weight.detach().clone()
    assert graft_pretrained_backbones(model, cfg, verbose=False) == [
        "pose_backbone"]
    after = model.pose_backbone.conv1.weight
    assert after.shape[1] == 6 and not torch.equal(after, before)


def test_residual_pose_model_without_device_raises():
    """Built without ``device=``, the model goes to CUDA, and raises where
    there is none, as every entry point of the port does."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        residual_pose_model(H, W)
