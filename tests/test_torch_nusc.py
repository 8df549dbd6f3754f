"""The port's nuScenes recipes against the shipped configs and the JAX
package, on the CPU:

* the port's config copies (``entry.nusc_config``, ``entry.distill_config``)
  field by field against ``meta_arch`` of ``configs/nusc_wpose_example.py``
  and ``configs/distill_nusc_example.py`` at 288x512, with the port's names
  and two known differences: ``pretrained`` is off (no ImageNet weights
  in the repo) and there is no ``teacher_net_path`` (no trained teacher);
* the recipe (``entry.NUSC_RECIPE``) against the configs' optimizer,
  scheduler and clip, and ``entry.nusc_batch`` against the recipe's batch;
* ``forward_test`` of the nuScenes ``MonoDepthWPose`` (ResNet-34, 64 bins,
  ``base_fx=369``) against JAX's at 64x128 in float64, from bridged
  weights (depth within 1e-10 of max |ref|).
"""
import os

import numpy as np
import pytest
import torch

import jax

from fsnet_tpu_torch.entry import (NUSC_RECIPE, distill_config, nusc_batch,
                                   nusc_config, nusc_model)
from fsnet_tpu_torch.models.flax_convert import load_flax_variables
from fsnet_tpu_torch.ops import conv3x3 as tc
from fsnet_tpu_torch.runtime.state import make_eval_step

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {"nusc_wpose_example.py": nusc_config,
           "distill_nusc_example.py": distill_config}


def _plain(node):
    """A config tree as plain dicts and lists (tuples, lists and numpy arrays
    alike), with the port's module names read as the JAX package's."""
    if isinstance(node, dict):
        return {k: _plain(v) for k, v in node.items()}
    if isinstance(node, (list, tuple, np.ndarray)):
        return [_plain(v) for v in list(node)]
    if isinstance(node, str):
        return node.replace("fsnet_tpu_torch.", "fsnet_tpu.")
    return node


def _load(name):
    from fsnet_tpu.utils import cfg_from_file

    return cfg_from_file(os.path.join(REPO, "configs", name))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_copy_matches_shipped(name):
    cfg = _load(name)
    ref = _plain(cfg.meta_arch)
    got = _plain(CONFIGS[name](*cfg.data.rgb_shape[:2]))
    # the known differences, then equality of everything else
    assert got.pop("teacher_net_path", "") == ""
    assert ("teacher_net_path" in ref) == (name.startswith("distill"))
    ref.pop("teacher_net_path", None)
    backbones = [("depth_backbone_cfg",)]
    if "teacher_net_cfg" in ref:
        backbones.append(("teacher_net_cfg", "backbone_cfg"))
    for path in backbones:
        r, g = ref, got
        for k in path:
            r, g = r[k], g[k]
        assert g.pop("pretrained") is False
        r.pop("pretrained")
    assert got == ref


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_recipe_matches_shipped(name):
    cfg = _load(name)
    assert NUSC_RECIPE["optimizer"] == dict(cfg.optimizer)
    assert NUSC_RECIPE["scheduler"] == dict(cfg.scheduler)
    assert NUSC_RECIPE["clip_gradients"] == \
        cfg.trainer.training_hook.clip_gradients
    H, W, _ = cfg.data.rgb_shape
    assert nusc_batch.__defaults__ == (cfg.data.batch_size, H, W)
    # at a ninth of the size (the full batch's textures take a minute of
    # scipy here): the CAM_BACK ego body, the bottom 2/9 of the rows
    batch = nusc_batch(2, H // 9, W // 9 * 2)
    mask = batch["patched_mask"]
    assert mask.shape == (2, H // 9, W // 9 * 2)
    cut = H // 9 - (2 * (H // 9)) // 9
    assert (mask[:, :cut] == 1).all() and (mask[:, cut:] == 0).all()
    assert batch["image/0"].shape == (2, H // 9, W // 9 * 2, 3)


def test_nusc_forward_test_matches_jax_f64(monkeypatch):
    from fsnet_tpu.utils.builder import build

    B, H, W = 2, 64, 128
    cfg = nusc_config(H, W)
    jmodel = build(**_plain(cfg))
    img = np.random.RandomState(0).rand(B, H, W, 3).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        v = jax.jit(lambda x: jmodel.init(jax.random.PRNGKey(0), x,
                                          method=jmodel.dummy_forward))(img)

    rng = np.random.RandomState(1)

    def leaf(path, a):
        a = np.asarray(a)
        name = str(path[-1].key)
        if name in ("var", "scale"):
            return 0.5 + rng.rand(*a.shape)
        if name in ("mean", "bias"):
            return 0.1 * rng.randn(*a.shape)
        return a.astype(np.float64)
    v = jax.tree_util.tree_map_with_path(leaf, v)
    v = {c: jax.tree.map(np.asarray, dict(t)) for c, t in v.items()}
    batch = {k: a.astype(np.float64) for k, a in nusc_batch(B, H, W).items()
             if k in ("image/0", "P2")}
    jax.config.update("jax_enable_x64", True)
    try:
        ref = np.asarray(jax.jit(lambda v, b: jmodel.apply(
            v, b, {"is_training": False}))(v, batch)["depth"])
    finally:
        jax.config.update("jax_enable_x64", False)
    model = nusc_model(H, W, device="cpu").double()  # loads in float64
    load_flax_variables(model, v)
    assert model.head.depth_decoder.dispconv_0.conv.weight.shape[-1] == 64
    assert model.head.depth_decoder.base_fx == 369
    assert not model.head.overlapped_mask
    monkeypatch.setitem(tc._DTYPES, torch.float64, -1)
    got = make_eval_step("cpu")(model, batch)["depth"].numpy()
    assert got.shape == ref.shape == (B, H, W, 1)
    assert np.abs(got - ref).max() <= 1e-10 * np.abs(ref).max()
