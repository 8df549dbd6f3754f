"""The port's nuScenes datasets, evaluator and evaluation hook against the
JAX package's, on the CPU, on a JPEG tree written by
``tests/disk_trees.write_nusc_json_tree`` (720x320 frames, so that
CAM_BACK's mask from row 700 on shows; the model at 64x96):

* ``NusceneJsonDataset``'s ``dataset[i]`` bitwise equal to JAX's under an
  identity augmentation (CAM_FRONT and CAM_BACK samples, the mask, the VO
  depth read relative to the working directory, a missing VO file), and
  under the recipes' train augmentation from the same seeds within the
  gates of ``tests/test_torch_disk_data.py`` (bilinear images within 1e-3
  on the 0-255 scale, the rest bitwise);
* ``NusceneDepthMonoDataset`` and ``NusceneSweepDepthMonoDataset`` bitwise
  equal to JAX's with the fake devkit of ``tests/test_nuscenes_raw_dataset
  .py`` in both singleton caches: the static sample's resampling (the
  port's generator set to numpy's global state, which JAX draws from),
  the filter off, and a sweep walk two steps back;
* ``generate_depth_map`` and ``pad_or_trim_to_np`` bitwise; the
  evaluator's ``single_call`` through the ``samples`` -> ``gt_saved_dir``
  rewrite bitwise where the prediction has the ground truth's size, and
  resized (the port's ``resize_linear`` for ``cv2.resize``) within 1e-5
  relative on the continuous metrics and 1/N on a1-a3, N the frame's valid
  pixels, the tolerance of ``tests/test_torch_eval.py``;
* ``FastNuscEvaluationHook`` on bridged weights against JAX's hook (float32,
  ``jax_default_matmul_precision=highest``, no loader workers, the batch's
  strings kept from JAX's jitted step, which refuses them), each camera's
  means and their mean, at that tolerance;
* ``train.main`` on the port's ``nusc_wpose_example.py`` (cut to 64x96 and
  ResNet-18) on the tree: 2 steps, then an evaluation, equal to
  ``test.main`` on the saved checkpoint; ``check_hooks`` taking the
  nuScenes hooks and refusing the JAX package's names;
* ``PostOptFastNuscEvaluationHook`` on the same bridged weights against
  JAX's hook, on VO PNGs ``disk_trees.write_nusc_vo`` writes beside the
  tree at the unpadded input size: each camera's means within 1e-3
  relative (continuous) and 1/N (a1-a3), every frame refined; a VO map of
  another size raises.
"""
import os

import numpy as np
import pytest
import torch

import jax

import disk_trees as dt
import fsnet_tpu.data.datasets.nuscenes_utils as jnu
from fsnet_tpu_torch.configs import common as tcommon
from fsnet_tpu_torch.data.datasets import nuscenes_utils as tnu
from fsnet_tpu_torch.evaluation import nuscenes_unsupervised_eval as tne
from fsnet_tpu_torch.utils import build as tbuild
from fsnet_tpu_torch.utils.easydict import EasyDict as edict
from test_nuscenes_raw_dataset import VERSION, FakeNusc
from test_torch_disk_data import (TOL, _global_draws, _identity, _jax_cfg,
                                  _pair, _same_sample, _train_aug)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUSC_CONFIG = os.path.join(REPO, "fsnet_tpu_torch", "configs",
                           "nusc_wpose_example.py")
H0, W0 = 720, 320
H, W = 64, 96
REL = 1e-5          # continuous metrics; a1-a3 within 1/N
JSON = "nuscene_dataset.NusceneJsonDataset"


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """4 training and 4 val samples, CAM_FRONT and CAM_BACK in turn, the
    val frames' ground truth from seeded scans."""
    root = tmp_path_factory.mktemp("nusc")
    return dt.write_nusc_json_tree(root, H0, W0, 4, 4, seed=2,
                                   depth_map=tne.generate_depth_map)


# ---------------------------------------------------------------- datasets

def test_json_dataset_matches_jax(tree, monkeypatch, capsys):
    got, ref = _pair(JSON, _identity(), json_path=tree["train"])
    assert len(got) == len(ref) == 4
    for i in range(4):
        g = got[i]
        _same_sample(g, ref[i])
        assert g[("image", 0)].shape == (H0, W0, 3)
        assert g[("filename", 0)].startswith(os.path.join("samples",
                                                          g["camera_type"]))
        mask = g["patched_mask"]
        if g["camera_type"] == "CAM_BACK":
            assert not mask[700:].any() and mask[:700].all()
        else:
            assert mask.all()
    # the VO depth, its path relative to the working directory
    monkeypatch.chdir(tree["root"])
    rel = got[0][("filename", 0)].replace("samples", "vo").replace(".jpg",
                                                                   ".png")
    os.makedirs(os.path.dirname(rel))
    vo = np.random.RandomState(3).randint(0, 65536, (H0, W0)).astype(
        np.uint16)
    dt.write_png(rel, vo)
    got, ref = _pair(JSON, _identity(), json_path=tree["train"],
                     vo_path="vo")
    for i in (0, 1):                 # a VO file, then none
        g, r = got[i], ref[i]
        _same_sample(g, r)
        assert (("vo_depth", 0) in g) == (i == 0)
    assert "No VO Depth file found at 1" in capsys.readouterr().out


def test_json_dataset_train_augmentation_matches_jax(tree):
    got, ref = _pair(JSON, _train_aug(), json_path=tree["train"])
    stds = np.array([0.229, 0.224, 0.225])
    approx = {}
    for f in (0, 1, -1):
        approx[("image", f)] = TOL / (255 * stds.min())
        approx[("original_image", f)] = TOL / 255
    for i, seed in ((0, 5), (1, 12), (1, 19)):    # CAM_BACK mask warped
        _global_draws(got.transform, seed)
        g = got[i]
        np.random.seed(seed)
        _same_sample(g, ref[i], approx)
        assert g[("image", 0)].shape == (H, W, 3)


@pytest.fixture
def fake_devkit(tmp_path, monkeypatch):
    """The fake devkit (272x320 PIL JPEGs; ego pose 2 repeats pose 1) in
    both packages' singleton caches."""
    fake = FakeNusc(tmp_path, n=4, static_pair=2)
    for cache in (jnu.GLOBAL_DICT, tnu.GLOBAL_DICT):
        monkeypatch.setitem(cache, (str(tmp_path), VERSION), fake)
    return tmp_path


def _raw_pair(root, cls, lines, **kw):
    split = root / f"split_{len(lines)}.txt"
    split.write_text("".join(f"{line}\n" for line in lines))
    return _pair(f"nuscene_dataset.{cls}", _identity(),
                 nuscenes_version=VERSION, nuscenes_dir=str(root),
                 split_file=str(split), channels=["CAM_FRONT"], **kw)


def test_raw_dataset_matches_jax(fake_devkit):
    # line 0: the next frame repeats the pose (static); line 1 moves
    got, ref = _raw_pair(fake_devkit, "NusceneDepthMonoDataset",
                         ["s1,s2,s0", "s1,s0,s3"], frame_ids=[0, 1, -1])
    assert len(got) == len(ref) == 2
    _same_sample(got[1], ref[1])
    for seed in (0, 1, 2):
        got.rng = np.random.RandomState(seed)
        g = got[0]
        np.random.seed(seed)
        r = ref[0]
        _same_sample(g, r)
        _same_sample(g, got[1])                  # resampled to line 1
        assert np.array_equal(got.rng.get_state()[1],
                              np.random.get_state()[1])
    got, ref = _raw_pair(fake_devkit, "NusceneDepthMonoDataset",
                         ["s1,s2,s0"], frame_ids=[0, 1, -1],
                         is_filter_static=False)
    g = got[0]
    _same_sample(g, ref[0])
    assert np.linalg.norm(g[("relative_pose", 1)][:3, 3]) < 1e-6


def test_sweep_dataset_matches_jax(fake_devkit):
    got, ref = _raw_pair(fake_devkit, "NusceneSweepDepthMonoDataset",
                         ["s2,s0,s0"], frame_ids=[0, 1, -2])
    g = got[0]
    _same_sample(g, ref[0])
    # s2 -> sd3 (x 3) and sd2 -> sd1 -> sd0 (x 0)
    assert abs(np.linalg.norm(g[("relative_pose", 1)][:3, 3]) - 2.0) < 1e-5
    assert abs(np.linalg.norm(g[("relative_pose", -2)][:3, 3]) - 1.0) < 1e-5


# --------------------------------------------------------------- evaluator

def test_depth_map_and_pad_match_jax():
    import fsnet_tpu.evaluation.nuscenes_unsupervised_eval as jne

    K = dt.nusc_intrinsics(H0, W0)
    for i, cam in enumerate(("CAM_FRONT", "CAM_BACK")):
        velo = dt.velodyne_scan(40 + i)
        if cam == "CAM_BACK":
            velo[:, :2] = -velo[:, :2]
        T = dt.nusc_extrinsics(cam)
        for shape in ((H0, W0), (900, 1600)):
            got = tne.generate_depth_map(velo, T, K, im_shape=shape)
            ref = jne.generate_depth_map(velo, T, K, im_shape=shape)
            assert got.dtype == ref.dtype and (got > 0).sum() > 1000
            np.testing.assert_array_equal(got, ref)
    x = np.arange(35, dtype=np.float32).reshape(7, 5)
    for shape in ((9, 8), (3, 2), (7, 5), (4, 9)):
        got, ref = (tne.pad_or_trim_to_np(x, shape, 1.5),
                    jne.pad_or_trim_to_np(x, shape, 1.5))
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


def _evaluators(tree):
    import fsnet_tpu.evaluation.nuscenes_unsupervised_eval as jne

    args = ("/unused", tree["split"], tree["gt"])
    return tne.NuscenesEvaluator(*args), jne.NuscenesEvaluator(*args)


def _valid(gt):
    h, w = gt.shape
    crop = np.array([0.03594771 * h, 0.99189189 * h, 0.03594771 * w,
                     0.96405229 * w]).astype(np.int32)
    inside = np.zeros_like(gt, dtype=bool)
    inside[crop[0]:crop[1], crop[2]:crop[3]] = True
    return int(((gt > 1e-3) & (gt < 80.0) & inside).sum())


def _held(got, ref, n):
    assert abs(got["ratio"] - ref["ratio"]) <= REL * abs(ref["ratio"])
    for suite in ("error", "abs_error"):
        g, r = np.array(got[suite]), np.array(ref[suite])
        assert np.all(np.abs(g[:4] - r[:4]) <= REL * np.abs(r[:4])), (
            suite, g, r)
        assert np.all(np.abs(g[4:] - r[4:]) <= 1.0 / n), (suite, g, r)


def test_single_call_matches_jax(tree):
    from fsnet_tpu_torch.data.datasets.io_utils import read_depth

    port, ref = _evaluators(tree)
    assert port.token_list == ref.token_list and len(port.token_list) == 4
    rng = np.random.RandomState(1)
    got, _ = _pair(JSON, _identity(), json_path=tree["val"])
    for i in range(4):
        name = got[i][("filename", 0)]
        gt = read_depth(os.path.join(
            tree["gt"], *name.split(os.sep)[1:])[:-4] + ".png")
        assert _valid(gt) > 500
        y = np.linspace(0.5, 1.0, H0)[:, None]
        same = (8.0 / y * rng.uniform(0.8, 1.2, (H0, W0))).astype(np.float32)
        a, b = port.single_call(same, name), ref.single_call(same, name)
        assert a["ratio"] == b["ratio"]
        for suite in ("error", "abs_error"):
            assert list(a[suite]) == list(b[suite])
        small = (8.0 / np.linspace(0.5, 1.0, H)[:, None]
                 * rng.uniform(0.8, 1.2, (H, W))).astype(np.float32)
        _held(port.single_call(small, name), ref.single_call(small, name),
              _valid(gt))


def test_precompute_raises_without_devkit(tree, tmp_path):
    import fsnet_tpu.evaluation.nuscenes_unsupervised_eval as jne

    missing = str(tmp_path / "no_gt")
    for cls in (tne.NuscenesEvaluator, jne.NuscenesEvaluator):
        with pytest.raises(ImportError):
            cls("/unused", tree["split"], missing)


# ----------------------------------------------------------- the whole hook

def _small(resnet_depth=18):
    return tcommon.wpose_meta_arch(
        edict(rgb_shape=(H, W, 3), frame_idxs=[0, 1, -1]), pretrained=False,
        resnet_depth=resnet_depth, base_fx=369, num_output_channels=64,
        overlapped_mask=False)


def _val_aug():
    return tcommon.wpose_augmentation(edict(rgb_shape=(H, W, 3)),
                                      [0, 1, -1], train=False)


def _hook_cfg(tree, **extra):
    hook = tcommon.nusc_evaluate_hook("/unused", REPO)
    hook.dataset_eval_cfg.update(split_file=tree["split"],
                                 gt_saved_dir=tree["gt"])
    hook.update(extra)
    return hook


@pytest.fixture(scope="module")
def bridged():
    """The small port model with BN statistics away from the identity, and
    a JAX train state on its weights (bridged by ``to_flax``)."""
    import optax

    from fsnet_tpu.runtime.state import TrainState
    from fsnet_tpu.utils.builder import build as jbuild
    from fsnet_tpu_torch.models.flax_convert import to_flax

    model = tbuild(**_small(), device="cpu", seed=3)
    with torch.no_grad():          # BN statistics away from the identity
        g = torch.Generator().manual_seed(4)
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=g))
            elif name.endswith("running_var"):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=g))
    variables = to_flax(model, model.state_dict())
    jmodel = jbuild(**_jax_cfg(_small()))
    state = TrainState.create(apply_fn=jmodel.apply,
                              params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              tx=optax.identity())
    return model, state


def _jax_hook_means(hook, state, val, monkeypatch):
    """JAX's hook over ``val``: each camera's logged means, and the mean
    over the cameras under ``all mean``."""
    import fsnet_tpu.evaluation.nuscenes_unsupervised_eval as jne
    import fsnet_tpu.pipeline_hooks.train_val_hooks as jtv
    from fsnet_tpu.utils.builder import build as jbuild

    logged = {}
    monkeypatch.setattr(
        jne.NuscenesEvaluator, "log",
        lambda self, writer, cam, m, a, **kw: logged.update({cam: (m, a)}))
    # JAX's hook hands the whole batch, its strings (camera_type,
    # filename) too, to its jitted eval step, which refuses them: a fault
    # on the reference side; the strings are kept from that step here
    call = jtv.BaseValidationHook.__call__
    monkeypatch.setattr(
        jtv.BaseValidationHook, "__call__",
        lambda self, data, *a, **kw: call(
            self, {k: v for k, v in data.items()
                   if not isinstance(v, list)}, *a, **kw))
    with jax.default_matmul_precision("highest"):
        jbuild(**_jax_cfg(hook))(state, jbuild(**_jax_cfg(val)))
    return logged


def _held_means(tree, port, got, logged, rel):
    from fsnet_tpu_torch.data.datasets.io_utils import read_depth

    assert sorted(logged) == ["CAM_BACK", "CAM_FRONT", "all mean"]
    assert sorted(port.channel_means) == ["CAM_BACK", "CAM_FRONT"]
    n = min(_valid(read_depth(p)) for p in (
        os.path.join(d, f) for d, _, fs in os.walk(tree["gt"]) for f in fs))
    pairs = [(port.channel_means[c], logged[c]) for c in port.channel_means]
    pairs.append((got, logged["all mean"]))
    for g_suites, r_suites in pairs:
        for g, r in zip(g_suites, r_suites):
            assert g.shape == (7,) and np.isfinite(g).all()
            assert np.all(np.abs(g[:4] - r[:4]) <= rel * np.abs(r[:4])), (
                g, r)
            assert np.all(np.abs(g[4:] - r[4:]) <= 1.0 / n), (g, r)


def test_fast_nusc_hook_matches_jax(tree, monkeypatch, bridged):
    """Each camera's means and their mean within REL (continuous) and 1/N
    (a1-a3) of JAX's, N the fewest valid pixels of a frame."""
    model, state = bridged
    val = edict(name=f"fsnet_tpu_torch.data.datasets.{JSON}",
                json_path=tree["val"], augmentation=_val_aug())
    hook = _hook_cfg(tree, batch_size=3, num_workers=0)
    port = tbuild(**hook, device="cpu")
    got = port(model, tbuild(**val))
    logged = _jax_hook_means(hook, state, val, monkeypatch)
    _held_means(tree, port, got, logged, REL)


def _jitted_refine(monkeypatch):
    """JAX's refine jitted for its hook (one compile, not one per
    operation); the same function."""
    import fsnet_tpu.ops.postopt as jpo

    monkeypatch.setattr(jpo, "post_optimization", jax.jit(
        jpo.post_optimization, static_argnames=(
            "h_seg", "w_seg", "lab_dist_weight", "iter_num",
            "depth_dist_weight", "image_dist_weight", "lambda0", "lambda1",
            "lambda2", "max_points")))


def test_postopt_nusc_hook_matches_jax(tree, monkeypatch, bridged):
    """``PostOptFastNuscEvaluationHook`` against JAX's on frames whose VO
    PNGs ``disk_trees.write_nusc_vo`` wrote at the unpadded input size
    (64x96): each camera's means and their mean within 1e-3 relative
    (continuous) and 1/N (a1-a3); every frame refined, the metrics moved
    from the unrefined hook's; a VO map of another size raises."""
    model, state = bridged
    vo = dt.write_nusc_vo(tree, "samples_vo", H, W, seed=5,
                          depth_map=tne.generate_depth_map)
    assert min(vo["points"]) > 200
    val = edict(name=f"fsnet_tpu_torch.data.datasets.{JSON}",
                json_path=tree["val"], augmentation=_val_aug(),
                vo_path=vo["vo_path"])
    hook = _hook_cfg(tree, batch_size=3, num_workers=0)
    plain = tbuild(**hook, device="cpu")(model, tbuild(**val))
    hook.name = hook.name.replace("FastNusc", "PostOptFastNusc")
    port = tbuild(**hook, device="cpu")
    got = port(model, tbuild(**val))
    assert port.post_opt["refined"] == 4 and port.post_opt["unrefined"] == 0
    assert np.abs(got[0][:4] - plain[0][:4]).max() > 1e-3
    _jitted_refine(monkeypatch)
    logged = _jax_hook_means(hook, state, val, monkeypatch)
    _held_means(tree, port, got, logged, 1e-3)
    small = dt.write_nusc_vo(tree, "samples_vo_small", H // 2, W // 2,
                             seed=5, depth_map=tne.generate_depth_map)
    with pytest.raises(ValueError, match="vo_depth"):
        port(model, tbuild(**dict(val, vo_path=small["vo_path"])))


# ------------------------------------------------------ the training loop

@pytest.fixture
def no_writer(monkeypatch):
    from fsnet_tpu_torch.scripts import train as train_script

    monkeypatch.setattr(train_script, "_writer", lambda *a, **k: None)


def test_train_main_evaluates_as_test_main(tree, tmp_path, no_writer):
    from fsnet_tpu_torch.scripts import test as test_script
    from fsnet_tpu_torch.scripts import train as train_script

    small = edict(rgb_shape=(H, W, 3))
    ev = "trainer.evaluate_hook."
    over = {
        "path.checkpoint_path": str(tmp_path / "ckpt"),
        "train_dataset.cfg_list": [dict(
            name=f"fsnet_tpu_torch.data.datasets.{JSON}",
            json_path=tree["train"])],
        "train_dataset.augmentation": tcommon.wpose_augmentation(
            small, [0, 1, -1], train=True),
        "val_dataset.json_path": tree["val"],
        "val_dataset.augmentation": _val_aug(),
        "meta_arch": _small(), "data.batch_size": 2, "data.num_workers": 0,
        "trainer.max_epochs": 1, "trainer.disp_iter": 1,
        ev + "num_workers": 0,
        ev + "dataset_eval_cfg.split_file": tree["split"],
        ev + "dataset_eval_cfg.gt_saved_dir": tree["gt"],
    }
    out = train_script.main(config=NUSC_CONFIG, device="cpu", **over)
    assert out["global_step"] == 2 and len(out["evals"]) == 1
    run = out["evals"][0]
    assert sorted(run["channels"]) == ["CAM_BACK", "CAM_FRONT"]
    for suites in [(run["errors"], run["abs_errors"])] + list(
            run["channels"].values()):
        for s in suites:
            assert s.shape == (7,) and np.isfinite(s).all()
    res = test_script.main(config=NUSC_CONFIG, checkpoint=out["checkpoint"],
                           device="cpu", **over)
    assert res["samples"] == 4 and res["epoch"] == 1
    np.testing.assert_array_equal(res["errors"], run["errors"])
    np.testing.assert_array_equal(res["abs_errors"], run["abs_errors"])
    for cam, suites in run["channels"].items():
        for a, b in zip(res["channels"][cam], suites):
            np.testing.assert_array_equal(a, b)


def test_check_hooks_takes_nusc(no_writer):
    from fsnet_tpu_torch.scripts.train import check_hooks
    from fsnet_tpu_torch.utils import cfg_from_file, update_cfg

    cfg = cfg_from_file(NUSC_CONFIG)
    check_hooks(cfg)
    for key, value in (
            ("trainer.evaluate_hook.name",
             "fsnet_tpu.pipeline_hooks.evaluation_hooks."
             "PostOptFastNuscEvaluationHook"),
            ("trainer.evaluate_hook.dataset_eval_cfg.name",
             "fsnet_tpu.evaluation.fusionportable_eval."
             "FusionPortableEvaluator")):
        with pytest.raises(NotImplementedError, match=value.split(".")[-1]):
            check_hooks(update_cfg(cfg_from_file(NUSC_CONFIG),
                                   **{key: value}))
    # the port's FusionPortable evaluator and post-opt hook (ported since)
    # pass
    check_hooks(update_cfg(cfg_from_file(NUSC_CONFIG), **{
        "trainer.evaluate_hook.dataset_eval_cfg.name":
            "fsnet_tpu_torch.evaluation.fusionportable_eval."
            "FusionPortableEvaluator"}))
    check_hooks(update_cfg(cfg_from_file(NUSC_CONFIG), **{
        "trainer.evaluate_hook.name":
            "fsnet_tpu_torch.pipeline_hooks.evaluation_hooks."
            "PostOptFastNuscEvaluationHook"}))
