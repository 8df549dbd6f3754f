"""The port's evaluation against the JAX package's, and the training
loop's evaluation, on the CPU, on trees written by ``tests/disk_trees.py``
(272x320 frames; the model at 64x96):

* ``compute_errors`` and ``compute_supervised_errors`` bitwise equal to
  JAX's; the masked torch suite within 1e-6 of the masked jnp one;
* the ground-truth precompute of ``KittiEigenEvaluator`` and
  ``Kitti360Evaluator`` bitwise equal to JAX's, each package reading the
  other's ``.npz``;
* ``_single_loss`` on the same prediction: bitwise where the prediction
  has the ground truth's size (the resize is then the identity); resized
  (the port's ``resize_linear`` for ``cv2.resize``) within 1e-5 relative
  on the continuous metrics and 1/N on a1-a3, N the frame's valid pixels;
* the whole ``KittiEvaluationHook`` on bridged weights against JAX's hook
  (float32, ``jax_default_matmul_precision=highest``, ``num_workers=0``
  in both) at the same tolerances;
* ``train.main`` on the port's KITTI raw recipe on a tiny tree: 2 steps,
  then an evaluation of 2 frames, equal to ``test.main`` on the saved
  checkpoint, in-process and with a loader worker; ``train.main`` and ``test.main`` raise at config load on a
  ``precompute_hook`` and on an evaluator the port lacks;
* the port's copies of ``configs/kitti_wpose_example.py``,
  ``kitti360_wpose_example.py``, ``nusc_wpose_example.py``,
  ``distill_nusc_example.py``, ``multi_dataset_example.py``,
  ``distill_kitti_example.py`` and ``distill_kitti360_example.py`` equal
  to them, names aside.
"""
import os

import numpy as np
import pytest
import torch

import jax

import disk_trees as dt
from fsnet_tpu_torch.configs import common as tcommon
from fsnet_tpu_torch.evaluation import kitti_unsupervised_eval as tke
from fsnet_tpu_torch.ops import metrics as tmetrics
from fsnet_tpu_torch.utils import build as tbuild
from fsnet_tpu_torch.utils import cfg_from_file
from fsnet_tpu_torch.utils.easydict import EasyDict as edict

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "fsnet_tpu_torch", "configs")
KITTI_CONFIG = os.path.join(CONFIGS, "kitti_wpose_example.py")
H0, W0 = 272, 320
H, W = 64, 96
DATE = "2011_09_26"
DRIVE = f"{DATE}/{DATE}_drive_0002_sync"
REL = 1e-5          # continuous metrics; a1-a3 within 1/N


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """A KITTI raw tree (6 frames with velodyne scans, a train split of 4
    entries and a test split of 3) and a KITTI-360 tree (4 frames with
    scans, a val list of 3)."""
    root = tmp_path_factory.mktemp("eval_trees")
    raw = root / "raw"
    dt.write_kitti_date(str(raw / DATE), H0, W0)
    dt.write_kitti_drive(str(raw), DRIVE, 6, H0, W0, seed=5, velodyne=True)
    k360 = root / "kitti360"
    dt.write_kitti360(str(k360), H0, W0, [0.0, 1.0, 2.0, 3.0], seed=6,
                      velodyne=True)
    seq = dt.KITTI360_SEQ
    return dict(
        root=root, raw=str(raw), k360=str(k360),
        train=dt.write_split(root / "train.txt", [
            f"{DRIVE} 1 l", f"{DRIVE} 2 r", f"{DRIVE} 3 l", f"{DRIVE} 4 r"]),
        test=dt.write_split(root / "test.txt", [
            f"{DRIVE} 1 l", f"{DRIVE} 3 l", f"{DRIVE} 4 l"]),
        val360=dt.write_split(root / "val360.txt", [
            f"{seq},1,1,0,2", f"{seq},2,2,1,3", f"{seq},1,1,0,2"]))


def _jax_names(node):
    from fsnet_tpu.utils.easydict import EasyDict as jedict

    if isinstance(node, dict):
        return jedict({k: _jax_names(v) for k, v in node.items()})
    if isinstance(node, list):
        return [_jax_names(v) for v in node]
    if isinstance(node, str):
        return node.replace("fsnet_tpu_torch.", "fsnet_tpu.")
    return node


def _gt(trees, kind, tmp_path, package="port"):
    """An evaluator of ``kind`` over the trees, its ground truth written to
    (or read from) ``tmp_path/<kind>_<package>.npz``."""
    data_path, split = ((trees["raw"], trees["test"]) if kind == "kitti"
                        else (trees["k360"], trees["val360"]))
    name = "KittiEigenEvaluator" if kind == "kitti" else "Kitti360Evaluator"
    gt = str(tmp_path / f"{kind}_{package}.npz")
    if package == "port":
        return getattr(tke, name)(data_path, split, gt)
    import fsnet_tpu.evaluation.kitti_unsupervised_eval as jke

    return getattr(jke, name)(data_path, split, gt)


# ------------------------------------------------------------------- metrics

def test_metrics_match_jax():
    import jax.numpy as jnp

    import fsnet_tpu.ops.metrics as J

    rng = np.random.RandomState(0)
    for dtype in (np.float64, np.float32):
        gt = rng.uniform(1.0, 80.0, 5000).astype(dtype)
        pred = (gt * rng.uniform(0.6, 1.6, 5000)).astype(dtype)
        got, ref = tmetrics.compute_errors(gt, pred), J.compute_errors(gt, pred)
        assert len(got) == 7
        for g, r in zip(got, ref):
            assert np.asarray(g).dtype == np.asarray(r).dtype and g == r
        gt_s = gt.copy()
        gt_s[::7] = 0.0
        assert tmetrics.compute_supervised_errors(gt_s, pred) == \
            J.compute_supervised_errors(gt_s, pred)
    mask = (rng.rand(5000) > 0.3).astype(np.float32)
    got = tmetrics.compute_depth_errors_masked(
        torch.from_numpy(gt), torch.from_numpy(pred), torch.from_numpy(mask))
    ref = J.compute_depth_errors_masked(jnp.asarray(gt), jnp.asarray(pred),
                                        jnp.asarray(mask))
    assert got.keys() == ref.keys()
    for k in ref:
        assert abs(float(got[k]) - float(ref[k])) <= 1e-6 * max(
            1.0, abs(float(ref[k]))), k


# ------------------------------------------------------------- ground truth

@pytest.mark.parametrize("kind", ["kitti", "kitti360"])
def test_gt_precompute_matches_jax(trees, tmp_path, kind):
    port, ref = _gt(trees, kind, tmp_path), _gt(trees, kind, tmp_path, "jax")
    assert len(port.gt_depths) == len(ref.gt_depths) == 3
    for g, r in zip(port.gt_depths, ref.gt_depths):
        assert g.shape == (H0, W0) and g.dtype == r.dtype == np.float32
        assert (g > 0).sum() > 1000
        np.testing.assert_array_equal(g, r)
    # each package reads the other's file
    os.replace(tmp_path / f"{kind}_port.npz", tmp_path / "swap.npz")
    os.replace(tmp_path / f"{kind}_jax.npz", tmp_path / f"{kind}_port.npz")
    os.replace(tmp_path / "swap.npz", tmp_path / f"{kind}_jax.npz")
    port2, ref2 = _gt(trees, kind, tmp_path), _gt(trees, kind, tmp_path,
                                                  "jax")
    for a, b, c in zip(port2.gt_depths, ref2.gt_depths, port.gt_depths):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)


def _held(got, ref, n):
    """``_single_loss`` results: ratio and the continuous metrics within
    REL, a1-a3 within 1/n."""
    assert abs(got["ratio"] - ref["ratio"]) <= REL * abs(ref["ratio"])
    for suite in ("error", "abs_error"):
        g, r = np.array(got[suite]), np.array(ref[suite])
        assert np.all(np.abs(g[:4] - r[:4]) <= REL * np.abs(r[:4])), (
            suite, g, r)
        assert np.all(np.abs(g[4:] - r[4:]) <= 1.0 / n), (suite, g, r)


def _valid(gt):
    h, w = gt.shape
    crop = np.array([0.40810811 * h, 0.99189189 * h, 0.03594771 * w,
                     0.96405229 * w]).astype(np.int32)
    inside = np.zeros_like(gt, dtype=bool)
    inside[crop[0]:crop[1], crop[2]:crop[3]] = True
    return int(((gt > 1e-3) & (gt < 80.0) & inside).sum())


def test_single_loss_matches_jax(trees, tmp_path):
    port, ref = _gt(trees, "kitti", tmp_path), _gt(trees, "kitti", tmp_path,
                                                   "jax")
    rng = np.random.RandomState(1)
    for i in range(3):
        gt = np.asarray(port.gt_depths[i], np.float64)
        y = np.linspace(0.5, 1.0, H0)[:, None]
        same = (8.0 / y * rng.uniform(0.8, 1.2, (H0, W0))).astype(np.float32)
        got, want = port.single_call(same, i), ref.single_call(same, i)
        assert got["ratio"] == want["ratio"]
        for suite in ("error", "abs_error"):
            assert list(got[suite]) == list(want[suite])
        small = (8.0 / np.linspace(0.5, 1.0, H)[:, None]
                 * rng.uniform(0.8, 1.2, (H, W))).astype(np.float32)
        # measured: 1.9e-8 relative at most, a1-a3 equal
        _held(port.single_call(small, i), ref.single_call(small, i),
              _valid(gt))


# ----------------------------------------------------------- the whole hook

def _small_model_cfg():
    return tcommon.wpose_meta_arch(edict(rgb_shape=(H, W, 3),
                                         frame_idxs=[0, 1, -1]),
                                   pretrained=False)


def test_evaluation_hook_matches_jax(trees, tmp_path):
    """Measured when this test was written: the continuous metrics within
    1.05e-7 relative of JAX's (gate 1e-5), a1-a3 equal (gate 1/8686)."""
    import optax

    from fsnet_tpu.runtime.state import TrainState
    from fsnet_tpu.utils.builder import build as jbuild
    from fsnet_tpu_torch.models.flax_convert import to_flax

    port_gt = _gt(trees, "kitti", tmp_path)
    model = tbuild(**_small_model_cfg(), device="cpu", seed=3)
    with torch.no_grad():          # BN statistics away from the identity
        g = torch.Generator().manual_seed(4)
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=g))
            elif name.endswith("running_var"):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=g))
    variables = to_flax(model, model.state_dict())
    jmodel = jbuild(**_jax_names(_small_model_cfg()))
    state = TrainState.create(apply_fn=jmodel.apply,
                              params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              tx=optax.identity())

    val = edict(
        name="fsnet_tpu_torch.data.datasets.mono_dataset."
             "KittiDepthMonoEigenTestDataset",
        raw_path=trees["raw"], split_file=trees["test"],
        augmentation=tcommon.wpose_augmentation(
            edict(rgb_shape=(H, W, 3)), [0, 1, -1], train=False))
    hook = tcommon.kitti_evaluate_hook(
        "KittiEigenEvaluator", trees["raw"], trees["test"],
        str(tmp_path / "kitti_port.npz"), "")
    hook.update(batch_size=2, num_workers=0)
    got = tbuild(**hook, device="cpu")(model, tbuild(**val))
    jhook = _jax_names(hook)
    with jax.default_matmul_precision("highest"):
        ref = jbuild(**jhook)(state, jbuild(**_jax_names(val)))
    n = min(_valid(np.asarray(d)) for d in port_gt.gt_depths)
    for g, r in zip(got, ref):
        assert g.shape == (7,) and np.isfinite(g).all()
        assert np.all(np.abs(g[:4] - r[:4]) <= REL * np.abs(r[:4])), (g, r)
        assert np.all(np.abs(g[4:] - r[4:]) <= 1.0 / n), (g, r)


# ------------------------------------------------------ the training loop

def _loop_overrides(trees, tmp_path):
    small = edict(rgb_shape=(H, W, 3))
    frames = [0, 1, -1]
    return {
        "path.checkpoint_path": str(tmp_path / "ckpt"),
        "path.kitti_path": trees["raw"],
        "train_dataset.cfg_list": [dict(
            name="fsnet_tpu_torch.data.datasets.mono_dataset."
                 "KittiDepthMonoDataset",
            raw_path=trees["raw"], split_file=trees["train"])],
        "train_dataset.augmentation": tcommon.wpose_augmentation(
            small, frames, train=True),
        "val_dataset.raw_path": trees["raw"],
        "val_dataset.split_file": str(tmp_path / "val.txt"),
        "val_dataset.augmentation": tcommon.wpose_augmentation(
            small, frames, train=False),
        "meta_arch": _small_model_cfg(),
        "data.batch_size": 2, "data.num_workers": 0,
        "trainer.max_epochs": 1, "trainer.test_iter": 1,
        "trainer.disp_iter": 1,
        "trainer.evaluate_hook.num_workers": 0,
        "trainer.evaluate_hook.dataset_eval_cfg.data_path": trees["raw"],
        "trainer.evaluate_hook.dataset_eval_cfg.split_file":
            str(tmp_path / "val.txt"),
        "trainer.evaluate_hook.dataset_eval_cfg.gt_saved_file":
            str(tmp_path / "gt.npz"),
    }


@pytest.fixture
def no_writer(monkeypatch):
    from fsnet_tpu_torch.scripts import train as train_script

    monkeypatch.setattr(train_script, "_writer", lambda *a, **k: None)


def test_train_main_evaluates_as_test_main(trees, tmp_path, no_writer):
    from fsnet_tpu_torch.scripts import test as test_script
    from fsnet_tpu_torch.scripts import train as train_script

    dt.write_split(tmp_path / "val.txt", [f"{DRIVE} 1 l", f"{DRIVE} 4 l"])
    over = _loop_overrides(trees, tmp_path)
    out = train_script.main(config=KITTI_CONFIG, device="cpu", **over)
    assert out["global_step"] == 2 and len(out["evals"]) == 1
    ev = out["evals"][0]
    assert ev["epoch"] == 0 and ev["global_step"] == 2
    for suite in ("errors", "abs_errors"):
        assert ev[suite].shape == (7,) and np.isfinite(ev[suite]).all()
    assert os.path.isfile(tmp_path / "gt.npz")
    # in-process, and with a spawned loader worker (the configs' default
    # is 4: their batches come as tensors)
    for workers in (0, 1):
        res = test_script.main(
            config=KITTI_CONFIG, checkpoint=out["checkpoint"], device="cpu",
            **dict(over, **{"trainer.evaluate_hook.num_workers": workers}))
        assert res["samples"] == 2 and res["epoch"] == 1
        np.testing.assert_array_equal(res["errors"], ev["errors"])
        np.testing.assert_array_equal(res["abs_errors"], ev["abs_errors"])


HOOK = "fsnet_tpu_torch.pipeline_hooks.evaluation_hooks"


@pytest.mark.parametrize("script,key,value,match", [
    ("train", "trainer.precompute_hook",
     {"name": "fsnet_tpu_torch.pipeline_hooks.precompute_hooks."
              "FarnebackMaskPrecompute"}, "precompute_hook"),
    ("test", "trainer.precompute_hook", {"name": "x.ArflowPrecompute"},
     "precompute_hook"),
    ("train", "trainer.evaluate_hook.name",
     f"{HOOK}.KittiEvaluationHook_postopt", "KittiEvaluationHook_postopt"),
    ("test", "trainer.evaluate_hook.dataset_eval_cfg.name",
     "fsnet_tpu.evaluation.kitti360_fisheye_eval."
     "Kitti360FisheyeEvaluator", "Kitti360FisheyeEvaluator"),
])
def test_unported_hooks_raise(tmp_path, no_writer, script, key, value,
                              match):
    """Raised at config load: the dataset paths do not exist, so anything
    built first would fail otherwise. (The fisheye evaluator is ported
    since; its JAX package's name is refused.)"""
    from fsnet_tpu_torch.scripts import test as test_script
    from fsnet_tpu_torch.scripts import train as train_script

    main = {"train": train_script.main, "test": test_script.main}[script]
    with pytest.raises(NotImplementedError, match=match):
        main(config=KITTI_CONFIG, device="cpu",
             **{key: value, "path.checkpoint_path": str(tmp_path)})


# ---------------------------------------------------------- config copies

def _plain(node):
    if isinstance(node, dict):
        return {k: _plain(v) for k, v in node.items()}
    if isinstance(node, (list, tuple, np.ndarray)):
        return [_plain(v) for v in list(node)]
    if isinstance(node, str):
        return node.replace("fsnet_tpu_torch.", "fsnet_tpu.")
    return node


# the evaluation hook of each copy (KittiEvaluationHook where not named)
COPY_HOOKS = {"nusc_wpose_example.py": "FastNuscEvaluationHook",
              "distill_nusc_example.py": "FastNuscEvaluationHook"}


@pytest.mark.parametrize("name", ["kitti_wpose_example.py",
                                  "kitti360_wpose_example.py",
                                  "nusc_wpose_example.py",
                                  "distill_nusc_example.py",
                                  "multi_dataset_example.py",
                                  "distill_kitti_example.py",
                                  "distill_kitti360_example.py"])
def test_config_copy_matches_shipped(name):
    from fsnet_tpu.utils import cfg_from_file as jax_cfg

    got = _plain(cfg_from_file(os.path.join(CONFIGS, name)))
    ref = _plain(jax_cfg(os.path.join(REPO, "configs", name)))
    assert sorted(got) == sorted(ref)
    for key in ref:
        assert got[key] == ref[key], key
    assert got["trainer"]["evaluate_hook"]["name"].endswith(
        COPY_HOOKS.get(name, "KittiEvaluationHook"))
