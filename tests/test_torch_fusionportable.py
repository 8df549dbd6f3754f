"""The port's FusionPortable dataset and evaluator and the supervised
9-metric evaluation against the JAX package, on the CPU, on trees written
by ``tests/disk_trees.py`` (48x64 frames, 3,000-point scans):

* the readers: OpenCV yaml (camera and Ouster calibration), TUM odometry,
  the split file and PCD scans in ASCII and binary, bitwise equal to
  JAX's; the ``opencv-matrix`` constructor registered on the port's own
  loader class, not on PyYAML's global loaders;
* ``FusionportableMonoDataset[i]`` bitwise equal to JAX's under an identity
  augmentation with ``use_right_image=True``, the dataset's own
  ``RandomState(seed)`` against JAX's ``np.random.seed(seed)``, both
  cameras drawn; under the flagship's val augmentation (the port's
  bilinear resize for ``cv2.resize``) the images within 1e-3 on the 0-255
  scale, the rest bitwise;
* ``FusionPortableEvaluator``'s ground truth bitwise equal to JAX's, each
  package reading the other's ``.npz``;
* the digests that ``chip_smoke.py`` phase 48 holds the card machine to:
  the port's and the JAX package's ``dataset[i]`` and ground truth on the
  phase's own tree (768x1024) give the recorded ones;
* ``evaluate_depth`` and ``evaluate_depth_unsupervised_aligned``: the
  output lines equal to JAX's, and the command lines print the same.
"""
import os
import runpy
import sys

import numpy as np
import pytest

import fsnet_tpu.utils.config  # noqa: F401 - installs the easydict shim
from easydict import EasyDict as jedict

import disk_trees as dt
from fsnet_tpu_torch.configs import common as tcommon
from fsnet_tpu_torch.utils import build as tbuild
from fsnet_tpu_torch.utils.easydict import EasyDict as edict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H0, W0 = 48, 64
TOL = 1e-3          # on the 0-255 scale
DATASET = "fusionportable_dataset.FusionportableMonoDataset"


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """8 frames a camera, frame 4 at frame 3's pose (the static filter
    drops the samples centred on 3 and 4); a train split of 1-6 and a val
    split of 3 frames."""
    root = tmp_path_factory.mktemp("fusionportable")
    out = dt.write_fusionportable(str(root), H0, W0, 8, static=(4,),
                                  scan_points=3000)
    out["train"] = dt.write_split(root / "train.txt", map(str, range(1, 7)))
    out["val"] = dt.write_split(root / "val.txt", ["1", "2", "5"])
    return out


def _jax_cfg(cfg):
    if isinstance(cfg, dict):
        return jedict({k: _jax_cfg(v) for k, v in cfg.items()})
    if isinstance(cfg, list):
        return [_jax_cfg(v) for v in cfg]
    if isinstance(cfg, str):
        return cfg.replace("fsnet_tpu_torch.", "fsnet_tpu.")
    return cfg


def _pair(tree, augmentation, **kw):
    from fsnet_tpu.utils.builder import build as jbuild

    cfg = edict(name=f"fsnet_tpu_torch.data.datasets.{DATASET}",
                base_path=tree["root"], odom_file=tree["odom"],
                frame_idxs=[0, 1, -1], augmentation=augmentation, **kw)
    return tbuild(**cfg), jbuild(**_jax_cfg(cfg))


def _identity():
    return edict(name="fsnet_tpu_torch.data.augmentations.EmptyAug")


def _same(got, ref, approx=None):
    assert list(got) == list(ref)
    for key in ref:
        g, r = np.asarray(got[key]), np.asarray(ref[key])
        assert g.dtype == r.dtype and g.shape == r.shape, key
        if approx and key in approx:
            assert np.abs(g.astype(np.float64) - r).max() <= approx[key], key
        else:
            np.testing.assert_array_equal(g, r, err_msg=str(key))


def test_readers_match_jax(tree):
    import fsnet_tpu.data.datasets.fusionportable_dataset as J
    from fsnet_tpu_torch.data.datasets import fusionportable_dataset as T

    calib = os.path.join(tree["root"], "calib")
    for cam in ("frame_cam00", "frame_cam01"):
        path = os.path.join(calib, f"{cam}.yaml")
        assert sorted(T.read_opencv_yaml(path)) == \
            sorted(J.read_opencv_yaml(path))
        got, ref = T.read_camera_calib(path), J.read_camera_calib(path)
        assert sorted(got) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(ref[k]), err_msg=k)
        assert got["P"].shape == (3, 4) and got["height"] == H0
    path = os.path.join(calib, "ouster00.yaml")
    got, ref = T.read_ouster_calib(path), J.read_ouster_calib(path)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]))
    path = os.path.join(tree["root"], tree["odom"])
    got, ref = T.read_odom(path), J.read_odom(path)
    for k in ref:
        assert got[k].shape[0] == 8
        np.testing.assert_array_equal(got[k], ref[k])
    assert T.read_split_file(tree["train"]) == \
        J.read_split_file(tree["train"]) == list(range(1, 7))
    for i in (0, 1):            # ASCII, binary
        path = os.path.join(tree["root"], "ouster00", "point", "data",
                            f"{i:06d}.pcd")
        got, ref = T.read_pcd_file(path), J.read_pcd_file(path)
        assert got.shape == (3000, 3) and got.dtype == np.float64
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        T.T_from_quaternion_translation([0.1, 0.2, 0.3, 0.9], [1, 2, 3]),
        J.T_from_quaternion_translation([0.1, 0.2, 0.3, 0.9], [1, 2, 3]))


def test_yaml_constructor_is_local():
    """Running the port's module leaves PyYAML's global loaders as they
    were (the JAX package registers its constructor on them): the module
    is executed again and the loaders' constructor tables compared."""
    import importlib

    import yaml

    from fsnet_tpu_torch.data.datasets import fusionportable_dataset as T

    tag = "tag:yaml.org,2002:opencv-matrix"
    loaders = (yaml.Loader, yaml.FullLoader, yaml.UnsafeLoader,
               yaml.SafeLoader, yaml.BaseLoader)
    before = [dict(L.yaml_constructors) for L in loaders]
    T = importlib.reload(T)
    assert [dict(L.yaml_constructors) for L in loaders] == before
    assert T._OpenCVLoader.yaml_constructors[tag] is T._opencv_matrix
    assert all(L.yaml_constructors.get(tag) is not T._opencv_matrix
               for L in loaders)


def test_dataset_matches_jax(tree):
    got, ref = _pair(tree, _identity(), split_file=tree["train"])
    assert len(got) == len(ref) == 4
    assert got.imdb == ref.imdb == [1, 2, 5, 6]
    cams = set()
    for i, seed in zip(range(4), range(4)):
        got.rng = np.random.RandomState(seed)
        g = got[i]
        np.random.seed(seed)
        _same(g, ref[i])
        assert g[("image", 0)].shape == (H0, W0, 3)
        cams.add(float(g["P2"][0, 3]))
    assert len(cams) == 2
    # under the flagship's val augmentation, camera 00 only
    aug = tcommon.wpose_augmentation(edict(rgb_shape=(32, 48, 3)),
                                     [0, 1, -1], train=False)
    got, ref = _pair(tree, aug, split_file=tree["val"],
                     is_filter_static=False, use_right_image=False)
    stds = np.array([0.229, 0.224, 0.225])
    approx = {("image", 0): TOL / (255 * stds.min())}
    approx.update({("original_image", f): TOL for f in (0, 1, -1)})
    for i in range(3):
        g, r = got[i], ref[i]
        assert g[("image", 0)].shape == (32, 48, 3)
        _same(g, r, approx)


def _evaluators(tree, tmp_path):
    import fsnet_tpu.evaluation.fusionportable_eval as J
    from fsnet_tpu_torch.evaluation import fusionportable_eval as T

    return (T.FusionPortableEvaluator(tree["root"], tree["val"],
                                      str(tmp_path / "port.npz")),
            J.FusionPortableEvaluator(tree["root"], tree["val"],
                                      str(tmp_path / "jax.npz")))


def test_evaluator_gt_matches_jax(tree, tmp_path):
    port, ref = _evaluators(tree, tmp_path)
    assert len(port.gt_depths) == len(ref.gt_depths) == 3
    for g, r in zip(port.gt_depths, ref.gt_depths):
        assert g.shape == (H0, W0) and g.dtype == r.dtype == np.float32
        assert (g > 0).sum() > 200
        np.testing.assert_array_equal(g, r)
    os.replace(tmp_path / "port.npz", tmp_path / "swap.npz")
    os.replace(tmp_path / "jax.npz", tmp_path / "port.npz")
    os.replace(tmp_path / "swap.npz", tmp_path / "jax.npz")
    port2, ref2 = _evaluators(tree, tmp_path)
    for a, b, c in zip(port2.gt_depths, ref2.gt_depths, port.gt_depths):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)
    rng = np.random.RandomState(3)
    pred = rng.uniform(2.0, 60.0, (H0, W0)).astype(np.float32)
    got, want = port.single_call(pred, 0), ref.single_call(pred, 0)
    assert got["ratio"] == want["ratio"]
    assert list(got["error"]) == list(want["error"])


def test_chip_smoke_digests(tmp_path):
    """``chip_smoke.py`` phase 48's tree and digests, here on the CPU: the
    port's ``dataset[i]`` and ground truth and the JAX package's give the
    digests it records."""
    sys.path.insert(0, REPO)
    import chip_smoke
    import fsnet_tpu.evaluation.fusionportable_eval as J
    from fsnet_tpu_torch.evaluation import fusionportable_eval as T

    tree = chip_smoke.write_fusion_tree(dt, tmp_path)
    port, ref = _pair(tree, _identity(), split_file=tree["train"])
    assert len(port) == chip_smoke.FUSION_FRAMES - 4
    gt_port = T.FusionPortableEvaluator(tree["root"], tree["val"],
                                        str(tmp_path / "port.npz"))
    gt_ref = J.FusionPortableEvaluator(tree["root"], tree["val"],
                                       str(tmp_path / "jax.npz"))
    assert chip_smoke.fusion_digests(port, gt_port) == \
        chip_smoke.FUSION_DIGESTS
    assert chip_smoke.fusion_digests(ref, gt_ref) == \
        chip_smoke.FUSION_DIGESTS
    drawn = {np.random.RandomState(s).rand() < 0.5
             for s in chip_smoke.FUSION_SEEDS}
    assert drawn == {True, False}


# ------------------------------------------------------ supervised metrics

@pytest.fixture(scope="module")
def depth_dirs(tmp_path_factory):
    """Two directories of 16-bit depth PNGs (metres x 256; zeros where the
    ground truth is empty) and an ``.npz`` of the ground truth."""
    root = tmp_path_factory.mktemp("supervised")
    rng = np.random.RandomState(7)
    (root / "gt").mkdir()
    (root / "pred").mkdir()
    gts = []
    for i in range(4):
        gt = dt.sparse_depth_png(40, 56, 30 + i)
        pred = (np.clip(gt.astype(np.float64) / 256.0
                        * rng.uniform(0.7, 1.3, gt.shape)
                        + rng.uniform(1.0, 5.0, gt.shape), 0, 255)
                * 256).astype(np.uint16)
        dt.write_png(root / "gt" / f"{i:04d}.png", gt)
        dt.write_png(root / "pred" / f"{i:04d}.png", pred)
        gts.append(gt / 256.0)
    arr = np.empty(4, dtype=object)
    for i, g in enumerate(gts):
        arr[i] = g
    np.savez_compressed(root / "gt.npz", data=arr)
    return root


@pytest.mark.filterwarnings("ignore:.*found in sys.modules")
def test_supervised_eval_matches_jax(depth_dirs, capsys, monkeypatch):
    import fsnet_tpu.evaluation.kitti_supervised_eval as J
    from fsnet_tpu_torch.evaluation import kitti_supervised_eval as T

    gt, pred = str(depth_dirs / "gt"), str(depth_dirs / "pred")
    npz = str(depth_dirs / "gt.npz")
    lines = T.evaluate_depth(gt, pred)
    assert lines == J.evaluate_depth(gt, pred)
    assert len(lines) == 9 and lines[0].startswith("mean mae : ")
    assert T.evaluate_depth_unsupervised_aligned(npz, pred) == \
        J.evaluate_depth_unsupervised_aligned(npz, pred)
    for args in ([gt, pred, "--png_dirs"], [npz, pred]):
        capsys.readouterr()
        T.main(args)
        got = capsys.readouterr().out
        monkeypatch.setattr(sys, "argv", ["kitti_supervised_eval"] + args)
        runpy.run_module("fsnet_tpu.evaluation.kitti_supervised_eval",
                         run_name="__main__")
        assert got == capsys.readouterr().out
        assert got.count("\nmean ") + got.startswith("mean ") == 9
