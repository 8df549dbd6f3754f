"""The port's data pipeline against the JAX package's, on the CPU, at the
smoke config's 64x96 and bs4:

* every augmentation class from the same seed: ``Resize`` (bilinear),
  ``RandomWarpAffine`` (bilinear) and the HSV conversions within 1e-3 on
  the 0-255 scale (the JAX package calls OpenCV there; the port computes
  the same functions in float32 numpy), the nearest-neighbour results and
  every geometry key (P2, poses, mirrored poses) bitwise, the other
  classes bitwise. The classes that draw from numpy's global state
  in the JAX package (``RandomMirror``, ``RandomCropToWidth``,
  ``PhotometricDistort``, ``Shuffle``) own a ``RandomState`` in the port:
  seeded with ``s`` it draws what ``np.random.seed(s)`` gives the JAX
  class;
* ``SyntheticMonoDataset`` samples, ``collate_fn`` and ``ConcatDataset``
  bitwise; ``TrainingSampler`` index streams at rank 0 and 1 of 2;
* ``Dataloader`` with ``num_workers=0`` on the port's copy of the smoke
  config: the same encoded batches as the JAX loader's on the shipped
  smoke config, bitwise;
* the port's worker processes: batches in the sampler's order, every
  worker on its own augmentation stream (``reseed_numpy``), the workers
  stopped by ``close``.
"""
import os

import numpy as np
import pytest
import torch

import fsnet_tpu.data.augmentations as J
import fsnet_tpu_torch.data.augmentations as T
from fsnet_tpu_torch.data import dataloader as tdl
from fsnet_tpu_torch.data.datasets import dataset_utils as tdu
from fsnet_tpu_torch.data.datasets.synthetic_dataset import \
    SyntheticMonoDataset
from fsnet_tpu_torch.utils import build, cfg_from_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "fsnet_tpu_torch", "configs",
                     "synthetic_smoke_example.py")
H, W = 64, 96
TOL = 1e-3          # on the 0-255 scale


def _image(rng, h, w, c=3):
    return (rng.random((h, w, c)) * 255).astype(np.float32)


def _sample(rng, h=H + 37, w=W + 71):
    P = np.array([[0.58 * w, 0, w / 2, 1.5], [0, 0.58 * w, h / 2, -0.3],
                  [0, 0, 1, 0.01]], np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.3, -0.02, 0.05]
    pose[:3, :3] = np.array([[0.999, -0.02, 0.03], [0.02, 0.999, 0.01],
                             [-0.03, -0.01, 0.999]], np.float32)
    return {"a": _image(rng, h, w), "b": _image(rng, h, w),
            "m": (rng.random((h, w)) > 0.3).astype(np.float64), "P": P,
            ("relative_pose", 1): pose}


def _copy(d):
    return {k: (v.copy() if isinstance(v, np.ndarray) else v)
            for k, v in d.items()}


def _compare(got, ref, approx=(), tol=TOL):
    assert list(got) == list(ref)
    for key in ref:
        g, r = np.asarray(got[key]), np.asarray(ref[key])
        assert g.dtype == r.dtype and g.shape == r.shape, key
        if key in approx:
            assert np.abs(g - r).max() <= tol, (key, np.abs(g - r).max())
        else:
            np.testing.assert_array_equal(g, r, err_msg=str(key))


RESIZE = {"down": dict(src=(101, 167), size=(H, W)),
          "up": dict(src=(30, 50), size=(H, W)),
          "same": dict(src=(H, W), size=(H, W)),
          "kitti": dict(src=(375, 1242), size=(192, 640)),
          "aspect_pad": dict(src=(90, 120), size=(H, W),
                             preserve_aspect_ratio=True),
          "aspect_crop": dict(src=(90, 220), size=(H, W),
                              preserve_aspect_ratio=True, force_pad=False)}


@pytest.mark.parametrize("case", sorted(RESIZE))
def test_resize_matches_jax(case):
    cfg = dict(RESIZE[case])
    src = cfg.pop("src")
    cfg.setdefault("preserve_aspect_ratio", False)
    kw = dict(image_keys=["a", "b"], gt_image_keys=["m"], calib_keys=["P"],
              **cfg)
    data = _sample(np.random.default_rng(3), *src)
    ref = J.Resize(**kw)(_copy(data))
    got = T.Resize(**kw)(_copy(data))
    _compare(got, ref, approx=("a", "b"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_warp_affine_matches_jax(seed):
    kw = dict(output_w=W, output_h=H, shift_border=40, random_seed=seed,
              image_keys=["a", "b"], gt_image_keys=["m"], calib_keys=["P"])
    data = _sample(np.random.default_rng(seed), 150, 230)
    ref = J.RandomWarpAffine(**kw)(_copy(data))
    got = T.RandomWarpAffine(**kw)(_copy(data))
    _compare(got, ref, approx=("a", "b"))


@pytest.mark.parametrize("current,transform",
                         [("RGB", "HSV"), ("HSV", "RGB"), ("BGR", "HSV"),
                          ("HSV", "BGR")])
def test_convert_color_matches_jax(current, transform):
    rng = np.random.default_rng(5)
    img = (rng.random((H, W, 3)) * 300 - 20).astype(np.float32)
    img[0, :8] = 100.0                       # grey: s = 0
    img[1, :8, 1] = img[1, :8, 0]            # ties of the maximum
    if current == "HSV":                     # a saturation-jittered HSV image
        img = J.ConvertColor(transform="HSV", image_keys=["a"])(
            {"a": img})["a"]
        img[..., 1] *= 1.3
    kw = dict(current=current, transform=transform, image_keys=["a"])
    ref = J.ConvertColor(**kw)({"a": img.copy()})
    got = T.ConvertColor(**kw)({"a": img.copy()})
    _compare(got, ref, approx=("a",))


SEEDED = {"RandomSaturation": dict(distort_prob=1.0, lower=0.6, upper=1.4),
          "RandomHue": dict(distort_prob=1.0, delta=30.0),
          "RandomContrast": dict(distort_prob=0.7, lower=0.6, upper=1.4),
          "RandomBrightness": dict(distort_prob=0.7),
          "RandomEigenvalueNoise": dict(distort_prob=0.8)}


@pytest.mark.parametrize("name", sorted(SEEDED))
def test_seeded_photometric_matches_jax(name):
    rng = np.random.default_rng(7)
    imgs = [_image(rng, H, W) for _ in range(4)]
    if name in ("RandomSaturation", "RandomHue"):      # HSV inputs
        imgs = [T.rgb_to_hsv(i) for i in imgs]
    kw = dict(SEEDED[name], image_keys=["a"], random_seed=11)
    ref_t, got_t = getattr(J, name)(**kw), getattr(T, name)(**kw)
    for img in imgs:             # one object, several draws in turn
        ref = ref_t({"a": img.copy()})
        got = got_t({"a": img.copy()})
        _compare(got, ref)


def test_global_state_classes_match_jax():
    """RandomMirror, RandomCropToWidth, PhotometricDistort and Shuffle: the
    port's own RandomState(s) against the JAX class after
    np.random.seed(s); several calls each."""
    rng = np.random.default_rng(9)
    pairs = [(("relative_pose", 1), 0)]
    cases = [
        ("RandomMirror", dict(mirror_prob=0.5, image_keys=["a", "b"],
                              gt_image_keys=["m"], calib_keys=["P"],
                              pose_axis_pairs=pairs), ()),
        ("RandomCropToWidth", dict(width=W, image_keys=["a", "b"],
                                   gt_image_keys=["m"], calib_keys=["P"]),
         ()),
        ("PhotometricDistort", dict(image_keys=["a", "b"]), ("a", "b")),
    ]
    for name, kw, approx in cases:
        np.random.seed(21)
        ref_t = getattr(J, name)(**kw)      # PhotometricDistort's children
        np.random.seed(21)                  # seed from the same state
        got_t = getattr(T, name)(random_seed=1234, **kw)
        np.random.seed(1234)
        for _ in range(6):
            data = _sample(rng)
            ref = ref_t(_copy(data))
            got = got_t(_copy(data))
            _compare(got, ref, approx=approx)
    # Shuffle: the order of its children
    from fsnet_tpu.utils.builder import Shuffle as JShuffle
    from fsnet_tpu_torch.utils.builder import Shuffle as TShuffle

    def cfg(pkg):
        return [dict(name=f"{pkg}.data.augmentations.Copy", from_keys=["a"],
                     to_keys=["b"]),
                dict(name=f"{pkg}.data.augmentations.RandomBrightness",
                     distort_prob=1.0, random_seed=3, image_keys=["a"]),
                dict(name=f"{pkg}.data.augmentations.RandomContrast",
                     distort_prob=1.0, random_seed=4, image_keys=["a"])]
    ref_t = JShuffle(cfg("fsnet_tpu"))
    got_t = TShuffle(cfg("fsnet_tpu_torch"), random_seed=77)
    np.random.seed(77)
    for _ in range(6):
        img = _image(rng, H, W)
        _compare(got_t({"a": img.copy()}), ref_t({"a": img.copy()}))


@pytest.mark.parametrize("composition", ["Sequential", "Parallel"])
def test_builder_compositions_match_jax(composition):
    """``Sequential`` chains its children, ``Parallel`` hands each the same
    input; both merge ``common_keywords`` under each child's cfg."""
    from fsnet_tpu.utils import builder as jb
    from fsnet_tpu_torch.utils import builder as tb

    def cfg(pkg):
        aug = f"{pkg}.data.augmentations"
        return [dict(name=f"{aug}.Copy", from_keys=["a"], to_keys=["b"]),
                dict(name=f"{aug}.CropRight", crop_right_index=5),
                dict(name=f"{aug}.Normalize", mean=[0.4, 0.5, 0.6],
                     stds=[0.2, 0.3, 0.4])]
    common = dict(image_keys=["a"])
    ref_t = getattr(jb, composition)(cfg("fsnet_tpu"), **common)
    got_t = getattr(tb, composition)(cfg("fsnet_tpu_torch"), **common)
    img = _image(np.random.default_rng(17), H, W)
    ref, got = ref_t({"a": img.copy()}), got_t({"a": img.copy()})
    if composition == "Parallel":
        assert isinstance(got, list) and len(got) == len(ref) == 3
        for g, r in zip(got, ref):
            _compare(g, r)
    else:
        _compare(got, ref)


def test_fixed_classes_match_jax():
    rng = np.random.default_rng(13)
    keys = dict(image_keys=["a", "b"], gt_image_keys=["m"])
    cases = [
        ("ConvertToFloat", dict(image_keys=["a", "b"])),
        ("ConvertToTensor", dict(keys, calib_keys=["P"])),
        ("Normalize", dict(mean=[0.485, 0.456, 0.406],
                           stds=[0.229, 0.224, 0.225], image_keys=["a"])),
        ("CropTop", dict(keys, crop_top_index=11, calib_keys=["P"])),
        ("CropTop", dict(keys, output_height=50, calib_keys=["P"])),
        ("CropRight", dict(keys, crop_right_index=7)),
        ("CropRight", dict(keys, output_width=60)),
        ("Pad2Shape", dict(keys, target_shape=(128, 200))),
        ("ExtractData", dict(extract_keys=["a", "P"],
                             mapped_keys={"m": "mask"})),
        ("Copy", dict(from_keys=["a"], to_keys=["c"])),
        ("EmptyAug", {}),
    ]
    for name, kw in cases:
        data = _sample(rng)
        data["a"] = data["a"].astype(np.float64)
        _compare(getattr(T, name)(**kw)(_copy(data)),
                 getattr(J, name)(**kw)(_copy(data)))


def test_pose_utils_match_jax():
    from fsnet_tpu.data import pose_utils as jp
    from fsnet_tpu_torch.data import pose_utils as tp

    pose = _sample(np.random.default_rng(1))[("relative_pose", 1)]
    other = np.linalg.inv(pose) @ pose.T
    for axis in (0, 1, 2):
        np.testing.assert_array_equal(tp.flip_relative_pose(pose, axis),
                                      jp.flip_relative_pose(pose, axis))
    np.testing.assert_array_equal(tp.cam_relative_pose(pose, other),
                                  jp.cam_relative_pose(pose, other))
    np.testing.assert_array_equal(
        tp.cam_relative_pose_nusc(pose, other, pose),
        jp.cam_relative_pose_nusc(pose, other, pose))
    q = np.array([0.9, 0.1, -0.2, 0.3])
    np.testing.assert_array_equal(tp.pose_from_quat_trans(q, [1, 2, 3]),
                                  jp.pose_from_quat_trans(q, [1, 2, 3]))


def test_synthetic_dataset_collate_concat_match_jax():
    from fsnet_tpu.data.datasets import dataset_utils as jdu
    from fsnet_tpu.data.datasets.synthetic_dataset import \
        SyntheticMonoDataset as JSynth

    kw = dict(length=5, height=H, width=W, seed=3, with_sparse_depth=True)
    ref_ds, got_ds = JSynth(**kw), SyntheticMonoDataset(**kw)
    samples = [got_ds[i] for i in range(4)]
    for i, got in enumerate(samples):
        _compare(got, ref_ds[i])
    _compare(tdu.collate_fn(samples), jdu.collate_fn(
        [ref_ds[i] for i in range(4)]))
    # scalars, lists and keys some samples lack
    mixed = [dict(a=np.ones(2) * i, s=i, f=0.5 * i, name=f"x{i}", **(
        {"only0": 1} if i == 0 else {})) for i in range(3)]
    got, ref = tdu.collate_fn(mixed), jdu.collate_fn(mixed)
    assert list(got) == list(ref) == ["a", "s", "f", "name"]
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]))

    def concat(pkg):
        name = f"{pkg}.data.datasets.synthetic_dataset.SyntheticMonoDataset"
        return dict(cfg_list=[dict(name=name, length=3, seed=1),
                              dict(name=name, length=4, seed=2)],
                    height=H // 2, width=W // 2, frame_idxs=[0, 1, -1])
    ref_c = jdu.ConcatDataset(**concat("fsnet_tpu"))
    got_c = tdu.ConcatDataset(**concat("fsnet_tpu_torch"))
    assert len(got_c) == len(ref_c) == 7
    for i in range(7):
        _compare(got_c[i], ref_c[i])


@pytest.mark.parametrize("rank", [0, 1])
def test_training_sampler_matches_jax(rank):
    import itertools

    from fsnet_tpu.data import dataloader as jdl

    for shuffle, seed in ((True, None), (True, 5), (False, None)):
        kw = dict(size=13, shuffle=shuffle, seed=seed, rank=rank,
                  world_size=2)
        got = list(itertools.islice(iter(tdl.TrainingSampler(**kw)), 40))
        ref = list(itertools.islice(iter(jdl.TrainingSampler(**kw)), 40))
        assert got == ref
    assert list(tdl.InferenceSampler(5)) == list(jdl.InferenceSampler(5))


def _same_batch(got, ref):
    assert list(got) == list(ref)
    for k in ref:
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        assert g.dtype == r.dtype, k
        np.testing.assert_array_equal(g, r, err_msg=k)


def test_dataloader_matches_jax():
    """The port's smoke config and the shipped one through their loaders,
    num_workers=0: the same encoded batches. The mirror draws from the
    port's RandomMirror(random_seed=s) and from the JAX loader's global
    state after np.random.seed(s)."""
    from fsnet_tpu.data.dataloader import build_dataloader as jbuild
    from fsnet_tpu.utils import build as jax_build
    from fsnet_tpu.utils import cfg_from_file as jax_cfg

    ref_cfg = jax_cfg(os.path.join(REPO, "configs",
                                   "synthetic_smoke_example.py"))
    got_cfg = cfg_from_file(SMOKE)
    mirror = [c for c in got_cfg.train_dataset.augmentation.cfg_list
              if c.name.endswith("RandomMirror")][0]
    mirror.random_seed = 99
    ref_loader = jbuild(jax_build(**ref_cfg.train_dataset), num_workers=0,
                        batch_size=ref_cfg.data.batch_size)
    got_loader = tdl.build_dataloader(build(**got_cfg.train_dataset),
                                      num_workers=0,
                                      batch_size=got_cfg.data.batch_size)
    assert len(got_loader) == len(ref_loader) == 3
    np.random.seed(99)
    ref_it = iter(ref_loader)
    for _ in range(2):       # two epochs; each iterator is one epoch
        got = list(iter(got_loader))
        assert len(got) == 3
        ref = [next(ref_it) for _ in range(3)]
        if _ == 0:
            ref_it = iter(ref_loader)     # the JAX loop's next epoch
        for g, r in zip(got, ref):
            _same_batch(g, r)


def test_dataloader_workers_order_and_streams():
    """Two worker processes against the in-line loader: the same samples
    in the same order (``original_image/0``, left alone by the
    augmentation, names the sample), and a brightness offset per sample
    (``image/0`` less it) that no two samples share, on neither the
    in-line loader's stream nor the parent's."""
    def loader(workers):
        aug = dict(name="fsnet_tpu_torch.utils.builder.Sequential",
                   cfg_list=[
                       dict(name="fsnet_tpu_torch.data.augmentations."
                                 "ConvertToFloat"),
                       dict(name="fsnet_tpu_torch.data.augmentations."
                                 "RandomBrightness", distort_prob=1.0)],
                   image_keys=[("image", 0)])
        np.random.seed(0)
        ds = SyntheticMonoDataset(length=12, height=8, width=16,
                                  frame_idxs=[0], augmentation=aug)
        return tdl.Dataloader(ds, batch_size=3,
                              sampler=tdl.TrainingSampler(12, seed=4),
                              num_workers=workers)

    par, ref = loader(2), loader(0)
    try:
        got = list(iter(par)) + list(iter(par))    # 2 epochs, same workers
        workers = list(par._workers._iterator._workers)
    finally:
        par.close()
    want = list(iter(ref)) + list(iter(ref))
    assert len(got) == len(want) == 8

    def offsets(b):
        return (np.asarray(b["image/0"]) - np.asarray(
            b["original_image/0"], np.float32))[:, 0, 0, 0]

    for g, w in zip(got, want):
        assert isinstance(g["image/0"], torch.Tensor)
        np.testing.assert_array_equal(g["original_image/0"].numpy(),
                                      w["original_image/0"])
    draws = np.concatenate([offsets(g) for g in got])
    assert len(np.unique(draws)) == len(draws)
    inline = np.concatenate([offsets(w) for w in want])
    assert not np.isin(draws, inline).any()
    for p in workers:
        p.join(timeout=10)
        assert not p.is_alive()


def test_reseed_numpy_reaches_every_generator():
    from fsnet_tpu_torch.utils.builder import Sequential

    aug = Sequential([
        dict(name="fsnet_tpu_torch.data.augmentations.RandomBrightness",
             distort_prob=1.0),
        dict(name="fsnet_tpu_torch.utils.builder.Shuffle", cfg_list=[
            dict(name="fsnet_tpu_torch.data.augmentations.RandomMirror",
                 mirror_prob=0.5)])], image_keys=["a"])
    holders = [aug.children[0], aug.children[1],
               aug.children[1].children[0]]
    before = [h.rng for h in holders]
    assert tdl.reseed_numpy({"t": [aug]}, 5) == 3
    after = [h.rng for h in holders]
    assert all(a is not b and type(a) is type(b)
               for a, b in zip(after, before))
    tdl.reseed_numpy({"t": [aug]}, 6)
    assert holders[0].rng.random() != after[0].random()


def test_device_prefetch_cpu():
    batches = [{"a": np.full((2, 3), i, np.float32), "n": ["x"]}
               for i in range(5)]
    out = list(tdl.device_prefetch(iter(batches), "cpu"))
    assert len(out) == 5
    for i, b in enumerate(out):
        assert isinstance(b["a"], torch.Tensor) and b["n"] == ["x"]
        assert float(b["a"][0, 0]) == i
