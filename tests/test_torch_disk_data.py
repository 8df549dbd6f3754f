"""The port's PNG reader, file readers and on-disk datasets against OpenCV,
PIL and the JAX package, on the CPU, on trees written by
``tests/disk_trees.py`` (272x320 frames, so that ``RandomWarpAffine`` has
room):

* the reader: ``imread_unchanged`` bitwise equal to ``cv2.imread(path,
  -1)`` and ``read_image`` to ``np.array(PIL.Image.open(path))`` on files
  ``cv2`` writes (8-bit RGB and grey, 16-bit grey and RGB, at compression
  levels 1 and 9) and on the repo's ``fisheye_mask.png``; the C unfilter
  bitwise equal to the plain version on rows written with each of the five
  filters, at 1, 2, 3, 6 and 8 bytes a pixel; the BGR order of
  ``imread_unchanged`` and ``get_flow``'s channels (the file's third and
  second); a raise, naming the file, on palette, grey+alpha, 1-bit and
  interlaced files;
* the helpers: the calibration parsers, ``read_pose_mat``,
  ``read_split_file``, the relative-pose algebra and ``lidar_projection``'s
  two maps, bitwise equal to the JAX package's on the written trees;
* ``dataset[i]`` of ``KittiDepthMonoDataset`` (static filter, sparse
  depth, motion mask and flow), ``KittiDepthMonoEigenTestDataset`` (sparse
  depth) and ``KITTI360MonoDataset`` (both cameras): every key bitwise
  equal to the JAX package's under an identity augmentation; under the
  flagship's train augmentation from the same seeds, the bilinear images
  within 1e-3 on the 0-255 scale and the rest bitwise (the gates of
  ``tests/test_torch_data.py``).
"""
import os

import cv2
import numpy as np
import pytest
import zlib
from PIL import Image

import fsnet_tpu.utils.config  # noqa: F401 - installs the easydict shim
from easydict import EasyDict as jedict

import disk_trees as dt
from fsnet_tpu_torch.configs import common as tcommon
from fsnet_tpu_torch.data.datasets import image_io as tio
from fsnet_tpu_torch.utils import build as tbuild
from fsnet_tpu_torch.utils.easydict import EasyDict as edict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H0, W0 = 272, 320
DATE = "2011_09_26"
DRIVE = f"{DATE}/{DATE}_drive_0001_sync"
TOL = 1e-3          # on the 0-255 scale
IDENTITY = "data.augmentations.EmptyAug"


@pytest.fixture(scope="module")
def kitti(tmp_path_factory):
    """A KITTI raw tree: 7 frames of one drive (frame 4 repeats frame 3's
    pose), velodyne scans and Eigen depth maps, a sparse-depth tree, motion
    masks and flow files, train and test splits."""
    root = tmp_path_factory.mktemp("kitti_raw")
    raw = root / "raw"
    dt.write_kitti_date(str(raw / DATE), H0, W0)
    dt.write_kitti_drive(str(raw), DRIVE, 7, H0, W0, seed=3, static=(4,),
                         velodyne=True, depth=True)
    for cam in ("image_02", "image_03"):
        d = root / "depth" / DRIVE.split("/")[1] / "proj_depth" / \
            "groundtruth" / cam
        d.mkdir(parents=True)
        for i in range(7):
            dt.write_png(d / ("%010d.png" % i),
                         dt.sparse_depth_png(H0, W0, 50 + i))
    rng = np.random.RandomState(4)
    (root / "mask").mkdir()
    (root / "flow").mkdir()
    for i in range(3):
        dt.write_png(root / "mask" / f"{i:08d}.png",
                     (rng.rand(H0, W0) > 0.5).astype(np.uint8))
        dt.write_png(root / "flow" / f"{i:08d}.png",
                     rng.randint(0, 65536, (H0, W0, 3)).astype(np.uint16))
    train = dt.write_split(root / "train.txt", [
        f"{DRIVE} 1 l", f"{DRIVE} 2 r", f"{DRIVE} 3 l", f"{DRIVE} 4 r",
        f"{DRIVE} 5 l"])
    test = dt.write_split(root / "test.txt", [
        f"{DRIVE} 1 l", f"{DRIVE} 2 r", f"{DRIVE} 5 l"])
    return dict(root=root, raw=str(raw), train=train, test=test)


@pytest.fixture(scope="module")
def kitti360(tmp_path_factory):
    """A KITTI-360 tree: key poses at 1 m steps with a static pair (3, 4)
    and a 6 m jump (4 -> 5), velodyne scans, a meta file of one kept, one
    static and one jumping sample."""
    root = tmp_path_factory.mktemp("kitti360")
    dt.write_kitti360(str(root), H0, W0, [0.0, 1.0, 2.0, 3.0, 3.0, 9.0, 10.0],
                      velodyne=True)
    seq = dt.KITTI360_SEQ
    meta = dt.write_split(root / "meta.txt", [
        f"{seq},1,1,0,2", f"{seq},3,3,2,4", f"{seq},5,5,4,6"])
    return dict(root=str(root), meta=meta)


# ---------------------------------------------------------------- the reader

def _cv2_image(kind, rng):
    return {"rgb8": lambda: rng.randint(0, 256, (45, 61, 3), np.uint8),
            "grey8": lambda: rng.randint(0, 256, (45, 61), np.uint8),
            "grey16": lambda: rng.randint(0, 65536, (45, 61), np.uint16),
            "rgb16": lambda: rng.randint(0, 65536, (45, 61, 3), np.uint16),
            }[kind]()


@pytest.mark.parametrize("level", [1, 9])
@pytest.mark.parametrize("kind", ["rgb8", "grey8", "grey16", "rgb16"])
def test_reader_matches_cv2_and_pil(tmp_path, kind, level):
    rng = np.random.RandomState(len(kind) * 10 + level)
    img = _cv2_image(kind, rng)
    # a smooth half, so that cv2's writer picks more than one filter
    img[: img.shape[0] // 2] = img[: img.shape[0] // 2].mean(
        axis=1, keepdims=True).astype(img.dtype)
    path = str(tmp_path / f"{kind}.png")
    assert cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, level])
    ref_cv = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    ref_pil = np.array(Image.open(path))
    got_cv, got_pil = tio.imread_unchanged(path), tio.read_image(path)
    assert got_cv.dtype == ref_cv.dtype and got_pil.dtype == ref_pil.dtype
    np.testing.assert_array_equal(got_cv, ref_cv)
    np.testing.assert_array_equal(got_pil, ref_pil)
    np.testing.assert_array_equal(tio.read_png(path, plain=True),
                                  tio.read_png(path))
    assert tio.png_size(path) == img.shape[:2]


def test_reader_matches_fisheye_mask():
    path = os.path.join(REPO, "meta_data", "kitti360_trainsub",
                        "fisheye_mask.png")
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert ref.shape == (700, 700) and ref.dtype == np.uint8
    np.testing.assert_array_equal(tio.imread_unchanged(path), ref)
    np.testing.assert_array_equal(tio.read_image(path),
                                  np.array(Image.open(path)))
    assert tio.png_size(path) == (700, 700)


def _stream(path):
    data = open(path, "rb").read()
    idat, pos = [], 8
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        if data[pos + 4:pos + 8] == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    return zlib.decompress(b"".join(idat))


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_unfilter_matches_plain(tmp_path, kind):
    """Every row written with filter ``kind``; grey, grey 16, RGB, RGB 16
    and RGBA 16 (1, 2, 3, 6 and 8 bytes a pixel)."""
    rng = np.random.RandomState(kind)
    for C, dtype in ((1, np.uint8), (1, np.uint16), (3, np.uint8),
                     (3, np.uint16), (4, np.uint16)):
        hi = np.iinfo(dtype).max + 1
        img = rng.randint(0, hi, (23, 37, C)).astype(dtype)
        img[5:9] = img[5:9, :1]                  # flat rows: ties in Paeth
        path = str(tmp_path / f"f{kind}_{C}_{img.itemsize}.png")
        dt.write_png(path, img, filters=[kind] * 23)
        stream = _stream(path)
        assert all(stream[r * (37 * C * img.itemsize + 1)] == kind
                   for r in range(23))
        bpp = C * img.itemsize
        got = tio.unfilter(stream, 23, 37 * bpp, bpp)
        ref = tio.unfilter_plain(stream, 23, 37 * bpp, bpp)
        np.testing.assert_array_equal(got, ref)
        want = (img.astype(">u2") if img.itemsize == 2 else img).view(
            np.uint8).reshape(23, -1)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tio.read_png(path), img[..., 0]
                                      if C == 1 else img)


def test_bgr_order_and_flow_channels(tmp_path):
    """A file with channels (R, G, B) = (1000, 2000, 3000): the port's
    ``imread_unchanged`` puts B first as cv2 does, and ``get_flow``'s
    ``[:, :, 0:2]`` reads the file's third and second channels."""
    from fsnet_tpu_torch.data.datasets.mono_dataset import \
        KittiDepthMonoDataset

    img = np.empty((4, 5, 3), np.uint16)
    img[..., 0], img[..., 1], img[..., 2] = 1000, 2000, 3000
    dt.write_png(tmp_path / "00000000.png", img)
    got = tio.imread_unchanged(str(tmp_path / "00000000.png"))
    np.testing.assert_array_equal(
        got, cv2.imread(str(tmp_path / "00000000.png"), -1))
    assert got[0, 0].tolist() == [3000, 2000, 1000]
    ds = KittiDepthMonoDataset.__new__(KittiDepthMonoDataset)
    ds.flow_path = str(tmp_path)
    flow = ds.get_flow(0)
    assert flow.shape == (4, 5, 2)
    np.testing.assert_array_equal(flow[0, 0], (np.array(
        [3000, 2000], np.float32) - 2 ** 15) / 64.0)


def test_reader_raises(tmp_path):
    rng = np.random.RandomState(0)
    rgb = rng.randint(0, 256, (8, 9, 3), np.uint8)
    files = {"palette": lambda p: Image.fromarray(rgb).convert("P").save(p),
             "grey with alpha": lambda p: Image.fromarray(
                 rgb[..., :2].copy(), "LA").save(p),
             "bit depth 1": lambda p: Image.fromarray(
                 rgb[..., 0] > 128).save(p),
             "Adam7": lambda p: dt.write_png(p, rgb, interlace=1)}
    for reason, write in files.items():
        path = str(tmp_path / f"{reason.replace(' ', '_')}.png")
        write(path)
        with pytest.raises(tio.PNGError) as err:
            tio.read_png(path)
        assert path in str(err.value) and reason in str(err.value), err.value
    bad = bytearray(open(path, "rb").read())
    bad[20] ^= 1                                  # inside IHDR
    open(path, "wb").write(bytes(bad))
    with pytest.raises(tio.PNGError, match="CRC"):
        tio.read_png(path)


# --------------------------------------------------------------- the helpers

def test_helpers_match_jax(kitti, kitti360):
    import fsnet_tpu.data.datasets.io_utils as J
    import fsnet_tpu.data.datasets.kitti360_dataset as J360
    import fsnet_tpu_torch.data.datasets.io_utils as T
    import fsnet_tpu_torch.data.datasets.kitti360_dataset as T360

    def same(a, b):
        if isinstance(a, (tuple, list)):
            assert type(a) is type(b) and len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        elif isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                same(a[k], b[k])
        else:
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)

    date = os.path.join(kitti["raw"], DATE)
    for fn, name in (("read_P23_from_sequence", "calib_cam_to_cam.txt"),
                     ("read_T_from_sequence", "calib_velo_to_cam.txt"),
                     ("read_imu2velo", "calib_imu_to_velo.txt")):
        same(getattr(T, fn)(os.path.join(date, name)),
             getattr(J, fn)(os.path.join(date, name)))
    for split in (kitti["train"], kitti["test"]):
        same(T.read_split_file(split), J.read_split_file(split))
    mat = os.path.join(kitti["raw"], DRIVE, "oxts", "pose.mat")
    poses = T.read_pose_mat(mat)
    same(poses, J.read_pose_mat(mat))
    depth = os.path.join(kitti["raw"], DRIVE, "depth", "%010d.png" % 2)
    same(T.read_depth(depth), J.read_depth(depth))
    same(T.read_vo_depth(depth), J.read_vo_depth(depth))
    velo = os.path.join(kitti["raw"], DRIVE, "velodyne_points", "data",
                        "%010d.bin" % 2)
    same(T.read_pc_from_bin(velo), J.read_pc_from_bin(velo))
    image = os.path.join(kitti["raw"], DRIVE, "image_03", "data",
                         "%010d.png" % 5)
    same(T.read_image(image), J.read_image(image))
    A, B = np.eye(4) + 0.01 * np.arange(16).reshape(4, 4), poses[3]
    same(T.cam_relative_pose(poses[1], poses[2], A, B),
         J.cam_relative_pose(poses[1], poses[2], A, B))
    same(T.cam_relative_pose_nusc(poses[1], poses[5], A),
         J.cam_relative_pose_nusc(poses[1], poses[5], A))
    q = [0.9, 0.1, -0.3, 0.2]
    same(T.get_transformation_matrix([1.0, 2.0, 3.0], q),
         J.get_transformation_matrix([1.0, 2.0, 3.0], q))

    calib = os.path.join(kitti360["root"], "calibration")
    for fn, name in (("read_P01_from_sequence", "perspective.txt"),
                     ("read_extrinsic_from_sequence",
                      "calib_cam_to_pose.txt"),
                     ("read_T_from_sequence", "calib_cam_to_velo.txt")):
        same(getattr(T360, fn)(os.path.join(calib, name)),
             getattr(J360, fn)(os.path.join(calib, name)))
    path = os.path.join(kitti360["root"], "data_poses", dt.KITTI360_SEQ,
                        "poses.txt")
    same(T360.read_poses_file(path), J360.read_poses_file(path))


def test_lidar_maps_match_jax(kitti, kitti360):
    import fsnet_tpu.evaluation.lidar_projection as J
    import fsnet_tpu_torch.evaluation.lidar_projection as T

    date = os.path.join(kitti["raw"], DATE)
    for name in ("calib_cam_to_cam.txt", "calib_velo_to_cam.txt"):
        got = T.read_calib_file(os.path.join(date, name))
        ref = J.read_calib_file(os.path.join(date, name))
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])
    for i in (1, 2, 5):
        velo = os.path.join(kitti["raw"], DRIVE, "velodyne_points", "data",
                            "%010d.bin" % i)
        for vel_depth in (True, False):
            got = T.generate_depth_map(date, velo, 2, vel_depth)
            ref = J.generate_depth_map(date, velo, 2, vel_depth)
            assert got.shape == (H0, W0) and (got > 0).sum() > 1000
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(T.load_velodyne_points(velo),
                                      J.load_velodyne_points(velo))
    velo = np.fromfile(os.path.join(
        kitti360["root"], "data_3d_raw", dt.KITTI360_SEQ, "velodyne_points",
        "data", "%010d.bin" % 1), np.float32).reshape(-1, 4)
    P = np.array([[150.0, 0, 160, 0], [0, 150.0, 136, 0], [0, 0, 1, 0]]
                 ) @ np.array([[0, -1, 0, 0.1], [0, 0, -1, 0.2],
                               [1, 0, 0, -0.3], [0, 0, 0, 1]])
    got = T.project_depth_map(velo, P, np.array([H0, W0], np.int32))
    ref = J.project_depth_map(velo, P, np.array([H0, W0], np.int32))
    assert (got > 0).sum() > 1000
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------- dataset[i]

def _jax_cfg(cfg):
    """The port's config tree with the JAX package's names, as the JAX
    package's EasyDict."""
    if isinstance(cfg, dict):
        return jedict({k: _jax_cfg(v) for k, v in cfg.items()})
    if isinstance(cfg, list):
        return [_jax_cfg(v) for v in cfg]
    if isinstance(cfg, str):
        return cfg.replace("fsnet_tpu_torch.", "fsnet_tpu.")
    return cfg


def _pair(name, augmentation, **kw):
    """The port's and the JAX package's ``name`` dataset on one config."""
    from fsnet_tpu.utils.builder import build as jbuild

    cfg = edict(name=f"fsnet_tpu_torch.data.datasets.{name}",
                augmentation=augmentation, **kw)
    return tbuild(**cfg), jbuild(**_jax_cfg(cfg))


def _identity():
    return edict(name=f"fsnet_tpu_torch.{IDENTITY}")


def _same_sample(got, ref, approx=None):
    """Every key equal in value and dtype; ``approx`` maps keys to a
    tolerance instead."""
    assert list(got) == list(ref)
    for key in ref:
        g, r = np.asarray(got[key]), np.asarray(ref[key])
        assert g.dtype == r.dtype and g.shape == r.shape, key
        if approx and key in approx:
            err = np.abs(g.astype(np.float64) - r).max()
            assert err <= approx[key], (key, err)
        else:
            np.testing.assert_array_equal(g, r, err_msg=str(key))


def test_kitti_dataset_matches_jax(kitti):
    root = kitti["root"]
    got, ref = _pair("mono_dataset.KittiDepthMonoDataset", _identity(),
                     raw_path=kitti["raw"], split_file=kitti["train"],
                     frame_idxs=[0, 1, -1], depth_path=str(root / "depth"),
                     is_motion_mask=True, motion_mask_path=str(root / "mask"),
                     is_precompute_flow=True, flow_path=str(root / "flow"))
    assert len(got) == len(ref) == 3     # entries 3 and 4 are static
    assert [o["index"] for o in got.imdb] == [1, 2, 5]
    for i in range(3):
        sample = got[i]
        assert sample[("image", 0)].shape == (H0, W0, 3)
        assert sample["flow"].shape == (H0, W0, 2)
        _same_sample(sample, ref[i])
    unfiltered = _pair("mono_dataset.KittiDepthMonoDataset", _identity(),
                       raw_path=kitti["raw"], split_file=kitti["train"],
                       frame_idxs=[0, 1, -1], is_filter_static=False)
    assert len(unfiltered[0]) == 5
    _same_sample(unfiltered[0][3], unfiltered[1][3])


def test_eigen_test_dataset_matches_jax(kitti):
    got, ref = _pair("mono_dataset.KittiDepthMonoEigenTestDataset",
                     _identity(), raw_path=kitti["raw"],
                     split_file=kitti["test"], depth_path="yes")
    assert len(got) == len(ref) == 3
    for i in range(3):
        assert got[i][("sparse_depth", 0)].dtype == np.float32
        _same_sample(got[i], ref[i])


def test_kitti360_dataset_matches_jax(kitti360):
    got, ref = _pair("kitti360_dataset.KITTI360MonoDataset", _identity(),
                     raw_path=kitti360["root"], split_file=kitti360["meta"],
                     frame_ids=[0, 1, -1])
    assert len(got) == len(ref) == 1      # the static and jump entries go
    cams = set()
    for seed in range(4):                 # the random camera pick
        np.random.seed(seed)
        g = got[0]
        np.random.seed(seed)
        _same_sample(g, ref[0])
        cams.add(float(g["P2"][0, 2]))
    assert len(got.imdb) == 1
    unfiltered = _pair("kitti360_dataset.KITTI360MonoDataset", _identity(),
                       raw_path=kitti360["root"],
                       split_file=kitti360["meta"], frame_ids=[0, 1, -1],
                       is_filter_static=False, use_right_image=False)
    assert len(unfiltered[0]) == 3
    _same_sample(unfiltered[0][2], unfiltered[1][2])


def _train_aug():
    """The flagship's train graph at 64x96 with every default_rng-seeded
    class given a seed."""
    aug = tcommon.wpose_augmentation(edict(rgb_shape=(64, 96, 3)),
                                     [0, 1, -1], train=True)
    seeds = iter(range(11, 100))

    def seed(node):
        if isinstance(node, dict):
            if str(node.get("name", "")).split(".")[-1] in (
                    "RandomWarpAffine", "RandomBrightness", "RandomContrast",
                    "RandomSaturation"):
                node["random_seed"] = next(seeds)
            for v in node.values():
                seed(v)
        elif isinstance(node, list):
            for v in node:
                seed(v)
    seed(aug)
    return aug


def _global_draws(transform, seed):
    """Sets the port's ``Shuffle`` and ``RandomMirror`` generators to draw,
    in one sample, what the JAX classes draw from numpy's global state
    after ``np.random.seed(seed)``: the permutation, then the mirror's
    ``rand()``."""
    from fsnet_tpu_torch.data.augmentations import RandomMirror
    from fsnet_tpu_torch.utils.builder import Sequential, Shuffle

    def walk(node):
        if isinstance(node, Shuffle):
            node.rng = np.random.RandomState(seed)
            yield node
        elif isinstance(node, RandomMirror):
            node.rng = np.random.RandomState(seed)
            node.rng.permutation(3)
            yield node
        if isinstance(node, (Sequential, Shuffle)):
            for child in node.children:
                yield from walk(child)
    assert len(list(walk(transform))) == 2


@pytest.mark.parametrize("dataset", ["kitti", "kitti360"])
def test_datasets_train_augmentation_match_jax(kitti, kitti360, dataset):
    if dataset == "kitti":
        got, ref = _pair("mono_dataset.KittiDepthMonoDataset", _train_aug(),
                         raw_path=kitti["raw"], split_file=kitti["train"],
                         frame_idxs=[0, 1, -1])
    else:
        got, ref = _pair("kitti360_dataset.KITTI360MonoDataset",
                         _train_aug(), raw_path=kitti360["root"],
                         split_file=kitti360["meta"], frame_ids=[0, 1, -1],
                         use_right_image=False)
    stds = np.array([0.229, 0.224, 0.225])
    approx = {}
    for f in (0, 1, -1):
        approx[("image", f)] = TOL / (255 * stds.min())
        approx[("original_image", f)] = TOL / 255
    mirrored = set()
    for i, seed in zip(list(range(len(got))) * 2, range(5, 50, 7)):
        _global_draws(got.transform, seed)
        g = got[i]
        np.random.seed(seed)
        r = ref[i]
        assert g[("image", 0)].shape == (64, 96, 3)
        _same_sample(g, r, approx)
        draws = np.random.RandomState(seed)
        draws.permutation(3)
        mirrored.add(bool(draws.rand() <= 0.5))
    assert mirrored == {True, False}
