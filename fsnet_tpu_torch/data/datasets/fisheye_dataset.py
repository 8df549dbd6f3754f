"""KITTI-360 fisheye dataset, Mei unified camera model (counterpart of
``fsnet_tpu.data.datasets.fisheye_dataset``): the yaml Mei calibration of
``image_02`` and ``image_03``, the cam -> pose extrinsics of all four
cameras, key-pose relative poses, static and > 3 m jump filtering, a random
pick of the left or right fisheye camera per sample, the fisheye validity
mask resized to the frame, and, after the augmentation (which may rescale
and mirror P2), the ray map of the final P2 and shape (``'fisheye_rays'``
[H, W, 4] = X, Y, Z, valid) and ``'fisheye_params'`` [3] = (xi, k1, k2).

The camera pick draws ``rand() < 0.5`` from a ``RandomState`` the dataset
owns (``rng``, seeded from numpy's global state when the dataset is
built), where the JAX package draws it from numpy's global state: with
``rng`` set to ``RandomState(s)`` it picks what ``np.random.seed(s)``
would have made the JAX dataset pick. Loader workers reseed it
(:mod:`fsnet_tpu_torch.data.dataloader`). The mask is read by the port's
PNG reader and resized by :func:`~fsnet_tpu_torch.data.augmentations.
resize_nearest` (``cv2.imread(path, -1)`` and ``cv2.resize(...,
INTER_NEAREST)``, bit for bit); each ray map is computed once per process
and camera (:class:`~fsnet_tpu_torch.ops.fisheye.MeiCameraProjection`).
"""
from __future__ import annotations

import os
from copy import deepcopy
from typing import Dict

import numpy as np
import yaml

from ...ops.fisheye import MeiCameraProjection
from ...utils.builder import build
from ..augmentations import resize_nearest
from .image_io import imread_unchanged
from .io_utils import cam_relative_pose_nusc, read_image
from .kitti360_dataset import read_poses_file


def read_fisheye_extrinsics(file: str) -> Dict[str, np.ndarray]:
    """cam -> pose extrinsics of the four cameras (``T_image0``-``3``)."""
    Ts = {f"T_image{i}": np.eye(4) for i in range(4)}
    with open(file, "r") as f:
        for line in f.readlines():
            for i in range(4):
                if line.startswith(f"image_{i:02d}"):
                    data = line.strip().split(" ")
                    Ts[f"T_image{i}"][0:3, :] = np.array(
                        [float(x) for x in data[1:13]]).reshape(3, 4)
    return Ts


def read_fisheycalib(file: str) -> Dict:
    """A KITTI-360 fisheye yaml; its first line is not yaml and is
    skipped."""
    with open(file, "r") as f:
        f.readline()
        return yaml.safe_load(f)


def extract_P_from_fisheye_calib(calib: Dict) -> np.ndarray:
    """gamma1, gamma2, u0, v0 -> a [3, 4] P."""
    P = np.zeros([3, 4])
    P[0, 0] = calib["projection_parameters"]["gamma1"]
    P[1, 1] = calib["projection_parameters"]["gamma2"]
    P[0, 2] = calib["projection_parameters"]["u0"]
    P[1, 2] = calib["projection_parameters"]["v0"]
    P[2, 2] = 1
    return P


class KITTI360FisheyeDataset:
    """Training (and, unfiltered, validation) dataset over KITTI-360's
    fisheye cameras."""

    def __init__(self, **data_cfg):
        self.raw_path = data_cfg.get("raw_path", "/data/KITTI-360")
        self.meta_file = data_cfg.get("split_file", "kitti360_meta.txt")
        self.resized_root = data_cfg.get("resized_root")

        if self.resized_root is not None:
            self.img_dir = self.resized_root
            self.calib_dir = os.path.join(self.resized_root, "calibration")
        else:
            self.img_dir = os.path.join(self.raw_path, "data_2d_raw")
            self.calib_dir = os.path.join(self.raw_path, "calibration")
        self.pose_dir = os.path.join(self.raw_path, "data_poses")
        self.pc_dir = os.path.join(self.raw_path, "data_3d_raw")

        self.frame_ids = list(data_cfg.get("frame_ids",
                                           data_cfg.get("frame_idxs", [0, -1, 1])))
        self.imdb = []
        self.sequence_names = set()
        with open(self.meta_file, "r") as f:
            for line in f.readlines():
                seq, pose_idx, img_idx, former, latter = line.strip().split(",")
                pose_idx, img_idx = int(pose_idx), int(img_idx)
                former, latter = int(former), int(latter)
                self.sequence_names.add(seq)
                index_dict = {0: img_idx, -1: former, 1: latter}
                self.imdb.append(dict(
                    sequence_name=seq,
                    pose_indexes=[pose_idx + i for i in self.frame_ids],
                    img_indexes=[index_dict[i] for i in self.frame_ids],
                ))

        self._load_calib()
        self._load_keypose()

        self.is_motion_mask = data_cfg.get("is_motion_mask", False)
        self.precompute_path = data_cfg.get("motion_mask_path", "")
        self.is_filter_static = data_cfg.get("is_filter_static", True)
        self.filter_threshold = data_cfg.get("filter_threshold", 0.03)
        if self.is_filter_static:
            self.imdb = self._filter_indexes()

        self.use_right_image = data_cfg.get("use_right_image", True)
        self.rng = np.random.RandomState(np.random.randint(0, 2 ** 32))

        fisheye_mask = data_cfg.get("fisheye_mask")
        self.fish_eye_mask = (imread_unchanged(fisheye_mask)
                              if fisheye_mask is not None else None)

        self.transform = build(**data_cfg["augmentation"])
        self.mei = MeiCameraProjection()

    def _load_calib(self):
        left_calib = read_fisheycalib(
            os.path.join(self.calib_dir, "image_02.yaml"))
        right_calib = read_fisheycalib(
            os.path.join(self.calib_dir, "image_03.yaml"))
        Ts = read_fisheye_extrinsics(
            os.path.join(self.calib_dir, "calib_cam_to_pose.txt"))
        self.cam_calib = dict(
            P0=extract_P_from_fisheye_calib(left_calib),
            P1=extract_P_from_fisheye_calib(right_calib),
            T_rect02baselink=Ts["T_image2"],
            T_rect12baselink=Ts["T_image3"],
            left_meta=left_calib,
            right_meta=right_calib,
        )

    def _load_keypose(self):
        self.keypose = {}
        for seq in self.sequence_names:
            _, poses = read_poses_file(
                os.path.join(self.pose_dir, seq, "poses.txt"))
            self.keypose[seq] = poses

    def _filter_indexes(self):
        """Drops the static (< threshold) and key-pose-jump (> 3 m)
        samples."""
        imdb = []
        extrinsics = self.cam_calib["T_rect02baselink"]
        for obj in self.imdb:
            poses = self.keypose[obj["sequence_name"]][obj["pose_indexes"]]
            is_overlook = False
            for i, _ in enumerate(self.frame_ids[1:]):
                pose_diff = cam_relative_pose_nusc(
                    poses[0], poses[i + 1],
                    np.linalg.inv(extrinsics)).astype(np.float32)
                t = np.linalg.norm(pose_diff[0:3, 3])
                if t < self.filter_threshold or t > 3:
                    is_overlook = True
            if not is_overlook:
                imdb.append(obj)
        print(f"Fisheye filtering: {len(self.imdb)} -> {len(imdb)} samples")
        return imdb

    def __len__(self):
        return len(self.imdb)

    def __getitem__(self, index: int) -> Dict:
        obj = self.imdb[index]
        seq = obj["sequence_name"]

        if (not self.use_right_image) or (self.rng.rand() < 0.5):
            extrinsics = self.cam_calib["T_rect02baselink"]
            image_dir_name = "image_02"
            P2 = self.cam_calib["P0"]
            calib_meta = self.cam_calib["left_meta"]
        else:
            extrinsics = self.cam_calib["T_rect12baselink"]
            image_dir_name = "image_03"
            P2 = self.cam_calib["P1"]
            calib_meta = self.cam_calib["right_meta"]

        data: Dict = {}
        poses = self.keypose[seq][obj["pose_indexes"]]
        for i, idx in enumerate(self.frame_ids[1:]):
            data[("relative_pose", idx)] = cam_relative_pose_nusc(
                poses[0], poses[i + 1],
                np.linalg.inv(extrinsics)).astype(np.float32)

        image_dir = os.path.join(self.img_dir, seq, image_dir_name, "data_rgb")
        for i, frame_id in enumerate(self.frame_ids):
            data[("image", frame_id)] = read_image(os.path.join(
                image_dir, f"{obj['img_indexes'][i]:010d}.png"))
            data[("original_image", frame_id)] = data[("image", frame_id)].copy()

        data["P2"] = np.zeros((3, 4), dtype=np.float32)
        data["P2"][0:3, 0:3] = P2[0:3, 0:3]
        data["original_P2"] = data["P2"].copy()
        data["calib_meta"] = deepcopy(calib_meta)

        h, w, _ = data[("image", 0)].shape
        if self.fish_eye_mask is not None:
            data["patched_mask"] = resize_nearest(self.fish_eye_mask, w, h)
        else:
            data["patched_mask"] = np.ones([h, w])

        data = self.transform(deepcopy(data))

        # the ray map of the final P2 and shape
        img0 = data[("image", 0)]
        fh, fw = img0.shape[0], img0.shape[1]
        X, Y, Z, mask = self.mei.get_ray_map(fh, fw, data["P2"], calib_meta)
        data["fisheye_rays"] = np.stack(
            [X[0], Y[0], Z[0], mask[0]], axis=-1).astype(np.float32)
        data["fisheye_params"] = np.array([
            calib_meta["mirror_parameters"]["xi"],
            calib_meta["distortion_parameters"]["k1"],
            calib_meta["distortion_parameters"]["k2"]], dtype=np.float32)
        return data
