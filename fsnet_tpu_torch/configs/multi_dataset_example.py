"""Joint training over three datasets (copy of
``configs/multi_dataset_example.py`` with ``fsnet_tpu_torch`` names):
KITTI raw's eigen_zhou split, the KITTI-360 train subset and the nuScenes
train subset's JSON through one ``ConcatDataset`` at 256x832, bs 8;
ResNet-18 (ImageNet weights), 64 bins scaled by ``base_fx=492``, 20 epochs,
Adam 1e-4, StepLR(8), clip 1.0, bf16, evaluated on the Eigen test split
every 5 epochs through ``KittiEvaluationHook`` and
``KittiEigenEvaluator``."""
import os

from fsnet_tpu_torch.configs.common import (build_path, kitti_evaluate_hook,
                                            trainer_section,
                                            wpose_augmentation,
                                            wpose_meta_arch)
from fsnet_tpu_torch.utils.easydict import EasyDict as edict

cfg = edict()
cfg.path = build_path(
    "multi_dataset_wpose",
    kitti_path="/data/kitti_raw",
    kitti360_path="/data/KITTI-360",
    nuscenes_dir="/data/nuscene",
)

data = edict(
    batch_size=8,
    num_workers=4,
    rgb_shape=(256, 832, 3),
    frame_idxs=[0, 1, -1],
)
META = os.path.join(cfg.path.base_path, "meta_data")
EIGEN = os.path.join(META, "eigen")

cfg.trainer = trainer_section(
    clip_gradients=1.0,
    evaluate_hook=kitti_evaluate_hook(
        "KittiEigenEvaluator", data_path=cfg.path.kitti_path,
        split_file=os.path.join(EIGEN, "test_files.txt"),
        gt_saved_file=os.path.join(EIGEN, "gt_depths.npz"),
        preprocessed_path=cfg.path.preprocessed_path),
)

cfg.optimizer = edict(name="adam", lr=1e-4, weight_decay=0)
cfg.scheduler = edict(name="StepLR", step_size=8)

DATASETS = "fsnet_tpu_torch.data.datasets"
cfg.train_dataset = edict(
    name=f"{DATASETS}.dataset_utils.ConcatDataset",
    frame_idxs=data.frame_idxs,
    is_filter_static=True,
    cfg_list=[
        edict(
            name=f"{DATASETS}.mono_dataset.KittiDepthMonoDataset",
            raw_path=cfg.path.kitti_path,
            split_file=os.path.join(META, "eigen_zhou", "train_files.txt"),
        ),
        edict(
            name=f"{DATASETS}.kitti360_dataset.KITTI360MonoDataset",
            raw_path=cfg.path.kitti360_path,
            split_file=os.path.join(META, "kitti360_trainsub",
                                    "kitti360_train.txt"),
        ),
        edict(
            name=f"{DATASETS}.nuscene_dataset.NusceneJsonDataset",
            json_path=os.path.join(META, "nusc_trainsub",
                                   "json_nusc_front_train.json"),
        ),
    ],
    augmentation=wpose_augmentation(data, data.frame_idxs, train=True),
)

cfg.val_dataset = edict(
    name=f"{DATASETS}.mono_dataset.KittiDepthMonoEigenTestDataset",
    raw_path=cfg.path.kitti_path,
    split_file=os.path.join(EIGEN, "test_files.txt"),
    augmentation=wpose_augmentation(data, data.frame_idxs, train=False),
)

cfg.data = data
cfg.meta_arch = wpose_meta_arch(
    data, min_depth=0.5, max_depth=100.0, base_fx=492,
    num_output_channels=64)
