"""The KITTI raw self-distillation recipe (copy of
``configs/distill_kitti_example.py`` with ``fsnet_tpu_torch`` names): a
frozen ``MonoDepthInference`` teacher (ResNet-18, 16 bins) loaded from
``<repo>/kitti_teacher``, a ResNet-18 student with the uncertain decoder
and the distillation loss at 0.3, bs 12 @192x640 from KITTI raw's
eigen_zhou split, 20 epochs, Adam 1e-4, StepLR(15), clip 35.0, bf16,
evaluated on the Eigen test split every 5 epochs through
``KittiEvaluationHook`` and ``KittiEigenEvaluator``."""
import os

from fsnet_tpu_torch.configs.common import (build_path, distill_meta_arch,
                                            kitti_evaluate_hook,
                                            trainer_section,
                                            wpose_augmentation)
from fsnet_tpu_torch.utils.easydict import EasyDict as edict

cfg = edict()
cfg.path = build_path("Distill_Kitti_MonoDepth2WPose",
                      kitti_path="/data/kitti_raw")

data = edict(
    batch_size=12,
    num_workers=4,
    rgb_shape=(192, 640, 3),
    frame_idxs=[0, 1, -1],
)
EIGEN = os.path.join(cfg.path.base_path, "meta_data", "eigen")

cfg.trainer = trainer_section(
    clip_gradients=35.0,
    evaluate_hook=kitti_evaluate_hook(
        "KittiEigenEvaluator", data_path=cfg.path.kitti_path,
        split_file=os.path.join(EIGEN, "test_files.txt"),
        gt_saved_file=os.path.join(EIGEN, "gt_depths.npz"),
        preprocessed_path=cfg.path.preprocessed_path),
)

cfg.optimizer = edict(name="adam", lr=1e-4, weight_decay=0)
cfg.scheduler = edict(name="StepLR", step_size=15)

cfg.train_dataset = edict(
    name="fsnet_tpu_torch.data.datasets.dataset_utils.ConcatDataset",
    frame_idxs=data.frame_idxs,
    is_filter_static=True,
    cfg_list=[
        edict(
            name="fsnet_tpu_torch.data.datasets.mono_dataset."
                 "KittiDepthMonoDataset",
            raw_path=cfg.path.kitti_path,
            split_file=os.path.join(cfg.path.base_path, "meta_data",
                                    "eigen_zhou", "train_files.txt"),
        ),
    ],
    augmentation=wpose_augmentation(data, data.frame_idxs, train=True),
)

cfg.val_dataset = edict(
    name="fsnet_tpu_torch.data.datasets.mono_dataset."
         "KittiDepthMonoEigenTestDataset",
    raw_path=cfg.path.kitti_path,
    split_file=os.path.join(EIGEN, "test_files.txt"),
    augmentation=wpose_augmentation(data, data.frame_idxs, train=False),
)

cfg.data = data
cfg.meta_arch = distill_meta_arch(
    data, os.path.join(cfg.path.base_path, "kitti_teacher"))
