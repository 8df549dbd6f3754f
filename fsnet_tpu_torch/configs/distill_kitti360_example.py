"""The KITTI-360 self-distillation recipe (copy of
``configs/distill_kitti360_example.py`` with ``fsnet_tpu_torch`` names): a
frozen ``MonoDepthInference`` teacher (ResNet-18, 16 bins) loaded from
``<repo>/kitti360_teacher``, a ResNet-18 student with the uncertain decoder
and the distillation loss at 0.3, bs 12 @192x640 from the KITTI-360 train
subset, 20 epochs, Adam 1e-4, StepLR(8), clip 1.0, bf16, evaluated on its
val list every 5 epochs through ``KittiEvaluationHook`` and
``Kitti360Evaluator``."""
import os

from fsnet_tpu_torch.configs.common import (build_path, distill_meta_arch,
                                            kitti_evaluate_hook,
                                            trainer_section,
                                            wpose_augmentation)
from fsnet_tpu_torch.utils.easydict import EasyDict as edict

cfg = edict()
cfg.path = build_path("Distill_KITTI360_WPose",
                      kitti360_path="/data/KITTI-360")

data = edict(
    batch_size=12,
    num_workers=4,
    rgb_shape=(192, 640, 3),
    frame_idxs=[0, 1, -1],
)
SUB = os.path.join(cfg.path.base_path, "meta_data", "kitti360_trainsub")

cfg.trainer = trainer_section(
    clip_gradients=1.0,
    evaluate_hook=kitti_evaluate_hook(
        "Kitti360Evaluator", data_path=cfg.path.kitti360_path,
        split_file=os.path.join(SUB, "kitti360_val.txt"),
        gt_saved_file=os.path.join(SUB, "gt_depth.npz"),
        preprocessed_path=cfg.path.preprocessed_path),
)

cfg.optimizer = edict(name="adam", lr=1e-4, weight_decay=0)
cfg.scheduler = edict(name="StepLR", step_size=8)

cfg.train_dataset = edict(
    name="fsnet_tpu_torch.data.datasets.dataset_utils.ConcatDataset",
    frame_idxs=data.frame_idxs,
    is_filter_static=True,
    cfg_list=[
        edict(
            name="fsnet_tpu_torch.data.datasets.kitti360_dataset."
                 "KITTI360MonoDataset",
            raw_path=cfg.path.kitti360_path,
            split_file=os.path.join(SUB, "kitti360_train.txt"),
        ),
    ],
    augmentation=wpose_augmentation(data, data.frame_idxs, train=True),
)

cfg.val_dataset = edict(
    name="fsnet_tpu_torch.data.datasets.kitti360_dataset.KITTI360MonoDataset",
    raw_path=cfg.path.kitti360_path,
    split_file=os.path.join(SUB, "kitti360_val.txt"),
    is_filter_static=False,
    use_right_image=False,
    augmentation=wpose_augmentation(data, data.frame_idxs, train=False),
)

cfg.data = data
cfg.meta_arch = distill_meta_arch(
    data, os.path.join(cfg.path.base_path, "kitti360_teacher"))
