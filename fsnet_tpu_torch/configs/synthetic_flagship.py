"""The flagship recipe (``configs/kitti_wpose_example.py``: ResNet-18,
16 bins, bs 12 @ 192x640, Adam 1e-4, StepLR(15), clip 35.0, bf16, 20
epochs) with the KITTI raw dataset swapped for the synthetic stand-in,
rendered at KITTI raw's 375x1242 so that the train graph's
``RandomWarpAffine`` (``shift_border=128``) crops it as it crops KITTI.
The train and val augmentation graphs are the recipe's. The encoder starts
from seeded random weights (``pretrained=False``: no ImageNet weights in
the repo) and no evaluator runs (``evaluate_hook`` dropped). The splits
have the sizes of the recipe's: eigen_zhou train (39,810 samples) and the
Eigen test split (697)."""
from fsnet_tpu_torch.configs.common import (build_path, trainer_section,
                                            wpose_augmentation,
                                            wpose_meta_arch)
from fsnet_tpu_torch.utils.easydict import EasyDict as edict

cfg = edict()
cfg.path = build_path("Synthetic_Flagship_WPose")

data = edict(
    batch_size=12,
    num_workers=4,
    rgb_shape=(192, 640, 3),
    frame_idxs=[0, 1, -1],
)
KITTI_H, KITTI_W = 375, 1242
SYNTHETIC = "fsnet_tpu_torch.data.datasets.synthetic_dataset.SyntheticMonoDataset"

cfg.trainer = trainer_section(clip_gradients=35.0)
cfg.trainer.max_epochs = 20

cfg.optimizer = edict(name="adam", lr=1e-4, weight_decay=0)
cfg.scheduler = edict(name="StepLR", step_size=15)

cfg.train_dataset = edict(
    name="fsnet_tpu_torch.data.datasets.dataset_utils.ConcatDataset",
    frame_idxs=data.frame_idxs,
    is_motion_mask=False,
    is_precompute_flow=False,
    is_filter_static=True,
    cfg_list=[
        edict(name=SYNTHETIC, length=39810, height=KITTI_H, width=KITTI_W,
              seed=1),
    ],
    augmentation=wpose_augmentation(data, data.frame_idxs, train=True),
)

cfg.val_dataset = edict(
    name=SYNTHETIC,
    length=697, height=KITTI_H, width=KITTI_W, seed=2,
    frame_idxs=data.frame_idxs,
    augmentation=wpose_augmentation(data, data.frame_idxs, train=False),
)

cfg.data = data
cfg.meta_arch = wpose_meta_arch(data, min_depth=0.5, max_depth=100.0,
                                pretrained=False)
