"""Smoke config (counterpart of ``configs/synthetic_smoke_example.py``):
the flagship wpose graph on the synthetic dataset at 64x96, bs 4, float32,
one epoch of 3 steps; ``fsnet_tpu_torch`` names and this package's
EasyDict."""
import os
import tempfile

import numpy as np

from fsnet_tpu_torch.utils.easydict import EasyDict as edict

cfg = edict()

## path
path = edict()
path.base_path = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
path.project_path = os.path.join(tempfile.gettempdir(), "fsnet_torch_smoke")
os.makedirs(path.project_path, exist_ok=True)
path.log_path = os.path.join(path.project_path, "log")
os.makedirs(path.log_path, exist_ok=True)
path.checkpoint_path = os.path.join(path.project_path, "checkpoint")
os.makedirs(path.checkpoint_path, exist_ok=True)
path.preprocessed_path = os.path.join(path.project_path, "output")
os.makedirs(path.preprocessed_path, exist_ok=True)
path.pretrained_checkpoint = ""
cfg.path = path

H, W = 64, 96

## trainer
cfg.trainer = edict(
    max_epochs=1,
    disp_iter=2,
    save_iter=1,
    test_iter=100,
    seed=42,
    training_hook=edict(
        name="fsnet_tpu_torch.pipeline_hooks.train_val_hooks.BaseTrainingHook",
        clip_gradients=1.0,
    ),
)

## optimizer / scheduler
cfg.optimizer = edict(name="adam", lr=1e-4, weight_decay=0)
cfg.scheduler = edict(name="StepLR", step_size=8)

data = edict(
    batch_size=4,
    num_workers=0,
    rgb_shape=(H, W, 3),
    frame_idxs=[0, 1, -1],
)

aug_path = "fsnet_tpu_torch.data.augmentations"
resize_image_keys = ([("image", idx) for idx in data.frame_idxs]
                     + [("original_image", idx) for idx in data.frame_idxs])
color_keys = [("image", idx) for idx in data.frame_idxs]
pose_axis_pairs = [(("relative_pose", idx), 0) for idx in data.frame_idxs[1:]]

augmentation = edict(
    name="fsnet_tpu_torch.utils.builder.Sequential",
    cfg_list=[
        edict(name=f"{aug_path}.ConvertToFloat"),
        edict(name=f"{aug_path}.Resize", size=(H, W),
              preserve_aspect_ratio=False),
        edict(name=f"{aug_path}.RandomMirror", mirror_prob=0.5,
              pose_axis_pairs=pose_axis_pairs),
        edict(name=f"{aug_path}.Normalize",
              mean=np.array([0.485, 0.456, 0.406]),
              stds=np.array([0.229, 0.224, 0.225]), image_keys=color_keys),
        edict(name=f"{aug_path}.Normalize", mean=np.array([0, 0, 0]),
              stds=np.array([1, 1, 1]),
              image_keys=[("original_image", idx) for idx in data.frame_idxs]),
        edict(name=f"{aug_path}.ConvertToTensor"),
    ],
    image_keys=resize_image_keys,
    calib_keys=["P2"],
    gt_image_keys=["patched_mask"],
)

cfg.train_dataset = edict(
    name="fsnet_tpu_torch.data.datasets.dataset_utils.ConcatDataset",
    frame_idxs=data.frame_idxs,
    cfg_list=[
        edict(
            name="fsnet_tpu_torch.data.datasets.synthetic_dataset.SyntheticMonoDataset",
            length=12, height=H, width=W, seed=1,
        ),
    ],
    augmentation=augmentation,
)

cfg.val_dataset = edict(
    name="fsnet_tpu_torch.data.datasets.synthetic_dataset.SyntheticMonoDataset",
    length=4, height=H, width=W, seed=2,
    frame_idxs=data.frame_idxs,
    augmentation=augmentation,
)

cfg.data = data

## networks
cfg.meta_arch = edict(
    name="fsnet_tpu_torch.models.meta_archs.monodepth2_model.MonoDepthWPose",
    depth_backbone_cfg=edict(
        name="fsnet_tpu_torch.models.backbones.resnet.resnet",
        depth=18,
        frozen_stages=-1,
        num_stages=4,
        out_indices=(-1, 0, 1, 2, 3),
        norm_eval=False,
        dilations=(1, 1, 1, 1),
    ),
    head_cfg=edict(
        name="fsnet_tpu_torch.models.heads.monodepth2_decoder.MonoDepth2Decoder",
        scales=(0, 1, 2, 3),
        height=H,
        width=W,
        min_depth=0.5,
        max_depth=100.0,
        is_log_image=False,
        overlapped_mask=True,
        depth_decoder_cfg=edict(
            name="fsnet_tpu_torch.models.heads.depth_decoder.MultiChannelDepthDecoder",
            num_output_channels=16,
            use_skips=True,
            scales=(0, 1, 2, 3),
            min_depth=0.5,
            max_depth=100.0,
        ),
    ),
    train_cfg=edict(frame_ids=(0, 1, -1)),
    test_cfg=edict(),
)
