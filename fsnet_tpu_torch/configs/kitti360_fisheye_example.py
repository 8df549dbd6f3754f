"""The KITTI-360 fisheye recipe (copy of
``configs/kitti360_fisheye_example.py`` with ``fsnet_tpu_torch`` names):
ResNet-18 (ImageNet weights), 16 bins under the Mei-camera
``FishEyeDecoder`` (depth 0.1-150), bs 16 @384x384 from the KITTI-360
train subset's fisheye frames (the aspect-preserving resize and the mirror
only, so the ray maps of the final P2 hold, and the fisheye validity
mask), 20 epochs, Adam 1e-4 with weight decay 1e-5, StepLR(8), clip 1.0,
bf16, evaluated on its val list every 5 epochs through
``KittiEvaluationHook`` and ``Kitti360FisheyeEvaluator``."""
import os

import numpy as np

from fsnet_tpu_torch.configs.common import (AUG, BUILDER, build_path,
                                            trainer_section,
                                            wpose_meta_arch)
from fsnet_tpu_torch.utils.easydict import EasyDict as edict

cfg = edict()
cfg.path = build_path("KITTI360_fisheye", kitti360_path="/data/KITTI-360")

data = edict(
    batch_size=16,
    num_workers=4,
    rgb_shape=(384, 384, 3),
    frame_idxs=[0, 1, -1],
)
SUB = os.path.join(cfg.path.base_path, "meta_data", "kitti360_trainsub")

cfg.trainer = trainer_section(
    clip_gradients=1.0,
    evaluate_hook=edict(
        name="fsnet_tpu_torch.pipeline_hooks.evaluation_hooks."
             "KittiEvaluationHook",
        test_run_hook_cfg=edict(
            name="fsnet_tpu_torch.pipeline_hooks.train_val_hooks."
                 "BaseValidationHook"),
        dataset_eval_cfg=edict(
            name="fsnet_tpu_torch.evaluation.kitti360_fisheye_eval."
                 "Kitti360FisheyeEvaluator",
            data_path=cfg.path.kitti360_path,
            split_file=os.path.join(SUB, "kitti360_val.txt"),
            gt_saved_file=os.path.join(SUB, "fisheye_gt_depth.npz"),
        ),
    ),
)

cfg.optimizer = edict(name="adam", lr=1e-4, weight_decay=1e-5)
cfg.scheduler = edict(name="StepLR", step_size=8)

# the aspect-preserving resize and the mirror only: a geometric warp would
# break the ray maps of the final P2; original_image copied after the
# mirror
resize_image_keys = [("image", idx) for idx in data.frame_idxs]
original_image_keys = [("original_image", idx) for idx in data.frame_idxs]
color_keys = [("image", idx) for idx in data.frame_idxs]
pose_axis_pairs = [(("relative_pose", idx), 0) for idx in data.frame_idxs[1:]]

train_augmentation = edict(
    name=f"{BUILDER}.Sequential",
    cfg_list=[
        edict(name=f"{AUG}.ConvertToFloat"),
        edict(name=f"{AUG}.Resize",
              size=(data.rgb_shape[0], data.rgb_shape[1]),
              preserve_aspect_ratio=True, force_pad=True),
        edict(name=f"{AUG}.RandomMirror", mirror_prob=0.5,
              pose_axis_pairs=pose_axis_pairs),
        edict(name=f"{AUG}.Copy", from_keys=resize_image_keys,
              to_keys=original_image_keys),
        edict(name=f"{BUILDER}.Shuffle",
              cfg_list=[
                  edict(name=f"{AUG}.RandomBrightness", distort_prob=1.0),
                  edict(name=f"{AUG}.RandomContrast", distort_prob=1.0,
                        lower=0.6, upper=1.4),
                  edict(name=f"{BUILDER}.Sequential",
                        cfg_list=[
                            edict(name=f"{AUG}.ConvertColor", transform="HSV"),
                            edict(name=f"{AUG}.RandomSaturation",
                                  distort_prob=1.0, lower=0.6, upper=1.4),
                            edict(name=f"{AUG}.ConvertColor", current="HSV",
                                  transform="RGB"),
                        ]),
              ],
              image_keys=color_keys),
        edict(name=f"{AUG}.Normalize", mean=np.array([0.485, 0.456, 0.406]),
              stds=np.array([0.229, 0.224, 0.225]), image_keys=color_keys),
        edict(name=f"{AUG}.Normalize", mean=np.array([0, 0, 0]),
              stds=np.array([1, 1, 1]), image_keys=original_image_keys),
        edict(name=f"{AUG}.ConvertToTensor"),
    ],
    image_keys=resize_image_keys,
    calib_keys=["P2"],
    gt_image_keys=["patched_mask"],
)

val_augmentation = edict(
    name=f"{BUILDER}.Sequential",
    cfg_list=[
        edict(name=f"{AUG}.ConvertToFloat"),
        edict(name=f"{AUG}.Resize",
              size=(data.rgb_shape[0], data.rgb_shape[1]),
              preserve_aspect_ratio=True, force_pad=True),
        edict(name=f"{AUG}.Normalize", mean=np.array([0.485, 0.456, 0.406]),
              stds=np.array([0.229, 0.224, 0.225])),
        edict(name=f"{AUG}.ConvertToTensor"),
    ],
    image_keys=[("image", 0)],
    calib_keys=["P2"],
)

cfg.train_dataset = edict(
    name="fsnet_tpu_torch.data.datasets.dataset_utils.ConcatDataset",
    frame_idxs=data.frame_idxs,
    is_filter_static=True,
    cfg_list=[
        edict(
            name="fsnet_tpu_torch.data.datasets.fisheye_dataset."
                 "KITTI360FisheyeDataset",
            raw_path=cfg.path.kitti360_path,
            split_file=os.path.join(SUB, "kitti360_train.txt"),
            fisheye_mask=os.path.join(SUB, "fisheye_mask.png"),
        ),
    ],
    augmentation=train_augmentation,
)

cfg.val_dataset = edict(
    name="fsnet_tpu_torch.data.datasets.fisheye_dataset."
         "KITTI360FisheyeDataset",
    raw_path=cfg.path.kitti360_path,
    split_file=os.path.join(SUB, "kitti360_val.txt"),
    is_filter_static=False,
    use_right_image=False,
    augmentation=val_augmentation,
)

cfg.data = data
cfg.meta_arch = wpose_meta_arch(
    data, min_depth=0.1, max_depth=150.0,
    head_name="fsnet_tpu_torch.models.heads.fisheye_decoder.FishEyeDecoder")
