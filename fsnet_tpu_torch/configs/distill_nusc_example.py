"""The nuScenes self-distillation recipe (copy of
``configs/distill_nusc_example.py`` with ``fsnet_tpu_torch`` names): a
frozen ``MonoDepthInference`` teacher (ResNet-18, 16 bins) loaded from
``<repo>/nusc_teacher``, a ResNet-18 student with the uncertain decoder
and the distillation loss at 0.3, bs 8 @288x512 from the train subset's
JSON, 20 epochs, Adam 1e-4, StepLR(4), clip 1.0, bf16, evaluated every 5
epochs through ``FastNuscEvaluationHook`` and ``NuscenesEvaluator``."""
import os

from fsnet_tpu_torch.configs.common import (build_path, distill_meta_arch,
                                            nusc_evaluate_hook,
                                            trainer_section,
                                            wpose_augmentation)
from fsnet_tpu_torch.utils.easydict import EasyDict as edict

cfg = edict()
cfg.path = build_path("Distill_nusc_WPose", nuscenes_dir="/data/nuscene")

data = edict(
    batch_size=8,
    num_workers=4,
    rgb_shape=(288, 512, 3),
    frame_idxs=[0, 1, -1],
)
SUB = os.path.join(cfg.path.base_path, "meta_data", "nusc_trainsub")

cfg.trainer = trainer_section(
    clip_gradients=1.0,
    evaluate_hook=nusc_evaluate_hook(cfg.path.nuscenes_dir,
                                     cfg.path.base_path),
)

cfg.optimizer = edict(name="adam", lr=1e-4, weight_decay=0)
cfg.scheduler = edict(name="StepLR", step_size=4)

cfg.train_dataset = edict(
    name="fsnet_tpu_torch.data.datasets.dataset_utils.ConcatDataset",
    frame_idxs=data.frame_idxs,
    is_filter_static=True,
    cfg_list=[
        edict(
            name="fsnet_tpu_torch.data.datasets.nuscene_dataset."
                 "NusceneJsonDataset",
            json_path=os.path.join(SUB, "json_nusc_front_train.json"),
        ),
    ],
    augmentation=wpose_augmentation(data, data.frame_idxs, train=True),
)

cfg.val_dataset = edict(
    name="fsnet_tpu_torch.data.datasets.nuscene_dataset.NusceneJsonDataset",
    json_path=os.path.join(SUB, "json_nusc_front_val.json"),
    augmentation=wpose_augmentation(data, data.frame_idxs, train=False),
)

cfg.data = data
cfg.meta_arch = distill_meta_arch(
    data, os.path.join(cfg.path.base_path, "nusc_teacher"))
