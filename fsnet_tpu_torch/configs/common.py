"""Shared config pieces (counterpart of ``configs/common.py`` with
``fsnet_tpu_torch`` names and this package's EasyDict): the project paths,
the flagship's train and val augmentation graphs, its ``MonoDepthWPose``
and the trainer section."""
import os

import numpy as np

from fsnet_tpu_torch.utils.easydict import EasyDict as edict

AUG = "fsnet_tpu_torch.data.augmentations"
BUILDER = "fsnet_tpu_torch.utils.builder"
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def build_path(project_name, workdir="workdirs", **data_roots):
    """The project's log, checkpoint and output directories under
    ``<repo>/<workdir>/<project_name>``, made if missing."""
    path = edict()
    path.base_path = REPO
    for key, value in data_roots.items():
        path[key] = value
    path.project_path = os.path.join(path.base_path, workdir, project_name)
    path.log_path = os.path.join(path.project_path, "log")
    path.checkpoint_path = os.path.join(path.project_path, "checkpoint")
    path.preprocessed_path = os.path.join(path.project_path, "output")
    path.train_imdb_path = os.path.join(path.preprocessed_path, "training")
    path.val_imdb_path = os.path.join(path.preprocessed_path, "validation")
    for key in ("project_path", "log_path", "checkpoint_path",
                "preprocessed_path", "train_imdb_path", "val_imdb_path"):
        os.makedirs(path[key], exist_ok=True)
    path.pretrained_checkpoint = ""
    return path


def wpose_augmentation(data, frame_idxs, train=True, extra_image_keys=()):
    """The flagship's train and val augmentation graphs."""
    resize_image_keys = ([("image", idx) for idx in frame_idxs]
                         + [("original_image", idx) for idx in frame_idxs]
                         + list(extra_image_keys))
    color_keys = [("image", idx) for idx in frame_idxs]
    pose_axis_pairs = [(("relative_pose", idx), 0) for idx in frame_idxs[1:]]
    crop_h, crop_w = data.rgb_shape[0], data.rgb_shape[1]

    if train:
        return edict(
            name=f"{BUILDER}.Sequential",
            cfg_list=[
                edict(name=f"{AUG}.ConvertToFloat"),
                edict(name=f"{AUG}.RandomWarpAffine", output_w=crop_w,
                      output_h=crop_h),
                edict(name=f"{BUILDER}.Shuffle",
                      cfg_list=[
                          edict(name=f"{AUG}.RandomBrightness",
                                distort_prob=1.0),
                          edict(name=f"{AUG}.RandomContrast", distort_prob=1.0,
                                lower=0.6, upper=1.4),
                          edict(name=f"{BUILDER}.Sequential",
                                cfg_list=[
                                    edict(name=f"{AUG}.ConvertColor",
                                          transform="HSV"),
                                    edict(name=f"{AUG}.RandomSaturation",
                                          distort_prob=1.0, lower=0.6,
                                          upper=1.4),
                                    edict(name=f"{AUG}.ConvertColor",
                                          current="HSV", transform="RGB"),
                                ]),
                      ],
                      image_keys=color_keys),
                edict(name=f"{AUG}.RandomMirror", mirror_prob=0.5,
                      pose_axis_pairs=pose_axis_pairs),
                edict(name=f"{AUG}.Normalize",
                      mean=np.array([0.485, 0.456, 0.406]),
                      stds=np.array([0.229, 0.224, 0.225]),
                      image_keys=color_keys),
                edict(name=f"{AUG}.Normalize", mean=np.array([0, 0, 0]),
                      stds=np.array([1, 1, 1]),
                      image_keys=[("original_image", idx)
                                  for idx in frame_idxs]),
                edict(name=f"{AUG}.ConvertToTensor"),
            ],
            image_keys=resize_image_keys,
            calib_keys=["P2"],
            gt_image_keys=["patched_mask"],
        )
    return edict(
        name=f"{BUILDER}.Sequential",
        cfg_list=[
            edict(name=f"{AUG}.ConvertToFloat"),
            edict(name=f"{AUG}.Resize", size=(crop_h, crop_w),
                  preserve_aspect_ratio=False),
            edict(name=f"{AUG}.Normalize",
                  mean=np.array([0.485, 0.456, 0.406]),
                  stds=np.array([0.229, 0.224, 0.225])),
            edict(name=f"{AUG}.ConvertToTensor"),
        ],
        image_keys=[("image", 0)],
        calib_keys=["P2"],
    )


def wpose_meta_arch(data, min_depth=0.5, max_depth=100.0, resnet_depth=18,
                    pretrained=True, num_output_channels=16,
                    overlapped_mask=True):
    """The flagship ``MonoDepthWPose`` graph."""
    models = "fsnet_tpu_torch.models"
    return edict(
        name=f"{models}.meta_archs.monodepth2_model.MonoDepthWPose",
        depth_backbone_cfg=edict(
            name=f"{models}.backbones.resnet.resnet",
            depth=resnet_depth,
            pretrained=pretrained,
            frozen_stages=-1,
            num_stages=4,
            out_indices=(-1, 0, 1, 2, 3),
            norm_eval=False,
            dilations=(1, 1, 1, 1),
        ),
        head_cfg=edict(
            name=f"{models}.heads.monodepth2_decoder.MonoDepth2Decoder",
            scales=[0, 1, 2, 3],
            height=data.rgb_shape[0],
            width=data.rgb_shape[1],
            min_depth=min_depth,
            max_depth=max_depth,
            is_log_image=False,
            overlapped_mask=overlapped_mask,
            depth_decoder_cfg=edict(
                name=f"{models}.heads.depth_decoder.MultiChannelDepthDecoder",
                num_ch_enc=np.array([64, 64, 128, 256, 512]),
                num_output_channels=num_output_channels,
                use_skips=True,
                scales=[0, 1, 2, 3],
                min_depth=min_depth,
                max_depth=max_depth,
            ),
        ),
        train_cfg=edict(frame_ids=data.frame_idxs),
        test_cfg=edict(),
    )


def trainer_section(clip_gradients):
    """20 epochs, logging every 50 steps, a checkpoint every 5 epochs, the
    bf16 step (every shipped config's ``compute_dtype``)."""
    return edict(
        max_epochs=20,
        disp_iter=50,
        save_iter=5,
        test_iter=5,
        training_hook=edict(
            name=("fsnet_tpu_torch.pipeline_hooks.train_val_hooks."
                  "BaseTrainingHook"),
            clip_gradients=clip_gradients,
            compute_dtype="bfloat16",
        ),
    )
