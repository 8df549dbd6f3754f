"""Shared config pieces (counterpart of ``configs/common.py`` with
``fsnet_tpu_torch`` names and this package's EasyDict): the project paths,
the flagship's train and val augmentation graphs, its ``MonoDepthWPose``,
the self-distillation ``DistillWPoseMeta``, the trainer section, the
KITTI and nuScenes evaluation hooks, and the motion-mask precompute
hook."""
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
                    overlapped_mask=True, base_fx=None, head_name=None):
    """The flagship ``MonoDepthWPose`` graph; ``base_fx`` scales the
    decoder's bins by each frame's focal length where given; ``head_name``
    replaces the ``MonoDepth2Decoder`` head (the fisheye config's
    ``FishEyeDecoder``)."""
    models = "fsnet_tpu_torch.models"
    cfg = edict(
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
            name=(head_name
                  or f"{models}.heads.monodepth2_decoder.MonoDepth2Decoder"),
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
    if base_fx is not None:
        cfg.head_cfg.depth_decoder_cfg.base_fx = base_fx
    return cfg


def distill_meta_arch(data, teacher_net_path):
    """The self-distillation ``DistillWPoseMeta``: a frozen
    ``MonoDepthInference`` teacher (ResNet-18, 16 bins) loaded from
    ``teacher_net_path``, a ResNet-18 student decoding through
    ``MultiChannelDepthDecoderUncertain`` under the head with the overlap
    mask and the uncertainty-weighted distillation loss at 0.3."""
    models = "fsnet_tpu_torch.models"
    backbone = edict(
        name=f"{models}.backbones.resnet.resnet",
        depth=18,
        pretrained=False,
        frozen_stages=-1,
        num_stages=4,
        out_indices=(-1, 0, 1, 2, 3),
        norm_eval=False,
        dilations=(1, 1, 1, 1),
    )

    def decoder(kind):
        return edict(
            name=f"{models}.heads.depth_decoder.{kind}",
            num_ch_enc=np.array([64, 64, 128, 256, 512]),
            num_output_channels=16,
            use_skips=True,
            scales=[0, 1, 2, 3],
            min_depth=0.5,
            max_depth=100,
        )

    return edict(
        name=f"{models}.meta_archs.monodepth2_model.DistillWPoseMeta",
        teacher_net_cfg=edict(
            name=f"{models}.meta_archs.monodepth2_model.MonoDepthInference",
            backbone_cfg=backbone,
            depth_head_cfg=decoder("MultiChannelDepthDecoder"),
        ),
        teacher_net_path=teacher_net_path,
        depth_backbone_cfg=backbone,
        head_cfg=edict(
            name=f"{models}.heads.monodepth2_decoder.MonoDepth2Decoder",
            scales=[0, 1, 2, 3],
            height=data.rgb_shape[0],
            width=data.rgb_shape[1],
            min_depth=0.5,
            max_depth=100.0,
            is_log_image=False,
            overlapped_mask=True,
            distillation_loss_weight=0.3,
            is_uncertain_distill=True,
            depth_decoder_cfg=decoder("MultiChannelDepthDecoderUncertain"),
        ),
        train_cfg=edict(frame_ids=data.frame_idxs),
        test_cfg=edict(),
    )


def trainer_section(clip_gradients, evaluate_hook=None):
    """20 epochs, logging every 50 steps, a checkpoint and an evaluation
    (where ``evaluate_hook`` is given) every 5 epochs, the bf16 step (every
    shipped config's ``compute_dtype``)."""
    section = edict(
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
    if evaluate_hook is not None:
        section.evaluate_hook = evaluate_hook
    return section


def kitti_evaluate_hook(evaluator, data_path, split_file, gt_saved_file,
                        preprocessed_path):
    """``KittiEvaluationHook`` on the validation hook with the evaluator
    ``evaluator`` (``KittiEigenEvaluator`` or ``Kitti360Evaluator``)."""
    return edict(
        name="fsnet_tpu_torch.pipeline_hooks.evaluation_hooks."
             "KittiEvaluationHook",
        test_run_hook_cfg=edict(
            name="fsnet_tpu_torch.pipeline_hooks.train_val_hooks."
                 "BaseValidationHook"),
        preprocessed_path=preprocessed_path,
        dataset_eval_cfg=edict(
            name="fsnet_tpu_torch.evaluation.kitti_unsupervised_eval."
                 f"{evaluator}",
            data_path=data_path,
            split_file=split_file,
            gt_saved_file=gt_saved_file,
        ),
    )


def nusc_evaluate_hook(data_path, base_path):
    """``FastNuscEvaluationHook`` on the validation hook with
    ``NuscenesEvaluator``: the nuScenes train subset's val tokens and its
    ground-truth depth PNGs under ``<base_path>/meta_data/nusc_trainsub``."""
    sub = os.path.join(base_path, "meta_data", "nusc_trainsub")
    return edict(
        name="fsnet_tpu_torch.pipeline_hooks.evaluation_hooks."
             "FastNuscEvaluationHook",
        test_run_hook_cfg=edict(
            name="fsnet_tpu_torch.pipeline_hooks.train_val_hooks."
                 "BaseValidationHook"),
        dataset_eval_cfg=edict(
            name="fsnet_tpu_torch.evaluation.nuscenes_unsupervised_eval."
                 "NuscenesEvaluator",
            data_path=data_path,
            split_file=os.path.join(sub, "nusc_val.txt"),
            gt_saved_dir=os.path.join(sub, "samples_depth_gt"),
        ),
    )


# cv2.calcOpticalFlowFarneback's settings in OpenCV's documented example
FARNEBACK_EXAMPLE = edict(pyr_scale=0.5, levels=3, winsize=15, iterations=3,
                          poly_n=5, poly_sigma=1.2, flags=0)


def motion_mask_hook(dataset_cfg, rgb_shape, output_dir,
                     distance_threshold=5.0):
    """``MotionMaskPrecomputeHook`` (the flow at :data:`FARNEBACK_EXAMPLE`)
    over ``dataset_cfg`` (a training dataset's config, its ``frame_idxs``
    included) with a resize-only augmentation to ``rgb_shape`` (frames 0
    and 1 and ``P2``), so that the masks have the training frame's size;
    the masks go to ``output_dir``. Other flow settings: edit the returned
    dict's ``flow_estimator_cfg``."""
    h, w = rgb_shape[0], rgb_shape[1]
    return edict(
        name="fsnet_tpu_torch.pipeline_hooks.precompute_hooks."
             "MotionMaskPrecomputeHook",
        train_dataset_cfg=edict(dataset_cfg, augmentation=edict(
            name=f"{BUILDER}.Sequential",
            cfg_list=[
                edict(name=f"{AUG}.ConvertToFloat"),
                edict(name=f"{AUG}.Resize", size=(h, w),
                      preserve_aspect_ratio=False, calib_keys=["P2"]),
            ],
            image_keys=[("image", 0), ("image", 1)])),
        flow_estimator_cfg=edict(FARNEBACK_EXAMPLE),
        distance_threshold=distance_threshold,
        output_dir=output_dir,
    )
