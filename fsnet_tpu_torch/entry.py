"""The flagship depth model of the port, its learned-pose baseline, the
KITTI-360 fisheye model, its export-style forward, the synthetic training
batches and the training recipe's optimizer (counterpart of
``__graft_entry__._flagship_model``, ``_synthetic_batch``, ``entry()``, the
optimizer of ``bench.py`` and the fisheye batch of
``scripts/tpu_fisheye_bench.py``).

The flagship's configuration is the JAX flagship's with ``fsnet_tpu_torch``
names: a ResNet-18 encoder with ``out_indices=(-1, 0, 1, 2, 3)`` and a
``MultiChannelDepthDecoder`` with 16 bins, scales 0-3 and depth 0.5-100,
under ``MonoDepthWPose``. The learned-pose baseline is ``MonoDepthMeta``
with the same depth net, a ResNet-18 pose encoder over frame pairs (six
input channels) and a ``PoseDecoder`` for two frames. The fisheye model is
the flagship with the ``FishEyeDecoder`` head of
``configs/kitti360_fisheye_example.py`` (depth 0.1-150, band 16), which
trains with :data:`FISHEYE_RECIPE`. All are built through the builder.
The DLA model is ``dlanet(34)`` under ``DLASegUpsample`` (the composition
of ``tests/test_backbones.py:114-125``), trained on the sum of its output
weighted by a seeded tensor.

The nuScenes recipes (bs8 @288x512, the nuScenes patched mask, so the loss
takes the grid route) are copies of two shipped configs' ``meta_arch``:
``configs/nusc_wpose_example.py`` (:func:`nusc_config`: ResNet-34, 64
bins, ``base_fx=369``, no overlap mask) and
``configs/distill_nusc_example.py`` (:func:`distill_config`: a frozen
ResNet-18/16-bin teacher beside a student with the uncertain decoder),
with ``pretrained`` off and no teacher path: the ImageNet weights and the
trained teacher are not in the repo, so weights are seeded or grafted from
a state_dict. Both train with :data:`NUSC_RECIPE`.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .models.backbones.dla_utils import ModulatedDeformConvPack
from .models.blocks import init_params
from .models.meta_archs.base_meta import BaseMetaArch
from .utils.builder import build
from .utils.device import DeviceLike, resolve_device
from .utils.keys import encode_batch


def flagship_config(height: int, width: int) -> Dict:
    return dict(
        name="fsnet_tpu_torch.models.meta_archs.monodepth2_model.MonoDepthWPose",
        depth_backbone_cfg=dict(
            name="fsnet_tpu_torch.models.backbones.resnet.resnet",
            depth=18, num_stages=4, out_indices=(-1, 0, 1, 2, 3),
            norm_eval=False, dilations=(1, 1, 1, 1),
        ),
        head_cfg=dict(
            name="fsnet_tpu_torch.models.heads.monodepth2_decoder.MonoDepth2Decoder",
            scales=(0, 1, 2, 3), height=height, width=width,
            min_depth=0.5, max_depth=100.0, is_log_image=False,
            overlapped_mask=True,
            depth_decoder_cfg=dict(
                name="fsnet_tpu_torch.models.heads.depth_decoder.MultiChannelDepthDecoder",
                num_output_channels=16, use_skips=True, scales=(0, 1, 2, 3),
                min_depth=0.5, max_depth=100.0,
            ),
        ),
        train_cfg=dict(frame_ids=(0, 1, -1)),
        test_cfg=dict(),
    )


def flagship_model(height: int, width: int, device: DeviceLike = "cuda",
                   seed: int = 0):
    """The flagship ``MonoDepthWPose`` with seeded random weights on
    ``device``."""
    return build(**flagship_config(height, width), device=device, seed=seed)


def learned_pose_config(height: int, width: int) -> Dict:
    """``MonoDepthMeta``: the flagship's depth net and head, with a
    ResNet-18 pose encoder over the concatenated frame pairs (BN in train
    mode) and ``PoseDecoder(num_ch_enc=(64, 64, 128, 256, 512),
    num_input_features=1, num_frames_to_predict_for=2)``."""
    cfg = flagship_config(height, width)
    cfg["name"] = \
        "fsnet_tpu_torch.models.meta_archs.monodepth2_model.MonoDepthMeta"
    cfg["pose_backbone_cfg"] = dict(
        name="fsnet_tpu_torch.models.backbones.resnet.resnet",
        depth=18, num_stages=4, out_indices=(-1, 0, 1, 2, 3),
        norm_eval=False, dilations=(1, 1, 1, 1), num_input_images=2,
    )
    cfg["head_cfg"]["pose_decoder_cfg"] = dict(
        name="fsnet_tpu_torch.models.heads.pose_decoder.PoseDecoder",
        num_ch_enc=(64, 64, 128, 256, 512), num_input_features=1,
        num_frames_to_predict_for=2,
    )
    return cfg


def learned_pose_model(height: int, width: int, device: DeviceLike = "cuda",
                       seed: int = 0):
    """The learned-pose ``MonoDepthMeta`` with seeded random weights on
    ``device``."""
    return build(**learned_pose_config(height, width), device=device,
                 seed=seed)


def fisheye_config(height: int, width: int) -> Dict:
    """``MonoDepthWPose`` of ``configs/kitti360_fisheye_example.py``
    (``configs/common.py:102-142``): the flagship's ResNet-18 and 16-bin
    ``MultiChannelDepthDecoder`` under the Mei-camera ``FishEyeDecoder``,
    depth 0.1-150, overlap mask, no image logging. The head's band is its
    default, 16."""
    cfg = flagship_config(height, width)
    head = cfg["head_cfg"]
    head["name"] = \
        "fsnet_tpu_torch.models.heads.fisheye_decoder.FishEyeDecoder"
    head["min_depth"], head["max_depth"] = 0.1, 150.0
    head["depth_decoder_cfg"].update(min_depth=0.1, max_depth=150.0)
    return cfg


def fisheye_model(height: int, width: int, device: DeviceLike = "cuda",
                  seed: int = 0):
    """The fisheye ``MonoDepthWPose`` with seeded random weights on
    ``device``."""
    return build(**fisheye_config(height, width), device=device, seed=seed)


def entry(device: DeviceLike = "cuda") -> Tuple[Callable, Tuple[torch.Tensor]]:
    """(fn, example_args): single-image depth forward (``dummy_forward``) at
    the KITTI training resolution, 192x640."""
    dev = resolve_device(device)
    height, width = 192, 640
    model = flagship_model(height, width, device=dev)
    image = torch.zeros((1, height, width, 3), device=dev)

    def fn(image: torch.Tensor) -> Dict:
        with torch.inference_mode():
            return model.dummy_forward(image)

    return fn, (image,)


def synthetic_batch(batch: int, height: int, width: int,
                    patched_mask: Optional[str] = None) -> Dict:
    """KITTI-like synthetic training batch, string-keyed numpy arrays (the
    numbers of ``__graft_entry__._synthetic_batch``, from the same
    ``RandomState(0)``): small random rotations (+-0.3 deg), forward/back
    translation tz of 0.55-0.8 m, and spatially correlated textures
    (bicubic-upsampled low-frequency noise) in [0, 1].

    ``patched_mask`` adds the mask every dataset puts in its samples, as
    float64 [batch, height, width], after all random draws: ``"ones"``
    (``mono_dataset.py:105``) or ``"nuscenes"``, with the bottom 2/9 of the
    rows zeroed (the ego body of ``CAM_BACK``, rows 700-899 of 900 in
    ``nuscene_dataset.py:216-220``). With a mask the flagship's loss takes
    the grid route, as it does on every dataset."""
    from scipy.ndimage import zoom

    rng = np.random.RandomState(0)
    P2 = np.zeros((batch, 3, 4), np.float32)
    P2[:, 0, 0] = P2[:, 1, 1] = 0.58 * width
    P2[:, 0, 2] = width / 2
    P2[:, 1, 2] = height / 2
    P2[:, 2, 2] = 1.0

    def pose(direction):
        out = np.tile(np.eye(4, dtype=np.float32), (batch, 1, 1))
        for b in range(batch):
            w = np.deg2rad(rng.uniform(-0.3, 0.3, 3)).astype(np.float32)
            th = float(np.linalg.norm(w)) + 1e-12
            k = w / th
            K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]],
                          [-k[1], k[0], 0]], np.float32)
            out[b, :3, :3] = (np.eye(3, dtype=np.float32) + np.sin(th) * K
                              + (1 - np.cos(th)) * (K @ K))
            out[b, :3, 3] = [rng.uniform(-0.05, 0.05),
                             rng.uniform(-0.02, 0.02),
                             direction * rng.uniform(0.55, 0.8)]
        return out

    def img():
        lo = rng.rand(batch, max(height // 16, 2), max(width // 16, 2), 3)
        up = zoom(lo, (1, height / lo.shape[1], width / lo.shape[2], 1),
                  order=3, grid_mode=True, mode="nearest")
        return np.clip(up, 0.0, 1.0).astype(np.float32)

    data = {
        ("image", 0): img(), ("image", 1): img(), ("image", -1): img(),
        ("original_image", 0): img(), ("original_image", 1): img(),
        ("original_image", -1): img(),
        ("relative_pose", 1): pose(+1), ("relative_pose", -1): pose(-1),
        "P2": P2,
    }
    if patched_mask is not None:
        mask = np.ones((batch, height, width))
        if patched_mask == "nuscenes":
            mask[:, height - (2 * height) // 9:] = 0.0
        elif patched_mask != "ones":
            raise ValueError(f"patched_mask {patched_mask!r}: None, 'ones' "
                             "or 'nuscenes'")
        data["patched_mask"] = mask
    return encode_batch(data)


def fisheye_batch(batch: int, height: int, width: int) -> Dict:
    """KITTI-360-like fisheye training batch, string-keyed numpy arrays (the
    numbers of ``scripts/tpu_fisheye_bench.py:31-66``, from the same
    ``RandomState(0)``): a Mei camera with (xi, k1, k2) = (2.2, 0.2, 0.1)
    and focal 1.3 W, side-camera motion (forward translation of 0.55-0.8 m
    along x, +-0.3 deg rotations), one pose for both source frames, the
    camera's backtracked ray map (``'fisheye_rays'`` [B, H, W, 4]),
    ``'fisheye_params'`` [B, 3], white-noise images in [0, 1) and an
    all-ones ``patched_mask``."""
    from scipy.spatial.transform import Rotation

    from .ops.fisheye import MeiCameraProjection

    xi, k1, k2 = 2.2, 0.2, 0.1
    H, W = height, width
    P_np = np.zeros((3, 4), np.float32)
    P_np[0, 0] = P_np[1, 1] = 1.3 * W
    P_np[0, 2], P_np[1, 2], P_np[2, 2] = W / 2.0, H / 2.0, 1.0
    rng = np.random.RandomState(0)
    P = np.tile(P_np[None], (batch, 1, 1))
    pose = np.tile(np.eye(4, dtype=np.float32), (batch, 1, 1))
    for b in range(batch):
        pose[b, :3, :3] = Rotation.from_euler(
            "xyz", rng.uniform(-0.3, 0.3, 3), degrees=True).as_matrix()
        pose[b, :3, 3] = [rng.uniform(0.55, 0.8), rng.uniform(-0.02, 0.02),
                          rng.uniform(-0.05, 0.05)]
    X, Y, Z, mask = MeiCameraProjection().get_ray_map(
        H, W, P_np, {"mirror_parameters": {"xi": xi},
                     "distortion_parameters": {"k1": k1, "k2": k2}})
    rays = np.stack([X[0], Y[0], Z[0], mask[0]], axis=-1)

    def img():
        return rng.rand(batch, H, W, 3).astype(np.float32)

    data = {
        ("image", 0): img(), ("image", 1): img(), ("image", -1): img(),
        ("original_image", 0): img(), ("original_image", 1): img(),
        ("original_image", -1): img(),
        ("relative_pose", 1): pose, ("relative_pose", -1): pose.copy(),
        "P2": P.astype(np.float32),
        "fisheye_rays": np.tile(rays[None], (batch, 1, 1, 1)).astype(
            np.float32),
        "fisheye_params": np.tile(np.array([[xi, k1, k2]], np.float32),
                                  (batch, 1)),
        "patched_mask": np.ones((batch, H, W), np.float32),
    }
    return encode_batch(data)


# the training recipe of bench.py, the KITTI-360 fisheye config's (the
# optimizer, scheduler and trainer.clip_gradients of
# configs/kitti360_fisheye_example.py) and the nuScenes configs' (those of
# configs/nusc_wpose_example.py and configs/distill_nusc_example.py); the
# compute_dtype of each is every shipped config's training hook's
# (configs/common.py:163, through trainer_section) and bench.py's: the bf16
# step of make_train_step(device, compute_dtype=recipe["compute_dtype"])
FLAGSHIP_RECIPE = dict(optimizer=dict(name="adam", lr=1e-4),
                       scheduler=dict(name="StepLR", step_size=8),
                       clip_gradients=1.0, compute_dtype="bfloat16")
FISHEYE_RECIPE = dict(optimizer=dict(name="adam", lr=1e-4,
                                     weight_decay=1e-5),
                      scheduler=dict(name="StepLR", step_size=8),
                      clip_gradients=1.0, compute_dtype="bfloat16")
NUSC_RECIPE = dict(optimizer=dict(name="adam", lr=1e-4, weight_decay=0),
                   scheduler=dict(name="StepLR", step_size=4),
                   clip_gradients=1.0, compute_dtype="bfloat16")


def recipe_optimizer(model: torch.nn.Module, recipe: Dict,
                     meta_arch_cfg: Optional[Dict] = None,
                     steps_per_epoch: int = 1000):
    """A recipe's optimizer (``recipe``: ``optimizer``, ``scheduler`` and
    ``clip_gradients`` as in a config) over ``model``'s parameters, less
    those that ``meta_arch_cfg`` freezes (the distillation teacher, frozen
    backbone stages), whose ``requires_grad`` is turned off. Returns
    (optimizer, schedule)."""
    from .runtime.optim import (build_frozen_mask, build_optimizer,
                                frozen_param_prefixes, trainable_params)

    mask = build_frozen_mask(model, frozen_param_prefixes(meta_arch_cfg or {}))
    return build_optimizer(trainable_params(model, mask),
                           dict(recipe["optimizer"]), recipe.get("scheduler"),
                           steps_per_epoch=steps_per_epoch,
                           clip_gradients=recipe.get("clip_gradients"))


def flagship_optimizer(model: torch.nn.Module, steps_per_epoch: int = 1000):
    """The training recipe of ``bench.py``: Adam (lr 1e-4), global-norm
    clip 1.0, StepLR with step_size 8, over all of ``model``'s
    parameters. Returns (optimizer, schedule)."""
    return recipe_optimizer(model, FLAGSHIP_RECIPE,
                            steps_per_epoch=steps_per_epoch)


NUSC_BATCH, NUSC_HEIGHT, NUSC_WIDTH = 8, 288, 512
_PKG = "fsnet_tpu_torch.models."


def _resnet_cfg(depth: int) -> Dict:
    return dict(name=_PKG + "backbones.resnet.resnet", depth=depth,
                pretrained=False, frozen_stages=-1, num_stages=4,
                out_indices=(-1, 0, 1, 2, 3), norm_eval=False,
                dilations=(1, 1, 1, 1))


def _decoder_cfg(name: str, bins: int, **extra) -> Dict:
    return dict(name=_PKG + "heads.depth_decoder." + name,
                num_ch_enc=(64, 64, 128, 256, 512), num_output_channels=bins,
                use_skips=True, scales=(0, 1, 2, 3), min_depth=0.5,
                max_depth=100, **extra)


def _head_cfg(height: int, width: int, overlapped_mask: bool,
              depth_decoder_cfg: Dict, **extra) -> Dict:
    return dict(name=_PKG + "heads.monodepth2_decoder.MonoDepth2Decoder",
                scales=(0, 1, 2, 3), height=height, width=width,
                min_depth=0.5, max_depth=100.0, is_log_image=False,
                overlapped_mask=overlapped_mask,
                depth_decoder_cfg=depth_decoder_cfg, **extra)


def nusc_config(height: int = NUSC_HEIGHT, width: int = NUSC_WIDTH) -> Dict:
    """``MonoDepthWPose`` of ``configs/nusc_wpose_example.py``
    (``configs/common.py:wpose_meta_arch`` with ResNet-34, depth 0.5-100,
    ``base_fx=369``, 64 bins, ``overlapped_mask=False``)."""
    dec = _decoder_cfg("MultiChannelDepthDecoder", 64)
    dec["max_depth"], dec["base_fx"] = 100.0, 369
    return dict(
        name=_PKG + "meta_archs.monodepth2_model.MonoDepthWPose",
        depth_backbone_cfg=_resnet_cfg(34),
        head_cfg=_head_cfg(height, width, False, dec),
        train_cfg=dict(frame_ids=(0, 1, -1)), test_cfg=dict())


def nusc_model(height: int = NUSC_HEIGHT, width: int = NUSC_WIDTH,
               device: DeviceLike = "cuda", seed: int = 0):
    """The nuScenes ``MonoDepthWPose`` with seeded random weights on
    ``device``."""
    return build(**nusc_config(height, width), device=device, seed=seed)


def nusc_batch(batch: int = NUSC_BATCH, height: int = NUSC_HEIGHT,
               width: int = NUSC_WIDTH) -> Dict:
    """The synthetic batch with the nuScenes ``CAM_BACK`` patched mask
    (:func:`synthetic_batch`, ``"nuscenes"``)."""
    return synthetic_batch(batch, height, width, patched_mask="nuscenes")


def distill_config(height: int = NUSC_HEIGHT,
                   width: int = NUSC_WIDTH) -> Dict:
    """``DistillWPoseMeta`` of ``configs/distill_nusc_example.py``: a
    ``MonoDepthInference`` teacher (ResNet-18, 16-bin
    ``MultiChannelDepthDecoder``), a ResNet-18 student under the head with
    the overlap mask, ``distillation_loss_weight=0.3`` and
    ``is_uncertain_distill``, decoding through
    ``MultiChannelDepthDecoderUncertain`` (16 bins)."""
    return dict(
        name=_PKG + "meta_archs.monodepth2_model.DistillWPoseMeta",
        teacher_net_cfg=dict(
            name=_PKG + "meta_archs.monodepth2_model.MonoDepthInference",
            backbone_cfg=_resnet_cfg(18),
            depth_head_cfg=_decoder_cfg("MultiChannelDepthDecoder", 16)),
        teacher_net_path="",
        depth_backbone_cfg=_resnet_cfg(18),
        head_cfg=_head_cfg(
            height, width, True,
            _decoder_cfg("MultiChannelDepthDecoderUncertain", 16),
            distillation_loss_weight=0.3, is_uncertain_distill=True),
        train_cfg=dict(frame_ids=(0, 1, -1)), test_cfg=dict())


def distill_model(height: int = NUSC_HEIGHT, width: int = NUSC_WIDTH,
                  device: DeviceLike = "cuda", seed: int = 0,
                  teacher_state: Optional[Dict] = None):
    """The nuScenes ``DistillWPoseMeta`` with seeded random weights on
    ``device``; with ``teacher_state``, the state_dict of a trained
    ``MonoDepthWPose`` whose depth net is the teacher's (ResNet-18, 16 bins,
    as :func:`flagship_model`'s), its teacher grafted from that
    (:func:`fsnet_tpu_torch.runtime.checkpoint.graft_teacher`). Train it
    with ``recipe_optimizer(model, NUSC_RECIPE, distill_config())``, which
    freezes the teacher."""
    from .runtime.checkpoint import graft_teacher

    model = build(**distill_config(height, width), device=device, seed=seed)
    if teacher_state is not None:
        graft_teacher(model, teacher_state)
    return model


DLA_CHANNELS = (16, 32, 64, 128, 256, 512)


class DLAUpsampleNet(BaseMetaArch):
    """A DLA trunk under ``DLASegUpsample`` (NHWC image in, the head's map at
    1/``down_ratio`` resolution out). Training minimises
    ``sum(out * batch['target_weight'])`` with BN in train mode; serving
    returns ``{'features': out}``."""

    def __init__(self, trunk_cfg: Dict, head_cfg: Dict):
        super().__init__()
        self.trunk = build(**dict(trunk_cfg))
        self.head = build(**dict(head_cfg))

    def dummy_forward(self, image: torch.Tensor,
                      train: bool = False) -> torch.Tensor:
        return self.head(self.trunk(image, train=train), train=train)

    def forward_train(self, data: Dict, meta: Dict,
                      noise: Optional[torch.Tensor] = None) -> Dict:
        out = self.dummy_forward(data["image/0"], train=True)
        return dict(loss=(out * data["target_weight"]).sum(), loss_dict={})

    def forward_test(self, data: Dict, meta: Dict) -> Dict:
        return dict(features=self.dummy_forward(data["image/0"]))


def dla_config(norm_frozen: bool = False) -> Dict:
    """``dlanet(34, out_indices=(0, ..., 5))`` and
    ``DLASegUpsample(input_channels=(16, 32, 64, 128, 256, 512),
    down_ratio=4, last_level=5)``: 16 deformable convs, all 3x3, stride 1,
    band 8, zeros padding. ``norm_frozen`` keeps every BN on its running
    statistics in training too (the trunk's ``norm_eval``, the head's
    ``norm_frozen``)."""
    return dict(
        trunk_cfg=dict(name="fsnet_tpu_torch.models.backbones.dla.dlanet",
                       depth=34, out_indices=(0, 1, 2, 3, 4, 5),
                       norm_eval=norm_frozen),
        head_cfg=dict(
            name="fsnet_tpu_torch.models.backbones.dla_utils.DLASegUpsample",
            input_channels=DLA_CHANNELS, down_ratio=4, last_level=5,
            norm_frozen=norm_frozen),
    )


def perturb_offsets(model: torch.nn.Module, std: float, seed: int) -> None:
    """Overwrite the kernel of every deformable conv's ``conv_offset`` (in
    module order) with numpy ``RandomState(seed)`` normals scaled by
    ``std / sqrt(fan_in)``: the offset conv is zero at init, so every DCN
    would be a plain conv at integer positions with masks of 0.5. With
    this, on the DLA's train-mode activations (mean square 0.5 to 1.2), the
    offsets spread by 0.6 to 1.1 ``std`` pixels and the masks move off
    0.5."""
    rng = np.random.RandomState(seed)
    for m in model.modules():
        if isinstance(m, ModulatedDeformConvPack):
            w = m.conv_offset.weight
            scale = std / np.sqrt(w[0].numel())
            with torch.no_grad():
                w.copy_(torch.from_numpy(rng.randn(*w.shape) * scale))


def dla_model(height: int, width: int, device: DeviceLike = "cuda",
              seed: int = 0, offset_std: float = 1.5,
              norm_frozen: bool = False) -> DLAUpsampleNet:
    """The DLA model of :func:`dla_config` with seeded random weights and
    the offset convs perturbed (:func:`perturb_offsets`) on ``device``. The
    size is the batch's; the model takes any input whose sides divide by
    32."""
    dev = resolve_device(device)
    model = DLAUpsampleNet(**dla_config(norm_frozen))
    init_params(model, torch.Generator().manual_seed(seed))
    perturb_offsets(model, offset_std, seed)
    return model.to(dev)


def dla_batch(batch: int, height: int, width: int) -> Dict:
    """The DLA model's batch, float32 numpy from ``RandomState(0)``:
    ``'image/0'`` [batch, height, width, 3] and ``'target_weight'``
    [batch, height/4, width/4, 64] (the loss's weights), both uniform in
    [0, 1)."""
    rng = np.random.RandomState(0)
    return {"image/0": rng.rand(batch, height, width, 3).astype(np.float32),
            "target_weight": rng.rand(batch, height // 4, width // 4,
                                      DLA_CHANNELS[2]).astype(np.float32)}
