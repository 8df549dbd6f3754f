"""MonoDepth meta-architectures (counterpart of
``fsnet_tpu.models.meta_archs.monodepth2_model``: ``MonoDepthMeta``, the
learned-pose baseline; ``MonoDepthWPose`` with GT poses or GT poses refined
by its residual-pose branch, ``forward_test`` and ``dummy_forward``;
``MonoDepthInference``; and
``DistillWPoseMeta``, the self-distillation student with its frozen
teacher).

Batches are string-keyed (``'image/0'``, ``'P2'``) and decoded to the
reference's tuple-key protocol at entry. Images are NHWC float tensors.

A model is built on ``device``, a CUDA device unless the caller asks for the
CPU, and raises when CUDA is asked for and absent. Its random weights come
from a ``torch.Generator`` seeded with ``seed``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ...ops.geometry import _mat_dtype, transformation_from_parameters
from ...utils.builder import build
from ...utils.device import DeviceLike, resolve_device
from ...utils.keys import decode_batch
from ..blocks import init_params
from .base_meta import BaseMetaArch


def _decode(data: Dict) -> Dict:
    """String-keyed batch -> tuple-key protocol dict."""
    if any("/" in k for k in data if isinstance(k, str)):
        return decode_batch(data)
    return dict(data)


def _place(module: nn.Module, device: Optional[DeviceLike],
           seed: int) -> None:
    """Seeded random weights, then ``device``; nothing for ``device=None``,
    a submodule that the model holding it places."""
    if device is None:
        return
    dev = resolve_device(device)
    init_params(module, torch.Generator().manual_seed(seed))
    module.to(dev)


class MonoDepthMeta(BaseMetaArch):
    """monodepth2 baseline: the depth net on frame 0 and a pose net on each
    (source, target) frame pair; the head warps with the predicted poses,
    so the loss takes the grid route and its gradients reach the pose net
    through the grid."""

    def __init__(self, depth_backbone_cfg: Dict, pose_backbone_cfg: Dict,
                 head_cfg: Dict, train_cfg: Dict,
                 test_cfg: Optional[Dict] = None, device: DeviceLike = "cuda",
                 seed: int = 0):
        super().__init__()
        self.train_cfg = dict(train_cfg)
        self.test_cfg = dict(test_cfg or {})
        self.depth_backbone = build(**dict(depth_backbone_cfg))
        self.pose_backbone = build(**dict(pose_backbone_cfg))
        self.head = build(frame_ids=tuple(self.train_cfg["frame_ids"]),
                          **dict(head_cfg))
        _place(self, device, seed)

    def forward_train(self, data: Dict, meta: Dict,
                      noise: Optional[torch.Tensor] = None) -> Dict:
        """Depth forward (without ``P2``, as the reference does) and, per
        source frame in order, the pose net in train mode on
        ``cat([f, 0])`` for f < 0, else ``cat([0, f])``: its BN running
        statistics take one update per frame. Then the head's loss."""
        data = _decode(data)
        features = self.depth_backbone(data[("image", 0)], train=True)
        outputs = self.head.forward_depth(features, train=True)
        for f_i in self.train_cfg["frame_ids"][1:]:
            pair = ([data[("image", f_i)], data[("image", 0)]] if f_i < 0
                    else [data[("image", 0)], data[("image", f_i)]])
            pose_feats = [self.pose_backbone(torch.cat(pair, dim=-1),
                                             train=True)]
            axisangle, translation = self.head.forward_pose(pose_feats)
            outputs[("axisangle", f_i)] = axisangle
            outputs[("translation", f_i)] = translation
            outputs[("cam_T_cam", f_i)] = transformation_from_parameters(
                axisangle[:, 0], translation[:, 0], invert=f_i < 0)
        return self.head.loss(outputs, data, noise=noise)

    def forward_test(self, data: Dict, meta: Dict) -> Dict:
        data = _decode(data)
        features = self.depth_backbone(data[("image", 0)], train=False)
        outputs = self.head.forward_depth(features, train=False)
        return self.head.get_prediction(data, outputs)

    def dummy_forward(self, image: torch.Tensor) -> Dict:
        features = self.depth_backbone(image, train=False)
        outputs = self.head.forward_depth(features, train=False)
        return self.head.get_prediction(None, outputs)


class MonoDepthWPose(BaseMetaArch):
    """"Full-scale" flagship: dataset GT relative poses drive the warp in
    training; at test time a depth backbone + the head's depth decoder.
    With ``pose_backbone_cfg`` the residual-pose branch refines each GT
    pose by the pose net's residual, its translation rescaled to the GT
    norm (``fsnet_tpu/models/meta_archs/monodepth2_model.py:98-160``)."""

    def __init__(self, depth_backbone_cfg: Dict, head_cfg: Dict,
                 train_cfg: Dict, test_cfg: Optional[Dict] = None,
                 pose_backbone_cfg: Optional[Dict] = None,
                 device: DeviceLike = "cuda", seed: int = 0):
        super().__init__()
        self.train_cfg = dict(train_cfg)
        self.test_cfg = dict(test_cfg or {})
        self.depth_backbone = build(**dict(depth_backbone_cfg))
        self.head = build(frame_ids=tuple(self.train_cfg["frame_ids"]),
                          **dict(head_cfg))
        self.is_use_res_pose = pose_backbone_cfg is not None
        if self.is_use_res_pose:
            self.pose_backbone = build(**dict(pose_backbone_cfg))
        _place(self, device, seed)

    def _residual_poses(self, data: Dict, outputs: Dict) -> None:
        """Per source frame, the pose net in train mode on the ordered pair
        (``cat([f, 0])`` for f < 0, else ``cat([0, f])``), its residual
        composed after the GT pose, ``rel @ T(axisangle, translation)``
        (inverted for f < 0), and the translation rescaled to the GT
        translation's norm per sample, as the JAX package does (the
        reference reduces the norm over the batch, a latent bug JAX
        notes). The head's ``forward_pose`` takes the base pose (the GT
        pose, inverted for f > 0) and leaves it unused, as in both."""
        for f_i in self.train_cfg["frame_ids"][1:]:
            rel = data[("relative_pose", f_i)]
            if f_i < 0:
                pair, base_pose = [data[("image", f_i)],
                                   data[("image", 0)]], rel
            else:
                pair = [data[("image", 0)], data[("image", f_i)]]
                base_pose = torch.linalg.inv(rel.to(_mat_dtype(rel.dtype)))
            pose_feats = [self.pose_backbone(torch.cat(pair, dim=-1),
                                             train=True)]
            axisangle, translation = self.head.forward_pose(pose_feats,
                                                            base_pose)
            outputs[("axisangle", f_i)] = axisangle
            outputs[("translation", f_i)] = translation
            T = torch.matmul(rel, transformation_from_parameters(
                axisangle[:, 0], translation[:, 0], invert=f_i < 0))
            gt_norm = torch.linalg.vector_norm(rel[:, :3, 3], dim=-1)
            t = T[:, :3, 3]
            ratio = torch.linalg.vector_norm(t, dim=-1) / (gt_norm + 1e-12)
            top = torch.cat([T[:, :3, :3], (t / ratio[:, None])[..., None]],
                            dim=2)
            outputs[("cam_T_cam", f_i)] = torch.cat([top, T[:, 3:]], dim=1)

    def forward_train(self, data: Dict, meta: Dict,
                      noise: Optional[torch.Tensor] = None) -> Dict:
        """Depth forward in train mode (BN batch statistics, running
        statistics updated), then the head's loss with the dataset's GT
        relative poses as the warp poses. ``noise``: the identity tie-break
        noise of the head's loss, or None."""
        data = _decode(data)
        outputs: Dict = {}
        for f_i in self.train_cfg.get("depth_production_frames", [0]):
            features = self.depth_backbone(data[("image", 0)], train=True)
            output_f_i = self.head.forward_depth(features, data["P2"],
                                                 train=True)
            if f_i == 0:
                outputs.update(output_f_i)
            else:
                # reference quirk kept: re-keys the frame-0 depths
                for key in output_f_i:
                    if key[0] == "depth":
                        outputs[(f"depth_{f_i}", key[1], key[2])] = \
                            outputs[key]
        if self.is_use_res_pose:
            # learned residuals: the poses carry gradients, so the head
            # takes its grid route
            self._residual_poses(data, outputs)
        else:
            for f_i in self.train_cfg["frame_ids"][1:]:
                outputs[("cam_T_cam", f_i)] = data[("relative_pose", f_i)]
            # every warp pose is a dataset constant: the head may take the
            # depth-direct warp
            outputs["pose_is_const"] = True
        return self.head.loss(outputs, data, noise=noise)

    def forward_test(self, data: Dict, meta: Dict) -> Dict:
        data = _decode(data)
        features = self.depth_backbone(data[("image", 0)], train=False)
        outputs = self.head.forward_depth(features, data["P2"], train=False)
        return self.head.get_prediction(data, outputs)

    def dummy_forward(self, image: torch.Tensor) -> Dict:
        features = self.depth_backbone(image, train=False)
        outputs = self.head.forward_depth(features, train=False)
        return self.head.get_prediction(None, outputs)


class MonoDepthInference(nn.Module):
    """Inference-only backbone + decoder (the distillation teacher). Its BN
    always runs on the running statistics. ``device=None`` leaves it
    unplaced, as a submodule of a model that places it."""

    def __init__(self, backbone_cfg: Dict, depth_head_cfg: Dict,
                 is_produce_detached: bool = True,
                 device: Optional[DeviceLike] = "cuda", seed: int = 0):
        super().__init__()
        self.is_produce_detached = is_produce_detached
        self.depth_backbone = build(**dict(backbone_cfg))
        self.depth_decoder = build(**dict(depth_head_cfg))
        _place(self, device, seed)

    def forward(self, x: torch.Tensor, train: bool = False) -> Dict:
        features = self.depth_backbone(x, train=False)
        return self.depth_decoder(features, train=False)

    def compute_teacher_depth(self, x: torch.Tensor) -> Dict:
        output_dict = self(x)
        teacher_output = {}
        for key in output_dict:
            if key[0] == "depth":
                value = output_dict[key]
                if self.is_produce_detached:
                    value = value.detach()
                teacher_output[("teacher_depth", key[1], key[2])] = value
        return teacher_output


class DistillWPoseMeta(BaseMetaArch):
    """Self-distillation: a frozen ``MonoDepthInference`` teacher's depth
    beside the student's, GT poses for the warp (the student's loss takes
    the route ``MonoDepthWPose``'s would). The teacher is built unplaced and
    initialised with the rest of the model, in module order (teacher,
    student backbone, head), before any teacher weights are grafted in
    (:func:`fsnet_tpu_torch.runtime.checkpoint.load_teacher_into_params`);
    the optimizer leaves it out
    (:func:`fsnet_tpu_torch.runtime.optim.frozen_param_prefixes`).
    ``teacher_net_path`` is kept for the config's sake; nothing here reads
    it."""

    def __init__(self, teacher_net_cfg: Dict, depth_backbone_cfg: Dict,
                 head_cfg: Dict, train_cfg: Dict,
                 test_cfg: Optional[Dict] = None, teacher_net_path: str = "",
                 device: DeviceLike = "cuda", seed: int = 0):
        super().__init__()
        self.train_cfg = dict(train_cfg)
        self.test_cfg = dict(test_cfg or {})
        self.teacher_net_path = teacher_net_path
        self.teacher_net = build(**dict(teacher_net_cfg), device=None)
        self.depth_backbone = build(**dict(depth_backbone_cfg))
        self.head = build(frame_ids=tuple(self.train_cfg["frame_ids"]),
                          **dict(head_cfg))
        _place(self, device, seed)

    def forward_train(self, data: Dict, meta: Dict,
                      noise: Optional[torch.Tensor] = None) -> Dict:
        """The student's depth in train mode (with ``P2``), the teacher's
        depth of frame 0 (BN on its running statistics; without autograd
        where the teacher produces detached depth, which gives the numbers
        ``.detach()`` would), then the head's loss with the dataset's GT
        relative poses as the warp poses. In the bf16 step the teacher runs,
        as the student does, on the step's bfloat16 copies of its
        parameters, its eval-mode BN reading its float32 statistics rounded
        to bfloat16 (flax on JAX's cast tree); its parameters and statistics
        are never written."""
        data = _decode(data)
        image_0 = data[("image", 0)]
        features = self.depth_backbone(image_0, train=True)
        outputs = self.head.forward_depth(features, data["P2"], train=True)
        with torch.set_grad_enabled(
                torch.is_grad_enabled()
                and not self.teacher_net.is_produce_detached):
            outputs.update(self.teacher_net.compute_teacher_depth(image_0))
        for f_i in self.train_cfg["frame_ids"][1:]:
            outputs[("cam_T_cam", f_i)] = data[("relative_pose", f_i)]
        outputs["pose_is_const"] = True
        return self.head.loss(outputs, data, noise=noise)

    def forward_test(self, data: Dict, meta: Dict) -> Dict:
        data = _decode(data)
        features = self.depth_backbone(data[("image", 0)], train=False)
        outputs = self.head.forward_depth(features, data["P2"], train=False)
        return self.head.get_prediction(data, outputs)

    def dummy_forward(self, image: torch.Tensor) -> Dict:
        features = self.depth_backbone(image, train=False)
        outputs = self.head.forward_depth(features, train=False)
        return self.head.get_prediction(None, outputs)
