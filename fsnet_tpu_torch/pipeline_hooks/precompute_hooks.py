"""Precompute hooks run once before training: epipolar motion masks
(counterpart of ``fsnet_tpu.pipeline_hooks.precompute_hooks``).

For each sample of the training dataset the flow from frame 0 to frame 1
is compared with the epipolar geometry of the sample's relative pose: a
pixel whose flowed position lies farther than ``distance_threshold`` from
its epipolar line moves on its own, and is 1 in the mask. The masks are
written as 8-bit grey PNGs ``{index:08d}.png`` into ``output_dir``, which
the datasets read with ``is_motion_mask=True`` and ``motion_mask_path``.

:class:`MotionMaskPrecomputeHook` computes the flow with the port's own
Farneback (:func:`~fsnet_tpu_torch.ops.optical_flow.farneback`, OpenCV's
method) on ``device``, and skips the indices whose file already exists.
:class:`MotionMaskARFlowPrecomputeHook` takes the dataset's ``flow`` (an
ARFlow file) and ``original_P2``, divides the distance by the flow's norm,
and writes every index. The distance is float64 on ``device``; the PNG
goes through :func:`~fsnet_tpu_torch.data.datasets.image_io.write_png`.
After a call, ``written``, ``skipped`` and ``seconds`` say what the pass
did.
"""
from __future__ import annotations

import os
import time
from typing import Dict

import numpy as np
import torch

from ..data.datasets.image_io import write_png
from ..ops.optical_flow import bgr_to_gray, farneback
from ..utils.builder import build
from ..utils.device import DeviceLike, resolve_device


def skew(T) -> np.ndarray:
    """The cross-product matrix of the 3-vector ``T``."""
    return np.array([
        [0, -T[2], T[1]],
        [T[2], 0, -T[0]],
        [-T[1], T[0], 0],
    ])


class BasePrecomputeHook:
    """A hook that does nothing."""

    def __init__(self, *args, **kwargs):
        pass

    def __call__(self, *args, **kwargs):
        pass


def _epipolar_distance(flow: torch.Tensor, P2, relative_pose
                       ) -> torch.Tensor:
    """[H, W] float64 signed distance of each flowed pixel to the epipolar
    line of its source pixel, on ``flow``'s device; the fundamental matrix
    ``K^-T [T]x R K^-1`` from ``P2`` and the relative pose in float64."""
    H, W = flow.shape[:2]
    dev = flow.device
    P2 = np.asarray(P2, np.float64)
    relative_pose = np.asarray(relative_pose, np.float64)
    K_inv = np.linalg.inv(P2[0:3, 0:3])
    fundamental = (K_inv.T @ skew(relative_pose[0:3, 3])
                   @ relative_pose[0:3, 0:3] @ K_inv)
    gy, gx = torch.meshgrid(
        torch.arange(H, dtype=torch.float64, device=dev),
        torch.arange(W, dtype=torch.float64, device=dev), indexing="ij")
    grid = torch.stack([gx, gy], dim=-1)
    flowed = grid + flow.to(torch.float64)
    ones = torch.ones((H, W, 1), dtype=torch.float64, device=dev)
    homo_grid = torch.cat([grid, ones], dim=-1)
    homo_flowed = torch.cat([flowed, ones], dim=-1)
    F = torch.as_tensor(fundamental, dtype=torch.float64, device=dev)
    corr = (F @ homo_grid.reshape(-1, 3).T).T.reshape(H, W, 3)
    den = torch.sqrt((corr[..., 0:2] * corr[..., 0:2]).sum(dim=-1))
    return (homo_flowed * (corr / den[..., None])).sum(dim=-1)


def _write_mask(path: str, mask: torch.Tensor) -> None:
    write_png(path, mask.to(torch.uint8).cpu().numpy())


class MotionMaskPrecomputeHook(BasePrecomputeHook):
    """Farneback-flow epipolar motion masks of ``train_dataset_cfg``'s
    samples; ``flow_estimator_cfg`` holds ``farneback``'s arguments
    (``cv2.calcOpticalFlowFarneback``'s keywords)."""

    def __init__(self, train_dataset_cfg: Dict, flow_estimator_cfg: Dict,
                 distance_threshold: float = 5.0, output_dir: str = "",
                 device: DeviceLike = "cuda"):
        self.dataset = build(**dict(train_dataset_cfg))
        self.flow_estimator_cfg = dict(flow_estimator_cfg)
        self.distance_threshold = distance_threshold
        self.output_dir = output_dir
        self.device = resolve_device(device)
        self.written = self.skipped = 0
        self.seconds = 0.0

    def gray(self, image) -> torch.Tensor:
        """Frame ``image`` (HxWx3, any numeric type, truncated to uint8 as
        the JAX hook casts it) as a uint8 grey image on the device."""
        img = torch.as_tensor(np.asarray(image)).to(self.device)
        if img.dtype != torch.uint8:
            img = img.to(torch.uint8)
        return bgr_to_gray(img)

    def mask(self, data: Dict) -> torch.Tensor:
        """The [H, W] bool motion mask of one sample."""
        flow = farneback(self.gray(data[("image", 0)]),
                         self.gray(data[("image", 1)]),
                         **self.flow_estimator_cfg)
        distances = _epipolar_distance(flow, data["P2"],
                                       data[("relative_pose", 1)])
        return distances.abs() > self.distance_threshold

    def __call__(self, *args, **kwargs):
        print("Start precomputing motion masks")
        t0 = time.perf_counter()
        os.makedirs(self.output_dir, exist_ok=True)
        self.written = self.skipped = 0
        for index in range(len(self.dataset)):
            target_path = os.path.join(self.output_dir, f"{index:08d}.png")
            if os.path.isfile(target_path):
                self.skipped += 1
                continue
            _write_mask(target_path, self.mask(self.dataset[index]))
            self.written += 1
        self.seconds = time.perf_counter() - t0
        print(f"motion masks: {self.written} written, {self.skipped} "
              f"already there, {self.seconds:.2f} s")


class MotionMaskARFlowPrecomputeHook(MotionMaskPrecomputeHook):
    """Epipolar motion masks from the dataset's precomputed ``flow``, the
    distance divided by the flow's norm; every index written.
    ``flow_estimator_cfg`` is kept for the configs and not read."""

    def mask(self, data: Dict) -> torch.Tensor:
        flow = torch.as_tensor(np.asarray(data["flow"], np.float64),
                               device=self.device)
        flow_norm = torch.sqrt((flow * flow).sum(dim=-1))
        distances = _epipolar_distance(flow, data["original_P2"],
                                       data[("relative_pose", 1)])
        return (distances.abs() / flow_norm.clamp(min=1e-12)
                ) > self.distance_threshold

    def __call__(self, *args, **kwargs):
        print("Start precomputing ARFlow motion masks")
        t0 = time.perf_counter()
        os.makedirs(self.output_dir, exist_ok=True)
        for index in range(len(self.dataset)):
            _write_mask(os.path.join(self.output_dir, f"{index:08d}.png"),
                        self.mask(self.dataset[index]))
        self.written, self.skipped = len(self.dataset), 0
        self.seconds = time.perf_counter() - t0
