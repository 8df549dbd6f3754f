"""Synthetic stand-in dataset with the KITTI sample-dict schema (counterpart
of ``fsnet_tpu.data.datasets.synthetic_dataset``, the same samples bit for
bit).

Images are procedural (textured gradients and blobs that shift with the
frame index, so the photometric loss has structure to latch onto); the
poses are pure x-translations and every sample carries an all-ones
``patched_mask``, as every dataset's samples do.
"""
from __future__ import annotations

from copy import deepcopy
from typing import Dict, Optional, Sequence

import numpy as np

from ...utils.builder import build


class SyntheticMonoDataset:
    """Procedural video-sequence dataset with GT relative poses; sample
    ``i`` depends on ``seed`` and ``i`` only."""

    def __init__(self, length: int = 64, height: int = 192, width: int = 640,
                 frame_idxs: Sequence[int] = (0, 1, -1), seed: int = 0,
                 augmentation: Optional[Dict] = None, with_sparse_depth=False,
                 **kwargs):
        self.length = length
        self.height = height
        self.width = width
        self.frame_idxs = list(frame_idxs)
        self.seed = seed
        self.with_sparse_depth = with_sparse_depth
        self.transform = (build(**augmentation) if augmentation is not None
                          else None)

    def __len__(self) -> int:
        return self.length

    def _render(self, rng: np.random.RandomState, shift: float) -> np.ndarray:
        h, w = self.height, self.width
        u = (np.arange(w, dtype=np.float32) + shift * 40.0)[None, :]
        v = np.arange(h, dtype=np.float32)[:, None]
        r = 127 + 80 * np.sin(u / 23.0) * np.cos(v / 17.0)
        g = 127 + 80 * np.sin(u / 41.0 + 1.0) + 0.0 * v
        b = 127 + 80 * np.cos(v / 29.0 + u / 53.0)
        img = np.stack([r, g, b], axis=-1)
        # a few textured blobs at stable (per-sample) locations
        for _ in range(4):
            cy, cx = (rng.randint(h // 8, 7 * h // 8),
                      rng.randint(w // 8, 7 * w // 8))
            rad = rng.randint(4, max(h // 6, 5))
            yy, xx = np.ogrid[:h, :w]
            mask = (yy - cy) ** 2 + (xx - cx + shift * 25.0) ** 2 < rad ** 2
            img[mask] = rng.randint(0, 255, size=3)
        return np.clip(img, 0, 255).astype(np.uint8)

    def __getitem__(self, i: int) -> Dict:
        rng = np.random.RandomState(self.seed * 100003 + i)
        h, w = self.height, self.width

        P2 = np.zeros((3, 4), np.float32)
        P2[0, 0] = P2[1, 1] = 0.58 * w
        P2[0, 2] = w / 2.0
        P2[1, 2] = h / 2.0
        P2[2, 2] = 1.0

        data: Dict = {}
        for idx in self.frame_idxs:
            blob_rng = np.random.RandomState(self.seed * 100003 + i)
            data[("image", idx)] = self._render(blob_rng, shift=float(idx))
            data[("original_image", idx)] = data[("image", idx)].copy()
        data["patched_mask"] = np.ones([h, w])

        for idx in self.frame_idxs[1:]:
            pose = np.eye(4, dtype=np.float32)
            pose[0, 3] = 0.3 * idx  # pure x-translation "ego motion"
            data[("relative_pose", idx)] = pose

        data["P2"] = P2
        data["original_P2"] = P2.copy()
        if self.with_sparse_depth:
            depth = np.zeros((h, w), np.float32)
            depth[::7, ::11] = rng.uniform(2.0, 60.0,
                                           size=depth[::7, ::11].shape)
            data[("sparse_depth", 0)] = depth

        if self.transform is None:
            return data
        return self.transform(deepcopy(data))
