"""Depth-bin codecs: log-spaced bins + softmax-expectation decode
(counterpart of ``fsnet_tpu.ops.depth_codec``, forward only)."""
from __future__ import annotations

import numpy as np
import torch


def build_depth_bins(min_depth: float, max_depth: float,
                     num_bins: int) -> np.ndarray:
    """Log-spaced depth bins, ``exp(arange(log(min), log(max), step))``:
    the arange in float64, the result cast to float32."""
    lo, hi = np.log(min_depth), np.log(max_depth)
    step = (hi - lo) / num_bins
    inv_bins = lo + step * np.arange(num_bins, dtype=np.float64)
    return np.exp(inv_bins).astype(np.float32)


def gather_activation(logits: torch.Tensor,
                      depth_bins: torch.Tensor) -> torch.Tensor:
    """Clamped-softmax expectation over depth bins: ``logits``
    [B, H, W, num_bins] (NHWC) -> depth [B, H, W, 1]. Logits are clipped to
    [-10, 10]; the bins stay float32."""
    x = torch.clamp(logits, -10.0, 10.0)
    activated = torch.exp(x - torch.amax(x, dim=-1, keepdim=True))
    activated = activated / torch.sum(activated, dim=-1, keepdim=True)
    return torch.sum(activated * depth_bins, dim=-1, keepdim=True)
