"""Depth-bin codecs: log-spaced bins + softmax-expectation decode
(counterpart of ``fsnet_tpu.ops.depth_codec``)."""
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


def _expectation(logits: torch.Tensor, depth_bins: torch.Tensor):
    x = torch.clamp(logits, -10.0, 10.0)
    activated = torch.exp(x - torch.amax(x, dim=-1, keepdim=True))
    activated = activated / torch.sum(activated, dim=-1, keepdim=True)
    return torch.sum(activated * depth_bins, dim=-1, keepdim=True), activated


class GatherActivation(torch.autograd.Function):
    """The JAX custom VJP (``depth_codec.py:54-73``): the logits cotangent is
    ``a_k (b_k - y) g``, zero where the logit is not strictly inside
    (-10, 10) (``torch.clamp``'s own derivative would pass 1 at the
    bounds). The bins get no gradient."""

    @staticmethod
    def forward(ctx, logits, depth_bins):
        y, activated = _expectation(logits, depth_bins)
        ctx.save_for_backward(logits, activated, depth_bins, y)
        return y

    @staticmethod
    def backward(ctx, g):
        logits, activated, bins, y = ctx.saved_tensors
        ct = activated.dtype
        gl = activated * (bins.to(ct) - y.to(ct)) * g.to(ct)
        mask = (logits > -10.0) & (logits < 10.0)
        return torch.where(mask, gl, torch.zeros_like(gl)), None


def gather_activation(logits: torch.Tensor,
                      depth_bins: torch.Tensor) -> torch.Tensor:
    """Clamped-softmax expectation over depth bins: ``logits``
    [B, H, W, num_bins] (NHWC) -> depth [B, H, W, 1]. Logits are clipped to
    [-10, 10]; the bins stay float32. Differentiable in ``logits``."""
    return GatherActivation.apply(logits, depth_bins)
