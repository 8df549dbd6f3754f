"""Depth error metrics (counterpart of ``fsnet_tpu.ops.metrics``): the
7-metric unsupervised suite and the 9-metric supervised suite on the host
in numpy, and the masked 7-metric suite in torch on a tensor's device.

The masked variant takes an explicit validity mask and computes
mask-weighted means instead of indexing ``gt[mask]``, so its shapes do not
depend on the data.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

UNSUP_METRIC_NAMES = ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2",
                      "a3")


def compute_errors(gt: np.ndarray, pred: np.ndarray):
    """The 7-metric unsupervised suite on flattened valid pixels."""
    thresh = np.maximum(gt / pred, pred / gt)
    a1 = (thresh < 1.25).mean()
    a2 = (thresh < 1.25 ** 2).mean()
    a3 = (thresh < 1.25 ** 3).mean()

    rmse = np.sqrt(((gt - pred) ** 2).mean())
    rmse_log = np.sqrt(((np.log(gt) - np.log(pred)) ** 2).mean())
    abs_rel = np.mean(np.abs(gt - pred) / gt)
    sq_rel = np.mean(((gt - pred) ** 2) / gt)
    return abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3


def compute_depth_errors_masked(gt: torch.Tensor, pred: torch.Tensor,
                                mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The 7-metric suite as mask-weighted means (``mask`` is {0, 1}; all
    inputs broadcastable), on the tensors' device. Returns 0-d tensors."""
    mask = mask.to(gt.dtype)
    n = torch.sum(mask) + 1e-7

    def masked_mean(x):
        return torch.sum(x * mask) / n

    safe_gt = torch.where(mask > 0, gt, torch.ones_like(gt))
    safe_pred = torch.where(mask > 0, pred, torch.ones_like(pred))

    thresh = torch.maximum(safe_gt / safe_pred, safe_pred / safe_gt)
    a1 = masked_mean((thresh < 1.25).to(gt.dtype))
    a2 = masked_mean((thresh < 1.25 ** 2).to(gt.dtype))
    a3 = masked_mean((thresh < 1.25 ** 3).to(gt.dtype))

    rmse = torch.sqrt(masked_mean((safe_gt - safe_pred) ** 2))
    rmse_log = torch.sqrt(masked_mean(
        (torch.log(safe_gt) - torch.log(safe_pred)) ** 2))
    abs_rel = masked_mean(torch.abs(safe_gt - safe_pred) / safe_gt)
    sq_rel = masked_mean((safe_gt - safe_pred) ** 2 / safe_gt)

    return {
        "de/abs_rel": abs_rel, "de/sq_rel": sq_rel, "de/rms": rmse,
        "de/log_rms": rmse_log, "da/a1": a1, "da/a2": a2, "da/a3": a3,
    }


SUPERVISED_METRIC_NAMES = (
    "MAE", "RMSE", "iMAE", "iRMSE", "logMAE", "logRMSE", "SILog",
    "absRel", "sqRel",
)


def compute_supervised_errors(gt: np.ndarray, pred: np.ndarray,
                              min_depth: float = 1e-3,
                              max_depth: float = 80.0):
    """The 9-metric supervised suite over one image pair, on the pixels
    with ``min_depth < gt < max_depth`` (the prediction clipped to that
    range): depths in m, inverse depths in 1/km, SILog scaled by 100, as
    the KITTI depth-prediction benchmark reports them."""
    valid = (gt > min_depth) & (gt < max_depth)
    g = gt[valid]
    p = np.clip(pred[valid], min_depth, max_depth)
    if g.size == 0:
        return {name: 0.0 for name in SUPERVISED_METRIC_NAMES}

    diff = p - g
    inv_diff = 1000.0 / p - 1000.0 / g  # 1/km
    log_diff = np.log(p) - np.log(g)

    silog = np.sqrt(np.mean(log_diff ** 2) - np.mean(log_diff) ** 2) * 100.0

    return {
        "MAE": float(np.mean(np.abs(diff))),
        "RMSE": float(np.sqrt(np.mean(diff ** 2))),
        "iMAE": float(np.mean(np.abs(inv_diff))),
        "iRMSE": float(np.sqrt(np.mean(inv_diff ** 2))),
        "logMAE": float(np.mean(np.abs(log_diff))),
        "logRMSE": float(np.sqrt(np.mean(log_diff ** 2))),
        "SILog": float(silog),
        "absRel": float(np.mean(np.abs(diff) / g)),
        "sqRel": float(np.mean(diff ** 2 / g)),
    }
