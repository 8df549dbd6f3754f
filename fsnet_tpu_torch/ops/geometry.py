"""Disparity <-> depth conversions (counterpart of the first two functions of
``fsnet_tpu.ops.geometry``; the rest of that module arrives with the
training slice)."""
from __future__ import annotations


def disp_to_depth(disp, min_depth: float, max_depth: float):
    """Sigmoid disparity -> (scaled_disp, depth)."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled_disp = min_disp + (max_disp - min_disp) * disp
    depth = 1.0 / scaled_disp
    return scaled_disp, depth


def depth_to_disp(depth, min_depth, max_depth):
    """Inverse of :func:`disp_to_depth`. ``min_depth``/``max_depth`` may be
    scalars or broadcastable tensors (fx-scaled per-sample bounds)."""
    return (1.0 / depth - 1.0 / max_depth) / (1.0 / min_depth - 1.0 / max_depth)
