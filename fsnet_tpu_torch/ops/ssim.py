"""SSIM dissimilarity on NHWC tensors (counterpart of
``fsnet_tpu.ops.ssim``: ``ssim_target_stats`` and ``ssim``,
``ssim.py:184-223``).

The TPU route computes these in XLA, outside any Pallas kernel, so the port
writes them as PyTorch operations. The 3x3 mean pool over reflection-padded
windows runs as two 1D passes of shifted adds, each scaled by float32(1/3),
the tap of the JAX package's default banded-matrix form (``_pool_matrix``),
so the two agree up to the order of the adds. A single 1/9 scale would not:
the SSIM denominators (C2 = 9e-4) turn its 1e-7 bias against (1/3)^2 in
float32 into a loss bias of a few 1e-6.
Clamps use ``torch.maximum``/``torch.minimum``, which split the gradient at
a tie as JAX does; ``torch.clamp`` would pass all of it.
"""
from __future__ import annotations

import torch

_C1 = 0.01 ** 2
_C2 = 0.03 ** 2


def _reflect1(x: torch.Tensor, dim: int) -> torch.Tensor:
    """One-element reflection pad along ``dim`` (edge not repeated)."""
    n = x.shape[dim]
    return torch.cat([x.narrow(dim, 1, 1), x, x.narrow(dim, n - 2, 1)],
                     dim=dim)


def avg_pool3(x: torch.Tensor) -> torch.Tensor:
    """Reflection pad by 1, then 3x3 mean pool with stride 1, over the H and
    W axes of an NHWC tensor: the H pass, then the W pass, each summed in
    float32 or wider and cast back to the input dtype."""
    acc = torch.promote_types(x.dtype, torch.float32)
    third = torch.tensor(1.0 / 3.0, dtype=acc, device=x.device)
    xp = _reflect1(x.to(acc), 1)
    x = ((xp[:, :-2] + xp[:, 1:-1] + xp[:, 2:]) * third).to(x.dtype)
    xp = _reflect1(x.to(acc), 2)
    return ((xp[:, :, :-2] + xp[:, :, 1:-1] + xp[:, :, 2:]) * third).to(
        x.dtype)


def _relu0(x: torch.Tensor) -> torch.Tensor:
    return torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))


def ssim_target_stats(y: torch.Tensor):
    """The target-side pooled stats (mu_y, sigma_y) of :func:`ssim`, to be
    computed once and broadcast over many predictions."""
    mu_y = avg_pool3(y)
    return mu_y, _relu0(avg_pool3(y * y) - mu_y * mu_y)


def ssim(x: torch.Tensor, y: torch.Tensor, y_stats=None) -> torch.Tensor:
    """SSIM dissimilarity ``clip((1 - SSIM) / 2, 0, 1)``, elementwise over
    NHWC (3x3 windows). ``y_stats``: :func:`ssim_target_stats` of ``y``,
    broadcastable against ``x``."""
    mu_x = avg_pool3(x)
    mu_y, sigma_y = ssim_target_stats(y) if y_stats is None else y_stats
    sigma_x = _relu0(avg_pool3(x * x) - mu_x * mu_x)
    sigma_xy = avg_pool3(x * y) - mu_x * mu_y
    ssim_n = (2.0 * mu_x * mu_y + _C1) * (2.0 * sigma_xy + _C2)
    ssim_d = (mu_x * mu_x + mu_y * mu_y + _C1) * (sigma_x + sigma_y + _C2)
    d = (1.0 - ssim_n / ssim_d) / 2.0
    return torch.minimum(_relu0(d), torch.ones((), dtype=d.dtype,
                                               device=d.device))
