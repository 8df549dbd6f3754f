"""Dense optical flow and grey conversion for the motion-mask precompute
(counterpart of the two OpenCV calls in
``fsnet_tpu.pipeline_hooks.precompute_hooks``: ``cv2.cvtColor(...,
COLOR_BGR2GRAY)`` and ``cv2.calcOpticalFlowFarneback``).

The port does not import ``cv2``; these are torch on the tensors' device.
:func:`bgr_to_gray` is OpenCV's fixed-point conversion, bit for bit.
:func:`farneback` is Farneback's two-frame method as OpenCV computes it
(``modules/video/src/optflowgf.cpp``), step by step and in the same
types:

* the pyramid: levels are dropped while a side of the coarsest would fall
  below 32 px; each level blurs the full-size float image
  (``GaussianBlur``, ksize ``max(round(5 sigma) | 1, 3)``, sigma
  ``(1 / scale - 1) / 2``, reflect-101 border; at the finest level sigma 0
  and OpenCV's fixed [1/4, 1/2, 1/4]) and resizes it linearly to the
  level's size (an exact halving averages 2x2 blocks, as ``cv2.resize``
  does);
* the polynomial expansion of each level over the 2 poly_n + 1 taps
  [-poly_n, poly_n] (float32 vertical pass, float64 horizontal pass,
  replicated borders), the matrices' update with the
  edge band's down-weighting, and per iteration the windowed solve: a box
  window summed in float64 (flags 0) or a Gaussian window of sigma
  0.3 (winsize // 2) in float32 (``OPTFLOW_FARNEBACK_GAUSSIAN``);
* the coarser level's flow resized linearly and divided by ``pyr_scale``.

The resizes and the image blur follow OpenCV 5's float32 arithmetic (a
one-channel blend is a fused multiply-add, the two-channel flow's a
multiply and an add; the blur's vector filters fused), which the tests
hold against ``cv2`` to a few float32 ulps of the flow.

OpenCV updates the matrices in row stripes while its window pass runs;
the stripes lag the pass by more than the window, so the whole-image
update after the pass gives the same values.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# cv2.OPTFLOW_USE_INITIAL_FLOW, cv2.OPTFLOW_FARNEBACK_GAUSSIAN
OPTFLOW_USE_INITIAL_FLOW = 4
OPTFLOW_FARNEBACK_GAUSSIAN = 256
# the smallest side of a pyramid level
_MIN_SIZE = 32
# FarnebackUpdateMatrices' down-weighting of the 5 pixels at each edge
_BORDER = (0.14, 0.14, 0.4472, 0.4472, 0.4472)


def bgr_to_gray(image: torch.Tensor) -> torch.Tensor:
    """``cv2.cvtColor(image, cv2.COLOR_BGR2GRAY)`` of a uint8 [..., H, W, 3]
    BGR image: OpenCV's 15-bit fixed point, rounded, bit for bit."""
    if image.dtype != torch.uint8 or image.shape[-1] != 3:
        raise TypeError(f"bgr_to_gray takes uint8 [..., 3] images, got "
                        f"{image.dtype} {tuple(image.shape)}")
    x = image.to(torch.int32)
    y = (x[..., 0] * 3735 + x[..., 1] * 19235 + x[..., 2] * 9798
         + (1 << 14)) >> 15
    return y.to(torch.uint8)


def _round_half_even(v: float) -> int:
    """cvRound: to the nearest integer, ties to even."""
    return int(np.rint(v))


def _gaussian_kernel(n: int, sigma: float) -> np.ndarray:
    """``cv2.getGaussianKernel(n, sigma, CV_32F)``: the float64 kernel
    (OpenCV's fixed small kernels where sigma <= 0) rounded to float32."""
    if sigma <= 0:
        fixed = {1: [1.0], 3: [0.25, 0.5, 0.25],
                 5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
                 7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875,
                     0.109375, 0.03125]}
        if n in fixed:
            return np.asarray(fixed[n], np.float32)
        sigma = ((n - 1) * 0.5 - 1) * 0.3 + 0.8
    half = (n - 1) // 2
    x = np.arange(n, dtype=np.float64) - half
    values = np.exp(x[:half] ** 2 * (-0.5 / (sigma * sigma)))
    total = 2.0 * values.sum() + 1.0
    scale = 1.0 / total
    k = np.empty(n, np.float64)
    k[:half] = values * scale
    k[n - 1 - np.arange(half)] = values * scale
    k[half] = scale
    return k.astype(np.float32)


def _fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """``a b + c`` in float32 with one rounding (a fused multiply-add,
    formed exactly in float64), as OpenCV's vector code computes it; ``b``
    a float or a float32 tensor."""
    if isinstance(b, torch.Tensor):
        b = b.double()
    return (a.double() * b + c.double()).float()


def _taps(img: torch.Tensor, r: int, dim: int, mode: str):
    """The shifted views [-r, r] of ``img`` along ``dim``, the border
    ``reflect`` (reflect-101) or ``replicate``."""
    n = img.shape[dim]
    idx = torch.arange(-r, n + r, device=img.device)
    if mode == "reflect":
        period = 2 * (n - 1) if n > 1 else 1
        idx = idx.remainder(period)
        idx = torch.where(idx >= n, period - idx, idx)
    else:
        idx = idx.clamp(0, n - 1)
    padded = img.index_select(dim, idx)
    return {i: padded.narrow(dim, r + i, n) for i in range(-r, r + 1)}


def _blur_rows(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """cv2's float32 row filter of a symmetric ``kernel`` (reflect-101):
    for 3 taps ``fma(s0, k0, (s-1 + s1) k1)``, else the taps left to right,
    each one fused-multiply-added."""
    r = (len(kernel) - 1) // 2
    t = _taps(img, r, 1, "reflect")
    k = [float(v) for v in kernel]
    if r == 1:
        return _fma(t[0], k[1], (t[-1] + t[1]) * k[0])
    out = t[-r] * k[0]
    for j in range(1, 2 * r + 1):
        out = _fma(t[j - r], k[j], out)
    return out


def _blur_cols(img: torch.Tensor, kernel: np.ndarray,
               mode: str = "reflect") -> torch.Tensor:
    """cv2's float32 symmetric column filter: ``s0 k0``, then
    ``fma(s-i + si, ki, .)`` for i rising."""
    r = (len(kernel) - 1) // 2
    t = _taps(img, r, 0, mode)
    k = [float(v) for v in kernel]
    out = t[0] * k[r]
    for i in range(1, r + 1):
        out = _fma(t[-i] + t[i], k[r + i], out)
    return out


def _gaussian_blur(img: torch.Tensor, ksize: int,
                   sigma: float) -> torch.Tensor:
    """``cv2.GaussianBlur(img, (ksize, ksize), sigma, sigma)`` of a float32
    [H, W] image: rows, then columns, reflect-101 border."""
    kernel = _gaussian_kernel(ksize, sigma)
    return _blur_cols(_blur_rows(img, kernel), kernel)


def _linear_axis(src: int, dst: int, device, float_coords: bool = False):
    """cv2.resize INTER_LINEAR's taps along one axis: the source index of
    each output index, the next one, and the float32 weights of both. The
    fraction is the float64 coordinate's, rounded; with ``float_coords``
    (OpenCV's two-channel path) the coordinate is rounded to float32
    first and the fraction taken there."""
    d = np.arange(dst, dtype=np.float64)
    if float_coords:
        sc = src / dst
        f = (d * sc + (sc * 0.5 - 0.5)).astype(np.float32)
        i0 = np.floor(f).astype(np.int64)
        frac = (f - i0.astype(np.float32)).astype(np.float32)
    else:
        f = (d + 0.5) * (1.0 / (dst / src)) - 0.5
        i0 = np.floor(f).astype(np.int64)
        frac = (f - i0).astype(np.float32)
    low = i0 < 0
    frac[low], i0[low] = 0.0, 0
    high = i0 >= src - 1
    frac[high], i0[high] = 0.0, src - 1
    i1 = np.minimum(i0 + 1, src - 1)
    w0 = (np.float32(1.0) - frac).astype(np.float32)

    def t(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return (t(i0, torch.int64), t(i1, torch.int64), t(w0, torch.float32),
            t(frac, torch.float32))


def _resize(img: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """``cv2.resize(img, (width, height))`` (INTER_LINEAR) of a float32
    [H, W] image or [H, W, 2] flow: rows, then columns. A flow blends its
    taps as ``a w0 + b w1`` (a multiply and an add) on float32
    coordinates."""
    H, W = img.shape[:2]
    if (H, W) == (height, width):
        return img
    flow = img.ndim == 3
    x0, x1, ax0, ax1 = _linear_axis(W, width, img.device, flow)
    y0, y1, by0, by1 = _linear_axis(H, height, img.device, flow)
    if flow:
        ax0, ax1 = ax0[None, :, None], ax1[None, :, None]
        rows = img[:, x0] * ax0 + img[:, x1] * ax1
        return rows[y0] * by0[:, None, None] + rows[y1] * by1[:, None, None]
    # a + (b - a) t, fused
    rows = _fma(img[:, x1] - img[:, x0], ax1[None, :], img[:, x0])
    return _fma(rows[y1] - rows[y0], by1[:, None], rows[y0])


def _poly_constants(n: int, sigma: float):
    """FarnebackPrepareGaussian: the float32 taps g, x g, x^2 g of
    [-n, n] and the four entries of the inverse moment matrix used."""
    if sigma < np.finfo(np.float32).eps:
        sigma = n * 0.3
    xs = np.arange(-n, n + 1)
    g = np.exp(-(xs * xs) / (2 * sigma * sigma)).astype(np.float32)
    s = 1.0 / float(np.sum(g.astype(np.float64)))
    g = (g.astype(np.float64) * s).astype(np.float32)
    xg = (xs.astype(np.float32) * g).astype(np.float32)
    xxg = ((xs * xs).astype(np.float32) * g).astype(np.float32)
    G = np.zeros((6, 6))
    gy, gx = g[:, None], g[None, :]
    xx = xs[None, :].astype(np.float32)
    yy = xs[:, None].astype(np.float32)
    gg = (gy * gx).astype(np.float32)
    G[0, 0] = gg.astype(np.float64).sum()
    G[1, 1] = (gg * xx * xx).astype(np.float64).sum()
    G[3, 3] = (gg * xx * xx * xx * xx).astype(np.float64).sum()
    G[5, 5] = (gg * xx * xx * yy * yy).astype(np.float64).sum()
    G[2, 2] = G[0, 3] = G[0, 4] = G[3, 0] = G[4, 0] = G[1, 1]
    G[4, 4] = G[3, 3]
    G[3, 4] = G[4, 3] = G[5, 5]
    inv = np.linalg.inv(G)
    return g, xg, xxg, (inv[1, 1], inv[0, 3], inv[3, 3], inv[5, 5])


def _poly_exp(src: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """FarnebackPolyExp of a float32 [H, W] image -> float32 [H, W, 5]:
    the coefficients (y, x, yy, xx, xy) of each pixel's quadratic fit."""
    g, xg, xxg, (ig11, ig03, ig33, ig55) = _poly_constants(n, sigma)
    H, W = src.shape
    dev = src.device
    rows = torch.arange(H, device=dev)
    # vertical pass, float32, rows clamped
    t0 = src * float(g[n])
    t1 = torch.zeros_like(src)
    t2 = torch.zeros_like(src)
    for k in range(1, n + 1):
        s0 = src[(rows - k).clamp(min=0)]
        s1 = src[(rows + k).clamp(max=H - 1)]
        p = s0 + s1
        t0 = t0 + float(g[n + k]) * p
        t1 = t1 + float(xg[n + k]) * (s1 - s0)
        t2 = t2 + float(xxg[n + k]) * p
    # horizontal pass, float64 sums of float32 terms, columns clamped
    cols = torch.arange(-n, W + n, device=dev).clamp(0, W - 1)
    r0, r1, r2 = t0[:, cols], t1[:, cols], t2[:, cols]

    def at(r, k):
        return r[:, n + k:n + k + W]

    g0 = float(g[n])
    b1 = (at(r0, 0) * g0).double()
    b3 = (at(r1, 0) * g0).double()
    b5 = (at(r2, 0) * g0).double()
    b2 = torch.zeros_like(b1)
    b4 = torch.zeros_like(b1)
    b6 = torch.zeros_like(b1)
    for k in range(1, n + 1):
        gk, xgk, xxgk = float(g[n + k]), float(xg[n + k]), float(xxg[n + k])
        tg = (at(r0, k) + at(r0, -k)).double()
        b1 = b1 + tg * gk
        b4 = b4 + tg * xxgk
        b2 = b2 + ((at(r0, k) - at(r0, -k)) * xgk).double()
        b3 = b3 + ((at(r1, k) + at(r1, -k)) * gk).double()
        b6 = b6 + ((at(r1, k) - at(r1, -k)) * xgk).double()
        b5 = b5 + ((at(r2, k) + at(r2, -k)) * gk).double()
    return torch.stack([b3 * ig11, b2 * ig11, b1 * ig03 + b5 * ig33,
                        b1 * ig03 + b4 * ig33, b6 * ig55],
                       dim=-1).float()


def _edge_factors(n: int, device):
    """The float32 down-weighting of each index along a side of ``n``: the
    factor of the low edge's band and that of the high edge's band."""
    low, high = np.ones(n, np.float32), np.ones(n, np.float32)
    for i, b in enumerate(_BORDER[:n]):
        low[i] = b
        high[n - 1 - i] = b
    return (torch.as_tensor(low, device=device),
            torch.as_tensor(high, device=device))


def _update_matrices(R0: torch.Tensor, R1: torch.Tensor,
                     flow: torch.Tensor) -> torch.Tensor:
    """FarnebackUpdateMatrices: the [H, W, 5] float32 system (G11, G12,
    G22, h1, h2) of each pixel from the two expansions and the flow."""
    H, W = flow.shape[:2]
    dev = flow.device
    dx, dy = flow[..., 0], flow[..., 1]
    xs = torch.arange(W, device=dev, dtype=torch.float32)[None, :]
    ys = torch.arange(H, device=dev, dtype=torch.float32)[:, None]
    fx = xs + dx
    fy = ys + dy
    x1 = torch.floor(fx)
    y1 = torch.floor(fy)
    fx = fx - x1
    fy = fy - y1
    inside = (x1 >= 0) & (x1 < W - 1) & (y1 >= 0) & (y1 < H - 1)
    xi = torch.where(inside, x1, torch.zeros_like(x1)).long()
    yi = torch.where(inside, y1, torch.zeros_like(y1)).long()
    flat = R1.reshape(H * W, 5)
    base = yi * W + xi
    p00, p01 = flat[base], flat[base + 1]
    p10, p11 = flat[base + W], flat[base + W + 1]
    a00 = ((1.0 - fx) * (1.0 - fy))[..., None]
    a01 = (fx * (1.0 - fy))[..., None]
    a10 = ((1.0 - fx) * fy)[..., None]
    a11 = (fx * fy)[..., None]
    r = a00 * p00 + a01 * p01 + a10 * p10 + a11 * p11
    r4 = torch.where(inside, (R0[..., 2] + r[..., 2]) * 0.5, R0[..., 2])
    r5 = torch.where(inside, (R0[..., 3] + r[..., 3]) * 0.5, R0[..., 3])
    r6 = torch.where(inside, (R0[..., 4] + r[..., 4]) * 0.25,
                     R0[..., 4] * 0.5)
    zero = torch.zeros((), device=dev)
    r2 = (R0[..., 0] - torch.where(inside, r[..., 0], zero)) * 0.5
    r3 = (R0[..., 1] - torch.where(inside, r[..., 1], zero)) * 0.5
    r2 = r2 + (r4 * dy + r6 * dx)
    r3 = r3 + (r6 * dy + r5 * dx)
    # the factors multiplied in OpenCV's order: x low, x high, y low, y high
    xl, xh = _edge_factors(W, dev)
    yl, yh = _edge_factors(H, dev)
    scale = ((xl * xh)[None, :] * yl[:, None]) * yh[:, None]
    r2, r3, r4, r5, r6 = (v * scale for v in (r2, r3, r4, r5, r6))
    return torch.stack([r4 * r4 + r6 * r6, (r4 + r5) * r6,
                        r5 * r5 + r6 * r6, r4 * r2 + r6 * r3,
                        r6 * r2 + r5 * r3], dim=-1)


def _solve(g11, g12, g22, h1, h2) -> torch.Tensor:
    """The float64 2x2 solve of each pixel, regularised by 1e-3 -> float32
    [H, W, 2] flow."""
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    return torch.stack([(g11 * h2 - g12 * h1) * idet,
                        (g22 * h1 - g12 * h2) * idet], dim=-1).float()


def _running_sums(first: torch.Tensor, steps: torch.Tensor,
                  dim: int) -> torch.Tensor:
    """``first``, ``first + steps[0]``, ... along ``dim`` without the last
    step: the running window sums of FarnebackUpdateFlow_Blur, added in
    its order (a scan over ``[first, steps...]``)."""
    seq = torch.cat([first.unsqueeze(dim), steps], dim=dim)
    return torch.cumsum(seq, dim=dim).narrow(dim, 1, steps.shape[dim])


def _box_sums(M: torch.Tensor, m: int) -> torch.Tensor:
    """Sums over the (2m+1)^2 window of each pixel of a float32 [H, W, 5]
    ``M``, borders replicated, as FarnebackUpdateFlow_Blur runs them in
    float64: down the rows, each step adding the float32 difference of the
    row entering and the row leaving; then along each row, each step
    adding the float64 difference of the columns entering and leaving."""
    H, W = M.shape[:2]
    dev = M.device
    ys = torch.arange(H, device=dev)
    # the window above row 0: row 0 (m + 2) times (a float32 product),
    # then rows 1 .. m - 1; each step adds row y + m, drops row y - m - 1
    first = (M[0] * float(m + 2)).double()
    for y in range(1, m):
        first = first + M[min(y, H - 1)].double()
    steps = (M[(ys + m).clamp(max=H - 1)]
             - M[(ys - m - 1).clamp(min=0)]).double()
    v = _running_sums(first, steps, 0)
    xs = torch.arange(W, device=dev)
    first = v[:, 0] * float(m + 2)
    for x in range(1, m):
        first = first + v[:, min(x, W - 1)]
    steps = v[:, (xs + m).clamp(max=W - 1)] - v[:, (xs - m - 1).clamp(min=0)]
    return _running_sums(first, steps, 1)


def _flow_box(M: torch.Tensor, block: int) -> torch.Tensor:
    """FarnebackUpdateFlow_Blur: the box window's means, solved."""
    s = _box_sums(M, block // 2) * (1.0 / (block * block))
    return _solve(*s.unbind(-1))


def _gauss_window(m: int) -> np.ndarray:
    """FarnebackUpdateFlow_GaussianBlur's float32 window taps [-m, m]."""
    sigma = m * 0.3
    k = np.empty(m + 1, np.float32)
    k[0] = 1.0
    s = 1.0
    for i in range(1, m + 1):
        t = np.float32(math.exp(-i * i / (2 * sigma * sigma)))
        k[i] = t
        s += float(t) * 2
    s = 1.0 / s
    k = (k.astype(np.float64) * s).astype(np.float32)
    return np.concatenate([k[:0:-1], k])


def _flow_gauss(M: torch.Tensor, block: int) -> torch.Tensor:
    """FarnebackUpdateFlow_GaussianBlur: the Gaussian window's float32
    sums (columns, then rows, borders replicated; each tap a multiply and
    an add), solved in float64."""
    k = [float(v) for v in _gauss_window(block // 2)]
    m = block // 2

    def window(img, dim):
        t = _taps(img, m, dim, "replicate")
        out = t[0] * k[m]
        for i in range(1, m + 1):
            out = out + (t[-i] + t[i]) * k[m + i]
        return out

    return _solve(*(window(window(M[..., c], 0), 1).double()
                    for c in range(5)))


def farneback(prev: torch.Tensor, next: torch.Tensor, pyr_scale: float,
              levels: int, winsize: int, iterations: int, poly_n: int,
              poly_sigma: float, flags: int = 0) -> torch.Tensor:
    """``cv2.calcOpticalFlowFarneback(prev, next, None, ...)`` of two uint8
    (or float) [H, W] grey images on their device: the float32 [H, W, 2]
    flow (dx, dy) from ``prev`` to ``next``. Takes ``flags`` 0 or
    ``OPTFLOW_FARNEBACK_GAUSSIAN`` and ``poly_n`` 5 or 7."""
    if flags not in (0, OPTFLOW_FARNEBACK_GAUSSIAN):
        raise ValueError(f"flags {flags}: 0 or OPTFLOW_FARNEBACK_GAUSSIAN "
                         "(256); an initial flow is not taken")
    if poly_n not in (5, 7):
        raise ValueError(f"poly_n {poly_n}: 5 or 7, as OpenCV takes")
    if not 0 < pyr_scale < 1:
        raise ValueError(f"pyr_scale {pyr_scale}: in (0, 1)")
    if prev.shape != next.shape or prev.dim() != 2:
        raise ValueError(f"two [H, W] images of one size, got "
                         f"{tuple(prev.shape)} and {tuple(next.shape)}")
    if prev.device != next.device:
        raise ValueError("the two images lie on different devices")
    H, W = prev.shape
    images = (prev.float(), next.float())
    scale, k = 1.0, 0
    while k < levels:
        scale *= pyr_scale
        if W * scale < _MIN_SIZE or H * scale < _MIN_SIZE:
            break
        k += 1
    flow = None
    for level in range(k, -1, -1):
        scale = 1.0
        for _ in range(level):
            scale *= pyr_scale
        sigma = (1.0 / scale - 1) * 0.5
        ksize = max(_round_half_even(sigma * 5) | 1, 3)
        width, height = _round_half_even(W * scale), _round_half_even(H * scale)
        if flow is None:
            flow = torch.zeros((height, width, 2), dtype=torch.float32,
                               device=prev.device)
        else:
            flow = _resize(flow, height, width) * float(1.0 / pyr_scale)
        R = [_poly_exp(_resize(_gaussian_blur(img, ksize, sigma), height,
                               width), poly_n, poly_sigma)
             for img in images]
        M = _update_matrices(R[0], R[1], flow)
        for it in range(iterations):
            if flags & OPTFLOW_FARNEBACK_GAUSSIAN:
                flow = _flow_gauss(M, winsize)
            else:
                flow = _flow_box(M, winsize)
            if it < iterations - 1:
                M = _update_matrices(R[0], R[1], flow)
    return flow
