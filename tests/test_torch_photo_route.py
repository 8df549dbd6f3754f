"""The host's choice between the two routes of the photometric kernels I
and J (``ops.photo_loss.photo_route``) and a model of the vector route's
schedule, on the CPU (seconds, no JAX).

* The vector route (``csrc/photo_loss.cu``: ``photo_loss_fwd_vec_kernel``,
  ``photo_loss_bwd_vec_kernel``) needs C <= 4, W % 4 == 0 and every operand
  16-byte aligned; every other shape takes the narrow route.
* :class:`VectorSchedule` is a pure-torch model of the vector kernels'
  schedule, block by block with their tile sizes: the staged tiles with
  their halo reflected by source address (unstaged slots hold NaN, so a
  read of one reaches the result), one warp per row and 4 pixels a lane,
  the H sums formed once per staged element and shared with the lanes
  beside by (modelled) shuffles, lanes 0 and 31 on the halo and ring
  columns, the loop over the N / B predictions of each target, and J's
  partials on the pooled ring followed by the W adjoint in the warp and the
  H adjoint over the block's rows. Its forward is bitwise equal to
  ``photo_loss_plain`` in float32 and its cotangent within 1e-12 of
  ``photo_loss_bwd_plain`` in float64 (measured: equal, and 1.8e-15), at
  ragged tiles, H = 2, W = 4, N / B = 1, 2 and 8 and a scene of exact ties.
  Nothing on the main path runs it: it finds index and halo faults before
  a chip run.
"""
import math

import numpy as np
import pytest
import torch

from fsnet_tpu_torch.ops import photo_loss as tpl
from fsnet_tpu_torch.ops.ssim import _C1, _C2, ssim_target_stats

torch.set_num_threads(1)

VW, FWD_ROWS, BWD_ROWS = 128, 8, 6        # the kernels' tile sizes


def _offset(t):
    """A contiguous copy of ``t`` whose data starts 4 bytes past a 16-byte
    boundary."""
    out = torch.empty(t.numel() + 4, dtype=t.dtype)
    base = (-out.data_ptr() // 4) % 4          # floats to a 16-byte boundary
    return out[base + 1:base + 1 + t.numel()].view(t.shape).copy_(t)


@pytest.mark.parametrize("C", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("W", [8, 10, 640])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset"])
def test_photo_route(C, W, aligned):
    pred = torch.rand(4, 3, W, C)
    target = torch.rand(2, 3, W, C)
    loss = torch.rand(4, 3, W)
    if not aligned:
        pred = _offset(pred)
        assert pred.is_contiguous() and pred.data_ptr() % 16 == 4
    want = "vector" if C <= 4 and W % 4 == 0 and aligned else "narrow"
    assert tpl.photo_route(pred, target, target, target, loss) == want
    # every operand must be aligned: the output too
    assert tpl.photo_route(torch.rand(4, 3, W, C), target, target, target,
                           _offset(loss)) == "narrow"


@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
def test_launchers_refuse_an_unknown_route(kernel):
    """``_launch_fwd`` and ``_launch_bwd`` raise on a route that is not
    one of ``ROUTES``, before anything is launched or counted."""
    pred, target = torch.rand(2, 3, 8, 3), torch.rand(1, 3, 8, 3)
    n0 = tpl.photo_loss_fwd.launches, tpl.photo_loss_bwd.launches
    with pytest.raises(ValueError):
        if kernel == "fwd":
            tpl._launch_fwd("wide", pred, target, target, target)
        else:
            tpl._launch_bwd("wide", pred, target, target, target,
                            torch.rand(2, 3, 8))
    assert (tpl.photo_loss_fwd.launches, tpl.photo_loss_bwd.launches) == n0


def _refl(k, n):
    """The kernels' reflect-101 index, clamped into [0, n)."""
    k = -k if k < 0 else k
    k = 2 * n - 2 - k if k >= n else k
    return min(max(k, 0), n - 1)


def _tap3(a, b, c, third):
    return ((a + b) + c) * third


def _adj3(a_m1, a_0, a_p1, p, n, third):
    """One axis of P^T at index ``p`` (a tensor or an int) of an axis of
    length ``n``, as the kernels' ``adj3``."""
    s = (a_m1 + a_0) + a_p1
    s = torch.where(torch.as_tensor(p == 1), s + a_m1, s)
    s = torch.where(torch.as_tensor(p == n - 2), s + a_p1, s)
    return s * third


def _shfl_up(t, edge):
    """Lane l gets lane l - 1's value of ``t`` [.., 32, ..] (lane dim 1);
    lane 0 gets ``edge``."""
    out = torch.roll(t, 1, dims=1)
    out[:, 0] = edge
    return out


def _shfl_down(t, edge):
    out = torch.roll(t, -1, dims=1)
    out[:, 31] = edge
    return out


class VectorSchedule:
    """The vector route's kernels I and J, block by block, in torch."""

    def __init__(self, pred, target, muy, sy):
        self.x, self.y, self.muy, self.sy = pred, target, muy, sy
        self.N, self.H, self.W, self.C = pred.shape
        self.B = target.shape[0]
        self.R = self.N // self.B
        self.third = torch.tensor(1.0 / 3.0, dtype=pred.dtype)

    def stage(self, img, i0, j0, rows, halo):
        """``stage_tile``: tile row r is image row i0 - halo + r, slot
        halo + q pixel j0 + q; the in-image interior, then halo pixels left
        of it and from q_r = min(128, W - j0) on, each row and halo pixel
        reflected by its source index. NaN where nothing is staged."""
        H, W = self.H, self.W
        t = torch.full((rows, VW + 2 * halo) + img.shape[2:], math.nan,
                       dtype=img.dtype)
        src = [_refl(i0 - halo + r, H) for r in range(rows)]
        qr = min(VW, W - j0)
        t[:, halo:halo + qr] = img[src, j0:j0 + qr]
        for q in list(range(-halo, 0)) + list(range(qr, qr + halo)):
            t[:, halo + q] = img[src, _refl(j0 + q, W)]
        return t

    def hsums(self, X, Y, rows):
        """The H sums of x, x*x, x*y of pooled rows 0 .. rows - 1 (tile rows
        r .. r + 2), each formed once per staged element: [rows, slots, C]
        each."""
        def hs(a):
            return _tap3(a[0:rows], a[1:rows + 1], a[2:rows + 2], self.third)
        return hs(X), hs(X * X), hs(X * Y)

    def lanes(self, h, halo):
        """Slots halo .. halo + 127 as [rows, 32 lanes, 4 pixels, C]."""
        return h[:, halo:halo + VW].reshape(h.shape[0], 32, 4, self.C)

    def wpool(self, own, left, right):
        """The W pass at each lane's 4 pixels: neighbours from the lanes
        beside, ``left`` / ``right`` [rows, C] at lanes 0 and 31."""
        lu = _shfl_up(own[:, :, 3], left)
        ru = _shfl_down(own[:, :, 0], right)
        cols = [_tap3(lu if p == 0 else own[:, :, p - 1], own[:, :, p],
                      ru if p == 3 else own[:, :, p + 1], self.third)
                for p in range(4)]
        return torch.stack(cols, dim=2)

    @staticmethod
    def terms(u, v, w, my, s_y):
        """``ssim_terms``, in its order."""
        uu = u * u
        sx_raw = v - uu
        sxy = w - u * my
        n1 = 2.0 * u * my + _C1
        n2 = 2.0 * sxy + _C2
        d1 = uu + my * my + _C1
        d2 = torch.clamp_min(sx_raw, 0.0) + s_y + _C2
        r = (n1 * n2) / (d1 * d2)
        return dict(sx_raw=sx_raw, n1=n1, n2=n2, d1=d1, d2=d2, r=r,
                    val=(1.0 - r) / 2.0)

    def stats(self, b, rows, j0):
        """muy and sy of target b at image rows ``rows`` and the tile's 128
        columns, as registers hold them: 0 outside the image."""
        C, H, W = self.C, self.H, self.W
        my = torch.zeros(len(rows), VW, C, dtype=self.x.dtype)
        s_y = torch.zeros_like(my)
        qr = min(VW, W - j0)
        for k, i in enumerate(rows):
            if 0 <= i < H:
                my[k, :qr] = self.muy[b, i, j0:j0 + qr]
                s_y[k, :qr] = self.sy[b, i, j0:j0 + qr]
        return (my.reshape(len(rows), 32, 4, C),
                s_y.reshape(len(rows), 32, 4, C))

    def tiles(self, rows):
        for b in range(self.B):
            for i0 in range(0, self.H, rows):
                for j0 in range(0, self.W, VW):
                    yield b, i0, j0

    def forward(self, w_ssim=0.85):
        N, H, W, C = self.x.shape
        loss = torch.full((N, H, W), math.nan, dtype=self.x.dtype)
        for b, i0, j0 in self.tiles(FWD_ROWS):
            Y = self.stage(self.y[b], i0, j0, FWD_ROWS + 2, 1)
            my, s_y = self.stats(b, range(i0, i0 + FWD_ROWS), j0)
            qr = min(VW, W - j0)
            live = min(FWD_ROWS, H - i0)
            for k in range(self.R):
                n = b + k * self.B
                X = self.stage(self.x[n], i0, j0, FWD_ROWS + 2, 1)
                hs = self.hsums(X, Y, FWD_ROWS)
                u, v, w = (self.wpool(self.lanes(h, 1), h[:, 0], h[:, VW + 1])
                           for h in hs)
                val = self.terms(u, v, w, my, s_y)["val"]
                dis = torch.minimum(torch.clamp_min(val, 0.0),
                                    torch.ones((), dtype=val.dtype))
                l1 = (Y[1:-1, 1:VW + 1] - X[1:-1, 1:VW + 1]).abs()
                l1 = l1.reshape(FWD_ROWS, 32, 4, C)
                dsum, lsum = dis[..., 0], l1[..., 0]
                for c in range(1, C):
                    dsum, lsum = dsum + dis[..., c], lsum + l1[..., c]
                out = (w_ssim * (dsum * (1.0 / C))
                       + (1.0 - w_ssim) * (lsum * (1.0 / C)))
                loss[n, i0:i0 + live, j0:j0 + qr] = \
                    out.reshape(FWD_ROWS, VW)[:live, :qr]
        return loss

    def partials(self, u, v, w, my, s_y, g, inside, k_ssim):
        t = self.terms(u, v, w, my, s_y)
        half = torch.tensor(0.5, dtype=u.dtype)

        def tie(gt, eq):
            return torch.where(gt, torch.ones_like(u),
                               torch.where(eq, half, torch.zeros_like(u)))

        gmax = tie(t["sx_raw"] > 0, t["sx_raw"] == 0)
        val = t["val"]
        gclip = tie((val > 0) & (val < 1), (val == 0) | (val == 1))
        G = g * k_ssim * gclip
        inv1, inv2 = 1.0 / t["d1"], 1.0 / t["d2"]
        i12 = inv1 * inv2
        dr_du = 2.0 * (my * i12 * (t["n2"] - t["n1"])
                       - u * t["r"] * (inv1 - gmax * inv2))
        zero = torch.zeros_like(u)
        return (torch.where(inside, G * dr_du, zero),
                torch.where(inside, -(G * gmax) * (t["r"] * inv2), zero),
                torch.where(inside, 2.0 * G * t["n1"] * i12, zero))

    def backward(self, g, w_ssim=0.85):
        N, H, W, C = self.x.shape
        k_ssim, k_l1 = -0.5 * w_ssim / C, (1.0 - w_ssim) / C
        P = BWD_ROWS + 2                        # pooled rows, one a warp
        dx = torch.full_like(self.x, math.nan)
        for b, i0, j0 in self.tiles(BWD_ROWS):
            Y = self.stage(self.y[b], i0, j0, BWD_ROWS + 4, 2)
            pooled = list(range(i0 - 1, i0 - 1 + P))
            prow = torch.tensor([0 <= pi < H for pi in pooled])
            my, s_y = self.stats(b, pooled, j0)
            # the ring columns j0 - 1 (lane 0) and j0 + 128 (lane 31)
            ring = {}
            for side, col in (("left", j0 - 1), ("right", j0 + VW)):
                inside = col >= 0 and col < W
                rm = torch.zeros(P, C, dtype=self.x.dtype)
                rs = torch.zeros_like(rm)
                for k, pi in enumerate(pooled):
                    if inside and 0 <= pi < H:
                        rm[k] = self.muy[b, pi, col]
                        rs[k] = self.sy[b, pi, col]
                ring[side] = (rm, rs, prow[:, None] & inside)
            cols = j0 + torch.arange(VW).reshape(32, 4)
            in_own = prow[:, None, None, None] & (cols < W)[None, ..., None]
            qr = min(VW, W - j0)
            live = min(BWD_ROWS, H - i0)
            for k in range(self.R):
                n = b + k * self.B
                X = self.stage(self.x[n], i0, j0, BWD_ROWS + 4, 2)
                Gt = self.stage(g[n][..., None], i0 + 0, j0, P, 1)[..., 0]
                hs = self.hsums(X, Y, P)
                a_own, a_ring = [], {}
                q = []
                for h in hs:
                    own = self.lanes(h, 2)
                    # e1 the ring column, e2 the halo column beyond it
                    e1l, e2l = h[:, 1], h[:, 0]
                    e1r, e2r = h[:, VW + 2], h[:, VW + 3]
                    q.append((self.wpool(own, e1l, e1r),
                              _tap3(e2l, e1l, own[:, 0, 0], self.third),
                              _tap3(own[:, 31, 3], e1r, e2r, self.third)))
                gv = Gt[:, 1:VW + 1].reshape(P, 32, 4, 1)
                a_own = self.partials(q[0][0], q[1][0], q[2][0], my, s_y, gv,
                                      in_own, k_ssim)
                for s, (side, gcol) in enumerate((("left", 0),
                                                  ("right", VW + 1))):
                    rm, rs, inside = ring[side]
                    a_ring[side] = self.partials(
                        q[0][1 + s], q[1][1 + s], q[2][1 + s], rm, rs,
                        Gt[:, gcol, None], inside.expand(P, C), k_ssim)
                # the W adjoint at each lane's 4 pixels; rows of pooled rows
                # outside the image are zeros
                bs = []
                for m in range(3):
                    a = a_own[m]
                    la = _shfl_up(a[:, :, 3], a_ring["left"][m])
                    ra = _shfl_down(a[:, :, 0], a_ring["right"][m])
                    adj = torch.stack([
                        _adj3(la if p == 0 else a[:, :, p - 1], a[:, :, p],
                              ra if p == 3 else a[:, :, p + 1],
                              cols[:, p, None], W, self.third)
                        for p in range(4)], dim=2)
                    adj = torch.where(prow[:, None, None, None], adj,
                                      torch.zeros_like(adj))
                    bs.append(adj.reshape(P, VW, C))
                # the H adjoint at output rows i0 .. i0 + 5 (bs rows o .. o
                # + 2) and the cotangent
                rows = torch.arange(i0, i0 + BWD_ROWS)[:, None, None]
                hu, hv, hw = (_adj3(t[0:BWD_ROWS], t[1:BWD_ROWS + 1],
                                    t[2:BWD_ROWS + 2], rows, H, self.third)
                              for t in bs)
                xc = X[2:BWD_ROWS + 2, 2:VW + 2]
                yc = Y[2:BWD_ROWS + 2, 2:VW + 2]
                gc = Gt[1:BWD_ROWS + 1, 1:VW + 1, None]
                sign = torch.where(yc - xc >= 0, -1.0, 1.0).to(xc.dtype)
                out = hu + 2.0 * xc * hv + yc * hw + gc * k_l1 * sign
                dx[n, i0:i0 + live, j0:j0 + qr] = out[:live, :qr]
        return dx


def _scene(seed, N, B, H, W, C, dtype, ties=False):
    """Predictions and targets in [0, 1), made with numpy; with ``ties``
    the scene of the card tests' ``_photo_scene``: a flat black patch in
    every image (zero variance) and prediction 0 equal to target 0."""
    rng = np.random.RandomState(seed)
    pred = rng.rand(N, H, W, C).astype(dtype)
    target = rng.rand(B, H, W, C).astype(dtype)
    if ties:
        target[:, :3, :3] = 0.0
        pred[:, :3, :3] = 0.0
        pred[0] = target[0]
    g = rng.randn(N, H, W).astype(dtype)
    return torch.from_numpy(pred), torch.from_numpy(target), \
        torch.from_numpy(g)


# (N, B, H, W, C, ties): ragged rows and columns (H not a multiple of 8 or
# 6, a last column tile of one lane), H = 2, W = 4, N / B = 1, 2 and 8,
# C = 1..4, and exact ties
CASES = [
    (8, 1, 11, 132, 3, False),
    (4, 2, 2, 4, 3, False),
    (3, 3, 9, 20, 1, False),
    (16, 2, 7, 136, 2, False),
    (2, 1, 13, 256, 4, False),
    (4, 2, 14, 40, 3, True),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_schedule_forward_is_bitwise_plain(case):
    N, B, H, W, C, ties = case
    pred, target, _ = _scene(0, N, B, H, W, C, np.float32, ties)
    muy, sy = ssim_target_stats(target)
    got = VectorSchedule(pred, target, muy, sy).forward()
    ref = tpl.photo_loss_plain(pred, target, muy, sy)
    assert not torch.isnan(got).any()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_schedule_cotangent_matches_plain(case):
    N, B, H, W, C, ties = case
    pred, target, g = _scene(1, N, B, H, W, C, np.float64, ties)
    muy, sy = ssim_target_stats(target)
    got = VectorSchedule(pred, target, muy, sy).backward(g)
    ref = tpl.photo_loss_bwd_plain(pred, target, muy, sy, g)
    assert not torch.isnan(got).any()
    err = (got - ref).abs().max() / ref.abs().max()
    assert err <= 1e-12, err
    if ties:        # the scene holds ties of both gates and of the L1 sign
        t = tpl._terms(pred, target, muy, sy)
        assert (t["sx_raw"] == 0).any() and (t["val"] == 0).any()
        assert (pred[0] == target[0]).all()
