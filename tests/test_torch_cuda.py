"""The port's Hopper kernel against its plain version, on a CUDA device.

Marked ``cuda``: each test skips when no CUDA device is present (decided in
the test, never at import). On a machine with a card, run

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest``: the repo's conftest configures JAX, which the port and
this file do not need).
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    # (B, H, W, Cs, Co, pad_mode, bias): ragged tiles, the decoder's
    # two-part Cin=96 conv, every output-channel tile width
    (2, 6, 20, (512,), 256, "zeros", True),
    (2, 12, 40, (128, 128), 128, "replicate", True),
    (1, 9, 33, (32, 64), 32, "replicate", True),
    (3, 17, 70, (16,), 16, "replicate", False),
    (2, 5, 7, (3,), 40, "zeros", True),
])
def test_kernel_matches_plain(cuda, dtype, shape):
    from fsnet_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_plain

    B, H, W, Cs, Co, pad_mode, with_bias = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    parts = [torch.randn(B, H, W, c, generator=g, device=cuda).to(dtype)
             for c in Cs]
    w = (torch.randn(3, 3, sum(Cs), Co, generator=g, device=cuda)
         / np.sqrt(9 * sum(Cs))).to(dtype)
    b = (torch.randn(Co, generator=g, device=cuda).to(dtype)
         if with_bias else None)
    n0 = conv3x3.launches
    out = conv3x3(parts, w, b, pad_mode)
    torch.cuda.synchronize()
    assert conv3x3.launches == n0 + 1
    ref = conv3x3_plain(parts, w, b, pad_mode)
    assert out.shape == (B, H, W, Co) and out.dtype == dtype
    err = (out.float() - ref.float()).abs().max() / ref.float().abs().max()
    assert err <= TOL[dtype], err


def _randn(g, *shape, scale=1.0):
    return torch.randn(*shape, generator=g, device="cuda") * scale


@pytest.mark.parametrize("shape", [
    # (B, H, W, Cs, Co, pad_mode): ragged tiles, two parts, each tile width
    (2, 6, 20, (512,), 256, "zeros"),
    (2, 12, 40, (128, 128), 128, "replicate"),
    (1, 9, 33, (32, 64), 32, "replicate"),
    (3, 17, 70, (16,), 16, "replicate"),
])
def test_moments_kernel_matches_plain(cuda, shape):
    from fsnet_tpu_torch.ops.conv3x3 import conv3x3_bn, conv3x3_plain

    B, H, W, Cs, Co, pad_mode = shape
    g = torch.Generator(device=cuda).manual_seed(1)
    parts = [_randn(g, B, H, W, c) for c in Cs]
    w = _randn(g, 3, 3, sum(Cs), Co, scale=1 / np.sqrt(9 * sum(Cs)))
    b = _randn(g, Co, scale=0.1)
    n0 = conv3x3_bn.launches
    out, s1, s2 = conv3x3_bn(parts, w, b, pad_mode)
    torch.cuda.synchronize()
    assert conv3x3_bn.launches == n0 + 1
    ref = conv3x3_plain(parts, w, b, pad_mode)
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()
    # moments: relative to the sum of |summands|
    assert (s1 - ref.sum((0, 1, 2))).abs().max() <= \
        1e-5 * ref.abs().sum((0, 1, 2)).max()
    assert (s2 - (out * out).sum((0, 1, 2))).abs().max() <= \
        1e-5 * (out * out).sum((0, 1, 2)).max()


@pytest.mark.parametrize("shape", [
    (2, 6, 20, (512,), 256, "zeros"),
    (2, 12, 40, (128, 128), 128, "replicate"),
    (1, 9, 33, (32, 64), 32, "replicate"),
    (3, 17, 70, (16,), 16, "replicate"),
    (2, 5, 7, (3,), 40, "zeros"),
])
def test_conv_gradient_kernels_match_plain(cuda, shape):
    """dx (the conv kernel on the padded cotangent, flipped weights) and dw
    (csrc/conv3x3_dw.cu) against their plain versions."""
    from fsnet_tpu_torch.ops import conv3x3 as tc

    B, H, W, Cs, Co, pad_mode = shape
    g = torch.Generator(device=cuda).manual_seed(2)
    parts = [_randn(g, B, H, W, c) for c in Cs]
    w = _randn(g, 3, 3, sum(Cs), Co, scale=1 / np.sqrt(9 * sum(Cs)))
    gy = _randn(g, B, H, W, Co)
    n_dx, n_dw = tc.conv3x3_dx.launches, tc.conv3x3_dw.launches
    dxs = tc.conv3x3_dx(gy, w, pad_mode, Cs)
    dw = tc.conv3x3_dw(parts, gy, pad_mode)
    torch.cuda.synchronize()
    assert tc.conv3x3_dx.launches == n_dx + len(Cs)
    assert tc.conv3x3_dw.launches == n_dw + 1
    ref_dxs = tc.conv3x3_dx_plain(gy, w, pad_mode, Cs)
    for a, r in zip(dxs, ref_dxs):
        assert a.shape == r.shape
        assert (a - r).abs().max() <= 1e-4 * r.abs().max()
    ref_dw = tc.conv3x3_dw_plain(parts, gy, pad_mode)
    assert dw.shape == ref_dw.shape
    assert (dw - ref_dw).abs().max() <= 1e-4 * ref_dw.abs().max()


def test_conv_autograd_on_card_matches_cpu(cuda):
    from fsnet_tpu_torch.ops.conv3x3 import conv3x3_bn

    g = torch.Generator(device=cuda).manual_seed(3)
    parts = [_randn(g, 2, 10, 36, c) for c in (32, 64)]
    w = _randn(g, 3, 3, 96, 32, scale=0.05)
    b = _randn(g, 32, scale=0.1)
    cot = _randn(g, 2, 10, 36, 32)
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [t.detach().to(dev).requires_grad_(True)
                  for t in (*parts, w, b)]
        out, s1, s2 = conv3x3_bn(leaves[:2], leaves[2], leaves[3],
                                 "replicate")
        ((out * cot.to(dev)).sum() + s1.sum() * 1e-2
         + s2.sum() * 1e-4).backward()
        grads[dev] = [t.grad.cpu() for t in leaves]
    for a, r in zip(grads["cuda"], grads["cpu"]):
        assert (a - r).abs().max() <= 1e-4 * r.abs().max()


def _warp_scene(g, S, F, B, H, W, C):
    from fsnet_tpu_torch.ops.geometry import invert_K, make_K44
    from fsnet_tpu_torch.ops.warp_depth import make_affine_rows

    image = torch.rand(F * B, H, W, C, generator=g, device="cuda")
    depth = 4.0 + 20.0 * torch.rand(S * B, H, W, generator=g, device="cuda")
    P = torch.zeros(B, 3, 4, device="cuda")
    P[:, 0, 0] = P[:, 1, 1] = 0.58 * W
    P[:, 0, 2], P[:, 1, 2], P[:, 2, 2] = W / 2, H / 2, 1.0
    K = make_K44(P)
    Ts = torch.eye(4, device="cuda").repeat(F, B, 1, 1)
    Ts[..., :3, 3] = (torch.rand(F, B, 3, generator=g, device="cuda") - 0.5) \
        * torch.tensor([0.2, 0.1, 1.4], device="cuda")
    return image, depth, make_affine_rows(K, invert_K(K), Ts, S)


@pytest.mark.parametrize("dims", [(2, 2, 2, 16, 128, 3, 4),
                                  (4, 2, 3, 24, 200, 3, 4),
                                  (1, 2, 1, 7, 33, 2, 8)])
def test_warp_kernels_match_plain(cuda, dims):
    """Kernels A and B against their plain versions on the card: the
    projection is rounded once per operation on both, so the corners agree
    and the values nearly bitwise."""
    from fsnet_tpu_torch.ops import warp_depth as twd

    S, F, B, H, W, C, band = dims
    g = torch.Generator(device=cuda).manual_seed(4)
    image, depth, arows = _warp_scene(g, S, F, B, H, W, C)
    n0, n1 = twd.warp_depth_fwd.launches, twd.warp_depth_bwd.launches
    got = twd.warp_depth_fwd(image, depth, arows, S, F, band)
    ref = twd.warp_depth_plain(image, depth, arows, S, F, band)
    gy = torch.randn(got[0].shape, generator=g, device=cuda)
    dd = twd.warp_depth_bwd(depth, gy, got[2], got[3], arows, S, F)
    dd_ref = twd.warp_depth_bwd_plain(depth, gy, ref[2], ref[3], arows, S, F)
    torch.cuda.synchronize()
    assert twd.warp_depth_fwd.launches == n0 + 1
    assert twd.warp_depth_bwd.launches == n1 + 1
    for a, r in zip(got, ref):
        assert a.shape == r.shape and a.dtype == r.dtype
    assert torch.equal(got[1], ref[1])
    for a, r in zip((got[0], got[2], got[3]), (ref[0], ref[2], ref[3])):
        assert (a - r).abs().max() <= 1e-6
    assert (dd - dd_ref).abs().max() <= 1e-5 * dd_ref.abs().max()


def test_train_step_on_card_matches_cpu(cuda):
    """The flagship train step at a small size through every training
    kernel, against the port on the CPU from the same weights and batch
    (white-noise images, as tests/test_torch_train_step.py explains)."""
    from fsnet_tpu_torch.entry import (flagship_model, flagship_optimizer,
                                       synthetic_batch)
    from fsnet_tpu_torch.ops import conv3x3 as tc
    from fsnet_tpu_torch.ops import photo_loss as tpl
    from fsnet_tpu_torch.ops import warp_depth as twd
    from fsnet_tpu_torch.runtime.state import make_train_step

    H, W, B = 64, 128, 2
    batch = synthetic_batch(B, H, W)
    rng = np.random.RandomState(7)
    for key in sorted(batch):
        if key.startswith(("image/", "original_image/")):
            batch[key] = rng.rand(*batch[key].shape).astype(np.float32)
    counters = (tc.conv3x3, tc.conv3x3_bn, tc.conv3x3_dx, tc.conv3x3_dw,
                twd.warp_depth_fwd, twd.warp_depth_bwd, tpl.photo_loss_fwd,
                tpl.photo_loss_bwd)
    res = {}
    for dev in ("cuda", "cpu"):
        model = flagship_model(H, W, device=dev, seed=0)
        opt, _ = flagship_optimizer(model)
        before = [f.launches for f in counters]
        met = make_train_step(dev, with_grads=True)(model, opt, batch)
        ran = [f.launches - n for f, n in zip(counters, before)]
        res[dev] = (float(met["loss"]), met["_grads"], ran)
    assert res["cuda"][2] == [4, 10, 18, 14, 1, 1, 2, 1]
    assert res["cpu"][2] == [0] * 8
    assert abs(res["cuda"][0] - res["cpu"][0]) <= 1e-4 * abs(res["cpu"][0])
    keys = [k for k in res["cpu"][1]
            if not (".upconv_" in k and k.endswith(".conv.bias"))]
    num = sum(float(((res["cuda"][1][k].cpu() - res["cpu"][1][k]) ** 2).sum())
              for k in keys)
    den = sum(float((res["cpu"][1][k] ** 2).sum()) for k in keys)
    assert (num / den) ** 0.5 <= 1e-2


def test_kernel_rejects_what_it_does_not_take(cuda):
    from fsnet_tpu_torch.ops.conv3x3 import conv3x3

    x = torch.randn(1, 8, 8, 4, device=cuda)
    w = torch.randn(3, 3, 4, 8, device=cuda)
    with pytest.raises(TypeError):
        conv3x3(x.double(), w.double())
    with pytest.raises(ValueError):
        conv3x3(x.transpose(1, 2), w)
    with pytest.raises(TypeError):
        conv3x3(x, w.cpu())


def test_flagship_on_card_matches_cpu(cuda):
    from fsnet_tpu_torch.entry import flagship_model
    from fsnet_tpu_torch.ops.conv3x3 import conv3x3
    from fsnet_tpu_torch.runtime.state import make_eval_step

    H, W = 64, 96
    img = np.random.RandomState(0).rand(2, H, W, 3).astype(np.float32)
    batch = {"image/0": img, "P2": np.eye(3, 4, dtype=np.float32)[None]
             .repeat(2, 0)}
    n0 = conv3x3.launches
    gpu = make_eval_step("cuda")(flagship_model(H, W, device="cuda"), batch)
    assert conv3x3.launches - n0 == 14
    cpu = make_eval_step("cpu")(flagship_model(H, W, device="cpu"), batch)
    a, b = gpu["depth"].cpu().numpy(), cpu["depth"].numpy()
    assert np.abs(a - b).max() / np.abs(b).max() <= 1e-3


def _grid_scene(g, M, N, H, W, C):
    """Images and smooth grids that leave the image at its edges."""
    image = torch.rand(M, H, W, C, generator=g, device="cuda")
    ys = torch.linspace(-1.15, 1.15, H, device="cuda").view(1, H, 1)
    xs = torch.linspace(-1.1, 1.1, W, device="cuda").view(1, 1, W)
    n = torch.arange(N, device="cuda").view(N, 1, 1).float()
    gx = xs + 0.05 * torch.sin(6.28 * xs + n) * torch.cos(3.14 * ys)
    gy = ys + 0.25 * torch.cos(3.14 * xs + 0.5 * n)
    jit = (torch.rand(N, H, W, 2, generator=g, device="cuda") * 2 - 1) \
        * torch.tensor([2.0 / W, 1.5 / H], device="cuda")
    return image, (torch.stack([gx.expand(N, H, W), gy.expand(N, H, W)],
                               dim=-1) + jit).contiguous()


@pytest.mark.parametrize("padding", ["border", "zeros"])
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("dims", [(2, 4, 16, 128, 3, 4),
                                  (3, 6, 24, 200, 1, 8),
                                  (1, 2, 7, 33, 2, 4)])
def test_grid_warp_kernels_match_plain(cuda, mode, padding, dims):
    """Kernels E (every mode and padding) and F (bilinear) against their
    plain versions on the card: the coordinates are rounded once per
    operation on both, so the corners agree and the values bitwise."""
    from fsnet_tpu_torch.ops import warp_fast as twf

    M, N, H, W, C, band = dims
    g = torch.Generator(device=cuda).manual_seed(5)
    image, grid = _grid_scene(g, M, N, H, W, C)
    n_e, n_f = twf.grid_band_fwd.launches, twf.grid_band_fused.launches
    out = twf.grid_band_fwd(image, grid, mode, padding, band)
    ref = twf.grid_band_plain(image, grid, mode, padding, band)
    torch.cuda.synchronize()
    assert twf.grid_band_fwd.launches == n_e + 1
    assert out.shape == ref[0].shape == (N, H, W, C)
    assert (out - ref[0]).abs().max() <= 1e-6
    if mode == "nearest":
        ones = torch.ones(M, H, W, 1, device=cuda)
        mask = twf.grid_band_fwd(ones, grid, mode, padding, band)
        assert torch.equal(mask == 1.0, twf.grid_band_plain(
            ones, grid, mode, padding, band, False)[0] == 1.0)
        return
    got = twf.grid_band_fused(image, grid, padding, band)
    torch.cuda.synchronize()
    assert twf.grid_band_fused.launches == n_f + 1
    for a, r in zip(got, ref):
        assert (a - r).abs().max() <= 1e-6


@pytest.mark.parametrize("kind", ["mask", "learned_pose"])
def test_grid_route_train_step_on_card_matches_cpu(cuda, kind):
    """The grid-route train steps at a small size, on the card through
    kernels E and F, against the port on the CPU."""
    from fsnet_tpu_torch.entry import (flagship_model, flagship_optimizer,
                                       learned_pose_model, synthetic_batch)
    from fsnet_tpu_torch.ops import warp_depth as twd
    from fsnet_tpu_torch.ops import warp_fast as twf
    from fsnet_tpu_torch.runtime.state import make_train_step

    H, W, B = 64, 128, 2
    batch = synthetic_batch(B, H, W, patched_mask="ones" if kind == "mask"
                            else None)
    rng = np.random.RandomState(7)
    for key in sorted(batch):
        if key.startswith(("image/", "original_image/")):
            batch[key] = rng.rand(*batch[key].shape).astype(np.float32)
    build = flagship_model if kind == "mask" else learned_pose_model
    counters = (twf.grid_band_fused, twf.grid_band_fwd, twd.warp_depth_fwd)
    res = {}
    for dev in ("cuda", "cpu"):
        model = build(H, W, device=dev, seed=0)
        opt, _ = flagship_optimizer(model)
        before = [f.launches for f in counters]
        met = make_train_step(dev, with_grads=True)(model, opt, batch)
        ran = [f.launches - n for f, n in zip(counters, before)]
        res[dev] = (float(met["loss"]), met["_grads"], ran)
    assert res["cuda"][2] == [1, 1 if kind == "mask" else 0, 0]
    assert res["cpu"][2] == [0, 0, 0]
    assert abs(res["cuda"][0] - res["cpu"][0]) <= 1e-4 * abs(res["cpu"][0])
    keys = [k for k in res["cpu"][1]
            if not (".upconv_" in k and k.endswith(".conv.bias"))]
    num = sum(float(((res["cuda"][1][k].cpu() - res["cpu"][1][k]) ** 2).sum())
              for k in keys)
    den = sum(float((res["cpu"][1][k] ** 2).sum()) for k in keys)
    assert (num / den) ** 0.5 < 3e-2


def _mei_scene(g, S, F, B, H, W, C):
    """The fisheye batch's rays, camera and poses with random frames and
    norms of 2-40 m."""
    from fsnet_tpu_torch.entry import fisheye_batch
    from fsnet_tpu_torch.ops.warp_mei import make_mei_rows

    t = {k: torch.from_numpy(v).cuda() for k, v in
         fisheye_batch(B, H, W).items()}
    image = torch.rand(F * B, H, W, C, generator=g, device="cuda")
    norm = 2.0 + 38.0 * torch.rand(S * B, H, W, generator=g, device="cuda")
    Ts = torch.stack([t[f"relative_pose/{f}"] for f in (1, -1)][:F])
    rays = t["fisheye_rays"]
    return (image, rays[..., 3].contiguous(), norm,
            rays[..., :3].permute(0, 3, 1, 2).contiguous(),
            make_mei_rows(t["P2"], t["fisheye_params"], Ts, S))


@pytest.mark.parametrize("dims", [(2, 2, 2, 16, 128, 3, 16, None),
                                  (4, 2, 3, 24, 200, 3, 8, None),
                                  (1, 1, 2, 7, 33, 2, 4, None),
                                  (2, 2, 1, 16, 64, 3, 16, -1.0)])
def test_mei_warp_kernels_match_plain(cuda, dims):
    """Kernels G and H against their plain versions on the card: one
    rounding per operation on both, so the corners agree and the values
    bitwise. xi = -1 sends zh + xi + eps through 0: the coordinates that
    come out non-finite read inside the image on both."""
    from fsnet_tpu_torch.ops import warp_mei as twm

    S, F, B, H, W, C, band, xi = dims
    g = torch.Generator(device=cuda).manual_seed(6)
    image, mask, norm, rays, rows = _mei_scene(g, S, F, B, H, W, C)
    if xi is not None:
        rows[:, 12] = xi
    n0, n1 = twm.warp_mei_fwd.launches, twm.warp_mei_bwd.launches
    got = twm.warp_mei_fwd(image, mask, norm, rays, rows, S, F, band, True)
    ref = twm.warp_mei_plain(image, mask, norm, rays, rows, S, F, band, True)
    gy = torch.randn(got[0].shape, generator=g, device=cuda)
    dn = twm.warp_mei_bwd(norm, rays, gy, got[2], got[3], rows, S, F)
    dn_ref = twm.warp_mei_bwd_plain(norm, rays, gy, ref[2], ref[3], rows, S,
                                    F)
    torch.cuda.synchronize()
    assert twm.warp_mei_fwd.launches == n0 + 1
    assert twm.warp_mei_bwd.launches == n1 + 1
    assert torch.equal(got[1], ref[1])
    for a, r in zip((got[0], got[2], got[3]), (ref[0], ref[2], ref[3])):
        assert a.shape == r.shape and bool(torch.isfinite(a).all())
        assert (a - r).abs().max() <= 1e-6
    if xi is None:
        assert (dn - dn_ref).abs().max() <= 1e-6 * dn_ref.abs().max()
    else:
        assert torch.equal(torch.isfinite(dn), torch.isfinite(dn_ref))


def test_fisheye_train_step_on_card_matches_cpu(cuda):
    """The fisheye train step at a small size, on the card through kernels
    G and H, against the port on the CPU (the fisheye batch's images are
    white noise)."""
    from fsnet_tpu_torch.entry import (fisheye_batch, fisheye_model,
                                       flagship_optimizer)
    from fsnet_tpu_torch.ops import photo_loss as tpl
    from fsnet_tpu_torch.ops import warp_depth as twd
    from fsnet_tpu_torch.ops import warp_fast as twf
    from fsnet_tpu_torch.ops import warp_mei as twm
    from fsnet_tpu_torch.runtime.state import make_train_step

    H, W, B = 64, 128, 2
    batch = fisheye_batch(B, H, W)
    counters = (twm.warp_mei_fwd, twm.warp_mei_bwd, twf.grid_band_fused,
                twd.warp_depth_fwd, tpl.photo_loss_fwd, tpl.photo_loss_bwd)
    res = {}
    for dev in ("cuda", "cpu"):
        model = fisheye_model(H, W, device=dev, seed=0)
        opt, _ = flagship_optimizer(model)
        before = [f.launches for f in counters]
        met = make_train_step(dev, with_grads=True)(model, opt, batch)
        ran = [f.launches - n for f, n in zip(counters, before)]
        res[dev] = (float(met["loss"]), met["_grads"], ran)
    assert res["cuda"][2] == [1, 1, 0, 0, 2, 1]
    assert res["cpu"][2] == [0] * 6
    assert abs(res["cuda"][0] - res["cpu"][0]) <= 1e-4 * abs(res["cpu"][0])
    keys = [k for k in res["cpu"][1]
            if not (".upconv_" in k and k.endswith(".conv.bias"))]
    num = sum(float(((res["cuda"][1][k].cpu() - res["cpu"][1][k]) ** 2).sum())
              for k in keys)
    den = sum(float((res["cpu"][1][k] ** 2).sum()) for k in keys)
    assert (num / den) ** 0.5 < 3e-2


def _photo_scene(g, N, B, H, W, C):
    """Predictions and targets in [0, 1) with exact ties: a flat black patch
    in all of them (zero variance), prediction 0 equal to target 0 (pred ==
    target, SSIM dissimilarity 0)."""
    pred = torch.rand(N, H, W, C, generator=g, device="cuda")
    target = torch.rand(B, H, W, C, generator=g, device="cuda")
    target[:, :3, :3] = 0.0
    pred[:, :3, :3] = 0.0
    pred[0] = target[0]
    return pred, target


@pytest.mark.parametrize("dims", [(4, 2, 16, 64, 3), (6, 3, 9, 33, 3),
                                  (2, 1, 2, 5, 1), (3, 3, 5, 2, 2),
                                  (4, 2, 40, 70, 3)])
def test_photo_loss_kernels_match_plain(cuda, dims):
    """The photometric kernels against their plain versions on the card, at
    ragged tiles, images of height or width 2 (every row or column an edge)
    and 1-3 channels, with exact ties: the forward bitwise but for rounding
    (within 1e-6 of the largest loss), the cotangent within 1e-5 of its
    largest entry against the plain cotangent and against autograd of the
    plain forward."""
    from fsnet_tpu_torch.ops import photo_loss as tpl
    from fsnet_tpu_torch.ops.ssim import ssim_target_stats

    N, B, H, W, C = dims
    g = torch.Generator(device=cuda).manual_seed(8)
    pred, target = _photo_scene(g, N, B, H, W, C)
    muy, sy = ssim_target_stats(target)
    cot = torch.randn(N, H, W, generator=g, device=cuda)
    n0 = tpl.photo_loss_fwd.launches, tpl.photo_loss_bwd.launches
    got = tpl.photo_loss_fwd(pred, target, muy, sy)
    dx = tpl.photo_loss_bwd(pred, target, muy, sy, cot)
    torch.cuda.synchronize()
    assert (tpl.photo_loss_fwd.launches, tpl.photo_loss_bwd.launches) == \
        (n0[0] + 1, n0[1] + 1)
    ref = tpl.photo_loss_plain(pred, target, muy, sy)
    assert got.shape == ref.shape == (N, H, W)
    assert (got - ref).abs().max() <= 1e-6 * ref.abs().max()
    xr = pred.clone().requires_grad_(True)
    tpl.photo_loss_plain(xr, target, muy, sy).backward(cot)
    for r in (tpl.photo_loss_bwd_plain(pred, target, muy, sy, cot), xr.grad):
        assert dx.shape == r.shape
        assert (dx - r).abs().max() <= 1e-5 * r.abs().max()


def test_photo_loss_autograd_on_card_matches_cpu(cuda):
    """``reprojection_loss_fused`` under autograd: on the card through the
    kernels, on the CPU through the plain versions, from the same inputs."""
    from fsnet_tpu_torch.ops import photo_loss as tpl
    from fsnet_tpu_torch.ops.ssim import ssim_target_stats

    g = torch.Generator(device=cuda).manual_seed(9)
    pred, target = _photo_scene(g, 8, 2, 24, 80, 3)
    cot = torch.randn(8, 24, 80, generator=g, device=cuda)
    res = {}
    for dev in ("cuda", "cpu"):
        x = pred.detach().to(dev).requires_grad_(True)
        t = target.to(dev)
        n0 = tpl.photo_loss_fwd.launches, tpl.photo_loss_bwd.launches
        loss = tpl.reprojection_loss_fused(x, t, *ssim_target_stats(t))
        loss.backward(cot.to(dev))
        ran = (tpl.photo_loss_fwd.launches - n0[0],
               tpl.photo_loss_bwd.launches - n0[1])
        res[dev] = (loss.detach().cpu(), x.grad.cpu(), ran)
    assert res["cuda"][2] == (1, 1) and res["cpu"][2] == (0, 0)
    ref_l, ref_g = res["cpu"][0], res["cpu"][1]
    assert (res["cuda"][0] - ref_l).abs().max() <= 1e-6 * ref_l.abs().max()
    assert (res["cuda"][1] - ref_g).abs().max() <= 1e-5 * ref_g.abs().max()


def test_photo_loss_rejects_what_it_does_not_take(cuda):
    from fsnet_tpu_torch.ops import photo_loss as tpl

    pred = torch.rand(4, 8, 16, 3, device=cuda)
    target = torch.rand(2, 8, 16, 3, device=cuda)
    with pytest.raises(TypeError):
        tpl.photo_loss_fwd(pred.double(), target.double(), target.double(),
                           target.double())
    with pytest.raises(TypeError):
        tpl.photo_loss_fwd(pred, target.cpu(), target, target)
    with pytest.raises(ValueError):
        tpl.photo_loss_fwd(pred[:3], target, target, target)


@pytest.mark.parametrize("case", [
    # (M, N, H, W, Ho, Wo, C, mode, padding, band): a DCN's 9 taps against
    # its inputs (C = 64, 512), ragged shapes, every mode and padding
    (2, 18, 12, 40, 12, 40, 64, "bilinear", "zeros", 8),
    (1, 9, 6, 20, 6, 20, 512, "bilinear", "zeros", 6),
    (2, 4, 16, 128, 12, 100, 3, "bilinear", "border", 4),
    (3, 6, 9, 33, 9, 33, 2, "nearest", "zeros", 4),
], ids=lambda c: "-".join(map(str, c)))
def test_grid_bwd_kernel_matches_plain(cuda, case):
    """Kernel K against its plain version on the card (gfx, gfy and the
    image cotangent within 1e-5 of their largest entries: the channel sums
    and the atomic adds run in other orders), and kernel E on the same
    image grads' forward (within 1e-6)."""
    from fsnet_tpu_torch.ops import warp_fast as twf

    M, N, H, W, Ho, Wo, C, mode, padding, band = case
    g = torch.Generator(device=cuda).manual_seed(10)
    image, grid = _grid_scene(g, M, N, Ho, Wo, C)
    image = torch.rand(M, H, W, C, generator=g, device=cuda)
    cot = torch.randn(N, Ho, Wo, C, generator=g, device=cuda)
    n_e, n_k = twf.grid_band_fwd.launches, twf.grid_band_bwd.launches
    out = twf.grid_band_fwd(image, grid, mode, padding, band)
    got = twf.grid_band_bwd(image, grid, cot, mode, padding, band)
    torch.cuda.synchronize()
    assert (twf.grid_band_fwd.launches, twf.grid_band_bwd.launches) == \
        (n_e + 1, n_k + 1)
    ref_out = twf.grid_band_plain(image, grid, mode, padding, band, False)[0]
    assert (out - ref_out).abs().max() <= 1e-6
    ref = twf.grid_band_bwd_plain(image, grid, cot, mode, padding, band)
    for a, r in zip(got, ref):
        assert a.shape == r.shape and a.dtype == r.dtype
        assert (a - r).abs().max() <= 1e-5 * r.abs().max()


def test_grid_bwd_kernel_rejects_what_it_does_not_take(cuda):
    from fsnet_tpu_torch.ops import warp_fast as twf

    image = torch.rand(2, 8, 16, 3, device=cuda)
    grid = torch.zeros(4, 8, 16, 2, device=cuda)
    cot = torch.rand(4, 8, 16, 3, device=cuda)
    with pytest.raises(TypeError):
        twf.grid_band_bwd(image.double(), grid.double(), cot.double(),
                          "bilinear", "zeros", 4)
    with pytest.raises(ValueError):
        twf.grid_band_bwd(image, grid, cot.cpu(), "bilinear", "zeros", 4)
    with pytest.raises(ValueError):
        twf.grid_band_bwd(image, grid[:3], cot[:3], "bilinear", "zeros", 4)


def test_dcn_on_card_matches_cpu(cuda):
    """One deformable conv (``ModulatedDeformConvPack``, offsets of about
    1.5 px) forward and backward on the card, through kernels E and K once
    each, against the port on the CPU from the same weights."""
    from fsnet_tpu_torch.entry import perturb_offsets
    from fsnet_tpu_torch.models.backbones.dla_utils import DeformConv
    from fsnet_tpu_torch.models.blocks import init_params
    from fsnet_tpu_torch.ops import warp_fast as twf

    x = torch.rand(2, 12, 40, 64, generator=torch.Generator().manual_seed(3))
    r = torch.rand(2, 12, 40, 32, generator=torch.Generator().manual_seed(4))
    res = {}
    for dev in ("cuda", "cpu"):
        m = DeformConv(64, 32)
        init_params(m, torch.Generator().manual_seed(0))
        perturb_offsets(m, 1.5, 0)
        m.to(dev)
        xd = x.to(dev).requires_grad_(True)
        n0 = twf.grid_band_fwd.launches, twf.grid_band_bwd.launches
        out = m(xd, train=True)
        (out * r.to(dev)).sum().backward()
        ran = (twf.grid_band_fwd.launches - n0[0],
               twf.grid_band_bwd.launches - n0[1])
        grads = {k: p.grad.cpu() for k, p in m.named_parameters()}
        grads["x"] = xd.grad.cpu()
        res[dev] = (out.detach().cpu(), grads, ran)
    assert res["cuda"][2] == (1, 1) and res["cpu"][2] == (0, 0)
    a, b = res["cuda"][0], res["cpu"][0]
    assert (a - b).abs().max() <= 1e-5 * b.abs().max()
    for k, ref in res["cpu"][1].items():
        if k == "conv.bias":        # BN cancels it: rounding noise both sides
            continue
        got = res["cuda"][1][k]
        assert (got - ref).norm() <= 1e-4 * ref.norm(), k


def test_dla_train_step_on_card_matches_cpu(cuda):
    """The DLA step at a small size on the card (16 launches of E and 16 of
    K, nothing else of the port's kernels) against the CPU port, every BN
    on its init statistics, held to the JAX package's gate between two
    routes: loss rel 1e-4, global gradient rel-L2 3e-2, every leaf 0.5.
    (With batch statistics float32 rounding alone moves this gradient by
    several percent: ``scripts/dla_conditioning.py``.)"""
    from fsnet_tpu_torch.entry import dla_batch, dla_model
    from fsnet_tpu_torch.ops import warp_fast as twf

    batch = dla_batch(2, 64, 128)
    counters = (twf.grid_band_fwd, twf.grid_band_bwd, twf.grid_band_fused)
    res = {}
    for dev in ("cuda", "cpu"):
        model = dla_model(64, 128, device=dev, seed=0, norm_frozen=True)
        before = [f.launches for f in counters]
        data = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        loss = model.forward_train(data, {})["loss"]
        grads = torch.autograd.grad(loss, list(model.parameters()),
                                    allow_unused=True)
        ran = [f.launches - n for f, n in zip(counters, before)]
        names = [k for k, _ in model.named_parameters()]
        res[dev] = (loss.item(), {
            k: g.detach().cpu().double() for k, g in zip(names, grads)
            if g is not None}, ran)
    card, cpu = res["cuda"], res["cpu"]
    assert card[2] == [16, 16, 0] and cpu[2] == [0, 0, 0]
    assert abs(card[0] - cpu[0]) <= 1e-4 * abs(cpu[0])
    num = sum(float(((card[1][k] - cpu[1][k]) ** 2).sum()) for k in cpu[1])
    den = sum(float((cpu[1][k] ** 2).sum()) for k in cpu[1])
    assert (num / den) ** 0.5 < 3e-2
    for k, ref in cpu[1].items():
        assert (card[1][k] - ref).norm() <= 0.5 * ref.norm(), k
