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


# (B, H, W, Cs, Co, pad_mode): ragged tiles, the decoder's two-part Cin=96
# and 256 convs, every tile width of the pixels, channel counts off the MMA
# depth (3, 40), H = 1, W = 1, W = 7, both paddings; the last three have
# grids large enough for the host to keep 32- and 64-channel tiles (the
# forward's and the input cotangent's), with 16-byte copies and without
SHAPES = [
    (2, 6, 20, (512,), 256, "zeros"),
    (2, 12, 40, (128, 128), 128, "replicate"),
    (1, 9, 33, (32, 64), 32, "replicate"),
    (3, 17, 70, (16,), 16, "replicate"),
    (2, 5, 7, (3,), 40, "zeros"),
    (2, 1, 37, (40,), 16, "replicate"),
    (1, 23, 1, (32, 64), 40, "zeros"),
    (2, 11, 7, (3,), 256, "replicate"),
    (1, 10, 24, (16,), 16, "zeros"),
    (2, 7, 9, (128, 128), 256, "zeros"),
    (3, 64, 96, (32, 32), 64, "replicate"),
    (3, 64, 96, (64,), 32, "zeros"),
    (3, 64, 96, (3,), 64, "replicate"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [s + (bias,) for s, bias in zip(
    SHAPES, (True, True, True, False, True, False, True, False, True, False,
             True, False, True))])
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


@pytest.mark.parametrize("shape", SHAPES)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_conv_gradient_kernels_match_plain(cuda, shape, dtype):
    """dx (the conv kernel's input-cotangent mode: one launch for all
    parts, the halo fold in its epilogue) and dw (csrc/conv3x3_dw.cu, a
    float32 cotangent of float32 or bfloat16 operands) against their plain
    versions."""
    from fsnet_tpu_torch.ops import conv3x3 as tc

    B, H, W, Cs, Co, pad_mode = shape
    g = torch.Generator(device=cuda).manual_seed(2)
    parts = [_randn(g, B, H, W, c).to(dtype) for c in Cs]
    w = _randn(g, 3, 3, sum(Cs), Co, scale=1 / np.sqrt(9 * sum(Cs))).to(dtype)
    gy = _randn(g, B, H, W, Co).to(dtype)
    n_dx, n_dw = tc.conv3x3_dx.launches, tc.conv3x3_dw.launches
    dxs = tc.conv3x3_dx(gy, w, pad_mode, Cs)
    torch.cuda.synchronize()
    assert tc.conv3x3_dx.launches == n_dx + 1
    ref_dxs = tc.conv3x3_dx_plain(gy, w, pad_mode, Cs)
    tol = 1e-4 if dtype == torch.float32 else TOL[dtype]
    for a, r in zip(dxs, ref_dxs):
        assert a.shape == r.shape and a.dtype == dtype
        assert (a.float() - r.float()).abs().max() <= \
            tol * r.float().abs().max()
    dw = tc.conv3x3_dw(parts, gy, pad_mode)
    torch.cuda.synchronize()
    assert tc.conv3x3_dw.launches == n_dw + 1
    ref_dw = tc.conv3x3_dw_plain(parts, gy, pad_mode)
    assert dw.shape == ref_dw.shape and dw.dtype == torch.float32
    assert (dw - ref_dw).abs().max() <= 1e-4 * ref_dw.abs().max()


def _bf16_ulp(t):
    """One bfloat16 ulp at |t| elementwise (0 at 0)."""
    a = t.float().abs()
    e = torch.frexp(a).exponent
    return torch.where(a > 0, torch.ldexp(torch.ones_like(a), e - 8),
                       torch.zeros_like(a))


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_moments_kernel_matches_plain(cuda, shape):
    """The moments kernel on bfloat16 operands: the stored bf16 output
    within one bf16 ulp of the plain one beyond 2e-5 of its largest entry
    (two float32 sums in other orders), the float32 moments the sums of
    that stored output (1e-5 of the sum of |summands|)."""
    from fsnet_tpu_torch.ops.conv3x3 import conv3x3_bn, conv3x3_plain

    B, H, W, Cs, Co, pad_mode = shape
    g = torch.Generator(device=cuda).manual_seed(1)
    parts = [_randn(g, B, H, W, c).bfloat16() for c in Cs]
    w = _randn(g, 3, 3, sum(Cs), Co,
               scale=1 / np.sqrt(9 * sum(Cs))).bfloat16()
    b = _randn(g, Co, scale=0.1).bfloat16()
    n0 = conv3x3_bn.dtypes["bfloat16"]
    out, s1, s2 = conv3x3_bn(parts, w, b, pad_mode)
    torch.cuda.synchronize()
    assert conv3x3_bn.dtypes["bfloat16"] == n0 + 1
    assert out.dtype == torch.bfloat16 and s1.dtype == torch.float32
    ref = conv3x3_plain(parts, w, b, pad_mode).float()
    got = out.float()
    big = torch.maximum(got.abs(), ref.abs())
    assert bool(((got - ref).abs() <= _bf16_ulp(big)
                 + 2e-5 * ref.abs().max()).all())
    assert (s1 - got.sum((0, 1, 2))).abs().max() <= \
        1e-5 * got.abs().sum((0, 1, 2)).max()
    assert (s2 - (got * got).sum((0, 1, 2))).abs().max() <= \
        1e-5 * (got * got).sum((0, 1, 2)).max()


@pytest.mark.parametrize("dims", [(4, 2, 16, 64, 3), (6, 3, 9, 33, 3),
                                  (96, 12, 20, 136, 3)])
def test_bf16_photo_loss_kernels_match_plain(cuda, dims):
    """Kernels I and J on bfloat16 operands (both routes: the vector one
    where it applies) against their plain versions: the loss and the
    cotangent bitwise equal to the rounding of the float32 kernels'
    results on the widened operands."""
    from fsnet_tpu_torch.ops import photo_loss as tpl
    from fsnet_tpu_torch.ops.ssim import ssim_target_stats

    N, B, H, W, C = dims
    g = torch.Generator(device=cuda).manual_seed(8)
    pred, target = (t.bfloat16() for t in _photo_scene(g, N, B, H, W, C))
    muy, sy = ssim_target_stats(target)
    cot = torch.randn(N, H, W, generator=g, device=cuda).bfloat16()
    wide = [t.float() for t in (pred, target, muy, sy, cot)]
    for route in tpl.ROUTES:
        if route == "vector" and tpl.photo_route(pred, target, muy, sy,
                                                 cot) != "vector":
            continue
        loss = tpl._launch_fwd(route, pred, target, muy, sy)
        dx = tpl._launch_bwd(route, pred, target, muy, sy, cot)
        torch.cuda.synchronize()
        assert loss.dtype == dx.dtype == torch.bfloat16
        assert torch.equal(loss, tpl.photo_loss_plain(pred, target, muy,
                                                      sy))
        assert torch.equal(loss, tpl._launch_fwd(route, *wide[:4]).bfloat16())
        assert torch.equal(dx, tpl._launch_bwd(route, *wide).bfloat16())
        ref = tpl.photo_loss_bwd_plain(pred, target, muy, sy, cot).float()
        assert (dx.float() - ref).abs().max() <= 1e-5 * ref.abs().max() \
            + _bf16_ulp(ref).max()


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


@pytest.mark.parametrize("dims", [(2, 2, 2, 16, 128, 3),
                                  (1, 2, 1, 7, 33, 2)])
def test_bf16_depth_bwd_kernel_matches_plain(cuda, dims):
    """Kernel B's bfloat16 form (bf16 g, va, vb; gfx, gfy formed in the
    kernel) against its plain version on the same operands, at the
    float32 kernel's gate, and counted under bfloat16."""
    from fsnet_tpu_torch.ops import warp_depth as twd

    S, F, B, H, W, C = dims
    g = torch.Generator(device=cuda).manual_seed(5)
    _, depth, arows = _warp_scene(g, S, F, B, H, W, C)
    gy, va, vb = (torch.randn(S * F * B, H, W, C, generator=g,
                              device=cuda).bfloat16() for _ in range(3))
    n0 = twd.warp_depth_bwd.dtypes["bfloat16"]
    dd = twd.warp_depth_bwd(depth, gy, va, vb, arows, S, F)
    ref = twd.warp_depth_bwd_plain(depth, gy, va, vb, arows, S, F)
    torch.cuda.synchronize()
    assert twd.warp_depth_bwd.dtypes["bfloat16"] == n0 + 1
    assert dd.dtype == torch.float32
    assert (dd - ref).abs().max() <= 1e-5 * ref.abs().max()


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
    assert res["cuda"][2] == [4, 10, 14, 14, 1, 1, 2, 1]
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


@pytest.mark.parametrize("dims", [(2, 2, 2, 16, 128, 3, 4),
                                  (4, 2, 3, 24, 200, 3, 4),
                                  (1, 2, 1, 7, 36, 2, 8),
                                  (1, 1, 2, 9, 1028, 1, 4)])
def test_warp_depth_routes_match_plain(cuda, dims):
    """Kernel A's two routes at rows the vector route takes (W % 4 == 0;
    at W = 1028 31 lanes of the last warp hold no pixel; C = 1, 2 run the
    kernel's run-time channel loop), each launched twice: out, va, vb and
    the overlap bitwise equal launch to launch, route to route and to the
    plain version; the public wrapper takes the vector route."""
    from fsnet_tpu_torch.ops import warp_depth as twd

    S, F, B, H, W, C, band = dims
    g = torch.Generator(device=cuda).manual_seed(14)
    image, depth, arows = _warp_scene(g, S, F, B, H, W, C)
    assert twd.proj_route(image, depth, arows) == "vector"
    r0 = dict(twd.warp_depth_fwd.routes)
    runs = [twd._launch_fwd(r, image, depth, arows, S, F, band)
            for r in ("vector", "narrow", "narrow", "vector")]
    runs.append(twd.warp_depth_fwd(image, depth, arows, S, F, band))
    torch.cuda.synchronize()
    assert twd.warp_depth_fwd.routes == dict(narrow=r0["narrow"] + 2,
                                             vector=r0["vector"] + 3)
    ref = twd.warp_depth_plain(image, depth, arows, S, F, band)
    for got in runs:
        for a, r in zip(got, ref):
            assert a.shape == r.shape and a.dtype == r.dtype
            assert torch.equal(a, r)


@pytest.mark.parametrize("with_mask", [True, False], ids=["mask", "no_mask"])
@pytest.mark.parametrize("dims", [(2, 2, 2, 16, 128, 3, 16, None),
                                  (4, 2, 3, 24, 200, 3, 8, None),
                                  (1, 1, 2, 8, 36, 2, 4, None),
                                  (2, 2, 1, 16, 64, 3, 16, -1.0)])
def test_mei_warp_routes_match_plain(cuda, dims, with_mask):
    """Kernel G's two routes at rows the vector route takes, with and
    without the mask pass (xi = -1 sends some coordinates non-finite), each
    launched twice: out, va, vb and the overlap bitwise equal launch to
    launch, route to route and to the plain version; the public wrapper
    takes the vector route."""
    from fsnet_tpu_torch.ops import warp_depth as twd
    from fsnet_tpu_torch.ops import warp_mei as twm

    S, F, B, H, W, C, band, xi = dims
    g = torch.Generator(device=cuda).manual_seed(15)
    scene = _mei_scene(g, S, F, B, H, W, C)
    if xi is not None:
        scene[4][:, 12] = xi
    assert twd.proj_route(*scene) == "vector"
    r0 = dict(twm.warp_mei_fwd.routes)
    runs = [twm._launch_fwd(r, *scene, S, F, band, with_mask)
            for r in ("vector", "narrow", "narrow", "vector")]
    runs.append(twm.warp_mei_fwd(*scene, S, F, band, with_mask))
    torch.cuda.synchronize()
    assert twm.warp_mei_fwd.routes == dict(narrow=r0["narrow"] + 2,
                                           vector=r0["vector"] + 3)
    ref = twm.warp_mei_plain(*scene, S, F, band, with_mask)
    for got in runs:
        assert (got[1] is None) == (ref[1] is None) == (not with_mask)
        for a, r in zip(got, ref):
            if r is not None:
                assert a.shape == r.shape and a.dtype == r.dtype
                assert bool(torch.isfinite(a.float()).all())
                assert torch.equal(a, r)


@pytest.mark.parametrize("what", ["offset", "width"])
@pytest.mark.parametrize("kernel", ["A", "G"])
def test_proj_warp_vector_route_refuses_what_it_does_not_take(cuda, kernel,
                                                             what):
    """The vector route's entry points of kernels A and G refuse an operand
    4 bytes off a 16-byte boundary and W % 4 != 0 (a raised error, no
    fallback to the narrow route)."""
    from fsnet_tpu_torch.ops import warp_depth as twd
    from fsnet_tpu_torch.ops import warp_mei as twm

    S, F, B, H, W, C = 2, 2, 1, 8, 18 if what == "width" else 16, 3
    g = torch.Generator(device=cuda).manual_seed(16)
    if kernel == "A":
        fn, launch = twd.warp_depth_fwd, twd._launch_fwd
        args = list(_warp_scene(g, S, F, B, H, W, C)) + [S, F, 4]
    else:
        fn, launch = twm.warp_mei_fwd, twm._launch_fwd
        args = list(_mei_scene(g, S, F, B, H, W, C)) + [S, F, 4, True]
    if what == "offset":
        args[0] = _unaligned(args[0])
        assert args[0].is_contiguous() and args[0].data_ptr() % 16
    assert twd.proj_route(*args[:-3 if kernel == "A" else -4]) == "narrow"
    n0, r0 = fn.launches, dict(fn.routes)
    with pytest.raises(RuntimeError):
        launch("vector", *args)
    assert (fn.launches, fn.routes) == (n0, r0)


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


@pytest.mark.parametrize("route", ["auto", "narrow"])
@pytest.mark.parametrize("dims", [(4, 2, 16, 64, 3), (6, 3, 9, 33, 3),
                                  (2, 1, 2, 5, 1), (3, 3, 5, 2, 2),
                                  (4, 2, 40, 70, 3), (96, 12, 20, 136, 3),
                                  (8, 2, 13, 64, 3), (6, 3, 2, 4, 3),
                                  (4, 2, 11, 132, 4)])
def test_photo_loss_kernels_match_plain(cuda, dims, route):
    """The photometric kernels against their plain versions on the card, at
    ragged tiles, images of height or width 2 (every row or column an edge)
    and 1-4 channels, with exact ties: the forward within 1e-6 of the
    largest loss, the cotangent within 1e-5 of its largest entry against
    the plain cotangent and against autograd of the plain forward. With
    ``route="auto"`` the wrappers take :func:`photo_route`'s route: the
    vector route (bitwise forward) wherever C <= 4 and W % 4 == 0, the
    flagship's 96 predictions against 12 targets among them; with
    ``"narrow"`` the launchers run the narrow route at every shape."""
    from fsnet_tpu_torch.ops import photo_loss as tpl
    from fsnet_tpu_torch.ops.ssim import ssim_target_stats

    N, B, H, W, C = dims
    g = torch.Generator(device=cuda).manual_seed(8)
    pred, target = _photo_scene(g, N, B, H, W, C)
    muy, sy = ssim_target_stats(target)
    cot = torch.randn(N, H, W, generator=g, device=cuda)
    want = tpl.photo_route(pred, target, muy, sy, cot) if route == "auto" \
        else route
    assert want == ("vector" if route == "auto" and C <= 4 and W % 4 == 0
                    else "narrow")
    n0 = tpl.photo_loss_fwd.launches, tpl.photo_loss_bwd.launches
    r0 = tpl.photo_loss_fwd.routes[want], tpl.photo_loss_bwd.routes[want]
    if route == "auto":
        got = tpl.photo_loss_fwd(pred, target, muy, sy)
        dx = tpl.photo_loss_bwd(pred, target, muy, sy, cot)
    else:
        got = tpl._launch_fwd(route, pred, target, muy, sy)
        dx = tpl._launch_bwd(route, pred, target, muy, sy, cot)
    torch.cuda.synchronize()
    assert (tpl.photo_loss_fwd.launches, tpl.photo_loss_bwd.launches) == \
        (n0[0] + 1, n0[1] + 1)
    assert (tpl.photo_loss_fwd.routes[want],
            tpl.photo_loss_bwd.routes[want]) == (r0[0] + 1, r0[1] + 1)
    ref = tpl.photo_loss_plain(pred, target, muy, sy)
    assert got.shape == ref.shape == (N, H, W)
    assert (got - ref).abs().max() <= 1e-6 * ref.abs().max()
    if want == "vector":
        assert torch.equal(got, ref)
    xr = pred.clone().requires_grad_(True)
    tpl.photo_loss_plain(xr, target, muy, sy).backward(cot)
    for r in (tpl.photo_loss_bwd_plain(pred, target, muy, sy, cot), xr.grad):
        assert dx.shape == r.shape
        assert (dx - r).abs().max() <= 1e-5 * r.abs().max()


@pytest.mark.parametrize("what", ["offset", "width", "channels"])
def test_photo_loss_vector_route_refuses_what_it_does_not_take(cuda, what):
    """The vector route's entry points refuse an operand 4 bytes off a
    16-byte boundary, W % 4 != 0 and C > 4 (a raised error, no fallback
    to the narrow route)."""
    from fsnet_tpu_torch.ops import photo_loss as tpl

    N, B, H, W, C = 4, 2, 8, 16, 3
    if what == "width":
        W = 18
    elif what == "channels":
        C = 5
    pred = torch.rand(N, H, W, C, device=cuda)
    target = torch.rand(B, H, W, C, device=cuda)
    if what == "offset":
        pred = _unaligned(pred)
        assert pred.is_contiguous() and pred.data_ptr() % 16
    cot = torch.rand(N, H, W, device=cuda)
    assert tpl.photo_route(pred, target, target, target, cot) == "narrow"
    n0 = tpl.photo_loss_fwd.launches, tpl.photo_loss_bwd.launches
    with pytest.raises(RuntimeError):
        tpl._launch_fwd("vector", pred, target, target, target)
    with pytest.raises(RuntimeError):
        tpl._launch_bwd("vector", pred, target, target, target, cot)
    assert (tpl.photo_loss_fwd.launches, tpl.photo_loss_bwd.launches) == n0


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


def _unaligned(t):
    """A contiguous copy of ``t`` whose data starts 4 bytes past a 16-byte
    boundary."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return out.view(t.shape).copy_(t)


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset"])
@pytest.mark.parametrize("padding", ["border", "zeros"])
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("case", [
    # (M, N, H, W, Ho, Wo, C, band): a DCN's 9 taps against its inputs at
    # C = 64 (2 samples a warp on the channel-wide route, Wo odd) and 512
    # (4 slices of 128 channels); C = 128 (one sample a warp); C = 4 (32
    # samples a warp, Wo = 21) and 12 (8 samples a warp, one lane of 4
    # idle, Wo = 19); C = 1, 2, 3 and 67 (the narrow route)
    (2, 18, 12, 41, 12, 41, 64, 8),
    (1, 9, 6, 20, 6, 20, 512, 6),
    (2, 4, 12, 37, 10, 29, 128, 8),
    (2, 4, 9, 21, 9, 21, 4, 4),
    (2, 6, 8, 19, 8, 19, 12, 4),
    (1, 3, 7, 13, 7, 13, 1, 4),
    (3, 6, 9, 33, 9, 33, 2, 4),
    (2, 4, 16, 128, 12, 100, 3, 4),
    (1, 3, 10, 23, 10, 23, 67, 8),
], ids=lambda c: "-".join(map(str, c)))
def test_grid_bwd_kernel_matches_plain(cuda, case, mode, padding, aligned):
    """Kernels E and K on both routes against their plain versions on the
    card: E bitwise, K's gfx, gfy and image cotangent within 1e-5 of their
    largest entries (the channel sums and the atomic adds run in other
    orders). C a multiple of 4 with aligned operands takes the channel-wide
    route; C <= 3, a ragged C or an image and cotangent 4 bytes off a
    16-byte boundary take the narrow one, and match all the same."""
    from fsnet_tpu_torch.ops import warp_fast as twf

    M, N, H, W, Ho, Wo, C, band = case
    g = torch.Generator(device=cuda).manual_seed(10)
    image, grid = _grid_scene(g, M, N, Ho, Wo, C)
    image = torch.rand(M, H, W, C, generator=g, device=cuda)
    cot = torch.randn(N, Ho, Wo, C, generator=g, device=cuda)
    if not aligned:
        image, cot = _unaligned(image), _unaligned(cot)
        assert image.is_contiguous() and image.data_ptr() % 16
    want = "vector" if C % 4 == 0 and aligned else "narrow"
    # kernel E takes the row route where the channel-wide one does not
    # apply and the row does (C = 3 at Wo = 100)
    want_e = "row" if want == "narrow" and aligned and Wo % 4 == 0 else want
    n_e, n_k = twf.grid_band_fwd.launches, twf.grid_band_bwd.launches
    r_e, r_k = twf.grid_band_fwd.routes[want_e], \
        twf.grid_band_bwd.routes[want]
    out = twf.grid_band_fwd(image, grid, mode, padding, band)
    got = twf.grid_band_bwd(image, grid, cot, mode, padding, band)
    torch.cuda.synchronize()
    assert (twf.grid_band_fwd.launches, twf.grid_band_bwd.launches) == \
        (n_e + 1, n_k + 1)
    assert (twf.grid_band_fwd.routes[want_e],
            twf.grid_band_bwd.routes[want]) == (r_e + 1, r_k + 1)
    ref_out = twf.grid_band_plain(image, grid, mode, padding, band, False)[0]
    assert torch.equal(out, ref_out)
    ref = twf.grid_band_bwd_plain(image, grid, cot, mode, padding, band)
    for a, r in zip(got, ref):
        assert a.shape == r.shape and a.dtype == r.dtype
        assert (a - r).abs().max() <= 1e-5 * r.abs().max()


@pytest.mark.parametrize("kind", ["F", "E-bilinear-border", "E-nearest-zeros",
                                  "E-bilinear-zeros", "E-nearest-border"])
@pytest.mark.parametrize("case", [
    # (M, N, H, W, Ho, Wo, C, band): the recipes' C = 3 and 1 at rows the
    # row route takes; C = 2 and 5 run its run-time channel loop; at
    # Wo = 1028 31 lanes of the last warp hold no sample; Ho, Wo != H, W
    (2, 4, 16, 128, 16, 128, 3, 4),
    (3, 6, 24, 200, 24, 200, 1, 8),
    (1, 2, 9, 36, 9, 36, 2, 4),
    (1, 2, 7, 1028, 7, 1028, 1, 4),
    (2, 4, 12, 40, 10, 32, 5, 4),
], ids=lambda c: "-".join(map(str, c)))
def test_grid_warp_routes_match_plain(cuda, case, kind):
    """Kernels E and F on their row and narrow routes, each launched twice
    in turns (row, narrow, narrow, row), and through the public wrapper
    (the row route): every output bitwise equal to the plain version, and
    so route to route and launch to launch."""
    from fsnet_tpu_torch.ops import warp_fast as twf

    M, N, H, W, Ho, Wo, C, band = case
    g = torch.Generator(device=cuda).manual_seed(17)
    _, grid = _grid_scene(g, M, N, Ho, Wo, C)
    image = torch.rand(M, H, W, C, generator=g, device=cuda)
    fused = kind == "F"
    mode, padding = ("bilinear", "border") if fused else kind.split("-")[1:]
    fn = twf.grid_band_fused if fused else twf.grid_band_fwd
    assert twf.warp_route(image, grid=grid, fused=fused) == "row"
    r0 = dict(fn.routes)
    runs = [twf._launch_grid(r, image, grid, mode, padding, band, fused)
            for r in ("row", "narrow", "narrow", "row")]
    runs.append(twf.grid_band_fused(image, grid, padding, band) if fused
                else twf.grid_band_fwd(image, grid, mode, padding, band))
    torch.cuda.synchronize()
    assert fn.routes == dict(r0, narrow=r0["narrow"] + 2, row=r0["row"] + 3)
    ref = twf.grid_band_plain(image, grid, mode, padding, band, fused)
    for got in runs:
        for a, r in zip(got if fused else (got,), ref):
            assert a.shape == r.shape == (N, Ho, Wo, C)
            assert torch.equal(a, r)


@pytest.mark.parametrize("what", ["offset", "grid-offset", "width"])
@pytest.mark.parametrize("kernel", ["E", "F"])
def test_grid_row_route_refuses_what_it_does_not_take(cuda, kernel, what):
    """The row route's entry points of kernels E and F refuse an image or a
    grid 4 bytes off a 16-byte boundary and Wo % 4 != 0 (a raised error, no
    fallback to the narrow route)."""
    from fsnet_tpu_torch.ops import warp_fast as twf

    g = torch.Generator(device=cuda).manual_seed(18)
    Wo = 18 if what == "width" else 16
    image, grid = _grid_scene(g, 2, 4, 8, Wo, 3)
    if what == "offset":
        image = _unaligned(image)
    elif what == "grid-offset":
        grid = _unaligned(grid)
    fused = kernel == "F"
    assert twf.warp_route(image, grid=grid, fused=fused) == "narrow"
    fn = twf.grid_band_fused if fused else twf.grid_band_fwd
    n0, r0 = fn.launches, dict(fn.routes)
    with pytest.raises(RuntimeError):
        twf._launch_grid("row", image, grid, "bilinear", "border", 4, fused)
    assert (fn.launches, fn.routes) == (n0, r0)


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


# the nuScenes recipes' new conv widths at their 288x512 frame, batch 2:
# Co = 64 (the 64-bin dispconvs) and Co = 1 (the uncertain convs: one
# 8-channel chunk with 7 channels masked in the cotangent, the output tile
# padded to 16, no 16-byte copies, dw on its scalar route), at the finest
# and a coarser scale
NUSC_CONV_SHAPES = [
    (2, 288, 512, (16,), 64, "replicate"),
    (2, 36, 64, (128,), 64, "replicate"),
    (2, 288, 512, (16,), 1, "replicate"),
    (2, 72, 128, (64,), 1, "replicate"),
]


@pytest.mark.parametrize("shape", NUSC_CONV_SHAPES,
                         ids=lambda s: f"{s[1]}x{s[2]}-{s[3][0]}to{s[4]}")
def test_conv_kernels_at_nuscenes_widths(cuda, shape):
    """Forward, moments, dx and dw against their plain versions at the
    gates of ``chip_smoke.py`` phase 8: forward 1e-4 of max |ref|; the
    moments kernel's stored output, s2, dx and dw 2e-5; s1 2e-5 of the sum
    of |out|."""
    from fsnet_tpu_torch.ops import conv3x3 as tc

    B, H, W, Cs, Co, pad_mode = shape
    g = torch.Generator(device=cuda).manual_seed(3)
    parts = [_randn(g, B, H, W, c) for c in Cs]
    w = _randn(g, 3, 3, sum(Cs), Co, scale=1 / np.sqrt(9 * sum(Cs)))
    b = _randn(g, Co, scale=0.1)
    gy = _randn(g, B, H, W, Co)
    ref = tc.conv3x3_plain(parts, w, b, pad_mode)

    def rel(a, r, scale=None):
        den = r.abs().max() if scale is None else scale
        return float((a.double() - r.double()).abs().max() / den)

    out = tc.conv3x3(parts, w, b, pad_mode)
    y, s1, s2 = tc.conv3x3_bn(parts, w, b, pad_mode)
    dxs = tc.conv3x3_dx(gy, w, pad_mode, Cs)
    dw = tc.conv3x3_dw(parts, gy, pad_mode)
    torch.cuda.synchronize()
    r1, r2 = tc.moments_plain(ref)
    assert rel(out, ref) <= 1e-4
    assert rel(y, ref) <= 2e-5
    assert rel(s1, r1, ref.abs().sum((0, 1, 2)).max()) <= 2e-5
    assert rel(s2, r2) <= 2e-5
    for a, r in zip(dxs, tc.conv3x3_dx_plain(gy, w, pad_mode, Cs)):
        assert a.shape == r.shape and rel(a, r) <= 2e-5
    assert rel(dw, tc.conv3x3_dw_plain(parts, gy, pad_mode)) <= 2e-5


def test_distill_train_step_on_card_keeps_the_teacher(cuda):
    """One ``DistillWPoseMeta`` step at a small size on the card: the
    teacher (grafted from a seeded ``MonoDepthWPose``) keeps its parameters
    and BN statistics bit for bit, the student moves, and every conv of
    both runs through the kernels (the teacher's 14 in eval mode)."""
    from fsnet_tpu_torch.entry import (NUSC_RECIPE, distill_config,
                                       distill_model, flagship_model,
                                       nusc_batch, recipe_optimizer)
    from fsnet_tpu_torch.ops import conv3x3 as tc
    from fsnet_tpu_torch.ops import warp_fast as twf
    from fsnet_tpu_torch.runtime.state import make_train_step

    H, W, B = 64, 128, 2
    teacher = flagship_model(H, W, device=cuda, seed=1)
    model = distill_model(H, W, device=cuda,
                          teacher_state=teacher.state_dict())
    opt, _ = recipe_optimizer(model, NUSC_RECIPE, distill_config(H, W))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    counters = (tc.conv3x3, tc.conv3x3_bn, tc.conv3x3_dx, tc.conv3x3_dw,
                twf.grid_band_fused, twf.grid_band_fwd)
    n0 = [f.launches for f in counters]
    met = make_train_step(cuda)(model, opt, nusc_batch(B, H, W))
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(counters, n0)] == \
        [22, 10, 18, 18, 1, 1]
    assert np.isfinite(float(met["loss"]))
    assert sorted(k for k in met if k.startswith("distilation/")) == [
        f"distilation/{s}" for s in range(4)]
    after = model.state_dict()
    for k, v in before.items():
        if k.startswith("teacher_net."):
            assert torch.equal(after[k], v), k
    moved = [k for k, v in before.items() if not k.startswith("teacher_net.")
             and not torch.equal(after[k], v)]
    assert len(moved) > 100
