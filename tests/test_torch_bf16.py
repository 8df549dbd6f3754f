"""The port's bfloat16 train step and the bf16 forms of its kernels (on the
CPU: their plain versions) against the JAX package, from the same numpy
inputs. Tolerances, with the values measured when this file was written:

* Kernel #2 (``conv3x3_fused_mats_m``, interpreted at bf16) against
  :func:`~fsnet_tpu_torch.ops.conv3x3.conv3x3_bn`: the stored bf16 outputs
  within one bf16 ulp elementwise (both round a float32 sum; the two sums
  run in other orders, so a value that lies near a rounding boundary may
  round apart: the share that is not bitwise equal is printed); the
  moments on each side are float32 sums of that side's stored output,
  within float32 rounding (1e-5 rel) of its float64 sum. A two-part input
  goes to JAX as its materialized concat: the TPU composite rounds part
  0's output to bf16 before the moments kernel adds part 1 to it
  (``fast_conv._conv3x3_forward_pallas_bn``, ``prev=out``), a second
  rounding that the XLA route's ``nn.Conv`` on the concat does not make,
  nor the port, whose kernel sums both parts into one float32 sum.
* Kernel #3 (``conv3x3_fused_dw``, interpreted at bf16) against
  :func:`~fsnet_tpu_torch.ops.conv3x3.conv3x3_dw` on the same bf16
  operands: both float32, within float32 rounding (rtol 1e-5, atol 1e-4
  scaled by the magnitude, as ``tests/test_torch_conv3x3_train.py``).
* Kernel #12 (``photo_loss_pallas`` at bf16, on the port's bf16 target
  stats): the loss within one bf16 ulp. Kernel #13
  (``photo_loss_bwd_pallas``): the float32 cotangent before rounding within
  1e-5 of its largest entry, and the port's bf16 cotangent exactly its
  rounding. JAX's kernel recomputes the target's stats in float32 from the
  target (``photo_kernel.py:258-259``) where the port's J reads the bf16
  stats that I reads, so the port's arithmetic is held there on the
  float32 stats of the bf16 target. No operand pair ties (pred == target),
  where the Pallas cotangent passes 0 and the port half (ROADMAP C).
* The warps at bf16 (A and B, F and E at a mask) against the JAX package's
  interpreted float32 route on the bf16-valued image, rounded to bf16:
  out, va and vb within one bf16 ulp elementwise of it, beyond the two
  float32 routes' own difference on the same inputs (XLA fuses JAX's
  projection chain into FMAs, so its coordinates lie a few float32 ulps
  from the port's: ``tests/test_torch_warp_depth.py`` bounds that; the
  share not bitwise equal printed); the overlap and the mask warp equal;
  the bf16 forms exactly the float32 ones rounded; against the packed
  bf16 route (``pack_rows_bf16``, which the port does not carry) within
  ``tests/test_warp_depth.py``'s 1e-2. The depth cotangent from the same
  bf16 residuals within 1e-5 of its largest entry, the grid cotangent
  within one bf16 ulp of its ``gfx``.
* BatchNorm and ConvBnReLU at bf16 (flax 0.12.3 ``nn.BatchNorm`` on the
  bf16 tree, ``fsnet_tpu.models.blocks``): the running statistics float32
  and within one bf16 ulp elementwise, the outputs within one bf16 ulp
  (measured bitwise). ConvBnReLU's BN (its moments from the conv kernel's
  epilogue) is held against flax's on the port's stored conv output: the
  conv is kernel #2's (above), which adds the bias in float32 before its one
  rounding, where ``nn.Conv`` on the XLA route rounds the product to bf16
  and then adds the bias in bf16 (28% of this conv's outputs round apart).
* The whole flagship step at 64x96, both routes (depth-direct on the
  synthetic batch; the grid route with the NuScenes patched mask), against
  ``fsnet_tpu.runtime.state.make_train_step(compute_dtype=jnp.bfloat16,
  with_grads=True)`` on its XLA route, from the same bridged weights, on
  white-noise images: loss rel < 2e-2 (the JAX package's own bf16 gate,
  ``scripts/tpu_smoke.py``; measured 1.51e-2 on both routes: JAX's XLA
  route takes SSIM's pools and target stats in bf16 with bf16 taps, the
  port's kernel I in float32 from bf16 operands, the function of the TPU
  kernel); the gradients against JAX's bf16 ones, over every leaf but the
  biases of the convs ahead of a train-mode BN (their exact gradient is 0):
  cosine > 0.8 (measured 0.889 and 0.881) and worst-leaf relative L2 <= 0.9
  (0.658 on both); gradient cosine against the port's float32 step >
  0.25 (0.897 and 0.891); every gradient leaf equal to its bf16 rounding;
  the batch leaves the port rounds exactly those JAX's ``_cast`` rounds, to
  the same values; the BN statistics float32 and, elementwise, within one
  bf16 ulp of JAX's plus a floor of 2 bf16 ulps of the leaf's largest
  statistic (the floor measured at 1.51 ulps; the means near 0 of ``bn1``
  lie up to 7101 ulps of their own from JAX's: batch means over a forward that
  two bf16 implementations round apart, 12 pixels at ``layer4``).
  The gradient and statistics gates cannot tell this step from the port's
  float32 step put in its place (that control reads cosine 0.918 and
  0.915, worst leaf 0.554 and 0.590, statistics floor 1.19 ulps): on every input
  measured (white noise, the synthetic textures, textures of 2 and 4
  pixels) two bf16 implementations' gradients lie as far from each other
  as either does from float32 (rel-L2 0.3-0.6), bf16's own noise, chiefly
  the min-reprojection's choices among near-equal bf16 losses; one ulp
  elementwise holds module by module (the BN test above, whose float32
  control misses it: 162 values in training, 424 in eval).
* What does tell the bf16 step from the float32 one is its loss on the
  synthetic batch's smooth textures, where SSIM's E[y^2] - mu^2 cancels in
  the bf16 target statistics (BASELINE.md:768-778): the port's depth-direct
  step there against JAX's bf16 step with the function the port's kernels
  compute (its photometric kernel forced on and interpreted, its stencil
  target stats, ``ssim.py:72-84``): loss rel < 7e-2 (measured 4.2e-2, the
  flat windows amplifying each ulp the two round apart), and the port's
  float32 step, the control, must miss that gate (measured 1.10e-1).
"""
import sys

import numpy as np
import pytest
import torch

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp

import __graft_entry__ as ge
import fsnet_tpu.ops.pallas.conv_kernel as ck
import fsnet_tpu.ops.photo_loss as jpl
import fsnet_tpu.ops.warp_depth as jwd
import fsnet_tpu.ops.warp_fast as jwf
from fsnet_tpu.ops import fast_conv as fc
from fsnet_tpu.ops.geometry import invert_K
from fsnet_tpu.ops.ssim import ssim_target_stats as jax_target_stats
from fsnet_tpu_torch.entry import (FLAGSHIP_RECIPE, flagship_model,
                                   flagship_optimizer, synthetic_batch)
from fsnet_tpu_torch.models.flax_convert import load_flax_variables, to_flax
from fsnet_tpu_torch.ops import conv3x3 as tc
from fsnet_tpu_torch.ops import photo_loss as tpl
from fsnet_tpu_torch.ops import warp_depth as twd
from fsnet_tpu_torch.ops import warp_fast as twf
from fsnet_tpu_torch.ops.ssim import ssim_target_stats
from fsnet_tpu_torch.runtime import state as tstate

from test_torch_train_step import _flat, _randomise, _to_dicts, jax_init

torch.set_num_threads(1)
BF = torch.bfloat16


@pytest.fixture(autouse=True)
def _interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)


def _bf(a) -> np.ndarray:
    """A numpy array rounded to bf16 values, as float32."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF).float().numpy()


def _ulp(a) -> np.ndarray:
    """One bf16 ulp at |a| (float32 spacing times 2^16)."""
    return np.spacing(np.abs(np.asarray(a, np.float32))) * 2.0 ** 16


def _within_ulp(got, ref, name, floor=0.0):
    """|got - ref| <= one bf16 ulp of the larger (+ ``floor``); prints the
    share that is not bitwise equal."""
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, name
    big = np.maximum(np.abs(got), np.abs(ref))
    bad = np.abs(got - ref) > _ulp(big) + floor
    print(f"{name}: {np.mean(got != ref):.2e} not bitwise equal, "
          f"{int(bad.sum())} beyond one bf16 ulp")
    assert not bad.any(), name


def _t(a, dtype=BF):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype).contiguous()


# --------------------------------------------------------- conv kernels

CONV_CASES = {
    # name: (B, H, W, Cs, Co, pad_mode)
    "one_part_zeros": (2, 8, 128, (16,), 16, "zeros"),
    "two_parts_replicate": (2, 8, 64, (32, 64), 32, "replicate"),
}


def _conv_inputs(seed, B, H, W, Cs, Co):
    rng = np.random.RandomState(seed)
    xs = [_bf(rng.randn(B, H, W, c)) for c in Cs]
    w = _bf(rng.randn(3, 3, sum(Cs), Co) * 0.1)
    b = _bf(rng.randn(Co) * 0.1)
    g = _bf(rng.randn(B, H, W, Co))
    return xs, w, b, g


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_moments_and_dw_bf16_match_pallas(case):
    B, H, W, Cs, Co, pad = CONV_CASES[case]
    xs, w, b, g = _conv_inputs(sorted(CONV_CASES).index(case), B, H, W, Cs,
                               Co)
    P = 128 // Co
    jparts = [fc.pack_width(jnp.asarray(x, jnp.bfloat16),
                            128 // c if x.shape[2] % (128 // c) == 0 else 1)
              for x, c in zip(xs, Cs)]
    wj = jnp.asarray(w, jnp.bfloat16)
    cat = jnp.concatenate([jnp.asarray(x, jnp.bfloat16) for x in xs], -1)
    with jax.default_matmul_precision("highest"):
        out, s1, s2 = fc._conv3x3_forward_pallas_bn(
            [fc.pack_width(cat, 1)], [sum(Cs)], wj,
            jnp.asarray(b, jnp.bfloat16), pad)
        gp = fc.pack_width(jnp.asarray(g, jnp.bfloat16), P)
        dws = []
        for part, c in zip(jparts, Cs):
            xpad = fc._rowpad3(fc.repack(part, c, P), pad)
            dws.append(ck.fold_dw(ck.conv3x3_fused_dw(xpad, gp), P, c, Co,
                                  pad))
        dw_ref = np.asarray(jnp.concatenate(dws, axis=2), np.float32)
    assert out.dtype == jnp.bfloat16 and s1.dtype == jnp.float32
    out_ref = np.asarray(fc.unpack_width(out, Co), np.float32)
    s_ref = [np.asarray(s, np.float64).reshape(P, Co).sum(0)
             for s in (s1, s2)]

    parts = [_t(x) for x in xs]
    y, m1, m2 = tc.conv3x3_bn(parts, _t(w), _t(b), pad)
    dw = tc.conv3x3_dw(parts, _t(g), pad)
    assert y.dtype == BF and m1.dtype == m2.dtype == dw.dtype == torch.float32
    _within_ulp(y.float().numpy(), out_ref, f"{case} conv3x3_bn output")
    # each side's moments are float32 sums of its own stored output
    for got, stored in (((m1, m2), y.double().numpy()),
                        (s_ref, out_ref.astype(np.float64))):
        ref1 = stored.sum(axis=(0, 1, 2))
        ref2 = (stored * stored).sum(axis=(0, 1, 2))
        for s, r in zip(got, (ref1, ref2)):
            s = np.asarray(s, np.float64)
            np.testing.assert_allclose(s, r, rtol=1e-5,
                                       atol=1e-5 * np.abs(r).max())
    np.testing.assert_allclose(dw.numpy(), dw_ref, rtol=1e-5,
                               atol=1e-4 * max(1.0,
                                               np.abs(dw_ref).max() / 100))
    for f in (tc.conv3x3, tc.conv3x3_bn, tc.conv3x3_dx, tc.conv3x3_dw):
        assert f.launches == 0          # the CPU never launches a kernel


# ---------------------------------------------------- photometric kernels

def test_photo_loss_bf16_matches_pallas():
    N, B, H, W, C = 4, 2, 16, 256, 3
    rng = np.random.RandomState(3)
    pred = _bf(rng.rand(N, H, W, C))
    target = _bf(rng.rand(B, H, W, C))
    tied = pred.reshape(N // B, B, H, W, C) == target[None]
    pred = pred.reshape(N // B, B, H, W, C)
    pred[tied] = _bf(target[np.nonzero(tied)[1:]] + 1e-2)
    pred = pred.reshape(N, H, W, C)
    assert not (pred.reshape(N // B, B, H, W, C) == target[None]).any()
    g = _bf(rng.randn(N, H, W))
    pj, tj = jnp.asarray(pred, jnp.bfloat16), jnp.asarray(target,
                                                          jnp.bfloat16)
    # the port's target stats: f32 accumulation, stored in bf16
    muy, sy = ssim_target_stats(_t(target))
    stats_j = (jnp.asarray(muy.float().numpy(), jnp.bfloat16),
               jnp.asarray(sy.float().numpy(), jnp.bfloat16))
    loss_ref = jpl.reprojection_loss_fused(pj, tj, *stats_j)
    assert loss_ref.dtype == jnp.bfloat16
    xpad, ypad, _, _ = jpl._prep(pj, tj, stats_j)
    n, hp, nt, _, lanes = xpad.shape
    gpad = jnp.pad(jnp.asarray(g, jnp.bfloat16).reshape(n, hp - 4, nt, lanes),
                   ((0, 0), (1, 1), (0, 0), (0, 0)))
    dx_ref = np.asarray(jpl._untile(jpl.photo_loss_bwd_pallas(
        xpad, ypad, gpad, 0.85, cn=C)[:, :, :, :C]), np.float32)

    p, t = _t(pred), _t(target)
    loss = tpl.photo_loss_fwd(p, t, muy, sy)
    dx = tpl.photo_loss_bwd(p, t, muy, sy, _t(g))
    assert loss.dtype == dx.dtype == BF
    _within_ulp(loss.float().numpy(), np.asarray(loss_ref, np.float32),
                "kernel I (plain) loss")
    g32 = _t(g, torch.float32)
    dx32 = tpl.photo_loss_bwd_plain(p.float(), t.float(),
                                    *ssim_target_stats(t.float()), g32)
    err = np.abs(dx32.numpy() - dx_ref).max() / np.abs(dx_ref).max()
    print(f"kernel J (plain) before rounding: {err:.2e} of the largest entry")
    assert err <= 1e-5
    assert torch.equal(dx, tpl.photo_loss_bwd_plain(
        p.float(), t.float(), muy.float(), sy.float(), g32).to(BF))
    assert tpl.photo_loss_fwd.launches == tpl.photo_loss_bwd.launches == 0


# ------------------------------------------------------------------ warps

def _depth_scene(rng, S, F, B, H, W, C):
    from test_warp_depth import _scene

    image, depth, K, Ts = _scene(rng, S, F, B, H, W, C)
    inv_K = invert_K(K)
    return (_bf(image), np.asarray(depth),
            np.asarray(jwd.make_affine_rows(K, inv_K, Ts, S)))


def _untile(t, W):
    """JAX's tiled residual [N, H, T, C, L] -> NHWC."""
    t = np.asarray(t, np.float32)
    if t.ndim == 5:
        t = np.moveaxis(t, 3, 4).reshape(t.shape[0], t.shape[1], W, -1)
    return t


def test_depth_direct_warp_bf16_matches_jax():
    S, F, B, H, W, C, band = 2, 2, 2, 16, 256, 3, 8
    rng = np.random.RandomState(5)
    image, depth, arows = _depth_scene(rng, S, F, B, H, W, C)
    out32, ov32, va32, vb32 = jwd._fwd_impl(jnp.asarray(image), depth, arows,
                                            S, F, band)
    packed, ov_packed = jwd.warp_depth_fused(
        jnp.asarray(image, jnp.bfloat16), depth, arows, S, F, band)

    img, dep, rows = _t(image), _t(depth, torch.float32), _t(arows,
                                                            torch.float32)
    out, ov, va, vb = twd.warp_depth_fwd(img, dep, rows, S, F, band)
    wide = twd.warp_depth_fwd(img.float(), dep, rows, S, F, band)
    assert out.dtype == va.dtype == vb.dtype == BF
    assert np.array_equal(ov.numpy(), np.asarray(ov32))
    for name, got, w32, ref in (("out", out, wide[0], out32),
                                ("va", va, wide[2], va32),
                                ("vb", vb, wide[3], vb32)):
        ref = _untile(ref, W)
        assert torch.equal(got, w32.to(BF)), name
        _within_ulp(got.float().numpy(), _bf(ref), f"kernel A (plain) {name}",
                    floor=np.abs(w32.numpy() - ref))
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(packed, np.float32), atol=1e-2)
    assert np.array_equal(ov.numpy(), np.asarray(ov_packed))

    # kernel B from the same bf16 residuals: gfx, gfy formed in bf16
    g = _bf(rng.randn(*out.shape))
    res = (jnp.asarray(image, jnp.bfloat16), jnp.asarray(depth),
           jnp.asarray(arows),
           jnp.asarray(va.float().numpy(), jnp.bfloat16),
           jnp.asarray(vb.float().numpy(), jnp.bfloat16))
    dd_ref = np.asarray(jwd._bwd(S, F, band, res, (jnp.asarray(
        g, jnp.bfloat16), None))[1])
    dd = twd.warp_depth_bwd(dep, _t(g), va, vb, rows, S, F)
    assert dd.dtype == torch.float32
    assert np.abs(dd.numpy() - dd_ref).max() <= 1e-5 * np.abs(dd_ref).max()
    assert twd.warp_depth_fwd.launches == twd.warp_depth_bwd.launches == 0


def _grid_inputs(rng, M, N, H, W, C):
    from test_torch_grid_warp import _inputs

    image, grid, _ = _inputs(H, W, C, seed=int(rng.randint(100)))
    return _bf(image[:M]), grid[:N].astype(np.float32)


def test_grid_warps_bf16_match_jax(monkeypatch):
    M, H, W, C, band = 2, 16, 128, 3, 8
    rng = np.random.RandomState(6)
    image, grid = _grid_inputs(rng, M, 2 * M, H, W, C)
    mask = np.ones((M, H, W, 1), np.float32)
    mask[:, H - 3:] = 0.0
    g = _bf(rng.randn(2 * M, H, W, C))
    monkeypatch.setattr(jwf, "_use_pallas", lambda *a: True)
    gj = jnp.asarray(grid)
    out32, (_, _, va32, vb32) = jwf._fwd(jnp.asarray(image), gj, "bilinear",
                                          "border", True, band)
    packed = jwf.grid_sample_band(jnp.asarray(image, jnp.bfloat16), gj,
                                  padding_mode="border", band=band)
    mask_ref = jwf.grid_sample_band(jnp.asarray(mask, jnp.bfloat16), gj,
                                    mode="nearest", padding_mode="zeros",
                                    band=band)

    img, grd = _t(image), _t(grid, torch.float32)
    out, va, vb = twf.grid_band_fused(img, grd, "border", band)
    wide = twf.grid_band_fused(img.float(), grd, "border", band)
    warped = twf.grid_band_fwd(_t(mask), grd, "nearest", "zeros", band)
    assert out.dtype == va.dtype == vb.dtype == warped.dtype == BF
    for name, got, w32, ref in (("out", out, wide[0], out32),
                                ("va", va, wide[1], va32),
                                ("vb", vb, wide[2], vb32)):
        ref = _untile(ref, W)
        assert torch.equal(got, w32.to(BF)), name
        _within_ulp(got.float().numpy(), _bf(ref), f"kernel F (plain) {name}",
                    floor=np.abs(w32.numpy() - ref))
    assert np.array_equal(warped.float().numpy(),
                          np.asarray(mask_ref, np.float32))
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(packed, np.float32), atol=1e-2)

    # the grid cotangent from the same bf16 residuals
    res = (jnp.asarray(image, jnp.bfloat16), gj,
           jnp.asarray(va.float().numpy(), jnp.bfloat16),
           jnp.asarray(vb.float().numpy(), jnp.bfloat16))
    dgrid_ref = np.asarray(jwf._bwd("bilinear", "border", True, band, False,
                                    res, jnp.asarray(g, jnp.bfloat16))[1])
    grd.requires_grad_(True)
    twf.grid_sample(img, grd, band=band).backward(_t(g))
    assert grd.grad.dtype == torch.float32
    gfx = (_t(g) * va).sum(-1).float().numpy()
    gfy = (_t(g) * vb).sum(-1).float().numpy()
    floor = _ulp(np.stack([gfx * (W - 1) / 2, gfy * (H - 1) / 2], -1))
    assert np.all(np.abs(grd.grad.numpy() - dgrid_ref) <= floor)
    assert twf.grid_band_fwd.launches == twf.grid_band_fused.launches == 0


def test_bf16_refused_where_there_is_no_bf16_form():
    """Kernels E and K have bfloat16 forms on their channel-wide route only
    and kernel F none: the grid warps' launcher refuses a bfloat16 image on
    the other routes (the wrappers widen it there; kernel G's refusals are
    ``tests/test_torch_bf16_recipes.py``'s). No warp takes float16, nor
    does the deformable conv, and the train step takes no other compute
    dtype than bfloat16."""
    from fsnet_tpu_torch.ops import dcn

    image = torch.rand(2, 8, 16, 8, dtype=BF)
    grid = torch.zeros(4, 8, 16, 2)
    for route, fused in (("narrow", False), ("row", False), ("narrow", True),
                         ("row", True)):
        with pytest.raises(TypeError):
            twf._launch_grid(route, image, grid, "bilinear", "zeros", 4,
                             fused)
    half = image.to(torch.float16)
    with pytest.raises(TypeError):
        twf.grid_band_bwd(half, grid, torch.zeros(4, 8, 16, 8,
                                                  dtype=torch.float16),
                          "bilinear", "zeros", 4)
    with pytest.raises(TypeError):
        twf.grid_sample(half, grid, padding_mode="zeros", image_grad=True)
    with pytest.raises(TypeError):
        dcn.modulated_deform_conv(
            half, torch.zeros(2, 8, 16, 18, dtype=torch.float16),
            torch.ones(2, 8, 16, 9, dtype=torch.float16),
            torch.zeros(3, 3, 8, 4, dtype=torch.float16))
    with pytest.raises(ValueError):
        tstate.make_train_step("cpu", compute_dtype="float16")


# ------------------------------------------------------------ batch norm

def test_batchnorm_and_conv_bn_relu_bf16_match_flax():
    from fsnet_tpu.models.blocks import BatchNorm as JBN
    from fsnet_tpu_torch.models.blocks import BatchNorm, ConvBnReLU

    rng = np.random.RandomState(8)
    B, H, W, Ci, Co = 2, 8, 16, 16, 32
    x = _bf(rng.randn(B, H, W, Co) * 2 + 0.5)
    xc = _bf(rng.randn(B, H, W, Ci))
    scale = (0.5 + rng.rand(Co)).astype(np.float32)
    bias = (0.1 * rng.randn(Co)).astype(np.float32)
    mean = (0.1 * rng.randn(Co)).astype(np.float32)
    var = (0.5 + rng.rand(Co)).astype(np.float32)
    kernel = _bf(rng.randn(3, 3, Ci, Co) * 0.1)
    cbias = _bf(rng.randn(Co) * 0.1)
    bn_vars = {"params": {"bn": {"scale": scale, "bias": bias}},
               "batch_stats": {"bn": {"mean": mean, "var": var}}}

    def cast(tree):
        return jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)

    def bridge(module, params, dtype=BF):
        torch_params = {k: _t(v, dtype) for k, v in params.items()}
        return lambda *a: torch.func.functional_call(module, torch_params, a)

    for train in (True, False):
        ref, mut = JBN().apply(cast(bn_vars), jnp.asarray(x, jnp.bfloat16),
                               train=train, mutable=["batch_stats"])
        stats = mut["batch_stats"]["bn"]
        outs = []
        for dtype in (BF, torch.float32):    # the step, its f32 control
            bn = BatchNorm(Co)
            bn.running_mean.copy_(torch.from_numpy(mean))
            bn.running_var.copy_(torch.from_numpy(var))
            y = bridge(bn, dict(weight=scale, bias=bias), dtype)(
                _t(x, dtype), train)
            assert y.dtype == dtype
            outs.append((y.to(BF).float().numpy(), bn.running_mean.numpy(),
                         bn.running_var.numpy()))
        for got, key in zip(outs[0], ("out", "mean", "var")):
            ref_k = ref if key == "out" else stats[key]
            assert key == "out" or ref_k.dtype == jnp.float32 or not train
            _within_ulp(got, np.asarray(ref_k, np.float32),
                        f"BatchNorm train={train} {key}")
        # the float32 module (its output rounded) misses the one-ulp gate
        ref_all = np.concatenate([np.asarray(r, np.float32).ravel() for r in
                                  (ref, stats["mean"], stats["var"])])
        got_all = np.concatenate([o.ravel() for o in outs[1]])
        big = np.maximum(np.abs(got_all), np.abs(ref_all))
        missed = int((np.abs(got_all - ref_all) > _ulp(big)).sum())
        print(f"BatchNorm train={train}: the float32 control, {missed} "
              "values beyond one bf16 ulp")
        assert missed > 0

    cbr = ConvBnReLU(Ci, Co)
    cbr.norm.running_mean.copy_(torch.from_numpy(mean))
    cbr.norm.running_var.copy_(torch.from_numpy(var))
    y = bridge(cbr, {"conv.weight": kernel, "conv.bias": cbias,
                     "norm.weight": scale, "norm.bias": bias})(_t(xc), True)
    conv = tc.conv3x3(_t(xc), _t(kernel), _t(cbias))
    ref, mut = JBN().apply(cast(bn_vars), jnp.asarray(
        conv.float().numpy(), jnp.bfloat16), train=True,
        mutable=["batch_stats"])
    _within_ulp(y.float().numpy(), np.asarray(jax.nn.relu(ref), np.float32),
                "ConvBnReLU output")
    stats = mut["batch_stats"]["bn"]
    for got, key in ((cbr.norm.running_mean, "mean"),
                     (cbr.norm.running_var, "var")):
        assert got.dtype == torch.float32 and stats[key].dtype == jnp.float32
        _within_ulp(got.numpy(), np.asarray(stats[key]),
                    f"ConvBnReLU {key}")


# ------------------------------------------------------ the whole step

STEP_ROUTES = {"depth_direct": None, "grid": "nuscenes"}
H, W, B = 64, 96, 2


def _batch(mask, white=True):
    """The synthetic batch at 64x96 in float32, its images white noise
    unless ``white`` is False."""
    batch = synthetic_batch(B, H, W, patched_mask=mask)
    rng = np.random.RandomState(7)
    for key in sorted(batch):
        if white and key.startswith(("image/", "original_image/")):
            batch[key] = rng.rand(*batch[key].shape)
    return {k: v.astype(np.float32) if k != "patched_mask" else v
            for k, v in batch.items()}


def _jax_bf16_step(batch):
    """JAX's bf16 step on its XLA route; also returns the batch its model
    saw (the step's ``_cast`` of it), handed out through the heatmap
    output."""
    from fsnet_tpu.runtime.optim import build_optimizer
    from fsnet_tpu.runtime.state import TrainState, make_train_step

    model = ge._flagship_model(H, W)
    v = jax_init("wpose", model, batch["image/0"])
    v = jax.tree.map(lambda a: np.asarray(a, np.float32),
                     _to_dicts(_randomise(v, np.random.RandomState(0))))
    tx, _ = build_optimizer(dict(name="adam", lr=1e-4),
                            dict(name="StepLR", step_size=8),
                            steps_per_epoch=1000, clip_gradients=1.0)

    def apply_fn(variables, data, meta, **kwargs):
        out, mutated = model.apply(variables, data, meta, **kwargs)
        return dict(out, hm=dict(data)), mutated

    st = TrainState.create(apply_fn=apply_fn, params=v["params"],
                           batch_stats=v["batch_stats"], tx=tx)
    new, met, seen = make_train_step(
        donate=False, compute_dtype=jnp.bfloat16, with_grads=True)(
        st, batch, jax.random.PRNGKey(0))
    return dict(variables=v, loss=float(met["loss"]),
                grads=_to_dicts(met["_grads"]),
                stats=_to_dicts(new.batch_stats),
                seen={k: np.asarray(a) for k, a in seen.items()})


def _port_step(v, batch, compute_dtype):
    port = flagship_model(H, W, device="cpu")
    load_flax_variables(port, v)
    opt, _ = flagship_optimizer(port)
    met = tstate.make_train_step("cpu", compute_dtype=compute_dtype,
                                 with_grads=True)(port, opt, batch)
    stats = {k: t for k, t in port.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return dict(loss=float(met["loss"]), raw=met["_grads"],
                grads=to_flax(port, met["_grads"])["params"],
                stats=to_flax(port, stats)["batch_stats"])


def _rel(got, ref):
    return abs(got["loss"] - ref["loss"]) / abs(ref["loss"])


def _grad_distance(got, ref):
    """(cosine, worst-leaf relative L2, its leaf) of ``got``'s gradients
    against ``ref``'s, over every leaf but the biases of convs ahead of a
    train-mode BN (a ``conv`` beside a ``norm``), whose exact gradient is
    0."""
    leaves = dict(_flat(ref["grads"]))
    mine = dict(_flat(got["grads"]))
    assert sorted(mine) == sorted(leaves)
    keep = sorted(p for p in leaves if not (
        p[-2:] == ("conv", "bias") and any(q[:len(p) - 2] == p[:-2]
                                           and q[len(p) - 2] == "norm"
                                           for q in leaves)))
    a, b = (np.concatenate([np.asarray(t[p], np.float64).ravel()
                            for p in keep]) for t in (mine, leaves))
    cos = float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))
    worst = max((float(np.linalg.norm(np.asarray(mine[p], np.float64)
                                      - np.asarray(leaves[p], np.float64))
                       / np.linalg.norm(np.asarray(leaves[p], np.float64))),
                 p) for p in keep)
    return cos, worst[0], worst[1]


def _stats_floor_ulps(got, ref):
    """The BN statistics' elementwise gate: the largest excess of
    ``|got - ref|`` over one bf16 ulp of each statistic, in bf16 ulps of its
    leaf's largest statistic."""
    ref_s, got_s = dict(_flat(ref["stats"])), dict(_flat(got["stats"]))
    assert sorted(got_s) == sorted(ref_s)
    worst = 0.0
    for path, r in ref_s.items():
        r = np.asarray(r)
        assert r.dtype == np.float32 and got_s[path].dtype == np.float32
        excess = np.abs(got_s[path] - r) - _ulp(r)
        worst = max(worst, float(excess.max() / _ulp(np.abs(r).max())))
    return worst


@pytest.mark.parametrize("route", sorted(STEP_ROUTES))
def test_flagship_bf16_step_matches_jax(route, monkeypatch):
    batch = _batch(STEP_ROUTES[route])
    ref = _jax_bf16_step(batch)
    warps = []
    for mod, fn in ((twd, "warp_depth_plain"), (twf, "grid_band_plain")):
        monkeypatch.setattr(mod, fn, lambda *a, _o=getattr(mod, fn), _f=fn,
                            **k: (warps.append(_f), _o(*a, **k))[1])
    got = _port_step(ref["variables"], batch, FLAGSHIP_RECIPE[
        "compute_dtype"])
    assert sorted(set(warps)) == (["grid_band_plain"] if route == "grid"
                                  else ["warp_depth_plain"])
    f32 = _port_step(ref["variables"], batch, None)

    rel = _rel(got, ref)
    print(f"{route}: loss port bf16 {got['loss']:.6f}, JAX bf16 "
          f"{ref['loss']:.6f} (rel {rel:.3e}), port f32 {f32['loss']:.6f}")
    assert rel < 2e-2

    cos, worst, leaf = _grad_distance(got, ref)
    ccos, cworst, _ = _grad_distance(f32, ref)
    print(f"{route}: gradients vs JAX bf16: cosine {cos:.4f}, worst leaf "
          f"rel-L2 {worst:.4f} at {'/'.join(leaf)}; the port's f32 step "
          f"(control) {ccos:.4f}, {cworst:.4f}")
    assert cos > 0.8 and worst <= 0.9
    cos = _grad_distance(got, f32)[0]
    print(f"{route}: gradient cosine, port bf16 vs port f32: {cos:.4f}")
    assert cos > 0.25
    for name, g in got["raw"].items():
        assert g.dtype == torch.float32, name
        assert torch.equal(g, g.to(BF).float()), name

    # the batch leaves rounded, and to what: JAX's _cast
    data = tstate._to_device(batch, torch.device("cpu"))
    cast = tstate._cast(data, BF)
    for key, seen in ref["seen"].items():
        mine = cast[key]
        assert (seen.dtype == jnp.bfloat16) == (mine.dtype == BF), key
        np.testing.assert_array_equal(mine.float().numpy(),
                                      np.asarray(seen, np.float32), key)
    assert ref["seen"]["P2"][0, 0, 0] != batch["P2"][0, 0, 0]   # fx rounds

    floor = _stats_floor_ulps(got, ref)
    print(f"{route}: BN statistics beyond one bf16 ulp each: {floor:.3f} "
          "bf16 ulps of the leaf's largest; the port's f32 step (control) "
          f"{_stats_floor_ulps(f32, ref):.3f}")
    assert floor <= 2.0


def test_flagship_bf16_step_loss_is_bf16s_on_smooth_textures(monkeypatch):
    """The loss on the synthetic textures against JAX's bf16 step with the
    photometric kernel and stencil target stats, which the port's kernels
    compute: within 7e-2, where the port's float32 step misses."""
    import fsnet_tpu.models.heads.monodepth2_decoder as jdec

    calls = []
    monkeypatch.setattr(jdec, "photo_loss_supported",
                        lambda shape: calls.append(shape) or True)
    monkeypatch.setattr(sys.modules["fsnet_tpu.ops.ssim"], "SSIM_STENCIL",
                        True)
    batch = _batch(None, white=False)
    ref = _jax_bf16_step(batch)
    assert len(calls) == 2              # the warped and identity stacks
    got = _port_step(ref["variables"], batch, "bfloat16")
    f32 = _port_step(ref["variables"], batch, None)
    rel, control = _rel(got, ref), _rel(f32, ref)
    print(f"smooth textures: loss port bf16 {got['loss']:.6f}, JAX bf16 "
          f"(photometric kernel, stencil stats) {ref['loss']:.6f}: rel "
          f"{rel:.3e}; the port's f32 step (control) {f32['loss']:.6f}: rel "
          f"{control:.3e}")
    print("smooth textures: gradients vs JAX bf16 (cosine, worst leaf): "
          f"port bf16 {_grad_distance(got, ref)[:2]}, port f32 "
          f"{_grad_distance(f32, ref)[:2]}")
    assert rel < 7e-2 <= control


def test_recipe_compute_dtype_is_the_configs():
    """Every shipped config trains in bf16: the recipe carries the
    training hook's compute_dtype (``configs/common.py:163``)."""
    import fsnet_tpu.utils.config  # noqa: F401 - installs the easydict shim
    from configs.common import trainer_section

    hook = trainer_section(1.0, None).training_hook
    assert FLAGSHIP_RECIPE["compute_dtype"] == hook.compute_dtype
