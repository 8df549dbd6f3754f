"""The port's loss operations against the JAX package's, value and gradient,
on the CPU in float32 (JAX at matmul precision "highest"): SSIM with the
target stats, ``gather_activation`` with its custom backward (at exactly
+-10 and at ties), ``get_smooth_loss``, the reprojection loss, the adaptive
pool, and the tie rules of min / max / clip / abs that the loss relies on.

Inputs come from numpy seeds and go to both sides as the same arrays.
Bounds: values within 1e-6 (SSIM and the reprojection loss: 5e-6, see
``test_ssim_matches``), gradients within 1e-5 relative to their largest
entry (SSIM and the reprojection loss: 1e-4).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fsnet_tpu.models.blocks import adaptive_avg_pool2d as j_pool
from fsnet_tpu.models.heads.monodepth2_decoder import \
    reprojection_loss as j_reproj
from fsnet_tpu.ops import depth_codec as jdc
from fsnet_tpu.ops import geometry as jgeo
from fsnet_tpu.ops.ssim import ssim as j_ssim, ssim_target_stats as j_stats
from fsnet_tpu_torch.models.blocks import adaptive_avg_pool2d as t_pool
from fsnet_tpu_torch.models.heads.monodepth2_decoder import \
    reprojection_loss as t_reproj
from fsnet_tpu_torch.ops import depth_codec as tdc
from fsnet_tpu_torch.ops import geometry as tgeo
from fsnet_tpu_torch.ops.ssim import ssim as t_ssim, \
    ssim_target_stats as t_stats

torch.set_num_threads(1)


def _vjp_jax(fn, args, cot):
    with jax.default_matmul_precision("highest"):
        out, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in args])
        return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(cot))]


def _vjp_torch(fn, args, cot):
    ts = [torch.from_numpy(np.array(a)).requires_grad_(True) for a in args]
    out = fn(*ts)
    out.backward(torch.from_numpy(np.asarray(cot)))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _close_grads(got, ref, rtol=1e-5):
    for a, r in zip(got, ref):
        assert a.shape == r.shape
        scale = max(np.abs(r).max(), 1e-30)
        assert np.abs(a - r).max() <= rtol * scale, np.abs(a - r).max() / scale


def _images(seed, shape=(3, 12, 20, 3)):
    rng = np.random.RandomState(seed)
    x = rng.rand(*shape).astype(np.float32)
    y = rng.rand(*shape).astype(np.float32)
    # flat patches: constant 3x3 windows, where the variance is 0 and the
    # >= 0 clamps sit at their tie
    x[0, :5, :6] = 0.25
    y[0, :5, :6] = 0.25
    y[1, 4:9, 8:14] = 0.5
    return x, y


@pytest.mark.parametrize("with_stats", [False, True])
def test_ssim_matches(with_stats):
    """SSIM's value differs from JAX's banded-matrix pool by reassociation
    of the pool sums, which the C2 = 9e-4 denominators amplify: 5e-6."""
    x, y = _images(0)
    cot = np.random.RandomState(1).randn(*x.shape).astype(np.float32)

    def jf(a, b):
        return j_ssim(a, b, y_stats=j_stats(b) if with_stats else None)

    def tf(a, b):
        return t_ssim(a, b, y_stats=t_stats(b) if with_stats else None)

    ref, rg = _vjp_jax(jf, (x, y), cot)
    got, gg = _vjp_torch(tf, (x, y), cot)
    assert np.abs(got - ref).max() <= 5e-6
    _close_grads(gg, rg, rtol=1e-4)


def test_ssim_target_stats_match():
    _, y = _images(2)
    mu_r, sig_r = (np.asarray(t) for t in j_stats(jnp.asarray(y)))
    mu, sig = (t.numpy() for t in t_stats(torch.from_numpy(y)))
    np.testing.assert_allclose(mu, mu_r, atol=1e-6)
    np.testing.assert_allclose(sig, sig_r, atol=1e-6)
    assert np.all(sig >= 0)


def test_reprojection_loss_matches():
    x, y = _images(3)
    cot = np.random.RandomState(4).randn(*x.shape[:3], 1).astype(np.float32)
    ref, rg = _vjp_jax(j_reproj, (x, y), cot)
    got, gg = _vjp_torch(t_reproj, (x, y), cot)
    assert got.shape == ref.shape == x.shape[:3] + (1,)
    assert np.abs(got - ref).max() <= 5e-6
    _close_grads(gg, rg, rtol=1e-4)


def test_gather_activation_matches():
    rng = np.random.RandomState(5)
    logits = (rng.randn(2, 6, 7, 16) * 6.0).astype(np.float32)
    # exactly at the clip bounds (zero gradient there), beyond them, and a
    # pixel whose logits tie
    logits[0, 0, 0, :4] = [10.0, -10.0, 12.0, -13.0]
    logits[0, 1, 1, :] = 3.0
    bins = jdc.build_depth_bins(0.5, 100.0, 16)
    np.testing.assert_array_equal(tdc.build_depth_bins(0.5, 100.0, 16), bins)
    cot = rng.randn(2, 6, 7, 1).astype(np.float32)
    ref, (rg,) = _vjp_jax(
        lambda a: jdc.gather_activation(a, jnp.asarray(bins)), (logits,), cot)
    got, (gg,) = _vjp_torch(
        lambda a: tdc.gather_activation(a, torch.from_numpy(bins)),
        (logits,), cot)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    assert np.all(gg[0, 0, 0, :4] == 0.0)       # strict mask at +-10
    _close_grads([gg], [rg])


def test_smooth_loss_matches():
    rng = np.random.RandomState(6)
    disp = rng.rand(2, 10, 14, 1).astype(np.float32)
    img = rng.rand(2, 10, 14, 3).astype(np.float32)
    disp[0, 0, :3] = 0.5          # equal neighbours: |0| takes JAX's +1
    ref, rg = _vjp_jax(jgeo.get_smooth_loss, (disp, img), np.float32(1.0))
    got, gg = _vjp_torch(tgeo.get_smooth_loss, (disp, img), np.float32(1.0))
    assert abs(float(got) - float(ref)) <= 1e-6 * abs(float(ref))
    _close_grads(gg, rg)


@pytest.mark.parametrize("out_hw", [(4, 5), (3, 7)])
def test_adaptive_avg_pool_matches(out_hw):
    x = np.random.RandomState(7).rand(2, 12, 20, 3).astype(np.float32)
    ref = np.asarray(j_pool(jnp.asarray(x), *out_hw))
    got = t_pool(torch.from_numpy(x), *out_hw).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("op", ["amin", "maximum", "minimum", "clip", "abs"])
def test_tie_rules_match_jax(op):
    """At a constructed tie JAX splits the cotangent evenly (min over an
    axis, maximum, minimum, clip at a bound) and takes +1 for |0|; the port's
    operations must do the same."""
    x = np.array([[1.0, 1.0, 2.0], [0.0, 0.0, 1.0]], np.float32)
    jf, tf = {
        "amin": (lambda a: jnp.min(a, axis=1),
                 lambda a: torch.amin(a, dim=1)),
        "maximum": (lambda a: jnp.maximum(a, 0.0),
                    lambda a: torch.maximum(a, torch.zeros(()))),
        "minimum": (lambda a: jnp.minimum(a, 1.0),
                    lambda a: torch.minimum(a, torch.ones(()))),
        "clip": (lambda a: jnp.clip(a, 0.0, 1.0),
                 lambda a: torch.minimum(torch.maximum(a, torch.zeros(())),
                                         torch.ones(()))),
        "abs": (jnp.abs, tgeo.abs_),
    }[op]
    ref, (rg,) = _vjp_jax(jf, (x,), np.ones_like(np.asarray(jf(x))))
    got, (gg,) = _vjp_torch(tf, (x,), np.ones_like(ref))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(gg, rg)


def test_smoothness_pyramid_falls_back_to_adaptive_pool():
    """Where the color pyramid stops halving evenly (the JAX package's
    reshape fails there), the port takes the adaptive pool of the target."""
    from fsnet_tpu_torch.entry import flagship_config
    from fsnet_tpu_torch.models.blocks import adaptive_avg_pool2d
    from fsnet_tpu_torch.utils.builder import build

    H, W, B = 20, 36, 1
    cfg = dict(flagship_config(H, W)["head_cfg"])
    head = build(frame_ids=(0, 1, -1), **cfg)
    rng = np.random.RandomState(8)
    sizes = [(20, 36), (10, 18), (5, 9), (3, 5)]
    out = {}
    for s, (h, w) in enumerate(sizes):
        out[("depth", s, s)] = torch.from_numpy(
            5 + 10 * rng.rand(B, h, w, 1).astype(np.float32))
        out[("disp", s)] = torch.from_numpy(rng.rand(B, h, w, 1).astype(
            np.float32))
    pose = torch.eye(4)[None]
    data = {("original_image", f): torch.from_numpy(
        rng.rand(B, H, W, 3).astype(np.float32)) for f in (0, 1, -1)}
    data["P2"] = torch.tensor([[[20.0, 0, 18, 0], [0, 20.0, 10, 0],
                                [0, 0, 1, 0]]])
    data[("relative_pose", 1)] = data[("relative_pose", -1)] = pose
    for f in (1, -1):
        out[("cam_T_cam", f)] = pose
    out["pose_is_const"] = True
    losses = head.loss(out, data)["loss_dict"]
    disp = out[("disp", 3)]
    want = tgeo.get_smooth_loss(
        disp / (disp.mean(dim=(1, 2), keepdim=True) + 1e-7),
        adaptive_avg_pool2d(data[("original_image", 0)], 3, 5)) * 1e-5 / 8
    torch.testing.assert_close(losses["smooth_loss/3"], want)
