"""The port's VO post-optimisation (``fsnet_tpu_torch.ops.postopt``)
against the JAX package's, on the CPU, on inputs made by numpy from a
seed: a smooth colour scene with two depth planes, its prediction, and a
sparse VO map of the true depth with noise (4 in 10 pixels; invalid ones
at 120 m as ``read_vo_depth`` makes them):

* in float64 (JAX under ``jax_enable_x64``): ``rgb2lab`` within 1e-12;
  the SLIC assignment identical; the VO selection identical, also where
  equal distances straddle the top-K boundary; ``post_optimization``
  within 1e-10 relative at 40x60 with K = 24 and at 48x96 with the shipped
  K = 180;
* in float32: ``post_optimization`` against JAX's on the same inputs, the
  assignment equal on at least 99.9% of the pixels and the refined depth
  within 1e-4 relative L2;
* ``denorm`` and the (u, v, depth) map bitwise; a size mismatch raises.
"""
import numpy as np
import pytest
import torch

import jax

import fsnet_tpu.ops.postopt as jpo
from fsnet_tpu_torch.ops import postopt as tpo

torch.set_num_threads(1)

# the evaluation hooks' refine parameters (the JAX hooks' defaults)
PARAMS = dict(lab_dist_weight=1, depth_dist_weight=1, image_dist_weight=1,
              iter_num=3, lambda0=0.54 / (10 * 18), lambda1=1.0,
              lambda2=0.4)


def _jit(fn, *static):
    return jax.jit(fn, static_argnames=static)


# the JAX functions jitted (one compile each, not one per operation)
post_optimization = _jit(jpo.post_optimization, "h_seg", "w_seg",
                         "lab_dist_weight", "iter_num", "depth_dist_weight",
                         "image_dist_weight", "lambda0", "lambda1",
                         "lambda2", "max_points")
slic_assign = _jit(jpo.slic_assign, "h_seg", "w_seg", "iter_num")


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def scene(H, W, seed):
    """(rgb [H, W, 3] in [0, 1], predicted depth, VO depth)."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:H, 0:W].astype(np.float64)
    rgb = np.stack([0.5 + 0.4 * np.sin(x * f + y * g + p) for f, g, p in
                    rng.rand(3, 3) * [0.3, 0.3, 6.0]], axis=-1)
    rgb = np.clip(rgb + rng.randn(H, W, 3) * 0.02, 0, 1)
    truth = np.where(x < W * 0.6, 8.0 + 0.2 * y, 25.0 - 0.1 * x)
    pred = truth * np.exp(0.3 * np.sin(x / 7.0) + rng.randn(H, W) * 0.02)
    vo = np.where(rng.rand(H, W) < 0.4,
                  truth * np.exp(rng.randn(H, W) * 0.05), 120.0)
    return rgb, pred, vo


def _both(dtype, *arrays):
    jnp_dtype = np.float64 if dtype == torch.float64 else np.float32
    return ([np.asarray(a, jnp_dtype) for a in arrays],
            [torch.tensor(a, dtype=dtype) for a in arrays])


def test_rgb2lab_matches_jax_f64(x64):
    rgb, _, _ = scene(24, 32, 0)
    rgb[0, :4] = [[0, 0, 0], [1, 1, 1], [0.04045, 0.5, 0.9], [0.2, 0.0, 1]]
    got = tpo.rgb2lab(torch.tensor(rgb)).numpy()
    ref = np.asarray(jpo.rgb2lab(rgb))
    assert got.dtype == ref.dtype == np.float64
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("H,W,h_seg,w_seg", [(40, 60, 4, 6),
                                             (48, 96, 10, 18)])
def test_slic_assignment_matches_jax_f64(x64, H, W, h_seg, w_seg):
    rgb, pred, _ = scene(H, W, 1)
    (jrgb, jpred), (trgb, tpred) = _both(torch.float64, rgb, pred)
    jlab = jpo.rgb2lab(jrgb)
    juvz = jpo.depth_image_to_point_cloud_array(jpred)
    ref, ref_uv, ref_z = slic_assign(jlab, juvz, h_seg=h_seg, w_seg=w_seg,
                                     iter_num=3)
    tuvz = tpo.depth_image_to_point_cloud_array(tpred)
    np.testing.assert_array_equal(tuvz.numpy(), np.asarray(juvz))
    got, uv, z = tpo.slic_assign(tpo.rgb2lab(trgb), tuvz, h_seg, w_seg,
                                 iter_num=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert len(np.unique(got.numpy())) > h_seg * w_seg // 2
    np.testing.assert_allclose(uv.numpy(), np.asarray(ref_uv), rtol=1e-12)
    np.testing.assert_allclose(z.numpy(), np.asarray(ref_z), rtol=1e-12)


@pytest.mark.parametrize("case", ["random", "ties", "few"])
def test_vo_selection_matches_jax_f64(x64, case):
    """``ties``: 40 pixels at one distance across the top-K boundary (20
    of them chosen, by index); ``few``: fewer valid points than K."""
    H, W, K = 20, 30, 50
    rng = np.random.RandomState(2)
    pred = np.log(rng.uniform(4, 60, (H, W)))
    vo = np.log(np.where(rng.rand(H, W) < 0.5, rng.uniform(2, 90, (H, W)),
                         120.0))
    if case == "ties":
        # a flat prediction: 30 pixels at distinct small distances, 40 at
        # one distance (exactly equal), the rest farther or invalid
        pred = np.full((H, W), np.log(10.0))
        d = 0.5 + rng.rand(H * W)
        order = rng.permutation(H * W)
        d[order[:30]] = 0.001 * np.arange(1, 31)
        d[order[30:70]] = 0.25
        vo = pred + d.reshape(H, W)
        vo.reshape(-1)[order[70:120]] = np.log(120.0)
    if case == "few":
        vo = np.where(rng.rand(H, W) < 0.05, pred, np.log(120.0))
    ref = np.asarray(jpo.select_best_vo_points(pred, vo, K))
    got = tpo.select_best_vo_points(torch.tensor(pred), torch.tensor(vo),
                                    K).numpy()
    np.testing.assert_array_equal(got, ref)
    if case == "ties":
        tied = np.isclose(np.abs(pred - vo), 0.25)
        assert ref.sum() == K and tied.sum() == 40
        assert (ref & tied).sum() == 20


@pytest.mark.parametrize("H,W,h_seg,w_seg", [(40, 60, 4, 6),
                                             (48, 96, 10, 18)])
def test_post_optimization_matches_jax_f64(x64, H, W, h_seg, w_seg):
    rgb, pred, vo = scene(H, W, 3)
    (jr, jp, jv), (tr, tp, tv) = _both(torch.float64, rgb, pred, vo)
    ref = np.asarray(post_optimization(
        jr, jpo.depth_image_to_point_cloud_array(jp), jp, jv, h_seg=h_seg,
        w_seg=w_seg, max_points=300, **PARAMS))
    got = tpo.post_optimization(
        tr, tpo.depth_image_to_point_cloud_array(tp), tp, tv, h_seg, w_seg,
        max_points=300, **PARAMS).numpy()
    assert got.dtype == np.float64
    assert np.abs(got - pred).max() > 0.1       # the refine moved it
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=0)


def test_post_optimization_matches_jax_f32():
    H, W = 48, 96
    rgb, pred, vo = scene(H, W, 4)
    (jr, jp, jv), (tr, tp, tv) = _both(torch.float32, rgb, pred, vo)
    juvz = jpo.depth_image_to_point_cloud_array(jp)
    ref = np.asarray(post_optimization(jr, juvz, jp, jv, h_seg=10,
                                       w_seg=18, **PARAMS))
    ref_assign = np.asarray(slic_assign(
        jpo.rgb2lab(jr), juvz, h_seg=10, w_seg=18, iter_num=3)[0])
    tuvz = tpo.depth_image_to_point_cloud_array(tp)
    got = tpo.post_optimization(tr, tuvz, tp, tv, 10, 18, **PARAMS)
    assign = tpo.slic_assign(tpo.rgb2lab(tr), tuvz, 10, 18, iter_num=3)[0]
    assert got.dtype == torch.float32
    agree = float(np.mean(assign.numpy() == ref_assign))
    assert agree >= 0.999, agree
    rel = np.linalg.norm(got.numpy() - ref) / np.linalg.norm(ref)
    assert rel <= 1e-4, rel


def test_denorm_and_mismatch():
    rng = np.random.RandomState(5)
    img = rng.randn(16, 24, 3).astype(np.float32)
    mean, std = np.array([0.485, 0.456, 0.406]), np.array([0.229, 0.224,
                                                           0.225])
    np.testing.assert_array_equal(
        tpo.denorm(torch.tensor(img), mean, std).numpy(),
        jpo.denorm(img, mean, std))
    rgb, pred, vo = scene(16, 24, 6)
    t = [torch.tensor(a, dtype=torch.float32) for a in (rgb, pred, vo)]
    with pytest.raises(tpo.PostOptError, match="one size"):
        tpo.post_optimization(t[0], tpo.depth_image_to_point_cloud_array(
            t[1]), t[1], t[2][:8], 2, 3)
