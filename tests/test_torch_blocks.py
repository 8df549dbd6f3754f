"""The port's small modules against their JAX counterparts, float32 on the
CPU: depth codec, disparity/depth conversions, NHWC blocks, BatchNorm in
eval and train mode, the builder."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fsnet_tpu.models import blocks as jblocks
from fsnet_tpu.ops import depth_codec as jcodec
from fsnet_tpu.ops import geometry as jgeo
from fsnet_tpu_torch.models import blocks as tblocks
from fsnet_tpu_torch.ops import depth_codec as tcodec
from fsnet_tpu_torch.ops import geometry as tgeo

torch.set_num_threads(1)


def _rng(seed=0):
    return np.random.RandomState(seed)


@pytest.mark.parametrize("lo,hi,n", [(0.5, 100.0, 16), (0.1, 80.0, 64)])
def test_build_depth_bins_identical(lo, hi, n):
    np.testing.assert_array_equal(tcodec.build_depth_bins(lo, hi, n),
                                  jcodec.build_depth_bins(lo, hi, n))


def test_gather_activation_matches():
    logits = (_rng().randn(2, 5, 7, 16) * 6).astype(np.float32)  # some clip
    bins = jcodec.build_depth_bins(0.5, 100.0, 16)
    ref = np.asarray(jcodec.gather_activation(jnp.asarray(logits),
                                              jnp.asarray(bins)))
    got = tcodec.gather_activation(torch.from_numpy(logits),
                                   torch.from_numpy(bins)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


def test_disp_depth_roundtrip_matches():
    disp = _rng().rand(3, 4).astype(np.float32)
    for a, b in zip(tgeo.disp_to_depth(torch.from_numpy(disp), 0.5, 100.0),
                    jgeo.disp_to_depth(jnp.asarray(disp), 0.5, 100.0)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    depth = 0.5 + 50 * disp
    np.testing.assert_allclose(
        tgeo.depth_to_disp(torch.from_numpy(depth), 0.5, 100.0).numpy(),
        np.asarray(jgeo.depth_to_disp(jnp.asarray(depth), 0.5, 100.0)),
        rtol=1e-5, atol=1e-7)


def test_upsample2x_nearest_matches():
    x = _rng().randn(2, 3, 5, 4).astype(np.float32)
    got = tblocks.upsample2x_nearest(torch.from_numpy(x))
    assert got.is_contiguous()
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jblocks.upsample2x_nearest(jnp.asarray(x))))


@pytest.mark.parametrize("align_corners", [True, False])
def test_interpolate_bilinear_matches(align_corners):
    x = _rng().randn(2, 6, 10, 3).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = jblocks.interpolate_bilinear(jnp.asarray(x), 24, 40,
                                           align_corners)
    got = tblocks.interpolate_bilinear(torch.from_numpy(x), 24, 40,
                                       align_corners)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_max_pool_matches():
    x = _rng().randn(2, 9, 12, 5).astype(np.float32) - 3.0   # -inf padding
    np.testing.assert_array_equal(
        tblocks.max_pool_3x3_s2_p1(torch.from_numpy(x)).numpy(),
        np.asarray(jblocks.max_pool_3x3_s2_p1(jnp.asarray(x))))


@pytest.mark.parametrize("train", [False, True])
def test_batchnorm_matches_flax(train):
    rng = _rng(1)
    C = 6
    x = rng.randn(4, 3, 5, C).astype(np.float32) * 2 + 1
    scale = (0.5 + rng.rand(C)).astype(np.float32)
    bias = rng.randn(C).astype(np.float32)
    mean = rng.randn(C).astype(np.float32)
    var = (0.5 + rng.rand(C)).astype(np.float32)
    variables = {"params": {"bn": {"scale": scale, "bias": bias}},
                 "batch_stats": {"bn": {"mean": mean, "var": var}}}
    ref, mutated = jblocks.BatchNorm().apply(
        variables, jnp.asarray(x), train=train, mutable=["batch_stats"])

    bn = tblocks.BatchNorm(C)
    with torch.no_grad():
        for t, a in ((bn.weight, scale), (bn.bias, bias),
                     (bn.running_mean, mean), (bn.running_var, var)):
            t.copy_(torch.from_numpy(a))
    got = bn(torch.from_numpy(x), train=train)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    stats = mutated["batch_stats"]["bn"] if mutated else {"mean": mean,
                                                           "var": var}
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-5, atol=1e-6)


def test_init_params_is_seeded_and_flax_scaled():
    """Same seed -> same weights; kernels follow flax's truncated LeCun
    normal (std 1/sqrt(fan_in), cut at 2 std)."""
    from fsnet_tpu_torch.entry import flagship_model

    a = flagship_model(64, 96, device="cpu", seed=3).state_dict()
    b = flagship_model(64, 96, device="cpu", seed=3).state_dict()
    c = flagship_model(64, 96, device="cpu", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = a["head.depth_decoder.trunk.upconv_4_0.conv.weight"]   # HWIO
    fan_in = 9 * w.shape[2]
    assert abs(float(w.std()) * np.sqrt(fan_in) - 1.0) < 0.05
    assert float(w.abs().max()) * np.sqrt(fan_in) <= 2 / 0.87962566103423978
    assert not torch.equal(w, c["head.depth_decoder.trunk.upconv_4_0.conv.weight"])
    assert torch.all(a["depth_backbone.bn1.running_var"] == 1)


def test_builder_resolves_port_names():
    from fsnet_tpu_torch.models.heads.depth_decoder import (
        MultiChannelDepthDecoder)
    from fsnet_tpu_torch.utils.builder import build, find_object

    assert find_object("fsnet_tpu_torch.models.heads.depth_decoder."
                       "MultiChannelDepthDecoder") is MultiChannelDepthDecoder
    dec = build(name="fsnet_tpu_torch.models.heads.depth_decoder."
                "MultiChannelDepthDecoder", min_depth=0.5, max_depth=100.0)
    assert isinstance(dec, MultiChannelDepthDecoder)
    with pytest.raises(ModuleNotFoundError):
        find_object("fsnet_tpu_torch.models.no_such_module.Thing")
