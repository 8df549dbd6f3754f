"""The port's pose pieces against the JAX package's, in float64 from the same
numpy inputs: ``transformation_from_parameters`` (Rodrigues with the 1e-7
axis epsilon, ``invert``) and ``PoseDecoder`` with weights carried over by
the flax bridge. Bounds: 1e-12 absolute (measured at rounding level)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fsnet_tpu.models.heads.pose_decoder import PoseDecoder as JPoseDecoder
from fsnet_tpu.ops import geometry as jgeo
from fsnet_tpu_torch.models.flax_convert import load_flax_variables
from fsnet_tpu_torch.models.heads.pose_decoder import PoseDecoder
from fsnet_tpu_torch.ops import geometry as tgeo

torch.set_num_threads(1)


@pytest.fixture()
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("invert", [False, True])
@pytest.mark.parametrize("rank", [2, 3])
def test_transformation_from_parameters_matches(x64, invert, rank):
    rng = np.random.RandomState(rank + 2 * invert)
    shape = (4, 3) if rank == 2 else (4, 1, 3)
    axisangle = 0.05 * rng.randn(*shape)
    axisangle[0] = 0.0                       # the 1e-7 epsilon's case
    translation = rng.randn(*shape)
    ref = jgeo.transformation_from_parameters(
        jnp.asarray(axisangle), jnp.asarray(translation), invert=invert)
    got = tgeo.transformation_from_parameters(
        torch.from_numpy(axisangle), torch.from_numpy(translation),
        invert=invert)
    assert got.dtype == torch.float64 and got.shape == (4, 4, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-12,
                               rtol=0)


def test_pose_decoder_matches(x64):
    rng = np.random.RandomState(0)
    feat = rng.randn(2, 2, 5, 512)          # the last map of one pyramid
    jdec = JPoseDecoder(num_input_features=1, num_frames_to_predict_for=2)
    variables = jdec.init(jax.random.PRNGKey(0), [[jnp.asarray(feat)]])
    variables = jax.tree.map(lambda a: 0.05 * rng.randn(*np.shape(a)),
                             variables)
    ref = jdec.apply(variables, [[jnp.asarray(feat)]])
    dec = PoseDecoder(num_input_features=1, num_frames_to_predict_for=2)
    load_flax_variables(dec.double(), {"params": variables["params"]})
    got = dec([[torch.from_numpy(feat)]])
    for a, r in zip(got, ref):
        assert tuple(a.shape) == (2, 2, 1, 3)
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(r),
                                   atol=1e-12, rtol=0)
