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
