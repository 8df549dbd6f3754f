"""The port's deployment export (``fsnet_tpu_torch.runtime.export``) and the
registered conv operator it records, on the CPU:

* ``torch.ops.fsnet_tpu_torch.conv3x3``: equal to the plain version for
  one and two parts under both pad modes, with and without a bias, its
  shape function giving the output's shape and dtype; ``conv3x3`` calls
  it where no gradient is needed and keeps its autograd function where
  one is; any device but the CPU and CUDA raises;
* ``export_dummy_forward`` of the flagship at bs1 @32x64 float32: the
  graph calls the operator for the decoder's 14 convs; the program saved
  and reloaded by ``smoke_check``, within JAX's 1e-4 of the live model
  and bitwise equal to it (the command line that runs a saved program,
  ``python -m fsnet_tpu_torch.runtime.export``, runs in a fresh process
  on the card: ``chip_smoke.py`` phase 49);
* on bridged weights, the reloaded program against JAX's
  ``dummy_forward`` as JAX's own export (``fsnet_tpu.runtime.export``)
  serialises and runs it: depth within 1e-4 of its largest value
  (measured 3.2e-7; ``tests/test_torch_slice.py``'s gate for the live
  forwards);
* on a CUDA device (skipped here): the reloaded program launches the conv
  kernel 14 times and matches the live model.
"""
import numpy as np
import pytest
import torch

import jax

from fsnet_tpu_torch.entry import flagship_config, flagship_model
from fsnet_tpu_torch.ops import conv3x3 as tc
from fsnet_tpu_torch.runtime import export

torch.set_num_threads(1)

H, W = 32, 64
SHAPE = (1, H, W, 3)


def _inputs(parts, C, Co, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    xs = [torch.randn(2, 6, 9, c, generator=g, dtype=dtype) for c in parts]
    w = torch.randn(3, 3, sum(parts), Co, generator=g, dtype=dtype)
    return xs, w, torch.randn(Co, generator=g, dtype=dtype)


@pytest.mark.parametrize("pad", ["zeros", "replicate"])
@pytest.mark.parametrize("parts", [(5,), (4, 3)])
def test_conv3x3_op(parts, pad):
    xs, w, b = _inputs(parts, sum(parts), 7, len(parts))
    ref = tc.conv3x3_plain(xs, w, b, pad)
    assert torch.equal(torch.ops.fsnet_tpu_torch.conv3x3(xs, w, b, pad), ref)
    assert torch.equal(torch.ops.fsnet_tpu_torch.conv3x3(xs, w, None, pad),
                       tc.conv3x3_plain(xs, w, None, pad))
    # the shape function, as torch.export calls it
    meta = tc._conv3x3_fake([x.to("meta") for x in xs], w.to("meta"),
                            None, pad)
    assert meta.shape == ref.shape and meta.dtype == ref.dtype
    with torch.no_grad():
        assert torch.equal(tc.conv3x3(xs, w, b, pad), ref)
    # with a gradient wanted: the autograd function, the same values
    w.requires_grad_(True)
    y = tc.conv3x3(xs, w, b, pad)
    assert y.grad_fn is not None and "Conv3x3Function" in type(
        y.grad_fn).__name__
    assert torch.equal(y.detach(), ref)
    y.sum().backward()
    assert w.grad.shape == w.shape
    with pytest.raises((RuntimeError, NotImplementedError)):
        tc.conv3x3([x.to("meta") for x in xs], w.detach().to("meta"),
                   b.to("meta"), pad)


def _jax_names(node):
    if isinstance(node, dict):
        return {k: _jax_names(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_jax_names(v) for v in node]
    if isinstance(node, str):
        return node.replace("fsnet_tpu_torch.", "fsnet_tpu.")
    return node


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The flagship (BN statistics moved off their init) exported, saved,
    reloaded and run by ``smoke_check``."""
    root = tmp_path_factory.mktemp("export")
    model = flagship_model(H, W, device="cpu", seed=2)
    with torch.no_grad():
        g = torch.Generator().manual_seed(4)
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=g))
            elif name.endswith("running_var"):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=g))
    path = str(root / "flagship.pt2")
    program = export.export_dummy_forward(model, SHAPE, path)
    return dict(model=model, path=path, program=program,
                smoke=export.smoke_check(path, model, SHAPE))


def test_export_round_trip(exported):
    program, model, res = (exported["program"], exported["model"],
                           exported["smoke"])
    assert export.conv_ops(program) == 14
    assert model.training          # its mode restored after the export
    assert res["outputs"] == 1 and res["conv_ops"] == 14
    assert res["max_diff"] < 1e-4
    with torch.no_grad():
        live = model.dummy_forward(res["image"])
    assert sorted(res["restored"]) == ["depth"]
    assert torch.equal(res["restored"]["depth"], live["depth"])


def test_export_matches_jax(exported):
    """The reloaded program against JAX's ``dummy_forward`` on the same
    weights (carried by the flax bridge), as JAX's own export
    (``fsnet_tpu.runtime.export``) serialises and runs it."""
    from jax import export as jax_export

    from fsnet_tpu.runtime.export import export_dummy_forward
    from fsnet_tpu.utils.builder import build
    from fsnet_tpu_torch.models.flax_convert import to_flax

    port = exported["model"]
    model = build(**_jax_names(flagship_config(H, W)))
    variables = to_flax(port, port.state_dict())
    image = exported["smoke"]["image"].numpy()
    with jax.default_matmul_precision("highest"):
        blob = export_dummy_forward(model, variables, SHAPE, "")
        ref = np.asarray(jax_export.deserialize(blob).call(image)["depth"])
    depth = exported["smoke"]["restored"]["depth"].numpy()
    assert depth.shape == ref.shape == (1, H, W, 1)
    err = np.abs(depth - ref).max() / np.abs(ref).max()
    print(f"exported program against JAX: {err:.2e} of the largest depth")
    assert err <= 1e-4


@pytest.mark.cuda
def test_export_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the conv kernel has no CPU form")
    model = flagship_model(H, W, device="cuda", seed=2)
    path = str(tmp_path / "flagship.pt2")
    program = export.export_dummy_forward(model, SHAPE, path)
    assert export.conv_ops(program) == 14
    image = torch.rand(SHAPE, device="cuda")
    res = export.run_saved(path, image)
    with torch.no_grad():
        live = model.dummy_forward(image)
    assert res["launches"] == 14
    assert (res["outputs"]["depth"] - live["depth"]).abs().max() < 1e-4
