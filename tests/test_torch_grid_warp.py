"""The port's grid band warp (``fsnet_tpu_torch.ops.warp_fast``, on the CPU
the plain version of kernels E and F) against the JAX package's
``grid_sample_band``, from the same numpy inputs.

* The XLA route (the JAX package's CPU route, one-hot einsums), both sides
  in float64: every mode and padding, C in {1, 3}, band in {4, 8},
  (H, W) in {(16, 128), (16, 640)}, N = 2 M grids against M images (warp n
  reads image n mod M). Forward within 1e-12; the grid cotangent of
  ``jax.vjp`` against torch autograd within 1e-10 in rel-L2; the nearest
  warp's cotangent exactly zero.
* The Pallas route in float32 (``_use_pallas`` forced on, every
  ``pallas_call`` interpreted, as ``tests/test_pallas_warp.py`` runs it):
  the fused forward + VJP kernel for bilinear warps and the forward kernel
  for nearest ones. Forward within 2e-5, cotangent within 1e-4 in rel-L2.

The grids are smooth fields (reprojection grids are) that leave the image
at its edges, so zeros padding and the border clamp both act, with a
jitter that spreads some rows beyond a band of 4. At W=640 the TPU
kernel's 3-tile lane window covers every sample of such a field, so the
window clamp the port does not carry never fires here.
"""
import numpy as np
import pytest
import torch

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp

import fsnet_tpu.ops.pallas.warp_kernel as wk
import fsnet_tpu.ops.warp_fast as jwf
from fsnet_tpu_torch.ops import warp_fast as twf

torch.set_num_threads(1)

M = 2
MODES = ["bilinear", "nearest"]
PADDINGS = ["border", "zeros"]


def _inputs(H, W, C, seed):
    rng = np.random.RandomState(seed)
    image = rng.rand(M, H, W, C)
    ys, xs = np.meshgrid(np.linspace(-1.15, 1.15, H),
                         np.linspace(-1.1, 1.1, W), indexing="ij")
    grids = []
    for n in range(2 * M):
        dx = 0.05 * np.sin(2 * np.pi * xs + n) * np.cos(np.pi * ys)
        dy = 0.25 * np.cos(np.pi * xs + 0.5 * n)
        jit = rng.uniform(-1, 1, (H, W, 2)) * [2.0 / W, 1.5 / H]
        grids.append(np.stack([xs + dx, ys + dy], -1) + jit)
    cot = rng.randn(2 * M, H, W, C)
    return image, np.stack(grids), cot


def _jax(image, grid, cot, mode, padding, band):
    def f(g):
        return jwf.grid_sample_band(jnp.asarray(image), g, mode=mode,
                                    padding_mode=padding, band=band)
    out, vjp = jax.vjp(f, jnp.asarray(grid))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(cot))[0])


def _port(image, grid, cot, mode, padding, band):
    g = torch.from_numpy(grid).requires_grad_(True)
    out = twf.grid_sample(torch.from_numpy(image), g, mode=mode,
                          padding_mode=padding, band=band)
    out.backward(torch.from_numpy(cot))
    return out.detach().numpy(), g.grad.numpy()


def _rel_l2(a, r):
    return float(np.linalg.norm(a - r) / np.linalg.norm(r))


@pytest.mark.parametrize("hw", [(16, 128), (16, 640)])
@pytest.mark.parametrize("band", [4, 8])
@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("padding", PADDINGS)
@pytest.mark.parametrize("mode", MODES)
def test_grid_warp_matches_jax_xla_f64(monkeypatch, mode, padding, C, band,
                                       hw):
    H, W = hw
    image, grid, cot = _inputs(H, W, C, seed=band + C)
    monkeypatch.setattr(twf, "_DTYPES", (torch.float64,))
    jax.config.update("jax_enable_x64", True)
    try:
        ref, ref_g = _jax(image, grid, cot, mode, padding, band)
    finally:
        jax.config.update("jax_enable_x64", False)
    assert ref.dtype == np.float64
    out, g = _port(image, grid, cot, mode, padding, band)
    assert out.shape == ref.shape == (2 * M, H, W, C)
    np.testing.assert_allclose(out, ref, atol=1e-12, rtol=0)
    if mode == "nearest":
        assert not np.any(g) and not np.any(ref_g)
    else:
        assert _rel_l2(g, ref_g) <= 1e-10


@pytest.mark.parametrize("case", [
    (mode, padding, C, 16, 128, 8)
    for mode in MODES for padding in PADDINGS for C in (1, 3)
] + [("bilinear", "border", 3, 16, 640, 4),
     ("nearest", "zeros", 1, 16, 640, 4)],
    ids=lambda c: "-".join(map(str, c)))
def test_grid_warp_matches_jax_pallas_f32(monkeypatch, case):
    mode, padding, C, H, W, band = case
    image, grid, cot = (a.astype(np.float32)
                        for a in _inputs(H, W, C, seed=band + C))

    def interpreted(*args, _orig=pl.pallas_call, **kwargs):
        kwargs["interpret"] = True
        return _orig(*args, **kwargs)

    ran = []
    for fn in ("grid_sample_band_pallas", "grid_sample_band_pallas_fused"):
        def counted(*args, _orig=getattr(wk, fn), _fn=fn, **kwargs):
            ran.append(_fn)
            return _orig(*args, **kwargs)
        monkeypatch.setattr(wk, fn, counted)
    monkeypatch.setattr(wk.pl, "pallas_call", interpreted)
    monkeypatch.setattr(jwf, "_use_pallas", lambda *a: True)
    ref, ref_g = _jax(image, grid, cot, mode, padding, band)
    assert ran == (["grid_sample_band_pallas_fused"] if mode == "bilinear"
                   else ["grid_sample_band_pallas"])
    out, g = _port(image, grid, cot, mode, padding, band)
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=0)
    if mode == "nearest":
        assert not np.any(g)
    else:
        assert _rel_l2(g, ref_g) <= 1e-4


def test_grid_warp_reads_images_modulo_batch():
    """Warp n reads image n mod M: the batched warp against one warp at a
    time, bitwise."""
    image, grid, _ = (torch.from_numpy(a.astype(np.float32))
                      for a in _inputs(16, 128, 3, seed=0))
    for mode, padding in ((m, p) for m in MODES for p in PADDINGS):
        out = twf.grid_band_plain(image, grid, mode, padding, 4)
        for n in range(2 * M):
            one = twf.grid_band_plain(image[n % M:n % M + 1],
                                      grid[n:n + 1].contiguous(), mode,
                                      padding, 4)
            for a, r in zip(out, one):
                assert torch.equal(a[n], r[0])


def test_nearest_zeros_warp_of_ones_is_the_in_bounds_test():
    """The mask warp the loss tests ``== 1.0``: exactly {0, 1}, and on a
    mask of ones exactly the analytic overlap of the grid."""
    _, grid, _ = _inputs(16, 128, 1, seed=3)
    grid = torch.from_numpy(grid.astype(np.float32))
    out = twf.grid_band_fwd(torch.ones(M, 16, 128, 1), grid, "nearest",
                            "zeros", 4)[..., 0]
    assert torch.all((out == 0) | (out == 1))
    x = twf.unnormalize(grid[..., 0], 128)
    y = twf.unnormalize(grid[..., 1], 16)
    inside = (x >= -0.5) & (x < 127.5) & (y >= -0.5) & (y < 15.5)
    assert torch.equal(out == 1.0, inside)
    assert 0 < int(inside.sum()) < inside.numel()


def test_grid_warp_rejects_what_it_does_not_take():
    image = torch.rand(2, 8, 16, 3)
    grid = torch.zeros(4, 8, 16, 2)
    with pytest.raises(TypeError):
        twf.grid_band_fwd(image.double(), grid.double(), "bilinear",
                          "border", 4)
    with pytest.raises(ValueError):
        twf.grid_band_fwd(image, grid[:3], "bilinear", "border", 4)
    with pytest.raises(ValueError):
        twf.grid_band_fused(image, grid, "reflect", 4)
    with pytest.raises(NotImplementedError):
        twf.grid_sample(image, grid, impl="gather")


@pytest.mark.parametrize("entry,nargs,pointers", [
    ("fsnet_warp_grid_fwd", 14, [0, 1, 2, 13]),
    ("fsnet_warp_grid_fused", 15, [0, 1, 2, 3, 4, 14]),
])
def test_grid_entry_points_declare_their_arguments(monkeypatch, entry, nargs,
                                                   pointers):
    """ctypes passes an undeclared argument as a 32-bit int and cuts a
    pointer: the wrappers name every pointer argument of their entry
    point (the stream, last, is one too) and its argument count."""
    import contextlib

    calls = []
    monkeypatch.setattr(twf, "_entry", lambda lib, name, ptrs, n: (
        calls.append((lib, name, ptrs, n)), lambda *args: 0)[1])
    monkeypatch.setattr(twf, "_route", lambda t, name: True)
    monkeypatch.setattr(twf, "_stream", lambda t: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    # Wo = 18: a row the row route does not take, so the wrappers reach the
    # narrow entry points (tests/test_torch_warp_grid_route.py checks the
    # row route's)
    image, grid = torch.rand(2, 8, 18, 3), torch.zeros(4, 8, 18, 2)
    if entry == "fsnet_warp_grid_fwd":
        twf.grid_band_fwd(image, grid, "nearest", "zeros", 4)
    else:
        twf.grid_band_fused(image, grid, "zeros", 4)
    (lib, name, ptrs, n), = calls
    assert (lib, name, n) == ("warp_grid", entry, nargs)
    assert sorted(set(ptrs) | {n - 1}) == pointers
