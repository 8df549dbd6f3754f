"""The port's image-gradient band warp (kernel K's plain version,
``fsnet_tpu_torch.ops.warp_fast.grid_band_bwd_plain``, behind
``grid_sample(..., image_grad=True)``) and its deformable conv
(``fsnet_tpu_torch.ops.dcn``) against the JAX package, from the same numpy
inputs.

* The warp against JAX's ``grid_sample_band(..., image_grad=True)`` on its
  XLA route, both sides in float64: both cotangents of ``jax.vjp`` (the
  image's from the one-hot band scatter, the grid's from the difference
  passes) against torch autograd within 1e-12 of the largest entry, border
  and zeros padding, bands 4 and 8, with samples outside the band.
* The grid cotangent (gfx, gfy) against the interpreted Pallas kernels
  ``warp_rows_pallas_dma_bwd`` (TPU #8, ``dma=True``) and
  ``warp_rows_pallas_bwd`` (#11, ``dma=False``) in float32, one warp each:
  within 1e-5 of the largest entry.
* ``modulated_deform_conv`` and ``deform_conv``: forward and the VJP in x,
  offset, mask, weight and bias against JAX in float64 at stride 1 and 2
  (within 1e-10 of each leaf's largest entry); zero offsets equal
  ``F.conv2d``; in float32 at zero offsets the grid's round trip through
  the normalized coordinate picks the JAX package's corners (the offset
  cotangent within 1e-4); one 1x1 DCN on JAX's forced Pallas route (#7
  forward, #8 backward, interpreted) within 1e-4.
"""
import contextlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp

import fsnet_tpu.ops.dcn as jdcn
import fsnet_tpu.ops.pallas.warp_kernel as wk
import fsnet_tpu.ops.warp_fast as jwf
from fsnet_tpu_torch.ops import dcn as tdcn
from fsnet_tpu_torch.ops import warp_fast as twf

torch.set_num_threads(1)


@pytest.fixture
def x64(monkeypatch):
    monkeypatch.setattr(twf, "_DTYPES", (torch.float64,))
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.fixture
def interpreted(monkeypatch):
    """Every Pallas call of the warp kernels interpreted; returns the names
    of the backward kernels that ran."""
    ran = []

    def patched(*args, _orig=pl.pallas_call, **kwargs):
        kwargs["interpret"] = True
        return _orig(*args, **kwargs)

    monkeypatch.setattr(wk.pl, "pallas_call", patched)
    for fn in ("warp_rows_pallas_dma_bwd", "warp_rows_pallas_bwd"):
        def counted(*args, _orig=getattr(wk, fn), _fn=fn, **kwargs):
            ran.append(_fn)
            return _orig(*args, **kwargs)
        monkeypatch.setattr(wk, fn, counted)
    return ran


def _rel(a, r):
    return float(np.abs(np.asarray(a) - np.asarray(r)).max()
                 / np.abs(np.asarray(r)).max())


def _warp_inputs(M, H, W, Ho, Wo, C, seed):
    """Images and smooth grids that leave the image at its edges (zeros
    padding and the border clamp both act) and spread some rows beyond a
    band of 8."""
    rng = np.random.RandomState(seed)
    image = rng.rand(M, H, W, C)
    ys, xs = np.meshgrid(np.linspace(-1.15, 1.15, Ho),
                         np.linspace(-1.1, 1.1, Wo), indexing="ij")
    grid = []
    for n in range(M):
        dx = 0.05 * np.sin(2 * np.pi * xs + n) * np.cos(np.pi * ys)
        dy = 0.6 * np.cos(np.pi * xs + 0.5 * n)
        jit = rng.uniform(-1, 1, (Ho, Wo, 2)) * [2.0 / W, 1.5 / H]
        grid.append(np.stack([xs + dx, ys + dy], -1) + jit)
    return image, np.stack(grid), rng.randn(M, Ho, Wo, C)


def _outside_band(grid, H, W, band, padding):
    """Samples with a weighted corner row the band does not hold."""
    g = torch.from_numpy(grid)
    iw = twf.indices_and_weights(twf.unnormalize(g[..., 0], W),
                                 twf.unnormalize(g[..., 1], H), H, W, band,
                                 "bilinear", padding)
    y = twf.unnormalize(g[..., 1], H)
    if padding == "border":
        y = y.clamp(0, H - 1)
    y0 = torch.floor(y)
    miss = (((iw["r0"] != y0.clamp(0, H - 1)) & (iw["wy0"] != 0))
            | ((iw["r1"] != (y0 + 1).clamp(0, H - 1)) & (iw["wy1"] != 0)))
    return int(miss.sum())


@pytest.mark.parametrize("band", [4, 8])
@pytest.mark.parametrize("padding", ["border", "zeros"])
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_image_grad_warp_matches_jax_xla_f64(x64, mode, padding, band):
    M, H, W, Ho, Wo, C = 2, 16, 40, 12, 28, 3
    image, grid, cot = _warp_inputs(M, H, W, Ho, Wo, C, seed=band)
    assert _outside_band(grid, H, W, band, padding) > 0

    def f(im, gr):
        return jwf.grid_sample_band(im, gr, mode=mode, padding_mode=padding,
                                    band=band, image_grad=True)
    ref, vjp = jax.vjp(f, jnp.asarray(image), jnp.asarray(grid))
    ref_di, ref_dg = vjp(jnp.asarray(cot))
    assert np.asarray(ref).dtype == np.float64

    im = torch.from_numpy(image).requires_grad_(True)
    gr = torch.from_numpy(grid).requires_grad_(True)
    out = twf.grid_sample(im, gr, mode=mode, padding_mode=padding, band=band,
                          image_grad=True)
    out.backward(torch.from_numpy(cot))
    assert _rel(out.detach(), ref) <= 1e-12
    assert _rel(im.grad, ref_di) <= 1e-12
    if mode == "nearest":
        assert not np.any(np.asarray(ref_dg)) and not gr.grad.any()
    else:
        assert _rel(gr.grad, ref_dg) <= 1e-12


@pytest.mark.parametrize("padding", ["border", "zeros"])
@pytest.mark.parametrize("dma", [True, False], ids=["dma_8", "bands_11"])
def test_grid_cotangent_matches_jax_pallas_f32(interpreted, dma, padding):
    """One warp through ``grid_sample_band_pallas_bwd`` (#8 with DMA band
    gathers, #11 on materialized bands) against the plain gfx, gfy."""
    H, W, C, band = 16, 128, 8, 8
    image, grid, cot = (a.astype(np.float32) for a in
                        _warp_inputs(1, H, W, H, W, C, seed=3))
    assert _outside_band(grid.astype(np.float64), H, W, band, padding) > 0
    iw = jwf._indices_and_weights(image.shape, jnp.asarray(grid), "bilinear",
                                  padding, True, band)
    mx0, mx1, my0, my1 = jwf._padding_masks(iw, padding, jnp.float32)
    gfx, gfy = wk.grid_sample_band_pallas_bwd(
        jnp.asarray(image), iw, band, -mx0, mx1, iw["wy0"], iw["wy1"],
        iw["wx0"], iw["wx1"], -my0, my1, jnp.asarray(cot), dma=dma)
    assert interpreted == ["warp_rows_pallas_dma_bwd" if dma
                           else "warp_rows_pallas_bwd"]
    got = twf.grid_band_bwd_plain(torch.from_numpy(image),
                                  torch.from_numpy(grid),
                                  torch.from_numpy(cot), "bilinear", padding,
                                  band)
    assert _rel(got[0], gfx) <= 1e-5
    assert _rel(got[1], gfy) <= 1e-5


def test_image_cotangent_goes_to_image_n_mod_m():
    """A grid batch of 2M against M images: each image's cotangent is the
    sum of its two warps', and the grid cotangent is per warp."""
    image, grid, cot = (torch.from_numpy(a.astype(np.float32)) for a in
                        _warp_inputs(4, 16, 40, 12, 28, 3, seed=5))
    image = image[:2].contiguous()
    gfx, gfy, dimage = twf.grid_band_bwd_plain(image, grid, cot, "bilinear",
                                               "zeros", 4)
    parts = [twf.grid_band_bwd_plain(image, grid[k:k + 2].contiguous(),
                                     cot[k:k + 2].contiguous(), "bilinear",
                                     "zeros", 4) for k in (0, 2)]
    assert torch.equal(gfx, torch.cat([p[0] for p in parts]))
    assert torch.equal(gfy, torch.cat([p[1] for p in parts]))
    assert torch.allclose(dimage, parts[0][2] + parts[1][2], rtol=0,
                          atol=1e-6)


def _dcn_inputs(B, H, W, Cin, Cout, stride, seed, offset_std=1.5, K=3):
    """A K x K DCN's operands (padding K // 2) and an output cotangent."""
    rng = np.random.RandomState(seed)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    return dict(x=rng.rand(B, H, W, Cin),
                offset=rng.randn(B, Ho, Wo, 2 * K * K) * offset_std,
                mask=rng.rand(B, Ho, Wo, K * K),
                weight=rng.randn(K, K, Cin, Cout) / np.sqrt(K * K * Cin),
                bias=rng.randn(Cout)), rng.randn(B, Ho, Wo, Cout)


def _jax_dcn(args, cot, stride, modulated):
    names = list(args) if modulated else [k for k in args if k != "mask"]
    pad = args["weight"].shape[0] // 2

    def f(*vals):
        kw = dict(zip(names, vals))
        if modulated:
            return jdcn.modulated_deform_conv(
                kw["x"], kw["offset"], kw["mask"], kw["weight"], kw["bias"],
                stride=stride, padding=pad, warp_band=8)
        return jdcn.deform_conv(kw["x"], kw["offset"], kw["weight"],
                                kw["bias"], stride=stride, padding=pad,
                                warp_band=8)
    out, vjp = jax.vjp(f, *(jnp.asarray(args[k]) for k in names))
    return np.asarray(out), dict(zip(names, vjp(jnp.asarray(cot))))


def _port_dcn(args, cot, stride, modulated):
    t = {k: torch.from_numpy(v).requires_grad_(True) for k, v in args.items()}
    pad = args["weight"].shape[0] // 2
    if modulated:
        out = tdcn.modulated_deform_conv(t["x"], t["offset"], t["mask"],
                                         t["weight"], t["bias"], stride, pad,
                                         1, 8)
    else:
        out = tdcn.deform_conv(t["x"], t["offset"], t["weight"], t["bias"],
                               stride, pad, 1, 8)
    out.backward(torch.from_numpy(cot))
    return out.detach().numpy(), {k: v.grad for k, v in t.items()
                                  if v.grad is not None}


@pytest.mark.parametrize("modulated", [True, False],
                         ids=["modulated", "deform"])
@pytest.mark.parametrize("stride", [1, 2])
def test_dcn_matches_jax_f64(x64, stride, modulated):
    args, cot = _dcn_inputs(2, 12, 14, 4, 5, stride, seed=stride)
    if not modulated:
        args.pop("mask")
    ref, ref_g = _jax_dcn(args, cot, stride, modulated)
    assert ref.dtype == np.float64
    out, grads = _port_dcn(args, cot, stride, modulated)
    assert out.shape == ref.shape
    assert _rel(out, ref) <= 1e-10
    assert sorted(grads) == sorted(ref_g)
    for k, g in grads.items():
        assert _rel(g.numpy(), ref_g[k]) <= 1e-10, k


@pytest.mark.parametrize("stride", [1, 2])
def test_dcn_with_zero_offsets_is_a_conv(stride):
    args, _ = _dcn_inputs(2, 10, 11, 3, 4, stride, seed=7, offset_std=0.0)
    t = {k: torch.from_numpy(v) for k, v in args.items()}
    out = tdcn.deform_conv(t["x"].float(), t["offset"].float(),
                           t["weight"].float(), t["bias"].float(), stride)
    ref = F.conv2d(t["x"].permute(0, 3, 1, 2), t["weight"].permute(3, 2, 0, 1),
                   t["bias"], stride, 1).permute(0, 2, 3, 1)
    assert out.shape == ref.shape
    assert _rel(out.double(), ref) <= 1e-6


def test_dcn_grid_round_trip_matches_jax_f32():
    """At zero offsets the sample positions are integers, and the
    normalized grid's round trip moves some of them one ulp down
    (4.9999997 -> corners 3 and 4): the port must pick JAX's corners, which
    the offset cotangent shows."""
    args, cot = _dcn_inputs(1, 10, 33, 3, 4, 1, seed=8, offset_std=0.0)
    args = {k: v.astype(np.float32) for k, v in args.items()}
    cot = cot.astype(np.float32)
    ref, ref_g = _jax_dcn(args, cot, 1, True)
    out, grads = _port_dcn(args, cot, 1, True)
    assert _rel(out, ref) <= 1e-5
    for k, g in grads.items():
        assert _rel(g.numpy(), ref_g[k]) <= 1e-4, k


def test_dcn_matches_jax_forced_pallas_f32(monkeypatch, interpreted):
    """JAX's DCN on its TPU route (``_use_pallas`` forced, Pallas
    interpreted): #7 forward and #8 backward for every tap. Each
    interpreted call costs seconds here, so the DCN is 1x1 (one tap; the
    taps of a 3x3 run the same warp): 1 forward and 1 backward call."""
    monkeypatch.setattr(jwf, "_use_pallas", lambda *a: True)
    args, cot = _dcn_inputs(1, 8, 16, 4, 4, 1, seed=9, K=1)
    args = {k: v.astype(np.float32) for k, v in args.items()}
    cot = cot.astype(np.float32)
    ref, ref_g = _jax_dcn(args, cot, 1, True)
    assert interpreted == ["warp_rows_pallas_dma_bwd"]
    out, grads = _port_dcn(args, cot, 1, True)
    assert _rel(out, ref) <= 1e-4
    for k, g in grads.items():
        assert _rel(g.numpy(), ref_g[k]) <= 1e-4, k


def test_grid_band_bwd_rejects_what_it_does_not_take():
    image, grid = torch.rand(2, 8, 16, 3), torch.zeros(4, 8, 16, 2)
    g = torch.rand(4, 8, 16, 3)
    with pytest.raises(ValueError):
        twf.grid_band_bwd(image, grid, g[:, :7], "bilinear", "zeros", 4)
    with pytest.raises(ValueError):
        twf.grid_band_bwd(image, grid, g.transpose(1, 2).contiguous()
                          .transpose(1, 2), "bilinear", "zeros", 4)
    with pytest.raises(TypeError):
        twf.grid_band_bwd(image.double(), grid.double(), g.double(),
                          "bilinear", "zeros", 4)


def test_grid_bwd_entry_point_declares_its_arguments(monkeypatch):
    """ctypes passes an undeclared argument as a 32-bit int and cuts a
    pointer: the wrapper names every pointer argument of kernel K's entry
    point (the stream, last, is one too) and its argument count."""
    calls = []
    monkeypatch.setattr(twf, "_entry", lambda lib, name, ptrs, n: (
        calls.append((lib, name, ptrs, n)), lambda *args: 0)[1])
    monkeypatch.setattr(twf, "_route", lambda t, name: True)
    monkeypatch.setattr(twf, "_stream", lambda t: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    twf.grid_band_bwd(torch.rand(2, 8, 16, 3), torch.zeros(4, 8, 16, 2),
                      torch.rand(4, 8, 16, 3), "bilinear", "zeros", 4)
    (lib, name, ptrs, n), = calls
    assert (lib, name, n) == ("warp_grad", "fsnet_warp_grid_bwd", 17)
    assert sorted(set(ptrs) | {n - 1}) == [0, 1, 2, 3, 4, 5, 16]
