"""The port's depth-direct warp (on the CPU: its plain version) against the
JAX package: ``warp_depth_fused`` with its Pallas kernels in interpret mode,
and the grid route (``reproject`` + ``grid_sample_band``).

Scenes as ``tests/test_warp_depth.py``: S=F=B=2, H=16, (W=256, band 8),
(W=128, band 4), and W=640 with band 4 against the grid route. Bounds:
the forward ``out`` within 2e-5 abs, overlap agreement >= 0.9999, and d depth
of ``sum(sin(3 out))`` within rel-L2 1e-4. Both sides get the same inputs
(made with numpy) and the same affine rows; float32, matmul precision
"highest" on the JAX side.

The port rounds once per operation of the projection chain (as numpy and
eager JAX do); XLA compiles the JAX side's chain with fused multiply-adds,
so its pixel coordinates differ by up to a few ulp (measured: 42% of the
coordinates, at most 7.6e-5 px at W=256). On white-noise images a
coordinate moves ``out`` by up to |va| (|vb|) per pixel, so the forward
bound adds that first-order effect of 4 ulp of x and y to the 2e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import jax.experimental.pallas as pl

import fsnet_tpu.ops.pallas.warp_kernel as wk
import fsnet_tpu.ops.warp_depth as jwd
from fsnet_tpu.ops import geometry as jgeo
from fsnet_tpu.ops.warp_fast import grid_sample_band
from fsnet_tpu_torch.ops import geometry as tgeo
from fsnet_tpu_torch.ops import warp_depth as twd

torch.set_num_threads(1)

S, F, B, H, C = 2, 2, 2, 16, 3


@pytest.fixture(autouse=True)
def _interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(wk.pl, "pallas_call", patched)


def _scene(seed, W):
    """Smooth positive depth, KITTI-like intrinsics, small motions, random
    images (the scene of tests/test_warp_depth.py), as numpy."""
    rng = np.random.RandomState(seed)
    image = rng.rand(F * B, H, W, C).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    base = 8.0 + 4.0 * np.sin(xs / W * 4.0)[None] + rng.rand(S * B, 1, 1) * 6.0
    depth = (base + 2.0 * np.cos(ys / H * 3.0)[None]).astype(np.float32)
    K = np.zeros((B, 4, 4), np.float32)
    K[:, 0, 0], K[:, 1, 1] = 0.58 * W, 1.92 * H
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2], K[:, 3, 3] = 0.5 * W, 0.5 * H, 1, 1
    Ts = np.tile(np.eye(4, dtype=np.float32), (F, B, 1, 1))
    for f in range(F):
        for b in range(B):
            ang = (rng.rand(3) - 0.5) * 0.01
            Ts[f, b, :3, 3] = (rng.rand(3) - 0.5) * np.array([0.2, 0.1, 1.4])
            Ts[f, b, 0, 1], Ts[f, b, 1, 0] = -ang[2], ang[2]
            Ts[f, b, 0, 2], Ts[f, b, 2, 0] = ang[1], -ang[1]
            Ts[f, b, 1, 2], Ts[f, b, 2, 1] = -ang[0], ang[0]
    return image, depth, K, Ts


def _jax_rows(K, Ts):
    with jax.default_matmul_precision("highest"):
        Kj = jnp.asarray(K)
        inv_K = jgeo.invert_K(Kj)
        return inv_K, jwd.make_affine_rows(Kj, inv_K, jnp.asarray(Ts), S)


def _port(image, depth, arows, band):
    """Port forward (out, overlap), d depth of sum(sin(3 out)) and the
    bound on |out - ref| (see the module docstring)."""
    img = torch.from_numpy(image)
    rows = torch.from_numpy(np.array(arows))
    d = torch.from_numpy(depth).requires_grad_(True)
    out, overlap = twd.warp_depth_fused(img, d, rows, S, F, band)
    torch.sin(3.0 * out).sum().backward()
    assert twd.warp_depth_fwd.launches == 0      # the CPU never launches
    assert twd.warp_depth_bwd.launches == 0
    with torch.no_grad():
        _, _, va, vb = twd.warp_depth_plain(img, d, rows, S, F, band)
        p = tgeo.project_rows(twd._per_warp_depth(d, S, F), rows)
    ulp = [np.spacing(np.abs(p[k].numpy()))[..., None] for k in ("x", "y")]
    tol = 2e-5 + 4.0 * (ulp[0] * np.abs(va.numpy())
                        + ulp[1] * np.abs(vb.numpy()))
    return out.detach().numpy(), overlap.numpy(), d.grad.numpy(), tol


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _assert_close(port, ref):
    out, ov, dd, tol = port
    rout, rov, rdd = ref
    assert out.shape == rout.shape and ov.shape == rov.shape
    assert np.all(np.abs(out - rout) <= tol), np.max(np.abs(out - rout) - tol)
    assert np.mean(ov == rov) >= 0.9999
    assert _rel_l2(dd, rdd) <= 1e-4, _rel_l2(dd, rdd)


@pytest.mark.parametrize("W,band", [(256, 8), (128, 4)])
def test_warp_depth_matches_pallas(W, band):
    image, depth, K, Ts = _scene(0, W)
    _, arows = _jax_rows(K, Ts)

    def loss(d):
        out, _ = jwd.warp_depth_fused(jnp.asarray(image), d, arows, S, F, band)
        return jnp.sum(jnp.sin(3.0 * out))

    out, ov = jwd.warp_depth_fused(jnp.asarray(image), jnp.asarray(depth),
                                   arows, S, F, band)
    dd = jax.grad(loss)(jnp.asarray(depth))
    _assert_close(_port(image, depth, arows, band),
                  (np.asarray(out), np.asarray(ov), np.asarray(dd)))


def test_warp_depth_matches_grid_route_at_kitti_width():
    """W=640, band 4: the JAX grid route (reproject -> normalized grid ->
    grid_sample_band, plain XLA on the CPU) against the port."""
    W, band = 640, 4
    image, depth, K, Ts = _scene(1, W)
    inv_K, arows = _jax_rows(K, Ts)
    Kj, Tj = jnp.asarray(K), jnp.asarray(Ts)

    def route(d):
        d4 = d.reshape(S, B, H, W, 1)
        grids = jax.vmap(lambda dd: jax.vmap(
            lambda T: jgeo.reproject(dd, Kj, inv_K, T))(Tj))(d4)
        gf = grids.reshape(S * F * B, H, W, 2)
        out = grid_sample_band(jnp.asarray(image), gf, padding_mode="border",
                               band=band)
        xu = (gf[..., 0] + 1.0) / 2.0 * (W - 1)
        yu = (gf[..., 1] + 1.0) / 2.0 * (H - 1)
        ov = (xu >= -0.5) & (xu < W - 0.5) & (yu >= -0.5) & (yu < H - 0.5)
        return out, ov, xu, yu

    with jax.default_matmul_precision("highest"):
        out, ov, xu, yu = route(jnp.asarray(depth))
        dd = jax.grad(lambda d: jnp.sum(jnp.sin(3.0 * route(d)[0])))(
            jnp.asarray(depth))
    # Where the grid route's normalize/unnormalize rounding puts a sample
    # on the other side of an integer, the two routes take other corners:
    # the value is continuous there, its derivative (va, vb) is not. Those
    # depth pixels are counted, bounded, and left out of the gradient check.
    p = tgeo.project_rows(twd._per_warp_depth(torch.from_numpy(depth), S, F),
                          torch.from_numpy(np.array(arows)))
    flip = np.zeros((S * F * B, H, W), bool)
    for ref, got, n in ((xu, p["x"], W), (yu, p["y"], H)):
        flip |= (np.floor(np.clip(np.asarray(ref), 0, n - 1))
                 != np.floor(np.clip(got.numpy(), 0, n - 1)))
    flip = flip.reshape(S, F, B, H, W).any(axis=1).reshape(S * B, H, W)
    assert flip.mean() <= 1e-3          # measured: 1 of 40960
    keep = ~flip
    out_p, ov_p, dd_p, tol = _port(image, depth, arows, band)
    _assert_close((out_p, ov_p, dd_p[keep], tol),
                  (np.asarray(out), np.asarray(ov), np.asarray(dd)[keep]))


def test_affine_rows_and_reproject_match():
    image, depth, K, Ts = _scene(2, 128)
    inv_K, arows = _jax_rows(K, Ts)
    tK, tTs = torch.from_numpy(K), torch.from_numpy(Ts)
    t_inv = tgeo.invert_K(tK)
    np.testing.assert_allclose(t_inv.numpy(), np.asarray(inv_K), rtol=1e-6,
                               atol=1e-9)
    t_rows = twd.make_affine_rows(tK, t_inv, tTs, S)
    np.testing.assert_allclose(t_rows.numpy(), np.asarray(arows), rtol=1e-6,
                               atol=1e-6)
    P = np.zeros((B, 3, 4), np.float32)
    P[:, :3, :3] = K[:, :3, :3]
    np.testing.assert_array_equal(
        tgeo.make_K44(torch.from_numpy(P)).numpy(),
        np.asarray(jgeo.make_K44(jnp.asarray(P))))
    d = depth[:B, ..., None]
    with jax.default_matmul_precision("highest"):
        ref = jgeo.reproject(jnp.asarray(d), jnp.asarray(K), inv_K,
                             jnp.asarray(Ts[0]))
    got = tgeo.reproject(torch.from_numpy(d), tK, t_inv, tTs[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-6)


def test_warp_depth_sources_modulo_batch():
    """Warp n = (s F + f) B + b reads source f B + b and depth s B + b: the
    plain version against a loop over single warps."""
    W, band = 128, 4
    image, depth, K, Ts = _scene(3, W)
    _, arows = _jax_rows(K, Ts)
    img, dep = torch.from_numpy(image), torch.from_numpy(depth)
    rows = torch.from_numpy(np.asarray(arows))
    out, ov, _, _ = twd.warp_depth_plain(img, dep, rows, S, F, band)
    for s in range(S):
        for f in range(F):
            for b in range(B):
                n = (s * F + f) * B + b
                one, one_ov, _, _ = twd.warp_depth_plain(
                    img[f * B + b:f * B + b + 1], dep[s * B + b:s * B + b + 1],
                    rows[n:n + 1], 1, 1, band)
                torch.testing.assert_close(out[n], one[0], atol=0, rtol=0)
                assert torch.equal(ov[n], one_ov[0])


@pytest.mark.parametrize("entry,nargs,pointers", [
    ("fsnet_warp_depth_fwd", 15, [0, 1, 2, 3, 4, 5, 6, 14]),
    ("fsnet_warp_depth_bwd", 13, [0, 1, 2, 3, 4, 5, 12]),
])
def test_warp_entry_points_declare_their_arguments(monkeypatch, entry, nargs,
                                                   pointers):
    """ctypes passes an undeclared argument as a 32-bit int and cuts a
    pointer: each entry point carries its argtypes."""
    import ctypes
    import types

    from fsnet_tpu_torch.ops import _build
    from fsnet_tpu_torch.ops import conv3x3 as mod

    fn = types.SimpleNamespace(argtypes=None, restype=ctypes.c_int)
    monkeypatch.setattr(_build, "load",
                        lambda name: types.SimpleNamespace(**{entry: fn}))
    spec = {"fsnet_warp_depth_fwd": (0, 1, 2, 3, 4, 5, 6),
            "fsnet_warp_depth_bwd": (0, 1, 2, 3, 4, 5)}[entry]
    assert mod._entry("warp_depth", entry, spec, nargs) is fn
    assert len(fn.argtypes) == nargs
    assert [i for i, t in enumerate(fn.argtypes)
            if t is ctypes.c_void_p] == pointers
