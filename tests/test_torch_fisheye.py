"""The port's fisheye pieces (on the CPU: the plain versions of kernels G and
H) against the JAX package: the Mei camera's host inverse and forward
model, the norm-direct warp ``warp_mei_fused`` (JAX: its Pallas kernels
``mei_prep_pallas``, ``warp_rows_pallas_dma_fused`` and
``mei_prep_bwd_pallas`` in interpret mode), the fisheye grid route, the
fisheye batch, and ``forward_test`` of the fisheye ``MonoDepthWPose`` from
bridged weights.

Bounds, with the values measured when this test was written:

* ``backtrack_ray_map`` and ``make_mei_rows``: equal (both packages run the
  same numpy and the same copies);
* ``cam2image`` in float64: within 1e-12 (0);
* the norm-direct forward in float32 against the interpreted Pallas route
  at (W, band) = (256, 16) and (128, 8): the share of samples whose output
  differs by more than 1e-5 or whose overlap differs is at most 1e-4
  (measured 0 and 0); the norm cotangent of ``sum(sin(3 out))`` within
  3e-4 of its max, ``tests/test_warp_mei.py``'s bound (measured 2.4e-7 and
  1.9e-7);
* in float64, the port's norm-direct route against its own grid route and
  against the JAX grid route: output and norm cotangent within 1e-10
  (measured 1.1e-15 and 1.7e-14);
* ``forward_test`` from the same weights: depth and norm within 1e-4 of
  their max, the mask equal (measured 7e-8).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import jax.experimental.pallas as pl

import fsnet_tpu.ops.fisheye as jfe
import fsnet_tpu.ops.pallas.warp_kernel as wk
import fsnet_tpu.ops.warp_mei as jwm
from fsnet_tpu.ops.pallas.mei_prep_kernel import mei_prep_pallas
from fsnet_tpu.models.heads.fisheye_decoder import _mei_project as jax_project
from fsnet_tpu.ops.warp_fast import grid_sample_band
from fsnet_tpu_torch.models.heads.fisheye_decoder import _mei_project
from fsnet_tpu_torch.ops import fisheye as tfe
from fsnet_tpu_torch.ops import photo_loss as tpl
from fsnet_tpu_torch.ops import warp_fast as twf
from fsnet_tpu_torch.ops import warp_mei as twm

torch.set_num_threads(1)

S, F, B, C = 2, 2, 2, 3


@pytest.fixture()
def interpret(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(wk.pl, "pallas_call", patched)


@pytest.fixture()
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _P(H, W):
    P = np.zeros((3, 4), np.float32)
    P[0, 0] = P[1, 1] = 1.3 * W
    P[0, 2], P[1, 2], P[2, 2] = W / 2.0, H / 2.0, 1.0
    return P


# (H, W, xi, k1, k2): the calib of tests/test_fisheye.py and the fisheye
# bench's
CALIBS = [(40, 48, 2.2, 0.05, -0.01), (64, 128, 2.2, 0.2, 0.1)]


@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("calib", CALIBS)
def test_backtrack_ray_map_matches_jax(calib, compat):
    H, W, xi, k1, k2 = calib
    got = tfe.backtrack_ray_map(H, W, _P(H, W), xi, k1, k2,
                                ref_compat_xy=compat)
    ref = jfe.backtrack_ray_map(H, W, _P(H, W), xi, k1, k2,
                                ref_compat_xy=compat)
    for a, r in zip(got, ref):
        assert a.dtype == np.float32 and a.shape == (1, H, W)
        np.testing.assert_array_equal(a, r)
    assert got[3].sum() > 0.5 * H * W


def test_ray_map_cache():
    mei = tfe.MeiCameraProjection()
    calib = {"mirror_parameters": {"xi": 2.2},
             "distortion_parameters": {"k1": 0.05, "k2": -0.01}}
    first = mei.get_ray_map(40, 48, _P(40, 48), calib)
    assert mei.get_ray_map(40, 48, _P(40, 48), calib) is first
    assert len(mei.cache) == 1


def test_cam2image_matches_jax_float64(x64):
    H, W, xi, k1, k2 = CALIBS[0]
    rng = np.random.RandomState(0)
    points = rng.randn(5, H, W, 3) + np.array([0.0, 0.0, 2.0])
    P = _P(H, W).astype(np.float64)
    got = tfe.cam2image(torch.from_numpy(points), torch.from_numpy(P), xi, k1,
                        k2).numpy()
    ref = np.asarray(jfe.cam2image(jnp.asarray(points), jnp.asarray(P), xi,
                                   k1, k2))
    assert ref.dtype == np.float64
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    dx, dy = tfe.mei_distort(0.3, -0.2, k1, k2)
    np.testing.assert_allclose((dx, dy), jfe.mei_distort(0.3, -0.2, k1, k2),
                               rtol=0, atol=1e-15)


def _scene(seed, H, W):
    """The scene of tests/test_warp_mei.py (smooth positive norms, a unit
    ray field with a validity disc, KITTI-360-class intrinsics, small
    motions), as numpy."""
    rng = np.random.RandomState(seed)
    image = rng.rand(F * B, H, W, C).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    base = 8.0 + 4.0 * np.sin(xs / W * 4.0)[None] \
        + rng.rand(S * B, 1, 1) * 6.0
    norm = (base + 2.0 * np.cos(ys / H * 3.0)[None]).astype(np.float32)
    u = (xs - 0.5 * W) / (0.35 * W)
    v = (ys - 0.5 * H) / (0.35 * W)
    rays = np.stack([u, v, np.ones_like(u)], axis=-1).astype(np.float32)
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    valid = (u * u + v * v < 1.9).astype(np.float32)
    rays4 = np.concatenate([np.tile(rays[None], (B, 1, 1, 1)),
                            np.tile(valid[None, ..., None], (B, 1, 1, 1))],
                           axis=-1)
    P = np.tile(_P(H, W)[None], (B, 1, 1))
    P[:, 1, 2] = 0.5 * H
    params = np.tile(np.array([[2.17, 1.68, 0.0]], np.float32), (B, 1))
    Ts = np.tile(np.eye(4, dtype=np.float32), (F, B, 1, 1))
    for f in range(F):
        for b in range(B):
            ang = (rng.rand(3) - 0.5) * 0.01
            Ts[f, b, :3, 3] = (rng.rand(3) - 0.5) * np.array([1.4, 0.1, 0.2])
            Ts[f, b, 0, 1], Ts[f, b, 1, 0] = -ang[2], ang[2]
            Ts[f, b, 0, 2], Ts[f, b, 2, 0] = ang[1], -ang[1]
            Ts[f, b, 1, 2], Ts[f, b, 2, 1] = -ang[0], ang[0]
    return image, norm, rays4, P, params, Ts


def _port_args(image, norm, rays4, mrows, dtype=torch.float32):
    rays = torch.from_numpy(rays4).to(dtype)
    return (torch.from_numpy(image).to(dtype), rays[..., 3].contiguous(),
            torch.from_numpy(norm).to(dtype),
            rays[..., :3].permute(0, 3, 1, 2).contiguous(),
            torch.as_tensor(np.asarray(mrows)).to(dtype))


def test_make_mei_rows_matches_jax():
    _, _, _, P, params, Ts = _scene(0, 16, 128)
    ref = jwm.make_mei_rows(jnp.asarray(P), jnp.asarray(params),
                            jnp.asarray(Ts), S)
    got = twm.make_mei_rows(torch.from_numpy(P), torch.from_numpy(params),
                            torch.from_numpy(Ts), S)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("W,band", [(256, 16), (128, 8)])
def test_warp_mei_matches_pallas(interpret, W, band):
    H = 16
    image, norm, rays4, P, params, Ts = _scene(0, H, W)
    mrows = jwm.make_mei_rows(jnp.asarray(P), jnp.asarray(params),
                              jnp.asarray(Ts), S)
    j_img, j_mask = jnp.asarray(image), jnp.asarray(rays4[..., 3])
    j_rays = jnp.moveaxis(jnp.asarray(rays4[..., :3]), -1, 1)

    def loss(n):
        out, _ = jwm.warp_mei_fused(j_img, j_mask, n, j_rays, mrows, S, F,
                                    band, False)
        return jnp.sum(jnp.sin(3.0 * out))

    ref, ref_ov = jwm.warp_mei_fused(j_img, j_mask, jnp.asarray(norm), j_rays,
                                     mrows, S, F, band, True)
    ref_dn = np.asarray(jax.grad(loss)(jnp.asarray(norm)))

    img, mask, n, rays, rows = _port_args(image, norm, rays4, mrows)
    n.requires_grad_(True)
    out, ov = twm.warp_mei_fused(img, mask, n, rays, rows, S, F, band, True)
    torch.sin(3.0 * out).sum().backward()
    assert twm.warp_mei_fwd.launches == 0 and twm.warp_mei_bwd.launches == 0
    with torch.no_grad():
        _, _, va, vb = twm.warp_mei_plain(img, mask, n, rays, rows, S, F,
                                          band, True)
        p = twm.mei_pix(n, rays, rows, S, F)
    # XLA contracts the interpreted prep kernel's chain into fused
    # multiply-adds, so its fractions differ from the port's by a few ulp
    # of the projection's terms (g1 a fac ~ 1e2 px); the output moves by
    # |d fx| |va| + |d fy| |vb|. Where a difference crosses an integer the
    # two take other corners (counted); elsewhere the fraction differences
    # stay below 1e-4 px (measured 4.8e-5 at W=256) and explain the output
    # differences to 1e-5.
    fpack = np.asarray(mei_prep_pallas(jnp.asarray(norm), j_rays, mrows, S,
                                       F, band)[1]).reshape(-1, 2, H, W)
    dfr = [np.abs(twm._clamp(p[k], lim - 1).numpy() % 1.0 - fpack[:, c])
           for c, (k, lim) in enumerate((("x", W), ("y", H)))]
    wrapped = (dfr[0] > 0.5) | (dfr[1] > 0.5)
    assert wrapped.mean() <= 1e-4, wrapped.mean()
    assert max(d[~wrapped].max() for d in dfr) <= 1e-4
    tol = 1e-5 + (dfr[0][..., None] * np.abs(va.numpy())
                  + dfr[1][..., None] * np.abs(vb.numpy()))
    out, ov = out.detach().numpy(), ov.numpy()
    ref, ref_ov = np.asarray(ref), np.asarray(ref_ov)
    assert out.shape == ref.shape and ov.shape == ref_ov.shape
    bad = ((np.abs(out - ref) > tol).any(axis=-1) & ~wrapped) | \
        (ov != ref_ov)
    assert bad.mean() <= 1e-4, bad.mean()
    dn = n.grad.numpy()
    assert np.abs(dn - ref_dn).max() <= 3e-4 * np.abs(ref_dn).max()


def _grid_route(project, grid_sample, norm, rays, P, params, Ts, H, W,
                stack):
    """The fisheye head's grid route, for either package: grids from the
    rotated ray field and the Mei projection, normalized."""
    R = Ts[:, :, :3, :3][:, :, None, None]
    rot = stack([R[..., k, 0] * rays[None, ..., 0]
                 + R[..., k, 1] * rays[None, ..., 1]
                 + R[..., k, 2] * rays[None, ..., 2] for k in range(3)], -1)
    pts = norm.reshape(S, 1, B, H, W, 1) * rot[None] \
        + Ts[:, :, :3, 3][None, :, :, None, None, :]
    N = S * F * B
    Pn = stack([P] * (S * F), 0).reshape(N, 3, 4)
    pn = stack([params] * (S * F), 0).reshape(N, 3)
    pix = project(pts.reshape(N, H, W, 3), Pn, pn)
    grid = stack([pix[..., 0] / (W - 1) * 2.0 - 1.0,
                  pix[..., 1] / (H - 1) * 2.0 - 1.0], -1)
    return grid_sample(grid)


def test_warp_mei_routes_match_in_float64(x64, monkeypatch):
    """The port's norm-direct route, its grid route (the head's
    ``_mei_project`` + band warp) and the JAX grid route compute one
    function: outputs and norm cotangents within 1e-10 in float64."""
    monkeypatch.setattr(twm, "_DTYPES", (torch.float64,))
    monkeypatch.setattr(twf, "_DTYPES", (torch.float64,))
    H, W, band = 16, 128, 16
    image, norm, rays4, P, params, Ts = _scene(1, H, W)
    image, norm, rays4, P, params, Ts = (a.astype(np.float64) for a in
                                         (image, norm, rays4, P, params, Ts))
    mrows = twm.make_mei_rows(torch.from_numpy(P), torch.from_numpy(params),
                              torch.from_numpy(Ts), S)
    img, mask, n_direct, rays, rows = _port_args(image, norm, rays4, mrows,
                                                 torch.float64)
    n_direct.requires_grad_(True)
    out_d, _ = twm.warp_mei_fused(img, mask, n_direct, rays, rows, S, F,
                                  band, False)
    torch.sin(3.0 * out_d).sum().backward()

    n_grid = torch.from_numpy(norm).requires_grad_(True)
    tt = [torch.from_numpy(a) for a in (rays4[..., :3], P, params, Ts)]
    out_g = _grid_route(
        _mei_project, lambda g: twf.grid_sample(
            img, g.contiguous(), "bilinear", "border", band=band),
        n_grid, tt[0], tt[1], tt[2], tt[3], H, W, torch.stack)
    torch.sin(3.0 * out_g).sum().backward()

    def jax_route(n):
        return _grid_route(
            jax_project, lambda g: grid_sample_band(
                jnp.asarray(image), g, padding_mode="border", band=band),
            n, jnp.asarray(rays4[..., :3]), jnp.asarray(P),
            jnp.asarray(params), jnp.asarray(Ts), H, W, jnp.stack)

    out_j = np.asarray(jax_route(jnp.asarray(norm)))
    dn_j = np.asarray(jax.grad(
        lambda n: jnp.sum(jnp.sin(3.0 * jax_route(n))))(jnp.asarray(norm)))
    assert out_j.dtype == np.float64
    for out, dn in ((out_g, n_grid.grad), (out_j, dn_j)):
        out = out.detach().numpy() if torch.is_tensor(out) else out
        dn = dn.numpy() if torch.is_tensor(dn) else dn
        assert np.abs(out_d.detach().numpy() - out).max() <= 1e-10
        assert np.abs(n_direct.grad.numpy() - dn).max() <= \
            1e-10 * np.abs(dn).max()


def test_warp_mei_sources_modulo_batch():
    """Warp n = (s F + f) B + b reads source f B + b, mask b, rays b and
    norm s B + b: the plain version against a loop over single warps."""
    H, W, band = 16, 128, 8
    image, norm, rays4, P, params, Ts = _scene(2, H, W)
    rows = twm.make_mei_rows(torch.from_numpy(P), torch.from_numpy(params),
                             torch.from_numpy(Ts), S)
    img, mask, nrm, rays, rows = _port_args(image, norm, rays4, rows)
    out, ov, va, vb = twm.warp_mei_plain(img, mask, nrm, rays, rows, S, F,
                                         band, True)
    for s in range(S):
        for f in range(F):
            for b in range(B):
                k = (s * F + f) * B + b
                one = twm.warp_mei_plain(
                    img[f * B + b:f * B + b + 1], mask[b:b + 1],
                    nrm[s * B + b:s * B + b + 1], rays[b:b + 1],
                    rows[k:k + 1], 1, 1, band, True)
                for a, r in zip((out, ov, va, vb), one):
                    assert torch.equal(a[k], r[0])


def test_warp_mei_clamps_non_finite_coordinates():
    """A coordinate that is NaN or infinite (zh + xi + eps at 0 when
    xi < 1) reads inside the image, as the kernel's fminf/fmaxf clamp does:
    NaN -> column 0, +inf -> the last."""
    H, W, band = 16, 128, 8
    image, norm, rays4, P, params, Ts = _scene(3, H, W)
    rows = twm.make_mei_rows(torch.from_numpy(P), torch.from_numpy(params),
                             torch.from_numpy(Ts), 1)
    img, mask, nrm, rays, rows = _port_args(image, norm[:B], rays4, rows)
    x = torch.tensor([float("nan"), float("inf"), -float("inf"), 3.5])
    np.testing.assert_array_equal(twm._clamp(x, W - 1).numpy(),
                                  [0.0, W - 1, 0.0, 3.5])
    rows[:, 12] = -1.0               # xi = -1: zh + xi + eps near or at 0
    rows[:, 11] = 0.0
    out, ov, va, vb = twm.warp_mei_plain(img, mask, nrm, rays, rows, 1, F,
                                         band, True)
    assert out.shape == (F * B, H, W, C)
    assert bool(torch.isfinite(out).all())


@pytest.mark.parametrize("entry,nargs,pointers", [
    ("fsnet_warp_mei_fwd", 19, list(range(9)) + [18]),
    ("fsnet_warp_mei_bwd", 15, list(range(7)) + [14]),
])
def test_warp_mei_entry_points_declare_their_arguments(monkeypatch, entry,
                                                       nargs, pointers):
    """ctypes passes an undeclared argument as a 32-bit int and cuts a
    pointer: the wrappers declare each entry point's argtypes and call it
    with that many arguments (a stand-in C function, CPU tensors routed as
    if on the card)."""
    import contextlib
    import ctypes
    import types

    from fsnet_tpu_torch.ops import _build

    calls = []

    class CFunction:
        argtypes = restype = None

        def __call__(self, *args):
            calls.append(args)
            return 0

    fn = CFunction()
    monkeypatch.setattr(_build, "load",
                        lambda name: types.SimpleNamespace(**{entry: fn})
                        if name == "warp_mei" else None)
    monkeypatch.setattr(twm, "_route", lambda t, name: True)
    monkeypatch.setattr(twm, "_stream", lambda t: 0)
    monkeypatch.setattr(twm.torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    H, W = 8, 18      # W % 4 != 0: the narrow route's entry points
    image, norm, rays4, P, params, Ts = _scene(4, H, W)
    rows = twm.make_mei_rows(torch.from_numpy(P), torch.from_numpy(params),
                             torch.from_numpy(Ts), S)
    img, mask, nrm, rays, rows = _port_args(image, norm, rays4, rows)
    n_fwd, n_bwd = twm.warp_mei_fwd.launches, twm.warp_mei_bwd.launches
    for wrapper in (twm.warp_mei_fwd, twm.warp_mei_bwd):
        monkeypatch.setattr(wrapper, "dtypes", dict(wrapper.dtypes))
    try:
        if entry == "fsnet_warp_mei_fwd":
            twm.warp_mei_fwd(img, mask, nrm, rays, rows, S, F, 4, True)
        else:
            g = torch.zeros(S * F * B, H, W, C)
            twm.warp_mei_bwd(nrm, rays, g, g, g, rows, S, F)
        assert (twm.warp_mei_fwd.launches - n_fwd,
                twm.warp_mei_bwd.launches - n_bwd) == \
            ((1, 0) if entry == "fsnet_warp_mei_fwd" else (0, 1))
    finally:
        twm.warp_mei_fwd.launches, twm.warp_mei_bwd.launches = n_fwd, n_bwd
    assert len(calls) == 1 and len(calls[0]) == nargs
    assert len(fn.argtypes) == nargs and fn.restype is ctypes.c_int
    assert [i for i, t in enumerate(fn.argtypes)
            if t is ctypes.c_void_p] == pointers


def _jax_names(cfg):
    """A port config with the JAX package's names."""
    if isinstance(cfg, dict):
        return {k: _jax_names(v) for k, v in cfg.items()}
    if isinstance(cfg, str):
        return cfg.replace("fsnet_tpu_torch.", "fsnet_tpu.")
    return cfg


def _randomise(variables, rng):
    """Every BN statistic, BN affine and bias randomised, so that a bridge
    that swaps or drops a tensor shows."""
    def leaf(path, a):
        a = np.asarray(a)
        name = str(path[-1].key)
        if name in ("var", "scale"):
            return (0.5 + rng.rand(*a.shape)).astype(np.float32)
        if name in ("mean", "bias"):
            return (0.1 * rng.randn(*a.shape)).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(leaf, variables)


def test_forward_test_matches_jax():
    """The fisheye ``MonoDepthWPose`` (built from ``fisheye_config`` under
    both packages' names) from the same weights, carried by the flax
    bridge: ``forward_test`` gives the z-depth, the norm and the fisheye
    mask of the JAX head; the bridge carries every parameter both ways (the
    head adds none)."""
    from fsnet_tpu.utils.builder import build
    from fsnet_tpu_torch.entry import (fisheye_batch, fisheye_config,
                                       fisheye_model)
    from fsnet_tpu_torch.models.flax_convert import (load_flax_variables,
                                                     to_flax)
    from fsnet_tpu_torch.runtime.state import make_eval_step

    H, W = 64, 128
    batch = fisheye_batch(2, H, W)
    model = build(**_jax_names(fisheye_config(H, W)))

    def init(m, x):
        return m.head.forward_depth(m.depth_backbone(x, train=False),
                                    train=False)

    with jax.default_matmul_precision("highest"):
        v = jax.jit(lambda x: model.init({"params": jax.random.PRNGKey(0)},
                                         x, method=init))(batch["image/0"])
        v = _randomise(v, np.random.RandomState(0))
        ref = model.apply(v, batch, {"is_training": False})
    port = fisheye_model(H, W, device="cpu")
    assert type(port.head).__name__ == "FishEyeDecoder"
    assert port.head.warp_band == 16
    load_flax_variables(port, v)
    got = make_eval_step("cpu")(port, batch)
    assert sorted(got) == sorted(ref) == ["depth", "fisheye_mask", "norm"]
    for key in ("depth", "norm"):
        r = np.asarray(ref[key])
        assert got[key].shape == r.shape == (2, H, W, 1)
        assert np.abs(got[key].numpy() - r).max() <= 1e-4 * np.abs(r).max()
    np.testing.assert_array_equal(got["fisheye_mask"].numpy(),
                                  np.asarray(ref["fisheye_mask"]))
    back = to_flax(port, dict(port.named_parameters()))["params"]
    flat = jax.tree_util.tree_leaves_with_path(v["params"])
    assert len(jax.tree_util.tree_leaves(back)) == len(flat)
    for path, leaf in flat:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(np.asarray(node), np.asarray(leaf))


def test_fisheye_batch_matches_tpu_bench(monkeypatch):
    """``entry.fisheye_batch`` is the batch of
    ``scripts/tpu_fisheye_bench.py`` (same RandomState(0) draws, camera,
    poses and ray map), at a small size: equal."""
    import importlib.util
    import sys
    from pathlib import Path

    from fsnet_tpu_torch.entry import fisheye_batch

    path = Path(__file__).resolve().parents[1] / "scripts" / \
        "tpu_fisheye_bench.py"
    monkeypatch.setattr(sys, "argv", [str(path), "2"])
    spec = importlib.util.spec_from_file_location("tpu_fisheye_bench", path)
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    monkeypatch.setattr(bench, "H", 64)
    monkeypatch.setattr(bench, "W", 128)
    ref = bench._batch()
    got = fisheye_batch(2, 64, 128)
    assert sorted(got) == sorted(ref)
    for key in ref:
        assert got[key].dtype == np.asarray(ref[key]).dtype, key
        np.testing.assert_array_equal(got[key], np.asarray(ref[key]))


def test_grid_route_matches_norm_direct_loss(monkeypatch):
    """The fisheye head's two routes in one port train step, float64: the
    norm-direct route (``MonoDepthWPose``'s constant poses) and the grid
    route (the constant-pose marker removed) give one loss, and each took
    its own warp."""
    from fsnet_tpu_torch.entry import (fisheye_batch, fisheye_model,
                                       flagship_optimizer)
    from fsnet_tpu_torch.ops import conv3x3 as tc
    from fsnet_tpu_torch.runtime.state import make_train_step

    H, W = 64, 128
    batch = {k: v.astype(np.float64)
             for k, v in fisheye_batch(2, H, W).items()}
    monkeypatch.setitem(tc._DTYPES, torch.float64, -1)
    monkeypatch.setattr(twm, "_DTYPES", (torch.float64,))
    monkeypatch.setattr(twf, "_DTYPES", (torch.float64,))
    monkeypatch.setattr(tpl, "_DTYPES", (torch.float64,))
    warps = []
    for mod, fn in ((twm, "warp_mei_plain"), (twf, "grid_band_plain")):
        monkeypatch.setattr(mod, fn, lambda *a, _o=getattr(mod, fn), _f=fn,
                            **k: (warps.append(_f), _o(*a, **k))[1])
    losses = {}
    for route in ("norm-direct", "grid"):
        model = fisheye_model(H, W, device="cpu").double()
        if route == "grid":
            warp_all = model.head._warp_all
            model.head._warp_all = lambda i, o: (o.pop("pose_is_const"),
                                                 warp_all(i, o))[1]
        opt, _ = flagship_optimizer(model)
        warps.clear()
        losses[route] = float(make_train_step("cpu")(model, opt,
                                                     batch)["loss"])
        assert sorted(set(warps)) == (["warp_mei_plain"] if route ==
                                      "norm-direct" else ["grid_band_plain"])
    assert abs(losses["grid"] - losses["norm-direct"]) <= \
        1e-10 * abs(losses["norm-direct"])
