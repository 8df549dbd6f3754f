"""The port's photometric loss (``fsnet_tpu_torch.ops.photo_loss``; on the
CPU the plain versions of the two kernels of ``csrc/photo_loss.cu``) against
the JAX package, and its closed-form cotangent against autograd.

Bounds, with the values measured when this test was written:

* ``photo_loss_plain`` against the JAX XLA route's ``reprojection_loss``
  (``monodepth2_decoder.py:86``, the target tiled to N) in float64, N = 8,
  B = 2, H, W in {2, 3, 5}, C in {1, 3}: within 1e-12 of the largest loss
  (measured 4.9e-15);
* ``reprojection_loss_fused`` against the JAX package's, its Pallas kernels
  interpreted as ``tests/test_photo_kernel.py`` runs them, float32 ``rand``
  data: the forward within 1e-5 absolute and the cotangent within 2e-5 of
  its largest entry, the JAX package's own gates between its kernel and its
  XLA route (measured 1.0e-6 and 3.8e-6: the TPU kernel pools with one 1/9
  scale, the port with two of 1/3);
* ``photo_loss_bwd_plain`` against autograd of ``photo_loss_plain`` in
  float64 on data with exact ties (flat windows, pred == target, SSIM
  clipped at 0 and at 1), H, W in {2, 3, 4, 5}: within 1e-12 of the largest
  entry (measured 5.3e-15);
* the loss head through the fused op against the head's former route
  (``reprojection_loss`` on the target and its stats tiled S x F fold) in
  float64: loss and depth cotangents within 1e-12 (measured 1.4e-16 and
  7.0e-16).
"""
import contextlib
import ctypes
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import jax.experimental.pallas as pl

import fsnet_tpu.ops.pallas.photo_kernel as pk
import fsnet_tpu.ops.photo_loss as jpl
from fsnet_tpu.models.heads.monodepth2_decoder import \
    reprojection_loss as j_reproj
from fsnet_tpu.ops.ssim import ssim_target_stats as j_stats
from fsnet_tpu_torch.models.heads import monodepth2_decoder as tmd
from fsnet_tpu_torch.ops import photo_loss as tpl
from fsnet_tpu_torch.ops import warp_depth as twd
from fsnet_tpu_torch.ops import warp_fast as twf
from fsnet_tpu_torch.ops.ssim import ssim_target_stats as t_stats

torch.set_num_threads(1)


@pytest.fixture()
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.fixture()
def interpret(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pk.pl, "pallas_call", patched)


@pytest.fixture()
def float64(monkeypatch):
    """The wrappers' type check widened to float64 (their plain versions
    are written for any float type)."""
    monkeypatch.setattr(tpl, "_DTYPES", (torch.float64,))


def _data(seed, N, B, H, W, C, dtype=np.float64):
    rng = np.random.RandomState(seed)
    return (rng.rand(N, H, W, C).astype(dtype),
            rng.rand(B, H, W, C).astype(dtype))


def _tile(t, R):
    return np.concatenate([t] * R, axis=0)


@pytest.mark.parametrize("H,W,C", [(2, 2, 1), (2, 5, 3), (3, 3, 3),
                                   (3, 5, 1), (5, 2, 3), (5, 5, 1)])
def test_plain_forward_matches_jax_xla_float64(x64, H, W, C):
    N, B = 8, 2
    pred, target = _data(0, N, B, H, W, C)
    mu, sig = j_stats(jnp.asarray(target))
    ref = np.asarray(j_reproj(jnp.asarray(pred),
                              jnp.asarray(_tile(target, N // B)),
                              target_stats=(jnp.asarray(_tile(mu, N // B)),
                                            jnp.asarray(_tile(sig, N // B))
                                            )))[..., 0]
    tt = torch.from_numpy(target)
    got = tpl.photo_loss_plain(torch.from_numpy(pred), tt, *t_stats(tt))
    assert got.dtype == torch.float64 and tuple(got.shape) == (N, H, W)
    assert np.abs(got.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("H,W", [(16, 256), (8, 128), (12, 640), (4, 128)])
def test_fused_loss_matches_interpreted_pallas(interpret, H, W):
    """Forward and cotangent of the fused loss against the JAX package's
    (``photo_loss_pallas`` and ``photo_loss_bwd_pallas``, interpreted), with
    the same random cotangent on both sides."""
    N, B, C = 4, 2, 3
    pred, target = _data(1, N, B, H, W, C, np.float32)
    cot = np.random.RandomState(2).randn(N, H, W).astype(np.float32)
    jt = jnp.asarray(target)
    ref, vjp = jax.vjp(lambda p: jpl.reprojection_loss_fused(
        p, jt, *j_stats(jt)), jnp.asarray(pred))
    ref_g = np.asarray(vjp(jnp.asarray(cot))[0])
    tt = torch.from_numpy(target)
    x = torch.from_numpy(pred).requires_grad_(True)
    got = tpl.reprojection_loss_fused(x, tt, *t_stats(tt))
    got.backward(torch.from_numpy(cot))
    assert np.abs(got.detach().numpy() - np.asarray(ref)).max() <= 1e-5
    assert np.abs(x.grad.numpy() - ref_g).max() <= 2e-5 * np.abs(ref_g).max()


def _tied(H, W, C=3, N=4, B=2, seed=3):
    """float64 predictions and targets with exact ties: a flat black patch
    in both (zero variance: the clamp at its tie), prediction 0 equal to
    target 0 (y == x, and SSIM exactly 0: the clip at 0), elsewhere noise;
    rows 0-2 of prediction 3 and target 1 hold m + d and m - d with d
    = (a, -2a, a) over the rows, large enough that C1 and C2 round away, so
    SSIM is exactly -1 at row 1 (the clip at 1)."""
    pred, target = _data(seed, N, B, H, W, C)
    target[0, :2, :2] = 0.0
    pred[1, :2, :2] = 0.0
    pred[0] = target[0]
    if H >= 3:
        m, a = 2.0 ** 33, 2.0 ** 30
        d = np.array([a, -2 * a, a])[:, None, None]
        pred[3, :3] = m + d
        target[1, :3] = m - d
    return pred, target


@pytest.mark.parametrize("H,W", [(2, 2), (2, 5), (3, 3), (3, 4), (4, 5),
                                 (5, 2), (5, 5)])
def test_bwd_plain_matches_autograd_at_ties(H, W):
    pred, target = _tied(H, W)
    x, y = torch.from_numpy(pred), torch.from_numpy(target)
    muy, sy = t_stats(y)
    terms = tpl._terms(x, y, muy, sy)
    ties = dict(variance=int((terms["sx_raw"] == 0).sum()),
                clip0=int((terms["val"] == 0).sum()),
                clip1=int((terms["val"] == 1).sum()),
                equal=int((y - terms["x"] == 0).sum()))
    assert ties["variance"] and ties["clip0"] and ties["equal"], ties
    assert ties["clip1"] or H < 3, ties
    g = torch.from_numpy(np.random.RandomState(4).randn(*pred.shape[:3]))
    xr = x.clone().requires_grad_(True)
    tpl.photo_loss_plain(xr, y, muy, sy).backward(g)
    got = tpl.photo_loss_bwd_plain(x, y, muy, sy, g)
    assert got.shape == x.shape
    err = (got - xr.grad).abs().max() / xr.grad.abs().max()
    assert err <= 1e-12, err


def _head_scene(H, W, B, seed=5):
    """Depth and disparity maps at the flagship head's 4 scales (depth
    differentiable), the head's batch with small camera motion, float64."""
    rng = np.random.RandomState(seed)
    out, leaves = {}, []
    for s in range(4):
        h, w = H >> s, W >> s
        d = torch.from_numpy(5 + 10 * rng.rand(B, h, w, 1)).requires_grad_(
            True)
        out[("depth", s, s)] = d
        out[("disp", s)] = torch.from_numpy(rng.rand(B, h, w, 1))
        leaves.append(d)
    data = {("original_image", f): torch.from_numpy(rng.rand(B, H, W, 3))
            for f in (0, 1, -1)}
    P = np.zeros((B, 3, 4))
    P[:, 0, 0] = P[:, 1, 1] = 0.58 * W
    P[:, 0, 2], P[:, 1, 2], P[:, 2, 2] = W / 2, H / 2, 1.0
    data["P2"] = torch.from_numpy(P)
    for f, t in ((1, 0.3), (-1, -0.2)):
        T = torch.eye(4, dtype=torch.float64).repeat(B, 1, 1)
        T[:, 0, 3], T[:, 2, 3] = 0.05 * t, t
        data[("relative_pose", f)] = T
        out[("cam_T_cam", f)] = T
    out["pose_is_const"] = True
    return out, data, leaves


def _former_route(pred, target, muy, sy, ssim_weight=0.85):
    """The head's photometric loss before the fused op: the target and its
    stats tiled to N, then ``reprojection_loss``."""
    R = pred.shape[0] // target.shape[0]

    def tile(t):
        return t[None].expand(R, *t.shape).reshape(-1, *t.shape[1:])

    return tmd.reprojection_loss(pred, tile(target), ssim_weight,
                                 (tile(muy), tile(sy)))[..., 0]


def test_head_loss_matches_former_route(monkeypatch, float64):
    """The flagship head's loss (depth-direct warp, automask, smoothness)
    through ``reprojection_loss_fused`` against its former route, float64:
    the loss and the depth cotangents."""
    from fsnet_tpu_torch.entry import flagship_config
    from fsnet_tpu_torch.utils.builder import build

    monkeypatch.setattr(twd, "_DTYPES", (torch.float64,))
    monkeypatch.setattr(twf, "_DTYPES", (torch.float64,))
    H, W, B = 32, 64, 2
    head = build(frame_ids=(0, 1, -1),
                 **dict(flagship_config(H, W)["head_cfg"]))
    res = {}
    for tag in ("fused", "former"):
        if tag == "former":
            monkeypatch.setattr(tmd, "reprojection_loss_fused", _former_route)
        out, data, leaves = _head_scene(H, W, B)
        loss = head.loss(out, data)["loss"]
        res[tag] = (float(loss.detach()), torch.autograd.grad(loss, leaves))
    (l_new, g_new), (l_old, g_old) = res["fused"], res["former"]
    assert abs(l_new - l_old) <= 1e-12 * abs(l_old)
    for a, r in zip(g_new, g_old):
        assert (a - r).abs().max() <= 1e-12 * r.abs().max()


def test_autograd_takes_the_plain_versions_on_the_cpu(monkeypatch):
    """On CPU tensors the autograd function runs the plain forward and the
    closed-form plain cotangent, launches nothing, and gives the target and
    its stats no gradient."""
    calls = []
    for fn in ("photo_loss_plain", "photo_loss_bwd_plain"):
        monkeypatch.setattr(tpl, fn, lambda *a, _o=getattr(tpl, fn), _f=fn,
                            **k: (calls.append(_f), _o(*a, **k))[1])
    pred, target = _data(6, 4, 2, 6, 9, 3, np.float32)
    x = torch.from_numpy(pred).requires_grad_(True)
    y = torch.from_numpy(target).requires_grad_(True)
    n0 = tpl.photo_loss_fwd.launches, tpl.photo_loss_bwd.launches
    loss = tpl.reprojection_loss_fused(x, y, *t_stats(y.detach()))
    assert tuple(loss.shape) == (4, 6, 9) and loss.dtype == torch.float32
    loss.sum().backward()
    assert calls == ["photo_loss_plain", "photo_loss_bwd_plain"]
    assert (tpl.photo_loss_fwd.launches, tpl.photo_loss_bwd.launches) == n0
    assert x.grad is not None and y.grad is None


@pytest.mark.parametrize("what", ["float64", "channels", "batch",
                                  "noncontiguous", "height", "stats"])
def test_wrappers_reject_what_the_kernels_do_not_take(what):
    pred = torch.rand(4, 6, 8, 3)
    target = torch.rand(2, 6, 8, 3)
    args = dict(pred=pred, target=target)
    if what == "float64":
        args = dict(pred=pred.double(), target=target.double())
    elif what == "channels":
        args["target"] = torch.rand(2, 6, 8, 2)
    elif what == "batch":
        args["target"] = torch.rand(3, 6, 8, 3)
    elif what == "noncontiguous":
        args["pred"] = torch.rand(4, 8, 6, 3).transpose(1, 2)
    elif what == "height":
        args = dict(pred=torch.rand(4, 1, 8, 3), target=torch.rand(2, 1, 8, 3))
    muy = sy = args["target"]
    if what == "stats":
        muy = torch.rand(2, 6, 8, 1)
    err = TypeError if what in ("float64", "noncontiguous") else ValueError
    with pytest.raises(err):
        tpl.photo_loss_fwd(args["pred"], args["target"], muy, sy)
    with pytest.raises(err):
        tpl.photo_loss_bwd(args["pred"], args["target"], muy, sy,
                           torch.rand(args["pred"].shape[:3]))


@pytest.mark.parametrize("entry,pointers,floats", [
    ("fsnet_photo_loss_fwd", [0, 1, 2, 3, 4, 14], [10, 11, 12]),
    ("fsnet_photo_loss_bwd", [0, 1, 2, 3, 4, 5, 14], [11, 12]),
    ("fsnet_photo_loss_fwd_vec", [0, 1, 2, 3, 4, 14], [10, 11, 12]),
    ("fsnet_photo_loss_bwd_vec", [0, 1, 2, 3, 4, 5, 14], [11, 12]),
])
def test_entry_points_declare_their_arguments(monkeypatch, entry, pointers,
                                              floats):
    """ctypes passes an undeclared argument as a 32-bit int: the wrappers
    declare every pointer, int and float of each entry point of both routes
    and call it with all 15 arguments, the dtype's code (float32: 0) the
    last before the stream (a stand-in C function, CPU tensors
    routed as if on the card); aligned operands with C = 3 take the vector
    route (``_vec``) at W = 8 and the narrow one at W = 6, and the launch
    is counted under its route."""
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
                        if name == "photo_loss" else None)
    monkeypatch.setattr(tpl, "_route", lambda t, name: True)
    monkeypatch.setattr(tpl, "_stream", lambda t: 0)
    monkeypatch.setattr(tpl.torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    for f in (tpl.photo_loss_fwd, tpl.photo_loss_bwd):
        monkeypatch.setattr(f, "routes", dict.fromkeys(tpl.ROUTES, 0))
    route = "vector" if entry.endswith("_vec") else "narrow"
    fwd = entry.startswith("fsnet_photo_loss_fwd")
    W = 8 if route == "vector" else 6
    pred, target = torch.rand(4, 6, W, 3), torch.rand(2, 6, W, 3)
    assert tpl.photo_route(pred, target) == route
    n0 = tpl.photo_loss_fwd.launches, tpl.photo_loss_bwd.launches
    try:
        if fwd:
            tpl.photo_loss_fwd(pred, target, target, target, 0.85)
        else:
            tpl.photo_loss_bwd(pred, target, target, target,
                               torch.rand(4, 6, W), 0.85)
        assert (tpl.photo_loss_fwd.launches - n0[0],
                tpl.photo_loss_bwd.launches - n0[1]) == \
            ((1, 0) if fwd else (0, 1))
    finally:
        tpl.photo_loss_fwd.launches, tpl.photo_loss_bwd.launches = n0
    used = tpl.photo_loss_fwd if fwd else tpl.photo_loss_bwd
    assert used.routes == dict(narrow=int(route == "narrow"),
                               vector=int(route == "vector"))
    assert len(calls) == 1 and len(calls[0]) == 15 and calls[0][13] == 0
    assert fn.restype is ctypes.c_int and len(fn.argtypes) == 15
    assert [i for i, t in enumerate(fn.argtypes)
            if t is ctypes.c_void_p] == pointers
    assert [i for i, t in enumerate(fn.argtypes)
            if t is ctypes.c_float] == floats
    n = 5 if fwd else 6
    assert calls[0][n:n + 5] == (4, 2, 6, W, 3)
    weights = [calls[0][i] for i in floats]
    assert weights == pytest.approx(
        [0.85, 0.15, 1 / 3] if fwd else [-0.85 / 6, 0.05])
