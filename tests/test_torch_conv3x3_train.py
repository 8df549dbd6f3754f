"""The port's differentiable conv3x3 (on the CPU: its plain versions)
against the JAX package's Pallas conv in interpret mode, through
``jax.vjp``: ``fast_conv._conv3x3_pallas_bn_cvjp`` (conv + BN moments,
kernels ``conv3x3_fused_mats_m`` and ``conv3x3_fused_dw``) and
``fast_conv._conv3x3_pallas_cvjp`` (conv alone). One and two input parts,
zeros and replicate padding, one ragged shape (H=6) and the decoder's
Cin=96 two-part conv; float32, matmul precision "highest".

The JAX moments are per packed lane (``[P*Co]``); the port's are per
channel, their sum over the P phases, so a port cotangent ``gs`` is the JAX
cotangent ``tile(gs, P)``. Tolerance atol 1e-4, rtol 1e-5: the two sides
sum the same float32 products in other orders.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import jax.experimental.pallas as pl

import fsnet_tpu.ops.pallas.conv_kernel as ck
from fsnet_tpu.ops import fast_conv as fc
from fsnet_tpu_torch.ops import conv3x3 as tc

torch.set_num_threads(1)

ATOL, RTOL = 1e-4, 1e-5

CASES = {
    # name: (B, H, W, Cs, Co, pad_mode)
    "one_part_zeros": (2, 8, 128, (16,), 16, "zeros"),
    "one_part_replicate": (2, 8, 128, (16,), 16, "replicate"),
    "two_parts_cin96_replicate": (2, 8, 64, (32, 64), 32, "replicate"),
    "two_parts_zeros": (1, 8, 64, (32, 32), 32, "zeros"),
    "ragged_h6_replicate": (2, 6, 64, (32,), 32, "replicate"),
}


@pytest.fixture(autouse=True)
def _interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(ck.pl, "pallas_call", patched)


def _inputs(seed, B, H, W, Cs, Co):
    rng = np.random.RandomState(seed)
    xs = [rng.randn(B, H, W, c).astype(np.float32) for c in Cs]
    w = (rng.randn(3, 3, sum(Cs), Co) * 0.1).astype(np.float32)
    b = (rng.randn(Co) * 0.1).astype(np.float32)
    g = rng.randn(B, H, W, Co).astype(np.float32)
    gs = (rng.randn(2, Co) * 1e-3).astype(np.float32)
    return xs, w, b, g, gs


def _jax(xs, w, b, g, gs, Cs, pad_mode, moments):
    Co = w.shape[3]
    P = 128 // Co
    parts = tuple(fc.pack_width(jnp.asarray(x), 128 // c if x.shape[2] %
                                (128 // c) == 0 else 1)
                  for x, c in zip(xs, Cs))
    fn = (fc._conv3x3_pallas_bn_cvjp if moments else fc._conv3x3_pallas_cvjp)
    with jax.default_matmul_precision("highest"):
        res, vjp = jax.vjp(lambda p, ww, bb: fn(p, ww, bb, Cs, pad_mode),
                           parts, jnp.asarray(w), jnp.asarray(b))
        out = res[0] if moments else res
        gp = fc.pack_width(jnp.asarray(g), P)
        cot = ((gp, jnp.tile(jnp.asarray(gs[0]), P),
                jnp.tile(jnp.asarray(gs[1]), P)) if moments else gp)
        dparts, dw, db = vjp(cot)
    ref = dict(out=np.asarray(fc.unpack_width(out, Co)),
               dx=[np.asarray(fc.unpack_width(d, c))
                   for d, c in zip(dparts, Cs)],
               dw=np.asarray(dw), db=np.asarray(db))
    if moments:
        ref["s1"] = np.asarray(res[1]).reshape(P, Co).sum(0)
        ref["s2"] = np.asarray(res[2]).reshape(P, Co).sum(0)
    return ref


def _port(xs, w, b, g, gs, pad_mode, moments):
    parts = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    wt = torch.from_numpy(w).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    fn = tc.conv3x3_bn if moments else tc.conv3x3
    res = fn(parts, wt, bt, pad_mode)
    gt = torch.from_numpy(g)
    if moments:
        out, s1, s2 = res
        torch.autograd.backward(
            [out, s1, s2], [gt, torch.from_numpy(gs[0]),
                            torch.from_numpy(gs[1])])
    else:
        out = res
        out.backward(gt)
    got = dict(out=out.detach().numpy(), dx=[p.grad.numpy() for p in parts],
               dw=wt.grad.numpy(), db=bt.grad.numpy())
    if moments:
        got["s1"], got["s2"] = s1.detach().numpy(), s2.detach().numpy()
    for f in (tc.conv3x3, tc.conv3x3_bn, tc.conv3x3_dx, tc.conv3x3_dw):
        assert f.launches == 0          # the CPU never launches a kernel
    return got


@pytest.mark.parametrize("moments", [True, False], ids=["bn", "plain"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_conv3x3_vjp_matches_pallas(case, moments):
    B, H, W, Cs, Co, pad_mode = CASES[case]
    xs, w, b, g, gs = _inputs(sorted(CASES).index(case), B, H, W, Cs, Co)
    ref = _jax(xs, w, b, g, gs, Cs, pad_mode, moments)
    got = _port(xs, w, b, g, gs, pad_mode, moments)
    assert sorted(got) == sorted(ref)
    for key in ref:
        if key == "dx":
            for a, r in zip(got[key], ref[key]):
                np.testing.assert_allclose(a, r, atol=ATOL, rtol=RTOL)
        else:
            # moments and dw sum over B*H*W products: scale the atol by the
            # reference's magnitude as well
            np.testing.assert_allclose(got[key], ref[key], rtol=RTOL,
                                       atol=ATOL * max(1.0, np.abs(
                                           ref[key]).max() / 100.0),
                                       err_msg=key)


@pytest.mark.parametrize("pad_mode", ["zeros", "replicate"])
def test_conv3x3_gradcheck_float64(pad_mode):
    """The autograd Function's explicit backward (dx through the flipped
    weight and the halo fold, dw, dbias, the moment-cotangent fold) against
    finite differences, float64, on the plain route."""
    rng = np.random.RandomState(7)
    parts = [torch.from_numpy(rng.randn(1, 3, 4, c)).requires_grad_(True)
             for c in (2, 3)]
    w = torch.from_numpy(rng.randn(3, 3, 5, 2)).requires_grad_(True)
    b = torch.from_numpy(rng.randn(2)).requires_grad_(True)
    for moments in (False, True):
        assert torch.autograd.gradcheck(
            lambda ww, bb, p0, p1: tc.Conv3x3Function.apply(
                pad_mode, moments, ww, bb, p0, p1),
            (w, b, *parts), eps=1e-6, atol=1e-7)


def test_fold_halo_replicate_corners():
    """Replicate padding: each halo entry of the padded cotangent lands on
    the edge pixel it was copied from, corners included."""
    e = torch.arange(1, 5 * 6 + 1, dtype=torch.float64).reshape(1, 5, 6, 1)
    d = tc._fold_halo(e, "replicate")[0, ..., 0]
    E = e[0, ..., 0]
    assert d.shape == (3, 4)
    assert d[0, 0] == E[0:2, 0:2].sum()
    assert d[2, 3] == E[3:5, 4:6].sum()
    assert d[0, 2] == E[0:2, 3].sum()
    assert d[1, 1] == E[2, 2]
    assert d.sum() == E.sum()


@pytest.mark.parametrize("entry,lib,nargs,pointers", [
    ("fsnet_conv3x3_bn_nhwc", "conv3x3", 15, [0, 2, 4, 5, 6, 7, 14]),
    ("fsnet_conv3x3_dw_nhwc", "conv3x3_dw", 13, [0, 2, 4, 5, 12]),
    ("fsnet_conv3x3_dx_nhwc", "conv3x3", 13, [0, 2, 3, 5, 12]),
    ("fsnet_photo_loss_fwd_vec", "photo_loss", 15, [0, 1, 2, 3, 4, 14]),
    ("fsnet_warp_depth_bwd", "warp_depth", 14, [0, 1, 2, 3, 4, 5, 13]),
])
def test_train_entry_points_declare_their_arguments(monkeypatch, entry, lib,
                                                    nargs, pointers):
    import ctypes
    import types

    from fsnet_tpu_torch.ops import _build

    fn = types.SimpleNamespace(argtypes=None, restype=ctypes.c_int)
    monkeypatch.setattr(_build, "load",
                        lambda name: types.SimpleNamespace(**{entry: fn}))
    assert tc._entry(lib, entry, pointers[:-1], nargs) is fn
    assert len(fn.argtypes) == nargs and fn.restype is ctypes.c_int
    assert [i for i, t in enumerate(fn.argtypes)
            if t is ctypes.c_void_p] == pointers
