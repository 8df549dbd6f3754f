"""The port's flagship train step (on the CPU: the plain versions of its
kernels) against the JAX package's, from the same bridged weights and the
same batch, with no tie-break noise on either side. Two JAX routes:

* ``xla``: the JAX package's CPU route at 64x96 (grid warp, XLA convs), both
  sides in float64 (the port's wrappers take float32; their plain versions
  are written for any float type, and this test widens the wrappers' type
  check to float64 on the CPU);
* ``tpu``: its shipped TPU route at 64x128 in float32, forced on the CPU as
  ``tests/test_multichip_kernel_route.py`` does (``jax.default_backend``
  reads "tpu", every ``pallas_call`` is interpreted), so the depth-direct
  warp (``warp_prep_pallas`` + the fused band warp + ``warp_prep_bwd_pallas``)
  and the train-mode conv kernels (``conv3x3_fused_mats_m``,
  ``conv3x3_fused_dw``) run; the test proves that they did.

The JAX side runs ``model.apply(..., mutable=["batch_stats"])`` under
``jax.value_and_grad`` at matmul precision "highest", then the optax chain
of ``bench.py`` (clip 1.0, Adam, lr 1e-4, StepLR). The batch is the
synthetic batch's poses and intrinsics with white-noise images: on its
smooth textures many 3x3 windows have a variance at the level of float32
rounding, where SSIM's ``>= 0`` variance clamp turns their gradient on or
off at random, and the JAX package's own two pool forms (banded matrix and
stencil) then differ by 8.6e-3 in rel-L2 of d loss / d depth.

Bounds, with the values measured when this test was written:

* float64 (``xla``): loss rel <= 1e-5 (1.1e-8); gradients per leaf rel-L2
  <= 1e-4 (6e-14); parameters after the Adam step within 1e-6 (7e-10); BN
  running statistics within 1e-6 (3e-15).
* float32 (``tpu``): rounding flips discrete choices (a bilinear corner
  where a coordinate lies within an ulp of an integer, the reprojection
  min at near ties), each of which moves the gradient of one pixel by O(1).
  The JAX package's own XLA and TPU routes differ by 1.2e-3 in global
  gradient rel-L2 on this batch (worst leaf 2.8e-3, dispconv_1). So: loss
  rel <= 1e-5 (1.6e-7); global gradient rel-L2 <= 1e-2 (2.3e-3), per leaf
  <= 2e-2 (5.4e-3); Adam's first step is about lr * sign(g), so every
  parameter is within 2 lr (1 + 1e-6) of JAX's and at least 97% of them
  within 1e-6 (98.7%); BN running statistics within 1e-5 * max(1, |ref|)
  (2.7e-6: the batch variance E[x^2] - mean^2 cancels, in float32).

The conv biases of the decoder's ``ConvBnReLU`` blocks feed train-mode BN,
which removes any constant per channel: their exact gradient is 0, and both
sides hold rounding noise there (measured 4e-9 of the gradient norm in
float32). Adam turns that noise into steps of up to lr in either direction,
so those leaves are held to |gradient| <= 1e-6 * ||g|| on both sides and
their update to |step| <= lr (1 + 1e-6), instead of the bounds above.
"""
import numpy as np
import pytest
import torch

import jax
import jax.experimental.pallas as pl
import optax

import __graft_entry__ as ge
from fsnet_tpu_torch.entry import flagship_model, flagship_optimizer, \
    synthetic_batch
from fsnet_tpu_torch.models.flax_convert import load_flax_variables, to_flax
from fsnet_tpu_torch.ops import conv3x3 as tc
from fsnet_tpu_torch.ops import warp_depth as twd
from fsnet_tpu_torch.runtime.state import make_train_step

torch.set_num_threads(1)

ROUTES = {"xla": (64, 96, np.float64), "tpu": (64, 128, np.float32)}
B = 2
LR = 1e-4


def _randomise(variables, rng):
    def leaf(path, a):
        a = np.asarray(a)
        name = str(path[-1].key)
        if name in ("var", "scale"):
            return (0.5 + rng.rand(*a.shape)).astype(np.float32)
        if name in ("mean", "bias"):
            return (0.1 * rng.randn(*a.shape)).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(leaf, variables)


def _to_dicts(tree):
    return {k: _to_dicts(v) if hasattr(v, "items") else np.asarray(v)
            for k, v in tree.items()}


def _flat(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, path + (k,))
        else:
            yield path + (k,), v


def _batch(H, W, dtype):
    """The synthetic batch's poses and intrinsics with white-noise images
    (see the module docstring), in ``dtype``."""
    batch = synthetic_batch(B, H, W)
    rng = np.random.RandomState(7)
    for key in sorted(batch):
        if key.startswith(("image/", "original_image/")):
            batch[key] = rng.rand(*batch[key].shape)
    return {k: v.astype(dtype) for k, v in batch.items()}


def _jax_step(H, W, batch, dtype):
    from fsnet_tpu.runtime.optim import build_optimizer

    model = ge._flagship_model(H, W)
    rng = np.random.RandomState(0)
    with jax.default_matmul_precision("highest"):
        v = jax.jit(lambda x: model.init(
            {"params": jax.random.PRNGKey(0)}, x,
            method=model.dummy_forward))(batch["image/0"])
        v = jax.tree.map(lambda a: np.asarray(a, dtype),
                         _to_dicts(_randomise(v, rng)))

        def loss_fn(params):
            out, mutated = model.apply(
                {"params": params, "batch_stats": v["batch_stats"]}, batch,
                {"is_training": True}, mutable=["batch_stats"])
            return out["loss"], mutated

        (loss, mutated), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(v["params"])
        tx, _ = build_optimizer(dict(name="adam", lr=LR),
                                dict(name="StepLR", step_size=8),
                                steps_per_epoch=1000, clip_gradients=1.0)
        updates, _ = tx.update(grads, tx.init(v["params"]), v["params"])
        new_params = optax.apply_updates(v["params"], updates)
    return dict(variables=v, loss=float(loss), grads=_to_dicts(grads),
                params=_to_dicts(new_params),
                stats=_to_dicts(mutated["batch_stats"]))


def _run(name):
    """Both steps on route ``name``: the JAX reference, the port's results
    in flax layout, and the counts of the TPU kernels the JAX side ran."""
    H, W, dtype = ROUTES[name]
    batch = _batch(H, W, dtype)
    calls = {}
    with pytest.MonkeyPatch.context() as mp:
        if name == "tpu":
            import fsnet_tpu.ops.pallas.conv_kernel as ck
            import fsnet_tpu.ops.pallas.prep_kernel as prk
            import fsnet_tpu.ops.pallas.warp_kernel as wk
            import fsnet_tpu.ops.warp_depth as jwd

            for mod in (ck, prk, wk):
                def patched(*args, _orig=pl.pallas_call, **kwargs):
                    kwargs["interpret"] = True
                    return _orig(*args, **kwargs)
                mp.setattr(mod.pl, "pallas_call", patched)
            for mods, fn in (((prk, jwd), "warp_prep_pallas"),
                             ((ck,), "conv3x3_fused_mats_m"),
                             ((ck,), "conv3x3_fused_dw")):
                calls[fn] = 0

                def counted(*args, _orig=getattr(mods[0], fn), _fn=fn,
                            **kwargs):
                    calls[_fn] += 1
                    return _orig(*args, **kwargs)
                for mod in mods:
                    mp.setattr(mod, fn, counted)
            mp.setattr(jax, "default_backend", lambda: "tpu")
        x64 = dtype == np.float64
        jax.config.update("jax_enable_x64", x64)
        try:
            ref = _jax_step(H, W, batch, dtype)
        finally:
            jax.config.update("jax_enable_x64", False)
    port = flagship_model(H, W, device="cpu").to(
        torch.float64 if x64 else torch.float32)
    load_flax_variables(port, ref["variables"])
    opt, _ = flagship_optimizer(port)
    with pytest.MonkeyPatch.context() as mp:
        if x64:
            mp.setitem(tc._DTYPES, torch.float64, -1)
            mp.setattr(twd, "_DTYPES", (torch.float64,))
        metrics = make_train_step("cpu", with_grads=True)(port, opt, batch)
    got = dict(loss=float(metrics["loss"]),
               grads=to_flax(port, metrics["_grads"])["params"],
               params=to_flax(port, dict(port.named_parameters()))["params"],
               stats=to_flax(port, {k: t for k, t in port.state_dict().items()
                                    if k.endswith(("running_mean",
                                                   "running_var"))}
                             )["batch_stats"])
    return dict(name=name, ref=ref, got=got, calls=calls)


@pytest.fixture(params=sorted(ROUTES))
def route(request):
    return _run(request.param)


def _bn_cancelled(path):
    """Conv biases of the decoder's ConvBnReLU blocks (upconv_*/conv)."""
    return (path[-1] == "bias" and len(path) >= 3 and path[-2] == "conv"
            and path[-3].startswith("upconv_"))


def _rel_l2(a, r):
    return float(np.linalg.norm(a - r) / np.linalg.norm(r))


def test_train_step_matches_jax(route):
    ref, got = route["ref"], route["got"]
    f64 = route["name"] == "xla"
    assert abs(got["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"])

    ref_g, got_g = dict(_flat(ref["grads"])), dict(_flat(got["grads"]))
    assert sorted(got_g) == sorted(ref_g)
    kept = [p for p in ref_g if not _bn_cancelled(p)]
    g_norm = np.sqrt(sum(float(np.sum(np.square(ref_g[p]))) for p in kept))
    for path, r in ref_g.items():
        assert got_g[path].shape == r.shape, path
        if _bn_cancelled(path):
            assert np.abs(r).max() <= 1e-6 * g_norm, path
            assert np.abs(got_g[path]).max() <= 1e-6 * g_norm, path
    errs = {p: _rel_l2(got_g[p], ref_g[p]) for p in kept}
    bad = {p: e for p, e in errs.items() if e > (1e-4 if f64 else 2e-2)}
    assert not bad, bad
    if not f64:
        diff = np.sqrt(sum(float(np.sum(np.square(got_g[p] - ref_g[p])))
                           for p in kept))
        assert diff <= 1e-2 * g_norm, diff / g_norm

    start = dict(_flat(ref["variables"]["params"]))
    ref_p, got_p = dict(_flat(ref["params"])), dict(_flat(got["params"]))
    assert sorted(got_p) == sorted(ref_p)
    n_close = n_all = 0
    for path, r in ref_p.items():
        a = got_p[path]
        assert a.shape == r.shape, path
        if _bn_cancelled(path):
            assert np.abs(a - start[path]).max() <= LR * (1 + 1e-6), path
            continue
        d = np.abs(a - r)
        assert d.max() <= (1e-6 if f64 else 2 * LR * (1 + 1e-6)), path
        n_close += int((d <= 1e-6).sum())
        n_all += d.size
    assert n_close >= 0.97 * n_all, n_close / n_all

    ref_s, got_s = dict(_flat(ref["stats"])), dict(_flat(got["stats"]))
    assert sorted(got_s) == sorted(ref_s)
    tol = 1e-6 if f64 else 1e-5
    for path, r in ref_s.items():
        assert np.all(np.abs(got_s[path] - r)
                      <= tol * np.maximum(1.0, np.abs(r))), path

    # the forced TPU route really ran the Pallas kernels
    if route["name"] == "tpu":
        assert sorted(route["calls"]) == ["conv3x3_fused_dw",
                                          "conv3x3_fused_mats_m",
                                          "warp_prep_pallas"]
        assert all(n > 0 for n in route["calls"].values()), route["calls"]
    else:
        assert route["calls"] == {}
