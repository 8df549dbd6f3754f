"""Every shipped recipe's train step at its shipped dtype, bfloat16, on the
CPU (the plain versions of the kernels) against the JAX package, from the
same numpy inputs: the bfloat16 forms of the Mei warp kernels G and H, and
the bf16 steps of the KITTI-360 fisheye recipe and of the two nuScenes
recipes (``nusc_wpose``, ``distill_nusc``). Tolerances, with the values
measured when this file was written:

* Kernel G's bfloat16 form (a bfloat16 image, the norm bfloat16 or
  float32; rays, mask and rows float32) against JAX's
  ``warp_mei._fwd_impl`` on its float32 route (interpreted Pallas) on the
  bf16-valued image, rounded: out, va and vb exactly the port's float32
  plain output rounded, and within one bf16 ulp elementwise of JAX's
  beyond the two float32 routes' own difference (XLA contracts the
  interpreted prep kernel's chain into FMAs; ``tests/test_torch_fisheye.py``
  bounds that); the overlap equal; against JAX's packed bfloat16 route
  (bf16 row pairs, which the port does not carry) within 1e-2, a reading.
* Kernel H's bfloat16 form against JAX's ``warp_mei._bwd`` on the same
  bfloat16 residuals: d norm within one bf16 ulp of the larger beyond 1e-5
  of its largest entry, in the norm's dtype.
* The whole step at 64x128, bs2, from the same bridged weights, against
  ``fsnet_tpu.runtime.state.make_train_step(compute_dtype=jnp.bfloat16,
  with_grads=True)`` on its XLA route (the fisheye head takes its grid
  route there; the port takes its norm-direct route, kernels G and H), on
  white-noise images: loss rel < 2e-2 (the JAX package's own bf16 gate,
  as ``tests/test_torch_bf16.py`` holds the flagship; measured fisheye
  1.50e-2, ``nusc_wpose`` 1.48e-2,
  ``distill_nusc`` 5.8e-3); every gradient leaf bf16-valued; the batch
  leaves rounded exactly as JAX's ``_cast`` rounds them; the distillation
  terms present on both sides; the gradients over every leaf but the
  biases of convs ahead of a train-mode BN: cosine > 0.5 and worst-leaf
  relative L2 <= 1.5 (measured 0.854, 0.667, 0.930 and 0.96, 1.10, 1.14);
  the BN statistics float32 and, elementwise, within one bf16 ulp of
  JAX's plus 6 bf16 ulps of the leaf's largest statistic (measured 1.59,
  4.46, 1.55). These recipes sit further apart than the flagship (whose
  gates are cosine > 0.8, worst leaf 0.9, 2 ulps), and so does JAX's own
  bf16 step from its float32 step, an equally correct pair (cosine 0.780,
  0.742, 0.942; worst leaf 1.13, 0.90, 1.14; statistics 1.36, 3.54, 1.21
  ulps): the port's float32 step, printed as the control, lies as far
  from JAX's bf16 step as the port's bf16 step does. The gradient gates
  still catch a broken warp cotangent on the fisheye and ``nusc_wpose``
  steps (kernel H's or the grid warp's zeroed: cosine 0.014 and 0.006),
  not on the distillation step, whose gradient its distillation terms
  carry (0.930 either way): there the smooth-texture test below holds
  the photometric part. ``PYTHONPATH=. python
  tests/test_torch_bf16_recipes.py`` prints those readings. The distillation teacher takes no
  gradient on either side; the port's teacher (parameters and
  statistics) is bitwise unchanged after the step; JAX's step casts back
  to float32 only the statistics that are float32, so its teacher's,
  never updated, stay their bfloat16 cast (held exactly).
* As for the flagship, none of those gates tells the bf16 step from the
  float32 one. What does is the loss on smooth textures (the synthetic
  batch's, which the nuScenes batch carries and which replace the fisheye
  batch's white noise here) against JAX's bf16 step with the function the
  port's kernels compute (its photometric kernel forced on and
  interpreted, its stencil target stats): loss rel < 7e-2, the flagship's
  gate, which the port's float32 step, the control, must miss; for the
  distillation step the loss less its distillation terms (0.3 of them),
  which would drown the photometric loss. Measured: fisheye 3.55e-2
  (control 9.60e-2), ``nusc_wpose`` 3.79e-2 (9.28e-2), ``distill_nusc``
  3.80e-2 (9.33e-2).
* The port's bf16 fisheye step on its norm-direct route against its own
  bf16 grid route (kernels F and E's bfloat16 wrappers), from the same
  weights: loss rel < 2e-2 and gradient cosine > 0.8 (measured 3.1e-7
  and 0.9999).
"""
import numpy as np
import pytest
import torch

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp

import fsnet_tpu.ops.warp_mei as jwm
from fsnet_tpu_torch.entry import (FISHEYE_RECIPE, NUSC_RECIPE,
                                   distill_config, distill_model,
                                   fisheye_batch, fisheye_model, nusc_batch,
                                   nusc_model, recipe_optimizer,
                                   synthetic_batch)
from fsnet_tpu_torch.models.flax_convert import load_flax_variables, to_flax
from fsnet_tpu_torch.ops import warp_fast as twf
from fsnet_tpu_torch.ops import warp_mei as twm
from fsnet_tpu_torch.runtime import state as tstate

from test_torch_bf16 import (_bf, _grad_distance, _stats_floor_ulps, _t,
                             _untile, _within_ulp)
from test_torch_fisheye import _scene
from test_torch_train_step import (_flat, _jax_names, _randomise, _to_dicts,
                                   jax_init, jax_model)

torch.set_num_threads(1)
BF = torch.bfloat16
B, H, W = 2, 64, 128
RECIPES = dict(fisheye=FISHEYE_RECIPE, nusc=NUSC_RECIPE, distill=NUSC_RECIPE)
BUILD = dict(fisheye=fisheye_model, nusc=nusc_model, distill=distill_model)
CONFIGS = dict(fisheye="kitti360_fisheye_example.py",
               nusc="nusc_wpose_example.py",
               distill="distill_nusc_example.py")


@pytest.fixture(autouse=True)
def _interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)


# ------------------------------------------------------- kernels G and H

S, F, C = 2, 2, 3          # the scene of tests/test_torch_fisheye.py


def _mei_scene(seed, Hs=16, Ws=128):
    """Kernel G's and H's operands: a bf16-valued image, float32 rays, mask
    and rows, the norm float32 (bf16-valued, so both dtypes carry one
    value)."""
    image, norm, rays4, P, params, Ts = _scene(seed, Hs, Ws)
    rows = np.asarray(jwm.make_mei_rows(jnp.asarray(P), jnp.asarray(params),
                                        jnp.asarray(Ts), S))
    rays = np.ascontiguousarray(np.moveaxis(rays4[..., :3], -1, 1))
    return _bf(image), np.ascontiguousarray(rays4[..., 3]), _bf(norm), \
        rays, rows


@pytest.mark.parametrize("norm_dtype", ["float32", "bfloat16"])
def test_warp_mei_bf16_matches_jax(norm_dtype):
    band = 16
    image, mask, norm, rays, rows = _mei_scene(0)
    Ws = image.shape[2]
    jargs = (jnp.asarray(mask), jnp.asarray(norm), jnp.asarray(rays),
             jnp.asarray(rows), S, F, band, True)
    out32, ov32, va32, vb32 = jwm._fwd_impl(jnp.asarray(image), *jargs)
    packed = jwm._fwd_impl(jnp.asarray(image, jnp.bfloat16), *jargs)[0]

    ndt = getattr(torch, norm_dtype)
    img, msk, nrm = _t(image), _t(mask, torch.float32), _t(norm, ndt)
    ray, row = _t(rays, torch.float32), _t(rows, torch.float32)
    out, ov, va, vb = twm.warp_mei_fwd(img, msk, nrm, ray, row, S, F, band,
                                       True)
    wide = twm.warp_mei_fwd(img.float(), msk, nrm.float(), ray, row, S, F,
                            band, True)
    assert out.dtype == va.dtype == vb.dtype == BF
    assert np.array_equal(ov.numpy(), np.asarray(ov32))
    assert torch.equal(ov, wide[1])
    for name, got, w32, ref in (("out", out, wide[0], out32),
                                ("va", va, wide[2], va32),
                                ("vb", vb, wide[3], vb32)):
        ref = _untile(ref, Ws)
        assert torch.equal(got, w32.to(BF)), name
        _within_ulp(got.float().numpy(), _bf(ref), f"kernel G (plain) {name}",
                    floor=np.abs(w32.numpy() - ref))
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(packed, np.float32), atol=1e-2)
    assert twm.warp_mei_fwd.launches == 0


@pytest.mark.parametrize("norm_dtype", ["float32", "bfloat16"])
def test_warp_mei_bwd_bf16_matches_jax(norm_dtype):
    band = 16
    image, mask, norm, rays, rows = _mei_scene(1)
    ndt = getattr(torch, norm_dtype)
    img, msk, nrm = _t(image), _t(mask, torch.float32), _t(norm, ndt)
    ray, row = _t(rays, torch.float32), _t(rows, torch.float32)
    _, _, va, vb = twm.warp_mei_fwd(img, msk, nrm, ray, row, S, F, band,
                                    False)
    g = _bf(np.random.RandomState(2).randn(*va.shape))
    jnorm = jnp.asarray(norm, getattr(jnp, norm_dtype))
    res = (jnp.asarray(image, jnp.bfloat16), jnp.asarray(mask), jnorm,
           jnp.asarray(rays), jnp.asarray(rows),
           jnp.asarray(va.float().numpy(), jnp.bfloat16),
           jnp.asarray(vb.float().numpy(), jnp.bfloat16))
    dn_ref = jwm._bwd(S, F, band, False, res,
                      (jnp.asarray(g, jnp.bfloat16), None))[2]
    dn = twm.warp_mei_bwd(nrm, ray, _t(g), va, vb, row, S, F)
    assert dn.dtype == ndt and dn_ref.dtype == jnorm.dtype
    dn, dn_ref = dn.float().numpy(), np.asarray(dn_ref, np.float32)
    _within_ulp(dn, dn_ref, f"kernel H (plain) d norm, {norm_dtype} norm",
                floor=1e-5 * np.abs(dn_ref).max())
    assert twm.warp_mei_bwd.launches == 0


@pytest.mark.parametrize("which", ["rays", "mask", "rows"])
def test_warp_mei_refuses_bf16_rays_mask_and_rows(which):
    """Kernel G takes a bfloat16 image, and norm, but rays, mask and rows
    are float32 at every dtype (bf16 pixel addressing would move the warp
    by pixels); the cotangent likewise. The refusal comes before any
    launch."""
    image, mask, norm, rays, rows = (torch.from_numpy(a) for a in
                                     _mei_scene(2, 8, 16))
    args = dict(rays=rays, mask=mask, rows=rows)
    args[which] = args[which].to(BF)
    img, nrm = image.to(BF), norm.to(BF)
    with pytest.raises(TypeError):
        twm.warp_mei_fwd(img, args["mask"], nrm, args["rays"], args["rows"],
                         S, F, 4, True)
    if which != "mask":
        g = torch.zeros(S * F * B, 8, 16, C, dtype=BF)
        with pytest.raises(TypeError):
            twm.warp_mei_bwd(nrm, args["rays"], g, g, g, args["rows"], S, F)
    # and a float32 image with a bfloat16 norm
    with pytest.raises(TypeError):
        twm.warp_mei_fwd(image, mask, nrm, rays, rows, S, F, 4, True)
    assert twm.warp_mei_fwd.launches == twm.warp_mei_bwd.launches == 0


# -------------------------------------------------------- the recipes

def _white(batch):
    rng = np.random.RandomState(7)
    out = dict(batch)
    for key in sorted(out):
        if key.startswith(("image/", "original_image/")):
            out[key] = rng.rand(*out[key].shape)
    return out


def _batch(kind, smooth=False):
    """The recipe's batch at 64x128 in float32: fisheye (white noise, or
    the synthetic batch's smooth textures), nuScenes (smooth textures, or
    white noise)."""
    if kind == "fisheye":
        batch = fisheye_batch(B, H, W)
        if smooth:
            tex = synthetic_batch(B, H, W)
            batch.update((k, v) for k, v in tex.items()
                         if k.startswith(("image/", "original_image/")))
    else:
        batch = nusc_batch(B, H, W)
        if not smooth:
            batch = _white(batch)
    return {k: v.astype(np.float32) if k != "patched_mask" else v
            for k, v in batch.items()}


def _jax_bf16_step(kind, batch):
    """JAX's bf16 step of recipe ``kind`` on its XLA route; also returns
    the batch its model saw (the step's ``_cast`` of it)."""
    from fsnet_tpu.runtime.optim import (build_frozen_mask, build_optimizer,
                                         frozen_param_prefixes)
    from fsnet_tpu.runtime.state import TrainState, make_train_step

    model = jax_model(kind, H, W)
    v = jax_init(kind, model, batch["image/0"])
    v = jax.tree.map(lambda a: np.asarray(a, np.float32),
                     _to_dicts(_randomise(v, np.random.RandomState(0))))
    recipe = RECIPES[kind]
    mask = (build_frozen_mask(v["params"], frozen_param_prefixes(
        _jax_names(distill_config(H, W)))) if kind == "distill" else None)
    tx, _ = build_optimizer(dict(recipe["optimizer"]), recipe["scheduler"],
                            steps_per_epoch=1000,
                            clip_gradients=recipe["clip_gradients"],
                            frozen_mask=mask)

    def apply_fn(variables, data, meta, **kwargs):
        out, mutated = model.apply(variables, data, meta, **kwargs)
        return dict(out, hm=dict(data)), mutated

    st = TrainState.create(apply_fn=apply_fn, params=v["params"],
                           batch_stats=v["batch_stats"], tx=tx)
    new, met, seen = make_train_step(
        donate=False, compute_dtype=jnp.bfloat16, with_grads=True)(
        st, batch, jax.random.PRNGKey(0))
    grads = _to_dicts(met["_grads"])
    teacher = grads.pop("teacher_net", None)
    assert (teacher is not None) == (kind == "distill")
    assert teacher is None or not any(np.any(a) for _, a in _flat(teacher))
    return dict(variables=v, loss=float(met["loss"]), grads=grads,
                stats=_to_dicts(new.batch_stats), terms=_distill_terms(met),
                seen={k: np.asarray(a) for k, a in seen.items()})


def _split_teacher(res):
    """``res`` with the teacher's BN statistics taken out of ``stats`` and
    returned beside it."""
    stats = dict(res["stats"])
    return dict(res, stats=stats), stats.pop("teacher_net", None)


def _port_step(kind, v, batch, compute_dtype, grid_route=False):
    port = BUILD[kind](H, W, device="cpu")
    load_flax_variables(port, v)
    opt, _ = recipe_optimizer(port, RECIPES[kind],
                              distill_config(H, W) if kind == "distill"
                              else None)
    teacher = {n: t.clone() for n, t in port.state_dict().items()
               if n.startswith("teacher_net.")}
    if grid_route:           # without the marker of dataset poses
        warp_all = port.head._warp_all
        port.head._warp_all = lambda i, o: (o.pop("pose_is_const"),
                                            warp_all(i, o))[1]
    met = tstate.make_train_step("cpu", compute_dtype=compute_dtype,
                                 with_grads=True)(port, opt, batch)
    state = port.state_dict()
    assert all(torch.equal(state[n], t) for n, t in teacher.items())
    stats = {k: t for k, t in state.items()
             if k.endswith(("running_mean", "running_var"))}
    return dict(loss=float(met["loss"]), raw=met["_grads"],
                grads=to_flax(port, met["_grads"])["params"],
                stats=to_flax(port, stats)["batch_stats"],
                terms=_distill_terms(met), teacher=len(teacher))


def _distill_terms(metrics):
    return {k: float(v) for k, v in metrics.items()
            if k.startswith("distilation/")}


def _rel(got, ref):
    return abs(got["loss"] - ref["loss"]) / abs(ref["loss"])


def _reprojection(res):
    """The loss less its distillation terms (weighted as the distillation
    head weighs them): the reprojection and smoothness losses."""
    w = distill_config(H, W)["head_cfg"]["distillation_loss_weight"]
    return res["loss"] - w * sum(res["terms"].values())


@pytest.mark.parametrize("kind", ["fisheye", "nusc", "distill"])
def test_recipe_bf16_step_matches_jax(kind, monkeypatch):
    batch = _batch(kind)
    ref = _jax_bf16_step(kind, batch)
    warps = []
    for mod, fn in ((twm, "warp_mei_plain"), (twm, "warp_mei_bwd_plain"),
                    (twf, "grid_band_plain")):
        monkeypatch.setattr(mod, fn, lambda *a, _o=getattr(mod, fn), _f=fn,
                            **k: (warps.append(_f), _o(*a, **k))[1])
    got = _port_step(kind, ref["variables"], batch,
                     RECIPES[kind]["compute_dtype"])
    f32 = _port_step(kind, ref["variables"], batch, None)
    assert sorted(set(warps)) == (
        ["warp_mei_bwd_plain", "warp_mei_plain"] if kind == "fisheye"
        else ["grid_band_plain"])
    assert (got["teacher"] > 0) == (kind == "distill")

    rel = _rel(got, ref)
    print(f"{kind}: loss port bf16 {got['loss']:.6f}, JAX bf16 "
          f"{ref['loss']:.6f} (rel {rel:.3e})")
    assert rel < 2e-2
    cos, worst, leaf = _grad_distance(got, ref)
    ccos, cworst, _ = _grad_distance(f32, ref)
    print(f"{kind}: gradients vs JAX bf16: cosine {cos:.4f}, worst leaf "
          f"rel-L2 {worst:.4f} at {'/'.join(leaf)}; the port's f32 step "
          f"(control) {ccos:.4f}, {cworst:.4f}")
    assert cos > 0.5 and worst <= 1.5
    assert sorted(got["terms"]) == sorted(ref["terms"])
    assert bool(got["terms"]) == (kind == "distill")
    for name, g in got["raw"].items():
        assert g.dtype == torch.float32, name
        assert torch.equal(g, g.to(BF).float()), name

    data = tstate._to_device(batch, torch.device("cpu"))
    cast = tstate._cast(data, BF)
    for key, seen in ref["seen"].items():
        mine = cast[key]
        assert (seen.dtype == jnp.bfloat16) == (mine.dtype == BF), key
        np.testing.assert_array_equal(mine.float().numpy(),
                                      np.asarray(seen, np.float32), key)

    # the frozen teacher's statistics: the port's float32 ones bitwise
    # unchanged (_port_step); JAX's step casts back to float32 only the
    # leaves that are float32, so its teacher's, never updated, stay the
    # bfloat16 cast of the float32 statistics
    ref, ref_teacher = _split_teacher(ref)
    got, got_teacher = _split_teacher(got)
    f32, _ = _split_teacher(f32)
    assert (ref_teacher is None) == (got_teacher is None)
    if ref_teacher is not None:
        start = dict(_flat(ref["variables"]["batch_stats"]["teacher_net"]))
        for path, r in _flat(ref_teacher):
            assert r.dtype == jnp.bfloat16, path
            assert np.array_equal(np.asarray(r, np.float32), _bf(start[path]))
        for path, a in _flat(got_teacher):
            assert np.array_equal(a, start[path]), path
    floor = _stats_floor_ulps(got, ref)
    print(f"{kind}: BN statistics beyond one bf16 ulp each: {floor:.3f} "
          "bf16 ulps of the leaf's largest; the port's f32 step (control) "
          f"{_stats_floor_ulps(f32, ref):.3f}")
    assert floor <= 6.0


@pytest.mark.parametrize("kind", ["fisheye", "nusc", "distill"])
def test_recipe_bf16_step_loss_is_bf16s_on_smooth_textures(kind,
                                                           monkeypatch):
    """The loss on smooth textures against JAX's bf16 step with the
    photometric kernel and stencil target stats, which the port's kernels
    compute: within 7e-2, where the port's float32 step misses (for the
    distillation step its reprojection loss, which the teacher's
    distillation terms would otherwise drown)."""
    import sys

    import fsnet_tpu.models.heads.monodepth2_decoder as jdec

    calls = []
    monkeypatch.setattr(jdec, "photo_loss_supported",
                        lambda shape: calls.append(shape) or True)
    monkeypatch.setattr(sys.modules["fsnet_tpu.ops.ssim"], "SSIM_STENCIL",
                        True)
    batch = _batch(kind, smooth=True)
    ref = _jax_bf16_step(kind, batch)
    assert len(calls) == 2              # the warped and identity stacks
    got = _port_step(kind, ref["variables"], batch, "bfloat16")
    f32 = _port_step(kind, ref["variables"], batch, None)
    loss = _reprojection if kind == "distill" else (lambda r: r["loss"])
    mine, theirs, ctl = loss(got), loss(ref), loss(f32)
    rel, control = abs(mine - theirs) / theirs, abs(ctl - theirs) / theirs
    print(f"{kind} on smooth textures: loss port bf16 {mine:.6f}, JAX bf16 "
          f"(photometric kernel, stencil stats) {theirs:.6f}: rel "
          f"{rel:.3e}; the port's f32 step (control) {ctl:.6f}: rel "
          f"{control:.3e}")
    assert rel < 7e-2 <= control


def test_fisheye_bf16_routes_agree():
    """The port's bf16 fisheye step on its norm-direct route (kernels G, H)
    and on its grid route (kernels F, E through their bfloat16 wrappers),
    from the same weights: one function at bf16's gates."""
    from fsnet_tpu_torch.models.flax_convert import to_flax as _to_flax

    batch = _batch("fisheye")
    port = fisheye_model(H, W, device="cpu")
    v = _to_flax(port, dict(port.state_dict()))
    routes = {tag: _port_step("fisheye", v, batch, "bfloat16",
                              grid_route=tag == "grid")
              for tag in ("norm-direct", "grid")}
    rel = _rel(routes["grid"], routes["norm-direct"])
    cos = _grad_distance(routes["grid"], routes["norm-direct"])[0]
    print(f"fisheye bf16 grid vs norm-direct route: loss rel {rel:.3e}, "
          f"gradient cosine {cos:.4f}")
    assert rel < 2e-2 and cos > 0.8


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_recipe_matches_its_config(kind):
    """Each recipe's optimizer, scheduler, clip and compute dtype are its
    shipped config's (``configs/common.py:163`` through
    ``trainer_section``)."""
    from test_torch_nusc import _load

    cfg = _load(CONFIGS[kind])
    recipe = RECIPES[kind]
    assert recipe["optimizer"] == dict(cfg.optimizer)
    assert recipe["scheduler"] == dict(cfg.scheduler)
    hook = cfg.trainer.training_hook
    assert recipe["clip_gradients"] == hook.clip_gradients
    assert recipe["compute_dtype"] == hook.compute_dtype == "bfloat16"


def test_fisheye_weight_decay_lands_after_the_clip():
    """The fisheye recipe's L2 weight decay is added after the global-norm
    clip and before Adam's moments, in optax's chain order
    (``fsnet_tpu/runtime/optim.py:133-146``): over two steps the port's
    parameters equal optax's within 1e-7, where decay before the clip moves
    them elsewhere (a gradient norm far above the clip)."""
    import optax

    from fsnet_tpu.runtime.optim import build_optimizer as jax_optimizer
    from fsnet_tpu_torch.runtime.optim import build_optimizer

    rng = np.random.RandomState(3)
    params = [rng.randn(*s).astype(np.float32) for s in ((4, 5), (7,))]
    # one leaf without a gradient: its update is the decay's alone, which
    # the clip scales down to Adam's epsilon when it comes first
    grads = [50.0 * rng.randn(*params[0].shape).astype(np.float32),
             np.zeros_like(params[1])]
    rec = FISHEYE_RECIPE
    tx, _ = jax_optimizer(dict(rec["optimizer"]), rec["scheduler"],
                          steps_per_epoch=1,
                          clip_gradients=rec["clip_gradients"])
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt, _ = build_optimizer(tp, dict(rec["optimizer"]), rec["scheduler"],
                             steps_per_epoch=1,
                             clip_gradients=rec["clip_gradients"])
    for _ in range(2):
        upd, state = tx.update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.from_numpy(g) for g in grads])
    for a, r in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-7)
    # the other order, decay before the clip, is another update
    assert np.sqrt(sum(float((g * g).sum()) for g in grads)) > 100.0
    wrong = optax.chain(optax.add_decayed_weights(1e-5),
                        optax.clip_by_global_norm(1.0),
                        optax.scale_by_adam(), optax.scale(-1e-4))
    jq = [jnp.asarray(p) for p in params]
    state = wrong.init(jq)
    for _ in range(2):
        upd, state = wrong.update([jnp.asarray(g) for g in grads], state, jq)
        jq = optax.apply_updates(jq, upd)
    assert max(float(np.abs(np.asarray(q) - a.numpy()).max())
               for q, a in zip(jq, tp)) > 1e-7


def _spread():
    """Prints, for each recipe, how far JAX's own bf16 step lies from its
    float32 step (the gates above admit that spread), and how far the
    port's bf16 step lies from JAX's with its warp cotangent zeroed (what
    the gradient gates must catch)."""
    import fsnet_tpu.runtime.state as jstate

    make = jstate.make_train_step
    for kind in RECIPES:
        batch = _batch(kind)
        ref = _jax_bf16_step(kind, batch)
        jstate.make_train_step = lambda **kw: make(**dict(
            kw, compute_dtype=None))
        try:
            with jax.default_matmul_precision("highest"):
                f32 = _jax_bf16_step(kind, batch)
        finally:
            jstate.make_train_step = make
        ref_s, f32_s = _split_teacher(ref)[0], _split_teacher(f32)[0]
        cos, worst, _ = _grad_distance(f32, ref)
        print(f"{kind}: JAX's f32 step against its bf16 step: gradient "
              f"cosine {cos:.4f}, worst leaf {worst:.4f}, BN statistics "
              f"{_stats_floor_ulps(f32_s, ref_s):.3f} bf16 ulps")
        with pytest.MonkeyPatch.context() as mp:
            if kind == "fisheye":
                mp.setattr(twm, "warp_mei_bwd_plain",
                           lambda *a, _o=twm.warp_mei_bwd_plain:
                           torch.zeros_like(_o(*a)))
            else:
                mp.setattr(twf, "_chain_to_grid",
                           lambda *a, _o=twf._chain_to_grid, **k:
                           torch.zeros_like(_o(*a, **k)))
            broken = _port_step(kind, ref["variables"], batch, "bfloat16")
        print(f"{kind}: the port's bf16 step with its warp cotangent zeroed "
              f"against JAX's bf16 step: gradient cosine "
              f"{_grad_distance(broken, ref)[0]:.4f}")


if __name__ == "__main__":
    _spread()
