"""The port's train steps (on the CPU: the plain versions of their kernels)
against the JAX package's, from the same bridged weights and the same
batch, with no tie-break noise on either side. Routes:

* ``xla``: the flagship ``MonoDepthWPose`` on the JAX package's CPU route at
  64x96 (grid warp, XLA convs), both sides in float64 (the port's wrappers
  take float32; their plain versions are written for any float type, and
  this test widens the wrappers' type check to float64 on the CPU); the
  port takes its depth-direct route;
* ``tpu``: its shipped TPU route at 64x128 in float32, forced on the CPU as
  ``tests/test_multichip_kernel_route.py`` does (``jax.default_backend``
  reads "tpu", every ``pallas_call`` is interpreted), so the depth-direct
  warp (``warp_prep_pallas`` + the fused band warp + ``warp_prep_bwd_pallas``)
  and the train-mode conv kernels (``conv3x3_fused_mats_m``,
  ``conv3x3_fused_dw``) run; the test proves that they did;
* ``mask_xla`` and ``mask_tpu``: the same two with a batch that carries the
  NuScenes ``CAM_BACK`` ``patched_mask``, as every dataset batch carries
  one, so both packages take the grid route: one bilinear/border band warp
  of all S x F grids and the nearest/zeros warp of the mask for the overlap.
  On ``mask_tpu`` the test proves that the fused grid-route kernel
  (``warp_rows_pallas_dma_fused``) and the forward kernel
  (``warp_rows_pallas_dma``) ran and ``warp_prep_pallas`` did not;
* ``meta_xla``: the learned-pose ``MonoDepthMeta`` at 64x96 in float64: the
  grid cotangent reaches the pose net, and the pose net's BN runs in train
  mode once per source frame, so its running statistics take two momentum
  updates per step on both sides (held by the statistics bound below, and
  counted on the port's side);
* ``fisheye_xla`` and ``fisheye_tpu``: the KITTI-360 fisheye
  ``MonoDepthWPose`` (``FishEyeDecoder``, band 16) at 64x128 on the fisheye
  batch (``entry.fisheye_batch``: a Mei camera, side-camera motion, the
  backtracked ray map, an all-ones ``patched_mask``). On ``fisheye_xla``
  (float64) the JAX package takes its CPU grid route, with its grid math
  widened from its pinned float32 to float64 (:class:`_Float64Grid`), and
  the port its norm-direct route; on ``fisheye_tpu`` (float32) both take
  the norm-direct route, and the test proves that ``mei_prep_pallas``,
  ``warp_rows_pallas_dma_fused`` and ``mei_prep_bwd_pallas`` ran and
  ``photo_loss_pallas`` did not;
* ``nusc_xla``: the ``MonoDepthWPose`` of ``configs/nusc_wpose_example.py``
  (``entry.nusc_config``: ResNet-34, 64 bins, ``base_fx=369``, no overlap
  mask) at 64x128 in float64 on the batch with the NuScenes patched mask,
  with the recipe's optimizer (``entry.NUSC_RECIPE``: StepLR step 4): both
  packages take the grid route, and only the photometric warp runs (no
  mask warp without the overlap mask);
* ``distill_xla``: the ``DistillWPoseMeta`` of
  ``configs/distill_nusc_example.py`` (``entry.distill_config``: a frozen
  ResNet-18/16-bin ``MonoDepthInference`` teacher, a student with
  ``MultiChannelDepthDecoderUncertain``, the uncertainty-weighted
  distillation loss at 0.3) at 64x128 in float64 on the same batch, bridged
  weights for student and teacher; the JAX step under
  ``build_frozen_mask`` (optax ``set_to_zero`` on the teacher), the port's
  with the teacher left out of its optimizer. The teacher's gradients are
  exactly 0 on the JAX side, so the clip's global norms must agree, and
  the teacher's parameters and BN statistics are bitwise unchanged on both
  sides; each ``distilation/{s}`` term matches JAX's to 1e-10 rel;
* ``photo_tpu``: ``mask_tpu`` with the JAX side's photometric kernel forced
  on (``fsnet_tpu.ops.photo_loss.PHOTO_KERNEL``), so the loss of the warped
  stack and of the identity stack runs ``photo_loss_pallas`` (interpreted)
  and its cotangent ``photo_loss_bwd_pallas``; the test proves that they ran,
  twice and once. On the port's side the photometric loss is always its
  fused op (``ops/photo_loss.py``: on the CPU the plain versions of its two
  kernels).

The JAX side runs ``model.apply(..., mutable=["batch_stats"])`` under
``jax.value_and_grad`` at matmul precision "highest", then the optax chain
of ``bench.py`` (clip 1.0, Adam, lr 1e-4, StepLR). The batch is the
synthetic batch's poses and intrinsics with white-noise images: on its
smooth textures many 3x3 windows have a variance at the level of float32
rounding, where SSIM's ``>= 0`` variance clamp turns their gradient on or
off at random, and the JAX package's own two pool forms (banded matrix and
stencil) then differ by 8.6e-3 in rel-L2 of d loss / d depth.

Bounds, with the values measured when this test was written:

* float64: loss rel <= 1e-5 on ``xla`` and ``fisheye_xla``, where the two
  packages take different warp routes (4.3e-16; 2.9e-16), and <= 1e-10 where
  both take the grid route (1.4e-16 ``mask_xla``, 5.4e-16 ``meta_xla``);
  gradients per leaf rel-L2 <= 1e-4 (6.1e-14; 9.4e-13 on ``meta_xla``;
  1.6e-13 on ``fisheye_xla``; with the port's photometric cotangent in
  closed form); parameters after the Adam step within 1e-6 (2e-13); BN
  running statistics within 1e-6 (7e-15); the global gradient norm (the
  clip's) within 1e-10 rel. On ``nusc_xla`` and ``distill_xla``: loss
  2.9e-16 and 8.7e-16, worst leaf 2.7e-13 and 5.7e-14, parameters
  6.9e-13 and 3.1e-13, statistics 2.3e-14 and 5.2e-15, gradient norm
  1.0e-14 and 2.6e-15, each ``distilation/{s}`` within 2.7e-15.
* float32 (``tpu``, ``mask_tpu``, ``photo_tpu``): rounding flips discrete
  choices (a bilinear corner where a coordinate lies within an ulp of an
  integer, the reprojection min at near ties), each of which moves the
  gradient of one pixel by O(1). The JAX package's own XLA and TPU routes
  differ by 1.2e-3 in global gradient rel-L2 on this batch (worst leaf
  2.8e-3, dispconv_1). So: loss rel <= 1e-5 (1.6e-7 on both; on
  ``photo_tpu`` within 2e-5 absolute, the JAX package's own gate between its
  photometric kernel and its XLA route: 6.0e-8); global gradient rel-L2 <=
  1e-2 (2.3e-3; 2.9e-3 on ``mask_tpu`` and on ``photo_tpu``), per leaf <=
  2e-2 (5.4e-3; 9.1e-3 on both); Adam's first step is about lr * sign(g), so
  every parameter is within 2 lr (1 + 1e-6) of JAX's and at least 97% of
  them within 1e-6 (98.7%); BN running statistics within 1e-5 * max(1,
  |ref|) (2.7e-6: the batch variance E[x^2] - mean^2 cancels, in float32).
* ``fisheye_tpu`` (float32): the same bounds, except per leaf <= 3e-2.
  Against the exact float64 gradient of this step, the JAX TPU route's own
  float32 gradient is off by 2.1e-2 on the BN bias of ``layer4_0.bn1`` (a
  leaf with 0.16% of the gradient norm; 4.7e-3 global) and the port's by
  1.1e-2 at worst (6.6e-3 global); port against JAX: loss 1.6e-7, global
  8.1e-3, worst leaf 2.2e-2 (that bias), 97.4% of the parameters within
  1e-6, statistics 2.8e-6.

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
from fsnet_tpu_torch.entry import (NUSC_RECIPE, distill_config,
                                   distill_model, fisheye_batch,
                                   fisheye_config, fisheye_model,
                                   flagship_model, flagship_optimizer,
                                   learned_pose_config, learned_pose_model,
                                   nusc_config, nusc_model, recipe_optimizer,
                                   synthetic_batch)
from fsnet_tpu_torch.models.flax_convert import load_flax_variables, to_flax
from fsnet_tpu_torch.ops import conv3x3 as tc
from fsnet_tpu_torch.ops import photo_loss as tpl
from fsnet_tpu_torch.ops import warp_depth as twd
from fsnet_tpu_torch.ops import warp_fast as twf
from fsnet_tpu_torch.ops import warp_mei as twm
from fsnet_tpu_torch.runtime.state import make_train_step

torch.set_num_threads(1)

# name: (H, W, dtype, model, patched mask)
ROUTES = {
    "xla": (64, 96, np.float64, "wpose", None),
    "tpu": (64, 128, np.float32, "wpose", None),
    "mask_xla": (64, 96, np.float64, "wpose", "nuscenes"),
    "mask_tpu": (64, 128, np.float32, "wpose", "nuscenes"),
    "meta_xla": (64, 96, np.float64, "meta", None),
    "fisheye_xla": (64, 128, np.float64, "fisheye", None),
    "fisheye_tpu": (64, 128, np.float32, "fisheye", None),
    "photo_tpu": (64, 128, np.float32, "wpose", "nuscenes"),
    "nusc_xla": (64, 128, np.float64, "nusc", "nuscenes"),
    "distill_xla": (64, 128, np.float64, "distill", "nuscenes"),
}
# the nuScenes recipes' configs and optimizer
RECIPE_CFG = dict(nusc=nusc_config, distill=distill_config)
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


def _batch(H, W, dtype, patched_mask=None, kind="wpose"):
    """The synthetic batch's poses and intrinsics with white-noise images
    (see the module docstring), or the fisheye batch (white noise already),
    in ``dtype``."""
    if kind == "fisheye":
        return {k: v.astype(dtype) for k, v in
                fisheye_batch(B, H, W).items()}
    batch = synthetic_batch(B, H, W, patched_mask=patched_mask)
    rng = np.random.RandomState(7)
    for key in sorted(batch):
        if key.startswith(("image/", "original_image/")):
            batch[key] = rng.rand(*batch[key].shape)
    return {k: v.astype(dtype) for k, v in batch.items()}


class _Float64Grid:
    """``jax.numpy`` with ``float32`` read as ``float64``: the JAX fisheye
    head pins its grid route's ray, pose, norm and camera arrays to float32
    (``fisheye_decoder.py:148-162``, the grid-math precision of its TPU
    recipe), which under x64 moves the warped frames by up to 1.6e-5 and the
    gradients by 1.8e-3 in global rel-L2 against an exact float64 warp. On
    ``fisheye_xla`` that module sees this namespace, so its grid is as wide
    as the rest of the step."""

    def __getattr__(self, name):
        import jax.numpy as jnp

        return jnp.float64 if name == "float32" else getattr(jnp, name)


def _jax_names(cfg):
    """A port config with the JAX package's names."""
    if isinstance(cfg, dict):
        return {k: _jax_names(v) for k, v in cfg.items()}
    if isinstance(cfg, str):
        return cfg.replace("fsnet_tpu_torch.", "fsnet_tpu.")
    return cfg


def jax_model(kind, H, W):
    """The JAX package's flagship, learned-pose ``MonoDepthMeta``,
    fisheye ``MonoDepthWPose`` or a nuScenes recipe's model."""
    if kind == "wpose":
        return ge._flagship_model(H, W)
    from fsnet_tpu.utils.builder import build

    cfg = dict(RECIPE_CFG, meta=learned_pose_config,
               fisheye=fisheye_config)[kind]
    return build(**_jax_names(cfg(H, W)))


def jax_init(kind, model, image):
    """Every variable of ``model``: the depth path, for the learned-pose
    model the pose net on a frame pair, for the distillation model the
    teacher."""
    def init_all(m, x):
        if kind == "fisheye":         # its prediction needs the ray maps
            return m.head.forward_depth(m.depth_backbone(x, train=False),
                                        train=False)
        out = m.dummy_forward(x)
        if kind == "meta":
            pair = jax.numpy.concatenate([x, x], axis=-1)
            m.head.forward_pose([m.pose_backbone(pair, train=False)])
        if kind == "distill":
            m.teacher_net(x)
        return out
    return jax.jit(lambda x: model.init({"params": jax.random.PRNGKey(0)},
                                        x, method=init_all))(image)


def _jax_step(kind, H, W, batch, dtype):
    from fsnet_tpu.runtime.optim import (build_frozen_mask, build_optimizer,
                                         frozen_param_prefixes)

    model = jax_model(kind, H, W)
    rng = np.random.RandomState(0)
    with jax.default_matmul_precision("highest"):
        v = jax_init(kind, model, batch["image/0"])
        v = jax.tree.map(lambda a: np.asarray(a, dtype),
                         _to_dicts(_randomise(v, rng)))

        def loss_fn(params):
            out, mutated = model.apply(
                {"params": params, "batch_stats": v["batch_stats"]}, batch,
                {"is_training": True}, mutable=["batch_stats"])
            return out["loss"], (mutated, out["loss_dict"])

        (loss, (mutated, loss_dict)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(v["params"])
        if kind in RECIPE_CFG:
            cfg = _jax_names(RECIPE_CFG[kind](H, W))
            mask = build_frozen_mask(v["params"], frozen_param_prefixes(cfg))
            tx, _ = build_optimizer(dict(NUSC_RECIPE["optimizer"], lr=LR),
                                    NUSC_RECIPE["scheduler"],
                                    steps_per_epoch=1000,
                                    clip_gradients=NUSC_RECIPE[
                                        "clip_gradients"],
                                    frozen_mask=mask)
        else:
            tx, _ = build_optimizer(dict(name="adam", lr=LR),
                                    dict(name="StepLR", step_size=8),
                                    steps_per_epoch=1000, clip_gradients=1.0)
        updates, _ = tx.update(grads, tx.init(v["params"]), v["params"])
        new_params = optax.apply_updates(v["params"], updates)
    return dict(variables=v, loss=float(loss), grads=_to_dicts(grads),
                grad_norm=float(optax.global_norm(grads)),
                loss_dict={k: float(x) for k, x in loss_dict.items()},
                params=_to_dicts(new_params),
                stats=_to_dicts(mutated["batch_stats"]))


def _run(name):
    """Both steps on route ``name``: the JAX reference, the port's results
    in flax layout, the counts of the TPU kernels the JAX side ran and the
    pose net's BN updates on the port's side."""
    H, W, dtype, kind, mask = ROUTES[name]
    batch = _batch(H, W, dtype, mask, kind)
    calls = {}
    with pytest.MonkeyPatch.context() as mp:
        if name.endswith("tpu"):
            import fsnet_tpu.ops.pallas.conv_kernel as ck
            import fsnet_tpu.ops.pallas.mei_prep_kernel as mpk
            import fsnet_tpu.ops.pallas.photo_kernel as phk
            import fsnet_tpu.ops.pallas.prep_kernel as prk
            import fsnet_tpu.ops.pallas.warp_kernel as wk
            import fsnet_tpu.ops.photo_loss as jpl
            import fsnet_tpu.ops.warp_depth as jwd
            import fsnet_tpu.ops.warp_mei as jwm

            for mod in (ck, prk, wk, mpk):
                def patched(*args, _orig=pl.pallas_call, **kwargs):
                    kwargs["interpret"] = True
                    return _orig(*args, **kwargs)
                mp.setattr(mod.pl, "pallas_call", patched)
            counted_fns = [((prk, jwd), "warp_prep_pallas"),
                           ((ck,), "conv3x3_fused_mats_m"),
                           ((ck,), "conv3x3_fused_dw")]
            if mask is not None:
                counted_fns += [((wk,), "warp_rows_pallas_dma_fused"),
                                ((wk,), "warp_rows_pallas_dma")]
            if name == "photo_tpu":
                mp.setattr(jpl, "PHOTO_KERNEL", True)
                counted_fns += [((phk, jpl), "photo_loss_pallas"),
                                ((phk, jpl), "photo_loss_bwd_pallas")]
            if kind == "fisheye":
                counted_fns += [((mpk, jwm), "mei_prep_pallas"),
                                ((mpk, jwm), "mei_prep_bwd_pallas"),
                                ((wk,), "warp_rows_pallas_dma_fused"),
                                ((phk, jpl), "photo_loss_pallas")]
            for mods, fn in counted_fns:
                calls[fn] = 0

                def counted(*args, _orig=getattr(mods[0], fn), _fn=fn,
                            **kwargs):
                    calls[_fn] += 1
                    return _orig(*args, **kwargs)
                for mod in mods:
                    mp.setattr(mod, fn, counted)
            mp.setattr(jax, "default_backend", lambda: "tpu")
        x64 = dtype == np.float64
        if x64 and kind == "fisheye":
            import fsnet_tpu.models.heads.fisheye_decoder as jfd

            mp.setattr(jfd, "jnp", _Float64Grid())
        jax.config.update("jax_enable_x64", x64)
        try:
            ref = _jax_step(kind, H, W, batch, dtype)
        finally:
            jax.config.update("jax_enable_x64", False)
    build_port = dict(wpose=flagship_model, meta=learned_pose_model,
                      fisheye=fisheye_model, nusc=nusc_model,
                      distill=distill_model)[kind]
    port = build_port(H, W, device="cpu").to(
        torch.float64 if x64 else torch.float32)
    load_flax_variables(port, ref["variables"])
    if kind in RECIPE_CFG:
        opt, _ = recipe_optimizer(port, NUSC_RECIPE, RECIPE_CFG[kind](H, W))
    else:
        opt, _ = flagship_optimizer(port)
    pose_bn_updates = []
    with pytest.MonkeyPatch.context() as mp:
        if x64:
            mp.setitem(tc._DTYPES, torch.float64, -1)
            mp.setattr(twd, "_DTYPES", (torch.float64,))
            mp.setattr(twf, "_DTYPES", (torch.float64,))
            mp.setattr(twm, "_DTYPES", (torch.float64,))
            mp.setattr(tpl, "_DTYPES", (torch.float64,))
        if kind == "meta":
            bn = port.pose_backbone.bn1
            mp.setattr(bn, "update_stats",
                       lambda m, v, d, _orig=bn.update_stats:
                       (pose_bn_updates.append(1), _orig(m, v, d)))
        metrics = make_train_step("cpu", with_grads=True)(port, opt, batch)
    got = dict(loss=float(metrics["loss"]),
               grad_norm=float(metrics["grad_norm"]),
               loss_dict={k: float(v) for k, v in metrics.items()
                          if k.startswith("distilation/")},
               grads=to_flax(port, metrics["_grads"])["params"],
               params=to_flax(port, dict(port.named_parameters()))["params"],
               stats=to_flax(port, {k: t for k, t in port.state_dict().items()
                                    if k.endswith(("running_mean",
                                                   "running_var"))}
                             )["batch_stats"])
    return dict(name=name, ref=ref, got=got, calls=calls,
                pose_bn_updates=len(pose_bn_updates))


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
    name = route["name"]
    f64 = ROUTES[name][2] == np.float64
    loss_tol = 1e-10 if f64 and name not in ("xla", "fisheye_xla") else 1e-5
    if name == "photo_tpu":
        # the JAX package's own gate between its photometric kernel (one
        # 1/9 pooling scale) and its XLA route (tests/test_photo_kernel.py)
        assert abs(got["loss"] - ref["loss"]) <= 2e-5
    else:
        assert abs(got["loss"] - ref["loss"]) <= loss_tol * abs(ref["loss"])

    ref_g, got_g = dict(_flat(ref["grads"])), dict(_flat(got["grads"]))
    # the distillation teacher: no gradient on the JAX side, none taken on
    # the port's (it is out of the optimizer)
    teacher = [p for p in ref_g if p[0] == "teacher_net"]
    assert bool(teacher) == (name == "distill_xla")
    for path in teacher:
        assert not np.any(ref_g.pop(path)), path
    assert sorted(got_g) == sorted(ref_g)
    kept = [p for p in ref_g if not _bn_cancelled(p)]
    g_norm = np.sqrt(sum(float(np.sum(np.square(ref_g[p]))) for p in kept))
    for path, r in ref_g.items():
        assert got_g[path].shape == r.shape, path
        if _bn_cancelled(path):
            assert np.abs(r).max() <= 1e-6 * g_norm, path
            assert np.abs(got_g[path]).max() <= 1e-6 * g_norm, path
    errs = {p: _rel_l2(got_g[p], ref_g[p]) for p in kept}
    leaf_tol = 1e-4 if f64 else (3e-2 if name == "fisheye_tpu" else 2e-2)
    bad = {p: e for p, e in errs.items() if e > leaf_tol}
    assert not bad, bad
    if not f64:
        diff = np.sqrt(sum(float(np.sum(np.square(got_g[p] - ref_g[p])))
                           for p in kept))
        assert diff <= 1e-2 * g_norm, diff / g_norm
    else:
        # the global norm the clip divides by, the teacher's zeros included
        # on the JAX side
        assert abs(got["grad_norm"] - ref["grad_norm"]) <= \
            1e-10 * ref["grad_norm"]
    distill = {k: v for k, v in ref["loss_dict"].items()
               if k.startswith("distilation/")}
    assert sorted(got["loss_dict"]) == sorted(distill)
    assert bool(distill) == (name == "distill_xla")
    for k, r in distill.items():
        assert abs(got["loss_dict"][k] - r) <= 1e-10 * abs(r), k

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
        if path[0] == "teacher_net":          # frozen: bitwise unchanged
            assert np.array_equal(r, start[path]), path
            assert np.array_equal(a, start[path]), path
        d = np.abs(a - r)
        assert d.max() <= (1e-6 if f64 else 2 * LR * (1 + 1e-6)), path
        n_close += int((d <= 1e-6).sum())
        n_all += d.size
    assert n_close >= 0.97 * n_all, n_close / n_all

    ref_s, got_s = dict(_flat(ref["stats"])), dict(_flat(got["stats"]))
    assert sorted(got_s) == sorted(ref_s)
    tol = 1e-6 if f64 else 1e-5
    start_s = dict(_flat(ref["variables"]["batch_stats"]))
    for path, r in ref_s.items():
        assert np.all(np.abs(got_s[path] - r)
                      <= tol * np.maximum(1.0, np.abs(r))), path
        if path[0] == "teacher_net":          # eval-mode BN: unchanged
            assert np.array_equal(r, start_s[path]), path
            assert np.array_equal(got_s[path], start_s[path]), path

    # the forced TPU route really ran the Pallas kernels: the depth-direct
    # warp without a patched mask, the grid route's two warps with one
    calls = route["calls"]
    if name == "tpu":
        assert sorted(calls) == ["conv3x3_fused_dw", "conv3x3_fused_mats_m",
                                 "warp_prep_pallas"]
        assert all(n > 0 for n in calls.values()), calls
    elif name in ("mask_tpu", "photo_tpu"):
        photo = (["photo_loss_bwd_pallas", "photo_loss_pallas"]
                 if name == "photo_tpu" else [])
        assert sorted(calls) == sorted(
            ["conv3x3_fused_dw", "conv3x3_fused_mats_m", "warp_prep_pallas",
             "warp_rows_pallas_dma", "warp_rows_pallas_dma_fused"] + photo)
        assert calls["warp_prep_pallas"] == 0, calls
        assert all(n > 0 for k, n in calls.items()
                   if k != "warp_prep_pallas"), calls
        if photo:
            # the warped stack and the identity stack; one cotangent
            assert (calls["photo_loss_pallas"],
                    calls["photo_loss_bwd_pallas"]) == (2, 1), calls
    elif name == "fisheye_tpu":
        assert sorted(calls) == ["conv3x3_fused_dw", "conv3x3_fused_mats_m",
                                 "mei_prep_bwd_pallas", "mei_prep_pallas",
                                 "photo_loss_pallas", "warp_prep_pallas",
                                 "warp_rows_pallas_dma_fused"]
        assert calls["warp_prep_pallas"] == 0, calls
        assert calls["photo_loss_pallas"] == 0, calls
        assert all(n > 0 for k, n in calls.items() if k not in
                   ("warp_prep_pallas", "photo_loss_pallas")), calls
    else:
        assert calls == {}
    # the pose net's BN: one running-statistics update per source frame
    assert route["pose_bn_updates"] == (2 if ROUTES[name][3] == "meta" else 0)


def test_patched_mask_of_ones_takes_the_grid_route_to_the_same_loss():
    """A batch with an all-ones ``patched_mask`` sends the flagship's loss
    down the grid route (reproject, band warp of the grids, nearest/zeros
    warp of the mask); without it the loss is depth-direct. The two
    compute one function: losses within 1e-5 rel in float64, the port
    alone."""
    H, W = 64, 96
    batch = _batch(H, W, np.float64, "ones")
    routes = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tc._DTYPES, torch.float64, -1)
        mp.setattr(twd, "_DTYPES", (torch.float64,))
        mp.setattr(twf, "_DTYPES", (torch.float64,))
        mp.setattr(tpl, "_DTYPES", (torch.float64,))
        for tag, b in (("grid", batch),
                       ("depth", {k: v for k, v in batch.items()
                                  if k != "patched_mask"})):
            warps = []
            for mod, fn in ((twd, "warp_depth_plain"),
                            (twf, "grid_band_plain")):
                mp.setattr(mod, fn, lambda *a, _o=getattr(mod, fn), _f=fn,
                           **k: (warps.append(_f), _o(*a, **k))[1])
            model = flagship_model(H, W, device="cpu").double()
            opt, _ = flagship_optimizer(model)
            met = make_train_step("cpu")(model, opt, b)
            routes[tag] = (float(met["loss"]), sorted(set(warps)))
    assert routes["grid"][1] == ["grid_band_plain"]
    assert routes["depth"][1] == ["warp_depth_plain"]
    assert abs(routes["grid"][0] - routes["depth"][0]) <= \
        1e-5 * abs(routes["depth"][0])
