"""The deformable conv, the DLA and the learned-pose and residual-pose steps
at bfloat16 on the CPU (the plain versions of the kernels) against the JAX
package, from the same numpy inputs. Tolerances, with the values measured
when this file was written:

* The DCN's sampling grid in bfloat16 (``ops/dcn.tap_grid`` on bf16
  offsets) equal bit for bit to the grid JAX's ``modulated_deform_conv``
  hands its warp, at a width whose ``W - 1`` (319) bf16 does not hold.
* Kernel K's plain version on bfloat16 operands (the float32 one on the
  widened image and cotangent, dimage rounded once) against JAX's
  ``warp_fast._bwd`` on the same bf16 image and cotangent and the float32
  grid: JAX's bf16 image cotangent scatter-adds in bf16, rounding at every
  add, and forms the grid cotangent from bf16 blends, so the two are a
  reading: rel-L2 4.3e-3 (dimage) and 3.6e-3 (the grid cotangent after
  the chain rule). The gate, 2e-2, lies between that and the same plain
  version with one corner's weight zeroed (the broken control: 0.71 and
  0.19).
* The DCN forward and VJP in bfloat16 against JAX's on the same
  bf16-valued inputs (rel-L2 of the output and of the cotangents of x,
  the offsets, the masks, the weight and the bias). JAX forms the grid
  in bf16 as the port does, but then unnormalises it in bf16 inside its
  warp, where the port widens it to float32 first: a coordinate beyond
  x = 128 lands on whole pixels in bf16. With the reference as it is
  (``reference``) that difference dominates: measured 3.7e-2, 9.5e-2,
  0.34, 3.8e-2, 4.0e-2, 1.8e-2, gated at about 1.5 times that; the port's
  float32 DCN on the same values lies as far (3.7e-2 on the output), so
  there the control is the broken warp alone. With JAX's unnormalisation
  taken in float32 (``float32_unnormalise``, the test's one change to the
  reference; run op by op, since under jit XLA may keep the grid in
  float32 ahead of the widening, excess precision) the rest agrees:
  5.8e-3, 5.6e-3, 5.4e-3, 6.1e-3, 3.9e-3 (bias 1.8e-2: JAX sums it in
  bf16), gated at 1.5e-2, which the port's float32 DCN, the control,
  misses (4.5e-2 and more), as does the broken warp. ROADMAP C logs the
  positional error.
* The DLA (``dlanet(34)`` at narrow widths under ``DLASegUpsample`` with
  ``down_ratio=16``, two deformable convs in the head, the trunk whole;
  every BN on its running statistics) at bf16 against JAX's trunk and head
  applied to the ``_cast`` parameters, statistics and input, the loss
  ``sum(out * r)`` and its gradient: loss rel < 2e-2 (measured 0.0),
  gradient cosine > 0.999 (0.99999) and global rel-L2 < 1.5e-2 (4.2e-3),
  which the port's float32 step, the control, misses (3.2e-2).
* ``MonoDepthMeta`` and the residual-pose ``MonoDepthWPose`` (``meta``,
  ``residual``) at 64x96: the port's bf16 step against
  ``fsnet_tpu.runtime.state.make_train_step(compute_dtype=jnp.bfloat16,
  with_grads=True)`` from the same bridged weights, the JAX side with its
  photometric kernel forced on (interpreted) and its stencil target stats,
  the function the port's kernels compute, one compile for two batches.
  On white noise the gates of ``tests/test_torch_bf16_recipes.py``: loss
  rel < 2e-2 (measured 4.3e-5 and 2.7e-5), gradient cosine > 0.8 and
  worst-leaf rel-L2 <= 1.0 over the leaves but the BN-cancelled conv
  biases (0.895 and 0.882; 0.627 and 0.675), every gradient leaf
  bf16-valued, the BN statistics within one bf16 ulp of JAX's plus 3 bf16
  ulps of the leaf's largest statistic (2.05 on both). As for the other
  recipes, the port's float32 step lies as near on these gates (cosine
  0.910 and 0.904). On the synthetic batch's smooth textures the loss
  within 7e-2 of JAX's (4.28e-2 and 4.24e-2), which the port's float32
  step, the control, misses (0.110 on both). On JAX's XLA route instead
  (its photometric loss in bf16 XLA) the white-noise loss reads 1.41e-2
  and 1.52e-2. ``PYTHONPATH=. python tests/test_torch_bf16_models.py``
  prints these readings.
"""
import sys

import numpy as np
import pytest
import torch

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp

import fsnet_tpu.ops.warp_fast as jwf
from fsnet_tpu.ops import dcn as jdcn
from fsnet_tpu_torch.entry import (DLAUpsampleNet, flagship_optimizer,
                                   learned_pose_config, learned_pose_model,
                                   perturb_offsets, residual_pose_config,
                                   residual_pose_model, synthetic_batch)
from fsnet_tpu_torch.models.blocks import init_params
from fsnet_tpu_torch.models.flax_convert import load_flax_variables, to_flax
from fsnet_tpu_torch.ops import dcn as tdcn
from fsnet_tpu_torch.ops import warp_fast as twf
from fsnet_tpu_torch.runtime import state as tstate

from test_torch_bf16 import _bf, _grad_distance, _stats_floor_ulps
from test_torch_train_step import (_jax_names, _randomise, _to_dicts,
                                   jax_init)

torch.set_num_threads(1)
BF = torch.bfloat16


@pytest.fixture(autouse=True)
def _interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)


def _rel(a, r):
    a, r = np.asarray(a, np.float64), np.asarray(r, np.float64)
    return float(np.linalg.norm(a - r) / np.linalg.norm(r))


def _zeroed_corner(monkeypatch):
    """The broken control: every sample's right-hand corner weighted 0 in
    the plain warps."""
    orig = twf.indices_and_weights

    def broken(*args, **kwargs):
        iw = orig(*args, **kwargs)
        iw["wx1"] = torch.zeros_like(iw["wx1"])
        return iw
    monkeypatch.setattr(twf, "indices_and_weights", broken)


# ------------------------------------------------------ the DCN in bf16

def test_tap_grid_bf16_is_jaxs(monkeypatch):
    rng = np.random.RandomState(4)
    B, H, W, K = 2, 5, 320, 3
    off = _bf(1.5 * rng.randn(B, H, W, 2 * K * K))
    seen = []

    def record(image, grid, **kwargs):
        seen.append(np.asarray(grid.astype(jnp.float32)))
        return jnp.zeros(grid.shape[:3] + image.shape[3:], image.dtype)
    monkeypatch.setattr(jdcn, "grid_sample", record)
    jdcn.modulated_deform_conv(
        jnp.zeros((B, H, W, 1), jnp.bfloat16), jnp.asarray(off, jnp.bfloat16),
        jnp.ones((B, H, W, K * K), jnp.bfloat16),
        jnp.zeros((K, K, 1, 1), jnp.bfloat16))
    got = tdcn.tap_grid(torch.from_numpy(off).to(BF), H, W, K)
    assert got.dtype == BF and len(seen) == K * K
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.concatenate(seen, axis=0))


def _grid_case(rng, B=2, H=12, W=40, C=16):
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    sx = xs + 1.5 * rng.randn(B, H, W)
    sy = ys + 1.5 * rng.randn(B, H, W)
    grid = np.stack([sx / (W - 1) * 2 - 1, sy / (H - 1) * 2 - 1], -1)
    return (_bf(rng.rand(B, H, W, C)), grid.astype(np.float32),
            _bf(rng.randn(B, H, W, C)))


@pytest.mark.parametrize("broken", [False, True], ids=["plain", "broken"])
def test_grid_bwd_bf16_plain_matches_jax(broken, monkeypatch):
    image, grid, g = _grid_case(np.random.RandomState(0))
    H, W, band = image.shape[1], image.shape[2], 8
    dimage_j, dgrid_j = jax.jit(
        lambda i, gr, c: jwf._bwd("bilinear", "zeros", True, band, True,
                                  (i, gr, None, None), c))(
        jnp.asarray(image, jnp.bfloat16), jnp.asarray(grid),
        jnp.asarray(g, jnp.bfloat16))
    if broken:
        _zeroed_corner(monkeypatch)
    gfx, gfy, dimage = twf.grid_band_bwd(
        torch.from_numpy(image).to(BF), torch.from_numpy(grid),
        torch.from_numpy(g).to(BF), "bilinear", "zeros", band)
    assert gfx.dtype == torch.float32 and dimage.dtype == BF
    dgrid = twf._chain_to_grid(torch.from_numpy(grid), gfx, gfy, H, W,
                               "zeros")
    errs = (_rel(dimage.float().numpy(), np.asarray(dimage_j, np.float32)),
            _rel(dgrid.numpy(), np.asarray(dgrid_j, np.float32)))
    print(f"kernel K plain ({'broken' if broken else 'as built'}) vs JAX "
          f"_bwd at bf16: dimage rel-L2 {errs[0]:.3e}, dgrid {errs[1]:.3e}")
    assert (min(errs) > 2e-2) if broken else (max(errs) < 2e-2)


DCN_CASE = (2, 12, 40, 16, 8, 3)           # B, H, W, Cin, Cout, K
DCN_NAMES = ("out", "dx", "doffset", "dmask", "dweight", "dbias")
DCN_GATES = dict(
    reference=dict(out=5.5e-2, dx=0.15, doffset=0.5, dmask=6e-2,
                   dweight=6e-2, dbias=3e-2),
    float32_unnormalise=dict(out=1.5e-2, dx=1.5e-2, doffset=1.5e-2,
                             dmask=1.5e-2, dweight=1.5e-2, dbias=3e-2))


def _dcn_inputs():
    B, H, W, Cin, Cout, K = DCN_CASE
    rng = np.random.RandomState(0)
    return (_bf(rng.rand(B, H, W, Cin)), _bf(1.5 * rng.randn(B, H, W,
                                                              2 * K * K)),
            _bf(rng.rand(B, H, W, K * K)),
            _bf(rng.randn(K, K, Cin, Cout) / np.sqrt(K * K * Cin)),
            _bf(0.1 * rng.randn(Cout)), _bf(rng.randn(B, H, W, Cout)))


def _port_dcn(inputs, dtype):
    *args, g = inputs
    args = [torch.from_numpy(a).to(dtype).requires_grad_() for a in args]
    out = tdcn.modulated_deform_conv(*args)
    grads = torch.autograd.grad(out, args, torch.from_numpy(g).to(dtype))
    return [out.detach().float().numpy()] + [t.float().numpy()
                                             for t in grads]


@pytest.mark.parametrize("reference", sorted(DCN_GATES))
def test_dcn_bf16_matches_jax(reference, monkeypatch):
    inputs = _dcn_inputs()
    *args, g = inputs
    if reference == "float32_unnormalise":
        orig = jwf._unnormalize
        monkeypatch.setattr(jwf, "_unnormalize", lambda c, size, ac: orig(
            c.astype(jnp.float32), size, ac))

    # op by op: under jit XLA may drop the rounding of the grid to bf16
    # before the patched unnormalisation widens it (excess precision)
    out, vjp = jax.vjp(jdcn.modulated_deform_conv,
                       *(jnp.asarray(a, jnp.bfloat16) for a in args))
    ref = [np.asarray(t, np.float32) for t in
           (out,) + vjp(jnp.asarray(g, jnp.bfloat16))]
    got = _port_dcn(inputs, BF)
    control = _port_dcn(inputs, torch.float32)
    with pytest.MonkeyPatch.context() as mp:
        _zeroed_corner(mp)
        broken = _port_dcn(inputs, BF)
    gates = DCN_GATES[reference]
    for name, a, c, b, r in zip(DCN_NAMES, got, control, broken, ref):
        err, ctl, brk = _rel(a, r), _rel(c, r), _rel(b, r)
        print(f"DCN bf16 vs JAX ({reference}) {name}: rel-L2 {err:.3e} "
              f"(gate {gates[name]:.1e}); the port's float32 DCN "
              f"{ctl:.3e}; the broken warp {brk:.3e}")
        assert err < gates[name], name
        if name != "dbias":          # the bias cotangent warps nothing
            assert brk >= gates[name], name
        if reference == "float32_unnormalise" and name != "dbias":
            assert ctl >= gates[name], name


# ------------------------------------------------------------- the DLA

NARROW = (4, 8, 8, 16, 16, 32)


def test_dla_bf16_matches_jax():
    from fsnet_tpu.models.backbones import dla_utils as jdu
    from fsnet_tpu.models.backbones.dla import dlanet as jax_dlanet

    H, W, down = 32, 64, 16

    def port_model():
        m = DLAUpsampleNet(
            trunk_cfg=dict(name="fsnet_tpu_torch.models.backbones.dla.dlanet",
                           depth=34, channels=NARROW, out_indices=range(6),
                           norm_eval=True),
            head_cfg=dict(
                name="fsnet_tpu_torch.models.backbones.dla_utils."
                     "DLASegUpsample", input_channels=NARROW,
                down_ratio=down, last_level=5, norm_frozen=True))
        init_params(m, torch.Generator().manual_seed(0))
        perturb_offsets(m, 1.5, 0)
        return m

    rng = np.random.RandomState(2)
    x = rng.rand(2, H, W, 3).astype(np.float32)
    r = rng.rand(2, H // down, W // down, NARROW[4]).astype(np.float32)
    port = port_model()
    trunk = jax_dlanet(34, channels=NARROW, out_indices=tuple(range(6)))
    head = jdu.DLASegUpsample(input_channels=NARROW, down_ratio=down,
                              last_level=5)
    tv = to_flax(port.trunk, port.trunk.state_dict())
    hv = to_flax(port.head, port.head.state_dict())

    def cast(tree):
        return jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)

    def loss(params):
        f = trunk.apply({"params": cast(params[0]),
                         "batch_stats": cast(tv["batch_stats"])},
                        jnp.asarray(x, jnp.bfloat16), train=False)
        o = head.apply({"params": cast(params[1]),
                        "batch_stats": cast(hv["batch_stats"])}, f,
                       train=False)
        return jnp.sum(o * jnp.asarray(r, jnp.bfloat16)).astype(jnp.float32)

    ref_loss, ref_g = jax.jit(jax.value_and_grad(loss))(
        (tv["params"], hv["params"]))
    ref = dict(loss=float(ref_loss),
               grads=_to_dicts(dict(trunk=ref_g[0], head=ref_g[1])))
    batch = {"image/0": x, "target_weight": r}
    res = {}
    for tag, cdt in (("bf16", "bfloat16"), ("f32", None)):
        model = port_model()
        opt, _ = flagship_optimizer(model)
        met = tstate.make_train_step("cpu", compute_dtype=cdt,
                                     with_grads=True)(model, opt, batch)
        grads = {part: to_flax(getattr(model, part), {
            k[len(part) + 1:]: v for k, v in met["_grads"].items()
            if k.startswith(part + ".")})["params"]
            for part in ("trunk", "head")}
        res[tag] = dict(loss=float(met["loss"]), grads=grads)
    flat = {tag: np.concatenate([np.asarray(a, np.float64).ravel()
                                 for _, a in sorted(_leaves(d["grads"]))])
            for tag, d in dict(res, ref=ref).items()}
    assert flat["bf16"].shape == flat["ref"].shape
    read = {tag: (abs(res[tag]["loss"] - ref["loss"]) / abs(ref["loss"]),
                  float(flat[tag] @ flat["ref"] / np.linalg.norm(flat[tag])
                        / np.linalg.norm(flat["ref"])),
                  _rel(flat[tag], flat["ref"])) for tag in res}
    print(f"DLA bf16 (BN frozen) vs JAX on the cast tree: loss rel, "
          f"gradient cosine, global rel-L2: port bf16 {read['bf16']}, the "
          f"port's float32 step (control) {read['f32']}")
    loss_rel, cos, grad = read["bf16"]
    assert loss_rel < 2e-2 and cos > 0.999 and grad < 1.5e-2
    assert read["f32"][2] >= 1.5e-2


def _leaves(tree, path=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


# ------------------------------------- the learned-pose and residual steps

POSE = dict(meta=(learned_pose_config, learned_pose_model),
            residual=(residual_pose_config, residual_pose_model))
H, W, B = 64, 96, 2


def _pose_batch(white):
    batch = synthetic_batch(B, H, W)
    rng = np.random.RandomState(7)
    for key in sorted(batch):
        if white and key.startswith(("image/", "original_image/")):
            batch[key] = rng.rand(*batch[key].shape)
    return {k: v.astype(np.float32) for k, v in batch.items()}


def _jax_pose_steps(kind, batches):
    """JAX's bf16 step of ``kind`` with its photometric kernel forced on
    and its stencil target stats, compiled once and run on each batch
    from the same state."""
    import fsnet_tpu.models.heads.monodepth2_decoder as jdec
    from fsnet_tpu.runtime.optim import build_optimizer
    from fsnet_tpu.runtime.state import TrainState, make_train_step
    from fsnet_tpu.utils.builder import build

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdec, "photo_loss_supported", lambda shape: True)
        mp.setattr(sys.modules["fsnet_tpu.ops.ssim"], "SSIM_STENCIL", True)
        model = build(**_jax_names(POSE[kind][0](H, W)))
        v = jax_init("meta", model, batches[0]["image/0"])
        v = jax.tree.map(lambda a: np.asarray(a, np.float32),
                         _to_dicts(_randomise(v, np.random.RandomState(0))))
        tx, _ = build_optimizer(dict(name="adam", lr=1e-4),
                                dict(name="StepLR", step_size=8),
                                steps_per_epoch=1000, clip_gradients=1.0)
        st = TrainState.create(apply_fn=model.apply, params=v["params"],
                               batch_stats=v["batch_stats"], tx=tx)
        step = make_train_step(donate=False, compute_dtype=jnp.bfloat16,
                               with_grads=True)
        out = []
        for batch in batches:
            new, met, _ = step(st, batch, jax.random.PRNGKey(0))
            out.append(dict(loss=float(met["loss"]),
                            grads=_to_dicts(met["_grads"]),
                            stats=_to_dicts(new.batch_stats)))
    return v, out


def _port_pose_step(kind, v, batch, compute_dtype):
    port = POSE[kind][1](H, W, device="cpu")
    load_flax_variables(port, v)
    opt, _ = flagship_optimizer(port)
    met = tstate.make_train_step("cpu", compute_dtype=compute_dtype,
                                 with_grads=True)(port, opt, batch)
    stats = {k: t for k, t in port.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return dict(loss=float(met["loss"]), raw=met["_grads"],
                grads=to_flax(port, met["_grads"])["params"],
                stats=to_flax(port, stats)["batch_stats"])


def _pose_readings(kind):
    v, (ref_w, ref_s) = _jax_pose_steps(kind, [_pose_batch(True),
                                               _pose_batch(False)])
    out = {}
    for tag, batch, ref in (("white", _pose_batch(True), ref_w),
                            ("smooth", _pose_batch(False), ref_s)):
        got = _port_pose_step(kind, v, batch, "bfloat16")
        f32 = _port_pose_step(kind, v, batch, None)
        out[tag] = dict(got=got, ref=ref, f32=f32)
        rel = {k: abs(r["loss"] - ref["loss"]) / abs(ref["loss"])
               for k, r in (("bf16", got), ("f32", f32))}
        print(f"{kind} on {tag} textures: loss rel port bf16 "
              f"{rel['bf16']:.3e}, the port's f32 step (control) "
              f"{rel['f32']:.3e}; gradients (cosine, worst leaf): bf16 "
              f"{_grad_distance(got, ref)}, f32 {_grad_distance(f32, ref)};"
              f" BN statistics floor {_stats_floor_ulps(got, ref):.3f} bf16 "
              f"ulps (f32 {_stats_floor_ulps(f32, ref):.3f})")
    return out


@pytest.mark.parametrize("kind", sorted(POSE))
def test_pose_bf16_step_matches_jax(kind):
    out = _pose_readings(kind)
    w = out["white"]
    got, ref = w["got"], w["ref"]
    assert abs(got["loss"] - ref["loss"]) < 2e-2 * abs(ref["loss"])
    cos, worst, _ = _grad_distance(got, ref)
    assert cos > 0.8 and worst <= 1.0
    assert any(p[0] == "pose_backbone" for p, _ in _leaves(got["grads"]))
    for name, g in got["raw"].items():
        assert g.dtype == torch.float32, name
        assert torch.equal(g, g.to(BF).float()), name
    assert _stats_floor_ulps(got, ref) <= 3.0
    s = out["smooth"]
    rel, control = (abs(r["loss"] - s["ref"]["loss"]) / s["ref"]["loss"]
                    for r in (s["got"], s["f32"]))
    assert rel < 7e-2 <= control


if __name__ == "__main__":
    for kind in sorted(POSE):
        _pose_readings(kind)
