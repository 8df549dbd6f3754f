"""The port's depth-inference slice against the JAX flagship with the same
weights (carried by ``models.flax_convert``), on two JAX routes:

* ``xla``: the JAX package's CPU route at 64x96;
* ``tpu``: its shipped TPU route at 64x128, forced on the CPU as
  ``tests/test_multichip_kernel_route.py`` does (``jax.default_backend``
  reads "tpu", every ``pallas_call`` is interpreted), so the decoder's packed
  convs run the Pallas kernel ``conv3x3_fused_mats``.

The JAX side runs float32 at matmul precision "highest". Every BN
statistic, BN affine and conv bias is randomised so that a mapping that
swaps or drops a tensor shows. Tolerances: ('logits', s) within
1e-4 * max|logits|, depth within 1e-4 relative to max|depth|.
"""
import numpy as np
import pytest
import torch

import jax
import jax.experimental.pallas as pl

import __graft_entry__ as ge
from fsnet_tpu_torch.entry import flagship_model
from fsnet_tpu_torch.models.flax_convert import load_flax_variables
from fsnet_tpu_torch.runtime.state import make_eval_step

torch.set_num_threads(1)

ROUTES = {"xla": (64, 96), "tpu": (64, 128)}
B = 2


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


def _jax_run(H, W, calls):
    model = ge._flagship_model(H, W)
    rng = np.random.RandomState(0)
    img = rng.rand(B, H, W, 3).astype(np.float32)
    P2 = np.zeros((B, 3, 4), np.float32)
    P2[:, 0, 0] = P2[:, 1, 1] = 0.58 * W
    P2[:, 0, 2], P2[:, 1, 2], P2[:, 2, 2] = W / 2, H / 2, 1.0
    batch = {"image/0": img, "P2": P2}

    def depth_outputs(m, x):
        return m.head.forward_depth(m.depth_backbone(x, train=False),
                                    train=False)

    with jax.default_matmul_precision("highest"):
        v = jax.jit(lambda: model.init({"params": jax.random.PRNGKey(0)}, img,
                                       method=model.dummy_forward))()
        v = _to_dicts(_randomise(v, rng))
        calls.clear()                 # count the forwards only, not init
        outs = jax.jit(lambda v, x: model.apply(
            v, x, method=depth_outputs))(v, img)
        test = jax.jit(lambda v, b: model.apply(
            v, b, {"is_training": False}))(v, batch)
        dummy = jax.jit(lambda v, x: model.apply(
            v, x, method=model.dummy_forward))(v, img)
    return dict(variables=v, batch=batch,
                logits={s: np.asarray(outs[("logits", s)]) for s in range(4)},
                test=np.asarray(test["depth"]),
                dummy=np.asarray(dummy["depth"]))


@pytest.fixture(scope="module", params=sorted(ROUTES))
def route(request):
    H, W = ROUTES[request.param]
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        if request.param == "tpu":
            import fsnet_tpu.ops.pallas.conv_kernel as ck
            import fsnet_tpu.ops.pallas.prep_kernel as prk
            import fsnet_tpu.ops.pallas.warp_kernel as wk

            for mod in (ck, prk, wk):
                def patched(*args, _orig=pl.pallas_call, **kwargs):
                    kwargs["interpret"] = True
                    return _orig(*args, **kwargs)
                mp.setattr(mod.pl, "pallas_call", patched)
            fused = ck.conv3x3_fused_mats

            def counted(*args, **kwargs):
                calls.append(args[0].shape)
                return fused(*args, **kwargs)
            mp.setattr(ck, "conv3x3_fused_mats", counted)
            mp.setattr(jax, "default_backend", lambda: "tpu")
        ref = _jax_run(H, W, calls)
    port = flagship_model(H, W, device="cpu")
    load_flax_variables(port, ref["variables"])
    return dict(name=request.param, ref=ref, port=port, pallas_calls=calls)


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def test_logits_match(route):
    port, ref = route["port"], route["ref"]
    img = torch.from_numpy(ref["batch"]["image/0"])
    with torch.inference_mode():
        out = port.head.forward_depth(port.depth_backbone(img))
    for s in range(4):
        got = out[("logits", s)].numpy()
        assert got.shape == ref["logits"][s].shape
        assert _rel(got, ref["logits"][s]) <= 1e-4, s


def test_forward_test_matches(route):
    port, ref = route["port"], route["ref"]
    pred = make_eval_step("cpu")(port, ref["batch"])["depth"].numpy()
    assert pred.shape == ref["test"].shape
    assert _rel(pred, ref["test"]) <= 1e-4


def test_dummy_forward_matches(route):
    port, ref = route["port"], route["ref"]
    with torch.inference_mode():
        pred = port.dummy_forward(
            torch.from_numpy(ref["batch"]["image/0"]))["depth"].numpy()
    assert _rel(pred, ref["dummy"]) <= 1e-4


def test_tpu_route_ran_the_pallas_conv(route):
    if route["name"] != "tpu":
        assert route["pallas_calls"] == []
        return
    # three forwards (logits, forward_test, dummy_forward), each through
    # the packed decoder convs
    assert len(route["pallas_calls"]) > 0
    assert len(route["pallas_calls"]) % 3 == 0


def _features(H, W, rng):
    """Random encoder outputs of a ResNet-18 at HxW (NHWC)."""
    shapes = [(H // 2, W // 2, 64), (H // 4, W // 4, 64),
              (H // 8, W // 8, 128), (H // 16, W // 16, 256),
              (H // 32, W // 32, 512)]
    return [rng.rand(B, h, w, c).astype(np.float32) for h, w, c in shapes]


@pytest.mark.parametrize("variant", ["DepthDecoder", "MultiChannelDepthDecoder"])
def test_decoder_variant_matches(variant):
    """Both decoders with the fx-aware depth scale (base_fx set, P2 given)."""
    from fsnet_tpu.models.heads import depth_decoder as jdd
    from fsnet_tpu_torch.models.heads import depth_decoder as tdd

    rng = np.random.RandomState(5)
    H, W = 64, 96
    feats = _features(H, W, rng)
    P2 = np.zeros((B, 3, 4), np.float32)
    P2[:, 0, 0] = [300.0, 450.0]
    kw = dict(scales=(0, 1, 2, 3), min_depth=0.5, max_depth=100.0,
              base_fx=400.0,
              num_output_channels=1 if variant == "DepthDecoder" else 16)
    jdec = getattr(jdd, variant)(packed=False, **kw)
    with jax.default_matmul_precision("highest"):
        v = jax.jit(lambda f, p: jdec.init(jax.random.PRNGKey(0), f, p,
                                           train=False))(feats, P2)
        v = _to_dicts(_randomise(v, rng))
        ref = jax.jit(lambda v, f, p: jdec.apply(v, f, p, train=False))(
            v, feats, P2)
    tdec = getattr(tdd, variant)(**kw)
    load_flax_variables(tdec, v)
    with torch.inference_mode():
        got = tdec([torch.from_numpy(f) for f in feats], torch.from_numpy(P2))
    assert set(got) == set(ref)
    for key in ref:
        assert _rel(got[key].numpy(), np.asarray(ref[key])) <= 1e-4, key


def test_monodepth_inference_matches():
    from fsnet_tpu.models import MonoDepthInference as JInference
    from fsnet_tpu_torch.models import MonoDepthInference as TInference

    def cfgs(pkg):
        return dict(
            backbone_cfg=dict(name=f"{pkg}.models.backbones.resnet.resnet",
                              depth=18, out_indices=(-1, 0, 1, 2, 3)),
            depth_head_cfg=dict(
                name=f"{pkg}.models.heads.depth_decoder."
                     "MultiChannelDepthDecoder",
                min_depth=0.5, max_depth=100.0))

    rng = np.random.RandomState(6)
    img = rng.rand(B, 64, 96, 3).astype(np.float32)
    jm = JInference(**cfgs("fsnet_tpu"))
    with jax.default_matmul_precision("highest"):
        v = jax.jit(lambda: jm.init(jax.random.PRNGKey(0), img))()
        v = _to_dicts(_randomise(v, rng))
        ref = jax.jit(lambda v, x: jm.apply(
            v, x, method=jm.compute_teacher_depth))(v, img)
    tm = TInference(**cfgs("fsnet_tpu_torch"), device="cpu")
    load_flax_variables(tm, v)
    with torch.inference_mode():
        got = tm.compute_teacher_depth(torch.from_numpy(img))
    assert set(got) == set(ref)
    for key in ref:
        assert _rel(got[key].numpy(), np.asarray(ref[key])) <= 1e-4, key


def test_entry_runs_on_the_cpu_when_asked():
    from fsnet_tpu_torch.entry import entry

    fn, (image,) = entry(device="cpu")
    depth = fn(image)["depth"]
    assert depth.shape == (1, 192, 640, 1)
    assert torch.isfinite(depth).all()
    assert 0.5 <= float(depth.min()) and float(depth.max()) <= 100.0
