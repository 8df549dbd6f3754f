"""The port's self-distillation pieces against the JAX package's, on the
CPU, with the same (bridged) weights:

* ``MultiChannelDepthDecoderUncertain`` forward: float64 on the JAX XLA
  route (every output within 1e-10 of max |ref|), with and without
  ``base_fx``; float32 with JAX's Pallas conv forced (``jax.default_backend``
  reads "tpu", every ``pallas_call`` interpreted, as
  ``tests/test_torch_slice.py`` forces it; within 1e-4 of max |ref|), the
  test proving that ``conv3x3_fused_mats`` ran;
* ``MonoDepth2Decoder.compute_distill_loss`` in its four branches
  (``is_unscaled_distill`` x ``is_uncertain_distill``), value and gradients
  in float64 (1e-12 rel);
* the teacher surgery (``runtime.checkpoint``): a ``MonoDepthWPose``'s
  tensors transformed and grafted under ``teacher_net`` equal the JAX
  package's ``transform_teacher_params`` / ``load_teacher_into_params`` on
  the same trees, leaf by leaf (both collections: a state_dict carries the
  BN statistics with the parameters);
* the frozen mask (``runtime.optim``): ``frozen_param_prefixes`` equal to
  JAX's, and ``build_frozen_mask`` freezing the same leaves, for the
  ``distill_nusc`` config and a learned-pose config with ``frozen_stages``
  2 (depth) and 1 (pose); the recipe's optimizer leaves the frozen
  parameters out;
* the ``DistillWPoseMeta`` bridge round trip (``to_flax`` of the loaded
  model gives back every JAX leaf) and the student's ``forward_test`` in
  float64 (1e-10 of max |ref|).
"""
import numpy as np
import pytest
import torch

import jax
import jax.experimental.pallas as pl

from fsnet_tpu_torch.entry import (NUSC_RECIPE, distill_config,
                                   distill_model, flagship_model,
                                   learned_pose_config, learned_pose_model,
                                   nusc_batch, recipe_optimizer)
from fsnet_tpu_torch.models.flax_convert import (flax_path,
                                                 load_flax_variables, to_flax)
from fsnet_tpu_torch.ops import conv3x3 as tc
from fsnet_tpu_torch.runtime import checkpoint as tck
from fsnet_tpu_torch.runtime import optim as topt
from fsnet_tpu_torch.runtime.state import make_eval_step

torch.set_num_threads(1)

B, H, W = 2, 64, 128


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


def _jax_names(cfg):
    if isinstance(cfg, dict):
        return {k: _jax_names(v) for k, v in cfg.items()}
    if isinstance(cfg, str):
        return cfg.replace("fsnet_tpu_torch.", "fsnet_tpu.")
    return cfg


@pytest.fixture
def f64_convs(monkeypatch):
    """The conv wrappers take float32 and bfloat16; their plain versions,
    which they run on the CPU, are written for any float type."""
    monkeypatch.setitem(tc._DTYPES, torch.float64, -1)


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(
        np.asarray(b)).max()


def _features(rng, dtype=np.float32):
    """Random ResNet-18 encoder outputs at H x W (NHWC)."""
    shapes = [(H // 2, W // 2, 64), (H // 4, W // 4, 64),
              (H // 8, W // 8, 128), (H // 16, W // 16, 256),
              (H // 32, W // 32, 512)]
    return [rng.rand(B, h, w, c).astype(dtype) for h, w, c in shapes]


def _init(model, *args, method=None, seed=0):
    """Randomised variables of a JAX module (numpy, float32)."""
    with jax.default_matmul_precision("highest"):
        v = jax.jit(lambda *a: model.init(jax.random.PRNGKey(0), *a,
                                          method=method))(*args)
    return _to_dicts(_randomise(v, np.random.RandomState(seed)))


def _cast(tree, dtype):
    return jax.tree.map(lambda a: np.asarray(a, dtype), tree)


# ------------------------------------------- MultiChannelDepthDecoderUncertain

def _decoders(base_fx, packed=None):
    from fsnet_tpu.models.heads import depth_decoder as jdd
    from fsnet_tpu_torch.models.heads import depth_decoder as tdd

    kw = dict(scales=(0, 1, 2, 3), min_depth=0.5, max_depth=100.0,
              num_output_channels=16, base_fx=base_fx)
    return (jdd.MultiChannelDepthDecoderUncertain(packed=packed, **kw),
            tdd.MultiChannelDepthDecoderUncertain(**kw))


def _P2(dtype):
    P2 = np.zeros((B, 3, 4), dtype)
    P2[:, 0, 0] = [300.0, 450.0]
    return P2


def _check_outputs(got, ref, tol):
    assert set(got) == set(ref)
    assert not any(k[0] == "logits" for k in got)
    for key in ref:
        r = np.asarray(ref[key])
        g = got[key].detach().numpy()
        assert g.shape == r.shape, key
        assert _rel(g, r) <= tol, (key, _rel(g, r))


@pytest.mark.parametrize("base_fx", [None, 400.0])
def test_uncertain_decoder_matches_jax_f64(base_fx, f64_convs):
    rng = np.random.RandomState(5)
    feats = _features(rng, np.float64)
    jdec, tdec = _decoders(base_fx, packed=False)
    v = _init(jdec, _features(np.random.RandomState(1)), _P2(np.float32),
              seed=2)
    jax.config.update("jax_enable_x64", True)
    try:
        ref = jax.jit(lambda v, f, p: jdec.apply(v, f, p, train=False))(
            _cast(v, np.float64), feats, _P2(np.float64))
    finally:
        jax.config.update("jax_enable_x64", False)
    load_flax_variables(tdec, v)
    tdec = tdec.double()
    with torch.inference_mode():
        got = tdec([torch.from_numpy(f) for f in feats],
                   torch.from_numpy(_P2(np.float64)))
    _check_outputs(got, ref, 1e-10)
    # one scope per JAX scope: the strict bridge filled every tensor, and
    # the uncertainty convs are one channel wide
    for i in range(4):
        assert tuple(getattr(tdec, f"uncertain_logz_{i}").conv.weight.shape
                     ) == (3, 3, (16, 32, 64, 128)[i], 1)


def test_uncertain_decoder_matches_forced_pallas_conv():
    import fsnet_tpu.ops.pallas.conv_kernel as ck

    rng = np.random.RandomState(6)
    feats = _features(rng)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        def patched(*args, _orig=pl.pallas_call, **kwargs):
            kwargs["interpret"] = True
            return _orig(*args, **kwargs)
        mp.setattr(ck.pl, "pallas_call", patched)
        fused = ck.conv3x3_fused_mats

        def counted(*args, **kwargs):
            calls.append(args[0].shape)
            return fused(*args, **kwargs)
        mp.setattr(ck, "conv3x3_fused_mats", counted)
        mp.setattr(jax, "default_backend", lambda: "tpu")
        jdec, tdec = _decoders(None)
        v = _init(jdec, feats, None, seed=3)
        calls.clear()                 # count the forward only, not init
        with jax.default_matmul_precision("highest"):
            ref = jax.jit(lambda v, f: jdec.apply(v, f, train=False))(
                v, feats)
    assert len(calls) > 0
    load_flax_variables(tdec, v)
    with torch.inference_mode():
        got = tdec([torch.from_numpy(f) for f in feats])
    _check_outputs(got, ref, 1e-4)


# ------------------------------------------------------ compute_distill_loss

@pytest.mark.parametrize("unscaled", [False, True])
@pytest.mark.parametrize("uncertain", [False, True])
def test_compute_distill_loss_matches_jax(unscaled, uncertain):
    from fsnet_tpu.models.heads.monodepth2_decoder import \
        MonoDepth2Decoder as JHead
    from fsnet_tpu_torch.models.heads.monodepth2_decoder import \
        MonoDepth2Decoder as THead

    rng = np.random.RandomState(7)
    h, w, s = 8, 16, 1
    pred = 0.5 + 60.0 * rng.rand(B, h, w, 1)
    teacher = 0.5 + 60.0 * rng.rand(B, h, w, 1)
    z = 1.0 / (1.0 + np.exp(-rng.randn(B, h, w, 1)))
    flags = dict(is_unscaled_distill=unscaled,
                 is_uncertain_distill=uncertain, distillation_loss_weight=0.3)
    dec_cfg = dict(name="MultiChannelDepthDecoder")
    jhead = JHead(depth_decoder_cfg=dict(
        dec_cfg, name="fsnet_tpu.models.heads.depth_decoder."
                      "MultiChannelDepthDecoder"), **flags)
    thead = THead(depth_decoder_cfg=dict(
        dec_cfg, name="fsnet_tpu_torch.models.heads.depth_decoder."
                      "MultiChannelDepthDecoder"), **flags)

    def outputs(p, t, u, wrap):
        return {("depth", s, s): wrap(p), ("teacher_depth", s, s): wrap(t),
                ("uncertain_z", s): wrap(u)}

    jax.config.update("jax_enable_x64", True)
    try:
        def jloss(p, t, u):
            return jhead.apply({}, outputs(p, t, u, lambda a: a), {}, s,
                               method=jhead.compute_distill_loss)
        ref, ref_g = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
            pred, teacher, z)
    finally:
        jax.config.update("jax_enable_x64", False)
    args = [torch.from_numpy(a).requires_grad_() for a in (pred, teacher, z)]
    got = thead.compute_distill_loss(outputs(*args, lambda a: a), {}, s)
    got.backward()
    assert abs(got.item() - float(ref)) <= 1e-12 * abs(float(ref))
    for a, r, what in zip(args, ref_g, ("student", "teacher", "z")):
        r = np.asarray(r)
        if what == "teacher" or (what == "z" and not uncertain):
            assert not np.any(r) and (a.grad is None or not a.grad.any())
            continue
        assert _rel(a.grad.numpy(), r) <= 1e-12, what


def test_distillation_weight_no_longer_raises_other_branches_do():
    cfg = distill_config(H, W)
    model = distill_model(H, W, device="cpu")
    head = model.head
    head._check_branch({}, {})                 # distillation: ported
    for key in head.unported:
        head.unported[key] = True
        with pytest.raises(NotImplementedError, match=key):
            head._check_branch({}, {})
        head.unported[key] = False
    assert cfg["head_cfg"]["distillation_loss_weight"] == 0.3


# ----------------------------------------------------------------- the models

@pytest.fixture(scope="module")
def jax_distill():
    """The JAX ``DistillWPoseMeta`` of the port's ``distill_config`` and its
    randomised variables, teacher included."""
    from fsnet_tpu.utils.builder import build

    model = build(**_jax_names(distill_config(H, W)))
    img = np.random.RandomState(0).rand(B, H, W, 3).astype(np.float32)

    def init_all(m, x):
        m.teacher_net(x)
        return m.dummy_forward(x)
    return model, _init(model, img, method=init_all, seed=4)


def test_teacher_surgery_matches_jax(jax_distill):
    from fsnet_tpu.runtime.checkpoint import (load_teacher_into_params,
                                              transform_teacher_params)

    _, dvars = jax_distill
    wpose = flagship_model(H, W, device="cpu", seed=1)
    wvars = to_flax(wpose, wpose.state_dict())
    ref = {c: load_teacher_into_params(dvars[c],
                                       transform_teacher_params(wvars[c]))
           for c in ("params", "batch_stats")}
    student = distill_model(H, W, device="cpu")
    load_flax_variables(student, dvars)
    teacher = tck.transform_teacher_params(wpose.state_dict())
    assert sorted(teacher) == sorted(
        k.replace("head.depth_decoder.", "depth_decoder.")
        for k in wpose.state_dict()
        if k.startswith(("depth_backbone.", "head.depth_decoder.")))
    grafted = tck.load_teacher_into_params(student.state_dict(), teacher)
    got = to_flax(student, grafted)
    for c in ("params", "batch_stats"):
        r, g = dict(_flat(ref[c])), dict(_flat(got[c]))
        assert sorted(g) == sorted(r)
        for path in r:
            assert np.array_equal(g[path], np.asarray(r[path])), path
        moved = [p for p in r if p[0] == "teacher_net"
                 and not np.array_equal(r[p], dict(_flat(dvars[c]))[p])]
        assert moved, c                        # the teacher was replaced
    # graft_teacher loads the same tensors in place
    tck.graft_teacher(student, wpose.state_dict())
    for k, v in grafted.items():
        assert torch.equal(student.state_dict()[k], v), k


def _mask_paths(model, mask):
    return sorted(flax_path(model, n)[1] for n, f in mask.items() if f)


def _jax_mask_paths(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return sorted(tuple(str(getattr(p, "key", p)) for p in path)
                  for path, v in leaves if v)


def test_frozen_mask_matches_jax_distill(jax_distill):
    from fsnet_tpu.runtime.optim import (build_frozen_mask,
                                         frozen_param_prefixes)

    _, dvars = jax_distill
    cfg = distill_config(H, W)
    prefixes = topt.frozen_param_prefixes(cfg)
    assert prefixes == list(frozen_param_prefixes(_jax_names(cfg))) == [
        ("teacher_net",)]
    model = distill_model(H, W, device="cpu")
    mask = topt.build_frozen_mask(model, prefixes)
    ref = _jax_mask_paths(build_frozen_mask(dvars["params"], prefixes))
    assert _mask_paths(model, mask) == ref
    assert all(p[0] == "teacher_net" for p in ref) and len(ref) > 100
    # the recipe's optimizer: the teacher out, requires_grad off
    opt, _ = recipe_optimizer(model, NUSC_RECIPE, cfg)
    ids = {id(p) for p in opt.params}
    for n, p in model.named_parameters():
        assert (id(p) in ids) == (not mask[n]) == p.requires_grad, n


def test_frozen_mask_matches_jax_frozen_stages():
    from fsnet_tpu.runtime.optim import (build_frozen_mask,
                                         frozen_param_prefixes)
    from fsnet_tpu.utils.builder import build

    cfg = learned_pose_config(H, W)
    cfg["depth_backbone_cfg"]["frozen_stages"] = 2
    cfg["pose_backbone_cfg"]["frozen_stages"] = 1
    prefixes = topt.frozen_param_prefixes(cfg)
    assert prefixes == list(frozen_param_prefixes(_jax_names(cfg)))
    jmodel = build(**_jax_names(cfg))
    img = jax.ShapeDtypeStruct((B, H, W, 3), np.float32)

    def init_all(m, x):
        m.head.forward_pose([m.pose_backbone(
            jax.numpy.concatenate([x, x], axis=-1), train=False)])
        return m.dummy_forward(x)
    shapes = jax.eval_shape(lambda x: jmodel.init(
        jax.random.PRNGKey(0), x, method=init_all), img)
    ref = _jax_mask_paths(build_frozen_mask(shapes["params"], prefixes))
    model = learned_pose_model(H, W, device="cpu")
    mask = topt.build_frozen_mask(model, prefixes)
    assert _mask_paths(model, mask) == ref
    scopes = {p[:2] for p in ref}
    assert ("depth_backbone", "layer2_1") in scopes
    assert ("pose_backbone", "layer1_0") in scopes
    assert not any(p[1].startswith(("layer3_", "layer4_")) for p in ref)
    assert not any(p[0] == "pose_backbone" and p[1].startswith("layer2_")
                   for p in ref)
    opt, _ = recipe_optimizer(model, NUSC_RECIPE, cfg)
    assert len(opt.params) == sum(not f for f in mask.values())


def test_distill_bridge_round_trip(jax_distill):
    _, dvars = jax_distill
    model = distill_model(H, W, device="cpu")
    load_flax_variables(model, dvars)
    back = to_flax(model, model.state_dict())
    for c in ("params", "batch_stats"):
        r, g = dict(_flat(dvars[c])), dict(_flat(back[c]))
        assert sorted(g) == sorted(r)
        for path in r:
            assert np.array_equal(g[path], r[path]), path
    scopes = {p[:3] for p in dict(_flat(dvars["params"]))}
    for want in (("teacher_net", "depth_backbone", "conv1"),
                 ("teacher_net", "depth_decoder", "trunk"),
                 ("head", "depth_decoder", "uncertain_logz_0")):
        assert want in scopes, want


def test_student_forward_test_matches_jax_f64(jax_distill, f64_convs):
    jmodel, dvars = jax_distill
    batch = {k: v.astype(np.float64) for k, v in nusc_batch(B, H, W).items()
             if k in ("image/0", "P2")}
    jax.config.update("jax_enable_x64", True)
    try:
        ref = jax.jit(lambda v, b: jmodel.apply(
            v, b, {"is_training": False}))(_cast(dvars, np.float64), batch)
    finally:
        jax.config.update("jax_enable_x64", False)
    model = distill_model(H, W, device="cpu")
    load_flax_variables(model, dvars)
    model = model.double()
    got = make_eval_step("cpu")(model, batch)["depth"].numpy()
    assert got.shape == (B, H, W, 1)
    assert _rel(got, ref["depth"]) <= 1e-10
