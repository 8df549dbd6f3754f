"""The port's DLA family (``fsnet_tpu_torch.models.backbones.dla`` and
``dla_utils``) against the JAX package, with the same weights: the port's
seeded weights, every BN statistic and affine, every deconv kernel (random,
not symmetric: the JAX deconv is a correlation, ``F.conv_transpose2d``
flips) and the perturbed offset convs carried to flax by
``models.flax_convert.to_flax``, whose tree must have the structure and
shapes of the JAX module's own init (``jax.eval_shape``). Both sides run
float64 (the JAX head cannot be initialised under x64, ROADMAP C; it is
never initialised here).

* ``dlanet`` 34/46/60/102/169 and a BottleneckX trunk at narrow widths: the
  train-mode forward (every level) and the updated BN statistics within
  1e-10.
* ``dlanet(34, channels=(4, 8, 8, 16, 16, 32))`` + ``DLASegUpsample``, 16
  deformable convs with offsets of about 1.5 px: the loss ``sum(out * r)``,
  the gradient of every parameter (1e-10 of each leaf's largest entry; the
  DCN biases that train-mode BN cancels and the projections a multi-level
  Tree computes and drops hold zero or rounding noise on both sides) and
  the updated BN statistics in train mode, then the eval forward.
* The bridge: flax -> port -> flax round trip, strict; the init of the
  offset convs and deconvs; ``entry.dla_model`` trains on the CPU.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fsnet_tpu.models.backbones import dla_utils as jdu
from fsnet_tpu.models.backbones.dla import dlanet as jax_dlanet
from fsnet_tpu_torch.entry import (DLAUpsampleNet, dla_batch, dla_model,
                                   flagship_optimizer, perturb_offsets)
from fsnet_tpu_torch.models import dlanet
from fsnet_tpu_torch.models.backbones.dla_utils import (
    ModulatedDeformConvPack, _GroupedDeconvUp)
from fsnet_tpu_torch.models.blocks import BatchNorm, init_params
from fsnet_tpu_torch.models.flax_convert import (flax_to_state_dict,
                                                 load_flax_variables, to_flax)
from fsnet_tpu_torch.ops import warp_fast as twf
from fsnet_tpu_torch.runtime.state import make_train_step

torch.set_num_threads(1)

NARROW = (4, 8, 8, 16, 16, 32)
TRUNKS = {
    "34": dict(depth=34), "46": dict(depth=46), "60": dict(depth=60),
    "102": dict(depth=102), "169": dict(depth=169),
    "46x": dict(depth=46, block="bottleneckx",
                channels=(4, 8, 32, 32, 32, 32)),
}


@pytest.fixture
def x64(monkeypatch):
    monkeypatch.setattr(twf, "_DTYPES", (torch.float64,))
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _randomise(model, seed):
    """Random BN affines and statistics, deconv kernels and DCN biases, so
    that a mapping that swaps, drops or flips a tensor shows."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                for t, lo, hi in ((m.weight, 0.5, 1.5), (m.bias, -0.2, 0.2),
                                  (m.running_mean, -0.2, 0.2),
                                  (m.running_var, 0.5, 1.5)):
                    t.copy_(torch.from_numpy(rng.uniform(lo, hi, t.shape)))
            elif isinstance(m, _GroupedDeconvUp) and m.f != 1:
                m.weight.copy_(torch.from_numpy(
                    rng.uniform(0, 1, m.weight.shape) / m.f ** 2))
            elif isinstance(m, ModulatedDeformConvPack):
                m.bias.copy_(torch.from_numpy(rng.uniform(-0.2, 0.2,
                                                          m.bias.shape)))
                m.conv_offset.bias.copy_(torch.from_numpy(
                    rng.uniform(-0.5, 0.5, m.conv_offset.bias.shape)))


def _shapes(tree):
    return {k: _shapes(v) if hasattr(v, "items") else tuple(np.shape(v))
            for k, v in tree.items()}


def _variables(port, jax_module, *args):
    """The port's weights as a flax tree, checked against the structure and
    shapes of the JAX module's own init."""
    tree = to_flax(port, port.state_dict())
    want = jax.eval_shape(lambda: jax_module.init(jax.random.PRNGKey(0),
                                                  *args, train=False))
    assert _shapes(tree) == _shapes(want)
    return tree


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def _rel(a, r):
    return float(np.abs(a - r).max() / np.abs(r).max())


def _stats(model):
    return {k: v for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


@pytest.mark.parametrize("name", sorted(TRUNKS))
def test_dlanet_forward_matches_jax_f64(x64, name):
    kw = dict(TRUNKS[name])
    kw.setdefault("channels", NARROW)
    depth = kw.pop("depth")
    port = dlanet(depth, **kw).double()
    init_params(port, torch.Generator().manual_seed(depth))
    _randomise(port, depth)
    jax_module = jax_dlanet(depth, **kw)
    x = np.random.RandomState(1).rand(2, 32, 32, 3)
    jax.config.update("jax_enable_x64", False)
    variables = _variables(port, jax_module, jnp.zeros((2, 32, 32, 3)))
    jax.config.update("jax_enable_x64", True)
    ref, upd = jax.jit(lambda v, x: jax_module.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, x)
    got = port(torch.from_numpy(x), train=True)
    assert len(got) == len(ref) == 7
    for g, r in zip(got, ref):
        assert g.shape == r.shape and _rel(g.detach().numpy(), r) <= 1e-10
    stats = dict(_flat(to_flax(port, _stats(port))))
    ref_stats = dict(_flat(upd))
    assert sorted(stats) == sorted(ref_stats)
    for k, r in ref_stats.items():
        assert _rel(stats[k], r) <= 1e-10, k


def _seg_port(seed=0):
    cfg = dict(
        trunk_cfg=dict(name="fsnet_tpu_torch.models.backbones.dla.dlanet",
                       depth=34, channels=NARROW, out_indices=range(6)),
        head_cfg=dict(
            name="fsnet_tpu_torch.models.backbones.dla_utils.DLASegUpsample",
            input_channels=NARROW, down_ratio=4, last_level=5))
    port = DLAUpsampleNet(**cfg).double()
    init_params(port, torch.Generator().manual_seed(seed))
    perturb_offsets(port, 1.5, seed)
    _randomise(port, seed)
    return port


def _bn_cancelled(key):
    """A DCN bias right before train-mode BN: its exact gradient is 0."""
    return key.endswith("conv/bias") and "/conv_offset/" not in key \
        and ("/proj_" in key or "/node_" in key)


def test_dla_seg_train_vjp_matches_jax_f64(x64):
    port = _seg_port()
    trunk = jax_dlanet(34, channels=NARROW, out_indices=tuple(range(6)))
    head = jdu.DLASegUpsample(input_channels=NARROW, down_ratio=4,
                              last_level=5)
    jax.config.update("jax_enable_x64", False)
    tv = _variables(port.trunk, trunk, jnp.zeros((2, 32, 64, 3)))
    feats = jax.eval_shape(lambda: trunk.apply(
        tv, jnp.zeros((2, 32, 64, 3)), train=False))
    hv = _variables(port.head, head, [jnp.zeros(f.shape) for f in feats])
    jax.config.update("jax_enable_x64", True)
    rng = np.random.RandomState(2)
    x, r = rng.rand(2, 32, 64, 3), rng.rand(2, 8, 16, NARROW[2])

    def loss(params, stats, x):
        f, tu = trunk.apply({"params": params[0], "batch_stats": stats[0]}, x,
                            train=True, mutable=["batch_stats"])
        o, hu = head.apply({"params": params[1], "batch_stats": stats[1]}, f,
                           train=True, mutable=["batch_stats"])
        return jnp.sum(o * r), (tu["batch_stats"], hu["batch_stats"])

    (ref_loss, ref_stats), ref_g = jax.jit(jax.value_and_grad(
        loss, has_aux=True))((tv["params"], hv["params"]),
                             (tv["batch_stats"], hv["batch_stats"]), x)
    ref_eval = jax.jit(lambda v, w, x: head.apply(w, trunk.apply(
        v, x, train=False), train=False))(tv, hv, x)

    with torch.no_grad():
        got_eval = port.dummy_forward(torch.from_numpy(x)).numpy()
    out = port.dummy_forward(torch.from_numpy(x), train=True)
    got_loss = (out * torch.from_numpy(r)).sum()
    names = [n for n, _ in port.named_parameters()]
    grads = torch.autograd.grad(got_loss, list(port.parameters()),
                                allow_unused=True)
    assert abs(got_loss.item() - float(ref_loss)) <= 1e-12 * abs(
        float(ref_loss))
    for part, ref_part, ref_st in ((port.trunk, ref_g[0], ref_stats[0]),
                                   (port.head, ref_g[1], ref_stats[1])):
        pre = "trunk." if part is port.trunk else "head."
        mine = {n[len(pre):]: (torch.zeros_like(p) if g is None else g)
                for n, p, g in zip(names, port.parameters(), grads)
                if n.startswith(pre)}
        got = dict(_flat(to_flax(part, mine)["params"]))
        want = dict(_flat(ref_part))
        assert sorted(got) == sorted(want)
        top = max(np.abs(w).max() for w in want.values())
        for k, w in want.items():
            if _bn_cancelled(k) or not np.any(w):
                assert np.abs(got[k]).max() <= 1e-10 * top, k
                assert np.abs(w).max() <= 1e-10 * top, k
            else:
                assert _rel(got[k], w) <= 1e-10, k
        stats = dict(_flat(to_flax(part, _stats(part))["batch_stats"]))
        for k, w in _flat(ref_st):
            assert _rel(stats[k], w) <= 1e-10, k
    zero = [k for k, g in zip(names, grads) if g is None]
    assert zero and all(".project_" in k for k in zero), zero
    assert _rel(got_eval, np.asarray(ref_eval)) <= 1e-10


def test_bridge_round_trip_is_strict():
    """flax -> port -> flax is the identity on a random tree of the JAX
    modules' structure (a non-symmetric deconv kernel, a grouped conv);
    a missing or surplus leaf raises."""
    rng = np.random.RandomState(3)
    port = _seg_port().float()
    bx = dlanet(46, block="bottleneckx", channels=(4, 8, 32, 32, 32, 32))
    for model in (port.trunk, port.head, bx):
        tree = jax.tree_util.tree_map(
            lambda a: rng.randn(*a.shape).astype(np.float32),
            to_flax(model, model.state_dict()))
        load_flax_variables(model, tree)
        back = dict(_flat(to_flax(model, model.state_dict())))
        want = dict(_flat(tree))
        assert sorted(back) == sorted(want)
        for k, w in want.items():
            assert np.array_equal(back[k], w), k
    for edit in ("drop", "add"):
        tree = to_flax(port.head, port.head.state_dict())
        ida = tree["params"]["dla_up"]["ida_0"]
        if edit == "drop":
            del ida["up_1"]
        else:
            ida["proj_1"]["conv"]["extra"] = np.zeros(3, np.float32)
        with pytest.raises(KeyError):
            flax_to_state_dict(port.head, tree)


def test_dla_init_follows_jax():
    """The offset convs start at zero (every DCN a plain conv with masks
    0.5), the DCN weight uniform in +-1/sqrt(K*K*Cin), the deconvs the JAX
    package's bilinear kernel."""
    port = DLAUpsampleNet(trunk_cfg=dict(
        name="fsnet_tpu_torch.models.backbones.dla.dlanet", depth=34,
        channels=NARROW, out_indices=range(6)), head_cfg=dict(
        name="fsnet_tpu_torch.models.backbones.dla_utils.DLASegUpsample",
        input_channels=NARROW))
    init_params(port, torch.Generator().manual_seed(0))
    dcns = [m for m in port.modules()
            if isinstance(m, ModulatedDeformConvPack)]
    ups = [m for m in port.modules() if isinstance(m, _GroupedDeconvUp)]
    assert len(dcns) == 16 and len(ups) == 8
    for m in dcns:
        assert not m.conv_offset.weight.any() and not m.conv_offset.bias.any()
        lim = 1 / np.sqrt(m.weight[..., 0].numel())
        assert 0.5 * lim < m.weight.abs().max().item() <= lim
    for m in ups:
        want = jdu._bilinear_upsample_kernel(m.f, m.weight.shape[-1])
        assert np.array_equal(m.weight.detach().numpy(), want)


def test_dla_model_trains_on_the_cpu():
    """``entry.dla_model`` at full width: the offsets spread by about 1.5
    px in train mode; three steps of the recipe through ``make_train_step``
    on the plain versions (no kernel launches) change every parameter a
    gradient reaches and every BN statistic."""
    model = dla_model(64, 128, device="cpu")
    batch = dla_batch(2, 64, 128)
    spread = []
    hooks = [m.register_forward_hook(lambda m, a, o: spread.append(
        m.conv_offset(a[0])[..., :18].detach().std().item()))
        for m in model.modules() if isinstance(m, ModulatedDeformConvPack)]
    opt, _ = flagship_optimizer(model)
    step = make_train_step("cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    n0 = (twf.grid_band_fwd.launches, twf.grid_band_bwd.launches)
    losses = [float(step(model, opt, batch)["loss"]) for _ in range(3)]
    for h in hooks:
        h.remove()
    assert (twf.grid_band_fwd.launches, twf.grid_band_bwd.launches) == n0
    assert len(spread) == 48 and 0.7 < float(np.mean(spread)) < 2.5
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    after = model.state_dict()
    same = [k for k in before if torch.equal(before[k], after[k])]
    assert all(".project_" in k for k in same), same
    out = model.forward_test(
        {"image/0": torch.from_numpy(batch["image/0"])}, {})["features"]
    assert out.shape == (2, 16, 32, 64) and bool(torch.isfinite(out).all())
