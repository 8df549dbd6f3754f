"""The port's training loop on the CPU, at the smoke config's 64x96 and
bs4:

* two steps of the port's ``BaseTrainingHook`` against the JAX package's
  hook in float64 on the loader's batches: the weights go across through
  the converter (``to_flax``), and the noise the JAX step drew
  (``jax.random.normal`` in its head, read back by a debug callback) is
  handed to the port's step. Each step's loss within 1e-10 rel (2.8e-14
  measured when this test was written; the port's step without the noise
  missed JAX's by 1.0e-6, so the bound sees the noise), and after each
  step every parameter leaf within 1e-4 of its largest entry, except
  the conv biases that train-mode BN cancels: their exact gradient is 0,
  both sides hold rounding noise there and Adam turns it into steps of up
  to lr either way, so they are held to |step| <= lr each;
* the hook's own noise: [F, B, H, W], a function of the seed and the global
  step, different at each step;
* ``train.main(device="cpu")`` on the port's smoke config: 3 steps,
  ``_latest`` written, reloaded bitwise (parameters, BN statistics, Adam's
  moments and count) into a fresh model, in place under the bf16 step's
  flat parameter buffer; a resumed run restores the epoch, the count and
  the learning rate (``schedule(count)`` at its first update), also on the
  bf16 step; ``test.main`` evaluates the checkpoint;
* the pretrained graft of a fake torchvision ResNet-18 file of random
  tensors against the JAX package's converter; a distillation teacher
  loaded from a port checkpoint file against ``graft_teacher``;
* the port's config copies against the shipped configs.
"""
import os

import numpy as np
import pytest
import torch

import jax

from fsnet_tpu_torch import entry
from fsnet_tpu_torch.data.dataloader import build_dataloader
from fsnet_tpu_torch.models.flax_convert import to_flax
from fsnet_tpu_torch.ops import conv3x3 as tc
from fsnet_tpu_torch.ops import photo_loss as tpl
from fsnet_tpu_torch.ops import warp_depth as twd
from fsnet_tpu_torch.ops import warp_fast as twf
from fsnet_tpu_torch.pipeline_hooks.train_val_hooks import BaseTrainingHook
from fsnet_tpu_torch.runtime import checkpoint as ck
from fsnet_tpu_torch.runtime import optim as topt
from fsnet_tpu_torch.runtime.pretrained import graft_pretrained_backbones
from fsnet_tpu_torch.runtime.state import make_train_step
from fsnet_tpu_torch.scripts import test as test_script
from fsnet_tpu_torch.scripts import train as train_script
from fsnet_tpu_torch.utils import build, cfg_from_file

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "fsnet_tpu_torch", "configs")
SMOKE = os.path.join(CONFIGS, "synthetic_smoke_example.py")
LR = 1e-4


def _float64(batch):
    return {k: v.astype(np.float64) if isinstance(v, np.ndarray)
            and v.dtype.kind == "f" else v for k, v in batch.items()}


def _flat(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flat(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def _bn_cancelled(path):
    """Conv biases of the decoder's ConvBnReLU blocks (upconv_*/conv)."""
    return (path[-1] == "bias" and len(path) >= 3 and path[-2] == "conv"
            and path[-3].startswith("upconv_"))


def test_training_hook_matches_jax(monkeypatch):
    from fsnet_tpu.pipeline_hooks.train_val_hooks import \
        BaseTrainingHook as JaxHook
    from fsnet_tpu.runtime.optim import build_optimizer
    from fsnet_tpu.runtime.state import TrainState
    from fsnet_tpu.utils import LossLogger as JaxLogger
    from fsnet_tpu.utils import build as jax_build
    from fsnet_tpu.utils import cfg_from_file as jax_cfg

    cfg = cfg_from_file(SMOKE)
    loader = build_dataloader(build(**cfg.train_dataset), num_workers=0,
                              batch_size=cfg.data.batch_size)
    batches = [_float64(b) for _, b in zip(range(2), iter(loader))]

    port = build(**cfg.meta_arch, device="cpu", seed=3).double()
    opt, _ = entry.recipe_optimizer(
        port, dict(optimizer=cfg.optimizer, scheduler=cfg.scheduler,
                   clip_gradients=1.0), cfg.meta_arch, steps_per_epoch=3)
    variables = to_flax(port, port.state_dict())

    noise = []
    normal = jax.random.normal

    def recorded(key, shape=(), dtype=float, *args, **kwargs):
        out = normal(key, shape, dtype, *args, **kwargs)
        if len(shape) == 4:
            jax.debug.callback(lambda x: noise.append(np.array(x)), out)
        return out

    jcfg = jax_cfg(os.path.join(REPO, "configs",
                                "synthetic_smoke_example.py"))
    monkeypatch.setattr(jax.random, "normal", recorded)
    jax.config.update("jax_enable_x64", True)
    try:
        tx, _ = build_optimizer(dict(jcfg.optimizer), dict(jcfg.scheduler),
                                steps_per_epoch=3, clip_gradients=1.0)
        state = TrainState.create(
            apply_fn=jax_build(**jcfg.meta_arch).apply,
            params=variables["params"],
            batch_stats=variables["batch_stats"], tx=tx)
        jax_hook = JaxHook(**jcfg.trainer.training_hook)
        rng = jax.random.PRNGKey(43)
        refs = []
        with jax.default_matmul_precision("highest"):
            for batch in batches:
                logger = JaxLogger()
                state = jax_hook(batch, state, rng,
                                 training_loss_logger=logger)
                jax.effects_barrier()
                refs.append((logger.loss_stats["total_loss"].val,
                             jax.tree.map(np.asarray, state.params)))
    finally:
        jax.config.update("jax_enable_x64", False)
    assert len(noise) == 2 and noise[0].shape == (2, 4, 64, 96)
    assert not np.array_equal(noise[0], noise[1])

    for mod in (twd, twf, tpl):
        monkeypatch.setattr(mod, "_DTYPES", (torch.float64,))
    monkeypatch.setitem(tc._DTYPES, torch.float64, -1)
    hook = BaseTrainingHook(**cfg.trainer.training_hook, device="cpu")
    given = iter(torch.from_numpy(n) for n in noise)
    monkeypatch.setattr(hook, "noise", lambda model, data, step: next(given))
    init = {n: p.detach().clone() for n, p in port.named_parameters()}
    for step, (batch, (ref_loss, ref_params)) in enumerate(zip(batches,
                                                               refs)):
        loss = float(hook(batch, port, opt, global_step=step)["loss"])
        assert abs(loss - ref_loss) <= 1e-10 * abs(ref_loss), (step, loss,
                                                               ref_loss)
        got = dict(_flat(to_flax(port, dict(port.named_parameters()))[
            "params"]))
        start = dict(_flat(to_flax(port, init)["params"]))
        for path, ref in _flat(ref_params):
            g = got[path]
            if _bn_cancelled(path):
                bound = LR * (step + 1) * (1 + 1e-6)
                assert np.abs(g - start[path]).max() <= bound, path
                assert np.abs(ref - start[path]).max() <= bound, path
                continue
            err = np.abs(g - ref).max() / np.abs(ref).max()
            assert err <= 1e-4, (step, path, err)


def test_hook_noise_per_step():
    model = entry.flagship_model(64, 96, device="cpu")
    batch = {"image/0": np.zeros((3, 64, 96, 3), np.float32)}
    hook = BaseTrainingHook(device="cpu", seed=7)
    a, b = hook.noise(model, batch, 0), hook.noise(model, batch, 1)
    assert a.shape == (2, 3, 64, 96) and a.dtype == torch.float32
    assert not torch.equal(a, b)
    assert torch.equal(a, BaseTrainingHook(device="cpu", seed=7).noise(
        model, batch, 0))
    assert not torch.equal(a, BaseTrainingHook(device="cpu", seed=8).noise(
        model, batch, 0))
    assert abs(float(a.std()) - 1.0) < 0.05


@pytest.fixture
def no_writer(monkeypatch):
    monkeypatch.setattr(train_script, "_writer", lambda *args: None)


def _fresh(cfg, steps_per_epoch=3, compute_dtype=None):
    model = build(**cfg.meta_arch, device="cpu", seed=11)
    opt, schedule = entry.recipe_optimizer(
        model, dict(optimizer=cfg.optimizer, scheduler=cfg.scheduler,
                    clip_gradients=1.0), cfg.meta_arch,
        steps_per_epoch=steps_per_epoch)
    return model, opt, schedule


def _lrs(monkeypatch):
    """(count, lr) of every Adam update from here on."""
    seen = []
    step = topt.Adam.step

    def recorded(self, grads):
        seen.append((self.count, self.schedule(self.count)))
        return step(self, grads)
    monkeypatch.setattr(topt.Adam, "step", recorded)
    return seen


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_main_saves_reloads_resumes(tmp_path, monkeypatch, no_writer,
                                          dtype):
    over = {"path.checkpoint_path": str(tmp_path / "a"),
            "trainer.disp_iter": 1, "scheduler.step_size": 1,
            "trainer.training_hook.compute_dtype": dtype}
    lrs = _lrs(monkeypatch)
    out = train_script.main(config=SMOKE, device="cpu", **over)
    assert out["epoch"] == 1 and out["global_step"] == 3
    assert [e["step"] for e in out["log"]] == [1, 2, 3]
    assert all(np.isfinite(e["loss"]) for e in out["log"])
    assert [c for c, _ in lrs] == [0, 1, 2]
    latest = tmp_path / "a" / "MonoDepthWPose_latest.pth"
    assert latest.exists() and (tmp_path / "a" / "MonoDepthWPose_0.pth"
                                ).exists()
    assert out["checkpoint"] == str(latest)

    # bitwise reload into a fresh model, in place under the bf16 step's
    # flat parameter buffer
    cfg = cfg_from_file(SMOKE)
    model, opt, _ = _fresh(cfg)
    step = make_train_step("cpu", compute_dtype="bfloat16")
    batch = next(iter(build_dataloader(build(**cfg.train_dataset),
                                       num_workers=0, batch_size=2)))
    step(model, opt, batch)
    params = list(opt.params)
    assert ck.load_models(str(latest), model, opt, strict=True) == 1
    assert opt.count == 3 and all(p is q for p, q in zip(opt.params, params))
    for k, v in out["model"].state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    for mine, theirs in ((opt.mu, out["optimizer"].mu),
                         (opt.nu, out["optimizer"].nu)):
        assert all(torch.equal(a, b) for a, b in zip(mine, theirs))
    # still views of the step's one flat buffer
    assert len({p.untyped_storage().data_ptr() for p in opt.params}) == 1
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step(model, opt, batch)               # the optimizer moves the model
    moved = sum(not torch.equal(p, before[n])
                for n, p in model.named_parameters())
    assert moved >= len(before) - 10 and opt.count == 4

    # resume: one more epoch from _latest
    lrs.clear()
    out2 = train_script.main(
        config=SMOKE, device="cpu", **dict(
            over, **{"path.checkpoint_path": str(tmp_path / "b"),
                     "path.pretrained_checkpoint": str(latest),
                     "trainer.max_epochs": 2}))
    assert out2["epoch"] == 2 and out2["global_step"] == 6
    assert [e["step"] for e in out2["log"]] == [4, 5, 6]
    assert lrs[0] == (3, out2["schedule"](3)) and lrs[0][1] == pytest.approx(
        LR * 0.1)
    assert [c for c, _ in lrs] == [3, 4, 5]

    res = test_script.main(config=SMOKE, checkpoint=str(latest),
                           device="cpu")
    assert res["samples"] == 4 and res["epoch"] == 1
    assert 0.5 <= res["min"] <= res["mean"] <= res["max"] <= 100.0


def test_evaluate_hook_raises(tmp_path, no_writer):
    with pytest.raises(NotImplementedError, match="evaluat"):
        train_script.main(config=SMOKE, device="cpu", **{
            "trainer.evaluate_hook": {"name": "x.KittiEvaluationHook"},
            "path.checkpoint_path": str(tmp_path)})


def _fake_resnet18(rng):
    """A torchvision ResNet-18 state_dict of random tensors."""
    sd = {}

    def bn(name, c):
        sd[f"{name}.weight"] = torch.from_numpy(rng.rand(c) + 0.5).float()
        sd[f"{name}.bias"] = torch.from_numpy(rng.randn(c)).float()
        sd[f"{name}.running_mean"] = torch.from_numpy(rng.randn(c)).float()
        sd[f"{name}.running_var"] = torch.from_numpy(rng.rand(c) + 0.5
                                                     ).float()
        sd[f"{name}.num_batches_tracked"] = torch.tensor(7)

    def conv(name, o, i, k):
        sd[f"{name}.weight"] = torch.from_numpy(rng.randn(o, i, k, k)).float()

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    inplanes = 64
    for s, planes in enumerate((64, 128, 256, 512), start=1):
        for b in range(2):
            t = f"layer{s}.{b}"
            conv(f"{t}.conv1", planes, inplanes if b == 0 else planes, 3)
            bn(f"{t}.bn1", planes)
            conv(f"{t}.conv2", planes, planes, 3)
            bn(f"{t}.bn2", planes)
            if b == 0 and s > 1:
                conv(f"{t}.downsample.0", planes, inplanes, 1)
                bn(f"{t}.downsample.1", planes)
        inplanes = planes
    sd["fc.weight"] = torch.from_numpy(rng.randn(1000, 512)).float()
    sd["fc.bias"] = torch.from_numpy(rng.randn(1000)).float()
    return sd


def test_pretrained_graft_matches_jax(tmp_path, monkeypatch):
    from fsnet_tpu.models.torch_convert import convert_resnet_state_dict

    sd = _fake_resnet18(np.random.RandomState(0))
    torch.save(sd, tmp_path / "resnet18-f37072fd.pth")
    monkeypatch.setenv("FSNET_PRETRAINED_DIR", str(tmp_path))
    model = entry.learned_pose_model(64, 96, device="cpu")
    cfg = entry.learned_pose_config(64, 96)
    cfg["depth_backbone_cfg"]["pretrained"] = True
    cfg["pose_backbone_cfg"]["pretrained_path"] = str(
        tmp_path / "resnet18-f37072fd.pth")
    assert graft_pretrained_backbones(model, cfg, verbose=False) == [
        "depth_backbone", "pose_backbone"]
    numpy_sd = {k: v.numpy() for k, v in sd.items()}
    for scope, images in (("depth_backbone", 1), ("pose_backbone", 2)):
        got = to_flax(model, {k: v for k, v in model.state_dict().items()
                              if k.startswith(scope + ".")})
        ref_p, ref_s = convert_resnet_state_dict(numpy_sd,
                                                 num_input_images=images)
        for coll, ref in (("params", ref_p), ("batch_stats", ref_s)):
            g = dict(_flat(got[coll][scope]))
            r = dict(_flat(ref))
            assert sorted(g) == sorted(r), scope
            for path in r:
                np.testing.assert_array_equal(g[path], r[path],
                                              err_msg=str((scope, path)))

    monkeypatch.setenv("FSNET_PRETRAINED_DIR", str(tmp_path / "none"))
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "none"))
    with pytest.raises(FileNotFoundError):
        graft_pretrained_backbones(model, entry.flagship_config(64, 96) | {
            "depth_backbone_cfg": dict(cfg["depth_backbone_cfg"],
                                       pretrained_path="")})
    with pytest.raises(NotImplementedError):
        graft_pretrained_backbones(model, {"depth_backbone_cfg": dict(
            name="fsnet_tpu_torch.models.backbones.dla.dlanet",
            pretrained=True)})


def test_teacher_from_checkpoint_file(tmp_path):
    wpose = entry.flagship_model(64, 128, device="cpu", seed=5)
    path = tmp_path / "wpose_latest.pth"
    ck.save_models(str(path), wpose, epoch=3)
    from_file = ck.load_teacher(entry.distill_model(64, 128, device="cpu"),
                                str(path))
    grafted = ck.graft_teacher(entry.distill_model(64, 128, device="cpu"),
                               wpose.state_dict())
    ref = grafted.state_dict()
    got = from_file.state_dict()
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    teacher = ck.transform_teacher_params(wpose.state_dict())
    assert len(teacher) == sum(k.startswith("teacher_net.") for k in got)
    for k, v in teacher.items():
        assert torch.equal(got["teacher_net." + k], v), k


def _plain(node):
    """A config tree as plain dicts and lists, the port's names read as the
    JAX package's."""
    if isinstance(node, dict):
        return {k: _plain(v) for k, v in node.items()}
    if isinstance(node, (list, tuple, np.ndarray)):
        return [_plain(v) for v in list(node)]
    if isinstance(node, str):
        return node.replace("fsnet_tpu_torch.", "fsnet_tpu.")
    return node


def test_config_copies_match_shipped():
    from fsnet_tpu.utils import cfg_from_file as jax_cfg

    got = _plain(cfg_from_file(SMOKE))
    ref = _plain(jax_cfg(os.path.join(REPO, "configs",
                                      "synthetic_smoke_example.py")))
    for key in ("trainer", "optimizer", "scheduler", "data", "train_dataset",
                "val_dataset", "meta_arch"):
        assert got[key] == ref[key], key

    got = _plain(cfg_from_file(os.path.join(CONFIGS,
                                            "synthetic_flagship.py")))
    ref = _plain(jax_cfg(os.path.join(REPO, "configs",
                                      "kitti_wpose_example.py")))
    assert ref["trainer"].pop("evaluate_hook")
    assert got["trainer"] == ref["trainer"]
    for key in ("optimizer", "scheduler", "data"):
        assert got[key] == ref[key], key
    assert ref["meta_arch"]["depth_backbone_cfg"]["pretrained"] is True
    ref["meta_arch"]["depth_backbone_cfg"]["pretrained"] = False
    assert got["meta_arch"] == ref["meta_arch"]
    for split in ("train_dataset", "val_dataset"):
        assert got[split]["augmentation"] == ref[split]["augmentation"]
    synth = got["train_dataset"]["cfg_list"][0]
    assert (synth["height"], synth["width"]) == (375, 1242)
    assert synth["length"] == 39810 and got["val_dataset"]["length"] == 697
