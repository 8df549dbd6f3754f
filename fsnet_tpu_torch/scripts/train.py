"""Training entry point of the port (counterpart of ``scripts/train.py``):
config -> writer -> datasets and loader -> model -> pretrained encoders,
distillation teacher -> optimizer and schedule -> resume -> epoch loop
(the training hook, logging every ``disp_iter`` steps, a checkpoint every
epoch).

Usage, from the root of the repo:

    python -m fsnet_tpu_torch.scripts.train \
        --config fsnet_tpu_torch/configs/synthetic_smoke_example.py \
        [--device cpu] [--experiment_name NAME] [--any.dotted.key value]

The run is on ``cuda`` unless ``--device`` says otherwise. Each
``disp_iter`` steps it prints the step, the loss, the host ms spent
waiting on the loader and the step's wall ms (means over the steps since
the last print; the print waits for the device). ``_latest`` is saved
after every epoch and ``_{epoch}`` every ``save_iter`` epochs and after the
last, as ``<checkpoint_path>/<model_name>_latest.pth``; set
``path.pretrained_checkpoint`` to one to resume from it (weights, BN
statistics, Adam's moments and count, the epoch). ``--debug_nans`` (or
``DEBUGGING=1``) turns on ``torch.autograd.set_detect_anomaly``;
``--profile_dir DIR`` writes a ``torch.profiler`` trace of steps 10-13.
The config's ``trainer.precompute_hook`` (the motion masks) is built on
the device and run before the datasets are built. Its ``evaluate_hook``
is built on the device before the first step (a KITTI evaluator
precomputes its ground truth then) and run on ``val_dataset`` after the
checkpoint of every ``test_iter``-th epoch (default 5); a post-opt hook
prints the frames it left unrefined. A config whose ``evaluate_hook`` or
``precompute_hook`` names something the port does not have raises before
anything is built.
"""
from __future__ import annotations

import argparse
import ast
import os
import pprint
import time
from typing import Dict


def parse_overrides(argv) -> Dict:
    """``--a.b.c value`` (or ``--a.b.c=value``) pairs -> a dict of
    literal-evaluated values (strings where they do not parse)."""
    overrides = {}
    key = None
    for token in argv:
        if token.startswith("--"):
            key = token[2:]
            if "=" in key:
                key, value = key.split("=", 1)
                overrides[key] = _literal(value)
                key = None
        elif key is not None:
            overrides[key] = _literal(token)
            key = None
    return overrides


def _literal(value: str):
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def _writer(cfg, experiment_name: str, config: str):
    """A TensorBoard writer where ``torch.utils.tensorboard`` imports, else
    None (the loss logger then prints)."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        print(f"TensorBoard writer unavailable ({e}); losses are printed")
        return None
    import shutil

    from ..utils.logger import styling_git_info

    recorder_dir = os.path.join(
        cfg.path.log_path,
        f"{experiment_name}config={os.path.basename(config)}")
    shutil.rmtree(recorder_dir, ignore_errors=True)
    writer = SummaryWriter(recorder_dir)
    writer.add_text("config.py", pprint.pformat(cfg).replace(
        " ", "&nbsp;").replace("\n", "  \n"))
    writer.add_text("git", styling_git_info(getattr(cfg.path, "base_path",
                                                    ".")))
    return writer


def _names(node):
    """Every ``name`` of a config subtree."""
    if isinstance(node, dict):
        if isinstance(node.get("name"), str):
            yield node["name"]
        for value in node.values():
            yield from _names(value)
    elif isinstance(node, (list, tuple)):
        for value in node:
            yield from _names(value)


def check_hooks(cfg) -> None:
    """Raises where ``trainer.precompute_hook`` or ``trainer.evaluate_hook``
    names anything outside the port's modules (a JAX package's name, a
    made-up one). The port has the precompute hooks
    ``MotionMaskPrecomputeHook`` and ``MotionMaskARFlowPrecomputeHook``,
    and the evaluation hooks ``KittiEvaluationHook`` and
    ``KittiEvaluationHook_postopt`` with ``KittiEigenEvaluator``,
    ``Kitti360Evaluator``, ``Kitti360FisheyeEvaluator`` and
    ``FusionPortableEvaluator``, and ``FastNuscEvaluationHook`` and
    ``PostOptFastNuscEvaluationHook`` with ``NuscenesEvaluator``."""
    from ..utils.builder import find_object

    for key in ("precompute_hook", "evaluate_hook"):
        hook = cfg.trainer.get(key)
        if not hook:
            continue
        for name in _names(hook):
            ported = name.startswith("fsnet_tpu_torch.")
            if ported:
                try:
                    find_object(name)
                except (ModuleNotFoundError, AttributeError):
                    ported = False
            if not ported:
                raise NotImplementedError(
                    f"trainer.{key} {hook.get('name')!r}: {name!r} is not "
                    "ported; the port precomputes motion masks through "
                    "fsnet_tpu_torch.pipeline_hooks.precompute_hooks."
                    "MotionMaskPrecomputeHook or "
                    "MotionMaskARFlowPrecomputeHook, and evaluates through "
                    "fsnet_tpu_torch.pipeline_hooks.evaluation_hooks."
                    "KittiEvaluationHook(_postopt) with the KITTI raw, "
                    "KITTI-360, KITTI-360 fisheye or FusionPortable "
                    "evaluator, or (PostOpt)FastNuscEvaluationHook with "
                    "NuscenesEvaluator")


def main(config: str = "fsnet_tpu_torch/configs/synthetic_smoke_example.py",
         experiment_name: str = "default", device: str = "cuda",
         debug_nans: bool = False,
         profile_dir: str = "", **kwargs) -> Dict:
    """Trains as the config says, on ``device`` (CUDA unless the caller
    asks for the CPU; raises when CUDA is asked for and absent). Returns
    ``model``, ``optimizer``, ``schedule``, ``hook``, ``epoch`` (epochs
    done), ``global_step``, ``checkpoint`` (the last ``_latest`` path),
    ``log``: one dict per printed window (step, loss, wait_ms, wall_ms,
    steps), and ``evals``: one dict per evaluation (epoch, global_step,
    errors and abs_errors, the evaluator's two mean error suites, channels,
    each camera's two suites where the hook groups by camera, post_opt, a
    post-opt hook's counts of frames refined and left unrefined and its
    seconds, and seconds), and ``precompute``: the precompute hook run
    before the datasets were built, or None."""
    import torch

    from ..data.dataloader import build_dataloader, device_prefetch
    from ..entry import recipe_optimizer
    from ..runtime.checkpoint import load_models, load_teacher, save_models
    from ..runtime.pretrained import graft_pretrained_backbones
    from ..utils import (LossLogger, Timer, build, cfg_from_file,
                         resolve_device, set_random_seed, update_cfg)

    dev = resolve_device(device)
    cfg = update_cfg(cfg_from_file(config), **kwargs)
    check_hooks(cfg)
    if debug_nans or os.environ.get("DEBUGGING", "").lower() in ("1",
                                                                  "true"):
        torch.autograd.set_detect_anomaly(True)
        print("anomaly detection on: the backward raises at the first op "
              "that produced NaN/Inf")

    seed = getattr(cfg.trainer, "seed", 100)
    set_random_seed(seed)
    writer = _writer(cfg, experiment_name, config)

    precompute = None
    if cfg.trainer.get("precompute_hook"):
        precompute = build(**cfg.trainer.precompute_hook, device=dev)
        precompute()

    dataset_train = build(**cfg.train_dataset)
    dataset_val = build(**cfg.val_dataset)
    print(f"train samples: {len(dataset_train)}, val: {len(dataset_val)}")
    dataloader_train = build_dataloader(
        dataset_train, num_workers=cfg.data.num_workers,
        batch_size=cfg.data.batch_size, pin_memory=dev.type == "cuda")
    iter_per_epoch = len(dataloader_train)
    num_epochs = cfg.trainer.max_epochs

    model = build(**cfg.meta_arch, device=dev, seed=seed)
    graft_pretrained_backbones(model, cfg.meta_arch)
    if cfg.meta_arch.get("teacher_net_path"):
        load_teacher(model, cfg.meta_arch.teacher_net_path)
    recipe = dict(optimizer=dict(cfg.optimizer),
                  scheduler=dict(cfg.scheduler),
                  clip_gradients=cfg.trainer.training_hook.get(
                      "clip_gradients"))
    optimizer, schedule = recipe_optimizer(model, recipe, cfg.meta_arch,
                                           steps_per_epoch=iter_per_epoch)
    num_params = sum(p.numel() for p in model.parameters())
    print(f"Number of parameters: {num_params}")
    if writer is not None:
        writer.add_text("model params", f"{num_params}")

    start_epoch = 0
    if getattr(cfg.path, "pretrained_checkpoint", ""):
        start_epoch = load_models(cfg.path.pretrained_checkpoint, model,
                                  optimizer, strict=False)
        print(f"Resumed from {cfg.path.pretrained_checkpoint} (epoch "
              f"{start_epoch}, step {optimizer.count}, lr "
              f"{schedule(optimizer.count):.3e})")

    hook = build(**cfg.trainer.training_hook, device=dev, seed=seed)
    evaluate_hook = (build(**cfg.trainer.evaluate_hook, device=dev)
                     if cfg.trainer.get("evaluate_hook") else None)
    logger = LossLogger(writer, "training")
    disp_iter = cfg.trainer.disp_iter
    save_iter = getattr(cfg.trainer, "save_iter", 5)
    test_iter = getattr(cfg.trainer, "test_iter", 5)
    ckpt_dir = cfg.path.checkpoint_path
    model_name = getattr(cfg.trainer, "model_name", type(model).__name__)
    latest = os.path.join(ckpt_dir, f"{model_name}_latest.pth")
    global_step = optimizer.count
    timer = Timer()
    log, evals = [], []
    prof = None
    done_epochs = start_epoch
    try:
        for epoch in range(start_epoch, num_epochs):
            batches = device_prefetch(iter(dataloader_train), dev, size=2)
            t_window, wait, steps = time.perf_counter(), 0.0, 0
            for step_in_epoch in range(iter_per_epoch):
                t0 = time.perf_counter()
                data = next(batches, None)
                if data is None:
                    break
                wait += time.perf_counter() - t0
                if profile_dir and global_step == 10:
                    prof = torch.profiler.profile(activities=(
                        [torch.profiler.ProfilerActivity.CPU]
                        + ([torch.profiler.ProfilerActivity.CUDA]
                           if dev.type == "cuda" else [])))
                    prof.__enter__()
                # the logger takes the first and the last step of a window
                fed = (global_step % disp_iter == 0
                       or (global_step + 1) % disp_iter == 0)
                metrics = hook(data, model, optimizer,
                               training_loss_logger=logger if fed else None,
                               global_step=global_step, epoch_num=epoch)
                global_step += 1
                steps += 1
                if prof is not None and global_step == 14:
                    prof.__exit__(None, None, None)
                    os.makedirs(profile_dir, exist_ok=True)
                    prof.export_chrome_trace(os.path.join(
                        profile_dir, "steps_10_13.json"))
                    print(f"\nprofiler trace (steps 10-13) -> {profile_dir}")
                    prof = None
                if global_step % disp_iter == 0:
                    loss = float(metrics["loss"])
                    now = time.perf_counter()
                    entry = dict(step=global_step, epoch=epoch, loss=loss,
                                 wait_ms=wait / steps * 1e3,
                                 wall_ms=(now - t_window) / steps * 1e3,
                                 steps=steps)
                    log.append(entry)
                    logger.log(global_step)
                    done = ((epoch - start_epoch) * iter_per_epoch
                            + step_in_epoch + 1)
                    total = (num_epochs - start_epoch) * iter_per_epoch
                    print(f"epoch {epoch} step {global_step} loss {loss:.6f}"
                          f" | loader wait {entry['wait_ms']:.2f} ms | step "
                          f"wall {entry['wall_ms']:.2f} ms | ETA "
                          f"{timer.compute_eta(done, total)}", flush=True)
                    t_window, wait, steps = time.perf_counter(), 0.0, 0
            batches.close()
            done_epochs = epoch + 1
            save_models(latest, model, optimizer, done_epochs)
            if done_epochs % save_iter == 0 or epoch == num_epochs - 1:
                save_models(os.path.join(ckpt_dir,
                                         f"{model_name}_{epoch}.pth"),
                            model, optimizer, done_epochs)
            if evaluate_hook is not None and done_epochs % test_iter == 0:
                print(f"\n============ evaluate at epoch {epoch} "
                      "============")
                t0 = time.perf_counter()
                errors, abs_errors = evaluate_hook(model, dataset_val,
                                                   writer, global_step,
                                                   epoch)
                post_opt = getattr(evaluate_hook, "post_opt", None)
                if post_opt is not None:
                    print(f"post-optimisation: {post_opt['refined']} frames "
                          f"refined, {post_opt['unrefined']} left unrefined")
                evals.append(dict(
                    epoch=epoch, global_step=global_step, errors=errors,
                    abs_errors=abs_errors,
                    channels=dict(getattr(evaluate_hook, "channel_means",
                                          {})),
                    post_opt=post_opt,
                    seconds=time.perf_counter() - t0))
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
        dataloader_train.close()
        if writer is not None:
            writer.close()
    print("Training complete")
    return dict(model=model, optimizer=optimizer, schedule=schedule,
                hook=hook, epoch=done_epochs, global_step=global_step,
                checkpoint=latest, log=log, evals=evals,
                precompute=precompute)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config",
                        default="fsnet_tpu_torch/configs/"
                                "synthetic_smoke_example.py")
    parser.add_argument("--experiment_name", default="default")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--debug_nans", action="store_true",
                        help="torch.autograd.set_detect_anomaly (also on "
                             "with DEBUGGING=1)")
    parser.add_argument("--profile_dir", default="",
                        help="write a torch.profiler trace of steps 10-13 "
                             "to this directory")
    args, unknown = parser.parse_known_args()
    main(config=args.config, experiment_name=args.experiment_name,
         device=args.device, debug_nans=args.debug_nans,
         profile_dir=args.profile_dir, **parse_overrides(unknown))
