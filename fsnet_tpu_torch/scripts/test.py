"""Checkpoint evaluation of the port (counterpart of ``scripts/test.py``):
restore a checkpoint and run the config's ``evaluate_hook`` on a split
(the KITTI raw and KITTI-360 recipes: the Eigen-style error suites; the
nuScenes recipes: the same suites per camera and their mean; as the
training loop evaluates); a config with no evaluator runs the validation
hook (``make_eval_step``) over the split one sample at a time and prints
the predicted depth's min, mean and max.

Usage, from the root of the repo:

    python -m fsnet_tpu_torch.scripts.test --config CFG \
        --checkpoint PATH [--split val] [--device cpu] [--a.b.c value]

A config whose ``evaluate_hook`` or ``precompute_hook`` names something the
port does not have raises, as ``train.py`` does; a ported
``precompute_hook`` is not run (the masks serve training only).
"""
from __future__ import annotations

import argparse
import time
from typing import Dict


def main(config: str, checkpoint: str = "", split: str = "val",
         device: str = "cuda", **kwargs) -> Dict:
    """Evaluates ``checkpoint`` (or the seeded initial weights) on the
    config's ``split`` on ``device`` (CUDA unless the caller asks for the
    CPU). Returns the ``samples`` count and the ``epoch`` restored, and,
    with an ``evaluate_hook``, its mean ``errors`` and ``abs_errors``
    (median-scaled and absolute, [7] each), ``channels`` (each camera's
    two suites where the hook groups by camera), ``seconds`` (the
    evaluation pass) and ``post_opt`` (a post-opt hook's counts of frames
    refined and left unrefined, and its seconds; else None), else the
    depth's ``min``, ``mean`` (of the per-sample means) and ``max``."""
    from ..data.datasets.dataset_utils import collate_fn
    from ..pipeline_hooks.train_val_hooks import BaseValidationHook
    from ..runtime.checkpoint import load_models
    from ..utils import (build, cfg_from_file, encode_batch, resolve_device,
                         update_cfg)
    from .train import check_hooks

    dev = resolve_device(device)
    if split not in ("train", "val", "test"):
        raise ValueError(f"split {split!r}: train, val or test")
    cfg = update_cfg(cfg_from_file(config), **kwargs)
    check_hooks(cfg)
    dataset = build(**cfg[f"{split}_dataset"])
    print(f"{split} dataset: {len(dataset)} samples")
    model = build(**cfg.meta_arch, device=dev,
                  seed=getattr(cfg.trainer, "seed", 100))
    epoch = 0
    if checkpoint:
        epoch = load_models(checkpoint, model, strict=False)
        print(f"Restored {checkpoint} (epoch {epoch})")

    if cfg.trainer.get("evaluate_hook"):
        evaluate_hook = build(**cfg.trainer.evaluate_hook, device=dev)
        t0 = time.perf_counter()
        errors, abs_errors = evaluate_hook(model, dataset, None, 0, 0)
        seconds = time.perf_counter() - t0
        post_opt = getattr(evaluate_hook, "post_opt", None)
        if post_opt is not None:
            print(f"post-optimisation: {post_opt['refined']} frames "
                  f"refined, {post_opt['unrefined']} left unrefined")
        return dict(errors=errors, abs_errors=abs_errors,
                    channels=dict(getattr(evaluate_hook, "channel_means",
                                          {})),
                    post_opt=post_opt, seconds=seconds,
                    samples=len(dataset), epoch=epoch)

    hook = BaseValidationHook(device=dev)
    mins, means, maxs = [], [], []
    for i in range(len(dataset)):
        depth = hook(encode_batch(collate_fn([dataset[i]])), model)["depth"]
        mins.append(float(depth.min()))
        means.append(float(depth.mean()))
        maxs.append(float(depth.max()))
    out = dict(min=min(mins), mean=sum(means) / len(means), max=max(maxs),
               samples=len(means), epoch=epoch)
    print(f"predictions over {out['samples']} samples: depth min "
          f"{out['min']:.3f} mean {out['mean']:.3f} max {out['max']:.3f}")
    return out


if __name__ == "__main__":
    from .train import parse_overrides

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", default="")
    parser.add_argument("--split", default="val")
    parser.add_argument("--device", default="cuda")
    args, unknown = parser.parse_known_args()
    main(config=args.config, checkpoint=args.checkpoint, split=args.split,
         device=args.device, **parse_overrides(unknown))
