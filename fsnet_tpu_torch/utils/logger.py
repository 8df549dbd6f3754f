"""Loss logging and git provenance (counterpart of
``fsnet_tpu.utils.logger``, without the heatmaps).

The TensorBoard writer is optional: ``scripts/train.py`` makes one where
``torch.utils.tensorboard`` imports, and :class:`LossLogger` prints its
averages where there is none.
"""
from __future__ import annotations

import subprocess
from typing import Dict

import numpy as np


class AverageMeter:
    """Running average of a scalar."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class LossLogger:
    """Accumulates per-step scalar losses; ``log(step)`` writes their
    averages to the writer (or prints them without one) and starts over.
    (The port's train step returns no heatmaps, so there are none to
    log.)"""

    def __init__(self, writer=None, split: str = "training"):
        self.writer = writer
        self.split = split
        self.loss_stats: Dict[str, AverageMeter] = {}

    def update(self, loss_dict: Dict[str, float]):
        for key, value in loss_dict.items():
            if key not in self.loss_stats:
                self.loss_stats[key] = AverageMeter()
            self.loss_stats[key].update(np.asarray(value).mean())

    def log(self, step: int):
        if self.writer is None:
            if self.loss_stats:
                print(f"[{self.split} {step}] " + ", ".join(
                    f"{k} {m.avg:.6g}" for k, m in self.loss_stats.items()))
        else:
            for key, meter in self.loss_stats.items():
                self.writer.add_scalar(f"{self.split}/{key}", meter.avg,
                                       step)
        self.loss_stats = {}


def styling_git_info(repo_path: str = ".") -> str:
    """The last commit and the working diff as markdown, for provenance."""
    try:
        log = subprocess.run(
            ["git", "-C", repo_path, "log", "-1",
             "--pretty=format:%H%n%an%n%ad%n%s"],
            capture_output=True, text=True, timeout=10).stdout
        diff = subprocess.run(["git", "-C", repo_path, "diff"],
                              capture_output=True, text=True,
                              timeout=10).stdout
    except (OSError, subprocess.SubprocessError):
        return "git info unavailable"
    return (f"### git log\n\n```\n{log}\n```\n\n### git diff\n\n```diff\n"
            f"{diff}\n```")
