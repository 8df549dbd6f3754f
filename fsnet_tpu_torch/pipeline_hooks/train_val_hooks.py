"""Training and validation step hooks (counterpart of
``fsnet_tpu.pipeline_hooks.train_val_hooks``).

The hooks keep the configs' surface (``cfg.trainer.training_hook`` with
``clip_gradients`` and ``compute_dtype``) and own the step functions of
:mod:`fsnet_tpu_torch.runtime.state`. The training hook draws the identity
tie-break noise of the loss at every step, as the JAX step draws it from
its ``loss_noise`` key: standard normal values of the shape
``make_train_step`` takes, [F, B, H, W] (the head's source frames, the
batch and its frame size), from its own ``torch.Generator`` on the step's
device. As the JAX loop folds the step into a key seeded with
``trainer.seed + 1``, the generator is seeded at each step from
``SeedSequence([seed + 1, step])``: the noise is a function of the seed and
the global step, so a resumed run draws what an uninterrupted one would.
The JAX PRNG's values cannot be reproduced; the values are the port's own.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..runtime.state import make_eval_step, make_train_step
from ..utils.device import DeviceLike, resolve_device
from ..utils.timer import profile

# the configs' names of the compute dtypes (None: the model's own type)
_DTYPES = {None: None, "float32": None, "bf16": "bfloat16",
           "bfloat16": "bfloat16"}


class BaseTrainingHook:
    """Owns the train step of ``compute_dtype`` on ``device`` and the
    tie-break noise generator. ``clip_gradients`` is consumed by the
    optimizer when it is built (:func:`fsnet_tpu_torch.entry.recipe_optimizer`);
    it is kept here because the configs put it here."""

    def __init__(self, tensor_keys: Optional[List[str]] = None,
                 clip_gradients: Optional[float] = None,
                 compute_dtype: Optional[str] = None,
                 device: DeviceLike = "cuda", seed: int = 100, **kwargs):
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype {compute_dtype!r}: one of "
                             f"{sorted(map(str, _DTYPES))}")
        self.tensor_keys = tensor_keys
        self.clip_gradients = clip_gradients
        self.compute_dtype = _DTYPES[compute_dtype]
        self.device = resolve_device(device)
        self._train_step = make_train_step(self.device,
                                           compute_dtype=self.compute_dtype)
        self.seed = seed
        self.generator = torch.Generator(device=self.device)

    def noise(self, model: nn.Module, data: Dict, step: int) -> torch.Tensor:
        """The tie-break noise of global step ``step`` for ``data``:
        [F, B, H, W] standard normal float32 on the step's device."""
        frames = len(model.head.frame_ids) - 1
        batch, height, width = data["image/0"].shape[:3]
        self.generator.manual_seed(int(np.random.SeedSequence(
            [self.seed + 1, step]).generate_state(1)[0]))
        return torch.randn((frames, batch, height, width),
                           generator=self.generator, device=self.device)

    @profile("Training hook", 0, 100)
    def __call__(self, data: Dict, model: nn.Module, optimizer,
                 training_loss_logger=None, global_step: int = 0,
                 epoch_num: int = 0) -> Dict:
        """One optimisation step with the noise of ``global_step``; returns
        the step's metrics (0-d tensors on the device). With a logger, its
        scalars (all but ``loss``) are read back and added to it."""
        metrics = self._train_step(model, optimizer, data,
                                   noise=self.noise(model, data, global_step))
        if training_loss_logger is not None:
            training_loss_logger.update(
                {k: float(v) for k, v in metrics.items() if k != "loss"})
        return metrics


class BaseValidationHook:
    """Owns the eval step on ``device``; ``scripts/test.py`` evaluates
    through it. Returns the step's predictions (``depth`` among them)."""

    def __init__(self, tensor_keys: Optional[List[str]] = None,
                 device: DeviceLike = "cuda", **kwargs):
        self.tensor_keys = tensor_keys
        self._eval_step = make_eval_step(device)

    def __call__(self, data: Dict, model: nn.Module, global_step: int = 0,
                 epoch_num: int = 0) -> Dict:
        return self._eval_step(model, data)
