"""The evaluator protocol (counterpart of
``fsnet_tpu.evaluation.base_evaluator``): ``reset``, ``step``, ``log`` and
``__call__``."""
from __future__ import annotations


class BaseEvaluator:
    def reset(self):
        raise NotImplementedError

    def step(self, *args, **kwargs):
        raise NotImplementedError

    def log(self, *args, **kwargs):
        raise NotImplementedError

    def __call__(self, *args, **kwargs):
        raise NotImplementedError
