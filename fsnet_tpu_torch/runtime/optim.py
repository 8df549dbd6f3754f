"""Optimizer + learning-rate schedule of the training recipe (counterpart of
``fsnet_tpu.runtime.optim.build_optimizer`` for ``adam`` with an optional
``StepLR`` schedule and global-norm clipping).

The update is optax's chain, in its order: clip by global norm, then Adam's
scaling, then the learning rate:

* clip: ``g <- g / ||g|| * max_norm`` when ``||g|| >= max_norm`` (optax
  adds no epsilon, unlike ``torch.nn.utils.clip_grad_norm_``);
* Adam: ``mu <- (1 - b1) g + b1 mu``, ``nu <- (1 - b2) g^2 + b2 nu``,
  ``u = mu_hat / (sqrt(nu_hat) + eps)`` with the bias corrections
  ``1 - b^t``;
* lr: ``p <- p - lr(t) u`` with ``t`` the number of updates made before,
  ``lr(t) = base_lr * gamma ** ((t // steps_per_epoch) // step_size)``.

Torch Adam's ``weight_decay`` is L2 added to the gradient before the
moments. The update runs in place on the parameters with ``torch._foreach``
operations, which keep the launches few on a CUDA device.

Frozen parameters (the distillation teacher, ``frozen_stages`` of a
backbone; :func:`frozen_param_prefixes`, :func:`build_frozen_mask`) are the
JAX package's ``optax.set_to_zero`` branch: :func:`trainable_params` turns
their ``requires_grad`` off and leaves them out of the optimizer, so they
take no update and no part in the clip's global norm (their gradients are
exactly 0 in the JAX step, so its norm is the same).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn


def build_lr_schedule(scheduler_cfg: Optional[Dict], base_lr: float,
                      steps_per_epoch: int) -> Callable[[int], float]:
    """cfg -> ``schedule(step) -> lr`` for no schedule or ``StepLR``
    (epoch-based unless ``is_iter_based``)."""
    cfg = dict(scheduler_cfg or {})
    name = cfg.pop("name", None)
    is_iter_based = bool(cfg.pop("is_iter_based", False))
    if name is None:
        return lambda step: float(base_lr)
    if name.lower() != "steplr":
        raise NotImplementedError(f"the port's schedules: StepLR, not {name}")
    step_size, gamma = cfg["step_size"], cfg.get("gamma", 0.1)
    per = 1 if is_iter_based else max(steps_per_epoch, 1)
    # float32 arithmetic, as the JAX schedule's jnp.power
    return lambda step: float(torch.tensor(base_lr, dtype=torch.float32)
                              * torch.tensor(gamma, dtype=torch.float32)
                              ** float((step // per) // step_size))


class Adam:
    """Clip-by-global-norm -> Adam -> learning rate over a fixed list of
    parameters. ``step(grads)`` applies one update in place."""

    def __init__(self, params: Sequence[torch.Tensor],
                 schedule: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0,
                 clip_gradients: Optional[float] = None):
        self.params: List[torch.Tensor] = list(params)
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.clip = clip_gradients if clip_gradients and clip_gradients > 0 \
            else None
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def global_norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(list(grads))))

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """One update from ``grads`` (one per parameter, same order).
        Returns the global norm of ``grads`` before clipping."""
        grads = [g.detach() for g in grads]
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for "
                             f"{len(self.params)} parameters")
        g_norm = self.global_norm(grads)
        if self.clip is not None:
            # optax: keep below the bound, else t / ||g|| * max_norm
            scale = torch.where(g_norm < self.clip, torch.ones_like(g_norm),
                                torch.full_like(g_norm, self.clip))
            div = torch.where(g_norm < self.clip, torch.ones_like(g_norm),
                              g_norm)
            grads = torch._foreach_div(grads, div)
            torch._foreach_mul_(grads, scale)
        if self.weight_decay:
            grads = torch._foreach_add(grads, self.params,
                                       alpha=self.weight_decay)
        b1, b2 = self.b1, self.b2
        # mu <- (1 - b1) g + b1 mu;  nu <- (1 - b2) g^2 + b2 nu
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1.0 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1.0 - b2))
        t = self.count + 1
        # bias corrections 1 - b^t in the parameters' float type (optax:
        # the default float type, float32 unless float64 is on)
        ft = torch.promote_types(self.params[0].dtype, torch.float32)
        bc1 = float(1.0 - torch.tensor(b1, dtype=ft) ** t)
        bc2 = float(1.0 - torch.tensor(b2, dtype=ft) ** t)
        mu_hat = torch._foreach_div(self.mu, bc1)
        nu_hat = torch._foreach_div(self.nu, bc2)
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu_hat, denom)
        # p + (u * -lr): two roundings, as optax's scale then apply_updates
        torch._foreach_mul_(upd, -self.schedule(self.count))
        torch._foreach_add_(self.params, upd)
        self.count = t
        return g_norm


def build_optimizer(params: Sequence[torch.Tensor], optimizer_cfg: Dict,
                    scheduler_cfg: Optional[Dict] = None,
                    steps_per_epoch: int = 1,
                    clip_gradients: Optional[float] = None
                    ) -> Tuple[Adam, Callable[[int], float]]:
    """The JAX package's ``build_optimizer`` for ``name='adam'``: returns
    (optimizer over ``params``, schedule)."""
    cfg = dict(optimizer_cfg)
    name = cfg.pop("name").lower()
    if name != "adam":
        raise NotImplementedError(f"the port's optimizer is adam, not {name}")
    base_lr = cfg.pop("lr", 1e-3)
    betas = cfg.pop("betas", (0.9, 0.999))
    schedule = build_lr_schedule(scheduler_cfg, base_lr, steps_per_epoch)
    opt = Adam(params, schedule, b1=betas[0], b2=cfg.pop("betas_b2", 0.999),
               eps=cfg.pop("eps", 1e-8),
               weight_decay=cfg.pop("weight_decay", 0.0),
               clip_gradients=clip_gradients)
    if cfg:
        raise TypeError(f"unknown optimizer options {sorted(cfg)}")
    return opt, schedule


def frozen_param_prefixes(meta_arch_cfg: Mapping) -> List[Tuple[str, ...]]:
    """Frozen parameter path prefixes of a meta-arch config: the
    distillation teacher (``('teacher_net',)``) and, for a backbone with
    ``frozen_stages >= 0``, its stem (``conv1``, ``bn1``) and the blocks of
    stages 1..frozen_stages (``'layer{i}_'``, a partial scope name)."""
    prefixes = []
    if "teacher_net_cfg" in meta_arch_cfg:
        prefixes.append(("teacher_net",))
    for scope in ("depth_backbone_cfg", "pose_backbone_cfg"):
        sub = meta_arch_cfg.get(scope)
        if not sub:
            continue
        frozen_stages = sub.get("frozen_stages", -1)
        if frozen_stages is None or frozen_stages < 0:
            continue
        name = scope[:-len("_cfg")]
        prefixes += [(name, "conv1"), (name, "bn1")]
        prefixes += [(name, f"layer{i}_") for i in range(1, frozen_stages + 1)]
    return prefixes


def build_frozen_mask(model: nn.Module,
                      prefixes: Sequence[Tuple[str, ...]]) -> Dict[str, bool]:
    """``model``'s parameter name -> frozen: True where the name's dotted
    path starts with one of ``prefixes``, whose last element may be a
    partial scope name (``'layer1_'``)."""

    def frozen(path: Tuple[str, ...]) -> bool:
        for pre in prefixes:
            if len(pre) > len(path):
                continue
            head, last = tuple(pre[:-1]), pre[-1]
            if path[:len(head)] == head and path[len(head)].startswith(last):
                return True
        return False

    return {n: frozen(tuple(n.split("."))) for n, _ in
            model.named_parameters()}


def trainable_params(model: nn.Module,
                     mask: Mapping[str, bool]) -> List[nn.Parameter]:
    """Turns ``requires_grad`` off for the parameters ``mask`` freezes and
    returns the others, in module order: the optimizer's parameter list."""
    out = []
    for n, p in model.named_parameters():
        if mask[n]:
            p.requires_grad_(False)
        else:
            out.append(p)
    return out
