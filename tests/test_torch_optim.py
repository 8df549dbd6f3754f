"""The port's optimizer (clip by global norm -> Adam -> StepLR) against the
JAX package's optax chain from ``fsnet_tpu.runtime.optim.build_optimizer``,
float32, over several steps from the same parameters and gradients.

The gradients are scaled so that the clip is active in every step (global
norm 5 to 50 against max_norm 1.0) but one, where it is not. The learning
rate is the recipe's, 1e-4. Parameters must agree within 1e-7 after each
step.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from fsnet_tpu.runtime.optim import build_optimizer as j_build
from fsnet_tpu_torch.runtime.optim import build_optimizer as t_build

torch.set_num_threads(1)

SHAPES = {"a": (3, 3, 4, 5), "b": (5,), "c": (7, 2)}


def _run(steps_per_epoch, scheduler, scales, weight_decay=0.0):
    rng = np.random.RandomState(0)
    params = {k: (rng.randn(*s) * 0.1).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: (rng.randn(*s) * sc).astype(np.float32)
              for k, s in SHAPES.items()} for sc in scales]
    cfg = dict(name="adam", lr=1e-4, weight_decay=weight_decay)

    tx, _ = j_build(cfg, scheduler, steps_per_epoch=steps_per_epoch,
                    clip_gradients=1.0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    ref = []
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        ref.append({k: np.asarray(v) for k, v in jp.items()})

    tp = [torch.from_numpy(params[k].copy()) for k in sorted(SHAPES)]
    opt, _ = t_build(tp, cfg, scheduler, steps_per_epoch=steps_per_epoch,
                     clip_gradients=1.0)
    got, norms = [], []
    for g in grads:
        norms.append(float(opt.step([torch.from_numpy(g[k])
                                     for k in sorted(SHAPES)])))
        got.append({k: t.numpy().copy() for k, t in zip(sorted(SHAPES), tp)})
    return ref, got, norms, grads


@pytest.mark.parametrize("scheduler,steps_per_epoch", [
    (dict(name="StepLR", step_size=2), 1),        # lr drops at step 2
    (dict(name="StepLR", step_size=8), 1000),
    (None, 1),
])
def test_adam_chain_matches_optax(scheduler, steps_per_epoch):
    ref, got, norms, grads = _run(steps_per_epoch, scheduler,
                                  (5.0, 0.01, 20.0, 50.0))
    for g, n in zip(grads, norms):
        want = np.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2))
                           for v in g.values()))
        assert abs(n - want) <= 1e-5 * want
    assert norms[1] < 1.0 < min(norms[0], norms[2], norms[3])
    for r, a in zip(ref, got):
        for k in SHAPES:
            np.testing.assert_allclose(a[k], r[k], rtol=0, atol=1e-7,
                                       err_msg=k)


def test_weight_decay_matches_optax():
    ref, got, _, _ = _run(1, None, (5.0, 3.0, 0.01), weight_decay=1e-2)
    for r, a in zip(ref, got):
        for k in SHAPES:
            np.testing.assert_allclose(a[k], r[k], rtol=0, atol=1e-7)


def test_schedule_matches():
    from fsnet_tpu.runtime.optim import build_lr_schedule as j_sched
    from fsnet_tpu_torch.runtime.optim import build_lr_schedule as t_sched

    cfg = dict(name="StepLR", step_size=3, gamma=0.5)
    js, _ = j_sched(cfg, 1e-4, 7)
    ts = t_sched(cfg, 1e-4, 7)
    for step in (0, 6, 7, 20, 21, 22, 63, 200):
        assert ts(step) == float(js(step)), step
