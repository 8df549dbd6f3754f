"""How far float32 rounding alone moves the DLA train step's gradient.

    python -m fsnet_tpu_torch.scripts.dla_conditioning [--batch 2]
        [--height 192] [--width 640] [--seeds 0] [--threads 4]

Runs one forward and backward of ``entry.dla_model`` (loss
``sum(out * target_weight)``) through the port on the CPU, once in float32
and once in float64, from the same seeded weights and ``entry.dla_batch``,
and prints for each variant: the loss's relative distance, the global
gradient rel-L2 (without the deformable convs' biases, which train-mode BN
cancels), the worst leaf, the output's relative distance, the number of
outputs whose ReLU gate differs, and the range over the 16 deformable convs
of their offsets' standard deviation (float64, pixels). Variants: the train-mode step as shipped;
the same with a two-pass batch variance ``mean((x - mean)^2)`` in place of
``mean(x^2) - mean^2``; BN frozen at its init statistics; BN frozen at the
batch's own statistics; and the train-mode step with the offset convs
perturbed to ``offset_std`` 0 and 0.3 instead of 1.5 pixels.
"""
from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch

from ..entry import dla_batch, dla_model
from ..models.backbones.dla_utils import ModulatedDeformConvPack
from ..models.blocks import BatchNorm
from ..ops import warp_fast as twf

VARIANTS = ("train", "train, two-pass variance", "BN frozen at init",
            "BN frozen at the batch's statistics", "train, offset_std 0",
            "train, offset_std 0.3")


@contextlib.contextmanager
def two_pass_variance():
    """BatchNorm's train-mode variance computed as mean((x - mean)^2)."""
    shipped = BatchNorm.forward

    def forward(self, x, train=False):
        if not (train and not self.frozen):
            return shipped(self, x, train)
        dims = tuple(range(x.dim() - 1))
        mean = x.mean(dim=dims)
        var = ((x - mean) ** 2).mean(dim=dims)
        self.update_stats(mean, var)
        return self.normalize(x, mean, var)

    BatchNorm.forward = forward
    try:
        yield
    finally:
        BatchNorm.forward = shipped


def run(variant, dtype, batch, seed):
    """(loss, gradients by name, output, pre-ReLU output, the offsets'
    standard deviation at each deformable conv) of one step."""
    H, W = batch["image/0"].shape[1:3]
    std = {"train, offset_std 0": 0.0,
           "train, offset_std 0.3": 0.3}.get(variant, 1.5)
    model = dla_model(H, W, device="cpu", seed=seed, offset_std=std).to(dtype)
    x = torch.from_numpy(batch["image/0"]).to(dtype)
    r = torch.from_numpy(batch["target_weight"]).to(dtype)
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    pre = []
    dtypes, twf._DTYPES = twf._DTYPES, (dtype,)
    try:
        if variant == "BN frozen at the batch's statistics":
            for bn in bns:
                bn.momentum = 0.0
            with torch.no_grad():
                model.dummy_forward(x, train=True)
            for bn in bns:
                bn.momentum = BatchNorm.momentum
        if variant.startswith("BN frozen"):
            for bn in bns:
                bn.frozen = True
        model.head.ida_up.node_2.bn.register_forward_hook(
            lambda m, i, o: pre.append(o.detach().double()))
        offset_sd = []
        for m in model.modules():
            if isinstance(m, ModulatedDeformConvPack):
                KK = m.weight.shape[0] ** 2
                m.conv_offset.register_forward_hook(
                    lambda m, i, o, KK=KK: offset_sd.append(
                        float(o[..., :2 * KK].detach().std())))
        with (two_pass_variance() if "two-pass" in variant
              else contextlib.nullcontext()):
            out = model.dummy_forward(x, train=True)
            loss = (out * r).sum()
            loss.backward()
    finally:
        twf._DTYPES = dtypes
    grads = {k: p.grad.double() for k, p in model.named_parameters()
             if p.grad is not None and not (k.endswith(".bias") and isinstance(
                 model.get_submodule(k.rsplit(".", 1)[0]),
                 ModulatedDeformConvPack))}
    return loss.item(), grads, out.detach().double(), pre[0], offset_sd


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--height", type=int, default=192)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--seeds", default="0",
                   help="comma-separated weight seeds")
    p.add_argument("--threads", type=int, default=4)
    args = p.parse_args()
    torch.set_num_threads(args.threads)
    batch = dla_batch(args.batch, args.height, args.width)
    size = f"bs{args.batch}@{args.height}x{args.width}"
    for seed in (int(s) for s in args.seeds.split(",")):
        for variant in VARIANTS:
            t0 = time.perf_counter()
            l32, g32, o32, y32, _ = run(variant, torch.float32, batch, seed)
            l64, g64, o64, y64, sd = run(variant, torch.float64, batch,
                                         seed)
            num = sum(float(((g32[k] - g64[k]) ** 2).sum()) for k in g64)
            den = sum(float((g64[k] ** 2).sum()) for k in g64)
            leaf = {k: float((g32[k] - g64[k]).norm() / g64[k].norm())
                    for k in g64 if bool(g64[k].any())}
            worst = max(leaf, key=leaf.get)
            flips = int(((y32 > 0) != (y64 > 0)).sum())
            print(f"{size} seed {seed}, {variant}: float32 vs float64 loss "
                  f"rel {abs(l32 - l64) / abs(l64):.3e}, global grad rel-L2 "
                  f"{np.sqrt(num / den):.3e}, worst leaf {worst} "
                  f"{leaf[worst]:.3e}, output rel "
                  f"{float((o32 - o64).norm() / o64.norm()):.3e}, ReLU gates "
                  f"differing at the output {flips} of {y64.numel()}, offsets"
                  f"' sd {min(sd):.3g}-{max(sd):.3g} px "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
