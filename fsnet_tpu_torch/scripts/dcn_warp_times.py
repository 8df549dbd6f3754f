"""Device time of kernels E and K at the 16 deformable convs of a DLA train
step (``entry.dla_model``, batch 12 at 192x640), summed over the convs: the
float32 kernels, and the bfloat16 forms where the tree has them (the inputs
and cotangents rounded to bf16, the float32 grid kept), each the mean of
``--iters`` back-to-back calls by CUDA events after 2 warm-up calls.

    python fsnet_tpu_torch/scripts/dcn_warp_times.py [--tree DIR] [--tag TAG]
        [--iters 20]

``--tree`` names the checkout whose ``fsnet_tpu_torch`` is timed (default:
the one this file lies in), so one copy of this script times a parent tree
unpacked beside the change: run it for each tree in turns (parent, change,
change, parent) in one chip call. Prints one line ``DCN_WARPS <tag>
{"e32": ms, "k32": ms, "e16": ms, "k16": ms}`` (the bf16 ones null where
the tree has no bf16 forms) and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    ap.add_argument("--tag", default="")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    import fsnet_tpu_torch
    from fsnet_tpu_torch.entry import dla_batch, dla_model
    from fsnet_tpu_torch.models.backbones.dla_utils import \
        ModulatedDeformConvPack
    from fsnet_tpu_torch.ops import warp_fast as twf
    from fsnet_tpu_torch.ops.dcn import tap_grid

    if not os.path.abspath(fsnet_tpu_torch.__file__).startswith(
            tree + os.sep):
        raise SystemExit(f"imported {fsnet_tpu_torch.__file__}, not the "
                         f"tree {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("dcn_warp_times: no CUDA device")
    model = dla_model(192, 640, device="cuda", seed=0)
    x0 = torch.from_numpy(dla_batch(12, 192, 640)["image/0"]).cuda()
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda m, a: seen.append((m, a[0].contiguous())))
        for m in model.modules() if isinstance(m, ModulatedDeformConvPack)]
    with torch.no_grad():
        model.dummy_forward(x0, train=False)
        scene = []
        for m, x in seen:
            K = m.weight.shape[0]
            off = m.conv_offset(x)[..., :2 * K * K]
            scene.append((x, tap_grid(off, x.shape[1], x.shape[2], K,
                                      m.stride, m.padding, m.dilation)))
    for h in hooks:
        h.remove()

    def ms(fn):
        for _ in range(2):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(args.iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / args.iters

    bf16 = hasattr(twf.grid_band_fwd, "dtypes")
    gen = torch.Generator(device="cuda").manual_seed(23)
    out = dict(e32=0.0, k32=0.0, e16=0.0 if bf16 else None,
               k16=0.0 if bf16 else None)
    for x, grid in scene:
        band = min(8, x.shape[1])
        g = torch.randn((grid.shape[0],) + x.shape[1:], device="cuda",
                        generator=gen)
        runs = [(x, g, "32")]
        if bf16:
            runs.append((x.to(torch.bfloat16), g.to(torch.bfloat16), "16"))
        for xi, gi, tag in runs:
            out["e" + tag] += ms(lambda: twf.grid_band_fwd(
                xi, grid, "bilinear", "zeros", band))
            out["k" + tag] += ms(lambda: twf.grid_band_bwd(
                xi, grid, gi, "bilinear", "zeros", band))
    print(f"DCN_WARPS {args.tag} {json.dumps(out)}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
