"""Where the time of a train step goes on the card.

    python -m fsnet_tpu_torch.scripts.profile_train [--batch 12] [--iters 5]
        [--model {wpose,learned_pose,fisheye,dla}] [--route {depth,grid}]
        [--host-batch]

Builds the model (seeded random weights) and the ``bench.py`` recipe (Adam
lr 1e-4, clip 1.0, StepLR) on the CUDA device with TF32 off: the flagship
``MonoDepthWPose`` (``--model wpose``) or the learned-pose
``MonoDepthMeta`` (``--model learned_pose``, always the grid route), or the
KITTI-360 fisheye ``MonoDepthWPose`` (``--model fisheye``: ``FishEyeDecoder``
at 384x384 on the fisheye batch, always its norm-direct route; the recipe's
batch is 16), or ``dlanet(34)`` under ``DLASegUpsample`` (``--model dla``:
16 deformable convs, kernels E and K, on ``entry.dla_batch``). The flagship's loss takes the depth-direct route on the
synthetic KITTI-like batch (``--route depth``) and the grid route when the
batch carries an all-ones ``patched_mask``, as every dataset batch does
(``--route grid``). Puts the batch on the card (as ``bench.py`` does for the
JAX step; ``--host-batch`` passes numpy arrays, so each step copies them),
warms up, then runs ``--iters`` train steps (192x640, or 384x384 for the
fisheye model) in float32 under
``torch.profiler`` and prints: the wall time per step and images/s, the
device's busy and idle share of that window, device time by group (each of
the port's kernels, the photometric loss's two among them, cuDNN/cuBLAS,
the deformable convs' image cotangent (kernel K),
the optimizer's multi-tensor updates, copies, everything else: the rest of
the loss, the target's SSIM stats, the grid's reprojection, BN, ReLU and
their gradients), the peak device memory of a step and the kernels with the
most device time.
"""
from __future__ import annotations

import argparse
import subprocess
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

_GROUPS = (
    ("conv3x3_dw_kernel", "conv3x3 weight cotangent (kernel D)"),
    ("warp_depth_fwd_kernel", "warp forward (kernel A)"),
    ("warp_depth_bwd_kernel", "warp backward (kernel B)"),
    ("warp_grid_kernel<true>", "grid warp + va, vb (kernel F)"),
    ("warp_grid_kernel<false>", "grid warp forward (kernel E)"),
    ("warp_grid_bwd_kernel", "grid warp backward (kernel K)"),
    ("warp_mei_fwd_kernel", "Mei warp + va, vb + overlap (kernel G)"),
    ("warp_mei_bwd_kernel", "Mei norm cotangent (kernel H)"),
    ("photo_loss_fwd_kernel", "photometric loss forward (kernel I)"),
    ("photo_loss_bwd_kernel", "photometric loss cotangent (kernel J)"),
)


def _group(name: str) -> str:
    if "conv3x3_nhwc_kernel" in name:      # <T, TCO, MOM>: the epilogue flag
        return ("conv3x3 + BN moments (kernel C)" if "true>" in name
                else "conv3x3: dispconvs and input cotangents")
    for key, group in _GROUPS:
        if key in name:
            return group
    low = name.lower()
    if "multi_tensor_apply" in low or "foreach" in low:
        return "optimizer (foreach updates)"
    if any(k in low for k in ("conv", "implicit", "wgrad", "dgrad", "sm90_",
                               "cudnn", "gemm")):
        return "cuDNN/cuBLAS (encoder convs, small matmuls)"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "elementwise/reduce/other (rest of the loss, BN, ReLU, gradients)"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=12)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--host-batch", action="store_true")
    ap.add_argument("--model", choices=("wpose", "learned_pose", "fisheye",
                                        "dla"), default="wpose")
    ap.add_argument("--route", choices=("depth", "grid"), default="depth")
    args = ap.parse_args(argv)
    if args.model == "learned_pose" and args.route != "grid":
        ap.error("learned poses take the grid route: pass --route grid")
    if args.model in ("fisheye", "dla") and args.route != "depth":
        ap.error(f"the {args.model} model has one route: leave --route out")

    from ..entry import (dla_batch, dla_model, fisheye_batch, fisheye_model,
                         flagship_model, flagship_optimizer,
                         learned_pose_model, synthetic_batch)
    from ..runtime.state import make_train_step

    # full float32, as chip_smoke.py measures it: no TF32 in cuDNN/cuBLAS
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fisheye = args.model == "fisheye"
    H, W, B = (384, 384, args.batch) if fisheye else (192, 640, args.batch)
    build = dict(wpose=flagship_model, learned_pose=learned_pose_model,
                 fisheye=fisheye_model, dla=dla_model)[args.model]
    model = build(H, W, device="cuda", seed=0)
    opt, _ = flagship_optimizer(model)
    step = make_train_step("cuda")
    mask = "ones" if args.model == "wpose" and args.route == "grid" else None
    batch = (fisheye_batch(B, H, W) if fisheye else dla_batch(B, H, W)
             if args.model == "dla"
             else synthetic_batch(B, H, W, patched_mask=mask))
    if not args.host_batch:
        batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    for _ in range(3):
        step(model, opt, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(model, opt, batch)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            step(model, opt, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    groups = defaultdict(float)
    for e in kernels:
        groups[_group(e.key)] += e.self_device_time_total / 1e3

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    n = args.iters
    where = "from host numpy" if args.host_batch else "on the card"
    lines = [f"{card}; torch {torch.__version__}; train step of "
             f"{args.model}, "
             + ("" if args.model == "dla" else
                f"{'norm-direct' if fisheye else args.route} route, ") +
             f"bs{B}@{H}x{W} float32, "
             f"batch {where}, {n} steps under torch.profiler",
             f"wall per step {wall_ms / n:.3f} ms ({B * n / wall_ms * 1e3:.2f}"
             f" imgs/s); device busy per step {busy_ms / n:.3f} ms; idle "
             f"share {1 - busy_ms / wall_ms:.3f}; peak memory of a step "
             f"{peak_gb:.3f} GB",
             "device time per step by group:"]
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        lines.append(f"  {ms / n:9.3f} ms  {100 * ms / busy_ms:5.1f}%  {g}")
    lines.append("top kernels (device ms per step, calls per step):")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:25]:
        lines.append(f"  {e.self_device_time_total / 1e3 / n:9.3f} ms  "
                     f"{e.count / n:6.1f}  {e.key[:110]}")
    print("\n".join(lines))


if __name__ == "__main__":
    main()
