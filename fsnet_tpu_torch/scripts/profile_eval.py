"""Where the time of the flagship eval step goes on the card.

    python -m fsnet_tpu_torch.scripts.profile_eval [--batch 12] [--iters 5]

Builds the flagship ``MonoDepthWPose`` (seeded random weights) on the CUDA
device with TF32 off, warms up, then runs ``--iters`` eval steps at 192x640
float32 under ``torch.profiler`` and prints: the wall time per step, the
device's busy and idle share of that window, device time by group (the
port's conv3x3 kernel, cuDNN convolutions, copies, everything else) and the
kernels with the most device time.
"""
from __future__ import annotations

import argparse
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile


def _group(name: str) -> str:
    if "conv3x3_nhwc" in name:
        return "conv3x3 kernel (decoder)"
    low = name.lower()
    if any(k in low for k in ("conv", "implicit", "wgrad", "dgrad", "sm90_",
                               "cudnn", "gemm")):
        return "cuDNN/cuBLAS (encoder convs)"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "elementwise/reduce/other"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=12)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)

    from ..entry import flagship_model
    from ..runtime.state import make_eval_step

    # full float32, as chip_smoke.py measures it: no TF32 in cuDNN/cuBLAS
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    H, W, B = 192, 640, args.batch
    model = flagship_model(H, W, device="cuda", seed=0)
    eval_step = make_eval_step("cuda")
    rng = np.random.RandomState(0)
    P2 = np.zeros((B, 3, 4), np.float32)
    P2[:, 0, 0] = P2[:, 1, 1] = 0.58 * W
    P2[:, 0, 2], P2[:, 1, 2], P2[:, 2, 2] = W / 2, H / 2, 1.0
    batch = {"image/0": rng.rand(B, H, W, 3).astype(np.float32), "P2": P2}
    for _ in range(3):
        eval_step(model, batch)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            eval_step(model, batch)
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
    lines = [f"{card}; torch {torch.__version__}; eval step bs{B}@{H}x{W} "
             f"float32, {n} steps under torch.profiler",
             f"wall per step {wall_ms / n:.3f} ms; device busy per step "
             f"{busy_ms / n:.3f} ms; idle share {1 - busy_ms / wall_ms:.3f}",
             "device time per step by group:"]
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        lines.append(f"  {ms / n:9.3f} ms  {100 * ms / busy_ms:5.1f}%  {g}")
    lines.append("top kernels (device ms per step, calls per step):")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:20]:
        lines.append(f"  {e.self_device_time_total / 1e3 / n:9.3f} ms  "
                     f"{e.count / n:5.1f}  {e.key[:110]}")
    print("\n".join(lines))


if __name__ == "__main__":
    main()
