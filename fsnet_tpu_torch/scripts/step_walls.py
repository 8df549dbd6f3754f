"""Wall time of the port's train steps on the card, as ``chip_smoke.py``
times them (phases 11, 16, 21): 2 warm-up steps, then the mean of
``--steps`` steps with the batch on the card, TF32 off, float32.

    python fsnet_tpu_torch/scripts/step_walls.py [--tree DIR] [--tag TAG]
        [--paths depth grid_mask learned_pose fisheye] [--steps 10]

``--tree`` names the checkout whose ``fsnet_tpu_torch`` is timed (default:
the one this file lies in), so one copy of this script times a parent tree
unpacked beside the change: run it for each tree in turns (parent, change,
change, parent, ...) in one chip call. Prints one line ``WALLS <tag>
{"path": ms, ...}`` and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

PATHS = ("depth", "grid_mask", "learned_pose", "fisheye")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    ap.add_argument("--tag", default="")
    ap.add_argument("--paths", nargs="+", choices=PATHS, default=PATHS)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    import fsnet_tpu_torch
    from fsnet_tpu_torch.entry import (fisheye_batch, fisheye_model,
                                       flagship_model, flagship_optimizer,
                                       learned_pose_model, synthetic_batch)
    from fsnet_tpu_torch.runtime.state import make_train_step

    if not os.path.abspath(fsnet_tpu_torch.__file__).startswith(
            tree + os.sep):
        raise SystemExit(f"imported {fsnet_tpu_torch.__file__}, not the "
                         f"tree {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("step_walls: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build = {
        "depth": lambda: (flagship_model(192, 640, device="cuda", seed=0),
                          synthetic_batch(12, 192, 640)),
        "grid_mask": lambda: (flagship_model(192, 640, device="cuda", seed=0),
                              synthetic_batch(12, 192, 640, "ones")),
        "learned_pose": lambda: (learned_pose_model(192, 640, device="cuda",
                                                    seed=0),
                                 synthetic_batch(12, 192, 640)),
        "fisheye": lambda: (fisheye_model(384, 384, device="cuda", seed=0),
                            fisheye_batch(16, 384, 384)),
    }
    step = make_train_step("cuda")
    walls = {}
    for path in args.paths:
        model, batch = build[path]()
        opt, _ = flagship_optimizer(model)
        on_card = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
        for _ in range(2):
            step(model, opt, on_card)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(model, opt, on_card)
        torch.cuda.synchronize()
        walls[path] = (time.perf_counter() - t0) / args.steps * 1e3
        del model, opt, on_card
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card)
    print(f"WALLS {args.tag} {json.dumps(walls)}")


if __name__ == "__main__":
    main()
