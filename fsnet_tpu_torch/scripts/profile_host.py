"""Where the host time of the flagship train step goes, float32 beside
bfloat16.

    python -m fsnet_tpu_torch.scripts.profile_host [--batch 12]
        [--steps 5] [--route {depth,grid}]

Builds the flagship ``MonoDepthWPose`` (seeded random weights) and the
``bench.py`` recipe on the CUDA device, the synthetic batch on the card
(``--route grid`` adds an all-ones ``patched_mask``), and for each of
``make_train_step(compute_dtype=None)`` and ``compute_dtype="bfloat16"``
warms up 3 steps, then prints the card's name and power limit, the wall
per step of ``--steps`` steps, the CUDA kernel launches of one step (the
profiler's host events) and a cProfile of ``--steps`` steps: the
cumulative host ms per step of the step's parts (the backward, the
forward, building the bf16 parameters, the optimizer) and the functions
with the most own time.
"""
from __future__ import annotations

import argparse
import cProfile
import pstats
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

_LAUNCH = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
           "cuLaunchKernelEx")
# the step's parts: (label, the file and the function that runs each, in
# cProfile's names)
_PARTS = (("backward (the autograd engine)", "graph.py",
           "_engine_run_backward"),
          ("forward_train", "monodepth2_model.py", "forward_train"),
          ("functional_call (bf16)", "functional_call.py", "functional_call"),
          ("bf16 parameters", "state.py", "low_params"),
          ("optimizer step", "optim.py", "step"))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=12)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--route", choices=("depth", "grid"), default="depth")
    args = ap.parse_args(argv)

    from ..entry import flagship_model, flagship_optimizer, synthetic_batch
    from ..runtime.state import make_train_step

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"{card}; flagship train step, {args.route} route, "
          f"bs{args.batch}@192x640")
    mask = "ones" if args.route == "grid" else None
    batch = {k: torch.from_numpy(v).cuda() for k, v in synthetic_batch(
        args.batch, 192, 640, patched_mask=mask).items()}
    for cdt in (None, "bfloat16"):
        model = flagship_model(192, 640, device="cuda", seed=0)
        opt, _ = flagship_optimizer(model)
        step = make_train_step("cuda", compute_dtype=cdt)
        for _ in range(3):
            step(model, opt, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(model, opt, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.steps * 1e3
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            step(model, opt, batch)
            torch.cuda.synchronize()
        launches = sum(e.count for e in prof.key_averages()
                       if e.key in _LAUNCH)
        prof_py = cProfile.Profile()
        prof_py.enable()
        for _ in range(args.steps):
            step(model, opt, batch)
        torch.cuda.synchronize()
        prof_py.disable()
        stats = pstats.Stats(prof_py)
        tag = cdt or "float32"
        print(f"== {tag}: wall {wall:.3f} ms a step; {launches} kernel "
              f"launches a step")
        for part, sfx, name in _PARTS:
            cum = sum(v[3] for (file, _, fn), v in stats.stats.items()
                      if fn == name and file.endswith(sfx))
            if cum:
                print(f"   {part:34s} {cum / args.steps * 1e3:8.3f} ms a "
                      "step (host, cProfile)")
        own = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:12]
        for (file, line, fn), v in own:
            print(f"   own {v[2] / args.steps * 1e3:8.3f} ms  {v[1]:6d} "
                  f"calls  {fn} ({file.rsplit('/', 1)[-1]}:{line})")
        del model, opt


if __name__ == "__main__":
    main()
