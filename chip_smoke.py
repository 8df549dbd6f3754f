#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port of FSNet (``fsnet_tpu_torch``) on one NVIDIA
GPU and checks it: the quickest proof that the port starts on the card.

    python3 chip_smoke.py          # from the root of a checkout, one GPU

Phases, in order; any failure ends the run with a non-zero exit code:

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. builds the kernels from ``fsnet_tpu_torch/csrc`` (nvcc, sm_90a) and
   prints the build time and the compiler's register/spill report;
3. turns TF32 off for matrix products and cuDNN convolutions, so every
   float32 reference on the card is full float32;
4. holds the conv3x3 kernel against its plain version at each of the
   decoder's 14 conv shapes at batch 12 x 192x640, in float32 and bfloat16
   (max |kernel - plain| / max |plain| <= 1e-4 and 2e-2);
5. the main path: builds the flagship ``MonoDepthWPose`` (ResNet-18 +
   16-bin MultiChannelDepthDecoder, seeded random weights) on the card and
   runs one ``forward_test`` through ``make_eval_step`` at batch 12 x
   192x640, float32, with the launch counter set to 0 just before; checks
   that the decoder's convs ran at the 14 shapes of phase 4, each through
   the kernel (14 launches), and that depth is finite, [12, 192, 640, 1]
   and within [0.5, 100];
6. runs the same weights and input at batch 2 on the card and through the
   port on the CPU (plain versions) and compares depth (rel-max <= 1e-3);
7. times, with CUDA events after warm-up, ``forward_test`` at batch 1
   (latency) and batch 12 (images/s), and at each conv shape the kernel,
   its plain version and ``F.conv2d`` (a yardstick only; the port never
   calls it for these convs).

It prints the per-shape record and the kernel record as JSON lines and,
last, the result line ``{"ok": true, "device": {...}}``. It imports nothing
of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

BATCH, HEIGHT, WIDTH = 12, 192, 640
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# H100 SXM peaks (NVIDIA data sheet, 700 W): float32 outside the tensor
# cores, bf16 dense tensor cores, HBM3 bandwidth
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12

# (name, H, W, input part channels, Co, padding) of the decoder's 3x3
# convs at 192x640, in the order the main path runs them
SHAPES = [
    ("upconv_4_0", 6, 20, (512,), 256, "zeros"),
    ("upconv_4_1", 12, 40, (256, 256), 256, "replicate"),
    ("upconv_3_0", 12, 40, (256,), 128, "zeros"),
    ("upconv_3_1", 24, 80, (128, 128), 128, "replicate"),
    ("upconv_2_0", 24, 80, (128,), 64, "zeros"),
    ("upconv_2_1", 48, 160, (64, 64), 64, "replicate"),
    ("upconv_1_0", 48, 160, (64,), 32, "zeros"),
    ("upconv_1_1", 96, 320, (32, 64), 32, "replicate"),
    ("upconv_0_0", 96, 320, (32,), 16, "zeros"),
    ("upconv_0_1", 192, 640, (16,), 16, "replicate"),
    ("dispconv_0", 192, 640, (16,), 16, "replicate"),
    ("dispconv_1", 96, 320, (32,), 16, "replicate"),
    ("dispconv_2", 48, 160, (64,), 16, "replicate"),
    ("dispconv_3", 24, 80, (128,), 16, "replicate"),
]


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(B, H, W, Cs, Co, dtype):
    """Least time for one conv: max(operations / peak, bytes / bandwidth),
    each input read once and the output written once."""
    cin = sum(Cs)
    ops = 2.0 * 9 * B * H * W * cin * Co
    nbytes = torch.finfo(dtype).bits // 8 * (
        B * H * W * cin + 9 * cin * Co + Co + B * H * W * Co)
    t_ops, t_bytes = ops / PEAK_OPS[dtype], nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes
            else "bytes", t_ops * 1e3, t_bytes * 1e3)


def conv_inputs(B, H, W, Cs, Co, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    parts = [torch.randn(B, H, W, c, generator=g, device="cuda").to(dtype)
             for c in Cs]
    w = (torch.randn(3, 3, sum(Cs), Co, generator=g, device="cuda")
         / np.sqrt(9 * sum(Cs))).to(dtype)
    b = (0.1 * torch.randn(Co, generator=g, device="cuda")).to(dtype)
    return parts, w, b


def flagship_batch(batch: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    P2 = np.zeros((batch, 3, 4), np.float32)
    P2[:, 0, 0] = P2[:, 1, 1] = 0.58 * WIDTH
    P2[:, 0, 2], P2[:, 1, 2], P2[:, 2, 2] = WIDTH / 2, HEIGHT / 2, 1.0
    img = rng.rand(batch, HEIGHT, WIDTH, 3).astype(np.float32)
    return {"image/0": img, "P2": P2}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from fsnet_tpu_torch.entry import flagship_model
    from fsnet_tpu_torch.models.blocks import Conv3x3
    from fsnet_tpu_torch.ops import _build
    from fsnet_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_plain
    from fsnet_tpu_torch.runtime.state import make_eval_step

    record = {}
    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    record["card"] = smi

    # 2. build
    t0 = time.time()
    logs = _build.build_all()
    record["build_s"] = time.time() - t0
    print(f"kernels built in {record['build_s']:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # 3. full float32 references
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 4. kernel against its plain version at the main path's shapes
    shapes = []
    for i, (name, H, W, Cs, Co, pad) in enumerate(SHAPES):
        row = dict(name=name, B=BATCH, H=H, W=W, Cs=list(Cs), Co=Co, pad=pad)
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            parts, w, b = conv_inputs(BATCH, H, W, Cs, Co, dtype, seed=i)
            out = conv3x3(parts, w, b, pad)
            torch.cuda.synchronize()
            ref = conv3x3_plain(parts, w, b, pad)
            diff = (out.float() - ref.float()).abs().max().item()
            rel = diff / ref.float().abs().max().item()
            row[f"max_abs_err_{tag}"], row[f"rel_err_{tag}"] = diff, rel
            check(out.shape == ref.shape and bool(torch.isfinite(out).all()),
                  f"{name} {tag}: bad output")
            check(rel <= TOL[dtype], f"{name} {tag}: rel err {rel:.3e} > "
                  f"{TOL[dtype]:.0e}")
        print(f"check {name:11s} B{BATCH} {H}x{W} {'+'.join(map(str, Cs))}"
              f"->{Co} {pad:9s} rel err f32 {row['rel_err_f32']:.2e} "
              f"bf16 {row['rel_err_bf16']:.2e}")
        shapes.append(row)

    # 5. the main path, through the entry points a user calls
    model = flagship_model(HEIGHT, WIDTH, device="cuda", seed=0)
    eval_step = make_eval_step("cuda")
    seen = []
    hooks = [m.register_forward_pre_hook(lambda m, args: seen.append(args[0]))
             for m in model.modules() if isinstance(m, Conv3x3)]
    batch = flagship_batch(BATCH)
    conv3x3.launches = 0
    pred = eval_step(model, batch)
    torch.cuda.synchronize()
    launches = conv3x3.launches
    for h in hooks:
        h.remove()
    seen_shapes = []
    for x in seen:
        parts = x if isinstance(x, tuple) else (x,)
        seen_shapes.append((parts[0].shape[1], parts[0].shape[2],
                            tuple(p.shape[3] for p in parts)))
    want = [(H, W, Cs) for _, H, W, Cs, _, _ in SHAPES]
    check(sorted(seen_shapes) == sorted(want),
          f"main path conv shapes {seen_shapes} differ from {want}")
    check(launches == len(SHAPES), f"{launches} conv3x3 launches in one "
          f"forward, expected {len(SHAPES)}")
    depth = pred["depth"]
    check(tuple(depth.shape) == (BATCH, HEIGHT, WIDTH, 1),
          f"depth shape {tuple(depth.shape)}")
    check(bool(torch.isfinite(depth).all()), "depth has non-finite values")
    dmin, dmax = depth.min().item(), depth.max().item()
    check(0.5 <= dmin and dmax <= 100.0, f"depth range [{dmin}, {dmax}]")
    print(f"main path: forward_test bs{BATCH}@{HEIGHT}x{WIDTH} f32, "
          f"{launches} conv3x3 launches, depth in [{dmin:.4f}, {dmax:.4f}]")
    record["main_path"] = dict(launches=launches, depth_min=dmin,
                               depth_max=dmax)

    # 6. the card against the CPU port, same weights and input
    small = {k: v[:2] for k, v in batch.items()}
    on_card = eval_step(model, small)["depth"].cpu().numpy()
    cpu_model = flagship_model(HEIGHT, WIDTH, device="cpu", seed=0)
    on_cpu = make_eval_step("cpu")(cpu_model, small)["depth"].numpy()
    rel = float(np.abs(on_card - on_cpu).max() / np.abs(on_cpu).max())
    check(rel <= 1e-3, f"card vs CPU depth rel-max {rel:.3e} > 1e-3")
    print(f"card vs CPU port, bs2: depth rel-max {rel:.3e}")
    record["card_vs_cpu_rel"] = rel

    # 7. timings
    b1 = flagship_batch(1)
    lat = cuda_ms(lambda: eval_step(model, b1), iters=20, warmup=3)
    fwd12 = cuda_ms(lambda: eval_step(model, batch), iters=10, warmup=2)
    record["forward_test"] = dict(bs1_ms=lat, bs12_ms=fwd12,
                                  bs12_imgs_per_s=BATCH / fwd12 * 1e3)
    print(f"forward_test bs1 latency {lat:.3f} ms; bs12 {fwd12:.3f} ms = "
          f"{BATCH / fwd12 * 1e3:.1f} imgs/s")
    tot = dict(ms=0.0, plain_ms=0.0, ops_ms=0.0, bytes_ms=0.0,
               conv2d_ms=0.0)
    # the yardstick gets cuDNN's fastest algorithm: its first (warm-up)
    # call autotunes
    torch.backends.cudnn.benchmark = True
    for i, (row, (name, H, W, Cs, Co, pad)) in enumerate(zip(shapes, SHAPES)):
        parts, w, b = conv_inputs(BATCH, H, W, Cs, Co, torch.float32, seed=i)
        row["ms"] = cuda_ms(lambda: conv3x3(parts, w, b, pad), iters=20)
        row["plain_ms"] = cuda_ms(lambda: conv3x3_plain(parts, w, b, pad),
                                  iters=5)
        xc = torch.cat(parts, dim=-1).permute(0, 3, 1, 2)   # channels-last
        wc = w.permute(3, 2, 0, 1).contiguous()
        row["conv2d_ms"] = cuda_ms(lambda: F.conv2d(xc, wc, b, padding=1),
                                   iters=20)
        # one PyTorch call computes this very function only for a one-part
        # zero-padded conv
        row["library_ms"] = (row["conv2d_ms"] if len(Cs) == 1
                             and pad == "zeros" else None)
        (row["bound_ms"], row["bound_by"], ops_ms,
         bytes_ms) = bound(BATCH, H, W, Cs, Co, torch.float32)
        row["bf16_bound_ms"] = bound(BATCH, H, W, Cs, Co, torch.bfloat16)[0]
        for k in ("ms", "plain_ms", "conv2d_ms"):
            tot[k] += row[k]
        tot["ops_ms"] += ops_ms
        tot["bytes_ms"] += bytes_ms
        print(f"time  {name:11s} kernel {row['ms']:.4f} ms  plain "
              f"{row['plain_ms']:.4f} ms  F.conv2d {row['conv2d_ms']:.4f} ms"
              f"  bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    torch.backends.cudnn.benchmark = False
    record["shapes"] = shapes

    kernel = dict(
        name="conv3x3", route="cuda", source="fsnet_tpu_torch/csrc/conv3x3.cu",
        replaces="fsnet_tpu/ops/pallas/conv_kernel.py:210",
        launches=launches,
        max_abs_err=max(r["max_abs_err_f32"] for r in shapes),
        max_abs_err_bf16=max(r["max_abs_err_bf16"] for r in shapes),
        ms=tot["ms"], plain_ms=tot["plain_ms"],
        bound_ms=max(tot["ops_ms"], tot["bytes_ms"]),
        bound_by="operations" if tot["ops_ms"] >= tot["bytes_ms"] else "bytes",
        library_ms=None, conv2d_ms=tot["conv2d_ms"],
        note="ms, plain_ms, bound_ms, conv2d_ms: sums over the 14 decoder "
             "convs of one bs12 forward, float32")

    print(json.dumps(record))
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
