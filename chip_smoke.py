#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port of FSNet (``fsnet_tpu_torch``) on one NVIDIA
GPU and checks it: the quickest proof that the port starts on the card.

    python3 chip_smoke.py          # from the root of a checkout, one GPU

Phases, in order; any failure ends the run with a non-zero exit code:

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. builds the kernels from ``fsnet_tpu_torch/csrc`` (nvcc, sm_90a, one
   process per source, all together) and prints the build time and the
   compiler's register/spill report;
3. turns TF32 off for matrix products and cuDNN convolutions, so every
   float32 number on the card (the encoder's convs included) is full
   float32;
4. holds the conv3x3 kernel against its plain version at each of the
   decoder's 14 conv shapes at batch 12 x 192x640, in float32 and bfloat16
   (max |kernel - plain| / max |plain| <= 1e-4 and 2e-2);
5. the eval path: builds the flagship ``MonoDepthWPose`` (ResNet-18 +
   16-bin MultiChannelDepthDecoder, seeded random weights) on the card and
   runs one ``forward_test`` through ``make_eval_step`` at batch 12 x
   192x640, float32, with the launch counters set to 0 just before; checks
   that the decoder's convs ran at the 14 shapes of phase 4, each through
   the kernel (14 launches, no other kernel), and that depth is finite,
   [12, 192, 640, 1] and within [0.5, 100];
6. runs the same weights and input at batch 2 on the card and through the
   port on the CPU (plain versions) and compares depth (rel-max <= 1e-3);
7. times, with CUDA events after warm-up, ``forward_test`` at batch 1
   (latency) and batch 12 (images/s), and at each conv shape the kernel,
   its plain version and ``F.conv2d`` (a yardstick only; the port never
   calls it for these convs);
8. holds the training kernels against their plain versions at the shapes
   the train step gives them at batch 12 x 192x640: the conv's moments
   epilogue at the 10 upconv shapes, the input cotangent (the conv kernel
   on the flipped weight) and the weight cotangent at all 14 (max error /
   max |plain| <= 2e-5 for out, s2, dx and dw; s1 against the sum of
   |out|), and the depth-direct warp forward (max abs err <= 1e-6, the
   overlap equal) and backward (<= 1e-6 relative) at 96 warps (4 scales x
   2 frames x 12); prints how many samples the TPU kernel's lane-window
   clamp would have moved there;
9. the train path: ``flagship_model(..., device="cuda")`` with the
   ``bench.py`` recipe (Adam lr 1e-4, clip 1.0, StepLR) and
   ``make_train_step("cuda")``, three steps at batch 12 x 192x640 on the
   synthetic KITTI-like batch, the launch counters set to 0 just before;
   checks the launches of every kernel per step, a finite loss, and that
   parameters and BN running statistics changed;
10. one train step at batch 2 x 192x640 on the card against the port on the
    CPU from the same weights and batch, held to the JAX package's own
    backward gate between two routes (``scripts/tpu_smoke.py``): loss rel
    <= 1e-4, global gradient rel-L2 < 3e-2, every leaf < 0.5 (the worst is
    printed), and Adam's first update differing by more than lr / 2 on
    under 2% of the parameters. In float32 the two sides' decoder outputs
    differ by about 1e-6 (cuDNN and the kernels against the CPU), which
    moves bilinear corners of the warp wherever a coordinate lies that
    close to an integer; each such sample moves the gradient of its pixel
    by O(1);
11. times the train step at batch 12 (images/s over 10 steps after
    warm-up; the batch on the card, as ``bench.py`` times the JAX step, and
    again from host numpy arrays) and each training kernel at its shapes beside its plain
    version, its bound and, where one PyTorch call computes the same
    function, that call (cuDNN's conv backward for the single-part
    zero-padded convs; a yardstick only);
12. holds the grid warp's kernels against their plain versions at the grid
    route's shapes at batch 12: 96 reprojection grids @192x640 (4 scales x
    2 frames x 12) against the 24 source frames for kernel F (bilinear,
    border, C=3: out, va, vb) and against the 12 patched masks for kernel E
    (nearest, zeros, C=1), max abs err <= 1e-6 and the ``== 1.0`` overlap
    equal; prints how many samples the TPU kernel's lane-window clamp would
    have moved there;
13. the grid route of the flagship: three train steps at batch 12 x
    192x640 on the synthetic batch with an all-ones ``patched_mask`` (as
    every dataset batch carries one), the launch counters set to 0 just
    before; checks per step kernel F 1 launch, kernel E 1, the depth-direct
    kernels 0 and the conv kernels as in phase 9, a finite loss and changed
    parameters and BN statistics; then one step from the same weights with
    and one without the mask (the depth-direct route): loss rel <= 1e-4 and
    global gradient rel-L2 < 3e-2 between the two routes;
14. the learned-pose ``MonoDepthMeta``: three train steps at batch 12, the
    counters set to 0 just before; per step kernel F 1 launch, kernel E 0,
    the depth-direct kernels 0, the conv kernels as in phase 9; a finite
    loss and changed pose parameters;
15. one ``MonoDepthMeta`` step at batch 2 on the card against the port on
    the CPU, held to phase 10's gate;
16. times both grid-route steps at batch 12 (images/s over 10 steps after
    warm-up, the batch on the card) and kernels E and F beside their plain
    versions and bounds (``F.grid_sample``, another function without the
    band, is timed beside them as a yardstick only);
17. the KITTI-360 fisheye recipe (bs 16 @ 384x384, Mei camera, band 16):
    holds kernels G (the norm-direct warp with its mask pass) and H (the
    norm cotangent) against their plain versions on the fisheye batch's
    rays, camera and poses at 128 warps against 32 sources and 16 masks
    (max abs err <= 1e-6 for out, va and vb, the overlap equal, d norm rel
    <= 1e-6), prints how many samples have a corner row outside the band
    (all, and those with a valid ray), in how many rows the pixels outside
    the fisheye disc pull the band start down, and how many samples the TPU
    lane-window clamp would move (none can at W = 384), and holds the conv
    kernels (forward, moments, dx, dw) against
    their plain versions at the 14 decoder shapes of 384x384, batch 16;
18. ``forward_test`` of ``fisheye_model`` at batch 16 through
    ``make_eval_step``: 14 conv launches and no other kernel, finite
    z-depth, norm and fisheye mask of the right shapes, the norm within
    [0.1, 150] and the mask the ray map's;
19. three fisheye train steps at batch 16, the counters set to 0 just
    before: per step kernels G and H 1 launch each, A, B, E and F none, the
    conv kernels as in phase 9; a finite loss and changed parameters and BN
    statistics;
20. one fisheye step at batch 2 on the card against the port on the CPU,
    held to phase 10's gate; then one step at batch 16 from the same
    weights on the norm-direct route (G, H) and one on the fisheye grid
    route (F, E at band 16, forced by leaving out the marker of dataset
    poses): loss rel <= 1e-4 and global gradient rel-L2 < 3e-2;
21. times the fisheye step at batch 16 (images/s over 10 steps, the batch
    on the card) and kernels G and H beside their plain versions and bounds
    (``F.grid_sample`` at the Mei grid as a yardstick only);
22. holds the photometric loss kernels (``csrc/photo_loss.cu``: the
    forward, kernel I, and the prediction cotangent, kernel J) against their
    plain versions on the loss's own operands at both recipes: the warped
    stack (phase 8's depth-direct warp of the synthetic batch's clipped
    textures, 96 warps @192x640; kernel G's 128 warps @384x384) and the
    identity stack (24 and 32 sources) against the 12 and 16 targets. The
    forward within 1e-6 of the largest loss (the share of bitwise-equal
    pixels printed), the cotangent of the warped stack within 1e-5 of its
    largest entry against the plain cotangent and against autograd of the
    plain forward on the card; prints the exact ties each stack holds (zero
    variance, SSIM dissimilarity at 0 and at 1, pred == target), and times
    both kernels beside their plain versions and bounds, summed over one
    step's launches at each recipe.

23. the DLA path: ``dla_model`` (``dlanet(34)`` under ``DLASegUpsample``,
    seeded weights, every offset conv perturbed so that the offsets spread
    by about 1.5 px) at batch 12 x 192x640: at each of its 16 deformable
    convs, the input and the 9-tap grid of a train-mode forward, kernel E
    (bilinear, zeros, band 8) against its plain version (max abs err
    <= 1e-6) and kernel K (``csrc/warp_grad.cu``: gfx, gfy and the image
    cotangent) against its plain version (within 1e-5 of each one's largest
    entry); prints how many samples fall outside the band of 8 rows;
24. the DLA serving forward (``train=False``) through ``make_eval_step``,
    the counters set to 0 just before: E 16 launches (one per DCN, its
    taps batched), K and every other kernel none; the output
    [12, 48, 160, 64] finite;
25. three DLA train steps (the loss ``sum(out * target_weight)``, the
    ``bench.py`` recipe), the counters set to 0 just before: per step E 16
    and K 16, nothing else; a finite loss and changed parameters and BN
    statistics; then one step at batch 2 on the card against the CPU port
    with every BN on its init statistics (``dla_model(norm_frozen=True)``),
    held to phase 10's gate; and, as a reading with only the loss held to
    1e-4, the train-mode step at batch 2 on the card against the CPU port
    and the CPU port's float32 step against its float64 step (float32
    rounding alone moves that gradient by several percent:
    ``scripts/dla_conditioning.py``);
26. times E and K summed over the 16 DCNs of one step beside their plain
    versions, bounds and yardsticks (``F.grid_sample`` and
    ``grid_sampler_2d_backward``, exact, without the band), then the DLA
    step at batch 12 (10 steps, the batch on the card; its peak memory)
    and its forward.

Every train step (phases 9, 13, 14, 19) launches the forward kernel twice
(the warped stack and the identity stack) and the cotangent kernel once;
``forward_test`` launches neither.

It prints the record and the kernel line as JSON lines and, last, the
result line ``{"ok": true, "device": {...}}``. It imports nothing of JAX or
of the JAX package.
"""
from __future__ import annotations

import functools
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

def decoder_shapes(H, W):
    """(name, H, W, input part channels, Co, padding) of the decoder's 14
    3x3 convs at an H x W input, in the order the main path runs them."""
    ch, enc = (16, 32, 64, 128, 256), (64, 64, 128, 256, 512)
    out = []
    for i in range(4, -1, -1):
        out.append((f"upconv_{i}_0", H >> (i + 1), W >> (i + 1),
                    (enc[4] if i == 4 else ch[i + 1],), ch[i], "zeros"))
        out.append((f"upconv_{i}_1", H >> i, W >> i,
                    (ch[i], enc[i - 1]) if i else (ch[i],), ch[i],
                    "replicate"))
    for s in range(4):
        out.append((f"dispconv_{s}", H >> s, W >> s, (ch[s],), 16,
                    "replicate"))
    return out


SHAPES = decoder_shapes(HEIGHT, WIDTH)
# the KITTI-360 fisheye recipe (configs/kitti360_fisheye_example.py)
FISH_BATCH, FISH_H, FISH_W, FISH_BAND = 16, 384, 384, 16
FISH_SHAPES = decoder_shapes(FISH_H, FISH_W)


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


def launch_counters():
    """The launch counter of every kernel wrapper, by kernel name."""
    from fsnet_tpu_torch.ops import conv3x3 as tc
    from fsnet_tpu_torch.ops import photo_loss as tpl
    from fsnet_tpu_torch.ops import warp_depth as twd
    from fsnet_tpu_torch.ops import warp_fast as twf
    from fsnet_tpu_torch.ops import warp_mei as twm

    return {"conv3x3": tc.conv3x3, "conv3x3_bn": tc.conv3x3_bn,
            "conv3x3_dx": tc.conv3x3_dx, "conv3x3_dw": tc.conv3x3_dw,
            "warp_depth_fwd": twd.warp_depth_fwd,
            "warp_depth_bwd": twd.warp_depth_bwd,
            "warp_grid_fused": twf.grid_band_fused,
            "warp_grid_fwd": twf.grid_band_fwd,
            "warp_grid_bwd": twf.grid_band_bwd,
            "warp_mei_fwd": twm.warp_mei_fwd,
            "warp_mei_bwd": twm.warp_mei_bwd,
            "photo_loss_fwd": tpl.photo_loss_fwd,
            "photo_loss_bwd": tpl.photo_loss_bwd}


def zero(counters) -> None:
    for fn in counters.values():
        fn.launches = 0


def read(counters):
    return {k: fn.launches for k, fn in counters.items()}


def rel_err(got, ref, scale=None):
    """(max |got - ref|, that over ``scale`` or max |ref|)."""
    diff = (got.double() - ref.double()).abs().max().item()
    den = ref.double().abs().max().item() if scale is None else scale
    return diff, diff / max(den, 1e-30)


def ms_bound(ops, nbytes):
    """(bound ms, what bounds it): float32 operations at the peak outside
    the tensor cores, bytes at the HBM rate."""
    t_ops, t_bytes = ops / PEAK_OPS[torch.float32], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def sum_bounds(items):
    """Sum of per-shape (ops, bytes) -> (bound ms, what bounds the sum)."""
    return ms_bound(sum(o for o, _ in items), sum(b for _, b in items))


# (S scales, F frames) of the flagship's warp
S_SCALES, F_FRAMES, BAND = 4, 2, 4


def lane_window_moves(x, W, L=128, window=3, nearest=False):
    """Samples whose corner columns the TPU kernels' lane window
    (``prep_kernel.py:150-164``, ``warp_kernel.py:236-309``) would have
    clamped: per output row and 128-lane output tile the columns are held
    to ``window`` tiles ending at the tile of the row's largest right
    corner. ``x`` [N, H, W] unclamped; bilinear corners of the border
    clamp, or with ``nearest`` those of the unclamped nearest warp."""
    T = W // L
    if T * L != W:
        return None
    kw = min(window, T)
    x0f = torch.floor(x + 0.5) if nearest else torch.floor(x.clamp(0.0, W - 1))
    x0 = x0f.clamp(0, W - 1).long()
    x1 = (x0f + 1).clamp(0, W - 1).long()
    hi = x1.view(*x1.shape[:2], T, L).amax(dim=-1) // L          # [N, H, T]
    lo = ((hi - (kw - 1)).clamp(0, T - kw) * L).repeat_interleave(L, dim=-1)
    hic = lo + kw * L - 1
    moved = (x0 < lo) | (x0 > hic) | (x1 < lo) | (x1 > hic)
    return int(moved.sum().item())


def warp_scene(batch_np, seed=0):
    """The warp's operands at the flagship batch: sources, per-scale depth
    and the projection rows of the batch's GT poses."""
    from fsnet_tpu_torch.ops.geometry import invert_K, make_K44
    from fsnet_tpu_torch.ops.warp_depth import make_affine_rows

    dev = "cuda"
    B = batch_np["P2"].shape[0]
    g = torch.Generator(device=dev).manual_seed(seed)
    image = torch.cat([torch.from_numpy(batch_np[f"original_image/{f}"])
                       for f in (1, -1)]).to(dev).contiguous()
    depth = (2.0 + 40.0 * torch.rand(S_SCALES * B, HEIGHT, WIDTH,
                                     generator=g, device=dev))
    K = make_K44(torch.from_numpy(batch_np["P2"]).to(dev))
    Ts = torch.stack([torch.from_numpy(batch_np[f"relative_pose/{f}"])
                      for f in (1, -1)]).to(dev)
    return image, depth, make_affine_rows(K, invert_K(K), Ts, S_SCALES)


def check_conv_kernels(B, shapes, rows, forward=False):
    """The conv kernels against their plain versions at ``shapes`` and
    batch ``B``, float32: with ``forward`` the conv (rel <= 1e-4, as phase
    4), the moments epilogue at the upconvs, the input and the weight
    cotangent at all (rel <= 2e-5). Returns the max abs errors by kernel."""
    from fsnet_tpu_torch.ops import conv3x3 as tc

    errs = {k: 0.0 for k in ("conv3x3", "conv3x3_bn", "conv3x3_bn_mom",
                             "conv3x3_dx", "conv3x3_dw")}
    for i, (name, H, W, Cs, Co, pad) in enumerate(shapes):
        parts, w, b = conv_inputs(B, H, W, Cs, Co, torch.float32, seed=i)
        gy = torch.randn(B, H, W, Co, device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(100 + i))
        row = rows[i]
        if forward:
            out = tc.conv3x3(parts, w, b, pad)
            torch.cuda.synchronize()
            d, e = rel_err(out, tc.conv3x3_plain(parts, w, b, pad))
            errs["conv3x3"] = max(errs["conv3x3"], d)
            row["rel_err"] = e
            check(e <= TOL[torch.float32], f"{name} conv: rel err {e:.2e}")
        if name.startswith("upconv_"):
            out, s1, s2 = tc.conv3x3_bn(parts, w, b, pad)
            torch.cuda.synchronize()
            ref = tc.conv3x3_plain(parts, w, b, pad)
            r1, r2 = tc.moments_plain(ref)
            d_out, e_out = rel_err(out, ref)
            # s1 sums values of both signs: its scale is the sum of |out|
            d1, e1 = rel_err(s1, r1, ref.abs().sum((0, 1, 2)).max().item())
            d2, e2 = rel_err(s2, r2)
            row.update(bn_rel_err=e_out, s1_rel_err=e1, s2_rel_err=e2)
            errs["conv3x3_bn"] = max(errs["conv3x3_bn"], d_out)
            errs["conv3x3_bn_mom"] = max(errs["conv3x3_bn_mom"], d1, d2)
            check(e_out <= 2e-5 and e1 <= 2e-5 and e2 <= 2e-5,
                  f"{name} moments kernel: rel err out {e_out:.2e} s1 "
                  f"{e1:.2e} s2 {e2:.2e} > 2e-5")
        dxs = tc.conv3x3_dx(gy, w, pad, Cs)
        dw = tc.conv3x3_dw(parts, gy, pad)
        torch.cuda.synchronize()
        ref_dxs = tc.conv3x3_dx_plain(gy, w, pad, Cs)
        ref_dw = tc.conv3x3_dw_plain(parts, gy, pad)
        e_dx = 0.0
        for a, r in zip(dxs, ref_dxs):
            d, e = rel_err(a, r)
            errs["conv3x3_dx"] = max(errs["conv3x3_dx"], d)
            e_dx = max(e_dx, e)
        d, e_dw = rel_err(dw, ref_dw)
        errs["conv3x3_dw"] = max(errs["conv3x3_dw"], d)
        row.update(dx_rel_err=e_dx, dw_rel_err=e_dw)
        check(e_dx <= 2e-5, f"{name} dx: rel err {e_dx:.2e} > 2e-5")
        check(e_dw <= 2e-5, f"{name} dw: rel err {e_dw:.2e} > 2e-5")
        print(f"check {name:11s} B{B} {H}x{W} conv kernels: rel err "
              + (f"conv {row['rel_err']:.2e} " if forward else "")
              + (f"bn out {row['bn_rel_err']:.2e} s1 {row['s1_rel_err']:.2e} "
                 f"s2 {row['s2_rel_err']:.2e} " if "bn_rel_err" in row else "")
              + f"dx {e_dx:.2e} dw {e_dw:.2e}")
    return errs


def check_training_kernels(batch_np, rows):
    """Phase 8: each training kernel against its plain version, on the
    card, at the train path's shapes. Returns per-kernel errors and the
    inputs the timings reuse."""
    from fsnet_tpu_torch.ops import warp_depth as twd
    from fsnet_tpu_torch.ops.geometry import project_rows

    errs = check_conv_kernels(BATCH, SHAPES, rows)
    image, depth, arows = warp_scene(batch_np)
    got = twd.warp_depth_fwd(image, depth, arows, S_SCALES, F_FRAMES, BAND)
    gy = torch.randn(got[0].shape, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(7))
    dd = twd.warp_depth_bwd(depth, gy, got[2], got[3], arows, S_SCALES,
                            F_FRAMES)
    torch.cuda.synchronize()
    ref = twd.warp_depth_plain(image, depth, arows, S_SCALES, F_FRAMES, BAND)
    dd_ref = twd.warp_depth_bwd_plain(depth, gy, ref[2], ref[3], arows,
                                      S_SCALES, F_FRAMES)
    ov_diff = int((got[1] != ref[1]).sum().item())
    fwd = max(rel_err(a, r)[0] for a, r in zip((got[0], got[2], got[3]),
                                              (ref[0], ref[2], ref[3])))
    d_dd, e_dd = rel_err(dd, dd_ref)
    errs["warp_depth_fwd"], errs["warp_depth_bwd"] = fwd, d_dd
    x = project_rows(twd._per_warp_depth(depth, S_SCALES, F_FRAMES),
                     arows)["x"]
    moved = lane_window_moves(x, WIDTH)
    print(f"check warp N={arows.shape[0]} {HEIGHT}x{WIDTH} band {BAND}: "
          f"fwd max abs err {fwd:.2e} (out, va, vb), overlap mismatches "
          f"{ov_diff}, d depth rel err {e_dd:.2e}; TPU lane-window clamp "
          f"would move {moved} of {x.numel()} samples")
    check(ov_diff == 0 and fwd <= 1e-6, "warp forward kernel disagrees")
    check(e_dd <= 1e-6, f"warp backward kernel: rel err {e_dd:.2e} > 1e-6")
    return errs, dict(image=image, depth=depth, arows=arows, gy=gy,
                      va=got[2], vb=got[3], lane_window_moves=moved,
                      samples=x.numel())


def white_noise_images(batch_np, seed=7):
    """The batch with its images replaced by white noise in [0, 1): the
    synthetic textures are so smooth that many 3x3 SSIM windows have a
    variance at float32 rounding level, where the variance clamp switches
    their gradient on and off at random."""
    rng = np.random.RandomState(seed)
    out = dict(batch_np)
    for key in sorted(out):
        if key.startswith(("image/", "original_image/")):
            out[key] = rng.rand(*out[key].shape).astype(np.float32)
    return out


def bn_cancelled(name):
    """Conv biases right before train-mode BN (the decoder's ConvBnReLU
    blocks, the DLA head's deformable convs): BN removes them, so their
    exact gradient is 0 and both sides hold rounding noise."""
    return name.endswith(".conv.bias") and any(
        k in name for k in (".upconv_", ".proj_", ".node_"))


def grad_rel_l2(g_a, g_b):
    """Global rel-L2 of the gradients ``g_a`` against ``g_b`` (by parameter
    name), without the BN-cancelled biases."""
    kept = [k for k in g_b if not bn_cancelled(k)]
    num = sum(float(((g_a[k].double() - g_b[k].double()) ** 2).sum())
              for k in kept)
    den = sum(float((g_b[k].double() ** 2).sum()) for k in kept)
    return (num / den) ** 0.5


def one_step(build, batch, dev, H, W, dtype=torch.float32):
    """(loss, gradients, first Adam updates) of one train step of
    ``build(H, W, ...)`` from its seeded weights, on ``dev`` in ``dtype``
    (float64 only on the CPU, through the plain versions)."""
    from fsnet_tpu_torch.entry import flagship_optimizer
    from fsnet_tpu_torch.ops import warp_fast as twf
    from fsnet_tpu_torch.runtime.state import make_train_step

    m = build(H, W, device=dev, seed=0).to(dtype)
    o, _ = flagship_optimizer(m)
    start = {k: p.detach().cpu().double().clone()
             for k, p in m.named_parameters()}
    if dtype == torch.float64:
        batch = {k: v.astype(np.float64) for k, v in batch.items()}
    dtypes, twf._DTYPES = twf._DTYPES, (dtype,)
    try:
        met = make_train_step(dev, with_grads=True)(m, o, batch)
    finally:
        twf._DTYPES = dtypes
    return (float(met["loss"]),
            {k: g.detach().cpu().double() for k, g in met["_grads"].items()},
            {k: p.detach().cpu().double() - start[k]
             for k, p in m.named_parameters()})


def card_vs_cpu(build, batch, what, H=HEIGHT, W=WIDTH):
    """One train step of ``build(H, W, ...)`` on the card and through the
    port on the CPU, from the same seeded weights and ``batch``, held to the
    JAX package's own backward gate between two routes: loss rel <= 1e-4,
    global gradient rel-L2 < 3e-2, every leaf < 0.5, Adam's first update
    off by more than lr / 2 on under 2% of the parameters."""
    (l_card, g_card, u_card) = one_step(build, batch, "cuda", H, W)
    (l_cpu, g_cpu, u_cpu) = one_step(build, batch, "cpu", H, W)
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    grad_rel = grad_rel_l2(g_card, g_cpu)
    zero = [k for k in g_cpu if not bool(g_cpu[k].any())]
    check(all(not bool(g_card[k].any()) for k in zero),
          f"{what}: gradients zero on the CPU but not on the card: {zero}")
    leaf = {k: float((g_card[k] - g_cpu[k]).norm() / g_cpu[k].norm())
            for k in g_cpu if not bn_cancelled(k) and k not in zero}
    worst = max(leaf, key=leaf.get)
    lr = 1e-4
    n_upd = sum(u.numel() for u in u_cpu.values())
    upd_frac = sum(int(((u_card[k] - u_cpu[k]).abs() > lr / 2).sum())
                   for k in u_cpu) / n_upd
    bs = next(iter(batch.values())).shape[0]
    print(f"card vs CPU port, {what} bs{bs}@{H}x{W}: loss "
          f"{l_card:.6f} vs {l_cpu:.6f} (rel {loss_rel:.2e}), global grad "
          f"rel-L2 {grad_rel:.2e}, worst leaf {worst} {leaf[worst]:.2e}, "
          f"Adam updates differing by > lr/2: {upd_frac:.4%}")
    check(loss_rel <= 1e-4, f"{what}: card vs CPU loss rel {loss_rel:.2e} "
          "> 1e-4")
    check(grad_rel < 3e-2, f"{what}: card vs CPU grad rel-L2 "
          f"{grad_rel:.2e} >= 3e-2")
    check(leaf[worst] < 0.5, f"{what}: card vs CPU grad of {worst}: rel-L2 "
          f"{leaf[worst]:.2e} >= 0.5")
    check(upd_frac < 0.02, f"{what}: card vs CPU Adam updates differ on "
          f"{upd_frac:.2%} of the parameters")
    return dict(loss_rel=loss_rel, grad_rel_l2=grad_rel, worst_leaf=worst,
                worst_leaf_rel_l2=leaf[worst], adam_update_differs=upd_frac,
                zero_gradient_leaves=zero)


def drive_steps(model, opt, batch, counters, want, what, steps=3,
                size=f"bs{BATCH}@{HEIGHT}x{WIDTH}"):
    """Phases 9, 13, 14, 19: ``steps`` train steps through ``make_train_step``,
    the launch counters set to 0 just before and read just after; checks
    the launches per step against ``want``, finite losses, and that the
    parameters and BN running variances changed."""
    from fsnet_tpu_torch.runtime.state import make_train_step

    step = make_train_step("cuda")
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    s0 = {n: b.clone() for n, b in model.named_buffers()
          if n.endswith("running_var")}
    zero(counters)
    losses = []
    for _ in range(steps):
        losses.append(float(step(model, opt, batch)["loss"]))
    torch.cuda.synchronize()
    counts = read(counters)
    print(f"{what}: {steps} steps {size} f32, "
          f"losses {losses}, launches {counts}")
    check(all(np.isfinite(losses)), f"{what}: non-finite loss {losses}")
    check(counts == {k: n * steps for k, n in want.items()},
          f"{what} launches {counts}, expected per step {want}")
    changed = {n for n, p in model.named_parameters()
               if bool((p.detach() != p0[n]).any())}
    stats_moved = sum(int((b != s0[n]).any().item())
                      for n, b in model.named_buffers() if n in s0)
    check(len(changed) >= len(p0) - 10 and stats_moved == len(s0),
          f"{what}: {len(changed)} of {len(p0)} parameters and {stats_moved} "
          f"of {len(s0)} BN variances changed")
    return dict(steps=steps, losses=losses, launches=counts,
                launches_per_step=want, params_changed=len(changed),
                params=len(p0), unchanged=sorted(set(p0) - changed))


def train_phases(counters, record):
    """Phases 8-11. Returns the launch counts of the train path and the
    kernel line's entries of the training kernels."""
    import torch.nn.functional as F

    from fsnet_tpu_torch.entry import (flagship_model, flagship_optimizer,
                                       synthetic_batch)
    from fsnet_tpu_torch.ops import conv3x3 as tc
    from fsnet_tpu_torch.ops import warp_depth as twd
    from fsnet_tpu_torch.runtime.state import make_train_step

    rows = [dict(name=n) for n, *_ in SHAPES]
    batch = synthetic_batch(BATCH, HEIGHT, WIDTH)

    # 8. training kernels against their plain versions
    errs, warp_in = check_training_kernels(batch, rows)
    record["lane_window_moves"] = dict(moved=warp_in["lane_window_moves"],
                                       samples=warp_in["samples"])

    # 9. the train path, three steps at bs12
    model = flagship_model(HEIGHT, WIDTH, device="cuda", seed=0)
    opt, _ = flagship_optimizer(model)
    step = make_train_step("cuda")
    n_dx = sum(len(Cs) for _, _, _, Cs, _, _ in SHAPES)
    want = dict(conv3x3=4, conv3x3_bn=10, conv3x3_dx=n_dx,
                conv3x3_dw=len(SHAPES), warp_depth_fwd=1, warp_depth_bwd=1,
                warp_grid_fused=0, warp_grid_fwd=0, warp_grid_bwd=0,
                warp_mei_fwd=0,
                warp_mei_bwd=0, photo_loss_fwd=2, photo_loss_bwd=1)
    record["train_path"] = drive_steps(model, opt, batch, counters, want,
                                       "train path")
    counts = record["train_path"]["launches"]

    # 10. one step at bs2 on the card against the port on the CPU
    small = white_noise_images({k: v[:2] for k, v in batch.items()})
    record["train_card_vs_cpu"] = card_vs_cpu(flagship_model, small,
                                              "train step")

    # 11. timings: the train step with the batch on the card (as bench.py
    # times the JAX step) and from host numpy arrays (pageable copies
    # included), then each training kernel
    on_card = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    n_steps = 10

    def step_ms(b):
        for _ in range(2):
            step(model, opt, b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step(model, opt, b)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n_steps * 1e3

    torch.cuda.reset_peak_memory_stats()
    ms_card = step_ms(on_card)
    peak = torch.cuda.max_memory_allocated() / 1e9
    ms_host = step_ms(batch)
    record["train_step"] = dict(bs=BATCH, ms=ms_card,
                                imgs_per_s=BATCH / ms_card * 1e3,
                                ms_from_host=ms_host, peak_mem_gb=peak)
    print(f"train step bs{BATCH}@{HEIGHT}x{WIDTH} f32 (mean of {n_steps}): "
          f"batch on the card {ms_card:.3f} ms = "
          f"{BATCH / ms_card * 1e3:.2f} imgs/s (peak memory {peak:.3f} GB); "
          f"from host numpy {ms_host:.3f} ms = "
          f"{BATCH / ms_host * 1e3:.2f} imgs/s")

    torch.backends.cudnn.benchmark = True      # the yardstick's best
    tot = {k: dict(ms=0.0, plain_ms=0.0, items=[], lib_ms=0.0,
                   lib_kernel_ms=0.0, lib_shapes=[])
           for k in ("conv3x3_bn", "conv3x3_dx", "conv3x3_dw")}
    for i, (name, H, W, Cs, Co, pad) in enumerate(SHAPES):
        parts, w, b = conv_inputs(BATCH, H, W, Cs, Co, torch.float32, seed=i)
        gy = torch.randn(BATCH, H, W, Co, device="cuda")
        n, cin = BATCH * H * W, sum(Cs)
        row = rows[i]
        timed = {}
        if name.startswith("upconv_"):
            timed["conv3x3_bn"] = (
                lambda: tc.conv3x3_bn(parts, w, b, pad),
                lambda: tc.moments_plain(tc.conv3x3_plain(parts, w, b, pad)),
                (2.0 * 9 * n * cin * Co + 3.0 * n * Co,
                 4.0 * (n * cin + 9 * cin * Co + Co + n * Co + 2 * Co)), None)
        lib = len(Cs) == 1 and pad == "zeros"
        xc = parts[0].permute(0, 3, 1, 2)
        wc = w.permute(3, 2, 0, 1).contiguous()
        gc = gy.permute(0, 3, 1, 2)
        timed["conv3x3_dx"] = (
            lambda: tc.conv3x3_dx(gy, w, pad, Cs),
            lambda: tc.conv3x3_dx_plain(gy, w, pad, Cs),
            (2.0 * 9 * n * Co * cin,
             4.0 * (n * Co + 9 * cin * Co + n * cin)),
            (lambda: torch.nn.grad.conv2d_input(xc.shape, wc, gc, padding=1))
            if lib else None)
        timed["conv3x3_dw"] = (
            lambda: tc.conv3x3_dw(parts, gy, pad),
            lambda: tc.conv3x3_dw_plain(parts, gy, pad),
            (2.0 * 9 * n * cin * Co,
             4.0 * (n * cin + n * Co + 9 * cin * Co)),
            (lambda: torch.nn.grad.conv2d_weight(xc, wc.shape, gc, padding=1))
            if lib else None)
        for k, (fn, plain, ob, library) in timed.items():
            t = tot[k]
            ms = cuda_ms(fn, iters=10)
            t["ms"] += ms
            t["plain_ms"] += cuda_ms(plain, iters=3, warmup=1)
            t["items"].append(ob)
            row[f"{k}_ms"] = ms
            row[f"{k}_bound_ms"] = ms_bound(*ob)[0]
            if library is not None:
                row[f"{k}_library_ms"] = cuda_ms(library, iters=10)
                t["lib_ms"] += row[f"{k}_library_ms"]
                t["lib_kernel_ms"] += ms
                t["lib_shapes"].append(name)
        print(f"time  {name:11s} "
              + " ".join(f"{k[8:]} {row[f'{k}_ms']:.4f} ms (bound "
                         f"{row[f'{k}_bound_ms']:.4f})" for k in timed))
    torch.backends.cudnn.benchmark = False
    record["train_shapes"] = rows

    # the warp at N = 96
    img, dep, ar = warp_in["image"], warp_in["depth"], warp_in["arows"]
    N, C = ar.shape[0], img.shape[-1]
    FB, SB, px = img.shape[0], dep.shape[0], N * HEIGHT * WIDTH
    warp_t = {
        "warp_depth_fwd": (
            lambda: twd.warp_depth_fwd(img, dep, ar, S_SCALES, F_FRAMES, BAND),
            lambda: twd.warp_depth_plain(img, dep, ar, S_SCALES, F_FRAMES,
                                         BAND),
            (px * (32.0 + 14.0 * C),
             4.0 * (FB * HEIGHT * WIDTH * C + SB * HEIGHT * WIDTH + N * 16)
             + px * (3 * 4.0 * C + 1))),
        "warp_depth_bwd": (
            lambda: twd.warp_depth_bwd(dep, warp_in["gy"], warp_in["va"],
                                       warp_in["vb"], ar, S_SCALES, F_FRAMES),
            lambda: twd.warp_depth_bwd_plain(dep, warp_in["gy"],
                                             warp_in["va"], warp_in["vb"], ar,
                                             S_SCALES, F_FRAMES),
            (px * (40.0 + 4.0 * C),
             4.0 * (3 * px * C + 2 * SB * HEIGHT * WIDTH + N * 16))),
    }
    kernels = []
    src = "fsnet_tpu_torch/csrc/"
    meta = {
        "conv3x3_bn": (src + "conv3x3.cu",
                       "fsnet_tpu/ops/pallas/conv_kernel.py:258"),
        "conv3x3_dx": (src + "conv3x3.cu",
                       "fsnet_tpu/ops/pallas/conv_kernel.py:210"),
        "conv3x3_dw": (src + "conv3x3_dw.cu",
                       "fsnet_tpu/ops/pallas/conv_kernel.py:351"),
        "warp_depth_fwd": (src + "warp_depth.cu",
                           "fsnet_tpu/ops/pallas/prep_kernel.py:190 + "
                           "fsnet_tpu/ops/pallas/warp_kernel.py:1022"),
        "warp_depth_bwd": (src + "warp_depth.cu",
                           "fsnet_tpu/ops/pallas/prep_kernel.py:277"),
    }
    for k, t in tot.items():
        b_ms, b_by = sum_bounds(t["items"])
        entry = dict(name=k, route="cuda", source=meta[k][0],
                     replaces=meta[k][1], launches=counts[k],
                     max_abs_err=errs[k], ms=t["ms"], plain_ms=t["plain_ms"],
                     bound_ms=b_ms, bound_by=b_by,
                     library_ms=t["lib_ms"] if t["lib_shapes"] else None)
        if k == "conv3x3_bn":
            entry["max_abs_err_moments"] = errs["conv3x3_bn_mom"]
        if t["lib_shapes"]:
            entry["library_shapes"] = t["lib_shapes"]
            entry["ms_library_shapes"] = t["lib_kernel_ms"]
        entry["note"] = ("sums over the shapes of one bs12 train step, "
                         "float32" + ("; library_ms: cuDNN conv backward "
                                      "(torch.nn.grad) at library_shapes, "
                                      "ms_library_shapes the kernel there"
                                      if t["lib_shapes"] else ""))
        kernels.append(entry)
    for k, (fn, plain, ob) in warp_t.items():
        ms = cuda_ms(fn, iters=10)
        b_ms, b_by = ms_bound(*ob)
        kernels.append(dict(
            name=k, route="cuda", source=meta[k][0], replaces=meta[k][1],
            launches=counts[k], max_abs_err=errs[k], ms=ms,
            plain_ms=cuda_ms(plain, iters=3, warmup=1), bound_ms=b_ms,
            bound_by=b_by, library_ms=None,
            note=f"N={N} warps of {HEIGHT}x{WIDTH}x{C}, band {BAND}, "
                 "float32"))
    for e in kernels:
        print(f"time  {e['name']:15s} kernel {e['ms']:.4f} ms  plain "
              f"{e['plain_ms']:.4f} ms  bound {e['bound_ms']:.4f} ms "
              f"({e['bound_by']})  library "
              + ("none" if e["library_ms"] is None else
                 f"{e['library_ms']:.4f} ms vs kernel "
                 f"{e['ms_library_shapes']:.4f} ms at "
                 f"{len(e['library_shapes'])} shapes"))
    return dict(counts=counts, kernels=kernels, batch=batch, warp_in=warp_in,
                want=want)


def grid_scene(batch_np, warp_in):
    """The grid route's warp operands at the flagship batch: the 24 source
    frames, the 12 patched masks (the NuScenes ``CAM_BACK`` form: the
    bottom 2/9 of the rows zeroed) and the 96 reprojection grids of phase
    8's depth through the batch's GT poses, in the loss's (s, f, b)
    order."""
    from fsnet_tpu_torch.ops.geometry import invert_K, make_K44, reproject

    S, F, B, H, W = S_SCALES, F_FRAMES, BATCH, HEIGHT, WIDTH
    N = S * F * B

    def per_warp(t):
        return t[None, None].expand(S, F, *t.shape).reshape(N, *t.shape[1:])

    K = make_K44(torch.from_numpy(batch_np["P2"]).cuda())
    Ts = torch.stack([torch.from_numpy(batch_np[f"relative_pose/{f}"])
                      for f in (1, -1)]).cuda()
    depth = warp_in["depth"].view(S, 1, B, H, W).expand(S, F, B, H, W)
    grid = reproject(depth.reshape(N, H, W, 1), per_warp(K),
                     per_warp(invert_K(K)),
                     Ts[None].expand(S, F, B, 4, 4).reshape(N, 4, 4))
    mask = torch.ones(B, H, W, 1, device="cuda")
    mask[:, H - (2 * H) // 9:] = 0.0
    return warp_in["image"], mask, grid.contiguous()


def check_grid_kernels(scene):
    """Phase 12: kernels F and E against their plain versions at the grid
    route's shapes. Returns their max abs errors and the lane-window
    counts."""
    from fsnet_tpu_torch.ops import warp_fast as twf

    image, mask, grid = scene
    got = twf.grid_band_fused(image, grid, "border", BAND)
    ov = twf.grid_band_fwd(mask, grid, "nearest", "zeros", BAND)
    torch.cuda.synchronize()
    ref = twf.grid_band_plain(image, grid, "bilinear", "border", BAND)
    ref_ov = twf.grid_band_plain(mask, grid, "nearest", "zeros", BAND,
                                 False)[0]
    err_f = max(rel_err(a, r)[0] for a, r in zip(got, ref))
    err_e = rel_err(ov, ref_ov)[0]
    ov_diff = int(((ov == 1.0) != (ref_ov == 1.0)).sum().item())
    x = twf.unnormalize(grid[..., 0], WIDTH)
    moved = dict(photometric=lane_window_moves(x, WIDTH),
                 mask=lane_window_moves(x, WIDTH, nearest=True),
                 samples=x.numel())
    print(f"check grid warp N={grid.shape[0]} {HEIGHT}x{WIDTH} band {BAND}: "
          f"kernel F (bilinear, border, C={image.shape[-1]}) max abs err "
          f"{err_f:.2e} (out, va, vb); kernel E (nearest, zeros, C=1, "
          f"{mask.shape[0]} masks) max abs err {err_e:.2e}, overlap "
          f"mismatches {ov_diff}; TPU lane-window clamp would move "
          f"{moved['photometric']} (photometric) and {moved['mask']} (mask) "
          f"of {moved['samples']} samples")
    check(err_f <= 1e-6, f"kernel F: max abs err {err_f:.2e} > 1e-6")
    check(err_e <= 1e-6 and ov_diff == 0,
          f"kernel E: max abs err {err_e:.2e}, {ov_diff} overlap mismatches")
    return dict(warp_grid_fused=err_f, warp_grid_fwd=err_e), moved


def grid_phases(counters, record, train):
    """Phases 12-16. Returns the kernel line's entries of kernels E and F
    and the launch counts of the two grid-route paths."""
    import copy

    import torch.nn.functional as F

    from fsnet_tpu_torch.entry import (flagship_model, flagship_optimizer,
                                       learned_pose_model, synthetic_batch)
    from fsnet_tpu_torch.ops import warp_fast as twf
    from fsnet_tpu_torch.runtime.state import make_train_step

    # 12. kernels E and F against their plain versions
    scene = grid_scene(train["batch"], train["warp_in"])
    errs, moved = check_grid_kernels(scene)
    record["grid_lane_window_moves"] = moved

    # 13. the flagship on the grid route: a batch with a patched mask
    masked = synthetic_batch(BATCH, HEIGHT, WIDTH, patched_mask="ones")
    want_mask = dict(train["want"], warp_depth_fwd=0, warp_depth_bwd=0,
                     warp_grid_fused=1, warp_grid_fwd=1)
    model = flagship_model(HEIGHT, WIDTH, device="cuda", seed=0)
    opt, _ = flagship_optimizer(model)
    record["grid_path_mask"] = drive_steps(model, opt, masked, counters,
                                           want_mask, "grid path (mask)")
    state = copy.deepcopy(model.state_dict())
    route = {}
    for tag, b in (("grid", masked), ("depth-direct", train["batch"])):
        model.load_state_dict(state)
        o, _ = flagship_optimizer(model)
        met = make_train_step("cuda", with_grads=True)(model, o, b)
        route[tag] = (float(met["loss"]), {k: g.detach() for k, g in
                                           met["_grads"].items()})
    model.load_state_dict(state)
    loss_rel = abs(route["grid"][0] - route["depth-direct"][0]) / \
        abs(route["depth-direct"][0])
    grad_rel = grad_rel_l2(route["grid"][1], route["depth-direct"][1])
    print(f"grid route (mask of ones) vs depth-direct route, one step bs"
          f"{BATCH} from the same weights: loss {route['grid'][0]:.6f} vs "
          f"{route['depth-direct'][0]:.6f} (rel {loss_rel:.2e}), global "
          f"grad rel-L2 {grad_rel:.2e}")
    record["grid_vs_depth_route"] = dict(loss_rel=loss_rel,
                                         grad_rel_l2=grad_rel)
    check(loss_rel <= 1e-4, f"grid vs depth-direct route: loss rel "
          f"{loss_rel:.2e} > 1e-4")
    check(grad_rel < 3e-2, f"grid vs depth-direct route: grad rel-L2 "
          f"{grad_rel:.2e} >= 3e-2")

    # 14. the learned-pose MonoDepthMeta
    want_pose = dict(want_mask, warp_grid_fwd=0)
    meta = learned_pose_model(HEIGHT, WIDTH, device="cuda", seed=0)
    meta_opt, _ = flagship_optimizer(meta)
    rec = drive_steps(meta, meta_opt, train["batch"], counters, want_pose,
                      "grid path (learned pose)")
    pose = [n for n, _ in meta.named_parameters()
            if n.startswith(("pose_backbone.", "head.pose_decoder."))]
    stuck = [n for n in pose if n in rec["unchanged"]]
    check(not stuck, f"learned pose: parameters of the pose net did not "
          f"change: {stuck}")
    rec["pose_params"] = len(pose)
    record["grid_path_learned_pose"] = rec

    # 15. one MonoDepthMeta step at bs2 on the card against the CPU port
    small = white_noise_images({k: v[:2] for k, v in train["batch"].items()})
    record["learned_pose_card_vs_cpu"] = card_vs_cpu(
        learned_pose_model, small, "learned-pose train step")

    # 16. timings: both grid-route steps, then kernels E and F
    step = make_train_step("cuda")
    n_steps = 10
    for key, m, o, b in (("grid_step_mask", model, opt, masked),
                         ("grid_step_learned_pose", meta, meta_opt,
                          train["batch"])):
        on_card = {k: torch.from_numpy(v).cuda() for k, v in b.items()}
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            step(m, o, on_card)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step(m, o, on_card)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / n_steps * 1e3
        peak = torch.cuda.max_memory_allocated() / 1e9
        record[key] = dict(bs=BATCH, ms=ms, imgs_per_s=BATCH / ms * 1e3,
                           peak_mem_gb=peak)
        print(f"{key} bs{BATCH}@{HEIGHT}x{WIDTH} f32 (mean of {n_steps}, "
              f"batch on the card): {ms:.3f} ms = {BATCH / ms * 1e3:.2f} "
              f"imgs/s (peak memory {peak:.3f} GB)")

    image, mask, grid = scene
    N, H, W, _ = grid.shape
    C, M, px = image.shape[-1], mask.shape[0], grid.shape[0] * H * W
    g_bytes = 4.0 * grid.numel()
    yard = {k: (src.permute(0, 3, 1, 2).repeat(N // src.shape[0], 1, 1, 1),
                mode, pad)
            for k, src, mode, pad in (
                ("warp_grid_fused", image, "bilinear", "border"),
                ("warp_grid_fwd", mask, "nearest", "zeros"))}
    timed = {
        "warp_grid_fused": (
            lambda: twf.grid_band_fused(image, grid, "border", BAND),
            lambda: twf.grid_band_plain(image, grid, "bilinear", "border",
                                        BAND),
            (px * (20.0 + 21.0 * C),
             g_bytes + 4.0 * image.numel() + 3 * 4.0 * px * C),
            "fsnet_tpu/ops/pallas/warp_kernel.py:1022 (grid route, "
            "grid_sample_band_pallas_fused :1328) + warp_kernel.py:974",
            f"N={N} grids of {H}x{W} against {image.shape[0]} sources, C={C},"
            f" bilinear, border, band {BAND}, float32"),
        "warp_grid_fwd": (
            lambda: twf.grid_band_fwd(mask, grid, "nearest", "zeros", BAND),
            lambda: twf.grid_band_plain(mask, grid, "nearest", "zeros", BAND,
                                        False),
            (px * 29.0, g_bytes + 4.0 * mask.numel() + 4.0 * px),
            "fsnet_tpu/ops/pallas/warp_kernel.py:752 + warp_kernel.py:1115",
            f"N={N} grids of {H}x{W} against {M} patched masks, C=1, "
            f"nearest, zeros, band {BAND}, float32"),
    }
    launches = {k: record["grid_path_mask"]["launches"][k]
                + record["grid_path_learned_pose"]["launches"][k]
                for k in timed}
    kernels = []
    for k, (fn, plain, ob, replaces, note) in timed.items():
        src, mode, pad = yard[k]
        b_ms, b_by = ms_bound(*ob)
        kernels.append(dict(
            name=k, route="cuda", source="fsnet_tpu_torch/csrc/warp_grid.cu",
            replaces=replaces, launches=launches[k], max_abs_err=errs[k],
            ms=cuda_ms(fn, iters=10), plain_ms=cuda_ms(plain, iters=3,
                                                       warmup=1),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            grid_sample_ms=cuda_ms(lambda: F.grid_sample(
                src, grid, mode=mode, padding_mode=pad, align_corners=True),
                iters=10),
            note=note + "; launches: 3 steps each of the two grid-route "
                 "paths (phases 13, 14); grid_sample_ms: F.grid_sample "
                 "(exact, no band, no va/vb) on the sources tiled to N, a "
                 "yardstick only"))
    for e in kernels:
        print(f"time  {e['name']:15s} kernel {e['ms']:.4f} ms  plain "
              f"{e['plain_ms']:.4f} ms  bound {e['bound_ms']:.4f} ms "
              f"({e['bound_by']})  F.grid_sample {e['grid_sample_ms']:.4f} ms"
              "  library none")
    return kernels


def mei_scene(batch_np, seed=0):
    """Kernel G's and H's operands at the fisheye recipe: the 32 source
    frames, the 16 validity masks (ray-map mask x patched mask) and the
    fisheye batch's rays, camera and poses, with smooth per-scale norms of
    5-40 m plus a little noise (S*B = 64 maps)."""
    from fsnet_tpu_torch.ops.warp_mei import make_mei_rows

    S, B, H, W = S_SCALES, FISH_BATCH, FISH_H, FISH_W
    t = {k: torch.from_numpy(v).cuda() for k, v in batch_np.items()}
    g = torch.Generator(device="cuda").manual_seed(seed)
    image = torch.cat([t[f"original_image/{f}"] for f in (1, -1)])
    rays = t["fisheye_rays"]
    mask = rays[..., 3] * t["patched_mask"]
    i = torch.arange(H, device="cuda").view(1, H, 1) / H
    j = torch.arange(W, device="cuda").view(1, 1, W) / W
    base = 5.0 + 20.0 * torch.rand(S * B, 1, 1, generator=g, device="cuda")
    norm = base * (1.0 + 0.3 * torch.sin(4.0 * j) * torch.cos(3.0 * i)) \
        + 0.2 * torch.rand(S * B, H, W, generator=g, device="cuda")
    Ts = torch.stack([t[f"relative_pose/{f}"] for f in (1, -1)])
    rows = make_mei_rows(t["P2"], t["fisheye_params"], Ts, S)
    return (image.contiguous(), mask.contiguous(), norm.contiguous(),
            rays[..., :3].permute(0, 3, 1, 2).contiguous(), rows)


def check_mei_kernels(scene):
    """Phase 17: kernels G and H against their plain versions at the fisheye
    recipe's shapes (128 warps, 32 sources, 16 masks, band 16). Returns
    their max abs errors, the cotangent the timings reuse and the band and
    lane-window counts."""
    from fsnet_tpu_torch.ops import warp_fast as twf
    from fsnet_tpu_torch.ops import warp_mei as twm

    image, mask, norm, rays, rows = scene
    S, F, H, W = S_SCALES, F_FRAMES, FISH_H, FISH_W
    got = twm.warp_mei_fwd(image, mask, norm, rays, rows, S, F, FISH_BAND,
                           True)
    gy = torch.randn(got[0].shape, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(9))
    dn = twm.warp_mei_bwd(norm, rays, gy, got[2], got[3], rows, S, F)
    torch.cuda.synchronize()
    ref = twm.warp_mei_plain(image, mask, norm, rays, rows, S, F, FISH_BAND,
                             True)
    dn_ref = twm.warp_mei_bwd_plain(norm, rays, gy, ref[2], ref[3], rows, S,
                                    F)
    fwd = max(rel_err(a, r)[0] for a, r in zip((got[0], got[2], got[3]),
                                              (ref[0], ref[2], ref[3])))
    ov_diff = int((got[1] != ref[1]).sum().item())
    d_dn, e_dn = rel_err(dn, dn_ref)
    # samples whose corner rows the band of 16 rows does not hold, over all
    # samples and over those whose own ray is valid; rows whose band start
    # the pixels outside the fisheye disc pull below the valid pixels' one
    p = twm.mei_pix(norm, rays, rows, S, F)
    xc, yc = twm._clamp(p["x"], W - 1), twm._clamp(p["y"], H - 1)
    iw = twf.indices_and_weights(xc, yc, H, W, FISH_BAND)
    y0 = torch.floor(yc).long()
    miss = (y0 != iw["r0"]) | ((y0 + 1).clamp(max=H - 1) != iw["r1"])
    valid = mask[torch.arange(rows.shape[0], device="cuda") % mask.shape[0]]
    valid = valid > 0
    out_of_band = int(miss.sum().item())
    out_of_band_valid = int((miss & valid).sum().item())
    pulled = int((y0.amin(2) < torch.where(valid, y0, H).amin(2)).sum().item())
    moved = lane_window_moves(p["x"], W)
    n_samples = p["x"].numel()
    print(f"check Mei warp N={rows.shape[0]} {H}x{W} band {FISH_BAND}: "
          f"kernel G max abs err {fwd:.2e} (out, va, vb), overlap mismatches "
          f"{ov_diff} ({int(got[1].sum().item())} of {n_samples} samples "
          f"overlap); kernel H d norm rel err {e_dn:.2e}; corner rows outside "
          f"the band: {out_of_band} of {n_samples} samples, "
          f"{out_of_band_valid} of the {int(valid.sum().item())} with a valid "
          f"ray; band start pulled down by pixels outside the disc in "
          f"{pulled} of {y0.shape[0] * H} rows; TPU lane-window clamp would "
          f"move {moved}")
    check(fwd <= 1e-6 and ov_diff == 0,
          f"kernel G: max abs err {fwd:.2e}, {ov_diff} overlap mismatches")
    check(e_dn <= 1e-6, f"kernel H: rel err {e_dn:.2e} > 1e-6")
    return (dict(warp_mei_fwd=fwd, warp_mei_bwd=d_dn), gy, got,
            dict(out_of_band=out_of_band, out_of_band_valid=out_of_band_valid,
                 rows_pulled=pulled, lane_window_moves=moved,
                 samples=n_samples))


def fisheye_phases(counters, record, train):
    """Phases 17-21. Returns the kernel line's entries of kernels G and H."""
    import copy

    import torch.nn.functional as F

    from fsnet_tpu_torch.entry import (fisheye_batch, fisheye_model,
                                       flagship_optimizer)
    from fsnet_tpu_torch.ops import warp_mei as twm
    from fsnet_tpu_torch.runtime.state import make_eval_step, make_train_step

    B, H, W = FISH_BATCH, FISH_H, FISH_W
    size = f"bs{B}@{H}x{W}"
    fb = fisheye_batch(B, H, W)

    # 17. kernels G and H, and the conv kernels at the fisheye shapes
    scene = mei_scene(fb)
    errs, gy, fwd_out, band = check_mei_kernels(scene)
    record["fisheye_band"] = band
    conv_rows = [dict(name=n) for n, *_ in FISH_SHAPES]
    record["fisheye_conv_errs"] = check_conv_kernels(B, FISH_SHAPES,
                                                     conv_rows, forward=True)

    # 18. forward_test of the fisheye model
    model = fisheye_model(H, W, device="cuda", seed=0)
    zero(counters)
    pred = make_eval_step("cuda")(model, fb)
    torch.cuda.synchronize()
    counts = read(counters)
    check(counts["conv3x3"] == len(FISH_SHAPES)
          and all(n == 0 for k, n in counts.items() if k != "conv3x3"),
          f"fisheye forward_test launches {counts}")
    check(sorted(pred) == ["depth", "fisheye_mask", "norm"],
          f"fisheye prediction keys {sorted(pred)}")
    check(tuple(pred["depth"].shape) == tuple(pred["norm"].shape)
          == (B, H, W, 1) and tuple(pred["fisheye_mask"].shape) == (B, H, W),
          "fisheye prediction shapes")
    check(all(bool(torch.isfinite(v).all()) for v in pred.values()),
          "fisheye prediction has non-finite values")
    nmin, nmax = pred["norm"].min().item(), pred["norm"].max().item()
    check(0.1 <= nmin and nmax <= 150.0, f"norm range [{nmin}, {nmax}]")
    check(torch.equal(pred["fisheye_mask"].cpu(),
                      torch.from_numpy(fb["fisheye_rays"][..., 3])),
          "fisheye_mask is not the ray map's mask")
    print(f"fisheye path: forward_test {size} f32, {counts['conv3x3']} "
          f"conv3x3 launches, norm in [{nmin:.4f}, {nmax:.4f}], z-depth in "
          f"[{pred['depth'].min().item():.4f}, "
          f"{pred['depth'].max().item():.4f}]")
    record["fisheye_forward_test"] = dict(launches=counts["conv3x3"],
                                          norm_min=nmin, norm_max=nmax)

    # 19. the fisheye train path, three steps
    opt, _ = flagship_optimizer(model)
    want = dict(train["want"], warp_depth_fwd=0, warp_depth_bwd=0,
                warp_mei_fwd=1, warp_mei_bwd=1)
    record["fisheye_path"] = drive_steps(model, opt, fb, counters, want,
                                         "fisheye path", size=size)

    # 20. the card against the CPU port at bs2; the norm-direct route
    # against the grid route on the card, from the same weights
    record["fisheye_card_vs_cpu"] = card_vs_cpu(
        fisheye_model, fisheye_batch(2, H, W), "fisheye train step", H, W)
    state = copy.deepcopy(model.state_dict())
    warp_all = model.head._warp_all
    route = {}
    for tag in ("norm-direct", "grid"):
        model.load_state_dict(state)
        if tag == "grid":       # without the marker of dataset poses
            model.head._warp_all = lambda i, o: (o.pop("pose_is_const"),
                                                 warp_all(i, o))[1]
        o, _ = flagship_optimizer(model)
        zero(counters)
        met = make_train_step("cuda", with_grads=True)(model, o, fb)
        torch.cuda.synchronize()
        route[tag] = (float(met["loss"]), {k: g.detach() for k, g in
                                           met["_grads"].items()},
                      read(counters))
    del model.head._warp_all
    model.load_state_dict(state)
    ran = {t: {k: route[t][2][k] for k in ("warp_mei_fwd", "warp_mei_bwd",
                                           "warp_grid_fused",
                                           "warp_grid_fwd")}
           for t in route}
    loss_rel = abs(route["grid"][0] - route["norm-direct"][0]) / \
        abs(route["norm-direct"][0])
    grad_rel = grad_rel_l2(route["grid"][1], route["norm-direct"][1])
    print(f"fisheye grid route vs norm-direct route, one step {size} from "
          f"the same weights: loss {route['grid'][0]:.6f} vs "
          f"{route['norm-direct'][0]:.6f} (rel {loss_rel:.2e}), global grad "
          f"rel-L2 {grad_rel:.2e}; launches {ran}")
    check(ran["norm-direct"] == dict(warp_mei_fwd=1, warp_mei_bwd=1,
                                     warp_grid_fused=0, warp_grid_fwd=0)
          and ran["grid"] == dict(warp_mei_fwd=0, warp_mei_bwd=0,
                                  warp_grid_fused=1, warp_grid_fwd=1),
          f"fisheye routes launched {ran}")
    check(loss_rel <= 1e-4, f"fisheye grid vs norm-direct route: loss rel "
          f"{loss_rel:.2e} > 1e-4")
    check(grad_rel < 3e-2, f"fisheye grid vs norm-direct route: grad rel-L2 "
          f"{grad_rel:.2e} >= 3e-2")
    record["fisheye_grid_vs_direct"] = dict(loss_rel=loss_rel,
                                            grad_rel_l2=grad_rel)

    # 21. timings: the fisheye step, then kernels G and H
    step = make_train_step("cuda")
    on_card = {k: torch.from_numpy(v).cuda() for k, v in fb.items()}
    n_steps = 10
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        step(model, opt, on_card)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        step(model, opt, on_card)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n_steps * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    record["fisheye_step"] = dict(bs=B, ms=ms, imgs_per_s=B / ms * 1e3,
                                  peak_mem_gb=peak)
    print(f"fisheye_step {size} f32 (mean of {n_steps}, batch on the card): "
          f"{ms:.3f} ms = {B / ms * 1e3:.2f} imgs/s (peak memory "
          f"{peak:.3f} GB)")

    image, mask, norm, rays, rows = scene
    S, Fr, N, C = S_SCALES, F_FRAMES, rows.shape[0], image.shape[-1]
    px, plane = N * H * W, H * W
    SB, FB = norm.shape[0], image.shape[0]
    p = twm.mei_pix(norm, rays, rows, S, Fr)
    grid = torch.stack([p["x"] / (W - 1) * 2.0 - 1.0,
                        p["y"] / (H - 1) * 2.0 - 1.0], dim=-1).contiguous()
    src = image.permute(0, 3, 1, 2).repeat(N // FB, 1, 1, 1)
    del p
    _, _, va, vb = fwd_out
    # operations per sample: the projection 51, corners and fractions 10,
    # 15 per channel, the mask and the overlap 19; the cotangent: the
    # projection and its derivative 89, 4 per channel, masks and sum 12
    timed = {
        "warp_mei_fwd": (
            lambda: twm.warp_mei_fwd(image, mask, norm, rays, rows, S, Fr,
                                     FISH_BAND, True),
            lambda: twm.warp_mei_plain(image, mask, norm, rays, rows, S, Fr,
                                       FISH_BAND, True),
            (px * (80.0 + 15.0 * C),
             4.0 * (SB * plane + 3 * FB // Fr * plane + FB * plane * C
                    + mask.numel() + N * 24) + px * (3 * 4.0 * C + 1)),
            "fsnet_tpu/ops/pallas/mei_prep_kernel.py:99 + "
            "fsnet_tpu/ops/pallas/warp_kernel.py:1022 (both sweeps of "
            "fsnet_tpu/ops/warp_mei.py:115-141)"),
        "warp_mei_bwd": (
            lambda: twm.warp_mei_bwd(norm, rays, gy, va, vb, rows, S, Fr),
            lambda: twm.warp_mei_bwd_plain(norm, rays, gy, va, vb, rows, S,
                                           Fr),
            (px * (101.0 + 4.0 * C),
             4.0 * (2 * SB * plane + 3 * FB // Fr * plane + 3 * px * C
                    + N * 24)),
            "fsnet_tpu/ops/pallas/mei_prep_kernel.py:209"),
    }
    kernels = []
    launches = record["fisheye_path"]["launches"]
    for k, (fn, plain, ob, replaces) in timed.items():
        b_ms, b_by = ms_bound(*ob)
        kernels.append(dict(
            name=k, route="cuda", source="fsnet_tpu_torch/csrc/warp_mei.cu",
            replaces=replaces, launches=launches[k], max_abs_err=errs[k],
            ms=cuda_ms(fn, iters=10), plain_ms=cuda_ms(plain, iters=3,
                                                       warmup=1),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            note=f"N={N} warps of {H}x{W}x{C} (S={S}, F={Fr}, B={B}), band "
                 f"{FISH_BAND}, float32; launches: 3 steps of the fisheye "
                 "path (phase 19)"))
    kernels[0]["grid_sample_ms"] = cuda_ms(lambda: F.grid_sample(
        src, grid, mode="bilinear", padding_mode="border",
        align_corners=True), iters=10)
    kernels[0]["note"] += ("; grid_sample_ms: F.grid_sample (exact, no band, "
                           "no va/vb, no mask) of the sources tiled to N at "
                           "the Mei grid, a yardstick only")
    for e in kernels:
        print(f"time  {e['name']:15s} kernel {e['ms']:.4f} ms  plain "
              f"{e['plain_ms']:.4f} ms  bound {e['bound_ms']:.4f} ms "
              f"({e['bound_by']})"
              + (f"  F.grid_sample {e['grid_sample_ms']:.4f} ms"
                 if "grid_sample_ms" in e else "") + "  library none")
    return kernels, launches, dict(scene=scene, batch=fb)


DLA_BAND = 8


def dcn_scene(model, x):
    """(module, input, grid) of each deformable conv of ``model`` in a
    train-mode forward of ``x`` without grad (the BN statistics restored
    after), the grid from the module's own (perturbed) offset conv: the
    operands the main path gives kernels E and K."""
    import copy

    from fsnet_tpu_torch.models.backbones.dla_utils import \
        ModulatedDeformConvPack
    from fsnet_tpu_torch.ops.dcn import tap_grid

    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda m, a: seen.append((m, a[0].contiguous())))
        for m in model.modules() if isinstance(m, ModulatedDeformConvPack)]
    state = copy.deepcopy(model.state_dict())
    with torch.no_grad():
        model.dummy_forward(x, train=True)
        out = []
        for m, inp in seen:
            K = m.weight.shape[0]
            off = m.conv_offset(inp)[..., :2 * K * K]
            out.append((m, inp, tap_grid(off, inp.shape[1], inp.shape[2], K,
                                         m.stride, m.padding, m.dilation)))
    model.load_state_dict(state)
    for h in hooks:
        h.remove()
    return out


def band_misses(grid, H, W, band):
    """Samples of a bilinear zeros-padded warp with a weighted corner row
    that the band of ``band`` rows does not hold (it reads the band's edge
    row instead)."""
    from fsnet_tpu_torch.ops import warp_fast as twf

    x, y = twf.unnormalize(grid[..., 0], W), twf.unnormalize(grid[..., 1], H)
    iw = twf.indices_and_weights(x, y, H, W, band, "bilinear", "zeros")
    y0 = torch.floor(y)
    miss = (((iw["r0"] != y0.clamp(0, H - 1)) & (iw["wy0"] != 0))
            | ((iw["r1"] != (y0 + 1).clamp(0, H - 1)) & (iw["wy1"] != 0)))
    return int(miss.sum().item())


def check_dcn_kernels(scene):
    """Phase 23: kernels E and K against their plain versions at the 16 DCN
    shapes. Returns the max errors, per-shape rows and the cotangents the
    timings reuse."""
    from fsnet_tpu_torch.ops import warp_fast as twf

    errs = dict(warp_grid_fwd=0.0, warp_grid_bwd=0.0)
    rows, cots = [], []
    tot = dict(samples=0, misses=0)
    gen = torch.Generator(device="cuda").manual_seed(23)
    for i, (m, x, grid) in enumerate(scene):
        _, H, W, C = x.shape
        band = min(DLA_BAND, H)
        out = twf.grid_band_fwd(x, grid, "bilinear", "zeros", band)
        g = torch.randn(out.shape, device="cuda", generator=gen)
        got = twf.grid_band_bwd(x, grid, g, "bilinear", "zeros", band)
        torch.cuda.synchronize()
        ref = twf.grid_band_plain(x, grid, "bilinear", "zeros", band,
                                  False)[0]
        e_fwd = rel_err(out, ref)[0]
        del ref
        refs = twf.grid_band_bwd_plain(x, grid, g, "bilinear", "zeros", band)
        e_bwd = [rel_err(a, r) for a, r in zip(got, refs)]
        del refs, got
        misses = band_misses(grid, H, W, band)
        tot["samples"] += grid[..., 0].numel()
        tot["misses"] += misses
        row = dict(input=list(x.shape), cout=m.weight.shape[-1],
                   grid=list(grid.shape), band=band,
                   fwd_max_abs_err=e_fwd,
                   bwd_rel_err=[e[1] for e in e_bwd], band_misses=misses,
                   samples=grid[..., 0].numel())
        rows.append(row)
        errs["warp_grid_fwd"] = max(errs["warp_grid_fwd"], e_fwd)
        errs["warp_grid_bwd"] = max(errs["warp_grid_bwd"],
                                    *(e[0] for e in e_bwd))
        print(f"check DCN {i:2d} {tuple(x.shape)} -> {row['cout']}: kernel E "
              f"max abs err {e_fwd:.2e}; kernel K rel err gfx "
              f"{e_bwd[0][1]:.2e} gfy {e_bwd[1][1]:.2e} dimage "
              f"{e_bwd[2][1]:.2e}; {misses} of {row['samples']} samples "
              f"outside the band of {band}")
        check(e_fwd <= 1e-6, f"DCN {i}: kernel E max abs err {e_fwd:.2e}")
        check(all(e[1] <= 1e-5 for e in e_bwd),
              f"DCN {i}: kernel K rel errs {[e[1] for e in e_bwd]} > 1e-5")
        cots.append(g)
    share = tot["misses"] / tot["samples"]
    print(f"DCN samples outside the band of {DLA_BAND} rows: {tot['misses']}"
          f" of {tot['samples']} ({share:.4%})")
    return errs, rows, cots, dict(tot, share=share)


def train_mode_spread(batch, H=HEIGHT, W=WIDTH):
    """A reading, not a gate: the train-mode DLA step (batch statistics) on
    the card against the CPU port, and the CPU port's float32 step against
    its float64 step. At random init float32 rounding alone moves this
    step's gradient by several percent (the bilinear warp's and ReLU's
    kinks, where float32 and float64 pick different sides;
    ``scripts/dla_conditioning.py``), so only the loss is held, to 1e-4."""
    from fsnet_tpu_torch.entry import dla_model

    l_card, g_card, _ = one_step(dla_model, batch, "cuda", H, W)
    l_cpu, g_cpu, _ = one_step(dla_model, batch, "cpu", H, W)
    l64, g64, _ = one_step(dla_model, batch, "cpu", H, W, torch.float64)
    out = dict(loss_rel=abs(l_card - l_cpu) / abs(l_cpu),
               grad_rel_l2=grad_rel_l2(g_card, g_cpu),
               card_vs_f64_grad_rel_l2=grad_rel_l2(g_card, g64),
               cpu_f32_vs_f64_loss_rel=abs(l_cpu - l64) / abs(l64),
               cpu_f32_vs_f64_grad_rel_l2=grad_rel_l2(g_cpu, g64))
    print(f"reading: DLA train step in train mode bs2@{H}x{W}, card vs CPU "
          f"port: loss rel {out['loss_rel']:.2e}, global grad rel-L2 "
          f"{out['grad_rel_l2']:.2e}; card vs CPU float64 "
          f"{out['card_vs_f64_grad_rel_l2']:.2e}; CPU float32 vs float64: "
          f"loss rel {out['cpu_f32_vs_f64_loss_rel']:.2e}, global grad rel-L2"
          f" {out['cpu_f32_vs_f64_grad_rel_l2']:.2e}")
    check(out["loss_rel"] <= 1e-4, f"DLA train mode: card vs CPU loss rel "
          f"{out['loss_rel']:.2e} > 1e-4")
    return out


def dla_phases(counters, record):
    """Phases 23-26. Returns the kernel line's entry of kernel K and E's
    numbers on the DLA path."""
    import torch.nn.functional as F

    from fsnet_tpu_torch.entry import (dla_batch, dla_model,
                                       flagship_optimizer)
    from fsnet_tpu_torch.ops import warp_fast as twf
    from fsnet_tpu_torch.runtime.state import make_eval_step, make_train_step

    B, H, W = BATCH, HEIGHT, WIDTH
    size = f"bs{B}@{H}x{W}"
    batch = dla_batch(B, H, W)
    on_card = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    model = dla_model(H, W, device="cuda", seed=0)
    n_params = sum(p.numel() for p in model.parameters())

    # 23. kernels E and K against their plain versions at the DCN shapes
    scene = dcn_scene(model, on_card["image/0"])
    check(len(scene) == 16, f"{len(scene)} deformable convs, expected 16")
    errs, rows, cots, band = check_dcn_kernels(scene)
    record["dla_dcn_shapes"] = rows
    record["dla_band"] = band

    # 24. serving: the train=False forward
    eval_step = make_eval_step("cuda")
    zero(counters)
    pred = eval_step(model, batch)["features"]
    torch.cuda.synchronize()
    counts = read(counters)
    want_eval = {k: 0 for k in counts}
    want_eval["warp_grid_fwd"] = len(scene)
    check(counts == want_eval, f"DLA forward launches {counts}, expected "
          f"{want_eval}")
    check(tuple(pred.shape) == (B, H // 4, W // 4, 64)
          and bool(torch.isfinite(pred).all()),
          f"DLA output {tuple(pred.shape)}, finite "
          f"{bool(torch.isfinite(pred).all())}")
    print(f"DLA path: forward {size} f32 ({n_params} parameters), launches "
          f"{counts}, output {tuple(pred.shape)} in "
          f"[{pred.min().item():.4f}, {pred.max().item():.4f}]")
    record["dla_forward"] = dict(launches=counts, params=n_params)

    # 25. three train steps, then one at bs2 on the card against the CPU
    opt, _ = flagship_optimizer(model)
    want = dict(want_eval, warp_grid_bwd=len(scene))
    record["dla_path"] = drive_steps(model, opt, batch, counters, want,
                                     "DLA train path", size=size)
    small = {k: v[:2] for k, v in batch.items()}
    record["dla_card_vs_cpu"] = card_vs_cpu(
        functools.partial(dla_model, norm_frozen=True), small,
        "DLA train step, BN on its init statistics")
    record["dla_train_mode_spread"] = train_mode_spread(small)

    # 26. timings: kernels E and K per step, then (the scene freed, so the
    # peak is the step's own) the step and the forward
    t = {k: dict(ms=0.0, plain_ms=0.0, ops=0.0, nbytes=0.0, yard_ms=0.0)
         for k in ("warp_grid_fwd", "warp_grid_bwd")}
    for (m, x, grid), g in zip(scene, cots):
        _, Hi, Wi, C = x.shape
        band = min(DLA_BAND, Hi)
        N = grid.shape[0]
        px = grid[..., 0].numel()
        src = x.permute(0, 3, 1, 2).repeat(N // x.shape[0], 1, 1, 1)
        gc = g.permute(0, 3, 1, 2)
        # operations per sample: corners and weights 20; per channel the
        # blend 6 (E), and 10 for va and vb, 4 for the sums against g and
        # 6 for the four scattered products (K)
        for k, fn, plain, ops, nbytes, yard in (
                ("warp_grid_fwd",
                 lambda: twf.grid_band_fwd(x, grid, "bilinear", "zeros", band),
                 lambda: twf.grid_band_plain(x, grid, "bilinear", "zeros",
                                             band, False),
                 px * (20.0 + 6.0 * C),
                 4.0 * (x.numel() + grid.numel() + px * C),
                 lambda: F.grid_sample(src, grid, mode="bilinear",
                                       padding_mode="zeros",
                                       align_corners=True)),
                ("warp_grid_bwd",
                 lambda: twf.grid_band_bwd(x, grid, g, "bilinear", "zeros",
                                           band),
                 lambda: twf.grid_band_bwd_plain(x, grid, g, "bilinear",
                                                 "zeros", band),
                 px * (20.0 + 20.0 * C),
                 4.0 * (2 * x.numel() + grid.numel() + px * C + 2 * px),
                 lambda: torch.ops.aten.grid_sampler_2d_backward(
                     gc, src, grid, 0, 0, True, [True, True]))):
            t[k]["ms"] += cuda_ms(fn, iters=10)
            t[k]["plain_ms"] += cuda_ms(plain, iters=2, warmup=1)
            t[k]["yard_ms"] += cuda_ms(yard, iters=10)
            t[k]["ops"] += ops
            t[k]["nbytes"] += nbytes
        del src, gc
    del scene, cots, m, x, grid, g, pred
    step = make_train_step("cuda")
    n_steps = 10
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 1e9
    for _ in range(2):
        step(model, opt, on_card)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        step(model, opt, on_card)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n_steps * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    fwd = cuda_ms(lambda: eval_step(model, on_card), iters=10)
    record["dla_step"] = dict(bs=B, ms=ms, imgs_per_s=B / ms * 1e3,
                              peak_mem_gb=peak, held_before_gb=held,
                              forward_ms=fwd,
                              forward_imgs_per_s=B / fwd * 1e3)
    print(f"dla_step {size} f32 (mean of {n_steps}, batch on the card): "
          f"{ms:.3f} ms = {B / ms * 1e3:.2f} imgs/s (peak memory "
          f"{peak:.3f} GB, {held:.3f} GB of it allocated before the first "
          "step: the model, its optimizer state, the batch and what earlier "
          f"phases hold); forward {fwd:.3f} ms = {B / fwd * 1e3:.2f} imgs/s")

    for k in t:
        t[k]["bound_ms"], t[k]["bound_by"] = ms_bound(t[k]["ops"],
                                                      t[k]["nbytes"])
    launches = record["dla_path"]["launches"]
    tk = t["warp_grid_bwd"]
    kernel_k = dict(
        name="warp_grid_bwd", route="cuda",
        source="fsnet_tpu_torch/csrc/warp_grad.cu",
        replaces="fsnet_tpu/ops/pallas/warp_kernel.py:815 + "
                 "warp_kernel.py:1169",
        launches=launches["warp_grid_bwd"],
        max_abs_err=errs["warp_grid_bwd"], ms=tk["ms"],
        plain_ms=tk["plain_ms"], bound_ms=tk["bound_ms"],
        bound_by=tk["bound_by"], library_ms=None,
        grid_sampler_2d_backward_ms=tk["yard_ms"],
        note=f"sums over the 16 DCNs of one {size} step (9 taps each as one "
             f"grid batch of 9 x {B}), bilinear, zeros, band {DLA_BAND}, "
             "float32; launches: 3 steps of the DLA path (phase 25); "
             "grid_sampler_2d_backward_ms: torch's exact backward (no band) "
             "on the inputs tiled to the grid batch, a yardstick only")
    te = t["warp_grid_fwd"]
    e_dla = dict(dla_launches=launches["warp_grid_fwd"],
                 dla_max_abs_err=errs["warp_grid_fwd"], dla_ms=te["ms"],
                 dla_plain_ms=te["plain_ms"], dla_bound_ms=te["bound_ms"],
                 dla_bound_by=te["bound_by"], dla_grid_sample_ms=te["yard_ms"])
    for name, e in (("K (bwd)", tk), ("E (fwd)", te)):
        print(f"time  DLA kernel {name} summed over 16 DCNs: {e['ms']:.4f} ms"
              f"  plain {e['plain_ms']:.4f} ms  bound {e['bound_ms']:.4f} ms"
              f" ({e['bound_by']})  yardstick {e['yard_ms']:.4f} ms  "
              "library none")
    return kernel_k, e_dla


# operations per pixel-channel of the photometric loss: the forward pools
# three quantities (54), the SSIM terms (17), the clip, L1 and channel sums
# (about 9); the cotangent adds the partials (35) and the adjoint of three
# pools (about 60)
PHOTO_OPS = dict(fwd=80.0, bwd=150.0)


def photo_ties(pred, target, muy, sy):
    """Exact ties of the loss's gates over the pixel-channels of ``pred``:
    zero variance (the clamp), SSIM dissimilarity at 0 and at 1 (the clip),
    and pred == target (the L1 sign)."""
    from fsnet_tpu_torch.ops import photo_loss as tpl

    t = tpl._terms(pred, target, muy, sy)
    return dict(variance=int((t["sx_raw"] == 0).sum()),
                clip0=int((t["val"] == 0).sum()),
                clip1=int((t["val"] == 1).sum()),
                equal=int((t["x"] == target).sum()), values=pred.numel())


def check_photo_kernels(recipe, stacks, target, seed):
    """Phase 22 at one recipe: the photometric kernels against their plain
    versions on the loss's own operands, the warped stack and the identity
    stack against ``target`` (n mod B): the forward within 1e-6 of the
    largest loss (and the share of bitwise-equal pixels), the cotangent of
    the warped stack within 1e-5 of its largest entry against the plain
    cotangent and against autograd of the plain forward on the card; the
    ties each stack holds. Returns the max abs errors, the ties and the
    kernels' timings."""
    from fsnet_tpu_torch.ops import photo_loss as tpl
    from fsnet_tpu_torch.ops.ssim import ssim_target_stats

    muy, sy = ssim_target_stats(target)
    B = target.shape[0]
    errs = dict(photo_loss_fwd=0.0, photo_loss_bwd=0.0)
    ties, timed = {}, dict(fwd=[], bwd=[])
    for kind, pred in stacks.items():
        N, H, W, C = pred.shape
        got = tpl.photo_loss_fwd(pred, target, muy, sy)
        torch.cuda.synchronize()
        ref = tpl.photo_loss_plain(pred, target, muy, sy)
        d, e = rel_err(got, ref)
        equal = float((got == ref).double().mean())
        errs["photo_loss_fwd"] = max(errs["photo_loss_fwd"], d)
        ties[kind] = photo_ties(pred, target, muy, sy)
        line = (f"check photometric loss, {recipe} {kind} stack N={N} "
                f"{H}x{W}x{C} against B={B}: forward max abs err {d:.2e} "
                f"(rel {e:.2e}), bitwise-equal pixels {equal:.6f}")
        check(e <= 1e-6, f"photo_loss_fwd {recipe} {kind}: rel err {e:.2e} "
              "> 1e-6")
        px = N * H * W * C
        nbytes = 4.0 * (px + 3 * B * H * W * C + N * H * W)
        timed["fwd"].append(
            (lambda p=pred: tpl.photo_loss_fwd(p, target, muy, sy),
             lambda p=pred: tpl.photo_loss_plain(p, target, muy, sy),
             (PHOTO_OPS["fwd"] * px, nbytes)))
        if kind == "warped":
            g = torch.randn(N, H, W, device="cuda", generator=torch.Generator(
                device="cuda").manual_seed(seed))
            dx = tpl.photo_loss_bwd(pred, target, muy, sy, g)
            torch.cuda.synchronize()
            ref_dx = tpl.photo_loss_bwd_plain(pred, target, muy, sy, g)
            xr = pred.clone().requires_grad_(True)
            tpl.photo_loss_plain(xr, target, muy, sy).backward(g)
            d_b, e_b = rel_err(dx, ref_dx)
            d_a, e_a = rel_err(dx, xr.grad)
            del xr
            errs["photo_loss_bwd"] = max(errs["photo_loss_bwd"], d_b)
            line += (f"; cotangent rel err {e_b:.2e} against the plain "
                     f"cotangent, {e_a:.2e} against autograd of the plain "
                     "forward")
            check(e_b <= 1e-5 and e_a <= 1e-5,
                  f"photo_loss_bwd {recipe}: rel err {e_b:.2e} (plain), "
                  f"{e_a:.2e} (autograd) > 1e-5")
            timed["bwd"].append(
                (lambda p=pred: tpl.photo_loss_bwd(p, target, muy, sy, g),
                 lambda p=pred: tpl.photo_loss_bwd_plain(p, target, muy, sy,
                                                         g),
                 (PHOTO_OPS["bwd"] * px, nbytes + 4.0 * px)))
        print(line + f"; ties {ties[kind]}")
    times = {}
    for k, items in timed.items():
        b_ms, b_by = sum_bounds([ob for _, _, ob in items])
        times[k] = dict(ms=sum(cuda_ms(fn, iters=10) for fn, _, _ in items),
                        plain_ms=sum(cuda_ms(pl, iters=3, warmup=1)
                                     for _, pl, _ in items),
                        bound_ms=b_ms, bound_by=b_by)
    return errs, ties, times


def photo_phases(record, train, fish):
    """Phase 22. Returns the kernel line's entries of the photometric
    kernels."""
    from fsnet_tpu_torch.ops import warp_depth as twd
    from fsnet_tpu_torch.ops import warp_mei as twm

    # the flagship: the warped stack of phase 8's scene (the synthetic
    # batch's clipped textures) and its 24 sources, against its 12 targets
    wi = train["warp_in"]
    warped = twd.warp_depth_fwd(wi["image"], wi["depth"], wi["arows"],
                                S_SCALES, F_FRAMES, BAND)[0]
    target = torch.from_numpy(train["batch"]["original_image/0"]).cuda()
    flag = check_photo_kernels(f"bs{BATCH}@{HEIGHT}x{WIDTH}",
                               dict(warped=warped, identity=wi["image"]),
                               target, seed=11)
    del warped
    # the fisheye recipe: kernel G's warped stack of phase 17's scene
    image, mask, norm, rays, rows = fish["scene"]
    warped = twm.warp_mei_fwd(image, mask, norm, rays, rows, S_SCALES,
                              F_FRAMES, FISH_BAND, True)[0]
    target = torch.from_numpy(fish["batch"]["original_image/0"]).cuda()
    fisheye = check_photo_kernels(
        f"bs{FISH_BATCH}@{FISH_H}x{FISH_W}",
        dict(warped=warped, identity=image), target, seed=12)
    del warped
    record["photo_ties"] = dict(flagship=flag[1], fisheye=fisheye[1])

    paths = dict(train_path="depth-direct", grid_path_mask="grid (mask)",
                 grid_path_learned_pose="learned pose",
                 fisheye_path="fisheye")
    kernels = []
    for k, tag, replaces in (
            ("photo_loss_fwd", "fwd",
             "fsnet_tpu/ops/pallas/photo_kernel.py:324"),
            ("photo_loss_bwd", "bwd",
             "fsnet_tpu/ops/pallas/photo_kernel.py:370")):
        t, tf = flag[2][tag], fisheye[2][tag]
        kernels.append(dict(
            name=k, route="cuda", source="fsnet_tpu_torch/csrc/photo_loss.cu",
            replaces=replaces, launches=record["train_path"]["launches"][k],
            launches_by_path={name: record[key]["launches"][k]
                              for key, name in paths.items()},
            max_abs_err=max(flag[0][k], fisheye[0][k]), ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=None,
            fisheye_ms=tf["ms"], fisheye_plain_ms=tf["plain_ms"],
            fisheye_bound_ms=tf["bound_ms"], fisheye_bound_by=tf["bound_by"],
            note=("ms, plain_ms, bound_ms: the launches of one bs12 @192x640 "
                  "step (" + ("the warped stack N=96 and the identity stack "
                              "N=24" if tag == "fwd" else "the warped stack "
                              "N=96") + " against 12 targets), float32; "
                  "fisheye_*: the same at bs16 @384x384 (N=128"
                  + (" and 32" if tag == "fwd" else "") + " against 16); "
                  "launches: 3 steps of the depth-direct path (phase 9), "
                  "launches_by_path: 3 steps of each path")))
    for e in kernels:
        print(f"time  {e['name']:15s} kernel {e['ms']:.4f} ms  plain "
              f"{e['plain_ms']:.4f} ms  bound {e['bound_ms']:.4f} ms "
              f"({e['bound_by']}); fisheye kernel {e['fisheye_ms']:.4f} ms  "
              f"plain {e['fisheye_plain_ms']:.4f} ms  bound "
              f"{e['fisheye_bound_ms']:.4f} ms  library none")
    return kernels


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

    counters = launch_counters()

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
    zero(counters)
    pred = eval_step(model, batch)
    torch.cuda.synchronize()
    eval_counts = read(counters)
    launches = eval_counts["conv3x3"]
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
    check(all(n == 0 for k, n in eval_counts.items() if k != "conv3x3"),
          f"the eval path launched training kernels: {eval_counts}")
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
        note="eval path (forward_test): ms, plain_ms, bound_ms, conv2d_ms "
             "are sums over the 14 decoder convs of one bs12 forward, "
             "float32")

    # 8-11. the train path
    train = train_phases(counters, record)
    kernel["launches_train_path"] = train["counts"]["conv3x3"]

    # 12-16. the grid route: patched-mask batches and learned poses
    grid_kernels = grid_phases(counters, record, train)

    # 17-21. the KITTI-360 fisheye recipe: Mei camera, norm-direct warp
    mei_kernels, fish_counts, fish = fisheye_phases(counters, record, train)
    kernel["launches_fisheye_path"] = fish_counts["conv3x3"]
    for e in train["kernels"]:
        if e["name"].startswith("conv3x3"):
            e["launches_fisheye_path"] = fish_counts[e["name"]]

    # 22. the photometric loss kernels at both recipes
    photo_kernels = photo_phases(record, train, fish)

    # 23-26. the DLA-34 + DLASegUpsample path: deformable convs (E, K)
    kernel_k, e_dla = dla_phases(counters, record)
    for e in grid_kernels:
        if e["name"] == "warp_grid_fwd":
            e.update(e_dla)
            e["note"] += ("; dla_*: the 16 DCNs of one bs12 @192x640 DLA "
                          "step (phases 23-26), launches over its 3 steps")

    print(json.dumps(record))
    print(json.dumps({"kernels": [kernel] + train["kernels"] + grid_kernels
                      + mei_kernels + photo_kernels + [kernel_k]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
