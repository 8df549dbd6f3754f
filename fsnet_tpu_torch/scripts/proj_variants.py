"""Times edited copies of the projecting warps' vector kernels beside the
tree's own build, on one CUDA card: kernel A (``csrc/warp_depth.cu``) at
the flagship recipe (96 warps of 192x640x3, band 4) and kernel G
(``csrc/warp_mei.cu``) at the fisheye recipe (128 warps of 384x384x3,
band 16, with the mask pass).

    python -m fsnet_tpu_torch.scripts.proj_variants [--spec FILE]
        [--only TAG ...]

``--spec`` (default: ``proj_variants.txt`` beside this script) holds the
variants, separated by lines ``===``. A variant's first line is the kernel
(``A`` or ``G``) and a tag; then come its edits, separated by lines
``---``: the exact text of the source, a line ``>>>``, and its
replacement. An edit whose text starts with a line ``@<header>`` edits
that header of ``csrc/`` instead (the edited copy shadows it). The
variant's sources are written under ``build/variants/<tag>/``, built with
the port's nvcc flags, and its vector entry point is launched on the
recipe's operands. Prints per variant: the registers (ptxas) and SASS
instruction count of its vector kernel at C = 3, whether its out, overlap,
va and vb equal the tree's bit for bit (a variant that drops work to
measure its cost does not), and its time and the tree's in turns (tree,
variant, variant, tree; CUDA events over 10 back-to-back launches each).
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
from collections import Counter
from pathlib import Path

import torch

from ..entry import fisheye_batch, synthetic_batch
from ..ops import _build
from ..ops import warp_depth as twd
from ..ops import warp_mei as twm
from ..ops.conv3x3 import _stream
from ..ops.geometry import invert_K, make_K44

OUT = _build.BUILD_DIR.parent / "variants"
SOURCE = dict(A="warp_depth", G="warp_mei")


def parse(text):
    """[(kernel, tag, [(file or None, old, new), ...]), ...]"""
    out = []
    for block in text.split("\n===\n"):
        lines = block.strip("\n").split("\n")
        if not lines[0].strip():
            continue
        kernel, tag = lines[0].split()
        edits = []
        for e in "\n".join(lines[1:]).split("\n---\n"):
            old, new = e.split("\n>>>")
            new = new[1:] if new.startswith("\n") else new
            name = None
            if old.startswith("@"):
                name, old = old[1:].split("\n", 1)
            edits.append((name, old, new))
        out.append((kernel, tag, edits))
    return out


def build(kernel, tag, edits):
    """Builds the variant; returns (library, registers, SASS instructions
    and their commonest opcodes) of its vector kernel at C = 3."""
    src = SOURCE[kernel] + ".cu"
    files = {src: (_build.CSRC_DIR / src).read_text()}
    for name, old, new in edits:
        name = name or src
        files.setdefault(name, (_build.CSRC_DIR / name).read_text())
        if old not in files[name]:
            raise ValueError(f"{tag}: no such text in {name}: {old[:60]!r}")
        files[name] = files[name].replace(old, new)
    d = OUT / tag
    d.mkdir(parents=True, exist_ok=True)
    for name, text in files.items():
        (d / name).write_text(text)
    lib = d / f"lib{SOURCE[kernel]}.so"
    run = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                          str(_build.CSRC_DIR), "-o", str(lib), str(d / src)],
                         capture_output=True, text=True, check=True)
    log = run.stdout + run.stderr
    regs = re.search(r"fwd_vec_kernelILi3E[^\n]*\n[^\n]*\n[^\n]*Used (\d+) "
                     r"registers", log)
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    ops = []
    for part in sass.split("Function : ")[1:]:
        if "fwd_vec_kernelILi3E" in part.split("\n", 1)[0]:
            ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                             r"([A-Z][\w.]*)", part)
    common = Counter(o.split(".")[0] for o in ops).most_common(8)
    return (ctypes.CDLL(str(lib)), regs and int(regs.group(1)), len(ops),
            dict(common))


def scenes():
    """The recipes' operands as ``chip_smoke.py`` phases 8 and 17 make them:
    A's sources, depth (uniform in [2, 42) m) and projection rows of the
    synthetic batch (bs12 @192x640, S = 4, F = 2); G's sources, validity
    masks, smooth norms of 5-40 m with a little noise, rays and Mei rows of
    the fisheye batch (bs16 @384x384)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    b = {k: torch.from_numpy(v).cuda() for k, v in
         synthetic_batch(12, 192, 640).items()}
    image = torch.cat([b[f"original_image/{f}"] for f in (1, -1)])
    depth = 2.0 + 40.0 * torch.rand(4 * 12, 192, 640, generator=g,
                                    device="cuda")
    K = make_K44(b["P2"])
    Ts = torch.stack([b[f"relative_pose/{f}"] for f in (1, -1)])
    a = (image.contiguous(), depth, twd.make_affine_rows(K, invert_K(K), Ts,
                                                         4))
    t = {k: torch.from_numpy(v).cuda() for k, v in
         fisheye_batch(16, 384, 384).items()}
    rays = t["fisheye_rays"]
    i = torch.arange(384, device="cuda").view(1, 384, 1) / 384
    j = torch.arange(384, device="cuda").view(1, 1, 384) / 384
    base = 5.0 + 20.0 * torch.rand(4 * 16, 1, 1, generator=g, device="cuda")
    norm = base * (1.0 + 0.3 * torch.sin(4.0 * j) * torch.cos(3.0 * i)) \
        + 0.2 * torch.rand(4 * 16, 384, 384, generator=g, device="cuda")
    Ts = torch.stack([t[f"relative_pose/{f}"] for f in (1, -1)])
    g_ops = (torch.cat([t[f"original_image/{f}"] for f in (1, -1)]),
             (rays[..., 3] * t["patched_mask"]).contiguous(), norm,
             rays[..., :3].permute(0, 3, 1, 2).contiguous(),
             twm.make_mei_rows(t["P2"], t["fisheye_params"], Ts, 4))
    return dict(A=a, G=g_ops)


def launcher(kernel, lib, ops):
    """A call of ``lib``'s vector entry point on the recipe's operands, and
    the outputs it writes."""
    image = ops[0]
    FB, H, W, C = image.shape
    N = 4 * FB
    out, va, vb = (torch.empty((N, H, W, C), device="cuda")
                   for _ in range(3))
    ov = torch.empty((N, H, W), dtype=torch.bool, device="cuda")
    ptrs = [t.data_ptr() for t in ops] + [out.data_ptr(), va.data_ptr(),
                                          vb.data_ptr(), ov.data_ptr()]
    if kernel == "A":
        fn, tail = lib.fsnet_warp_depth_fwd_vec, (4, 2, FB // 2, H, W, C, 4)
    else:
        fn, tail = lib.fsnet_warp_mei_fwd_vec, (4, 2, FB // 2, H, W, C, 16,
                                                1)
    fn.argtypes = ([ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * len(tail)
                   + [ctypes.c_void_p])

    def go():
        err = fn(*ptrs, *tail, _stream(image))
        if err:
            raise RuntimeError(f"variant launch failed: CUDA error {err}")
    return go, (out, ov, va, vb)


def cuda_ms(fn, iters=10, warmup=2):
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spec", type=Path,
                    default=Path(__file__).with_name("proj_variants.txt"))
    ap.add_argument("--only", nargs="*", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("proj_variants: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    ops = scenes()
    tree = {k: build(k, f"tree_{k}", []) for k in SOURCE}
    for k, (_, regs, n, common) in tree.items():
        print(f"tree {k}: {regs} registers, {n} SASS instructions {common}")
    for kernel, tag, edits in parse(args.spec.read_text()):
        if args.only and tag not in args.only:
            continue
        lib, regs, n, common = build(kernel, tag, edits)
        go_t, out_t = launcher(kernel, tree[kernel][0], ops[kernel])
        go_v, out_v = launcher(kernel, lib, ops[kernel])
        go_t()
        go_v()
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(out_v, out_t))
        ms = dict(tree=[], variant=[])
        for who, go in (("tree", go_t), ("variant", go_v), ("variant", go_v),
                        ("tree", go_t)):
            ms[who].append(round(cuda_ms(go), 4))
        print(f"variant {kernel} {tag}: {regs} registers, {n} SASS "
              f"instructions {common}; bitwise equal to the tree: {same}; "
              f"ms tree {ms['tree']} variant {ms['variant']}")
        del out_t, out_v


if __name__ == "__main__":
    main()
