"""The host's choice between the two routes of the projecting warps, kernel A
(``csrc/warp_depth.cu``) and kernel G (``csrc/warp_mei.cu``):
``ops.warp_depth.proj_route``. The vector route (each pixel projected once,
the row staged in shared memory and written as 16-byte stores) needs
W % 4 == 0, W <= 2048, the staged row (12 W C + W bytes) within the
shared-memory limit and every operand 16-byte aligned; everything else
takes the narrow route. Both routes are hand-written CUDA kernels that run
only on the card; the choice is made on the host, so it is pinned here on
the CPU.

* The recipes' rows (192x640 and 384x384, C = 3) take the vector route, and
  so do the operands that the depth-direct and the fisheye train steps hand
  kernels A and G.
* W % 4 != 0, W > 2048, a row too wide for shared memory and an operand 4
  bytes off a 16-byte boundary take the narrow route.
* On each route the wrappers call that route's C entry point with every
  pointer argument declared, and count the launch under the route.
"""
import contextlib

import pytest
import torch

from fsnet_tpu_torch.ops import warp_depth as twd
from fsnet_tpu_torch.ops import warp_mei as twm

torch.set_num_threads(1)


def _offset(t):
    out = torch.empty(t.numel() + 1, dtype=t.dtype)[1:]
    return out.view(t.shape).copy_(t)


@pytest.mark.parametrize("W, C, aligned, want", [
    (640, 3, True, "vector"), (384, 3, True, "vector"),
    (4, 1, True, "vector"), (2048, 3, True, "vector"),
    (2048, 9, True, "vector"), (642, 3, True, "narrow"),
    (33, 3, True, "narrow"), (2052, 1, True, "narrow"),
    (2048, 10, True, "narrow"), (640, 3, False, "narrow"),
], ids=lambda v: str(v))
def test_proj_route(W, C, aligned, want):
    image = torch.empty(2, 3, W, C)
    depth = torch.rand(2, 3, W)
    if not aligned:
        depth = _offset(depth)
        assert depth.is_contiguous() and depth.data_ptr() % 16 == 4
    assert twd.proj_route(image, depth) == want
    # every operand must be aligned: the image too
    assert twd.proj_route(_offset(image), torch.rand(2, 3, W)) == "narrow"


def test_train_paths_hand_the_vector_route_its_operands(monkeypatch):
    """One depth-direct and one fisheye train step on the CPU: the operands
    the loss heads give kernels A and G take the vector route (the outputs
    are fresh allocations of the wrappers)."""
    from fsnet_tpu_torch.entry import (fisheye_batch, fisheye_model,
                                       flagship_model, flagship_optimizer,
                                       synthetic_batch)
    from fsnet_tpu_torch.runtime.state import make_train_step

    seen = []
    fwd_a, fwd_g = twd.warp_depth_fwd, twm.warp_mei_fwd

    def rec_a(image, depth, arows, S, F, band):
        got = fwd_a(image, depth, arows, S, F, band)
        seen.append(("A", image.shape[2],
                     twd.proj_route(image, depth, arows)))
        return got

    def rec_g(image, mask, norm, rays, rows, S, F, band, with_mask):
        got = fwd_g(image, mask, norm, rays, rows, S, F, band, with_mask)
        seen.append(("G", image.shape[2],
                     twd.proj_route(image, mask, norm, rays, rows)))
        return got

    monkeypatch.setattr(twd, "warp_depth_fwd", rec_a)
    monkeypatch.setattr(twm, "warp_mei_fwd", rec_g)
    H, W = 32, 64
    step = make_train_step("cpu")
    model = flagship_model(H, W, device="cpu", seed=0)
    step(model, flagship_optimizer(model)[0], synthetic_batch(2, H, W))
    model = fisheye_model(H, W, device="cpu", seed=0)
    step(model, flagship_optimizer(model)[0], fisheye_batch(2, H, W))
    assert seen == [("A", W, "vector"), ("G", W, "vector")]


def _stub(monkeypatch, mod, calls, fn):
    """``mod``'s wrappers routed as if on the card, with a stand-in entry
    point that records its name and declaration; ``fn``'s counters reset
    and restored after the test."""
    monkeypatch.setattr(fn, "launches", 0)
    monkeypatch.setattr(fn, "routes", dict.fromkeys(twd.ROUTES, 0))
    if hasattr(fn, "dtypes"):
        monkeypatch.setattr(fn, "dtypes", dict.fromkeys(fn.dtypes, 0))
    monkeypatch.setattr(mod, "_entry", lambda lib, name, ptrs, n: (
        calls.append((lib, name, tuple(ptrs), n)), lambda *args: 0)[1])
    monkeypatch.setattr(mod, "_route", lambda t, name: True)
    monkeypatch.setattr(mod, "_stream", lambda t: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())


@pytest.mark.parametrize("kernel, W, entry, nargs, pointers", [
    ("A", 16, "fsnet_warp_depth_fwd_vec", 15, [0, 1, 2, 3, 4, 5, 6, 14]),
    ("A", 18, "fsnet_warp_depth_fwd", 15, [0, 1, 2, 3, 4, 5, 6, 14]),
    ("G", 16, "fsnet_warp_mei_fwd_vec", 19, list(range(9)) + [18]),
    ("G", 18, "fsnet_warp_mei_fwd", 19, list(range(9)) + [18]),
])
def test_route_entry_points_declare_their_arguments(
        monkeypatch, kernel, W, entry, nargs, pointers):
    """ctypes passes an undeclared argument as a 32-bit int and cuts a
    pointer: on each route the wrappers call that route's entry point,
    name every pointer argument (the stream, last, is one too) and its
    argument count, and count the launch under its route (CPU tensors
    routed as if on the card)."""
    calls = []
    S, F, B, H, C = 2, 2, 1, 8, 3
    image = torch.rand(F * B, H, W, C)
    if kernel == "A":
        fn = twd.warp_depth_fwd
        _stub(monkeypatch, twd, calls, fn)
        twd.warp_depth_fwd(image, torch.rand(S * B, H, W),
                           torch.rand(S * F * B, 16), S, F, 4)
        lib = "warp_depth"
    else:
        fn = twm.warp_mei_fwd
        _stub(monkeypatch, twm, calls, fn)
        twm.warp_mei_fwd(image, torch.rand(B, H, W), torch.rand(S * B, H, W),
                         torch.rand(B, 3, H, W), torch.rand(S * F * B, 24),
                         S, F, 4, True)
        lib = "warp_mei"
    route = "vector" if entry.endswith("_vec") else "narrow"
    (got_lib, name, ptrs, n), = calls
    assert (got_lib, name, n) == (lib, entry, nargs)
    assert sorted(set(ptrs) | {n - 1}) == pointers
    assert fn.launches == 1
    assert fn.routes == dict.fromkeys(twd.ROUTES, 0) | {route: 1}


@pytest.mark.parametrize("kernel", ["A", "G"])
def test_launchers_refuse_an_unknown_route(kernel):
    image = torch.rand(2, 8, 16, 3)
    with pytest.raises(ValueError, match="route"):
        if kernel == "A":
            twd._launch_fwd("wide", image, torch.rand(2, 8, 16),
                            torch.rand(4, 16), 2, 2, 4)
        else:
            twm._launch_fwd("wide", image, torch.rand(1, 8, 16),
                            torch.rand(2, 8, 16), torch.rand(1, 3, 8, 16),
                            torch.rand(4, 24), 2, 2, 4, True)


@pytest.mark.parametrize("W, C, want", [
    (384, 3, "vector"), (640, 3, "vector"), (388, 3, "narrow"),
    (4, 2, "vector"), (4, 1, "narrow"),
], ids=lambda v: str(v))
def test_proj_route_at_bf16_row_bytes(W, C, want):
    """Kernel G's bfloat16 form stages a row of 2-byte outputs and writes it
    as 16-byte stores of 8 values: the vector route takes W C a multiple of
    8 (the fisheye recipe's 384 x 3), where float32 takes every W % 4 == 0
    row."""
    image = torch.empty(2, 3, W, C, dtype=torch.bfloat16)
    assert twd.proj_route(image, torch.rand(2, 3, W)) == want
    assert twd.proj_route(image.float(), torch.rand(2, 3, W)) == "vector"


@pytest.mark.parametrize("image_dtype, norm_dtype, code", [
    (torch.float32, torch.float32, 0), (torch.bfloat16, torch.bfloat16, 1),
    (torch.bfloat16, torch.float32, 2),
], ids=["float32", "bfloat16", "bfloat16_image_float32_norm"])
def test_warp_mei_entry_points_take_the_dtype(monkeypatch, image_dtype,
                                              norm_dtype, code):
    """Kernels G and H are told the operands' types in one ``dtype``
    argument (0, 1 or 2: ``csrc/warp_mei.cu``), allocate their outputs in
    the image's and the norm's dtypes and count the launch by the image's
    dtype (CPU tensors routed as if on the card)."""
    args = []
    S, F, B, H, W, C = 2, 2, 1, 8, 16, 3
    for fn in (twm.warp_mei_fwd, twm.warp_mei_bwd):
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "dtypes", dict.fromkeys(fn.dtypes, 0))
    monkeypatch.setattr(twm.warp_mei_fwd, "routes",
                        dict.fromkeys(twd.ROUTES, 0))
    monkeypatch.setattr(twm, "_entry", lambda lib, name, ptrs, n: (
        lambda *a: (args.append((name, a)), 0)[1]))
    monkeypatch.setattr(twm, "_route", lambda t, name: True)
    monkeypatch.setattr(twm, "_stream", lambda t: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    image = torch.rand(F * B, H, W, C).to(image_dtype)
    norm = torch.rand(S * B, H, W).to(norm_dtype)
    rays, rows = torch.rand(B, 3, H, W), torch.rand(S * F * B, 24)
    out, _, va, vb = twm.warp_mei_fwd(image, torch.rand(B, H, W), norm,
                                      rays, rows, S, F, 4, True)
    dn = twm.warp_mei_bwd(norm, rays, out, va, vb, rows, S, F)
    assert out.dtype == va.dtype == vb.dtype == image_dtype
    assert dn.dtype == norm_dtype
    (fwd, a_fwd), (bwd, a_bwd) = args
    assert fwd == "fsnet_warp_mei_fwd_vec" and bwd == "fsnet_warp_mei_bwd"
    assert a_fwd[17] == a_bwd[13] == code
    name = str(image_dtype).split(".")[1]
    for fn in (twm.warp_mei_fwd, twm.warp_mei_bwd):
        assert fn.launches == 1 and fn.dtypes[name] == 1
