"""The host's choice between the two routes of the band warp's kernels E and
K (``ops.warp_fast.warp_route``): the channel-wide route (float4 lanes over
the channels, vector atomics) needs C a multiple of 4 and every operand
16-byte aligned; everything else takes the narrow route. Both routes are
hand-written CUDA kernels that run only on the card; the choice is made on
the host, so it is pinned here on the CPU.

* Every deformable conv of ``entry.dla_config`` (the DLA path's 16 DCNs,
  the full widths at a small image) hands kernels E and K operands that
  take the channel-wide route, on a train-mode forward and backward.
* C in {1, 2, 3, 67} and an operand 4 bytes off a 16-byte boundary take the
  narrow route; C in {4, 12, 64, 512}, aligned, the channel-wide one.
* On that route the wrappers call the route's own C entry points with every
  pointer argument declared, and count the launch under the route.
"""
from collections import Counter

import pytest
import torch

from fsnet_tpu_torch.entry import dla_batch, dla_model
from fsnet_tpu_torch.ops import warp_fast as twf

torch.set_num_threads(1)


def test_dla_dcns_take_the_channel_wide_route(monkeypatch):
    seen = {"fwd": [], "bwd": []}
    fwd, bwd = twf.grid_band_fwd, twf.grid_band_bwd

    def rec_fwd(image, grid, mode, padding, band):
        seen["fwd"].append((image.shape[-1], twf.warp_route(image)))
        return fwd(image, grid, mode, padding, band)

    def rec_bwd(image, grid, g, mode, padding, band):
        seen["bwd"].append((image.shape[-1], twf.warp_route(image, g)))
        return bwd(image, grid, g, mode, padding, band)

    monkeypatch.setattr(twf, "grid_band_fwd", rec_fwd)
    monkeypatch.setattr(twf, "grid_band_bwd", rec_bwd)
    H, W = 64, 128
    model = dla_model(H, W, device="cpu", seed=0)
    image = torch.from_numpy(dla_batch(1, H, W)["image/0"])
    model.dummy_forward(image, train=True).square().sum().backward()
    for kind in ("fwd", "bwd"):
        assert len(seen[kind]) == 16
        assert {r for _, r in seen[kind]} == {"vector"}
        # the widths of the 16 DCNs at bs12 @192x640 (the sizing of the
        # channel-wide route): one at 512 channels, 4 at 256, 6 at 128, 5 at
        # 64
        assert Counter(c for c, _ in seen[kind]) == {512: 1, 256: 4, 128: 6,
                                                     64: 5}


def _offset(t):
    out = torch.empty(t.numel() + 1, dtype=t.dtype)[1:]
    return out.view(t.shape).copy_(t)


@pytest.mark.parametrize("C, aligned, want", [
    (1, True, "narrow"), (2, True, "narrow"), (3, True, "narrow"),
    (67, True, "narrow"), (64, False, "narrow"), (4, False, "narrow"),
    (4, True, "vector"), (12, True, "vector"), (64, True, "vector"),
    (512, True, "vector"),
], ids=lambda v: str(v))
def test_warp_route(C, aligned, want):
    image = torch.rand(2, 5, 7, C)
    g = torch.rand(4, 3, 6, C)
    if not aligned:
        image = _offset(image)
        assert image.is_contiguous() and image.data_ptr() % 16 == 4
    assert twf.warp_route(image) == want
    assert twf.warp_route(image, g) == want
    # kernel K's route needs every operand aligned: the cotangent too
    assert twf.warp_route(torch.rand(2, 5, 7, C), _offset(g)) == "narrow"


@pytest.mark.parametrize("kernel, entry, nargs, pointers", [
    ("E", "fsnet_warp_grid_fwd_vec", 14, [0, 1, 2, 13]),
    ("K", "fsnet_warp_grid_bwd_vec", 17, [0, 1, 2, 3, 4, 5, 16]),
])
def test_channel_wide_entry_points_declare_their_arguments(
        monkeypatch, kernel, entry, nargs, pointers):
    """ctypes passes an undeclared argument as a 32-bit int and cuts a
    pointer: on the channel-wide route the wrappers call that route's entry
    point, name every pointer argument (the stream, last, is one too) and
    its argument count, and count the launch under its route."""
    import contextlib

    calls = []
    monkeypatch.setattr(twf, "_entry", lambda lib, name, ptrs, n: (
        calls.append((lib, name, ptrs, n)), lambda *args: 0)[1])
    monkeypatch.setattr(twf, "_route", lambda t, name: True)
    monkeypatch.setattr(twf, "_stream", lambda t: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    fn = twf.grid_band_fwd if kernel == "E" else twf.grid_band_bwd
    monkeypatch.setattr(fn, "routes", dict.fromkeys(twf.ROUTES, 0))
    image, grid = torch.rand(2, 8, 16, 64), torch.zeros(4, 8, 16, 2)
    if kernel == "E":
        twf.grid_band_fwd(image, grid, "bilinear", "zeros", 4)
    else:
        twf.grid_band_bwd(image, grid, torch.rand(4, 8, 16, 64), "bilinear",
                          "zeros", 4)
    (lib, name, ptrs, n), = calls
    lib_want = "warp_grid" if kernel == "E" else "warp_grad"
    assert (lib, name, n) == (lib_want, entry, nargs)
    assert sorted(set(ptrs) | {n - 1}) == pointers
    assert fn.routes == dict(narrow=0, vector=1)
