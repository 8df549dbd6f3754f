"""The host's choice among the routes of the grid warp's kernels E and F
(``ops.warp_fast.warp_route`` with the grid): E takes the channel-wide
route where it applies (C a multiple of 4, every operand 16-byte aligned),
else, as F does, the row route (each sample's grid read once, the row
staged in shared memory and written as 16-byte stores) where Wo % 4 == 0,
Wo <= 2048, the staged row (4 Wo C bytes for E, 12 Wo C for F) fits in
shared memory and every operand is aligned; everything else takes the
narrow route. The kernels run only on the card; the choice is made on the
host, so it is pinned here on the CPU.

* The recipes' rows (192x640, 384x384, nuScenes' 288x512) take the row
  route at C = 3 and C = 1; C = 64 takes E's channel-wide route; Wo = 642,
  Wo = 2052 and an operand 4 bytes off a 16-byte boundary the narrow one.
* The grid-route train step, the learned-pose model, the fisheye grid route
  and the DLA's deformable convs hand kernels F and E operands that take
  the expected route.
* On each route the wrappers call that route's C entry point with every
  pointer argument declared, and count the launch under the route; an
  unknown route is refused.
* A torch model of the row kernel's partition (thread t takes samples
  t + k Wo/4, the block's minimum of their first rows, the row staged in
  sample order and flushed as float4s) gives the plain version's band start
  and its NHWC order.
"""
import contextlib

import pytest
import torch

from fsnet_tpu_torch.ops import warp_fast as twf

torch.set_num_threads(1)


def _offset(t):
    out = torch.empty(t.numel() + 1, dtype=t.dtype)[1:]
    return out.view(t.shape).copy_(t)


@pytest.mark.parametrize("kernel", ["E", "F"])
@pytest.mark.parametrize("H, W, C, aligned, want_e, want_f", [
    (192, 640, 3, True, "row", "row"), (192, 640, 1, True, "row", "row"),
    (384, 384, 3, True, "row", "row"), (384, 384, 1, True, "row", "row"),
    (288, 512, 3, True, "row", "row"), (288, 512, 1, True, "row", "row"),
    (12, 40, 64, True, "vector", "row"),
    (192, 640, 64, True, "vector", "narrow"),
    (4, 642, 3, True, "narrow", "narrow"),
    (4, 2052, 1, True, "narrow", "narrow"),
    (4, 2048, 1, True, "row", "row"), (4, 2048, 9, True, "row", "row"),
    (4, 2048, 10, True, "row", "narrow"),
    (4, 2048, 29, True, "narrow", "narrow"),
    (192, 640, 3, False, "narrow", "narrow"),
    (192, 640, 1, False, "narrow", "narrow"),
], ids=lambda v: str(v))
def test_warp_route(kernel, H, W, C, aligned, want_e, want_f):
    fused = kernel == "F"
    want = want_f if fused else want_e
    image = torch.empty(2, H, W, C)
    grid = torch.empty(4, H, W, 2)
    if not aligned:
        image = _offset(image)
        assert image.is_contiguous() and image.data_ptr() % 16 == 4
    assert twf.warp_route(image, grid=grid, fused=fused) == want
    # every operand must be aligned, the grid too; the channel-wide route
    # reads the grid as scalars and does not need it aligned
    want_off = "vector" if want == "vector" else "narrow"
    assert twf.warp_route(image, grid=_offset(grid), fused=fused) == want_off
    # kernel K passes no grid: its routes are the channel-wide and narrow
    assert twf.warp_route(image) in ("vector", "narrow")


def _record(monkeypatch):
    """Records (kernel, C, Wo, route) of every kernel E and F call that the
    wrappers make, on the CPU."""
    seen = []
    fwd, fused = twf.grid_band_fwd, twf.grid_band_fused

    def rec_fwd(image, grid, mode, padding, band):
        seen.append(("E", image.shape[-1], grid.shape[2],
                     twf.warp_route(image, grid=grid)))
        return fwd(image, grid, mode, padding, band)

    def rec_fused(image, grid, padding, band):
        seen.append(("F", image.shape[-1], grid.shape[2],
                     twf.warp_route(image, grid=grid, fused=True)))
        return fused(image, grid, padding, band)

    monkeypatch.setattr(twf, "grid_band_fwd", rec_fwd)
    monkeypatch.setattr(twf, "grid_band_fused", rec_fused)
    return seen


@pytest.mark.parametrize("path", ["mask", "learned_pose", "fisheye_grid"])
def test_train_paths_hand_the_row_route_its_operands(monkeypatch, path):
    """One train step of each path that warps by a grid, on the CPU: the
    operands its loss gives kernel F (the frames, C = 3) and kernel E (the
    mask, C = 1) take the row route."""
    from fsnet_tpu_torch.entry import (fisheye_batch, fisheye_model,
                                       flagship_model, flagship_optimizer,
                                       learned_pose_model, synthetic_batch)
    from fsnet_tpu_torch.runtime.state import make_train_step

    seen = _record(monkeypatch)
    H, W = 32, 64
    if path == "mask":
        model = flagship_model(H, W, device="cpu", seed=0)
        batch = synthetic_batch(2, H, W, "ones")
        want = [("F", 3, W, "row"), ("E", 1, W, "row")]
    elif path == "learned_pose":
        model = learned_pose_model(H, W, device="cpu", seed=0)
        batch = synthetic_batch(2, H, W)
        want = [("F", 3, W, "row")]
    else:
        model = fisheye_model(H, W, device="cpu", seed=0)
        batch = fisheye_batch(2, H, W)
        warp_all = model.head._warp_all
        # without the marker of dataset poses the fisheye head takes its
        # grid route
        monkeypatch.setattr(model.head, "_warp_all", lambda i, o: (
            o.pop("pose_is_const"), warp_all(i, o))[1])
        want = [("F", 3, W, "row"), ("E", 1, W, "row")]
    make_train_step("cpu")(model, flagship_optimizer(model)[0], batch)
    assert seen == want


def test_dla_dcns_keep_the_channel_wide_route(monkeypatch):
    """The DLA's 16 deformable convs hand kernel E operands that take the
    channel-wide route, as before the row route."""
    from fsnet_tpu_torch.entry import dla_batch, dla_model

    seen = _record(monkeypatch)
    H, W = 32, 64
    model = dla_model(H, W, device="cpu", seed=0)
    image = torch.from_numpy(dla_batch(1, H, W)["image/0"])
    with torch.no_grad():
        model.dummy_forward(image, train=False)
    assert len(seen) == 16
    assert {(k, r) for k, _, _, r in seen} == {("E", "vector")}


def _stub(monkeypatch, calls):
    """The wrappers routed as if on the card, with a stand-in entry point
    that records its name and declaration; the counters reset and
    restored after the test."""
    for fn, routes in ((twf.grid_band_fwd, twf.FWD_ROUTES),
                       (twf.grid_band_fused, twf.FUSED_ROUTES)):
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "routes", dict.fromkeys(routes, 0))
    monkeypatch.setattr(twf, "_entry", lambda lib, name, ptrs, n: (
        calls.append((lib, name, tuple(ptrs), n)), lambda *args: 0)[1])
    monkeypatch.setattr(twf, "_route", lambda t, name: True)
    monkeypatch.setattr(twf, "_stream", lambda t: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())


@pytest.mark.parametrize("kernel, Wo, entry, nargs, pointers", [
    ("E", 16, "fsnet_warp_grid_fwd_row", 14, [0, 1, 2, 13]),
    ("E", 18, "fsnet_warp_grid_fwd", 14, [0, 1, 2, 13]),
    ("F", 16, "fsnet_warp_grid_fused_row", 15, [0, 1, 2, 3, 4, 14]),
    ("F", 18, "fsnet_warp_grid_fused", 15, [0, 1, 2, 3, 4, 14]),
])
def test_route_entry_points_declare_their_arguments(
        monkeypatch, kernel, Wo, entry, nargs, pointers):
    """ctypes passes an undeclared argument as a 32-bit int and cuts a
    pointer: on the row and narrow routes the wrappers call that route's
    entry point, name every pointer argument (the stream, last, is one too)
    and its argument count, and count the launch under its route (CPU
    tensors routed as if on the card)."""
    calls = []
    _stub(monkeypatch, calls)
    image, grid = torch.rand(2, 8, 16, 3), torch.zeros(4, 8, Wo, 2)
    if kernel == "E":
        fn = twf.grid_band_fwd
        out = twf.grid_band_fwd(image, grid, "nearest", "zeros", 4)
        assert out.shape == (4, 8, Wo, 3)
    else:
        fn = twf.grid_band_fused
        got = twf.grid_band_fused(image, grid, "border", 4)
        assert [t.shape for t in got] == [(4, 8, Wo, 3)] * 3
    route = "row" if entry.endswith("_row") else "narrow"
    (lib, name, ptrs, n), = calls
    assert (lib, name, n) == ("warp_grid", entry, nargs)
    assert sorted(set(ptrs) | {n - 1}) == pointers
    assert fn.launches == 1
    assert fn.routes == dict.fromkeys(fn.routes, 0) | {route: 1}


@pytest.mark.parametrize("kernel, route", [("E", "wide"), ("F", "wide"),
                                           ("F", "vector")])
def test_launcher_refuses_an_unknown_route(kernel, route):
    """``_launch_grid`` refuses a route the kernel does not have: F has no
    channel-wide route."""
    image, grid = torch.rand(2, 8, 16, 3), torch.zeros(4, 8, 16, 2)
    with pytest.raises(ValueError, match="route"):
        twf._launch_grid(route, image, grid, "bilinear", "border", 4,
                         fused=kernel == "F")


def _rows(gy, H, nearest, zeros):
    """The clipped rows of a sample's two corners, as ``axis`` of
    ``csrc/warp_band.cuh`` computes them; the first is ``first_row``, the
    band start's input."""
    y = twf.unnormalize(gy, H)
    if not zeros:
        y = y.clamp(0.0, H - 1)
    y0f = torch.floor(y + 0.5) if nearest else torch.floor(y)
    return y0f.clamp(0, H - 1).long(), (y0f + 1).clamp(0, H - 1).long()


@pytest.mark.parametrize("mode, padding", [("bilinear", "border"),
                                           ("nearest", "zeros"),
                                           ("bilinear", "zeros")])
@pytest.mark.parametrize("N, H, W, Ho, Wo, C, band", [
    (4, 12, 24, 12, 24, 3, 4), (2, 9, 20, 7, 1028, 1, 4),
    (3, 16, 40, 10, 32, 5, 8), (2, 6, 8, 6, 8, 2, 6),
], ids=lambda v: str(v))
def test_row_partition_model_matches_plain(N, H, W, Ho, Wo, C, band, mode,
                                           padding):
    """The row kernel's schedule, modelled in torch: Wo / 4 threads (whole
    warps), thread t reading samples t + k Wo/4 once; the band start from
    the block's minimum of the threads' minima, clipped and rounded down to
    even; each sample's value staged at j C + c and the row flushed as
    float4s in order. The band start equals the plain version's ymin, the
    band-clamped rows its r0, r1, and the flushed row its NHWC output."""
    gen = torch.Generator().manual_seed(11)
    image = torch.rand(N // 2 or 1, H, W, C, generator=gen)
    grid = (torch.rand(N, Ho, Wo, 2, generator=gen) * 2.4 - 1.2)
    # rows that stay in the band: gy spread over a few rows of each
    # output row
    rows = torch.linspace(-1.0, 1.0, Ho).view(1, Ho, 1)
    grid[..., 1] = rows + (grid[..., 1] * 0.1)
    nearest, zeros = mode == "nearest", padding == "zeros"
    out, _, _ = twf.grid_band_plain(image, grid, mode, padding, band, False)
    iw = twf.indices_and_weights(twf.unnormalize(grid[..., 0], W),
                                 twf.unnormalize(grid[..., 1], H), H, W,
                                 band, mode, padding)
    T = Wo // 4
    threads = (T + 31) // 32 * 32
    for n in range(N):
        for i in range(Ho):
            g = grid[n, i]
            lo = []
            for t in range(threads):
                if t >= T:                         # lanes past Wo/4 only
                    lo.append(2 ** 31 - 1)         # reduce
                    continue
                js = torch.tensor([t + k * T for k in range(4)])
                lo.append(int(_rows(g[js, 1], H, nearest, zeros)[0].min()))
            ymin = min(max(min(lo), 0), max(H - band, 0))
            ymin -= ymin & 1
            assert ymin == int(iw["ymin"][n, i])
            for y, key in zip(_rows(g[:, 1], H, nearest, zeros),
                              ("r0", "r1")):
                assert torch.equal(ymin + (y - ymin).clamp(0, band - 1),
                                   iw[key][n, i])
            # staging: thread t writes sample j's C values at j C + c
            stage = torch.empty(Wo * C)
            for t in range(T):
                for k in range(4):
                    j = t + k * T
                    stage[j * C:(j + 1) * C] = out[n, i, j]
            # the flush: float4 q of the row goes to float4 q of row n Ho + i
            flat = torch.empty(N * Ho * Wo * C)
            q4 = Wo * C // 4
            row = n * Ho + i
            for q in range(q4):
                flat[(row * q4 + q) * 4:(row * q4 + q + 1) * 4] = \
                    stage[4 * q:4 * q + 4]
            got = flat[row * Wo * C:(row + 1) * Wo * C].view(Wo, C)
            assert torch.equal(got, out[n, i])
