"""The motion-mask path of the port on the CPU: its grey conversion and
Farneback flow against ``cv2`` (the test oracle; the port does not import
it), its PNG writer, the two precompute hooks against the JAX package's,
the loss's motion-mask branch against the JAX head in float64, and
``train.py`` running the precompute and training on its masks:

* ``bgr_to_gray`` bitwise to ``cv2.cvtColor(..., COLOR_BGR2GRAY)`` over
  every 24-bit colour;
* ``farneback`` against ``cv2.calcOpticalFlowFarneback``, both float32, on
  ``tests/tiny_motion_dataset.py``'s textured shifted pairs (64x96 and
  128x192) and a 192x640 pair of the synthetic render at two times, with
  the JAX parity test's ``FLOW_CFG`` and OpenCV's example settings, each
  with flags 0 and 256: max |d flow| <= 1e-2 px and mean <= 1e-4 px
  (measured when this test was written: 0 on 10 of the 12 cases, the
  render's two box-window ones max 2.4e-7 px and mean 9.8e-13 px);
* ``write_png`` read back bitwise by ``cv2.imread(path, -1)`` and the
  port's reader, 8- and 16-bit;
* from the same flow, both hooks' masks bitwise equal to the JAX hooks'
  (the Farneback hook fed cv2's flow); from the port's own flow, masks
  that differ only where JAX's |distance| lies within 1e-2 of the
  threshold; existing files skipped;
* the loss with a ``motion_mask`` against the JAX head's in float64 on the
  grid route (a patched mask of ones): the loss within 1e-10 relative,
  the gradients of depth, disparity and poses per leaf within 1e-4
  relative L2; a mask of ones leaves only the smoothness term's gradient,
  a mask of zeros is min-reprojection with no automask; the noise changes
  nothing;
* the masks of a 192x640 drive mark its moving object;
* ``train.main`` on a tiny KITTI raw tree with a moving object: the
  precompute hook writes the masks before the datasets are built, the
  steps train on them (``is_motion_mask=True``), a second run skips them;
  ``check_hooks`` takes the port's precompute and post-opt hooks.
"""
import os

import cv2
import numpy as np
import pytest
import torch

import jax

import disk_trees as dt
from fsnet_tpu_torch.configs import common as tcommon
from fsnet_tpu_torch.data.datasets import image_io
from fsnet_tpu_torch.ops import optical_flow as tof
from fsnet_tpu_torch.pipeline_hooks import precompute_hooks as tph
from fsnet_tpu_torch.utils.easydict import EasyDict as edict

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KITTI_CONFIG = os.path.join(REPO, "fsnet_tpu_torch", "configs",
                            "kitti_wpose_example.py")
FLOW_CFG = dict(pyr_scale=0.5, levels=2, winsize=9, iterations=2,
                poly_n=5, poly_sigma=1.1, flags=0)
EXAMPLE = dict(tcommon.FARNEBACK_EXAMPLE)
TINY = dict(name="tiny_motion_dataset.TinyMotionDataset", length=2,
            height=64, width=96)
RENDER = dict(name="fsnet_tpu_torch.data.datasets.synthetic_dataset."
                   "SyntheticMonoDataset", length=1, height=192, width=640,
              frame_idxs=[0, 1], seed=4)


def _dataset(cfg):
    from fsnet_tpu_torch.utils import build

    return build(**cfg)


def _grey_pair(cfg, index=0):
    data = _dataset(cfg)[index]
    return tuple(cv2.cvtColor(np.asarray(data[("image", f)]),
                              cv2.COLOR_BGR2GRAY) for f in (0, 1))


def test_bgr_to_gray_matches_cv2():
    v = np.arange(256, dtype=np.uint8)
    cube = np.stack(np.meshgrid(v, v, v, indexing="ij"), axis=-1
                    ).reshape(4096, 4096, 3)
    got = tof.bgr_to_gray(torch.from_numpy(cube)).numpy()
    np.testing.assert_array_equal(got, cv2.cvtColor(cube,
                                                    cv2.COLOR_BGR2GRAY))
    with pytest.raises(TypeError):
        tof.bgr_to_gray(torch.zeros(4, 4, 3))


@pytest.mark.parametrize("pair", ["tiny64x96", "tiny128x192",
                                  "render192x640"])
@pytest.mark.parametrize("cfg", ["flow_cfg", "example"])
@pytest.mark.parametrize("flags", [0, tof.OPTFLOW_FARNEBACK_GAUSSIAN])
def test_farneback_matches_cv2(pair, cfg, flags):
    a, b = {"tiny64x96": lambda: _grey_pair(TINY),
            "tiny128x192": lambda: _grey_pair(dict(TINY, height=128,
                                                   width=192), 1),
            "render192x640": lambda: _grey_pair(RENDER)}[pair]()
    kw = dict({"flow_cfg": FLOW_CFG, "example": EXAMPLE}[cfg], flags=flags)
    ref = cv2.calcOpticalFlowFarneback(a, b, None, **kw)
    got = tof.farneback(torch.from_numpy(a), torch.from_numpy(b), **kw)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    d = np.abs(got.numpy() - ref)
    print(f"{pair} {cfg} flags {flags}: max {d.max():.3e} px, mean "
          f"{d.mean():.3e} px (|flow| mean {np.abs(ref).mean():.3f})")
    assert d.max() <= 1e-2 and d.mean() <= 1e-4, (d.max(), d.mean())


def test_farneback_refuses_what_it_does_not_take():
    a = torch.zeros(40, 40, dtype=torch.uint8)
    for kw in (dict(EXAMPLE, flags=tof.OPTFLOW_USE_INITIAL_FLOW),
               dict(EXAMPLE, poly_n=3), dict(EXAMPLE, pyr_scale=1.0)):
        with pytest.raises(ValueError):
            tof.farneback(a, a, **kw)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_write_png_reads_back(tmp_path, dtype):
    rng = np.random.RandomState(3)
    img = (rng.rand(191, 643) * np.iinfo(dtype).max).astype(dtype)
    path = str(tmp_path / "a.png")
    image_io.write_png(path, img)
    np.testing.assert_array_equal(image_io.read_png(path), img)
    back = cv2.imread(path, -1)
    assert back.dtype == dtype
    np.testing.assert_array_equal(back, img)


# ------------------------------------------------------------------ hooks

def _masks(root):
    names = sorted(os.listdir(root))
    return names, [cv2.imread(os.path.join(root, n), -1) for n in names]


@pytest.mark.parametrize("data,thresh", [(TINY, 0.05), (RENDER, 1.0)])
def test_farneback_hook_matches_jax(tmp_path, monkeypatch, data, thresh):
    import fsnet_tpu.pipeline_hooks.precompute_hooks as jph

    kw = dict(train_dataset_cfg=dict(data), flow_estimator_cfg=EXAMPLE,
              distance_threshold=thresh)
    jph.MotionMaskPrecomputeHook(output_dir=str(tmp_path / "jax"), **kw)()
    names, ref = _masks(tmp_path / "jax")
    assert all(0 < m.sum() < m.size for m in ref)

    # from cv2's flow: bitwise
    monkeypatch.setattr(tph, "farneback", lambda a, b, **k: torch.from_numpy(
        cv2.calcOpticalFlowFarneback(a.numpy(), b.numpy(), None, **k)))
    hook = tph.MotionMaskPrecomputeHook(output_dir=str(tmp_path / "cv2"),
                                        device="cpu", **kw)
    hook()
    got_names, got = _masks(tmp_path / "cv2")
    assert got_names == names and hook.written == len(names)
    for g, r, n in zip(got, ref, names):
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(
            image_io.read_png(str(tmp_path / "cv2" / n)), r)
    hook()
    assert hook.written == 0 and hook.skipped == len(names)

    # from the port's own flow: equal but at the threshold's edge
    monkeypatch.undo()
    hook = tph.MotionMaskPrecomputeHook(output_dir=str(tmp_path / "port"),
                                        device="cpu", **kw)
    hook()
    _, own = _masks(tmp_path / "port")
    ds = _dataset(data)
    for i, (g, r) in enumerate(zip(own, ref)):
        sample = ds[i]
        a, b = (cv2.cvtColor(np.asarray(sample[("image", f)]).astype(
            np.uint8), cv2.COLOR_BGR2GRAY) for f in (0, 1))
        dist = jph._epipolar_distance(
            cv2.calcOpticalFlowFarneback(a, b, None, **EXAMPLE),
            np.asarray(sample["P2"]), np.asarray(sample[("relative_pose", 1)]))
        differ = g != r
        assert np.all(np.abs(np.abs(dist[differ]) - thresh) <= 1e-2)


def test_arflow_hook_matches_jax(tmp_path):
    import fsnet_tpu.pipeline_hooks.precompute_hooks as jph

    kw = dict(train_dataset_cfg=dict(TINY), flow_estimator_cfg={},
              distance_threshold=0.05)
    jph.MotionMaskARFlowPrecomputeHook(output_dir=str(tmp_path / "jax"),
                                       **kw)()
    tph.MotionMaskARFlowPrecomputeHook(output_dir=str(tmp_path / "port"),
                                       device="cpu", **kw)()
    names, ref = _masks(tmp_path / "jax")
    got_names, got = _masks(tmp_path / "port")
    assert got_names == names and any(0 < m.sum() < m.size for m in ref)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


# ------------------------------------------------- the loss's mask branch

def _head_inputs(H, W, B, seed):
    """Decoder outputs at the flagship head's 4 scales, a batch with small
    camera motion and a patched mask of ones (the grid route on both
    sides), float64 numpy."""
    rng = np.random.RandomState(seed)
    out = {}
    for s in range(4):
        h, w = H >> s, W >> s
        out[("depth", s, s)] = 5 + 10 * rng.rand(B, h, w, 1)
        out[("disp", s)] = rng.rand(B, h, w, 1)
    data = {("original_image", f): rng.rand(B, H, W, 3) for f in (0, 1, -1)}
    P = np.zeros((B, 3, 4))
    P[:, 0, 0] = P[:, 1, 1] = 0.58 * W
    P[:, 0, 2], P[:, 1, 2], P[:, 2, 2] = W / 2, H / 2, 1.0
    data["P2"] = P
    for f, t in ((1, 0.3), (-1, -0.2)):
        T = np.tile(np.eye(4), (B, 1, 1))
        T[:, 0, 3], T[:, 2, 3] = 0.05 * t, t
        out[("cam_T_cam", f)] = T
    data["patched_mask"] = np.ones((B, H, W))
    return out, data


LEAVES = [("depth", s, s) for s in range(4)] + [("disp", s) for s in range(4)] \
    + [("cam_T_cam", 1), ("cam_T_cam", -1)]


def _port_loss(head, out, data, noise=None):
    leaves = {k: torch.from_numpy(out[k]).requires_grad_(True)
              for k in LEAVES}
    o = dict(leaves)
    d = {k: torch.from_numpy(v) for k, v in data.items()}
    loss = head.loss(o, d, noise=noise)["loss"]
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), [g.numpy() for g in grads]


def _jax_loss(out, data, H, W):
    import jax.numpy as jnp

    from fsnet_tpu.utils.builder import build as jbuild
    from fsnet_tpu_torch.entry import flagship_config

    cfg = dict(flagship_config(H, W)["head_cfg"])
    cfg = {k: (v.replace("fsnet_tpu_torch.", "fsnet_tpu.")
               if isinstance(v, str) else v) for k, v in cfg.items()}
    cfg["depth_decoder_cfg"] = {
        k: (v.replace("fsnet_tpu_torch.", "fsnet_tpu.")
            if isinstance(v, str) else v)
        for k, v in cfg["depth_decoder_cfg"].items()}
    head = jbuild(frame_ids=(0, 1, -1), **cfg).bind({})
    jdata = {k: jnp.asarray(v) for k, v in data.items()}

    def f(*leaves):
        o = dict(zip(LEAVES, leaves))
        return head.loss(o, dict(jdata))["loss"]

    args = [jnp.asarray(out[k]) for k in LEAVES]
    loss, grads = jax.jit(jax.value_and_grad(
        f, argnums=tuple(range(len(args)))))(*args)
    return float(loss), [np.asarray(g) for g in grads]


@pytest.fixture
def float64(monkeypatch):
    from fsnet_tpu_torch.ops import photo_loss as tpl
    from fsnet_tpu_torch.ops import warp_fast as twf

    monkeypatch.setattr(twf, "_DTYPES", (torch.float64,))
    monkeypatch.setattr(tpl, "_DTYPES", (torch.float64,))
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("mask", ["random", "ones", "zeros"])
def test_motion_mask_loss_matches_jax_f64(float64, mask):
    from fsnet_tpu_torch.entry import flagship_config
    from fsnet_tpu_torch.utils.builder import build

    H, W, B = 32, 64, 2
    out, data = _head_inputs(H, W, B, seed=7)
    rng = np.random.RandomState(8)
    data["motion_mask"] = {"random": (rng.rand(B, H, W) < 0.3),
                           "ones": np.ones((B, H, W)),
                           "zeros": np.zeros((B, H, W))}[mask].astype(
                               np.uint8)
    head = build(frame_ids=(0, 1, -1),
                 **dict(flagship_config(H, W)["head_cfg"]))
    loss, grads = _port_loss(head, out, data)
    ref_loss, ref_grads = _jax_loss(out, data, H, W)
    assert abs(loss - ref_loss) <= 1e-10 * abs(ref_loss), (loss, ref_loss)
    for k, g, r in zip(LEAVES, grads, ref_grads):
        scale = np.linalg.norm(r)
        if scale == 0:
            assert np.linalg.norm(g) == 0, k
        else:
            assert np.linalg.norm(g - r) <= 1e-4 * scale, k
    # the tie-break noise is not read on this branch
    noise = torch.randn(2, B, H, W, generator=torch.Generator().manual_seed(
        9), dtype=torch.float64)
    n_loss, n_grads = _port_loss(head, out, data, noise=noise)
    assert n_loss == loss
    assert all(np.array_equal(a, b) for a, b in zip(n_grads, grads))
    plain = dict(data)
    del plain["motion_mask"]
    auto_loss, _ = _port_loss(head, out, plain)
    if mask == "ones":
        # no gradient through the photometric term: depth and poses get
        # none, disparity only the smoothness term's
        assert all(not np.any(g) for k, g in zip(LEAVES, grads)
                   if k[0] != "disp")
    if mask in ("ones", "zeros"):
        # the value is min-reprojection without the identity candidates,
        # at least the automasked loss
        assert loss >= auto_loss
    if mask == "zeros":
        assert all(np.any(g) for g in grads)


# ------------------------------------------------------- the training loop

H, W = 64, 96
DATE = "2011_09_26"
DRIVE = f"{DATE}/{DATE}_drive_0003_sync"


@pytest.fixture
def no_writer(monkeypatch):
    from fsnet_tpu_torch.scripts import train as train_script

    monkeypatch.setattr(train_script, "_writer", lambda *a, **k: None)


def test_masks_mark_the_moving_object(tmp_path):
    """On a 192x640 drive with ``disk_trees.moving_object``, the Farneback
    hook (OpenCV's example settings; 5 px at 375x1242 scaled to 192x640)
    marks at least 90% of the object that moves on its own, at least 3
    times as densely as the rest (the textures' shift does not follow the
    drive's poses, so the rest has some ones)."""
    raw, frames = tmp_path / "raw", (1, 2)
    dt.write_kitti_date(str(raw / DATE), 192, 640)
    dt.write_kitti_drive(str(raw), DRIVE, 4, 192, 640, seed=1, mover=True)
    split = dt.write_split(tmp_path / "train.txt",
                           [f"{DRIVE} {i} {'lr'[i % 2]}" for i in frames])
    child = dict(name="fsnet_tpu_torch.data.datasets.mono_dataset."
                      "KittiDepthMonoDataset",
                 raw_path=str(raw), split_file=split, frame_idxs=[0, 1, -1])
    cfg = tcommon.motion_mask_hook(child, (192, 640), str(tmp_path / "m"),
                                   distance_threshold=5.0 * 192 / 375)
    del cfg["name"]
    tph.MotionMaskPrecomputeHook(device="cpu", **cfg)()
    for k, i in enumerate(frames):
        m = image_io.read_png(str(tmp_path / "m" / f"{k:08d}.png")) > 0
        y0, x0, h, w = dt.mover_box(192, 640, i)
        box = np.zeros_like(m)
        box[y0:y0 + h, x0:x0 + w] = True
        inside, rest = m[box].mean(), m[~box].mean()
        assert inside >= 0.9 and inside >= 3 * rest, (inside, rest)


def test_train_main_precomputes_and_trains_on_masks(tmp_path, no_writer):
    from fsnet_tpu_torch.scripts import train as train_script

    raw = tmp_path / "raw"
    dt.write_kitti_date(str(raw / DATE), 272, 320)
    dt.write_kitti_drive(str(raw), DRIVE, 6, 272, 320, seed=4, mover=True)
    split = dt.write_split(tmp_path / "train.txt",
                           [f"{DRIVE} {i} l" for i in range(1, 5)])
    masks = str(tmp_path / "masks")
    frames = [0, 1, -1]
    child = dict(name="fsnet_tpu_torch.data.datasets.mono_dataset."
                      "KittiDepthMonoDataset",
                 raw_path=str(raw), split_file=split)
    small = edict(rgb_shape=(H, W, 3))
    over = {
        "path.checkpoint_path": str(tmp_path / "ckpt"),
        "train_dataset.cfg_list": [child],
        "train_dataset.is_motion_mask": True,
        "train_dataset.motion_mask_path": masks,
        "train_dataset.augmentation": tcommon.wpose_augmentation(
            small, frames, train=True),
        "trainer.precompute_hook": tcommon.motion_mask_hook(
            dict(child, frame_idxs=frames), (H, W), masks,
            distance_threshold=1.5),
        "trainer.evaluate_hook": None,
        "val_dataset.raw_path": str(raw), "val_dataset.split_file": split,
        "val_dataset.augmentation": tcommon.wpose_augmentation(
            small, frames, train=False),
        "meta_arch": tcommon.wpose_meta_arch(
            edict(rgb_shape=(H, W, 3), frame_idxs=frames), pretrained=False),
        "data.batch_size": 2, "data.num_workers": 0,
        "trainer.max_epochs": 1, "trainer.disp_iter": 1,
    }
    seen = []
    from fsnet_tpu_torch.models.heads import monodepth2_decoder as tmd

    loss = tmd.MonoDepth2Decoder.compute_total_reprojection_loss

    def watched(self, output_dict, input_dict, noise=None):
        seen.append(input_dict["motion_mask"].clone())
        return loss(self, output_dict, input_dict, noise=noise)

    tmd.MonoDepth2Decoder.compute_total_reprojection_loss = watched
    try:
        out = train_script.main(config=KITTI_CONFIG, device="cpu", **over)
    finally:
        tmd.MonoDepth2Decoder.compute_total_reprojection_loss = loss
    pre = out["precompute"]
    assert pre.written == 4 and pre.skipped == 0
    names = sorted(os.listdir(masks))
    assert names == [f"{i:08d}.png" for i in range(4)]
    written = [image_io.read_png(os.path.join(masks, n)) for n in names]
    assert all(m.shape == (H, W) and m.dtype == np.uint8 and m.max() <= 1
               for m in written)
    assert 0 < sum(int(m.sum()) for m in written) < 4 * H * W / 2
    assert out["global_step"] == 2 and len(seen) == 2
    assert all(m.shape == (2, H, W) and m.dtype == torch.uint8 for m in seen)
    assert np.isfinite([e["loss"] for e in out["log"]]).all()
    out = train_script.main(config=KITTI_CONFIG, device="cpu",
                            **dict(over, **{"trainer.max_epochs": 0}))
    assert out["precompute"].written == 0 and out["precompute"].skipped == 4


def test_check_hooks_takes_the_ported_hooks():
    from fsnet_tpu_torch.scripts.train import check_hooks
    from fsnet_tpu_torch.utils import cfg_from_file, update_cfg

    hooks = "fsnet_tpu_torch.pipeline_hooks."
    pre = tcommon.motion_mask_hook(
        dict(name="fsnet_tpu_torch.data.datasets.mono_dataset."
                  "KittiDepthMonoDataset", frame_idxs=[0, 1, -1]),
        (192, 640), "/unused")
    for over in ({"trainer.precompute_hook": pre},
                 {"trainer.precompute_hook": dict(
                     pre, name=hooks + "precompute_hooks."
                     "MotionMaskARFlowPrecomputeHook")},
                 {"trainer.evaluate_hook.name":
                  hooks + "evaluation_hooks.KittiEvaluationHook_postopt"}):
        check_hooks(update_cfg(cfg_from_file(KITTI_CONFIG), **over))
    for over in ({"trainer.precompute_hook": dict(
                     pre, name="fsnet_tpu.pipeline_hooks.precompute_hooks."
                     "MotionMaskPrecomputeHook")},
                 {"trainer.precompute_hook": dict(
                     pre, train_dataset_cfg=dict(
                         pre.train_dataset_cfg,
                         name="fsnet_tpu.data.datasets.mono_dataset."
                              "KittiDepthMonoDataset"))}):
        with pytest.raises(NotImplementedError, match="precompute_hook"):
            check_hooks(update_cfg(cfg_from_file(KITTI_CONFIG), **over))
