"""Writers of small on-disk dataset trees in the layouts of KITTI raw and
KITTI-360, with numpy, ``zlib`` and ``scipy.io`` only (no ``cv2`` or
``PIL``), so that ``chip_smoke.py`` can write them on a machine that has
neither. Nothing is downloaded: the images are seeded textures, the poses
1 m steps, the velodyne scans seeded points on a ground plane and walls.

* :func:`write_png`: a PNG file of 8- or 16-bit grey, RGB or RGBA samples;
  its rows cycle through the five scanline filters (None, Sub, Up,
  Average, Paeth) unless told otherwise, so that every branch of a reader
  runs. Forward filtering needs only the original bytes, so it is
  vectorised.
* :func:`write_kitti_date`, :func:`write_kitti_drive`: the KITTI raw layout
  of ``tests/test_kitti_dataset.py`` (calibration text files of one date,
  ``image_02``/``image_03`` frames, ``oxts/pose.mat``, velodyne ``.bin``
  scans and ``depth`` maps where asked), with KITTI's published calibration
  scaled to the frame size.
* :func:`write_kitti360`: the KITTI-360 layout of
  ``tests/test_kitti360_dataset.py`` (``calibration/``, ``data_poses/``,
  ``data_2d_raw/``, ``data_3d_raw/``).
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Iterable, Optional, Sequence

import numpy as np

_COLOUR = {1: 0, 3: 2, 4: 6}


def filter_rows(raw: np.ndarray, bpp: int, filters: np.ndarray
                ) -> np.ndarray:
    """[H, 1 + rowbytes] filtered scanlines of the [H, rowbytes] bytes
    ``raw``, row r filtered with type ``filters[r]``."""
    x = raw.astype(np.int16)
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    corner = np.zeros_like(x)
    corner[1:, bpp:] = x[:-1, :-bpp]
    p = left + up - corner
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - corner)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, corner))
    preds = (np.zeros_like(x), left, up, (left + up) >> 1, paeth)
    out = np.empty((x.shape[0], x.shape[1] + 1), np.uint8)
    out[:, 0] = filters
    for kind, pred in enumerate(preds):
        rows = filters == kind
        out[rows, 1:] = ((x[rows] - pred[rows]) & 0xFF).astype(np.uint8)
    return out


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def write_png(path, img: np.ndarray, level: int = 6,
              filters: Optional[Sequence[int]] = None,
              interlace: int = 0) -> None:
    """Writes ``img`` ([H, W] or [H, W, C], C in 1, 3, 4; ``uint8`` or
    ``uint16``) as a PNG. ``filters`` gives each row's filter type
    (default: the five in turn); ``interlace`` only sets the header's flag
    (the rows are written as they are); the stream is cut into IDAT chunks
    of 64 KiB."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"write_png takes uint8 or uint16, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    H, W, C = img.shape
    depth = 8 * img.dtype.itemsize
    data = img.astype(">u2") if depth == 16 else img
    raw = np.ascontiguousarray(data).view(np.uint8).reshape(H, -1)
    filters = (np.arange(H) % 5 if filters is None
               else np.asarray(filters, np.uint8))
    stream = zlib.compress(
        filter_rows(raw, C * depth // 8, filters).tobytes(), level)
    header = struct.pack(">IIBBBBB", W, H, depth, _COLOUR[C], 0, 0,
                         interlace)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header))
        for i in range(0, len(stream), 1 << 16):
            f.write(_chunk(b"IDAT", stream[i:i + (1 << 16)]))
        f.write(_chunk(b"IEND", b""))


def texture(H: int, W: int, shift: float, seed: int) -> np.ndarray:
    """An [H, W, 3] ``uint8`` frame: a smooth scene moved ``shift`` pixels
    to the left, with seeded noise."""
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    x = x + shift
    img = np.empty((H, W, 3), np.float32)
    for c, (fx, fy, ph) in enumerate(((0.031, 0.017, 0.0),
                                      (0.019, 0.043, 1.0),
                                      (0.053, 0.011, 2.0))):
        img[..., c] = (120 + 60 * np.sin(x * fx + ph) * np.cos(y * fy)
                       + 40 * np.sin((x - 0.6 * y) * 0.007 * (c + 1)))
    img += np.random.RandomState(seed).randn(H, W, 3).astype(np.float32) * 6
    return np.clip(img, 0, 255).astype(np.uint8)


# KITTI raw's published calibration of 2011_09_26 (1242x375)
KITTI_W, KITTI_H = 1242, 375
_P2 = [7.215377e+02, 0.0, 6.095593e+02, 4.485728e+01,
       0.0, 7.215377e+02, 1.728540e+02, 2.163791e-01,
       0.0, 0.0, 1.0, 2.745884e-03]
_P3 = [7.215377e+02, 0.0, 6.095593e+02, -3.395242e+02,
       0.0, 7.215377e+02, 1.728540e+02, 2.199936e+00,
       0.0, 0.0, 1.0, 2.729905e-03]
_R_RECT = [9.999239e-01, 9.837760e-03, -7.445048e-03,
           -9.869795e-03, 9.999421e-01, -4.278459e-03,
           7.402527e-03, 4.351614e-03, 9.999631e-01]
_VELO_R = [7.533745e-03, -9.999714e-01, -6.166020e-04,
           1.480249e-02, 7.280733e-04, -9.998902e-01,
           9.998621e-01, 7.523790e-03, 1.480755e-02]
_VELO_T = [-4.069766e-03, -7.631618e-02, -2.717806e-01]
_IMU_R = [9.999976e-01, 7.553071e-04, -2.035826e-03,
          -7.854027e-04, 9.998898e-01, -1.482298e-02,
          2.024406e-03, 1.482454e-02, 9.998881e-01]
_IMU_T = [-8.086759e-01, 3.195559e-01, -7.997231e-01]


def _floats(values: Iterable[float]) -> str:
    return " ".join(f"{v:.6e}" for v in values)


def _scaled(P, H: int, W: int):
    P = np.asarray(P, np.float64).reshape(3, 4).copy()
    P[0] *= W / KITTI_W
    P[1] *= H / KITTI_H
    return P.ravel()


def write_kitti_date(date_dir, H: int, W: int) -> None:
    """The three calibration files of one KITTI raw date, for H x W frames."""
    os.makedirs(date_dir, exist_ok=True)
    stamp = "calib_time: 09-Jan-2012 13:57:47\n"
    with open(os.path.join(date_dir, "calib_cam_to_cam.txt"), "w") as f:
        f.write(stamp)
        f.write(f"S_rect_02: {_floats([W, H])}\n")
        f.write(f"R_rect_00: {_floats(_R_RECT)}\n")
        f.write(f"P_rect_00: {_floats(_scaled(_P2, H, W))}\n")
        f.write(f"P_rect_02: {_floats(_scaled(_P2, H, W))}\n")
        f.write(f"S_rect_03: {_floats([W, H])}\n")
        f.write(f"P_rect_03: {_floats(_scaled(_P3, H, W))}\n")
    with open(os.path.join(date_dir, "calib_velo_to_cam.txt"), "w") as f:
        f.write(stamp)
        f.write(f"R: {_floats(_VELO_R)}\n")
        f.write(f"T: {_floats(_VELO_T)}\n")
        f.write("delta_f: 0.000000e+00 0.000000e+00\n")
    with open(os.path.join(date_dir, "calib_imu_to_velo.txt"), "w") as f:
        f.write(stamp)
        f.write(f"R: {_floats(_IMU_R)}\n")
        f.write(f"T: {_floats(_IMU_T)}\n")


def velodyne_scan(seed: int, n: int = 30000) -> np.ndarray:
    """[n, 4] float32 points (x forward, y left, z up, reflectance): half
    on the ground 1.73 m below the sensor, half on walls 7 m to each side,
    2 to 70 m ahead."""
    rng = np.random.RandomState(seed)
    pts = np.empty((n, 4), np.float32)
    g = n // 2
    pts[:, 0] = rng.uniform(2.0, 70.0, n)
    pts[:g, 1] = rng.uniform(-7.0, 7.0, g)
    pts[:g, 2] = -1.73
    pts[g:, 1] = np.where(rng.rand(n - g) < 0.5, -7.0, 7.0)
    pts[g:, 2] = rng.uniform(-1.73, 2.5, n - g)
    pts[:, 3] = rng.rand(n)
    return pts


def poses(n: int, static: Sequence[int] = ()) -> np.ndarray:
    """[n, 4, 4] imu->world poses: 1 m forward per frame with a slight
    yaw; frame k in ``static`` repeats frame k - 1."""
    out = np.stack([np.eye(4) for _ in range(n)])
    for i in range(n):
        a = 0.01 * i
        out[i, :2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        out[i, 0, 3] = float(i)
        out[i, 1, 3] = 0.05 * i
    for k in static:
        out[k] = out[k - 1]
    return out


def write_kitti_drive(root, drive: str, n: int, H: int, W: int,
                      seed: int = 0, cams=("image_02", "image_03"),
                      static: Sequence[int] = (), velodyne: bool = False,
                      depth: bool = False) -> None:
    """``n`` frames of ``drive`` (``<date>/<date>_drive_XXXX_sync``) under
    ``root``: each camera's PNGs, ``oxts/pose.mat``; with ``velodyne`` a
    scan per frame, with ``depth`` a 16-bit sparse depth PNG per frame under
    ``depth/`` (the Eigen test dataset's layout)."""
    import scipy.io as sio

    base = os.path.join(root, drive)
    for c, cam in enumerate(cams):
        d = os.path.join(base, cam, "data")
        os.makedirs(d, exist_ok=True)
        for i in range(n):
            write_png(os.path.join(d, "%010d.png" % i),
                      texture(H, W, 4.0 * i + 20 * c, seed * 1000 + 10 * i + c),
                      level=1)
    os.makedirs(os.path.join(base, "oxts"), exist_ok=True)
    sio.savemat(os.path.join(base, "oxts", "pose.mat"),
                {"pose_mat": poses(n, static)})
    if velodyne:
        d = os.path.join(base, "velodyne_points", "data")
        os.makedirs(d, exist_ok=True)
        for i in range(n):
            velodyne_scan(seed * 1000 + i).tofile(
                os.path.join(d, "%010d.bin" % i))
    if depth:
        d = os.path.join(base, "depth")
        os.makedirs(d, exist_ok=True)
        for i in range(n):
            write_png(os.path.join(d, "%010d.png" % i),
                      sparse_depth_png(H, W, seed * 1000 + i))


def sparse_depth_png(H: int, W: int, seed: int) -> np.ndarray:
    """[H, W] ``uint16`` KITTI-style depth (metres * 256, 0 where empty),
    one pixel in twenty filled."""
    rng = np.random.RandomState(seed)
    d = (rng.uniform(1.0, 80.0, (H, W)) * 256).astype(np.uint16)
    d[rng.rand(H, W) > 0.05] = 0
    return d


def write_split(path, lines: Iterable[str]) -> str:
    with open(path, "w") as f:
        f.write("".join(f"{line}\n" for line in lines))
    return str(path)


KITTI360_SEQ = "2013_05_28_drive_0000_sync"


def write_kitti360(root, H: int, W: int, xs: Sequence[float],
                   seed: int = 1, velodyne: bool = False) -> None:
    """A KITTI-360 tree of one sequence under ``root``: perspective and
    extrinsic calibration, ``poses.txt`` with baselink x at ``xs`` (one
    key pose and one frame each), both cameras' PNGs and, with
    ``velodyne``, a scan per frame and ``calib_cam_to_velo.txt``."""
    calib = os.path.join(root, "calibration")
    os.makedirs(calib, exist_ok=True)
    P = [0.55 * W, 0.0, W / 2, 0.0, 0.0, 0.55 * W, H / 2, 0.0,
         0.0, 0.0, 1.0, 0.0]
    with open(os.path.join(calib, "perspective.txt"), "w") as f:
        f.write(f"P_rect_00: {_floats(P)}\n")
        f.write(f"R_rect_00: {_floats(np.eye(3).ravel())}\n")
        f.write(f"P_rect_01: {_floats(P[:3] + [-0.3 * W] + P[4:])}\n")
        f.write(f"R_rect_01: {_floats(np.eye(3).ravel())}\n")
    # cam -> pose: cam z along baselink x, a small offset
    ext = "0 0 1 0.5 -1 0 0 0.1 0 -1 0 -0.2"
    with open(os.path.join(calib, "calib_cam_to_pose.txt"), "w") as f:
        f.write(f"image_00: {ext}\n")
        f.write(f"image_01: {ext}\n")
    # cam -> velo: velo x forward, y left, z up
    with open(os.path.join(calib, "calib_cam_to_velo.txt"), "w") as f:
        f.write("0 0 1 0.8 -1 0 0 0.3 0 -1 0 -0.7\n")
    pose_dir = os.path.join(root, "data_poses", KITTI360_SEQ)
    os.makedirs(pose_dir, exist_ok=True)
    with open(os.path.join(pose_dir, "poses.txt"), "w") as f:
        for i, x in enumerate(xs):
            f.write(f"{i} 1 0 0 {x} 0 1 0 0 0 0 1 0\n")
    for c, cam in enumerate(("image_00", "image_01")):
        d = os.path.join(root, "data_2d_raw", KITTI360_SEQ, cam, "data_rect")
        os.makedirs(d, exist_ok=True)
        for i, x in enumerate(xs):
            write_png(os.path.join(d, "%010d.png" % i),
                      texture(H, W, 4.0 * x + 20 * c,
                              seed * 1000 + 10 * i + c), level=1)
    if velodyne:
        d = os.path.join(root, "data_3d_raw", KITTI360_SEQ,
                         "velodyne_points", "data")
        os.makedirs(d, exist_ok=True)
        for i in range(len(xs)):
            velodyne_scan(seed * 1000 + i).tofile(
                os.path.join(d, "%010d.bin" % i))
