"""Writers of small on-disk dataset trees in the layouts of KITTI raw,
KITTI-360 and nuScenes, with numpy, ``zlib``, ``json`` and ``scipy.io``
only (no ``cv2`` or ``PIL``), so that ``chip_smoke.py`` can write them on a
machine that has neither. Nothing is downloaded: the images are seeded
textures, the poses 1 m steps, the velodyne scans seeded points on a
ground plane and walls.

* :func:`write_png`: a PNG file of 8- or 16-bit grey, RGB or RGBA samples;
  its rows cycle through the five scanline filters (None, Sub, Up,
  Average, Paeth) unless told otherwise, so that every branch of a reader
  runs. Forward filtering needs only the original bytes, so it is
  vectorised.
* :func:`write_jpeg`: a baseline JPEG file (grey, or YCbCr at 4:4:4,
  4:2:2, 4:2:0 or 4:4:0), in integer arithmetic throughout (IJG's
  colour tables and ``jfdctint`` forward DCT), so that its bytes are the
  same on every machine; the Annex K tables scaled by quality as IJG scales
  them, optional restart markers; the bit packing is vectorised.
* :func:`write_kitti_date`, :func:`write_kitti_drive`: the KITTI raw layout
  of ``tests/test_kitti_dataset.py`` (calibration text files of one date,
  ``image_02``/``image_03`` frames, ``oxts/pose.mat``, velodyne ``.bin``
  scans and ``depth`` maps where asked), with KITTI's published calibration
  scaled to the frame size.
* :func:`write_kitti360`: the KITTI-360 layout of
  ``tests/test_kitti360_dataset.py`` (``calibration/``, ``data_poses/``,
  ``data_2d_raw/``, ``data_3d_raw/``).
* :func:`write_nusc_json_tree`: nuScenes ``samples/<CAM>/<name>.jpg``
  frames, the train and val JSON files that ``NusceneJsonDataset`` reads
  and 16-bit ground-truth depth PNGs (metres x 256) under the evaluator's
  ``gt_saved_dir``.
"""
from __future__ import annotations

import json
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


# ------------------------------------------------------------ JPEG writer

# ITU T.81 Annex K: the example quantisation tables (natural order) and
# Huffman tables (counts of codes of length 1-16, then the symbols)
_K_QUANT = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
     14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
     18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    [17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
     24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32], np.int64)
_K_HUFF = {
    ("dc", 0): ("00010501010101010100000000000000",
                "000102030405060708090a0b"),
    ("dc", 1): ("00030101010101010101010000000000",
                "000102030405060708090a0b"),
    ("ac", 0): ("0002010303020403050504040000017d",
                "01020300041105122131410613516107227114328191a1082342b1c115"
                "52d1f02433627282090a161718191a25262728292a3435363738393a43"
                "4445464748494a535455565758595a636465666768696a737475767778"
                "797a838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2"
                "b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3"
                "e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"),
    ("ac", 1): ("00020102040403040705040400010277",
                "000102031104052131061241510761711322328108144291a1b1c10923"
                "3352f0156272d10a162434e125f11718191a262728292a35363738393a"
                "434445464748494a535455565758595a636465666768696a7374757677"
                "78797a82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9"
                "aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2"
                "e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"),
}
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# luma (h, v) sampling factors; chroma is 1x1
JPEG_SAMPLING = {"4:4:4": (1, 1), "4:2:2": (2, 1), "4:2:0": (2, 2),
                 "4:4:0": (1, 2)}


def jpeg_quant(quality: int) -> np.ndarray:
    """[2, 64] the Annex K tables scaled by ``quality`` as IJG's
    ``jpeg_quality_scaling`` does, limited to 1-255 (baseline)."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((_K_QUANT * scale + 50) // 100, 1, 255)


def _huff_codes(key):
    """symbol -> (code, length) of an Annex K table."""
    bits = bytes.fromhex(_K_HUFF[key][0])
    vals = bytes.fromhex(_K_HUFF[key][1])
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code, p = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            code_of[vals[p]], len_of[vals[p]] = code, length
            code += 1
            p += 1
        code <<= 1
    return code_of, len_of


def _ycbcr(rgb: np.ndarray) -> np.ndarray:
    """IJG ``jccolor.c``: RGB -> YCbCr in 16-bit fixed point."""
    fix = lambda v: int(v * 65536 + 0.5)                 # noqa: E731
    r, g, b = (rgb[..., c].astype(np.int64) for c in range(3))
    half, off = 1 << 15, 128 << 16
    y = (fix(0.299) * r + fix(0.587) * g + fix(0.114) * b + half) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + off + half
          - 1) >> 16
    cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + off + half
          - 1) >> 16
    return np.stack([y, cb, cr], -1)


def _fdct(blocks: np.ndarray) -> np.ndarray:
    """IJG ``jfdctint.c`` on [n, 8, 8] level-shifted samples: the
    coefficients scaled by 8, in integers."""
    def descale(x, n):
        return (x + (1 << (n - 1))) >> n

    def one_d(d, final):
        s0, s1, s2, s3, s4, s5, s6, s7 = (d[..., i] for i in range(8))
        t0, t7, t1, t6 = s0 + s7, s0 - s7, s1 + s6, s1 - s6
        t2, t5, t3, t4 = s2 + s5, s2 - s5, s3 + s4, s3 - s4
        t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
        sh = 15 if final else 11         # CONST_BITS +- PASS1_BITS
        out = [None] * 8
        if final:
            out[0], out[4] = descale(t10 + t11, 2), descale(t10 - t11, 2)
        else:
            out[0], out[4] = (t10 + t11) << 2, (t10 - t11) << 2
        z1 = (t12 + t13) * 4433
        out[2] = descale(z1 + t13 * 6270, sh)
        out[6] = descale(z1 - t12 * 15137, sh)
        z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
        z5 = (z3 + z4) * 9633
        t4, t5, t6, t7 = t4 * 2446, t5 * 16819, t6 * 25172, t7 * 12299
        z1, z2 = z1 * -7373, z2 * -20995
        z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
        out[7] = descale(t4 + z1 + z3, sh)
        out[5] = descale(t5 + z2 + z4, sh)
        out[3] = descale(t6 + z2 + z3, sh)
        out[1] = descale(t7 + z1 + z4, sh)
        return np.stack(out, -1)

    rows = one_d(blocks.astype(np.int64), False)             # along rows
    return np.swapaxes(one_d(np.swapaxes(rows, 1, 2), True), 1, 2)


def _blocks(plane: np.ndarray) -> np.ndarray:
    """[bh, bw, 8, 8] blocks of a plane whose sides are multiples of 8."""
    H, W = plane.shape
    return plane.reshape(H // 8, 8, W // 8, 8).transpose(0, 2, 1, 3)


def _category(v: np.ndarray) -> np.ndarray:
    """The bit length of |v| (0 for 0)."""
    return np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)


def _pack(vals: np.ndarray, nbits: np.ndarray) -> np.ndarray:
    """The bit fields (``vals``, ``nbits`` <= 32 each, MSB first) as bytes;
    every field lies within 5 bytes of its start, so each adds its share
    to those 5 bytes (the fields do not overlap, so adding is OR-ing)."""
    ends = np.cumsum(nbits)
    starts = ends - nbits
    nbytes = int(-(-ends[-1] // 8)) if len(ends) else 0
    shift = 40 - (starts % 8) - nbits
    window = vals << shift                       # a 40-bit window
    idx = (starts // 8)[:, None] + np.arange(5)
    part = (window[:, None] >> (32 - 8 * np.arange(5))) & 0xFF
    keep = idx < nbytes
    out = np.bincount(idx[keep], weights=part[keep], minlength=nbytes)
    return out.astype(np.uint8)


def write_jpeg(path, img: np.ndarray, quality: int = 90,
               subsampling: str = "4:2:0", restart_interval: int = 0
               ) -> None:
    """Writes ``img`` ([H, W, 3] RGB or [H, W] grey ``uint8``) as a
    baseline JFIF JPEG with the Annex K Huffman tables. ``subsampling``:
    the chroma planes' resolution (``JPEG_SAMPLING``; ignored for grey);
    ``restart_interval``: MCUs between RSTn markers (0: none)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise TypeError(f"write_jpeg takes [H, W(, 3)] uint8, got "
                        f"{img.dtype} {img.shape}")
    H, W = img.shape[:2]
    grey = img.ndim == 2
    hs, vs = (1, 1) if grey else JPEG_SAMPLING[subsampling]
    mx, my = -(-W // (8 * hs)), -(-H // (8 * vs))
    Hp, Wp = my * 8 * vs, mx * 8 * hs
    padded = np.pad(img, ((0, Hp - H), (0, Wp - W))
                    + ((), ((0, 0),))[not grey], mode="edge")
    planes = ([padded.astype(np.int64)] if grey
              else list(np.moveaxis(_ycbcr(padded), -1, 0)))
    # chroma: the mean of each hs x vs cell, rounded half up
    for c in range(1, len(planes)):
        cell = planes[c].reshape(Hp // vs, vs, Wp // hs, hs)
        planes[c] = (cell.sum((1, 3)) + (hs * vs) // 2) // (hs * vs)
    quant = jpeg_quant(quality)
    comps = [(hs, vs, 0)] + [(1, 1, 1)] * (len(planes) - 1)
    coefs = []                    # per component: [my, mx, v, h, 64] zigzag
    for plane, (h, v, t) in zip(planes, comps):
        blocks = _blocks(plane - 128)
        bh, bw = blocks.shape[:2]
        c = _fdct(blocks.reshape(-1, 8, 8)).reshape(-1, 64)
        q = quant[t] * 8
        c = np.sign(c) * ((np.abs(c) + q // 2) // q)
        c = c[:, _ZIGZAG].reshape(bh // v, v, bw // h, h, 64)
        coefs.append(c.transpose(0, 2, 1, 3, 4).reshape(my, mx, v * h, 64))
    # the blocks in scan order: MCU by MCU, each component's blocks in turn
    order = np.concatenate(coefs, 2).reshape(-1, 64)
    per_mcu = order.shape[0] // (mx * my)
    table = np.concatenate([np.full(h * v, t) for h, v, t in comps])
    comp_of = np.concatenate([np.full(h * v, i)
                              for i, (h, v, _) in enumerate(comps)])
    mcu = np.arange(order.shape[0]) // per_mcu
    interval = mcu // restart_interval if restart_interval else 0 * mcu
    # DC differences, predictors reset at each restart interval
    dc = order[:, 0]
    diff = np.empty_like(dc)
    for i in range(len(comps)):
        sel = np.flatnonzero(comp_of[np.arange(len(dc)) % per_mcu] == i)
        prev = np.concatenate([[0], dc[sel][:-1]])
        first = np.concatenate([[True], interval[sel][1:]
                                != interval[sel][:-1]])
        diff[sel] = dc[sel] - np.where(first, 0, prev)
    tables = np.tile(table, mx * my)
    codes = {k: _huff_codes(k) for k in _K_HUFF}
    # every field: (sort key, value, bits); key = (block, position, sub)
    keys, vals, nbits = [], [], []

    def add(key, sym, extra, size, kind, tab):
        code = np.where(tab == 0, codes[(kind, 0)][0][sym],
                        codes[(kind, 1)][0][sym])
        length = np.where(tab == 0, codes[(kind, 0)][1][sym],
                          codes[(kind, 1)][1][sym])
        keys.append(key)
        vals.append((code << size) | (extra & ((1 << size) - 1)))
        nbits.append(length + size)

    blocks = np.arange(len(dc))
    s = _category(diff)
    add(blocks * 260, s, np.where(diff < 0, diff - 1, diff), s, "dc",
        tables)
    b, k = np.nonzero(order[:, 1:])
    k = k + 1
    v = order[b, k]
    prev_k = np.where(np.concatenate([[True], b[1:] != b[:-1]]), 0,
                      np.concatenate([[0], k[:-1]]))
    run = k - prev_k - 1
    zrl = run // 16
    for z in range(1, 4):                    # runs of 16 zeros first
        sel = zrl >= z
        add((b[sel] * 65 + k[sel]) * 4 + z - 1, np.full(sel.sum(), 0xF0),
            np.zeros(sel.sum(), np.int64), np.zeros(sel.sum(), np.int64),
            "ac", tables[b[sel]])
    s = _category(v)
    add((b * 65 + k) * 4 + 3, ((run % 16) << 4) | s,
        np.where(v < 0, v - 1, v), s, "ac", tables[b])
    last = np.zeros(len(dc), np.int64)
    last[b] = k                              # k ascends within a block
    eob = np.flatnonzero(last < 63)
    add(eob * 260 + 259, np.zeros(len(eob), np.int64),
        np.zeros(len(eob), np.int64), np.zeros(len(eob), np.int64), "ac",
        tables[eob])
    keys = np.concatenate(keys)
    order_ = np.argsort(keys, kind="stable")
    vals = np.concatenate(vals)[order_]
    nbits = np.concatenate(nbits)[order_]
    field_interval = interval[keys[order_] // 260]
    # each interval padded with 1-bits to a whole byte
    n_int = int(field_interval.max()) + 1
    bits_per = np.bincount(field_interval, weights=nbits, minlength=n_int
                           ).astype(np.int64)
    pad = (-bits_per) % 8
    ends = np.searchsorted(field_interval, np.arange(n_int), side="right")
    vals = np.insert(vals, ends, (1 << pad) - 1)
    nbits = np.insert(nbits, ends, pad)
    data = _pack(vals, nbits)
    # stuff a 00 after every FF, then an RSTn after each interval but the
    # last
    interval_end = np.cumsum((bits_per + pad) // 8)
    ff = np.flatnonzero(data == 0xFF)
    data = np.insert(data, ff + 1, 0)
    at = interval_end[:-1] + np.searchsorted(ff, interval_end[:-1])
    rst = 0xD0 + np.arange(n_int - 1) % 8
    data = np.insert(data, np.repeat(at, 2),
                     np.stack([np.full(n_int - 1, 0xFF), rst], 1).ravel())

    def segment(marker, payload):
        return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload

    head = [b"\xff\xd8", segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00"
                                 b"\x01\x00\x00")]
    for t in range(1 if grey else 2):
        head.append(segment(0xDB, bytes([t]) + bytes(
            quant[t][_ZIGZAG].astype(np.uint8))))
    sof = struct.pack(">BHHB", 8, H, W, len(comps)) + b"".join(
        bytes([i + 1, (h << 4) | v, t]) for i, (h, v, t) in enumerate(comps))
    head.append(segment(0xC0, sof))
    for (kind, t), (bits, syms) in sorted(_K_HUFF.items()):
        if t and grey:
            continue
        head.append(segment(0xC4, bytes([(kind == "ac") << 4 | t])
                            + bytes.fromhex(bits) + bytes.fromhex(syms)))
    if restart_interval:
        head.append(segment(0xDD, struct.pack(">H", restart_interval)))
    sos = bytes([len(comps)]) + b"".join(
        bytes([i + 1, (t << 4) | t]) for i, (_, _, t) in enumerate(comps)
    ) + b"\x00\x3f\x00"
    head.append(segment(0xDA, sos))
    with open(path, "wb") as f:
        f.write(b"".join(head) + data.tobytes() + b"\xff\xd9")


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


# nuScenes' CAM_FRONT intrinsics at 1600x900 (the devkit's v1.0 calibration)
NUSC_W, NUSC_H = 1600, 900
_NUSC_K = [1266.417, 0.0, 816.267, 0.0, 1266.417, 491.507, 0.0, 0.0, 1.0]
# the devkit's channel order (``camera_type_indexes``)
NUSC_CHANNELS = ("CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_BACK_RIGHT",
                 "CAM_BACK", "CAM_BACK_LEFT", "CAM_FRONT_LEFT")


def nusc_intrinsics(H: int, W: int) -> np.ndarray:
    K = np.asarray(_NUSC_K, np.float64).reshape(3, 3).copy()
    K[0] *= W / NUSC_W
    K[1] *= H / NUSC_H
    return K


def nusc_extrinsics(cam: str) -> np.ndarray:
    """camera -> ego, 4x4: CAM_FRONT looks along the ego's x axis,
    CAM_BACK against it, both level and at the ego's origin (the two
    cameras the trees hold)."""
    T = np.eye(4)
    sign = 1.0 if cam == "CAM_FRONT" else -1.0
    # columns: the camera's x (right), y (down) and z (forward) in the ego
    T[:3, :3] = [[0.0, 0.0, sign], [-sign, 0.0, 0.0], [0.0, -1.0, 0.0]]
    return T


def _nusc_pose(step: float) -> np.ndarray:
    T = np.eye(4)
    T[2, 3] = -step
    return T


def write_nusc_json_tree(root, H: int, W: int, n_train: int, n_val: int,
                         seed: int = 0, quality: int = 90,
                         subsampling: str = "4:2:0",
                         restart_interval: int = 0, depth_map=None,
                         cams: Sequence[str] = ("CAM_FRONT", "CAM_BACK")
                         ) -> dict:
    """A nuScenes tree under ``root``: per camera of ``cams`` a sequence of
    JPEG frames ``samples/<CAM>/<CAM>__<k>.jpg`` (H x W seeded textures, 4
    pixels apart); ``n_train`` training samples, the cameras in turn, each
    a frame and its two neighbours in ``json_train.json``, and ``n_val`` of
    the same frames in ``json_val.json`` (the keys ``NusceneJsonDataset``
    reads, absolute paths); ``nusc_val.txt`` of one token a val sample;
    with ``depth_map`` (``generate_depth_map``'s signature), each val
    frame's ground truth from a seeded scan as a 16-bit PNG (metres x 256)
    under ``samples_depth_gt/<CAM>/``. Returns the paths and the frames
    written."""
    root = str(root)
    per_cam = -(-max(n_train, n_val) // len(cams))
    frames = {}
    for c, cam in enumerate(cams):
        d = os.path.join(root, "samples", cam)
        os.makedirs(d, exist_ok=True)
        for k in range(per_cam + 2):
            path = os.path.join(d, f"{cam}__{k:06d}.jpg")
            write_jpeg(path, texture(H, W, 4.0 * k, seed * 1000 + 10 * k + c),
                       quality, subsampling, restart_interval)
            frames[cam, k] = path
    K = nusc_intrinsics(H, W)
    pose = _nusc_pose(0.9)

    def sample(i):
        cam = cams[i % len(cams)]
        k = i // len(cams) + 1
        return {"frame0": frames[cam, k], "frame1": frames[cam, k + 1],
                "frame-1": frames[cam, k - 1], "P2": K.ravel().tolist(),
                "pose01": pose.ravel().tolist(),
                "pose0-1": np.linalg.inv(pose).ravel().tolist(),
                "camera_type_indexes": NUSC_CHANNELS.index(cam),
                "camera_type": cam}

    out = dict(root=root, frames=sorted(frames.values()))
    for split, n in (("train", n_train), ("val", n_val)):
        out[split] = os.path.join(root, f"json_{split}.json")
        with open(out[split], "w") as f:
            json.dump({"samples": [sample(i) for i in range(n)]}, f)
    out["split"] = write_split(os.path.join(root, "nusc_val.txt"),
                               [f"token{i:04d}" for i in range(n_val)])
    out["gt"] = os.path.join(root, "samples_depth_gt")
    if depth_map is not None:
        for i in range(n_val):
            s = sample(i)
            cam = s["camera_type"]
            os.makedirs(os.path.join(out["gt"], cam), exist_ok=True)
            velo = velodyne_scan(seed * 1000 + 500 + i)
            if cam == "CAM_BACK":              # the scan turned to face it
                velo[:, :2] = -velo[:, :2]
            depth = depth_map(velo, nusc_extrinsics(cam), K, im_shape=(H, W))
            name = os.path.basename(s["frame0"])[:-4] + ".png"
            write_png(os.path.join(out["gt"], cam, name),
                      (depth * 256).astype(np.uint16), level=1)
    return out


# ------------------------------------------------- KITTI-360 fisheye tree

# threads that make and write a tree's frames
THREADS = 8

# two Mei cameras for 1400x1400 frames, of the size KITTI-360's fisheye
# calibration has (xi about 2.2 and 2.6, the fisheye disc about 640 px in
# radius): image_02 looks to the left of the car, image_03 to the right
FISHEYE_H = FISHEYE_W = 1400
FISHEYE_CAMS = {
    "image_02": dict(xi=2.2134047507854890, k1=1.6798235660113681e-02,
                     k2=1.6548773243373522, gamma1=1336.3220825849971,
                     gamma2=1335.7883350012958, u0=716.94323510126321,
                     v0=705.76498308221585),
    "image_03": dict(xi=2.5535139132482758, k1=4.9370396274089505e-02,
                     k2=4.5068455478645308, gamma1=1485.4388981875156,
                     gamma2=1484.9477411748708, u0=698.88316784030962,
                     v0=698.14541887723055),
}
# cam -> pose (baselink x forward, y left, z up), row-major 3x4: the
# perspective pair looking ahead, image_02 to the left, image_03 to the
# right
_FISHEYE_EXT = {
    "image_00": "0 0 1 0.5 -1 0 0 0.1 0 -1 0 -0.2",
    "image_01": "0 0 1 0.5 -1 0 0 -0.5 0 -1 0 -0.2",
    "image_02": "1 0 0 0.7 0 0 1 0.8 0 -1 0 0",
    "image_03": "-1 0 0 0.7 0 0 -1 -0.8 0 -1 0 0",
}


def fisheye_meta(k: int) -> str:
    """The meta line of the sample centred on frame ``k`` (pose row and
    image ``k``, neighbours ``k - 1`` and ``k + 1``)."""
    return f"{KITTI360_SEQ},{k},{k},{k - 1},{k + 1}"


def write_kitti360_fisheye(root, H: int, W: int, n: int, step: float = 0.8,
                           seed: int = 1, velodyne: Sequence[int] = ()
                           ) -> dict:
    """A KITTI-360 fisheye tree of one sequence under ``root``: the Mei
    yaml of ``image_02`` and ``image_03`` (:data:`FISHEYE_CAMS` scaled to
    H x W; the first line ``%YAML:1.0``, which the readers skip),
    ``calib_cam_to_pose.txt`` of ``image_00``-``image_03``,
    ``calib_cam_to_velo.txt``, ``poses.txt`` with baselink x at ``step``
    metres a frame (inside the static filter's 0.03-3 m), ``n`` frames of
    each fisheye camera under ``data_2d_raw/<seq>/image_0x/data_rgb`` and a
    30,000-point velodyne scan for each frame in ``velodyne``; the frames
    are made and written by :data:`THREADS` threads (numpy and zlib release
    the GIL). Returns the paths."""
    from concurrent.futures import ThreadPoolExecutor

    root = str(root)
    calib = os.path.join(root, "calibration")
    os.makedirs(calib, exist_ok=True)
    for cam, p in FISHEYE_CAMS.items():
        with open(os.path.join(calib, f"{cam}.yaml"), "w") as f:
            f.write("%YAML:1.0\n---\nmodel_type: MEI\n")
            f.write(f"camera_name: {cam}\nimage_width: {W}\n"
                    f"image_height: {H}\n")
            f.write(f"mirror_parameters:\n   xi: {p['xi']!r}\n")
            f.write(f"distortion_parameters:\n   k1: {p['k1']!r}\n"
                    f"   k2: {p['k2']!r}\n   p1: 0.0\n   p2: 0.0\n")
            f.write("projection_parameters:\n"
                    f"   gamma1: {p['gamma1'] * W / FISHEYE_W!r}\n"
                    f"   gamma2: {p['gamma2'] * H / FISHEYE_H!r}\n"
                    f"   u0: {p['u0'] * W / FISHEYE_W!r}\n"
                    f"   v0: {p['v0'] * H / FISHEYE_H!r}\n")
    with open(os.path.join(calib, "calib_cam_to_pose.txt"), "w") as f:
        for cam, ext in _FISHEYE_EXT.items():
            f.write(f"{cam}: {ext}\n")
    with open(os.path.join(calib, "calib_cam_to_velo.txt"), "w") as f:
        f.write("0 0 1 0.8 -1 0 0 0.3 0 -1 0 -0.7\n")
    pose_dir = os.path.join(root, "data_poses", KITTI360_SEQ)
    os.makedirs(pose_dir, exist_ok=True)
    with open(os.path.join(pose_dir, "poses.txt"), "w") as f:
        for i in range(n):
            f.write(f"{i} 1 0 0 {step * i} 0 1 0 0 0 0 1 0\n")
    jobs = []
    for c, cam in enumerate(("image_02", "image_03")):
        d = os.path.join(root, "data_2d_raw", KITTI360_SEQ, cam, "data_rgb")
        os.makedirs(d, exist_ok=True)
        jobs += [(os.path.join(d, "%010d.png" % i), 4.0 * i + 20 * c,
                  seed * 1000 + 10 * i + c) for i in range(n)]
    with ThreadPoolExecutor(THREADS) as pool:
        list(pool.map(lambda j: write_png(j[0], texture(H, W, j[1], j[2]),
                                          level=1), jobs))
    d = os.path.join(root, "data_3d_raw", KITTI360_SEQ, "velodyne_points",
                     "data")
    os.makedirs(d, exist_ok=True)
    for i in velodyne:
        velodyne_scan(seed * 1000 + i).tofile(
            os.path.join(d, "%010d.bin" % i))
    return dict(root=root, seq=KITTI360_SEQ, n=n)


# ---------------------------------------------------- FusionPortable tree

# FusionPortable's frame cameras: 1024x768; intrinsics of that order
FUSION_W, FUSION_H = 1024, 768
_FUSION_K = [606.0, 0.0, 518.5, 0.0, 605.5, 380.5, 0.0, 0.0, 1.0]
# quaternions (w, x, y, z): body IMU (x forward, y left, z up) -> camera
# (x right, y down, z forward), and camera -> Ouster (x forward)
_IMU2CAM_Q = [0.5, 0.5, -0.5, 0.5]
_CAM2OUSTER_Q = [0.5, -0.5, 0.5, -0.5]


def _opencv_matrix(f, name: str, rows: int, cols: int, data) -> None:
    f.write(f"{name}: !!opencv-matrix\n   rows: {rows}\n   cols: {cols}\n"
            f"   dt: d\n   data: [{', '.join(repr(float(v)) for v in data)}]\n")


def write_pcd(path, points: np.ndarray, binary: bool) -> None:
    """A PCD file of [N, 4] float32 (x, y, z, intensity), ``DATA ascii``
    (``%.6f``) or ``DATA binary``."""
    pts = np.ascontiguousarray(points, np.float32)
    head = ("# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
            "FIELDS x y z intensity\nSIZE 4 4 4 4\nTYPE F F F F\n"
            "COUNT 1 1 1 1\n"
            f"WIDTH {len(pts)}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
            f"POINTS {len(pts)}\nDATA {'binary' if binary else 'ascii'}\n")
    with open(path, "wb") as f:
        f.write(head.encode("ascii"))
        if binary:
            f.write(pts.tobytes())
        else:
            f.write((("%.6f %.6f %.6f %.6f\n" * len(pts))
                     % tuple(pts.astype(np.float64).ravel())).encode("ascii"))


def write_fusionportable(root, H: int, W: int, n: int, seed: int = 0,
                         static: Sequence[int] = (), scan_points: int = 30000
                         ) -> dict:
    """A FusionPortable sequence under ``root``: the OpenCV yaml of
    ``frame_cam00``, ``frame_cam01`` (a 0.25 m stereo baseline in P) and
    ``ouster00``, TUM odometry ``odom.txt`` (0.5 m forward a frame with a
    slight yaw; frame k in ``static`` repeats frame k - 1), ``n`` PNG frames
    of each camera and an Ouster scan a frame as PCD, ASCII for even
    frames and binary for odd ones; the frames are made and written by
    :data:`THREADS` threads. Returns the paths."""
    from concurrent.futures import ThreadPoolExecutor

    root = str(root)
    calib = os.path.join(root, "calib")
    os.makedirs(calib, exist_ok=True)
    K = np.asarray(_FUSION_K).reshape(3, 3).copy()
    K[0] *= W / FUSION_W
    K[1] *= H / FUSION_H
    for c, cam in enumerate(("frame_cam00", "frame_cam01")):
        P = np.zeros((3, 4))
        P[:, :3] = K
        P[0, 3] = -0.25 * K[0, 0] * c
        with open(os.path.join(calib, f"{cam}.yaml"), "w") as f:
            f.write(f"%YAML:1.0\nimage_height: {H}\nimage_width: {W}\n"
                    "distortion_model: plumb_bob\n")
            _opencv_matrix(f, "camera_matrix", 3, 3, K.ravel())
            _opencv_matrix(f, "rectification_matrix", 3, 3,
                           np.eye(3).ravel())
            _opencv_matrix(f, "distortion_coefficients", 1, 5, [0.0] * 5)
            _opencv_matrix(f, "projection_matrix", 3, 4, P.ravel())
            _opencv_matrix(f, "quaternion_sensor_bodyimu", 1, 4, _IMU2CAM_Q)
            _opencv_matrix(f, "translation_sensor_bodyimu", 1, 3,
                           [0.1, -0.05 - 0.25 * c, 0.2])
    with open(os.path.join(calib, "ouster00.yaml"), "w") as f:
        f.write("%YAML:1.0\n")
        _opencv_matrix(f, "quaternion_sensor_bodyimu", 1, 4,
                       [1.0, 0.0, 0.0, 0.0])
        _opencv_matrix(f, "translation_sensor_bodyimu", 1, 3,
                       [0.0, 0.0, 0.3])
        _opencv_matrix(f, "quaternion_sensor_frame_cam00", 1, 4,
                       _CAM2OUSTER_Q)
        _opencv_matrix(f, "translation_sensor_frame_cam00", 1, 3,
                       [0.1, 0.05, -0.1])
    xs = [0.5 * i for i in range(n)]
    for k in static:
        xs[k] = xs[k - 1]
    with open(os.path.join(root, "odom.txt"), "w") as f:
        for i, x in enumerate(xs):
            a = 0.01 * i
            f.write(f"{1646000000.0 + 0.1 * i:.6f} {x:.6f} {0.02 * i:.6f} "
                    f"0.000000 0.000000 0.000000 {np.sin(a / 2):.9f} "
                    f"{np.cos(a / 2):.9f}\n")
    jobs = []
    for c, cam in enumerate(("frame_cam00", "frame_cam01")):
        d = os.path.join(root, cam, "image", "data")
        os.makedirs(d, exist_ok=True)
        jobs += [(os.path.join(d, "%06d.png" % i), 4.0 * i + 12 * c,
                  seed * 1000 + 10 * i + c) for i in range(n)]
    d = os.path.join(root, "ouster00", "point", "data")
    os.makedirs(d, exist_ok=True)
    with ThreadPoolExecutor(THREADS) as pool:
        list(pool.map(lambda j: write_png(j[0], texture(H, W, j[1], j[2]),
                                          level=1), jobs))
    for i in range(n):
        write_pcd(os.path.join(d, "%06d.pcd" % i),
                  velodyne_scan(seed * 1000 + 500 + i, scan_points),
                  binary=bool(i % 2))
    return dict(root=root, odom="odom.txt", n=n)
