"""The port's PNG and JPEG readers (host code, no ``cv2``, ``PIL`` or
``libjpeg``): they stand in for the ``cv2.imread`` and ``PIL.Image.open``
calls of the JAX package's ``fsnet_tpu.data.datasets.io_utils``.

A PNG file is read in three steps:

1. the chunks are parsed in Python: the signature, IHDR, the run of IDAT
   chunks and IEND, each chunk's CRC checked with ``zlib.crc32``;
2. the IDAT stream is inflated by the standard library's ``zlib``;
3. the scanline filters (None, Sub, Up, Average, Paeth) are reversed in C
   (``csrc/host/png_unfilter.c``). Average and Paeth read the reconstructed
   pixel to the left and the one above, so the scan is serial; a loop in
   numpy would take seconds for a KITTI frame.

A JPEG file is read in two steps:

1. the markers are parsed and checked in Python (SOI, APPn, COM, DQT,
   SOF0/SOF1, DHT, DRI, SOS, EOI);
2. one C call (``csrc/host/jpeg_decode.c``) decodes the scan: Huffman
   decoding, dequantisation, the integer "islow" IDCT, libjpeg's "fancy"
   upsampling and its fixed-point YCbCr -> RGB conversion, the arithmetic of
   libjpeg-turbo's default decompression, so that the pixels are PIL's bit
   for bit.

Read: 8-bit sequential Huffman files (baseline SOF0 and extended SOF1) of
one interleaved scan, grey or YCbCr, each chroma plane at 1 or 1/2 of the
luma's resolution on each axis (4:4:4, 4:2:2, 4:2:0, 4:4:0), restart
intervals, any size. Progressive, arithmetic-coded, lossless and 12-bit
files, CMYK and RGB (Adobe transform 0) colour, and files of several scans
raise :class:`JPEGError`, naming the file and the reason; no dataset of the
repo holds one.

The C code is compiled at first use with ``cc -O2 -shared -fPIC`` into the
git-ignored ``build/host/`` at the root of the checkout, under a file name
that carries a hash of the source and the flags, written to a temporary
name and renamed into place so that parallel processes may build at once;
it is loaded with ``ctypes``. Without ``cc`` the readers raise: there is no
other route. :func:`unfilter_plain` is the same function in numpy and
Python, and :func:`decode_plain` takes the C decoder's quantised
coefficients through the same IDCT, upsampling and colour arithmetic in
numpy, for the tests and ``chip_smoke.py`` to hold the C code against.

Files read: bit depth 8 or 16 (16-bit samples are big-endian in the file),
colour type 0 (grey), 2 (RGB) or 6 (RGBA), not interlaced. Palette,
grey+alpha, Adam7-interlaced files and bit depths below 8 raise, naming the
file and the reason; no dataset of the repo holds one.

What each reader returns matches the call it replaces exactly:

* :func:`read_image` is ``np.array(PIL.Image.open(path))`` for a PNG or a
  JPEG, chosen by the file's signature: HxWx3 ``uint8`` in RGB order (HxWx4
  for an RGBA PNG, HxW for grey); a 16-bit colour PNG is reduced to its
  high bytes as PIL reduces it, a 16-bit grey PNG stays ``uint16``;
* :func:`imread_unchanged` is ``cv2.imread(path, cv2.IMREAD_UNCHANGED)``:
  grey HxW, colour in BGR (BGRA) order, ``uint8`` or ``uint16``;
* :func:`png_size` reads only the header: (H, W).

:func:`write_png` writes a grey 8- or 16-bit PNG (the motion masks of
``pipeline_hooks/precompute_hooks.py``) in place of ``cv2.imwrite``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
import zlib
from pathlib import Path
from typing import Tuple

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8"
HOST_SRC = Path(__file__).resolve().parents[2] / "csrc" / "host"
SOURCE = HOST_SRC / "png_unfilter.c"
JPEG_SOURCE = HOST_SRC / "jpeg_decode.c"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "host"
CC_FLAGS = ("-O2", "-shared", "-fPIC")
# colour type -> samples per pixel
_CHANNELS = {0: 1, 2: 3, 6: 4}
_REFUSED = {3: "palette colour (type 3)", 4: "grey with alpha (type 4)"}

_lock = threading.Lock()
_libs = {}


class PNGError(ValueError):
    """A PNG file the reader cannot or will not decode."""


class JPEGError(ValueError):
    """A JPEG file the reader cannot or will not decode."""


def library_path(source: Path = SOURCE) -> Path:
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join(CC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}_{digest.hexdigest()[:16]}.so"


def _build(out: Path, source: Path) -> None:
    cc = os.environ.get("CC") or shutil.which("cc")
    if cc is None:
        raise RuntimeError(f"the image readers' {source.name} is C code "
                           "built at first use, and no C compiler (cc) was "
                           "found")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cc, *CC_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"cc failed on {source}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)     # atomic: a reader never sees half a library


_I64, _PTR = ctypes.c_int64, ctypes.c_void_p
# each library's entry points: (argument types, result type)
_ENTRY_POINTS = {
    SOURCE: {"png_unfilter": ((ctypes.c_char_p, _PTR, _I64, _I64, _I64),
                              _I64)},
    JPEG_SOURCE: {
        "jpeg_coefficients": ((ctypes.c_char_p, _I64, _I64, _PTR, _I64,
                               _I64, _I64, _PTR, _PTR, _PTR, _PTR, _PTR),
                              _I64),
        "jpeg_decode": ((ctypes.c_char_p, _I64, _I64, _PTR, _I64, _I64,
                         _I64, _PTR, _PTR, _PTR, _PTR, _PTR, _I64, _I64,
                         _PTR, _PTR), _I64),
        "jpeg_error": ((_I64,), ctypes.c_char_p)},
}


def _library(source: Path = SOURCE) -> ctypes.CDLL:
    """The C code of ``source``, built at first use and loaded once."""
    with _lock:
        if source not in _libs:
            path = library_path(source)
            if not path.exists():
                _build(path, source)
            lib = ctypes.CDLL(str(path))
            for name, (argtypes, restype) in _ENTRY_POINTS[source].items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            _libs[source] = lib
        return _libs[source]


def unfilter(data: bytes, height: int, rowbytes: int, bpp: int
             ) -> np.ndarray:
    """The reconstructed bytes, [height, rowbytes] ``uint8``, of the
    inflated stream ``data`` (each row a filter-type byte and ``rowbytes``
    filtered bytes); ``bpp`` is the bytes of one pixel. The C code."""
    if len(data) < height * (rowbytes + 1):
        raise PNGError(f"{len(data)} bytes of image data, "
                       f"{height * (rowbytes + 1)} needed")
    out = np.empty((height, rowbytes), np.uint8)
    rc = _library().png_unfilter(data, out.ctypes.data, height, rowbytes,
                                 bpp)
    if rc != 0:
        row = -rc - 1
        raise PNGError(f"row {row}: filter type "
                       f"{data[row * (rowbytes + 1)]}")
    return out


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def unfilter_plain(data: bytes, height: int, rowbytes: int, bpp: int
                   ) -> np.ndarray:
    """:func:`unfilter` in numpy and Python, row by row: the reference the
    C code is held to."""
    if len(data) < height * (rowbytes + 1):
        raise PNGError(f"{len(data)} bytes of image data, "
                       f"{height * (rowbytes + 1)} needed")
    rows = np.frombuffer(data, np.uint8, height * (rowbytes + 1)
                         ).reshape(height, rowbytes + 1)
    out = np.zeros((height, rowbytes), np.uint8)
    prev = np.zeros(rowbytes, np.uint8)
    for r in range(height):
        kind, raw = int(rows[r, 0]), rows[r, 1:]
        if kind == 0:
            row = raw.copy()
        elif kind == 1:           # a running sum along each byte lane
            row = (np.cumsum(raw.reshape(-1, bpp), axis=0, dtype=np.uint64)
                   % 256).astype(np.uint8).reshape(-1)
        elif kind == 2:
            row = raw + prev          # uint8 wraps modulo 256
        elif kind in (3, 4):
            x, up = raw.tolist(), prev.tolist()
            got = [0] * rowbytes
            for i in range(rowbytes):
                left = got[i - bpp] if i >= bpp else 0
                if kind == 3:
                    pred = (left + up[i]) >> 1
                else:
                    pred = _paeth(left, up[i],
                                  up[i - bpp] if i >= bpp else 0)
                got[i] = (x[i] + pred) & 0xFF
            row = np.array(got, np.uint8)
        else:
            raise PNGError(f"row {r}: filter type {kind}")
        out[r] = row
        prev = row
    return out


def _chunks(path: str):
    """(type, data) of each chunk of ``path`` up to IEND, CRCs checked."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != SIGNATURE:
        raise PNGError(f"{path}: not a PNG file (bad signature)")
    pos = 8
    while True:
        if pos + 8 > len(blob):
            raise PNGError(f"{path}: truncated before IEND")
        length, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(blob):
            raise PNGError(f"{path}: chunk {kind!r} truncated")
        data = blob[pos + 8:end]
        (crc,) = struct.unpack(">I", blob[end:end + 4])
        if zlib.crc32(kind + data) != crc:
            raise PNGError(f"{path}: CRC mismatch in chunk {kind!r}")
        yield kind, data
        if kind == b"IEND":
            return
        pos = end + 4


def _header(path: str, data: bytes) -> Tuple[int, int, int, int]:
    if len(data) != 13:
        raise PNGError(f"{path}: IHDR of {len(data)} bytes")
    width, height, depth, colour, comp, filt, interlace = struct.unpack(
        ">IIBBBBB", data)
    if colour in _REFUSED:
        raise PNGError(f"{path}: {_REFUSED[colour]} is not read")
    if colour not in _CHANNELS:
        raise PNGError(f"{path}: colour type {colour} is not a PNG type")
    if depth not in (8, 16):
        raise PNGError(f"{path}: bit depth {depth} is not read (8 or 16)")
    if interlace != 0:
        raise PNGError(f"{path}: Adam7 interlacing is not read")
    if comp != 0 or filt != 0:
        raise PNGError(f"{path}: compression {comp} / filter method {filt}")
    return height, width, depth, colour


def png_size(path: str) -> Tuple[int, int]:
    """(H, W) of ``path`` from its header alone (the first 33 bytes)."""
    with open(path, "rb") as f:
        head = f.read(33)
    if head[:8] != SIGNATURE:
        raise PNGError(f"{path}: not a PNG file (bad signature)")
    if len(head) < 33 or head[12:16] != b"IHDR" or \
            struct.unpack(">I", head[8:12])[0] != 13:
        raise PNGError(f"{path}: no IHDR of 13 bytes at the start")
    if zlib.crc32(head[12:29]) != struct.unpack(">I", head[29:33])[0]:
        raise PNGError(f"{path}: CRC mismatch in chunk b'IHDR'")
    width, height = struct.unpack(">II", head[16:24])
    return height, width


def read_png(path: str, plain: bool = False) -> np.ndarray:
    """The samples of ``path`` in file order: [H, W] for grey, [H, W, 3]
    RGB, [H, W, 4] RGBA; ``uint8`` or native-order ``uint16``. ``plain``
    reverses the filters with :func:`unfilter_plain` instead of the C
    code."""
    header, idat = None, []
    for kind, data in _chunks(path):
        if header is None:
            if kind != b"IHDR":
                raise PNGError(f"{path}: first chunk {kind!r}, not IHDR")
            header = _header(path, data)
        elif kind == b"IDAT":
            idat.append(data)
    height, width, depth, colour = header
    if not idat:
        raise PNGError(f"{path}: no IDAT chunk")
    channels = _CHANNELS[colour]
    bpp = channels * depth // 8
    try:
        stream = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise PNGError(f"{path}: {e}") from None
    try:
        rows = (unfilter_plain if plain else unfilter)(
            stream, height, width * bpp, bpp)
    except PNGError as e:
        raise PNGError(f"{path}: {e}") from None
    if depth == 16:
        img = rows.view(">u2").astype(np.uint16)
    else:
        img = rows
    img = img.reshape(height, width, channels)
    return img[:, :, 0] if channels == 1 else img


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def write_png(path: str, img: np.ndarray) -> None:
    """Writes a grey ``uint8`` or ``uint16`` [H, W] image as a PNG (colour
    type 0, bit depth 8 or 16, every row filter None, one zlib stream at
    zlib's level 6 cut into IDAT chunks of 64 KiB, each chunk's CRC by
    ``zlib.crc32``): the
    file ``cv2.imwrite`` would hold for these samples, which
    :func:`read_png` and ``cv2.imread(path, -1)`` read back bit for bit.
    The file is written to a temporary name and renamed into place."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"write_png takes a grey uint8 or uint16 [H, W] "
                        f"image, got {img.dtype} {img.shape}")
    H, W = img.shape
    depth = 8 * img.dtype.itemsize
    rows = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img
                                ).view(np.uint8).reshape(H, -1)
    raw = np.concatenate([np.zeros((H, 1), np.uint8), rows], axis=1)
    stream = zlib.compress(raw.tobytes(), 6)
    parts = [SIGNATURE, _png_chunk(b"IHDR", struct.pack(
        ">IIBBBBB", W, H, depth, 0, 0, 0, 0))]
    parts += [_png_chunk(b"IDAT", stream[i:i + (1 << 16)])
              for i in range(0, len(stream), 1 << 16)]
    parts.append(_png_chunk(b"IEND", b""))
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(b"".join(parts))
    os.replace(tmp, path)


def read_image(path: str) -> np.ndarray:
    """``np.array(PIL.Image.open(path))`` of a PNG or a JPEG file."""
    with open(path, "rb") as f:
        head = f.read(len(SIGNATURE))
    if head[:2] == JPEG_SIGNATURE:
        return read_jpeg(path)
    if head != SIGNATURE:
        raise ValueError(f"{path}: neither a PNG nor a JPEG file "
                         f"(signature {head!r})")
    img = read_png(path)
    if img.ndim == 3 and img.dtype == np.uint16:
        return (img >> 8).astype(np.uint8)
    return img


def imread_unchanged(path: str) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_UNCHANGED)``: colour in BGR(A)
    order."""
    img = read_png(path)
    if img.ndim == 3:
        order = [2, 1, 0] + ([3] if img.shape[2] == 4 else [])
        img = np.ascontiguousarray(img[:, :, order])
    return img


# ------------------------------------------------------------------- JPEG

# zigzag position -> natural (row-major) index within an 8x8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int64)
_JPEG_REFUSED = {
    0xC2: "progressive (SOF2)", 0xC3: "lossless (SOF3)",
    0xC5: "differential sequential (SOF5)",
    0xC6: "differential progressive (SOF6)",
    0xC7: "differential lossless (SOF7)",
    0xC9: "arithmetic coding (SOF9)",
    0xCA: "progressive arithmetic coding (SOF10)",
    0xCB: "lossless arithmetic coding (SOF11)",
    0xCC: "arithmetic coding (DAC)",
    0xCD: "differential arithmetic coding (SOF13)",
    0xCE: "differential arithmetic coding (SOF14)",
    0xCF: "differential arithmetic coding (SOF15)",
    0xDC: "a DNL marker (the height defined after the scan)",
}


class JPEGHeader:
    """What the markers of one file say: the frame's size and components,
    the tables, the restart interval, the scan's entropy-coded bytes and
    the layout of the coefficient planes (``comp``: one row a component,
    h, v, quantisation table, DC table, AC table, width and height in
    blocks, first block)."""

    def __init__(self, path: str):
        self.path = path
        self.quant = np.zeros((4, 64), np.uint16)
        self.dc_bits = np.zeros((4, 17), np.uint8)
        self.dc_vals = np.zeros((4, 256), np.uint8)
        self.ac_bits = np.zeros((4, 17), np.uint8)
        self.ac_vals = np.zeros((4, 256), np.uint8)
        self.defined = set()          # ("q" | "dc" | "ac", table)
        self.restart_interval = 0
        self.jfif = False
        self.adobe_transform = None
        self.frame = None             # (height, width, [(id, h, v, tq)])
        self.scan = None
        self.comp = None
        self.mcus = None              # (across, down) of the scan
        self.blocks = 0               # blocks of all the planes

    def fail(self, reason: str):
        raise JPEGError(f"{self.path}: {reason}")

    @property
    def height(self) -> int:
        return self.frame[0]

    @property
    def width(self) -> int:
        return self.frame[1]

    @property
    def channels(self) -> int:
        return len(self.frame[2])


def _scan_end(blob: bytes, start: int) -> int:
    """The offset of the marker that ends the entropy-coded segment at
    ``start``: the first FF followed by a byte that is not 00 (stuffing),
    FF (fill) or D0-D7 (RSTn)."""
    arr = np.frombuffer(blob, np.uint8)
    ff = np.flatnonzero(arr[start:-1] == 0xFF) + start
    nxt = arr[ff + 1]
    ends = ff[(nxt != 0x00) & (nxt != 0xFF) & ((nxt < 0xD0) | (nxt > 0xD7))]
    return int(ends[0]) if len(ends) else len(blob)


def _dqt(h: JPEGHeader, data: bytes) -> None:
    pos = 0
    while pos < len(data):
        pq, tq = data[pos] >> 4, data[pos] & 15
        n = 128 if pq else 64
        if pq > 1 or tq > 3 or pos + 1 + n > len(data):
            h.fail(f"a bad DQT segment (precision {pq}, table {tq})")
        vals = np.frombuffer(data[pos + 1:pos + 1 + n],
                             ">u2" if pq else np.uint8)
        h.quant[tq, ZIGZAG] = vals
        h.defined.add(("q", tq))
        pos += 1 + n


def _dht(h: JPEGHeader, data: bytes) -> None:
    pos = 0
    while pos < len(data):
        tc, th = data[pos] >> 4, data[pos] & 15
        if tc > 1 or th > 3 or pos + 17 > len(data):
            h.fail(f"a bad DHT segment (class {tc}, table {th})")
        counts = np.frombuffer(data[pos + 1:pos + 17], np.uint8)
        n = int(counts.sum(dtype=np.int64))
        vals = np.frombuffer(data[pos + 17:pos + 17 + n], np.uint8)
        if n > 256 or len(vals) != n:
            h.fail(f"a bad Huffman table ({n} symbols)")
        if tc == 0 and len(vals) and vals.max() > 15:
            h.fail("a bad Huffman table (a DC symbol above 15)")
        bits, table = ((h.dc_bits, h.dc_vals) if tc == 0
                       else (h.ac_bits, h.ac_vals))
        bits[th, 0] = 0
        bits[th, 1:] = counts
        table[th] = 0
        table[th, :n] = vals
        h.defined.add(("dc" if tc == 0 else "ac", th))
        pos += 17 + n


def _sof(h: JPEGHeader, marker: int, data: bytes) -> None:
    if h.frame is not None:
        h.fail("a second frame header")
    if len(data) < 6:
        h.fail("a truncated frame header")
    precision, height, width, nf = struct.unpack(">BHHB", data[:6])
    if precision != 8:
        h.fail(f"{precision}-bit samples (8-bit only)")
    if height == 0:
        h.fail(_JPEG_REFUSED[0xDC])
    if width == 0:
        h.fail("a frame of width 0")
    if nf == 4:
        h.fail("CMYK or YCCK colour (4 components)")
    if nf not in (1, 3) or len(data) < 6 + 3 * nf:
        h.fail(f"{nf} components (1 or 3 only)")
    comps = []
    for i in range(nf):
        cid, hv, tq = data[6 + 3 * i:9 + 3 * i]
        hs, vs = hv >> 4, hv & 15
        if not (1 <= hs <= 4 and 1 <= vs <= 4) or tq > 3:
            h.fail(f"component {cid}: sampling {hs}x{vs}, table {tq}")
        comps.append((cid, hs, vs, tq))
    h.frame = (height, width, comps)


def _sos(h: JPEGHeader, data: bytes) -> None:
    if h.frame is None:
        h.fail("a scan before the frame header")
    ns = data[0] if data else 0
    if len(data) < 4 + 2 * ns:
        h.fail("a truncated scan header")
    comps = h.frame[2]
    if ns != len(comps):
        h.fail(f"several scans (this one holds {ns} of the {len(comps)} "
               "components)")
    sel = [(data[1 + 2 * i], data[2 + 2 * i] >> 4, data[2 + 2 * i] & 15)
           for i in range(ns)]
    if [s[0] for s in sel] != [c[0] for c in comps]:
        h.fail("the scan's components are not in the frame's order")
    ss, se, ahl = data[1 + 2 * ns:4 + 2 * ns]
    if (ss, se, ahl) != (0, 63, 0):
        h.fail(f"spectral selection {ss}-{se}, approximation {ahl} "
               "(progressive)")
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    H, W = h.frame[:2]
    rows, offset = [], 0
    for (cid, hs, vs, tq), (_, td, ta) in zip(comps, sel):
        for kind, t in (("q", tq), ("dc", td), ("ac", ta)):
            if t > 3 or (kind, t) not in h.defined:
                h.fail(f"component {cid}: {kind} table {t} is not defined")
        if hmax % hs or vmax % vs or hmax // hs > 2 or vmax // vs > 2:
            h.fail(f"component {cid}: sampling {hs}x{vs} of {hmax}x{vmax} "
                   "(ratios of 1 or 2 only)")
        if len(comps) == 1:
            bw, bh = -(-W // 8), -(-H // 8)
        else:
            bw = -(-W // (8 * hmax)) * hs
            bh = -(-H // (8 * vmax)) * vs
        rows.append((hs, vs, tq, td, ta, bw, bh, offset))
        offset += bw * bh
    h.comp = np.array(rows, np.int64)
    if len(comps) == 1:
        h.mcus = (int(rows[0][5]), int(rows[0][6]))
    else:
        h.mcus = (-(-W // (8 * hmax)), -(-H // (8 * vmax)))
    h.blocks = offset


def parse_jpeg(path: str) -> JPEGHeader:
    """The markers of ``path``, checked; raises :class:`JPEGError` on what
    the reader does not decode."""
    with open(path, "rb") as f:
        blob = f.read()
    h = JPEGHeader(path)
    if blob[:2] != JPEG_SIGNATURE:
        h.fail("not a JPEG file (no SOI marker)")
    pos = 2
    while True:
        if pos >= len(blob):
            h.fail("truncated before EOI")
        if blob[pos] != 0xFF:
            h.fail(f"no marker at byte {pos}")
        while pos < len(blob) and blob[pos] == 0xFF:
            pos += 1
        if pos >= len(blob):
            h.fail("truncated before EOI")
        marker = blob[pos]
        pos += 1
        if marker == 0xD9:                        # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue                              # no length
        if pos + 2 > len(blob):
            h.fail("truncated marker segment")
        (length,) = struct.unpack(">H", blob[pos:pos + 2])
        data = blob[pos + 2:pos + length]
        if length < 2 or len(data) != length - 2:
            h.fail(f"truncated segment of marker {marker:#04x}")
        pos += length
        if marker in _JPEG_REFUSED:
            h.fail(_JPEG_REFUSED[marker] + " is not read")
        if marker in (0xC0, 0xC1):
            _sof(h, marker, data)
        elif marker == 0xC4:
            _dht(h, data)
        elif marker == 0xDB:
            _dqt(h, data)
        elif marker == 0xDD:
            if len(data) != 2:
                h.fail("a bad DRI segment")
            (h.restart_interval,) = struct.unpack(">H", data)
        elif marker == 0xE0 and data[:5] == b"JFIF\x00":
            h.jfif = True
        elif marker == 0xEE and data[:5] == b"Adobe" and len(data) >= 12:
            h.adobe_transform = data[11]
        elif marker == 0xDA:
            if h.scan is not None:
                h.fail("several scans (a second SOS marker)")
            _sos(h, data)
            end = _scan_end(blob, pos)
            h.scan = blob[pos:end]
            pos = end
        elif 0xC0 <= marker <= 0xCF:
            h.fail(f"frame type {marker:#04x} is not read")
    if h.frame is None or h.scan is None:
        h.fail("no frame or no scan before EOI")
    if h.channels == 3 and not h.jfif:
        # libjpeg's colour guess: JFIF means YCbCr, then the Adobe marker's
        # transform, then the component ids
        ids = tuple(c[0] for c in h.frame[2])
        if h.adobe_transform == 0 or (h.adobe_transform is None
                                      and ids == (82, 71, 66)):
            h.fail("RGB colour (Adobe transform 0) is not read")
    return h


def _tables(h: JPEGHeader):
    return (h.dc_bits.ctypes.data, h.dc_vals.ctypes.data,
            h.ac_bits.ctypes.data, h.ac_vals.ctypes.data)


def _jpeg_check(h: JPEGHeader, rc: int) -> None:
    if rc != 0:
        msg = _library(JPEG_SOURCE).jpeg_error(rc).decode()
        h.fail(msg)


def jpeg_coefficients(path: str):
    """(header, coefficients): every block's quantised coefficients,
    [blocks, 64] ``int16`` in natural order, decoded by the C code."""
    h = parse_jpeg(path)
    coefs = np.empty((h.blocks, 64), np.int16)
    rc = _library(JPEG_SOURCE).jpeg_coefficients(
        h.scan, len(h.scan), h.channels, h.comp.ctypes.data, *h.mcus,
        h.restart_interval, *_tables(h), coefs.ctypes.data)
    _jpeg_check(h, rc)
    return h, coefs


# the islow IDCT's constants (IJG jidctint.c: FIX(x) at CONST_BITS 13)
_CONST_BITS, _PASS1_BITS = 13, 2
_F = dict(f0_298631336=2446, f0_390180644=3196, f0_541196100=4433,
          f0_765366865=6270, f0_899976223=7373, f1_175875602=9633,
          f1_501321110=12299, f1_847759065=15137, f1_961570560=16069,
          f2_053119869=16819, f2_562915447=20995, f3_072711026=25172)


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _idct_1d(v, shift):
    """One 8-point pass of jidctint.c along the last axis of ``v`` (int64,
    the 8 inputs of each line); the 8 outputs, descaled by ``shift``."""
    f = _F
    z2, z3 = v[..., 2], v[..., 6]
    z1 = (z2 + z3) * f["f0_541196100"]
    t2 = z1 - z3 * f["f1_847759065"]
    t3 = z1 + z2 * f["f0_765366865"]
    z2, z3 = v[..., 0], v[..., 4]
    t0 = (z2 + z3) << _CONST_BITS
    t1 = (z2 - z3) << _CONST_BITS
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    t0, t1, t2, t3 = v[..., 7], v[..., 5], v[..., 3], v[..., 1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * f["f1_175875602"]
    t0 = t0 * f["f0_298631336"]
    t1 = t1 * f["f2_053119869"]
    t2 = t2 * f["f3_072711026"]
    t3 = t3 * f["f1_501321110"]
    z1 = z1 * -f["f0_899976223"]
    z2 = z2 * -f["f2_562915447"]
    z3 = z3 * -f["f1_961570560"] + z5
    z4 = z4 * -f["f0_390180644"] + z5
    t0, t1 = t0 + z1 + z3, t1 + z2 + z4
    t2, t3 = t2 + z2 + z3, t3 + z1 + z4
    out = np.stack([t10 + t3, t11 + t2, t12 + t1, t13 + t0,
                    t13 - t0, t12 - t1, t11 - t2, t10 - t3], axis=-1)
    return _descale(out, shift)


def _idct_limit() -> np.ndarray:
    """libjpeg's post-IDCT range limit, indexed by (value & 1023)."""
    v = np.arange(1024)
    v = np.where(v < 512, v, v - 1024)
    return np.clip(v + 128, 0, 255).astype(np.uint8)


def _upsample_plain(plane, dw, dh, rh, rv, width, height):
    """libjpeg-turbo's fancy upsampling of a component's real dh x dw
    samples by (rh, rv), edges replicated, cropped to height x width."""
    x = plane[:dh, :dw].astype(np.int64)
    if rv == 2:
        up = np.concatenate([x[:1], x[:-1]])          # the row above
        down = np.concatenate([x[1:], x[-1:]])        # the row below
        if rh == 1:
            rows = np.stack([(3 * x + up + 1) >> 2,
                             (3 * x + down + 2) >> 2], 1)
            return rows.reshape(2 * dh, dw)[:height, :width]
        if dw <= 2:
            return np.repeat(np.repeat(x, 2, 0), 2, 1)[:height, :width]
        sums = np.stack([3 * x + up, 3 * x + down], 1).reshape(2 * dh, dw)
        left = np.concatenate([sums[:, :1], sums[:, :-1]], 1)
        right = np.concatenate([sums[:, 1:], sums[:, -1:]], 1)
        cols = np.stack([(3 * sums + left + 8) >> 4,
                         (3 * sums + right + 7) >> 4], 2)
        return cols.reshape(2 * dh, 2 * dw)[:height, :width]
    if rh == 1:
        return x[:height, :width]
    if dw <= 2:
        return np.repeat(x, 2, 1)[:height, :width]
    left = np.concatenate([x[:, :1], x[:, :-1]], 1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], 1)
    cols = np.stack([(3 * x + left + 1) >> 2, (3 * x + right + 2) >> 2], 2)
    return cols.reshape(dh, 2 * dw)[:height, :width]


def decode_plain(h: JPEGHeader, coefs: np.ndarray) -> np.ndarray:
    """What the C decoder makes of ``coefs`` (the quantised coefficients
    of :func:`jpeg_coefficients`), in numpy, vectorised over blocks: the
    dequantisation, the islow IDCT, the fancy upsampling and the YCbCr ->
    RGB tables, each as libjpeg-turbo computes it."""
    H, W = h.height, h.width
    comps = h.frame[2]
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    limit = _idct_limit()
    full = []
    for (hs, vs, tq, _, _, bw, bh, off) in h.comp.tolist():
        if len(comps) == 1:
            hs = vs = hmax = vmax = 1
        blocks = coefs[off:off + bw * bh].astype(np.int64)
        q = h.quant[tq].astype(np.int64)
        x = (blocks * q).reshape(-1, 8, 8)              # [n, row, col]
        # pass 1 down the columns, pass 2 along the rows
        ws = _idct_1d(np.swapaxes(x, 1, 2), _CONST_BITS - _PASS1_BITS)
        out = _idct_1d(np.swapaxes(ws, 1, 2),
                       _CONST_BITS + _PASS1_BITS + 3)
        pixels = limit[out & 1023]                      # [n, row, col]
        plane = pixels.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(
            bh * 8, bw * 8)
        dw, dh = -(-W * hs // hmax), -(-H * vs // vmax)
        full.append(_upsample_plain(plane, dw, dh, hmax // hs, vmax // vs,
                                    W, H))
    if len(full) == 1:
        return full[0].astype(np.uint8)
    y, cb, cr = full
    one_half, scale = 1 << 15, 16
    fix = lambda v: int(v * 65536 + 0.5)                # noqa: E731
    t = np.arange(256, dtype=np.int64) - 128
    cr_r = (fix(1.40200) * t + one_half) >> scale
    cb_b = (fix(1.77200) * t + one_half) >> scale
    cr_g = -fix(0.71414) * t
    cb_g = -fix(0.34414) * t + one_half
    rgb = np.stack([y + cr_r[cr], y + ((cb_g[cb] + cr_g[cr]) >> scale),
                    y + cb_b[cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def read_jpeg(path: str, plain: bool = False) -> np.ndarray:
    """``np.array(PIL.Image.open(path))`` of a JPEG file: [H, W, 3] RGB or
    [H, W] grey ``uint8``. ``plain`` takes the C decoder's coefficients
    through :func:`decode_plain` instead of the C code's own IDCT,
    upsampling and colour conversion."""
    if plain:
        return decode_plain(*jpeg_coefficients(path))
    h = parse_jpeg(path)
    coefs = np.empty((h.blocks, 64), np.int16)
    shape = (h.height, h.width) + ((3,) if h.channels == 3 else ())
    out = np.empty(shape, np.uint8)
    rc = _library(JPEG_SOURCE).jpeg_decode(
        h.scan, len(h.scan), h.channels, h.comp.ctypes.data, *h.mcus,
        h.restart_interval, *_tables(h), h.quant.ctypes.data, h.width,
        h.height, coefs.ctypes.data, out.ctypes.data)
    _jpeg_check(h, rc)
    return out
