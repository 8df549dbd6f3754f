"""The port's PNG reader (host code, no ``cv2`` or ``PIL``): it stands in for
the ``cv2.imread`` and ``PIL.Image.open`` calls of the JAX package's
``fsnet_tpu.data.datasets.io_utils``.

A file is read in three steps:

1. the chunks are parsed in Python: the signature, IHDR, the run of IDAT
   chunks and IEND, each chunk's CRC checked with ``zlib.crc32``;
2. the IDAT stream is inflated by the standard library's ``zlib``;
3. the scanline filters (None, Sub, Up, Average, Paeth) are reversed in C
   (``csrc/host/png_unfilter.c``). Average and Paeth read the reconstructed
   pixel to the left and the one above, so the scan is serial; a loop in
   numpy would take seconds for a KITTI frame.

The C code is compiled at first use with ``cc -O2 -shared -fPIC`` into the
git-ignored ``build/host/`` at the root of the checkout, under a file name
that carries a hash of the source and the flags, written to a temporary
name and renamed into place so that parallel processes may build at once;
it is loaded with ``ctypes``. Without ``cc`` the reader raises: there is no
other route. :func:`unfilter_plain` is the same function in numpy and
Python, for the tests and ``chip_smoke.py`` to hold the C code against.

Files read: bit depth 8 or 16 (16-bit samples are big-endian in the file),
colour type 0 (grey), 2 (RGB) or 6 (RGBA), not interlaced. Palette,
grey+alpha, Adam7-interlaced files and bit depths below 8 raise, naming the
file and the reason; no dataset of the repo holds one.

What each reader returns matches the call it replaces exactly:

* :func:`read_image` is ``np.array(PIL.Image.open(path))``: HxWx3 ``uint8``
  in RGB order (HxWx4 for RGBA, HxW for grey); a 16-bit colour file is
  reduced to its high bytes as PIL reduces it, a 16-bit grey file stays
  ``uint16``;
* :func:`imread_unchanged` is ``cv2.imread(path, cv2.IMREAD_UNCHANGED)``:
  grey HxW, colour in BGR (BGRA) order, ``uint8`` or ``uint16``;
* :func:`png_size` reads only the header: (H, W).
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
SOURCE = (Path(__file__).resolve().parents[2] / "csrc" / "host"
          / "png_unfilter.c")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "host"
CC_FLAGS = ("-O2", "-shared", "-fPIC")
# colour type -> samples per pixel
_CHANNELS = {0: 1, 2: 3, 6: 4}
_REFUSED = {3: "palette colour (type 3)", 4: "grey with alpha (type 4)"}

_lock = threading.Lock()
_lib = None


class PNGError(ValueError):
    """A file the reader cannot or will not decode."""


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CC_FLAGS).encode())
    return BUILD_DIR / f"libpng_unfilter_{digest.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    cc = os.environ.get("CC") or shutil.which("cc")
    if cc is None:
        raise RuntimeError("the PNG reader's unfilter is C code built at "
                           "first use, and no C compiler (cc) was found")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cc, *CC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"cc failed on {SOURCE}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)     # atomic: a reader never sees half a library


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            lib.png_unfilter.argtypes = (ctypes.c_char_p, ctypes.c_void_p,
                                         ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_int64)
            lib.png_unfilter.restype = ctypes.c_int64
            _lib = lib
        return _lib


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


def read_image(path: str) -> np.ndarray:
    """``np.array(PIL.Image.open(path))``."""
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
