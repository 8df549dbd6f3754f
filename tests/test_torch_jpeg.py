"""The port's JPEG reader against PIL (libjpeg-turbo), on the CPU:

* the C decoder bitwise equal to ``np.array(PIL.Image.open(path))`` on
  files PIL writes (4:4:4, 4:2:2, 4:2:0 and grey; quality 50, 90 and 100;
  ``optimize=True`` Huffman tables; ``restart_marker_blocks``; sizes that
  are no multiple of the MCU, down to 1x1; a saturated texture at quality
  100, where the IDCT's range limit decides) and on the files
  ``tests/disk_trees.write_jpeg`` writes (the same subsamplings and 4:4:0,
  restart intervals of 1 and 3 MCUs);
* on every one of those files, the C decoder bitwise equal to
  ``decode_plain`` on its own quantised coefficients;
* ``read_image`` choosing the reader by the file's signature;
* each refused kind (progressive, arithmetic coding, lossless, 12-bit,
  CMYK, Adobe RGB, several scans) raising ``JPEGError`` with the file's
  name and the reason; no C compiler: a raise, no other route.
"""
import struct
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import disk_trees as dt
from fsnet_tpu_torch.data.datasets import image_io as tio

SIZES = [(37, 53), (64, 80), (17, 9), (1, 1)]
PIL_SUBSAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}


def _images(H, W, seed):
    """A noisy texture, and a saturated checkerboard of 0 and 255 whose
    edges overshoot the sample range after the IDCT."""
    rng = np.random.RandomState(seed)
    tex = (dt.texture(H, W, 0.0, seed) if min(H, W) > 1
           else rng.randint(0, 256, (H, W, 3), np.uint8))
    y, x = np.mgrid[0:H, 0:W]
    board = ((y // 3 + x // 2) % 2 * 255).astype(np.uint8)
    sat = np.stack([board, 255 - board, board], -1)
    return {"texture": tex, "saturated": sat}


def _same_three_ways(path):
    """The C decode equal to PIL's and to ``decode_plain`` on the C
    decoder's coefficients, bit for bit."""
    ref = np.array(Image.open(path))
    got = tio.read_jpeg(str(path))
    assert got.dtype == np.uint8 and got.shape == ref.shape, (got.shape,
                                                              ref.shape)
    np.testing.assert_array_equal(got, ref, err_msg=str(path))
    np.testing.assert_array_equal(tio.read_jpeg(str(path), plain=True), got,
                                  err_msg=str(path))


@pytest.mark.parametrize("quality", [50, 90, 100])
@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:2", "4:2:0", "grey"])
def test_decoder_matches_pil(tmp_path, subsampling, quality):
    extras = {"plain": {}, "optimize": {"optimize": True},
              "restart": {"restart_marker_blocks": 3}}
    for H, W in SIZES:
        for name, img in _images(H, W, H * W + quality).items():
            if subsampling == "grey":
                img = img[..., 1].copy()
            for tag, extra in extras.items():
                path = tmp_path / f"{name}_{H}x{W}_{tag}.jpg"
                kw = ({} if subsampling == "grey"
                      else {"subsampling": PIL_SUBSAMPLING[subsampling]})
                Image.fromarray(img).save(path, quality=quality, **kw,
                                          **extra)
                _same_three_ways(path)


@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:2", "4:2:0", "4:4:0",
                                         "grey"])
def test_writer_files_match_pil(tmp_path, subsampling):
    for (H, W), quality, restart in (((37, 53), 90, 0), ((64, 80), 100, 1),
                                     ((17, 9), 50, 3), ((96, 160), 75, 0)):
        img = dt.texture(H, W, 2.0, H + W)
        if subsampling == "grey":
            img = img[..., 0].copy()
        path = tmp_path / f"w_{H}x{W}.jpg"
        dt.write_jpeg(path, img, quality,
                      "4:2:0" if subsampling == "grey" else subsampling,
                      restart)
        pil = Image.open(path)
        assert pil.format == "JPEG" and not pil.info.get("progressive")
        _same_three_ways(path)
        header = tio.parse_jpeg(str(path))
        assert header.restart_interval == restart
        if subsampling != "grey":
            assert tuple(header.comp[0, :2]) == dt.JPEG_SAMPLING[subsampling]


def test_read_image_dispatch(tmp_path):
    rgb = dt.texture(24, 40, 0.0, 1)
    jpg, png, other = (tmp_path / "a.jpg", tmp_path / "a.png",
                       tmp_path / "a.bin")
    dt.write_jpeg(jpg, rgb, 90)
    dt.write_png(png, rgb)
    other.write_bytes(b"GIF89a" + bytes(32))
    np.testing.assert_array_equal(tio.read_image(str(jpg)),
                                  np.array(Image.open(jpg)))
    np.testing.assert_array_equal(tio.read_image(str(png)), rgb)
    with pytest.raises(ValueError, match="neither a PNG nor a JPEG"):
        tio.read_image(str(other))


def _segments(blob: bytes):
    """(offset, marker, length) of each marker segment before the scan."""
    pos, out = 2, []
    while True:
        marker = blob[pos + 1]
        (length,) = struct.unpack(">H", blob[pos + 2:pos + 4])
        out.append((pos, marker, length))
        if marker == 0xDA:
            return out
        pos += 2 + length


def _patched(src: Path, dst: Path, marker: int, edit) -> Path:
    """``src`` with ``edit(segment bytes)`` in place of its first segment
    of ``marker``."""
    blob = src.read_bytes()
    pos, _, length = next(s for s in _segments(blob) if s[1] == marker)
    seg = edit(blob[pos:pos + 2 + length])
    dst.write_bytes(blob[:pos] + seg + blob[pos + 2 + length:])
    return dst


def test_refused_kinds_raise(tmp_path):
    rgb = dt.texture(24, 40, 0.0, 2)
    base = tmp_path / "base.jpg"
    dt.write_jpeg(base, rgb, 90)

    def sof(kind):
        return lambda seg: seg[:1] + bytes([kind]) + seg[2:]

    def adobe_rgb(seg):
        # the JFIF marker (which would mean YCbCr) replaced by an Adobe
        # marker with transform 0
        app14 = b"Adobe\x00\x64\x00\x00\x00\x00\x00"
        return b"\xff\xee" + struct.pack(">H", len(app14) + 2) + app14

    def one_of_three(seg):
        # a scan of the first component only
        return (b"\xff\xda" + struct.pack(">H", 8) + b"\x01" + seg[5:7]
                + b"\x00\x3f\x00")

    cases = {
        "progressive (SOF2)": lambda p: Image.fromarray(rgb).save(
            p, quality=90, progressive=True),
        "arithmetic coding (SOF9)": lambda p: _patched(base, p, 0xC0,
                                                       sof(0xC9)),
        "lossless (SOF3)": lambda p: _patched(base, p, 0xC0, sof(0xC3)),
        "12-bit samples": lambda p: _patched(
            base, p, 0xC0, lambda s: s[:4] + b"\x0c" + s[5:]),
        "CMYK": lambda p: Image.fromarray(rgb).convert("CMYK").save(
            p, quality=90),
        "RGB colour (Adobe transform 0)": lambda p: _patched(
            base, p, 0xE0, adobe_rgb),
        "several scans": lambda p: _patched(base, p, 0xDA, one_of_three),
    }
    for reason, write in cases.items():
        path = tmp_path / f"{reason.split()[0]}.jpg"
        write(path)
        with pytest.raises(tio.JPEGError) as err:
            tio.read_jpeg(str(path))
        assert str(path) in str(err.value) and reason in str(err.value), (
            reason, err.value)
        with pytest.raises(tio.JPEGError):
            tio.read_image(str(path))


def test_no_compiler_raises(tmp_path, monkeypatch):
    """The decoder is C built at first use: without ``cc`` it raises."""
    monkeypatch.setattr(tio, "BUILD_DIR", tmp_path / "host")
    monkeypatch.setattr(tio, "_libs", {})
    monkeypatch.delenv("CC", raising=False)
    monkeypatch.setattr(tio.shutil, "which", lambda name: None)
    path = tmp_path / "a.jpg"
    dt.write_jpeg(path, dt.texture(16, 16, 0.0, 3), 90)
    with pytest.raises(RuntimeError, match="no C compiler"):
        tio.read_jpeg(str(path))


def test_chip_smoke_digests(tmp_path):
    """The files ``chip_smoke.py`` phase 44 writes on the card machine (no
    PIL there) are the ones whose digests it holds: the file's and PIL's
    decode's sha256, recorded where PIL is; the C decode gives the
    latter."""
    import hashlib

    import chip_smoke

    paths = chip_smoke.write_jpeg_files(dt, tmp_path)
    assert sorted(paths) == sorted(chip_smoke.JPEG_DIGESTS)
    for name, path in paths.items():
        file_sha, pil_sha = chip_smoke.JPEG_DIGESTS[name]
        assert hashlib.sha256(path.read_bytes()).hexdigest() == file_sha
        for img in (np.array(Image.open(path)), tio.read_jpeg(str(path))):
            assert hashlib.sha256(np.ascontiguousarray(img).tobytes()
                                  ).hexdigest() == pil_sha, name
