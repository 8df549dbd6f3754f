"""Host-side data augmentation in numpy (counterpart of
``fsnet_tpu.data.augmentations``, every class).

Each transform takes and returns the flat sample dict, is keyed by
``image_keys`` / ``gt_image_keys`` / ``calib_keys`` / ``lidar_keys``, and
geometric ops rewrite the camera matrix P with the pixels. Images stay HWC
numpy arrays; they reach the device at the loader's prefetch.

The JAX package calls OpenCV in three places; this module computes the
same functions in numpy, on float images (every config converts to float
first), in plain float32 arithmetic:

* :class:`Resize`: ``cv2.resize`` with ``INTER_LINEAR`` takes half-pixel
  centres clamped to the edge and blends as ``a + t (b - a)``, rows first;
  ``INTER_NEAREST`` takes source index ``floor(x / (dw / sw))`` (no
  half-pixel shift), clamped.
* :class:`RandomWarpAffine`: ``cv2.warpAffine`` inverts M, maps each output
  pixel to ``x M0 + (y M1 + M2)`` in float32, the last sum rounded once as
  OpenCV's fused multiply-add rounds it, and blends as ``Resize`` does,
  with the taps outside the image at 0 (``BORDER_CONSTANT``).
  ``INTER_NEAREST`` (the masks) goes through OpenCV's fixed-point map:
  coordinates in units of 1/1024 (``AB_BITS = 10``), rounded to the
  nearest pixel, so that the same pixels are picked.
* :class:`ConvertColor`: OpenCV's float RGB<->HSV formulas (H in degrees,
  S in [0, 1] of V, V the channel maximum).

The bilinear and HSV results agree with OpenCV's to float32 rounding (well
inside 1e-3 on the 0-255 scale), not bit for bit.

Randomness: the classes that the JAX package seeds with
``np.random.default_rng(random_seed)`` (``None``: a seed drawn from numpy's
global state when the object is built) do the same here, so from the same
seed they draw the same parameters in the same order. ``RandomCropToWidth``,
``RandomMirror`` and ``PhotometricDistort``, which draw from numpy's global
state at each call there, own an ``np.random.RandomState(random_seed)``
here (seeded the same way): from seed ``s`` it draws what
``np.random.seed(s)`` would have given the JAX class. Loader workers reseed
every generator they hold (:mod:`fsnet_tpu_torch.data.dataloader`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .pose_utils import flip_relative_pose

# cv2.BORDER_CONSTANT, the one border mode of RandomWarpAffine here
BORDER_CONSTANT = 0
# cv2.warpAffine's fixed-point map (imgwarp.cpp): AB_BITS fractional bits
_AB_BITS = 10
_AB_SCALE = 1 << _AB_BITS


def _seed(random_seed: Optional[int]) -> int:
    return (random_seed if random_seed is not None
            else np.random.randint(0, 2 ** 32))


def _lerp(a: np.ndarray, b: np.ndarray, t: np.ndarray) -> np.ndarray:
    """The linear blend ``a + t (b - a)`` in float32."""
    return a + t * (b - a)


def _float_image(img: np.ndarray, what: str) -> np.ndarray:
    if img.dtype != np.float32:
        raise TypeError(f"{what} takes float32 images (ConvertToFloat "
                        f"first), got {img.dtype}")
    return img


def _linear_taps(src: int, dst: int):
    """cv2.resize INTER_LINEAR's source index pair and float32 fraction of
    each output index along one axis."""
    d = np.arange(dst, dtype=np.float64)
    f = (d + 0.5) * (src / dst) - 0.5
    i0 = np.floor(f).astype(np.int64)
    frac = (f - i0).astype(np.float32)
    low = i0 < 0
    frac[low], i0[low] = 0.0, 0
    high = i0 >= src - 1
    frac[high], i0[high] = 0.0, src - 1
    return i0, np.minimum(i0 + 1, src - 1), frac


def resize_linear(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """``cv2.resize(img, (w, h))`` (``INTER_LINEAR``) of a float32 [H, W] or
    [H, W, C] image."""
    img = _float_image(img, "resize_linear")
    H, W = img.shape[:2]
    x0, x1, fx = _linear_taps(W, w)
    y0, y1, fy = _linear_taps(H, h)
    extra = (1,) * (img.ndim - 2)
    rows = _lerp(img[:, x0], img[:, x1], fx.reshape(1, w, *extra))
    return _lerp(rows[y0], rows[y1], fy.reshape(h, 1, *extra))


def resize_nearest(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST)``: source
    index ``floor(x * (1 / (w / W)))``, clamped (resize.cpp ``resizeNN``)."""
    H, W = img.shape[:2]
    xs = np.minimum(np.floor(np.arange(w) * (1.0 / (w / W))).astype(np.int64),
                    W - 1)
    ys = np.minimum(np.floor(np.arange(h) * (1.0 / (h / H))).astype(np.int64),
                    H - 1)
    return img[ys][:, xs]


def _inverse_affine(M: np.ndarray) -> np.ndarray:
    """cv2.warpAffine's inverse of the 2x3 ``M``, as its 6 coefficients."""
    m = np.asarray(M, np.float64).reshape(6).copy()
    D = m[0] * m[4] - m[1] * m[3]
    D = 1.0 / D if D != 0 else 0.0
    a11, a22 = m[4] * D, m[0] * D
    m[0], m[1], m[3], m[4] = a11, -m[1] * D, -m[3] * D, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m


class _AffineMap:
    """The source taps of ``cv2.warpAffine`` at one output size, shared by
    every image of a sample (all the same size): for ``INTER_LINEAR`` the
    four corners' flat indices, which lie inside the image, and float32
    fractions; for ``INTER_NEAREST`` the rounded pixel and whether it lies
    inside."""

    def __init__(self, M: np.ndarray, shape, ow: int, oh: int):
        self.H, self.W = shape[:2]
        self.ow, self.oh = ow, oh
        self.m = _inverse_affine(M)
        self._linear = self._nearest = None

    def linear(self):
        if self._linear is None:
            m = self.m.astype(np.float32)
            x = np.arange(self.ow, dtype=np.float32)[None, :]
            y = np.arange(self.oh, dtype=np.float32)[:, None]
            # as OpenCV forms the map: the row's offset in float32, then
            # x M0 added with one rounding (exact in float64, then rounded).
            # A coordinate one float32 step off would move a sample on a
            # sharp edge by more than 1e-3 of 255. Once per sample, shared
            # by its images.
            sx = (x.astype(np.float64) * m[0] + (y * m[1] + m[2])).astype(
                np.float32)
            sy = (x.astype(np.float64) * m[3] + (y * m[4] + m[5])).astype(
                np.float32)
            ix, iy = np.floor(sx), np.floor(sy)
            ax = (sx - ix).reshape(-1, 1)
            ay = (sy - iy).reshape(-1, 1)
            ix, iy = ix.astype(np.int64).ravel(), iy.astype(np.int64).ravel()
            taps = []
            for dy in (0, 1):
                for dx in (0, 1):
                    xx, yy = ix + dx, iy + dy
                    inside = ((xx >= 0) & (xx < self.W) & (yy >= 0)
                              & (yy < self.H))
                    flat = (np.clip(yy, 0, self.H - 1) * self.W
                            + np.clip(xx, 0, self.W - 1))
                    taps.append((flat, ~inside))
            self._linear = taps, ax, ay
        return self._linear

    def nearest(self):
        if self._nearest is None:
            m = self.m
            x = np.arange(self.ow)
            y = np.arange(self.oh)
            adelta = np.rint(m[0] * x * _AB_SCALE).astype(np.int64)
            bdelta = np.rint(m[3] * x * _AB_SCALE).astype(np.int64)
            half = _AB_SCALE // 2
            X0 = np.rint((m[1] * y + m[2]) * _AB_SCALE).astype(np.int64) + half
            Y0 = np.rint((m[4] * y + m[5]) * _AB_SCALE).astype(np.int64) + half
            X = (X0[:, None] + adelta[None, :]) >> _AB_BITS
            Y = (Y0[:, None] + bdelta[None, :]) >> _AB_BITS
            inside = (X >= 0) & (X < self.W) & (Y >= 0) & (Y < self.H)
            flat = np.clip(Y, 0, self.H - 1) * self.W + np.clip(X, 0,
                                                               self.W - 1)
            self._nearest = flat.ravel(), ~inside.ravel()
        return self._nearest

    def warp_linear(self, *imgs: np.ndarray):
        """The bilinear warp of each image (float32, [H, W] or [H, W, C]),
        gathered as one stack of their channels."""
        for img in imgs:
            _float_image(img, "warpAffine INTER_LINEAR")
        taps, ax, ay = self.linear()
        widths = [int(np.prod(img.shape[2:], dtype=np.int64)) for img in imgs]
        src = np.concatenate([img.reshape(self.H * self.W, -1)
                              for img in imgs], axis=1)
        p = []
        for flat, outside in taps:
            v = src[flat]
            v[outside] = 0.0
            p.append(v)
        out = _lerp(_lerp(p[0], p[1], ax), _lerp(p[2], p[3], ax), ay)
        parts = np.split(out, np.cumsum(widths)[:-1], axis=1)
        return [part.reshape((self.oh, self.ow) + img.shape[2:])
                for part, img in zip(parts, imgs)]

    def warp_nearest(self, img: np.ndarray) -> np.ndarray:
        flat, outside = self.nearest()
        out = img.reshape((self.H * self.W,) + img.shape[2:])[flat]
        out[outside] = 0
        return out.reshape((self.oh, self.ow) + img.shape[2:])


_HSV_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1],
                         [0, 1, 3], [2, 1, 0]])
_FLT_EPSILON = np.float32(np.finfo(np.float32).eps)


def rgb_to_hsv(img: np.ndarray, blue: int = 2) -> np.ndarray:
    """OpenCV's float ``RGB2HSV`` (``blue`` = 2; ``BGR2HSV``: 0): H in
    degrees [0, 360), S = (V - min) / (|V| + eps), V the channel maximum."""
    img = _float_image(img, "ConvertColor")
    r, g, b = img[..., blue ^ 2], img[..., 1], img[..., blue]
    v = np.maximum(np.maximum(r, g), b)
    vmin = np.minimum(np.minimum(r, g), b)
    diff = v - vmin
    s = diff / (np.abs(v) + _FLT_EPSILON)
    scale = np.float32(60.0) / (diff + _FLT_EPSILON)
    h_r = (g - b) * scale
    h = np.where(v == r, np.where(h_r < 0, h_r + np.float32(360), h_r),
                 np.where(v == g, (b - r) * scale + np.float32(120),
                          (r - g) * scale + np.float32(240)))
    return np.stack([h, s, v], axis=-1).astype(np.float32)


def hsv_to_rgb(img: np.ndarray, blue: int = 2) -> np.ndarray:
    """OpenCV's float ``HSV2RGB`` (``blue`` = 2; ``HSV2BGR``: 0), H in
    degrees."""
    img = _float_image(img, "ConvertColor")
    h = img[..., 0] * np.float32(6.0 / 360.0)
    s, v = img[..., 1], img[..., 2]
    while True:
        low, high = h < 0, h >= 6
        if not (low.any() or high.any()):
            break
        h = np.where(low, h + np.float32(6), np.where(high, h - np.float32(6),
                                                     h))
    sector = np.floor(h)
    h = h - sector
    sector = sector.astype(np.int64)
    bad = (sector < 0) | (sector >= 6)
    sector = np.where(bad, 0, sector)
    h = np.where(bad, np.float32(0), h)
    one = np.float32(1)
    tab = np.stack([v, v * (one - s), v * (one - s * h),
                    v * (one - s * (one - h))], axis=-1)
    bgr = np.take_along_axis(tab, _HSV_SECTORS[sector], axis=-1)
    out = np.empty_like(img)
    out[..., blue] = bgr[..., 0]
    out[..., 1] = bgr[..., 1]
    out[..., blue ^ 2] = bgr[..., 2]
    return out


class EmptyAug:
    """No-op."""

    def __init__(self, *args, **kwargs):
        pass

    def __call__(self, data):
        return data


class ExtractData:
    """Trim the sample dict to ``extract_keys`` (+ renames via
    ``mapped_keys``)."""

    def __init__(self, extract_keys=(), mapped_keys=None, **kwargs):
        self.extract_keys = list(extract_keys)
        self.mapped_keys = dict(mapped_keys or {})

    def __call__(self, data):
        output = {key: data[key] for key in self.extract_keys}
        for key, new_key in self.mapped_keys.items():
            output[new_key] = data[key]
        return output


class ConvertToFloat:
    """Image dtype -> float32."""

    def __init__(self, image_keys=("image",), **kwargs):
        self.image_keys = list(image_keys)

    def __call__(self, data):
        for key in self.image_keys:
            data[key] = data[key].astype(np.float32)
        return data


class ConvertToTensor:
    """Finalise arrays for the device boundary: HWC float32 contiguous numpy
    (the port's layout is NHWC; the loader makes the tensors)."""

    def __init__(self, image_keys=("image",), gt_image_keys=(), calib_keys=(),
                 lidar_keys=(), **kwargs):
        self.image_keys = list(image_keys)
        self.gt_image_keys = list(gt_image_keys)
        self.calib_keys = list(calib_keys)
        self.lidar_keys = list(lidar_keys)

    def __call__(self, data):
        for key in (self.image_keys + self.gt_image_keys + self.calib_keys
                    + self.lidar_keys):
            data[key] = np.ascontiguousarray(data[key], dtype=np.float32)
        return data


class Normalize:
    """x/255 then per-channel (x - mean)/std; mean/std tile across
    multi-image channel stacks."""

    def __init__(self, mean, stds, image_keys=("image",), **kwargs):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.stds = np.asarray(stds, dtype=np.float32)
        self.image_keys = list(image_keys)

    def __call__(self, data):
        for key in self.image_keys:
            image = data[key].astype(np.float32) / 255.0
            reps = int(image.shape[2] / self.mean.shape[0])
            image = image - np.tile(self.mean, reps)
            image = image / np.tile(self.stds, reps)
            data[key] = image.astype(np.float32)
        return data


class Resize:
    """Resize with optional aspect preservation + pad/crop; rewrites P and
    records ``('image_resize', 'original_shape'/'effective_size')`` for the
    evaluators' unpadding. Images bilinear, ``gt_image_keys`` nearest, as
    ``cv2.resize`` does (:func:`resize_linear`, :func:`resize_nearest`)."""

    def __init__(self, size, preserve_aspect_ratio=True, force_pad=True,
                 image_keys=("image",), calib_keys=(), gt_image_keys=(),
                 **kwargs):
        self.size = size
        self.preserve_aspect_ratio = preserve_aspect_ratio
        self.force_pad = force_pad
        self.image_keys = list(image_keys)
        self.calib_keys = list(calib_keys)
        self.gt_image_keys = list(gt_image_keys)

    def __call__(self, data):
        image = data[self.image_keys[0]]
        data[("image_resize", "original_shape")] = np.asarray(
            image.shape[:2], dtype=np.int64)

        if self.preserve_aspect_ratio:
            sf_x = self.size[0] / image.shape[0]
            sf_y = self.size[1] / image.shape[1]
            if self.force_pad:
                scale = min(sf_x, sf_y)
                mode = "pad_0" if sf_x > sf_y else "pad_1"
            else:
                scale = sf_x
                mode = "crop_1" if sf_x > sf_y else "pad_1"
            h = int(np.round(image.shape[0] * scale))
            w = int(np.round(image.shape[1] * scale))
            scale_yx = (scale, scale)
        else:
            scale_yx = (self.size[0] / image.shape[0],
                        self.size[1] / image.shape[1])
            mode = "none"
            h, w = self.size[0], self.size[1]

        data[("image_resize", "effective_size")] = np.asarray(
            [h, w], dtype=np.int64)

        for key in self.image_keys:
            data[key] = resize_linear(data[key], w, h)
        for key in self.gt_image_keys:
            data[key] = resize_nearest(data[key], w, h)

        if len(self.size) > 1:
            for key in self.image_keys + self.gt_image_keys:
                img = data[key]
                if mode == "crop_1":
                    data[key] = img[:, 0:self.size[1]]
                elif mode == "pad_1":
                    padW = self.size[1] - img.shape[1]
                    pads = ([(0, 0), (0, padW)]
                            + ([(0, 0)] if img.ndim == 3 else []))
                    data[key] = np.pad(img, pads, "constant")
                elif mode == "pad_0":
                    padH = self.size[0] - img.shape[0]
                    pads = ([(0, padH), (0, 0)]
                            + ([(0, 0)] if img.ndim == 3 else []))
                    data[key] = np.pad(img, pads, "constant")

        for key in self.calib_keys:
            P = data[key]
            P[0, :] = P[0, :] * scale_yx[1]
            P[1, :] = P[1, :] * scale_yx[0]
            data[key] = P
        return data


class CropTop:
    """Crop rows off the top; shifts cy."""

    def __init__(self, crop_top_index=None, output_height=None,
                 image_keys=("image",), gt_image_keys=(), calib_keys=(),
                 **kwargs):
        if crop_top_index is None and output_height is None:
            crop_top_index = 0
        self.crop_top_index = crop_top_index
        self.output_height = output_height
        self.image_keys = list(image_keys)
        self.calib_keys = list(calib_keys)
        self.gt_image_keys = list(gt_image_keys)

    def __call__(self, data):
        height = data[self.image_keys[0]].shape[0]
        upper = (self.crop_top_index if self.crop_top_index is not None
                 else height - self.output_height)
        for key in self.image_keys + self.gt_image_keys:
            data[key] = data[key][upper:height]
        for key in self.calib_keys:
            P = data[key]
            P[1, 2] = P[1, 2] - upper
            P[1, 3] = P[1, 3] - upper * P[2, 3]
            data[key] = P
        return data


class CropRight:
    """Crop columns off the right."""

    def __init__(self, crop_right_index=None, output_width=None,
                 image_keys=("image",), gt_image_keys=(), **kwargs):
        if crop_right_index is None and output_width is None:
            crop_right_index = 0
        self.crop_right_index = crop_right_index
        self.output_width = output_width
        self.image_keys = list(image_keys)
        self.gt_image_keys = list(gt_image_keys)

    def __call__(self, data):
        width = data[self.image_keys[0]].shape[1]
        if self.crop_right_index is not None:
            righter = width - self.crop_right_index
        else:
            righter = self.output_width
        if righter > width:
            return data
        for key in self.image_keys + self.gt_image_keys:
            data[key] = data[key][:, 0:righter]
        return data


class Pad2Shape:
    """Zero-pad bottom/right to a target shape."""

    def __init__(self, target_shape, image_keys=("image",), gt_image_keys=(),
                 **kwargs):
        self.target_shape = target_shape
        self.image_keys = list(image_keys)
        self.gt_image_keys = list(gt_image_keys)

    def __call__(self, data):
        height, width = data[self.image_keys[0]].shape[:2]
        padH = self.target_shape[0] - height
        padW = self.target_shape[1] - width
        for key in self.image_keys + self.gt_image_keys:
            img = data[key]
            pads = [(0, padH), (0, padW)] + ([(0, 0)] if img.ndim == 3 else [])
            data[key] = np.pad(img, pads, "constant")
        return data


class FilterObject:
    """Drop objects fully outside the image."""

    def __init__(self, image_keys=("image",), objects_keys=(), **kwargs):
        self.image_keys = list(image_keys)
        self.object_keys = list(objects_keys)

    def __call__(self, data):
        height, width = data[self.image_keys[0]].shape[:2]
        for key in self.object_keys:
            data[key].filter(height, width)
        return data


class RandomCropToWidth:
    """Random horizontal crop to a fixed width; shifts cx. The left edge is
    ``self.rng.randint(0, W - width)`` (see the module docstring)."""

    def __init__(self, width: int, image_keys=("image",), gt_image_keys=(),
                 calib_keys=(), random_seed=None, **kwargs):
        self.width = width
        self.image_keys = list(image_keys)
        self.calib_keys = list(calib_keys)
        self.gt_image_keys = list(gt_image_keys)
        self.rng = np.random.RandomState(_seed(random_seed))

    def __call__(self, data):
        original_width = data[self.image_keys[0]].shape[1]
        if self.width > original_width:
            return data
        lefter = self.rng.randint(0, original_width - self.width)
        righter = lefter + self.width
        for key in self.image_keys + self.gt_image_keys:
            data[key] = data[key][:, lefter:righter]
        for key in self.calib_keys:
            P = data[key]
            P[0, 2] = P[0, 2] - lefter
            P[0, 3] = P[0, 3] - lefter * P[2, 3]
            data[key] = P
        return data


class RandomMirror:
    """Horizontal flip with probability ``mirror_prob`` (``self.rng.rand()
    <= mirror_prob``): images, calib (cx), lidar x, relative poses (euler
    negation about the mirror axis), optional stereo left/right swap."""

    def __init__(self, mirror_prob, image_keys=("image",), calib_keys=(),
                 gt_image_keys=(), object_keys=(), lidar_keys=(),
                 pose_axis_pairs=(), is_switch_left_right=True,
                 stereo_image_key_pairs=(), stereo_calib_key_pairs=(),
                 random_seed=None, **kwargs):
        self.mirror_prob = mirror_prob
        self.image_keys = list(image_keys)
        self.calib_keys = list(calib_keys)
        self.gt_image_keys = list(gt_image_keys)
        self.object_keys = list(object_keys)
        self.lidar_keys = list(lidar_keys)
        self.pose_axis_pairs = list(pose_axis_pairs)
        self.is_switch_lr = is_switch_left_right
        self.stereo_image_key_pairs = list(stereo_image_key_pairs)
        self.stereo_calib_key_pairs = list(stereo_calib_key_pairs)
        self.rng = np.random.RandomState(_seed(random_seed))

    def __call__(self, data):
        width = data[self.image_keys[0]].shape[1]
        if self.rng.rand() <= self.mirror_prob:
            for key in self.image_keys + self.gt_image_keys:
                data[key] = np.ascontiguousarray(data[key][:, ::-1])
            for key in self.calib_keys:
                P = data[key]
                P[0, 3] = -P[0, 3]
                P[0, 2] = width - P[0, 2] - 1
                data[key] = P
            for key in self.object_keys:
                data[key].flip_objects()
            for key in self.lidar_keys:
                data[key] = -data[key][..., 0]
            for key, axis_num in self.pose_axis_pairs:
                data[key] = flip_relative_pose(data[key], axis_num)
            if self.is_switch_lr:
                for key_l, key_r in (self.stereo_image_key_pairs
                                     + self.stereo_calib_key_pairs):
                    data[key_l], data[key_r] = data[key_r], data[key_l]
        return data


class RandomWarpAffine:
    """Random scale + shift crop resized to a fixed output, with P rewrite;
    images bilinear, ``gt_image_keys`` nearest, as ``cv2.warpAffine`` with
    ``BORDER_CONSTANT`` (see the module docstring). The centre lies at least
    ``shift_border`` pixels inside each edge."""

    def __init__(self, scale_lower=0.6, scale_upper=1.4, shift_border=128,
                 output_w=1280, output_h=384, image_keys=("image",),
                 gt_image_keys=(), calib_keys=(),
                 border_mode=BORDER_CONSTANT, random_seed=None, **kwargs):
        if border_mode != BORDER_CONSTANT:
            raise NotImplementedError(
                "RandomWarpAffine takes border_mode BORDER_CONSTANT (0) "
                f"only, got {border_mode}")
        self.scale_lower = scale_lower
        self.scale_upper = scale_upper
        self.shift_border = shift_border
        self.output_w = output_w
        self.output_h = output_h
        self.image_keys = list(image_keys)
        self.gt_image_keys = list(gt_image_keys)
        self.calib_keys = list(calib_keys)
        self.border_mode = border_mode
        self.rng = np.random.default_rng(_seed(random_seed))

    def __call__(self, data):
        height, width = data[self.image_keys[0]].shape[:2]
        s_original = max(height, width)
        scale = s_original * self.rng.uniform(self.scale_lower,
                                              self.scale_upper)
        center_w = self.rng.integers(self.shift_border,
                                     width - self.shift_border)
        center_h = self.rng.integers(self.shift_border,
                                     height - self.shift_border)

        final_scale = max(self.output_w, self.output_h) / scale
        final_shift_w = self.output_w / 2 - center_w * final_scale
        final_shift_h = self.output_h / 2 - center_h * final_scale
        M = np.array([[final_scale, 0, final_shift_w],
                      [0, final_scale, final_shift_h]], dtype=np.float32)

        # one map per image size; the images of a size warped as one stack
        by_shape = {}
        for key in self.image_keys:
            by_shape.setdefault(data[key].shape[:2], []).append(key)
        maps = {shape: _AffineMap(M, shape, self.output_w, self.output_h)
                for shape in by_shape}
        for shape, keys in by_shape.items():
            warped = maps[shape].warp_linear(*(data[k] for k in keys))
            data.update(zip(keys, warped))
        for key in self.gt_image_keys:
            shape = data[key].shape[:2]
            if shape not in maps:
                maps[shape] = _AffineMap(M, shape, self.output_w,
                                         self.output_h)
            data[key] = maps[shape].warp_nearest(data[key])
        for key in self.calib_keys:
            P = data[key]
            P[0:2, :] *= final_scale
            P[0, 2] = P[0, 2] + final_shift_w
            P[0, 3] = P[0, 3] + final_shift_w * P[2, 3]
            P[1, 2] = P[1, 2] + final_shift_h
            P[1, 3] = P[1, 3] + final_shift_h * P[2, 3]
            data[key] = P
        return data


class RandomSaturation:
    """Scale the S channel of an HSV image."""

    def __init__(self, distort_prob, lower=0.5, upper=1.5,
                 image_keys=("image",), random_seed=None, **kwargs):
        if not upper >= lower >= 0:
            raise ValueError(f"need upper >= lower >= 0, got {lower}, "
                             f"{upper}")
        self.distort_prob = distort_prob
        self.lower = lower
        self.upper = upper
        self.image_keys = list(image_keys)
        self.rng = np.random.default_rng(_seed(random_seed))

    def __call__(self, data):
        if self.rng.random() <= self.distort_prob:
            ratio = self.rng.uniform(self.lower, self.upper)
            for key in self.image_keys:
                data[key][:, :, 1] *= ratio
        return data


class RandomHue:
    """Rotate the H channel of an HSV image."""

    def __init__(self, distort_prob, delta=18.0, image_keys=("image",),
                 random_seed=None, **kwargs):
        if not 0.0 <= delta <= 360.0:
            raise ValueError(f"delta {delta} outside [0, 360]")
        self.delta = delta
        self.distort_prob = distort_prob
        self.image_keys = list(image_keys)
        self.rng = np.random.default_rng(_seed(random_seed))

    def __call__(self, data):
        if self.rng.random() <= self.distort_prob:
            shift = self.rng.uniform(-self.delta, self.delta)
            for key in self.image_keys:
                image = data[key]
                image[:, :, 0] += shift
                image[:, :, 0][image[:, :, 0] > 360.0] -= 360.0
                image[:, :, 0][image[:, :, 0] < 0.0] += 360.0
                data[key] = image
        return data


# ConvertColor's conversions: (current, transform) -> (function, blue index)
_CONVERSIONS = {("RGB", "HSV"): (rgb_to_hsv, 2), ("BGR", "HSV"): (rgb_to_hsv, 0),
                ("HSV", "RGB"): (hsv_to_rgb, 2), ("HSV", "BGR"): (hsv_to_rgb, 0)}


class ConvertColor:
    """RGB/BGR <-> HSV with OpenCV's float formulas (:func:`rgb_to_hsv`,
    :func:`hsv_to_rgb`)."""

    def __init__(self, current="RGB", transform="HSV", image_keys=("image",),
                 **kwargs):
        if (current, transform) not in _CONVERSIONS:
            raise NotImplementedError(
                f"ConvertColor {current}2{transform}: the port converts "
                f"{sorted(_CONVERSIONS)}")
        self.convertor = _CONVERSIONS[(current, transform)]
        self.image_keys = list(image_keys)

    def __call__(self, data):
        fn, blue = self.convertor
        for key in self.image_keys:
            data[key] = fn(data[key], blue)
        return data


class RandomContrast:
    """Scale pixel values."""

    def __init__(self, distort_prob, lower=0.5, upper=1.5,
                 image_keys=("image",), random_seed=None, **kwargs):
        if not upper >= lower >= 0:
            raise ValueError(f"need upper >= lower >= 0, got {lower}, "
                             f"{upper}")
        self.distort_prob = distort_prob
        self.lower = lower
        self.upper = upper
        self.image_keys = list(image_keys)
        self.rng = np.random.default_rng(_seed(random_seed))

    def __call__(self, data):
        if self.rng.random() <= self.distort_prob:
            alpha = self.rng.uniform(self.lower, self.upper)
            for key in self.image_keys:
                data[key] = data[key] * alpha
        return data


class RandomBrightness:
    """Add a uniform offset."""

    def __init__(self, distort_prob, delta=32, image_keys=("image",),
                 random_seed=None, **kwargs):
        if not 0.0 <= delta <= 255.0:
            raise ValueError(f"delta {delta} outside [0, 255]")
        self.delta = delta
        self.distort_prob = distort_prob
        self.image_keys = list(image_keys)
        self.rng = np.random.default_rng(_seed(random_seed))

    def __call__(self, data):
        if self.rng.random() <= self.distort_prob:
            delta = self.rng.uniform(-self.delta, self.delta)
            for key in self.image_keys:
                data[key] = data[key] + delta
        return data


class RandomEigenvalueNoise:
    """ImageNet PCA colour noise."""

    def __init__(self, distort_prob=1.0, alphastd=0.1,
                 eigen_value=np.array([0.2141788, 0.01817699, 0.00341571],
                                      dtype=np.float32),
                 eigen_vector=np.array([
                     [-0.58752847, -0.69563484, 0.41340352],
                     [-0.5832747, 0.00994535, -0.81221408],
                     [-0.56089297, 0.71832671, 0.41158938]], dtype=np.float32),
                 image_keys=("image",), random_seed=None, **kwargs):
        self.distort_prob = distort_prob
        self._eig_val = eigen_value
        self._eig_vec = eigen_vector
        self.alphastd = alphastd
        self.image_keys = list(image_keys)
        self.rng = np.random.default_rng(_seed(random_seed))

    def __call__(self, data):
        if self.rng.random() <= self.distort_prob:
            alpha = self.rng.normal(scale=self.alphastd, size=(3,))
            noise = np.dot(self._eig_vec, self._eig_val * alpha) * 255
            for key in self.image_keys:
                data[key] = data[key] + noise
        return data


class PhotometricDistort:
    """SSD-style photometric distortion: brightness, then contrast before
    or after (``self.rng.rand() <= 0.5``: before) the HSV saturation and
    hue jitter."""

    def __init__(self, distort_prob=1.0, contrast_lower=0.5, contrast_upper=1.5,
                 saturation_lower=0.5, saturation_upper=1.5, hue_delta=18.0,
                 brightness_delta=32, image_keys=("image",), random_seed=None,
                 **kwargs):
        self.transforms = [
            RandomContrast(distort_prob, contrast_lower, contrast_upper,
                           image_keys=image_keys),
            ConvertColor(transform="HSV", image_keys=image_keys),
            RandomSaturation(distort_prob, saturation_lower, saturation_upper,
                             image_keys=image_keys),
            RandomHue(distort_prob, hue_delta, image_keys=image_keys),
            ConvertColor(current="HSV", transform="RGB", image_keys=image_keys),
            RandomContrast(distort_prob, contrast_lower, contrast_upper,
                           image_keys=image_keys),
        ]
        self.rand_brightness = RandomBrightness(distort_prob, brightness_delta,
                                                image_keys=image_keys)
        self.rng = np.random.RandomState(_seed(random_seed))

    def __call__(self, data):
        distortion = (self.transforms[:-1] if self.rng.rand() <= 0.5
                      else self.transforms[1:])
        data = self.rand_brightness(data)
        for t in distortion:
            data = t(data)
        return data


class Copy:
    """Duplicate keys."""

    def __init__(self, from_keys, to_keys, **kwargs):
        self.from_keys = list(from_keys)
        self.to_keys = list(to_keys)

    def __call__(self, data):
        for from_key, to_key in zip(self.from_keys, self.to_keys):
            data[to_key] = data[from_key].copy()
        return data
