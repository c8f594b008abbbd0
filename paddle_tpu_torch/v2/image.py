"""v2 image utilities (reference: python/paddle/v2/image.py).

Numpy-only implementations (the reference shells out to cv2): resize via
nearest/bilinear sampling, center/random crop, flip, and the composed
``simple_transform`` used by the dataset readers.
"""
from __future__ import annotations

import numpy as np

__all__ = ["resize_short", "to_chw", "center_crop", "random_crop",
           "left_right_flip", "simple_transform", "load_image",
           "load_and_transform"]


def _bilinear_resize(im, h, w):
    """im: HWC float array → [h, w, C]."""
    H, W = im.shape[:2]
    ys = np.linspace(0, H - 1, h)
    xs = np.linspace(0, W - 1, w)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, H - 1)
    x1 = np.minimum(x0 + 1, W - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    im = im.astype(np.float32)
    a = im[y0][:, x0]
    b = im[y0][:, x1]
    c = im[y1][:, x0]
    d = im[y1][:, x1]
    out = (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx +
           c * wy * (1 - wx) + d * wy * wx)
    return out


def load_image(file, is_color=True):
    """Minimal image loader: supports .npy arrays (no cv2 in this image)."""
    arr = np.load(file) if str(file).endswith(".npy") else np.asarray(file)
    if not is_color and arr.ndim == 3:
        arr = arr.mean(axis=2)
    return arr


def resize_short(im, size):
    """Resize so the SHORT side equals ``size``, keeping aspect ratio."""
    h, w = im.shape[:2]
    if h < w:
        nh, nw = size, int(w * size / h)
    else:
        nh, nw = int(h * size / w), size
    if im.ndim == 2:
        return _bilinear_resize(im[:, :, None], nh, nw)[:, :, 0]
    return _bilinear_resize(im, nh, nw)


def to_chw(im, order=(2, 0, 1)):
    return im.transpose(order)


def center_crop(im, size, is_color=True):
    h, w = im.shape[:2]
    h0 = max(0, (h - size) // 2)
    w0 = max(0, (w - size) // 2)
    return im[h0:h0 + size, w0:w0 + size]


def random_crop(im, size, is_color=True, rng=None):
    rng = rng or np.random
    h, w = im.shape[:2]
    h0 = rng.randint(0, max(h - size, 0) + 1)
    w0 = rng.randint(0, max(w - size, 0) + 1)
    return im[h0:h0 + size, w0:w0 + size]


def left_right_flip(im, is_color=True):
    return im[:, ::-1]


def simple_transform(im, resize_size, crop_size, is_train, is_color=True,
                     mean=None):
    """resize_short → crop (random+flip when training) → CHW → mean-sub."""
    im = resize_short(im, resize_size)
    if is_train:
        im = random_crop(im, crop_size, is_color)
        if np.random.randint(2) == 0:
            im = left_right_flip(im, is_color)
    else:
        im = center_crop(im, crop_size, is_color)
    if im.ndim == 3:
        im = to_chw(im)
    im = im.astype(np.float32)
    if mean is not None:
        mean = np.asarray(mean, dtype=np.float32)
        im -= mean if mean.ndim != 1 else mean[:, None, None]
    return im


def load_and_transform(filename, resize_size, crop_size, is_train,
                       is_color=True, mean=None):
    return simple_transform(load_image(filename, is_color), resize_size,
                            crop_size, is_train, is_color, mean)
