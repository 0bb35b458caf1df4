"""Image resampling for the port's data paths, NumPy only: look-alikes of
the three library resizes the JAX package calls (cv2 and Pillow, which the
card's machine lacks).

  resize_nearest  cv2.resize(..., INTER_NEAREST): destination pixel x takes
                  source pixel min(floor(x * sx), src - 1), sx = 1 / (dst /
                  src) in double precision (masks and depth fields,
                  data/satellite.py);
  resize_linear   cv2.resize(..., INTER_LINEAR) of float images of 1 to 4
                  channels: half-pixel
                  centres, float32 weights, clamped borders; an
                  exact 2x reduction on both axes is cv2's 2x2 mean, as cv2
                  switches to INTER_AREA there (images, data/satellite.py);
  resize_lanczos  Pillow's Image.resize(..., LANCZOS) of 8-bit images:
                  RGBA and LA are premultiplied by alpha first and divided
                  back after, as Pillow converts them to RGBa / La; a
                  horizontal then a vertical pass with Pillow's 22-bit
                  fixed-point coefficients, each rounded and clipped to
                  uint8 (blender frames, data/blender.py).

Like cv2, the first two take (H, W) or (H, W, C) arrays and return an
(H', W') array for a one-channel (H, W, 1) input.
"""

from __future__ import annotations

import numpy as np


def _nearest_index(src: int, dst: int) -> np.ndarray:
    ifx = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst) * ifx).astype(np.int64),
                      src - 1)


def _squeeze(out: np.ndarray) -> np.ndarray:
    return out[..., 0] if out.ndim == 3 and out.shape[-1] == 1 else out


def resize_nearest(img: np.ndarray, w: int, h: int) -> np.ndarray:
    img = np.asarray(img)
    out = img[_nearest_index(img.shape[0], h)][:, _nearest_index(
        img.shape[1], w)]
    return _squeeze(out)


def _linear_taps(src: int, dst: int):
    """cv2's (index, index + 1, weight, weight) per destination pixel."""
    scale = src / dst
    fx = (np.arange(dst) + 0.5) * scale - 0.5
    sx = np.floor(fx).astype(np.int64)
    fx = fx - sx
    low = sx < 0
    fx[low], sx[low] = 0, 0
    high = sx >= src - 1
    fx[high], sx[high] = 0, src - 1
    a1 = fx.astype(np.float32)
    a0 = (np.float32(1) - a1).astype(np.float32)
    return sx, np.minimum(sx + 1, src - 1), a0, a1


def resize_linear(img: np.ndarray, w: int, h: int) -> np.ndarray:
    img = np.asarray(img)
    if not np.issubdtype(img.dtype, np.floating):
        raise ValueError("resize_linear takes float images (cv2's 8-bit "
                         "fixed-point path is not reproduced)")
    src_h, src_w = img.shape[:2]
    x = img if img.ndim == 3 else img[..., None]
    if x.shape[-1] > 4:
        raise ValueError("resize_linear takes 1 to 4 channels (cv2 weighs "
                         "more channels another way)")
    dt = img.dtype.type
    if src_w == 2 * w and src_h == 2 * h:
        out = (((x[0::2, 0::2] + x[0::2, 1::2]) + x[1::2, 0::2])
               + x[1::2, 1::2]) * dt(0.25)
    else:
        i0, i1, a0, a1 = _linear_taps(src_w, w)
        rows = (x[:, i0] * a0[None, :, None].astype(dt)
                + x[:, i1] * a1[None, :, None].astype(dt))
        j0, j1, b0, b1 = _linear_taps(src_h, h)
        out = (rows[j0] * b0[:, None, None].astype(dt)
               + rows[j1] * b1[:, None, None].astype(dt))
    return _squeeze(out.astype(img.dtype))


# ----------------------------------------------------------- Pillow LANCZOS

PRECISION_BITS = 32 - 8 - 2
LANCZOS_SUPPORT = 3.0


def _lanczos(x: np.ndarray) -> np.ndarray:
    def sinc(v):
        with np.errstate(invalid="ignore", divide="ignore"):
            pv = v * np.pi
            return np.where(v == 0.0, 1.0, np.sin(pv) / pv)
    return np.where((x >= -3.0) & (x < 3.0), sinc(x) * sinc(x / 3.0), 0.0)


def _lanczos_matrix(src: int, dst: int) -> np.ndarray:
    """Pillow's precompute_coeffs + normalize_coeffs_8bpc as a dense (dst,
    src) matrix of its integer coefficients (float64, exact)."""
    scale = src / dst
    filterscale = max(scale, 1.0)
    support = LANCZOS_SUPPORT * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(dst) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64),
                      src) - xmin
    x = np.arange(ksize)[None, :]
    w = _lanczos((x + xmin[:, None] - center[:, None] + 0.5)
                 * (1.0 / filterscale))
    w = np.where(x < xmax[:, None], w, 0.0)
    ww = w.sum(1, keepdims=True)
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    k = np.where(w < 0, np.trunc(-0.5 + w * (1 << PRECISION_BITS)),
                 np.trunc(0.5 + w * (1 << PRECISION_BITS)))
    m = np.zeros((dst, src))
    cols = np.minimum(xmin[:, None] + x, src - 1)
    rows = np.broadcast_to(np.arange(dst)[:, None], cols.shape)
    keep = x < xmax[:, None]
    m[rows[keep], cols[keep]] = k[keep]
    return m


def _clip8(ss: np.ndarray) -> np.ndarray:
    return np.clip(np.floor(ss / (1 << PRECISION_BITS)), 0,
                   255).astype(np.uint8)


def _premultiply(a: np.ndarray) -> np.ndarray:
    """Pillow's RGBA -> RGBa (and LA -> La): MULDIV255 of each colour by
    alpha."""
    out = a.copy()
    alpha = a[..., -1:].astype(np.uint32)
    tmp = a[..., :-1].astype(np.uint32) * alpha + 128
    out[..., :-1] = (((tmp >> 8) + tmp) >> 8).astype(np.uint8)
    return out


def _unpremultiply(a: np.ndarray) -> np.ndarray:
    """Pillow's RGBa -> RGBA: 255 * c / alpha, clipped, where 0 < alpha <
    255."""
    out = a.copy()
    alpha = a[..., -1:].astype(np.uint32)
    part = (alpha > 0) & (alpha < 255)
    div = (255 * a[..., :-1].astype(np.uint32)) // np.where(part, alpha, 1)
    out[..., :-1] = np.where(part, np.minimum(div, 255),
                             a[..., :-1]).astype(np.uint8)
    return out


def resize_lanczos(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """Pillow's Image.fromarray(img).resize((w, h), LANCZOS) as an array:
    img is uint8 (H, W) or (H, W, C), C in 1..4; C = 2 and 4 carry alpha
    last."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError("resize_lanczos takes uint8 images")
    if img.shape[:2] == (h, w):
        return img.copy()
    x = img if img.ndim == 3 else img[..., None]
    alpha = x.shape[-1] in (2, 4)
    if alpha:
        x = _premultiply(x)
    src_h, src_w = x.shape[:2]
    if src_w != w:
        m = _lanczos_matrix(src_w, w)
        ss = np.einsum("hwc,vw->hvc", x.astype(np.float64), m,
                       optimize=True) + (1 << (PRECISION_BITS - 1))
        x = _clip8(ss)
    if src_h != h:
        m = _lanczos_matrix(src_h, h)
        ss = np.einsum("hwc,vh->vwc", x.astype(np.float64), m,
                       optimize=True) + (1 << (PRECISION_BITS - 1))
        x = _clip8(ss)
    if alpha:
        x = _unpremultiply(x)
    return x if img.ndim == 3 else x[..., 0]


# ------------------------------------------- Pillow NEAREST and 16-bit

def resize_nearest_pil(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """Pillow's Image.resize(..., NEAREST), which it takes for every "1"
    and "P" image (ImagingScaleAffine): destination pixel k reads source
    pixel int(sx / 2 + k * sx), the position accumulated step by step in
    double precision as Pillow accumulates it."""
    img = np.asarray(img)
    if img.shape[:2] == (h, w):
        return img.copy()

    def index(src, dst):
        a = src / dst
        pos = np.cumsum(np.concatenate([[a * 0.5], np.full(dst - 1, a)]))
        return np.minimum(pos.astype(np.int64), src - 1)
    return img[index(img.shape[0], h)][:, index(img.shape[1], w)]


def _pillow_coeffs(src: int, dst: int):
    """Pillow's precompute_coeffs for LANCZOS in double precision, summed
    in its order: per destination pixel (first source pixel, weights)."""
    import math

    def sinc(x):
        if x == 0.0:
            return 1.0
        x = x * math.pi
        return math.sin(x) / x

    scale = src / dst
    filterscale = max(scale, 1.0)
    support = LANCZOS_SUPPORT * filterscale
    out = []
    for xx in range(dst):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), src) - xmin
        k, ww = [], 0.0
        for x in range(xmax):
            v = (x + xmin - center + 0.5) * ss
            f = sinc(v) * sinc(v / 3) if -3.0 <= v < 3.0 else 0.0
            k.append(f)
            ww += f
        out.append((xmin, [f / ww if ww != 0.0 else f for f in k]))
    return out


def _resample16(x: np.ndarray, dst: int) -> np.ndarray:
    """One 16bpc pass along axis 1 of (rows, src) uint16: the sum in
    double, ROUND_UP, and each byte of the result clipped on its own
    (ImagingResampleHorizontal_16bpc)."""
    out = np.empty((x.shape[0], dst), np.uint16)
    xf = x.astype(np.float64)
    for xx, (xmin, k) in enumerate(_pillow_coeffs(x.shape[1], dst)):
        ss = np.zeros(x.shape[0])
        for i, f in enumerate(k):
            ss = ss + xf[:, xmin + i] * f
        r = np.where(ss >= 0.0, np.floor(ss + 0.5),
                     -np.floor(np.abs(ss) + 0.5)).astype(np.int64)
        lo = np.clip(np.fmod(r, 256), 0, 255)
        hi = np.clip(r >> 8, 0, 255)
        out[:, xx] = lo + (hi << 8)
    return out


def resize_lanczos16(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """Pillow's Image.resize(..., LANCZOS) of an "I;16" image (uint16
    (H, W)): a horizontal then a vertical pass, each with double weights
    and rounded to 16 bits."""
    img = np.asarray(img)
    if img.dtype != np.uint16 or img.ndim != 2:
        raise ValueError("resize_lanczos16 takes uint16 (H, W) images")
    if img.shape == (h, w):
        return img.copy()
    x = img
    if x.shape[1] != w:
        x = _resample16(x, w)
    if x.shape[0] != h:
        x = _resample16(x.T, h).T
    return np.ascontiguousarray(x)
