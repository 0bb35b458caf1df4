"""PNG read and write for the port's data and output paths, NumPy and zlib
only (the JAX package reads and writes PNGs through PIL, which the card's
machine lacks).

read_png decodes 8-bit greyscale, greyscale + alpha, RGB and RGBA images,
not interlaced, in any number of IDAT chunks, with all five row filters,
to the array PIL gives (`np.asarray(Image.open(path))`): (H, W) for
greyscale, (H, W, C) otherwise, uint8.  Anything else (palettes, 16-bit
samples, Adam7) is refused with a ValueError naming it.

Row reconstruction is sequential along a row (Sub, Average and Paeth
predict from the byte to the left), so it runs in a host C library,
csrc/png_unfilter.c, built at first use with the system C compiler
(ops/cuda_build.load_host); unfilter_plain is its NumPy twin, which the
tests and chip_smoke.py hold it to.

write_png encodes the same four layouts with one filter type a row: a
given type for every row, a sequence of types, or by default the type
whose filtered row has the least sum of absolute values (the heuristic
of the PNG specification's section 12.8).
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Sequence, Union

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (8-bit samples only)
CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}
COLOR_TYPE = {c: t for t, c in CHANNELS.items()}
NONE, SUB, UP, AVERAGE, PAETH = range(5)


def _chunks(buf: bytes, path: str):
    if buf[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(buf):
        n, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        data = buf[pos + 8:pos + 8 + n]
        crc = buf[pos + 8 + n:pos + 12 + n]
        if len(data) != n or len(crc) != 4:
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + data):
            raise ValueError(f"{path}: bad CRC in the {kind!r} chunk")
        yield kind, data
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: no IEND chunk")


def _header(data: bytes, path: str):
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB",
                                                              data)
    if ctype == 3:
        raise ValueError(f"{path}: palette PNGs are not supported")
    if ctype not in CHANNELS:
        raise ValueError(f"{path}: unknown PNG colour type {ctype}")
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit samples are not supported "
                         "(8-bit only)")
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNGs are not "
                         "supported")
    if comp or filt:
        raise ValueError(f"{path}: unknown compression or filter method")
    return h, w, CHANNELS[ctype]


def inflate(buf: bytes, path: str = "<bytes>"):
    """The PNG's (h, w, channels) and its inflated IDAT stream: h rows of
    a filter-type byte and w * channels filtered bytes."""
    head, idat = None, []
    for kind, data in _chunks(buf, path):
        if kind == b"IHDR":
            head = _header(data, path)
        elif kind == b"IDAT":
            idat.append(data)
    if head is None or not idat:
        raise ValueError(f"{path}: no IHDR or no IDAT chunk")
    h, w, c = head
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (w * c + 1):
        raise ValueError(f"{path}: image data holds {len(raw)} bytes, "
                         f"{h * (w * c + 1)} expected")
    return h, w, c, raw


def _unfilter_c(raw: bytes, h: int, w: int, c: int, path: str) -> np.ndarray:
    from ..ops.cuda_build import load_host
    lib = load_host("png_unfilter")
    fn = lib.png_unfilter
    fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int]
    fn.restype = ctypes.c_int
    out = np.empty((h, w * c), np.uint8)
    bad = fn(raw, out.ctypes.data, h, w * c, c)
    if bad:
        row = bad - 1
        raise ValueError(f"{path}: row {row} has filter type "
                         f"{raw[row * (w * c + 1)]} (0..4 only)")
    return out


def unfilter_plain(raw: bytes, h: int, w: int, c: int) -> np.ndarray:
    """NumPy twin of csrc/png_unfilter.c: (h, w * c) uint8 scanlines.  A
    pixel depends on its left, upper and upper-left neighbours alone, so
    the pixels of one anti-diagonal (y + x constant) are reconstructed
    together, diagonal after diagonal, each with its row's filter type."""
    rows = np.frombuffer(raw, np.uint8).reshape(h, w * c + 1)
    kinds = rows[:, 0].astype(np.int64)
    if kinds.max(initial=0) > PAETH:
        y = int(np.argmax(kinds > PAETH))
        raise ValueError(f"row {y} has filter type {kinds[y]} (0..4 only)")
    x = rows[:, 1:].reshape(h, w, c).astype(np.int64)
    # out[y + 1, i + 1] is pixel (y, i); row 0 and column 0 are the zeros
    # that stand for the bytes before the image's first row and column
    out = np.zeros((h + 1, w + 1, c), np.int64)
    for k in range(h + w - 1):
        y = np.arange(max(0, k - w + 1), min(h, k + 1))
        i = k - y
        left, up, ul = out[y + 1, i], out[y, i + 1], out[y, i]
        p = left + up - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, up, ul))
        kind = kinds[y][:, None]
        pred = np.select([kind == NONE, kind == SUB, kind == UP,
                          kind == AVERAGE],
                         [np.zeros_like(left), left, up, (left + up) >> 1],
                         paeth)
        out[y + 1, i + 1] = (x[y, i] + pred) & 255
    return out[1:, 1:].reshape(h, w * c).astype(np.uint8)


def decode_png(buf: bytes, path: str = "<bytes>") -> np.ndarray:
    h, w, c, raw = inflate(buf, path)
    img = _unfilter_c(raw, h, w, c, path).reshape(h, w, c)
    return img[..., 0] if c == 1 else img


def read_png(path: str) -> np.ndarray:
    """The image as PIL's np.asarray(Image.open(path)) gives it."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def _predictors(x: np.ndarray, up: np.ndarray, c: int):
    """Each filter type's prediction of every byte of (h, n) scanlines x
    from the raw bytes (so every row is filtered at once)."""
    h, n = x.shape
    left = np.zeros_like(x)
    left[:, c:] = x[:, :-c]
    ul = np.zeros_like(x)
    ul[:, c:] = up[:, :-c]
    p = left + up - ul
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, ul))
    return (np.zeros_like(x), left, up, (left + up) >> 1, paeth)


def encode_png(img: np.ndarray,
               filters: Union[None, int, Sequence[int]] = None,
               idat_size: int = 1 << 20) -> bytes:
    """PNG bytes of a uint8 (H, W) or (H, W, 1..4) image.  filters: one
    type for every row, a type per row, or None (least sum of absolute
    filtered values, row by row).  The compressed stream is cut into IDAT
    chunks of idat_size bytes."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 images, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[-1] not in COLOR_TYPE:
        raise ValueError(f"write_png takes (H, W) or (H, W, 1..4) images, "
                         f"not {img.shape}")
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int16)
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    filtered = np.stack([(x - p) & 255 for p in _predictors(x, up, c)])
    if filters is None:
        signed = np.where(filtered > 127, 256 - filtered, filtered)
        kinds = np.argmin(signed.sum(-1, dtype=np.int64), 0)
    else:
        kinds = np.broadcast_to(np.asarray(filters, np.int64), (h,))
        if kinds.min() < 0 or kinds.max() > 4:
            raise ValueError("PNG filter types are 0..4")
    rows = np.empty((h, w * c + 1), np.uint8)
    rows[:, 0] = kinds
    rows[:, 1:] = filtered[kinds, np.arange(h)]
    data = zlib.compress(rows.tobytes())

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    out = [SIGNATURE, chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, 8, COLOR_TYPE[c], 0, 0, 0))]
    for i in range(0, max(len(data), 1), idat_size):
        out.append(chunk(b"IDAT", data[i:i + idat_size]))
    out.append(chunk(b"IEND", b""))
    return b"".join(out)


def write_png(path: str, img: np.ndarray,
              filters: Union[None, int, Sequence[int]] = None) -> str:
    with open(path, "wb") as f:
        f.write(encode_png(img, filters))
    return path
