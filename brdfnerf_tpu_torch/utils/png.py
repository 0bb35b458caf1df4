"""PNG read and write for the port's data and output paths, NumPy and zlib
only (the JAX package reads and writes PNGs through PIL, which the card's
machine lacks).

decode_image decodes every PNG of the specification, in any number of IDAT
chunks, with all five row filters, to the array PIL 12.1 gives
(`np.asarray(Image.open(path))`), mode by mode (PngImagePlugin's _MODES):

  colour type  depth     PIL mode  array
  0 grey       1         "1"       bool (H, W)
  0 grey       2, 4, 8   "L"       uint8 (H, W), 2- and 4-bit scaled to 0..255
  0 grey       16        "I;16"    uint16 (H, W)
  2 RGB        8, 16     "RGB"     uint8 (H, W, 3), 16-bit: the high bytes
  3 palette    1-8       "P"       uint8 (H, W): the palette indices
  4 grey+alpha 8         "LA"      uint8 (H, W, 2)
  4 grey+alpha 16        "RGBA"    uint8 (H, W, 4): L, L, L, A high bytes
  6 RGBA       8, 16     "RGBA"    uint8 (H, W, 4), 16-bit: the high bytes

Adam7-interlaced images are decoded pass by pass, each pass's rows
unfiltered with the filter's bytes per pixel (one byte below 8 bits a
pixel) and scattered to its pixels.  Ancillary chunks (PLTE, tRNS, ...)
do not change the array.  decode_image also returns PIL's mode; read_png
reads a file's array.

Row reconstruction is sequential along a row (Sub, Average and Paeth
predict from the byte to the left), so it runs in a host C library,
csrc/png_unfilter.c, built at first use with the system C compiler
(ops/cuda_build.load_host); unfilter_plain is its NumPy twin, which the
tests and chip_smoke.py hold it to.

write_png encodes 8-bit greyscale, greyscale + alpha, RGB and RGBA with
one filter type a row: a given type for every row, a sequence of types,
or by default the type whose filtered row has the least sum of absolute
values (the heuristic of the PNG specification's section 12.8).
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import List, NamedTuple, Sequence, Tuple, Union

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples a pixel, and the bit depths each allows
SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
          6: (8, 16)}
# channels of an 8-bit image -> the colour type write_png gives it
COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}
NONE, SUB, UP, AVERAGE, PAETH = range(5)
# Adam7 passes: (first row, first column, row step, column step)
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
         (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


class Header(NamedTuple):
    height: int
    width: int
    depth: int
    ctype: int
    interlace: int


class Pass(NamedTuple):
    """One pass's filtered rows: `rows` of a filter byte and `stride`
    bytes, `bpp` bytes a pixel for the filters, covering the pixels
    [y0::dy, x0::dx]."""
    y0: int
    x0: int
    dy: int
    dx: int
    rows: int
    cols: int
    stride: int
    bpp: int
    raw: bytes


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


def _header(data: bytes, path: str) -> Header:
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB",
                                                              data)
    if ctype not in DEPTHS:
        raise ValueError(f"{path}: unknown PNG colour type {ctype}")
    if depth not in DEPTHS[ctype]:
        raise ValueError(f"{path}: bit depth {depth} is not allowed with "
                         f"colour type {ctype}")
    if interlace not in (0, 1):
        raise ValueError(f"{path}: unknown interlace method {interlace}")
    if comp or filt:
        raise ValueError(f"{path}: unknown compression or filter method")
    return Header(h, w, depth, ctype, interlace)


def scanlines(buf: bytes, path: str = "<bytes>") -> Tuple[Header,
                                                         List[Pass]]:
    """The header and the inflated IDAT stream cut into its passes (one
    without interlacing, up to seven with Adam7; an empty pass has no
    bytes, not even filter bytes)."""
    head, idat = None, []
    for kind, data in _chunks(buf, path):
        if kind == b"IHDR":
            head = _header(data, path)
        elif kind == b"IDAT":
            idat.append(data)
    if head is None or not idat:
        raise ValueError(f"{path}: no IHDR or no IDAT chunk")
    raw = zlib.decompress(b"".join(idat))
    bits = SAMPLES[head.ctype] * head.depth
    bpp = max(1, bits // 8)
    passes, pos = [], 0
    for y0, x0, dy, dx in (ADAM7 if head.interlace else ((0, 0, 1, 1),)):
        rows = max(0, -(-(head.height - y0) // dy))
        cols = max(0, -(-(head.width - x0) // dx))
        if not rows or not cols:
            continue
        stride = (cols * bits + 7) // 8
        n = rows * (stride + 1)
        passes.append(Pass(y0, x0, dy, dx, rows, cols, stride, bpp,
                           raw[pos:pos + n]))
        pos += n
    if len(raw) != pos:
        raise ValueError(f"{path}: image data holds {len(raw)} bytes, "
                         f"{pos} expected")
    return head, passes


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
    """NumPy twin of csrc/png_unfilter.c: (h, w * c) uint8 scanlines of
    rows of w * c bytes, c bytes a pixel for the filters (w pixels of c
    bytes, or a sub-byte depth's stride w and c = 1).  A
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


def _samples(rows: np.ndarray, cols: int, depth: int, n: int) -> np.ndarray:
    """(r, stride) unfiltered bytes -> (r, cols, n) samples as integers."""
    r = rows.shape[0]
    if depth == 8:
        return rows[:, :cols * n].reshape(r, cols, n)
    if depth == 16:
        return rows[:, :2 * cols * n].view(">u2").reshape(r, cols, n)
    bits = np.unpackbits(rows, axis=1)[:, :cols * n * depth]
    weights = 1 << np.arange(depth - 1, -1, -1)
    vals = bits.reshape(r, cols * n, depth) @ weights
    return vals.reshape(r, cols, n).astype(np.uint8)


def _pil_array(img: np.ndarray, head: Header) -> Tuple[np.ndarray, str]:
    """(h, w, samples) integers as np.asarray of PIL's image, and its
    mode."""
    d, t = head.depth, head.ctype
    if t == 3:
        return img[..., 0].astype(np.uint8), "P"
    if t == 0:
        if d == 1:
            return img[..., 0] != 0, "1"
        if d == 16:
            return img[..., 0].astype(np.uint16), "I;16"
        return (img[..., 0] * (255 // ((1 << d) - 1))).astype(np.uint8), "L"
    if d == 16:
        hi = (img >> 8).astype(np.uint8)
        if t == 4:                                       # LA;16B -> RGBA
            return np.concatenate([hi[..., :1]] * 3 + [hi[..., 1:]], -1), \
                "RGBA"
        return hi, {2: "RGB", 6: "RGBA"}[t]
    return img.astype(np.uint8), {2: "RGB", 4: "LA", 6: "RGBA"}[t]


def decode_image(buf: bytes, path: str = "<bytes>") -> Tuple[np.ndarray,
                                                            str]:
    """The array and the mode PIL gives for a PNG."""
    head, passes = scanlines(buf, path)
    n = SAMPLES[head.ctype]
    img = np.zeros((head.height, head.width, n),
                   np.uint16 if head.depth == 16 else np.uint8)
    for p in passes:
        rows = _unfilter_c(p.raw, p.rows, p.stride // p.bpp, p.bpp, path)
        img[p.y0::p.dy, p.x0::p.dx] = _samples(rows, p.cols, head.depth, n)
    return _pil_array(img, head)


def read_png(path: str) -> np.ndarray:
    """The image as PIL's np.asarray(Image.open(path)) gives it."""
    with open(path, "rb") as f:
        return decode_image(f.read(), path)[0]


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
