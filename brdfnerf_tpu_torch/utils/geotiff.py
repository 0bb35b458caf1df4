"""Self-contained GeoTIFF codec (read + write), NumPy only: the port's copy
of the JAX package's utils/geotiff.py.

The reference delegates raster I/O to rasterio/GDAL (satellite.py:67-80,
eval.py:153-182, sat_utils.py:185-276).  Neither wheel exists in this
image, so the TIFF slice real satellite products use is implemented here
from the TIFF 6.0 / GeoTIFF 1.1 specs:

  * strip AND tile layouts (real Pléiades/WorldView crops are tiled)
  * uncompressed, DEFLATE/zlib, LZW (with early-change), PackBits
  * horizontal predictor (2) for ints and floating-point predictor (3),
    applied per strip/tile segment as libtiff/GDAL produce them
  * uint8/uint16/int16/int32/float32/float64, chunky or planar
  * georeferencing tags: ModelPixelScale, ModelTiepoint, GeoKeyDirectory
    (projected or geographic EPSG), GDAL_NODATA
  * the RPC coefficient tag (50844) that vendor products embed — parsed
    into an rpcm-style dict (the reference reads RPCs via
    rpcm.rpc_from_geotiff in generate_dataset.py:152-163)

A compression outside that slice the JAX package hands to PIL, and so
does read_geotiff here, to read_pixels: the pixels np.asarray(PIL.Image.
open(path)) gives, with no PIL (the card's machine has none), bit for bit
Pillow 12.1's through libtiff 4.7 and libjpeg-turbo 3.1:

  * JPEG (7): photometric 1, 2 and 6, YCbCrSubSampling 1x1, 2x1 and 2x2
    (and whatever the stream's factors are), strips and tiles, planar 1
    and 2, abbreviated streams with JPEGTables (347); utils/jpeg decodes;
    YCbCr converts as libjpeg does where the planes are interleaved and as
    libtiff's TIFFYCbCrToRGB does where they are not;
  * old-style JPEG (6) behind JPEGInterchangeFormat (513/514): libtiff's
    raw planes, replicated, through TIFFYCbCrToRGB;
  * LZMA (34925): an .xz stream a segment (stdlib lzma);
  * CCITT RLE (2), T.4 1-D / 2-D (3) and T.6 (4) bilevel: utils/ccitt;
  * bilevel (1-bit) images under every compression: bool, MSB-first rows
    padded to a byte, WhiteIsZero inverted, FillOrder 2 bit-reversed;
  * Pillow's modes: 8-bit L / LA / RGB / RGBA (WhiteIsZero inverted),
    16-bit grey uint16 (signed: int32), 16-bit RGB(A) as its high bytes,
    32-bit float32 or int32.
ZSTD (50000), WebP (50001) and every other compression raise
UnsupportedTiffFeature naming it; a layout Pillow does not read raises a
ValueError naming the file.  BigTIFF (magic 43,
8-byte offsets, 20-byte IFD entries) is read natively through the same
strip/tile/compression slice; only IFD 0 is consumed (later IFDs in
GDAL products are reduced overviews).  Writes stay classic TIFF.

API (shapes follow rasterio conventions):
  read_geotiff(path)  -> (array (bands, H, W), GeoProfile)
  read_pixels(path)   -> the array PIL gives ((H, W) or (H, W, bands))
  write_geotiff(path, array, profile)
  GeoProfile: ulx/uly (upper-left corner), xres/yres (yres > 0, applied
  as -yres going down), epsg, nodata, rpc (optional rpcm-style dict).
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

# TIFF tag ids
_T_WIDTH, _T_HEIGHT = 256, 257
_T_BITS, _T_COMPRESSION, _T_PHOTOMETRIC = 258, 259, 262
_T_FILL_ORDER, _T_T4_OPTIONS = 266, 292
_T_STRIP_OFFSETS, _T_SPP, _T_ROWS_PER_STRIP, _T_STRIP_COUNTS = 273, 277, 278, 279
_T_PLANAR, _T_PREDICTOR = 284, 317
_T_TILE_W, _T_TILE_H, _T_TILE_OFFSETS, _T_TILE_COUNTS = 322, 323, 324, 325
_T_EXTRA_SAMPLES, _T_SAMPLE_FORMAT = 338, 339
_T_JPEG_TABLES = 347
_T_JPEG_IF, _T_JPEG_IF_LEN = 513, 514
_T_YCBCR_COEFS, _T_YCBCR_SUB, _T_REF_BW = 529, 530, 532
_T_PIXEL_SCALE, _T_TIEPOINT = 33550, 33922
_T_GEO_KEYS, _T_GEO_DOUBLES, _T_GEO_ASCII = 34735, 34736, 34737
_T_NODATA = 42113
_T_RPC = 50844   # RPCCoefficientTag: 92 doubles (see _rpc_dict_from_tag)

# compressions read_geotiff decodes itself, as the JAX package does, and
# those it reads as PIL would (read_pixels); the ones refused are named
NATIVE = {1, 5, 8, 32946, 32773}
PIL_ONLY = {2: "CCITT modified Huffman RLE", 3: "CCITT T.4", 4: "CCITT T.6",
            6: "old-style JPEG", 7: "JPEG", 34925: "LZMA"}
REFUSED = {50000: "ZSTD", 50001: "WebP", 34887: "LERC", 34892: "lossy JPEG",
           32771: "CCITT RLEW", 32809: "ThunderScan", 32908: "Pixar log",
           34676: "SGI log", 34712: "JPEG 2000"}

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
               10: 8, 11: 4, 12: 8, 13: 4, 16: 8, 17: 8, 18: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f",
             12: "d", 13: "I", 16: "Q", 17: "q", 18: "Q"}


@dataclass
class GeoProfile:
    width: int = 0
    height: int = 0
    count: int = 1
    dtype: str = "float32"
    ulx: float = 0.0        # upper-left pixel corner X (easting)
    uly: float = 0.0        # upper-left pixel corner Y (northing)
    xres: float = 1.0
    yres: float = 1.0       # positive; row step is -yres
    epsg: Optional[int] = None
    nodata: Optional[float] = None
    rpc: Optional[dict] = None   # rpcm-style dict from tag 50844, if present

    @property
    def geotransform(self):
        """GDAL-ordered (ulx, xres, 0, uly, 0, -yres)."""
        return (self.ulx, self.xres, 0.0, self.uly, 0.0, -self.yres)


def utm_epsg(zone: int, northern: bool) -> int:
    return (32600 if northern else 32700) + int(zone)


# ------------------------------------------------------------------- reader

def _read_ifd_entries(buf, off, endian, big: bool = False):
    """Parse one IFD: classic (2-byte count, 12-byte entries, u32
    offsets) or BigTIFF (8-byte count, 20-byte entries, u64 offsets —
    TIFF Technical Note: BigTIFF)."""
    if big:
        n = struct.unpack(endian + "Q", buf[off:off + 8])[0]
        base, esz, inline, off_fmt = off + 8, 20, 8, "Q"
    else:
        n = struct.unpack(endian + "H", buf[off:off + 2])[0]
        base, esz, inline, off_fmt = off + 2, 12, 4, "I"
    entries = {}
    for i in range(n):
        e = base + esz * i
        tag, typ = struct.unpack(endian + "HH", buf[e:e + 4])
        count = struct.unpack(endian + off_fmt, buf[e + 4:e + 4 + inline])[0]
        val_at = e + 4 + inline
        size = _TYPE_SIZES.get(typ, 1) * count
        if size <= inline:
            raw = buf[val_at:val_at + size]
        else:
            ptr = struct.unpack(endian + off_fmt,
                                buf[val_at:val_at + inline])[0]
            raw = buf[ptr:ptr + size]
        if typ in _TYPE_FMT:
            vals = struct.unpack(endian + _TYPE_FMT[typ] * count, raw)
        elif typ == 5:   # RATIONAL
            ints = struct.unpack(endian + "I" * (2 * count), raw)
            vals = tuple(ints[2 * j] / max(ints[2 * j + 1], 1)
                         for j in range(count))
        elif typ == 2:   # ASCII
            vals = (raw.rstrip(b"\0").decode("ascii", "replace"),)
        else:
            vals = (raw,)
        entries[tag] = vals
    next_off = struct.unpack(
        endian + off_fmt, buf[base + esz * n:base + esz * n + inline])[0]
    return entries, next_off


def _np_dtype(bits: int, fmt: int, endian: str, path: str = "<tiff>"):
    if bits not in (8, 16, 32, 64):
        raise ValueError(
            f"{path}: {bits}-bit samples: read_geotiff reads 8-, 16-, 32- "
            f"and 64-bit samples (a bilevel mask reads with read_pixels)")
    kind = {1: "u", 2: "i", 3: "f"}.get(fmt, "u")
    return np.dtype(f"{endian if endian == '<' else '>'}{kind}{bits // 8}")


def _lzw_decode(data: bytes) -> bytes:
    """TIFF-variant LZW (TIFF 6.0 §13): MSB-first bitstream, 9->12 bit
    codes, ClearCode=256, EOI=257, 'early change' (the code width grows
    one code EARLIER than plain LZW — when the table holds 2^n - 1
    entries).  State resets per strip/tile, so callers decode segments
    independently."""
    CLEAR, EOI = 256, 257
    base = [bytes([i]) for i in range(256)] + [b"", b""]
    table = list(base)
    out = bytearray()
    bitbuf = 0
    bitcnt = 0
    nbits = 9
    prev: Optional[bytes] = None
    for byte in data:
        bitbuf = (bitbuf << 8) | byte
        bitcnt += 8
        while bitcnt >= nbits:
            code = (bitbuf >> (bitcnt - nbits)) & ((1 << nbits) - 1)
            bitcnt -= nbits
            if code == EOI:
                return bytes(out)
            if code == CLEAR:
                table = list(base)
                nbits = 9
                prev = None
                continue
            if prev is None:
                entry = table[code]
            elif code < len(table):
                entry = table[code]
                table.append(prev + entry[:1])
            else:           # the KwKwK case
                entry = prev + prev[:1]
                table.append(entry)
            out += entry
            prev = entry
            if len(table) >= (1 << nbits) - 1 and nbits < 12:
                nbits += 1
    return bytes(out)


def _packbits_decode(data: bytes, expected: int) -> bytes:
    """PackBits RLE (TIFF 6.0 §9)."""
    out = bytearray()
    i = 0
    n = len(data)
    while i < n and len(out) < expected:
        hdr = data[i]
        i += 1
        if hdr < 128:                       # literal run of hdr+1 bytes
            out += data[i:i + hdr + 1]
            i += hdr + 1
        elif hdr > 128:                     # repeat next byte 257-hdr times
            out += data[i:i + 1] * (257 - hdr)
            i += 1
        # hdr == 128: no-op
    return bytes(out)


class UnsupportedTiffFeature(ValueError):
    """A structurally valid TIFF uses a feature outside what the port
    decodes (ZSTD or WebP compression, a progressive JPEG, ...); any other
    error (truncated strip, bad LZW stream, short buffer) is a corrupt
    file.  In read_geotiff it marks, as in the JAX package, a compression
    outside the native slice, whose pixels then come from read_pixels."""


def _compression_name(comp: int) -> str:
    name = PIL_ONLY.get(comp) or REFUSED.get(comp)
    return f"compression {comp} ({name})" if name else f"compression {comp}"


def _decode_segment(raw: bytes, comp: int, path: str,
                    expected: int) -> bytes:
    if comp == 1:
        return raw
    if comp in (8, 32946):                  # DEFLATE (new + old code)
        return zlib.decompress(raw)
    if comp == 5:                           # LZW
        return _lzw_decode(raw)
    if comp == 32773:                       # PackBits
        return _packbits_decode(raw, expected)
    raise UnsupportedTiffFeature(
        f"{path}: TIFF {_compression_name(comp)} is not supported (none, "
        f"LZW, DEFLATE and PackBits are)")


def _decode_segment_pil(raw: bytes, comp: int, path: str,
                        expected: int) -> bytes:
    """_decode_segment plus LZMA, which PIL's libtiff reads (imported
    here: a Python built without liblzma still reads every other TIFF)."""
    if comp == 34925:
        import lzma
        return lzma.decompress(raw)
    return _decode_segment(raw, comp, path, expected)


def _unpredict(seg: np.ndarray, predictor: int, dt: np.dtype) -> np.ndarray:
    """Undo the TIFF predictor on one decoded segment (rows, width, spp).

    Predictor 2 (horizontal differencing) accumulates per channel across
    the segment's width with modular wraparound; predictor 3 (floating
    point, TechNote 3) byte-accumulates each row then reassembles the
    byte-plane-major (MSB plane first) layout into native floats.  The
    predictor resets at every segment, which is why the caller applies it
    per strip/tile BEFORE assembling the canvas."""
    if predictor == 2:
        return np.cumsum(seg.astype(np.int64), axis=1).astype(dt)
    if predictor == 3:
        rows, w, spp = seg.shape
        bps = dt.itemsize
        rb = np.ascontiguousarray(seg).view(np.uint8).reshape(rows, w * spp * bps)
        rb = np.cumsum(rb.astype(np.uint32), axis=1).astype(np.uint8)
        planes = rb.reshape(rows, bps, w * spp)          # plane 0 = MSB
        be = planes.transpose(0, 2, 1)                   # (rows, w*spp, bps)
        flat = np.ascontiguousarray(be).reshape(rows, w * spp * bps)
        vals = flat.view(np.dtype(f">{dt.kind}{bps}"))
        return vals.reshape(rows, w, spp).astype(dt.newbyteorder("="))
    return seg


def _segments(tags, path, w, h, planar):
    """Every strip or tile: (offset, byte count, band group, y0, x0, coded
    rows, coded columns).  A tile is coded at its full size (the edge tiles
    too); a strip has the image's width and its rows (the last strip
    short)."""
    if _T_TILE_OFFSETS in tags:
        tw = tags[_T_TILE_W][0]
        th = tags[_T_TILE_H][0]
        tiles_x = (w + tw - 1) // tw
        tiles_y = (h + th - 1) // th
        for i, (o, c) in enumerate(zip(tags[_T_TILE_OFFSETS],
                                       tags[_T_TILE_COUNTS])):
            g, rem = divmod(i, tiles_y * tiles_x)
            ty, tx = divmod(rem, tiles_x)
            yield o, c, g, ty * th, tx * tw, th, tw
        return
    if _T_STRIP_OFFSETS not in tags:
        # neither strips nor tiles: e.g. old-style JPEG TIFF carrying the
        # pixel data behind JPEGInterchangeFormat (tag 513): a clear error
        # instead of a bare KeyError.
        raise UnsupportedTiffFeature(
            f"{path}: no StripOffsets/TileOffsets in the first IFD "
            f"(old-style JPEG layout?)")
    rows_per_strip = tags.get(_T_ROWS_PER_STRIP, (h,))[0]
    strips_per_band = (h + rows_per_strip - 1) // rows_per_strip
    for i, (o, c) in enumerate(zip(tags[_T_STRIP_OFFSETS],
                                   tags[_T_STRIP_COUNTS])):
        g, band_row = divmod(i, strips_per_band) if planar == 2 else (0, i)
        rows = min(rows_per_strip, h - band_row * rows_per_strip)
        yield o, c, g, band_row * rows_per_strip, 0, rows, w


def _assemble(buf, tags, path, w, h, spp, planar, dt, decode) -> np.ndarray:
    """Decode strips or tiles into an (h, w, spp) array (chunky) or
    (spp, h, w) (planar).  decode(raw, rows, cols, seg_spp) gives one
    segment's (rows, cols, seg_spp) array at its coded size."""
    seg_spp = 1 if planar == 2 else spp
    canvas = np.zeros((spp if planar == 2 else 1, h, w, seg_spp), dtype=dt)
    for o, c, g, y0, x0, rows, cols in _segments(tags, path, w, h, planar):
        seg = decode(buf[o:o + c], rows, cols, seg_spp)
        ny = min(rows, h - y0)
        nx = min(cols, w - x0)
        canvas[g, y0:y0 + ny, x0:x0 + nx] = seg[:ny, :nx]
    if planar == 2:
        return canvas[:, :, :, 0]                        # (spp, h, w)
    return canvas[0]                                     # (h, w, spp)


def _assemble_pixels(buf, tags, path, w, h, spp, dt, comp,
                     planar, predictor, decode_bytes=_decode_segment
                     ) -> np.ndarray:
    """Decode strips or tiles of whole-byte samples into an (h, w, spp)
    array (chunky) or (spp, h, w) (planar), with the predictor undone per
    segment."""
    def decode(raw, rows, cols, seg_spp):
        n = rows * cols * seg_spp
        data = decode_bytes(raw, comp, path, n * dt.itemsize)
        seg = np.frombuffer(data, dtype=dt, count=n).copy()
        return _unpredict(seg.reshape(rows, cols, seg_spp), predictor, dt)
    return _assemble(buf, tags, path, w, h, spp, planar, dt, decode)


def _rpc_dict_from_tag(vals) -> dict:
    """Tag 50844 (RPCCoefficientTag): 92 doubles in the order
    ERR_BIAS, ERR_RAND, LINE_OFF, SAMP_OFF, LAT_OFF, LONG_OFF, HEIGHT_OFF,
    LINE_SCALE, SAMP_SCALE, LAT_SCALE, LONG_SCALE, HEIGHT_SCALE, then
    LINE_NUM(20), LINE_DEN(20), SAMP_NUM(20), SAMP_DEN(20) — mapped to the
    rpcm-style dict the dataset JSONs carry (LINE=row, SAMP=col)."""
    v = [float(x) for x in vals]
    if len(v) != 92:
        raise ValueError(f"RPC tag holds {len(v)} values, expected 92")
    return {
        "row_offset": v[2], "col_offset": v[3],
        "lat_offset": v[4], "lon_offset": v[5], "alt_offset": v[6],
        "row_scale": v[7], "col_scale": v[8],
        "lat_scale": v[9], "lon_scale": v[10], "alt_scale": v[11],
        "row_num": v[12:32], "row_den": v[32:52],
        "col_num": v[52:72], "col_den": v[72:92],
    }


def read_tiff_header(path: str, buf: bytes):
    """Validate the TIFF header and parse the first IFD.

    Returns (endian, tags).  ONE implementation for every consumer of the
    classic-TIFF container (read_geotiff here, geo/rpc's IFD-only RPC tag
    reader) so header handling — endianness, the BigTIFF rejection
    message, future format support — cannot drift between them."""
    if buf[:2] == b"II":
        endian = "<"
    elif buf[:2] == b"MM":
        endian = ">"
    else:
        raise ValueError(f"{path}: not a TIFF")
    magic = struct.unpack(endian + "H", buf[2:4])[0]
    if magic == 42:                               # classic TIFF
        ifd_off = struct.unpack(endian + "I", buf[4:8])[0]
        big = False
    elif magic == 43:                             # BigTIFF
        off_size, reserved = struct.unpack(endian + "HH", buf[4:8])
        if off_size != 8 or reserved != 0:
            raise ValueError(
                f"{path}: BigTIFF with offset size {off_size} (reserved "
                f"{reserved}) — only the standard 8-byte layout exists")
        ifd_off = struct.unpack(endian + "Q", buf[8:16])[0]
        big = True
    else:
        raise ValueError(f"{path}: not a TIFF (magic {magic})")
    # first IFD only: in GDAL/libtiff products later IFDs are reduced
    # overviews; the full-resolution raster is IFD 0
    tags, _ = _read_ifd_entries(buf, ifd_off, endian, big=big)
    return endian, tags


# ------------------------------------------------------- PIL's pixels

_BITREV = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _fill_order(raw: bytes, tags) -> bytes:
    """FillOrder 2 (least significant bit first): libtiff reverses the
    bits of every raw byte before it decodes the segment."""
    if tags.get(_T_FILL_ORDER, (1,))[0] == 2:
        return _BITREV[np.frombuffer(raw, np.uint8)].tobytes()
    return raw


def _bilevel_pixels(buf, tags, path, w, h, comp) -> np.ndarray:
    """A 1-bit image as PIL's mode "1": bool (h, w), True where the sample
    is 1 (BlackIsZero) or 0 (WhiteIsZero, photometric 0)."""
    if tags.get(_T_SPP, (1,))[0] != 1:
        raise ValueError(f"{path}: 1-bit samples with several bands "
                         f"(PIL reads one)")
    planar = tags.get(_T_PLANAR, (1,))[0]

    def decode(raw, rows, cols, _):
        raw = _fill_order(raw, tags)
        stride = (cols + 7) // 8
        if comp in (2, 3, 4):
            from .ccitt import decode as ccitt_decode
            data = ccitt_decode(raw, rows, cols, comp,
                                tags.get(_T_T4_OPTIONS, (0,))[0])
        else:
            data = _decode_segment_pil(raw, comp, path, rows * stride)
        if len(data) < rows * stride:
            raise ValueError(f"{path}: a 1-bit segment holds {len(data)} "
                             f"bytes, {rows * stride} expected")
        packed = np.frombuffer(data, np.uint8, rows * stride)
        bits = np.unpackbits(packed.reshape(rows, stride), axis=1)
        return bits[:, :cols, None].astype(bool)

    arr = _assemble(buf, tags, path, w, h, 1, planar, bool, decode)
    arr = arr[0] if planar == 2 else arr[..., 0]
    if tags.get(_T_PHOTOMETRIC, (1,))[0] == 0:
        arr = ~arr
    return arr


def _pil_layout(arr, bits, fmt, tags, path) -> np.ndarray:
    """Whole-byte samples (h, w, spp) as np.asarray of PIL's mode for
    them (TiffImagePlugin's OPEN_INFO)."""
    spp = arr.shape[-1]
    photometric = tags.get(_T_PHOTOMETRIC, (1,))[0]
    extra = tags.get(_T_EXTRA_SAMPLES, ())
    if bits == 8 and fmt == 1:
        if spp == 1:
            return 255 - arr[..., 0] if photometric == 0 else arr[..., 0]
        if spp == 2 and extra:
            return arr                                   # LA
        if spp == 3 or (spp == 4 and tuple(extra) != (1,)):
            return arr                                   # RGB, RGBA
    elif bits == 16 and fmt in (1, 2) and spp == 1:
        return arr[..., 0].astype(np.uint16 if fmt == 1 else np.int32)
    elif bits == 16 and fmt == 1 and spp in (3, 4):
        return (arr >> 8).astype(np.uint8)               # RGB;16, RGBA;16
    elif bits == 32 and spp == 1:
        a = arr[..., 0]
        return a.astype(np.float32) if fmt == 3 else a.view(np.int32)
    raise ValueError(f"{path}: PIL reads no {bits}-bit sample format {fmt} "
                     f"image of {spp} bands (extra samples {tuple(extra)})")


def _ycbcr_tables(tags):
    """libtiff's TIFFYCbCrToRGBInit (tif_color.c): float32 luma and
    ReferenceBlackWhite, 16-bit fixed point -> Y, Cr->R, Cb->B, Cr->G,
    Cb->G tables."""
    f32 = np.float32
    luma = [f32(v) for v in tags.get(_T_YCBCR_COEFS, (0.299, 0.587, 0.114))]
    bits = tags.get(_T_BITS, (8,))[0]
    rbw = [f32(v) for v in tags.get(
        _T_REF_BW, (0, (1 << bits) - 1, 1 << (bits - 1), (1 << bits) - 1,
                    1 << (bits - 1), (1 << bits) - 1))]

    def fix(v):
        return int(np.float64(f32(min(max(v, f32(0)), f32(2)))
                              * f32(65536)) + 0.5)

    def code2v(c, rb, rw, cr):
        d = rw - rb
        return (f32(c - int(rb)) * f32(cr)) / (d if d != 0 else f32(1))

    def clampw(v):
        return int(min(max(v, f32(-128 * 32)), f32(128 * 32)))

    lr, lg, lb = luma
    f1 = f32(2) - f32(2) * lr
    f3 = f32(2) - f32(2) * lb
    d1, d2 = fix(f1), -fix(lr * f1 / lg)
    d3, d4 = fix(f3), -fix(lb * f3 / lg)
    x = np.arange(256) - 128
    cr = np.array([clampw(code2v(v, rbw[4] - f32(128), rbw[5] - f32(128),
                                 127)) for v in x], np.int64)
    cb = np.array([clampw(code2v(v, rbw[2] - f32(128), rbw[3] - f32(128),
                                 127)) for v in x], np.int64)
    y = np.array([clampw(code2v(v + 128, rbw[0], rbw[1], 255)) for v in x],
                 np.int64)
    return (y, (d1 * cr + 32768) >> 16, (d3 * cb + 32768) >> 16, d2 * cr,
            d4 * cb + 32768)


def _libtiff_ycbcr(yc, cb, cr, tags) -> np.ndarray:
    """Full-resolution Y, Cb, Cr planes to RGB by TIFFYCbCrtoRGB."""
    y_tab, cr_r, cb_b, cr_g, cb_g = _ycbcr_tables(tags)
    y = y_tab[yc]
    rgb = np.stack([y + cr_r[cr], y + ((cb_g[cb] + cr_g[cr]) >> 16),
                    y + cb_b[cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _jpeg_pixels(buf, tags, path, w, h, spp) -> np.ndarray:
    """Compression 7: each strip or tile a JPEG stream (abbreviated, its
    tables in JPEGTables), as libtiff's tif_jpeg decodes it for PIL."""
    from . import jpeg
    photometric = tags.get(_T_PHOTOMETRIC, (1,))[0]
    planar = tags.get(_T_PLANAR, (1,))[0]
    tables = tags.get(_T_JPEG_TABLES, (b"",))[0]
    if not isinstance(tables, bytes):
        tables = bytes(tags[_T_JPEG_TABLES])
    if photometric not in (1, 2, 6) or spp not in (1, 3):
        raise UnsupportedTiffFeature(
            f"{path}: JPEG compression with photometric {photometric} and "
            f"{spp} bands is not supported (photometric 1, 2 and 6)")
    # without the tag, libtiff takes the first stream's factors
    sub = tuple(tags[_T_YCBCR_SUB][:2]) if _T_YCBCR_SUB in tags else None
    ycc = photometric == 6 and planar == 1
    if photometric == 6 and planar == 2 and (sub or (2, 2)) != (1, 1):
        raise ValueError(f"{path}: separate YCbCr planes subsampled "
                         f"{sub or (2, 2)} (PIL reads 1 x 1 only)")
    seg_spp = 1 if planar == 2 else spp
    tiled = _T_TILE_OFFSETS in tags
    per_strip = tags.get(_T_ROWS_PER_STRIP, (h,))[0]

    def decode(raw, rows, cols, _):
        raw = _fill_order(raw, tags)
        frame = jpeg.parse(raw, tables, entropy=False)
        first = (frame.comps[0].h, frame.comps[0].v)
        want = (sub or first) if ycc else (1, 1)
        if (first[0] > want[0] or first[1] > want[1]
                or any((c.h, c.v) != (1, 1) for c in frame.comps[1:])):
            raise ValueError(
                f"{path}: JPEG sampling factors "
                f"{[(c.h, c.v) for c in frame.comps]} where libtiff takes "
                f"{want} for the first component and 1 x 1 for the rest")
        if len(frame.comps) != seg_spp:
            raise ValueError(f"{path}: a JPEG segment of "
                             f"{len(frame.comps)} components, {seg_spp} "
                             f"expected")
        short = not tiled and rows < per_strip      # the last strip
        if frame.width != cols or frame.height < rows or (
                frame.height > rows and not short):
            raise ValueError(f"{path}: JPEG segment of {frame.width} x "
                             f"{frame.height}, {cols} x {rows} expected")
        img = jpeg.decode(raw, tables, ycc)
        return img.reshape(img.shape[0], img.shape[1], -1)

    arr = _assemble(buf, tags, path, w, h, spp, planar, np.uint8, decode)
    if planar == 2:
        arr = arr.transpose(1, 2, 0)
        if photometric == 6:
            return _libtiff_ycbcr(arr[..., 0], arr[..., 1], arr[..., 2], tags)
    return arr[..., 0] if spp == 1 else arr


def _ojpeg_pixels(buf, tags, path, w, h, spp) -> np.ndarray:
    """Compression 6: a whole JPEG stream behind JPEGInterchangeFormat
    (513/514), or else in the strips' bytes, which libtiff's OJPEG decodes
    to raw planes (no upsampling, no colour conversion).  PIL reads one
    greyscale plane (1 x 1 sampling) as it is, and YCbCr planes through
    TIFFReadRGBA: chroma replicated over the stream's sampling unit
    (whatever YCbCrSubSampling says), TIFFYCbCrtoRGB."""
    from . import jpeg
    photometric = tags.get(_T_PHOTOMETRIC, (1,))[0]
    if _T_JPEG_IF in tags:
        off = tags[_T_JPEG_IF][0]
        n = tags.get(_T_JPEG_IF_LEN, (len(buf) - off,))[0]
        stream = buf[off:off + n]
    else:
        stream = b"".join(buf[o:o + c] for o, c, *_ in _segments(
            tags, path, w, h, 1))
    stream = _fill_order(stream, tags)
    frame = jpeg.parse(stream, entropy=False)
    grey = spp == 1 and photometric == 1 and len(frame.comps) == 1 and (
        frame.comps[0].h, frame.comps[0].v) == (1, 1)
    ycc = spp == 3 and photometric == 6 and len(frame.comps) == 3
    if not (grey or ycc) or frame.width < w or frame.height < h:
        raise ValueError(
            f"{path}: an old-style JPEG of photometric {photometric} and "
            f"{spp} bands holding {len(frame.comps)} components sampled "
            f"{[(c.h, c.v) for c in frame.comps]} at {frame.width} x "
            f"{frame.height}: PIL reads none such")
    planes = jpeg.raw_planes(stream)
    if grey:
        return planes[0][:h, :w]
    full = [np.repeat(np.repeat(p, frame.vmax // c.v, 0), frame.hmax // c.h,
                      1)[:h, :w] for p, c in zip(planes, frame.comps)]
    return _libtiff_ycbcr(*full, tags)


def _pixels(path, buf, endian, tags) -> np.ndarray:
    w = tags[_T_WIDTH][0]
    h = tags[_T_HEIGHT][0]
    spp = tags.get(_T_SPP, (1,))[0]
    bits = tags.get(_T_BITS, (1,))[0]           # TIFF's default, as PIL's
    fmt = tags.get(_T_SAMPLE_FORMAT, (1,))[0]
    comp = tags.get(_T_COMPRESSION, (1,))[0]
    if comp not in NATIVE and comp not in PIL_ONLY:
        raise UnsupportedTiffFeature(
            f"{path}: TIFF {_compression_name(comp)} is not supported (none, "
            f"LZW, DEFLATE, PackBits, LZMA, JPEG, old-style JPEG and CCITT "
            f"RLE, T.4 and T.6 are)")
    if bits == 1:
        return _bilevel_pixels(buf, tags, path, w, h, comp)
    if comp in (2, 3, 4):
        raise ValueError(f"{path}: CCITT compression of {bits}-bit samples")
    if comp == 6:
        return _ojpeg_pixels(buf, tags, path, w, h, spp)
    if comp == 7:
        if bits != 8:
            raise UnsupportedTiffFeature(
                f"{path}: JPEG compression of {bits}-bit samples is not "
                f"supported (8-bit only)")
        return _jpeg_pixels(buf, tags, path, w, h, spp)
    planar = tags.get(_T_PLANAR, (1,))[0]
    dt = _np_dtype(bits, fmt, endian, path)

    def decode_bytes(raw, comp, path, expected):
        return _decode_segment_pil(_fill_order(raw, tags), comp, path,
                                   expected)
    arr = _assemble_pixels(buf, tags, path, w, h, spp, dt, comp,
                           planar, tags.get(_T_PREDICTOR, (1,))[0],
                           decode_bytes)
    if planar == 2:
        arr = arr.transpose(1, 2, 0)
    return _pil_layout(arr.astype(arr.dtype.newbyteorder("=")), bits, fmt,
                       tags, path)


def read_pixels(path: str) -> np.ndarray:
    """The array np.asarray(PIL.Image.open(path)) gives for a TIFF: bool
    (H, W) for a bilevel image, (H, W) or (H, W, bands) in PIL's dtype
    for the rest (see the module's docstring)."""
    with open(path, "rb") as f:
        buf = f.read()
    endian, tags = read_tiff_header(path, buf)
    return _pixels(path, buf, endian, tags)


def read_geotiff(path: str) -> Tuple[np.ndarray, GeoProfile]:
    with open(path, "rb") as f:
        buf = f.read()
    endian, tags = read_tiff_header(path, buf)

    w = tags[_T_WIDTH][0]
    h = tags[_T_HEIGHT][0]
    spp = tags.get(_T_SPP, (1,))[0]
    bits = tags.get(_T_BITS, (8,))[0]
    fmt = tags.get(_T_SAMPLE_FORMAT, (1,))[0]
    comp = tags.get(_T_COMPRESSION, (1,))[0]
    planar = tags.get(_T_PLANAR, (1,))[0]
    predictor = tags.get(_T_PREDICTOR, (1,))[0]
    dt = _np_dtype(bits, fmt, endian, path)

    try:
        arr = _assemble_pixels(buf, tags, path, w, h, spp, dt,
                               comp, planar, predictor)
        if arr.ndim == 3 and planar != 2:
            arr = arr.transpose(2, 0, 1)                 # -> (bands, h, w)
    except UnsupportedTiffFeature:
        # outside the native slice (JPEG-in-TIFF, LZMA, ...): the pixels PIL
        # gives, as the JAX package reads them; geo tags come from the IFD
        a = _pixels(path, buf, endian, tags)
        arr = a[None] if a.ndim == 2 else a.transpose(2, 0, 1)
    except ValueError as e:
        if _T_BITS in tags:
            raise
        # as the JAX package, 8 bits a sample without the tag, which then
        # fails; TIFF's default is 1 bit
        raise ValueError(
            f"{path}: no BitsPerSample tag, so 1-bit samples (TIFF's "
            f"default), which read_geotiff does not read (read_pixels "
            f"does)") from e

    prof = GeoProfile(width=w, height=h, count=int(arr.shape[0]),
                      dtype=np.dtype(dt.str[1:]).name)
    if _T_PIXEL_SCALE in tags:
        sx, sy = tags[_T_PIXEL_SCALE][0], tags[_T_PIXEL_SCALE][1]
        prof.xres, prof.yres = float(sx), float(sy)
    if _T_TIEPOINT in tags:
        tp = tags[_T_TIEPOINT]
        # (i, j, k, X, Y, Z): raster point -> model point
        prof.ulx = float(tp[3]) - float(tp[0]) * prof.xres
        prof.uly = float(tp[4]) + float(tp[1]) * prof.yres
    if _T_GEO_KEYS in tags:
        keys = tags[_T_GEO_KEYS]
        n_keys = keys[3]
        for i in range(1, n_keys + 1):
            kid, loc, cnt, val = keys[4 * i:4 * i + 4]
            if kid == 3072 and loc == 0:   # ProjectedCSTypeGeoKey
                prof.epsg = int(val)
            elif kid == 2048 and loc == 0 and prof.epsg is None:
                prof.epsg = int(val)       # GeographicTypeGeoKey
    if _T_NODATA in tags:
        try:
            prof.nodata = float(tags[_T_NODATA][0])
        except (TypeError, ValueError):
            pass
    if _T_RPC in tags:
        prof.rpc = _rpc_dict_from_tag(tags[_T_RPC])
    arr = arr.astype(arr.dtype.newbyteorder("="))
    return arr, prof


# ------------------------------------------------------------------- writer

def _pack_entry(endian, tag, typ, vals, heap, heap_base):
    count = len(vals)
    if typ == 2:   # ASCII: vals is a bytes payload
        payload = vals
        count = len(payload)
    else:
        payload = struct.pack(endian + _TYPE_FMT[typ] * count, *vals)
    if len(payload) <= 4:
        payload = payload.ljust(4, b"\0")
        return struct.pack(endian + "HHI", tag, typ, count) + payload, heap
    ptr = heap_base + len(heap)
    return (struct.pack(endian + "HHII", tag, typ, count, ptr),
            heap + payload.ljust((len(payload) + 1) // 2 * 2, b"\0"))


def write_geotiff(path: str, array: np.ndarray, profile: GeoProfile = None,
                  nodata: Optional[float] = None):
    """Write (bands, H, W) or (H, W) array as an uncompressed GeoTIFF.
    Parent directories are created (src ids may carry path separators,
    e.g. blender frame file_paths like './val/r_0')."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    arr = np.asarray(array)
    if arr.ndim == 2:
        arr = arr[None]
    bands, h, w = arr.shape
    prof = profile or GeoProfile()
    if nodata is None:
        nodata = prof.nodata

    dt = arr.dtype
    if dt.kind == "f":
        fmt = 3
    elif dt.kind == "i":
        fmt = 2
    else:
        fmt = 1
    bits = dt.itemsize * 8
    endian = "<"
    pix = arr.transpose(1, 2, 0).astype(dt.newbyteorder("<")).tobytes()

    entries = []   # (tag, typ, vals)
    entries.append((_T_WIDTH, 4, (w,)))
    entries.append((_T_HEIGHT, 4, (h,)))
    entries.append((_T_BITS, 3, (bits,) * bands))
    entries.append((_T_COMPRESSION, 3, (1,)))
    entries.append((_T_PHOTOMETRIC, 3, (2 if bands >= 3 else 1,)))
    entries.append((_T_SPP, 3, (bands,)))
    entries.append((_T_ROWS_PER_STRIP, 4, (h,)))
    entries.append((_T_STRIP_COUNTS, 4, (len(pix),)))
    entries.append((_T_PLANAR, 3, (1,)))
    entries.append((_T_SAMPLE_FORMAT, 3, (fmt,) * bands))
    has_geo = prof.xres != 1.0 or prof.ulx != 0.0 or prof.epsg is not None
    if has_geo:
        entries.append((_T_PIXEL_SCALE, 12,
                        (float(prof.xres), float(prof.yres), 0.0)))
        entries.append((_T_TIEPOINT, 12,
                        (0.0, 0.0, 0.0, float(prof.ulx), float(prof.uly), 0.0)))
        epsg = prof.epsg or 32601
        # GTModelTypeGeoKey=1 (projected), GTRasterTypeGeoKey=1 (PixelIsArea),
        # ProjectedCSTypeGeoKey=epsg, ProjLinearUnitsGeoKey=9001 (metre)
        entries.append((_T_GEO_KEYS, 3, (
            1, 1, 0, 4,
            1024, 0, 1, 1,
            1025, 0, 1, 1,
            3072, 0, 1, int(epsg),
            3076, 0, 1, 9001)))
    if nodata is not None:
        nd = (f"{nodata:g}").encode("ascii") + b"\0"
        entries.append((_T_NODATA, 2, nd))
    if prof.rpc is not None:
        r = prof.rpc
        rpc_vals = ([0.0, 0.0,
                     float(r["row_offset"]), float(r["col_offset"]),
                     float(r["lat_offset"]), float(r["lon_offset"]),
                     float(r["alt_offset"]),
                     float(r["row_scale"]), float(r["col_scale"]),
                     float(r["lat_scale"]), float(r["lon_scale"]),
                     float(r["alt_scale"])]
                    + [float(x) for x in r["row_num"]]
                    + [float(x) for x in r["row_den"]]
                    + [float(x) for x in r["col_num"]]
                    + [float(x) for x in r["col_den"]])
        entries.append((_T_RPC, 12, tuple(rpc_vals)))
    entries.append((_T_STRIP_OFFSETS, 4, (0,)))   # patched below
    entries.sort(key=lambda e: e[0])

    n = len(entries)
    ifd_off = 8
    ifd_size = 2 + 12 * n + 4
    heap_base = ifd_off + ifd_size
    heap = b""
    packed = []
    strip_entry_idx = None
    for i, (tag, typ, vals) in enumerate(entries):
        if tag == _T_STRIP_OFFSETS:
            strip_entry_idx = i
        b, heap = _pack_entry(endian, tag, typ, vals, heap, heap_base)
        packed.append(b)
    data_off = heap_base + len(heap)
    # patch the strip offset value in place
    b, _ = _pack_entry(endian, _T_STRIP_OFFSETS, 4, (data_off,), b"", 0)
    packed[strip_entry_idx] = b

    with open(path, "wb") as f:
        f.write(struct.pack(endian + "2sHI", b"II", 42, ifd_off))
        f.write(struct.pack(endian + "H", n))
        f.write(b"".join(packed))
        f.write(struct.pack(endian + "I", 0))   # next IFD
        f.write(heap)
        f.write(pix)
    return path
