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

A compression outside that slice (e.g. JPEG-in-TIFF, which the JAX
package hands to PIL) raises UnsupportedTiffFeature naming it: the port
reads no image through PIL.  BigTIFF (magic 43,
8-byte offsets, 20-byte IFD entries) is read natively through the same
strip/tile/compression slice; only IFD 0 is consumed (later IFDs in
GDAL products are reduced overviews).  Writes stay classic TIFF.

API (shapes follow rasterio conventions):
  read_geotiff(path)  -> (array (bands, H, W), GeoProfile)
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
_T_STRIP_OFFSETS, _T_SPP, _T_ROWS_PER_STRIP, _T_STRIP_COUNTS = 273, 277, 278, 279
_T_PLANAR, _T_PREDICTOR = 284, 317
_T_TILE_W, _T_TILE_H, _T_TILE_OFFSETS, _T_TILE_COUNTS = 322, 323, 324, 325
_T_SAMPLE_FORMAT = 339
_T_PIXEL_SCALE, _T_TIEPOINT = 33550, 33922
_T_GEO_KEYS, _T_GEO_DOUBLES, _T_GEO_ASCII = 34735, 34736, 34737
_T_NODATA = 42113
_T_RPC = 50844   # RPCCoefficientTag: 92 doubles (see _rpc_dict_from_tag)

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


def _np_dtype(bits: int, fmt: int, endian: str):
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
    """A structurally valid TIFF uses a feature outside the native decode
    slice (e.g. JPEG-in-TIFF compression), where the JAX package falls
    back to PIL for the pixel data; any other error from the native path
    (truncated strip, bad LZW stream, short buffer) is a corrupt file."""


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
        f"{path}: TIFF compression {comp} is not supported (none, LZW, "
        f"DEFLATE and PackBits are)")


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


def _assemble_pixels(buf, tags, path, endian, w, h, spp, dt, comp,
                     planar, predictor) -> np.ndarray:
    """Decode strips or tiles into an (h, w, spp) array (chunky) or
    (spp, h, w) (planar), with the predictor undone per segment."""
    bps = dt.itemsize
    tiled = _T_TILE_OFFSETS in tags
    if tiled:
        tw = tags[_T_TILE_W][0]
        th = tags[_T_TILE_H][0]
        offsets = tags[_T_TILE_OFFSETS]
        counts = tags[_T_TILE_COUNTS]
        tiles_x = (w + tw - 1) // tw
        tiles_y = (h + th - 1) // th
        n_band_groups = spp if planar == 2 else 1
        seg_spp = 1 if planar == 2 else spp
        canvas = np.zeros((n_band_groups, h, w, seg_spp), dtype=dt)
        expected = th * tw * seg_spp * bps
        for i, (o, c) in enumerate(zip(offsets, counts)):
            data = _decode_segment(buf[o:o + c], comp, path, expected)
            tile = np.frombuffer(data, dtype=dt,
                                 count=th * tw * seg_spp).copy()
            tile = tile.reshape(th, tw, seg_spp)
            tile = _unpredict(tile, predictor, dt)
            g, rem = divmod(i, tiles_y * tiles_x)
            ty, tx = divmod(rem, tiles_x)
            y0, x0 = ty * th, tx * tw
            ny = min(th, h - y0)
            nx = min(tw, w - x0)
            canvas[g, y0:y0 + ny, x0:x0 + nx] = tile[:ny, :nx]
        if planar == 2:
            return canvas[:, :, :, 0]                    # (spp, h, w)
        return canvas[0]                                 # (h, w, spp)

    if _T_STRIP_OFFSETS not in tags:
        # neither strips nor tiles: e.g. old-style JPEG TIFF carrying the
        # pixel data behind JPEGInterchangeFormat (tag 513): a clear error
        # instead of a bare KeyError.
        raise UnsupportedTiffFeature(
            f"{path}: no StripOffsets/TileOffsets in the first IFD "
            f"(old-style JPEG layout?)")
    offsets = tags[_T_STRIP_OFFSETS]
    counts = tags[_T_STRIP_COUNTS]
    rows_per_strip = tags.get(_T_ROWS_PER_STRIP, (h,))[0]
    seg_spp = 1 if planar == 2 else spp
    strips_per_band = (h + rows_per_strip - 1) // rows_per_strip
    segs = []
    for i, (o, c) in enumerate(zip(offsets, counts)):
        band_row = i % strips_per_band if planar == 2 else i
        rows = min(rows_per_strip, h - band_row * rows_per_strip)
        expected = rows * w * seg_spp * bps
        data = _decode_segment(buf[o:o + c], comp, path, expected)
        seg = np.frombuffer(data, dtype=dt, count=rows * w * seg_spp).copy()
        seg = seg.reshape(rows, w, seg_spp)
        segs.append(_unpredict(seg, predictor, dt))
    flat = np.concatenate(segs, axis=0)                  # (spp*h | h, w, seg_spp)
    if planar == 2:
        return flat[:, :, 0].reshape(spp, h, w)
    return flat.reshape(h, w, spp)


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
    dt = _np_dtype(bits, fmt, endian)

    arr = _assemble_pixels(buf, tags, path, endian, w, h, spp, dt,
                           comp, planar, predictor)
    if arr.ndim == 3 and planar != 2:
        arr = arr.transpose(2, 0, 1)                     # -> (bands, h, w)

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
