"""The images the JAX package reads through PIL, decoded by the port with
no PIL, against Pillow 12.1 and the JAX functions on the same files, on
the CPU:

  * utils/png: every colour type and bit depth, interlaced (Adam7) or
    not, equal to np.asarray(Image.open(path)); data/blender._load_image
    equal to the JAX one on those frames, at the native size and resized;
  * utils/jpeg: the C library equal to its NumPy twin and both equal to
    Pillow's JPEG decoder (sampling factors, restarts, qualities, RGB and
    greyscale), the refused frames;
  * utils/ccitt: the C library equal to its twin on every mode;
  * utils/geotiff: JPEG-in-TIFF (photometric 1, 2 and 6, strips and
    tiles, planar 1 and 2, JPEGTables), old-style JPEG, LZMA and every
    1-bit layout against read_geotiff / load_mask of the JAX package;
    ZSTD and WebP refused;
  * a synthetic AOI re-encoded as JPEG-in-TIFF with 1-bit masks: the
    port's SatelliteDataset equal to the JAX package's.
"""

import dataclasses
import io
import json
import os
import struct
import zlib

import numpy as np
import pytest

import brdfnerf_tpu.native as jnative
from brdfnerf_tpu.data import blender as jbl
from brdfnerf_tpu.data import satellite as jsat
from brdfnerf_tpu.utils import geotiff as jgt

from brdfnerf_tpu_torch.data import blender as tbl
from brdfnerf_tpu_torch.data import satellite as tsat
from brdfnerf_tpu_torch.utils import ccitt, geotiff as tgt, jpeg, png

import torch_port_common  # noqa: F401  (one torch thread a process)
from image_builders import (build_tiff, encode_jpeg, encode_png_any,
                            libjpeg_ycc, markers, pil_jpeg, split_tables)

Image = pytest.importorskip("PIL.Image")


def smooth(h, w, c, seed=0):
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.stack([127 + 120 * np.sin(xx / (4 + i) + yy / (6 + i) + seed + i)
                  for i in range(c)], -1)
    return a.astype(np.uint8)


def noise(h, w, c, seed=0, hi=256):
    return np.random.default_rng(seed).integers(0, hi, (h, w, c))


# ------------------------------------------------------------------ PNG

PNG_KINDS = [(t, d) for t, ds in png.DEPTHS.items() for d in ds]


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("ctype,depth", PNG_KINDS)
def test_png_every_type_and_depth_equals_pil(ctype, depth, interlace):
    """Every colour type and depth, Adam7 or not, at sizes that leave some
    passes empty or one pixel wide: PIL's array, dtype and mode."""
    n = png.SAMPLES[ctype]
    for k, (h, w) in enumerate(((37, 29), (1, 1), (3, 9), (64, 64))):
        s = noise(h, w, n, seed=k, hi=1 << depth)
        buf = encode_png_any(s, depth, ctype, interlace, seed=k)
        im = Image.open(io.BytesIO(buf))
        ref = np.asarray(im)
        got, mode = png.decode_image(buf)
        assert mode == im.mode, (mode, im.mode)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert np.array_equal(got, ref), (ctype, depth, interlace, h, w)


@pytest.mark.parametrize("interlace", [False, True])
def test_png_unfilter_library_equals_twin_on_every_pass(interlace):
    for ctype, depth in PNG_KINDS:
        s = noise(23, 31, png.SAMPLES[ctype], seed=depth, hi=1 << depth)
        head, passes = png.scanlines(encode_png_any(s, depth, ctype, interlace))
        assert len(passes) == (7 if interlace else 1)
        for p in passes:
            w, c = p.stride // p.bpp, p.bpp
            assert np.array_equal(png._unfilter_c(p.raw, p.rows, w, c, "x"),
                                  png.unfilter_plain(p.raw, p.rows, w, c))


@pytest.mark.parametrize("mode", ["1", "L", "P", "I;16", "LA", "RGB",
                                  "RGBA", "P;4"])
def test_blender_load_image_equals_jax(tmp_path, mode):
    """data/blender._load_image on frames of every mode PIL gives for a
    PNG, written by PIL (Adam7 by the test's encoder), at the native size
    and resized: LANCZOS, or NEAREST for "1" and "P" as Image.resize."""
    rng = np.random.default_rng(3)
    base = smooth(40, 44, 4)
    if mode == "1":
        img = Image.fromarray(base[..., 0] > 127)
    elif mode in ("P", "P;4"):
        img = Image.fromarray(base[..., :3]).convert(
            "P", palette=Image.Palette.ADAPTIVE,
            colors=16 if mode == "P;4" else 256)
    elif mode == "I;16":
        img = Image.fromarray(base[..., 0].astype(np.uint16) * 250
                              + rng.integers(0, 250, (40, 44)).astype(
                                  np.uint16))
    else:
        n = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
        img = Image.fromarray(base[..., 0] if n == 1 else base[..., :n], mode)
    paths = [str(tmp_path / "f.png")]
    img.save(paths[0], bits=4) if mode == "P;4" else img.save(paths[0])
    ref_arr = np.asarray(Image.open(paths[0]))
    samples = ref_arr[..., None] if ref_arr.ndim == 2 else ref_arr
    ctype, depth = {"1": (0, 1), "L": (0, 8), "P": (3, 8), "P;4": (3, 4),
                    "I;16": (0, 16), "LA": (4, 8), "RGB": (2, 8),
                    "RGBA": (6, 8)}[mode]
    paths.append(str(tmp_path / "adam7.png"))
    with open(paths[1], "wb") as f:
        f.write(encode_png_any(samples.astype(np.int64), depth, ctype, True))
    for path in paths:
        assert np.array_equal(png.read_png(path),
                              np.asarray(Image.open(path))), path
        for wh in ((44, 40), (30, 27), (61, 50)):
            try:
                ref = jbl._load_image(path, wh)
            except ValueError as e:               # LA: rgb of 2 channels
                with pytest.raises(ValueError, match=str(e)[:20]):
                    tbl._load_image(path, wh)
                continue
            got = tbl._load_image(path, wh)
            for g, r in zip(got, ref):
                assert g.dtype == r.dtype and g.shape == r.shape
                if (wh != (44, 40) and mode in ("L", "LA", "RGB", "RGBA")
                        and g.dtype != bool):
                    # the 8-bit LANCZOS within one level, as in
                    # tests/test_torch_port_blender.py
                    assert np.abs(g - r).max() <= 1 / 255 + 1e-7, (mode, wh)
                else:
                    assert np.array_equal(g, r), (mode, wh, path)


def test_png_refusals_name_the_fault():
    s = noise(4, 4, 1, hi=256)
    buf = bytearray(encode_png_any(s, 8, 0))
    buf[24] = 3                                  # IHDR bit depth 3
    buf[29:33] = struct.pack(">I", zlib.crc32(bytes(buf[12:29])))
    with pytest.raises(ValueError, match="bit depth 3"):
        png.decode_image(bytes(buf))
    buf[24], buf[25] = 8, 5                      # colour type 5
    buf[29:33] = struct.pack(">I", zlib.crc32(bytes(buf[12:29])))
    with pytest.raises(ValueError, match="colour type 5"):
        png.decode_image(bytes(buf))


# ----------------------------------------------------------------- JPEG

def _held(stream, tables=b""):
    """The C library, its twin and Pillow on one stream: all equal, with
    the colour conversion Pillow's decoder guesses."""
    ycc = libjpeg_ycc(stream)
    got = jpeg.decode(stream, tables, ycc)
    assert np.array_equal(got, jpeg.decode_plain(stream, tables, ycc))
    if not tables:
        ref = np.asarray(Image.open(io.BytesIO(stream)))
        assert got.shape == ref.shape and np.array_equal(got, ref)
    return got


@pytest.mark.parametrize("kind", ["grey", "444", "422", "420", "rgb"])
def test_jpeg_pil_streams_equal_pil_and_twin(kind):
    """Pillow-written JFIF (and Adobe RGB) streams at three qualities, with
    and without restart markers, at sizes down to one pixel."""
    for h, w in ((1, 1), (2, 3), (17, 9), (33, 64), (5, 40)):
        for q in (20, 75, 100):
            for extra in ({}, dict(restart_marker_blocks=2)):
                for seed, img in enumerate((smooth(h, w, 3),
                                            noise(h, w, 3).astype(np.uint8))):
                    if kind == "grey":
                        arr, kw = img[..., 0], {}
                    elif kind == "rgb":
                        arr, kw = img, dict(keep_rgb=True)
                    else:
                        arr = img
                        kw = dict(subsampling={"444": 0, "422": 1,
                                               "420": 2}[kind])
                    _held(pil_jpeg(arr, quality=q, **kw, **extra))


FACTORS = {"h1v2": [(1, 2), (1, 1), (1, 1)], "h4v1": [(4, 1), (1, 1), (2, 1)],
           "mixed": [(2, 2), (1, 2), (2, 1)], "h3v1": [(3, 1), (1, 1), (1, 1)],
           "h1v3": [(1, 3), (1, 1), (1, 1)], "h2v2": [(2, 2), (1, 1), (1, 1)],
           "grey2x2": [(2, 2)]}


@pytest.mark.parametrize("name", sorted(FACTORS))
def test_jpeg_any_sampling_factors(name):
    """Sampling factors PIL does not write (the test's encoder): fancy h1v2,
    box replication at 3x and 4x, a component of each kind, one scan a
    component, restart intervals, widths of 2 and 3 (no fancy h2v1 or
    h2v2 there, as libjpeg-turbo)."""
    f = FACTORS[name]
    img = smooth(37, 45, len(f))
    for h, w in ((37, 45), (5, 3), (16, 2), (9, 17)):
        for inter in (True, False):
            for rst in (0, 3):
                _held(encode_jpeg(img[:h, :w], f, restart=rst,
                                  interleave=inter))


def test_jpeg_colour_markers_and_tables():
    """JFIF, Adobe transform 0 / 1 and component ids decide the colour
    space as libjpeg guesses; an abbreviated stream reads its tables from
    a tables-only stream; the raw planes of the library equal the twin's."""
    img = smooth(24, 30, 3)
    for marker, ids in (("jfif", (1, 2, 3)), (0, (1, 2, 3)),
                        (1, (1, 2, 3)), (None, (82, 71, 66)),
                        (None, (5, 6, 7))):
        _held(encode_jpeg(img, FACTORS["h2v2"], marker=marker, ids=ids))
    whole = pil_jpeg(img, subsampling=2)
    tables, short = split_tables(whole)
    assert np.array_equal(_held(short, tables), _held(whole))
    with pytest.raises(ValueError):
        jpeg.decode(short, b"", True)             # no tables
    for p, q in zip(jpeg.raw_planes(whole), jpeg.raw_planes_plain(whole)):
        assert np.array_equal(p, q)
    assert [p.shape for p in jpeg.raw_planes(whole)] == [(24, 30), (12, 15),
                                                         (12, 15)]


def test_jpeg_refuses_what_it_does_not_decode():
    img = smooth(16, 16, 3)
    with pytest.raises(tgt.UnsupportedTiffFeature, match="SOF2"):
        jpeg.decode(pil_jpeg(img, progressive=True), b"", True)
    base = pil_jpeg(img)
    sof = base.index(b"\xff\xc0")
    for marker, match in ((0xC9, "SOF9"), (0xC3, "SOF3"), (0xCA, "SOF10")):
        s = base[:sof + 1] + bytes([marker]) + base[sof + 2:]
        with pytest.raises(tgt.UnsupportedTiffFeature, match=match):
            jpeg.decode(s, b"", True)
    s = base[:sof + 4] + bytes([12]) + base[sof + 5:]
    with pytest.raises(tgt.UnsupportedTiffFeature, match="12-bit"):
        jpeg.decode(s, b"", True)
    cmyk = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 4), np.uint8), "CMYK").save(cmyk, "JPEG")
    with pytest.raises(tgt.UnsupportedTiffFeature, match="4 components"):
        jpeg.decode(cmyk.getvalue(), b"", True)
    with pytest.raises(ValueError, match="blocks an MCU"):
        jpeg.decode(encode_jpeg(img, [(4, 4), (2, 2), (1, 1)]), b"", True)


def _segment_at(stream, marker, first=None):
    """Byte offset of the body of the first segment with this marker (and
    this first byte)."""
    pos = 2
    for m, seg in markers(stream):
        if m == marker and first in (None, seg[0]):
            return pos + 4
        pos += 4 + len(seg)
    raise AssertionError(f"no marker {marker:#x}")


def _corrupt_tables(base):
    """Streams with a table libjpeg refuses, and what each breaks."""
    dht = _segment_at(base, 0xC4, 0x00)          # Pillow's DC table 0
    counts = base[dht + 1:dht + 17]
    nsym = sum(counts)
    yield "a DHT of all its codes at length 1", (
        base[:dht + 1] + bytes([nsym]) + bytes(15) + base[dht + 17:])
    ac = _segment_at(base, 0xC4, 0x10)           # AC table 0
    nac = sum(base[ac + 1:ac + 17])
    yield f"a DHT of {nac} codes at length 1", (
        base[:ac + 1] + bytes([nac]) + bytes(15) + base[ac + 17:])
    yield "a DHT whose length-2 codes reach all ones", (
        base[:dht + 1] + bytes([1, 2, nsym - 3]) + bytes(13)
        + base[dht + 17:])
    yield "a DHT table id of 4", base[:dht] + b"\x04" + base[dht + 1:]
    yield "a DHT table class of 2", base[:dht] + b"\x20" + base[dht + 1:]
    dqt = _segment_at(base, 0xDB)
    yield "a DQT table id of 4", base[:dqt] + b"\x04" + base[dqt + 1:]
    sof = _segment_at(base, 0xC0)
    yield "a frame naming quantisation table 4", (
        base[:sof + 8] + b"\x04" + base[sof + 9:])


@pytest.mark.parametrize("kind", ["parse", "library"])
def test_jpeg_refuses_tables_libjpeg_refuses(kind):
    """A corrupt table is refused before it is built: Pillow (libjpeg)
    refuses each of these streams, the port's parse raises ValueError, and
    the C library, called with no parse before it, returns its corrupt
    table code (before this check, the look-up fill of a DHT with 162
    codes at length 1 wrote past the table)."""
    img = smooth(16, 16, 3)
    for name, s in _corrupt_tables(pil_jpeg(img)):
        with pytest.raises(OSError):
            Image.open(io.BytesIO(s)).load()
        if kind == "parse":
            with pytest.raises(ValueError, match="table"):
                jpeg.decode(s, b"", True)
        else:
            with pytest.raises(ValueError, match="bad Huffman or "
                               "quantisation table"):
                jpeg._call(s, b"", 1, 16 * 16 * 3)


# ----------------------------------------------------------------- CCITT

def _masks():
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:40, 0:64]
    yield (xx - 30) ** 2 + (yy - 20) ** 2 < 200
    yield rng.integers(0, 2, (12, 17)).astype(bool)
    yield rng.random((30, 33)) < 0.1
    yield np.zeros((5, 9), bool)
    wide = np.zeros((3, 2600), bool)           # runs past 1728 and 2560
    wide[0, 1900:2590] = wide[1, 3:2000] = wide[2, 2599] = True
    yield wide


CCITT = {"rle": ("tiff_ccitt", 0), "t4": ("group3", 0),
         "t4_2d": ("group3", 1), "t4_fill": ("group3", 4),
         "t4_2d_fill": ("group3", 5), "t6": ("group4", 0)}


def _pil_bilevel(m, compression, t4=0, rows_per_strip=None):
    """PIL's file of a bool mask: (its strips' bytes, rows a strip, tags)."""
    info = {}
    if t4:
        info[292] = t4
    if rows_per_strip:
        info[278] = rows_per_strip
    b = io.BytesIO()
    Image.fromarray(m).save(b, "TIFF", compression=compression,
                            tiffinfo=info)
    im = Image.open(io.BytesIO(b.getvalue()))
    data = b.getvalue()
    strips = [data[o:o + n] for o, n in zip(im.tag_v2[273], im.tag_v2[279])]
    return strips, im.tag_v2.get(278, m.shape[0]), dict(im.tag_v2)


@pytest.mark.parametrize("mode", sorted(CCITT))
def test_ccitt_library_equals_twin(mode):
    compression, t4 = CCITT[mode]
    comp = {"tiff_ccitt": 2, "group3": 3, "group4": 4}[compression]
    for m in _masks():
        strips, rps, tags = _pil_bilevel(m, compression, t4, 7)
        assert tags.get(292, 0) == t4
        h, w = m.shape
        rows = [min(rps, h - y) for y in range(0, h, rps)]
        got = b"".join(ccitt.decode(s, r, w, comp, t4)
                       for s, r in zip(strips, rows))
        assert got == b"".join(ccitt.decode_plain(s, r, w, comp, t4)
                               for s, r in zip(strips, rows))
        bits = np.unpackbits(np.frombuffer(got, np.uint8).reshape(
            h, -1), axis=1)[:, :w]
        assert np.array_equal(bits.astype(bool), m), (mode, m.shape)
    with pytest.raises(tgt.UnsupportedTiffFeature, match="uncompressed"):
        ccitt.decode(b"\0", 1, 8, 3, 2)


# --------------------------------------------------------- JPEG-in-TIFF

GEO = {33550: (12, [0.5, 0.5, 0.0]),
       33922: (12, [0.0, 0.0, 0.0, 500000.0, 4100000.0, 0.0]),
       34735: (3, [1, 1, 0, 2, 1024, 0, 1, 1, 3072, 0, 1, 32631])}


def _jpeg_tags(photometric, spp, rows=None, planar=1, sub=None,
               tables=b""):
    tags = dict(GEO)
    tags.update({258: (3, [8] * spp), 259: (3, [7]),
                 262: (3, [photometric]), 277: (3, [spp]),
                 284: (3, [planar])})
    if rows:
        tags[278] = (4, [rows])
    if sub:
        tags[530] = (3, list(sub))
    if tables:
        tags[347] = (7, tables)
    return tags


def _strips(img, rows, fn):
    return [fn(img[y:y + rows]) for y in range(0, img.shape[0], rows)]


def _tiles(img, t, fn):
    out = []
    for y in range(0, img.shape[0], t):
        for x in range(0, img.shape[1], t):
            tile = np.zeros((t, t) + img.shape[2:], np.uint8)
            part = img[y:y + t, x:x + t]
            tile[:part.shape[0], :part.shape[1]] = part
            out.append(fn(tile))
    return out


def _abbreviated(streams):
    tables = split_tables(streams[0])[0]
    return tables, [split_tables(s)[1] for s in streams]


def jpeg_tiff(case):
    """The TIFF bytes of one JPEG-in-TIFF layout (40 x 44 pixels)."""
    img = smooth(40, 44, 3)
    sub = {"11": 0, "21": 1, "22": 2}
    if case == "pil_rgb":
        b = io.BytesIO()
        Image.fromarray(img).save(b, "TIFF", compression="jpeg",
                                  tiffinfo={278: 16})
        return b.getvalue()
    if case == "pil_grey":
        b = io.BytesIO()
        Image.fromarray(img[..., 0]).save(b, "TIFF", compression="jpeg")
        return b.getvalue()
    if case == "ycbcr_strips_big_endian":
        return build_tiff(44, 40, _jpeg_tags(6, 3, 16, sub=(2, 2)),
                          _strips(img, 16, lambda a: pil_jpeg(
                              a, subsampling=2)), endian=">")
    if case.startswith("ycbcr_strips_"):
        s = case[-2:]
        return build_tiff(44, 40, _jpeg_tags(6, 3, 16, sub=(int(s[0]),
                                                            int(s[1]))),
                          _strips(img, 16, lambda a: pil_jpeg(
                              a, subsampling=sub[s])))
    if case == "ycbcr_no_subsampling_tag":
        return build_tiff(44, 40, _jpeg_tags(6, 3, 16),
                          _strips(img, 16, lambda a: pil_jpeg(
                              a, subsampling=1)))
    if case == "ycbcr_last_strip_full_height":
        segs = _strips(np.pad(img, ((0, 8), (0, 0), (0, 0)), mode="edge"),
                       16, lambda a: pil_jpeg(a, subsampling=2))
        return build_tiff(44, 40, _jpeg_tags(6, 3, 16, sub=(2, 2)), segs)
    if case == "ycbcr_tiles_tables":
        tables, segs = _abbreviated(_tiles(img, 16, lambda a: pil_jpeg(
            a, subsampling=2)))
        return build_tiff(44, 40, _jpeg_tags(6, 3, sub=(2, 2),
                                             tables=tables),
                          segs, tiled=(16, 16))
    if case == "rgb_tiles_tables":
        tables, segs = _abbreviated(_tiles(img, 16, lambda a: pil_jpeg(
            a, keep_rgb=True)))
        return build_tiff(44, 40, _jpeg_tags(2, 3, tables=tables), segs,
                          tiled=(16, 16))
    if case == "grey_tiles":
        return build_tiff(44, 40, _jpeg_tags(1, 1), _tiles(
            img[..., 0], 16, pil_jpeg), tiled=(16, 16))
    if case in ("rgb_planar", "ycbcr_planar"):
        segs = [s for c in range(3) for s in _strips(
            np.ascontiguousarray(img[..., c]), 24, pil_jpeg)]
        return build_tiff(44, 40, _jpeg_tags(
            2 if case == "rgb_planar" else 6, 3, 24, planar=2,
            sub=(1, 1)), segs)
    if case == "ycbcr_planar_tiles":
        segs = [s for c in range(3) for s in _tiles(
            np.ascontiguousarray(img[..., c]), 16, pil_jpeg)]
        return build_tiff(44, 40, _jpeg_tags(6, 3, planar=2, sub=(1, 1)),
                          segs, tiled=(16, 16))
    raise KeyError(case)


JPEG_TIFFS = ["pil_rgb", "pil_grey", "ycbcr_strips_11", "ycbcr_strips_21",
              "ycbcr_strips_22", "ycbcr_strips_big_endian",
              "ycbcr_no_subsampling_tag", "ycbcr_last_strip_full_height",
              "ycbcr_tiles_tables", "rgb_tiles_tables", "grey_tiles",
              "rgb_planar", "ycbcr_planar", "ycbcr_planar_tiles"]


def _same_read(path):
    """The port's read_geotiff equal to the JAX package's (its pixels
    through PIL), and read_pixels to np.asarray(Image.open)."""
    ja, jp = jgt.read_geotiff(path)
    ta, tp = tgt.read_geotiff(path)
    assert ta.dtype == ja.dtype and np.array_equal(ta, ja), path
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp), (tp, jp)
    ref = np.asarray(Image.open(path))
    got = tgt.read_pixels(path)
    assert got.dtype == ref.dtype and np.array_equal(got, ref), path
    return ta


@pytest.mark.parametrize("case", JPEG_TIFFS)
def test_read_geotiff_jpeg_equals_jax(tmp_path, case):
    path = str(tmp_path / f"{case}.tif")
    with open(path, "wb") as f:
        f.write(jpeg_tiff(case))
    arr = _same_read(path)
    assert arr.shape[1:] == (40, 44)


def test_old_style_jpeg(tmp_path):
    """Compression 6, a whole JPEG stream behind JPEGInterchangeFormat or
    in its strip, as PIL reads it (libtiff's raw planes; YCbCr through
    TIFFYCbCrToRGB at the stream's sampling factors, whatever
    YCbCrSubSampling says); where PIL refuses (a subsampled greyscale
    stream) the port raises a ValueError naming the file."""
    img = smooth(40, 44, 3)

    def write(name, stream, spp, over=()):
        tags = dict(GEO)
        tags.update({258: (3, [8] * spp), 259: (3, [6]),
                     262: (3, [1 if spp == 1 else 6]), 277: (3, [spp]),
                     278: (4, [40]), 284: (3, [1]), 513: (4, [8]),
                     514: (4, [len(stream)]), 530: (3, [2, 2])})
        tags.update(dict(over))
        tags = {k: v for k, v in tags.items() if v is not None}
        path = str(tmp_path / f"{name}.tif")
        with open(path, "wb") as f:
            f.write(build_tiff(44, 40, tags, [stream]))
        return path

    for sub in (2, 1):
        stream = pil_jpeg(img, subsampling=sub)
        _same_read(write(f"ycc{sub}", stream, 3))
        _same_read(write(f"strip{sub}", stream, 3, {513: None, 514: None}))
    _same_read(write("grey", pil_jpeg(img[..., 0]), 1))
    path = write("grey22", pil_jpeg(img[..., 0], subsampling=2), 1)
    with pytest.raises(Exception):
        np.asarray(Image.open(path))
    with pytest.raises(ValueError, match="grey22.tif"):
        tgt.read_geotiff(path)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "I;16", "F", "I",
                                  "predictor"])
def test_lzma_equals_jax(tmp_path, mode):
    rng = np.random.default_rng(1)
    if mode in ("L", "RGB", "RGBA", "predictor"):
        n = {"L": 1, "RGB": 3, "RGBA": 4, "predictor": 3}[mode]
        a = smooth(37, 29, n)
        im = Image.fromarray(a[..., 0] if n == 1 else a)
    elif mode == "I;16":
        im = Image.fromarray(rng.integers(0, 65535, (37, 29)).astype(
            np.uint16))
    elif mode == "F":
        im = Image.fromarray(rng.normal(size=(37, 29)).astype(np.float32))
    else:
        im = Image.fromarray(rng.integers(-9999, 9999, (37, 29)).astype(
            np.int32))
    path = str(tmp_path / "z.tif")
    info = {317: 2} if mode == "predictor" else {}
    im.save(path, compression="lzma", tiffinfo=info)
    assert Image.open(path).tag_v2[259] == 34925
    _same_read(path)
    if mode == "RGB":                           # the same pixels in tiles
        import lzma
        a = np.asarray(im)
        tags = {258: (3, [8, 8, 8]), 259: (3, [34925]), 262: (3, [2]),
                277: (3, [3]), 284: (3, [1])}
        tiles = _tiles(a, 16, lambda t: lzma.compress(t.tobytes()))
        with open(path, "wb") as f:
            f.write(build_tiff(29, 37, tags, tiles, tiled=(16, 16)))
        assert np.array_equal(_same_read(path).transpose(1, 2, 0), a)


@pytest.mark.parametrize("codec", ["zstd", "webp", "progressive",
                                   "arithmetic"])
def test_refused_codecs_raise_naming_them(tmp_path, codec):
    """ZSTD, WebP and the JPEG modes out of scope raise
    UnsupportedTiffFeature naming the codec, and never return an array."""
    path = str(tmp_path / "r.tif")
    img = smooth(16, 16, 3)
    if codec == "zstd":
        Image.fromarray(img).save(path, compression="zstd")
        assert Image.open(path).tag_v2[259] == 50000
        match = "ZSTD"
    elif codec == "webp":               # this Pillow's libtiff writes none
        tags = dict(_jpeg_tags(2, 3, 16))
        tags[259] = (3, [50001])
        with open(path, "wb") as f:
            f.write(build_tiff(16, 16, tags, [b"RIFF\0\0\0\0WEBP"]))
        match = "WebP"
    else:
        s = pil_jpeg(img, subsampling=2, progressive=codec == "progressive")
        if codec == "arithmetic":
            i = s.index(b"\xff\xc0")
            s = s[:i + 1] + b"\xc9" + s[i + 2:]
        with open(path, "wb") as f:
            f.write(build_tiff(16, 16, _jpeg_tags(6, 3, 16, sub=(2, 2)),
                               [s]))
        match = "SOF2" if codec == "progressive" else "SOF9"
    for fn in (tgt.read_geotiff, tgt.read_pixels):
        with pytest.raises(tgt.UnsupportedTiffFeature, match=match):
            fn(path)


def test_read_geotiff_refuses_one_bit_as_jax(tmp_path):
    """read_geotiff keeps the JAX function's refusal of a 1-bit image (its
    dtype fails before the PIL fallback), with the bit depth named."""
    path = str(tmp_path / "m.tif")
    Image.fromarray(np.eye(8, dtype=bool)).save(path)
    with pytest.raises((TypeError, ValueError)):
        jgt.read_geotiff(path)
    with pytest.raises(ValueError, match="1-bit"):
        tgt.read_geotiff(path)


# ------------------------------------------------------------- 1-bit masks

BILEVEL = ["raw", "tiff_lzw", "tiff_adobe_deflate", "packbits", "lzma",
           "tiff_ccitt", "group3", "group3_2d", "group4"]


def mask_tiff(m, compression, photometric, fill_order, tiled=False):
    """A 1-bit TIFF of mask m whose segments PIL wrote, rebuilt with the
    given photometric and FillOrder (2: every raw byte bit-reversed)."""
    t4 = 1 if compression == "group3_2d" else 0
    comp_name = "group3" if compression == "group3_2d" else compression
    if tiled:
        segs = []
        for y in range(0, m.shape[0], 16):
            for x in range(0, m.shape[1], 16):
                tile = np.zeros((16, 16), bool)
                part = m[y:y + 16, x:x + 16]
                tile[:part.shape[0], :part.shape[1]] = part
                segs += _pil_bilevel(tile, comp_name, t4)[0]
        rows, tags = None, _pil_bilevel(m[:16, :16], comp_name, t4)[2]
    else:
        segs, rows, tags = _pil_bilevel(m, comp_name, t4, 8)
    if fill_order == 2:
        rev = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)],
                       np.uint8)
        segs = [rev[np.frombuffer(s, np.uint8)].tobytes() for s in segs]
    out = {258: (3, [1]), 259: (3, [tags[259]]), 262: (3, [photometric]),
           266: (3, [fill_order]), 277: (3, [1])}
    if rows:
        out[278] = (4, [rows])
    if t4:
        out[292] = (4, [t4])
    return build_tiff(m.shape[1], m.shape[0], out, segs,
                      tiled=(16, 16) if tiled else None)


@pytest.mark.parametrize("fill_order", [1, 2])
@pytest.mark.parametrize("photometric", [0, 1])
@pytest.mark.parametrize("compression", BILEVEL)
def test_load_mask_one_bit_equals_jax(tmp_path, compression, photometric,
                                      fill_order):
    """load_mask on 1-bit masks (strips and tiles, WhiteIsZero and
    BlackIsZero, FillOrder 1 and 2) equals the JAX function, at the mask's
    size and resized; read_pixels equals PIL's bool array."""
    m = next(_masks())[:37, :45]
    json_p = str(tmp_path / "img.json")
    for tiled in (False, True):
        with open(json_p[:-5] + "_mask.tif", "wb") as f:
            f.write(mask_tiff(m, compression, photometric, fill_order,
                              tiled))
        ref = np.asarray(Image.open(json_p[:-5] + "_mask.tif"))
        got = tgt.read_pixels(json_p[:-5] + "_mask.tif")
        assert got.dtype == bool and np.array_equal(got, ref)
        assert np.array_equal(got, m if photometric else ~m)
        for h, w in ((37, 45), (40, 30)):
            assert np.array_equal(tsat.load_mask(json_p, h, w),
                                  jsat.load_mask(json_p, h, w)), (h, w)


@pytest.mark.parametrize("compression", ["raw", "tiff_lzw",
                                         "tiff_adobe_deflate", "packbits",
                                         "group3", "group4", "tiff_ccitt"])
def test_load_mask_pil_written_one_bit_equals_jax(tmp_path, compression):
    """The 1-bit masks PIL writes (mode "1"; uncompressed without a
    BitsPerSample tag, TIFF's default of 1): load_mask equals the JAX
    function, where the port crashed before on every one of them."""
    json_p = str(tmp_path / "img.json")
    m = np.random.default_rng(2).integers(0, 2, (12, 17)).astype(bool)
    Image.fromarray(m).save(json_p[:-5] + "_mask.tif",
                            compression=compression)
    for h, w in ((12, 17), (20, 9)):
        assert np.array_equal(tsat.load_mask(json_p, h, w),
                              jsat.load_mask(json_p, h, w)), (h, w)
    assert np.array_equal(tgt.read_pixels(json_p[:-5] + "_mask.tif"), m)


def test_load_mask_jpeg_and_eight_bit_equal_jax(tmp_path):
    json_p = str(tmp_path / "img.json")
    m = (smooth(24, 20, 1)[..., 0] > 100).astype(np.uint8) * 255
    for kw in (dict(compression="jpeg"), dict(compression="tiff_lzw"),
               dict(compression="packbits"), {}):
        Image.fromarray(m).save(json_p[:-5] + "_mask.tif", **kw)
        for h, w in ((24, 20), (12, 31)):
            assert np.array_equal(tsat.load_mask(json_p, h, w),
                                  jsat.load_mask(json_p, h, w)), kw


# ------------------------------------------------- the slice as a whole

def _reencode_aoi(root):
    """Every image of the AOI as a tiled YCbCr 4:2:0 JPEG-in-TIFF with
    JPEGTables, keeping its geo and RPC tags; every json a 1-bit Group 4
    mask."""
    n = 0
    for name in sorted(os.listdir(root)):
        path = os.path.join(root, name)
        if name.endswith(".tif") and "mask" not in name:
            arr, _ = tgt.read_geotiff(path)
            _, src = tgt.read_tiff_header(path, open(path, "rb").read())
            img = np.ascontiguousarray(arr.transpose(1, 2, 0))
            tables, segs = _abbreviated(_tiles(img, 32, lambda a: pil_jpeg(
                a, subsampling=2, quality=90)))
            tags = _jpeg_tags(6, 3, sub=(2, 2), tables=tables)
            for tag, typ in ((33550, 12), (33922, 12), (34735, 3),
                             (50844, 12)):
                if tag in src:
                    tags[tag] = (typ, list(src[tag]))
            with open(path, "wb") as f:
                f.write(build_tiff(img.shape[1], img.shape[0], tags, segs,
                                   tiled=(32, 32)))
            n += 1
        elif name.endswith(".json"):
            p = path[:-5] + "_mask.tif"
            yy, xx = np.mgrid[0:64, 0:64]
            m = (xx + 2 * yy + 7 * n) % 23 > 4
            Image.fromarray(m).save(p, compression="group4")
    return n


def test_satellite_dataset_on_jpeg_tiffs_equals_jax(tmp_path, monkeypatch):
    """A synth_aoi.build_aoi(size=64) scene re-encoded as JPEG-in-TIFF with
    1-bit masks: the port's SatelliteDataset ingests it as the JAX
    package's does (train store and val images, array for array)."""
    from brdfnerf_tpu_torch.data import synth_aoi as taoi
    monkeypatch.setattr(jnative, "usable", lambda *a, **k: None)
    info = taoi.build_aoi(str(tmp_path / "aoi"), size=64)
    assert _reencode_aoi(info["root"]) >= 3
    assert Image.open(os.path.join(info["root"], sorted(
        f for f in os.listdir(info["root"])
        if f.endswith(".tif") and "mask" not in f)[0])).tag_v2[259] == 7
    kw = dict(root_dir=info["root"], aoi_id="Synth_001")
    jc, tc = jsat.SatelliteConfig(**kw), tsat.SatelliteConfig(**kw)
    jtr, ttr = jsat.SatelliteDataset(jc, "train"), tsat.SatelliteDataset(
        tc, "train")
    assert set(ttr.store) == set(jtr.store)
    for k, v in jtr.store.items():
        assert ttr.store[k].dtype == v.dtype and np.array_equal(
            ttr.store[k], v), k
    jva, tva = jsat.SatelliteDataset(jc, "val"), tsat.SatelliteDataset(
        tc, "val")
    for i in range(len(jva)):
        sj, st = jva.get_image(i), tva.get_image(i)
        assert set(st) == set(sj)
        for k, v in sj.items():
            if isinstance(v, np.ndarray):
                assert np.array_equal(st[k], v), (i, k)
            else:
                assert st[k] == v, (i, k)
        assert not sj["mask"].all()           # the 1-bit mask was read


def test_committed_fixtures_decode_to_pillows_arrays(capsys):
    """chip_smoke.py's fixture check on the CPU: every file of
    tests/data_torch_port decodes through the host C libraries equal to
    the NumPy twins and to the SHA-256 of Pillow's array in the manifest,
    and Pillow still gives that array here."""
    import importlib.util
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.image_fixtures("cpu") > 0
    out = capsys.readouterr().out
    with open(os.path.join(smoke.FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    names = [n for n in manifest if not n.startswith("_")]
    assert len(names) == 6 and out.count("SHA-256 equal") == 6
    total = 0
    for name in names:
        path = os.path.join(smoke.FIXTURES, name)
        total += os.path.getsize(path)
        assert smoke.digest(np.asarray(Image.open(path))) == manifest[
            name]["sha256"], name
    assert total <= 300_000
