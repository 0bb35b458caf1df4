"""Baseline JPEG decoding for the port's image readers, with no PIL: the
JPEG-in-TIFF products that the JAX package reads through Pillow
(libtiff + libjpeg-turbo) are decoded here to the same bytes.

Scope: sequential Huffman-coded frames (SOF0, SOF1) of 8-bit samples and
1 or 3 components, any sampling factors, interleaved or one-component
scans, DRI restart intervals, and abbreviated streams whose tables come
from elsewhere (a TIFF's JPEGTables, tag 347).  Progressive, lossless,
arithmetic-coded, hierarchical and 12-bit frames raise
UnsupportedTiffFeature naming their SOF marker.

The arithmetic is libjpeg-turbo 3.1's with its default decompression
parameters, as Pillow calls it:
  * the `islow` integer inverse DCT (jidctint.c: 13-bit constants, two
    passes, the second descaled by 18 bits), outputs clamped to 0..255;
  * fancy (triangle) upsampling (jdsample.c) for h2v1 and h2v2 when the
    component is more than 2 samples wide, and for h1v2; box replication
    for every other integral ratio; the edge rows and columns replicate the
    last real sample;
  * jdcolor.c's fixed-point YCbCr -> RGB (16 fraction bits, tables).

Two implementations of that one arithmetic:
  decode        the host C library csrc/jpeg_decode.c (ops/cuda_build.
                load_host), which the readers call;
  decode_plain  its NumPy twin (the entropy decoding in Python), which the
                tests and chip_smoke.py hold the library to, bit for bit;
  raw_planes / raw_planes_plain  the same for the components at their
                downsampled size (libjpeg's raw_data_out, which libtiff's
                old-style JPEG reads).
A failure of the library's build or call raises; nothing falls back to
the twin.

ycc: True converts three components YCbCr -> RGB; False returns them as
decoded and upsampled (libtiff's JCS_UNKNOWN).  The TIFF reader takes it
from the Photometric tag, as libtiff does.

A table that libjpeg refuses (a DHT whose code counts overflow the code
space or that holds more than 256 symbols, a DQT, DHT or frame naming a
table id above 3) raises ValueError, here and in the library.
"""

from __future__ import annotations

import ctypes
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from .geotiff import UnsupportedTiffFeature

SOF_NAMES = {0xC0: "SOF0 (baseline)", 0xC1: "SOF1 (extended sequential)",
             0xC2: "SOF2 (progressive)", 0xC3: "SOF3 (lossless)",
             0xC5: "SOF5 (differential sequential)",
             0xC6: "SOF6 (differential progressive)",
             0xC7: "SOF7 (differential lossless)",
             0xC9: "SOF9 (arithmetic sequential)",
             0xCA: "SOF10 (arithmetic progressive)",
             0xCB: "SOF11 (arithmetic lossless)",
             0xCD: "SOF13 (arithmetic differential sequential)",
             0xCE: "SOF14 (arithmetic differential progressive)",
             0xCF: "SOF15 (arithmetic differential lossless)"}

# zigzag index -> natural index, with 16 extra entries of 63 that catch a
# run past the block's end in corrupt data (libjpeg's jpeg_natural_order)
NATURAL = np.array(
    [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26,
     33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57,
     50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31,
     39, 46, 53, 60, 61, 54, 47, 55, 62, 63] + [63] * 16, np.int64)


@dataclass
class Component:
    cid: int
    h: int
    v: int
    tq: int


@dataclass
class Scan:
    comps: List[Tuple[int, int, int]]   # (component index, DC table, AC)
    segments: List[bytes]               # one a restart interval, unstuffed
    restart: int                        # MCUs an interval (0: none)
    dc: Dict[int, tuple] = field(default_factory=dict)
    ac: Dict[int, tuple] = field(default_factory=dict)


@dataclass
class Frame:
    width: int
    height: int
    comps: List[Component]
    qt: Dict[int, np.ndarray]           # table id -> 64 values, natural
    scans: List[Scan]

    @property
    def hmax(self):
        return max(c.h for c in self.comps)

    @property
    def vmax(self):
        return max(c.v for c in self.comps)


def _entropy_segments(buf: bytes, pos: int, keep: bool = True):
    """The entropy-coded data from pos, unstuffed and cut at RSTn markers:
    ([segment bytes], position of the marker that ends the scan); with
    keep False only that position.  As libjpeg reads it, 0xFF fill bytes
    before a marker are skipped and FF 00 is a data byte 0xFF."""
    segs, cur = [], bytearray()
    n = len(buf)
    while True:
        j = buf.find(b"\xff", pos)
        if j < 0:
            if keep:
                segs.append(bytes(cur + buf[pos:]))
            return segs, n
        if keep:
            cur += buf[pos:j]
        k = j + 1
        while k < n and buf[k] == 0xFF:
            k += 1
        if k >= n:
            if keep:
                segs.append(bytes(cur))
            return segs, n
        m = buf[k]
        pos = k + 1
        if m == 0:
            if keep:
                cur.append(0xFF)
        elif 0xD0 <= m <= 0xD7:
            if keep:
                segs.append(bytes(cur))
                cur = bytearray()
        else:
            if keep:
                segs.append(bytes(cur))
            return segs, k - 1


def parse(buf: bytes, tables: bytes = b"", entropy: bool = True) -> Frame:
    """Markers of a JPEG stream (and of a tables-only stream read before
    it, as libtiff reads JPEGTables): the frame, its quantisation tables
    and every scan with the Huffman tables in force at its start (and,
    with entropy, its entropy-coded segments, which the twin decodes)."""
    qt: Dict[int, np.ndarray] = {}
    dc: Dict[int, tuple] = {}
    ac: Dict[int, tuple] = {}
    state = {"restart": 0}
    frame = None
    scans: List[Scan] = []

    def markers(data: bytes, is_tables: bool):
        nonlocal frame
        if data[:2] != b"\xff\xd8":
            raise ValueError("not a JPEG stream (no SOI marker)")
        pos = 2
        n = len(data)
        while pos < n:
            if data[pos] != 0xFF:
                raise ValueError(f"JPEG: expected a marker at byte {pos}")
            while pos < n and data[pos] == 0xFF:
                pos += 1
            if pos >= n:
                break
            m = data[pos]
            pos += 1
            if m == 0xD9:                                   # EOI
                return
            if m == 0x01 or 0xD0 <= m <= 0xD7:
                continue
            if pos + 2 > n:
                raise ValueError("JPEG: truncated marker segment")
            ln = struct.unpack(">H", data[pos:pos + 2])[0]
            seg = data[pos + 2:pos + ln]
            if len(seg) != ln - 2:
                raise ValueError("JPEG: truncated marker segment")
            pos += ln
            if m == 0xDB:                                   # DQT
                i = 0
                while i < len(seg):
                    pq, tq = seg[i] >> 4, seg[i] & 15
                    if tq > 3:
                        raise ValueError(f"JPEG: quantisation table id {tq} "
                                         f"(at most 3)")
                    if i + (129 if pq else 65) > len(seg):
                        raise ValueError("JPEG: truncated marker segment")
                    if pq:
                        vals = struct.unpack(">64H", seg[i + 1:i + 129])
                        i += 129
                    else:
                        vals = tuple(seg[i + 1:i + 65])
                        i += 65
                    t = np.zeros(64, np.int64)
                    t[NATURAL[:64]] = vals
                    qt[tq] = t
            elif m == 0xC4:                                 # DHT
                i = 0
                while i < len(seg):
                    tc, th = seg[i] >> 4, seg[i] & 15
                    if tc > 1 or th > 3:
                        raise ValueError(f"JPEG: Huffman table class {tc} "
                                         f"id {th} (at most 1 and 3)")
                    counts = tuple(seg[i + 1:i + 17])
                    nsym = sum(counts)
                    syms = tuple(seg[i + 17:i + 17 + nsym])
                    if len(counts) < 16 or len(syms) != nsym:
                        raise ValueError("JPEG: truncated marker segment")
                    if not huffman_fits(counts):
                        raise ValueError("JPEG: bad Huffman table (its code "
                                         "counts overflow the code space)")
                    i += 17 + nsym
                    (ac if tc else dc)[th] = (counts, syms)
            elif m == 0xDD:                                 # DRI
                state["restart"] = struct.unpack(">H", seg[:2])[0]
            elif m == 0xCC:
                raise UnsupportedTiffFeature(
                    "JPEG: arithmetic coding (DAC marker) is not supported "
                    "(sequential Huffman only)")
            elif 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
                if m not in (0xC0, 0xC1):
                    raise UnsupportedTiffFeature(
                        f"JPEG: {SOF_NAMES[m]} frames are not supported "
                        f"(SOF0 and SOF1, sequential Huffman, only)")
                if frame is not None:
                    raise ValueError("JPEG: a second frame header")
                p, h, w, nc = struct.unpack(">BHHB", seg[:6])
                if p != 8:
                    raise UnsupportedTiffFeature(
                        f"JPEG: {SOF_NAMES[m]} with {p}-bit samples is not "
                        f"supported (8-bit only)")
                if nc not in (1, 3):
                    raise UnsupportedTiffFeature(
                        f"JPEG: {nc} components are not supported (1 or 3)")
                if h == 0:
                    raise UnsupportedTiffFeature(
                        "JPEG: a frame height given by a DNL marker is not "
                        "supported")
                comps = []
                for k in range(nc):
                    cid, hv, tq = seg[6 + 3 * k:9 + 3 * k]
                    comps.append(Component(cid, hv >> 4, hv & 15, tq))
                    if tq > 3:
                        raise ValueError(f"JPEG: quantisation table id {tq} "
                                         f"(at most 3)")
                    if not (1 <= hv >> 4 <= 4 and 1 <= hv & 15 <= 4):
                        raise ValueError(f"JPEG: bad sampling factors {hv:#x}")
                frame = Frame(w, h, comps, qt, scans)
                for c in comps:
                    if frame.hmax % c.h or frame.vmax % c.v:
                        raise UnsupportedTiffFeature(
                            f"JPEG: fractional sampling ratio {frame.hmax}/"
                            f"{c.h} x {frame.vmax}/{c.v} is not supported")
            elif m == 0xDA:                                 # SOS
                if frame is None:
                    raise ValueError("JPEG: SOS before the frame header")
                ns = seg[0]
                ids = {c.cid: k for k, c in enumerate(frame.comps)}
                sc = []
                for k in range(ns):
                    cid, t = seg[1 + 2 * k:3 + 2 * k]
                    if cid not in ids:
                        raise ValueError(f"JPEG: scan names component {cid}")
                    sc.append((ids[cid], t >> 4, t & 15))
                blocks = sum(frame.comps[k].h * frame.comps[k].v
                             for k, _, _ in sc)
                if ns > 1 and blocks > 10:
                    raise ValueError(f"JPEG: {blocks} blocks an MCU (libjpeg "
                                     f"takes at most 10)")
                segs, pos = _entropy_segments(data, pos, entropy)
                scans.append(Scan(sc, segs, state["restart"],
                                  dict(dc), dict(ac)))
        if not is_tables and frame is None:
            raise ValueError("JPEG: no frame header")

    if tables:
        markers(tables, True)
    markers(buf, False)
    if frame is None or not scans:
        raise ValueError("JPEG: no frame or no scan")
    return frame


def huffman_fits(counts) -> bool:
    """libjpeg's check of a DHT (jdmarker.c get_dht, jdhuff.c
    jpeg_make_d_derived_tbl): at most 256 symbols, and at each length the
    codes so far stay below all ones."""
    if sum(counts) > 256:
        return False
    code = 0
    for ln in range(1, 17):
        code += counts[ln - 1]
        if code >= 1 << ln:
            return False
        code <<= 1
    return True


def layout(frame: Frame):
    """Per component: (downsampled width, height, blocks wide, blocks high
    as stored), the MCU grid of the interleaved scans."""
    hm, vm = frame.hmax, frame.vmax
    mx = -(-frame.width // (8 * hm))
    my = -(-frame.height // (8 * vm))
    out = []
    for c in frame.comps:
        dw = -(-frame.width * c.h // hm)
        dh = -(-frame.height * c.v // vm)
        out.append((dw, dh, max(mx * c.h, -(-dw // 8)),
                    max(my * c.v, -(-dh // 8))))
    return out, mx, my


# ---------------------------------------------------------------- entropy

def _lut(table):
    """(symbol, length) for every 16-bit look-ahead: canonical Huffman."""
    counts, syms = table
    sym = [0] * 65536
    length = [0] * 65536
    code, k = 0, 0
    for ln in range(1, 17):
        for _ in range(counts[ln - 1]):
            lo = code << (16 - ln)
            hi = (code + 1) << (16 - ln)
            sym[lo:hi] = [syms[k]] * (hi - lo)
            length[lo:hi] = [ln] * (hi - lo)
            code += 1
            k += 1
        code <<= 1
    return sym, length


class _Bits:
    """MSB-first bits of one restart interval; zeros past its end, as
    libjpeg inserts them."""

    def __init__(self, data: bytes):
        d = np.frombuffer(data + b"\0\0\0\0\0", np.uint8).astype(np.uint64)
        self.w = ((d[:-3] << 24) | (d[1:-2] << 16) | (d[2:-1] << 8)
                  | d[3:]).tolist()
        self.nbits = 8 * len(data)
        self.pos = 0

    def peek16(self):
        p = self.pos
        if p >= self.nbits:
            return 0
        return (self.w[p >> 3] >> (16 - (p & 7))) & 0xFFFF

    def get(self, n):
        p = self.pos
        self.pos = p + n
        if p >= self.nbits:
            return 0
        return (self.w[p >> 3] >> (32 - (p & 7) - n)) & ((1 << n) - 1)


def _extend(r, s):
    return r - (1 << s) + 1 if r < (1 << (s - 1)) else r


def decode_coefficients(frame: Frame) -> List[np.ndarray]:
    """Every component's quantised coefficients, (blocks high, blocks
    wide, 64) int16 in natural order, from all scans."""
    dims, mx, my = layout(frame)
    coefs = [np.zeros((bh, bw, 64), np.int16) for _, _, bw, bh in dims]
    nat = NATURAL.tolist()
    for scan in frame.scans:
        luts = {}
        for ci, td, ta in scan.comps:
            for kind, t, src in (("dc", td, scan.dc), ("ac", ta, scan.ac)):
                if t not in src:
                    raise ValueError(f"JPEG: scan uses an undefined {kind} "
                                     f"Huffman table {t}")
                luts[kind, t] = _lut(src[t])
        if len(scan.comps) == 1:
            ci = scan.comps[0][0]
            dw, dh = dims[ci][:2]
            units = [[(ci, by, bx)] for by in range(-(-dh // 8))
                     for bx in range(-(-dw // 8))]
        else:
            units = []
            for y in range(my):
                for x in range(mx):
                    u = []
                    for ci, _, _ in scan.comps:
                        c = frame.comps[ci]
                        u += [(ci, y * c.v + j, x * c.h + i)
                              for j in range(c.v) for i in range(c.h)]
                    units.append(u)
        tabs = {ci: (luts["dc", td], luts["ac", ta])
                for ci, td, ta in scan.comps}
        per = scan.restart or len(units)
        for k in range(0, len(units), per):
            seg = k // per
            bits = _Bits(scan.segments[seg] if seg < len(scan.segments)
                         else b"")
            pred = {ci: 0 for ci, _, _ in scan.comps}
            for unit in units[k:k + per]:
                for ci, by, bx in unit:
                    (dsym, dlen), (asym, alen) = tabs[ci]
                    blk = coefs[ci][by, bx]
                    v = bits.peek16()
                    if dlen[v] == 0 or dsym[v] > 15:
                        raise ValueError("JPEG: bad Huffman code")
                    bits.pos += dlen[v]
                    s = dsym[v]
                    diff = _extend(bits.get(s), s) if s else 0
                    pred[ci] += diff
                    blk[0] = np.int16(((pred[ci] + 32768) & 0xFFFF) - 32768)
                    i = 1
                    while i < 64:
                        v = bits.peek16()
                        if alen[v] == 0:
                            raise ValueError("JPEG: bad Huffman code")
                        bits.pos += alen[v]
                        rs = asym[v]
                        r, s = rs >> 4, rs & 15
                        if s:
                            i += r
                            val = _extend(bits.get(s), s)
                            blk[nat[i]] = val
                            i += 1
                        elif r == 15:
                            i += 16
                        else:
                            break
    return coefs


# ------------------------------------------------------------ inverse DCT

CONST_BITS, PASS1_BITS = 13, 2
F_0_298, F_0_390, F_0_541 = 2446, 3196, 4433
F_0_765, F_0_899, F_1_175 = 6270, 7373, 9633
F_1_501, F_1_847, F_1_961 = 12299, 15137, 16069
F_2_053, F_2_562, F_3_072 = 16819, 20995, 25172


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _idct_1d(d0, d1, d2, d3, d4, d5, d6, d7):
    """jidctint.c's butterfly on int64 arrays: the 8 outputs before the
    descale."""
    z1 = (d2 + d6) * F_0_541
    tmp2 = z1 + d6 * -F_1_847
    tmp3 = z1 + d2 * F_0_765
    tmp0 = (d0 + d4) << CONST_BITS
    tmp1 = (d0 - d4) << CONST_BITS
    t10, t13 = tmp0 + tmp3, tmp0 - tmp3
    t11, t12 = tmp1 + tmp2, tmp1 - tmp2
    o0, o1, o2, o3 = d7, d5, d3, d1
    z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    z5 = (z3 + z4) * F_1_175
    o0 = o0 * F_0_298
    o1 = o1 * F_2_053
    o2 = o2 * F_3_072
    o3 = o3 * F_1_501
    z1 = z1 * -F_0_899
    z2 = z2 * -F_2_562
    z3 = z3 * -F_1_961 + z5
    z4 = z4 * -F_0_390 + z5
    o0 += z1 + z3
    o1 += z2 + z4
    o2 += z2 + z3
    o3 += z1 + z4
    return (t10 + o3, t11 + o2, t12 + o1, t13 + o0,
            t13 - o0, t12 - o1, t11 - o2, t10 - o3)


def idct_islow(coef: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """(..., 64) quantised coefficients (natural order) and their table ->
    (..., 8, 8) uint8 samples."""
    x = coef.astype(np.int64) * qt.astype(np.int64)
    x = x.reshape(x.shape[:-1] + (8, 8))
    cols = _idct_1d(*[x[..., r, :] for r in range(8)])      # pass 1
    ws = np.stack([_descale(c, CONST_BITS - PASS1_BITS) for c in cols], -2)
    rows = _idct_1d(*[ws[..., :, k] for k in range(8)])     # pass 2
    out = np.stack([_descale(r, CONST_BITS + PASS1_BITS + 3) for r in rows],
                   -1)
    return np.clip(out + 128, 0, 255).astype(np.uint8)


def component_planes(frame: Frame, coefs: List[np.ndarray]):
    """Each component's samples at its downsampled size."""
    dims, _, _ = layout(frame)
    planes = []
    for c, co, (dw, dh, bw, bh) in zip(frame.comps, coefs, dims):
        if c.tq not in frame.qt:
            raise ValueError(f"JPEG: undefined quantisation table {c.tq}")
        px = idct_islow(co, frame.qt[c.tq])                 # (bh, bw, 8, 8)
        px = px.transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)
        planes.append(px[:dh, :dw])
    return planes


# -------------------------------------------------------------- upsampling

def _h2v1_fancy(p):
    x = p.astype(np.int64)
    out = np.empty((x.shape[0], 2 * x.shape[1]), np.int64)
    left = np.concatenate([x[:, :1], x[:, :-1]], 1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], 1)
    out[:, 0::2] = (3 * x + left + 1) >> 2
    out[:, 1::2] = (3 * x + right + 2) >> 2
    out[:, 0] = x[:, 0]
    out[:, -1] = x[:, -1]
    return out


def _v_context(x):
    above = np.concatenate([x[:1], x[:-1]], 0)
    below = np.concatenate([x[1:], x[-1:]], 0)
    return above, below


def _h1v2_fancy(p):
    x = p.astype(np.int64)
    above, below = _v_context(x)
    out = np.empty((2 * x.shape[0], x.shape[1]), np.int64)
    out[0::2] = (3 * x + above + 1) >> 2
    out[1::2] = (3 * x + below + 2) >> 2
    return out


def _h2v2_fancy(p):
    x = p.astype(np.int64)
    above, below = _v_context(x)
    out = np.empty((2 * x.shape[0], 2 * x.shape[1]), np.int64)
    for r, nb in ((0, above), (1, below)):
        s = 3 * x + nb                                      # column sums
        last = np.concatenate([s[:, :1], s[:, :-1]], 1)
        nxt = np.concatenate([s[:, 1:], s[:, -1:]], 1)
        even = (3 * s + last + 8) >> 4
        odd = (3 * s + nxt + 7) >> 4
        even[:, 0] = (4 * s[:, 0] + 8) >> 4
        odd[:, -1] = (4 * s[:, -1] + 7) >> 4
        out[r::2, 0::2] = even
        out[r::2, 1::2] = odd
    return out


def upsample(frame: Frame, planes) -> List[np.ndarray]:
    """Every component at the frame's size (jdsample.c's method choice)."""
    hm, vm = frame.hmax, frame.vmax
    out = []
    for c, p in zip(frame.comps, planes):
        fh, fv = hm // c.h, vm // c.v
        wide = p.shape[1] > 2
        if (fh, fv) == (1, 1):
            u = p
        elif (fh, fv) == (2, 1) and wide:
            u = _h2v1_fancy(p)
        elif (fh, fv) == (1, 2):
            u = _h1v2_fancy(p)
        elif (fh, fv) == (2, 2) and wide:
            u = _h2v2_fancy(p)
        else:
            u = np.repeat(np.repeat(p, fv, 0), fh, 1)
        out.append(u[:frame.height, :frame.width].astype(np.uint8))
    return out


# ------------------------------------------------------ colour conversion

SCALEBITS = 16
ONE_HALF = 1 << (SCALEBITS - 1)


def _fix(x):
    return int(x * (1 << SCALEBITS) + 0.5)


def ycc_tables():
    """jdcolor.c's build_ycc_rgb_table: Cr->R, Cb->B, Cr->G, Cb->G."""
    x = np.arange(256, dtype=np.int64) - 128
    cr_r = (_fix(1.40200) * x + ONE_HALF) >> SCALEBITS
    cb_b = (_fix(1.77200) * x + ONE_HALF) >> SCALEBITS
    cr_g = -_fix(0.71414) * x
    cb_g = -_fix(0.34414) * x + ONE_HALF
    return cr_r, cb_b, cr_g, cb_g


def ycc_to_rgb(y, cb, cr) -> np.ndarray:
    cr_r, cb_b, cr_g, cb_g = ycc_tables()
    y = y.astype(np.int64)
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> SCALEBITS)
    b = y + cb_b[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def decode_plain(buf: bytes, tables: bytes, ycc: bool) -> np.ndarray:
    """The NumPy twin of csrc/jpeg_decode.c: (H, W) uint8 for one
    component, (H, W, 3) for three."""
    frame = parse(buf, tables)
    planes = upsample(frame, component_planes(
        frame, decode_coefficients(frame)))
    if len(planes) == 1:
        return planes[0]
    if ycc:
        return ycc_to_rgb(*planes)
    return np.stack(planes, -1)


# ------------------------------------------------------------ the library

_ERRORS = {1: "not a JPEG stream or a truncated marker segment",
           2: "no frame header or no scan",
           3: "bad Huffman code",
           4: "undefined Huffman or quantisation table",
           5: "out of memory",
           6: "unsupported frame (checked by parse first)",
           7: "output buffer of the wrong size",
           8: "bad Huffman or quantisation table"}


def _fn():
    from ..ops.cuda_build import load_host
    fn = load_host("jpeg_decode").jpeg_decode
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
                   ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int64]
    fn.restype = ctypes.c_int
    return fn


def _call(buf: bytes, tables: bytes, mode: int, size: int) -> np.ndarray:
    out = np.empty(size, np.uint8)
    err = _fn()(tables, len(tables), buf, len(buf), mode, out.ctypes.data,
                out.size)
    if err:
        raise ValueError(f"JPEG: {_ERRORS.get(err, f'error {err}')} "
                         f"(host decoder)")
    return out


def decode(buf: bytes, tables: bytes, ycc: bool) -> np.ndarray:
    """The stream decoded by the host C library: decode_plain's array."""
    frame = parse(buf, tables, False)  # refusals and the output's shape
    nc = len(frame.comps)
    out = _call(buf, tables, int(ycc and nc == 3),
                frame.height * frame.width * nc)
    out = out.reshape(frame.height, frame.width, nc)
    return out[..., 0] if nc == 1 else out


def raw_planes_plain(buf: bytes, tables: bytes = b"") -> List[np.ndarray]:
    """NumPy twin of raw_planes."""
    frame = parse(buf, tables)
    return component_planes(frame, decode_coefficients(frame))


def raw_planes(buf: bytes, tables: bytes = b"") -> List[np.ndarray]:
    """Each component's samples at its downsampled size, neither upsampled
    nor converted (libjpeg's raw_data_out), from the host C library."""
    frame = parse(buf, tables, False)
    dims, _, _ = layout(frame)
    out = _call(buf, tables, 2, sum(dw * dh for dw, dh, _, _ in dims))
    planes, k = [], 0
    for dw, dh, _, _ in dims:
        planes.append(out[k:k + dw * dh].reshape(dh, dw))
        k += dw * dh
    return planes
