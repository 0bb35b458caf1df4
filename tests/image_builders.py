"""Writers of the image files the port's image tests decode: TIFFs with
any tags and strips or tiles, baseline JPEG streams at any sampling
factors (PIL writes 4:4:4, 4:2:2 and 4:2:0 only), and PNGs of every
colour type, depth and Adam7 (PIL writes few of them).  Test code only:
Pillow decodes what these write, and the port is held to Pillow."""

import io
import struct
import zlib

import numpy as np

from brdfnerf_tpu_torch.utils import jpeg, png

_FMT = {1: "B", 2: "B", 3: "H", 4: "I", 7: "B", 12: "d", 16: "Q"}
_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 7: 1, 12: 8, 16: 8}


def build_tiff(w, h, tags, segments, tiled=None, endian="<"):
    """A classic TIFF: tags {tag: (type, values or bytes)}, the segments'
    bytes as strips (tags hold RowsPerStrip) or tiles (tiled = (tw, th));
    width, height and the offsets and byte counts are filled in."""
    entries = dict(tags)
    entries[256] = (4, [w])
    entries[257] = (4, [h])
    data, offs = b"", []
    for s in segments:
        offs.append(8 + len(data))
        data += s + (b"\0" if len(s) % 2 else b"")
    counts = [len(s) for s in segments]
    if tiled:
        entries[322] = (3, [tiled[0]])
        entries[323] = (3, [tiled[1]])
        entries[324] = (4, offs)
        entries[325] = (4, counts)
    else:
        entries[273] = (4, offs)
        entries[279] = (4, counts)
    ifd_off = 8 + len(data)
    heap_off = ifd_off + 2 + 12 * len(entries) + 4
    heap, packed = b"", b""
    for tag in sorted(entries):
        typ, vals = entries[tag]
        if isinstance(vals, (bytes, bytearray)):
            payload = bytes(vals)
        else:
            payload = struct.pack(endian + _FMT[typ] * len(vals), *vals)
        count = len(payload) // _SIZE[typ]
        if len(payload) <= 4:
            packed += struct.pack(endian + "HHI", tag, typ, count)
            packed += payload.ljust(4, b"\0")
        else:
            packed += struct.pack(endian + "HHII", tag, typ, count,
                                  heap_off + len(heap))
            heap += payload + (b"\0" if len(payload) % 2 else b"")
    head = (b"II*\0" if endian == "<" else b"MM\0*")
    return (head + struct.pack(endian + "I", ifd_off) + data
            + struct.pack(endian + "H", len(entries)) + packed
            + struct.pack(endian + "I", 0) + heap)


def pil_jpeg(arr, **kw):
    from PIL import Image
    b = io.BytesIO()
    Image.fromarray(arr).save(b, "JPEG", **kw)
    return b.getvalue()


def markers(stream):
    """(marker, segment body) of each marker segment up to the first SOS."""
    pos = 2
    while pos + 4 <= len(stream) and stream[pos + 1] != 0xDA:
        ln = struct.unpack(">H", stream[pos + 2:pos + 4])[0]
        yield stream[pos + 1], stream[pos + 4:pos + 2 + ln]
        pos += 2 + ln


def libjpeg_ycc(stream):
    """Whether Pillow's JPEG decoder converts YCbCr -> RGB: libjpeg's
    default_decompress_parms guess for three components (JFIF, or an Adobe
    transform flag other than 0, or component ids other than 'R', 'G',
    'B')."""
    jfif, adobe, ids = False, -1, ()
    for m, seg in markers(stream):
        if m == 0xE0 and seg[:5] == b"JFIF\0":
            jfif = True
        elif m == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe = seg[11]
        elif m in (0xC0, 0xC1):
            ids = tuple(seg[6 + 3 * k] for k in range(seg[5]))
    if len(ids) != 3:
        return False
    if jfif:
        return True
    if adobe >= 0:
        return adobe != 0
    return ids != (82, 71, 66)


def split_tables(stream):
    """A whole JPEG stream -> (tables-only stream, abbreviated stream): the
    DQT and DHT segments move to the tables, as libtiff's JPEGTables."""
    tables, rest, pos = b"\xff\xd8", b"\xff\xd8", 2
    while True:
        m = stream[pos + 1]
        if m == 0xDA:
            rest += stream[pos:]
            return tables + b"\xff\xd9", rest
        ln = struct.unpack(">H", stream[pos + 2:pos + 4])[0]
        seg = stream[pos:pos + 2 + ln]
        if m in (0xDB, 0xC4):
            tables += seg
        else:
            rest += seg
        pos += 2 + ln


# ------------------------------------------------- a baseline JPEG encoder

def _std_tables():
    f = jpeg.parse(pil_jpeg(np.zeros((8, 8, 3), np.uint8)))
    s = f.scans[0]
    return s.dc[0], s.ac[0], s.dc[1], s.ac[1]


def _codes(table):
    counts, syms = table
    out, code, k = {}, 0, 0
    for ln in range(1, 17):
        for _ in range(counts[ln - 1]):
            out[syms[k]] = (code, ln)
            code += 1
            k += 1
        code <<= 1
    return out


def _dct_matrix():
    k = np.arange(8)
    c = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) * 0.5
    c[0] /= np.sqrt(2)
    return c


class _Writer:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, code, ln):
        self.acc = (self.acc << ln) | code
        self.n += ln
        while self.n >= 8:
            b = (self.acc >> (self.n - 8)) & 255
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)
            self.n -= 8

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _category(v):
    return 0 if v == 0 else int(abs(v)).bit_length()


def encode_jpeg(img, factors, restart=0, interleave=True, q=6,
                ids=(1, 2, 3), marker="jfif"):
    """A baseline JPEG of (h, w, nc) uint8 at the given (h, v) sampling
    factor of each component, box-downsampled, a flat quantisation table
    of q, the standard Huffman tables, DRI every `restart` MCUs, one
    interleaved scan or one scan a component."""
    h, w, nc = img.shape
    hm = max(f[0] for f in factors)
    vm = max(f[1] for f in factors)
    mx, my = -(-w // (8 * hm)), -(-h // (8 * vm))
    dct = _dct_matrix()
    tabs = [_std_tables()[:2], _std_tables()[2:]]
    comps = []
    for ci in range(nc):
        fh, fv = factors[ci]
        sh, sv = hm // fh, vm // fv
        dw, dh = -(-w * fh // hm), -(-h * fv // vm)
        pad = np.pad(img[..., ci].astype(np.float64),
                     ((0, dh * sv - h), (0, dw * sh - w)), mode="edge")
        plane = pad.reshape(dh, sv, dw, sh).mean((1, 3))
        bw = max(mx * fh, -(-dw // 8)) if interleave or nc == 1 else \
            -(-dw // 8)
        bh = max(my * fv, -(-dh // 8)) if interleave or nc == 1 else \
            -(-dh // 8)
        full = np.pad(plane, ((0, bh * 8 - dh), (0, bw * 8 - dw)),
                      mode="edge") - 128
        blocks = full.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        coef = np.rint(dct @ blocks @ dct.T / q).astype(np.int64)
        zz = coef.reshape(bh, bw, 64)[..., jpeg.NATURAL[:64]]
        comps.append((fh, fv, dw, dh, zz))

    def seg(m, body):
        return b"\xff" + bytes([m]) + struct.pack(">H", len(body) + 2) + body

    out = b"\xff\xd8"
    if marker == "jfif":
        out += seg(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")
    elif marker is not None:                     # Adobe transform flag
        out += seg(0xEE, b"Adobe\0\x64\0\0\0\0" + bytes([marker]))
    out += seg(0xDB, bytes([0]) + bytes([q] * 64))
    sof = struct.pack(">BHHB", 8, h, w, nc)
    for ci in range(nc):
        sof += bytes([ids[ci], (factors[ci][0] << 4) | factors[ci][1], 0])
    out += seg(0xC0, sof)
    for tc, th, t in ((0, 0, tabs[0][0]), (1, 0, tabs[0][1]),
                      (0, 1, tabs[1][0]), (1, 1, tabs[1][1])):
        out += seg(0xC4, bytes([(tc << 4) | th]) + bytes(t[0]) + bytes(t[1]))
    if restart:
        out += seg(0xDD, struct.pack(">H", restart))
    codes = [(_codes(tabs[0][0]), _codes(tabs[0][1])),
             (_codes(tabs[1][0]), _codes(tabs[1][1]))]
    scans = [list(range(nc))] if interleave else [[c] for c in range(nc)]
    for sc in scans:
        out += seg(0xDA, bytes([len(sc)]) + b"".join(
            bytes([ids[c], 0 if c == 0 else 0x11]) for c in sc) + b"\0\x3f\0")
        if len(sc) == 1:
            fh, fv, dw, dh, zz = comps[sc[0]]
            units = [[(sc[0], by, bx)] for by in range(-(-dh // 8))
                     for bx in range(-(-dw // 8))]
        else:
            units = [[(c, y * comps[c][1] + j, x * comps[c][0] + i)
                      for c in sc for j in range(comps[c][1])
                      for i in range(comps[c][0])]
                     for y in range(my) for x in range(mx)]
        wr, pred = _Writer(), [0] * nc
        for k, unit in enumerate(units):
            if restart and k and k % restart == 0:
                wr.flush()
                wr.out += bytes([0xFF, 0xD0 + (k // restart - 1) % 8])
                pred = [0] * nc
            for c, by, bx in unit:
                dc_codes, ac_codes = codes[min(c, 1)]
                z = comps[c][4][by, bx]
                diff = int(z[0]) - pred[c]
                pred[c] = int(z[0])
                s = _category(diff)
                wr.put(*dc_codes[s])
                if s:
                    wr.put(diff if diff > 0 else diff + (1 << s) - 1, s)
                run = 0
                last = max([i for i in range(1, 64) if z[i]] or [0])
                for i in range(1, last + 1):
                    v = int(z[i])
                    if v == 0:
                        run += 1
                        continue
                    while run > 15:
                        wr.put(*ac_codes[0xF0])
                        run -= 16
                    s = _category(v)
                    wr.put(*ac_codes[(run << 4) | s])
                    wr.put(v if v > 0 else v + (1 << s) - 1, s)
                    run = 0
                if last < 63:
                    wr.put(*ac_codes[0x00])
        wr.flush()
        out += bytes(wr.out)
    return out + b"\xff\xd9"


# -------------------------------------------------------------------- PNG

def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png_any(samples, depth, ctype, interlace=False, seed=0):
    """A PNG of (h, w, n) integer samples at any depth and colour type,
    Adam7 or not, each row with a random filter type."""
    rng = np.random.default_rng(seed)
    h, w, n = samples.shape
    passes = png.ADAM7 if interlace else ((0, 0, 1, 1),)
    out = bytearray()
    for y0, x0, dy, dx in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        r, c = sub.shape[:2]
        if depth == 16:
            rows = sub.astype(">u2").reshape(r, c * n).view(np.uint8)
            rows = rows.reshape(r, -1)
        elif depth == 8:
            rows = sub.astype(np.uint8).reshape(r, c * n)
        else:
            vals = sub.reshape(r, c * n).astype(np.uint8)
            bits = np.unpackbits(vals[..., None], axis=-1)[..., 8 - depth:]
            rows = np.packbits(bits.reshape(r, -1), axis=1)
        bpp = max(1, n * depth // 8)
        x = rows.astype(np.int16)
        up = np.zeros_like(x)
        up[1:] = x[:-1]
        preds = png._predictors(x, up, bpp)
        for y in range(r):
            kind = int(rng.integers(0, 5))
            out.append(kind)
            out += ((x[y] - preds[kind][y]) & 255).astype(np.uint8).tobytes()
    head = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace))
    extra = _chunk(b"PLTE", bytes(range(48)) * 16) if ctype == 3 else b""
    return (png.SIGNATURE + _chunk(b"IHDR", head) + extra
            + _chunk(b"IDAT", zlib.compress(bytes(out)))
            + _chunk(b"IEND", b""))
