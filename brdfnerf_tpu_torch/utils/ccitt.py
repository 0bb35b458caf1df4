"""CCITT bilevel decoding for the port's TIFF reader, with no PIL: the
masks the JAX package reads through Pillow (libtiff's tif_fax3) decode
here to the same bits.

  compression 2  Modified Huffman run lengths (T.4 1-D codes, no EOL),
                 every row starting on a byte boundary;
  compression 3  T.4: every row after an EOL (fill bits before it
                 allowed); T4Options (tag 292) bit 0 set means 2-D coding,
                 where a tag bit after the EOL says 1-D (1) or 2-D (0);
  compression 4  T.6: 2-D rows, no EOLs, the first row coded against an
                 all-white line.

Rows come out packed MSB-first, padded to a byte, 1 for a black run (as
libtiff writes them; photometric and FillOrder are the caller's, see
utils/geotiff).  Two implementations of one procedure:
  decode        the host C library csrc/ccitt_decode.c (ops/cuda_build.
                load_host), which the reader calls;
  decode_plain  its Python twin, which the tests and chip_smoke.py hold the
                library to, bit for bit.
A failure of the library's build or call raises; nothing falls back to
the twin.  Uncompressed mode (T4Options bit 1) and the 2-D extension codes
raise UnsupportedTiffFeature.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import numpy as np

from .geotiff import UnsupportedTiffFeature

# (run length, code) of T.4's terminating and make-up codes
WHITE = [
    (0, "00110101"), (1, "000111"), (2, "0111"), (3, "1000"), (4, "1011"),
    (5, "1100"), (6, "1110"), (7, "1111"), (8, "10011"), (9, "10100"),
    (10, "00111"), (11, "01000"), (12, "001000"), (13, "000011"),
    (14, "110100"), (15, "110101"), (16, "101010"), (17, "101011"),
    (18, "0100111"), (19, "0001100"), (20, "0001000"), (21, "0010111"),
    (22, "0000011"), (23, "0000100"), (24, "0101000"), (25, "0101011"),
    (26, "0010011"), (27, "0100100"), (28, "0011000"), (29, "00000010"),
    (30, "00000011"), (31, "00011010"), (32, "00011011"), (33, "00010010"),
    (34, "00010011"), (35, "00010100"), (36, "00010101"), (37, "00010110"),
    (38, "00010111"), (39, "00101000"), (40, "00101001"), (41, "00101010"),
    (42, "00101011"), (43, "00101100"), (44, "00101101"), (45, "00000100"),
    (46, "00000101"), (47, "00001010"), (48, "00001011"), (49, "01010010"),
    (50, "01010011"), (51, "01010100"), (52, "01010101"), (53, "00100100"),
    (54, "00100101"), (55, "01011000"), (56, "01011001"), (57, "01011010"),
    (58, "01011011"), (59, "01001010"), (60, "01001011"), (61, "00110010"),
    (62, "00110011"), (63, "00110100"),
    (64, "11011"), (128, "10010"), (192, "010111"), (256, "0110111"),
    (320, "00110110"), (384, "00110111"), (448, "01100100"),
    (512, "01100101"), (576, "01101000"), (640, "01100111"),
    (704, "011001100"), (768, "011001101"), (832, "011010010"),
    (896, "011010011"), (960, "011010100"), (1024, "011010101"),
    (1088, "011010110"), (1152, "011010111"), (1216, "011011000"),
    (1280, "011011001"), (1344, "011011010"), (1408, "011011011"),
    (1472, "010011000"), (1536, "010011001"), (1600, "010011010"),
    (1664, "011000"), (1728, "010011011")]
BLACK = [
    (0, "0000110111"), (1, "010"), (2, "11"), (3, "10"), (4, "011"),
    (5, "0011"), (6, "0010"), (7, "00011"), (8, "000101"), (9, "000100"),
    (10, "0000100"), (11, "0000101"), (12, "0000111"), (13, "00000100"),
    (14, "00000111"), (15, "000011000"), (16, "0000010111"),
    (17, "0000011000"), (18, "0000001000"), (19, "00001100111"),
    (20, "00001101000"), (21, "00001101100"), (22, "00000110111"),
    (23, "00000101000"), (24, "00000010111"), (25, "00000011000"),
    (26, "000011001010"), (27, "000011001011"), (28, "000011001100"),
    (29, "000011001101"), (30, "000001101000"), (31, "000001101001"),
    (32, "000001101010"), (33, "000001101011"), (34, "000011010010"),
    (35, "000011010011"), (36, "000011010100"), (37, "000011010101"),
    (38, "000011010110"), (39, "000011010111"), (40, "000001101100"),
    (41, "000001101101"), (42, "000011011010"), (43, "000011011011"),
    (44, "000001010100"), (45, "000001010101"), (46, "000001010110"),
    (47, "000001010111"), (48, "000001100100"), (49, "000001100101"),
    (50, "000001010010"), (51, "000001010011"), (52, "000000100100"),
    (53, "000000110111"), (54, "000000111000"), (55, "000000100111"),
    (56, "000000101000"), (57, "000001011000"), (58, "000001011001"),
    (59, "000000101011"), (60, "000000101100"), (61, "000001011010"),
    (62, "000001100110"), (63, "000001100111"),
    (64, "0000001111"), (128, "000011001000"), (192, "000011001001"),
    (256, "000001011011"), (320, "000000110011"), (384, "000000110100"),
    (448, "000000110101"), (512, "0000001101100"), (576, "0000001101101"),
    (640, "0000001001010"), (704, "0000001001011"), (768, "0000001001100"),
    (832, "0000001001101"), (896, "0000001110010"), (960, "0000001110011"),
    (1024, "0000001110100"), (1088, "0000001110101"),
    (1152, "0000001110110"), (1216, "0000001110111"),
    (1280, "0000001010010"), (1344, "0000001010011"),
    (1408, "0000001010100"), (1472, "0000001010101"),
    (1536, "0000001011010"), (1600, "0000001011011"),
    (1664, "0000001100100"), (1728, "0000001100101")]
# make-up codes common to both colours
EXTENDED = [
    (1792, "00000001000"), (1856, "00000001100"), (1920, "00000001101"),
    (1984, "000000010010"), (2048, "000000010011"), (2112, "000000010100"),
    (2176, "000000010101"), (2240, "000000010110"), (2304, "000000010111"),
    (2368, "000000011100"), (2432, "000000011101"), (2496, "000000011110"),
    (2560, "000000011111")]
# 2-D mode codes: pass, horizontal, vertical a1 - b1 = -3 .. 3
P, H = "P", "H"
MODES = [(P, "0001"), (H, "001"), (0, "1"), (1, "011"), (2, "000011"),
         (3, "0000011"), (-1, "010"), (-2, "000010"), (-3, "0000010")]
EOL_BITS = 12


def _table(codes) -> Dict[Tuple[int, int], object]:
    return {(len(c), int(c, 2)): v for v, c in codes}


_RUNS = (_table(WHITE + EXTENDED), _table(BLACK + EXTENDED))
_MODES = _table(MODES)


class _Bits:
    """MSB-first bits of a segment; zeros past its end."""

    def __init__(self, data: bytes):
        self.bits = np.unpackbits(np.frombuffer(data, np.uint8)).tolist()
        self.n = len(self.bits)
        self.pos = 0

    def bit(self) -> int:
        p = self.pos
        self.pos = p + 1
        return self.bits[p] if p < self.n else 0

    def code(self, table, limit=13):
        c = 0
        for ln in range(1, limit + 1):
            c = (c << 1) | self.bit()
            if (ln, c) in table:
                return table[ln, c]
        raise ValueError(f"CCITT: no code at bit {self.pos - limit}")

    def run(self, colour: int) -> int:
        """A run: make-up codes then a terminating code (< 64)."""
        total = 0
        while True:
            v = self.code(_RUNS[colour])
            total += v
            if v < 64:
                return total

    def eol(self) -> bool:
        """Skip fill bits and an EOL (eleven or more zeros, then a one) if
        they come next; False at the end of the data."""
        zeros = 0
        while self.pos < self.n:
            if self.bit():
                if zeros >= 11:
                    return True
                raise ValueError(f"CCITT: expected an EOL at bit "
                                 f"{self.pos - zeros - 1}")
            zeros += 1
        return False

    def align(self):
        self.pos = (self.pos + 7) // 8 * 8


def _row_1d(bits: _Bits, width: int) -> List[int]:
    """Changing elements of a 1-D coded row: positions where the colour
    changes, white first."""
    changes, a0, colour = [], 0, 0
    while a0 < width:
        a0 = min(a0 + bits.run(colour), width)
        changes.append(a0)
        colour ^= 1
    return changes


def _row_2d(bits: _Bits, ref: List[int], width: int) -> List[int]:
    """Changing elements of a 2-D coded row against the reference row's
    (T.4 section 4.2)."""
    refs = ref + [width, width]
    changes: List[int] = []
    a0, colour, i = -1, 0, 0
    while a0 < width:
        # b1: the first changing element on the reference line right of a0
        # of the colour opposite to a0's (even index: to black)
        while refs[i] <= a0 and refs[i] < width:
            i += 1
        if (i & 1) != colour:
            i += 1
        b1, b2 = refs[min(i, len(refs) - 1)], refs[min(i + 1, len(refs) - 1)]
        mode = bits.code(_MODES, 7)
        if mode == P:
            a0 = b2
        elif mode == H:
            start = max(a0, 0)
            a1 = min(start + bits.run(colour), width)
            a2 = min(a1 + bits.run(colour ^ 1), width)
            changes += [a1, a2]
            a0 = a2
        else:
            a1 = min(max(b1 + mode, 0), width)
            changes.append(a1)
            a0 = a1
            colour ^= 1
        while i > 0 and refs[i - 1] > a0:
            i -= 1
    return changes


def _pack(rows: List[List[int]], width: int) -> bytes:
    out = np.zeros((len(rows), width), np.uint8)
    for y, changes in enumerate(rows):
        edges = [0] + changes
        for k in range(1, len(edges) - 1, 2):     # black runs
            out[y, edges[k]:edges[k + 1]] = 1
    return np.packbits(out, axis=1).tobytes()


def decode_plain(data: bytes, rows: int, width: int, comp: int,
                 t4_options: int = 0) -> bytes:
    """Python twin of csrc/ccitt_decode.c: rows packed MSB-first, padded to
    a byte, 1 for black."""
    if comp == 3 and t4_options & 2:
        raise UnsupportedTiffFeature("CCITT T.4 uncompressed mode "
                                     "(T4Options bit 1) is not supported")
    bits = _Bits(data)
    out: List[List[int]] = []
    ref: List[int] = []
    for _ in range(rows):
        if comp == 2:
            row = _row_1d(bits, width)
            bits.align()
        elif comp == 3:
            bits.eol()
            if t4_options & 1 and not bits.bit():
                row = _row_2d(bits, ref, width)
            else:
                row = _row_1d(bits, width)
        elif comp == 4:
            row = _row_2d(bits, ref, width)
        else:
            raise ValueError(f"CCITT: compression {comp} (2, 3 or 4)")
        out.append(row)
        ref = [c for c in row if c < width] if row else []
    return _pack(out, width)


# ------------------------------------------------------------ the library

_ERRORS = {1: "bad code", 2: "expected an EOL", 3: "uncompressed mode",
           4: "out of memory", 5: "unknown compression"}


def decode(data: bytes, rows: int, width: int, comp: int,
           t4_options: int = 0) -> bytes:
    """The host C library's decode: decode_plain's bytes."""
    if comp == 3 and t4_options & 2:
        raise UnsupportedTiffFeature("CCITT T.4 uncompressed mode "
                                     "(T4Options bit 1) is not supported")
    from ..ops.cuda_build import load_host
    fn = load_host("ccitt_decode").ccitt_decode
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = np.zeros(rows * ((width + 7) // 8), np.uint8)
    err = fn(data, len(data), rows, width, comp, t4_options,
             out.ctypes.data)
    if err:
        raise ValueError(f"CCITT: {_ERRORS.get(err, f'error {err}')} "
                         f"(host decoder)")
    return out.tobytes()
