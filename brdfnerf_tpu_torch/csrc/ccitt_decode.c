/* CCITT bilevel decoding on the host (TIFF compressions 2, 3 and 4): the
 * procedure of utils/ccitt.py's decode_plain, its Python twin, step for
 * step.  Plain C interface, loaded with ctypes by utils/ccitt.py.
 *
 * ccitt_decode: `data` holds one strip or tile (its bits already in
 * MSB-first order); `out` receives `rows` rows of (width + 7) / 8 bytes,
 * packed MSB-first, 1 for black.  comp 2: Modified Huffman rows, each
 * starting on a byte boundary; comp 3: T.4, an EOL before each row,
 * t4_options bit 0 for 2-D coding (a tag bit after the EOL: 1 for a 1-D
 * row); comp 4: T.6.  Returns 0, or 1 (no code matches), 2 (expected an
 * EOL), 3 (uncompressed mode), 4 (out of memory), 5 (unknown
 * compression).
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

typedef struct { int len; int code; int value; } code_t;

/* the codes as strings, turned into (len, code) at each call */
typedef struct { int value; const char *bits; } src_t;

static const src_t white_src[] = {
    {0, "00110101"}, {1, "000111"}, {2, "0111"}, {3, "1000"}, {4, "1011"},
    {5, "1100"}, {6, "1110"}, {7, "1111"}, {8, "10011"}, {9, "10100"},
    {10, "00111"}, {11, "01000"}, {12, "001000"}, {13, "000011"},
    {14, "110100"}, {15, "110101"}, {16, "101010"}, {17, "101011"},
    {18, "0100111"}, {19, "0001100"}, {20, "0001000"}, {21, "0010111"},
    {22, "0000011"}, {23, "0000100"}, {24, "0101000"}, {25, "0101011"},
    {26, "0010011"}, {27, "0100100"}, {28, "0011000"}, {29, "00000010"},
    {30, "00000011"}, {31, "00011010"}, {32, "00011011"}, {33, "00010010"},
    {34, "00010011"}, {35, "00010100"}, {36, "00010101"}, {37, "00010110"},
    {38, "00010111"}, {39, "00101000"}, {40, "00101001"}, {41, "00101010"},
    {42, "00101011"}, {43, "00101100"}, {44, "00101101"}, {45, "00000100"},
    {46, "00000101"}, {47, "00001010"}, {48, "00001011"}, {49, "01010010"},
    {50, "01010011"}, {51, "01010100"}, {52, "01010101"}, {53, "00100100"},
    {54, "00100101"}, {55, "01011000"}, {56, "01011001"}, {57, "01011010"},
    {58, "01011011"}, {59, "01001010"}, {60, "01001011"}, {61, "00110010"},
    {62, "00110011"}, {63, "00110100"},
    {64, "11011"}, {128, "10010"}, {192, "010111"}, {256, "0110111"},
    {320, "00110110"}, {384, "00110111"}, {448, "01100100"},
    {512, "01100101"}, {576, "01101000"}, {640, "01100111"},
    {704, "011001100"}, {768, "011001101"}, {832, "011010010"},
    {896, "011010011"}, {960, "011010100"}, {1024, "011010101"},
    {1088, "011010110"}, {1152, "011010111"}, {1216, "011011000"},
    {1280, "011011001"}, {1344, "011011010"}, {1408, "011011011"},
    {1472, "010011000"}, {1536, "010011001"}, {1600, "010011010"},
    {1664, "011000"}, {1728, "010011011"}};

static const src_t black_src[] = {
    {0, "0000110111"}, {1, "010"}, {2, "11"}, {3, "10"}, {4, "011"},
    {5, "0011"}, {6, "0010"}, {7, "00011"}, {8, "000101"}, {9, "000100"},
    {10, "0000100"}, {11, "0000101"}, {12, "0000111"}, {13, "00000100"},
    {14, "00000111"}, {15, "000011000"}, {16, "0000010111"},
    {17, "0000011000"}, {18, "0000001000"}, {19, "00001100111"},
    {20, "00001101000"}, {21, "00001101100"}, {22, "00000110111"},
    {23, "00000101000"}, {24, "00000010111"}, {25, "00000011000"},
    {26, "000011001010"}, {27, "000011001011"}, {28, "000011001100"},
    {29, "000011001101"}, {30, "000001101000"}, {31, "000001101001"},
    {32, "000001101010"}, {33, "000001101011"}, {34, "000011010010"},
    {35, "000011010011"}, {36, "000011010100"}, {37, "000011010101"},
    {38, "000011010110"}, {39, "000011010111"}, {40, "000001101100"},
    {41, "000001101101"}, {42, "000011011010"}, {43, "000011011011"},
    {44, "000001010100"}, {45, "000001010101"}, {46, "000001010110"},
    {47, "000001010111"}, {48, "000001100100"}, {49, "000001100101"},
    {50, "000001010010"}, {51, "000001010011"}, {52, "000000100100"},
    {53, "000000110111"}, {54, "000000111000"}, {55, "000000100111"},
    {56, "000000101000"}, {57, "000001011000"}, {58, "000001011001"},
    {59, "000000101011"}, {60, "000000101100"}, {61, "000001011010"},
    {62, "000001100110"}, {63, "000001100111"},
    {64, "0000001111"}, {128, "000011001000"}, {192, "000011001001"},
    {256, "000001011011"}, {320, "000000110011"}, {384, "000000110100"},
    {448, "000000110101"}, {512, "0000001101100"}, {576, "0000001101101"},
    {640, "0000001001010"}, {704, "0000001001011"}, {768, "0000001001100"},
    {832, "0000001001101"}, {896, "0000001110010"}, {960, "0000001110011"},
    {1024, "0000001110100"}, {1088, "0000001110101"},
    {1152, "0000001110110"}, {1216, "0000001110111"},
    {1280, "0000001010010"}, {1344, "0000001010011"},
    {1408, "0000001010100"}, {1472, "0000001010101"},
    {1536, "0000001011010"}, {1600, "0000001011011"},
    {1664, "0000001100100"}, {1728, "0000001100101"}};

static const src_t extended_src[] = {
    {1792, "00000001000"}, {1856, "00000001100"}, {1920, "00000001101"},
    {1984, "000000010010"}, {2048, "000000010011"}, {2112, "000000010100"},
    {2176, "000000010101"}, {2240, "000000010110"}, {2304, "000000010111"},
    {2368, "000000011100"}, {2432, "000000011101"}, {2496, "000000011110"},
    {2560, "000000011111"}};

#define MODE_P 100
#define MODE_H 101
static const src_t mode_src[] = {
    {MODE_P, "0001"}, {MODE_H, "001"}, {0, "1"}, {1, "011"}, {2, "000011"},
    {3, "0000011"}, {-1, "010"}, {-2, "000010"}, {-3, "0000010"}};

#define NW (sizeof white_src / sizeof *white_src)
#define NB (sizeof black_src / sizeof *black_src)
#define NE (sizeof extended_src / sizeof *extended_src)
#define NM (sizeof mode_src / sizeof *mode_src)

typedef struct {
    code_t white[NW + NE], black[NB + NE], modes[NM];
} tables_t;

static void to_code(const src_t *s, code_t *c) {
    c->len = (int)strlen(s->bits);
    c->code = 0;
    for (int i = 0; i < c->len; ++i) c->code = (c->code << 1) | (s->bits[i] - '0');
    c->value = s->value;
}

static void build(tables_t *t) {
    for (size_t i = 0; i < NW; ++i) to_code(&white_src[i], &t->white[i]);
    for (size_t i = 0; i < NB; ++i) to_code(&black_src[i], &t->black[i]);
    for (size_t i = 0; i < NE; ++i) {
        to_code(&extended_src[i], &t->white[NW + i]);
        to_code(&extended_src[i], &t->black[NB + i]);
    }
    for (size_t i = 0; i < NM; ++i) to_code(&mode_src[i], &t->modes[i]);
}

typedef struct {
    const uint8_t *data;
    int64_t n;                   /* bits */
    int64_t pos;
} bits_t;

static inline int bit(bits_t *b) {
    int64_t p = b->pos++;
    return p < b->n ? (b->data[p >> 3] >> (7 - (p & 7))) & 1 : 0;
}

/* the code among `tab` that the next bits spell, shortest first (the
 * codes are prefix-free); -1000 if none of up to `limit` bits does */
static int code(bits_t *b, const code_t *tab, int ntab, int limit) {
    int c = 0;
    for (int len = 1; len <= limit; ++len) {
        c = (c << 1) | bit(b);
        for (int i = 0; i < ntab; ++i)
            if (tab[i].len == len && tab[i].code == c) return tab[i].value;
    }
    return -1000;
}

static int run(bits_t *b, const tables_t *t, int colour, int *total) {
    *total = 0;
    for (;;) {
        int v = colour ? code(b, t->black, (int)(NB + NE), 13)
                       : code(b, t->white, (int)(NW + NE), 13);
        if (v < 0) return 1;
        *total += v;
        if (v < 64) return 0;
    }
}

/* fill bits and an EOL if they come next; 0 also at the end of the data */
static int eol(bits_t *b) {
    int zeros = 0;
    while (b->pos < b->n) {
        if (bit(b)) return zeros >= 11 ? 0 : 2;
        ++zeros;
    }
    return 0;
}

static int64_t clamp64(int64_t v, int64_t lo, int64_t hi) {
    return v < lo ? lo : v > hi ? hi : v;
}

static int row_1d(bits_t *b, const tables_t *t, int64_t width, int64_t *ch,
                  int64_t cap, int64_t *nch) {
    int64_t a0 = 0, n = 0;
    int colour = 0;
    while (a0 < width) {
        int r;
        if (run(b, t, colour, &r)) return 1;
        a0 = clamp64(a0 + r, 0, width);
        if (n >= cap) return 4;
        ch[n++] = a0;
        colour ^= 1;
    }
    *nch = n;
    return 0;
}

/* refs: nref changing elements of the reference row, then width, width */
static int row_2d(bits_t *b, const tables_t *t, const int64_t *refs,
                  int64_t nref, int64_t width, int64_t *ch, int64_t cap,
                  int64_t *nch) {
    int64_t a0 = -1, i = 0, n = 0, last = nref + 1;
    int colour = 0;
    while (a0 < width) {
        while (refs[i] <= a0 && refs[i] < width) ++i;
        if ((i & 1) != colour) ++i;
        int64_t b1 = refs[i < last ? i : last];
        int64_t b2 = refs[i + 1 < last ? i + 1 : last];
        int mode = code(b, t->modes, (int)NM, 7);
        if (mode == -1000) return 1;
        if (mode == MODE_P) {
            a0 = b2;
        } else if (mode == MODE_H) {
            int r1, r2;
            int64_t start = a0 > 0 ? a0 : 0;
            if (run(b, t, colour, &r1)) return 1;
            int64_t a1 = clamp64(start + r1, 0, width);
            if (run(b, t, colour ^ 1, &r2)) return 1;
            int64_t a2 = clamp64(a1 + r2, 0, width);
            if (n + 2 > cap) return 4;
            ch[n++] = a1;
            ch[n++] = a2;
            a0 = a2;
        } else {
            int64_t a1 = clamp64(b1 + mode, 0, width);
            if (n >= cap) return 4;
            ch[n++] = a1;
            a0 = a1;
            colour ^= 1;
        }
        while (i > 0 && refs[i - 1] > a0) --i;
    }
    *nch = n;
    return 0;
}

int ccitt_decode(const uint8_t *data, int64_t len, int64_t rows,
                 int64_t width, int comp, int t4_options, uint8_t *out) {
    if (comp == 3 && (t4_options & 2)) return 3;
    if (comp < 2 || comp > 4) return 5;
    tables_t t;
    build(&t);
    bits_t b = {data, len * 8, 0};
    int64_t cap = 2 * width + 8;
    int64_t *ref = malloc((size_t)(cap + 2) * sizeof(int64_t));
    int64_t *cur = malloc((size_t)(cap + 2) * sizeof(int64_t));
    if (!ref || !cur) {
        free(ref);
        free(cur);
        return 4;
    }
    int64_t nref = 0, stride = (width + 7) / 8;
    int err = 0;
    for (int64_t y = 0; y < rows && !err; ++y) {
        int64_t ncur = 0;
        ref[nref] = width;
        ref[nref + 1] = width;
        if (comp == 2) {
            err = row_1d(&b, &t, width, cur, cap, &ncur);
            b.pos = (b.pos + 7) / 8 * 8;
        } else if (comp == 3) {
            err = eol(&b);
            if (!err) {
                if ((t4_options & 1) && !bit(&b))
                    err = row_2d(&b, &t, ref, nref, width, cur, cap, &ncur);
                else
                    err = row_1d(&b, &t, width, cur, cap, &ncur);
            }
        } else {
            err = row_2d(&b, &t, ref, nref, width, cur, cap, &ncur);
        }
        if (err) break;
        /* black runs: [cur[0], cur[1]), [cur[2], cur[3]), ... */
        uint8_t *row = out + y * stride;
        for (int64_t k = 0; k + 1 < ncur; k += 2)
            for (int64_t x = cur[k]; x < cur[k + 1]; ++x)
                row[x >> 3] |= (uint8_t)(0x80 >> (x & 7));
        nref = 0;
        for (int64_t k = 0; k < ncur; ++k)
            if (cur[k] < width) ref[nref++] = cur[k];
    }
    free(ref);
    free(cur);
    return err;
}
