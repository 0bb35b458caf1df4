/* Baseline JPEG decoding on the host: the arithmetic of libjpeg-turbo 3.1
 * with its default decompression parameters, which is what Pillow (and so
 * the JAX package) gives for a JPEG-in-TIFF.  Plain C interface, loaded
 * with ctypes by utils/jpeg.py, whose decode_plain is the NumPy twin of
 * every step here.
 *
 *   Huffman decoding of sequential frames (SOF0/SOF1, 8-bit, 1 or 3
 *   components), interleaved or one-component scans, DRI restart
 *   intervals, abbreviated streams with their tables in a separate
 *   tables-only stream (a TIFF's JPEGTables);
 *   jidctint.c's islow inverse DCT, outputs clamped to 0..255;
 *   jdsample.c's fancy upsampling (h2v1 and h2v2 when the component is
 *   more than 2 samples wide, h1v2), box replication otherwise;
 *   jdcolor.c's fixed-point YCbCr -> RGB.
 *
 * mode 0 writes the components upsampled and interleaved (H, W, C), mode 1
 * the same converted YCbCr -> RGB, mode 2 each component's plane at its
 * downsampled size, one after the other (libjpeg's raw_data_out, which
 * libtiff's old-style JPEG reads).
 *
 * The caller (utils/jpeg.py) parses the markers first: it refuses the
 * frames out of scope with their names and sizes `out` from the frame
 * header, so the codes returned here are for corrupt data.
 *
 * jpeg_decode returns 0, or 1 (bad marker structure), 2 (no frame or no
 * scan), 3 (bad Huffman code), 4 (undefined table), 5 (out of memory),
 * 6 (frame out of scope), 7 (out_size is not what the mode writes), 8 (a
 * table libjpeg refuses: a DHT whose code counts overflow the code space or
 * that holds more than 256 symbols, a table id above 3).  parse() refuses
 * every table before it is built, so no look-up index leaves its array.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define MAXC 4

#define LOOK 9                   /* bits of the look-up table */

typedef struct {
    int defined;
    int32_t mincode[17], maxcode[18], valptr[17];
    uint8_t vals[256];
    uint8_t look_len[1 << LOOK], look_sym[1 << LOOK];  /* codes <= LOOK */
} huff_t;

typedef struct {
    int cid, h, v, tq;
    int dw, dh, bw, bh;          /* downsampled size, blocks as stored */
    int16_t *coef;               /* bh * bw * 64, natural order */
} comp_t;

typedef struct {
    int qt_defined[4];
    int32_t qt[4][64];
    huff_t dc[4], ac[4];
    int restart;
    int width, height, nc, have_frame, nscans;
    comp_t comp[MAXC];
} dec_t;

static const int natural[80] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50,
    43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63,
    63, 63, 63, 63, 63, 63};

/* jdhuff.c's check: at each length the codes so far stay below all ones */
static int huff_fits(const uint8_t *counts, int nsym) {
    int32_t code = 0;
    if (nsym > 256) return 0;
    for (int l = 1; l <= 16; ++l) {
        code += counts[l - 1];
        if (code >= (int32_t)1 << l) return 0;
        code <<= 1;
    }
    return 1;
}

/* counts and nsym have passed huff_fits */
static void build_huff(huff_t *t, const uint8_t *counts, const uint8_t *syms,
                       int nsym) {
    int code = 0, k = 0;
    memset(t, 0, sizeof *t);
    memcpy(t->vals, syms, (size_t)nsym);
    for (int l = 1; l <= 16; ++l) {
        t->valptr[l] = k;
        t->mincode[l] = code;
        code += counts[l - 1];
        k += counts[l - 1];
        t->maxcode[l] = counts[l - 1] ? code - 1 : -1;
        code <<= 1;
    }
    t->maxcode[17] = 0x7fffffff;
    code = 0;
    k = 0;
    for (int l = 1; l <= LOOK; ++l) {
        for (int i = 0; i < counts[l - 1]; ++i, ++code, ++k) {
            int lo = code << (LOOK - l), hi = (code + 1) << (LOOK - l);
            for (int j = lo; j < hi; ++j) {
                t->look_len[j] = (uint8_t)l;
                t->look_sym[j] = t->vals[k & 255];
            }
        }
        code <<= 1;
    }
    t->defined = 1;
}

/* ------------------------------------------------------------ bit reader */

typedef struct {
    const uint8_t *p, *end;      /* entropy data of the scan */
    uint32_t acc;
    int n;
    int at_marker;               /* a marker stopped the reader at p */
} bits_t;

static void fill(bits_t *b) {
    while (b->n <= 24) {
        uint32_t c = 0;
        if (!b->at_marker && b->p < b->end) {
            c = *b->p;
            if (c == 0xFF) {
                const uint8_t *q = b->p + 1;
                while (q < b->end && *q == 0xFF) ++q;
                if (q < b->end && *q == 0) {
                    b->p = q + 1;
                } else {
                    b->at_marker = 1;     /* zeros from here, as libjpeg */
                    b->p = q;
                    c = 0;
                }
            } else {
                ++b->p;
            }
        } else {
            b->at_marker = 1;
        }
        b->acc |= c << (24 - b->n);
        b->n += 8;
    }
}

static inline int get_bits(bits_t *b, int s) {
    if (s == 0) return 0;
    if (b->n < s) fill(b);
    int v = (int)(b->acc >> (32 - s));
    b->acc <<= s;
    b->n -= s;
    return v;
}

/* skip to just past the next RSTn marker (the end of a restart interval) */
static void restart(bits_t *b) {
    const uint8_t *q = b->p;
    int stopped = b->at_marker;
    b->acc = 0;
    b->n = 0;
    b->at_marker = 0;
    if (stopped && q < b->end) {     /* the reader stopped at the marker */
        b->p = (*q >= 0xD0 && *q <= 0xD7) ? q + 1 : q;
        return;
    }
    while (q < b->end) {
        if (*q != 0xFF) { ++q; continue; }
        ++q;
        while (q < b->end && *q == 0xFF) ++q;
        if (q >= b->end) break;
        if (*q == 0) { ++q; continue; }
        if (*q >= 0xD0 && *q <= 0xD7) { ++q; break; }
        break;
    }
    b->p = q;
}

static int decode_sym(bits_t *b, const huff_t *t) {
    if (b->n < 16) fill(b);
    int peek = (int)(b->acc >> (32 - LOOK)), l0 = t->look_len[peek];
    if (l0) {
        b->acc <<= l0;
        b->n -= l0;
        return t->look_sym[peek];
    }
    int code = 0;
    for (int l = 1; l <= 16; ++l) {
        code = (code << 1) | (int)(b->acc >> 31);
        b->acc <<= 1;
        b->n -= 1;
        if (t->maxcode[l] >= 0 && code <= t->maxcode[l])
            return t->vals[(t->valptr[l] + code - t->mincode[l]) & 255];
    }
    return -1;
}

static inline int extend(int r, int s) {
    return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r;
}

/* end of the entropy data at p: the first marker other than RSTn */
static const uint8_t *scan_end(const uint8_t *p, const uint8_t *end) {
    while (p < end) {
        if (*p != 0xFF) { ++p; continue; }
        const uint8_t *q = p + 1;
        while (q < end && *q == 0xFF) ++q;
        if (q >= end) return end;
        if (*q == 0 || (*q >= 0xD0 && *q <= 0xD7)) { p = q + 1; continue; }
        return q - 1;
    }
    return end;
}

static int decode_block(bits_t *b, const huff_t *dc, const huff_t *ac,
                        int *pred, int16_t *blk) {
    int s = decode_sym(b, dc);
    if (s < 0 || s > 15) return 3;          /* a DC size past 15: corrupt */
    int diff = s ? extend(get_bits(b, s), s) : 0;
    *pred += diff;
    blk[0] = (int16_t)*pred;
    for (int k = 1; k < 64;) {
        int rs = decode_sym(b, ac);
        if (rs < 0) return 3;
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
            k += r;
            blk[natural[k]] = (int16_t)extend(get_bits(b, s), s);
            ++k;
        } else if (r == 15) {
            k += 16;
        } else {
            break;
        }
    }
    return 0;
}

static int decode_scan(dec_t *d, const uint8_t *seg, const uint8_t *p,
                       const uint8_t *end, const uint8_t **next) {
    int ns = seg[0];
    int ci[MAXC], td[MAXC], ta[MAXC], blocks = 0;
    if (ns < 1 || ns > d->nc) return 1;
    for (int k = 0; k < ns; ++k) {
        int cid = seg[1 + 2 * k], t = seg[2 + 2 * k];
        ci[k] = -1;
        for (int c = 0; c < d->nc; ++c)
            if (d->comp[c].cid == cid) ci[k] = c;
        if (ci[k] < 0) return 1;
        td[k] = t >> 4;
        ta[k] = t & 15;
        blocks += d->comp[ci[k]].h * d->comp[ci[k]].v;
        if (td[k] > 3 || ta[k] > 3 || !d->dc[td[k]].defined ||
            !d->ac[ta[k]].defined)
            return 4;
    }
    if (ns > 1 && blocks > 10) return 6;     /* libjpeg's MCU limit */
    const uint8_t *stop = scan_end(p, end);
    *next = stop;
    bits_t b = {p, stop, 0, 0, 0};
    int pred[MAXC] = {0};
    int hm = 1, vm = 1;
    for (int c = 0; c < d->nc; ++c) {
        if (d->comp[c].h > hm) hm = d->comp[c].h;
        if (d->comp[c].v > vm) vm = d->comp[c].v;
    }
    int64_t units, ux;
    if (ns == 1) {
        comp_t *c = &d->comp[ci[0]];
        ux = (c->dw + 7) / 8;
        units = ux * ((c->dh + 7) / 8);
    } else {
        ux = (d->width + 8 * hm - 1) / (8 * hm);
        units = ux * ((d->height + 8 * vm - 1) / (8 * vm));
    }
    int left = d->restart;
    for (int64_t u = 0; u < units; ++u) {
        if (d->restart) {
            if (left == 0) {
                restart(&b);
                memset(pred, 0, sizeof pred);
                left = d->restart;
            }
            --left;
        }
        int64_t uy = u / ux, uxx = u % ux;
        for (int k = 0; k < ns; ++k) {
            comp_t *c = &d->comp[ci[k]];
            int nv = ns == 1 ? 1 : c->v, nh = ns == 1 ? 1 : c->h;
            for (int j = 0; j < nv; ++j)
                for (int i = 0; i < nh; ++i) {
                    int64_t by = uy * nv + j, bx = uxx * nh + i;
                    int16_t *blk = c->coef + (by * c->bw + bx) * 64;
                    int err = decode_block(&b, &d->dc[td[k]], &d->ac[ta[k]],
                                           &pred[k], blk);
                    if (err) return err;
                }
        }
    }
    return 0;
}

static int parse(dec_t *d, const uint8_t *buf, int64_t n, int tables_only) {
    if (n < 2 || buf[0] != 0xFF || buf[1] != 0xD8) return 1;
    const uint8_t *p = buf + 2, *end = buf + n;
    while (p < end) {
        if (*p != 0xFF) return 1;
        while (p < end && *p == 0xFF) ++p;
        if (p >= end) break;
        int m = *p++;
        if (m == 0xD9) return 0;
        if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
        if (end - p < 2) return 1;
        int len = (p[0] << 8) | p[1];
        if (len < 2 || end - p < len) return 1;
        const uint8_t *seg = p + 2;
        int sl = len - 2;
        p += len;
        if (m == 0xDB) {
            for (int i = 0; i < sl;) {
                int pq = seg[i] >> 4, tq = seg[i] & 15;
                int need = pq ? 129 : 65;
                if (i + need > sl) return 1;
                if (tq > 3) return 8;
                for (int k = 0; k < 64; ++k)
                    d->qt[tq][natural[k]] = pq ? (seg[i + 1 + 2 * k] << 8) |
                                                     seg[i + 2 + 2 * k]
                                               : seg[i + 1 + k];
                d->qt_defined[tq] = 1;
                i += need;
            }
        } else if (m == 0xC4) {
            for (int i = 0; i < sl;) {
                if (i + 17 > sl) return 1;
                int tc = seg[i] >> 4, th = seg[i] & 15, nsym = 0;
                for (int k = 0; k < 16; ++k) nsym += seg[i + 1 + k];
                if (i + 17 + nsym > sl) return 1;
                if (tc > 1 || th > 3 || !huff_fits(seg + i + 1, nsym))
                    return 8;
                build_huff(tc ? &d->ac[th] : &d->dc[th], seg + i + 1,
                           seg + i + 17, nsym);
                i += 17 + nsym;
            }
        } else if (m == 0xDD) {
            if (sl < 2) return 1;
            d->restart = (seg[0] << 8) | seg[1];
        } else if (m == 0xC0 || m == 0xC1) {
            if (d->have_frame) return 1;             /* a second frame */
            if (sl < 6 || seg[0] != 8) return 6;
            d->height = (seg[1] << 8) | seg[2];
            d->width = (seg[3] << 8) | seg[4];
            d->nc = seg[5];
            if ((d->nc != 1 && d->nc != 3) || d->height == 0 ||
                sl < 6 + 3 * d->nc)
                return 6;
            int hm = 1, vm = 1;
            for (int c = 0; c < d->nc; ++c) {
                comp_t *cp = &d->comp[c];
                cp->cid = seg[6 + 3 * c];
                cp->h = seg[7 + 3 * c] >> 4;
                cp->v = seg[7 + 3 * c] & 15;
                cp->tq = seg[8 + 3 * c];
                if (cp->tq > 3) return 8;
                if (cp->h < 1 || cp->h > 4 || cp->v < 1 || cp->v > 4) return 6;
                if (cp->h > hm) hm = cp->h;
                if (cp->v > vm) vm = cp->v;
            }
            int64_t mx = (d->width + 8 * hm - 1) / (8 * hm);
            int64_t my = (d->height + 8 * vm - 1) / (8 * vm);
            for (int c = 0; c < d->nc; ++c) {
                comp_t *cp = &d->comp[c];
                cp->dw = (int)(((int64_t)d->width * cp->h + hm - 1) / hm);
                cp->dh = (int)(((int64_t)d->height * cp->v + vm - 1) / vm);
                cp->bw = (int)(mx * cp->h);
                cp->bh = (int)(my * cp->v);
                if (cp->bw < (cp->dw + 7) / 8) cp->bw = (cp->dw + 7) / 8;
                if (cp->bh < (cp->dh + 7) / 8) cp->bh = (cp->dh + 7) / 8;
                cp->coef = calloc((size_t)cp->bw * cp->bh * 64,
                                  sizeof(int16_t));
                if (!cp->coef) return 5;
            }
            d->have_frame = 1;
        } else if ((m >= 0xC2 && m <= 0xCF && m != 0xC4 && m != 0xC8) ) {
            return 6;
        } else if (m == 0xDA) {
            if (!d->have_frame || tables_only) return 2;
            if (sl < 1) return 1;
            const uint8_t *next;
            int err = decode_scan(d, seg, p, end, &next);
            if (err) return err;
            d->nscans++;
            p = next;
        }
    }
    return 0;
}

/* ------------------------------------------------------------ islow IDCT */

#define CONST_BITS 13
#define PASS1_BITS 2
#define F_0_298 2446
#define F_0_390 3196
#define F_0_541 4433
#define F_0_765 6270
#define F_0_899 7373
#define F_1_175 9633
#define F_1_501 12299
#define F_1_847 15137
#define F_1_961 16069
#define F_2_053 16819
#define F_2_562 20995
#define F_3_072 25172
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n) - 1))) >> (n))

static void idct_1d(const int64_t *in, int stride, int64_t *out) {
    int64_t d0 = in[0], d1 = in[stride], d2 = in[2 * stride],
            d3 = in[3 * stride], d4 = in[4 * stride], d5 = in[5 * stride],
            d6 = in[6 * stride], d7 = in[7 * stride];
    int64_t z1 = (d2 + d6) * F_0_541;
    int64_t tmp2 = z1 + d6 * -F_1_847;
    int64_t tmp3 = z1 + d2 * F_0_765;
    int64_t tmp0 = (d0 + d4) * (1 << CONST_BITS);
    int64_t tmp1 = (d0 - d4) * (1 << CONST_BITS);
    int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3;
    int64_t t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    int64_t o0 = d7, o1 = d5, o2 = d3, o3 = d1;
    z1 = o0 + o3;
    int64_t z2 = o1 + o2, z3 = o0 + o2, z4 = o1 + o3;
    int64_t z5 = (z3 + z4) * F_1_175;
    o0 *= F_0_298;
    o1 *= F_2_053;
    o2 *= F_3_072;
    o3 *= F_1_501;
    z1 *= -F_0_899;
    z2 *= -F_2_562;
    z3 = z3 * -F_1_961 + z5;
    z4 = z4 * -F_0_390 + z5;
    o0 += z1 + z3;
    o1 += z2 + z4;
    o2 += z2 + z3;
    o3 += z1 + z4;
    out[0] = t10 + o3;
    out[1] = t11 + o2;
    out[2] = t12 + o1;
    out[3] = t13 + o0;
    out[4] = t13 - o0;
    out[5] = t12 - o1;
    out[6] = t11 - o2;
    out[7] = t10 - o3;
}

static void idct_islow(const int16_t *coef, const int32_t *qt, uint8_t *dst,
                       int64_t pitch) {
    int64_t x[64], ws[64], col[8];
    for (int k = 0; k < 64; ++k) x[k] = (int64_t)coef[k] * qt[k];
    for (int c = 0; c < 8; ++c) {           /* pass 1: columns */
        idct_1d(x + c, 8, col);
        for (int r = 0; r < 8; ++r)
            ws[r * 8 + c] = DESCALE(col[r], CONST_BITS - PASS1_BITS);
    }
    for (int r = 0; r < 8; ++r) {           /* pass 2: rows */
        idct_1d(ws + r * 8, 1, col);
        for (int c = 0; c < 8; ++c) {
            int64_t v = DESCALE(col[c], CONST_BITS + PASS1_BITS + 3) + 128;
            dst[r * pitch + c] = (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
        }
    }
}

/* ------------------------------------------------------------ upsampling */

/* component plane p (dw x dh, pitch pp) -> full plane o (ow x oh), cropped
 * to the frame */
static void upsample(const uint8_t *p, int64_t pp, int dw, int dh, int fh,
                     int fv, uint8_t *o, int ow, int oh) {
    int wide = dw > 2;
    for (int64_t y = 0; y < oh; ++y) {
        uint8_t *out = o + y * ow;
        int64_t sy = y / fv;
        const uint8_t *row = p + sy * pp;
        if (fh == 1 && fv == 1) {
            memcpy(out, row, (size_t)ow);
        } else if (fh == 2 && fv == 1 && wide) {
            for (int64_t x = 0; x < ow; ++x) {
                int64_t s = x >> 1;
                int v = row[s];
                if (x == 0 || x == 2 * (int64_t)dw - 1)
                    out[x] = (uint8_t)v;
                else if (x & 1)
                    out[x] = (uint8_t)((3 * v + row[s + 1] + 2) >> 2);
                else
                    out[x] = (uint8_t)((3 * v + row[s - 1] + 1) >> 2);
            }
        } else if (fh == 1 && fv == 2) {
            int64_t ny = (y & 1) ? (sy + 1 < dh ? sy + 1 : sy)
                                 : (sy > 0 ? sy - 1 : 0);
            const uint8_t *nb = p + ny * pp;
            int bias = (y & 1) ? 2 : 1;
            for (int64_t x = 0; x < ow; ++x)
                out[x] = (uint8_t)((3 * row[x] + nb[x] + bias) >> 2);
        } else if (fh == 2 && fv == 2 && wide) {
            int64_t ny = (y & 1) ? (sy + 1 < dh ? sy + 1 : sy)
                                 : (sy > 0 ? sy - 1 : 0);
            const uint8_t *nb = p + ny * pp;
            for (int64_t x = 0; x < ow; ++x) {
                int64_t s = x >> 1;
                int this_ = 3 * row[s] + nb[s];
                if (x == 0) {
                    out[x] = (uint8_t)((4 * this_ + 8) >> 4);
                } else if (x == 2 * (int64_t)dw - 1) {
                    out[x] = (uint8_t)((4 * this_ + 7) >> 4);
                } else if (x & 1) {
                    int nxt = 3 * row[s + 1] + nb[s + 1];
                    out[x] = (uint8_t)((3 * this_ + nxt + 7) >> 4);
                } else {
                    int last = 3 * row[s - 1] + nb[s - 1];
                    out[x] = (uint8_t)((3 * this_ + last + 8) >> 4);
                }
            }
        } else {
            for (int64_t x = 0; x < ow; ++x) out[x] = row[x / fh];
        }
    }
}

/* ------------------------------------------------------- colour and all */

static void free_dec(dec_t *d) {
    for (int c = 0; c < MAXC; ++c) free(d->comp[c].coef);
}

int jpeg_decode(const uint8_t *tables, int64_t tables_len,
                const uint8_t *data, int64_t len, int mode, uint8_t *out,
                int64_t out_size) {
    const int ycc = mode == 1, raw = mode == 2;
    dec_t *d = calloc(1, sizeof(dec_t));
    if (!d) return 5;
    int err = 0;
    uint8_t *plane = NULL, *full[MAXC] = {NULL};
    if (tables_len > 0) err = parse(d, tables, tables_len, 1);
    if (!err) err = parse(d, data, len, 0);
    if (!err && (!d->have_frame || d->nscans == 0)) err = 2;
    int64_t need = 0;
    for (int c = 0; !err && c < d->nc; ++c)
        need += raw ? (int64_t)d->comp[c].dw * d->comp[c].dh
                    : (int64_t)d->width * d->height;
    if (!err && out_size != need) err = 7;
    uint8_t *dst = out;
    int hm = 1, vm = 1;
    for (int c = 0; !err && c < d->nc; ++c) {
        if (d->comp[c].h > hm) hm = d->comp[c].h;
        if (d->comp[c].v > vm) vm = d->comp[c].v;
        if (!d->qt_defined[d->comp[c].tq]) err = 4;
    }
    for (int c = 0; !err && c < d->nc; ++c) {
        comp_t *cp = &d->comp[c];
        if (hm % cp->h || vm % cp->v) { err = 6; break; }
        int64_t pitch = (int64_t)cp->bw * 8;
        plane = malloc((size_t)pitch * cp->bh * 8);
        full[c] = malloc((size_t)d->width * d->height);
        if (!plane || !full[c]) { err = 5; break; }
        for (int64_t by = 0; by < cp->bh; ++by)
            for (int64_t bx = 0; bx < cp->bw; ++bx)
                idct_islow(cp->coef + (by * cp->bw + bx) * 64,
                           d->qt[cp->tq], plane + by * 8 * pitch + bx * 8,
                           pitch);
        if (raw) {
            for (int64_t y = 0; y < cp->dh; ++y)
                memcpy(dst + y * cp->dw, plane + y * pitch, (size_t)cp->dw);
            dst += (int64_t)cp->dw * cp->dh;
        } else {
            upsample(plane, pitch, cp->dw, cp->dh, hm / cp->h, vm / cp->v,
                     full[c], d->width, d->height);
        }
        free(plane);
        plane = NULL;
    }
    if (!err && !raw) {
        int64_t np = (int64_t)d->width * d->height;
        if (d->nc == 1) {
            memcpy(out, full[0], (size_t)np);
        } else if (!ycc) {
            for (int64_t i = 0; i < np; ++i)
                for (int c = 0; c < 3; ++c) out[3 * i + c] = full[c][i];
        } else {
            int32_t cr_r[256], cb_b[256];
            int64_t cr_g[256], cb_g[256];
            const int64_t one_half = (int64_t)1 << 15;
            const int64_t f140 = (int64_t)(1.40200 * 65536 + 0.5),
                          f177 = (int64_t)(1.77200 * 65536 + 0.5),
                          f071 = (int64_t)(0.71414 * 65536 + 0.5),
                          f034 = (int64_t)(0.34414 * 65536 + 0.5);
            for (int i = 0; i < 256; ++i) {
                int64_t x = i - 128;
                cr_r[i] = (int32_t)((f140 * x + one_half) >> 16);
                cb_b[i] = (int32_t)((f177 * x + one_half) >> 16);
                cr_g[i] = -f071 * x;
                cb_g[i] = -f034 * x + one_half;
            }
            for (int64_t i = 0; i < np; ++i) {
                int y = full[0][i], cb = full[1][i], cr = full[2][i];
                int r = y + cr_r[cr];
                int g = y + (int)((cb_g[cb] + cr_g[cr]) >> 16);
                int b = y + cb_b[cb];
                out[3 * i] = (uint8_t)(r < 0 ? 0 : r > 255 ? 255 : r);
                out[3 * i + 1] = (uint8_t)(g < 0 ? 0 : g > 255 ? 255 : g);
                out[3 * i + 2] = (uint8_t)(b < 0 ? 0 : b > 255 ? 255 : b);
            }
        }
    }
    free(plane);
    for (int c = 0; c < MAXC; ++c) free(full[c]);
    free_dec(d);
    free(d);
    return err;
}
