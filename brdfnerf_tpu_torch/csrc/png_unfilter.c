/* PNG row unfiltering (PNG specification, section 9): the decoder's one
 * sequential loop.  Sub, Average and Paeth predict each byte from the byte
 * bpp to its left in the same, already reconstructed row, so a row cannot
 * be reconstructed in parallel along its length; this host library does it
 * byte by byte.  Plain C interface, loaded with ctypes by utils/png.py.
 *
 * png_unfilter: `src` holds h rows of 1 + stride bytes (a filter-type byte,
 * then the filtered scanline), as zlib inflates the IDAT stream; `dst`
 * receives the h reconstructed scanlines of stride bytes.  bpp is the bytes
 * per complete pixel (1..8).  Returns 0, or 1 + the index of the first row
 * whose filter type is not 0..4.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

static inline uint8_t paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
    if (pa <= pb && pa <= pc) return (uint8_t)a;
    if (pb <= pc) return (uint8_t)b;
    return (uint8_t)c;
}

int png_unfilter(const uint8_t *src, uint8_t *dst, int64_t h, int64_t stride,
                 int bpp) {
    const uint8_t *prev = NULL;
    for (int64_t y = 0; y < h; ++y) {
        const uint8_t *in = src + y * (stride + 1);
        uint8_t *out = dst + y * stride;
        const int type = in[0];
        ++in;
        int64_t i;
        switch (type) {
        case 0:
            memcpy(out, in, (size_t)stride);
            break;
        case 1:
            for (i = 0; i < bpp && i < stride; ++i) out[i] = in[i];
            for (; i < stride; ++i) out[i] = (uint8_t)(in[i] + out[i - bpp]);
            break;
        case 2:
            if (prev)
                for (i = 0; i < stride; ++i) out[i] = (uint8_t)(in[i] + prev[i]);
            else
                memcpy(out, in, (size_t)stride);
            break;
        case 3:
            for (i = 0; i < bpp && i < stride; ++i)
                out[i] = (uint8_t)(in[i] + ((prev ? prev[i] : 0) >> 1));
            for (; i < stride; ++i)
                out[i] = (uint8_t)(in[i] +
                                   ((out[i - bpp] + (prev ? prev[i] : 0)) >> 1));
            break;
        case 4:
            if (prev) {
                for (i = 0; i < bpp && i < stride; ++i)
                    out[i] = (uint8_t)(in[i] + prev[i]);
                for (; i < stride; ++i)
                    out[i] = (uint8_t)(in[i] + paeth(out[i - bpp], prev[i],
                                                     prev[i - bpp]));
            } else {
                /* no row above: Paeth picks the left byte, as Sub */
                for (i = 0; i < bpp && i < stride; ++i) out[i] = in[i];
                for (; i < stride; ++i)
                    out[i] = (uint8_t)(in[i] + out[i - bpp]);
            }
            break;
        default:
            return (int)(y + 1);
        }
        prev = out;
    }
    return 0;
}
