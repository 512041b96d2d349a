/* PNG row unfilter (PNG specification, section 9: filter types 0-4).
 *
 * Bound with ctypes by gradient_sdf_tpu_torch/data/png.py, whose numpy
 * version `_unfilter` is the plain reference the tests hold this code to.
 * Filters 3 (average) and 4 (Paeth) depend on the byte just decoded to the
 * left, so a row is a sequential loop; in C that is ~1 ns a byte, where the
 * interpreted loop takes ~1 us.
 */
#include <stdint.h>
#include <string.h>

static int paeth(int a, int b, int c)
{
    int p = a + b - c;
    int pa = p > a ? p - a : a - p;
    int pb = p > b ? p - b : b - p;
    int pc = p > c ? p - c : c - p;
    if (pa <= pb && pa <= pc)
        return a;
    return pb <= pc ? b : c;
}

/* in: h rows of (1 filter byte + stride bytes); out: h rows of stride bytes;
 * bpp: bytes per complete pixel (at least 1). Returns 0, or 1 + the index of
 * the first row whose filter type is not 0-4 (out is then incomplete). */
int64_t gsdf_png_unfilter(const uint8_t *in, uint8_t *out, int64_t h,
                          int64_t stride, int64_t bpp)
{
    const uint8_t *prev = NULL;
    for (int64_t y = 0; y < h; y++) {
        const uint8_t *line = in + y * (stride + 1) + 1;
        uint8_t *cur = out + y * stride;
        int64_t i;
        switch (in[y * (stride + 1)]) {
        case 0:
            memcpy(cur, line, (size_t)stride);
            break;
        case 1:
            for (i = 0; i < stride; i++)
                cur[i] = (uint8_t)(line[i] + (i >= bpp ? cur[i - bpp] : 0));
            break;
        case 2:
            for (i = 0; i < stride; i++)
                cur[i] = (uint8_t)(line[i] + (prev ? prev[i] : 0));
            break;
        case 3:
            for (i = 0; i < stride; i++) {
                int a = i >= bpp ? cur[i - bpp] : 0;
                int b = prev ? prev[i] : 0;
                cur[i] = (uint8_t)(line[i] + ((a + b) >> 1));
            }
            break;
        case 4:
            for (i = 0; i < stride; i++) {
                int a = i >= bpp ? cur[i - bpp] : 0;
                int b = prev ? prev[i] : 0;
                int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
                cur[i] = (uint8_t)(line[i] + paeth(a, b, c));
            }
            break;
        default:
            return y + 1;
        }
        prev = cur;
    }
    return 0;
}
