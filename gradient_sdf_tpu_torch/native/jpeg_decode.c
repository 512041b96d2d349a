/* Baseline JPEG decoder: sequential Huffman, 8-bit samples, 1 or 3
 * components, chroma sampled 4:4:4, 4:2:2 or 4:2:0, restart intervals, any
 * image size.
 *
 * Bound with ctypes by gradient_sdf_tpu_torch/data/jpeg.py (Redwood's
 * rgb/*.jpg frames). It decodes to the samples libjpeg(-turbo) gives with its
 * default settings, which is what PIL returns, by following libjpeg's
 * algorithms: the accurate integer inverse DCT ("islow", jidctint.c) with
 * its wrap-around range limit, "fancy" triangular chroma upsampling
 * (jdsample.c h2v1 and h2v2, with edge rows and columns replicated) and the
 * fixed-point YCbCr -> RGB tables of jdcolor.c. Progressive and lossless
 * frames, arithmetic coding and 12-bit samples are refused with a message.
 */
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

typedef struct {
    int present;
    uint8_t vals[256];
    int32_t mincode[17], maxcode[18], valptr[17];
    uint8_t look_len[256], look_sym[256];   /* codes of <= 8 bits */
} Huff;

typedef struct {
    int id, h, v, tq;
    int td, ta;                 /* tables of the current scan */
    int pred;                   /* DC predictor */
    int bw, bh;                 /* plane size in blocks (interleaved MCUs) */
    int dw, dh;                 /* downsampled width and height in samples */
    uint8_t *plane;             /* bh*8 rows of bw*8 samples */
} Comp;

typedef struct {
    const uint8_t *p, *end;
    uint64_t acc;               /* bits, most significant first */
    int nbits;
    int at_marker;
} Bits;

typedef struct {
    int w, h, nc, hmax, vmax, restart, adobe, adobe_transform, jfif;
    int seen_sof;
    uint16_t q[4][64];          /* natural order */
    int q_present[4];
    Huff dc[4], ac[4];
    Comp c[3];
    char *err;
    int errlen;
} Dec;

/* zigzag index -> natural index; 16 extra entries absorb corrupt runs */
static const int NATURAL[80] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

static int fail(Dec *d, int code, const char *msg)
{
    if (d->err && d->errlen > 0)
        snprintf(d->err, (size_t)d->errlen, "%s", msg);
    return code;
}

static int build_huff(Huff *t, const uint8_t *counts, const uint8_t *vals, int n)
{
    int code = 0, k = 0;
    memset(t, 0, sizeof(*t));
    memcpy(t->vals, vals, (size_t)n);
    for (int len = 1; len <= 16; len++) {
        t->valptr[len] = k;
        t->mincode[len] = code;
        code += counts[len - 1];
        k += counts[len - 1];
        t->maxcode[len] = counts[len - 1] ? code - 1 : -1;
        if (code > (1 << len))
            return -1;
        code <<= 1;
    }
    t->maxcode[17] = 0x7fffffff;
    /* lookahead: every 8-bit prefix of a code of <= 8 bits */
    k = 0;
    code = 0;
    for (int len = 1; len <= 8; len++) {
        for (int i = 0; i < counts[len - 1]; i++, k++) {
            int c = t->mincode[len] + i;
            int lo = c << (8 - len), hi = (c + 1) << (8 - len);
            for (int x = lo; x < hi; x++) {
                t->look_len[x] = (uint8_t)len;
                t->look_sym[x] = vals[k];
            }
        }
    }
    t->present = 1;
    return 0;
}

static void fill(Bits *b)
{
    while (b->nbits <= 56) {
        unsigned c = 0;
        if (!b->at_marker && b->p < b->end) {
            c = *b->p;
            if (c == 0xFF) {
                unsigned c2 = b->p + 1 < b->end ? b->p[1] : 0xD9;
                if (c2 == 0x00) {
                    b->p += 2;
                } else {        /* a marker: feed zeros, as libjpeg does */
                    b->at_marker = 1;
                    c = 0;
                }
            } else {
                b->p++;
            }
        }
        b->acc |= (uint64_t)c << (56 - b->nbits);
        b->nbits += 8;
    }
}

static int get_bits(Bits *b, int n)
{
    if (n == 0)
        return 0;
    if (b->nbits < n)
        fill(b);
    int v = (int)(b->acc >> (64 - n));
    b->acc <<= n;
    b->nbits -= n;
    return v;
}

static int decode_sym(Bits *b, const Huff *t)
{
    if (b->nbits < 16)
        fill(b);
    int look = (int)(b->acc >> 56);
    int len = t->look_len[look];
    if (len) {
        b->acc <<= len;
        b->nbits -= len;
        return t->look_sym[look];
    }
    int code = get_bits(b, 1);
    len = 1;
    while (code > t->maxcode[len]) {
        code = (code << 1) | get_bits(b, 1);
        if (++len > 16)
            return -1;
    }
    return t->vals[t->valptr[len] + code - t->mincode[len]];
}

static int extend(int v, int s)
{
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

/* ---- jidctint.c: accurate integer inverse DCT ------------------------- */
#define CONST_BITS 13
#define PASS1_BITS 2
#define FIX_0_298631336 ((int64_t)2446)
#define FIX_0_390180644 ((int64_t)3196)
#define FIX_0_541196100 ((int64_t)4433)
#define FIX_0_765366865 ((int64_t)6270)
#define FIX_0_899976223 ((int64_t)7373)
#define FIX_1_175875602 ((int64_t)9633)
#define FIX_1_501321110 ((int64_t)12299)
#define FIX_1_847759065 ((int64_t)15137)
#define FIX_1_961570560 ((int64_t)16069)
#define FIX_2_053119869 ((int64_t)16819)
#define FIX_2_562915447 ((int64_t)20995)
#define FIX_3_072711026 ((int64_t)25172)
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n) - 1))) >> (n))

/* libjpeg's post-IDCT range limit: the value is taken modulo 1024 and
 * mapped to [-512, 511] before it is clamped (jdmaster.c
 * prepare_range_limit_table), so a wild value wraps as it does there. */
static uint8_t idct_limit(int64_t x)
{
    int v = (int)(x & 1023);
    if (v >= 512)
        v -= 1024;
    v += 128;
    return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

static void idct_islow(const int16_t *coef, const uint16_t *q, uint8_t *out,
                       int out_stride)
{
    int ws[64];
    for (int col = 0; col < 8; col++) {
        const int16_t *in = coef + col;
        const uint16_t *qt = q + col;
        int64_t z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3;
        int64_t tmp10, tmp11, tmp12, tmp13;
        z2 = (int64_t)in[16] * qt[16];
        z3 = (int64_t)in[48] * qt[48];
        z1 = (z2 + z3) * FIX_0_541196100;
        tmp2 = z1 + z3 * (-FIX_1_847759065);
        tmp3 = z1 + z2 * FIX_0_765366865;
        z2 = (int64_t)in[0] * qt[0];
        z3 = (int64_t)in[32] * qt[32];
        tmp0 = (z2 + z3) * ((int64_t)1 << CONST_BITS);
        tmp1 = (z2 - z3) * ((int64_t)1 << CONST_BITS);
        tmp10 = tmp0 + tmp3;
        tmp13 = tmp0 - tmp3;
        tmp11 = tmp1 + tmp2;
        tmp12 = tmp1 - tmp2;
        tmp0 = (int64_t)in[56] * qt[56];
        tmp1 = (int64_t)in[40] * qt[40];
        tmp2 = (int64_t)in[24] * qt[24];
        tmp3 = (int64_t)in[8] * qt[8];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        z4 = tmp1 + tmp3;
        z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 = tmp0 * FIX_0_298631336;
        tmp1 = tmp1 * FIX_2_053119869;
        tmp2 = tmp2 * FIX_3_072711026;
        tmp3 = tmp3 * FIX_1_501321110;
        z1 = z1 * (-FIX_0_899976223);
        z2 = z2 * (-FIX_2_562915447);
        z3 = z3 * (-FIX_1_961570560);
        z4 = z4 * (-FIX_0_390180644);
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        ws[col + 0] = (int)DESCALE(tmp10 + tmp3, CONST_BITS - PASS1_BITS);
        ws[col + 56] = (int)DESCALE(tmp10 - tmp3, CONST_BITS - PASS1_BITS);
        ws[col + 8] = (int)DESCALE(tmp11 + tmp2, CONST_BITS - PASS1_BITS);
        ws[col + 48] = (int)DESCALE(tmp11 - tmp2, CONST_BITS - PASS1_BITS);
        ws[col + 16] = (int)DESCALE(tmp12 + tmp1, CONST_BITS - PASS1_BITS);
        ws[col + 40] = (int)DESCALE(tmp12 - tmp1, CONST_BITS - PASS1_BITS);
        ws[col + 24] = (int)DESCALE(tmp13 + tmp0, CONST_BITS - PASS1_BITS);
        ws[col + 32] = (int)DESCALE(tmp13 - tmp0, CONST_BITS - PASS1_BITS);
    }
    for (int row = 0; row < 8; row++) {
        const int *w = ws + 8 * row;
        uint8_t *o = out + row * out_stride;
        int64_t z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3;
        int64_t tmp10, tmp11, tmp12, tmp13;
        const int n = CONST_BITS + PASS1_BITS + 3;
        z2 = w[2];
        z3 = w[6];
        z1 = (z2 + z3) * FIX_0_541196100;
        tmp2 = z1 + z3 * (-FIX_1_847759065);
        tmp3 = z1 + z2 * FIX_0_765366865;
        tmp0 = ((int64_t)w[0] + w[4]) * ((int64_t)1 << CONST_BITS);
        tmp1 = ((int64_t)w[0] - w[4]) * ((int64_t)1 << CONST_BITS);
        tmp10 = tmp0 + tmp3;
        tmp13 = tmp0 - tmp3;
        tmp11 = tmp1 + tmp2;
        tmp12 = tmp1 - tmp2;
        tmp0 = w[7];
        tmp1 = w[5];
        tmp2 = w[3];
        tmp3 = w[1];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        z4 = tmp1 + tmp3;
        z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 = tmp0 * FIX_0_298631336;
        tmp1 = tmp1 * FIX_2_053119869;
        tmp2 = tmp2 * FIX_3_072711026;
        tmp3 = tmp3 * FIX_1_501321110;
        z1 = z1 * (-FIX_0_899976223);
        z2 = z2 * (-FIX_2_562915447);
        z3 = z3 * (-FIX_1_961570560);
        z4 = z4 * (-FIX_0_390180644);
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        o[0] = idct_limit(DESCALE(tmp10 + tmp3, n));
        o[7] = idct_limit(DESCALE(tmp10 - tmp3, n));
        o[1] = idct_limit(DESCALE(tmp11 + tmp2, n));
        o[6] = idct_limit(DESCALE(tmp11 - tmp2, n));
        o[2] = idct_limit(DESCALE(tmp12 + tmp1, n));
        o[5] = idct_limit(DESCALE(tmp12 - tmp1, n));
        o[3] = idct_limit(DESCALE(tmp13 + tmp0, n));
        o[4] = idct_limit(DESCALE(tmp13 - tmp0, n));
    }
}

/* one 8x8 block of component `c` at block row `by`, column `bx` */
static int decode_block(Dec *d, Bits *b, Comp *c, int by, int bx)
{
    int16_t coef[64];
    memset(coef, 0, sizeof(coef));
    int t = decode_sym(b, &d->dc[c->td]);
    if (t < 0 || t > 11)
        return fail(d, -20, "corrupt JPEG data: bad DC code");
    c->pred += t ? extend(get_bits(b, t), t) : 0;
    coef[0] = (int16_t)c->pred;
    for (int k = 1; k < 64; k++) {
        int rs = decode_sym(b, &d->ac[c->ta]);
        if (rs < 0)
            return fail(d, -21, "corrupt JPEG data: bad AC code");
        int r = rs >> 4, s = rs & 15;
        if (s) {
            k += r;
            coef[NATURAL[k]] = (int16_t)extend(get_bits(b, s), s);
        } else if (r == 15) {
            k += 15;
        } else {
            break;
        }
    }
    int stride = c->bw * 8;
    idct_islow(coef, d->q[c->tq], c->plane + (size_t)by * 8 * stride + bx * 8,
               stride);
    return 0;
}

static void restart(Bits *b, Comp **sc, int ns)
{
    const uint8_t *p = b->p;
    while (p + 1 < b->end && !(p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7))
        p++;
    b->p = p + 1 < b->end ? p + 2 : b->end;
    b->acc = 0;
    b->nbits = 0;
    b->at_marker = 0;
    for (int i = 0; i < ns; i++)
        sc[i]->pred = 0;
}

/* entropy-coded data of one scan from `p`; returns the position after it */
static const uint8_t *decode_scan(Dec *d, const uint8_t *p, const uint8_t *end,
                                  Comp **sc, int ns, int *rc)
{
    Bits b = {p, end, 0, 0, 0};
    int mcux, mcuy;
    for (int i = 0; i < ns; i++)
        sc[i]->pred = 0;
    if (ns == 1) {   /* non-interleaved: one block per MCU, the component's own size */
        mcux = (sc[0]->dw + 7) / 8;
        mcuy = (sc[0]->dh + 7) / 8;
    } else {
        mcux = (d->w + 8 * d->hmax - 1) / (8 * d->hmax);
        mcuy = (d->h + 8 * d->vmax - 1) / (8 * d->vmax);
    }
    int64_t n = 0;
    for (int my = 0; my < mcuy; my++) {
        for (int mx = 0; mx < mcux; mx++) {
            if (d->restart && n && n % d->restart == 0)
                restart(&b, sc, ns);
            n++;
            for (int i = 0; i < ns; i++) {
                Comp *c = sc[i];
                int hh = ns == 1 ? 1 : c->h, vv = ns == 1 ? 1 : c->v;
                for (int v = 0; v < vv; v++)
                    for (int h = 0; h < hh; h++) {
                        *rc = decode_block(d, &b, c, my * vv + v, mx * hh + h);
                        if (*rc)
                            return end;
                    }
            }
        }
    }
    /* skip what is left of the entropy-coded segment up to the next marker */
    p = b.p;
    while (p + 1 < end && !(p[0] == 0xFF && p[1] != 0x00
                            && !(p[1] >= 0xD0 && p[1] <= 0xD7)))
        p++;
    *rc = 0;
    return p;
}

/* ---- jdsample.c fancy upsampling, jdcolor.c YCbCr -> RGB --------------- */

static uint8_t sample(const Comp *c, int y, int x)
{
    if (y < 0) y = 0;
    if (y >= c->dh) y = c->dh - 1;
    if (x < 0) x = 0;
    if (x >= c->dw) x = c->dw - 1;
    return c->plane[(size_t)y * c->bw * 8 + x];
}

/* component `c` upsampled to the full image size -> out [h, w] */
static int upsample(Dec *d, const Comp *c, uint8_t *out)
{
    int fx = d->hmax / c->h, fy = d->vmax / c->v;
    int fancy = c->dw > 2;
    if (d->hmax % c->h || d->vmax % c->v || fx > 2 || fy > fx)
        return fail(d, -30, "unsupported JPEG chroma subsampling (4:4:4, 4:2:2 "
                            "and 4:2:0 are supported)");
    for (int y = 0; y < d->h; y++) {
        uint8_t *o = out + (size_t)y * d->w;
        int iy = y / fy;
        /* the nearer and the farther input row of the vertical triangle */
        int ny = (fy == 2) ? ((y & 1) ? iy + 1 : iy - 1) : iy;
        for (int x = 0; x < d->w; x++) {
            int ix = x / fx;
            if (fx == 1) {
                o[x] = sample(c, iy, ix);
            } else if (!fancy) {
                o[x] = sample(c, iy, ix);
            } else if (fy == 1) {   /* h2v1: 3/4 nearer + 1/4 farther column */
                int near = sample(c, iy, ix) * 3;
                o[x] = (x & 1) ? (uint8_t)((near + sample(c, iy, ix + 1) + 2) >> 2)
                               : (uint8_t)((near + sample(c, iy, ix - 1) + 1) >> 2);
            } else {                /* h2v2: the same on column sums 3:1 */
                int sx = (x & 1) ? ix + 1 : ix - 1;
                int this_sum = sample(c, iy, ix) * 3 + sample(c, ny, ix);
                int far_sum = sample(c, iy, sx) * 3 + sample(c, ny, sx);
                o[x] = (x & 1) ? (uint8_t)((this_sum * 3 + far_sum + 7) >> 4)
                               : (uint8_t)((this_sum * 3 + far_sum + 8) >> 4);
            }
        }
    }
    return 0;
}

static uint8_t clamp255(int v)
{
    return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

static int finish(Dec *d, uint8_t *out)
{
    if (d->nc == 1) {
        for (int y = 0; y < d->h; y++)
            memcpy(out + (size_t)y * d->w,
                   d->c[0].plane + (size_t)y * d->c[0].bw * 8, (size_t)d->w);
        return 0;
    }
    size_t npix = (size_t)d->w * d->h;
    uint8_t *full = malloc(3 * npix);
    if (!full)
        return fail(d, -40, "out of memory");
    for (int i = 0; i < 3; i++) {
        int rc = upsample(d, &d->c[i], full + i * npix);
        if (rc) {
            free(full);
            return rc;
        }
    }
    /* libjpeg guesses the colour space as jdapimin.c does: JFIF -> YCbCr;
     * an Adobe marker decides by its transform flag; else component ids
     * 'R','G','B' mean RGB */
    int rgb = 0;
    if (!d->jfif && d->adobe)
        rgb = d->adobe_transform == 0;
    else if (!d->jfif)
        rgb = d->c[0].id == 'R' && d->c[1].id == 'G' && d->c[2].id == 'B';
    const int64_t ONE_HALF = (int64_t)1 << 15;
#define FIX(x) ((int64_t)((x) * 65536.0 + 0.5))
    for (size_t k = 0; k < npix; k++) {
        int y = full[k], cb = full[npix + k], cr = full[2 * npix + k];
        if (rgb) {
            out[3 * k] = (uint8_t)y;
            out[3 * k + 1] = (uint8_t)cb;
            out[3 * k + 2] = (uint8_t)cr;
            continue;
        }
        int64_t xb = cb - 128, xr = cr - 128;
        int crr = (int)((FIX(1.40200) * xr + ONE_HALF) >> 16);
        int cbb = (int)((FIX(1.77200) * xb + ONE_HALF) >> 16);
        int g = (int)(((-FIX(0.34414)) * xb + ONE_HALF + (-FIX(0.71414)) * xr) >> 16);
        out[3 * k] = clamp255(y + crr);
        out[3 * k + 1] = clamp255(y + g);
        out[3 * k + 2] = clamp255(y + cbb);
    }
#undef FIX
    free(full);
    return 0;
}

static void release(Dec *d)
{
    for (int i = 0; i < 3; i++) {
        free(d->c[i].plane);
        d->c[i].plane = NULL;
    }
}

static int be16(const uint8_t *p) { return (p[0] << 8) | p[1]; }

/* Walks the markers; decodes the scans when `out` is not NULL. */
static int run(Dec *d, const uint8_t *buf, int64_t len, uint8_t *out)
{
    const uint8_t *p = buf, *end = buf + len;
    if (len < 4 || p[0] != 0xFF || p[1] != 0xD8)
        return fail(d, -1, "not a JPEG file (no SOI marker)");
    p += 2;
    while (p < end) {
        if (*p != 0xFF) {       /* garbage between segments: skip, as libjpeg */
            p++;
            continue;
        }
        while (p < end && *p == 0xFF)
            p++;
        if (p >= end)
            break;
        int m = *p++;
        if (m == 0xD9)          /* EOI */
            break;
        if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01)
            continue;
        if (p + 2 > end)
            return fail(d, -2, "truncated JPEG marker segment");
        int seg = be16(p);
        const uint8_t *s = p + 2, *send = p + seg;
        if (seg < 2 || send > end)
            return fail(d, -2, "truncated JPEG marker segment");
        p = send;
        if (m == 0xC0 || m == 0xC1) {   /* baseline / extended sequential */
            /* a second frame header could change the size `info` reported,
             * which the caller sized `out` by */
            if (d->seen_sof)
                return fail(d, -3, "more than one frame header in the JPEG file");
            if (seg < 8)
                return fail(d, -3, "bad SOF segment");
            if (s[0] != 8)
                return fail(d, -4, "only 8-bit JPEG samples are supported");
            d->h = be16(s + 1);
            d->w = be16(s + 3);
            d->nc = s[5];
            if (d->h == 0 || d->w == 0)
                return fail(d, -5, "JPEG image without a height (DNL) or width");
            if (d->nc != 1 && d->nc != 3)
                return fail(d, -6, "only 1- and 3-component JPEGs are supported");
            if (seg < 8 + 3 * d->nc)
                return fail(d, -3, "bad SOF segment");
            d->hmax = d->vmax = 1;
            for (int i = 0; i < d->nc; i++) {
                Comp *c = &d->c[i];
                c->id = s[6 + 3 * i];
                c->h = d->nc == 1 ? 1 : s[7 + 3 * i] >> 4;
                c->v = d->nc == 1 ? 1 : s[7 + 3 * i] & 15;
                c->tq = s[8 + 3 * i] & 3;
                if (c->h < 1 || c->h > 4 || c->v < 1 || c->v > 4)
                    return fail(d, -3, "bad JPEG sampling factors");
                if (c->h > d->hmax) d->hmax = c->h;
                if (c->v > d->vmax) d->vmax = c->v;
            }
            int mcux = (d->w + 8 * d->hmax - 1) / (8 * d->hmax);
            int mcuy = (d->h + 8 * d->vmax - 1) / (8 * d->vmax);
            for (int i = 0; i < d->nc; i++) {
                Comp *c = &d->c[i];
                c->bw = mcux * c->h;
                c->bh = mcuy * c->v;
                c->dw = (int)(((int64_t)d->w * c->h + d->hmax - 1) / d->hmax);
                c->dh = (int)(((int64_t)d->h * c->v + d->vmax - 1) / d->vmax);
                if (out) {
                    c->plane = calloc((size_t)c->bw * 8 * c->bh * 8, 1);
                    if (!c->plane)
                        return fail(d, -40, "out of memory");
                }
            }
            d->seen_sof = 1;
            if (!out)
                return 0;       /* the header is all `info` needs */
        } else if (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE) {
            return fail(d, -7, "progressive JPEG is not supported (baseline only)");
        } else if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF) {
            return fail(d, -8, "lossless JPEG is not supported (baseline only)");
        } else if (m == 0xC5 || m == 0xC9 || m == 0xCD) {
            return fail(d, -9, "arithmetic-coded or hierarchical JPEG is not supported");
        } else if (m == 0xC4) {         /* DHT */
            while (s < send) {
                if (s + 17 > send)
                    return fail(d, -10, "bad DHT segment");
                int tc = s[0] >> 4, th = s[0] & 15, n = 0;
                for (int i = 0; i < 16; i++)
                    n += s[1 + i];
                if (tc > 1 || th > 3 || n > 256 || s + 17 + n > send)
                    return fail(d, -10, "bad DHT segment");
                if (build_huff(tc ? &d->ac[th] : &d->dc[th], s + 1, s + 17, n))
                    return fail(d, -10, "bad Huffman table");
                s += 17 + n;
            }
        } else if (m == 0xDB) {         /* DQT */
            while (s < send) {
                int pq = s[0] >> 4, tq = s[0] & 15;
                int n = pq ? 128 : 64;
                if (tq > 3 || s + 1 + n > send)
                    return fail(d, -11, "bad DQT segment");
                for (int k = 0; k < 64; k++)
                    d->q[tq][NATURAL[k]] = (uint16_t)(pq ? be16(s + 1 + 2 * k)
                                                          : s[1 + k]);
                d->q_present[tq] = 1;
                s += 1 + n;
            }
        } else if (m == 0xDD) {         /* DRI */
            if (seg < 4)
                return fail(d, -12, "bad DRI segment");
            d->restart = be16(s);
        } else if (m == 0xE0) {         /* APP0: JFIF */
            if (seg >= 7 && !memcmp(s, "JFIF\0", 5))
                d->jfif = 1;
        } else if (m == 0xEE) {         /* APP14: Adobe */
            if (seg >= 14 && !memcmp(s, "Adobe", 5)) {
                d->adobe = 1;
                d->adobe_transform = s[11];
            }
        } else if (m == 0xDA) {         /* SOS */
            if (!d->seen_sof)
                return fail(d, -13, "JPEG scan before its frame header");
            int ns = seg >= 3 ? s[0] : 0;
            Comp *sc[3];
            if (ns < 1 || ns > d->nc || seg < 6 + 2 * ns)
                return fail(d, -13, "bad SOS segment");
            for (int i = 0; i < ns; i++) {
                int id = s[1 + 2 * i], k;
                for (k = 0; k < d->nc && d->c[k].id != id; k++)
                    ;
                if (k == d->nc)
                    return fail(d, -13, "SOS names an unknown component");
                sc[i] = &d->c[k];
                sc[i]->td = s[2 + 2 * i] >> 4;
                sc[i]->ta = s[2 + 2 * i] & 15;
                if (sc[i]->td > 3 || sc[i]->ta > 3 || !d->dc[sc[i]->td].present
                    || !d->ac[sc[i]->ta].present || !d->q_present[sc[i]->tq])
                    return fail(d, -14, "JPEG scan refers to a missing table");
            }
            const uint8_t *ss = s + 1 + 2 * ns;
            if (ss[0] != 0 || ss[1] != 63 || ss[2] != 0)
                return fail(d, -7, "progressive JPEG is not supported (baseline only)");
            int rc = 0;
            p = decode_scan(d, send, end, sc, ns, &rc);
            if (rc)
                return rc;
        }
        /* other markers (APPn, COM, DNL, ...) are skipped */
    }
    if (!d->seen_sof)
        return fail(d, -3, "no baseline frame header (SOF0/SOF1) in the JPEG file");
    return out ? finish(d, out) : 0;
}

/* Image size and components (1 grey, 3 colour). Returns 0 or a negative
 * code with a message in err. */
int gsdf_jpeg_info(const uint8_t *buf, int64_t len, int *w, int *h, int *nc,
                   char *err, int errlen)
{
    Dec d;
    memset(&d, 0, sizeof(d));
    d.err = err;
    d.errlen = errlen;
    int rc = run(&d, buf, len, NULL);
    *w = d.w;
    *h = d.h;
    *nc = d.nc;
    return rc;
}

/* Decode into out: h*w samples (grey) or h*w*3 (RGB, interleaved), where
 * cap is out's size in bytes. Returns 0 or a negative code with a message. */
int gsdf_jpeg_decode(const uint8_t *buf, int64_t len, uint8_t *out, int64_t cap,
                     char *err, int errlen)
{
    Dec d;
    memset(&d, 0, sizeof(d));
    d.err = err;
    d.errlen = errlen;
    int w, h, nc;
    int rc = gsdf_jpeg_info(buf, len, &w, &h, &nc, err, errlen);
    if (rc)
        return rc;
    if ((int64_t)w * h * (nc == 1 ? 1 : 3) > cap)
        return fail(&d, -41, "output buffer too small");
    rc = run(&d, buf, len, out);
    release(&d);
    return rc;
}
