/* Decodes the one scan of a baseline (or extended sequential, 8-bit,
 * Huffman-coded) JPEG on the host, reproducing libjpeg-turbo's default
 * decompression bit for bit: the integer "islow" IDCT (IJG jidctint.c),
 * "fancy" triangle-filter upsampling (jdsample.c) and the fixed-point
 * YCbCr -> RGB tables (jdcolor.c).
 *
 * The markers are parsed by the caller (fsnet_tpu_torch/data/datasets/
 * image_io.py), which passes the entropy-coded segment of the scan (from the
 * byte after the SOS header to the marker that ends it, RSTn markers
 * included), the frame's geometry and the tables:
 *
 *   comp[c * 8 + k], k = 0..7: h, v (sampling factors), quantisation table,
 *     DC table, AC table, width in blocks, height in blocks, offset of the
 *     component's first block in coefs (in blocks);
 *   dc_bits, ac_bits: 4 tables x 17 counts (index 1..16: codes of that
 *     length), dc_vals, ac_vals: 4 tables x 256 symbols;
 *   quant: 4 tables x 64 values in natural (row-major) order.
 *
 * jpeg_coefficients() writes the quantised coefficients of every block,
 * [block][64] in natural order, each component's plane of
 * height_in_blocks x width_in_blocks blocks at its offset.
 * jpeg_decode() does that and then the IDCT, the upsampling and the colour
 * conversion into out (height x width x ncomp bytes; ncomp 1 or 3).
 *
 * Both return 0, or a negative code that jpeg_error() names.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

enum {
    ERR_HUFF_TABLE = -1,   /* a Huffman table whose codes overflow */
    ERR_HUFF_CODE = -2,    /* a bit pattern that is no code of the table */
    ERR_RESTART = -3,      /* the expected RSTn marker is missing */
    ERR_MEMORY = -4,
    ERR_SAMPLING = -5,     /* a sampling ratio other than 1 or 2 */
};

const char *jpeg_error(int64_t code) {
    switch (code) {
    case ERR_HUFF_TABLE: return "a Huffman table's codes overflow their lengths";
    case ERR_HUFF_CODE: return "corrupt entropy-coded data (no such Huffman code)";
    case ERR_RESTART: return "a restart marker is missing or out of sequence";
    case ERR_MEMORY: return "out of memory";
    case ERR_SAMPLING: return "a sampling ratio other than 1 or 2";
    default: return "unknown error";
    }
}

/* zigzag position -> natural index; 16 extra entries absorb run lengths
 * that overshoot the block in corrupt data, as libjpeg's table does */
static const int natural_order[64 + 16] = {
    0,  1,  8, 16,  9,  2,  3, 10, 17, 24, 32, 25, 18, 11,  4,  5,
   12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,  6,  7, 14, 21, 28,
   35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
   58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
   63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63,
};

/* ------------------------------------------------------------ Huffman */

#define LOOK_BITS 9

typedef struct {
    int32_t maxcode[18];      /* largest code of each length, -1 if none */
    int32_t valoffset[17];    /* symbol index = code + valoffset[length] */
    uint8_t vals[256];
    uint8_t look_len[1 << LOOK_BITS];  /* 0: the code is longer */
    uint8_t look_sym[1 << LOOK_BITS];
} huff_t;

/* ITU T.81 Annex C: the canonical codes of bits[1..16] and vals */
static int huff_build(huff_t *t, const uint8_t *bits, const uint8_t *vals) {
    int sizes[257], codes[256], n = 0;
    for (int l = 1; l <= 16; ++l)
        for (int i = 0; i < bits[l]; ++i) {
            if (n >= 256) return ERR_HUFF_TABLE;
            sizes[n++] = l;
        }
    sizes[n] = 0;
    int code = 0, si = n ? sizes[0] : 0, p = 0;
    while (p < n) {
        while (p < n && sizes[p] == si) codes[p++] = code++;
        if (code > (1 << si)) return ERR_HUFF_TABLE;
        code <<= 1;
        ++si;
    }
    memcpy(t->vals, vals, 256);
    p = 0;
    for (int l = 1; l <= 16; ++l) {
        if (bits[l]) {
            t->valoffset[l] = p - codes[p];
            p += bits[l];
            t->maxcode[l] = codes[p - 1];
        } else {
            t->maxcode[l] = -1;
        }
    }
    t->maxcode[17] = 0x7FFFFFFF;    /* sentinel: ends the slow search */
    memset(t->look_len, 0, sizeof(t->look_len));
    for (p = 0; p < n; ++p) {
        int l = sizes[p];
        if (l > LOOK_BITS) break;
        int first = codes[p] << (LOOK_BITS - l);
        for (int i = 0; i < (1 << (LOOK_BITS - l)); ++i) {
            t->look_len[first + i] = (uint8_t)l;
            t->look_sym[first + i] = vals[p];
        }
    }
    return 0;
}

typedef struct {
    const uint8_t *p, *end;
    uint64_t buf;             /* the next `bits` bits, right-aligned */
    int bits;
    int marker;               /* a marker was reached: zeros follow */
} reader_t;

/* Tops the buffer up to at least 57 bits. Stuffed bytes (FF 00) are data
 * FF; at any other marker (or the end of the segment) the stream goes on
 * as zero bits, as libjpeg's does. */
static void fill(reader_t *r) {
    while (r->bits <= 56) {
        uint32_t c = 0;
        if (!r->marker) {
            const uint8_t *q = r->p;
            if (q >= r->end) {
                r->marker = 1;
            } else if (*q != 0xFF) {
                c = *q;
                r->p = q + 1;
            } else {
                while (q < r->end && *q == 0xFF) ++q;  /* fill bytes */
                if (q < r->end && *q == 0x00) {
                    c = 0xFF;
                    r->p = q + 1;
                } else {
                    r->marker = 1;   /* r->p stays on the marker's FF */
                }
            }
        }
        r->buf = (r->buf << 8) | c;
        r->bits += 8;
    }
}

static inline int get_bits(reader_t *r, int n) {
    if (n == 0) return 0;
    if (r->bits < n) fill(r);
    r->bits -= n;
    return (int)((r->buf >> r->bits) & ((1u << n) - 1));
}

/* F.12: the n-bit magnitude category value -> a signed coefficient */
static inline int extend(int v, int n) {
    return v < (1 << (n - 1)) ? v - (1 << n) + 1 : v;
}

static int decode(reader_t *r, const huff_t *t) {
    if (r->bits < 16) fill(r);
    int look = (int)((r->buf >> (r->bits - LOOK_BITS)) & ((1 << LOOK_BITS) - 1));
    int l = t->look_len[look];
    if (l) {
        r->bits -= l;
        return t->look_sym[look];
    }
    l = LOOK_BITS + 1;
    int code = (int)((r->buf >> (r->bits - l)) & ((1 << l) - 1));
    while (code > t->maxcode[l]) {
        if (++l > 16) return ERR_HUFF_CODE;
        code = (int)((r->buf >> (r->bits - l)) & ((1 << l) - 1));
    }
    r->bits -= l;
    return t->vals[(code + t->valoffset[l]) & 0xFF];
}

/* discards the buffered bits and reads RST(num & 7) */
static int restart(reader_t *r, int num) {
    const uint8_t *q = r->p;
    r->buf = 0;
    r->bits = 0;
    r->marker = 0;
    if (q >= r->end || *q != 0xFF) return ERR_RESTART;
    while (q < r->end && *q == 0xFF) ++q;
    if (q >= r->end || *q != 0xD0 + (num & 7)) return ERR_RESTART;
    r->p = q + 1;
    return 0;
}

int64_t jpeg_coefficients(const uint8_t *scan, int64_t scan_len,
                          int64_t ncomp, const int64_t *comp,
                          int64_t mcus_x, int64_t mcus_y,
                          int64_t restart_interval,
                          const uint8_t *dc_bits, const uint8_t *dc_vals,
                          const uint8_t *ac_bits, const uint8_t *ac_vals,
                          int16_t *coefs) {
    huff_t *tables = malloc(8 * sizeof(huff_t));
    if (!tables) return ERR_MEMORY;
    int rc = 0;
    for (int i = 0; i < 4 && !rc; ++i) {
        rc = huff_build(&tables[i], dc_bits + 17 * i, dc_vals + 256 * i);
        if (!rc)
            rc = huff_build(&tables[4 + i], ac_bits + 17 * i,
                            ac_vals + 256 * i);
    }
    if (rc) {
        free(tables);
        return rc;
    }
    reader_t r = {scan, scan + scan_len, 0, 0, 0};
    int pred[4] = {0, 0, 0, 0};
    int64_t mcus = 0, restarts = 0;
    /* one component: a non-interleaved scan, one block an MCU */
    const int single = ncomp == 1;
    for (int64_t my = 0; my < mcus_y && !rc; ++my) {
        for (int64_t mx = 0; mx < mcus_x && !rc; ++mx, ++mcus) {
            if (restart_interval && mcus && mcus % restart_interval == 0) {
                rc = restart(&r, (int)restarts++);
                if (rc) break;
                pred[0] = pred[1] = pred[2] = pred[3] = 0;
            }
            for (int c = 0; c < ncomp && !rc; ++c) {
                const int64_t *k = comp + 8 * c;
                const int h = single ? 1 : (int)k[0];
                const int v = single ? 1 : (int)k[1];
                const huff_t *dc = &tables[k[3]], *ac = &tables[4 + k[4]];
                for (int by = 0; by < v && !rc; ++by) {
                    for (int bx = 0; bx < h; ++bx) {
                        int64_t row = my * v + by, col = mx * h + bx;
                        int16_t *blk = coefs
                            + 64 * (k[7] + row * k[5] + col);
                        memset(blk, 0, 64 * sizeof(int16_t));
                        int s = decode(&r, dc);
                        if (s < 0) { rc = s; break; }
                        if (s) s = extend(get_bits(&r, s), s);
                        pred[c] += s;
                        blk[0] = (int16_t)pred[c];
                        for (int z = 1; z < 64; ++z) {
                            int rs = decode(&r, ac);
                            if (rs < 0) { rc = rs; break; }
                            int run = rs >> 4;
                            s = rs & 15;
                            if (s) {
                                z += run;
                                blk[natural_order[z]] = (int16_t)extend(
                                    get_bits(&r, s), s);
                            } else {
                                if (run != 15) break;
                                z += 15;
                            }
                        }
                        if (rc) break;
                    }
                }
            }
        }
    }
    free(tables);
    return rc;
}

/* ---------------------------------------------------------- islow IDCT */

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
#define RANGE_MASK 1023

/* libjpeg's post-IDCT range limit: index (value & 1023) of a value centred
 * on 0; [-128, 127] -> [0, 255], [128, 511] -> 255, [-512, -129] -> 0,
 * beyond that the mask wraps */
static uint8_t idct_limit[1024];

static void init_limit(void) {
    for (int j = 0; j < 1024; ++j) {
        int v = j < 512 ? j : j - 1024;
        idct_limit[j] = (uint8_t)(v < -128 ? 0 : v > 127 ? 255 : v + 128);
    }
}

/* one 8-point pass of jidctint.c: in[0..7] (stride) -> the 8 sums */
#define IDCT_1D(i0, i1, i2, i3, i4, i5, i6, i7, OUT, SHIFT)               \
    do {                                                                  \
        int64_t z1, z2, z3, z4, z5, t0, t1, t2, t3, t10, t11, t12, t13;   \
        z2 = (i2); z3 = (i6);                                             \
        z1 = (z2 + z3) * FIX_0_541196100;                                 \
        t2 = z1 + z3 * (-FIX_1_847759065);                                \
        t3 = z1 + z2 * FIX_0_765366865;                                   \
        z2 = (i0); z3 = (i4);                                             \
        t0 = (z2 + z3) * ((int64_t)1 << CONST_BITS);                      \
        t1 = (z2 - z3) * ((int64_t)1 << CONST_BITS);                      \
        t10 = t0 + t3; t13 = t0 - t3; t11 = t1 + t2; t12 = t1 - t2;       \
        t0 = (i7); t1 = (i5); t2 = (i3); t3 = (i1);                       \
        z1 = t0 + t3; z2 = t1 + t2; z3 = t0 + t2; z4 = t1 + t3;           \
        z5 = (z3 + z4) * FIX_1_175875602;                                 \
        t0 = t0 * FIX_0_298631336; t1 = t1 * FIX_2_053119869;             \
        t2 = t2 * FIX_3_072711026; t3 = t3 * FIX_1_501321110;             \
        z1 = z1 * (-FIX_0_899976223); z2 = z2 * (-FIX_2_562915447);       \
        z3 = z3 * (-FIX_1_961570560); z4 = z4 * (-FIX_0_390180644);       \
        z3 += z5; z4 += z5;                                               \
        t0 += z1 + z3; t1 += z2 + z4; t2 += z2 + z3; t3 += z1 + z4;       \
        OUT(0, DESCALE(t10 + t3, SHIFT)); OUT(7, DESCALE(t10 - t3, SHIFT)); \
        OUT(1, DESCALE(t11 + t2, SHIFT)); OUT(6, DESCALE(t11 - t2, SHIFT)); \
        OUT(2, DESCALE(t12 + t1, SHIFT)); OUT(5, DESCALE(t12 - t1, SHIFT)); \
        OUT(3, DESCALE(t13 + t0, SHIFT)); OUT(4, DESCALE(t13 - t0, SHIFT)); \
    } while (0)

static void idct_islow(const int16_t *coef, const uint16_t *q, uint8_t *out,
                       int64_t stride) {
    int64_t ws[64];
    for (int c = 0; c < 8; ++c) {          /* columns */
        const int16_t *in = coef + c;
        const uint16_t *qc = q + c;
        if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48]
            && !in[56]) {
            int64_t dc = (int64_t)in[0] * qc[0] * (1 << PASS1_BITS);
            for (int k = 0; k < 8; ++k) ws[8 * k + c] = dc;
            continue;
        }
#define COL(k, val) ws[8 * (k) + c] = (val)
        IDCT_1D((int64_t)in[0] * qc[0], (int64_t)in[8] * qc[8],
                (int64_t)in[16] * qc[16], (int64_t)in[24] * qc[24],
                (int64_t)in[32] * qc[32], (int64_t)in[40] * qc[40],
                (int64_t)in[48] * qc[48], (int64_t)in[56] * qc[56],
                COL, CONST_BITS - PASS1_BITS);
#undef COL
    }
    for (int r = 0; r < 8; ++r) {          /* rows */
        const int64_t *w = ws + 8 * r;
        uint8_t *o = out + r * stride;
        if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
            uint8_t v = idct_limit[DESCALE(w[0], PASS1_BITS + 3) & RANGE_MASK];
            for (int k = 0; k < 8; ++k) o[k] = v;
            continue;
        }
#define ROW(k, val) o[k] = idct_limit[(val) & RANGE_MASK]
        IDCT_1D(w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7], ROW,
                CONST_BITS + PASS1_BITS + 3);
#undef ROW
    }
}

/* --------------------------------------------------------- upsampling */

/* The component's plane (pw wide, its first dh rows and dw columns real)
 * -> out, height x width: libjpeg-turbo's fancy upsamplers for ratios
 * (2, 1), (1, 2) and (2, 2) (box replication where the downsampled width
 * is 2 or less, as libjpeg's), with the first and last real row and column
 * standing in for their neighbours beyond the edges. */
static void upsample(const uint8_t *in, int64_t pw, int64_t dw, int64_t dh,
                     int rh, int rv, uint8_t *out, int64_t width,
                     int64_t height, int *colsum) {
    for (int64_t y = 0; y < height; ++y) {
        uint8_t *o = out + y * width;
        const int64_t r = rv == 2 ? y >> 1 : y;
        const uint8_t *row = in + r * pw;
        if (rv == 1 && rh == 1) {
            memcpy(o, row, (size_t)width);
        } else if (rv == 1) {                  /* h2v1 */
            for (int64_t x = 0; x < width; ++x) {
                int64_t i = x >> 1;
                if (dw <= 2) {
                    o[x] = row[i];
                } else if (x & 1) {
                    int64_t n = i + 1 < dw ? i + 1 : dw - 1;
                    o[x] = (uint8_t)((3 * row[i] + row[n] + 2) >> 2);
                } else {
                    int64_t p = i > 0 ? i - 1 : 0;
                    o[x] = (uint8_t)((3 * row[i] + row[p] + 1) >> 2);
                }
            }
        } else {
            const int64_t nr = (y & 1) ? (r + 1 < dh ? r + 1 : dh - 1)
                                       : (r > 0 ? r - 1 : 0);
            const uint8_t *near = in + nr * pw;
            if (rh == 1) {                     /* h1v2 */
                const int bias = (y & 1) ? 2 : 1;
                for (int64_t x = 0; x < width; ++x)
                    o[x] = (uint8_t)((3 * row[x] + near[x] + bias) >> 2);
            } else if (dw <= 2) {              /* h2v2, box */
                for (int64_t x = 0; x < width; ++x) o[x] = row[x >> 1];
            } else {                           /* h2v2 */
                for (int64_t i = 0; i < dw; ++i)
                    colsum[i] = 3 * row[i] + near[i];
                for (int64_t x = 0; x < width; ++x) {
                    int64_t i = x >> 1;
                    if (x & 1) {
                        int64_t n = i + 1 < dw ? i + 1 : dw - 1;
                        o[x] = (uint8_t)((3 * colsum[i] + colsum[n] + 7) >> 4);
                    } else {
                        int64_t p = i > 0 ? i - 1 : 0;
                        o[x] = (uint8_t)((3 * colsum[i] + colsum[p] + 8) >> 4);
                    }
                }
            }
        }
    }
}

/* ------------------------------------------------------------- colour */

#define SCALEBITS 16
#define ONE_HALF ((int64_t)1 << (SCALEBITS - 1))
#define FIX(x) ((int64_t)((x) * (1L << SCALEBITS) + 0.5))

static int cr_r[256], cb_b[256];
static int64_t cr_g[256], cb_g[256];

static void init_colour(void) {
    for (int i = 0; i < 256; ++i) {
        int64_t x = i - 128;
        cr_r[i] = (int)((FIX(1.40200) * x + ONE_HALF) >> SCALEBITS);
        cb_b[i] = (int)((FIX(1.77200) * x + ONE_HALF) >> SCALEBITS);
        cr_g[i] = -FIX(0.71414) * x;
        cb_g[i] = -FIX(0.34414) * x + ONE_HALF;
    }
}

static inline uint8_t clamp255(int v) {
    return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

int64_t jpeg_decode(const uint8_t *scan, int64_t scan_len, int64_t ncomp,
                    const int64_t *comp, int64_t mcus_x, int64_t mcus_y,
                    int64_t restart_interval, const uint8_t *dc_bits,
                    const uint8_t *dc_vals, const uint8_t *ac_bits,
                    const uint8_t *ac_vals, const uint16_t *quant,
                    int64_t width, int64_t height, int16_t *coefs,
                    uint8_t *out) {
    int64_t rc = jpeg_coefficients(scan, scan_len, ncomp, comp, mcus_x,
                                   mcus_y, restart_interval, dc_bits,
                                   dc_vals, ac_bits, ac_vals, coefs);
    if (rc) return rc;
    init_limit();
    init_colour();
    int hmax = 1, vmax = 1;
    for (int c = 0; c < ncomp; ++c) {
        if (comp[8 * c] > hmax) hmax = (int)comp[8 * c];
        if (comp[8 * c + 1] > vmax) vmax = (int)comp[8 * c + 1];
    }
    uint8_t *planes[3] = {NULL, NULL, NULL}, *full[3] = {NULL, NULL, NULL};
    int *colsum = malloc(sizeof(int) * (size_t)(width + 16));
    rc = colsum ? 0 : ERR_MEMORY;
    for (int c = 0; c < ncomp && !rc; ++c) {
        const int64_t *k = comp + 8 * c;
        const int64_t bw = k[5], bh = k[6], pw = 8 * bw;
        const int h = ncomp == 1 ? 1 : (int)k[0];
        const int v = ncomp == 1 ? 1 : (int)k[1];
        const int rh = ncomp == 1 ? 1 : hmax / h;
        const int rv = ncomp == 1 ? 1 : vmax / v;
        if ((rh != 1 && rh != 2) || (rv != 1 && rv != 2) || rh * h != hmax
            || rv * v != vmax) {
            rc = ERR_SAMPLING;
            break;
        }
        planes[c] = malloc((size_t)(pw * 8 * bh));
        full[c] = malloc((size_t)(width * height));
        if (!planes[c] || !full[c]) {
            rc = ERR_MEMORY;
            break;
        }
        const uint16_t *q = quant + 64 * k[2];
        for (int64_t by = 0; by < bh; ++by)
            for (int64_t bx = 0; bx < bw; ++bx)
                idct_islow(coefs + 64 * (k[7] + by * bw + bx), q,
                           planes[c] + by * 8 * pw + bx * 8, pw);
        /* the downsampled size: ceil(width * h / hmax) */
        const int64_t dw = (width * h + hmax - 1) / hmax;
        const int64_t dh = (height * v + vmax - 1) / vmax;
        upsample(planes[c], pw, dw, dh, rh, rv, full[c], width, height,
                 colsum);
    }
    if (!rc) {
        const int64_t n = width * height;
        if (ncomp == 1) {
            memcpy(out, full[0], (size_t)n);
        } else {
            for (int64_t i = 0; i < n; ++i) {
                int y = full[0][i], cb = full[1][i], cr = full[2][i];
                out[3 * i] = clamp255(y + cr_r[cr]);
                out[3 * i + 1] = clamp255(
                    y + (int)((cb_g[cb] + cr_g[cr]) >> SCALEBITS));
                out[3 * i + 2] = clamp255(y + cb_b[cb]);
            }
        }
    }
    for (int c = 0; c < 3; ++c) {
        free(planes[c]);
        free(full[c]);
    }
    free(colsum);
    return rc;
}
