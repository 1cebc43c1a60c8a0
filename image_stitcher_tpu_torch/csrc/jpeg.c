/* Baseline JPEG written by hand: the decoder of .jpg tiles and the
 * encoder of JPEG OME-TIFF tiles.
 *
 * The port's host-side counterpart of the libjpeg-turbo that OpenCV links
 * for the JAX package's cv2.imread and cv2.imencode('.jpg'). Built at
 * first use with the system C compiler and bound with ctypes
 * (image_stitcher_tpu_torch/native, io/jpeg.py); every function is
 * reentrant, works on caller-owned buffers and touches no Python object,
 * so ctypes calls run with the interpreter lock released and the tile
 * loader's threads and the TIFF writer's encode pool work in parallel.
 *
 * io/jpeg_plain.py is the specification: its module docstring sets out
 * the scope and libjpeg-turbo's integer arithmetic (the islow DCTs, the
 * fancy upsampling, the colour tables, the reciprocal quantisation, the
 * edge padding, the markers) that both follow; the two give equal pixels
 * and equal streams, byte for byte, and refuse the same streams.
 *
 * Decoding is bound by the Huffman decoder's serial dependency (a 9-bit
 * lookup per symbol, a canonical search for longer codes); the IDCT,
 * upsampling and colour conversion are a few operations a sample.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define ERR_ARGS -1
#define ERR_CORRUPT -2
#define ERR_NOMEM -4
#define ERR_SPACE -5
/* streams outside the scope (io/jpeg.py names each) */
#define ERR_PROGRESSIVE -10
#define ERR_ARITHMETIC -11
#define ERR_LOSSLESS -12
#define ERR_HIERARCHICAL -13
#define ERR_PRECISION -14
#define ERR_COMPONENTS -15
#define ERR_SAMPLING -16
#define ERR_ADOBE -17
#define ERR_RGB_IDS -18
#define ERR_COEF_RANGE -19

static const uint8_t ZIGZAG[64] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

static const uint8_t STD_QUANT[2][64] = {
    {16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
     14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
     18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103,
     99},
    {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
     24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99}};

static const uint8_t DC_BITS[2][16] = {
    {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
    {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
static const uint8_t DC_VALS[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
static const uint8_t AC_BITS[2][16] = {
    {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
    {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};
static const uint8_t AC_VALS[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41,
     0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91,
     0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24,
     0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a,
     0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38,
     0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53,
     0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66,
     0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
     0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93,
     0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
     0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7,
     0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
     0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1,
     0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
     0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12,
     0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14,
     0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15,
     0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17,
     0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37,
     0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a,
     0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65,
     0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
     0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a,
     0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
     0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5,
     0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
     0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9,
     0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
     0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

/* the islow DCTs' constants (13 fraction bits) */
#define F0298 2446
#define F0390 3196
#define F0541 4433
#define F0765 6270
#define F0899 7373
#define F1175 9633
#define F1501 12299
#define F1847 15137
#define F1961 16069
#define F2053 16819
#define F2562 20995
#define F3072 25172

#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n) - 1))) >> (n))

/* ------------------------------------------------------------ the DCTs */

/* the inverse butterfly on c[0..7] at stride s, outputs before descale */
static void inv_butterfly(const int64_t *c, int s, int64_t out[8])
{
    int64_t z1 = (c[2 * s] + c[6 * s]) * F0541;
    int64_t tmp2 = z1 - c[6 * s] * F1847;
    int64_t tmp3 = z1 + c[2 * s] * F0765;
    int64_t tmp0 = (c[0] + c[4 * s]) * 8192;
    int64_t tmp1 = (c[0] - c[4 * s]) * 8192;
    int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3;
    int64_t t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    int64_t o0 = c[7 * s], o1 = c[5 * s], o2 = c[3 * s], o3 = c[s];
    int64_t za = o0 + o3, zb = o1 + o2, zc = o0 + o2, zd = o1 + o3;
    int64_t z5 = (zc + zd) * F1175;
    o0 *= F0298;
    o1 *= F2053;
    o2 *= F3072;
    o3 *= F1501;
    za *= -F0899;
    zb *= -F2562;
    zc = zc * -F1961 + z5;
    zd = zd * -F0390 + z5;
    o0 += za + zc;
    o1 += zb + zd;
    o2 += zb + zc;
    o3 += za + zd;
    out[0] = t10 + o3;
    out[1] = t11 + o2;
    out[2] = t12 + o1;
    out[3] = t13 + o0;
    out[4] = t13 - o0;
    out[5] = t12 - o1;
    out[6] = t11 - o2;
    out[7] = t10 - o3;
}

/* libjpeg's post-IDCT range limit of v (centred) */
static uint8_t post_idct(int64_t v)
{
    int64_t m = v & 1023;
    if (m >= 512)
        m -= 1024;
    m += 128;
    return (uint8_t)(m < 0 ? 0 : m > 255 ? 255 : m);
}

/* jpeg_idct_islow: one block of quantised coefficients (natural order)
 * into 8x8 samples at out (row pitch). */
static void idct_islow(const int16_t *coef, const uint16_t *quant,
                       uint8_t *out, int64_t pitch)
{
    int64_t c[64], ws[64], t[8];
    for (int k = 0; k < 64; ++k)
        c[k] = (int64_t)coef[k] * quant[k];
    /* a column or row whose AC terms are all zero gives its DC term,
     * descaled: the same values the butterfly gives */
    for (int col = 0; col < 8; ++col) {
        if (!(c[8 + col] | c[16 + col] | c[24 + col] | c[32 + col]
              | c[40 + col] | c[48 + col] | c[56 + col])) {
            for (int k = 0; k < 8; ++k)
                ws[k * 8 + col] = c[col] * 4;
            continue;
        }
        inv_butterfly(c + col, 8, t);
        for (int k = 0; k < 8; ++k)
            ws[k * 8 + col] = DESCALE(t[k], 11);
    }
    for (int row = 0; row < 8; ++row) {
        const int64_t *r = ws + row * 8;
        uint8_t *o = out + row * pitch;
        if (!(r[1] | r[2] | r[3] | r[4] | r[5] | r[6] | r[7])) {
            uint8_t v = post_idct(DESCALE(r[0], 5));
            for (int k = 0; k < 8; ++k)
                o[k] = v;
            continue;
        }
        inv_butterfly(r, 1, t);
        for (int k = 0; k < 8; ++k)
            o[k] = post_idct(DESCALE(t[k], 18));
    }
}

/* the forward butterfly on d[0..7] at stride s: outputs 0..7 before
 * their descale (0 and 4 unshifted sums) */
static void fwd_butterfly(const int64_t *d, int s, int64_t out[8])
{
    int64_t tmp0 = d[0] + d[7 * s], tmp7 = d[0] - d[7 * s];
    int64_t tmp1 = d[s] + d[6 * s], tmp6 = d[s] - d[6 * s];
    int64_t tmp2 = d[2 * s] + d[5 * s], tmp5 = d[2 * s] - d[5 * s];
    int64_t tmp3 = d[3 * s] + d[4 * s], tmp4 = d[3 * s] - d[4 * s];
    int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3;
    int64_t t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    out[0] = t10 + t11;
    out[4] = t10 - t11;
    int64_t z1 = (t12 + t13) * F0541;
    out[2] = z1 + t13 * F0765;
    out[6] = z1 - t12 * F1847;
    int64_t za = tmp4 + tmp7, zb = tmp5 + tmp6;
    int64_t zc = tmp4 + tmp6, zd = tmp5 + tmp7;
    int64_t z5 = (zc + zd) * F1175;
    za *= -F0899;
    zb *= -F2562;
    zc = zc * -F1961 + z5;
    zd = zd * -F0390 + z5;
    out[7] = tmp4 * F0298 + za + zc;
    out[5] = tmp5 * F2053 + zb + zd;
    out[3] = tmp6 * F3072 + zb + zc;
    out[1] = tmp7 * F1501 + za + zd;
}

/* jpeg_fdct_islow on samples - 128 at src (row pitch), then
 * libjpeg-turbo's quantisation by (recip, corr, shift) per coefficient;
 * the quantised block in natural order */
static void fdct_quantize(const uint8_t *src, int64_t pitch,
                          const int64_t *recip, const int64_t *corr,
                          const int *shift, int16_t *out)
{
    int64_t d[64], ws[64], t[8];
    for (int r = 0; r < 8; ++r)
        for (int k = 0; k < 8; ++k)
            d[r * 8 + k] = (int64_t)src[r * pitch + k] - 128;
    for (int r = 0; r < 8; ++r) {
        fwd_butterfly(d + r * 8, 1, t);
        for (int k = 0; k < 8; ++k)
            ws[r * 8 + k] = (k == 0 || k == 4) ? t[k] * 4
                                                 : DESCALE(t[k], 11);
    }
    for (int col = 0; col < 8; ++col) {
        fwd_butterfly(ws + col, 8, t);
        for (int k = 0; k < 8; ++k) {
            int64_t v = (k == 0 || k == 4) ? DESCALE(t[k], 2)
                                           : DESCALE(t[k], 15);
            int i = k * 8 + col;
            int64_t mag = (((v < 0 ? -v : v) + corr[i]) * recip[i])
                          >> shift[i];
            out[i] = (int16_t)(v < 0 ? -mag : mag);
        }
    }
}

/* libjpeg-turbo's compute_reciprocal (16-bit DCTELEM) */
static void reciprocal(int64_t divisor, int64_t *recip, int64_t *corr,
                       int *shift)
{
    int b = 0;
    while ((divisor >> (b + 1)) != 0)
        ++b;
    int r = 16 + b;
    int64_t fq = ((int64_t)1 << r) / divisor;
    int64_t fr = ((int64_t)1 << r) % divisor;
    int64_t c = divisor / 2;
    if (fr == 0) {
        fq >>= 1;
        --r;
    } else if (fr <= divisor / 2) {
        ++c;
    } else {
        ++fq;
    }
    *recip = fq;
    *corr = c;
    *shift = r;
}

/* jpeg_set_quality(quality, TRUE): table t (0 luma, 1 chroma), natural */
static void quant_table(int quality, int t, uint16_t *out)
{
    int q = quality < 1 ? 1 : quality > 100 ? 100 : quality;
    int scale = q < 50 ? 5000 / q : 200 - 2 * q;
    for (int k = 0; k < 64; ++k) {
        long v = ((long)STD_QUANT[t][k] * scale + 50) / 100;
        out[k] = (uint16_t)(v < 1 ? 1 : v > 255 ? 255 : v);
    }
}

/* ------------------------------------------------------------ Huffman */

#define FAST_AC_BITS 10

typedef struct {
    uint16_t fast[512];     /* sym << 8 | length for codes of <= 9 bits */
    /* an AC code and its magnitude bits within FAST_AC_BITS: value << 16
     * | run << 8 | bits taken; 0 where they do not fit */
    int32_t fast_ac[1 << FAST_AC_BITS];
    int32_t maxcode[18];    /* largest code of each length, -1 if none */
    int32_t valoff[17];     /* HUFFVAL index of a length's first code */
    int32_t mincode[17];
    uint8_t vals[256];
    int defined;
} htable;

/* build a decoding table from BITS and HUFFVAL; 0, or ERR_CORRUPT */
static int build_htable(htable *t, const uint8_t *bits, const uint8_t *vals,
                        int count)
{
    int32_t code = 0, k = 0;
    memset(t->fast, 0, sizeof(t->fast));
    memcpy(t->vals, vals, (size_t)count);
    for (int len = 1; len <= 16; ++len) {
        t->valoff[len] = k;
        t->mincode[len] = code;
        code += bits[len - 1];
        if (code > (1 << len))
            return ERR_CORRUPT;
        t->maxcode[len] = bits[len - 1] ? code - 1 : -1;
        for (int32_t c = t->mincode[len]; len <= 9 && c < code; ++c) {
            int lo = c << (9 - len), n = 1 << (9 - len);
            for (int j = 0; j < n; ++j)
                t->fast[lo + j] = (uint16_t)(vals[k + c - t->mincode[len]]
                                             << 8 | len);
        }
        k += bits[len - 1];
        code <<= 1;
    }
    t->maxcode[17] = 0x7fffffff;
    /* AC codes with their magnitude bits in FAST_AC_BITS, decoded whole */
    memset(t->fast_ac, 0, sizeof(t->fast_ac));
    for (int i = 0; i < (1 << FAST_AC_BITS); ++i) {
        unsigned e = t->fast[i >> (FAST_AC_BITS - 9)];
        int len = e & 255, sym = e >> 8, s = sym & 15;
        if (!e || !s || len + s > FAST_AC_BITS)
            continue;
        int32_t v = (i >> (FAST_AC_BITS - len - s)) & ((1 << s) - 1);
        if (v < (1 << (s - 1)))
            v -= (1 << s) - 1;
        t->fast_ac[i] = (int32_t)((uint32_t)v << 16) | (sym >> 4) << 8
                        | (len + s);
    }
    t->defined = 1;
    return 0;
}

/* the 64 bits at bit position pos of a zero-padded buffer, MSB first */
static inline uint64_t peek(const uint8_t *buf, int64_t pos)
{
    uint64_t w;
    memcpy(&w, buf + (pos >> 3), 8);
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
    w = __builtin_bswap64(w);
#endif
    return w << (pos & 7);
}

/* one symbol at bit position *pos: sym, or -1 for no code */
static inline int huff_decode(const htable *t, const uint8_t *buf,
                              int64_t *pos, uint64_t *w)
{
    *w = peek(buf, *pos);
    unsigned e = t->fast[*w >> 55];
    if (e) {
        *pos += e & 255;
        *w <<= e & 255;
        return (int)(e >> 8);
    }
    for (int len = 10; len <= 16; ++len) {
        int32_t code = (int32_t)(*w >> (64 - len));
        if (t->maxcode[len] >= 0 && code <= t->maxcode[len]
                && code >= t->mincode[len]) {
            *pos += len;
            *w <<= len;
            return t->vals[t->valoff[len] + code - t->mincode[len]];
        }
    }
    return -1;
}

/* the s-bit magnitude at the top of w, extended to its value */
static inline int32_t extend(uint64_t w, int s)
{
    int32_t v = (int32_t)(w >> (64 - s));
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

/* ------------------------------------------------------------ decoder */

typedef struct {
    int id, h, v, tq;
    int64_t bw, bh;        /* blocks of the MCU-padded grid */
    int16_t *coef;         /* bh * bw * 64, natural order */
    int32_t pred;
} comp_t;

typedef struct {
    uint16_t quant[4][64];
    int qdef[4];
    htable dc[4], ac[4];
    int restart, jfif, adobe, ncomp;
    int64_t height, width;
    int hmax, vmax;
    int64_t mcux, mcuy;
    comp_t comp[3];
} frame_t;

static int parse_sof(frame_t *f, int marker, const uint8_t *b, int64_t n)
{
    if (marker == 0xC2 || marker == 0xC6 || marker == 0xCA
            || marker == 0xCE)
        return ERR_PROGRESSIVE;
    if (marker == 0xC9 || marker == 0xCB || marker == 0xCD
            || marker == 0xCF)
        return ERR_ARITHMETIC;
    if (marker == 0xC3 || marker == 0xC7)
        return ERR_LOSSLESS;
    if (marker == 0xC5)
        return ERR_HIERARCHICAL;
    if (f->ncomp)
        return ERR_CORRUPT;
    if (n < 6)
        return ERR_CORRUPT;
    if (b[0] != 8)
        return ERR_PRECISION;
    f->height = b[1] << 8 | b[2];
    f->width = b[3] << 8 | b[4];
    int nc = b[5];
    if (nc != 1 && nc != 3)
        return ERR_COMPONENTS;
    if (f->height == 0 || f->width == 0 || n < 6 + 3 * nc)
        return ERR_CORRUPT;
    for (int k = 0; k < nc; ++k) {
        comp_t *c = &f->comp[k];
        c->id = b[6 + 3 * k];
        c->h = b[7 + 3 * k] >> 4;
        c->v = b[7 + 3 * k] & 15;
        c->tq = b[8 + 3 * k];
    }
    if (f->comp[0].h < 1 || f->comp[0].h > 2 || f->comp[0].v < 1
            || f->comp[0].v > 2)
        return ERR_SAMPLING;
    for (int k = 1; k < nc; ++k)
        if (f->comp[k].h != 1 || f->comp[k].v != 1)
            return ERR_SAMPLING;
    f->ncomp = nc;
    f->hmax = f->comp[0].h;
    f->vmax = f->comp[0].v;
    f->mcux = (f->width + 8 * f->hmax - 1) / (8 * f->hmax);
    f->mcuy = (f->height + 8 * f->vmax - 1) / (8 * f->vmax);
    for (int k = 0; k < nc; ++k) {
        f->comp[k].bw = f->mcux * f->comp[k].h;
        f->comp[k].bh = f->mcuy * f->comp[k].v;
    }
    return 0;
}

static int alloc_coef(frame_t *f)
{
    for (int k = 0; k < f->ncomp; ++k) {
        comp_t *c = &f->comp[k];
        c->coef = (int16_t *)calloc((size_t)(c->bw * c->bh * 64),
                                    sizeof(int16_t));
        if (c->coef == NULL)
            return ERR_NOMEM;
    }
    return 0;
}

static int parse_dqt(frame_t *f, const uint8_t *b, int64_t n)
{
    int64_t k = 0;
    while (k < n) {
        int pq = b[k] >> 4, tq = b[k] & 15;
        int64_t size = pq ? 128 : 64;
        if (pq > 1 || tq > 3 || k + 1 + size > n)
            return ERR_CORRUPT;
        for (int i = 0; i < 64; ++i)
            f->quant[tq][ZIGZAG[i]] = pq
                ? (uint16_t)(b[k + 1 + 2 * i] << 8 | b[k + 2 + 2 * i])
                : b[k + 1 + i];
        f->qdef[tq] = 1;
        k += 1 + size;
    }
    return 0;
}

static int parse_dht(frame_t *f, const uint8_t *b, int64_t n)
{
    int64_t k = 0;
    while (k < n) {
        int tc = b[k] >> 4, th = b[k] & 15;
        if (tc > 1 || th > 3 || k + 17 > n)
            return ERR_CORRUPT;
        int count = 0;
        for (int i = 0; i < 16; ++i)
            count += b[k + 1 + i];
        if (count > 256 || k + 17 + count > n)
            return ERR_CORRUPT;
        for (int i = 0; !tc && i < count; ++i)
            if (b[k + 17 + i] > 15)
                return ERR_CORRUPT;     /* a DC category over 15 */
        int rc = build_htable(tc ? &f->ac[th] : &f->dc[th], b + k + 1,
                              b + k + 17, count);
        if (rc)
            return rc;
        k += 17 + count;
    }
    return 0;
}

/* the offset of the first marker at or after pos that is not a stuffed
 * 0xFF00, an RSTn or fill; -1 when there is none */
static int64_t entropy_end(const uint8_t *d, int64_t n, int64_t pos)
{
    for (;;) {
        const uint8_t *p = memchr(d + pos, 0xFF, (size_t)(n - pos));
        if (p == NULL)
            return -1;
        pos = p - d;
        if (pos + 1 >= n)
            return -1;
        uint8_t nx = d[pos + 1];
        if (nx == 0 || (nx >= 0xD0 && nx <= 0xD7) || nx == 0xFF) {
            ++pos;
            continue;
        }
        return pos;
    }
}

/* copy one segment's entropy-coded bytes into buf without the stuffed
 * zeros, 16 zero bytes after them; their count, or ERR_CORRUPT for a
 * marker inside */
static int64_t destuff(const uint8_t *s, int64_t n, uint8_t *buf)
{
    int64_t o = 0;
    for (int64_t i = 0; i < n; ++i) {
        buf[o++] = s[i];
        if (s[i] == 0xFF) {
            if (i + 1 >= n || s[i + 1] != 0)
                return ERR_CORRUPT;
            ++i;
        }
    }
    memset(buf + o, 0, 16);
    return o;
}

/* one block's coefficients from the bit position *pos; the segment
 * holds limit bits */
static int decode_block(const htable *dct, const htable *act,
                        const uint8_t *buf, int64_t limit, int64_t *pos,
                        int32_t *pred, int16_t *out)
{
    uint64_t w;
    int s = huff_decode(dct, buf, pos, &w);
    if (s < 0)
        return ERR_CORRUPT;
    if (s) {
        *pred += extend(w, s);
        *pos += s;
    }
    if (*pos > limit)
        return ERR_CORRUPT;
    out[0] = (int16_t)*pred;
    for (int k = 1; k < 64;) {
        int32_t f = act->fast_ac[peek(buf, *pos) >> (64 - FAST_AC_BITS)];
        if (f) {
            k += (f >> 8) & 15;
            if (k > 63)
                return ERR_CORRUPT;
            out[ZIGZAG[k]] = (int16_t)(f >> 16);
            *pos += f & 255;
            ++k;
            if (*pos > limit)
                return ERR_CORRUPT;
            continue;
        }
        int e = huff_decode(act, buf, pos, &w);
        if (e < 0)
            return ERR_CORRUPT;
        int r = e >> 4;
        s = e & 15;
        if (s) {
            k += r;
            if (k > 63)
                return ERR_CORRUPT;
            out[ZIGZAG[k]] = (int16_t)extend(w, s);
            *pos += s;
            ++k;
        } else if (r == 15) {
            k += 16;
            if (k > 64)
                return ERR_CORRUPT;
        } else {
            break;
        }
        if (*pos > limit)
            return ERR_CORRUPT;
    }
    return *pos > limit ? ERR_CORRUPT : 0;
}

static int decode_scan(frame_t *f, const uint8_t *b, int64_t n,
                       const uint8_t *d, int64_t dn, int64_t *pos)
{
    if (n < 1)
        return ERR_CORRUPT;
    int ns = b[0];
    if (ns < 1 || ns > f->ncomp || n < 4 + 2 * ns)
        return ERR_CORRUPT;
    int sc[3];
    const htable *dct[3], *act[3];
    for (int k = 0; k < ns; ++k) {
        int cid = b[1 + 2 * k], t = b[2 + 2 * k], ci = -1;
        for (int j = 0; j < f->ncomp; ++j)
            if (f->comp[j].id == cid && ci < 0)
                ci = j;
        if (ci < 0 || (t >> 4) > 3 || (t & 15) > 3
                || !f->dc[t >> 4].defined || !f->ac[t & 15].defined)
            return ERR_CORRUPT;
        sc[k] = ci;
        dct[k] = &f->dc[t >> 4];
        act[k] = &f->ac[t & 15];
    }
    if (b[1 + 2 * ns] != 0 || b[2 + 2 * ns] != 63 || b[3 + 2 * ns] != 0)
        return ERR_CORRUPT;
    int64_t nx, ny;
    if (ns == 1) {
        comp_t *c = &f->comp[sc[0]];
        nx = (f->width * c->h + f->hmax * 8 - 1) / (f->hmax * 8);
        ny = (f->height * c->v + f->vmax * 8 - 1) / (f->vmax * 8);
    } else {
        nx = f->mcux;
        ny = f->mcuy;
    }
    int64_t end = entropy_end(d, dn, *pos);
    if (end < 0)
        return ERR_CORRUPT;
    int64_t nmcu = nx * ny, per = f->restart ? f->restart : nmcu;
    uint8_t *buf = (uint8_t *)malloc((size_t)(end - *pos + 16));
    if (buf == NULL)
        return ERR_NOMEM;
    int64_t start = *pos, m = 0;
    int rc = 0;
    for (int64_t seg = 0; rc == 0 && m < nmcu; ++seg) {
        /* the segment runs to the next RSTn of the interval, or the end */
        int64_t stop = end;
        if (f->restart) {
            uint8_t rst = (uint8_t)(0xD0 + seg % 8);
            for (int64_t i = start; i + 1 < end; ++i)
                if (d[i] == 0xFF && d[i + 1] == rst) {
                    stop = i;
                    break;
                }
        }
        int64_t len = destuff(d + start, stop - start, buf);
        if (len < 0) {
            rc = (int)len;
            break;
        }
        int64_t bp = 0;
        for (int k = 0; k < ns; ++k)
            f->comp[sc[k]].pred = 0;
        for (int64_t i = 0; i < per && m < nmcu && rc == 0; ++i, ++m) {
            int64_t my = m / nx, mx = m % nx;
            for (int k = 0; k < ns && rc == 0; ++k) {
                comp_t *c = &f->comp[sc[k]];
                int hh = ns == 1 ? 1 : c->h, vv = ns == 1 ? 1 : c->v;
                for (int y = 0; y < vv && rc == 0; ++y)
                    for (int x = 0; x < hh && rc == 0; ++x) {
                        int64_t by = my * vv + y, bx = mx * hh + x;
                        rc = decode_block(dct[k], act[k], buf, len * 8,
                                          &bp, &c->pred,
                                          c->coef + (by * c->bw + bx) * 64);
                    }
            }
        }
        if (rc)
            break;
        if (m < nmcu) {
            if (stop == end)
                rc = ERR_CORRUPT;   /* too few restart markers */
            start = stop + 2;
        } else if (stop != end) {
            rc = ERR_CORRUPT;       /* more restart markers than intervals */
        }
    }
    free(buf);
    *pos = end;
    return rc;
}

/* fancy (or, for h2 planes at most 2 wide, box) upsampling of the
 * (dh, dw) plane p (pitch pp) by (fh, fv) into the (H, W) plane out */
static void upsample(const uint8_t *p, int64_t pp, int64_t dh, int64_t dw,
                     int fh, int fv, uint8_t *out, int64_t H, int64_t W)
{
    for (int64_t y = 0; y < H; ++y) {
        uint8_t *o = out + y * W;
        int64_t r = y / fv;
        const uint8_t *near = p + r * pp;
        if (fh == 1 && fv == 1) {
            memcpy(o, near, (size_t)W);
            continue;
        }
        if (fh == 2 && dw <= 2) {
            for (int64_t x = 0; x < W; ++x)
                o[x] = near[x / 2];
            continue;
        }
        if (fv == 1) {
            for (int64_t x = 0; x < W; ++x) {
                int64_t c = x >> 1;
                int v3 = 3 * near[c];
                o[x] = (uint8_t)((x & 1)
                    ? (v3 + near[c + 1 < dw ? c + 1 : c] + 2) >> 2
                    : (v3 + near[c > 0 ? c - 1 : 0] + 1) >> 2);
            }
            continue;
        }
        int lower = y & 1;
        int64_t fr = lower ? (r + 1 < dh ? r + 1 : r) : (r > 0 ? r - 1 : 0);
        const uint8_t *far = p + fr * pp;
        if (fh == 1) {
            int bias = lower ? 2 : 1;
            for (int64_t x = 0; x < W; ++x)
                o[x] = (uint8_t)((3 * near[x] + far[x] + bias) >> 2);
            continue;
        }
        for (int64_t x = 0; x < W; ++x) {
            int64_t c = x >> 1;
            int s = 3 * near[c] + far[c];
            int64_t n2 = (x & 1) ? (c + 1 < dw ? c + 1 : c)
                                 : (c > 0 ? c - 1 : 0);
            int s2 = 3 * near[n2] + far[n2];
            o[x] = (uint8_t)((x & 1) ? (3 * s + s2 + 7) >> 4
                                     : (3 * s + s2 + 8) >> 4);
        }
    }
}

static uint8_t clamp255(int64_t v)
{
    return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

static int output(frame_t *f, uint8_t *dst)
{
    int nc = f->ncomp;
    int64_t H = f->height, W = f->width;
    uint8_t *up[3] = {NULL, NULL, NULL};
    int rc = 0;
    if (nc == 3) {
        if (f->adobe)
            return ERR_ADOBE;
        if (!f->jfif && f->comp[0].id == 82 && f->comp[1].id == 71
                && f->comp[2].id == 66)
            return ERR_RGB_IDS;
    }
    for (int k = 0; k < nc && rc == 0; ++k) {
        comp_t *c = &f->comp[k];
        if (c->tq > 3 || !f->qdef[c->tq]) {
            rc = ERR_CORRUPT;
            break;
        }
        int64_t pw = c->bw * 8;
        uint8_t *plane = (uint8_t *)malloc((size_t)(c->bh * 8 * pw));
        up[k] = nc == 1 ? dst : (uint8_t *)malloc((size_t)(H * W));
        if (plane == NULL || up[k] == NULL) {
            free(plane);
            rc = ERR_NOMEM;
            break;
        }
        for (int64_t by = 0; by < c->bh; ++by)
            for (int64_t bx = 0; bx < c->bw; ++bx)
                idct_islow(c->coef + (by * c->bw + bx) * 64,
                           f->quant[c->tq], plane + by * 8 * pw + bx * 8,
                           pw);
        int64_t dh = (H * c->v + f->vmax - 1) / f->vmax;
        int64_t dw = (W * c->h + f->hmax - 1) / f->hmax;
        upsample(plane, pw, dh, dw, f->hmax / c->h, f->vmax / c->v, up[k],
                 H, W);
        free(plane);
    }
    if (rc == 0 && nc == 3) {
        for (int64_t i = 0; i < H * W; ++i) {
            int64_t y = up[0][i], cb = up[1][i] - 128, cr = up[2][i] - 128;
            dst[3 * i] = clamp255(y + ((91881 * cr + 32768) >> 16));
            dst[3 * i + 1] = clamp255(
                y + ((-22554 * cb + 32768 - 46802 * cr) >> 16));
            dst[3 * i + 2] = clamp255(y + ((116130 * cb + 32768) >> 16));
        }
    }
    if (nc == 3)
        for (int k = 0; k < 3; ++k)
            free(up[k]);
    return rc;
}

static void free_frame(frame_t *f)
{
    for (int k = 0; k < 3; ++k)
        free(f->comp[k].coef);
}

/* Parse (and, with dst, decode) a JPEG stream. info: height, width,
 * components. */
static int64_t run(const uint8_t *d, int64_t n, int64_t *info, uint8_t *dst,
                   int64_t dstsize)
{
    frame_t *f = (frame_t *)calloc(1, sizeof(frame_t));
    if (f == NULL)
        return ERR_NOMEM;
    int64_t rc = 0, pos = 2;
    int scanned = 0;
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8)
        rc = ERR_CORRUPT;
    while (rc == 0) {
        while (pos + 1 < n && d[pos] == 0xFF && d[pos + 1] == 0xFF)
            ++pos;
        if (pos + 2 > n || d[pos] != 0xFF) {
            rc = ERR_CORRUPT;
            break;
        }
        int marker = d[pos + 1];
        pos += 2;
        if (marker == 0xD9)
            break;
        if ((marker >= 0xD0 && marker <= 0xD8) || marker == 0x01)
            continue;
        if (pos + 2 > n) {
            rc = ERR_CORRUPT;
            break;
        }
        int64_t len = d[pos] << 8 | d[pos + 1];
        if (len < 2 || pos + len > n) {
            rc = ERR_CORRUPT;
            break;
        }
        const uint8_t *b = d + pos + 2;
        int64_t bn = len - 2;
        pos += len;
        if (marker >= 0xC0 && marker <= 0xCF && marker != 0xC4
                && marker != 0xC8 && marker != 0xCC) {
            rc = parse_sof(f, marker, b, bn);
            if (rc == 0 && dst == NULL) {
                scanned = 1;
                break;
            }
            if (rc == 0)
                rc = alloc_coef(f);
        } else if (marker == 0xCC) {
            rc = ERR_ARITHMETIC;
        } else if (marker == 0xDB) {
            rc = parse_dqt(f, b, bn);
        } else if (marker == 0xC4) {
            rc = parse_dht(f, b, bn);
        } else if (marker == 0xDD) {
            if (bn != 2)
                rc = ERR_CORRUPT;
            else
                f->restart = b[0] << 8 | b[1];
        } else if (marker == 0xDA) {
            if (!f->ncomp)
                rc = ERR_CORRUPT;
            else
                rc = decode_scan(f, b, bn, d, n, &pos);
            scanned = 1;
        } else if (marker == 0xE0 && bn >= 5 && !memcmp(b, "JFIF", 5)) {
            f->jfif = 1;
        } else if (marker == 0xEE && bn >= 5 && !memcmp(b, "Adobe", 5)) {
            f->adobe = 1;
        } else if (marker == 0xDC) {
            rc = ERR_CORRUPT;
        }
    }
    if (rc == 0 && !scanned)
        rc = ERR_CORRUPT;
    if (rc == 0) {
        info[0] = f->height;
        info[1] = f->width;
        info[2] = f->ncomp;
        if (dst != NULL) {
            if (dstsize < f->height * f->width * f->ncomp)
                rc = ERR_SPACE;
            else
                rc = output(f, dst);
        }
    }
    free_frame(f);
    free(f);
    return rc;
}

/* The height, width and component count of a JPEG stream from its frame
 * header (info[0..2]); 0, or a negative error. */
int64_t jpeg_info(const uint8_t *src, int64_t n, int64_t *info)
{
    if (src == NULL || n < 0 || info == NULL)
        return ERR_ARGS;
    return run(src, n, info, NULL, 0);
}

/* Decode a JPEG stream into dst: (H, W) grey or (H, W, 3) RGB uint8;
 * the bytes written, or a negative error. */
int64_t jpeg_decode(const uint8_t *src, int64_t n, uint8_t *dst,
                    int64_t dstsize)
{
    int64_t info[3];
    if (src == NULL || n < 0 || dst == NULL)
        return ERR_ARGS;
    int64_t rc = run(src, n, info, dst, dstsize);
    return rc < 0 ? rc : info[0] * info[1] * info[2];
}

/* ------------------------------------------------------------ encoder */

typedef struct {
    uint8_t *out, *end;
    uint64_t acc;
    int n;
    int overflow;
} bitw_t;

static void put_byte(bitw_t *w, uint8_t b)
{
    if (w->out < w->end)
        *w->out++ = b;
    else
        w->overflow = 1;
}

/* the whole bytes of the accumulator, each 0xFF followed by a 0x00 */
static void drain_bytes(bitw_t *w)
{
    while (w->n >= 8) {
        uint8_t b = (uint8_t)(w->acc >> (w->n - 8));
        if (w->out + 2 <= w->end) {
            *w->out++ = b;
            if (b == 0xFF)
                *w->out++ = 0;
        } else {
            put_byte(w, b);
            if (b == 0xFF)
                put_byte(w, 0);
        }
        w->n -= 8;
    }
}

/* len <= 27 bits of code; bytes leave the accumulator 32 bits at a time */
static inline void put_bits(bitw_t *w, uint32_t code, int len)
{
    w->acc = (w->acc << len) | code;
    w->n += len;
    if (w->n >= 32)
        drain_bytes(w);
}

static void flush_bits(bitw_t *w)
{
    drain_bytes(w);
    if (w->n > 0)
        put_bits(w, (1u << (8 - w->n)) - 1, 8 - w->n);
    drain_bytes(w);
}

typedef struct {
    uint32_t code[256];
    uint8_t len[256];
} ehuff;

static void build_ehuff(ehuff *t, const uint8_t *bits, const uint8_t *vals)
{
    uint32_t code = 0;
    int k = 0;
    memset(t, 0, sizeof(*t));
    for (int len = 1; len <= 16; ++len) {
        for (int i = 0; i < bits[len - 1]; ++i, ++k) {
            t->code[vals[k]] = code++;
            t->len[vals[k]] = (uint8_t)len;
        }
        code <<= 1;
    }
}

static int nbits(int32_t v)
{
    uint32_t a = (uint32_t)(v < 0 ? -v : v);
    return a ? 32 - __builtin_clz(a) : 0;
}

/* the 4 whole bytes at the top of the n bits in acc, each 0xFF followed
 * by a 0x00 (8 bytes at most; none past end, which flags overflow) */
static inline uint8_t *drain32(uint8_t *out, const uint8_t *end,
                               uint64_t acc, int n, int *overflow)
{
    if (end - out < 8) {
        *overflow = 1;
        return out;
    }
    for (int i = 1; i <= 4; ++i) {
        uint8_t b = (uint8_t)(acc >> (n - 8 * i));
        *out++ = b;
        if (b == 0xFF)
            *out++ = 0;
    }
    return out;
}

/* one block's DC difference and AC terms; the bit writer's state is kept
 * in locals (stores through out may alias any memory) */
static int encode_block(bitw_t *w, const ehuff *dc, const ehuff *ac,
                        const int16_t *blk, int32_t *pred)
{
    uint64_t acc = w->acc;
    int n = w->n, rc = 0;
    uint8_t *out = w->out;
#define PUT(code, len)                                                  \
    do {                                                                \
        acc = (acc << (len)) | (code);                                  \
        n += (len);                                                     \
        if (n >= 32) {                                                  \
            out = drain32(out, w->end, acc, n, &w->overflow);           \
            n -= 32;                                                    \
        }                                                               \
    } while (0)
    int32_t diff = blk[0] - *pred;
    *pred = blk[0];
    int s = nbits(diff);
    if (s > 11)
        return ERR_COEF_RANGE;
    PUT(dc->code[s], dc->len[s]);
    if (s)
        PUT((uint32_t)(diff < 0 ? diff + (1 << s) - 1 : diff)
            & ((1u << s) - 1), s);
    /* the AC terms in zigzag order, and a bit for each nonzero one */
    int16_t zz[64];
    uint64_t nonzero = 0;
    for (int k = 1; k < 64; ++k) {
        zz[k] = blk[ZIGZAG[k]];
        nonzero |= (uint64_t)(zz[k] != 0) << k;
    }
    int last = 0;
    while (nonzero) {
        int k = __builtin_ctzll(nonzero);
        nonzero &= nonzero - 1;
        int32_t v = zz[k];
        int run = k - last - 1;
        last = k;
        for (; run >= 16; run -= 16)
            PUT(ac->code[0xF0], ac->len[0xF0]);
        s = nbits(v);
        if (s > 10) {
            rc = ERR_COEF_RANGE;
            break;
        }
        int sym = run << 4 | s;
        PUT(ac->code[sym], ac->len[sym]);
        PUT((uint32_t)(v < 0 ? v + (1 << s) - 1 : v) & ((1u << s) - 1), s);
    }
    if (rc == 0 && last < 63)
        PUT(ac->code[0], ac->len[0]);
#undef PUT
    w->acc = acc;
    w->n = n;
    w->out = out;
    return rc;
}

static void put_marker(bitw_t *w, int marker, int64_t len)
{
    put_byte(w, 0xFF);
    put_byte(w, (uint8_t)marker);
    put_byte(w, (uint8_t)((len + 2) >> 8));
    put_byte(w, (uint8_t)(len + 2));
}

static void put_headers(bitw_t *w, int64_t H, int64_t W, int nc,
                        const int *hs, const int *vs,
                        uint16_t quant[2][64], int restart)
{
    static const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0,
                                     0, 1, 0, 1, 0, 0};
    put_byte(w, 0xFF);
    put_byte(w, 0xD8);
    put_marker(w, 0xE0, 14);
    for (int i = 0; i < 14; ++i)
        put_byte(w, jfif[i]);
    int nt = nc > 1 ? 2 : 1;
    for (int t = 0; t < nt; ++t) {
        put_marker(w, 0xDB, 65);
        put_byte(w, (uint8_t)t);
        for (int k = 0; k < 64; ++k)
            put_byte(w, (uint8_t)quant[t][ZIGZAG[k]]);
    }
    put_marker(w, 0xC0, 6 + 3 * nc);
    put_byte(w, 8);
    put_byte(w, (uint8_t)(H >> 8));
    put_byte(w, (uint8_t)H);
    put_byte(w, (uint8_t)(W >> 8));
    put_byte(w, (uint8_t)W);
    put_byte(w, (uint8_t)nc);
    for (int k = 0; k < nc; ++k) {
        put_byte(w, (uint8_t)(k + 1));
        put_byte(w, (uint8_t)(hs[k] << 4 | vs[k]));
        put_byte(w, (uint8_t)(k ? 1 : 0));
    }
    for (int t = 0; t < nt; ++t) {
        put_marker(w, 0xC4, 29);
        put_byte(w, (uint8_t)t);
        for (int i = 0; i < 16; ++i)
            put_byte(w, DC_BITS[t][i]);
        for (int i = 0; i < 12; ++i)
            put_byte(w, DC_VALS[i]);
        put_marker(w, 0xC4, 179);
        put_byte(w, (uint8_t)(0x10 | t));
        for (int i = 0; i < 16; ++i)
            put_byte(w, AC_BITS[t][i]);
        for (int i = 0; i < 162; ++i)
            put_byte(w, AC_VALS[t][i]);
    }
    if (restart) {
        put_marker(w, 0xDD, 2);
        put_byte(w, (uint8_t)(restart >> 8));
        put_byte(w, (uint8_t)restart);
    }
    put_marker(w, 0xDA, 1 + 2 * nc + 3);
    put_byte(w, (uint8_t)nc);
    for (int k = 0; k < nc; ++k) {
        put_byte(w, (uint8_t)(k + 1));
        put_byte(w, (uint8_t)(k ? 0x11 : 0));
    }
    put_byte(w, 0);
    put_byte(w, 63);
    put_byte(w, 0);
}

/* one component's blocks of data: the ext plane (eh, ew, replicated past
 * the image) downsampled by (fh, fv) into a (rows_b * 8, cols_b * 8)
 * plane, the rows under the last downsampled one copying it */
static void component_plane(const uint8_t *ext, int64_t eh, int64_t ew,
                            int fh, int fv, int64_t rows_b, int64_t cols_b,
                            uint8_t *out)
{
    int64_t ow = cols_b * 8, dsh = eh / fv;
    for (int64_t y = 0; y < rows_b * 8; ++y) {
        int64_t r = y < dsh ? y : dsh - 1;
        const uint8_t *a = ext + r * fv * ew;
        const uint8_t *b = fv == 2 ? a + ew : a;
        uint8_t *o = out + y * ow;
        if (fh == 1 && fv == 1) {
            memcpy(o, a, (size_t)ow);
            continue;
        }
        for (int64_t x = 0; x < ow; ++x) {
            if (fh == 2 && fv == 2)
                o[x] = (uint8_t)((a[2 * x] + a[2 * x + 1] + b[2 * x]
                                  + b[2 * x + 1] + 1 + (x & 1)) >> 2);
            else if (fh == 2)
                o[x] = (uint8_t)((a[2 * x] + a[2 * x + 1] + (x & 1)) >> 1);
            else
                o[x] = (uint8_t)((a[x] + b[x] + 1) / 2);
        }
    }
}

/* Encode (H, W) grey (nc 1) or (H, W, 3) RGB uint8 pixels as a JPEG
 * stream into dst (cap bytes), luma sampling (hs, vs) for RGB, a restart
 * interval of `restart` MCUs (0: none); the stream's size, or a negative
 * error (ERR_SPACE when it does not fit). */
int64_t jpeg_encode(const uint8_t *pix, int64_t H, int64_t W, int nc,
                    int quality, int hs0, int vs0, int restart,
                    uint8_t *dst, int64_t cap)
{
    if (pix == NULL || dst == NULL || H < 1 || W < 1 || H > 65535
            || W > 65535 || (nc != 1 && nc != 3) || restart < 0
            || restart > 65535 || (nc == 3 && (hs0 < 1 || hs0 > 2
                                               || vs0 < 1 || vs0 > 2)))
        return ERR_ARGS;
    int hs[3] = {nc == 3 ? hs0 : 1, 1, 1}, vs[3] = {nc == 3 ? vs0 : 1, 1, 1};
    int hmax = hs[0], vmax = vs[0];
    int64_t mcux = (W + 8 * hmax - 1) / (8 * hmax);
    int64_t mcuy = (H + 8 * vmax - 1) / (8 * vmax);
    int64_t eh = (H + vmax - 1) / vmax * vmax, ew = mcux * 8 * hmax;
    uint16_t quant[2][64];
    int64_t recip[2][64], corr[2][64];
    int shift[2][64];
    for (int t = 0; t < 2; ++t) {
        quant_table(quality, t, quant[t]);
        for (int k = 0; k < 64; ++k)
            reciprocal((int64_t)quant[t][k] << 3, &recip[t][k], &corr[t][k],
                       &shift[t][k]);
    }
    /* the image in Y (Cb, Cr) planes, replicated to (eh, ew) */
    uint8_t *ext = (uint8_t *)malloc((size_t)(eh * ew * nc));
    int16_t *grid[3] = {NULL, NULL, NULL};
    uint8_t *plane = (uint8_t *)malloc((size_t)(mcuy * vmax * 8 * ew));
    int64_t rc = 0, gw[3], gh[3], rows_b[3], cols_b[3];
    if (ext == NULL || plane == NULL)
        rc = ERR_NOMEM;
    for (int64_t y = 0; rc == 0 && y < eh; ++y) {
        const uint8_t *src = pix + (y < H ? y : H - 1) * W * nc;
        if (nc == 1) {
            memcpy(ext + y * ew, src, (size_t)W);
            memset(ext + y * ew + W, src[W - 1], (size_t)(ew - W));
            continue;
        }
        for (int64_t x = 0; x < ew; ++x) {
            const uint8_t *p = src + (x < W ? x : W - 1) * nc;
            int64_t r = p[0], g = p[1], b = p[2];
            ext[y * ew + x] = (uint8_t)((19595 * r + 38470 * g + 7471 * b
                                         + 32768) >> 16);
            ext[eh * ew + y * ew + x] = (uint8_t)(
                (-11059 * r - 21709 * g + 32768 * b + (128 << 16) + 32767)
                >> 16);
            ext[2 * eh * ew + y * ew + x] = (uint8_t)(
                (32768 * r - 27439 * g - 5329 * b + (128 << 16) + 32767)
                >> 16);
        }
    }
    /* quantised blocks of each component on its MCU-padded grid */
    for (int k = 0; rc == 0 && k < nc; ++k) {
        gw[k] = mcux * hs[k];
        gh[k] = mcuy * vs[k];
        cols_b[k] = (W * hs[k] + hmax * 8 - 1) / (hmax * 8);
        rows_b[k] = (H * vs[k] + vmax * 8 - 1) / (vmax * 8);
        grid[k] = (int16_t *)calloc((size_t)(gw[k] * gh[k] * 64),
                                    sizeof(int16_t));
        if (grid[k] == NULL) {
            rc = ERR_NOMEM;
            break;
        }
        component_plane(ext + k * eh * ew, eh, ew, hmax / hs[k],
                        vmax / vs[k], rows_b[k], cols_b[k], plane);
        int t = k ? 1 : 0;
        int64_t pw = cols_b[k] * 8;
        for (int64_t by = 0; by < rows_b[k]; ++by)
            for (int64_t bx = 0; bx < cols_b[k]; ++bx)
                fdct_quantize(plane + by * 8 * pw + bx * 8, pw, recip[t],
                              corr[t], shift[t],
                              grid[k] + (by * gw[k] + bx) * 64);
        int16_t *g = grid[k];
        if (nc > 1) {
            for (int64_t by = 0; by < rows_b[k]; ++by)
                for (int64_t bx = cols_b[k]; bx < gw[k]; ++bx)
                    g[(by * gw[k] + bx) * 64] = g[(by * gw[k] + bx - 1) * 64];
            for (int64_t by = rows_b[k]; by < gh[k]; ++by)
                for (int64_t bx = 0; bx < gw[k]; ++bx)
                    g[(by * gw[k] + bx) * 64] = g[((by - 1) * gw[k]
                        + bx / hs[k] * hs[k] + hs[k] - 1) * 64];
        }
    }
    free(ext);
    free(plane);
    if (rc == 0) {
        ehuff *tabs = (ehuff *)malloc(4 * sizeof(ehuff));
        if (tabs == NULL) {
            rc = ERR_NOMEM;
        } else {
            for (int t = 0; t < 2; ++t) {
                build_ehuff(&tabs[2 * t], DC_BITS[t], DC_VALS);
                build_ehuff(&tabs[2 * t + 1], AC_BITS[t], AC_VALS[t]);
            }
            bitw_t w = {dst, dst + cap, 0, 0, 0};
            put_headers(&w, H, W, nc, hs, vs, quant, restart);
            int64_t nx = nc == 1 ? cols_b[0] : mcux;
            int64_t ny = nc == 1 ? rows_b[0] : mcuy;
            int64_t nmcu = nx * ny;
            int32_t pred[3] = {0, 0, 0};
            for (int64_t m = 0; rc == 0 && m < nmcu; ++m) {
                if (restart && m > 0 && m % restart == 0) {
                    flush_bits(&w);
                    put_byte(&w, 0xFF);
                    put_byte(&w, (uint8_t)(0xD0 + (m / restart - 1) % 8));
                    pred[0] = pred[1] = pred[2] = 0;
                }
                int64_t my = m / nx, mx = m % nx;
                for (int k = 0; rc == 0 && k < nc; ++k) {
                    int t = k ? 1 : 0;
                    for (int y = 0; rc == 0 && y < vs[k]; ++y)
                        for (int x = 0; rc == 0 && x < hs[k]; ++x) {
                            int64_t by = my * vs[k] + y;
                            int64_t bx = mx * hs[k] + x;
                            rc = encode_block(&w, &tabs[2 * t],
                                              &tabs[2 * t + 1],
                                              grid[k] + (by * gw[k] + bx)
                                              * 64, &pred[k]);
                        }
                }
            }
            flush_bits(&w);
            put_byte(&w, 0xFF);
            put_byte(&w, 0xD9);
            free(tabs);
            if (rc == 0)
                rc = w.overflow ? ERR_SPACE : w.out - dst;
        }
    }
    for (int k = 0; k < 3; ++k)
        free(grid[k]);
    return rc;
}
