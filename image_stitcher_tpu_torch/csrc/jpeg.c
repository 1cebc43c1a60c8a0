/* JPEG written by hand: the decoder of .jpg tiles (baseline, extended
 * and progressive frames, Huffman or arithmetic-coded, with libjpeg-
 * turbo's block smoothing; lossless frames of 2..8 bits; 1, 3 or 4
 * components; any integral sampling; YCbCr, RGB, CMYK and YCCK) and the
 * baseline encoder of JPEG OME-TIFF tiles.
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
 * upsampling and colour conversion are a few operations a sample. A
 * progressive frame's scans refine the whole frame's coefficients,
 * which are kept until its last scan.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define ERR_ARGS -1
#define ERR_CORRUPT -2
#define ERR_NOMEM -4
#define ERR_SPACE -5
/* streams OpenCV and Pillow give no pixels for (io/jpeg.py names each) */
#define ERR_HIERARCHICAL -11
#define ERR_LOSSLESS_ARITH -12
#define ERR_PRECISION -13      /* DCT frames not of 8 bits, lossless over 8 */
#define ERR_TWO_COMPONENTS -14
#define ERR_LOSSLESS_YCC -15   /* lossless YCbCr or YCCK */
#define ERR_COEF_RANGE -19

/* output modes (jpeg_decode) */
#define MODE_CV2 0      /* cv2.imread's: the colour space by the markers */
#define MODE_RAW 1      /* the components as they are (JCS_UNKNOWN) */
#define MODE_YCC 2      /* 3 components YCbCr -> RGB whatever the markers */

#define MAX_COMPS 4
#define MAX_BLOCKS_IN_MCU 10   /* jdhuff.c's limit for interleaved scans */
#define SMOOTHING_COEFS 10     /* jdcoefct.c's SAVED_COEFS */
#define FIXED_BIN 113          /* jdarith.c's fixed 0.5 estimate */

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

/* libjpeg-turbo's block smoothing (jdcoefct.c::decompress_smooth_data):
 * the weights of the 5x5 neighbours' DCs (rows r - 2..r + 2, columns
 * c - 2..c + 2) in the estimate of zigzag coefficients 1..9 when no AC
 * has been sent, of 1..5 otherwise, and of the DC when no AC has been
 * sent */
static const int16_t SMOOTH_CHANGE_DC[9][25] = {
    {-1, -1, 0, 1, 1, -3, 13, 0, -13, 3, -3, 38, 0, -38, 3, -3, 13, 0, -13, 3,
     -1, -1, 0, 1, 1},
    {-1, -3, -3, -3, -1, -1, 13, 38, 13, -1, 0, 0, 0, 0, 0, 1, -13, -38, -13,
     1, 1, 3, 3, 3, 1},
    {0, 0, 1, 0, 0, 0, 2, 7, 2, 0, 0, -5, -14, -5, 0, 0, 2, 7, 2, 0, 0, 0, 1,
     0, 0},
    {-1, 0, 0, 0, 1, 0, 9, 0, -9, 0, 0, 0, 0, 0, 0, 0, -9, 0, 9, 0, 1, 0, 0,
     0, -1},
    {0, 0, 0, 0, 0, 0, 2, -5, 2, 0, 1, 7, -14, 7, 1, 0, 2, -5, 2, 0, 0, 0, 0,
     0, 0},
    {0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, 2, 0, -2, 0, 0, 1, 0, -1, 0, 0, 0, 0,
     0, 0},
    {0, 0, 0, 0, 0, 0, 1, -3, 1, 0, 0, 0, 0, 0, 0, 0, -1, 3, -1, 0, 0, 0, 0,
     0, 0},
    {0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, -3, 0, 3, 0, 0, 1, 0, -1, 0, 0, 0, 0,
     0, 0},
    {0, 0, 0, 0, 0, 0, 1, 2, 1, 0, 0, 0, 0, 0, 0, 0, -1, -2, -1, 0, 0, 0, 0,
     0, 0},
};
static const int16_t SMOOTH_AC[5][25] = {
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -7, 50, 0, -50, 7, 0, 0, 0, 0, 0, 0, 0, 0,
     0, 0},
    {0, 0, -7, 0, 0, 0, 0, 50, 0, 0, 0, 0, 0, 0, 0, 0, 0, -50, 0, 0, 0, 0, 7,
     0, 0},
    {0, 0, -1, 0, 0, 0, 0, 13, 0, 0, 0, 0, -24, 0, 0, 0, 0, 13, 0, 0, 0, 0,
     -1, 0, 0},
    {0, -1, 0, 1, 0, -1, 10, 0, -10, 1, 0, 0, 0, 0, 0, 1, -10, 0, 10, -1, 0,
     1, 0, -1, 0},
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -1, 13, -24, 13, -1, 0, 0, 0, 0, 0, 0, 0,
     0, 0, 0},
};
static const int16_t SMOOTH_DC[25] = {
    -2, -6, -8, -6, -2, -6, 6, 42, 6, -6, -8, 42, 152, 42, -8, -6, 6, 42, 6,
     -6, -2, -6, -8, -6, -2};
/* T.81 Table D.2 as jaricom.c packs it: Qe << 16 | next index after an
 * MPS << 8 | MPS switch << 7 | next index after an LPS; entry 113 is the
 * fixed estimate */
static const uint32_t ARITAB[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617,
    0x00e50719, 0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39,
    0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b,
    0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669,
    0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171,
};

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

/* the next n (0..16) bits at *pos, as an unsigned number */
static inline int32_t get_bits(const uint8_t *buf, int64_t *pos, int n)
{
    if (n == 0)
        return 0;
    int32_t v = (int32_t)(peek(buf, *pos) >> (64 - n));
    *pos += n;
    return v;
}

/* ------------------------------------------------------------ decoder */

typedef struct {
    int id, h, v, tq;
    int64_t bw, bh;        /* blocks (lossless: samples) of the MCU grid */
    int16_t *coef;         /* bh * bw * 64, natural order; lossless: the
                            * bh * bw differences, then samples */
    uint8_t *samples;      /* lossless: the undifferenced 8-bit samples */
    int32_t pred;
    int ctx;               /* arithmetic DC conditioning context */
} comp_t;

typedef struct {
    uint16_t quant[4][64];
    int qdef[4];
    htable dc[4], ac[4];
    int restart, jfif, ncomp, progressive;
    int lossless, arith, precision;
    int dc_max[4];         /* the largest symbol of each DC table */
    /* arithmetic conditioning by table: DC L and U, AC Kx (DAC) */
    uint8_t dac_l[16], dac_u[16], dac_k[16];
    int adobe;             /* the APP14 transform flag; -1: no APP14 */
    int64_t height, width;
    int hmax, vmax;
    int64_t mcux, mcuy;
    comp_t comp[MAX_COMPS];
    /* per component and zigzag index: the successive-approximation bit
     * last coded, -1 before any scan (cinfo->coef_bits) */
    int coef_bits[MAX_COMPS][64];
} frame_t;

static int parse_sof(frame_t *f, int marker, const uint8_t *b, int64_t n)
{
    if (marker == 0xC5 || marker == 0xC6 || marker == 0xC7 || marker == 0xCD
            || marker == 0xCE || marker == 0xCF)
        return ERR_HIERARCHICAL;
    if (marker == 0xCB)
        return ERR_LOSSLESS_ARITH;
    if (f->ncomp)
        return ERR_CORRUPT;
    if (n < 6)
        return ERR_CORRUPT;
    f->lossless = marker == 0xC3;
    f->arith = marker == 0xC9 || marker == 0xCA;
    f->progressive = marker == 0xC2 || marker == 0xCA;
    f->precision = b[0];
    if (f->lossless && (b[0] < 2 || b[0] > 16))
        return ERR_CORRUPT;
    if (f->lossless ? b[0] > 8 : b[0] != 8)
        return ERR_PRECISION;
    f->height = b[1] << 8 | b[2];
    f->width = b[3] << 8 | b[4];
    int nc = b[5];
    if (nc == 2)
        return ERR_TWO_COMPONENTS;
    if (nc != 1 && nc != 3 && nc != 4)
        return ERR_CORRUPT;
    if (f->height == 0 || f->width == 0 || n < 6 + 3 * nc)
        return ERR_CORRUPT;
    f->hmax = f->vmax = 1;
    for (int k = 0; k < nc; ++k) {
        comp_t *c = &f->comp[k];
        c->id = b[6 + 3 * k];
        c->h = b[7 + 3 * k] >> 4;
        c->v = b[7 + 3 * k] & 15;
        c->tq = b[8 + 3 * k];
        if (c->h < 1 || c->h > 4 || c->v < 1 || c->v > 4)
            return ERR_CORRUPT;
        f->hmax = c->h > f->hmax ? c->h : f->hmax;
        f->vmax = c->v > f->vmax ? c->v : f->vmax;
    }
    /* jdsample.c: fractional sampling is not implemented (cv2 reads
     * nothing) */
    for (int k = 0; k < nc; ++k)
        if (f->hmax % f->comp[k].h || f->vmax % f->comp[k].v)
            return ERR_CORRUPT;
    f->ncomp = nc;
    const int size = f->lossless ? 1 : 8;
    f->mcux = (f->width + size * f->hmax - 1) / (size * f->hmax);
    f->mcuy = (f->height + size * f->vmax - 1) / (size * f->vmax);
    for (int k = 0; k < nc; ++k) {
        f->comp[k].bw = f->mcux * f->comp[k].h;
        f->comp[k].bh = f->mcuy * f->comp[k].v;
        for (int i = 0; i < 64; ++i)
            f->coef_bits[k][i] = -1;
    }
    return 0;
}

static int alloc_coef(frame_t *f)
{
    for (int k = 0; k < f->ncomp; ++k) {
        comp_t *c = &f->comp[k];
        c->coef = (int16_t *)calloc((size_t)(c->bw * c->bh
                                             * (f->lossless ? 1 : 64)),
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
            if (b[k + 17 + i] > 16)
                return ERR_CORRUPT;     /* a DC category over 16 */
        if (!tc) {
            /* 16 is a lossless difference of 32768 only: checked when a
             * scan takes the table */
            f->dc_max[th] = 0;
            for (int i = 0; i < count; ++i)
                if (b[k + 17 + i] > f->dc_max[th])
                    f->dc_max[th] = b[k + 17 + i];
        }
        int rc = build_htable(tc ? &f->ac[th] : &f->dc[th], b + k + 1,
                              b + k + 17, count);
        if (rc)
            return rc;
        k += 17 + count;
    }
    return 0;
}

/* DAC (jdmarker.c's get_dac): per table, DC conditioning L and U (U >=
 * L) or the AC one Kx */
static int parse_dac(frame_t *f, const uint8_t *b, int64_t n)
{
    if (n % 2)
        return ERR_CORRUPT;
    for (int64_t k = 0; k < n; k += 2) {
        int index = b[k], val = b[k + 1];
        if (index >= 32)
            return ERR_CORRUPT;
        if (index >= 16) {
            f->dac_k[index - 16] = (uint8_t)val;
        } else {
            if ((val & 15) > val >> 4)
                return ERR_CORRUPT;
            f->dac_l[index] = (uint8_t)(val & 15);
            f->dac_u[index] = (uint8_t)(val >> 4);
        }
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

#define PAD_BYTES 16

/* copy one segment's entropy-coded bytes into buf without the stuffed
 * zeros, PAD_BYTES zero bytes after them; their count, or ERR_CORRUPT
 * for a marker inside */
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
    memset(buf + o, 0, PAD_BYTES);
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

/* Progressive scans (jdphuff.c). Every read is checked against limit
 * as it is made, so a corrupt segment never reads past its padding. */

/* a DC first scan's block: the difference, the prediction shifted by al */
static int decode_dc_first(const htable *dct, const uint8_t *buf,
                           int64_t limit, int64_t *pos, int32_t *pred,
                           int al, int16_t *out)
{
    uint64_t w;
    int s = huff_decode(dct, buf, pos, &w);
    if (s < 0)
        return ERR_CORRUPT;
    if (s) {
        *pred += extend(w, s);
        *pos += s;
    }
    out[0] = (int16_t)(int32_t)((uint32_t)*pred << al);
    return *pos > limit ? ERR_CORRUPT : 0;
}

/* a DC refinement scan's block: one bit */
static int decode_dc_refine(const uint8_t *buf, int64_t limit,
                            int64_t *pos, int al, int16_t *out)
{
    if (get_bits(buf, pos, 1))
        out[0] = (int16_t)(out[0] | (1 << al));
    return *pos > limit ? ERR_CORRUPT : 0;
}

/* an AC first scan's block: band [ss, se], coefficients shifted by al;
 * *eobrun counts the blocks an end-of-band run still covers */
static int decode_ac_first(const htable *act, const uint8_t *buf,
                           int64_t limit, int64_t *pos, int ss, int se,
                           int al, int32_t *eobrun, int16_t *out)
{
    if (*eobrun > 0) {
        --*eobrun;
        return 0;
    }
    uint64_t w;
    for (int k = ss; k <= se; ++k) {
        int e = huff_decode(act, buf, pos, &w);
        if (e < 0)
            return ERR_CORRUPT;
        int r = e >> 4, s = e & 15;
        if (s) {
            k += r;
            if (k > 63)
                return ERR_CORRUPT;
            out[ZIGZAG[k]] = (int16_t)(int32_t)((uint32_t)extend(w, s) << al);
            *pos += s;
        } else if (r == 15) {
            k += 15;
        } else {
            *eobrun = (1 << r) + get_bits(buf, pos, r) - 1;
            break;
        }
        if (*pos > limit)
            return ERR_CORRUPT;
    }
    return *pos > limit ? ERR_CORRUPT : 0;
}

/* one correction bit for the nonzero coefficient *c at bit al */
static inline void correct(const uint8_t *buf, int64_t *pos, int16_t *c,
                           int al)
{
    int p1 = 1 << al;
    if (get_bits(buf, pos, 1) && (*c & p1) == 0)
        *c = (int16_t)(*c >= 0 ? *c + p1 : *c - p1);
}

/* an AC refinement scan's block (decode_mcu_AC_refine): the correction
 * bits of band [ss, se]'s nonzero coefficients, and its newly nonzero
 * ones (+-1 << al) */
static int decode_ac_refine(const htable *act, const uint8_t *buf,
                            int64_t limit, int64_t *pos, int ss, int se,
                            int al, int32_t *eobrun, int16_t *out)
{
    int k = ss;
    uint64_t w;
    if (*eobrun == 0) {
        for (; k <= se; ++k) {
            int e = huff_decode(act, buf, pos, &w);
            if (e < 0)
                return ERR_CORRUPT;
            int r = e >> 4, s = e & 15;
            if (s) {
                s = get_bits(buf, pos, 1) ? 1 : -1;
            } else if (r != 15) {
                *eobrun = (1 << r) + get_bits(buf, pos, r);
                break;
            }
            for (; k <= se; ++k) {
                int16_t *c = out + ZIGZAG[k];
                if (*c != 0)
                    correct(buf, pos, c, al);
                else if (--r < 0)
                    break;
                if (*pos > limit)
                    return ERR_CORRUPT;
            }
            if (s) {
                if (k > 63)
                    return ERR_CORRUPT;
                out[ZIGZAG[k]] = (int16_t)(s * (1 << al));
            }
            if (*pos > limit)
                return ERR_CORRUPT;
        }
    }
    if (*eobrun > 0) {
        for (; k <= se; ++k) {
            int16_t *c = out + ZIGZAG[k];
            if (*c != 0)
                correct(buf, pos, c, al);
            if (*pos > limit)
                return ERR_CORRUPT;
        }
        --*eobrun;
    }
    return *pos > limit ? ERR_CORRUPT : 0;
}

/* Arithmetic-coded scans (jdarith.c): T.81 Annex D's QM decoder, with
 * the statistical models of F.1.4 (sequential) and G.1.3 (progressive). */

typedef struct {
    const uint8_t *data;   /* the segment's bytes, destuffed */
    int64_t n, pos;
    int64_t c, a;
    int ct;
} arith_t;

/* an arithmetic segment's data bytes as jdarith.c's get_byte reads them:
 * 0xFF 0x00 is 0xFF, further 0xFF fill bytes are swallowed, and the data
 * ends at a marker (zeros are fed from there on); their count */
static int64_t arith_destuff(const uint8_t *s, int64_t n, uint8_t *buf)
{
    int64_t o = 0, i = 0;
    while (i < n) {
        uint8_t b = s[i++];
        if (b == 0xFF) {
            while (i < n && s[i] == 0xFF)
                ++i;
            if (i >= n || s[i] != 0)
                break;
            ++i;
        }
        buf[o++] = b;
    }
    return o;
}

static void arith_init(arith_t *e, const uint8_t *data, int64_t n)
{
    e->data = data;
    e->n = n;
    e->pos = 0;
    e->c = e->a = 0;
    e->ct = -16;        /* read 2 bytes before the first decision */
}

/* one binary decision with the statistics bin *st (jdarith.c's
 * arith_decode: D.2.4-D.2.6) */
static int arith_decode(arith_t *e, uint8_t *st)
{
    while (e->a < 0x8000) {
        if (--e->ct < 0) {
            int data = e->pos < e->n ? e->data[e->pos++] : 0;
            e->c = (e->c << 8) | data;
            if ((e->ct += 8) < 0 && ++e->ct == 0)
                e->a = 0x8000;
        }
        e->a <<= 1;
    }
    int sv = *st;
    uint32_t q = ARITAB[sv & 0x7F];
    int nl = q & 0xFF, nm = (q >> 8) & 0xFF;
    int64_t qe = q >> 16;
    int64_t temp = e->a - qe;
    e->a = temp;
    temp <<= e->ct;
    if (e->c >= temp) {
        e->c -= temp;
        if (e->a < qe) {
            e->a = qe;
            *st = (uint8_t)((sv & 0x80) ^ nm);
        } else {
            e->a = qe;
            *st = (uint8_t)((sv & 0x80) ^ nl);
            sv ^= 0x80;
        }
    } else if (e->a < 0x8000) {
        if (e->a < qe) {
            *st = (uint8_t)((sv & 0x80) ^ nl);
            sv ^= 0x80;
        } else {
            *st = (uint8_t)((sv & 0x80) ^ nm);
        }
    }
    return sv >> 7;
}

/* the bits below the top one of a magnitude category m (Figure F.24)
 * from the M bins at st; |v| - 1 */
static int32_t arith_bits(arith_t *e, uint8_t *st, int32_t m)
{
    int32_t v = m;
    while (m >>= 1)
        if (arith_decode(e, st))
            v |= m;
    return v;
}

/* a DC difference (Figure F.19) with the DC statistics st in the
 * component's conditioning context, which it updates (F.1.4.4.1.2);
 * ERR_CORRUPT on a magnitude overflow */
static int arith_dc(arith_t *e, uint8_t *st, comp_t *c, int lo, int hi,
                    int32_t *diff)
{
    uint8_t *s0 = st + c->ctx;
    *diff = 0;
    if (!arith_decode(e, s0)) {
        c->ctx = 0;
        return 0;
    }
    int sign = arith_decode(e, s0 + 1);
    uint8_t *p = s0 + 2 + sign;
    int32_t m = arith_decode(e, p);
    if (m) {
        p = st + 20;
        while (arith_decode(e, p)) {
            if ((m <<= 1) == 0x8000)
                return ERR_CORRUPT;
            ++p;
        }
    }
    if (m < (1 << lo) >> 1)
        c->ctx = 0;
    else if (m > (1 << hi) >> 1)
        c->ctx = 12 + sign * 4;
    else
        c->ctx = 4 + sign * 4;
    int32_t v = arith_bits(e, p + 14, m) + 1;
    *diff = sign ? -v : v;
    return 0;
}

/* the ACs start..end of a block, each shifted left by al (Figure F.20;
 * decode_mcu and decode_mcu_AC_first) */
static int arith_ac(arith_t *e, uint8_t *st, uint8_t *fixed, int start,
                    int end, int kx, int al, int16_t *out)
{
    int k = start - 1;
    while (k < end) {
        uint8_t *p = st + 3 * k;
        if (arith_decode(e, p))
            break;
        for (;;) {
            ++k;
            if (arith_decode(e, p + 1))
                break;
            p += 3;
            if (k >= end)
                return ERR_CORRUPT;
        }
        int sign = arith_decode(e, fixed);
        p += 2;
        int32_t m = arith_decode(e, p);
        if (m && arith_decode(e, p)) {
            m <<= 1;
            p = st + (k <= kx ? 189 : 217);
            while (arith_decode(e, p)) {
                if ((m <<= 1) == 0x8000)
                    return ERR_CORRUPT;
                ++p;
            }
        }
        int32_t v = arith_bits(e, p + 14, m) + 1;
        out[ZIGZAG[k]] = (int16_t)(int32_t)((uint32_t)(sign ? -v : v) << al);
    }
    return 0;
}

/* decode_mcu_AC_refine: correction bits of the band's nonzero
 * coefficients, newly nonzero ones of +-1 << al */
static int arith_ac_refine(arith_t *e, uint8_t *st, uint8_t *fixed, int ss,
                           int se, int al, int16_t *out)
{
    const int p1 = 1 << al, m1 = -(1 << al);
    int kex = se;
    while (kex > 0 && out[ZIGZAG[kex]] == 0)
        --kex;
    for (int k = ss - 1; k < se;) {
        uint8_t *p = st + 3 * k;
        if (k >= kex && arith_decode(e, p))
            break;
        for (;;) {
            int16_t *c = out + ZIGZAG[++k];
            if (*c) {
                if (arith_decode(e, p + 2))
                    *c = (int16_t)(*c + (*c < 0 ? m1 : p1));
                break;
            }
            if (arith_decode(e, p + 1)) {
                *c = (int16_t)(arith_decode(e, fixed) ? m1 : p1);
                break;
            }
            p += 3;
            if (k >= se)
                return ERR_CORRUPT;
        }
    }
    return 0;
}

/* Lossless frames (jdlossls.c, jddiffct.c, jdpred.c). */

/* a component's samples from its decoded differences: predictor psv on
 * Ra (left), Rb (above), Rc (above-left), mod 2^16; first rows 1-D from
 * 2^(P - Pt - 1), other rows' first sample from Rb; the first rows are
 * the image's and that of each iMCU row (v rows) in which a restart
 * interval starts (libjpeg-turbo undifferences an iMCU row once it is
 * decoded whole); then shifted left by Pt into 8-bit samples */
static int undifference(frame_t *f, comp_t *c, int psv, int pt, int one,
                        int64_t nx)
{
    const int64_t hib = (f->height * c->v + f->vmax - 1) / f->vmax;
    const int64_t wib = (f->width * c->h + f->hmax - 1) / f->hmax;
    uint16_t *prev = (uint16_t *)malloc((size_t)wib * 2);
    uint16_t *row = (uint16_t *)malloc((size_t)wib * 2);
    free(c->samples);
    c->samples = (uint8_t *)malloc((size_t)(hib * wib));
    if (prev == NULL || row == NULL || c->samples == NULL) {
        free(prev);
        free(row);
        return ERR_NOMEM;
    }
    uint8_t *first = (uint8_t *)calloc((size_t)hib, 1);
    if (first == NULL) {
        free(prev);
        free(row);
        return ERR_NOMEM;
    }
    const int64_t every = f->restart ? f->restart / nx : 0;
    const int unit = one ? 1 : c->v;
    first[0] = 1;
    for (int64_t q = 0; every && q < hib; ++q)
        if (q % unit == 0 && (q / unit) % every == 0)
            first[q / c->v * c->v] = 1;
    const uint32_t init = 1u << (f->precision - pt - 1);
    for (int64_t r = 0; r < hib; ++r) {
        const int16_t *d = c->coef + r * c->bw;
        if (first[r]) {
            uint32_t ra = init;
            for (int64_t x = 0; x < wib; ++x)
                row[x] = (uint16_t)(ra = (ra + (uint16_t)d[x]) & 0xFFFF);
        } else {
            int32_t ra = (prev[0] + (uint16_t)d[0]) & 0xFFFF;
            row[0] = (uint16_t)ra;
            for (int64_t x = 1; x < wib; ++x) {
                int32_t rb = prev[x], rc = prev[x - 1], p;
                switch (psv) {
                case 1: p = ra; break;
                case 2: p = rb; break;
                case 3: p = rc; break;
                case 4: p = ra + rb - rc; break;
                case 5: p = ra + ((rb - rc) >> 1); break;
                case 6: p = rb + ((ra - rc) >> 1); break;
                default: p = (ra + rb) >> 1; break;
                }
                ra = (p + (uint16_t)d[x]) & 0xFFFF;
                row[x] = (uint16_t)ra;
            }
        }
        for (int64_t x = 0; x < wib; ++x)
            c->samples[r * wib + x] = (uint8_t)(row[x] << pt);
        uint16_t *t = prev;
        prev = row;
        row = t;
    }
    free(first);
    free(prev);
    free(row);
    return 0;
}

/* one block of an arithmetic-coded scan */
static int arith_block(frame_t *f, arith_t *e, comp_t *c, uint8_t *dcs,
                       uint8_t *acs, uint8_t *fixed, int td, int ta, int ss,
                       int se, int ah, int al, int16_t *out)
{
    int rc = 0;
    if (!f->progressive || (ss == 0 && ah == 0)) {
        int32_t diff;
        rc = arith_dc(e, dcs, c, f->dac_l[td], f->dac_u[td], &diff);
        if (rc)
            return rc;
        c->pred += diff;
        out[0] = (int16_t)(int32_t)((uint32_t)c->pred
                                    << (f->progressive ? al : 0));
    } else if (ss == 0) {
        if (arith_decode(e, fixed))
            out[0] = (int16_t)(out[0] | (1 << al));
    }
    if (!f->progressive)
        rc = arith_ac(e, acs, fixed, 1, 63, f->dac_k[ta], 0, out);
    else if (ss && ah == 0)
        rc = arith_ac(e, acs, fixed, ss, se, f->dac_k[ta], al, out);
    else if (ss)
        rc = arith_ac_refine(e, acs, fixed, ss, se, al, out);
    return rc;
}

static int decode_scan(frame_t *f, const uint8_t *b, int64_t n,
                       const uint8_t *d, int64_t dn, int64_t *pos)
{
    if (n < 1)
        return ERR_CORRUPT;
    int ns = b[0];
    if (ns < 1 || ns > f->ncomp || n < 4 + 2 * ns)
        return ERR_CORRUPT;
    int ss = b[1 + 2 * ns], se = b[2 + 2 * ns];
    int ah = b[3 + 2 * ns] >> 4, al = b[3 + 2 * ns] & 15;
    if (f->lossless) {
        if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al >= f->precision)
            return ERR_CORRUPT;     /* jdlossls.c: bad scan parameters */
    } else if (f->progressive) {
        int dc = ss == 0;
        if ((dc && se != 0) || (!dc && (ss > se || se > 63 || ns != 1))
                || (ah && al != ah - 1) || al > 13)
            return ERR_CORRUPT;     /* jdphuff.c: bad progression */
    } else if (ss != 0 || se != 63 || ah != 0 || al != 0) {
        return ERR_CORRUPT;
    }
    int need_dc = !f->arith && (f->lossless || !f->progressive
                                || (ss == 0 && ah == 0));
    int need_ac = !f->arith && !f->lossless && (!f->progressive || ss > 0);
    int sc[MAX_COMPS], td[MAX_COMPS], ta[MAX_COMPS];
    const htable *dct[MAX_COMPS], *act[MAX_COMPS];
    const int size = f->lossless ? 1 : 8;
    for (int k = 0; k < ns; ++k) {
        int cid = b[1 + 2 * k], t = b[2 + 2 * k], ci = -1;
        for (int j = 0; j < f->ncomp; ++j)
            if (f->comp[j].id == cid && ci < 0)
                ci = j;
        if (ci < 0 || (t >> 4) > 3 || (t & 15) > 3
                || (need_dc && !f->dc[t >> 4].defined)
                || (need_ac && !f->ac[t & 15].defined)
                || (need_dc && f->dc_max[t >> 4] > (f->lossless ? 16 : 15)))
            return ERR_CORRUPT;
        sc[k] = ci;
        td[k] = t >> 4;
        ta[k] = t & 15;
        dct[k] = &f->dc[t >> 4];
        act[k] = &f->ac[t & 15];
    }
    int64_t nx, ny;
    if (ns == 1) {
        comp_t *c = &f->comp[sc[0]];
        nx = (f->width * c->h + f->hmax * size - 1) / (f->hmax * size);
        ny = (f->height * c->v + f->vmax * size - 1) / (f->vmax * size);
    } else {
        int blocks = 0;
        for (int k = 0; k < ns; ++k)
            blocks += f->comp[sc[k]].h * f->comp[sc[k]].v;
        if (blocks > MAX_BLOCKS_IN_MCU)
            return ERR_CORRUPT;
        nx = f->mcux;
        ny = f->mcuy;
    }
    if (f->lossless && f->restart && f->restart % nx)
        return ERR_CORRUPT;     /* jddiffct.c: whole MCU rows only */
    for (int k = 0; k < ns && !f->lossless; ++k)
        for (int i = ss; i <= se; ++i)
            f->coef_bits[sc[k]][i] = al;
    uint8_t dc_st[4][64], ac_st[4][256], fixed = FIXED_BIN;
    arith_t ar;
    int64_t end = entropy_end(d, dn, *pos);
    if (end < 0)
        return ERR_CORRUPT;
    int64_t nmcu = nx * ny, per = f->restart ? f->restart : nmcu;
    uint8_t *buf = (uint8_t *)malloc((size_t)(end - *pos + PAD_BYTES));
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
        int64_t len = f->arith ? arith_destuff(d + start, stop - start, buf)
                               : destuff(d + start, stop - start, buf);
        if (len < 0) {
            rc = (int)len;
            break;
        }
        int64_t bp = 0, limit = len * 8;
        int32_t eobrun = 0;
        for (int k = 0; k < ns; ++k) {
            f->comp[sc[k]].pred = 0;
            f->comp[sc[k]].ctx = 0;
        }
        if (f->arith) {
            /* the statistics restart with every interval */
            arith_init(&ar, buf, len);
            fixed = FIXED_BIN;
            for (int k = 0; k < ns; ++k) {
                if (!f->progressive || (ss == 0 && ah == 0))
                    memset(dc_st[td[k]], 0, 64);
                if (!f->progressive || ss)
                    memset(ac_st[ta[k]], 0, 256);
            }
        }
        for (int64_t i = 0; i < per && m < nmcu && rc == 0; ++i, ++m) {
            int64_t my = m / nx, mx = m % nx;
            for (int k = 0; k < ns && rc == 0; ++k) {
                comp_t *c = &f->comp[sc[k]];
                int hh = ns == 1 ? 1 : c->h, vv = ns == 1 ? 1 : c->v;
                for (int y = 0; y < vv && rc == 0; ++y)
                    for (int x = 0; x < hh && rc == 0; ++x) {
                        int64_t by = my * vv + y, bx = mx * hh + x;
                        if (f->lossless) {
                            uint64_t w;
                            int s = huff_decode(dct[k], buf, &bp, &w);
                            if (s < 0) {
                                rc = ERR_CORRUPT;
                                break;
                            }
                            int32_t v = s == 16 ? 32768 : 0;
                            if (s && s < 16) {
                                v = extend(w, s);
                                bp += s;
                            }
                            c->coef[by * c->bw + bx] = (int16_t)v;
                            if (bp > limit)
                                rc = ERR_CORRUPT;
                            continue;
                        }
                        int16_t *out = c->coef + (by * c->bw + bx) * 64;
                        if (f->arith) {
                            rc = arith_block(f, &ar, c, dc_st[td[k]],
                                             ac_st[ta[k]], &fixed, td[k],
                                             ta[k], ss, se, ah, al, out);
                            continue;
                        }
                        if (!f->progressive)
                            rc = decode_block(dct[k], act[k], buf, limit,
                                              &bp, &c->pred, out);
                        else if (ss == 0 && ah == 0)
                            rc = decode_dc_first(dct[k], buf, limit, &bp,
                                                 &c->pred, al, out);
                        else if (ss == 0)
                            rc = decode_dc_refine(buf, limit, &bp, al, out);
                        else if (ah == 0)
                            rc = decode_ac_first(act[k], buf, limit, &bp, ss,
                                                 se, al, &eobrun, out);
                        else
                            rc = decode_ac_refine(act[k], buf, limit, &bp,
                                                  ss, se, al, &eobrun, out);
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
    for (int k = 0; k < ns && rc == 0 && f->lossless; ++k)
        rc = undifference(f, &f->comp[sc[k]], ss, al, ns == 1, nx);
    return rc;
}

/* upsampling of the (dh, dw) plane p (pitch pp) by the integral ratio
 * (fh, fv) into the (H, W) plane out, as jdsample.c's jinit_upsampler
 * picks it: a copy for (1, 1); fancy for (2, 1), (2, 2) and (1, 2) (box
 * for the h2 ratios of a plane at most 2 wide); box replication
 * (int_upsample) for any other ratio */
static void upsample(const uint8_t *p, int64_t pp, int64_t dh, int64_t dw,
                     int fh, int fv, uint8_t *out, int64_t H, int64_t W)
{
    int fancy = ((fh == 2 && (fv == 1 || fv == 2)) || (fh == 1 && fv == 2))
                && !(fh == 2 && dw <= 2);
    for (int64_t y = 0; y < H; ++y) {
        uint8_t *o = out + y * W;
        int64_t r = y / fv;
        const uint8_t *near = p + r * pp;
        if (fh == 1 && fv == 1) {
            memcpy(o, near, (size_t)W);
            continue;
        }
        if (!fancy) {
            for (int64_t x = 0; x < W; ++x)
                o[x] = near[x / fh];
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

/* whether libjpeg-turbo would smooth this progressive frame's blocks
 * (jdcoefct.c's smoothing_ok): every component has its table with nonzero
 * values where the smoothing reads them and its DC sent, and some
 * component has one of its first SMOOTHING_COEFS zigzag coefficients not
 * refined to the last bit */
static int smoothed(const frame_t *f)
{
    static const int at[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    int useful = 0;
    if (!f->progressive)
        return 0;
    for (int k = 0; k < f->ncomp; ++k) {
        const comp_t *c = &f->comp[k];
        if (c->tq > 3 || !f->qdef[c->tq] || f->coef_bits[k][0] < 0)
            return 0;
        for (int i = 0; i < 10; ++i)
            if (f->quant[c->tq][at[i]] == 0)
                return 0;
        for (int i = 1; i < SMOOTHING_COEFS; ++i)
            useful |= f->coef_bits[k][i] != 0;
    }
    return useful;
}

/* the colour space jdapimin.c's default_decompress_parms guesses */
enum { GREY, YCC, RGB, CMYK, YCCK, RAW4 };

static int colour_space(const frame_t *f)
{
    if (f->ncomp == 1)
        return GREY;
    if (f->ncomp == 4)
        return f->adobe > 0 ? YCCK : CMYK;
    if (f->jfif)
        return YCC;
    if (f->adobe >= 0)
        return f->adobe == 0 ? RGB : YCC;
    /* libjpeg-turbo 3 takes a lossless frame with no marker as RGB */
    return (f->comp[0].id == 82 && f->comp[1].id == 71 && f->comp[2].id == 66)
           || f->lossless ? RGB : YCC;
}

/* libjpeg-turbo's block smoothing of component k's (hib, wib) blocks
 * into coefficients of their own (jdcoefct.c::decompress_smooth_data):
 * each of the first zigzag ACs still zero and not known to the last bit
 * gets an estimate from the 5x5 neighbours' DCs, clamped below 2^Al;
 * with no AC sent at all, the DC too. The neighbour rows follow its
 * numbering (io/jpeg_plain.py::smooth_rows), padding rows included;
 * columns past an edge repeat the edge's. */
static int16_t *smooth(const frame_t *f, int k, int64_t hib, int64_t wib)
{
    const comp_t *c = &f->comp[k];
    const uint16_t *q = f->quant[c->tq];
    const int *bits = f->coef_bits[k];
    int16_t *out = (int16_t *)malloc((size_t)(hib * wib * 64) * 2);
    int64_t (*rows)[5] = malloc((size_t)hib * sizeof(*rows));
    if (out == NULL || rows == NULL) {
        free(out);
        free(rows);
        return NULL;
    }
    const int64_t last = f->mcuy - 1;
    for (int64_t r = 0; r < hib; ++r) {
        int64_t i = r / c->v, b = r % c->v;
        int64_t nrows = i < last ? c->v : (hib % c->v ? hib % c->v : c->v);
        int64_t num = i * nrows + b, total = nrows * f->mcuy;
        int64_t prev = num > 0 ? r - 1 : r, next = num < total - 1 ? r + 1 : r;
        rows[r][0] = num > 1 ? r - 2 : prev;
        rows[r][1] = prev;
        rows[r][2] = r;
        rows[r][3] = next;
        rows[r][4] = num < total - 2 ? r + 2 : next;
    }
    int change_dc = 1;
    for (int i = 1; i < 10; ++i)
        change_dc &= bits[i] == -1;
    static const int at[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    const int64_t q00 = q[0];
    for (int64_t r = 0; r < hib; ++r)
        for (int64_t x = 0; x < wib; ++x) {
            int16_t *w = out + (r * wib + x) * 64;
            memcpy(w, c->coef + (r * c->bw + x) * 64, 128);
            int64_t dc[25];
            for (int i = 0; i < 5; ++i)
                for (int j = 0; j < 5; ++j) {
                    int64_t col = x + j - 2;
                    col = col < 0 ? 0 : col > wib - 1 ? wib - 1 : col;
                    dc[i * 5 + j] = c->coef[(rows[r][i] * c->bw + col) * 64];
                }
            for (int i = 1; i < 10; ++i) {
                const int16_t *wt = change_dc ? SMOOTH_CHANGE_DC[i - 1]
                                    : i <= 5 ? SMOOTH_AC[i - 1] : NULL;
                int al = bits[i];
                if (wt == NULL || al == 0 || w[at[i]] != 0)
                    continue;
                int64_t num = 0, qk = q[at[i]];
                for (int j = 0; j < 25; ++j)
                    num += wt[j] * dc[j];
                num *= q00;
                int64_t pred = ((qk << 7) + (num < 0 ? -num : num))
                               / (qk << 8);
                if (al > 0 && pred >= (1 << al))
                    pred = (1 << al) - 1;
                w[at[i]] = (int16_t)(num < 0 ? -pred : pred);
            }
            if (change_dc) {
                int64_t num = 0;
                for (int j = 0; j < 25; ++j)
                    num += SMOOTH_DC[j] * dc[j];
                num *= q00;
                int64_t pred = ((q00 << 7) + (num < 0 ? -num : num))
                               / (q00 << 8);
                w[0] = (int16_t)(num < 0 ? -pred : pred);
            }
        }
    free(rows);
    return out;
}

/* a lossless frame's pixels: its components box-upsampled (libjpeg-turbo
 * upsamples fancy only from IDCT blocks wider than a sample); 3
 * components RGB, 4 CMYK; YCbCr and YCCK, which libjpeg-turbo does not
 * convert in a lossless frame, are refused */
static int lossless_output(frame_t *f, int space, uint8_t *dst)
{
    int nc = f->ncomp;
    int64_t H = f->height, W = f->width;
    if (space == YCC || space == YCCK)
        return ERR_LOSSLESS_YCC;
    for (int k = 0; k < nc; ++k)
        if (f->comp[k].samples == NULL)
            return ERR_CORRUPT;
    for (int64_t y = 0; y < H; ++y)
        for (int64_t x = 0; x < W; ++x) {
            uint8_t v[MAX_COMPS];
            for (int k = 0; k < nc; ++k) {
                const comp_t *c = &f->comp[k];
                int64_t wib = (W * c->h + f->hmax - 1) / f->hmax;
                v[k] = c->samples[(y / (f->vmax / c->v)) * wib
                                  + x / (f->hmax / c->h)];
            }
            uint8_t *o = dst + (y * W + x) * (nc == 1 ? 1 : 3);
            if (nc == 1)
                o[0] = v[0];
            else if (nc == 3)
                memcpy(o, v, 3);
            else
                for (int k = 0; k < 3; ++k)
                    o[k] = (uint8_t)(v[3] - (((255 - v[k]) * v[3]) >> 8));
        }
    return 0;
}

static int output(frame_t *f, int mode, uint8_t *dst)
{
    int nc = f->ncomp;
    int64_t H = f->height, W = f->width;
    uint8_t *up[MAX_COMPS] = {NULL, NULL, NULL, NULL};
    int rc = 0;
    int space = mode == MODE_YCC ? YCC : mode == MODE_CV2 ? colour_space(f)
                : nc == 1 ? GREY : nc == 3 ? RGB : RAW4;
    if (f->lossless)
        return lossless_output(f, space, dst);
    const int smoothing = smoothed(f);
    for (int k = 0; k < nc && rc == 0; ++k) {
        comp_t *c = &f->comp[k];
        if (c->tq > 3 || !f->qdef[c->tq]) {
            rc = ERR_CORRUPT;
            break;
        }
        int64_t dh = (H * c->v + f->vmax - 1) / f->vmax;
        int64_t dw = (W * c->h + f->hmax - 1) / f->hmax;
        int64_t hib = (dh + 7) / 8, wib = (dw + 7) / 8;
        int16_t *coef = c->coef, *smoothed_coef = NULL;
        int64_t stride = c->bw;
        if (smoothing) {
            coef = smoothed_coef = smooth(f, k, hib, wib);
            stride = wib;
        }
        int64_t pw = wib * 8;
        uint8_t *plane = (uint8_t *)malloc((size_t)(hib * 8 * pw));
        up[k] = nc == 1 ? dst : (uint8_t *)malloc((size_t)(H * W));
        if (plane == NULL || up[k] == NULL || (smoothing && coef == NULL)) {
            free(plane);
            free(smoothed_coef);
            rc = ERR_NOMEM;
            break;
        }
        for (int64_t by = 0; by < hib; ++by)
            for (int64_t bx = 0; bx < wib; ++bx)
                idct_islow(coef + (by * stride + bx) * 64, f->quant[c->tq],
                           plane + by * 8 * pw + bx * 8, pw);
        free(smoothed_coef);
        upsample(plane, pw, dh, dw, f->hmax / c->h, f->vmax / c->v, up[k],
                 H, W);
        free(plane);
    }
    for (int64_t i = 0; rc == 0 && nc > 1 && i < H * W; ++i) {
        int64_t v[3];
        if (space == RAW4) {
            for (int k = 0; k < 4; ++k)
                dst[4 * i + k] = up[k][i];
            continue;
        }
        if (space == RGB) {
            for (int k = 0; k < 3; ++k)
                dst[3 * i + k] = up[k][i];
            continue;
        }
        if (space == YCC || space == YCCK) {
            int64_t y = up[0][i], cb = up[1][i] - 128, cr = up[2][i] - 128;
            v[0] = y + ((91881 * cr + 32768) >> 16);
            v[1] = y + ((-22554 * cb + 32768 - 46802 * cr) >> 16);
            v[2] = y + ((116130 * cb + 32768) >> 16);
            if (space == YCC) {
                for (int k = 0; k < 3; ++k)
                    dst[3 * i + k] = clamp255(v[k]);
                continue;
            }
            /* jdcolor.c's ycck_cmyk_convert: C, M, Y = 255 - RGB */
            for (int k = 0; k < 3; ++k)
                v[k] = clamp255(255 - v[k]);
        } else {
            for (int k = 0; k < 3; ++k)
                v[k] = up[k][i];
        }
        /* OpenCV's CMYK -> BGR (icvCvt_CMYK2BGR_8u_C4C3R), as RGB */
        int64_t kk = up[3][i];
        for (int k = 0; k < 3; ++k)
            dst[3 * i + k] = (uint8_t)(kk - (((255 - v[k]) * kk) >> 8));
    }
    if (nc > 1)
        for (int k = 0; k < nc; ++k)
            free(up[k]);
    return rc;
}

static void free_frame(frame_t *f)
{
    for (int k = 0; k < MAX_COMPS; ++k) {
        free(f->comp[k].coef);
        free(f->comp[k].samples);
    }
}

/* Parse (and, with dst, decode) a JPEG stream. info: height, width,
 * components. */
static int64_t run(const uint8_t *d, int64_t n, int64_t *info, uint8_t *dst,
                   int64_t dstsize, int mode)
{
    frame_t *f = (frame_t *)calloc(1, sizeof(frame_t));
    if (f == NULL)
        return ERR_NOMEM;
    f->adobe = -1;
    for (int t = 0; t < 16; ++t) {
        f->dac_u[t] = 1;        /* T.81 F.1.4.4: L 0, U 1, Kx 5 */
        f->dac_k[t] = 5;
    }
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
            rc = parse_dac(f, b, bn);
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
        } else if (marker == 0xE0 && bn >= 14 && !memcmp(b, "JFIF", 5)) {
            f->jfif = 1;       /* jdmarker.c reads APP0 of 14 bytes on */
        } else if (marker == 0xEE && bn >= 12 && !memcmp(b, "Adobe", 5)) {
            f->adobe = b[11];  /* the transform flag */
        } else if (marker == 0xDC) {
            rc = ERR_CORRUPT;
        }
    }
    if (rc == 0 && !scanned)
        rc = ERR_CORRUPT;
    if (rc == 0) {
        int channels = f->ncomp == 1 ? 1
                       : f->ncomp == 4 && mode == MODE_RAW ? 4 : 3;
        info[0] = f->height;
        info[1] = f->width;
        info[2] = f->ncomp == 1 ? 1 : 3;
        info[3] = f->ncomp;
        if (dst != NULL) {
            if (dstsize < f->height * f->width * channels)
                rc = ERR_SPACE;
            else
                rc = output(f, mode, dst);
        }
    }
    free_frame(f);
    free(f);
    return rc;
}

/* The height, width and channels of a JPEG stream's decoded pixels from
 * its frame header (info[0..3]: 1 grey, 3 RGB; the components); 0, or a
 * negative error. */
int64_t jpeg_info(const uint8_t *src, int64_t n, int64_t *info)
{
    if (src == NULL || n < 0 || info == NULL)
        return ERR_ARGS;
    return run(src, n, info, NULL, 0, MODE_CV2);
}

/* Decode a JPEG stream into dst: (H, W) grey or (H, W, 3) RGB uint8; in
 * MODE_CV2 the pixels of cv2.imread (BGR flipped), else as the mode says
 * (JPEG-in-TIFF: libtiff sets the colour space); the bytes written, or a
 * negative error. */
int64_t jpeg_decode(const uint8_t *src, int64_t n, uint8_t *dst,
                    int64_t dstsize, int mode)
{
    int64_t info[4];
    if (src == NULL || n < 0 || dst == NULL || mode < 0 || mode > MODE_YCC)
        return ERR_ARGS;
    int64_t rc = run(src, n, info, dst, dstsize, mode);
    return rc < 0 ? rc : info[0] * info[1]
                         * (mode == MODE_RAW ? info[3] : info[2]);
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
