/* Tile decoders written by hand: TIFF LZW (both styles), PackBits, the
 * TIFF horizontal and floating-point predictors, TIFF FillOrder 2 bit
 * reversal, packed sample unpacking, CCITT bilevel decoding, PNG row
 * unfiltering and BMP run-length decoding.
 *
 * The port's host-side counterpart of the OpenCV (libtiff, libpng) that
 * the JAX package's read_image decodes tiles with. Built at first use
 * with the system C compiler and bound with ctypes
 * (image_stitcher_tpu_torch/native, io/tile_decode.py); every function
 * is reentrant, works on caller-owned buffers and touches no Python
 * object, so ctypes calls run with the interpreter lock released and the
 * tile loader's threads decode in parallel. Deflate (TIFF compression 8
 * and 32946, PNG IDAT) is not here: the stdlib's zlib inflates it.
 *
 * io/tile_decode.py holds the plain version of every function here; the
 * two give byte-equal output on every input, corrupt ones included
 * (same return value). The rules both follow:
 *   - LZW is TIFF's (libtiff's LZWDecode): codes MSB-first, 9 to 12
 *     bits, ClearCode 256, EndOfInformation 257, first free code 258;
 *     "early change": the width grows one code early, once the next free
 *     code reaches 511, 1023 and 2047; the table holds 4096 entries and
 *     takes no more until a ClearCode. Output stops at EOI, at the end
 *     of the input, or when the destination is full (a string that does
 *     not fit is cut). A code above the next free one, or a first code
 *     after a ClearCode above 255, is corrupt.
 *   - old-style LZW (libtiff's LZWDecodeCompat), which a stream starting
 *     0x00 0x?1 (its ClearCode LSB-first) is: codes LSB-first, the width
 *     growing only once the next free code reaches 512, 1024 and 2048;
 *     a ClearCode must come first; every code after the first of a
 *     table adds an entry, up to 5120 (past that is corrupt); a code
 *     above the next free one, or a code above 256 right after a
 *     ClearCode, is corrupt.
 *   - PackBits: a header byte n >= 0 copies n + 1 literal bytes,
 *     -127..-1 repeats the next byte 1 - n times, -128 is skipped; a
 *     run cut by the end of the input or of the destination is cut.
 *   - the horizontal predictor (Predictor 2) adds each sample to the
 *     same sample of the pixel before it in the row, modulo 2^bits, for
 *     8-, 16-, 32- and 64-bit samples in native byte order, as libtiff
 *     does after it swaps the bytes of a big-endian file (its horAcc8 to
 *     horAcc64; a signed or float sample is added as its unsigned bits).
 *   - the floating-point predictor (Predictor 3) is libtiff's fpAcc, row
 *     by row on the decoded bytes: each byte adds the byte spp before it
 *     in the row (modulo 256), then the row, which holds the samples'
 *     bytes as planes, most significant byte's plane first, is put back
 *     as samples in native byte order (libtiff swaps no bytes after it,
 *     whatever the file's byte order).
 *   - FillOrder 2: each byte's bits reversed, in place.
 *   - packed samples of 1 to 16 bits, MSB-first, each row starting on a
 *     byte: unpacked to one uint8 (up to 8 bits) or native uint16 sample
 *     each, values unscaled.
 *   - CCITT (ITU-T T.4 and T.6 as libtiff's tif_fax3.c reads them),
 *     decoded to packed rows, MSB-first, 1 for black (a white run is 0
 *     bits, whatever PhotometricInterpretation says), each row padded
 *     with 0 bits to a byte. Compression 2 (Modified Huffman): 1-D rows,
 *     each starting on a byte. Compression 3 (T.4): before every row an
 *     EOL is searched as libtiff's SYNC_EOL does (11 zero bits, then
 *     zeros up to a 1, so fill bits pass); with T4Options bit 0 a tag
 *     bit follows (1: a 1-D row, 0: a 2-D row). Compression 4 (T.6):
 *     2-D rows back to back. The first row's reference is white. A 1-D
 *     row is white and black runs in turn until the row is full; a 2-D
 *     row takes pass, horizontal and vertical (-3..3) modes against the
 *     reference's changing elements. A run past the row's end, a code
 *     that is not in the tables (an EOL or extension within a row
 *     included) or data that ends before the last row is corrupt. Bits
 *     past the end of the data read as 0.
 *   - PNG filters 0-4 (None, Sub, Up, Average, Paeth) undone row by row
 *     with bpp = bytes per complete pixel (1 for bit depths under 8);
 *     the row above the first is zeros; a filter type over 4 is corrupt.
 *   - BMP BI_RLE8 / BI_RLE4 as OpenCV 5.0's grfmt_bmp.cpp decodes them,
 *     to one palette index a pixel, rows in the file's order (the bottom
 *     row first for a bottom-up BMP). A run (count n > 0, then a byte:
 *     the index, or for RLE4 two indices, high nibble first, in turn)
 *     may not pass the row's end; in RLE8 one that ends on it moves to
 *     the next row, and an EOL right after that is skipped. An absolute
 *     run (0, n >= 3, n indices padded to 16 bits) may not pass it
 *     either and stays on the row. EOL (0, 0) fills the rest of the row
 *     with index 0 and moves to the next. In RLE8 a delta (0, 2, dx, dy)
 *     fills the next dx + dy * width pixels with index 0, row after
 *     row, and EOF (0, 1) every pixel left; in RLE4 EOF is another EOL
 *     and a delta fills the next dx pixels only. Decoding ends once the
 *     last row is passed; a run past a row's end, or data that ends
 *     before that, is corrupt.
 *
 * Each is bound by its serial dependency (a code's string, a run, the
 * previous sample or pixel), not by memory: a few nanoseconds a byte.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define ERR_ARGS -1
#define ERR_CORRUPT -2
#define ERR_NOMEM -4

#define LZW_CLEAR 256
#define LZW_EOI 257
#define LZW_FIRST 258
#define LZW_TABLE 4096
#define LZW_MAX_BITS 12

/* Copy the string of table entry code (length len) to dst + pos, cut to
 * the room left; returns the bytes written. */
static int64_t put_string(const uint16_t *prefix, const uint8_t *suffix,
                          int c, int64_t len, uint8_t *dst, int64_t pos,
                          int64_t cap)
{
    if (len > cap - pos) {
        for (int64_t k = len - (cap - pos); k > 0; k--)
            c = prefix[c];
        len = cap - pos;
    }
    uint8_t *p = dst + pos + len - 1;
    for (int64_t k = 0; k < len; k++) {
        *p-- = suffix[c];
        c = prefix[c];
    }
    return len;
}

#define LZW_COMPAT_TABLE (4096 + 1024)

/* Old-style (LSB-first) TIFF LZW, as libtiff's LZWDecodeCompat. */
static int64_t lzw_decode_compat(const uint8_t *src, int64_t n, uint8_t *dst,
                                 int64_t cap)
{
    uint16_t prefix[LZW_COMPAT_TABLE];
    uint8_t suffix[LZW_COMPAT_TABLE], first[LZW_COMPAT_TABLE];
    uint16_t length[LZW_COMPAT_TABLE];
    uint64_t bitbuf = 0;
    int bits = 0, nbits = 9, next = LZW_FIRST, old = -1;
    int64_t i = 0, pos = 0;

    for (int c = 0; c < 256; c++) {
        prefix[c] = 0;
        suffix[c] = (uint8_t)c;
        first[c] = (uint8_t)c;
        length[c] = 1;
    }
    while (pos < cap) {
        int code;
        while (bits < nbits) {
            if (i >= n)
                return pos;
            bitbuf |= (uint64_t)src[i++] << bits;
            bits += 8;
        }
        code = (int)(bitbuf & ((1u << nbits) - 1));
        bitbuf >>= nbits;
        bits -= nbits;
        if (code == LZW_EOI)
            break;
        if (code == LZW_CLEAR) {
            nbits = 9;
            next = LZW_FIRST;
            old = -2;       /* the next code starts a table */
            continue;
        }
        if (old == -1)
            return ERR_CORRUPT;     /* no ClearCode first */
        if (old == -2) {
            if (code > 255)
                return ERR_CORRUPT;
            dst[pos++] = (uint8_t)code;
            old = code;
            continue;
        }
        if (code > next || next >= LZW_COMPAT_TABLE)
            return ERR_CORRUPT;
        prefix[next] = (uint16_t)old;
        suffix[next] = first[code == next ? old : code];
        first[next] = first[old];
        length[next] = (uint16_t)(length[old] + 1);
        next++;
        if (next > (1 << nbits) - 1 && nbits < LZW_MAX_BITS)
            nbits++;
        pos += put_string(prefix, suffix, code, length[code], dst, pos, cap);
        old = code;
    }
    return pos;
}

/* Decode one TIFF LZW strip into dst (cap bytes). Returns the bytes
 * written, or a negative error. */
int64_t tiff_lzw_decode(const uint8_t *src, int64_t n, uint8_t *dst,
                        int64_t cap)
{
    uint16_t prefix[LZW_TABLE];
    uint8_t suffix[LZW_TABLE], first[LZW_TABLE];
    uint16_t length[LZW_TABLE];
    uint64_t bitbuf = 0;
    int bits = 0, nbits = 9, next = LZW_FIRST, old = -1;
    int64_t i = 0, pos = 0;

    if (n < 0 || cap < 0 || (n > 0 && !src) || (cap > 0 && !dst))
        return ERR_ARGS;
    if (n >= 2 && src[0] == 0 && (src[1] & 1))
        return lzw_decode_compat(src, n, dst, cap);
    for (int c = 0; c < 256; c++) {
        prefix[c] = 0;
        suffix[c] = (uint8_t)c;
        first[c] = (uint8_t)c;
        length[c] = 1;
    }
    while (pos < cap) {
        int code;
        while (bits < nbits) {
            if (i >= n)
                return pos;
            bitbuf = (bitbuf << 8) | src[i++];
            bits += 8;
        }
        code = (int)((bitbuf >> (bits - nbits)) & ((1u << nbits) - 1));
        bits -= nbits;
        if (code == LZW_EOI)
            break;
        if (code == LZW_CLEAR) {
            nbits = 9;
            next = LZW_FIRST;
            old = -1;
            continue;
        }
        if (old < 0) {
            if (code > 255)
                return ERR_CORRUPT;
        } else if (code < next || (code == next && next < LZW_TABLE)) {
            if (next < LZW_TABLE) {
                /* code == next (KwKwK) reads the entry it defines: its
                 * first byte is old's */
                prefix[next] = (uint16_t)old;
                suffix[next] = first[code == next ? old : code];
                first[next] = first[old];
                length[next] = (uint16_t)(length[old] + 1);
                next++;
                if (next >= (1 << nbits) - 1 && nbits < LZW_MAX_BITS)
                    nbits++;
            }
        } else {
            return ERR_CORRUPT;
        }
        pos += put_string(prefix, suffix, code, length[code], dst, pos, cap);
        old = code;
    }
    return pos;
}

/* Decode PackBits into dst (cap bytes). Returns the bytes written. */
int64_t packbits_decode(const uint8_t *src, int64_t n, uint8_t *dst,
                        int64_t cap)
{
    int64_t i = 0, pos = 0;
    if (n < 0 || cap < 0 || (n > 0 && !src) || (cap > 0 && !dst))
        return ERR_ARGS;
    while (i < n && pos < cap) {
        int h = (int8_t)src[i++];
        if (h >= 0) {
            int64_t k = h + 1;
            if (k > n - i)
                k = n - i;
            if (k > cap - pos)
                k = cap - pos;
            memcpy(dst + pos, src + i, (size_t)k);
            i += h + 1;
            pos += k;
        } else if (h != -128) {
            int64_t k = 1 - h;
            if (i >= n)
                break;
            if (k > cap - pos)
                k = cap - pos;
            memset(dst + pos, src[i++], (size_t)k);
            pos += k;
        }
    }
    return pos;
}

#define UNDO_PREDICTOR(T)                                                 \
    for (int64_t r = 0; r < rows; r++) {                                  \
        T *p = (T *)data + r * row_samples;                               \
        for (int64_t k = spp; k < row_samples; k++)                       \
            p[k] = (T)(p[k] + p[k - spp]);                                \
    }

/* Undo the TIFF horizontal predictor in place over rows of row_samples
 * samples (pixels x spp) of sample_bytes each (1, 2, 4 or 8), native byte
 * order. Returns 0, or ERR_ARGS. */
int tiff_predictor_undo(void *data, int64_t rows, int64_t row_samples,
                        int spp, int sample_bytes)
{
    if (rows < 0 || row_samples < 0 || spp < 1
            || (rows > 0 && row_samples > 0 && !data))
        return ERR_ARGS;
    if (sample_bytes == 1) {
        UNDO_PREDICTOR(uint8_t)
    } else if (sample_bytes == 2) {
        UNDO_PREDICTOR(uint16_t)
    } else if (sample_bytes == 4) {
        UNDO_PREDICTOR(uint32_t)
    } else if (sample_bytes == 8) {
        UNDO_PREDICTOR(uint64_t)
    } else {
        return ERR_ARGS;
    }
    return 0;
}

/* Undo the TIFF floating-point predictor (libtiff's fpAcc) in place over
 * rows of row_bytes bytes, each row_bytes / sample_bytes samples of
 * sample_bytes each (2, 4 or 8), spp samples a pixel. Returns 0, ERR_ARGS or
 * ERR_NOMEM. */
int tiff_fp_predictor_undo(uint8_t *data, int64_t rows, int64_t row_bytes,
                           int spp, int sample_bytes)
{
    if (rows < 0 || row_bytes < 0 || spp < 1
            || (sample_bytes != 2 && sample_bytes != 4 && sample_bytes != 8)
            || row_bytes % sample_bytes != 0
            || (rows > 0 && row_bytes > 0 && !data))
        return ERR_ARGS;
    if (rows == 0 || row_bytes == 0)
        return 0;
    uint8_t *tmp = (uint8_t *)malloc((size_t)row_bytes);
    if (!tmp)
        return ERR_NOMEM;
    const uint16_t probe = 1;
    const int little = *(const uint8_t *)&probe == 1;
    const int64_t wc = row_bytes / sample_bytes;
    for (int64_t r = 0; r < rows; r++) {
        uint8_t *cp = data + r * row_bytes;
        for (int64_t k = spp; k < row_bytes; k++)
            cp[k] = (uint8_t)(cp[k] + cp[k - spp]);
        memcpy(tmp, cp, (size_t)row_bytes);
        for (int64_t i = 0; i < wc; i++)
            for (int b = 0; b < sample_bytes; b++)
                cp[sample_bytes * i + b] =
                    tmp[(little ? sample_bytes - b - 1 : b) * wc + i];
    }
    free(tmp);
    return 0;
}

static inline uint8_t paeth(int a, int b, int c)
{
    int p = a + b - c;
    int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
    if (pa <= pb && pa <= pc)
        return (uint8_t)a;
    return (uint8_t)(pb <= pc ? b : c);
}

/* Undo PNG row filters: src holds rows of (1 filter byte + row_bytes),
 * dst receives rows x row_bytes. Returns 0, or a negative error. */
int png_unfilter(const uint8_t *src, int64_t rows, int64_t row_bytes,
                 int bpp, uint8_t *dst)
{
    uint8_t *zero;
    if (rows < 0 || row_bytes < 0 || bpp < 1 || bpp > 8
            || (rows > 0 && (!src || !dst)))
        return ERR_ARGS;
    zero = (uint8_t *)calloc((size_t)row_bytes + 1, 1);
    if (!zero)
        return ERR_NOMEM;
    for (int64_t r = 0; r < rows; r++) {
        const uint8_t *in = src + r * (row_bytes + 1);
        uint8_t *out = dst + r * row_bytes;
        const uint8_t *up = r ? out - row_bytes : zero;
        int64_t k;
        switch (*in++) {
        case 0:
            memcpy(out, in, (size_t)row_bytes);
            break;
        case 1:
            for (k = 0; k < row_bytes && k < bpp; k++)
                out[k] = in[k];
            for (; k < row_bytes; k++)
                out[k] = (uint8_t)(in[k] + out[k - bpp]);
            break;
        case 2:
            for (k = 0; k < row_bytes; k++)
                out[k] = (uint8_t)(in[k] + up[k]);
            break;
        case 3:
            for (k = 0; k < row_bytes && k < bpp; k++)
                out[k] = (uint8_t)(in[k] + (up[k] >> 1));
            for (; k < row_bytes; k++)
                out[k] = (uint8_t)(in[k] + ((out[k - bpp] + up[k]) >> 1));
            break;
        case 4:
            for (k = 0; k < row_bytes && k < bpp; k++)
                out[k] = (uint8_t)(in[k] + up[k]);
            for (; k < row_bytes; k++)
                out[k] = (uint8_t)(in[k] + paeth(out[k - bpp], up[k],
                                                 up[k - bpp]));
            break;
        default:
            free(zero);
            return ERR_CORRUPT;
        }
    }
    free(zero);
    return 0;
}

/* FillOrder 2: reverse the bits of each of n bytes in place. */
void reverse_bits(uint8_t *data, int64_t n)
{
    for (int64_t i = 0; i < n; i++) {
        uint8_t b = data[i];
        b = (uint8_t)((b & 0xF0) >> 4 | (b & 0x0F) << 4);
        b = (uint8_t)((b & 0xCC) >> 2 | (b & 0x33) << 2);
        data[i] = (uint8_t)((b & 0xAA) >> 1 | (b & 0x55) << 1);
    }
}

/* Unpack rows (row_bytes bytes each) of count samples of bits (1..16)
 * bits, MSB-first, into dst: rows x count uint8 samples (bits <= 8) or
 * native uint16 samples. Returns 0, or ERR_ARGS. */
int unpack_samples(const uint8_t *src, int64_t rows, int64_t row_bytes,
                   int64_t count, int bits, void *dst)
{
    if (rows < 0 || count < 0 || bits < 1 || bits > 16
            || row_bytes < (count * bits + 7) / 8
            || (rows > 0 && count > 0 && (!src || !dst)))
        return ERR_ARGS;
    const uint32_t mask = (1u << bits) - 1;
    for (int64_t r = 0; r < rows; r++) {
        const uint8_t *in = src + r * row_bytes;
        uint64_t acc = 0;
        int have = 0;
        if (bits <= 8) {
            uint8_t *out = (uint8_t *)dst + r * count;
            for (int64_t k = 0; k < count; k++) {
                if (have < bits) {
                    acc = (acc << 8) | *in++;
                    have += 8;
                }
                have -= bits;
                out[k] = (uint8_t)((acc >> have) & mask);
            }
        } else {
            uint16_t *out = (uint16_t *)dst + r * count;
            for (int64_t k = 0; k < count; k++) {
                while (have < bits) {
                    acc = (acc << 8) | *in++;
                    have += 8;
                }
                have -= bits;
                out[k] = (uint16_t)((acc >> have) & mask);
            }
        }
    }
    return 0;
}

/* ------------------------------------------------------------- CCITT */

/* Code words of ITU-T T.4 (tables 1-3) as (bits, length, value): the
 * terminating codes (runs 0-63), make-up codes (64-1728) of each colour,
 * the make-up codes both share (1792-2560) and EOL. */
typedef struct {
    uint16_t code;
    uint8_t len;
    int16_t run;
} fax_code;

#define FAX_EOL (-2)
#define FAX_BAD (-1)

static const fax_code WHITE_CODES[] = {
    {0x35, 8, 0}, {0x7, 6, 1}, {0x7, 4, 2}, {0x8, 4, 3}, {0xB, 4, 4},
    {0xC, 4, 5}, {0xE, 4, 6}, {0xF, 4, 7}, {0x13, 5, 8}, {0x14, 5, 9},
    {0x7, 5, 10}, {0x8, 5, 11}, {0x8, 6, 12}, {0x3, 6, 13}, {0x34, 6, 14},
    {0x35, 6, 15}, {0x2A, 6, 16}, {0x2B, 6, 17}, {0x27, 7, 18},
    {0xC, 7, 19}, {0x8, 7, 20}, {0x17, 7, 21}, {0x3, 7, 22}, {0x4, 7, 23},
    {0x28, 7, 24}, {0x2B, 7, 25}, {0x13, 7, 26}, {0x24, 7, 27},
    {0x18, 7, 28}, {0x2, 8, 29}, {0x3, 8, 30}, {0x1A, 8, 31},
    {0x1B, 8, 32}, {0x12, 8, 33}, {0x13, 8, 34}, {0x14, 8, 35},
    {0x15, 8, 36}, {0x16, 8, 37}, {0x17, 8, 38}, {0x28, 8, 39},
    {0x29, 8, 40}, {0x2A, 8, 41}, {0x2B, 8, 42}, {0x2C, 8, 43},
    {0x2D, 8, 44}, {0x4, 8, 45}, {0x5, 8, 46}, {0xA, 8, 47}, {0xB, 8, 48},
    {0x52, 8, 49}, {0x53, 8, 50}, {0x54, 8, 51}, {0x55, 8, 52},
    {0x24, 8, 53}, {0x25, 8, 54}, {0x58, 8, 55}, {0x59, 8, 56},
    {0x5A, 8, 57}, {0x5B, 8, 58}, {0x4A, 8, 59}, {0x4B, 8, 60},
    {0x32, 8, 61}, {0x33, 8, 62}, {0x34, 8, 63},
    {0x1B, 5, 64}, {0x12, 5, 128}, {0x17, 6, 192}, {0x37, 7, 256},
    {0x36, 8, 320}, {0x37, 8, 384}, {0x64, 8, 448}, {0x65, 8, 512},
    {0x68, 8, 576}, {0x67, 8, 640}, {0xCC, 9, 704}, {0xCD, 9, 768},
    {0xD2, 9, 832}, {0xD3, 9, 896}, {0xD4, 9, 960}, {0xD5, 9, 1024},
    {0xD6, 9, 1088}, {0xD7, 9, 1152}, {0xD8, 9, 1216}, {0xD9, 9, 1280},
    {0xDA, 9, 1344}, {0xDB, 9, 1408}, {0x98, 9, 1472}, {0x99, 9, 1536},
    {0x9A, 9, 1600}, {0x18, 6, 1664}, {0x9B, 9, 1728},
};

static const fax_code BLACK_CODES[] = {
    {0x37, 10, 0}, {0x2, 3, 1}, {0x3, 2, 2}, {0x2, 2, 3}, {0x3, 3, 4},
    {0x3, 4, 5}, {0x2, 4, 6}, {0x3, 5, 7}, {0x5, 6, 8}, {0x4, 6, 9},
    {0x4, 7, 10}, {0x5, 7, 11}, {0x7, 7, 12}, {0x4, 8, 13}, {0x7, 8, 14},
    {0x18, 9, 15}, {0x17, 10, 16}, {0x18, 10, 17}, {0x8, 10, 18},
    {0x67, 11, 19}, {0x68, 11, 20}, {0x6C, 11, 21}, {0x37, 11, 22},
    {0x28, 11, 23}, {0x17, 11, 24}, {0x18, 11, 25}, {0xCA, 12, 26},
    {0xCB, 12, 27}, {0xCC, 12, 28}, {0xCD, 12, 29}, {0x68, 12, 30},
    {0x69, 12, 31}, {0x6A, 12, 32}, {0x6B, 12, 33}, {0xD2, 12, 34},
    {0xD3, 12, 35}, {0xD4, 12, 36}, {0xD5, 12, 37}, {0xD6, 12, 38},
    {0xD7, 12, 39}, {0x6C, 12, 40}, {0x6D, 12, 41}, {0xDA, 12, 42},
    {0xDB, 12, 43}, {0x54, 12, 44}, {0x55, 12, 45}, {0x56, 12, 46},
    {0x57, 12, 47}, {0x64, 12, 48}, {0x65, 12, 49}, {0x52, 12, 50},
    {0x53, 12, 51}, {0x24, 12, 52}, {0x37, 12, 53}, {0x38, 12, 54},
    {0x27, 12, 55}, {0x28, 12, 56}, {0x58, 12, 57}, {0x59, 12, 58},
    {0x2B, 12, 59}, {0x2C, 12, 60}, {0x5A, 12, 61}, {0x66, 12, 62},
    {0x67, 12, 63},
    {0xF, 10, 64}, {0xC8, 12, 128}, {0xC9, 12, 192}, {0x5B, 12, 256},
    {0x33, 12, 320}, {0x34, 12, 384}, {0x35, 12, 448}, {0x6C, 13, 512},
    {0x6D, 13, 576}, {0x4A, 13, 640}, {0x4B, 13, 704}, {0x4C, 13, 768},
    {0x4D, 13, 832}, {0x72, 13, 896}, {0x73, 13, 960}, {0x74, 13, 1024},
    {0x75, 13, 1088}, {0x76, 13, 1152}, {0x77, 13, 1216}, {0x52, 13, 1280},
    {0x53, 13, 1344}, {0x54, 13, 1408}, {0x55, 13, 1472}, {0x5A, 13, 1536},
    {0x5B, 13, 1600}, {0x64, 13, 1664}, {0x65, 13, 1728},
};

static const fax_code SHARED_CODES[] = {
    {0x8, 11, 1792}, {0xC, 11, 1856}, {0xD, 11, 1920}, {0x12, 12, 1984},
    {0x13, 12, 2048}, {0x14, 12, 2112}, {0x15, 12, 2176}, {0x16, 12, 2240},
    {0x17, 12, 2304}, {0x1C, 12, 2368}, {0x1D, 12, 2432}, {0x1E, 12, 2496},
    {0x1F, 12, 2560}, {0x1, 12, FAX_EOL},
};

/* 2-D mode codes, by the next 7 bits */
enum { M_BAD, M_PASS, M_HORIZ, M_V0, M_VR1, M_VR2, M_VR3, M_VL1, M_VL2,
       M_VL3 };
static const fax_code MODE_CODES[] = {
    {0x1, 4, M_PASS}, {0x1, 3, M_HORIZ}, {0x1, 1, M_V0}, {0x3, 3, M_VR1},
    {0x3, 6, M_VR2}, {0x3, 7, M_VR3}, {0x2, 3, M_VL1}, {0x2, 6, M_VL2},
    {0x2, 7, M_VL3},
};

#define WHITE_BITS 12
#define BLACK_BITS 13
#define MODE_BITS 7

typedef struct {
    int16_t run;      /* run length, FAX_EOL or FAX_BAD */
    uint8_t len;
} fax_entry;

typedef struct {
    fax_entry white[1 << WHITE_BITS], black[1 << BLACK_BITS];
    fax_entry mode[1 << MODE_BITS];
} fax_tables;

static void fill_table(fax_entry *t, int bits, const fax_code *codes,
                       size_t n)
{
    for (size_t i = 0; i < n; i++) {
        int shift = bits - codes[i].len;
        for (int k = 0; k < (1 << shift); k++) {
            t[(codes[i].code << shift) | k].run = codes[i].run;
            t[(codes[i].code << shift) | k].len = codes[i].len;
        }
    }
}

static void build_fax_tables(fax_tables *t)
{
    for (int i = 0; i < (1 << WHITE_BITS); i++)
        t->white[i] = (fax_entry){FAX_BAD, 0};
    for (int i = 0; i < (1 << BLACK_BITS); i++)
        t->black[i] = (fax_entry){FAX_BAD, 0};
    for (int i = 0; i < (1 << MODE_BITS); i++)
        t->mode[i] = (fax_entry){M_BAD, 0};
    fill_table(t->white, WHITE_BITS, WHITE_CODES,
               sizeof WHITE_CODES / sizeof *WHITE_CODES);
    fill_table(t->white, WHITE_BITS, SHARED_CODES,
               sizeof SHARED_CODES / sizeof *SHARED_CODES);
    fill_table(t->black, BLACK_BITS, BLACK_CODES,
               sizeof BLACK_CODES / sizeof *BLACK_CODES);
    fill_table(t->black, BLACK_BITS, SHARED_CODES,
               sizeof SHARED_CODES / sizeof *SHARED_CODES);
    fill_table(t->mode, MODE_BITS, MODE_CODES,
               sizeof MODE_CODES / sizeof *MODE_CODES);
}

typedef struct {
    const uint8_t *src;
    int64_t nbits, pos;     /* bits in the data, the next bit's index */
} bit_reader;

/* The next k (<= 25) bits, MSB-first; bits past the data read as 0. */
static inline uint32_t peek_bits(const bit_reader *br, int k)
{
    int64_t byte = br->pos >> 3, nbytes = br->nbits >> 3;
    uint32_t w = 0;
    for (int i = 0; i < 4; i++)
        w = (w << 8) | (byte + i < nbytes ? br->src[byte + i] : 0);
    return (w << (br->pos & 7)) >> (32 - k);
}

/* One run: make-up codes, then a terminating code. Returns its length,
 * or ERR_CORRUPT. */
static int64_t read_run(bit_reader *br, const fax_tables *t, int black)
{
    int64_t run = 0;
    for (;;) {
        if (br->pos >= br->nbits)
            return ERR_CORRUPT;
        const fax_entry e = black ? t->black[peek_bits(br, BLACK_BITS)]
                                  : t->white[peek_bits(br, WHITE_BITS)];
        if (e.run < 0)
            return ERR_CORRUPT;
        br->pos += e.len;
        run += e.run;
        if (e.run < 64)
            return run;
    }
}

/* A 1-D row: its changing elements into cur; returns their count. */
static int64_t row_1d(bit_reader *br, const fax_tables *t, int64_t width,
                      int32_t *cur)
{
    int64_t pos = 0, nc = 0;
    int black = 0;
    for (;;) {
        int64_t run = read_run(br, t, black);
        if (run < 0)
            return run;
        pos += run;
        if (pos > width)
            return ERR_CORRUPT;
        if (pos == width)
            return nc;
        if (nc >= width)
            return ERR_CORRUPT;
        cur[nc++] = (int32_t)pos;
        black ^= 1;
    }
}

/* A 2-D row against ref (nref changing elements, then 3 x width): its
 * changing elements into cur; returns their count. */
static int64_t row_2d(bit_reader *br, const fax_tables *t, int64_t width,
                      const int32_t *ref, int64_t nref, int32_t *cur)
{
    int64_t a0 = -1, nc = 0, j = 0;
    int color = 0;
    while (a0 < width) {
        if (j > 0)
            j--;
        while (ref[j] <= a0 || (j & 1) != color)
            j++;
        if (j > nref + 1)
            return ERR_CORRUPT;
        const int64_t b1 = ref[j], b2 = ref[j + 1];
        if (br->pos >= br->nbits)
            return ERR_CORRUPT;
        const fax_entry e = t->mode[peek_bits(br, MODE_BITS)];
        int64_t a1, d;
        br->pos += e.len;
        switch (e.run) {
        case M_PASS:
            a0 = b2;
            continue;
        case M_HORIZ: {
            int64_t r1 = read_run(br, t, color), r2;
            if (r1 < 0)
                return r1;
            r2 = read_run(br, t, !color);
            if (r2 < 0)
                return r2;
            a1 = (a0 < 0 ? 0 : a0) + r1;
            if (a1 + r2 > width
                    || nc + (a1 < width) + (a1 + r2 < width) > width)
                return ERR_CORRUPT;
            if (a1 < width)
                cur[nc++] = (int32_t)a1;
            if (a1 + r2 < width)
                cur[nc++] = (int32_t)(a1 + r2);
            a0 = a1 + r2;
            continue;
        }
        case M_V0: d = 0; break;
        case M_VR1: d = 1; break;
        case M_VR2: d = 2; break;
        case M_VR3: d = 3; break;
        case M_VL1: d = -1; break;
        case M_VL2: d = -2; break;
        case M_VL3: d = -3; break;
        default:
            return ERR_CORRUPT;     /* EOL, extension or no code */
        }
        a1 = b1 + d;
        if (a1 < (a0 < 0 ? 0 : a0) || a1 > width
                || (a1 < width && nc >= width))
            return ERR_CORRUPT;
        if (a1 < width)
            cur[nc++] = (int32_t)a1;
        a0 = a1;
        color ^= 1;
    }
    return nc;
}

/* T.4's SYNC_EOL: 11 zero bits, then zeros up to a 1, consumed. */
static int sync_eol(bit_reader *br)
{
    while (peek_bits(br, 11) != 0) {
        if (++br->pos >= br->nbits)
            return ERR_CORRUPT;
    }
    while (peek_bits(br, 1) == 0) {
        if (++br->pos >= br->nbits)
            return ERR_CORRUPT;
    }
    br->pos++;
    return 0;
}

/* Decode one CCITT strip or tile of rows x width pixels (compression 2,
 * 3 or 4; options: T4Options) into dst, rows x ((width + 7) / 8) bytes.
 * Returns the bytes written, or a negative error. */
int64_t ccitt_decode(const uint8_t *src, int64_t n, uint8_t *dst,
                     int64_t rows, int64_t width, int compression,
                     int options)
{
    if (n < 0 || rows < 0 || width < 1 || width > (1 << 30)
            || compression < 2 || compression > 4
            || (n > 0 && !src) || (rows > 0 && !dst))
        return ERR_ARGS;
    const int64_t row_bytes = (width + 7) / 8;
    fax_tables *t = (fax_tables *)malloc(sizeof *t);
    int32_t *buf = (int32_t *)malloc(sizeof(int32_t) * 2 * (width + 4));
    int64_t rc = 0;
    if (!t || !buf) {
        free(t);
        free(buf);
        return ERR_NOMEM;
    }
    build_fax_tables(t);
    int32_t *ref = buf, *cur = buf + width + 4;
    int64_t nref = 0;
    bit_reader br = {src, n * 8, 0};
    for (int k = 0; k < 3; k++)
        ref[k] = (int32_t)width;
    memset(dst, 0, (size_t)(rows * row_bytes));
    for (int64_t r = 0; r < rows; r++) {
        int two_d = compression == 4;
        int64_t nc;
        if (compression == 3) {
            if ((rc = sync_eol(&br)) < 0)
                break;
            if (options & 1) {
                if (br.pos >= br.nbits) {
                    rc = ERR_CORRUPT;
                    break;
                }
                two_d = peek_bits(&br, 1) == 0;
                br.pos++;
            }
        }
        nc = two_d ? row_2d(&br, t, width, ref, nref, cur)
                   : row_1d(&br, t, width, cur);
        if (nc < 0) {
            rc = nc;
            break;
        }
        if (compression == 2)
            br.pos = (br.pos + 7) & ~(int64_t)7;
        uint8_t *out = dst + r * row_bytes;
        for (int64_t k = 1; k < nc + 1; k += 2) {
            int64_t x0 = cur[k - 1], x1 = k < nc ? cur[k] : width;
            for (int64_t x = x0; x < x1; x++)
                out[x >> 3] |= (uint8_t)(0x80 >> (x & 7));
        }
        for (int k = 0; k < 3; k++)
            cur[nc + k] = (int32_t)width;
        int32_t *swap = ref;
        ref = cur;
        cur = swap;
        nref = nc;
    }
    free(t);
    free(buf);
    return rc < 0 ? rc : rows * row_bytes;
}

/* --------------------------------------------------------- BMP RLE */

/* Fill count pixels from (*y, *x) on with index v, row after row (to
 * the end of the image at most), as OpenCV's FillUniColor. */
static void rle_fill(uint8_t *dst, int64_t width, int64_t height,
                     int64_t *y, int64_t *x, int64_t count, uint8_t v)
{
    do {
        int64_t k = width - *x < count ? width - *x : count;
        memset(dst + *y * width + *x, v, (size_t)k);
        *x += k;
        count -= k;
        if (*x >= width) {
            *x = 0;
            if (++*y >= height)
                break;
        }
    } while (count > 0);
}

/* Decode BI_RLE8 (bits 8) or BI_RLE4 (bits 4) data into dst: height rows
 * of width palette indices, in the file's row order. Returns 0, or a
 * negative error. */
int bmp_rle_decode(const uint8_t *src, int64_t n, uint8_t *dst,
                   int64_t width, int64_t height, int bits)
{
    int64_t i = 0, y = 0, x = 0;
    int line_end_flag = 0;
    if (n < 0 || width < 1 || height < 1 || (bits != 4 && bits != 8)
            || (n > 0 && !src) || !dst)
        return ERR_ARGS;
    for (;;) {
        if (i + 2 > n)
            return ERR_CORRUPT;
        const int64_t len = src[i];
        const int code = src[i + 1];
        i += 2;
        if (len != 0) {                 /* a run */
            if (x + len > width)
                return ERR_CORRUPT;
            if (bits == 8) {
                const int64_t prev_y = y;
                rle_fill(dst, width, height, &y, &x, len, (uint8_t)code);
                line_end_flag = y != prev_y;
                if (y >= height)
                    return 0;
            } else {
                for (int64_t k = 0; k < len; k++)
                    dst[y * width + x + k] = (uint8_t)(k & 1 ? code & 15
                                                             : code >> 4);
                x += len;
            }
        } else if (code > 2) {          /* an absolute run */
            const int64_t size = bits == 8 ? (code + 1) & ~1
                                           : (((code + 1) >> 1) + 1) & ~1;
            if (x + code > width)
                return ERR_CORRUPT;
            if (i + size > n)
                return ERR_CORRUPT;
            for (int64_t k = 0; k < code; k++)
                dst[y * width + x + k] = bits == 8 ? src[i + k]
                    : (uint8_t)(k & 1 ? src[i + k / 2] & 15
                                      : src[i + k / 2] >> 4);
            i += size;
            x += code;
            line_end_flag = 0;
        } else {                        /* EOL, EOF or a delta */
            int64_t dx = width - x, dy = height - y;
            if (bits == 4 || code || !line_end_flag || dx < width) {
                if (code == 2) {
                    if (i + 2 > n)
                        return ERR_CORRUPT;
                    dx = src[i];
                    dy = src[i + 1];
                    i += 2;
                }
                /* RLE4: EOF ends the row as EOL does, a delta moves
                 * right only */
                if (bits == 8 && code != 0)
                    dx += dy * width;
                rle_fill(dst, width, height, &y, &x, dx, 0);
            }
            line_end_flag = 0;
            if (y >= height)
                return 0;
        }
    }
}
