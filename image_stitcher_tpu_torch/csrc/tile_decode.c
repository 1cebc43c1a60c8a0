/* Tile decoders written by hand: TIFF LZW, PackBits, the TIFF horizontal
 * predictor, and PNG row unfiltering.
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
 *     after a ClearCode above 255, is corrupt. Old-style (LSB-first)
 *     LZW, which starts 0x00 0x?1, is refused.
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
 *   - PNG filters 0-4 (None, Sub, Up, Average, Paeth) undone row by row
 *     with bpp = bytes per complete pixel (1 for bit depths under 8);
 *     the row above the first is zeros; a filter type over 4 is corrupt.
 *
 * Each is bound by its serial dependency (a code's string, a run, the
 * previous sample or pixel), not by memory: a few nanoseconds a byte.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define ERR_ARGS -1
#define ERR_CORRUPT -2
#define ERR_UNSUPPORTED -3
#define ERR_NOMEM -4

#define LZW_CLEAR 256
#define LZW_EOI 257
#define LZW_FIRST 258
#define LZW_TABLE 4096
#define LZW_MAX_BITS 12

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
        return ERR_UNSUPPORTED;
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
        {
            int c = code;
            int64_t len = length[code];
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
            pos += len;
        }
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
