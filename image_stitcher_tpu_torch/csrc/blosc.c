/* Blosc1 frames, written by hand: byte and bit shuffle, and the codecs
 * blosclz (code 0), LZ4 and LZ4HC (code 1), snappy (code 2), zlib (code
 * 3; the encoder only) and zstd (code 4).
 *
 * The host-side codec of the port's compressed zarr chunks, the
 * counterpart of the c-blosc 1.x that tensorstore links (zarr v2
 * {"id": "blosc"}, and the zarr v3 "blosc" codec inside shards). Built at
 * first use with the system C compiler from this file and the codec
 * files it includes (codec_*.h), and bound with ctypes
 * (image_stitcher_tpu_torch/native, io/blosc.py); every function is
 * reentrant and touches no Python object, so ctypes calls run with the
 * interpreter lock released, one chunk per thread. Every frame, zlib's
 * included, is written here; nothing links a compression library. zlib
 * frames are decoded by io/blosc.py: the frame layer below unshuffles
 * their blocks (blosc_unshuffle_blocks) and the stdlib's zlib inflates
 * the streams.
 *
 * io/blosc.py documents the frame and holds the plain version of every
 * function here; the two produce byte-equal frames.
 * Little-endian hosts only.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define BLOSC_MAX_OVERHEAD 16
#define BLOSC_MIN_BUFFERSIZE 128
#define BLOSC_L1 (32 * 1024)
#define BLOSC_MAX_SPLITS 16
#define FLAG_SHUFFLE 0x01
#define FLAG_MEMCPYED 0x02
#define FLAG_BITSHUFFLE 0x04
#define FLAG_DONT_SPLIT 0x10

/* codec ids (io/blosc.py CNAMES) and their frame codes */
enum { CID_BLOSCLZ, CID_LZ4, CID_LZ4HC, CID_SNAPPY, CID_ZLIB, CID_ZSTD,
       CID_COUNT };
static const int CODE_OF[CID_COUNT] = {0, 1, 1, 2, 3, 4};
#define CODE_ZLIB 3
#define CODE_ZSTD 4

/* error codes (negative returns) */
#define ERR_ARGS -1
#define ERR_CORRUPT -2
#define ERR_UNSUPPORTED -3
#define ERR_NOMEM -4

static uint32_t read32(const uint8_t *p)
{
    uint32_t v;
    memcpy(&v, p, 4);
    return v;
}

static void write32(uint8_t *p, int64_t v)
{
    uint32_t u = (uint32_t)v;
    memcpy(p, &u, 4);
}

static int64_t read_i32(const uint8_t *p)
{
    int32_t v;
    memcpy(&v, p, 4);
    return v;
}

/* bytes a and b agree from the start, a bounded by a_limit */
static int64_t common_len(const uint8_t *a, const uint8_t *b,
                          const uint8_t *a_limit)
{
    const uint8_t *start = a;
    while (a + 8 <= a_limit) {
        uint64_t x, y;
        memcpy(&x, a, 8);
        memcpy(&y, b, 8);
        if (x != y)
            return (a - start) + (__builtin_ctzll(x ^ y) >> 3);
        a += 8;
        b += 8;
    }
    while (a < a_limit && *a == *b) {
        ++a;
        ++b;
    }
    return a - start;
}

/* op[0, len) = the len bytes starting off bytes back (off >= 1; they may
 * overlap op): copy what is already written, doubling, so source and
 * destination never overlap */
static void copy_match(uint8_t *op, int64_t off, int64_t len)
{
    const uint8_t *ref = op - off;
    for (int64_t done = 0; done < len;) {
        int64_t n = off + done < len - done ? off + done : len - done;
        memcpy(op + done, ref, (size_t)n);
        done += n;
    }
}

#include "codec_lz4.h"
#include "codec_blosclz.h"
#include "codec_snappy.h"
#include "codec_zstd.h"
#include "codec_zlib.h"

/* ------------------------------------------------------------ shuffles */

/* dst[j * ne + i] = src[i * ts + j] for the ne = n / ts whole elements;
 * a tail of n % ts bytes is copied as it is (c-blosc's generic shuffle). */
static void shuffle(int64_t ts, int64_t n, const uint8_t *src, uint8_t *dst)
{
    int64_t ne = n / ts;
    if (ts == 2) {
        for (int64_t i = 0; i < ne; ++i) {
            dst[i] = src[2 * i];
            dst[ne + i] = src[2 * i + 1];
        }
    } else {
        for (int64_t j = 0; j < ts; ++j)
            for (int64_t i = 0; i < ne; ++i)
                dst[j * ne + i] = src[i * ts + j];
    }
    memcpy(dst + ne * ts, src + ne * ts, (size_t)(n - ne * ts));
}

static void unshuffle(int64_t ts, int64_t n, const uint8_t *src,
                      uint8_t *dst)
{
    int64_t ne = n / ts;
    if (ts == 2) {
        for (int64_t i = 0; i < ne; ++i) {
            dst[2 * i] = src[i];
            dst[2 * i + 1] = src[ne + i];
        }
    } else {
        for (int64_t j = 0; j < ts; ++j)
            for (int64_t i = 0; i < ne; ++i)
                dst[i * ts + j] = src[j * ne + i];
    }
    memcpy(dst + ne * ts, src + ne * ts, (size_t)(n - ne * ts));
}

/* byte k of the result holds bit k of each byte of x, bit b from byte b
 * (an 8 x 8 bit transpose; its own inverse) */
static uint64_t transpose8x8(uint64_t x)
{
    uint64_t t;
    t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AAULL;
    x = x ^ t ^ (t << 7);
    t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCCULL;
    x = x ^ t ^ (t << 14);
    t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0ULL;
    x = x ^ t ^ (t << 28);
    return x;
}

/* c-blosc 1.x's bit shuffle of a block of n bytes: with ne = n / ts
 * elements a multiple of 8, bit b of byte j of element i goes to bit
 * i % 8 of byte (j * 8 + b) * ne / 8 + i / 8, and the n % ts tail bytes
 * are copied as they are; otherwise the whole block is copied as it
 * is. */
static void bitshuffle(int64_t ts, int64_t n, const uint8_t *src,
                       uint8_t *dst)
{
    int64_t ne = n / ts;
    if (ne % 8) {
        memcpy(dst, src, (size_t)n);
        return;
    }
    int64_t row = ne / 8;
    for (int64_t g = 0; g < row; ++g) {
        const uint8_t *e = src + g * 8 * ts;
        for (int64_t j = 0; j < ts; ++j) {
            uint64_t x = 0;
            for (int k = 0; k < 8; ++k)
                x |= (uint64_t)e[k * ts + j] << (8 * k);
            x = transpose8x8(x);
            for (int b = 0; b < 8; ++b)
                dst[(j * 8 + b) * row + g] = (uint8_t)(x >> (8 * b));
        }
    }
    memcpy(dst + ne * ts, src + ne * ts, (size_t)(n - ne * ts));
}

static void bitunshuffle(int64_t ts, int64_t n, const uint8_t *src,
                         uint8_t *dst)
{
    int64_t ne = n / ts;
    if (ne % 8) {
        memcpy(dst, src, (size_t)n);
        return;
    }
    int64_t row = ne / 8;
    for (int64_t g = 0; g < row; ++g) {
        uint8_t *e = dst + g * 8 * ts;
        for (int64_t j = 0; j < ts; ++j) {
            uint64_t x = 0;
            for (int b = 0; b < 8; ++b)
                x |= (uint64_t)src[(j * 8 + b) * row + g] << (8 * b);
            x = transpose8x8(x);
            for (int k = 0; k < 8; ++k)
                e[k * ts + j] = (uint8_t)(x >> (8 * k));
        }
    }
    memcpy(dst + ne * ts, src + ne * ts, (size_t)(n - ne * ts));
}

/* ---------------------------------------------------------- frame layer */

/* 'shuffle' -1 (auto): bit shuffle for 1-byte types, byte shuffle
 * otherwise; the header's shuffle flag for 0, 1, 2 */
static int resolve_shuffle(int shuffle, int64_t ts)
{
    return shuffle < 0 ? (ts == 1 ? 2 : 1) : shuffle;
}

/* c-blosc 1.x's split rule (BLOSC_FORWARD_COMPAT_SPLIT): every codec
 * but zstd splits a block into typesize streams when the type is at
 * most 16 bytes and the block holds at least 128 elements */
static int split_block(int cid, int64_t ts, int64_t blocksize)
{
    return cid != CID_ZSTD && ts <= BLOSC_MAX_SPLITS
           && blocksize / ts >= BLOSC_MIN_BUFFERSIZE;
}

/* c-blosc 1.x's compute_blocksize with no forced block size: L1 (32 KiB)
 * scaled by clevel, doubled for the high-compression-ratio codecs (LZ4HC,
 * zlib, zstd) and again at clevel 9 for them; a split block is then
 * multiplied by the type size within [64 KiB, 1 MiB]. */
static int64_t blosc_blocksize(int cid, int clevel, int64_t ts,
                               int64_t nbytes)
{
    static const int factor_x4[10] = {1, 2, 4, 8, 16, 16, 32, 32, 32, 32};
    const int hcr = cid == CID_LZ4HC || cid == CID_ZLIB || cid == CID_ZSTD;
    const int cl = clevel < 0 ? 0 : clevel > 9 ? 9 : clevel;
    if (nbytes < ts)
        return 1;
    int64_t bs = nbytes;
    if (nbytes >= BLOSC_L1) {
        bs = (int64_t)BLOSC_L1 * (hcr ? 2 : 1) * factor_x4[cl] / 4;
        if (cl == 9 && hcr)
            bs *= 2;
    }
    if (clevel > 0 && split_block(cid, ts, bs)) {
        if (bs > (1 << 18))
            bs = 1 << 18;
        bs *= ts;
        if (bs < (1 << 16))
            bs = 1 << 16;
        if (bs > (1 << 20))
            bs = 1 << 20;
    }
    if (bs > nbytes)
        bs = nbytes;
    if (bs > ts)
        bs = bs / ts * ts;
    return bs;
}

static void put_header(uint8_t *dest, int flags, int64_t ts, int64_t nbytes,
                       int64_t blocksize, int64_t cbytes)
{
    dest[0] = 2;          /* blosc format version */
    dest[1] = 1;          /* the codec's format version (1 for each) */
    dest[2] = (uint8_t)flags;
    dest[3] = (uint8_t)ts;
    write32(dest + 4, nbytes);
    write32(dest + 8, blocksize);
    write32(dest + 12, cbytes);
}

/* the frame's flags byte, block size and split rule */
static int frame_flags(int cid, int clevel, int shuffle, int64_t ts,
                       int64_t nbytes, int64_t *bs, int *split)
{
    int mode = resolve_shuffle(shuffle, ts);
    int flags = CODE_OF[cid] << 5;
    if (mode == 1)
        flags |= FLAG_SHUFFLE;
    else if (mode == 2)
        flags |= FLAG_BITSHUFFLE;
    *bs = blosc_blocksize(cid, clevel, ts, nbytes);
    *split = split_block(cid, ts, *bs);
    if (!*split)
        flags |= FLAG_DONT_SPLIT;
    return flags;
}

/* block src[0, bsize) as the codec sees it: shuffled into tmp (returned)
 * or src itself */
static const uint8_t *prepare_block(int flags, int64_t ts, int64_t bsize,
                                    const uint8_t *src, uint8_t *tmp)
{
    if ((flags & FLAG_SHUFFLE) && ts > 1) {
        shuffle(ts, bsize, src, tmp);
        return tmp;
    }
    if ((flags & FLAG_BITSHUFFLE) && bsize >= ts) {
        bitshuffle(ts, bsize, src, tmp);
        return tmp;
    }
    return src;
}

static int needs_unshuffle(int flags, int64_t ts, int64_t bsize)
{
    return ((flags & FLAG_SHUFFLE) && ts > 1)
           || ((flags & FLAG_BITSHUFFLE) && bsize >= ts);
}

static void finish_block(int flags, int64_t ts, int64_t bsize,
                         const uint8_t *tmp, uint8_t *dst)
{
    if (flags & FLAG_SHUFFLE)
        unshuffle(ts, bsize, tmp, dst);
    else
        bitunshuffle(ts, bsize, tmp, dst);
}

static int64_t stream_compress(int cid, const uint8_t *src, int64_t n,
                               uint8_t *dst, int64_t cap, int clevel,
                               int split)
{
    switch (cid) {
    case CID_BLOSCLZ:
        return blosclz_compress(src, n, dst, cap, clevel, split);
    case CID_LZ4:
        return lz4_compress_block(src, n, dst, cap, clevel);
    case CID_LZ4HC:
        return lz4hc_compress_block(src, n, dst, cap, clevel);
    case CID_SNAPPY:
        return snappy_compress(src, n, dst, cap, clevel);
    case CID_ZLIB:
        return zlib_compress(src, n, dst, cap, clevel);
    case CID_ZSTD:
        return zstd_compress(src, n, dst, cap, clevel);
    }
    return ERR_UNSUPPORTED;
}

static int64_t stream_decompress(int code, const uint8_t *src, int64_t n,
                                 uint8_t *dst, int64_t dstlen)
{
    switch (code) {
    case 0:
        return blosclz_decompress(src, n, dst, dstlen);
    case 1:
        return lz4_decompress_block(src, n, dst, dstlen);
    case 2:
        return snappy_decompress(src, n, dst, dstlen);
    case CODE_ZSTD:
        return zstd_decompress(src, n, dst, dstlen);
    }
    return ERR_UNSUPPORTED;
}

/* A blosc1 frame of src[0, nbytes) with codec cid into dest
 * (destsize >= nbytes + 16); returns its size or a negative error. A
 * frame that would exceed nbytes + 16 bytes, an input under 128 bytes or
 * clevel 0 gives a memcpyed frame. */
int64_t blosc_compress(int cid, int clevel, int shuffle, int64_t ts,
                       const uint8_t *src, int64_t nbytes, uint8_t *dest,
                       int64_t destsize)
{
    if (cid < 0 || cid >= CID_COUNT || clevel < 0 || clevel > 9
            || shuffle < -1 || shuffle > 2 || ts < 1 || ts > 255
            || nbytes < 0 || nbytes > 0x7fffffff - 16
            || destsize < nbytes + BLOSC_MAX_OVERHEAD)
        return ERR_ARGS;
    int64_t bs;
    int split;
    int flags = frame_flags(cid, clevel, shuffle, ts, nbytes, &bs, &split);
    int64_t nblocks = bs > 0 ? nbytes / bs : 0;
    int64_t leftover = bs > 0 ? nbytes % bs : 0;
    if (leftover)
        ++nblocks;
    const int64_t maxbytes = nbytes + BLOSC_MAX_OVERHEAD;
    int64_t pos = BLOSC_MAX_OVERHEAD + 4 * nblocks;
    int ok = nbytes >= BLOSC_MIN_BUFFERSIZE && clevel > 0 && pos <= maxbytes;
    int64_t rc = 0;
    uint8_t *tmp = NULL;
    if (ok && (flags & (FLAG_SHUFFLE | FLAG_BITSHUFFLE))) {
        tmp = (uint8_t *)malloc((size_t)bs);
        if (tmp == NULL)
            return ERR_NOMEM;
    }
    for (int64_t j = 0; ok && j < nblocks; ++j) {
        int last = j == nblocks - 1 && leftover;
        int64_t bsize = last ? leftover : bs;
        write32(dest + BLOSC_MAX_OVERHEAD + 4 * j, pos);
        const uint8_t *blk = prepare_block(flags, ts, bsize, src + j * bs,
                                           tmp);
        int64_t nsplits = split && !last ? ts : 1;
        int64_t neblock = bsize / nsplits;
        for (int64_t s = 0; ok && s < nsplits; ++s) {
            pos += 4;
            /* c-blosc gives snappy its worst case (which snappy refuses
             * once clipped to the frame's room); the others must fit in
             * the stream's size */
            int64_t maxout = cid == CID_SNAPPY
                             ? 32 + neblock + neblock / 6 : neblock;
            if (pos + maxout > maxbytes)
                maxout = maxbytes - pos;
            if (maxout <= 0) {
                ok = 0;
                break;
            }
            int64_t c = stream_compress(cid, blk + s * neblock, neblock,
                                        dest + pos, maxout, clevel, split);
            if (c < 0) {
                rc = c;
                ok = 0;
                break;
            }
            if (c == 0 || c == neblock) {
                /* stored as it is */
                if (pos + neblock > maxbytes) {
                    ok = 0;
                    break;
                }
                memcpy(dest + pos, blk + s * neblock, (size_t)neblock);
                c = neblock;
            }
            write32(dest + pos - 4, c);
            pos += c;
        }
    }
    free(tmp);
    if (rc < 0)
        return rc;
    if (!ok) {
        flags |= FLAG_MEMCPYED;
        memcpy(dest + BLOSC_MAX_OVERHEAD, src, (size_t)nbytes);
        pos = maxbytes;
    }
    put_header(dest, flags, ts, nbytes, bs, pos);
    return pos;
}

/* The header of a frame: checks what every decoder needs. */
static int64_t read_header(const uint8_t *src, int64_t srcsize,
                           int64_t destsize, int *flags, int64_t *ts,
                           int64_t *nbytes, int64_t *bs, int64_t *cbytes)
{
    if (srcsize < BLOSC_MAX_OVERHEAD)
        return ERR_CORRUPT;
    *flags = src[2];
    *ts = src[3];
    *nbytes = read_i32(src + 4);
    *bs = read_i32(src + 8);
    *cbytes = read_i32(src + 12);
    if (*nbytes < 0 || *nbytes > destsize || *cbytes > srcsize
            || *cbytes < BLOSC_MAX_OVERHEAD)
        return ERR_CORRUPT;
    return 0;
}

/* Decode a blosc1 frame (any codec but zlib, split or not, byte- or
 * bit-shuffled or not, memcpyed) into dest; returns its size, or a
 * negative error: ERR_UNSUPPORTED for compressor code 3 (zlib: decoded
 * through io/blosc.py) and 5-7. */
int64_t blosc_decompress(const uint8_t *src, int64_t srcsize, uint8_t *dest,
                         int64_t destsize)
{
    int flags;
    int64_t ts, nbytes, bs, cbytes;
    int64_t rc = read_header(src, srcsize, destsize, &flags, &ts, &nbytes,
                             &bs, &cbytes);
    if (rc < 0)
        return rc;
    if (flags & FLAG_MEMCPYED) {
        if (cbytes < nbytes + BLOSC_MAX_OVERHEAD)
            return ERR_CORRUPT;
        memcpy(dest, src + BLOSC_MAX_OVERHEAD, (size_t)nbytes);
        return nbytes;
    }
    const int code = flags >> 5;
    if (code == CODE_ZLIB || code > CODE_ZSTD)
        return ERR_UNSUPPORTED;
    if (nbytes == 0)
        return 0;
    if (bs <= 0 || ts < 1)
        return ERR_CORRUPT;
    int64_t nblocks = nbytes / bs, leftover = nbytes % bs;
    if (leftover)
        ++nblocks;
    if (BLOSC_MAX_OVERHEAD + 4 * nblocks > cbytes)
        return ERR_CORRUPT;
    int dont_split = flags & FLAG_DONT_SPLIT;
    uint8_t *tmp = NULL;
    if (flags & (FLAG_SHUFFLE | FLAG_BITSHUFFLE)) {
        tmp = (uint8_t *)malloc((size_t)bs);
        if (tmp == NULL)
            return ERR_NOMEM;
    }
    rc = nbytes;
    for (int64_t j = 0; j < nblocks && rc >= 0; ++j) {
        int last = j == nblocks - 1 && leftover;
        int64_t bsize = last ? leftover : bs;
        int64_t pos = read_i32(src + BLOSC_MAX_OVERHEAD + 4 * j);
        int unshuf = needs_unshuffle(flags, ts, bsize);
        uint8_t *out = unshuf ? tmp : dest + j * bs;
        int64_t nsplits = !dont_split && !last ? ts : 1;
        int64_t neblock = bsize / nsplits;
        if (neblock * nsplits != bsize) {
            rc = ERR_CORRUPT;
            break;
        }
        for (int64_t s = 0; s < nsplits; ++s) {
            if (pos < 0 || pos + 4 > cbytes) {
                rc = ERR_CORRUPT;
                break;
            }
            int64_t csize = read_i32(src + pos);
            pos += 4;
            if (csize <= 0 || csize > cbytes - pos) {
                rc = ERR_CORRUPT;
                break;
            }
            if (csize == neblock) {
                memcpy(out + s * neblock, src + pos, (size_t)neblock);
            } else if (stream_decompress(code, src + pos, csize,
                                         out + s * neblock,
                                         neblock) != neblock) {
                rc = ERR_CORRUPT;
                break;
            }
            pos += csize;
        }
        if (rc >= 0 && unshuf)
            finish_block(flags, ts, bsize, tmp, dest + j * bs);
    }
    free(tmp);
    return rc;
}

/* Blocks of src (as a frame with these flags, type size and block size
 * holds them) unshuffled into dest: the zlib frame's decode, after the
 * stdlib has inflated its streams. */
int64_t blosc_unshuffle_blocks(int flags, int64_t ts, int64_t bs,
                               const uint8_t *src, int64_t nbytes,
                               uint8_t *dest)
{
    if (ts < 1 || bs <= 0 || nbytes < 0)
        return ERR_ARGS;
    for (int64_t off = 0; off < nbytes; off += bs) {
        int64_t bsize = nbytes - off < bs ? nbytes - off : bs;
        if (needs_unshuffle(flags, ts, bsize))
            finish_block(flags, ts, bsize, src + off, dest + off);
        else
            memcpy(dest + off, src + off, (size_t)bsize);
    }
    return 0;
}

/* 1 when every byte of src[0, n) is zero. */
int all_zero(const uint8_t *src, int64_t n)
{
    int64_t i = 0;
    for (; i + 8 <= n; i += 8) {
        uint64_t v;
        memcpy(&v, src + i, 8);
        if (v)
            return 0;
    }
    for (; i < n; ++i)
        if (src[i])
            return 0;
    return 1;
}
