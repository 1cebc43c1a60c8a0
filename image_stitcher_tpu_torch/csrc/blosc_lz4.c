/* Blosc1 frames with LZ4 blocks, byte shuffle, written by hand.
 *
 * The host-side codec of the port's compressed zarr chunks, the
 * counterpart of the c-blosc that tensorstore links (zarr v2
 * {"id": "blosc", "cname": "lz4"}, and the zarr v3 "blosc" codec inside
 * shards). Built at first use with the system C compiler and bound with
 * ctypes (image_stitcher_tpu_torch/native, io/blosc.py); every function
 * is reentrant and touches no Python object, so ctypes calls run with
 * the interpreter lock released, one chunk per thread.
 *
 * io/blosc.py holds the plain version of every function here and
 * documents the format; the two produce byte-equal frames. The matcher
 * rules that make them equal:
 *   - a 4-byte little-endian sequence at ip hashes to
 *     (seq * 2654435761 mod 2^32) >> 20, a 4096-entry table of the last
 *     position with that hash, empty (-1) at the start of each block;
 *   - a position may start a match only if ip <= n - 12 (and never in
 *     a block shorter than 13 bytes); a match extends while bytes agree,
 *     up to n - 5, so the last 5 bytes are always literals;
 *   - a candidate is taken when its 4 bytes equal ip's and ip - ref is at
 *     most 65535; no backward extension;
 *   - after a miss ip advances by (search >> 6), search += 1, where
 *     search starts at accel << 6 and is reset after every match;
 *     accel = 10 - clevel (at least 1), as c-blosc sets it for LZ4;
 *   - after a match of length L ending at e, position e - 2 is entered
 *     in the table, and the search goes on at e.
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
#define LZ4_CODE 1

#define HASH_LOG 12
#define MINMATCH 4
#define MFLIMIT 12
#define LASTLITERALS 5
#define SKIP_TRIGGER 6
#define MAX_DISTANCE 65535

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

static uint32_t hash4(uint32_t seq)
{
    return (seq * 2654435761u) >> (32 - HASH_LOG);
}

static void write32(uint8_t *p, int64_t v)
{
    uint32_t u = (uint32_t)v;
    memcpy(p, &u, 4);
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

static int64_t length_bytes(int64_t len)
{
    return len >= 15 ? (len - 15) / 255 + 1 : 0;
}

static uint8_t *put_length(uint8_t *op, int64_t len)
{
    len -= 15;
    while (len >= 255) {
        *op++ = 255;
        len -= 255;
    }
    *op++ = (uint8_t)len;
    return op;
}

/* One sequence: literals, then (mlen > 0) a match at offset. NULL when
 * it does not fit before oend. */
static uint8_t *emit(uint8_t *op, const uint8_t *oend, const uint8_t *lit,
                     int64_t litlen, int64_t offset, int64_t mlen)
{
    int64_t need = 1 + length_bytes(litlen) + litlen;
    if (mlen > 0)
        need += 2 + length_bytes(mlen - MINMATCH);
    if (need > oend - op)
        return NULL;
    uint8_t *token = op++;
    *token = (uint8_t)((litlen >= 15 ? 15 : litlen) << 4);
    if (litlen >= 15)
        op = put_length(op, litlen);
    memcpy(op, lit, (size_t)litlen);
    op += litlen;
    if (mlen > 0) {
        int64_t m = mlen - MINMATCH;
        *op++ = (uint8_t)(offset & 0xff);
        *op++ = (uint8_t)(offset >> 8);
        *token |= (uint8_t)(m >= 15 ? 15 : m);
        if (m >= 15)
            op = put_length(op, m);
    }
    return op;
}

/* An LZ4 block of src[0, n) into dst; its size, or 0 when it would
 * exceed cap bytes. */
int64_t lz4_compress_block(const uint8_t *src, int64_t n, uint8_t *dst,
                           int64_t cap, int accel)
{
    int32_t table[1 << HASH_LOG];
    uint8_t *op = dst;
    const uint8_t *oend = dst + cap;
    int64_t anchor = 0, ip = 0;
    if (accel < 1)
        accel = 1;
    if (n >= MFLIMIT + 1) {
        const int64_t mflimit = n - MFLIMIT;
        const uint8_t *matchlimit = src + n - LASTLITERALS;
        uint32_t search = (uint32_t)accel << SKIP_TRIGGER;
        for (int i = 0; i < (1 << HASH_LOG); ++i)
            table[i] = -1;
        while (ip <= mflimit) {
            uint32_t seq = read32(src + ip);
            uint32_t h = hash4(seq);
            int64_t ref = table[h];
            table[h] = (int32_t)ip;
            if (ref >= 0 && ip - ref <= MAX_DISTANCE
                    && read32(src + ref) == seq) {
                int64_t len = MINMATCH + common_len(src + ip + MINMATCH,
                                                    src + ref + MINMATCH,
                                                    matchlimit);
                op = emit(op, oend, src + anchor, ip - anchor, ip - ref, len);
                if (op == NULL)
                    return 0;
                ip += len;
                anchor = ip;
                table[hash4(read32(src + ip - 2))] = (int32_t)(ip - 2);
                search = (uint32_t)accel << SKIP_TRIGGER;
            } else {
                ip += search++ >> SKIP_TRIGGER;
            }
        }
    }
    op = emit(op, oend, src + anchor, n - anchor, 0, 0);
    if (op == NULL)
        return 0;
    return op - dst;
}

/* Decode one LZ4 block of srclen bytes into exactly dstlen bytes (any
 * valid block, overlapping matches included). dstlen, or ERR_CORRUPT. */
int64_t lz4_decompress_block(const uint8_t *src, int64_t srclen,
                             uint8_t *dst, int64_t dstlen)
{
    const uint8_t *ip = src, *iend = src + srclen;
    uint8_t *op = dst, *oend = dst + dstlen;
    for (;;) {
        if (ip >= iend)
            return ERR_CORRUPT;
        unsigned token = *ip++;
        int64_t lit = token >> 4;
        if (lit == 15) {
            unsigned b;
            do {
                if (ip >= iend)
                    return ERR_CORRUPT;
                b = *ip++;
                lit += b;
            } while (b == 255);
        }
        if (lit > iend - ip || lit > oend - op)
            return ERR_CORRUPT;
        memcpy(op, ip, (size_t)lit);
        op += lit;
        ip += lit;
        if (ip == iend)
            break;
        if (iend - ip < 2)
            return ERR_CORRUPT;
        int64_t off = ip[0] | ((int64_t)ip[1] << 8);
        ip += 2;
        if (off == 0 || off > op - dst)
            return ERR_CORRUPT;
        int64_t mlen = token & 15;
        if (mlen == 15) {
            unsigned b;
            do {
                if (ip >= iend)
                    return ERR_CORRUPT;
                b = *ip++;
                mlen += b;
            } while (b == 255);
        }
        mlen += MINMATCH;
        if (mlen > oend - op)
            return ERR_CORRUPT;
        /* the match repeats the last off bytes: copy what is already
         * written, doubling, so source and destination never overlap */
        const uint8_t *ref = op - off;
        for (int64_t done = 0; done < mlen;) {
            int64_t n = off + done < mlen - done ? off + done : mlen - done;
            memcpy(op + done, ref, (size_t)n);
            done += n;
        }
        op += mlen;
    }
    return op == oend ? dstlen : ERR_CORRUPT;
}

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

static int split_block(int64_t ts, int64_t blocksize)
{
    return ts <= BLOSC_MAX_SPLITS && blocksize / ts >= BLOSC_MIN_BUFFERSIZE;
}

/* c-blosc 1.x's compute_blocksize for LZ4 (not a high-compression-ratio
 * codec) with no forced block size. */
static int64_t blosc_blocksize(int clevel, int64_t ts, int64_t nbytes)
{
    static const int factor_x4[10] = {1, 2, 4, 8, 16, 16, 32, 32, 32, 32};
    if (nbytes < ts)
        return 1;
    int64_t bs = nbytes;
    if (nbytes >= BLOSC_L1)
        bs = (int64_t)BLOSC_L1 * factor_x4[clevel < 0 ? 0 : clevel > 9 ? 9
                                           : clevel] / 4;
    if (clevel > 0 && split_block(ts, bs)) {
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
    dest[1] = 1;          /* LZ4 format version */
    dest[2] = (uint8_t)flags;
    dest[3] = (uint8_t)ts;
    write32(dest + 4, nbytes);
    write32(dest + 8, blocksize);
    write32(dest + 12, cbytes);
}

/* A blosc1 LZ4 frame of src[0, nbytes) into dest (destsize >= nbytes +
 * 16); returns its size. A frame that would exceed nbytes + 16 bytes, an
 * input under 128 bytes or clevel 0 gives a memcpyed frame. */
int64_t blosc_lz4_compress(int clevel, int doshuffle, int64_t ts,
                           const uint8_t *src, int64_t nbytes,
                           uint8_t *dest, int64_t destsize)
{
    if (ts < 1 || ts > 255 || nbytes < 0 || nbytes > 0x7fffffff - 16
            || destsize < nbytes + BLOSC_MAX_OVERHEAD)
        return ERR_ARGS;
    int flags = LZ4_CODE << 5;
    if (doshuffle)
        flags |= FLAG_SHUFFLE;
    int64_t bs = blosc_blocksize(clevel, ts, nbytes);
    int split = split_block(ts, bs);
    if (!split)
        flags |= FLAG_DONT_SPLIT;
    int64_t nblocks = bs > 0 ? nbytes / bs : 0;
    int64_t leftover = bs > 0 ? nbytes % bs : 0;
    if (leftover)
        ++nblocks;
    const int64_t maxbytes = nbytes + BLOSC_MAX_OVERHEAD;
    int64_t pos = BLOSC_MAX_OVERHEAD + 4 * nblocks;
    int ok = nbytes >= BLOSC_MIN_BUFFERSIZE && clevel > 0 && pos <= maxbytes;
    uint8_t *tmp = NULL;
    if (ok && doshuffle && ts > 1) {
        tmp = (uint8_t *)malloc((size_t)bs);
        if (tmp == NULL)
            return ERR_NOMEM;
    }
    int accel = 10 - clevel;
    for (int64_t j = 0; ok && j < nblocks; ++j) {
        int last = j == nblocks - 1 && leftover;
        int64_t bsize = last ? leftover : bs;
        const uint8_t *blk = src + j * bs;
        write32(dest + BLOSC_MAX_OVERHEAD + 4 * j, pos);
        if (tmp != NULL) {
            shuffle(ts, bsize, blk, tmp);
            blk = tmp;
        }
        int64_t nsplits = split && !last ? ts : 1;
        int64_t neblock = bsize / nsplits;
        for (int64_t s = 0; ok && s < nsplits; ++s) {
            pos += 4;
            int64_t maxout = neblock;
            if (pos + maxout > maxbytes)
                maxout = maxbytes - pos;
            if (maxout <= 0) {
                ok = 0;
                break;
            }
            int64_t c = lz4_compress_block(blk + s * neblock, neblock,
                                           dest + pos, maxout, accel);
            if (c == 0 || c >= neblock) {
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
    if (!ok) {
        flags |= FLAG_MEMCPYED;
        memcpy(dest + BLOSC_MAX_OVERHEAD, src, (size_t)nbytes);
        pos = maxbytes;
    }
    put_header(dest, flags, ts, nbytes, bs, pos);
    return pos;
}

static int64_t read_i32(const uint8_t *p)
{
    int32_t v;
    memcpy(&v, p, 4);
    return v;
}

/* Decode a blosc1 frame (LZ4 blocks, split or not, shuffled or not,
 * memcpyed) into dest; returns its size, or a negative error. */
int64_t blosc_lz4_decompress(const uint8_t *src, int64_t srcsize,
                             uint8_t *dest, int64_t destsize)
{
    if (srcsize < BLOSC_MAX_OVERHEAD)
        return ERR_CORRUPT;
    int flags = src[2];
    int64_t ts = src[3];
    int64_t nbytes = read_i32(src + 4);
    int64_t bs = read_i32(src + 8);
    int64_t cbytes = read_i32(src + 12);
    if (nbytes < 0 || nbytes > destsize || cbytes > srcsize
            || cbytes < BLOSC_MAX_OVERHEAD)
        return ERR_CORRUPT;
    if (flags & FLAG_MEMCPYED) {
        if (cbytes < nbytes + BLOSC_MAX_OVERHEAD)
            return ERR_CORRUPT;
        memcpy(dest, src + BLOSC_MAX_OVERHEAD, (size_t)nbytes);
        return nbytes;
    }
    if ((flags & FLAG_BITSHUFFLE) || (flags >> 5) != LZ4_CODE)
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
    int doshuffle = (flags & FLAG_SHUFFLE) && ts > 1;
    int dont_split = flags & FLAG_DONT_SPLIT;
    uint8_t *tmp = NULL;
    if (doshuffle) {
        tmp = (uint8_t *)malloc((size_t)bs);
        if (tmp == NULL)
            return ERR_NOMEM;
    }
    int64_t rc = nbytes;
    for (int64_t j = 0; j < nblocks && rc >= 0; ++j) {
        int last = j == nblocks - 1 && leftover;
        int64_t bsize = last ? leftover : bs;
        int64_t pos = read_i32(src + BLOSC_MAX_OVERHEAD + 4 * j);
        uint8_t *out = doshuffle ? tmp : dest + j * bs;
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
            } else if (lz4_decompress_block(src + pos, csize,
                                            out + s * neblock,
                                            neblock) != neblock) {
                rc = ERR_CORRUPT;
                break;
            }
            pos += csize;
        }
        if (rc >= 0 && doshuffle)
            unshuffle(ts, bsize, tmp, dest + j * bs);
    }
    free(tmp);
    return rc;
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
