/* Blosc 1.x frame decoder for the benchmark's output check.
 *
 * A frozen copy of the decoders of image_stitcher_tpu_torch/csrc (LZ4
 * blocks from codec_lz4.h, Zstandard frames from codec_zstd.h; both held
 * byte-equal to liblz4 and libzstd there), so that the check reads the
 * program's chunk files with code of its own: the card's host has no
 * liblz4 or libzstd. The frame walker and the byte unshuffle below are
 * written here. Build: cc -O2 -shared -fPIC unblosc.c -o libunblosc.so
 * (stitchbench/unblosc.py builds it at first use).
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define ERR_ARGS -1
#define ERR_CORRUPT -2
#define ERR_UNSUPPORTED -3
#define ERR_NOMEM -4
#define MINMATCH 4

static uint32_t read32(const uint8_t *p)
{
    uint32_t v;
    memcpy(&v, p, 4);
    return v;
}

/* op[0, len) = the len bytes starting off bytes back (off >= 1) */
static void copy_match(uint8_t *op, int64_t off, int64_t len)
{
    const uint8_t *ref = op - off;
    for (int64_t done = 0; done < len;) {
        int64_t n = off + done < len - done ? off + done : len - done;
        memcpy(op + done, ref, (size_t)n);
        done += n;
    }
}

/* ---------------------------------------------- LZ4 (from codec_lz4.h) */
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
        copy_match(op, off, mlen);
        op += mlen;
    }
    return op == oend ? dstlen : ERR_CORRUPT;
}

/* ------------------------------------- Zstandard (from codec_zstd.h) */
#define ZSTD_MAGIC 0xFD2FB528u
#define ZSTD_BLOCK_MAX (128 * 1024)
#define ZSTD_MAX_LL 35
#define ZSTD_MAX_ML 52
#define ZSTD_MAX_OF 31
#define ZSTD_LL_LOG 9
#define ZSTD_ML_LOG 9
#define ZSTD_OF_LOG 8
#define HUF_MAX_BITS 11
#define HUF_WEIGHT_LOG 6

static const uint32_t LL_BASE[ZSTD_MAX_LL + 1] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 18, 20, 22,
    24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384,
    32768, 65536};
static const uint8_t LL_BITS[ZSTD_MAX_LL + 1] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
    2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
static const uint32_t ML_BASE[ZSTD_MAX_ML + 1] = {
    3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21,
    22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37, 39, 41, 43,
    47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387,
    32771, 65539};
static const uint8_t ML_BITS[ZSTD_MAX_ML + 1] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9,
    10, 11, 12, 13, 14, 15, 16};
static const int16_t LL_DEFAULT[ZSTD_MAX_LL + 1] = {
    4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2,
    2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
static const int16_t ML_DEFAULT[ZSTD_MAX_ML + 1] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    -1, -1, -1, -1, -1, -1, -1};
static const int16_t OF_DEFAULT[29] = {
    1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, -1, -1, -1, -1, -1};
#define LL_DEFAULT_LOG 6
#define ML_DEFAULT_LOG 6
#define OF_DEFAULT_LOG 5

static int highbit32(uint32_t v)
{
    return 31 - __builtin_clz(v);
}

/* ------------------------------------------------------------ bit I/O */

/* a backward bit stream (read from its last bit towards its first) */
typedef struct {
    const uint8_t *start;
    int64_t size;
    int64_t pos;     /* bits not yet read; negative once overread */
} bitin;

static uint64_t load_le(const uint8_t *p, int64_t avail)
{
    uint64_t v = 0;
    if (avail >= 8) {
        memcpy(&v, p, 8);
        return v;
    }
    for (int64_t k = 0; k < avail; ++k)
        v |= (uint64_t)p[k] << (8 * k);
    return v;
}

/* a backward stream's bits: its last byte holds the end mark */
static int bitin_init(bitin *b, const uint8_t *src, int64_t n)
{
    if (n < 1 || src[n - 1] == 0)
        return ERR_CORRUPT;
    b->start = src;
    b->size = n;
    b->pos = 8 * (n - 1) + highbit32(src[n - 1]);
    return 0;
}

/* the next nb (<= 56) bits as an integer, bits past the start reading as
 * zeros (pos goes negative) */
static uint64_t bitin_peek(const bitin *b, int nb)
{
    if (nb == 0)
        return 0;
    int64_t p = b->pos - nb;
    if (p >= 0) {
        int64_t byte = p >> 3;
        uint64_t v = load_le(b->start + byte, b->size - byte);
        return (v >> (p & 7)) & ((1ULL << nb) - 1);
    }
    if (b->pos <= 0)
        return 0;
    uint64_t v = load_le(b->start, b->size);
    return (v & ((1ULL << b->pos) - 1)) << (-p);
}

static uint64_t bitin_read(bitin *b, int nb)
{
    uint64_t v = bitin_peek(b, nb);
    b->pos -= nb;
    return v;
}

/* a forward bit stream, LSB first */
typedef struct {
    uint8_t *p, *end;
    uint64_t acc;
    int n;
    int overflow;
    int64_t bits;    /* bits added in all */
} bitout;

static void bitout_init(bitout *w, uint8_t *dst, int64_t cap)
{
    w->p = dst;
    w->end = dst + cap;
    w->acc = 0;
    w->n = 0;
    w->overflow = 0;
    w->bits = 0;
}

/* nb <= 32 bits of v; whole 32-bit words go out as they fill (the
 * stream's bytes are the same as one byte at a time) */
static void bitout_add(bitout *w, uint64_t v, int nb)
{
    w->acc |= (v & ((1ULL << nb) - 1)) << w->n;
    w->n += nb;
    w->bits += nb;
    if (w->n >= 32) {
        if (w->end - w->p >= 4) {
            uint32_t word = (uint32_t)w->acc;
            memcpy(w->p, &word, 4);
            w->p += 4;
        } else {
            w->overflow = 1;
        }
        w->acc >>= 32;
        w->n -= 32;
    }
}

/* the bytes still held, the last one partial; a backward stream adds
 * its end mark first */
static void bitout_flush(bitout *w)
{
    for (; w->n > 0; w->n -= 8) {
        if (w->p < w->end)
            *w->p++ = (uint8_t)w->acc;
        else
            w->overflow = 1;
        w->acc >>= 8;
    }
    w->acc = 0;
    w->n = 0;
}

/* ------------------------------------------------------------------ FSE */

typedef struct {
    uint16_t baseline;
    uint8_t nbits;
    uint8_t symbol;
} fse_cell;

typedef struct {
    int log;
    fse_cell cell[1 << ZSTD_LL_LOG];
} fse_dtable;

/* positions of each symbol in a table of 2^log cells, as FSE spreads
 * them; -1 (less than one) symbols take the top cells */
static int fse_spread(const int16_t *norm, int maxsym, int log,
                      uint8_t *symbol_at)
{
    const int size = 1 << log;
    int high = size - 1;
    for (int s = 0; s <= maxsym; ++s)
        if (norm[s] == -1)
            symbol_at[high--] = (uint8_t)s;
    int pos = 0;
    const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
    for (int s = 0; s <= maxsym; ++s)
        for (int i = 0; i < norm[s]; ++i) {
            symbol_at[pos] = (uint8_t)s;
            do
                pos = (pos + step) & mask;
            while (pos > high);
        }
    return pos == 0 ? 0 : ERR_CORRUPT;
}

static int fse_build_dtable(fse_dtable *t, const int16_t *norm, int maxsym,
                            int log)
{
    uint8_t symbol_at[1 << ZSTD_LL_LOG];
    uint16_t next[256];
    const int size = 1 << log;
    if (fse_spread(norm, maxsym, log, symbol_at) < 0)
        return ERR_CORRUPT;
    for (int s = 0; s <= maxsym; ++s)
        next[s] = (uint16_t)(norm[s] == -1 ? 1 : norm[s]);
    t->log = log;
    for (int u = 0; u < size; ++u) {
        int s = symbol_at[u];
        uint32_t x = next[s]++;
        int nb = log - highbit32(x);
        t->cell[u].symbol = (uint8_t)s;
        t->cell[u].nbits = (uint8_t)nb;
        t->cell[u].baseline = (uint16_t)((x << nb) - size);
    }
    return 0;
}

static void fse_rle_dtable(fse_dtable *t, int symbol)
{
    t->log = 0;
    t->cell[0].symbol = (uint8_t)symbol;
    t->cell[0].nbits = 0;
    t->cell[0].baseline = 0;
}

/* an FSE table description (RFC 8878 4.1.1) at src: normalized counts
 * into norm[0..maxsym] (zero past the last), the table log into *log;
 * returns the bytes read or ERR_CORRUPT */
static int64_t fse_read_ncount(const uint8_t *src, int64_t n, int16_t *norm,
                               int maxsym, int maxlog, int *log)
{
    int64_t bit = 0;
#define NC_PEEK(nb) ((int)((load_le(src + (bit >> 3), n - (bit >> 3)) \
                            >> (bit & 7)) & ((1u << (nb)) - 1)))
    if (n < 1)
        return ERR_CORRUPT;
    memset(norm, 0, sizeof(int16_t) * (size_t)(maxsym + 1));
    int tl = NC_PEEK(4) + 5;
    bit += 4;
    if (tl > maxlog)
        return ERR_CORRUPT;
    int remaining = (1 << tl) + 1, threshold = 1 << tl, nbits = tl + 1;
    int s = 0, prev0 = 0;
    while (remaining > 1 && s <= maxsym) {
        if (prev0) {
            int r;
            do {
                if ((bit >> 3) >= n)
                    return ERR_CORRUPT;
                r = NC_PEEK(2);
                bit += 2;
                s += r;
            } while (r == 3);
            if (s > maxsym)
                return ERR_CORRUPT;
        }
        if ((bit >> 3) >= n)
            return ERR_CORRUPT;
        int max = (2 * threshold - 1) - remaining;
        int count = NC_PEEK(nbits) ;
        if ((count & (threshold - 1)) < max) {
            count &= threshold - 1;
            bit += nbits - 1;
        } else {
            if (count >= threshold)
                count -= max;
            bit += nbits;
        }
        count -= 1;
        remaining -= count < 0 ? -count : count;
        norm[s++] = (int16_t)count;
        prev0 = count == 0;
        while (remaining < threshold) {
            nbits--;
            threshold >>= 1;
        }
    }
#undef NC_PEEK
    if (remaining != 1 || (bit + 7) >> 3 > n)
        return ERR_CORRUPT;
    *log = tl;
    return (bit + 7) >> 3;
}

/* ------------------------------------------------------------- Huffman */

typedef struct {
    int maxbits;              /* 0: no table yet */
    uint8_t symbol[1 << HUF_MAX_BITS];
    uint8_t nbits[1 << HUF_MAX_BITS];
} huf_dtable;

/* a Huffman tree description at src into t; the bytes read or an
 * error */
static int64_t huf_read_table(huf_dtable *t, const uint8_t *src, int64_t n)
{
    uint8_t w[256];
    int nw = 0;
    int64_t used;
    if (n < 1)
        return ERR_CORRUPT;
    int hb = src[0];
    if (hb >= 128) {
        nw = hb - 127;
        used = 1 + (nw + 1) / 2;
        if (used > n)
            return ERR_CORRUPT;
        for (int i = 0; i < nw; ++i)
            w[i] = (uint8_t)(i & 1 ? src[1 + i / 2] & 15 : src[1 + i / 2] >> 4);
    } else {
        int16_t norm[16];
        int log;
        used = 1 + hb;
        if (used > n)
            return ERR_CORRUPT;
        int64_t hsize = fse_read_ncount(src + 1, hb, norm, 15, HUF_WEIGHT_LOG,
                                        &log);
        if (hsize < 0)
            return hsize;
        fse_dtable *dt = (fse_dtable *)malloc(sizeof(fse_dtable));
        if (dt == NULL)
            return ERR_NOMEM;
        int maxsym = 15;
        while (maxsym > 0 && norm[maxsym] == 0)
            --maxsym;
        bitin b;
        if (fse_build_dtable(dt, norm, maxsym, log) < 0
                || bitin_init(&b, src + 1 + hsize, hb - hsize) < 0) {
            free(dt);
            return ERR_CORRUPT;
        }
        int s1 = (int)bitin_read(&b, log), s2 = (int)bitin_read(&b, log);
        for (;;) {
            if (nw > 253) {
                free(dt);
                return ERR_CORRUPT;
            }
            w[nw++] = dt->cell[s1].symbol;
            s1 = dt->cell[s1].baseline
                 + (int)bitin_read(&b, dt->cell[s1].nbits);
            if (b.pos < 0) {
                w[nw++] = dt->cell[s2].symbol;
                break;
            }
            w[nw++] = dt->cell[s2].symbol;
            s2 = dt->cell[s2].baseline
                 + (int)bitin_read(&b, dt->cell[s2].nbits);
            if (b.pos < 0) {
                w[nw++] = dt->cell[s1].symbol;
                break;
            }
        }
        free(dt);
    }
    /* the last symbol's weight completes the sum to a power of two */
    uint32_t sum = 0;
    for (int i = 0; i < nw; ++i) {
        if (w[i] > HUF_MAX_BITS)
            return ERR_CORRUPT;
        if (w[i])
            sum += 1u << (w[i] - 1);
    }
    if (sum == 0 || nw > 255)
        return ERR_CORRUPT;
    int maxbits = highbit32(sum) + 1;
    uint32_t rest = (1u << maxbits) - sum;
    if (maxbits > HUF_MAX_BITS || (rest & (rest - 1)))
        return ERR_CORRUPT;
    w[nw++] = (uint8_t)(highbit32(rest) + 1);
    uint32_t start[HUF_MAX_BITS + 2] = {0};
    uint32_t count[HUF_MAX_BITS + 2] = {0};
    for (int i = 0; i < nw; ++i)
        count[w[i]]++;
    uint32_t next = 0;
    for (int k = 1; k <= maxbits; ++k) {
        start[k] = next;
        next += count[k] << (k - 1);
    }
    for (int s = 0; s < nw; ++s) {
        if (!w[s])
            continue;
        uint32_t len = 1u << (w[s] - 1);
        for (uint32_t u = start[w[s]]; u < start[w[s]] + len; ++u) {
            t->symbol[u] = (uint8_t)s;
            t->nbits[u] = (uint8_t)(maxbits + 1 - w[s]);
        }
        start[w[s]] += len;
    }
    t->maxbits = maxbits;
    return used;
}

/* one Huffman stream of n bytes holding exactly count symbols */
static int huf_decode_stream(const huf_dtable *t, const uint8_t *src,
                             int64_t n, uint8_t *dst, int64_t count)
{
    bitin b;
    if (bitin_init(&b, src, n) < 0)
        return ERR_CORRUPT;
    const int mb = t->maxbits;
    for (int64_t i = 0; i < count; ++i) {
        int v = (int)bitin_peek(&b, mb);
        dst[i] = t->symbol[v];
        b.pos -= t->nbits[v];
        if (b.pos < 0)
            return ERR_CORRUPT;
    }
    return b.pos == 0 ? 0 : ERR_CORRUPT;
}

/* ------------------------------------------------------------- decoder */

typedef struct {
    uint32_t rep[3];
    huf_dtable huf;
    fse_dtable ll, of, ml;
    int have_ll, have_of, have_ml;
} zstd_dstate;

static int64_t zstd_read_literals(zstd_dstate *st, const uint8_t *src,
                                  int64_t n, uint8_t *lit, int64_t litcap,
                                  int64_t *nlit, const uint8_t **litp)
{
    if (n < 1)
        return ERR_CORRUPT;
    int type = src[0] & 3, sf = (src[0] >> 2) & 3;
    if (type < 2) {
        int64_t regen, hs;
        if (sf == 0 || sf == 2) {
            regen = src[0] >> 3;
            hs = 1;
        } else if (sf == 1) {
            if (n < 2)
                return ERR_CORRUPT;
            regen = (src[0] >> 4) + ((int64_t)src[1] << 4);
            hs = 2;
        } else {
            if (n < 3)
                return ERR_CORRUPT;
            regen = (src[0] >> 4) + ((int64_t)src[1] << 4)
                    + ((int64_t)src[2] << 12);
            hs = 3;
        }
        if (regen > litcap)
            return ERR_CORRUPT;
        *nlit = regen;
        if (type == 0) {
            if (hs + regen > n)
                return ERR_CORRUPT;
            *litp = src + hs;
            return hs + regen;
        }
        if (hs + 1 > n)
            return ERR_CORRUPT;
        memset(lit, src[hs], (size_t)regen);
        *litp = lit;
        return hs + 1;
    }
    int hs = sf < 2 ? 3 : sf == 2 ? 4 : 5;
    int bits = sf < 2 ? 10 : sf == 2 ? 14 : 18;
    if (n < hs)
        return ERR_CORRUPT;
    uint64_t h = load_le(src, hs);
    int64_t regen = (int64_t)((h >> 4) & ((1u << bits) - 1));
    int64_t csize = (int64_t)((h >> (4 + bits)) & ((1u << bits) - 1));
    if (regen > litcap || hs + csize > n)
        return ERR_CORRUPT;
    const uint8_t *p = src + hs;
    int64_t left = csize;
    if (type == 2) {
        int64_t used = huf_read_table(&st->huf, p, left);
        if (used < 0)
            return used;
        p += used;
        left -= used;
    } else if (!st->huf.maxbits) {
        return ERR_CORRUPT;
    }
    if (sf == 0) {
        if (huf_decode_stream(&st->huf, p, left, lit, regen) < 0)
            return ERR_CORRUPT;
    } else {
        if (left < 6)
            return ERR_CORRUPT;
        int64_t sz[4];
        sz[0] = p[0] | (p[1] << 8);
        sz[1] = p[2] | (p[3] << 8);
        sz[2] = p[4] | (p[5] << 8);
        sz[3] = left - 6 - sz[0] - sz[1] - sz[2];
        if (sz[3] < 0)
            return ERR_CORRUPT;
        int64_t seg = (regen + 3) / 4;
        if (3 * seg > regen)
            return ERR_CORRUPT;
        p += 6;
        for (int k = 0; k < 4; ++k) {
            int64_t cnt = k < 3 ? seg : regen - 3 * seg;
            if (huf_decode_stream(&st->huf, p, sz[k], lit + k * seg, cnt) < 0)
                return ERR_CORRUPT;
            p += sz[k];
        }
    }
    *nlit = regen;
    *litp = lit;
    return hs + csize;
}

/* the table of one sequence field by its mode; the bytes read */
static int64_t zstd_seq_table(fse_dtable *t, int *have, int mode,
                              const uint8_t *src, int64_t n,
                              const int16_t *defnorm, int defmax, int deflog,
                              int maxsym, int maxlog)
{
    if (mode == 0) {
        *have = 1;
        return fse_build_dtable(t, defnorm, defmax, deflog) < 0
               ? ERR_CORRUPT : 0;
    }
    if (mode == 1) {
        if (n < 1 || src[0] > maxsym)
            return ERR_CORRUPT;
        fse_rle_dtable(t, src[0]);
        *have = 1;
        return 1;
    }
    if (mode == 3)
        return *have ? 0 : ERR_CORRUPT;
    int16_t norm[ZSTD_MAX_ML + 1];
    int log;
    int64_t used = fse_read_ncount(src, n, norm, maxsym, maxlog, &log);
    if (used < 0)
        return used;
    int top = maxsym;
    while (top > 0 && norm[top] == 0)
        --top;
    if (fse_build_dtable(t, norm, top, log) < 0)
        return ERR_CORRUPT;
    *have = 1;
    return used;
}

/* one compressed block of n bytes into op (at most oend), the frame
 * starting at base; the bytes written or an error */
static int64_t zstd_block(zstd_dstate *st, const uint8_t *src, int64_t n,
                          uint8_t *base, uint8_t *op, uint8_t *oend,
                          uint8_t *litbuf, int64_t litcap)
{
    int64_t nlit;
    const uint8_t *lit;
    int64_t used = zstd_read_literals(st, src, n, litbuf, litcap, &nlit,
                                      &lit);
    if (used < 0)
        return used;
    const uint8_t *ip = src + used, *iend = src + n;
    if (ip >= iend)
        return ERR_CORRUPT;
    int64_t nseq = *ip++;
    if (nseq >= 128) {
        if (nseq == 255) {
            if (iend - ip < 2)
                return ERR_CORRUPT;
            nseq = ip[0] + ((int64_t)ip[1] << 8) + 0x7F00;
            ip += 2;
        } else {
            if (iend - ip < 1)
                return ERR_CORRUPT;
            nseq = ((nseq - 128) << 8) + *ip++;
        }
    }
    uint8_t *const ostart = op;
    if (nseq > 0) {
        if (ip >= iend)
            return ERR_CORRUPT;
        int modes = *ip++;
        if (modes & 3)
            return ERR_CORRUPT;
        int64_t r;
        r = zstd_seq_table(&st->ll, &st->have_ll, modes >> 6, ip, iend - ip,
                           LL_DEFAULT, ZSTD_MAX_LL, LL_DEFAULT_LOG,
                           ZSTD_MAX_LL, ZSTD_LL_LOG);
        if (r < 0)
            return r;
        ip += r;
        r = zstd_seq_table(&st->of, &st->have_of, (modes >> 4) & 3, ip,
                           iend - ip, OF_DEFAULT, 28, OF_DEFAULT_LOG,
                           ZSTD_MAX_OF, ZSTD_OF_LOG);
        if (r < 0)
            return r;
        ip += r;
        r = zstd_seq_table(&st->ml, &st->have_ml, (modes >> 2) & 3, ip,
                           iend - ip, ML_DEFAULT, ZSTD_MAX_ML, ML_DEFAULT_LOG,
                           ZSTD_MAX_ML, ZSTD_ML_LOG);
        if (r < 0)
            return r;
        ip += r;
        bitin b;
        if (bitin_init(&b, ip, iend - ip) < 0)
            return ERR_CORRUPT;
        int sll = (int)bitin_read(&b, st->ll.log);
        int sof = (int)bitin_read(&b, st->of.log);
        int sml = (int)bitin_read(&b, st->ml.log);
        const uint8_t *lp = lit, *lend = lit + nlit;
        for (int64_t i = 0; i < nseq; ++i) {
            int llc = st->ll.cell[sll].symbol, mlc = st->ml.cell[sml].symbol;
            int ofc = st->of.cell[sof].symbol;
            if (llc > ZSTD_MAX_LL || mlc > ZSTD_MAX_ML || ofc > ZSTD_MAX_OF)
                return ERR_CORRUPT;
            uint64_t ofv = (1ULL << ofc) + bitin_read(&b, ofc);
            int64_t ml = ML_BASE[mlc] + (int64_t)bitin_read(&b, ML_BITS[mlc]);
            int64_t ll = LL_BASE[llc] + (int64_t)bitin_read(&b, LL_BITS[llc]);
            uint64_t off;
            if (ofv > 3) {
                off = ofv - 3;
                st->rep[2] = st->rep[1];
                st->rep[1] = st->rep[0];
                st->rep[0] = (uint32_t)off;
            } else {
                int idx = (int)ofv - 1 + (ll == 0);
                if (idx == 0) {
                    off = st->rep[0];
                } else {
                    off = idx == 3 ? st->rep[0] - 1 : st->rep[idx];
                    if (idx != 1)
                        st->rep[2] = st->rep[1];
                    st->rep[1] = st->rep[0];
                    st->rep[0] = (uint32_t)off;
                }
            }
            if (ll > lend - lp || ll + ml > oend - op)
                return ERR_CORRUPT;
            memcpy(op, lp, (size_t)ll);
            op += ll;
            lp += ll;
            if (off == 0 || off > (uint64_t)(op - base))
                return ERR_CORRUPT;
            copy_match(op, (int64_t)off, ml);
            op += ml;
            if (i + 1 < nseq) {
                sll = st->ll.cell[sll].baseline
                      + (int)bitin_read(&b, st->ll.cell[sll].nbits);
                sml = st->ml.cell[sml].baseline
                      + (int)bitin_read(&b, st->ml.cell[sml].nbits);
                sof = st->of.cell[sof].baseline
                      + (int)bitin_read(&b, st->of.cell[sof].nbits);
            }
            if (b.pos < 0)
                return ERR_CORRUPT;
        }
        if (b.pos != 0)
            return ERR_CORRUPT;
        nlit = lend - lp;
        lit = lp;
    } else if (ip != iend) {
        return ERR_CORRUPT;
    }
    if (nlit > oend - op)
        return ERR_CORRUPT;
    memcpy(op, lit, (size_t)nlit);
    op += nlit;
    if (op - ostart > ZSTD_BLOCK_MAX)
        return ERR_CORRUPT;
    return op - ostart;
}

/* Decode the zstd frames (and skip the skippable frames) of src[0, n)
 * into dst (at most cap bytes): the bytes written, or an error. */
int64_t zstd_decompress(const uint8_t *src, int64_t n, uint8_t *dst,
                        int64_t cap)
{
    const uint8_t *ip = src, *iend = src + n;
    uint8_t *op = dst, *oend = dst + cap;
    if (n < 4)
        return ERR_CORRUPT;
    zstd_dstate *st = (zstd_dstate *)malloc(sizeof(zstd_dstate));
    /* a block's literals are at most the bytes it regenerates */
    const int64_t litcap = cap < ZSTD_BLOCK_MAX ? cap : ZSTD_BLOCK_MAX;
    uint8_t *litbuf = (uint8_t *)malloc((size_t)litcap + 1);
    int64_t rc = 0;
    if (st == NULL || litbuf == NULL) {
        rc = ERR_NOMEM;
        goto done;
    }
    while (ip < iend) {
        if (iend - ip < 4) {
            rc = ERR_CORRUPT;
            goto done;
        }
        uint32_t magic = read32(ip);
        ip += 4;
        if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
            if (iend - ip < 4 || read32(ip) > (uint64_t)(iend - ip - 4)) {
                rc = ERR_CORRUPT;
                goto done;
            }
            ip += 4 + read32(ip);
            continue;
        }
        if (magic != ZSTD_MAGIC || ip >= iend) {
            rc = ERR_CORRUPT;
            goto done;
        }
        int fhd = *ip++;
        int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1;
        int dict_flag = fhd & 3;
        if (fhd & 0x08) {
            rc = ERR_CORRUPT;
            goto done;
        }
        int64_t hlen = (single ? 0 : 1) + (dict_flag == 3 ? 4 : dict_flag)
                       + (fcs_flag == 0 ? single : 1 << fcs_flag);
        if (iend - ip < hlen) {
            rc = ERR_CORRUPT;
            goto done;
        }
        if (!single)
            ++ip;    /* the window descriptor: the whole output is kept */
        int dn = dict_flag == 3 ? 4 : dict_flag;
        uint64_t dict = load_le(ip, dn) & (dn ? (~0ULL >> (64 - 8 * dn)) : 0);
        ip += dn;
        if (dict) {
            rc = ERR_UNSUPPORTED;
            goto done;
        }
        int fn = fcs_flag == 0 ? single : 1 << fcs_flag;
        int64_t fcs = -1;
        if (fn) {
            uint64_t v = load_le(ip, fn);
            if (fn < 8)
                v &= ~0ULL >> (64 - 8 * fn);
            fcs = (int64_t)(fn == 2 ? v + 256 : v);
            ip += fn;
        }
        memset(st, 0, sizeof(*st));
        st->rep[0] = 1;
        st->rep[1] = 4;
        st->rep[2] = 8;
        uint8_t *base = op;
        for (;;) {
            if (iend - ip < 3) {
                rc = ERR_CORRUPT;
                goto done;
            }
            uint32_t bh = ip[0] | (ip[1] << 8) | ((uint32_t)ip[2] << 16);
            ip += 3;
            int last = bh & 1, btype = (bh >> 1) & 3;
            int64_t bsize = bh >> 3;
            if (btype == 0) {
                if (bsize > iend - ip || bsize > oend - op) {
                    rc = ERR_CORRUPT;
                    goto done;
                }
                memcpy(op, ip, (size_t)bsize);
                op += bsize;
                ip += bsize;
            } else if (btype == 1) {
                if (ip >= iend || bsize > oend - op) {
                    rc = ERR_CORRUPT;
                    goto done;
                }
                memset(op, *ip++, (size_t)bsize);
                op += bsize;
            } else if (btype == 2) {
                if (bsize > iend - ip || bsize > ZSTD_BLOCK_MAX) {
                    rc = ERR_CORRUPT;
                    goto done;
                }
                int64_t got = zstd_block(st, ip, bsize, base, op, oend,
                                         litbuf, litcap);
                if (got < 0) {
                    rc = got;
                    goto done;
                }
                op += got;
                ip += bsize;
            } else {
                rc = ERR_CORRUPT;
                goto done;
            }
            if (last)
                break;
        }
        if (fcs >= 0 && op - base != fcs) {
            rc = ERR_CORRUPT;
            goto done;
        }
        if (fhd & 0x04) {
            if (iend - ip < 4) {
                rc = ERR_CORRUPT;
                goto done;
            }
            ip += 4;    /* the content checksum, not verified */
        }
    }
    rc = op - dst;
done:
    free(st);
    free(litbuf);
    return rc;
}

/* ------------------------------------------------------------- encoder */


/* ------------------------------------------------------ the blosc frame */

/* Decode one blosc 1.x frame of srcsize bytes into dest (destsize bytes,
 * the frame's nbytes): the bytes written, or an error. Codes 1 (lz4,
 * lz4hc) and 4 (zstd); byte shuffle or none; split or unsplit blocks. */
int64_t unblosc(const uint8_t *src, int64_t srcsize, uint8_t *dest,
                int64_t destsize)
{
    if (srcsize < 16)
        return ERR_CORRUPT;
    int flags = src[2], ts = src[3];
    int64_t nbytes = read32(src + 4), bs = read32(src + 8);
    int64_t cbytes = read32(src + 12);
    if (nbytes != destsize || cbytes > srcsize || ts < 1)
        return ERR_ARGS;
    if (flags & 0x02) {                   /* memcpyed */
        if (16 + nbytes > srcsize)
            return ERR_CORRUPT;
        memcpy(dest, src + 16, (size_t)nbytes);
        return nbytes;
    }
    if (flags & 0x04)
        return ERR_UNSUPPORTED;           /* bit shuffle */
    int code = flags >> 5;
    if (code != 1 && code != 4)
        return ERR_UNSUPPORTED;
    if (bs <= 0)
        return ERR_CORRUPT;
    int64_t nblocks = (nbytes + bs - 1) / bs;
    if (16 + 4 * nblocks > srcsize)
        return ERR_CORRUPT;
    uint8_t *tmp = (uint8_t *)malloc((size_t)bs);
    if (tmp == NULL)
        return ERR_NOMEM;
    int64_t rc = nbytes;
    for (int64_t b = 0; b < nblocks && rc >= 0; ++b) {
        int64_t bsize = b == nblocks - 1 ? nbytes - b * bs : bs;
        int64_t pos = read32(src + 16 + 4 * b);
        int last = b == nblocks - 1 && (nbytes % bs) != 0;
        int shuffled = (flags & 0x01) && ts > 1;
        /* c-blosc splits a whole block into one stream per byte of the
         * element unless the frame says it does not */
        int nstreams = !(flags & 0x10) && !last ? ts : 1;
        int64_t slen = bsize / nstreams;
        if (slen * nstreams != bsize) {
            rc = ERR_CORRUPT;
            break;
        }
        uint8_t *out = shuffled ? tmp : dest + b * bs;
        for (int s = 0; s < nstreams; ++s) {
            if (pos + 4 > srcsize) {
                rc = ERR_CORRUPT;
                break;
            }
            int64_t csize = (int32_t)read32(src + pos);
            pos += 4;
            if (csize < 0 || pos + csize > srcsize) {
                rc = ERR_CORRUPT;
                break;
            }
            if (csize == slen) {
                memcpy(out + s * slen, src + pos, (size_t)slen);
            } else {
                int64_t got = code == 1
                    ? lz4_decompress_block(src + pos, csize, out + s * slen,
                                           slen)
                    : zstd_decompress(src + pos, csize, out + s * slen,
                                      slen);
                if (got != slen) {
                    rc = got < 0 ? got : ERR_CORRUPT;
                    break;
                }
            }
            pos += csize;
        }
        if (rc >= 0 && shuffled) {
            /* byte unshuffle: stream k holds byte k of every element */
            int64_t n = bsize / ts;
            uint8_t *dst = dest + b * bs;
            for (int k = 0; k < ts; ++k)
                for (int64_t i = 0; i < n; ++i)
                    dst[i * ts + k] = tmp[k * n + i];
            memcpy(dst + n * ts, tmp + n * ts, (size_t)(bsize - n * ts));
        }
    }
    free(tmp);
    return rc;
}
