/* Zstandard frames (RFC 8878) for blosc code 4, included by blosc.c.
 *
 * The decoder reads any valid frame: concatenated and skippable frames,
 * a frame header with or without a content size and with a window
 * descriptor, raw, RLE and compressed blocks, raw, RLE, Huffman and
 * treeless literals in 1 or 4 streams with weights FSE-coded or direct,
 * sequences in predefined, RLE, FSE and repeat modes, and repeat offsets
 * carried across the blocks of a frame. A content checksum is skipped,
 * not verified; a frame that names a dictionary is refused.
 *
 * The encoder (io/zstd_plain.py is its plain version, byte for byte):
 * at clevel 1 to 9, the frame of libzstd 1.5.7's ZSTD_compressCCtx at the
 * level c-blosc asks for, 2 * clevel - 1 (1, 3, ..., 15) and 22 at clevel
 * 9, within the same output capacity, byte for byte, for every input up
 * to the clevel's blosc block (128 KiB at clevel 1 and 2, 256 KiB at 3 to
 * 5, 512 KiB at 6 to 8, 1 MiB at 9): the parameters of libzstd's table
 * for the source size (up to 16 KiB, 128 KiB, 256 KiB, larger) as
 * ZSTD_adjustCParams cuts them; ZSTD_compressBlock_fast (level 1),
 * _doubleFast (3), ZSTD_compressBlock_lazy_generic, greedy, lazy or lazy2,
 * over libzstd's row hash (a window over 16 KiB), hash chain (up to 16
 * KiB) or the DUBT binary tree (btlazy2), with its lazy skipping; or
 * ZSTD_compressBlock_opt_generic (btopt, btultra, btultra2, whose first
 * block is parsed once to seed the prices) over the binary tree and the
 * hash3 table; blocks of 128 KiB, later ones reaching into earlier ones,
 * a full block after the first cut where ZSTD_splitBlock_byChunks sees its
 * statistics change, and from btopt up over windows of 128 KiB or more a
 * block's sequences split into partitions where ZSTD_deriveBlockSplits
 * estimates a gain; libzstd's entropy stage (HUF_buildCTable's sort, tree
 * and height limit, HUF_optimalTableLog with its depth search from
 * btultra up, the weights' FSE or direct header, 1 or 4 streams, an
 * earlier block's Huffman table repeated where it serves;
 * ZSTD_selectEncodingType's shortcuts below strategy lazy and its cost
 * comparisons of the predefined, repeated and a new table from lazy up,
 * FSE_optimalTableLog, FSE_normalizeCount), its block choice
 * (ZSTD_minGain by strategy, a raw block otherwise, an RLE block for a
 * later block of one byte value), the repeat offsets and tables confirmed
 * only after a compressed block, and its room checks, whose failures give
 * 0 (c-blosc then stores the block). Inputs longer than any blosc block
 * hands a clevel (stream_compress callers) keep the port's own matcher (a
 * greedy hash chain over the whole frame, its search depth by clevel,
 * blocks of 128 KiB with repeat offsets across them) with the same entropy
 * stage and block choice.
 */

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

/* libzstd's errors, told apart where it treats them apart: dstSize_tooSmall
 * and any other */
#define ZE_SMALL (-100)
#define ZE_GENERIC (-101)

/* strategies: fast, dfast, greedy, lazy, lazy2, btlazy2, btopt, btultra,
 * btultra2 */
#define ZST_FAST 1
#define ZST_DFAST 2
#define ZST_GREEDY 3
#define ZST_LAZY 4
#define ZST_BTLAZY2 6
#define ZST_BTOPT 7
#define ZST_BTULTRA 8
#define ZST_BTULTRA2 9

static uint64_t read64(const uint8_t *p)
{
    uint64_t v;
    memcpy(&v, p, 8);
    return v;
}

/* a backward stream of w->bits bits written into cap bytes fits as
 * libzstd's bit writers see it (they keep 8 bytes of slack) */
static int stream_fits(const bitout *w, int64_t cap)
{
    return cap > 8 && (w->bits >> 3) < cap - 8;
}

/* ---------------------------------------------------------------- FSE */

/* FSE_optimalTableLog_internal (unsigned arithmetic, as libzstd's) */
static int fse_optimal_log(int maxlog, int64_t n, int maxsym, int minus)
{
    uint32_t maxbits_src = (uint32_t)highbit32((uint32_t)(n - 1))
                           - (uint32_t)minus;
    uint32_t minsrc = (uint32_t)highbit32((uint32_t)n) + 1;
    uint32_t minsym = (uint32_t)highbit32((uint32_t)(maxsym | 1)) + 2;
    uint32_t minbits = minsrc < minsym ? minsrc : minsym;
    uint32_t log = (uint32_t)maxlog;
    if (maxbits_src < log)
        log = maxbits_src;
    if (minbits > log)
        log = minbits;
    if (log < 5)
        log = 5;
    if (log > 12)
        log = 12;
    return (int)log;
}

/* FSE_normalizeM2: the second method, for skewed counts */
static int fse_normalize_m2(int16_t *norm, int log, const uint32_t *count,
                            uint64_t total, int maxsym, int16_t low_prob)
{
    const int16_t unset = -2;
    uint32_t distributed = 0;
    const uint32_t low_threshold = (uint32_t)(total >> log);
    uint32_t low_one = (uint32_t)((total * 3) >> (log + 1));
    for (int s = 0; s <= maxsym; ++s) {
        if (count[s] == 0) {
            norm[s] = 0;
        } else if (count[s] <= low_threshold) {
            norm[s] = low_prob;
            distributed++;
            total -= count[s];
        } else if (count[s] <= low_one) {
            norm[s] = 1;
            distributed++;
            total -= count[s];
        } else {
            norm[s] = unset;
        }
    }
    uint32_t todo = (1u << log) - distributed;
    if (todo == 0)
        return 0;
    if (total / todo > low_one) {
        low_one = (uint32_t)((total * 3) / (todo * 2));
        for (int s = 0; s <= maxsym; ++s)
            if (norm[s] == unset && count[s] <= low_one) {
                norm[s] = 1;
                distributed++;
                total -= count[s];
            }
        todo = (1u << log) - distributed;
    }
    if (distributed == (uint32_t)maxsym + 1) {
        uint32_t maxv = 0, maxc = 0;
        for (int s = 0; s <= maxsym; ++s)
            if (count[s] > maxc) {
                maxv = (uint32_t)s;
                maxc = count[s];
            }
        norm[maxv] = (int16_t)(norm[maxv] + (int16_t)todo);
        return 0;
    }
    if (total == 0) {
        for (int s = 0; todo > 0; s = (s + 1) % (maxsym + 1))
            if (norm[s] > 0) {
                todo--;
                norm[s]++;
            }
        return 0;
    }
    const uint64_t vlog = 62 - (uint64_t)log;
    const uint64_t mid = (1ULL << (vlog - 1)) - 1;
    const uint64_t rstep = (((1ULL << vlog) * todo) + mid) / (uint32_t)total;
    uint64_t tmp = mid;
    for (int s = 0; s <= maxsym; ++s) {
        if (norm[s] != unset)
            continue;
        uint64_t end = tmp + count[s] * rstep;
        uint32_t weight = (uint32_t)(end >> vlog) - (uint32_t)(tmp >> vlog);
        if (weight < 1)
            return ZE_GENERIC;
        norm[s] = (int16_t)weight;
        tmp = end;
    }
    return 0;
}

/* FSE_normalizeCount of count[0..maxsym] (two or more symbols present)
 * to 2^log; low_prob gives the symbols under 1/2^log the count -1 */
static int fse_normalize(int16_t *norm, int log, const uint32_t *count,
                         uint64_t total, int maxsym, int low_prob)
{
    static const uint32_t rtb[8] = {0, 473195, 504333, 520860, 550000,
                                    700000, 750000, 830000};
    const int16_t lowc = low_prob ? -1 : 1;
    const uint64_t scale = 62 - (uint64_t)log;
    const uint64_t step = (1ULL << 62) / (uint32_t)total;
    const uint64_t vstep = 1ULL << (scale - 20);
    int still = 1 << log, largest = 0;
    int16_t largest_p = 0;
    const uint32_t low_threshold = (uint32_t)(total >> log);
    for (int s = 0; s <= maxsym; ++s) {
        if (count[s] == total)
            return 0;
        if (count[s] == 0) {
            norm[s] = 0;
            continue;
        }
        if (count[s] <= low_threshold) {
            norm[s] = lowc;
            still--;
        } else {
            int16_t p = (int16_t)((count[s] * step) >> scale);
            if (p < 8) {
                uint64_t beat = vstep * rtb[p];
                p = (int16_t)(p + ((count[s] * step) - ((uint64_t)p << scale)
                                   > beat));
            }
            if (p > largest_p) {
                largest_p = p;
                largest = s;
            }
            norm[s] = p;
            still -= p;
        }
    }
    if (-still >= (norm[largest] >> 1))
        return fse_normalize_m2(norm, log, count, total, maxsym, lowc);
    norm[largest] = (int16_t)(norm[largest] + still);
    return 0;
}

/* FSE_writeNCount into cap bytes: its size, or ZE_SMALL where libzstd's
 * bounded writer runs out of room */
static int64_t fse_write_ncount(uint8_t *dst, int64_t cap, const int16_t *norm,
                                int maxsym, int log)
{
    const int64_t bound = ((int64_t)(maxsym + 1) * log + 6) / 8 + 3;
    const int safe = cap >= bound;
    int64_t out = 0;
    int nbits = log + 1, remaining = (1 << log) + 1, threshold = 1 << log;
    uint32_t bits = (uint32_t)(log - 5);
    int nb = 4, s = 0, prev0 = 0;
#define NCOUNT_FLUSH()                                 \
    do {                                               \
        if (!safe && out > cap - 2)                    \
            return ZE_SMALL;                           \
        dst[out] = (uint8_t)bits;                      \
        dst[out + 1] = (uint8_t)(bits >> 8);           \
        out += 2;                                      \
        bits >>= 16;                                   \
    } while (0)
    while (s <= maxsym && remaining > 1) {
        if (prev0) {
            int start = s;
            while (s <= maxsym && !norm[s])
                s++;
            if (s > maxsym)
                break;
            while (s >= start + 24) {
                start += 24;
                bits += 0xFFFFu << nb;
                NCOUNT_FLUSH();
            }
            while (s >= start + 3) {
                start += 3;
                bits += 3u << nb;
                nb += 2;
            }
            bits += (uint32_t)(s - start) << nb;
            nb += 2;
            if (nb > 16) {
                NCOUNT_FLUSH();
                nb -= 16;
            }
        }
        int count = norm[s++];
        const int max = (2 * threshold - 1) - remaining;
        remaining -= count < 0 ? -count : count;
        count++;
        if (count >= threshold)
            count += max;
        bits += (uint32_t)count << nb;
        nb += nbits - (count < max);
        prev0 = count == 1;
        if (remaining < 1)
            return ZE_GENERIC;
        while (remaining < threshold) {
            nbits--;
            threshold >>= 1;
        }
        if (nb > 16) {
            NCOUNT_FLUSH();
            nb -= 16;
        }
    }
    if (remaining != 1)
        return ZE_GENERIC;
    if (!safe && out > cap - 2)
        return ZE_SMALL;
    dst[out] = (uint8_t)bits;
    dst[out + 1] = (uint8_t)(bits >> 8);
    return out + (nb + 7) / 8;
#undef NCOUNT_FLUSH
}

/* an FSE encoding table (FSE_buildCTable_wksp) of symbols 0..maxsym */
typedef struct {
    int log, maxsym;
    uint16_t state[1 << ZSTD_LL_LOG];
    int32_t delta_find[256];
    uint32_t delta_nbits[256];
} fse_ctable;

static void fse_build_ctable(fse_ctable *t, const int16_t *norm, int maxsym,
                             int log)
{
    uint8_t symbol_at[1 << ZSTD_LL_LOG];
    uint32_t cumul[257];
    const int size = 1 << log;
    fse_spread(norm, maxsym, log, symbol_at);
    cumul[0] = 0;
    for (int s = 0; s <= maxsym; ++s)
        cumul[s + 1] = cumul[s] + (norm[s] == -1 ? 1 : (uint32_t)norm[s]);
    for (int u = 0; u < size; ++u)
        t->state[cumul[symbol_at[u]]++] = (uint16_t)(size + u);
    uint32_t total = 0;
    for (int s = 0; s <= maxsym; ++s) {
        int c = norm[s];
        if (c == 0) {
            t->delta_nbits[s] = ((uint32_t)(log + 1) << 16) - size;
            t->delta_find[s] = 0;
        } else if (c == -1 || c == 1) {
            t->delta_nbits[s] = ((uint32_t)log << 16) - size;
            t->delta_find[s] = (int32_t)total - 1;
            total += 1;
        } else {
            uint32_t maxout = (uint32_t)(log - highbit32((uint32_t)c - 1));
            uint32_t minplus = (uint32_t)c << maxout;
            t->delta_nbits[s] = (maxout << 16) - minplus;
            t->delta_find[s] = (int32_t)total - c;
            total += (uint32_t)c;
        }
    }
    t->log = log;
    t->maxsym = maxsym;
}

/* FSE_initCState2: the first state of symbol s (the one with the most
 * bits) */
static uint32_t fse_init_state(const fse_ctable *t, int s)
{
    uint32_t nb = (t->delta_nbits[s] + (1u << 15)) >> 16;
    uint32_t value = (nb << 16) - t->delta_nbits[s];
    return t->state[(int32_t)(value >> nb) + t->delta_find[s]];
}

static uint32_t fse_encode(bitout *w, const fse_ctable *t, uint32_t state,
                           int s)
{
    uint32_t nb = (state + t->delta_nbits[s]) >> 16;
    bitout_add(w, state, (int)nb);
    return t->state[(int32_t)(state >> nb) + t->delta_find[s]];
}

/* ------------------------------------------------------------- Huffman */

typedef struct {
    uint32_t count;
    uint16_t parent;
    uint8_t byte, nbits;
} huf_node;

static uint32_t huf_rank_index(uint32_t c)
{
    return c < 165 ? c : (uint32_t)highbit32(c) + 158;
}

static void huf_swap(huf_node *a, huf_node *b)
{
    huf_node t = *a;
    *a = *b;
    *b = t;
}

/* HUF_insertionSort: descending counts, stable */
static void huf_insertion_sort(huf_node *a, int low, int high)
{
    a += low;
    for (int i = 1; i < high - low + 1; ++i) {
        huf_node key = a[i];
        int j = i - 1;
        while (j >= 0 && a[j].count < key.count) {
            a[j + 1] = a[j];
            j--;
        }
        a[j + 1] = key;
    }
}

/* HUF_simpleQuickSort (the last element the pivot): its order among equal
 * counts is libzstd's */
static void huf_quick_sort(huf_node *a, int low, int high)
{
    if (high - low < 8) {
        huf_insertion_sort(a, low, high);
        return;
    }
    while (low < high) {
        const uint32_t pivot = a[high].count;
        int i = low - 1;
        for (int j = low; j < high; ++j)
            if (a[j].count > pivot)
                huf_swap(&a[++i], &a[j]);
        huf_swap(&a[i + 1], &a[high]);
        const int idx = i + 1;
        if (idx - low < high - idx) {
            huf_quick_sort(a, low, idx - 1);
            low = idx + 1;
        } else {
            huf_quick_sort(a, idx + 1, high);
            high = idx - 1;
        }
    }
}

/* HUF_sort: symbols 0..maxsym by descending count into node[] (bucketed:
 * counts under 165 in symbol order, larger ones by log2; rank r's symbols
 * sit at base[r + 1], so libzstd's sort from rank 165 up also reorders
 * the symbols of count 164) */
static void huf_sort(huf_node *node, const uint32_t *count, int maxsym)
{
    uint16_t base[192] = {0}, curr[192] = {0};
    for (int n = 0; n <= maxsym; ++n)
        base[huf_rank_index(count[n])]++;
    for (int n = 191; n > 0; --n) {
        base[n - 1] = (uint16_t)(base[n - 1] + base[n]);
        curr[n - 1] = base[n - 1];
    }
    for (int n = 0; n <= maxsym; ++n) {
        const uint32_t r = huf_rank_index(count[n]) + 1;
        const int pos = curr[r]++;
        node[pos].count = count[n];
        node[pos].byte = (uint8_t)n;
    }
    for (int n = 165; n < 191; ++n) {
        const int size = curr[n] - base[n];
        if (size > 1)
            huf_quick_sort(node + base[n], 0, size - 1);
    }
}

/* HUF_setMaxHeight: no code longer than target, libzstd's way; returns the
 * longest length */
static int huf_set_max_height(huf_node *node, int last, int target)
{
    const int largest = node[last].nbits;
    if (largest <= target)
        return largest;
    int cost = 0;
    const int base_cost = 1 << (largest - target);
    int n = last;
    while (node[n].nbits > target) {
        cost += base_cost - (1 << (largest - node[n].nbits));
        node[n].nbits = (uint8_t)target;
        n--;
    }
    while (node[n].nbits == target)
        --n;
    cost >>= largest - target;
    const uint32_t none = 0xF0F0F0F0u;
    uint32_t rank_last[14];     /* HUF_TABLELOG_MAX (12) + 2 */
    for (int k = 0; k < 14; ++k)
        rank_last[k] = none;
    {
        int cur = target;
        for (int pos = n; pos >= 0; pos--) {
            if (node[pos].nbits >= cur)
                continue;
            cur = node[pos].nbits;
            rank_last[target - cur] = (uint32_t)pos;
        }
    }
    while (cost > 0) {
        int dec = highbit32((uint32_t)cost) + 1;
        for (; dec > 1; dec--) {
            const uint32_t high = rank_last[dec], low = rank_last[dec - 1];
            if (high == none)
                continue;
            if (low == none)
                break;
            if (node[high].count <= 2 * node[low].count)
                break;
        }
        while (dec <= 12 && rank_last[dec] == none)
            dec++;
        cost -= 1 << (dec - 1);
        node[rank_last[dec]].nbits++;
        if (rank_last[dec - 1] == none)
            rank_last[dec - 1] = rank_last[dec];
        if (rank_last[dec] == 0) {
            rank_last[dec] = none;
        } else {
            rank_last[dec]--;
            if (node[rank_last[dec]].nbits != target - dec)
                rank_last[dec] = none;
        }
    }
    while (cost < 0) {
        if (rank_last[1] == none) {
            while (node[n].nbits == target)
                n--;
            node[n + 1].nbits--;
            rank_last[1] = (uint32_t)(n + 1);
            cost++;
            continue;
        }
        node[rank_last[1] + 1].nbits--;
        rank_last[1]++;
        cost++;
    }
    return target;
}

/* HUF_buildCTable_wksp: code lengths (nbits, 0 for absent symbols) and codes
 * of count[0..maxsym] (two or more symbols present), none longer than
 * maxbits; returns the longest */
static int huf_build(const uint32_t *count, int maxsym, int maxbits,
                     uint8_t *nbits, uint16_t *code)
{
    huf_node node0[2 * 256 + 1];
    huf_node *node = node0 + 1;
    memset(node0, 0, sizeof(node0));
    huf_sort(node, count, maxsym);
    /* HUF_buildTree: leaves from the smallest, a node first among equals */
    int nonnull = maxsym;
    while (node[nonnull].count == 0)
        nonnull--;
    int low_s = nonnull, nb = 256, low_n = 256;
    const int root = nb + low_s - 1;
    node[nb].count = node[low_s].count + node[low_s - 1].count;
    node[low_s].parent = node[low_s - 1].parent = (uint16_t)nb;
    nb++;
    low_s -= 2;
    for (int k = nb; k <= root; ++k)
        node[k].count = 1u << 30;
    node[-1].count = 1u << 31;
    while (nb <= root) {
        const int n1 = node[low_s].count < node[low_n].count ? low_s--
                                                             : low_n++;
        const int n2 = node[low_s].count < node[low_n].count ? low_s--
                                                             : low_n++;
        node[nb].count = node[n1].count + node[n2].count;
        node[n1].parent = node[n2].parent = (uint16_t)nb;
        nb++;
    }
    node[root].nbits = 0;
    for (int k = root - 1; k >= 256; k--)
        node[k].nbits = (uint8_t)(node[node[k].parent].nbits + 1);
    for (int k = 0; k <= nonnull; k++)
        node[k].nbits = (uint8_t)(node[node[k].parent].nbits + 1);
    const int longest = huf_set_max_height(node, nonnull, maxbits);
    /* HUF_buildCTableFromTree: values within a length in symbol order */
    uint16_t per_rank[HUF_MAX_BITS + 2] = {0}, val[HUF_MAX_BITS + 2] = {0};
    for (int k = 0; k <= nonnull; k++)
        per_rank[node[k].nbits]++;
    uint16_t min = 0;
    for (int k = longest; k > 0; k--) {
        val[k] = min;
        min = (uint16_t)(min + per_rank[k]);
        min >>= 1;
    }
    memset(nbits, 0, 256);
    for (int k = 0; k <= maxsym; k++)
        nbits[node[k].byte] = node[k].nbits;
    for (int s = 0; s <= maxsym; s++)
        code[s] = nbits[s] ? val[nbits[s]]++ : 0;
    return longest;
}

/* FSE_compress_usingCTable of the weights w[0, n) into cap bytes: 0 where
 * libzstd gives up (n <= 2, no room) */
static int64_t fse_compress_weights(uint8_t *dst, int64_t cap,
                                    const uint8_t *w, int n,
                                    const fse_ctable *t)
{
    if (n <= 2 || cap <= 8)
        return 0;
    bitout bw;
    bitout_init(&bw, dst, cap);
    uint32_t st[2];
    st[(n - 1) & 1] = fse_init_state(t, w[n - 1]);
    st[(n - 2) & 1] = fse_init_state(t, w[n - 2]);
    for (int i = n - 3; i >= 0; --i)
        st[i & 1] = fse_encode(&bw, t, st[i & 1], w[i]);
    bitout_add(&bw, st[1], t->log);
    bitout_add(&bw, st[0], t->log);
    bitout_add(&bw, 1, 1);
    if (!stream_fits(&bw, cap))
        return 0;
    bitout_flush(&bw);
    return bw.p - dst;
}

/* HUF_compressWeights: 0 for no FSE form, 1 for a single weight */
static int64_t huf_compress_weights(uint8_t *dst, int64_t cap,
                                    const uint8_t *w, int n)
{
    if (n <= 1)
        return 0;
    uint32_t count[HUF_MAX_BITS + 1] = {0}, most = 0;
    int maxw = 0;
    for (int i = 0; i < n; ++i)
        count[w[i]]++;
    for (int k = 0; k <= HUF_MAX_BITS; ++k)
        if (count[k]) {
            maxw = k;
            if (count[k] > most)
                most = count[k];
        }
    if (most == (uint32_t)n)
        return 1;
    if (most == 1)
        return 0;
    const int log = fse_optimal_log(HUF_WEIGHT_LOG, n, maxw, 2);
    int16_t norm[HUF_MAX_BITS + 1];
    int rc = fse_normalize(norm, log, count, (uint64_t)n, maxw, 0);
    if (rc < 0)
        return rc;
    int64_t h = fse_write_ncount(dst, cap, norm, maxw, log);
    if (h < 0)
        return h;
    fse_ctable *t = (fse_ctable *)malloc(sizeof(fse_ctable));
    if (t == NULL)
        return ERR_NOMEM;
    fse_build_ctable(t, norm, maxw, log);
    int64_t c = fse_compress_weights(dst + h, cap - h, w, n, t);
    free(t);
    return c == 0 ? 0 : h + c;
}

/* HUF_writeCTable_wksp: the tree description (maxsym + 1 symbols) */
static int64_t huf_write_table(uint8_t *dst, int64_t cap, const uint8_t *nbits,
                               int maxsym, int longest)
{
    uint8_t w[256];
    for (int s = 0; s < maxsym; ++s)
        w[s] = (uint8_t)(nbits[s] ? longest + 1 - nbits[s] : 0);
    if (cap < 1)
        return ZE_SMALL;
    int64_t h = huf_compress_weights(dst + 1, cap - 1, w, maxsym);
    if (h < 0)
        return h;
    if (h > 1 && h < maxsym / 2) {
        dst[0] = (uint8_t)h;
        return h + 1;
    }
    if (maxsym > 128)
        return ZE_GENERIC;
    if ((maxsym + 1) / 2 + 1 > cap)
        return ZE_SMALL;
    dst[0] = (uint8_t)(128 + maxsym - 1);
    w[maxsym] = 0;
    for (int s = 0; s < maxsym; s += 2)
        dst[s / 2 + 1] = (uint8_t)((w[s] << 4) + w[s + 1]);
    return (maxsym + 1) / 2 + 1;
}

/* one Huffman stream (HUF_compress1X_usingCTable): 0 where it does not fit
 * cap as libzstd's writer sees it */
static int64_t huf_stream(uint8_t *dst, int64_t cap, const uint8_t *src,
                          int64_t n, const uint8_t *nbits,
                          const uint16_t *code)
{
    if (cap <= 8)
        return 0;
    int64_t total = 1;
    for (int64_t i = 0; i < n; ++i)
        total += nbits[src[i]];
    if ((total >> 3) >= cap - 8)
        return 0;
    bitout bw;
    bitout_init(&bw, dst, cap);
    for (int64_t i = n - 1; i >= 0; --i)
        bitout_add(&bw, code[src[i]], nbits[src[i]]);
    bitout_add(&bw, 1, 1);
    bitout_flush(&bw);
    return bw.p - dst;
}

/* a Huffman encoding table: code lengths (0 for a symbol absent from it)
 * and codes of symbols 0..maxsym, none longer than log */
typedef struct {
    int maxsym, log;
    uint8_t nbits[256];
    uint16_t code[256];
} huf_ctable;

/* the repeat mode of an earlier block's table (libzstd's HUF_repeat and
 * FSE_repeat): not usable, or usable after a check of the counts (its
 * "valid", usable unchecked, comes only from a dictionary, which c-blosc
 * never gives) */
#define ZR_NONE 0
#define ZR_CHECK 1

/* what a block leaves to the next (ZSTD_entropyCTables_t): the literals'
 * Huffman table and the literal length, offset and match length tables,
 * each with its repeat mode */
typedef struct {
    int huf_mode;
    huf_ctable huf;
    int fse_mode[3];
    fse_ctable fse[3];
} zentropy;

static void zentropy_reset(zentropy *e)
{
    e->huf_mode = ZR_NONE;
    for (int f = 0; f < 3; ++f)
        e->fse_mode[f] = ZR_NONE;
}

/* HUF_compressCTable_internal: 1 or 4 streams of src[0, n) with table t
 * at dst + op (a table description before it); the size from dst, 0 for
 * not compressible */
static int64_t huf_streams(uint8_t *dst, int64_t op, int64_t cap,
                           const uint8_t *src, int64_t n, int single,
                           const huf_ctable *t)
{
    if (single) {
        int64_t c = huf_stream(dst + op, cap - op, src, n, t->nbits, t->code);
        if (c == 0)
            return 0;
        op += c;
    } else {
        const int64_t seg = (n + 3) / 4;
        if (cap - op < 6 + 1 + 1 + 1 + 8 || n < 12)
            return 0;
        const int64_t jump = op;
        op += 6;
        for (int k = 0; k < 4; ++k) {
            const int64_t cnt = k < 3 ? seg : n - 3 * seg;
            int64_t c = huf_stream(dst + op, cap - op, src + k * seg, cnt,
                                   t->nbits, t->code);
            if (c == 0 || c > 65535)
                return 0;
            if (k < 3) {
                dst[jump + 2 * k] = (uint8_t)c;
                dst[jump + 2 * k + 1] = (uint8_t)(c >> 8);
            }
            op += c;
        }
    }
    if (op >= n - 1)
        return 0;
    return op;
}

/* HUF_estimateCompressedSize: the bytes of count[0..maxsym] in a table */
static uint64_t huf_estimate(const uint8_t *nbits, const uint32_t *count,
                             int maxsym)
{
    uint64_t bits = 0;
    for (int s = 0; s <= maxsym; ++s)
        bits += (uint64_t)nbits[s] * count[s];
    return bits >> 3;
}

/* HUF_optimalTableLog: FSE_optimalTableLog's guess, or from strategy
 * btultra up (HUF_flags_optimalDepth) the depth whose table and codes
 * are the smallest, searched up from the least depth the symbols need
 * until the size grows */
static int huf_optimal_log(const uint32_t *count, int maxsym, int64_t n,
                           int depth)
{
    if (!depth)
        return fse_optimal_log(HUF_MAX_BITS, n, maxsym, 1);
    int card = 0;
    for (int s = 0; s <= maxsym; ++s)
        card += count[s] != 0;
    const int minlog = highbit32((uint32_t)card) + 1;
    uint64_t best = UINT64_MAX - 1;
    int log = HUF_MAX_BITS;
    huf_ctable t;
    uint8_t buf[1024];
    for (int guess = minlog; guess <= HUF_MAX_BITS; ++guess) {
        const int maxbits = huf_build(count, maxsym, guess, t.nbits, t.code);
        if (maxbits < guess && guess > minlog)
            break;
        const int64_t h = huf_write_table(buf, sizeof(buf), t.nbits, maxsym,
                                          maxbits);
        if (h == ERR_NOMEM)
            return ERR_NOMEM;
        if (h < 0)
            continue;
        const uint64_t size = huf_estimate(t.nbits, count, maxsym)
                              + (uint64_t)h;
        if (size > best + 1)
            break;
        if (size < best) {
            best = size;
            log = guess;
        }
    }
    return log;
}

/* HUF_compress1X_repeat / HUF_compress4X_repeat (HUF_compress_internal):
 * src[0, n) into cap bytes with the earlier table *old (of mode *repeat)
 * or a new one (its description first, and then *old, *repeat ZR_NONE),
 * its depth searched where depth is set; 0 for not compressible, 1 for a
 * single symbol (dst[0] that symbol) */
static int64_t huf_compress(uint8_t *dst, int64_t cap, const uint8_t *src,
                            int64_t n, int single, int suspect, int prefer,
                            int depth, int *repeat, huf_ctable *old)
{
    if (n == 0 || cap == 0)
        return 0;
    uint32_t count[256];
    if (suspect && n >= 4096 * 10) {
        uint32_t largest_total = 0;
        for (int k = 0; k < 2; ++k) {
            const uint8_t *p = k ? src + n - 4096 : src;
            uint32_t most = 0;
            memset(count, 0, sizeof(count));
            for (int i = 0; i < 4096; ++i)
                count[p[i]]++;
            for (int s = 0; s < 256; ++s)
                if (count[s] > most)
                    most = count[s];
            largest_total += most;
        }
        if (largest_total <= (2 * 4096 >> 7) + 4)
            return 0;
    }
    memset(count, 0, sizeof(count));
    for (int64_t i = 0; i < n; ++i)
        count[src[i]]++;
    uint32_t largest = 0;
    int maxsym = 0;
    for (int s = 0; s < 256; ++s)
        if (count[s]) {
            maxsym = s;
            if (count[s] > largest)
                largest = count[s];
        }
    if (largest == (uint64_t)n) {
        dst[0] = src[0];
        return 1;
    }
    if (largest <= (uint64_t)((n >> 7) + 4))
        return 0;
    if (*repeat == ZR_CHECK) {    /* HUF_validateCTable */
        int bad = old->maxsym < maxsym;
        for (int s = 0; !bad && s <= maxsym; ++s)
            bad = count[s] != 0 && old->nbits[s] == 0;
        if (bad)
            *repeat = ZR_NONE;
    }
    if (prefer && *repeat != ZR_NONE)
        return huf_streams(dst, 0, cap, src, n, single, old);
    huf_ctable t;
    t.maxsym = maxsym;
    const int log = huf_optimal_log(count, maxsym, n, depth);
    if (log < 0)
        return log;
    t.log = huf_build(count, maxsym, log, t.nbits, t.code);
    const int64_t h = huf_write_table(dst, cap, t.nbits, maxsym, t.log);
    if (h < 0)
        return h;
    if (*repeat != ZR_NONE) {     /* HUF_estimateCompressedSize of both */
        if ((int64_t)huf_estimate(old->nbits, count, maxsym)
                <= h + (int64_t)huf_estimate(t.nbits, count, maxsym)
                || h + 12 >= n)
            return huf_streams(dst, 0, cap, src, n, single, old);
    }
    if (h + 12 >= n)
        return 0;
    *repeat = ZR_NONE;
    *old = t;
    return huf_streams(dst, h, cap, src, n, single, &t);
}

/* the header of a raw or RLE literals section */
static int64_t literal_header(uint8_t *dst, int type, int64_t n)
{
    if (n < 32) {
        dst[0] = (uint8_t)(type | (n << 3));
        return 1;
    }
    if (n < 4096) {
        dst[0] = (uint8_t)(type | (1 << 2) | ((n & 15) << 4));
        dst[1] = (uint8_t)(n >> 4);
        return 2;
    }
    dst[0] = (uint8_t)(type | (3 << 2) | ((n & 15) << 4));
    dst[1] = (uint8_t)(n >> 4);
    dst[2] = (uint8_t)(n >> 12);
    return 3;
}

static int64_t raw_literals(uint8_t *dst, int64_t cap, const uint8_t *lit,
                            int64_t n)
{
    const int64_t fl = 1 + (n > 31) + (n > 4095);
    if (n + fl > cap)
        return ZE_SMALL;
    literal_header(dst, 0, n);
    memcpy(dst + fl, lit, (size_t)n);
    return n + fl;
}

/* ZSTD_minGain: n / 64 + 2 below strategy btultra, n >> (strategy - 1)
 * + 2 from it up */
static int64_t zstd_min_gain(int64_t n, int strat)
{
    return (n >> (strat >= ZST_BTULTRA ? strat - 1 : 6)) + 2;
}

/* ZSTD_compressLiterals: the literals section, with the earlier block's
 * Huffman table (prev) where it serves (a treeless section); next gets
 * the table a later block may repeat */
static int64_t zstd_write_literals(uint8_t *dst, int64_t cap,
                                   const uint8_t *lit, int64_t n, int strat,
                                   int suspect, const zentropy *prev,
                                   zentropy *next)
{
    const int64_t lh = 3 + (n >= 1024) + (n >= 16384);
    const int shift = 9 - strat < 3 ? 9 - strat : 3;
    const int single = n < 256;
    int repeat = prev->huf_mode;
    next->huf_mode = prev->huf_mode;
    next->huf = prev->huf;
    /* ZSTD_minLiteralsToCompress */
    if (n < (int64_t)8 << shift)
        return raw_literals(dst, cap, lit, n);
    if (cap < lh + 1)
        return ZE_SMALL;
    int64_t c = huf_compress(dst + lh, cap - lh, lit, n, single, suspect,
                             strat < ZST_LAZY && n <= 1024,
                             strat >= ZST_BTULTRA, &repeat, &next->huf);
    if (c == ERR_NOMEM)
        return c;
    const int type = repeat != ZR_NONE ? 3 : 2;
    if (c <= 0 || c >= n - zstd_min_gain(n, strat)) {
        next->huf = prev->huf;
        return raw_literals(dst, cap, lit, n);
    }
    if (c == 1) {
        next->huf = prev->huf;
        const int64_t fl = literal_header(dst, 1, n);
        dst[fl] = lit[0];
        return fl + 1;
    }
    if (type == 2)
        next->huf_mode = ZR_CHECK;
    uint64_t h;
    if (lh == 3)
        h = (uint64_t)type | ((uint64_t)!single << 2) | ((uint64_t)n << 4)
            | ((uint64_t)c << 14);
    else if (lh == 4)
        h = (uint64_t)type | (2 << 2) | ((uint64_t)n << 4)
            | ((uint64_t)c << 18);
    else
        h = (uint64_t)type | (3 << 2) | ((uint64_t)n << 4)
            | ((uint64_t)c << 22);
    for (int k = 0; k < lh; ++k)
        dst[k] = (uint8_t)(h >> (8 * k));
    return lh + c;
}

/* ----------------------------------------------------------- sequences */

typedef struct {
    uint32_t ll, ml, ofv;    /* literal length, match length, offset value */
} zseq;

/* the largest code whose baseline is at most v */
static int code_of(const uint32_t *base, int maxcode, uint32_t v)
{
    if (v - base[0] < 16)      /* the first 16 codes of both tables are */
        return (int)(v - base[0]);    /* their baselines, one apart */
    int c = maxcode;
    while (base[c] > v)
        --c;
    return c;
}

/* kInverseProbabilityLog256: -log2(i / 256) in 1/256 bits, rounded down */
static const uint16_t INV_PROB_LOG256[256] = {
    0, 2048, 1792, 1642, 1536, 1453, 1386, 1329, 1280, 1236, 1197, 1162,
    1130, 1100, 1073, 1047, 1024, 1001, 980, 960, 941, 923, 906, 889, 874,
    859, 844, 830, 817, 804, 791, 779, 768, 756, 745, 734, 724, 714, 704,
    694, 685, 676, 667, 658, 650, 642, 633, 626, 618, 610, 603, 595, 588,
    581, 574, 567, 561, 554, 548, 542, 535, 529, 523, 517, 512, 506, 500,
    495, 489, 484, 478, 473, 468, 463, 458, 453, 448, 443, 438, 434, 429,
    424, 420, 415, 411, 407, 402, 398, 394, 390, 386, 382, 377, 373, 370,
    366, 362, 358, 354, 350, 347, 343, 339, 336, 332, 329, 325, 322, 318,
    315, 311, 308, 305, 302, 298, 295, 292, 289, 286, 282, 279, 276, 273,
    270, 267, 264, 261, 258, 256, 253, 250, 247, 244, 241, 239, 236, 233,
    230, 228, 225, 222, 220, 217, 215, 212, 209, 207, 204, 202, 199, 197,
    194, 192, 190, 187, 185, 182, 180, 178, 175, 173, 171, 168, 166, 164,
    162, 159, 157, 155, 153, 151, 149, 146, 144, 142, 140, 138, 136, 134,
    132, 130, 128, 126, 123, 121, 119, 117, 115, 114, 112, 110, 108, 106,
    104, 102, 100, 98, 96, 94, 93, 91, 89, 87, 85, 83, 82, 80, 78, 76, 74,
    73, 71, 69, 67, 66, 64, 62, 61, 59, 57, 55, 54, 52, 50, 49, 47, 46, 44,
    42, 41, 39, 37, 36, 34, 33, 31, 30, 28, 26, 25, 23, 22, 20, 19, 17, 16,
    14, 13, 11, 10, 8, 7, 5, 4, 2, 1};

#define ZCOST_NONE UINT64_MAX    /* libzstd's ERROR(GENERIC) as a cost */

/* ZSTD_crossEntropyCost: the bits of count[0..max] in a default table */
static uint64_t cross_entropy_cost(const int16_t *norm, int log,
                                   const uint32_t *count, int max)
{
    uint64_t cost = 0;
    for (int s = 0; s <= max; ++s) {
        const uint32_t p = norm[s] != -1 ? (uint32_t)norm[s] : 1;
        cost += (uint64_t)count[s] * INV_PROB_LOG256[p << (8 - log)];
    }
    return cost >> 8;
}

/* ZSTD_fseBitCost: the bits of count[0..max] in an earlier table, or
 * ZCOST_NONE where it cannot code them */
static uint64_t fse_bit_cost(const fse_ctable *t, const uint32_t *count,
                             int max)
{
    if (t->maxsym < max)
        return ZCOST_NONE;
    const uint32_t log = (uint32_t)t->log, size = 1u << log;
    uint64_t cost = 0;
    for (int s = 0; s <= max; ++s) {
        /* FSE_bitCost at 8 bits of accuracy */
        const uint32_t min_nb = t->delta_nbits[s] >> 16;
        const uint32_t delta = ((min_nb + 1) << 16)
                               - (t->delta_nbits[s] + size);
        const uint32_t bits = (min_nb + 1) * 256 - ((delta << 8) >> log);
        if (count[s] == 0)
            continue;
        if (bits >= (log + 1) << 8)
            return ZCOST_NONE;
        cost += (uint64_t)count[s] * bits;
    }
    return cost >> 8;
}

/* ZSTD_NCountCost: the bytes of a new table's description */
static uint64_t ncount_cost(const uint32_t *count, int max, int64_t nseq,
                            int fselog)
{
    int16_t norm[ZSTD_MAX_ML + 1];
    uint8_t buf[512];
    const int log = fse_optimal_log(fselog, nseq, max, 2);
    if (fse_normalize(norm, log, count, (uint64_t)nseq, max, nseq >= 2048) < 0)
        return ZCOST_NONE;
    const int64_t h = fse_write_ncount(buf, sizeof(buf), norm, max, log);
    return h < 0 ? ZCOST_NONE : (uint64_t)h;
}

/* ZSTD_entropyCost: the bits of count[0..max] in a table of their own */
static uint64_t entropy_cost(const uint32_t *count, int max, int64_t total)
{
    uint32_t cost = 0;
    for (int s = 0; s <= max; ++s) {
        uint32_t p = (uint32_t)(((uint64_t)256 * count[s]) / (uint64_t)total);
        if (count[s] != 0 && p == 0)
            p = 1;
        cost += count[s] * INV_PROB_LOG256[p];
    }
    return cost >> 8;
}

/* one sequence field (literal length, offset or match length codes):
 * ZSTD_selectEncodingType and ZSTD_buildCTable, from the earlier block's
 * table prevt (of mode prevmode); its type (0 predefined, 1 RLE, 2 a new
 * table, 3 repeat), table t and mode for the next block, and description
 * (at dst, the size returned) */
static int64_t seq_field(const uint8_t *codes, int64_t nseq, int maxcode,
                         int fselog, const int16_t *defnorm, int defmax,
                         int deflog, int strat, const fse_ctable *prevt,
                         int prevmode, fse_ctable *t, int *nextmode,
                         int *type, uint8_t *dst, int64_t cap)
{
    uint32_t count[ZSTD_MAX_ML + 1] = {0}, most = 0;
    int max = 0;
    for (int64_t i = 0; i < nseq; ++i)
        count[codes[i]]++;
    for (int s = 0; s <= maxcode; ++s)
        if (count[s]) {
            max = s;
            if (count[s] > most)
                most = count[s];
        }
    const int def_ok = max <= defmax;
    int mode = prevmode;
    if (most == (uint64_t)nseq) {
        mode = ZR_NONE;
        *type = def_ok && nseq <= 2 ? 0 : 1;
    } else if (strat < 4) {
        if (def_ok && (nseq < (((int64_t)1 << deflog) * (10 - strat)) >> 3
                       || most < (uint64_t)(nseq >> (deflog - 1)))) {
            mode = ZR_NONE;
            *type = 0;
        } else {
            *type = 2;
        }
    } else {
        const uint64_t basic = def_ok ? cross_entropy_cost(defnorm, deflog,
                                                           count, max)
                                      : ZCOST_NONE;
        const uint64_t rep = mode != ZR_NONE ? fse_bit_cost(prevt, count, max)
                                             : ZCOST_NONE;
        const uint64_t nc = ncount_cost(count, max, nseq, fselog);
        const uint64_t comp = nc == ZCOST_NONE ? ZCOST_NONE
                              : (nc << 3) + entropy_cost(count, max, nseq);
        if (basic <= rep && basic <= comp) {
            mode = ZR_NONE;
            *type = 0;
        } else {
            *type = rep <= comp ? 3 : 2;
        }
    }
    if (*type == 2)
        mode = ZR_CHECK;
    *nextmode = mode;
    if (*type == 0) {
        fse_build_ctable(t, defnorm, defmax, deflog);
        return 0;
    }
    if (*type == 1) {
        t->log = 0;
        t->maxsym = max;
        if (cap == 0)
            return ZE_SMALL;
        dst[0] = codes[0];
        return 1;
    }
    if (*type == 3) {
        *t = *prevt;
        return 0;
    }
    const int log = fse_optimal_log(fselog, nseq, max, 2);
    int64_t total = nseq;
    if (count[codes[nseq - 1]] > 1) {
        count[codes[nseq - 1]]--;
        total--;
    }
    int16_t norm[ZSTD_MAX_ML + 1];
    int rc = fse_normalize(norm, log, count, (uint64_t)total, max,
                           total >= 2048);
    if (rc < 0)
        return rc;
    int64_t h = fse_write_ncount(dst, cap, norm, max, log);
    if (h < 0)
        return h;
    fse_build_ctable(t, norm, max, log);
    return h;
}

/* ZSTD_entropyCompressSeqStore_internal: the literals and sequences
 * sections of a block into cap bytes, from the tables prev left; next
 * gets what this block leaves */
static int64_t zstd_write_block_body(const uint8_t *lit, int64_t nlit,
                                     const zseq *seq, int64_t nseq, int strat,
                                     const zentropy *prev, zentropy *next,
                                     uint8_t *dst, int64_t cap)
{
    const int suspect = nseq == 0 || nlit / nseq >= 20;
    int64_t op = zstd_write_literals(dst, cap, lit, nlit, strat, suspect,
                                     prev, next);
    if (op < 0)
        return op;
    if (cap - op < 4)
        return ZE_SMALL;
    if (nseq < 128) {
        dst[op++] = (uint8_t)nseq;
    } else if (nseq < 0x7F00) {
        dst[op++] = (uint8_t)((nseq >> 8) + 128);
        dst[op++] = (uint8_t)nseq;
    } else {
        dst[op++] = 255;
        dst[op++] = (uint8_t)(nseq - 0x7F00);
        dst[op++] = (uint8_t)((nseq - 0x7F00) >> 8);
    }
    if (nseq == 0) {     /* the tables carry over as if repeated */
        for (int f = 0; f < 3; ++f) {
            next->fse_mode[f] = prev->fse_mode[f];
            next->fse[f] = prev->fse[f];
        }
        return op;
    }
    uint8_t *llc = (uint8_t *)malloc((size_t)nseq * 3);
    if (llc == NULL)
        return ERR_NOMEM;
    uint8_t *mlc = llc + nseq, *ofc = mlc + nseq;
    for (int64_t i = 0; i < nseq; ++i) {
        llc[i] = (uint8_t)code_of(LL_BASE, ZSTD_MAX_LL, seq[i].ll);
        mlc[i] = (uint8_t)code_of(ML_BASE, ZSTD_MAX_ML, seq[i].ml);
        ofc[i] = (uint8_t)highbit32(seq[i].ofv);
    }
    const int64_t head = op++;
    int m[3];
    int64_t last_count = 0, r = 0, out;
    fse_ctable *t = next->fse;
    const uint8_t *codes[3] = {llc, ofc, mlc};
    static const int maxc[3] = {ZSTD_MAX_LL, ZSTD_MAX_OF, ZSTD_MAX_ML};
    static const int logs[3] = {ZSTD_LL_LOG, ZSTD_OF_LOG, ZSTD_ML_LOG};
    static const int defmax[3] = {ZSTD_MAX_LL, 28, ZSTD_MAX_ML};
    static const int deflog[3] = {LL_DEFAULT_LOG, OF_DEFAULT_LOG,
                                  ML_DEFAULT_LOG};
    const int16_t *defnorm[3] = {LL_DEFAULT, OF_DEFAULT, ML_DEFAULT};
    for (int f = 0; f < 3 && r >= 0; ++f) {
        r = seq_field(codes[f], nseq, maxc[f], logs[f], defnorm[f], defmax[f],
                      deflog[f], strat, &prev->fse[f], prev->fse_mode[f],
                      &t[f], &next->fse_mode[f], &m[f], dst + op, cap - op);
        if (r >= 0) {
            if (m[f] == 2)
                last_count = r;
            op += r;
        }
    }
    if (r < 0) {
        out = r;
        goto done;
    }
    dst[head] = (uint8_t)((m[0] << 6) | (m[1] << 4) | (m[2] << 2));
    if (cap - op <= 8) {
        out = ZE_SMALL;
        goto done;
    }
    {
        bitout bw;
        bitout_init(&bw, dst + op, cap - op);
        int64_t k = nseq - 1;
        uint32_t sll = m[0] == 1 ? 0 : fse_init_state(&t[0], llc[k]);
        uint32_t sof = m[1] == 1 ? 0 : fse_init_state(&t[1], ofc[k]);
        uint32_t sml = m[2] == 1 ? 0 : fse_init_state(&t[2], mlc[k]);
        for (;;) {
            bitout_add(&bw, seq[k].ll - LL_BASE[llc[k]], LL_BITS[llc[k]]);
            bitout_add(&bw, seq[k].ml - ML_BASE[mlc[k]], ML_BITS[mlc[k]]);
            bitout_add(&bw, seq[k].ofv, ofc[k]);
            if (k-- == 0)
                break;
            if (m[1] != 1)
                sof = fse_encode(&bw, &t[1], sof, ofc[k]);
            if (m[2] != 1)
                sml = fse_encode(&bw, &t[2], sml, mlc[k]);
            if (m[0] != 1)
                sll = fse_encode(&bw, &t[0], sll, llc[k]);
        }
        bitout_add(&bw, sml, m[2] == 1 ? 0 : t[2].log);
        bitout_add(&bw, sof, m[1] == 1 ? 0 : t[1].log);
        bitout_add(&bw, sll, m[0] == 1 ? 0 : t[0].log);
        bitout_add(&bw, 1, 1);
        if (!stream_fits(&bw, cap - op)) {
            out = ZE_SMALL;
            goto done;
        }
        bitout_flush(&bw);
        const int64_t bs = bw.p - (dst + op);
        /* libzstd's guard for decoders up to 1.3.4 */
        out = last_count && last_count + bs < 4 ? 0 : op + bs;
    }
done:
    free(llc);
    return out;
}

/* ZSTD_entropyCompressSeqStore: the compressed block's body, or 0 for a
 * block to store raw */
static int64_t zstd_block_body(const uint8_t *lit, int64_t nlit,
                               const zseq *seq, int64_t nseq, int strat,
                               const zentropy *prev, zentropy *next,
                               int64_t n, uint8_t *dst, int64_t cap)
{
    int64_t c = zstd_write_block_body(lit, nlit, seq, nseq, strat, prev, next,
                                      dst, cap);
    if (c == ZE_SMALL && n <= cap)
        return 0;
    if (c < 0)
        return c;
    return c >= n - zstd_min_gain(n, strat) ? 0 : c;
}

/* ------------------------------------------------------------ matchers */

typedef struct {
    const uint8_t *src;
    zseq *seq;
    int64_t nseq;
    uint8_t *lit;
    int64_t nlit;
} zsink;

static void zsink_store(zsink *k, int64_t anchor, int64_t ll, uint32_t ofv,
                        int64_t ml)
{
    memcpy(k->lit + k->nlit, k->src + anchor, (size_t)ll);
    k->nlit += ll;
    k->seq[k->nseq].ll = (uint32_t)ll;
    k->seq[k->nseq].ml = (uint32_t)ml;
    k->seq[k->nseq].ofv = ofv;
    k->nseq++;
}

/* ZSTD_hashPtr of the mls bytes at p (libzstd's primes, no salt) */
static uint32_t zl_hash(const uint8_t *p, int hlog, int mls)
{
    switch (mls) {
    case 5:
        return (uint32_t)(((read64(p) << 24) * 889523592379ULL)
                          >> (64 - hlog));
    case 6:
        return (uint32_t)(((read64(p) << 16) * 227718039650203ULL)
                          >> (64 - hlog));
    case 7:
        return (uint32_t)(((read64(p) << 8) * 58295818150454627ULL)
                          >> (64 - hlog));
    case 8:
        return (uint32_t)((read64(p) * 0xCF1BBCDCB7A56463ULL)
                          >> (64 - hlog));
    default:
        return (read32(p) * 2654435761u) >> (32 - hlog);
    }
}

/* the tables hold position + 2 (libzstd's first index), 0 for none */
#define ZL_IDX(pos) ((uint32_t)(pos) + 2)

/* ZSTD_compressBlock_fast on a fresh frame's one block src[0, n): its
 * sequences into k; returns where the last literals start */
static int64_t zl_fast(zsink *k, int64_t n, int hlog, int mls, uint32_t *ht)
{
    const uint8_t *src = k->src;
    const int64_t ilimit = n - 8;
    /* the first position is skipped and rep[1] (4) lies before the block
     * at the second: set aside */
    int64_t anchor = 0, ip0 = 1;
    uint32_t rep1 = 1, rep2 = 0;
    for (;;) {
        int64_t step = 2, next_step = ip0 + 128;
        int64_t ip1 = ip0 + 1, ip2 = ip0 + step, ip3 = ip2 + 1;
        int64_t cur0 = ip0, match0 = 0, mlen = 0;
        uint32_t ofv = 0, midx, hash0, hash1;
        int found = 0;
        if (ip3 >= ilimit)
            break;
        hash0 = zl_hash(src + ip0, hlog, mls);
        hash1 = zl_hash(src + ip1, hlog, mls);
        midx = ht[hash0];
        do {
            const uint32_t rval = read32(src + ip2 - rep1);
            cur0 = ip0;
            ht[hash0] = ZL_IDX(ip0);
            if (read32(src + ip2) == rval && rep1 > 0) {
                ip0 = ip2;
                match0 = ip0 - rep1;
                mlen = src[ip0 - 1] == src[match0 - 1];
                ip0 -= mlen;
                match0 -= mlen;
                ofv = 1;
                mlen += 4;
                ht[hash1] = ZL_IDX(ip1);
                found = 1;
                break;
            }
            if (midx >= 2 && read32(src + ip0) == read32(src + midx - 2)) {
                ht[hash1] = ZL_IDX(ip1);
                found = 2;
                break;
            }
            midx = ht[hash1];
            hash0 = hash1;
            hash1 = zl_hash(src + ip2, hlog, mls);
            ip0 = ip1;
            ip1 = ip2;
            ip2 = ip3;
            cur0 = ip0;
            ht[hash0] = ZL_IDX(ip0);
            if (midx >= 2 && read32(src + ip0) == read32(src + midx - 2)) {
                if (step <= 4)
                    ht[hash1] = ZL_IDX(ip1);
                found = 2;
                break;
            }
            midx = ht[hash1];
            hash0 = hash1;
            hash1 = zl_hash(src + ip2, hlog, mls);
            ip0 = ip1;
            ip1 = ip2;
            ip2 = ip0 + step;
            ip3 = ip1 + step;
            if (ip2 >= next_step) {
                step++;
                next_step += 128;
            }
        } while (ip3 < ilimit);
        if (!found)
            break;
        if (found == 2) {
            match0 = (int64_t)midx - 2;
            rep2 = rep1;
            rep1 = (uint32_t)(ip0 - match0);
            ofv = rep1 + 3;
            mlen = 4;
            while (ip0 > anchor && match0 > 0
                   && src[ip0 - 1] == src[match0 - 1]) {
                ip0--;
                match0--;
                mlen++;
            }
        }
        mlen += common_len(src + ip0 + mlen, src + match0 + mlen, src + n);
        zsink_store(k, anchor, ip0 - anchor, ofv, mlen);
        ip0 += mlen;
        anchor = ip0;
        if (ip0 <= ilimit) {
            ht[zl_hash(src + cur0 + 2, hlog, mls)] = ZL_IDX(cur0 + 2);
            ht[zl_hash(src + ip0 - 2, hlog, mls)] = ZL_IDX(ip0 - 2);
            if (rep2 > 0) {
                while (ip0 <= ilimit
                       && read32(src + ip0) == read32(src + ip0 - rep2)) {
                    const int64_t rl = common_len(src + ip0 + 4,
                                                  src + ip0 + 4 - rep2,
                                                  src + n) + 4;
                    const uint32_t tmp = rep2;
                    rep2 = rep1;
                    rep1 = tmp;
                    ht[zl_hash(src + ip0, hlog, mls)] = ZL_IDX(ip0);
                    ip0 += rl;
                    zsink_store(k, anchor, 0, 1, rl);
                    anchor = ip0;
                }
            }
        }
    }
    return anchor;
}

/* ZSTD_compressBlock_doubleFast on a fresh frame's one block src[0, n):
 * a long table (8-byte hash, hlog bits) and a short one (mls bytes, slog
 * bits); returns where the last literals start */
static int64_t zl_dfast(zsink *k, int64_t n, int hlog, int slog, int mls,
                        uint32_t *hl, uint32_t *hs)
{
    const uint8_t *src = k->src;
    const int64_t ilimit = n - 8;
    int64_t anchor = 0, ip = 1;
    uint32_t rep1 = 1, rep2 = 0;
    for (;;) {
        int64_t step = 1, next_step = ip + 256, ip1 = ip + step;
        int64_t cur = ip, mlen = 0, matchs0 = 0;
        uint32_t offset = 0, hl0, hl1 = 0, idxl0, idxl1 = 0, idxs0 = 0;
        int found = 0;
        if (ip1 > ilimit)
            break;
        hl0 = zl_hash(src + ip, hlog, 8);
        idxl0 = hl[hl0];
        do {
            const uint32_t hs0 = zl_hash(src + ip, slog, mls);
            idxs0 = hs[hs0];
            cur = ip;
            hl[hl0] = hs[hs0] = ZL_IDX(ip);
            if (rep1 > 0 && read32(src + ip + 1 - rep1) == read32(src + ip + 1)) {
                mlen = common_len(src + ip + 5, src + ip + 5 - rep1, src + n)
                       + 4;
                ip++;
                zsink_store(k, anchor, ip - anchor, 1, mlen);
                found = 1;
                break;
            }
            hl1 = zl_hash(src + ip1, hlog, 8);
            if (idxl0 >= 2 && read64(src + idxl0 - 2) == read64(src + ip)) {
                int64_t m0 = (int64_t)idxl0 - 2;
                mlen = common_len(src + ip + 8, src + m0 + 8, src + n) + 8;
                offset = (uint32_t)(ip - m0);
                while (ip > anchor && m0 > 0 && src[ip - 1] == src[m0 - 1]) {
                    ip--;
                    m0--;
                    mlen++;
                }
                found = 2;
                break;
            }
            idxl1 = hl[hl1];
            if (idxs0 >= 2 && read32(src + idxs0 - 2) == read32(src + ip)) {
                found = 3;
                break;
            }
            if (ip1 >= next_step) {
                step++;
                next_step += 256;
            }
            ip = ip1;
            ip1 += step;
            hl0 = hl1;
            idxl0 = idxl1;
        } while (ip1 <= ilimit);
        if (!found)
            break;
        if (found == 3) {
            /* a short match: a longer one at the next position? */
            matchs0 = (int64_t)idxs0 - 2;
            mlen = common_len(src + ip + 4, src + matchs0 + 4, src + n) + 4;
            offset = (uint32_t)(ip - matchs0);
            if (idxl1 > 2 && read64(src + idxl1 - 2) == read64(src + ip1)) {
                const int64_t l1 = common_len(src + ip1 + 8,
                                              src + idxl1 - 2 + 8, src + n)
                                   + 8;
                if (l1 > mlen) {
                    ip = ip1;
                    mlen = l1;
                    matchs0 = (int64_t)idxl1 - 2;
                    offset = (uint32_t)(ip - matchs0);
                }
            }
            while (ip > anchor && matchs0 > 0
                   && src[ip - 1] == src[matchs0 - 1]) {
                ip--;
                matchs0--;
                mlen++;
            }
        }
        if (found >= 2) {
            rep2 = rep1;
            rep1 = offset;
            if (step < 4)
                hl[hl1] = ZL_IDX(ip1);
            zsink_store(k, anchor, ip - anchor, offset + 3, mlen);
        }
        ip += mlen;
        anchor = ip;
        if (ip <= ilimit) {
            const int64_t ins = cur + 2;
            hl[zl_hash(src + ins, hlog, 8)] = ZL_IDX(ins);
            hl[zl_hash(src + ip - 2, hlog, 8)] = ZL_IDX(ip - 2);
            hs[zl_hash(src + ins, slog, mls)] = ZL_IDX(ins);
            hs[zl_hash(src + ip - 1, slog, mls)] = ZL_IDX(ip - 1);
            while (ip <= ilimit && rep2 > 0
                   && read32(src + ip) == read32(src + ip - rep2)) {
                const int64_t rl = common_len(src + ip + 4,
                                              src + ip + 4 - rep2, src + n)
                                   + 4;
                const uint32_t tmp = rep2;
                rep2 = rep1;
                rep1 = tmp;
                hs[zl_hash(src + ip, slog, mls)] = ZL_IDX(ip);
                hl[zl_hash(src + ip, hlog, 8)] = ZL_IDX(ip);
                zsink_store(k, anchor, 0, 1, rl);
                ip += rl;
                anchor = ip;
            }
        }
    }
    return anchor;
}

/* libzstd 1.5.7's parameters at level 1, 3, 5, 7, 9, 11, 13, 15 or 22 (the
 * levels of blosc clevel 1 to 9) for a known source of n bytes: the row
 * of its table for the size (up to 16 KiB, 128 KiB, 256 KiB, larger),
 * then ZSTD_adjustCParams_internal (window, hash and chain logs cut to
 * the source) */
typedef struct {
    int wlog, clog, hlog, slog, mls, tlen, strat;
} zparams;

/* blosc clevel 1-9 -> libzstd level: 2 * clevel - 1, and its maximum, 22,
 * at clevel 9 */
static int zstd_lib_level(int clevel)
{
    return clevel == 9 ? 22 : 2 * clevel - 1;
}

static zparams zstd_lib_params(int level, int64_t n)
{
    /* W, C, H, S, L, TL, strategy of levels 1, 3, ..., 15, 22 */
    static const int16_t rows[4][9][7] = {
        {{14, 14, 15, 1, 5, 0, 1}, {14, 14, 15, 2, 4, 0, 2},
         {14, 14, 14, 3, 4, 4, 4}, {14, 14, 14, 6, 4, 8, 5},
         {14, 15, 14, 5, 4, 8, 6}, {14, 15, 14, 3, 4, 12, 7},
         {14, 15, 14, 5, 3, 32, 8}, {14, 15, 15, 7, 3, 256, 8},
         {14, 15, 15, 10, 3, 999, 9}},
        {{17, 12, 13, 1, 6, 0, 1}, {17, 15, 16, 2, 5, 0, 2},
         {17, 16, 17, 3, 4, 2, 3}, {17, 16, 17, 3, 4, 8, 5},
         {17, 16, 17, 5, 4, 8, 5}, {17, 17, 17, 5, 4, 8, 6},
         {17, 18, 17, 3, 4, 12, 7}, {17, 18, 17, 6, 3, 256, 7},
         {17, 18, 17, 11, 3, 999, 9}},
        {{18, 13, 14, 1, 6, 0, 1}, {18, 16, 16, 1, 4, 0, 2},
         {18, 17, 18, 5, 5, 2, 3}, {18, 18, 19, 4, 4, 4, 4},
         {18, 18, 19, 5, 4, 8, 5}, {18, 18, 19, 5, 4, 12, 6},
         {18, 18, 19, 4, 4, 16, 7}, {18, 18, 19, 6, 3, 128, 7},
         {18, 19, 19, 13, 3, 999, 9}},
        {{19, 13, 14, 1, 7, 0, 1}, {21, 16, 17, 1, 5, 0, 2},
         {21, 18, 19, 3, 5, 2, 3}, {21, 19, 20, 4, 5, 8, 4},
         {22, 20, 21, 4, 5, 16, 5}, {22, 21, 22, 6, 5, 16, 5},
         {22, 22, 22, 4, 5, 32, 6}, {22, 23, 23, 6, 5, 32, 6},
         {27, 27, 25, 9, 3, 999, 9}}};
    const int16_t *r = rows[n <= 16 * 1024 ? 0 : n <= 128 * 1024 ? 1
                            : n <= 256 * 1024 ? 2 : 3]
                           [level == 22 ? 8 : (level - 1) / 2];
    zparams p = {r[0], r[1], r[2], r[3], r[4], r[5], r[6]};
    const int srclog = n < 64 ? 6 : highbit32((uint32_t)(n - 1)) + 1;
    if (p.wlog > srclog)
        p.wlog = srclog;
    if (p.hlog > p.wlog + 1)
        p.hlog = p.wlog + 1;
    const int cycle = p.clog - (p.strat >= ZST_BTLAZY2);
    if (cycle > p.wlog)
        p.clog -= cycle - p.wlog;
    if (p.wlog < 10)
        p.wlog = 10;
    return p;
}

/* ------------------------------------------ libzstd's lazy matchers */

/* search methods: hash chain, row hash, binary tree */
#define ZS_HC 0
#define ZS_ROW 1
#define ZS_BT 2

/* ZSTD_MatchState_t for the lazy parsers on one frame: positions are
 * libzstd's indices, the frame's byte p at index p + 2 */
typedef struct {
    const uint8_t *src;
    int search, depth, hlog, clog, slog, mls, wlog, rowlog;
    uint32_t *ht;       /* hash table; the row matcher's rows */
    uint32_t *chain;    /* hash chain, or the binary tree's pairs */
    uint8_t *tags;      /* the row matcher's tags, each row's head first */
    uint32_t next;      /* nextToUpdate */
    int skipping;       /* lazySkipping */
} zlazy;

#define ZB(z, idx) ((z)->src + (idx) - 2)

/* ZSTD_getLowestMatchIndex (no dictionary) */
static uint32_t zl_low(const zlazy *z, uint32_t curr)
{
    const uint32_t maxd = 1u << z->wlog;
    return curr - 2 > maxd ? curr - maxd : 2;
}

/* ZSTD_HcFindBestMatch: the longest of 2^slog candidates in the chain of
 * ip's hash (ZSTD_insertAndFindFirstIndex enters the positions before ip;
 * in lazy skipping only the first of them) */
static int64_t zhc_find(zlazy *z, int64_t ip, int64_t iend, uint32_t *ofb)
{
    const uint8_t *src = z->src;
    const uint32_t curr = (uint32_t)ip + 2, csize = 1u << z->clog;
    const uint32_t mask = csize - 1, low = zl_low(z, curr);
    const uint32_t minchain = curr > csize ? curr - csize : 0;
    uint32_t attempts = 1u << z->slog;
    for (uint32_t idx = z->next; idx < curr;) {
        const uint32_t h = zl_hash(ZB(z, idx), z->hlog, z->mls);
        z->chain[idx & mask] = z->ht[h];
        z->ht[h] = idx++;
        if (z->skipping)
            break;
    }
    z->next = curr;
    uint32_t m = z->ht[zl_hash(src + ip, z->hlog, z->mls)];
    int64_t ml = 3;
    for (; m >= low && attempts > 0; attempts--) {
        const int64_t mp = (int64_t)m - 2;
        int64_t len = 0;
        if (read32(src + mp + ml - 3) == read32(src + ip + ml - 3))
            len = common_len(src + ip, src + mp, src + iend);
        if (len > ml) {
            ml = len;
            *ofb = curr - m + 3;
            if (ip + len == iend)
                break;
        }
        if (m <= minchain)
            break;
        m = z->chain[m & mask];
    }
    return ml;
}

/* the row matcher's hash of index idx: its row above 8 bits of tag */
static uint32_t zrow_hash(const zlazy *z, uint32_t idx)
{
    return zl_hash(ZB(z, idx), z->hlog - z->rowlog + 8, z->mls);
}

/* ZSTD_row_nextIndex: the row's next slot, cycling down through
 * [1, entries) (slot 0 holds the head) */
static uint32_t zrow_slot(uint8_t *tagrow, uint32_t mask)
{
    uint32_t next = (uint32_t)(tagrow[0] - 1) & mask;
    next += next == 0 ? mask : 0;
    tagrow[0] = (uint8_t)next;
    return next;
}

static void zrow_insert(zlazy *z, uint32_t idx)
{
    /* the row 8 positions on, fetched ahead as libzstd's hash cache does
     * (its bytes lie within the block) */
    const uint32_t ahead = (zrow_hash(z, idx + 8) >> 8) << z->rowlog;
    __builtin_prefetch(z->tags + ahead);
    __builtin_prefetch(z->ht + ahead);
    const uint32_t h = zrow_hash(z, idx);
    const uint32_t rel = (h >> 8) << z->rowlog;
    const uint32_t slot = zrow_slot(z->tags + rel, (1u << z->rowlog) - 1);
    z->tags[rel + slot] = (uint8_t)h;
    z->ht[rel + slot] = idx;
}

/* ZSTD_RowFindBestMatch: the rows' candidates of ip's tag from the
 * newest, at most 2^min(slog, rowlog), then ip entered. The positions
 * before ip are entered first (ZSTD_row_update_internal: past a long
 * match only its first 96 and last 32), none in lazy skipping. libzstd's
 * hash cache holds these same hashes and its salt permutes the rows and
 * tags alike, so neither changes a candidate. */
static int64_t zrow_find(zlazy *z, int64_t ip, int64_t iend, uint32_t *ofb)
{
    const uint8_t *src = z->src;
    const uint32_t curr = (uint32_t)ip + 2, low = zl_low(z, curr);
    const uint32_t entries = 1u << z->rowlog, mask = entries - 1;
    uint32_t attempts = 1u << (z->slog < z->rowlog ? z->slog : z->rowlog);
    if (!z->skipping) {
        uint32_t idx = z->next;
        if (curr - idx > 384) {
            for (const uint32_t bound = idx + 96; idx < bound; ++idx)
                zrow_insert(z, idx);
            idx = curr - 32;
        }
        for (; idx < curr; ++idx)
            zrow_insert(z, idx);
    }
    z->next = curr;
    const uint32_t h = zrow_hash(z, curr);
    const uint32_t rel = (h >> 8) << z->rowlog;
    uint8_t *tagrow = z->tags + rel;
    uint32_t *row = z->ht + rel;
    const uint32_t head = tagrow[0] & mask;
    uint32_t cand[64];
    int nc = 0;
    /* the slots holding the tag (8 at a time), rotated to start at the
     * head: the newest first (ZSTD_row_getMatchMask) */
    uint64_t hits = 0;
    for (uint32_t w = 0; w < entries; w += 8) {
        uint64_t x;
        memcpy(&x, tagrow + w, 8);
        x ^= 0x0101010101010101ULL * (uint8_t)h;
        const uint64_t low7 = 0x7F7F7F7F7F7F7F7FULL;
        const uint64_t zero = ~(((x & low7) + low7) | x | low7);
        hits |= ((zero >> 7) * 0x0102040810204080ULL) >> 56 << w;
    }
    if (head)
        hits = (hits >> head) | (hits << (entries - head));
    if (entries < 64)
        hits &= (1ULL << entries) - 1;
    for (; hits && attempts > 0; hits &= hits - 1) {
        const uint32_t slot = (head + (uint32_t)__builtin_ctzll(hits)) & mask;
        if (slot == 0)
            continue;
        if (row[slot] < low)
            break;
        __builtin_prefetch(ZB(z, row[slot]));
        cand[nc++] = row[slot];
        attempts--;
    }
    const uint32_t slot = zrow_slot(tagrow, mask);
    tagrow[slot] = (uint8_t)h;
    row[slot] = z->next++;
    int64_t ml = 3;
    for (int c = 0; c < nc; ++c) {
        const int64_t mp = (int64_t)cand[c] - 2;
        int64_t len = 0;
        if (read32(src + mp + ml - 3) == read32(src + ip + ml - 3))
            len = common_len(src + ip, src + mp, src + iend);
        if (len > ml) {
            ml = len;
            *ofb = curr - cand[c] + 3;
            if (ip + len == iend)
                break;
        }
    }
    return ml;
}

#define DUBT_UNSORTED 1

/* ZSTD_insertDUBT1: sort index curr into the tree, at most nbcmp
 * comparisons, none at or below btlow */
static void zbt_insert1(zlazy *z, uint32_t curr, int64_t iend, uint32_t nbcmp,
                        uint32_t btlow)
{
    uint32_t *bt = z->chain;
    const uint32_t btmask = (1u << (z->clog - 1)) - 1;
    const uint8_t *ip = ZB(z, curr), *end = z->src + iend;
    uint32_t *smaller = bt + 2 * (curr & btmask), *larger = smaller + 1;
    uint32_t m = *smaller, dummy;
    const uint32_t wlow = zl_low(z, curr);
    int64_t cs = 0, cl = 0;
    for (; nbcmp && m > wlow; --nbcmp) {
        uint32_t *nextp = bt + 2 * (m & btmask);
        const uint8_t *match = ZB(z, m);
        int64_t ml = cs < cl ? cs : cl;
        ml += common_len(ip + ml, match + ml, end);
        if (ip + ml == end)
            break;
        if (match[ml] < ip[ml]) {
            *smaller = m;
            cs = ml;
            if (m <= btlow) {
                smaller = &dummy;
                break;
            }
            smaller = nextp + 1;
            m = nextp[1];
        } else {
            *larger = m;
            cl = ml;
            if (m <= btlow) {
                larger = &dummy;
                break;
            }
            larger = nextp;
            m = nextp[0];
        }
    }
    *smaller = *larger = 0;
}

/* ZSTD_BtFindBestMatch: ZSTD_updateDUBT enters the positions before ip
 * unsorted, ZSTD_DUBT_findBestMatch sorts the newest of ip's hash and
 * searches the tree for the match of the best gain; nothing inside the
 * area a long match skipped */
static int64_t zbt_find(zlazy *z, int64_t ip, int64_t iend, uint32_t *ofb)
{
    uint32_t *bt = z->chain, *ht = z->ht;
    const uint32_t btmask = (1u << (z->clog - 1)) - 1;
    const uint32_t curr = (uint32_t)ip + 2;
    if (curr < z->next)
        return 0;
    for (uint32_t idx = z->next; idx < curr; ++idx) {
        const uint32_t h = zl_hash(ZB(z, idx), z->hlog, z->mls);
        bt[2 * (idx & btmask)] = ht[h];
        bt[2 * (idx & btmask) + 1] = DUBT_UNSORTED;
        ht[h] = idx;
    }
    z->next = curr;
    const uint32_t h = zl_hash(z->src + ip, z->hlog, z->mls);
    const uint32_t wlow = zl_low(z, curr);
    const uint32_t btlow = btmask >= curr ? 0 : curr - btmask;
    const uint32_t unsort_limit = btlow > wlow ? btlow : wlow;
    uint32_t nbcmp = 1u << z->slog, nbcand = nbcmp, prev = 0;
    uint32_t m = ht[h];
    uint32_t *next_cand = bt + 2 * (m & btmask), *mark = next_cand + 1;
    while (m > unsort_limit && *mark == DUBT_UNSORTED && nbcand > 1) {
        *mark = prev;     /* a chain back up to the newest */
        prev = m;
        m = *next_cand;
        next_cand = bt + 2 * (m & btmask);
        mark = next_cand + 1;
        nbcand--;
    }
    if (m > unsort_limit && *mark == DUBT_UNSORTED)
        *next_cand = *mark = 0;
    for (m = prev; m;) {
        const uint32_t up = bt[2 * (m & btmask) + 1];
        zbt_insert1(z, m, iend, nbcand, unsort_limit);
        m = up;
        nbcand++;
    }
    const uint8_t *in = z->src + ip, *end = z->src + iend;
    uint32_t *smaller = bt + 2 * (curr & btmask), *larger = smaller + 1;
    uint32_t match_end = curr + 8 + 1, dummy;
    int64_t cs = 0, cl = 0, best = 0;
    m = ht[h];
    ht[h] = curr;
    for (; nbcmp && m > wlow; --nbcmp) {
        uint32_t *nextp = bt + 2 * (m & btmask);
        const uint8_t *match = ZB(z, m);
        int64_t ml = cs < cl ? cs : cl;
        ml += common_len(in + ml, match + ml, end);
        if (ml > best) {
            if (ml > (int64_t)(match_end - m))
                match_end = m + (uint32_t)ml;
            if (4 * (int)(ml - best) > (int)((uint32_t)highbit32(curr - m + 1)
                                             - (uint32_t)highbit32(*ofb))) {
                best = ml;
                *ofb = curr - m + 3;
            }
            if (in + ml == end)
                break;
        }
        if (match[ml] < in[ml]) {
            *smaller = m;
            cs = ml;
            if (m <= btlow) {
                smaller = &dummy;
                break;
            }
            smaller = nextp + 1;
            m = nextp[1];
        } else {
            *larger = m;
            cl = ml;
            if (m <= btlow) {
                larger = &dummy;
                break;
            }
            larger = nextp;
            m = nextp[0];
        }
    }
    *smaller = *larger = 0;
    z->next = match_end - 8;     /* skip repetitive patterns */
    return best;
}

static int64_t zlazy_find(zlazy *z, int64_t ip, int64_t iend, uint32_t *ofb)
{
    *ofb = 999999999;    /* libzstd's start, whose high bit the gains read */
    if (z->search == ZS_ROW)
        return zrow_find(z, ip, iend, ofb);
    if (z->search == ZS_BT)
        return zbt_find(z, ip, iend, ofb);
    return zhc_find(z, ip, iend, ofb);
}

/* ZSTD_compressBlock_lazy_generic (no dictionary) at depth 0 (greedy), 1
 * (lazy) or 2 (lazy2, btlazy2) on block [istart, iend) of the frame: its
 * sequences into k, rep[0] and rep[1] carried; returns where its last
 * literals start */
static int64_t zlazy_block(zlazy *z, zsink *k, int64_t istart, int64_t iend,
                           uint32_t *rep)
{
    const uint8_t *src = z->src;
    const int depth = z->depth;
    const int64_t ilimit = iend - 8 - (z->search == ZS_ROW ? 8 : 0);
    int64_t ip = istart + (istart == 0), anchor = istart;
    uint32_t off1 = rep[0], off2 = rep[1], saved1 = 0, saved2 = 0;
    {
        const uint32_t curr = (uint32_t)ip + 2;
        const uint32_t maxrep = curr - zl_low(z, curr);
        if (off2 > maxrep) {
            saved2 = off2;
            off2 = 0;
        }
        if (off1 > maxrep) {
            saved1 = off1;
            off1 = 0;
        }
    }
    z->skipping = 0;
    while (ip < ilimit) {
        int64_t ml = 0, start = ip + 1;
        uint32_t ofb = 1, found;
        if (off1 > 0 && read32(src + ip + 1 - off1) == read32(src + ip + 1)) {
            ml = common_len(src + ip + 5, src + ip + 5 - off1, src + iend) + 4;
            if (depth == 0)
                goto store;
        }
        {
            const int64_t ml2 = zlazy_find(z, ip, iend, &found);
            if (ml2 > ml) {
                ml = ml2;
                start = ip;
                ofb = found;
            }
        }
        if (ml < 4) {
            const int64_t step = ((ip - anchor) >> 8) + 1;
            ip += step;
            z->skipping = step > 8;
            continue;
        }
        /* a better match one or two positions on? */
        while (depth >= 1 && ip < ilimit) {
            ip++;
            if (off1 > 0 && read32(src + ip) == read32(src + ip - off1)) {
                const int64_t mlrep = common_len(src + ip + 4,
                                                 src + ip + 4 - off1,
                                                 src + iend) + 4;
                const int gain2 = (int)(mlrep * 3);
                const int gain1 = (int)(ml * 3 - highbit32(ofb) + 1);
                if (mlrep >= 4 && gain2 > gain1) {
                    ml = mlrep;
                    ofb = 1;
                    start = ip;
                }
            }
            {
                const int64_t ml2 = zlazy_find(z, ip, iend, &found);
                const int gain2 = (int)(ml2 * 4 - highbit32(found));
                const int gain1 = (int)(ml * 4 - highbit32(ofb) + 4);
                if (ml2 >= 4 && gain2 > gain1) {
                    ml = ml2;
                    ofb = found;
                    start = ip;
                    continue;
                }
            }
            if (depth == 2 && ip < ilimit) {
                ip++;
                if (off1 > 0 && read32(src + ip) == read32(src + ip - off1)) {
                    const int64_t mlrep = common_len(src + ip + 4,
                                                     src + ip + 4 - off1,
                                                     src + iend) + 4;
                    const int gain2 = (int)(mlrep * 4);
                    const int gain1 = (int)(ml * 4 - highbit32(ofb) + 1);
                    if (mlrep >= 4 && gain2 > gain1) {
                        ml = mlrep;
                        ofb = 1;
                        start = ip;
                    }
                }
                const int64_t ml2 = zlazy_find(z, ip, iend, &found);
                const int gain2 = (int)(ml2 * 4 - highbit32(found));
                const int gain1 = (int)(ml * 4 - highbit32(ofb) + 7);
                if (ml2 >= 4 && gain2 > gain1) {
                    ml = ml2;
                    ofb = found;
                    start = ip;
                    continue;
                }
            }
            break;
        }
        if (ofb > 3) {      /* a new offset: catch up backwards */
            const uint32_t off = ofb - 3;
            while (start > anchor && start - off > 0
                   && src[start - 1] == src[start - off - 1]) {
                start--;
                ml++;
            }
            off2 = off1;
            off1 = off;
        }
store:
        zsink_store(k, anchor, start - anchor, ofb, ml);
        anchor = ip = start + ml;
        z->skipping = 0;
        /* the second repeat offset, at once */
        while (ip <= ilimit && off2 > 0
               && read32(src + ip) == read32(src + ip - off2)) {
            ml = common_len(src + ip + 4, src + ip + 4 - off2, src + iend) + 4;
            const uint32_t t = off2;
            off2 = off1;
            off1 = t;
            zsink_store(k, anchor, 0, 1, ml);
            ip += ml;
            anchor = ip;
        }
    }
    if (saved1 != 0 && off1 != 0)
        saved2 = saved1;
    rep[0] = off1 ? off1 : saved1;
    rep[1] = off2 ? off2 : saved2;
    return anchor;
}

/* ------------------------------------------- libzstd's optimal parser */

#define ZOPT_NUM (1 << 12)              /* ZSTD_OPT_NUM */
#define ZOPT_SIZE (ZOPT_NUM + 3)
#define ZOPT_MAX_PRICE (1 << 30)
#define ZOPT_BIT 256                    /* BITCOST_MULTIPLIER */
#define ZOPT_PREDEF 8                   /* ZSTD_PREDEF_THRESHOLD */

/* a stretch of the forward pass (ZSTD_optimal_t): a match (mlen, off)
 * then litlen literals, its price, and the repeat offsets after it */
typedef struct {
    int price;
    uint32_t off, mlen, litlen;
    uint32_t rep[3];
} zopt_cell;

typedef struct {
    uint32_t off, len;
} zopt_match;

/* ZSTD_MatchState_t and optState_t of the optimal parser on one frame:
 * the frame's byte p at index p + base, base 2 (btultra2's first pass
 * moves it on by the first block) */
typedef struct {
    const uint8_t *src;
    uint32_t base, low;     /* window.base's index of src[0]; lowLimit */
    int hlog, clog, slog, wlog, mls, mm, tlen, h3log, optlevel;
    uint32_t *ht, *bt, *ht3;
    uint32_t next;          /* nextToUpdate */
    uint32_t lit_freq[256], ll_freq[ZSTD_MAX_LL + 1];
    uint32_t ml_freq[ZSTD_MAX_ML + 1], of_freq[ZSTD_MAX_OF + 1];
    uint32_t lit_sum, ll_sum, ml_sum, of_sum;
    uint32_t lit_price, ll_price, ml_price, of_price;   /* *SumBasePrice */
    int predef;
    zopt_cell *opt;
    zopt_match *matches;
} zopt;

#define ZO(o, idx) ((o)->src + (idx) - (o)->base)

static uint32_t zll_code(uint32_t ll)
{
    static const uint8_t code[64] = {
        0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
        16, 16, 17, 17, 18, 18, 19, 19, 20, 20, 20, 20, 21, 21, 21, 21,
        22, 22, 22, 22, 22, 22, 22, 22, 23, 23, 23, 23, 23, 23, 23, 23,
        24, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24};
    return ll > 63 ? (uint32_t)highbit32(ll) + 19 : code[ll];
}

/* the code of a match length less 3 */
static uint32_t zml_code(uint32_t mlb)
{
    static const uint8_t code[128] = {
        0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
        16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31,
        32, 32, 33, 33, 34, 34, 35, 35, 36, 36, 36, 36, 37, 37, 37, 37,
        38, 38, 38, 38, 38, 38, 38, 38, 39, 39, 39, 39, 39, 39, 39, 39,
        40, 40, 40, 40, 40, 40, 40, 40, 40, 40, 40, 40, 40, 40, 40, 40,
        41, 41, 41, 41, 41, 41, 41, 41, 41, 41, 41, 41, 41, 41, 41, 41,
        42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42,
        42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42};
    return mlb > 127 ? (uint32_t)highbit32(mlb) + 36 : code[mlb];
}

/* WEIGHT: ZSTD_bitWeight (btopt, whole bits) or ZSTD_fracWeight (btultra
 * up), in 1/256 bits */
static uint32_t zo_weight(const zopt *o, uint32_t stat)
{
    const uint32_t s = stat + 1, hb = (uint32_t)highbit32(s);
    return hb * ZOPT_BIT + (o->optlevel ? (s << 8) >> hb : 0);
}

static void zo_set_prices(zopt *o)
{
    o->lit_price = zo_weight(o, o->lit_sum);
    o->ll_price = zo_weight(o, o->ll_sum);
    o->ml_price = zo_weight(o, o->ml_sum);
    o->of_price = zo_weight(o, o->of_sum);
}

/* ZSTD_downscaleStats */
static uint32_t zo_downscale(uint32_t *t, int last, int shift, int base1)
{
    uint32_t sum = 0;
    for (int s = 0; s <= last; ++s) {
        t[s] = (base1 ? 1 : t[s] > 0) + (t[s] >> shift);
        sum += t[s];
    }
    return sum;
}

/* ZSTD_scaleStats: the counts cut down to about 2^logt in all */
static uint32_t zo_scale(uint32_t *t, int last, int logt)
{
    uint32_t sum = 0;
    for (int s = 0; s <= last; ++s)
        sum += t[s];
    const uint32_t factor = sum >> logt;
    return factor <= 1 ? sum : zo_downscale(t, last, highbit32(factor), 1);
}

/* ZSTD_rescaleFreqs: a frame's first block starts from its own bytes'
 * counts and fixed length and offset counts (below 9 bytes, fixed
 * prices); a later one from the counts carried, scaled down */
static void zo_rescale(zopt *o, const uint8_t *src, int64_t n)
{
    static const uint8_t ll0[ZSTD_MAX_LL + 1] = {
        4, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
        1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};
    static const uint8_t of0[ZSTD_MAX_OF + 1] = {
        6, 2, 1, 1, 2, 3, 4, 4, 4, 3, 2, 1, 1, 1, 1, 1,
        1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};
    o->predef = 0;
    if (o->ll_sum == 0) {
        o->predef = n <= ZOPT_PREDEF;
        memset(o->lit_freq, 0, sizeof(o->lit_freq));
        for (int64_t i = 0; i < n; ++i)
            o->lit_freq[src[i]]++;
        o->lit_sum = zo_downscale(o->lit_freq, 255, 8, 0);
        o->ll_sum = 0;
        for (int s = 0; s <= ZSTD_MAX_LL; ++s)
            o->ll_sum += o->ll_freq[s] = ll0[s];
        for (int s = 0; s <= ZSTD_MAX_ML; ++s)
            o->ml_freq[s] = 1;
        o->ml_sum = ZSTD_MAX_ML + 1;
        o->of_sum = 0;
        for (int s = 0; s <= ZSTD_MAX_OF; ++s)
            o->of_sum += o->of_freq[s] = of0[s];
    } else {
        o->lit_sum = zo_scale(o->lit_freq, 255, 12);
        o->ll_sum = zo_scale(o->ll_freq, ZSTD_MAX_LL, 11);
        o->ml_sum = zo_scale(o->ml_freq, ZSTD_MAX_ML, 11);
        o->of_sum = zo_scale(o->of_freq, ZSTD_MAX_OF, 11);
    }
    zo_set_prices(o);
}

/* ZSTD_rawLiteralsCost of one literal */
static int zo_lit_price(const zopt *o, uint8_t c)
{
    if (o->predef)
        return 6 * ZOPT_BIT;
    uint32_t p = zo_weight(o, o->lit_freq[c]);
    if (p > o->lit_price - ZOPT_BIT)
        p = o->lit_price - ZOPT_BIT;
    return (int)(o->lit_price - p);
}

/* ZSTD_litLengthPrice */
static int zo_ll_price(const zopt *o, uint32_t ll)
{
    if (o->predef)
        return (int)zo_weight(o, ll);
    if (ll == ZSTD_BLOCK_MAX)
        return ZOPT_BIT + zo_ll_price(o, ZSTD_BLOCK_MAX - 1);
    const uint32_t c = zll_code(ll);
    return (int)(LL_BITS[c] * ZOPT_BIT + o->ll_price
                 - zo_weight(o, o->ll_freq[c]));
}

/* ZSTD_getMatchPrice of offset value offb and length ml */
static int zo_match_price(const zopt *o, uint32_t offb, uint32_t ml)
{
    const uint32_t ofc = (uint32_t)highbit32(offb), mlb = ml - 3;
    if (o->predef)
        return (int)(zo_weight(o, mlb) + (16 + ofc) * ZOPT_BIT);
    uint32_t price = ofc * ZOPT_BIT + o->of_price
                     - zo_weight(o, o->of_freq[ofc]);
    if (o->optlevel < 2 && ofc >= 20)    /* far offsets cost more */
        price += (ofc - 19) * 2 * ZOPT_BIT;
    const uint32_t mlc = zml_code(mlb);
    price += ML_BITS[mlc] * ZOPT_BIT + o->ml_price
             - zo_weight(o, o->ml_freq[mlc]);
    return (int)(price + ZOPT_BIT / 5);
}

/* ZSTD_updateStats after a sequence */
static void zo_update_stats(zopt *o, uint32_t ll, const uint8_t *lit,
                            uint32_t offb, uint32_t ml)
{
    for (uint32_t u = 0; u < ll; ++u)
        o->lit_freq[lit[u]] += 2;
    o->lit_sum += ll * 2;
    o->ll_freq[zll_code(ll)]++;
    o->ll_sum++;
    o->of_freq[highbit32(offb)]++;
    o->of_sum++;
    o->ml_freq[zml_code(ml - 3)]++;
    o->ml_sum++;
}

/* ZSTD_updateRep: the repeat offsets after a match of offset value offb
 * (ll0: after no literals) */
static void zo_update_rep(uint32_t *rep, uint32_t offb, uint32_t ll0)
{
    if (offb > 3) {
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offb - 3;
        return;
    }
    const uint32_t r = offb - 1 + ll0;
    if (r > 0) {
        const uint32_t cur = r == 3 ? rep[0] - 1 : rep[r];
        rep[2] = r >= 2 ? rep[1] : rep[2];
        rep[1] = rep[0];
        rep[0] = cur;
    }
}

/* ZSTD_getLowestMatchIndex (no dictionary) */
static uint32_t zo_low(const zopt *o, uint32_t curr)
{
    const uint32_t maxd = 1u << o->wlog;
    return curr - o->low > maxd ? curr - maxd : o->low;
}

/* ZSTD_insertBt1: sort index curr into the binary tree; how far on the
 * next insertion may start */
static uint32_t zo_insert_bt1(zopt *o, uint32_t curr, int64_t iend,
                              uint32_t target)
{
    const uint32_t btmask = (1u << (o->clog - 1)) - 1;
    const uint8_t *ip = ZO(o, curr), *end = o->src + iend;
    const uint32_t h = zl_hash(ip, o->hlog, o->mls);
    uint32_t m = o->ht[h], dummy;
    uint32_t *smaller = o->bt + 2 * (curr & btmask), *larger = smaller + 1;
    const uint32_t btlow = btmask >= curr ? 0 : curr - btmask;
    const uint32_t wlow = zo_low(o, target);
    uint32_t match_end = curr + 8 + 1, nbcmp = 1u << o->slog;
    int64_t cs = 0, cl = 0, best = 8;
    o->ht[h] = curr;
    for (; nbcmp && m >= wlow; --nbcmp) {
        uint32_t *nextp = o->bt + 2 * (m & btmask);
        const uint8_t *match = ZO(o, m);
        int64_t ml = cs < cl ? cs : cl;
        ml += common_len(ip + ml, match + ml, end);
        if (ml > best) {
            best = ml;
            if (ml > (int64_t)(match_end - m))
                match_end = m + (uint32_t)ml;
        }
        if (ip + ml == end)
            break;
        if (match[ml] < ip[ml]) {
            *smaller = m;
            cs = ml;
            if (m <= btlow) {
                smaller = &dummy;
                break;
            }
            smaller = nextp + 1;
            m = nextp[1];
        } else {
            *larger = m;
            cl = ml;
            if (m <= btlow) {
                larger = &dummy;
                break;
            }
            larger = nextp;
            m = nextp[0];
        }
    }
    *smaller = *larger = 0;
    const uint32_t skip = best > 384 ? (best - 384 < 192
                                        ? (uint32_t)(best - 384) : 192) : 0;
    return skip > match_end - (curr + 8) ? skip : match_end - (curr + 8);
}

/* the first minMatch (3 or 4) bytes at p (ZSTD_readMINMATCH) */
static uint32_t zo_head(const uint8_t *p, uint32_t mm)
{
    return mm == 3 ? read32(p) << 8 : read32(p);
}

/* ZSTD_btGetAllMatches: ZSTD_updateTree enters the positions before ip
 * (ZSTD_insertBt1), then ZSTD_insertBtAndGetAllMatches: the repeat
 * offsets, the hash3 table's candidate where minMatch is 3, and the tree,
 * each match longer than the last; their count in o->matches */
static int zo_get_matches(zopt *o, uint32_t *next3, int64_t ip, int64_t iend,
                          const uint32_t *rep, uint32_t ll0)
{
    const uint32_t curr = (uint32_t)ip + o->base, mm = o->mm;
    if (curr < o->next)
        return 0;                       /* a skipped area */
    for (uint32_t idx = o->next; idx < curr;)
        idx += zo_insert_bt1(o, idx, iend, curr);
    o->next = curr;
    const uint32_t sufficient = o->tlen < ZOPT_NUM - 1 ? (uint32_t)o->tlen
                                                        : ZOPT_NUM - 1;
    const uint32_t btmask = (1u << (o->clog - 1)) - 1;
    const uint8_t *in = o->src + ip, *end = o->src + iend;
    const uint32_t h = zl_hash(in, o->hlog, o->mls);
    const uint32_t btlow = btmask >= curr ? 0 : curr - btmask;
    const uint32_t wlow = zo_low(o, curr), mlow = wlow ? wlow : 1;
    uint32_t *smaller = o->bt + 2 * (curr & btmask), *larger = smaller + 1;
    uint32_t m = o->ht[h], match_end = curr + 8 + 1, dummy;
    uint32_t nbcmp = 1u << o->slog;
    int64_t cs = 0, cl = 0, best = mm - 1;
    zopt_match *out = o->matches;
    int nm = 0;
    for (uint32_t r = ll0; r < 3 + ll0; ++r) {
        const uint32_t roff = r == 3 ? rep[0] - 1 : rep[r];
        int64_t len = 0;
        if (roff - 1 < curr - o->low && curr - roff >= wlow
                && zo_head(in, mm) == zo_head(in - roff, mm))
            len = common_len(in + mm, in + mm - roff, end) + mm;
        if (len > best) {
            best = len;
            out[nm].off = r - ll0 + 1;
            out[nm].len = (uint32_t)len;
            nm++;
            if (len > sufficient || in + len == end)
                return nm;
        }
    }
    if (o->mls == 3 && best < 3) {
        /* ZSTD_insertAndFindFirstIndexHash3 */
        uint32_t idx = *next3;
        for (; idx < curr; ++idx)
            o->ht3[((read32(ZO(o, idx)) << 8) * 506832829u)
                   >> (32 - o->h3log)] = idx;
        *next3 = curr;
        const uint32_t m3 = o->ht3[((read32(in) << 8) * 506832829u)
                                   >> (32 - o->h3log)];
        if (m3 >= mlow && curr - m3 < (1u << 18)) {
            const int64_t len = common_len(in, ZO(o, m3), end);
            if (len >= 3) {
                best = len;
                out[0].off = curr - m3 + 3;
                out[0].len = (uint32_t)len;
                nm = 1;
                if (len > sufficient || in + len == end) {
                    o->next = curr + 1;     /* not entered in the tree */
                    return 1;
                }
            }
        }
    }
    o->ht[h] = curr;
    for (; nbcmp && m >= mlow; --nbcmp) {
        uint32_t *nextp = o->bt + 2 * (m & btmask);
        const uint8_t *match = ZO(o, m);
        int64_t ml = cs < cl ? cs : cl;
        ml += common_len(in + ml, match + ml, end);
        if (ml > best) {
            if (ml > (int64_t)(match_end - m))
                match_end = m + (uint32_t)ml;
            best = ml;
            out[nm].off = curr - m + 3;
            out[nm].len = (uint32_t)ml;
            nm++;
            if (ml > ZOPT_NUM || in + ml == end)
                break;
        }
        if (match[ml] < in[ml]) {
            *smaller = m;
            cs = ml;
            if (m <= btlow) {
                smaller = &dummy;
                break;
            }
            smaller = nextp + 1;
            m = nextp[1];
        } else {
            *larger = m;
            cl = ml;
            if (m <= btlow) {
                larger = &dummy;
                break;
            }
            larger = nextp;
            m = nextp[0];
        }
    }
    *smaller = *larger = 0;
    o->next = match_end - 8;            /* skip repetitive patterns */
    return nm;
}

/* ZSTD_compressBlock_opt_generic (no dictionary) at optLevel 0 (btopt) or
 * 2 (btultra, btultra2) on block [istart, iend) of the frame: a forward
 * pass prices every position up to ZSTD_OPT_NUM on (a match of more than
 * targetLength bytes taken at once), a backward walk emits the cheapest
 * path; its sequences into k, rep carried; returns where its last
 * literals start */
static int64_t zopt_block(zopt *o, zsink *k, int64_t istart, int64_t iend,
                          uint32_t *rep)
{
    const uint8_t *src = o->src;
    const int64_t ilimit = iend - 8;
    const uint32_t sufficient = o->tlen < ZOPT_NUM - 1 ? (uint32_t)o->tlen
                                                        : ZOPT_NUM - 1;
    const uint32_t mm = o->mm;
    uint32_t next3 = o->next;
    zopt_cell *opt = o->opt, last;
    const zopt_match *matches = o->matches;
    int64_t ip = istart, anchor = istart;
    memset(&last, 0, sizeof(last));
    zo_rescale(o, src + istart, iend - istart);
    ip += (uint32_t)ip + o->base == o->low;
#define LL_INC(l) (zo_ll_price(o, l) - zo_ll_price(o, (l) - 1))
    while (ip < ilimit) {
        uint32_t cur, last_pos = 0;
        {
            const uint32_t litlen = (uint32_t)(ip - anchor);
            const int nb = zo_get_matches(o, &next3, ip, iend, rep, !litlen);
            if (!nb) {
                ip++;
                continue;
            }
            opt[0].mlen = 0;
            opt[0].litlen = litlen;
            opt[0].price = zo_ll_price(o, litlen);
            memcpy(opt[0].rep, rep, sizeof(opt[0].rep));
            if (matches[nb - 1].len > sufficient) {   /* at once */
                last.litlen = 0;
                last.mlen = matches[nb - 1].len;
                last.off = matches[nb - 1].off;
                cur = 0;
                last_pos = last.mlen;
                goto shortest;
            }
            uint32_t pos;
            for (pos = 1; pos < mm; pos++) {
                opt[pos].price = ZOPT_MAX_PRICE;
                opt[pos].mlen = 0;
                opt[pos].litlen = litlen + pos;
            }
            for (int mi = 0; mi < nb; mi++) {
                const uint32_t offb = matches[mi].off;
                for (; pos <= matches[mi].len; pos++) {
                    opt[pos].mlen = pos;
                    opt[pos].off = offb;
                    opt[pos].litlen = 0;
                    opt[pos].price = opt[0].price
                                     + zo_match_price(o, offb, pos)
                                     + zo_ll_price(o, 0);
                }
            }
            last_pos = pos - 1;
            opt[pos].price = ZOPT_MAX_PRICE;
        }
        for (cur = 1; cur <= last_pos; cur++) {
            const int64_t inr = ip + cur;
            /* one literal on from the stretch before, if cheaper */
            const uint32_t litlen = opt[cur - 1].litlen + 1;
            const int price = opt[cur - 1].price + zo_lit_price(o, src[inr - 1])
                              + LL_INC(litlen);
            if (price <= opt[cur].price) {
                const zopt_cell prevm = opt[cur];
                opt[cur] = opt[cur - 1];
                opt[cur].litlen = litlen;
                opt[cur].price = price;
                if (o->optlevel >= 1 && prevm.litlen == 0 && LL_INC(1) < 0
                        && inr < iend) {
                    /* the replaced match and one literal at the next
                     * position, if cheaper there */
                    const int with1 = prevm.price + zo_lit_price(o, src[inr])
                                      + LL_INC(1);
                    const int withmore = price + zo_lit_price(o, src[inr])
                                         + LL_INC(litlen + 1);
                    if (with1 < withmore && with1 < opt[cur + 1].price) {
                        const uint32_t prev = cur - prevm.mlen;
                        opt[cur + 1] = prevm;
                        memcpy(opt[cur + 1].rep, opt[prev].rep,
                               sizeof(opt[0].rep));
                        zo_update_rep(opt[cur + 1].rep, prevm.off,
                                      opt[prev].litlen == 0);
                        opt[cur + 1].litlen = 1;
                        opt[cur + 1].price = with1;
                        if (last_pos < cur + 1)
                            last_pos = cur + 1;
                    }
                }
            }
            if (opt[cur].litlen == 0) {    /* a match ends here */
                const uint32_t prev = cur - opt[cur].mlen;
                memcpy(opt[cur].rep, opt[prev].rep, sizeof(opt[0].rep));
                zo_update_rep(opt[cur].rep, opt[cur].off,
                              opt[prev].litlen == 0);
            }
            if (inr > ilimit)
                continue;
            if (cur == last_pos)
                break;
            if (o->optlevel == 0
                    && opt[cur + 1].price <= opt[cur].price + ZOPT_BIT / 2)
                continue;
            const int base_price = opt[cur].price + zo_ll_price(o, 0);
            const int nb = zo_get_matches(o, &next3, inr, iend, opt[cur].rep,
                                          opt[cur].litlen == 0);
            if (!nb)
                continue;
            const uint32_t longest = matches[nb - 1].len;
            if (longest > sufficient || cur + longest >= ZOPT_NUM
                    || inr + longest >= iend) {
                last.mlen = longest;
                last.off = matches[nb - 1].off;
                last.litlen = 0;
                last_pos = cur + longest;
                goto shortest;
            }
            for (int mi = 0; mi < nb; mi++) {
                const uint32_t offb = matches[mi].off;
                const uint32_t start = mi > 0 ? matches[mi - 1].len + 1 : mm;
                for (uint32_t ml = matches[mi].len; ml >= start; ml--) {
                    const uint32_t pos = cur + ml;
                    const int p = base_price + zo_match_price(o, offb, ml);
                    if (pos > last_pos || p < opt[pos].price) {
                        while (last_pos < pos) {
                            last_pos++;
                            opt[last_pos].price = ZOPT_MAX_PRICE;
                            opt[last_pos].litlen = 1;
                        }
                        opt[pos].mlen = ml;
                        opt[pos].off = offb;
                        opt[pos].litlen = 0;
                        opt[pos].price = p;
                    } else if (o->optlevel == 0) {
                        break;
                    }
                }
            }
            opt[last_pos + 1].price = ZOPT_MAX_PRICE;
        }
        last = opt[last_pos];
        cur = last_pos - last.mlen;
shortest:
        if (last.mlen == 0) {       /* literals only */
            ip += last_pos;
            continue;
        }
        if (last.litlen == 0) {
            uint32_t r[3];
            memcpy(r, opt[cur].rep, sizeof(r));
            zo_update_rep(r, last.off, opt[cur].litlen == 0);
            memcpy(rep, r, sizeof(r));
        } else {
            memcpy(rep, last.rep, sizeof(last.rep));
            cur -= last.litlen;
        }
        /* the backward walk: stretches (a match, then literals) become
         * sequences (literals, then a match), stored from cur + 2 down.
         * libzstd 1.5.7 writes a last stretch's literals and then, not
         * instead, the stretch itself: its literals are not taken, and the
         * next pass starts where its match ends */
        {
            const uint32_t store_end = cur + 2;
            uint32_t store_start, pos = cur;
            if (last.litlen > 0) {
                opt[store_end].litlen = last.litlen;
                opt[store_end].mlen = 0;
                store_start = store_end - 1;
                opt[store_start] = last;
            }
            opt[store_end] = last;
            store_start = store_end;
            for (;;) {
                const zopt_cell s = opt[pos];
                opt[store_start].litlen = s.litlen;
                if (s.mlen == 0)
                    break;
                store_start--;
                opt[store_start] = s;
                pos -= s.litlen + s.mlen;
            }
            for (uint32_t sp = store_start; sp <= store_end; sp++) {
                const uint32_t llen = opt[sp].litlen, mlen = opt[sp].mlen;
                if (mlen == 0) {
                    ip = anchor + llen;
                    continue;
                }
                zo_update_stats(o, llen, src + anchor, opt[sp].off, mlen);
                zsink_store(k, anchor, llen, opt[sp].off, mlen);
                anchor += llen + mlen;
                ip = anchor;
            }
            zo_set_prices(o);
        }
    }
#undef LL_INC
    return anchor;
}

/* ------------------------------------------------- the block splitter */

/* a fingerprint of byte pairs (lib/compress/zstd_preSplit.c) */
typedef struct {
    uint32_t events[1024];
    uint64_t nb;
} zfprint;

static void zfp_record(zfprint *f, const uint8_t *p, int rate, int hlog)
{
    const int64_t limit = 8192 - 2 + 1;
    memset(f->events, 0, sizeof(uint32_t) << hlog);
    for (int64_t i = 0; i < limit; i += rate) {
        const uint32_t pair = (uint32_t)p[i] | (uint32_t)p[i + 1] << 8;
        f->events[hlog == 8 ? p[i] : (pair * 0x9E3779B9u) >> (32 - hlog)]++;
    }
    f->nb = (uint64_t)(limit / rate);
}

/* ZSTD_splitBlock_byChunks at level 1-4 (sampling rates 43, 11, 5, 1):
 * the first 8 KiB step of a full block whose fingerprint differs from the
 * steps before it, or the whole block */
static int64_t zstd_split_block(const uint8_t *p, int level)
{
    static const int rates[4] = {43, 11, 5, 1}, hlogs[4] = {8, 9, 10, 10};
    const int rate = rates[level - 1], hlog = hlogs[level - 1];
    zfprint *f = (zfprint *)calloc(2, sizeof(zfprint));
    if (f == NULL)
        return ERR_NOMEM;
    int penalty = 3;
    int64_t pos;
    zfp_record(&f[0], p, rate, hlog);
    for (pos = 8192; pos <= ZSTD_BLOCK_MAX - 8192; pos += 8192) {
        zfp_record(&f[1], p + pos, rate, hlog);
        uint64_t dist = 0;
        for (int e = 0; e < (1 << hlog); ++e) {
            const int64_t d = (int64_t)f[0].events[e] * (int64_t)f[1].nb
                              - (int64_t)f[1].events[e] * (int64_t)f[0].nb;
            dist += (uint64_t)(d < 0 ? -d : d);
        }
        if (dist >= f[0].nb * f[1].nb * (uint64_t)(14 + penalty) / 16)
            break;
        for (int e = 0; e < 1024; ++e)
            f[0].events[e] += f[1].events[e];
        f[0].nb += f[1].nb;
        if (penalty > 0)
            penalty--;
    }
    free(f);
    return pos <= ZSTD_BLOCK_MAX - 8192 ? pos : ZSTD_BLOCK_MAX;
}

/* ZSTD_optimalBlockSize: a full block is split only after the frame has
 * saved 3 bytes or more (so never the first block); fast (level 0, split
 * from the borders) never reaches it, its frames here holding one block */
static int64_t zstd_block_size(const uint8_t *p, int64_t remaining,
                               int strat, int64_t savings)
{
    static const int levels[10] = {0, 0, 1, 2, 2, 3, 3, 4, 4, 4};
    if (remaining < ZSTD_BLOCK_MAX)
        return remaining;
    if (savings < 3 || levels[strat] == 0)
        return ZSTD_BLOCK_MAX;
    return zstd_split_block(p, levels[strat]);
}

/* ---------------------------------------------- the port's own matcher */

/* search depth of the matcher by clevel */
static int zstd_depth(int clevel)
{
    static const int depth[10] = {1, 1, 2, 4, 8, 16, 32, 64, 128, 256};
    return depth[clevel < 0 ? 0 : clevel > 9 ? 9 : clevel];
}

typedef struct {
    const uint8_t *src;
    int64_t n, next;     /* positions below next are in the tables */
    int hlog, depth;
    int32_t *head, *chain;
} zmatcher;

static void zm_insert_to(zmatcher *m, int64_t ip)
{
    for (; m->next < ip; ++m->next) {
        uint32_t h = (read32(m->src + m->next) * 2654435761u)
                     >> (32 - m->hlog);
        if (m->chain)
            m->chain[m->next] = m->head[h];
        m->head[h] = (int32_t)m->next;
    }
}

/* the offset value of a match at offset off after ll literals, and the
 * repeat offsets after it (RFC 8878 3.1.2.5) */
static uint32_t zstd_offset_value(uint32_t *rep, uint32_t off, uint32_t ll)
{
    uint32_t v;
    if (ll > 0)
        v = off == rep[0] ? 1 : off == rep[1] ? 2 : off == rep[2] ? 3 : 0;
    else
        v = off == rep[1] ? 1 : off == rep[2] ? 2 : off == rep[0] - 1 ? 3 : 0;
    if (v == 0) {
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = off;
        return off + 3;
    }
    int idx = (int)v - 1 + (ll == 0);
    if (idx != 0) {
        if (idx != 1)
            rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = off;
    }
    return v;
}

/* the own matcher's sequences of block [bstart, bend) into k (literal
 * positions relative to the frame); returns where its last literals
 * start */
static int64_t zm_block(zmatcher *m, zsink *k, int64_t bstart, int64_t bend,
                        uint32_t *rep)
{
    const uint8_t *src = m->src;
    int64_t ip = bstart, anchor = bstart;
    while (ip + 4 <= bend) {
        zm_insert_to(m, ip);
        uint32_t seqv = read32(src + ip);
        int64_t best = 0, best_off = 0;
        if (ip > anchor && (int64_t)rep[0] <= ip
                && read32(src + ip - rep[0]) == seqv) {
            best = 4 + common_len(src + ip + 4, src + ip - rep[0] + 4,
                                  src + bend);
            best_off = rep[0];
        } else {
            int64_t cand = m->head[(seqv * 2654435761u) >> (32 - m->hlog)];
            for (int d = 0; d < m->depth && cand >= 0; ++d) {
                if (read32(src + cand) == seqv) {
                    int64_t len = 4 + common_len(src + ip + 4, src + cand + 4,
                                                 src + bend);
                    if (len > best) {
                        best = len;
                        best_off = ip - cand;
                    }
                }
                if (m->chain == NULL)
                    break;
                cand = m->chain[cand];
            }
        }
        if (best >= 4) {
            int64_t ll = ip - anchor;
            zsink_store(k, anchor, ll, zstd_offset_value(rep,
                        (uint32_t)best_off, (uint32_t)ll), best);
            ip += best;
            anchor = ip;
        } else {
            ip += 1 + ((ip - anchor) >> 8);
        }
    }
    return anchor;
}


/* ---------------------------------------------------------------- frame */

static int all_same(const uint8_t *p, int64_t n)
{
    for (int64_t i = 1; i < n; ++i)
        if (p[i] != p[0])
            return 0;
    return 1;
}

/* ------------------------------------------------ the post-block splitter */

/* a block's sequences as ZSTD_deriveBlockSplits sees them: their codes,
 * where each one's literals start (litpos[nseq]: all the literals), and
 * the tables the last compressed block left */
typedef struct {
    const zsink *k;
    const uint8_t *codes[3];        /* literal length, offset, match length */
    const int64_t *litpos;
    int strat, nomem;
    const zentropy *prev;
    zentropy *scratch;
} zsplit;

/* ZSTD_estimateBlockSize_symbolType: a sequence field's bytes in a table
 * of type 0 (predefined), 1 (RLE), 2 or 3 (new, repeated), its extra bits
 * included (an offset code is its own count of extra bits) */
static int64_t zsplit_field_bytes(int type, const uint8_t *codes, int64_t nseq,
                                  int maxcode, const fse_ctable *t,
                                  const uint8_t *extra, const int16_t *defnorm,
                                  int deflog)
{
    uint32_t count[ZSTD_MAX_ML + 1] = {0};
    int max = 0;
    for (int64_t i = 0; i < nseq; ++i)
        count[codes[i]]++;
    for (int s = 0; s <= maxcode; ++s)
        if (count[s])
            max = s;
    uint64_t bits = 0;
    if (type == 0) {
        bits = cross_entropy_cost(defnorm, deflog, count, max);
    } else if (type >= 2) {
        bits = fse_bit_cost(t, count, max);
        if (bits == ZCOST_NONE)
            return nseq * 10;
    }
    for (int64_t i = 0; i < nseq; ++i)
        bits += extra ? extra[codes[i]] : codes[i];
    return (int64_t)(bits >> 3);
}

/* ZSTD_estimateSubBlockSize_seqStore of sequences [s0, s1) (the last
 * ones with the block's last literals): ZSTD_buildBlockEntropyStats from
 * the last compressed block's tables, then ZSTD_estimateBlockSize; an
 * error where libzstd's is */
static int64_t zsplit_estimate(zsplit *sp, int64_t s0, int64_t s1)
{
    const zentropy *prev = sp->prev;
    const int64_t nseq = s1 - s0, l0 = sp->litpos[s0];
    const int64_t nlit = sp->litpos[s1] - l0;
    const uint8_t *lit = sp->k->lit + l0;
    int64_t lit_bytes = nlit;       /* raw */
    if (nlit > 63) {
        uint32_t count[256] = {0}, largest = 0;
        int maxsym = 255;
        for (int64_t i = 0; i < nlit; ++i)
            count[lit[i]]++;
        while (!count[maxsym])
            maxsym--;
        for (int s = 0; s <= maxsym; ++s)
            if (count[s] > largest)
                largest = count[s];
        if (largest == (uint64_t)nlit) {
            lit_bytes = 1;
        } else if (largest > (uint64_t)((nlit >> 7) + 4)) {
            int repeat = prev->huf_mode;
            if (repeat == ZR_CHECK) {       /* HUF_validateCTable */
                int bad = prev->huf.maxsym < maxsym;
                for (int s = 0; !bad && s <= maxsym; ++s)
                    bad = count[s] != 0 && prev->huf.nbits[s] == 0;
                if (bad)
                    repeat = ZR_NONE;
            }
            const int log = huf_optimal_log(count, maxsym, nlit,
                                            sp->strat >= ZST_BTULTRA);
            if (log < 0)
                return log;
            huf_ctable t;
            uint8_t desc[128];
            t.log = huf_build(count, maxsym, log, t.nbits, t.code);
            const uint64_t newc = huf_estimate(t.nbits, count, maxsym);
            const int64_t h = huf_write_table(desc, sizeof(desc), t.nbits,
                                              maxsym, t.log);
            if (h == ERR_NOMEM)
                return h;
            /* libzstd compares an error's size_t as it is */
            const uint64_t hs = h >= 0 ? (uint64_t)h
                                : h == ZE_SMALL ? (uint64_t)-70 : (uint64_t)-1;
            const uint8_t *nbits = NULL;
            uint64_t desc_size = 0;
            if (repeat != ZR_NONE) {
                const uint64_t oldc = huf_estimate(prev->huf.nbits, count,
                                                   maxsym);
                if (oldc < (uint64_t)nlit
                        && (oldc <= hs + newc || hs + 12 >= (uint64_t)nlit))
                    nbits = prev->huf.nbits;
            }
            if (nbits == NULL && newc + hs < (uint64_t)nlit) {
                if (h < 0)
                    return ZE_GENERIC;
                nbits = t.nbits;
                desc_size = hs;
            }
            if (nbits != NULL)
                lit_bytes = (int64_t)(huf_estimate(nbits, count, maxsym)
                                      + desc_size) + (nlit >= 256 ? 6 : 0)
                            + 3 + (nlit >= 1024) + (nlit >= 16384);
        }
    }
    /* ZSTD_buildSequencesStatistics into ZSTD_MAX_FSE_HEADERS_SIZE bytes */
    static const int maxc[3] = {ZSTD_MAX_LL, ZSTD_MAX_OF, ZSTD_MAX_ML};
    static const int logs[3] = {ZSTD_LL_LOG, ZSTD_OF_LOG, ZSTD_ML_LOG};
    static const int defmax[3] = {ZSTD_MAX_LL, 28, ZSTD_MAX_ML};
    static const int deflog[3] = {LL_DEFAULT_LOG, OF_DEFAULT_LOG,
                                  ML_DEFAULT_LOG};
    const int16_t *defnorm[3] = {LL_DEFAULT, OF_DEFAULT, ML_DEFAULT};
    const uint8_t *extra[3] = {LL_BITS, NULL, ML_BITS};
    uint8_t buf[133];
    int64_t op = 0, seq_bytes = 0;
    for (int f = 0; f < 3; ++f) {
        int type, mode;
        const int64_t r = seq_field(sp->codes[f] + s0, nseq, maxc[f], logs[f],
                                    defnorm[f], defmax[f], deflog[f],
                                    sp->strat, &prev->fse[f],
                                    prev->fse_mode[f], &sp->scratch->fse[f],
                                    &mode, &type, buf + op,
                                    (int64_t)sizeof(buf) - op);
        if (r < 0)
            return r;
        op += r;
        seq_bytes += zsplit_field_bytes(type, sp->codes[f] + s0, nseq, maxc[f],
                                        &sp->scratch->fse[f], extra[f],
                                        defnorm[f], deflog[f]);
    }
    seq_bytes += op + 2 + (nseq >= 128) + (nseq >= 0x7F00);
    return seq_bytes + lit_bytes + 3;
}

/* ZSTD_deriveBlockSplitsHelper: split [s0, s1) in half where both halves'
 * estimates undercut the whole's, and each half again (no part under 300
 * sequences, at most 196 splits) */
static void zsplit_derive(zsplit *sp, int64_t s0, int64_t s1, int64_t *parts,
                          int *nparts)
{
    const int64_t mid = (s0 + s1) / 2;
    if (s1 - s0 < 300 || *nparts >= 196 || sp->nomem)
        return;
    const int64_t whole = zsplit_estimate(sp, s0, s1);
    const int64_t first = zsplit_estimate(sp, s0, mid);
    const int64_t second = zsplit_estimate(sp, mid, s1);
    if (whole == ERR_NOMEM || first == ERR_NOMEM || second == ERR_NOMEM) {
        sp->nomem = 1;
        return;
    }
    if (whole < 0 || first < 0 || second < 0)
        return;
    if (first + second < whole) {
        zsplit_derive(sp, s0, mid, parts, nparts);
        parts[(*nparts)++] = mid;
        zsplit_derive(sp, mid, s1, parts, nparts);
    }
}

/* ZSTD_seqStore_resolveOffCodes: a repeat offset that means another
 * offset to the decoder (drep: its history, which raw and RLE blocks
 * reset; crep: the matcher's) becomes the offset it meant */
static void zsplit_resolve(uint32_t *drep, uint32_t *crep, zseq *seq,
                           int64_t nseq)
{
    for (int64_t i = 0; i < nseq; ++i) {
        const uint32_t ll0 = seq[i].ll == 0, offb = seq[i].ofv;
        if (offb <= 3) {
            const uint32_t r = offb - 1 + ll0;
            const uint32_t d = r == 3 ? drep[0] - 1 : drep[r];
            const uint32_t c = r == 3 ? crep[0] - 1 : crep[r];
            if (d != c)
                seq[i].ofv = c + 3;
        }
        zo_update_rep(drep, seq[i].ofv, ll0);
        zo_update_rep(crep, offb, ll0);
    }
}

/* the frame's tables and repeat offsets between blocks */
typedef struct {
    zentropy *prev, *next;      /* the last compressed block's; scratch */
    int strat, first;
} zblocks;

/* ZSTD_compressSeqStore_singleBlock: src[0, n) from sequences seq[0,
 * nseq) and literals lit[0, nlit) as one block at dst (its header first;
 * raw where it does not compress, RLE for a later block of one byte
 * value): its size, or an error; *btype its type, and a partition's repeat
 * offsets resolved first */
static int64_t zstd_seq_block(zblocks *b, const uint8_t *src, int64_t n,
                              const uint8_t *lit, int64_t nlit, zseq *seq,
                              int64_t nseq, uint32_t *drep, uint32_t *crep,
                              int last, uint8_t *dst, int64_t cap, int *btype)
{
    uint32_t dorig[3];
    memcpy(dorig, drep, sizeof(dorig));
    if (crep != NULL)
        zsplit_resolve(drep, crep, seq, nseq);
    if (cap < 3)
        return ZE_SMALL;
    int64_t c = zstd_block_body(lit, nlit, seq, nseq, b->strat, b->prev,
                                b->next, n, dst + 3, cap - 3);
    if (c < 0)
        return c;
    if (!b->first && c < 25 && all_same(src, n))
        c = 1;
    uint32_t size = (uint32_t)c;
    if (c == 0) {
        if (n + 3 > cap)
            return ZE_SMALL;
        *btype = 0;
        size = (uint32_t)n;
        memcpy(dst + 3, src, (size_t)n);
        c = n;
    } else if (c == 1) {
        if (cap < 4)
            return ZE_SMALL;
        *btype = 1;
        size = (uint32_t)n;
        dst[3] = src[0];
    } else {
        /* ZSTD_blockState_confirmRepcodesAndEntropyTables */
        zentropy *t = b->prev;
        b->prev = b->next;
        b->next = t;
        *btype = 2;
    }
    if (*btype != 2)
        memcpy(drep, dorig, sizeof(dorig));
    const uint32_t bh = (uint32_t)last | (uint32_t)(*btype << 1) | (size << 3);
    dst[0] = (uint8_t)bh;
    dst[1] = (uint8_t)(bh >> 8);
    dst[2] = (uint8_t)(bh >> 16);
    return 3 + c;
}

/* ZSTD_compressBlock_internal (one block) or, with split,
 * ZSTD_compressBlock_splitBlock_internal (in partitions where
 * ZSTD_deriveBlockSplits finds them): block src[0, n) of sequences k
 * (rep: the matcher's repeat offsets after it, as the next block sees
 * them after the call; saved: those before it) at dst; their size, or an
 * error */
static int64_t zstd_split_blocks(zblocks *b, const uint8_t *src, int64_t n,
                                 zsink *k, uint32_t *rep,
                                 const uint32_t *saved, int split, int last,
                                 uint8_t *dst, int64_t cap)
{
    const int64_t nseq = k->nseq;
    int64_t *parts = NULL, *litpos = NULL, out = 0;
    uint8_t *codes = NULL;
    int nparts = 0, btype;
    uint32_t drep[3], crep[3];
    memcpy(drep, saved, sizeof(drep));
    memcpy(crep, saved, sizeof(crep));
    if (split && nseq > 4) {
        parts = (int64_t *)malloc(sizeof(int64_t) * 197);
        litpos = (int64_t *)malloc(sizeof(int64_t) * (size_t)(nseq + 1));
        codes = (uint8_t *)malloc((size_t)nseq * 3);
        if (parts == NULL || litpos == NULL || codes == NULL) {
            out = ERR_NOMEM;
            goto done;
        }
        zsplit sp = {k, {codes, codes + nseq, codes + 2 * nseq}, litpos,
                     b->strat, 0, b->prev, b->next};
        litpos[0] = 0;
        for (int64_t i = 0; i < nseq; ++i) {
            codes[i] = (uint8_t)zll_code(k->seq[i].ll);
            codes[nseq + i] = (uint8_t)highbit32(k->seq[i].ofv);
            codes[2 * nseq + i] = (uint8_t)zml_code(k->seq[i].ml - 3);
            litpos[i + 1] = litpos[i] + k->seq[i].ll;
        }
        litpos[nseq] = k->nlit;
        zsplit_derive(&sp, 0, nseq, parts, &nparts);
        if (sp.nomem) {
            out = ERR_NOMEM;
            goto done;
        }
    }
    if (nparts == 0) {
        out = zstd_seq_block(b, src, n, k->lit, k->nlit, k->seq, nseq, drep,
                             NULL, last, dst, cap, &btype);
        if (out >= 0 && btype != 2)
            memcpy(rep, saved, 3 * sizeof(uint32_t));
        goto done;
    }
    parts[nparts] = nseq;
    {
        int64_t s0 = 0, done_bytes = 0;
        for (int i = 0; i <= nparts; ++i) {
            const int64_t s1 = parts[i], l0 = litpos[s0], l1 = litpos[s1];
            int64_t bytes = 0;
            for (int64_t j = s0; j < s1; ++j)
                bytes += k->seq[j].ll + k->seq[j].ml;
            if (i == nparts)
                bytes = n - done_bytes;
            const int64_t c = zstd_seq_block(b, src + done_bytes, bytes,
                                              k->lit + l0, l1 - l0, k->seq + s0,
                                              s1 - s0, drep, crep,
                                              last && i == nparts, dst + out,
                                              cap - out, &btype);
            if (c < 0) {
                out = c;
                goto done;
            }
            out += c;
            done_bytes += bytes;
            s0 = s1;
        }
    }
    memcpy(rep, drep, sizeof(drep));
done:
    free(parts);
    free(litpos);
    free(codes);
    return out;
}

/* the longest input clevel follows libzstd on: its blosc block */
static int64_t zstd_lib_maxsrc(int clevel)
{
    return (int64_t)ZSTD_BLOCK_MAX << (clevel <= 2 ? 0 : clevel <= 5 ? 1
                                       : clevel <= 8 ? 2 : 3);
}

/* The zstd frame of src[0, n) into dst; its size, 0 where libzstd would
 * fail for want of cap bytes (c-blosc then stores the block), or an
 * error. */
int64_t zstd_compress(const uint8_t *src, int64_t n, uint8_t *dst,
                      int64_t cap, int clevel)
{
    if (n < 0 || n > 0x7fffffff)
        return ERR_ARGS;
    /* ZSTD_writeFrameHeader wants room for the largest header */
    if (cap < 18)
        return 0;
    const int lib = clevel >= 1 && clevel <= 9 && n <= zstd_lib_maxsrc(clevel);
    int64_t pos = 4;
    write32(dst, ZSTD_MAGIC);
    if (n < 256) {
        dst[pos++] = 0x20;
        dst[pos++] = (uint8_t)n;
    } else if (n < 65536 + 256) {
        dst[pos++] = 0x60;
        dst[pos++] = (uint8_t)(n - 256);
        dst[pos++] = (uint8_t)((n - 256) >> 8);
    } else {
        dst[pos++] = 0xA0;
        write32(dst + pos, n);
        pos += 4;
    }
    if (n == 0) {     /* the epilogue: an empty last raw block */
        dst[pos] = 1;
        dst[pos + 1] = dst[pos + 2] = 0;
        return pos + 3;
    }
    int64_t bmax = n < ZSTD_BLOCK_MAX ? n : ZSTD_BLOCK_MAX;
    zparams p = {0, 0, 0, 0, 0, 0, ZST_DFAST};
    zmatcher m = {src, n, 0, 0, zstd_depth(clevel), NULL, NULL};
    zlazy z;
    zopt o;
    memset(&z, 0, sizeof(z));
    memset(&o, 0, sizeof(o));
    uint32_t *ht = NULL;
    zsink k = {src, NULL, 0, NULL, 0};
    zentropy *ent = (zentropy *)malloc(2 * sizeof(zentropy));
    int64_t rc = 0;
    k.seq = (zseq *)malloc(sizeof(zseq) * (size_t)(bmax / 3 + 1));
    k.lit = (uint8_t *)malloc((size_t)bmax + 1);
    int ok = k.seq != NULL && k.lit != NULL && ent != NULL;
    if (lib) {
        p = zstd_lib_params(zstd_lib_level(clevel), n);
        size_t cells = (size_t)1 << p.hlog;
        if (p.strat == ZST_DFAST)
            cells += (size_t)1 << p.clog;
        if (p.strat >= ZST_BTOPT) {
            o.src = src;
            o.base = o.low = o.next = 2;
            o.hlog = p.hlog;
            o.clog = p.clog;
            o.slog = p.slog;
            o.wlog = p.wlog;
            o.mls = p.mls < 3 ? 3 : p.mls > 6 ? 6 : p.mls;
            o.mm = p.mls == 3 ? 3 : 4;
            o.tlen = p.tlen;
            o.optlevel = p.strat == ZST_BTOPT ? 0 : 2;
            o.h3log = p.mls == 3 ? (p.wlog < 17 ? p.wlog : 17) : 0;
            o.bt = (uint32_t *)calloc((size_t)1 << p.clog, sizeof(uint32_t));
            if (o.h3log)
                o.ht3 = (uint32_t *)calloc((size_t)1 << o.h3log,
                                           sizeof(uint32_t));
            o.opt = (zopt_cell *)calloc(ZOPT_SIZE, sizeof(zopt_cell));
            o.matches = (zopt_match *)calloc(ZOPT_SIZE, sizeof(zopt_match));
            ok = ok && o.bt != NULL && (!o.h3log || o.ht3 != NULL)
                 && o.opt != NULL && o.matches != NULL;
        } else if (p.strat >= ZST_GREEDY) {
            z.src = src;
            z.depth = p.strat == ZST_GREEDY ? 0 : p.strat == ZST_LAZY ? 1 : 2;
            z.search = p.strat == ZST_BTLAZY2 ? ZS_BT
                       : p.wlog > 14 ? ZS_ROW : ZS_HC;
            z.hlog = p.hlog;
            z.clog = p.clog;
            z.slog = p.slog;
            z.wlog = p.wlog;
            z.mls = p.mls < 4 ? 4 : p.mls > 6 ? 6 : p.mls;
            z.rowlog = p.slog < 4 ? 4 : p.slog > 6 ? 6 : p.slog;
            z.next = 2;
            if (z.search == ZS_ROW)
                z.tags = (uint8_t *)calloc(cells, 1);
            else
                z.chain = (uint32_t *)calloc((size_t)1 << p.clog,
                                             sizeof(uint32_t));
            ok = ok && (z.tags != NULL || z.chain != NULL);
        }
        ht = (uint32_t *)calloc(cells, sizeof(uint32_t));
        z.ht = o.ht = ht;
        ok = ok && ht != NULL;
    } else {
        int hlog = n > 1 ? highbit32((uint32_t)(n - 1)) : 10;
        m.hlog = hlog < 10 ? 10 : hlog > 17 ? 17 : hlog;
        m.head = (int32_t *)malloc(sizeof(int32_t) << m.hlog);
        if (m.depth > 1)
            m.chain = (int32_t *)malloc(sizeof(int32_t) * (size_t)(n + 1));
        ok = ok && m.head != NULL && (m.depth == 1 || m.chain != NULL);
    }
    if (!ok) {
        rc = ERR_NOMEM;
        goto done;
    }
    if (!lib)
        for (int i = 0; i < (1 << m.hlog); ++i)
            m.head[i] = -1;
    /* the tables of the last compressed block, and a block's own; the
     * post-block splitter from btopt up over windows of 128 KiB or more */
    zblocks b = {&ent[0], &ent[1], p.strat, 1};
    const int split = lib && p.strat >= ZST_BTOPT && p.wlog >= 17;
    zentropy_reset(b.prev);
    uint32_t rep[3] = {1, 4, 8};
    int64_t bstart = 0, savings = 0;
    do {
        const int64_t bn = lib ? zstd_block_size(src + bstart, n - bstart,
                                                 p.strat, savings)
                               : n - bstart < ZSTD_BLOCK_MAX ? n - bstart
                                                            : ZSTD_BLOCK_MAX;
        if (bn < 0) {
            rc = bn;
            goto done;
        }
        const int64_t bend = bstart + bn;
        const int last = bend == n;
        const int64_t room = cap - pos;
        const uint32_t saved[3] = {rep[0], rep[1], rep[2]};
        int64_t c;
        if (room < 3 + 2 + 1) {
            rc = 0;
            goto done;
        }
        /* ZSTD_buildSeqStore: no attempt under 7 bytes */
        if (bn < 7) {
            if (bn + 3 > room) {
                rc = 0;
                goto done;
            }
            const uint32_t bh = (uint32_t)last | (uint32_t)(bn << 3);
            dst[pos] = (uint8_t)bh;
            dst[pos + 1] = (uint8_t)(bh >> 8);
            dst[pos + 2] = (uint8_t)(bh >> 16);
            memcpy(dst + pos + 3, src + bstart, (size_t)bn);
            c = bn + 3;
        } else {
            int64_t tail;
            k.nseq = k.nlit = 0;
            if (lib && p.strat >= ZST_GREEDY) {
                /* a limited update after a very long match */
                uint32_t *upd = p.strat >= ZST_BTOPT ? &o.next : &z.next;
                const uint32_t curr = (uint32_t)bstart
                                      + (p.strat >= ZST_BTOPT ? o.base : 2);
                if (curr > *upd + 384)
                    *upd = curr - (curr - *upd - 384 < 192 ? curr - *upd - 384
                                                            : 192);
            }
            if (!lib) {
                tail = zm_block(&m, &k, bstart, bend, rep);
            } else if (p.strat == ZST_FAST) {
                tail = zl_fast(&k, n, p.hlog, p.mls, ht);
            } else if (p.strat == ZST_DFAST) {
                tail = zl_dfast(&k, n, p.hlog, p.clog, p.mls, ht,
                                ht + ((size_t)1 << p.hlog));
            } else if (p.strat >= ZST_BTOPT) {
                if (p.strat == ZST_BTULTRA2 && bstart == 0 && bn > ZOPT_PREDEF) {
                    /* ZSTD_initStats_ultra: a first pass seeds the prices;
                     * its sequences go, and the window moves past it */
                    uint32_t tmp[3] = {rep[0], rep[1], rep[2]};
                    zopt_block(&o, &k, 0, bend, tmp);
                    k.nseq = k.nlit = 0;
                    o.base += (uint32_t)bn;
                    o.low = o.next = o.base;
                }
                tail = zopt_block(&o, &k, bstart, bend, rep);
            } else {
                tail = zlazy_block(&z, &k, bstart, bend, rep);
            }
            memcpy(k.lit + k.nlit, src + tail, (size_t)(bend - tail));
            k.nlit += bend - tail;
            c = zstd_split_blocks(&b, src + bstart, bn, &k, rep, saved, split,
                                  last, dst + pos, room);
            if (c < 0) {
                rc = c == ERR_NOMEM ? c : 0;
                goto done;
            }
        }
        pos += c;
        savings += bn - c;
        bstart = bend;
        b.first = 0;
    } while (bstart < n);
    rc = pos;
done:
    free(ht);
    free(z.chain);
    free(z.tags);
    free(o.bt);
    free(o.ht3);
    free(o.opt);
    free(o.matches);
    free(m.head);
    free(m.chain);
    free(k.seq);
    free(k.lit);
    free(ent);
    return rc;
}
