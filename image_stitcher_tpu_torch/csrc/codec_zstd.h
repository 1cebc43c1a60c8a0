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
 * The encoder is the port's own (io/zstd_plain.py is its plain version, byte
 * for byte; the rules are spelled out there): one single-segment frame
 * with its content size and no checksum, blocks of 128 KiB, a greedy
 * hash-chain matcher over the whole frame whose search depth follows
 * clevel, repeat offsets, Huffman-coded literals (weights FSE-coded or
 * direct) or raw or RLE literals, sequences with the predefined
 * distributions, RLE or FSE tables of its own, and a raw block wherever
 * the compressed one is not smaller.
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
} bitout;

static void bitout_init(bitout *w, uint8_t *dst, int64_t cap)
{
    w->p = dst;
    w->end = dst + cap;
    w->acc = 0;
    w->n = 0;
    w->overflow = 0;
}

/* nb <= 32 bits of v; whole 32-bit words go out as they fill (the
 * stream's bytes are the same as one byte at a time) */
static void bitout_add(bitout *w, uint64_t v, int nb)
{
    w->acc |= (v & ((1ULL << nb) - 1)) << w->n;
    w->n += nb;
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

/* FSE normalized counts of count[0..maxsym] (total > 0, at least two
 * symbols present) to 2^log: each present symbol gets
 * max(1, round(count * 2^log / total)), then the sum is brought to 2^log
 * one step at a time: up on the symbol with the largest count, down on
 * the symbol with the largest normalized count above 1 (the lowest
 * symbol among equals). */
static void fse_normalize(const uint32_t *count, int maxsym, int log,
                          int16_t *norm)
{
    uint64_t total = 0;
    for (int s = 0; s <= maxsym; ++s)
        total += count[s];
    int sum = 0, big = 0;
    for (int s = 0; s <= maxsym; ++s) {
        norm[s] = 0;
        if (!count[s])
            continue;
        uint64_t v = (((uint64_t)count[s] << log) + total / 2) / total;
        norm[s] = (int16_t)(v < 1 ? 1 : v);
        sum += norm[s];
        if (count[s] > count[big])
            big = s;
    }
    const int size = 1 << log;
    if (sum < size)
        norm[big] = (int16_t)(norm[big] + size - sum);
    while (sum > size) {
        int top = -1;
        for (int s = 0; s <= maxsym; ++s)
            if (norm[s] > 1 && (top < 0 || norm[s] > norm[top]))
                top = s;
        norm[top]--;
        sum--;
    }
}

/* the table log of a field's own FSE table: about log2(nseq) - 2, at
 * least 5 and enough for its symbols, at most maxlog */
static int fse_table_log(int64_t nsymbols_coded, int distinct, int maxlog)
{
    int log = highbit32((uint32_t)(nsymbols_coded - 1)) - 1;
    int need = highbit32((uint32_t)distinct) + 2;
    if (log < need)
        log = need;
    if (log < 5)
        log = 5;
    if (log > maxlog)
        log = maxlog;
    return log;
}

static void fse_write_ncount(bitout *w, const int16_t *norm, int maxsym,
                             int log)
{
    bitout_add(w, (uint64_t)(log - 5), 4);
    int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1;
    int s = 0, prev0 = 0;
    while (s <= maxsym && remaining > 1) {
        if (prev0) {
            int start = s;
            while (s <= maxsym && !norm[s])
                ++s;
            while (s >= start + 3) {
                bitout_add(w, 3, 2);
                start += 3;
            }
            bitout_add(w, (uint64_t)(s - start), 2);
        }
        int count = norm[s++];
        int max = (2 * threshold - 1) - remaining;
        remaining -= count < 0 ? -count : count;
        count++;
        if (count >= threshold)
            count += max;
        bitout_add(w, (uint64_t)count, nbits - (count < max));
        prev0 = count == 1;
        while (remaining < threshold) {
            nbits--;
            threshold >>= 1;
        }
    }
    bitout_flush(w);
}

typedef struct {
    int log;
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
}

/* the first state of symbol s (the one with the most bits) */
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

/* Huffman code lengths of count[0..255] (at least two symbols present),
 * none over HUF_MAX_BITS: a Huffman tree over the symbols sorted by
 * (count, symbol), merging the two smallest of the leaf queue and the
 * node queue (a leaf first among equals); while the deepest leaf is
 * deeper than HUF_MAX_BITS the counts become (count + 1) / 2 and the
 * tree is built again. Returns the longest length. */
/* (count, symbol) keys, compared in that order */
static int huf_key_cmp(const void *a, const void *b)
{
    uint64_t x = *(const uint64_t *)a, y = *(const uint64_t *)b;
    return (x > y) - (x < y);
}

static int huf_lengths(const uint32_t *count_in, uint8_t *len)
{
    uint32_t count[256];
    uint64_t key[256];
    int order[256], n = 0;
    memcpy(count, count_in, sizeof(count));
    for (;;) {
        n = 0;
        for (int s = 0; s < 256; ++s)
            if (count[s])
                key[n++] = (uint64_t)count[s] << 8 | (uint64_t)s;
        qsort(key, (size_t)n, sizeof(uint64_t), huf_key_cmp);
        for (int i = 0; i < n; ++i)
            order[i] = (int)(key[i] & 255);
        uint64_t weight[512];
        int parent[512];
        for (int i = 0; i < n; ++i)
            weight[i] = count[order[i]];
        int leaf = 0, node = n, made = n;
        while (made < 2 * n - 1) {
            int pick[2];
            for (int k = 0; k < 2; ++k) {
                if (leaf < n && (node >= made || weight[leaf] <= weight[node]))
                    pick[k] = leaf++;
                else
                    pick[k] = node++;
            }
            weight[made] = weight[pick[0]] + weight[pick[1]];
            parent[pick[0]] = parent[pick[1]] = made;
            made++;
        }
        int depth[512];
        depth[2 * n - 2] = 0;
        for (int i = 2 * n - 3; i >= 0; --i)
            depth[i] = depth[parent[i]] + 1;
        int maxlen = 0;
        memset(len, 0, 256);
        for (int i = 0; i < n; ++i) {
            len[order[i]] = (uint8_t)depth[i];
            if (depth[i] > maxlen)
                maxlen = depth[i];
        }
        if (maxlen <= HUF_MAX_BITS)
            return maxlen;
        for (int s = 0; s < 256; ++s)
            if (count[s])
                count[s] = (count[s] + 1) / 2;
    }
}

/* the canonical codes of lengths len (longest maxlen) as zstd assigns
 * them: by weight (maxlen + 1 - length), then symbol */
static void huf_codes(const uint8_t *len, int maxlen, uint16_t *code)
{
    uint32_t start[HUF_MAX_BITS + 2] = {0}, cnt[HUF_MAX_BITS + 2] = {0};
    for (int s = 0; s < 256; ++s)
        if (len[s])
            cnt[maxlen + 1 - len[s]]++;
    uint32_t next = 0;
    for (int w = 1; w <= maxlen; ++w) {
        start[w] = next;
        next += cnt[w] << (w - 1);
    }
    for (int s = 0; s < 256; ++s) {
        if (!len[s])
            continue;
        int w = maxlen + 1 - len[s];
        code[s] = (uint16_t)(start[w] >> (w - 1));
        start[w] += 1u << (w - 1);
    }
}

/* The Huffman tree description of lengths len (last present symbol
 * last): the weights FSE-coded (table log 6, two interleaved states)
 * when they hold two or more distinct values and that is shorter than
 * the direct form, else direct (at most 128 weights). Returns its size,
 * or 0 when neither form can describe them. */
static int64_t huf_write_table(const uint8_t *len, int maxlen, int last,
                               uint8_t *dst, int64_t cap)
{
    uint8_t w[256];
    uint32_t hist[16] = {0};
    int nw = last;     /* the last symbol's weight is implied */
    for (int s = 0; s < nw; ++s) {
        w[s] = (uint8_t)(len[s] ? maxlen + 1 - len[s] : 0);
        hist[w[s]]++;
    }
    int64_t direct = nw <= 128 ? 1 + (nw + 1) / 2 : 0;
    int distinct = 0, maxw = 0;
    for (int k = 0; k < 16; ++k)
        if (hist[k]) {
            distinct++;
            maxw = k;
        }
    uint8_t fse[160];
    int64_t fsize = 0;
    if (distinct >= 2) {
        int16_t norm[16];
        fse_ctable *t = (fse_ctable *)malloc(sizeof(fse_ctable));
        if (t == NULL)
            return ERR_NOMEM;
        fse_normalize(hist, maxw, HUF_WEIGHT_LOG, norm);
        bitout bw;
        bitout_init(&bw, fse + 1, (int64_t)sizeof(fse) - 1);
        fse_write_ncount(&bw, norm, maxw, HUF_WEIGHT_LOG);
        fse_build_ctable(t, norm, maxw, HUF_WEIGHT_LOG);
        uint32_t st[2];
        st[(nw - 1) & 1] = fse_init_state(t, w[nw - 1]);
        st[(nw - 2) & 1] = fse_init_state(t, w[nw - 2]);
        for (int i = nw - 3; i >= 0; --i)
            st[i & 1] = fse_encode(&bw, t, st[i & 1], w[i]);
        bitout_add(&bw, st[1], HUF_WEIGHT_LOG);
        bitout_add(&bw, st[0], HUF_WEIGHT_LOG);
        bitout_add(&bw, 1, 1);
        bitout_flush(&bw);
        free(t);
        fsize = bw.p - (fse + 1);
        if (bw.overflow || fsize >= 128)
            fsize = 0;
    }
    if (fsize && (!direct || fsize + 1 < direct)) {
        if (fsize + 1 > cap)
            return 0;
        dst[0] = (uint8_t)fsize;
        memcpy(dst + 1, fse + 1, (size_t)fsize);
        return fsize + 1;
    }
    if (!direct || direct > cap)
        return 0;
    dst[0] = (uint8_t)(127 + nw);
    memset(dst + 1, 0, (size_t)(direct - 1));
    for (int i = 0; i < nw; ++i)
        dst[1 + i / 2] |= (uint8_t)(i & 1 ? w[i] : w[i] << 4);
    return direct;
}

/* one Huffman stream of src[0, n), symbols written last first */
static int64_t huf_write_stream(const uint8_t *src, int64_t n,
                                const uint8_t *len, const uint16_t *code,
                                uint8_t *dst, int64_t cap)
{
    bitout bw;
    bitout_init(&bw, dst, cap);
    for (int64_t i = n - 1; i >= 0; --i)
        bitout_add(&bw, code[src[i]], len[src[i]]);
    bitout_add(&bw, 1, 1);
    bitout_flush(&bw);
    return bw.overflow ? -1 : bw.p - dst;
}

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

/* The literals section of lit[0, n) into dst (cap >= n + 8): raw when n
 * is under 64 or Huffman is not smaller, RLE when every literal is the
 * same, else Huffman in 1 stream (n < 256) or 4. Its size, or an
 * error. */
static int64_t zstd_write_literals(const uint8_t *lit, int64_t n,
                                   uint8_t *dst, int64_t cap)
{
    int64_t raw = literal_header(dst, 0, n) + n;
    uint32_t count[256] = {0};
    for (int64_t i = 0; i < n; ++i)
        count[lit[i]]++;
    int distinct = 0, last = 0;
    for (int s = 0; s < 256; ++s)
        if (count[s]) {
            distinct++;
            last = s;
        }
    if (n > 0 && distinct == 1) {
        int64_t h = literal_header(dst, 1, n);
        dst[h] = lit[0];
        return h + 1;
    }
    if (n >= 64) {
        uint8_t len[256];
        uint16_t code[256];
        int maxlen = huf_lengths(count, len);
        huf_codes(len, maxlen, code);
        uint8_t *tmp = (uint8_t *)malloc((size_t)(n + 512));
        if (tmp == NULL)
            return ERR_NOMEM;
        int64_t pos = huf_write_table(len, maxlen, last, tmp, n + 512);
        int four = n >= 256;
        if (pos < 0) {
            free(tmp);
            return pos;
        }
        if (pos > 0) {
            int64_t start = pos;
            if (four)
                pos += 6;
            int64_t seg = (n + 3) / 4;
            for (int k = 0; k < (four ? 4 : 1) && pos > 0; ++k) {
                int64_t off = four ? k * seg : 0;
                int64_t cnt = !four ? n : k < 3 ? seg : n - 3 * seg;
                int64_t sz = huf_write_stream(lit + off, cnt, len, code,
                                              tmp + pos, n + 512 - pos);
                if (sz < 0 || (four && k < 3 && sz > 65535)) {
                    pos = 0;
                    break;
                }
                if (four && k < 3) {
                    tmp[start + 2 * k] = (uint8_t)sz;
                    tmp[start + 2 * k + 1] = (uint8_t)(sz >> 8);
                }
                pos += sz;
            }
        }
        if (pos > 0) {
            int64_t csize = pos, big = n > csize ? n : csize;
            int sf = !four ? 0 : big < 1024 ? 1 : big < 16384 ? 2 : 3;
            int hs = sf < 2 ? 3 : sf == 2 ? 4 : 5;
            int bits = sf < 2 ? 10 : sf == 2 ? 14 : 18;
            if (hs + csize < raw && hs + csize <= cap) {
                uint64_t h = 2 | ((uint64_t)sf << 2) | ((uint64_t)n << 4)
                             | ((uint64_t)csize << (4 + bits));
                for (int k = 0; k < hs; ++k)
                    dst[k] = (uint8_t)(h >> (8 * k));
                memcpy(dst + hs, tmp, (size_t)csize);
                free(tmp);
                return hs + csize;
            }
        }
        free(tmp);
    }
    int64_t h = literal_header(dst, 0, n);
    memcpy(dst + h, lit, (size_t)n);
    return raw;
}

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

/* mode and table of one sequence field: RLE for one symbol, the
 * predefined distribution under 64 sequences, else FSE of its own */
static int64_t seq_field_table(const uint8_t *codes, int64_t nseq,
                               int maxsym, int maxlog, const int16_t *defnorm,
                               int defmax, int deflog, fse_ctable *t,
                               int *mode, uint8_t *dst, int64_t cap)
{
    uint32_t count[ZSTD_MAX_ML + 1] = {0};
    int distinct = 0, top = 0;
    for (int64_t i = 0; i < nseq; ++i)
        count[codes[i]]++;
    for (int s = 0; s <= maxsym; ++s)
        if (count[s]) {
            distinct++;
            top = s;
        }
    if (distinct == 1) {
        *mode = 1;
        t->log = 0;
        if (cap < 1)
            return -1;
        dst[0] = (uint8_t)top;
        return 1;
    }
    if (nseq < 64) {
        *mode = 0;
        fse_build_ctable(t, defnorm, defmax, deflog);
        return 0;
    }
    *mode = 2;
    int16_t norm[ZSTD_MAX_ML + 1];
    int log = fse_table_log(nseq, distinct, maxlog);
    fse_normalize(count, top, log, norm);
    bitout bw;
    bitout_init(&bw, dst, cap);
    fse_write_ncount(&bw, norm, top, log);
    fse_build_ctable(t, norm, top, log);
    return bw.overflow ? -1 : bw.p - dst;
}

/* the sequences section into dst; its size, or -1 when it does not fit */
static int64_t zstd_write_sequences(const zseq *seq, int64_t nseq,
                                    uint8_t *dst, int64_t cap)
{
    uint8_t *op = dst, *oend = dst + cap;
    if (oend - op < 4)
        return -1;
    if (nseq < 128) {
        *op++ = (uint8_t)nseq;
    } else if (nseq < 0x7F00) {
        *op++ = (uint8_t)((nseq >> 8) + 128);
        *op++ = (uint8_t)nseq;
    } else {
        *op++ = 255;
        *op++ = (uint8_t)(nseq - 0x7F00);
        *op++ = (uint8_t)((nseq - 0x7F00) >> 8);
    }
    if (nseq == 0)
        return op - dst;
    uint8_t *llc = (uint8_t *)malloc((size_t)nseq * 3);
    fse_ctable *t = (fse_ctable *)malloc(3 * sizeof(fse_ctable));
    if (llc == NULL || t == NULL) {
        free(llc);
        free(t);
        return ERR_NOMEM;
    }
    uint8_t *mlc = llc + nseq, *ofc = mlc + nseq;
    for (int64_t i = 0; i < nseq; ++i) {
        llc[i] = (uint8_t)code_of(LL_BASE, ZSTD_MAX_LL, seq[i].ll);
        mlc[i] = (uint8_t)code_of(ML_BASE, ZSTD_MAX_ML, seq[i].ml);
        ofc[i] = (uint8_t)highbit32(seq[i].ofv);
    }
    uint8_t *modes = op++;
    int m[3];
    int64_t r = seq_field_table(llc, nseq, ZSTD_MAX_LL, ZSTD_LL_LOG,
                                LL_DEFAULT, ZSTD_MAX_LL, LL_DEFAULT_LOG,
                                &t[0], &m[0], op, oend - op);
    if (r >= 0) {
        op += r;
        r = seq_field_table(ofc, nseq, ZSTD_MAX_OF, ZSTD_OF_LOG, OF_DEFAULT,
                            28, OF_DEFAULT_LOG, &t[1], &m[1], op, oend - op);
    }
    if (r >= 0) {
        op += r;
        r = seq_field_table(mlc, nseq, ZSTD_MAX_ML, ZSTD_ML_LOG, ML_DEFAULT,
                            ZSTD_MAX_ML, ML_DEFAULT_LOG, &t[2], &m[2], op,
                            oend - op);
    }
    int64_t out = -1;
    if (r >= 0) {
        op += r;
        *modes = (uint8_t)((m[0] << 6) | (m[1] << 4) | (m[2] << 2));
        bitout bw;
        bitout_init(&bw, op, oend - op);
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
        bitout_add(&bw, sml, t[2].log);
        bitout_add(&bw, sof, t[1].log);
        bitout_add(&bw, sll, t[0].log);
        bitout_add(&bw, 1, 1);
        bitout_flush(&bw);
        if (!bw.overflow)
            out = bw.p - dst;
    }
    free(llc);
    free(t);
    return out;
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

/* The zstd frame of src[0, n) into dst; its size, 0 when it would exceed
 * cap bytes, or an error. */
int64_t zstd_compress(const uint8_t *src, int64_t n, uint8_t *dst,
                      int64_t cap, int clevel)
{
    if (n < 0 || n > 0x7fffffff)
        return ERR_ARGS;
    uint8_t hdr[14];
    int hl = 0;
    write32(hdr, ZSTD_MAGIC);
    hl = 4;
    if (n < 256) {
        hdr[hl++] = 0x20;
        hdr[hl++] = (uint8_t)n;
    } else if (n < 65536 + 256) {
        hdr[hl++] = 0x60;
        hdr[hl++] = (uint8_t)(n - 256);
        hdr[hl++] = (uint8_t)((n - 256) >> 8);
    } else {
        hdr[hl++] = 0xA0;
        write32(hdr + hl, n);
        hl += 4;
    }
    if (hl > cap)
        return 0;
    memcpy(dst, hdr, (size_t)hl);
    int64_t pos = hl;
    zmatcher m = {src, n, 0, 0, zstd_depth(clevel), NULL, NULL};
    int hlog = n > 1 ? highbit32((uint32_t)(n - 1)) : 10;
    m.hlog = hlog < 10 ? 10 : hlog > 17 ? 17 : hlog;
    m.head = (int32_t *)malloc(sizeof(int32_t) << m.hlog);
    if (m.depth > 1)
        m.chain = (int32_t *)malloc(sizeof(int32_t) * (size_t)(n + 1));
    /* scratch for one block: at most one sequence per 4 bytes */
    int64_t bmax = n < ZSTD_BLOCK_MAX ? n : ZSTD_BLOCK_MAX;
    zseq *seq = (zseq *)malloc(sizeof(zseq) * (size_t)(bmax / 4 + 1));
    uint8_t *lit = (uint8_t *)malloc((size_t)bmax + 1);
    int64_t bcap = bmax + 1024;
    uint8_t *blk = (uint8_t *)malloc((size_t)bcap);
    int64_t rc = 0;
    if (m.head == NULL || (m.depth > 1 && m.chain == NULL) || seq == NULL
            || lit == NULL || blk == NULL) {
        rc = ERR_NOMEM;
        goto done;
    }
    for (int i = 0; i < (1 << m.hlog); ++i)
        m.head[i] = -1;
    uint32_t rep[3] = {1, 4, 8};
    int64_t bstart = 0;
    do {
        int64_t bend = n - bstart < ZSTD_BLOCK_MAX ? n : bstart
                       + ZSTD_BLOCK_MAX;
        int64_t bn = bend - bstart;
        int last = bend == n;
        uint32_t saved[3] = {rep[0], rep[1], rep[2]};
        /* sequences of the block */
        int64_t nseq = 0, nlit = 0, ip = bstart, anchor = bstart;
        while (ip + 4 <= bend) {
            zm_insert_to(&m, ip);
            uint32_t seqv = read32(src + ip);
            int64_t best = 0, best_off = 0;
            if (ip > anchor && (int64_t)rep[0] <= ip
                    && read32(src + ip - rep[0]) == seqv) {
                best = 4 + common_len(src + ip + 4, src + ip - rep[0] + 4,
                                      src + bend);
                best_off = rep[0];
            } else {
                int64_t cand = m.head[(seqv * 2654435761u) >> (32 - m.hlog)];
                for (int k = 0; k < m.depth && cand >= 0; ++k) {
                    if (read32(src + cand) == seqv) {
                        int64_t len = 4 + common_len(src + ip + 4,
                                                     src + cand + 4,
                                                     src + bend);
                        if (len > best) {
                            best = len;
                            best_off = ip - cand;
                        }
                    }
                    if (m.chain == NULL)
                        break;
                    cand = m.chain[cand];
                }
            }
            if (best >= 4) {
                int64_t ll = ip - anchor;
                memcpy(lit + nlit, src + anchor, (size_t)ll);
                nlit += ll;
                seq[nseq].ll = (uint32_t)ll;
                seq[nseq].ml = (uint32_t)best;
                seq[nseq].ofv = zstd_offset_value(rep, (uint32_t)best_off,
                                                  (uint32_t)ll);
                nseq++;
                ip += best;
                anchor = ip;
            } else {
                ip += 1 + ((ip - anchor) >> 8);
            }
        }
        memcpy(lit + nlit, src + anchor, (size_t)(bend - anchor));
        nlit += bend - anchor;
        /* the block: RLE, compressed, or raw */
        int64_t body = -1, btype = 0;
        int same = bn > 0;
        for (int64_t i = 1; i < bn && same; ++i)
            same = src[bstart + i] == src[bstart];
        if (same && bn > 1) {
            blk[0] = src[bstart];
            body = 1;
            btype = 1;
        } else if (bn > 0) {
            int64_t a = zstd_write_literals(lit, nlit, blk, bcap);
            if (a < 0) {
                rc = a;
                goto done;
            }
            int64_t b = zstd_write_sequences(seq, nseq, blk + a, bcap - a);
            if (b == ERR_NOMEM) {
                rc = b;
                goto done;
            }
            if (b >= 0 && a + b < bn) {
                body = a + b;
                btype = 2;
            }
        }
        if (btype != 2)
            memcpy(rep, saved, sizeof(rep));
        if (body < 0)
            body = bn;
        int64_t need = 3 + (btype == 0 ? bn : body);
        if (pos + need > cap) {
            rc = 0;
            goto done;
        }
        uint32_t bh = (uint32_t)last | (uint32_t)(btype << 1)
                      | (uint32_t)((btype == 1 ? bn : btype == 0 ? bn : body)
                                   << 3);
        dst[pos] = (uint8_t)bh;
        dst[pos + 1] = (uint8_t)(bh >> 8);
        dst[pos + 2] = (uint8_t)(bh >> 16);
        pos += 3;
        if (btype == 0)
            memcpy(dst + pos, src + bstart, (size_t)bn);
        else
            memcpy(dst + pos, blk, (size_t)body);
        pos += btype == 0 ? bn : body;
        bstart = bend;
    } while (bstart < n);
    rc = pos;
done:
    free(m.head);
    free(m.chain);
    free(seq);
    free(lit);
    free(blk);
    return rc;
}
