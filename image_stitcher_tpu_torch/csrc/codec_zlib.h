/* zlib streams for blosc code 3, included by blosc.c: deflate as the
 * zlib that tensorstore's c-blosc links (Chromium's fork of zlib 1.3.1)
 * runs it in compress2(dest, &maxout, src, n, clevel), so its streams
 * are c-blosc's byte for byte; io/zlib_plain.py is its plain version,
 * byte for byte. Only the encoder is here: blosc frames of code 3 are
 * decoded through io/blosc.py.
 *
 * The stream (RFC 1950/1951): a 2-byte header, 0x78 then zlib's FLEVEL
 * byte (0x01 at levels 0-1, 0x5e at 2-5, 0x9c at 6, 0xda at 7-9), the
 * deflate blocks, and the adler32 of the input, big-endian. deflateInit's
 * defaults: a 32 KiB window (a 64 KiB buffer that slides by 32 KiB once
 * strstart reaches 32 KiB + MAX_DIST, MAX_DIST = 32 KiB - 262), memLevel
 * 8 (a 16384-symbol buffer: a block ends after 16383 symbols),
 * Z_DEFAULT_STRATEGY. Level 0 writes stored blocks of 65535 bytes (with
 * the whole output buffer free); levels 1-3 run deflate_fast and 4-9
 * deflate_slow with zlib's table of (good, lazy, nice, chain):
 * 1 (4, 4, 8, 4), 2 (4, 5, 16, 8), 3 (4, 6, 32, 32), 4 (4, 4, 16, 16),
 * 5 (8, 16, 32, 32), 6 (8, 16, 128, 128), 7 (8, 32, 128, 256),
 * 8 (32, 128, 258, 1024), 9 (32, 258, 258, 4096).
 *
 * Chromium's one change that shows in the bytes is the hash: position p
 * goes into a 2^15-entry chain head table at
 * ((load32_le(window + p) * 66521 + 66521) mod 2^32) >> 16, masked to 15
 * bits, hashing 4 bytes (so 3-byte matches come only from collisions);
 * a position is hashed whenever zlib inserts it, with whatever the
 * window holds after the input's end (zeros, or bytes of an earlier fill
 * left by a slide). Everything else is zlib's deflate.c and trees.c:
 * longest_match (the chain cut at MAX_DIST and after `chain` candidates,
 * a quarter of them once the previous match is `good`, nice_match capped
 * at the lookahead, the result capped at it), deflate_slow's lazy
 * evaluation with 3-byte matches more than 4096 back dropped, and each
 * block sent stored, with the fixed code or with dynamic codes
 * (build_tree's heap and tie order, gen_bitlen's overflow repair,
 * build_bl_tree and bl_order), whichever _tr_flush_block finds
 * shortest. */

#define ZL_WSIZE 32768u
#define ZL_WMASK (ZL_WSIZE - 1)
#define ZL_WINDOW (2 * ZL_WSIZE)
#define ZL_HASH_SIZE 32768u
#define ZL_HASH_MASK (ZL_HASH_SIZE - 1)
#define ZL_MIN_MATCH 3
#define ZL_MAX_MATCH 258
#define ZL_MIN_LOOKAHEAD (ZL_MAX_MATCH + ZL_MIN_MATCH + 1)
#define ZL_MAX_DIST (ZL_WSIZE - ZL_MIN_LOOKAHEAD)
#define ZL_LIT_BUFSIZE 16384
#define ZL_TOO_FAR 4096
#define ZL_MAX_STORED 65535
#define ZL_LENGTH_CODES 29
#define ZL_LITERALS 256
#define ZL_END_BLOCK 256
#define ZL_L_CODES (ZL_LITERALS + 1 + ZL_LENGTH_CODES)
#define ZL_D_CODES 30
#define ZL_BL_CODES 19
#define ZL_HEAP_SIZE (2 * ZL_L_CODES + 1)
#define ZL_MAX_BITS 15
#define ZL_MAX_BL_BITS 7
#define ZL_REP_3_6 16
#define ZL_REPZ_3_10 17
#define ZL_REPZ_11_138 18

/* zlib's ct_data: the frequency (then the code) and the father (then the
 * bit length) share their fields, as in trees.c */
typedef struct {
    uint16_t fc;    /* Freq, then Code */
    uint16_t dl;    /* Dad, then Len */
} zl_ct;

typedef struct {
    zl_ct *dyn_tree;
    int max_code;
    const zl_ct *static_tree;
    const int *extra_bits;
    int extra_base, elems, max_length;
} zl_tree_desc;

static const int ZL_EXTRA_LBITS[ZL_LENGTH_CODES] = {
    0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4,
    5, 5, 5, 5, 0};
static const int ZL_EXTRA_DBITS[ZL_D_CODES] = {
    0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10,
    11, 11, 12, 12, 13, 13};
static const int ZL_EXTRA_BLBITS[ZL_BL_CODES] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2, 3, 7};
static const uint8_t ZL_BL_ORDER[ZL_BL_CODES] = {
    16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};
/* good, lazy, nice, chain of levels 0-9 */
static const uint16_t ZL_CONFIG[10][4] = {
    {0, 0, 0, 0}, {4, 4, 8, 4}, {4, 5, 16, 8}, {4, 6, 32, 32},
    {4, 4, 16, 16}, {8, 16, 32, 32}, {8, 16, 128, 128}, {8, 32, 128, 256},
    {32, 128, 258, 1024}, {32, 258, 258, 4096}};

typedef struct {
    /* input */
    const uint8_t *in;
    int64_t in_len, in_pos;
    /* output: a 64-bit bit buffer, bytes written while they fit */
    uint8_t *op, *oend;
    uint64_t bi_buf;
    int bi_valid, overflow;
    /* matcher */
    unsigned good_match, max_lazy, nice_match, max_chain;
    unsigned strstart, lookahead, match_start, match_length, prev_length;
    unsigned prev_match, match_available;
    int64_t block_start;
    uint16_t head[ZL_HASH_SIZE];
    uint16_t prev[ZL_WSIZE];
    uint8_t window[ZL_WINDOW + 8];
    /* symbols of the current block */
    uint16_t sym_dist[ZL_LIT_BUFSIZE];
    uint8_t sym_lc[ZL_LIT_BUFSIZE];
    unsigned sym_next;
    /* trees */
    zl_ct dyn_ltree[ZL_HEAP_SIZE];
    zl_ct dyn_dtree[2 * ZL_D_CODES + 1];
    zl_ct bl_tree[2 * ZL_BL_CODES + 1];
    zl_tree_desc l_desc, d_desc, bl_desc;
    uint16_t bl_count[ZL_MAX_BITS + 1];
    int heap[2 * ZL_L_CODES + 1];
    int heap_len, heap_max;
    uint8_t depth[2 * ZL_L_CODES + 1];
    uint64_t opt_len, static_len;
    /* trees.c's static tables */
    zl_ct static_ltree[ZL_L_CODES + 2];
    zl_ct static_dtree[ZL_D_CODES];
    uint8_t dist_code[512];
    uint8_t length_code[256];
    int base_length[ZL_LENGTH_CODES];
    int base_dist[ZL_D_CODES];
} zl_state;

/* ------------------------------------------------------------ bit layer */

static void zl_put_byte(zl_state *s, unsigned b)
{
    if (s->op < s->oend)
        *s->op++ = (uint8_t)b;
    else
        s->overflow = 1;
}

static void zl_send_bits(zl_state *s, unsigned value, int length)
{
    s->bi_buf |= (uint64_t)value << s->bi_valid;
    s->bi_valid += length;
    if (s->bi_valid >= 32) {
        if (s->oend - s->op >= 4) {
            write32(s->op, (int64_t)(uint32_t)s->bi_buf);
            s->op += 4;
        } else {
            s->overflow = 1;
        }
        s->bi_buf >>= 32;
        s->bi_valid -= 32;
    }
}

/* the bits left, to a byte boundary */
static void zl_bi_windup(zl_state *s)
{
    while (s->bi_valid > 0) {
        zl_put_byte(s, (unsigned)(s->bi_buf & 255));
        s->bi_buf >>= 8;
        s->bi_valid -= 8;
    }
    s->bi_buf = 0;
    s->bi_valid = 0;
}

static unsigned zl_bi_reverse(unsigned code, int len)
{
    unsigned res = 0;
    do {
        res |= code & 1;
        code >>= 1;
        res <<= 1;
    } while (--len > 0);
    return res >> 1;
}

#define zl_send_code(s, c, tree) zl_send_bits(s, (tree)[c].fc, (tree)[c].dl)

static unsigned zl_d_code(const zl_state *s, unsigned dist)
{
    return dist < 256 ? s->dist_code[dist] : s->dist_code[256 + (dist >> 7)];
}

/* ---------------------------------------------------------- trees.c */

static void zl_gen_codes(zl_ct *tree, int max_code, const uint16_t *bl_count)
{
    uint16_t next_code[ZL_MAX_BITS + 1];
    unsigned code = 0;
    for (int bits = 1; bits <= ZL_MAX_BITS; bits++) {
        code = (code + bl_count[bits - 1]) << 1;
        next_code[bits] = (uint16_t)code;
    }
    for (int n = 0; n <= max_code; n++) {
        int len = tree[n].dl;
        if (len == 0)
            continue;
        tree[n].fc = (uint16_t)zl_bi_reverse(next_code[len]++, len);
    }
}

static void zl_static_init(zl_state *s)
{
    int n, code, length = 0, dist = 0;
    uint16_t bl_count[ZL_MAX_BITS + 1];
    for (code = 0; code < ZL_LENGTH_CODES - 1; code++) {
        s->base_length[code] = length;
        for (n = 0; n < (1 << ZL_EXTRA_LBITS[code]); n++)
            s->length_code[length++] = (uint8_t)code;
    }
    s->length_code[length - 1] = (uint8_t)code;
    s->base_length[ZL_LENGTH_CODES - 1] = 0;
    for (code = 0; code < 16; code++) {
        s->base_dist[code] = dist;
        for (n = 0; n < (1 << ZL_EXTRA_DBITS[code]); n++)
            s->dist_code[dist++] = (uint8_t)code;
    }
    dist >>= 7;
    for (; code < ZL_D_CODES; code++) {
        s->base_dist[code] = dist << 7;
        for (n = 0; n < (1 << (ZL_EXTRA_DBITS[code] - 7)); n++)
            s->dist_code[256 + dist++] = (uint8_t)code;
    }
    memset(bl_count, 0, sizeof bl_count);
    for (n = 0; n <= 287; n++) {
        int len = n <= 143 ? 8 : n <= 255 ? 9 : n <= 279 ? 7 : 8;
        s->static_ltree[n].dl = (uint16_t)len;
        bl_count[len]++;
    }
    zl_gen_codes(s->static_ltree, ZL_L_CODES + 1, bl_count);
    for (n = 0; n < ZL_D_CODES; n++) {
        s->static_dtree[n].dl = 5;
        s->static_dtree[n].fc = (uint16_t)zl_bi_reverse((unsigned)n, 5);
    }
    s->l_desc = (zl_tree_desc){s->dyn_ltree, 0, s->static_ltree,
                               ZL_EXTRA_LBITS, ZL_LITERALS + 1, ZL_L_CODES,
                               ZL_MAX_BITS};
    s->d_desc = (zl_tree_desc){s->dyn_dtree, 0, s->static_dtree,
                               ZL_EXTRA_DBITS, 0, ZL_D_CODES, ZL_MAX_BITS};
    s->bl_desc = (zl_tree_desc){s->bl_tree, 0, NULL, ZL_EXTRA_BLBITS, 0,
                                ZL_BL_CODES, ZL_MAX_BL_BITS};
}

static void zl_init_block(zl_state *s)
{
    for (int n = 0; n < ZL_L_CODES; n++)
        s->dyn_ltree[n].fc = 0;
    for (int n = 0; n < ZL_D_CODES; n++)
        s->dyn_dtree[n].fc = 0;
    for (int n = 0; n < ZL_BL_CODES; n++)
        s->bl_tree[n].fc = 0;
    s->dyn_ltree[ZL_END_BLOCK].fc = 1;
    s->opt_len = s->static_len = 0;
    s->sym_next = 0;
}

/* n is smaller than m: lower frequency, then lower depth */
static int zl_smaller(const zl_ct *tree, int n, int m, const uint8_t *depth)
{
    return tree[n].fc < tree[m].fc
           || (tree[n].fc == tree[m].fc && depth[n] <= depth[m]);
}

static void zl_pqdownheap(zl_state *s, const zl_ct *tree, int k)
{
    int v = s->heap[k];
    int j = k << 1;
    while (j <= s->heap_len) {
        if (j < s->heap_len
                && zl_smaller(tree, s->heap[j + 1], s->heap[j], s->depth))
            j++;
        if (zl_smaller(tree, v, s->heap[j], s->depth))
            break;
        s->heap[k] = s->heap[j];
        k = j;
        j <<= 1;
    }
    s->heap[k] = v;
}

static void zl_gen_bitlen(zl_state *s, zl_tree_desc *desc)
{
    zl_ct *tree = desc->dyn_tree;
    int max_code = desc->max_code;
    const zl_ct *stree = desc->static_tree;
    const int *extra = desc->extra_bits;
    int base = desc->extra_base, max_length = desc->max_length;
    int h, n, m, bits, xbits, overflow = 0;
    for (bits = 0; bits <= ZL_MAX_BITS; bits++)
        s->bl_count[bits] = 0;
    tree[s->heap[s->heap_max]].dl = 0;    /* root of the heap */
    for (h = s->heap_max + 1; h < ZL_HEAP_SIZE; h++) {
        n = s->heap[h];
        bits = tree[tree[n].dl].dl + 1;
        if (bits > max_length) {
            bits = max_length;
            overflow++;
        }
        tree[n].dl = (uint16_t)bits;
        if (n > max_code)
            continue;    /* not a leaf */
        s->bl_count[bits]++;
        xbits = n >= base ? extra[n - base] : 0;
        unsigned f = tree[n].fc;
        s->opt_len += (uint64_t)f * (unsigned)(bits + xbits);
        if (stree)
            s->static_len += (uint64_t)f * (unsigned)(stree[n].dl + xbits);
    }
    if (overflow == 0)
        return;
    do {
        bits = max_length - 1;
        while (s->bl_count[bits] == 0)
            bits--;
        s->bl_count[bits]--;
        s->bl_count[bits + 1] += 2;
        s->bl_count[max_length]--;
        overflow -= 2;
    } while (overflow > 0);
    for (bits = max_length; bits != 0; bits--) {
        n = s->bl_count[bits];
        while (n != 0) {
            m = s->heap[--h];
            if (m > max_code)
                continue;
            if (tree[m].dl != (unsigned)bits) {
                s->opt_len += ((uint64_t)bits - tree[m].dl) * tree[m].fc;
                tree[m].dl = (uint16_t)bits;
            }
            n--;
        }
    }
}

static void zl_build_tree(zl_state *s, zl_tree_desc *desc)
{
    zl_ct *tree = desc->dyn_tree;
    const zl_ct *stree = desc->static_tree;
    int elems = desc->elems;
    int n, m, max_code = -1, node;
    s->heap_len = 0;
    s->heap_max = ZL_HEAP_SIZE;
    for (n = 0; n < elems; n++) {
        if (tree[n].fc != 0) {
            s->heap[++(s->heap_len)] = max_code = n;
            s->depth[n] = 0;
        } else {
            tree[n].dl = 0;
        }
    }
    /* at least two codes of non-zero frequency */
    while (s->heap_len < 2) {
        node = s->heap[++(s->heap_len)] = max_code < 2 ? ++max_code : 0;
        tree[node].fc = 1;
        s->depth[node] = 0;
        s->opt_len--;
        if (stree)
            s->static_len -= stree[node].dl;
    }
    desc->max_code = max_code;
    for (n = s->heap_len / 2; n >= 1; n--)
        zl_pqdownheap(s, tree, n);
    node = elems;
    do {
        n = s->heap[1];
        s->heap[1] = s->heap[s->heap_len--];
        zl_pqdownheap(s, tree, 1);
        m = s->heap[1];
        s->heap[--(s->heap_max)] = n;
        s->heap[--(s->heap_max)] = m;
        tree[node].fc = (uint16_t)(tree[n].fc + tree[m].fc);
        s->depth[node] = (uint8_t)((s->depth[n] >= s->depth[m]
                                    ? s->depth[n] : s->depth[m]) + 1);
        tree[n].dl = tree[m].dl = (uint16_t)node;
        s->heap[1] = node++;
        zl_pqdownheap(s, tree, 1);
    } while (s->heap_len >= 2);
    s->heap[--(s->heap_max)] = s->heap[1];
    zl_gen_bitlen(s, desc);
    zl_gen_codes(tree, max_code, s->bl_count);
}

static void zl_scan_tree(zl_state *s, zl_ct *tree, int max_code)
{
    int prevlen = -1, curlen, nextlen = tree[0].dl;
    int count = 0, max_count = 7, min_count = 4;
    if (nextlen == 0) {
        max_count = 138;
        min_count = 3;
    }
    tree[max_code + 1].dl = 0xffff;    /* guard */
    for (int n = 0; n <= max_code; n++) {
        curlen = nextlen;
        nextlen = tree[n + 1].dl;
        if (++count < max_count && curlen == nextlen) {
            continue;
        } else if (count < min_count) {
            s->bl_tree[curlen].fc = (uint16_t)(s->bl_tree[curlen].fc + count);
        } else if (curlen != 0) {
            if (curlen != prevlen)
                s->bl_tree[curlen].fc++;
            s->bl_tree[ZL_REP_3_6].fc++;
        } else if (count <= 10) {
            s->bl_tree[ZL_REPZ_3_10].fc++;
        } else {
            s->bl_tree[ZL_REPZ_11_138].fc++;
        }
        count = 0;
        prevlen = curlen;
        if (nextlen == 0) {
            max_count = 138;
            min_count = 3;
        } else if (curlen == nextlen) {
            max_count = 6;
            min_count = 3;
        } else {
            max_count = 7;
            min_count = 4;
        }
    }
}

static void zl_send_tree(zl_state *s, const zl_ct *tree, int max_code)
{
    int prevlen = -1, curlen, nextlen = tree[0].dl;
    int count = 0, max_count = 7, min_count = 4;
    if (nextlen == 0) {
        max_count = 138;
        min_count = 3;
    }
    for (int n = 0; n <= max_code; n++) {
        curlen = nextlen;
        nextlen = tree[n + 1].dl;
        if (++count < max_count && curlen == nextlen) {
            continue;
        } else if (count < min_count) {
            do {
                zl_send_code(s, curlen, s->bl_tree);
            } while (--count != 0);
        } else if (curlen != 0) {
            if (curlen != prevlen) {
                zl_send_code(s, curlen, s->bl_tree);
                count--;
            }
            zl_send_code(s, ZL_REP_3_6, s->bl_tree);
            zl_send_bits(s, (unsigned)(count - 3), 2);
        } else if (count <= 10) {
            zl_send_code(s, ZL_REPZ_3_10, s->bl_tree);
            zl_send_bits(s, (unsigned)(count - 3), 3);
        } else {
            zl_send_code(s, ZL_REPZ_11_138, s->bl_tree);
            zl_send_bits(s, (unsigned)(count - 11), 7);
        }
        count = 0;
        prevlen = curlen;
        if (nextlen == 0) {
            max_count = 138;
            min_count = 3;
        } else if (curlen == nextlen) {
            max_count = 6;
            min_count = 3;
        } else {
            max_count = 7;
            min_count = 4;
        }
    }
}

static int zl_build_bl_tree(zl_state *s)
{
    int max_blindex;
    zl_scan_tree(s, s->dyn_ltree, s->l_desc.max_code);
    zl_scan_tree(s, s->dyn_dtree, s->d_desc.max_code);
    zl_build_tree(s, &s->bl_desc);
    for (max_blindex = ZL_BL_CODES - 1; max_blindex >= 3; max_blindex--)
        if (s->bl_tree[ZL_BL_ORDER[max_blindex]].dl != 0)
            break;
    s->opt_len += 3 * ((uint64_t)max_blindex + 1) + 5 + 5 + 4;
    return max_blindex;
}

static void zl_send_all_trees(zl_state *s, int lcodes, int dcodes,
                              int blcodes)
{
    zl_send_bits(s, (unsigned)(lcodes - 257), 5);
    zl_send_bits(s, (unsigned)(dcodes - 1), 5);
    zl_send_bits(s, (unsigned)(blcodes - 4), 4);
    for (int rank = 0; rank < blcodes; rank++)
        zl_send_bits(s, s->bl_tree[ZL_BL_ORDER[rank]].dl, 3);
    zl_send_tree(s, s->dyn_ltree, lcodes - 1);
    zl_send_tree(s, s->dyn_dtree, dcodes - 1);
}

static void zl_compress_block(zl_state *s, const zl_ct *ltree,
                              const zl_ct *dtree)
{
    for (unsigned sx = 0; sx < s->sym_next; sx++) {
        unsigned dist = s->sym_dist[sx];
        int lc = s->sym_lc[sx];
        if (dist == 0) {
            zl_send_code(s, lc, ltree);
        } else {
            unsigned code = s->length_code[lc];
            zl_send_code(s, code + ZL_LITERALS + 1, ltree);
            int extra = ZL_EXTRA_LBITS[code];
            if (extra != 0)
                zl_send_bits(s, (unsigned)(lc - s->base_length[code]), extra);
            dist--;
            code = zl_d_code(s, dist);
            zl_send_code(s, code, dtree);
            extra = ZL_EXTRA_DBITS[code];
            if (extra != 0)
                zl_send_bits(s, dist - (unsigned)s->base_dist[code], extra);
        }
    }
    zl_send_code(s, ZL_END_BLOCK, ltree);
}

static void zl_stored_block(zl_state *s, const uint8_t *buf,
                            uint64_t stored_len, int last)
{
    zl_send_bits(s, (0u << 1) + (unsigned)last, 3);
    zl_bi_windup(s);
    zl_put_byte(s, (unsigned)(stored_len & 255));
    zl_put_byte(s, (unsigned)((stored_len >> 8) & 255));
    zl_put_byte(s, (unsigned)(~stored_len & 255));
    zl_put_byte(s, (unsigned)((~stored_len >> 8) & 255));
    if (stored_len == 0)
        return;
    if ((uint64_t)(s->oend - s->op) < stored_len) {
        s->overflow = 1;
        return;
    }
    memcpy(s->op, buf, (size_t)stored_len);
    s->op += stored_len;
}

/* _tr_flush_block: the block as stored, fixed or dynamic, the shortest
 * (stored only while its bytes are still in the window: buf not NULL) */
static void zl_flush_block(zl_state *s, const uint8_t *buf,
                           uint64_t stored_len, int last)
{
    int max_blindex = 0;
    zl_build_tree(s, &s->l_desc);
    zl_build_tree(s, &s->d_desc);
    max_blindex = zl_build_bl_tree(s);
    uint64_t opt_lenb = (s->opt_len + 3 + 7) >> 3;
    uint64_t static_lenb = (s->static_len + 3 + 7) >> 3;
    if (static_lenb <= opt_lenb)
        opt_lenb = static_lenb;
    if (stored_len + 4 <= opt_lenb && buf != NULL) {
        zl_stored_block(s, buf, stored_len, last);
    } else if (static_lenb == opt_lenb) {
        zl_send_bits(s, (1u << 1) + (unsigned)last, 3);
        zl_compress_block(s, s->static_ltree, s->static_dtree);
    } else {
        zl_send_bits(s, (2u << 1) + (unsigned)last, 3);
        zl_send_all_trees(s, s->l_desc.max_code + 1, s->d_desc.max_code + 1,
                          max_blindex + 1);
        zl_compress_block(s, s->dyn_ltree, s->dyn_dtree);
    }
    zl_init_block(s);
    if (last)
        zl_bi_windup(s);
}

/* FLUSH_BLOCK: the block from block_start to strstart */
static void zl_flush(zl_state *s, int last)
{
    zl_flush_block(s, s->block_start >= 0
                      ? s->window + s->block_start : NULL,
                   (uint64_t)((int64_t)s->strstart - s->block_start), last);
    s->block_start = s->strstart;
}

/* _tr_tally: 1 when the symbol buffer is full (16383 symbols) */
static int zl_tally_lit(zl_state *s, unsigned c)
{
    s->sym_dist[s->sym_next] = 0;
    s->sym_lc[s->sym_next++] = (uint8_t)c;
    s->dyn_ltree[c].fc++;
    return s->sym_next == ZL_LIT_BUFSIZE - 1;
}

static int zl_tally_dist(zl_state *s, unsigned dist, unsigned lc)
{
    s->sym_dist[s->sym_next] = (uint16_t)dist;
    s->sym_lc[s->sym_next++] = (uint8_t)lc;
    dist--;
    s->dyn_ltree[s->length_code[lc] + ZL_LITERALS + 1].fc++;
    s->dyn_dtree[zl_d_code(s, dist)].fc++;
    return s->sym_next == ZL_LIT_BUFSIZE - 1;
}

/* ---------------------------------------------------------- deflate.c */

static unsigned zl_insert(zl_state *s, unsigned str)
{
    uint32_t v = read32(s->window + str);
    unsigned h = ((v * 66521u + 66521u) >> 16) & ZL_HASH_MASK;
    unsigned ret = s->head[h];
    s->prev[str & ZL_WMASK] = (uint16_t)ret;
    s->head[h] = (uint16_t)str;
    return ret;
}

static void zl_slide_hash(zl_state *s)
{
    for (unsigned n = 0; n < ZL_HASH_SIZE; n++)
        s->head[n] = (uint16_t)(s->head[n] >= ZL_WSIZE
                                ? s->head[n] - ZL_WSIZE : 0);
    for (unsigned n = 0; n < ZL_WSIZE; n++)
        s->prev[n] = (uint16_t)(s->prev[n] >= ZL_WSIZE
                                ? s->prev[n] - ZL_WSIZE : 0);
}

/* fill_window: slide by 32 KiB once strstart reaches WSIZE + MAX_DIST
 * (the bytes past the data stay as they are), then read what fits */
static void zl_fill_window(zl_state *s)
{
    do {
        unsigned more = ZL_WINDOW - s->lookahead - s->strstart;
        if (s->strstart >= ZL_WSIZE + ZL_MAX_DIST) {
            memcpy(s->window, s->window + ZL_WSIZE, ZL_WSIZE - more);
            s->match_start -= ZL_WSIZE;
            s->strstart -= ZL_WSIZE;
            s->block_start -= ZL_WSIZE;
            zl_slide_hash(s);
            more += ZL_WSIZE;
        }
        if (s->in_pos == s->in_len)
            break;
        int64_t left = s->in_len - s->in_pos;
        unsigned n = left < more ? (unsigned)left : more;
        memcpy(s->window + s->strstart + s->lookahead, s->in + s->in_pos, n);
        s->in_pos += n;
        s->lookahead += n;
    } while (s->lookahead < ZL_MIN_LOOKAHEAD && s->in_pos < s->in_len);
}

static unsigned zl_longest_match(zl_state *s, unsigned cur_match)
{
    unsigned chain_length = s->max_chain;
    const uint8_t *scan = s->window + s->strstart;
    int best_len = (int)s->prev_length;
    int nice_match = (int)s->nice_match;
    unsigned limit = s->strstart > ZL_MAX_DIST ? s->strstart - ZL_MAX_DIST : 0;
    const uint8_t *strend = s->window + s->strstart + ZL_MAX_MATCH;
    uint8_t scan_end1 = scan[best_len - 1];
    uint8_t scan_end = scan[best_len];
    if (s->prev_length >= s->good_match)
        chain_length >>= 2;
    if ((unsigned)nice_match > s->lookahead)
        nice_match = (int)s->lookahead;
    do {
        const uint8_t *match = s->window + cur_match;
        if (match[best_len] != scan_end || match[best_len - 1] != scan_end1
                || match[0] != scan[0] || match[1] != scan[1])
            continue;
        /* bytes 2 on: zlib skips byte 2 (equal when the others are, for
         * any candidate a 2-byte match could lose to) */
        const uint8_t *p = scan + 2, *q = match + 2;
        do {
        } while (*++p == *++q && *++p == *++q && *++p == *++q
                 && *++p == *++q && *++p == *++q && *++p == *++q
                 && *++p == *++q && *++p == *++q && p < strend);
        int len = ZL_MAX_MATCH - (int)(strend - p);
        if (len > best_len) {
            s->match_start = cur_match;
            best_len = len;
            if (len >= nice_match)
                break;
            scan_end1 = scan[best_len - 1];
            scan_end = scan[best_len];
        }
    } while ((cur_match = s->prev[cur_match & ZL_WMASK]) > limit
             && --chain_length != 0);
    if ((unsigned)best_len <= s->lookahead)
        return (unsigned)best_len;
    return s->lookahead;
}

/* levels 1-3: a match is taken as found; the positions it covers are
 * hashed when it is at most max_lazy long */
static void zl_deflate_fast(zl_state *s)
{
    for (;;) {
        if (s->lookahead < ZL_MIN_LOOKAHEAD) {
            zl_fill_window(s);
            if (s->lookahead == 0)
                break;
        }
        unsigned hash_head = 0;
        int bflush;
        if (s->lookahead >= ZL_MIN_MATCH)
            hash_head = zl_insert(s, s->strstart);
        if (hash_head != 0 && s->strstart - hash_head <= ZL_MAX_DIST)
            s->match_length = zl_longest_match(s, hash_head);
        if (s->match_length >= ZL_MIN_MATCH) {
            bflush = zl_tally_dist(s, s->strstart - s->match_start,
                                   s->match_length - ZL_MIN_MATCH);
            s->lookahead -= s->match_length;
            if (s->match_length <= s->max_lazy
                    && s->lookahead >= ZL_MIN_MATCH) {
                s->match_length--;
                do {
                    s->strstart++;
                    zl_insert(s, s->strstart);
                } while (--s->match_length != 0);
                s->strstart++;
            } else {
                s->strstart += s->match_length;
                s->match_length = 0;
            }
        } else {
            bflush = zl_tally_lit(s, s->window[s->strstart]);
            s->lookahead--;
            s->strstart++;
        }
        if (bflush) {
            zl_flush(s, 0);
            if (s->overflow)
                return;
        }
    }
    zl_flush(s, 1);
}

/* levels 4-9: lazy evaluation */
static void zl_deflate_slow(zl_state *s)
{
    int bflush;
    for (;;) {
        if (s->lookahead < ZL_MIN_LOOKAHEAD) {
            zl_fill_window(s);
            if (s->lookahead == 0)
                break;
        }
        unsigned hash_head = 0;
        if (s->lookahead >= ZL_MIN_MATCH)
            hash_head = zl_insert(s, s->strstart);
        s->prev_length = s->match_length;
        s->prev_match = s->match_start;
        s->match_length = ZL_MIN_MATCH - 1;
        if (hash_head != 0 && s->prev_length < s->max_lazy
                && s->strstart - hash_head <= ZL_MAX_DIST) {
            s->match_length = zl_longest_match(s, hash_head);
            if (s->match_length == ZL_MIN_MATCH
                    && s->strstart - s->match_start > ZL_TOO_FAR)
                s->match_length = ZL_MIN_MATCH - 1;
        }
        if (s->prev_length >= ZL_MIN_MATCH
                && s->match_length <= s->prev_length) {
            unsigned max_insert = s->strstart + s->lookahead - ZL_MIN_MATCH;
            bflush = zl_tally_dist(s, s->strstart - 1 - s->prev_match,
                                   s->prev_length - ZL_MIN_MATCH);
            s->lookahead -= s->prev_length - 1;
            s->prev_length -= 2;
            do {
                if (++s->strstart <= max_insert)
                    zl_insert(s, s->strstart);
            } while (--s->prev_length != 0);
            s->match_available = 0;
            s->match_length = ZL_MIN_MATCH - 1;
            s->strstart++;
            if (bflush) {
                zl_flush(s, 0);
                if (s->overflow)
                    return;
            }
        } else if (s->match_available) {
            bflush = zl_tally_lit(s, s->window[s->strstart - 1]);
            if (bflush) {
                zl_flush(s, 0);
                if (s->overflow)
                    return;
            }
            s->strstart++;
            s->lookahead--;
        } else {
            s->match_available = 1;
            s->strstart++;
            s->lookahead--;
        }
    }
    if (s->match_available) {
        zl_tally_lit(s, s->window[s->strstart - 1]);
        s->match_available = 0;
    }
    zl_flush(s, 1);
}

/* level 0: stored blocks of 65535 bytes, the last one shorter (with the
 * whole output buffer free, deflate_stored copies straight from the
 * input) */
static void zl_deflate_stored(zl_state *s)
{
    int64_t pos = 0;
    do {
        int64_t len = s->in_len - pos < ZL_MAX_STORED ? s->in_len - pos
                                                        : ZL_MAX_STORED;
        zl_stored_block(s, s->in + pos, (uint64_t)len,
                        pos + len == s->in_len);
        pos += len;
    } while (pos < s->in_len && !s->overflow);
}

static uint32_t zl_adler32(const uint8_t *p, int64_t n)
{
    uint32_t a = 1, b = 0;
    while (n > 0) {
        int64_t k = n < 5552 ? n : 5552;    /* zlib's NMAX */
        n -= k;
        while (k--) {
            a += *p++;
            b += a;
        }
        a %= 65521;
        b %= 65521;
    }
    return (b << 16) | a;
}

/* A zlib stream of src[0, n) at level clevel (0-9) into dst; its size,
 * or 0 when it would exceed cap bytes (compress2 returns Z_BUF_ERROR,
 * and c-blosc stores the stream), or ERR_NOMEM. */
int64_t zlib_compress(const uint8_t *src, int64_t n, uint8_t *dst,
                      int64_t cap, int clevel)
{
    if (clevel < 0 || clevel > 9 || n < 0 || n > 0xffffffffLL)
        return ERR_ARGS;
    zl_state *s = (zl_state *)calloc(1, sizeof *s);
    if (s == NULL)
        return ERR_NOMEM;
    s->in = src;
    s->in_len = n;
    s->op = dst;
    s->oend = dst + cap;
    s->good_match = ZL_CONFIG[clevel][0];
    s->max_lazy = ZL_CONFIG[clevel][1];
    s->nice_match = ZL_CONFIG[clevel][2];
    s->max_chain = ZL_CONFIG[clevel][3];
    s->match_length = s->prev_length = ZL_MIN_MATCH - 1;
    zl_static_init(s);
    zl_init_block(s);
    unsigned flevel = clevel < 2 ? 0 : clevel < 6 ? 1 : clevel == 6 ? 2 : 3;
    unsigned header = (0x78u << 8) | (flevel << 6);
    header += 31 - (header % 31);
    zl_put_byte(s, header >> 8);
    zl_put_byte(s, header & 255);
    if (clevel == 0)
        zl_deflate_stored(s);
    else if (clevel <= 3)
        zl_deflate_fast(s);
    else
        zl_deflate_slow(s);
    uint32_t adler = zl_adler32(src, n);
    for (int k = 3; k >= 0; k--)
        zl_put_byte(s, (adler >> (8 * k)) & 255);
    int64_t size = s->overflow ? 0 : s->op - dst;
    free(s);
    return size;
}
