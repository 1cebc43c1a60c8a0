/* LZ4 blocks for blosc code 1 ('lz4' and 'lz4hc'), included by blosc.c.
 *
 * io/blosc.py holds the plain version of both matchers; the C and the
 * plain encoders write byte-equal blocks. Rules shared by both matchers
 * (the LZ4 block format leaves them free):
 *   - a position may start a match only if ip <= n - 12 (and never in
 *     a block shorter than 13 bytes); a match extends while bytes agree,
 *     up to n - 5, so the last 5 bytes are always literals;
 *   - a candidate is taken when its 4 bytes equal ip's and ip - ref is at
 *     most 65535; no backward extension.
 * 'lz4' (the fast matcher):
 *   - a 4-byte little-endian sequence at ip hashes to
 *     (seq * 2654435761 mod 2^32) >> 20, a 4096-entry table of the last
 *     position with that hash, empty (-1) at the start of each block;
 *   - after a miss ip advances by (search >> 6), search += 1, where
 *     search starts at accel << 6 and is reset after every match;
 *     accel = 10 - clevel (at least 1), as c-blosc sets it for LZ4;
 *   - after a match of length L ending at e, position e - 2 is entered
 *     in the table, and the search goes on at e.
 * 'lz4hc' (the hash-chain matcher):
 *   - the hash is (seq * 2654435761 mod 2^32) >> 17, a 32768-entry table
 *     of the last position with that hash; each position p also records
 *     in chain[p mod 65536] its distance to the previous position with
 *     the same hash (0 when there is none within 65535 bytes);
 *   - before the search at ip every position not yet entered below ip is
 *     entered; the search walks the chain from the newest candidate, at
 *     most 2^(clevel - 1) candidates (clevel 1..9), and keeps the longest
 *     match (the nearest of equal length);
 *   - a match of 4 bytes or more is emitted and the search goes on after
 *     it; otherwise ip advances by one.
 */

#define HASH_LOG 12
#define HC_HASH_LOG 15
#define HC_WINDOW 65536
#define MINMATCH 4
#define MFLIMIT 12
#define LASTLITERALS 5
#define SKIP_TRIGGER 6
#define LZ4_MAX_DISTANCE 65535

static uint32_t hash4(uint32_t seq)
{
    return (seq * 2654435761u) >> (32 - HASH_LOG);
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

/* An LZ4 block of src[0, n) into dst with the fast matcher; its size, or
 * 0 when it would exceed cap bytes. */
int64_t lz4_compress_block(const uint8_t *src, int64_t n, uint8_t *dst,
                           int64_t cap, int clevel)
{
    int32_t table[1 << HASH_LOG];
    uint8_t *op = dst;
    const uint8_t *oend = dst + cap;
    int64_t anchor = 0, ip = 0;
    int accel = 10 - clevel;
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
            if (ref >= 0 && ip - ref <= LZ4_MAX_DISTANCE
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

/* An LZ4 block of src[0, n) into dst with the hash-chain matcher; its
 * size, 0 when it would exceed cap bytes, ERR_NOMEM. */
int64_t lz4hc_compress_block(const uint8_t *src, int64_t n, uint8_t *dst,
                             int64_t cap, int clevel)
{
    uint8_t *op = dst;
    const uint8_t *oend = dst + cap;
    int64_t anchor = 0, ip = 0;
    if (n >= MFLIMIT + 1) {
        int32_t *head = (int32_t *)malloc(sizeof(int32_t) << HC_HASH_LOG);
        uint16_t *chain = (uint16_t *)malloc(sizeof(uint16_t) * HC_WINDOW);
        if (head == NULL || chain == NULL) {
            free(head);
            free(chain);
            return ERR_NOMEM;
        }
        for (int i = 0; i < (1 << HC_HASH_LOG); ++i)
            head[i] = -1;
        const int level = clevel < 1 ? 1 : clevel > 9 ? 9 : clevel;
        const int depth = 1 << (level - 1);
        const int64_t mflimit = n - MFLIMIT;
        const uint8_t *matchlimit = src + n - LASTLITERALS;
        int64_t next = 0;
        while (ip <= mflimit) {
            for (; next < ip; ++next) {
                uint32_t h = (read32(src + next) * 2654435761u)
                             >> (32 - HC_HASH_LOG);
                int64_t prev = head[h];
                chain[next & (HC_WINDOW - 1)] = (uint16_t)(
                    prev >= 0 && next - prev <= LZ4_MAX_DISTANCE
                    ? next - prev : 0);
                head[h] = (int32_t)next;
            }
            uint32_t seq = read32(src + ip);
            int64_t cand = head[(seq * 2654435761u) >> (32 - HC_HASH_LOG)];
            int64_t best = 0, best_ref = 0;
            for (int k = 0; k < depth && cand >= 0
                    && ip - cand <= LZ4_MAX_DISTANCE; ++k) {
                if (read32(src + cand) == seq) {
                    int64_t len = MINMATCH + common_len(
                        src + ip + MINMATCH, src + cand + MINMATCH,
                        matchlimit);
                    if (len > best) {
                        best = len;
                        best_ref = cand;
                    }
                }
                int64_t delta = chain[cand & (HC_WINDOW - 1)];
                if (delta == 0)
                    break;
                cand -= delta;
            }
            if (best >= MINMATCH) {
                op = emit(op, oend, src + anchor, ip - anchor, ip - best_ref,
                          best);
                if (op == NULL)
                    break;
                ip += best;
                anchor = ip;
            } else {
                ++ip;
            }
        }
        free(head);
        free(chain);
        if (op == NULL)
            return 0;
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
        copy_match(op, off, mlen);
        op += mlen;
    }
    return op == oend ? dstlen : ERR_CORRUPT;
}
