/* LZ4 blocks for blosc code 1 ('lz4' and 'lz4hc'), included by blosc.c.
 *
 * io/blosc.py holds the plain version of both matchers; the C and the
 * plain encoders write byte-equal blocks.
 * 'lz4' is liblz4 1.9's LZ4_compress_fast with a bounded output, as
 * c-blosc calls it (acceleration accel = max(1, 10 - clevel), the output
 * bounded by the stream's length), so the blocks are byte-equal to
 * c-blosc's:
 *   - a block under 13 bytes is all literals; a match extends while the
 *     bytes agree, up to n - 5;
 *   - a stream of at least 65547 bytes hashes the 8-byte little-endian
 *     word v at a position to ((v << 24) * 889523592379 mod 2^64) >> 52
 *     (4096 entries) and skips candidates more than 65535 bytes back; a
 *     shorter one hashes the u32 to (u32 * 2654435761 mod 2^32) >> 19
 *     (8192 entries), with no distance check;
 *   - the table starts all zero (every hash names position 0); position
 *     0 is entered and the search starts at 1;
 *   - each search starts with step 1 and n = accel << 6: take the
 *     candidate of ip's hash, next = ip + step, step = n++ >> 6; stop
 *     with the last literals when next > len - 11; hash next, enter ip;
 *     accept when the 4 bytes at the candidate equal ip's;
 *   - the match is extended backwards while ip is past the last
 *     sequence's end, the candidate past 0 and the bytes before agree;
 *   - after a match ending at e (stop if e >= len - 11), e - 2 is
 *     entered, then e is looked up and entered: a hit emits a sequence
 *     with no literals and repeats, a miss searches on from e + 1;
 *   - liblz4's output bounds: 0 (stored as it is) when the literals
 *     would leave less than 8 + litlen / 255 bytes, the match less than
 *     6 + (matchcode + 240) / 255, or the last literals less than
 *     1 + (run + 240) / 255 after them.
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

#define LZ4_64K_LIMIT (65536 + MFLIMIT - 1)

static uint32_t lz4_hash(const uint8_t *p, int big)
{
    if (big) {
        uint64_t v;
        memcpy(&v, p, 8);
        return (uint32_t)(((v << 24) * 889523592379ull) >> 52);
    }
    return (read32(p) * 2654435761u) >> 19;
}

/* An LZ4 block of src[0, n) into dst with the fast matcher; its size, or
 * 0 when liblz4 would not fit it in cap bytes. */
int64_t lz4_compress_block(const uint8_t *src, int64_t n, uint8_t *dst,
                           int64_t cap, int clevel)
{
    uint32_t table[1 << (HASH_LOG + 1)];
    uint8_t *op = dst;
    const uint8_t *olimit = dst + cap;
    const int big = n >= LZ4_64K_LIMIT;
    const int64_t accel = clevel < 9 ? 10 - clevel : 1;
    int64_t anchor = 0;
    if (n >= MFLIMIT + 1) {
        const int64_t limit = n - MFLIMIT + 1;
        const uint8_t *matchlimit = src + n - LASTLITERALS;
        memset(table, 0, sizeof(table));
        int64_t ip = 1, match;
        uint32_t fwdh = lz4_hash(src + 1, big);
        table[lz4_hash(src, big)] = 0;
        for (;;) {
            int64_t fwd = ip, step = 1, search = accel << SKIP_TRIGGER;
            for (;;) {
                uint32_t h = fwdh;
                int64_t cur = fwd;
                match = table[h];
                ip = fwd;
                fwd += step;
                step = search++ >> SKIP_TRIGGER;
                if (fwd > limit)
                    goto last_literals;
                fwdh = lz4_hash(src + fwd, big);
                table[h] = (uint32_t)cur;
                if (big && match + LZ4_MAX_DISTANCE < cur)
                    continue;
                if (read32(src + match) == read32(src + ip))
                    break;
            }
            while (ip > anchor && match > 0 && src[ip - 1] == src[match - 1]) {
                --ip;
                --match;
            }
            int64_t litlen = ip - anchor;
            uint8_t *token = op++;
            if (op + litlen + 8 + litlen / 255 > olimit)
                return 0;
            if (litlen >= 15) {
                *token = 15 << 4;
                op = put_length(op, litlen);
            } else {
                *token = (uint8_t)(litlen << 4);
            }
            memcpy(op, src + anchor, (size_t)litlen);
            op += litlen;
            for (;;) {
                int64_t off = ip - match;
                *op++ = (uint8_t)(off & 0xff);
                *op++ = (uint8_t)(off >> 8);
                int64_t code = common_len(src + ip + MINMATCH,
                                          src + match + MINMATCH, matchlimit);
                ip += code + MINMATCH;
                if (op + 6 + (code + 240) / 255 > olimit)
                    return 0;
                if (code >= 15) {
                    *token += 15;
                    op = put_length(op, code);
                } else {
                    *token += (uint8_t)code;
                }
                anchor = ip;
                if (ip >= limit)
                    goto last_literals;
                table[lz4_hash(src + ip - 2, big)] = (uint32_t)(ip - 2);
                uint32_t h = lz4_hash(src + ip, big);
                match = table[h];
                table[h] = (uint32_t)ip;
                if ((big && match + LZ4_MAX_DISTANCE < ip)
                        || read32(src + match) != read32(src + ip))
                    break;
                token = op++;
                *token = 0;
            }
            fwdh = lz4_hash(src + ++ip, big);
        }
    }
last_literals:;
    int64_t run = n - anchor;
    if (op + run + 1 + (run + 240) / 255 > olimit)
        return 0;
    if (run >= 15) {
        *op++ = 15 << 4;
        op = put_length(op, run);
    } else {
        *op++ = (uint8_t)(run << 4);
    }
    memcpy(op, src + anchor, (size_t)run);
    op += run;
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
