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
 * 'lz4hc' is liblz4 1.10's LZ4_compress_HC with a bounded output, as
 * c-blosc calls it (the clevel passed through, the output bounded by the
 * stream's length): levels 1-2 LZ4MID_compress, 3-9 the hash chain
 * LZ4HC_compress_hashChain with 2^(level - 1) attempts (9 for clevel < 1).
 * io/lz4hc_plain.py states the rules and is the plain version.
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

/* liblz4's HC state: indices are positions + HC_BASE, so a table entry of
 * 0 is out of reach of every search. */
#define HC_BASE 65536
#define OPTIMAL_ML 18

typedef struct {
    const uint8_t *src;
    uint32_t *head;
    uint16_t *chain;
    int64_t next;
    int attempts;
    int pattern;
} hc_state;

typedef struct {
    int64_t len, off, back;
} hc_match;

static uint32_t hc_hash(const uint8_t *p)
{
    return (read32(p) * 2654435761u) >> (32 - HC_HASH_LOG);
}

static void hc_insert(hc_state *s, int64_t ip)
{
    for (; s->next < ip; ++s->next) {
        uint32_t h = hc_hash(s->src + s->next);
        uint32_t idx = (uint32_t)(s->next + HC_BASE);
        uint32_t delta = idx - s->head[h];
        s->chain[idx & 0xFFFF] = (uint16_t)(delta > LZ4_MAX_DISTANCE
                                            ? LZ4_MAX_DISTANCE : delta);
        s->head[h] = idx;
    }
}

/* bytes from p (before end) equal to b */
static int64_t run_fwd(const uint8_t *p, const uint8_t *end, uint8_t b)
{
    const uint8_t *q = p;
    while (q < end && *q == b)
        ++q;
    return q - p;
}

static int64_t run_back(const uint8_t *p, const uint8_t *low, uint8_t b)
{
    const uint8_t *q = p;
    while (q > low && q[-1] == b)
        --q;
    return p - q;
}

/* LZ4HC_InsertAndGetWiderMatch: the best match longer than longest of ip
 * extended back to low, or {longest, 0, 0} */
static hc_match hc_wider(hc_state *s, int64_t ip, int64_t low,
                         int64_t high, int64_t longest)
{
    const uint8_t *src = s->src;
    hc_match best = {longest, 0, 0};
    hc_insert(s, ip);
    const uint32_t ip_idx = (uint32_t)(ip + HC_BASE);
    const uint32_t lowest = ip_idx < 2 * HC_BASE ? HC_BASE
                            : ip_idx - LZ4_MAX_DISTANCE;
    const int64_t look_back = ip - low;
    const uint32_t pattern = read32(src + ip);
    int nb = s->attempts, repeat = -1;
    int64_t src_len = 0;
    uint32_t m_idx = s->head[hc_hash(src + ip)];
    while (m_idx >= lowest && nb > 0) {
        --nb;
        const int64_t mp = (int64_t)m_idx - HC_BASE;
        const int64_t k = best.len - 1;
        if (src[low + k] == src[mp - look_back + k]
                && src[low + k + 1] == src[mp - look_back + k + 1]
                && read32(src + mp) == pattern) {
            int64_t back = 0;
            if (look_back) {
                const int64_t lim = low - ip > -mp ? low - ip : -mp;
                while (back > lim && src[ip + back - 1] == src[mp + back - 1])
                    --back;
            }
            int64_t len = MINMATCH + common_len(src + ip + MINMATCH,
                                                src + mp + MINMATCH,
                                                src + high) - back;
            if (len > best.len) {
                best.len = len;
                best.off = ip_idx - m_idx;
                best.back = back;
            }
        }
        const uint32_t dist = s->chain[m_idx & 0xFFFF];
        if (s->pattern && dist == 1) {
            const uint32_t cand = m_idx - 1;
            const uint8_t byte = (uint8_t)pattern;
            if (repeat < 0) {
                repeat = pattern == byte * 0x01010101u;
                if (repeat)
                    src_len = run_fwd(src + ip + 4, src + high, byte) + 4;
            }
            if (repeat && cand >= lowest) {
                const int64_t cp = (int64_t)cand - HC_BASE;
                if (read32(src + cp) == pattern) {
                    const int64_t fwd = run_fwd(src + cp + 4, src + high,
                                                byte) + 4;
                    int64_t back_len = run_back(src + cp, src, byte);
                    int64_t floor_idx = (int64_t)cand - back_len;
                    if (floor_idx < lowest)
                        floor_idx = lowest;
                    back_len = cand - floor_idx;
                    const int64_t seg = back_len + fwd;
                    if (seg >= src_len && fwd <= src_len) {
                        m_idx = (uint32_t)(cand + fwd - src_len);
                    } else {
                        m_idx = (uint32_t)(cand - back_len);
                        if (look_back == 0) {
                            const int64_t max_ml = seg < src_len ? seg
                                                                 : src_len;
                            if (best.len < max_ml) {
                                if (ip_idx - m_idx > LZ4_MAX_DISTANCE)
                                    break;
                                best.len = max_ml;
                                best.off = ip_idx - m_idx;
                            }
                            const uint32_t d = s->chain[m_idx & 0xFFFF];
                            if (d > m_idx)
                                break;
                            m_idx -= d;
                        }
                    }
                    continue;
                }
            }
        }
        m_idx -= dist;
    }
    return best;
}

/* LZ4HC_encodeSequence: literals [anchor, ip), a match of mlen at off;
 * the new op, NULL past oend. */
static uint8_t *hc_sequence(uint8_t *op, const uint8_t *oend,
                            const uint8_t *src, int64_t anchor, int64_t ip,
                            int64_t mlen, int64_t off)
{
    const int64_t lit = ip - anchor;
    uint8_t *token = op++;
    if (op + lit / 255 + lit + 2 + 1 + LASTLITERALS > oend)
        return NULL;
    if (lit >= 15) {
        *token = 15 << 4;
        op = put_length(op, lit);
    } else {
        *token = (uint8_t)(lit << 4);
    }
    memcpy(op, src + anchor, (size_t)lit);
    op += lit;
    *op++ = (uint8_t)(off & 0xff);
    *op++ = (uint8_t)(off >> 8);
    const int64_t m = mlen - MINMATCH;
    if (op + m / 255 + 1 + LASTLITERALS > oend)
        return NULL;
    if (m >= 15) {
        *token += 15;
        op = put_length(op, m);
    } else {
        *token += (uint8_t)m;
    }
    return op;
}

#define HC_SEQ(len, off)                                                  \
    do {                                                                  \
        op = hc_sequence(op, oend, src, anchor, ip, (len), (off));        \
        if (op == NULL)                                                   \
            goto overflow;                                                \
        ip += (len);                                                      \
        anchor = ip;                                                      \
    } while (0)

/* LZ4HC_compress_hashChain over src[0, n); the new op, NULL past oend */
static uint8_t *hc_hash_chain(hc_state *s, int64_t n, uint8_t *op,
                              const uint8_t *oend, int64_t *anchor_out)
{
    const uint8_t *src = s->src;
    const int64_t mflimit = n - MFLIMIT, matchlimit = n - LASTLITERALS;
    int64_t ip = 0, anchor = 0, start0, s2 = 0, s3 = 0;
    hc_match m0, m1, m2, m3;
    while (ip <= mflimit) {
        m1 = hc_wider(s, ip, ip, matchlimit, MINMATCH - 1);
        if (m1.len < MINMATCH) {
            ++ip;
            continue;
        }
        start0 = ip;
        m0 = m1;
search2:
        if (ip + m1.len <= mflimit) {
            s2 = ip + m1.len - 2;
            m2 = hc_wider(s, s2, ip, matchlimit, m1.len);
            s2 += m2.back;
        } else {
            m2.len = 0;
        }
        if (m2.len <= m1.len) {
            HC_SEQ(m1.len, m1.off);
            continue;
        }
        if (start0 < ip && s2 < ip + m0.len) {
            ip = start0;
            m1 = m0;
        }
        if (s2 - ip < 3) {
            ip = s2;
            m1 = m2;
            goto search2;
        }
search3:
        if (s2 - ip < OPTIMAL_ML) {
            int64_t new_ml = m1.len > OPTIMAL_ML ? OPTIMAL_ML : m1.len;
            if (ip + new_ml > s2 + m2.len - MINMATCH)
                new_ml = s2 - ip + m2.len - MINMATCH;
            const int64_t corr = new_ml - (s2 - ip);
            if (corr > 0) {
                s2 += corr;
                m2.len -= corr;
            }
        }
        if (s2 + m2.len <= mflimit) {
            s3 = s2 + m2.len - 3;
            m3 = hc_wider(s, s3, s2, matchlimit, m2.len);
            s3 += m3.back;
        } else {
            m3.len = 0;
        }
        if (m3.len <= m2.len) {
            if (s2 < ip + m1.len)
                m1.len = s2 - ip;
            HC_SEQ(m1.len, m1.off);
            ip = s2;
            HC_SEQ(m2.len, m2.off);
            continue;
        }
        if (s3 < ip + m1.len + 3) {
            if (s3 >= ip + m1.len) {
                if (s2 < ip + m1.len) {
                    const int64_t corr = ip + m1.len - s2;
                    s2 += corr;
                    m2.len -= corr;
                    if (m2.len < MINMATCH) {
                        s2 = s3;
                        m2 = m3;
                    }
                }
                HC_SEQ(m1.len, m1.off);
                ip = s3;
                m1 = m3;
                start0 = s2;
                m0 = m2;
                goto search2;
            }
            s2 = s3;
            m2 = m3;
            goto search3;
        }
        if (s2 < ip + m1.len) {
            if (s2 - ip < OPTIMAL_ML) {
                if (m1.len > OPTIMAL_ML)
                    m1.len = OPTIMAL_ML;
                if (ip + m1.len > s2 + m2.len - MINMATCH)
                    m1.len = s2 - ip + m2.len - MINMATCH;
                const int64_t corr = m1.len - (s2 - ip);
                if (corr > 0) {
                    s2 += corr;
                    m2.len -= corr;
                }
            } else {
                m1.len = s2 - ip;
            }
        }
        HC_SEQ(m1.len, m1.off);
        ip = s2;
        m1 = m2;
        s2 = s3;
        m2 = m3;
        goto search3;
    }
    *anchor_out = anchor;
    return op;
overflow:
    return NULL;
}

#define MID_LOG 14

static uint32_t mid_hash4(const uint8_t *p)
{
    return (read32(p) * 2654435761u) >> (32 - MID_LOG);
}

static uint32_t mid_hash8(const uint8_t *p)
{
    uint64_t v;
    memcpy(&v, p, 8);
    return (uint32_t)(((v << 8) * 58295818150454627ull) >> (64 - MID_LOG));
}

/* LZ4MID_compress over src[0, n); the new op, NULL past oend */
static uint8_t *hc_mid(const uint8_t *src, int64_t n, uint32_t *t4,
                       uint8_t *op, const uint8_t *oend, int64_t *anchor_out)
{
    uint32_t *t8 = t4 + (1 << MID_LOG);
    const int64_t mflimit = n - MFLIMIT, matchlimit = n - LASTLITERALS;
    const uint32_t ilimit_idx = (uint32_t)(n - 8 + HC_BASE);
    int64_t ip = 0, anchor = 0, mlen = 0;
    uint32_t dist = 0;
    while (ip <= mflimit) {
        const uint32_t ip_idx = (uint32_t)(ip + HC_BASE);
        int found = 0;
        uint32_t h = mid_hash8(src + ip), pos = t8[h];
        t8[h] = ip_idx;
        if (ip_idx - pos <= LZ4_MAX_DISTANCE) {
            mlen = common_len(src + ip, src + pos - HC_BASE,
                              src + matchlimit);
            if (mlen >= MINMATCH) {
                dist = ip_idx - pos;
                found = 1;
            }
        }
        if (!found) {
            h = mid_hash4(src + ip);
            pos = t4[h];
            t4[h] = ip_idx;
            if (ip_idx - pos <= LZ4_MAX_DISTANCE) {
                mlen = common_len(src + ip, src + pos - HC_BASE,
                                  src + matchlimit);
                if (mlen >= MINMATCH) {
                    found = 1;
                    dist = ip_idx - pos;
                    const uint32_t h2 = mid_hash8(src + ip + 1);
                    const uint32_t pos8 = t8[h2];
                    const uint32_t d2 = ip_idx + 1 - pos8;
                    if (d2 <= LZ4_MAX_DISTANCE && ip < mflimit) {
                        int64_t ml2 = common_len(src + ip + 1,
                                                 src + pos8 - HC_BASE,
                                                 src + matchlimit);
                        if (ml2 > mlen) {
                            t8[h2] = ip_idx + 1;
                            ++ip;
                            mlen = ml2;
                            dist = d2;
                        }
                    }
                }
            }
        }
        if (!found) {
            ip += 1 + ((ip - anchor) >> 9);
            continue;
        }
        while (ip > anchor && ip > (int64_t)dist
                && src[ip - 1] == src[ip - dist - 1]) {
            --ip;
            ++mlen;
        }
        t8[mid_hash8(src + ip + 1)] = ip_idx + 1;
        t8[mid_hash8(src + ip + 2)] = ip_idx + 2;
        t4[mid_hash4(src + ip + 1)] = ip_idx + 1;
        op = hc_sequence(op, oend, src, anchor, ip, mlen, dist);
        if (op == NULL)
            return NULL;
        ip += mlen;
        anchor = ip;
        const uint32_t end = (uint32_t)(ip + HC_BASE);
        if (end - 2 < ilimit_idx) {
            if (ip > 5)
                t8[mid_hash8(src + ip - 5)] = end - 5;
            t8[mid_hash8(src + ip - 3)] = end - 3;
            t8[mid_hash8(src + ip - 2)] = end - 2;
            t4[mid_hash4(src + ip - 2)] = end - 2;
            t4[mid_hash4(src + ip - 1)] = end - 1;
        }
    }
    *anchor_out = anchor;
    return op;
}

/* An LZ4 block of src[0, n) into dst as LZ4_compress_HC writes it; its
 * size, 0 when liblz4 would not fit it in cap bytes, ERR_NOMEM. */
int64_t lz4hc_compress_block(const uint8_t *src, int64_t n, uint8_t *dst,
                             int64_t cap, int clevel)
{
    uint8_t *op = dst;
    const uint8_t *oend = dst + cap;
    int64_t anchor = 0;
    const int level = clevel < 1 ? 9 : clevel > 9 ? 9 : clevel;
    if (n >= MFLIMIT + 1) {
        uint32_t *head = (uint32_t *)calloc((size_t)1 << HC_HASH_LOG,
                                            sizeof(uint32_t));
        uint16_t *chain = (uint16_t *)calloc(HC_WINDOW, sizeof(uint16_t));
        if (head == NULL || chain == NULL) {
            free(head);
            free(chain);
            return ERR_NOMEM;
        }
        if (level <= 2) {
            op = hc_mid(src, n, head, op, oend, &anchor);
        } else {
            hc_state s = {src, head, chain, 0, 1 << (level - 1), level == 9};
            op = hc_hash_chain(&s, n, op, oend, &anchor);
        }
        free(head);
        free(chain);
        if (op == NULL)
            return 0;
    }
    const int64_t run = n - anchor;
    if (op + 1 + (run + 240) / 255 + run > oend)
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
