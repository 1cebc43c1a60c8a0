/* blosclz streams for blosc code 0, included by blosc.c.
 *
 * The format (c-blosc's FastLZ-style codec, as its decoder reads it):
 *   - a control byte c < 32 is a literal run: c + 1 bytes follow (the
 *     stream's first byte is always one, read with its top 3 bits
 *     masked off);
 *   - otherwise bits 5-7 of c are a length code L and bits 0-4 the high
 *     bits H of a distance; L == 7 continues with bytes added to the
 *     length while they are 255; then a byte D: the match is L + 2 bytes
 *     (plus the continuation bytes) long, at distance (H << 8) + D + 1;
 *     H == 31 and D == 255 instead read a big-endian u16 F and the
 *     distance is F + 8192;
 *   - the stream ends after a literal run or after a match's last byte,
 *     but c-blosc's decoder copies a match only when a control byte
 *     follows it, so a stream never ends with a match.
 * The encoder (the port's own; io/blosclz.py is its plain version, byte
 * for byte):
 *   - the hash of the 4 bytes at ip is (seq * 2654435761 mod 2^32) >> 18,
 *     a 16384-entry table of the last position with that hash;
 *   - positions ip <= n - 12 may start a match, which extends up to
 *     n - 5 (so a stream ends with at least 5 literals); a candidate is
 *     taken when its 4 bytes equal ip's and it is at most 73725 bytes
 *     back;
 *   - after a miss ip advances by (search >> 6), search += 1, search
 *     starting at max(1, 10 - clevel) << 6 and reset after each match;
 *   - after a match ending at e, e - 2 is entered in the table;
 *   - literal runs are cut into runs of 32.
 */

#define BLZ_HASH_LOG 14
#define BLZ_MAX_COPY 32
#define BLZ_MAX_DISTANCE 8191
#define BLZ_MAX_FARDISTANCE (65535 + BLZ_MAX_DISTANCE - 1)

/* literals src[0, n) as runs of at most 32; NULL when they do not fit */
static uint8_t *blz_literals(uint8_t *op, const uint8_t *oend,
                             const uint8_t *src, int64_t n)
{
    while (n > 0) {
        int64_t run = n < BLZ_MAX_COPY ? n : BLZ_MAX_COPY;
        if (oend - op < run + 1)
            return NULL;
        *op++ = (uint8_t)(run - 1);
        memcpy(op, src, (size_t)run);
        op += run;
        src += run;
        n -= run;
    }
    return op;
}

static uint8_t *blz_match(uint8_t *op, const uint8_t *oend, int64_t mlen,
                          int64_t distance)
{
    int64_t len = mlen - 2, dist = distance - 1;
    int far = dist >= BLZ_MAX_DISTANCE;
    if (far)
        dist -= BLZ_MAX_DISTANCE;
    if (oend - op < (far ? 4 : 2) + (len >= 7 ? (len - 7) / 255 + 1 : 0))
        return NULL;
    int hi = far ? 31 : (int)(dist >> 8);
    if (len < 7) {
        *op++ = (uint8_t)((len << 5) + hi);
    } else {
        *op++ = (uint8_t)((7 << 5) + hi);
        for (len -= 7; len >= 255; len -= 255)
            *op++ = 255;
        *op++ = (uint8_t)len;
    }
    if (far) {
        *op++ = 255;
        *op++ = (uint8_t)(dist >> 8);
        *op++ = (uint8_t)(dist & 255);
    } else {
        *op++ = (uint8_t)(dist & 255);
    }
    return op;
}

/* A blosclz stream of src[0, n) into dst; its size, or 0 when it would
 * exceed cap bytes. */
int64_t blosclz_compress(const uint8_t *src, int64_t n, uint8_t *dst,
                         int64_t cap, int clevel)
{
    uint8_t *op = dst;
    const uint8_t *oend = dst + cap;
    int64_t anchor = 0, ip = 0;
    int accel = 10 - clevel;
    if (accel < 1)
        accel = 1;
    if (n >= MFLIMIT + 1) {
        int32_t table[1 << BLZ_HASH_LOG];
        const int64_t mflimit = n - MFLIMIT;
        const uint8_t *matchlimit = src + n - LASTLITERALS;
        uint32_t search = (uint32_t)accel << SKIP_TRIGGER;
        for (int i = 0; i < (1 << BLZ_HASH_LOG); ++i)
            table[i] = -1;
        while (ip <= mflimit) {
            uint32_t seq = read32(src + ip);
            uint32_t h = (seq * 2654435761u) >> (32 - BLZ_HASH_LOG);
            int64_t ref = table[h];
            table[h] = (int32_t)ip;
            if (ref >= 0 && ip - ref <= BLZ_MAX_FARDISTANCE
                    && read32(src + ref) == seq) {
                int64_t len = MINMATCH + common_len(src + ip + MINMATCH,
                                                    src + ref + MINMATCH,
                                                    matchlimit);
                op = blz_literals(op, oend, src + anchor, ip - anchor);
                if (op == NULL)
                    return 0;
                op = blz_match(op, oend, len, ip - ref);
                if (op == NULL)
                    return 0;
                ip += len;
                anchor = ip;
                table[(read32(src + ip - 2) * 2654435761u)
                      >> (32 - BLZ_HASH_LOG)] = (int32_t)(ip - 2);
                search = (uint32_t)accel << SKIP_TRIGGER;
            } else {
                ip += search++ >> SKIP_TRIGGER;
            }
        }
    }
    op = blz_literals(op, oend, src + anchor, n - anchor);
    if (op == NULL)
        return 0;
    return op - dst;
}

/* Decode a blosclz stream of srclen bytes into dst (at most dstlen
 * bytes), as c-blosc's decoder does: the bytes written, or ERR_CORRUPT
 * where it gives up. */
int64_t blosclz_decompress(const uint8_t *src, int64_t srclen, uint8_t *dst,
                           int64_t dstlen)
{
    const uint8_t *ip = src, *iend = src + srclen;
    uint8_t *op = dst, *oend = dst + dstlen;
    if (srclen == 0)
        return ERR_CORRUPT;
    unsigned ctrl = *ip++ & 31u;
    for (;;) {
        if (ctrl >= 32) {
            int64_t len = (int64_t)(ctrl >> 5) - 1;
            int64_t ofs = (int64_t)(ctrl & 31) << 8;
            unsigned code;
            if (len == 6) {
                do {
                    if (ip + 1 >= iend)
                        return ERR_CORRUPT;
                    code = *ip++;
                    len += code;
                } while (code == 255);
            } else if (ip + 1 >= iend) {
                return ERR_CORRUPT;
            }
            code = *ip++;
            len += 3;
            int64_t distance = ofs + code + 1;
            if (code == 255 && ofs == (31 << 8)) {
                if (ip + 1 >= iend)
                    return ERR_CORRUPT;
                distance = ((int64_t)ip[0] << 8) + ip[1] + BLZ_MAX_DISTANCE
                           + 1;
                ip += 2;
            }
            if (len > oend - op || distance > op - dst)
                return ERR_CORRUPT;
            if (ip >= iend)
                break;    /* c-blosc drops a match that ends the stream */
            ctrl = *ip++;
            copy_match(op, distance, len);
            op += len;
        } else {
            int64_t run = (int64_t)ctrl + 1;
            if (run > oend - op || run > iend - ip)
                return ERR_CORRUPT;
            memcpy(op, ip, (size_t)run);
            op += run;
            ip += run;
            if (ip >= iend)
                break;
            ctrl = *ip++;
        }
    }
    return op - dst;
}
