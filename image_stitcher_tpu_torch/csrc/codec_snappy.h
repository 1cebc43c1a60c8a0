/* Snappy streams for blosc code 2, included by blosc.c.
 *
 * The raw snappy block format: the uncompressed length as a varint, then
 * elements, each starting with a tag byte whose low 2 bits say what it
 * is: 00 literals (length - 1 in the top 6 bits, or 60..63 for a length
 * - 1 in the next 1..4 bytes, LE), 01 a copy of 4..11 bytes ((tag >> 2)
 * & 7) + 4 with an 11-bit offset (tag >> 5 high bits, then a byte), 10 a
 * copy of (tag >> 2) + 1 bytes with a u16 LE offset, 11 the same with a
 * u32 LE offset. The decoder reads all of them.
 * The encoder (the port's own; io/snappy.py is its plain version, byte
 * for byte):
 *   - the hash of the 4 bytes at ip is (seq * 0x1e35a7bd mod 2^32) >> 18,
 *     a 16384-entry table of the last position with that hash;
 *   - positions ip <= n - 4 may start a match, which extends to the end
 *     of the input; a candidate is taken when its 4 bytes equal ip's and
 *     it is at most 65535 bytes back;
 *   - after a miss ip advances by (search >> 5), search += 1, search
 *     starting at 32 and reset after each match;
 *   - after a match ending at e (e <= n - 4), e - 1 is entered in the
 *     table;
 *   - a match is emitted as copies of 64 bytes while 68 or more are
 *     left, then one of 60 if more than 64 are left; a copy of 4..11
 *     bytes at an offset under 2048 takes the 2-byte form (01), every
 *     other the 3-byte form (10).
 */

#define SNAPPY_HASH_LOG 14

static uint8_t *snappy_literal(uint8_t *op, const uint8_t *oend,
                               const uint8_t *src, int64_t n)
{
    if (n == 0)
        return op;
    int64_t m = n - 1;
    int extra = m < 60 ? 0 : m < 256 ? 1 : m < 65536 ? 2 : m < 16777216
                ? 3 : 4;
    if (oend - op < 1 + extra + n)
        return NULL;
    if (extra == 0) {
        *op++ = (uint8_t)(m << 2);
    } else {
        *op++ = (uint8_t)((59 + extra) << 2);
        for (int k = 0; k < extra; ++k)
            *op++ = (uint8_t)(m >> (8 * k));
    }
    memcpy(op, src, (size_t)n);
    return op + n;
}

static uint8_t *snappy_copy(uint8_t *op, const uint8_t *oend, int64_t len,
                            int64_t offset)
{
    while (len > 0) {
        int64_t part = len >= 68 ? 64 : len > 64 ? 60 : len;
        if (part <= 11 && offset < 2048) {
            if (oend - op < 2)
                return NULL;
            *op++ = (uint8_t)(1 | ((part - 4) << 2) | ((offset >> 8) << 5));
            *op++ = (uint8_t)(offset & 255);
        } else {
            if (oend - op < 3)
                return NULL;
            *op++ = (uint8_t)(2 | ((part - 1) << 2));
            *op++ = (uint8_t)(offset & 255);
            *op++ = (uint8_t)(offset >> 8);
        }
        len -= part;
    }
    return op;
}

/* A snappy stream of src[0, n) into dst; its size, or 0 when it would
 * exceed cap bytes. */
int64_t snappy_compress(const uint8_t *src, int64_t n, uint8_t *dst,
                        int64_t cap, int clevel)
{
    (void)clevel;    /* snappy has no levels */
    uint8_t *op = dst;
    const uint8_t *oend = dst + cap;
    uint64_t v = (uint64_t)n;
    do {
        if (op >= oend)
            return 0;
        *op++ = (uint8_t)((v & 127) | (v >= 128 ? 128 : 0));
        v >>= 7;
    } while (v);
    int64_t anchor = 0, ip = 0;
    if (n >= 4) {
        int32_t table[1 << SNAPPY_HASH_LOG];
        uint32_t search = 32;
        for (int i = 0; i < (1 << SNAPPY_HASH_LOG); ++i)
            table[i] = -1;
        while (ip <= n - 4) {
            uint32_t seq = read32(src + ip);
            uint32_t h = (seq * 0x1e35a7bdu) >> (32 - SNAPPY_HASH_LOG);
            int64_t ref = table[h];
            table[h] = (int32_t)ip;
            if (ref >= 0 && ip - ref <= 65535 && read32(src + ref) == seq) {
                int64_t len = 4 + common_len(src + ip + 4, src + ref + 4,
                                             src + n);
                op = snappy_literal(op, oend, src + anchor, ip - anchor);
                if (op == NULL)
                    return 0;
                op = snappy_copy(op, oend, len, ip - ref);
                if (op == NULL)
                    return 0;
                ip += len;
                anchor = ip;
                if (ip <= n - 4)
                    table[(read32(src + ip - 1) * 0x1e35a7bdu)
                          >> (32 - SNAPPY_HASH_LOG)] = (int32_t)(ip - 1);
                search = 32;
            } else {
                ip += search++ >> 5;
            }
        }
    }
    op = snappy_literal(op, oend, src + anchor, n - anchor);
    if (op == NULL)
        return 0;
    return op - dst;
}

/* Decode a snappy stream of srclen bytes holding exactly dstlen bytes:
 * dstlen, or ERR_CORRUPT. */
int64_t snappy_decompress(const uint8_t *src, int64_t srclen, uint8_t *dst,
                          int64_t dstlen)
{
    const uint8_t *ip = src, *iend = src + srclen;
    uint8_t *op = dst, *oend = dst + dstlen;
    uint64_t len = 0;
    for (int shift = 0;; shift += 7) {
        if (ip >= iend || shift > 28)
            return ERR_CORRUPT;
        unsigned b = *ip++;
        len |= (uint64_t)(b & 127) << shift;
        if (!(b & 128))
            break;
    }
    if (len != (uint64_t)dstlen)
        return ERR_CORRUPT;
    while (ip < iend) {
        unsigned tag = *ip++;
        int64_t n, off;
        switch (tag & 3) {
        case 0:
            n = tag >> 2;
            if (n >= 60) {
                int extra = (int)n - 59;
                if (iend - ip < extra)
                    return ERR_CORRUPT;
                n = 0;
                for (int k = 0; k < extra; ++k)
                    n |= (int64_t)ip[k] << (8 * k);
                ip += extra;
            }
            n += 1;
            if (n > iend - ip || n > oend - op)
                return ERR_CORRUPT;
            memcpy(op, ip, (size_t)n);
            op += n;
            ip += n;
            continue;
        case 1:
            if (iend - ip < 1)
                return ERR_CORRUPT;
            n = ((tag >> 2) & 7) + 4;
            off = ((int64_t)(tag >> 5) << 8) | ip[0];
            ip += 1;
            break;
        case 2:
            if (iend - ip < 2)
                return ERR_CORRUPT;
            n = (tag >> 2) + 1;
            off = ip[0] | ((int64_t)ip[1] << 8);
            ip += 2;
            break;
        default:
            if (iend - ip < 4)
                return ERR_CORRUPT;
            n = (tag >> 2) + 1;
            off = (int64_t)read32(ip);
            ip += 4;
            break;
        }
        if (off == 0 || off > op - dst || n > oend - op)
            return ERR_CORRUPT;
        copy_match(op, off, n);
        op += n;
    }
    return op == oend ? dstlen : ERR_CORRUPT;
}
