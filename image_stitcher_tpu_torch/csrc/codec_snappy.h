/* Snappy streams for blosc code 2, included by blosc.c.
 *
 * The raw snappy block format: the uncompressed length as a varint, then
 * elements, each starting with a tag byte whose low 2 bits say what it
 * is: 00 literals (length - 1 in the top 6 bits, or 60..63 for a length
 * - 1 in the next 1..4 bytes, LE), 01 a copy of 4..11 bytes ((tag >> 2)
 * & 7) + 4 with an 11-bit offset (tag >> 5 high bits, then a byte), 10 a
 * copy of (tag >> 2) + 1 bytes with a u16 LE offset, 11 the same with a
 * u32 LE offset. The decoder reads all of them.
 * The encoder is Google snappy 1.2's Compress at level 1 (c-blosc calls
 * its C API, snappy_compress), so its streams are c-blosc's byte for
 * byte; io/snappy_plain.py is its plain version, byte for byte:
 *   - the varint length, then the input in fragments of at most 65536
 *     bytes, each compressed on its own (no copy reaches back into an
 *     earlier fragment) with a zeroed table of u16 offsets from the
 *     fragment's start, so position 0 is a live candidate;
 *   - the table has the next power of two >= the fragment's length
 *     entries, clamped to [256, 2^15]; the 4 bytes at p index it by the
 *     top 15 bits of (load32_le(p) * 0x1e35a7bd mod 2^32), masked to its
 *     size;
 *   - a fragment under 15 bytes is one literal; otherwise ip_limit is its
 *     end - 15. Each literal run starts at next_emit = ip++ (its first
 *     byte is not looked up). The search at ip takes the candidate of
 *     ip's hash and enters ip; it steps skip >> 5 bytes, skip += that,
 *     skip starting at 32, and leaves for the remainder literal (from
 *     next_emit) once ip + step passes ip_limit. When 16 or more
 *     positions are left before ip_limit, snappy first probes the 16
 *     positions ip..ip+15 unrolled (skip ends at 48), which is the same
 *     walk;
 *   - a candidate whose 4 bytes equal ip's gives a match, extended to the
 *     fragment's end. After each copy: stop (remainder literal from ip)
 *     when ip >= ip_limit; otherwise enter ip - 1 and ip, and copy again
 *     while the candidate at ip (its entry before ip was entered) matches
 *     4 bytes;
 *   - a copy goes out as copies of 64 bytes while 68 or more are left,
 *     then one of 60 if more than 64 are left, then the rest; a copy of
 *     4..11 bytes at an offset under 2048 takes the 2-byte form (01),
 *     every other the 3-byte form (10);
 *   - snappy's C API refuses an output buffer under its worst case,
 *     32 + n + n / 6 bytes: the stream is then not written (0), which
 *     c-blosc stores as it is.
 */

#define SNAPPY_BLOCK 65536
#define SNAPPY_MAX_TABLE (1 << 15)
#define SNAPPY_MARGIN 15

static uint8_t *snappy_literal(uint8_t *op, const uint8_t *src, int64_t n)
{
    int64_t m = n - 1;
    if (m < 60) {
        *op++ = (uint8_t)(m << 2);
    } else {
        int extra = m < 256 ? 1 : m < 65536 ? 2 : m < 16777216 ? 3 : 4;
        *op++ = (uint8_t)((59 + extra) << 2);
        for (int k = 0; k < extra; ++k)
            *op++ = (uint8_t)(m >> (8 * k));
    }
    memcpy(op, src, (size_t)n);
    return op + n;
}

static uint8_t *snappy_copy(uint8_t *op, int64_t len, int64_t offset)
{
    while (len > 0) {
        int64_t part = len >= 68 ? 64 : len > 64 ? 60 : len;
        if (part <= 11 && offset < 2048) {
            *op++ = (uint8_t)(1 | ((part - 4) << 2) | ((offset >> 8) << 5));
            *op++ = (uint8_t)(offset & 255);
        } else {
            *op++ = (uint8_t)(2 | ((part - 1) << 2));
            *op++ = (uint8_t)(offset & 255);
            *op++ = (uint8_t)(offset >> 8);
        }
        len -= part;
    }
    return op;
}

static uint32_t snappy_slot(uint32_t v, uint32_t mask)
{
    return ((v * 0x1e35a7bdu) >> 17) & mask;
}

/* One fragment (n <= 65536 bytes) after the stream's length: snappy's
 * CompressFragment. */
static uint8_t *snappy_fragment(const uint8_t *in, int64_t n, uint8_t *op,
                                uint16_t *table)
{
    int64_t size = 256;
    while (size < n && size < SNAPPY_MAX_TABLE)
        size <<= 1;
    const uint32_t mask = (uint32_t)size - 1;
    memset(table, 0, (size_t)size * sizeof *table);
    int64_t ip = 0, next_emit = 0;
    if (n >= SNAPPY_MARGIN) {
        const int64_t ip_limit = n - SNAPPY_MARGIN;
        for (;;) {
            next_emit = ip++;
            uint32_t skip = 32;
            int64_t cand = -1;
            if (ip_limit - ip >= 16) {
                for (int i = 0; i < 16; ++i) {
                    uint32_t v = read32(in + ip + i);
                    uint32_t h = snappy_slot(v, mask);
                    int64_t c = table[h];
                    table[h] = (uint16_t)(ip + i);
                    if (read32(in + c) == v) {
                        ip += i;
                        cand = c;
                        break;
                    }
                }
                if (cand < 0) {
                    ip += 16;
                    skip += 16;
                }
            }
            while (cand < 0) {
                uint32_t v = read32(in + ip);
                uint32_t h = snappy_slot(v, mask);
                uint32_t step = skip >> 5;
                skip += step;
                if (ip + step > ip_limit) {
                    ip = next_emit;
                    goto remainder;
                }
                int64_t c = table[h];
                table[h] = (uint16_t)ip;
                if (read32(in + c) == v)
                    cand = c;
                else
                    ip += step;
            }
            op = snappy_literal(op, in + next_emit, ip - next_emit);
            for (;;) {
                int64_t len = 4 + common_len(in + ip + 4, in + cand + 4,
                                             in + n);
                op = snappy_copy(op, len, ip - cand);
                ip += len;
                if (ip >= ip_limit)
                    goto remainder;
                table[snappy_slot(read32(in + ip - 1), mask)] =
                    (uint16_t)(ip - 1);
                uint32_t v = read32(in + ip);
                uint32_t h = snappy_slot(v, mask);
                cand = table[h];
                table[h] = (uint16_t)ip;
                if (read32(in + cand) != v)
                    break;
            }
        }
    }
remainder:
    if (ip < n)
        op = snappy_literal(op, in + ip, n - ip);
    return op;
}

/* A snappy stream of src[0, n) into dst; its size, or 0 when cap is
 * under snappy's worst case for n bytes. */
int64_t snappy_compress(const uint8_t *src, int64_t n, uint8_t *dst,
                        int64_t cap, int clevel)
{
    (void)clevel;    /* c-blosc runs snappy at its level 1 */
    if (cap < 32 + n + n / 6)    /* snappy's worst case */
        return 0;
    uint8_t *op = dst;
    uint64_t v = (uint64_t)n;
    do {
        *op++ = (uint8_t)((v & 127) | (v >= 128 ? 128 : 0));
        v >>= 7;
    } while (v);
    uint16_t table[SNAPPY_MAX_TABLE];
    for (int64_t pos = 0; pos < n; pos += SNAPPY_BLOCK) {
        int64_t len = n - pos < SNAPPY_BLOCK ? n - pos : SNAPPY_BLOCK;
        op = snappy_fragment(src + pos, len, op, table);
    }
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
