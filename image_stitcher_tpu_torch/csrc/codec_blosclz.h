/* blosclz streams for blosc code 0, included by blosc.c.
 *
 * The format (c-blosc's FastLZ-style codec, as its decoder reads it):
 *   - a control byte c < 32 is a literal run: c + 1 bytes follow (the
 *     stream's first byte is always one, read with its top 3 bits
 *     masked off: the encoder sets bit 5 there as a marker);
 *   - otherwise bits 5-7 of c are a length code L and bits 0-4 the high
 *     bits H of a distance; L == 7 continues with bytes added to the
 *     length while they are 255; then a byte D: the match is L + 2 bytes
 *     (plus the continuation bytes) long, at distance (H << 8) + D + 1;
 *     H == 31 and D == 255 instead read a big-endian u16 F and the
 *     distance is F + 8192;
 *   - the stream ends after a literal run or after a match's last byte,
 *     but c-blosc's decoder copies a match only when a control byte
 *     follows it, so a stream never ends with a match.
 *
 * The encoder is c-blosc 1.x's (blosclz 2.x, FastLZ-derived, with its
 * entropy probe), byte for byte; io/blosclz_plain.py is its plain
 * version. n is the stream's length, cap the room c-blosc gives it,
 * hash(seq, log) = (seq * 2654435761 mod 2^32) >> (32 - log) of a
 * little-endian u32 seq.
 *   - Refusals (return 0: the frame stores the stream as it is): n < 16,
 *     cap < 66, the probe below, and the first write that would pass
 *     cap (a literal asks for 2 bytes of room, a match form for its own
 *     bytes), which can refuse a stream whose whole length would fit.
 *     A frame reaches cap < 66 and a refusal at its last literal only
 *     where earlier stored streams left its last one little room
 *     (tests/test_torch_blosclz_frames.py).
 *   - The entropy probe: a dry run over w = min(n / 4, 4096) bytes from
 *     n - n / 4, with a zeroed 4096-entry u16 table of offsets (hash log
 *     12) and matches of at least 3 bytes: it counts output bytes oc
 *     from 5 with 4 pending literals (a literal 1, and 1 more at every
 *     32nd of a run; a match -1 when no literal is pending, then 2 near
 *     or 4 far, (len - 7) / 255 + 1 more when len >= 7, and 1 for the
 *     next literal header; after a match its end is entered and the
 *     scan steps 2), while ip < w - 12, extending matches up to w - 1.
 *     ratio = ip / oc in double; the stream is refused when ratio <
 *     {2, 1.5, 1.2, 1.2, 1.2, 1.2, 1.15, 1.1, 1.0}[clevel - 1] (0 when
 *     w <= 12, so every stream under 52 bytes is refused).
 *   - shift = minimum length = 4 when the frame's blocks are split and
 *     ratio >= 4.0 (a probe ratio of exactly 4 takes 4), else 3.
 *   - The table: hash log 12 at clevel 1, 13 at 2, 14 from 3; u32
 *     positions, zeroed, so the first candidate is position 0.
 *   - The parse: the header byte 31 and src[0, 4) as pending literals,
 *     then while ip < n - 12: anchor = ip, ref = table[hash(seq at
 *     ip)], the table takes anchor; a literal src[anchor] unless
 *     anchor - ref is in [1, 73725) and the 4 bytes equal. A match then
 *     extends from anchor + 4 against ref + 4 to one past the first
 *     byte that differs, at most n - 1 (c-blosc's run scan for distance
 *     1 compares against the byte before and stops at the same place);
 *     ip = that end - shift, len = ip - anchor, distance = anchor - ref
 *     - 1; len < shift, or len <= 5 with distance >= 8191, is a literal
 *     after all (ip = anchor + 1).
 *   - Literal runs of at most 32 go behind a placeholder header 31; a
 *     match patches it to the run's length - 1, or drops it when no
 *     literal is pending. A near match (distance < 8191) is (len << 5)
 *     + (distance >> 8) and distance & 255; a far one takes distance -=
 *     8191 and writes (len << 5) + 31, 255, distance >> 8, distance &
 *     255; len >= 7 writes 7 in the length bits and len - 7 in 255s and
 *     a last byte before the distance bytes. After a match the table
 *     takes ip (hash of the u32 at ip), ip += 1, at clevel 9 also
 *     hash(that u32 >> 8) -> ip, then ip += 1 and a new placeholder.
 *   - The tail: src[ip, n) as literals, the last header patched (or
 *     dropped), then dst[0] |= 0x20.
 */

#define BLZ_MAX_COPY 32
#define BLZ_MAX_DISTANCE 8191
#define BLZ_MAX_FARDISTANCE (65535 + BLZ_MAX_DISTANCE - 1)
#define BLZ_PROBE_MAX 4096
#define BLZ_PROBE_LOG 12

static const double BLZ_RATIO_FLOOR[9] = {2.0, 1.5, 1.2, 1.2, 1.2, 1.2,
                                          1.15, 1.1, 1.0};

static uint32_t blz_hash(uint32_t seq, int log)
{
    return (seq * 2654435761u) >> (32 - log);
}

/* one past the first byte at or after ip that differs from its
 * counterpart at ref, at most bound */
static int64_t blz_extend(const uint8_t *src, int64_t ip, int64_t ref,
                          int64_t bound)
{
    while (ip + 8 <= bound) {
        uint64_t x, y;
        memcpy(&x, src + ip, 8);
        memcpy(&y, src + ref, 8);
        if (x != y)
            return ip + (__builtin_ctzll(x ^ y) >> 3) + 1;
        ip += 8;
        ref += 8;
    }
    for (; ip < bound; ++ip, ++ref)
        if (src[ip] != src[ref])
            return ip + 1;
    return bound;
}

/* c-blosc's entropy probe of src[0, n): the ratio its dry run over the
 * last quarter estimates */
static double blz_probe(const uint8_t *src, int64_t n)
{
    const uint8_t *base = src + n - n / 4;
    int64_t w = n / 4 < BLZ_PROBE_MAX ? n / 4 : BLZ_PROBE_MAX;
    uint16_t table[1 << BLZ_PROBE_LOG];
    int64_t ip = 0, oc = 5;
    int copy = 4;
    memset(table, 0, sizeof table);
    while (ip < w - 12) {
        int64_t anchor = ip, len = 0;
        uint32_t seq = read32(base + ip);
        uint32_t h = blz_hash(seq, BLZ_PROBE_LOG);
        int64_t ref = table[h], distance = anchor - ref;
        table[h] = (uint16_t)anchor;
        if (distance > 0 && distance < BLZ_MAX_FARDISTANCE
                && read32(base + ref) == seq) {
            ip = blz_extend(base, anchor + 4, ref + 4, w - 1) - 3;
            len = ip - anchor;
        }
        if (len < 3) {
            ++oc;
            ip = anchor + 1;
            if (++copy == BLZ_MAX_COPY) {
                copy = 0;
                ++oc;
            }
            continue;
        }
        if (!copy)
            --oc;
        copy = 0;
        if (len >= 7)
            oc += (len - 7) / 255 + 1;
        oc += distance - 1 < BLZ_MAX_DISTANCE ? 2 : 4;
        table[blz_hash(read32(base + ip), BLZ_PROBE_LOG)] = (uint16_t)ip;
        ip += 2;
        ++oc;
    }
    return (double)ip / (double)oc;
}

/* A blosclz stream of src[0, n) into dst, for a frame whose blocks are
 * split (or not); its size, or 0 where c-blosc declines (clevel is held
 * to 1-9). */
int64_t blosclz_compress(const uint8_t *src, int64_t n, uint8_t *dst,
                         int64_t cap, int clevel, int split)
{
    if (clevel < 1)
        clevel = 1;
    if (clevel > 9)
        clevel = 9;
    if (n < 16 || cap < 66)
        return 0;
    double ratio = blz_probe(src, n);
    if (ratio < BLZ_RATIO_FLOOR[clevel - 1])
        return 0;
    const int64_t shift = split && ratio >= 4.0 ? 4 : 3;
    const int log = clevel == 1 ? 12 : clevel == 2 ? 13 : 14;
    uint32_t table[1 << 14];
    memset(table, 0, sizeof(uint32_t) << log);
    uint8_t *op = dst;
    const uint8_t *oend = dst + cap;
    const int64_t bound = n - 1;
    int64_t ip = 4;
    int copy = 4;
    *op++ = BLZ_MAX_COPY - 1;
    memcpy(op, src, 4);
    op += 4;
    while (ip < n - 12) {
        int64_t anchor = ip, len = -1;
        uint32_t seq = read32(src + ip);
        uint32_t h = blz_hash(seq, log);
        int64_t ref = table[h], distance = anchor - ref;
        table[h] = (uint32_t)anchor;
        if (distance > 0 && distance < BLZ_MAX_FARDISTANCE
                && read32(src + ref) == seq) {
            --distance;
            ip = blz_extend(src, anchor + 4, ref + 4, bound) - shift;
            len = ip - anchor;
            if (len <= 5 && distance >= BLZ_MAX_DISTANCE)
                len = -1;
        }
        if (len < shift) {
            if (oend - op < 2)
                return 0;
            *op++ = src[anchor];
            ip = anchor + 1;
            if (++copy == BLZ_MAX_COPY) {
                copy = 0;
                *op++ = BLZ_MAX_COPY - 1;
            }
            continue;
        }
        if (copy)
            op[-copy - 1] = (uint8_t)(copy - 1);
        else
            --op;
        copy = 0;
        const int far = distance >= BLZ_MAX_DISTANCE;
        if (far)
            distance -= BLZ_MAX_DISTANCE;
        const int hi = far ? 31 : (int)(distance >> 8);
        const int64_t tail = far ? 3 : 1;
        if (len < 7) {
            if (oend - op < 1 + tail)
                return 0;
            *op++ = (uint8_t)((len << 5) + hi);
        } else {
            if (oend - op < 1)
                return 0;
            *op++ = (uint8_t)((7 << 5) + hi);
            for (len -= 7; len >= 255; len -= 255) {
                if (oend - op < 1)
                    return 0;
                *op++ = 255;
            }
            if (oend - op < 1 + tail)
                return 0;
            *op++ = (uint8_t)len;
        }
        if (far) {
            *op++ = 255;
            *op++ = (uint8_t)(distance >> 8);
        }
        *op++ = (uint8_t)(distance & 255);
        seq = read32(src + ip);
        table[blz_hash(seq, log)] = (uint32_t)ip;
        ++ip;
        if (clevel == 9)
            table[blz_hash(seq >> 8, log)] = (uint32_t)ip;
        ++ip;
        if (oend - op < 1)
            return 0;
        *op++ = BLZ_MAX_COPY - 1;
    }
    for (; ip < n; ++ip) {
        if (oend - op < 2)
            return 0;
        *op++ = src[ip];
        if (++copy == BLZ_MAX_COPY) {
            copy = 0;
            *op++ = BLZ_MAX_COPY - 1;
        }
    }
    if (copy)
        op[-copy - 1] = (uint8_t)(copy - 1);
    else
        --op;
    dst[0] |= 0x20;
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
