"""The plain version of blosc's 'lz4hc' streams: liblz4 1.10's
``LZ4_compress_HC`` with a bounded output, as c-blosc calls it (the clevel
passed through, the output bounded by the block's length), so a stream is
byte-equal to tensorstore's c-blosc. ``csrc/codec_lz4.h`` is the C version
and writes the same bytes.

liblz4's rules, in positions of the stream (its indices are these plus
65536, so a table entry of 0 lies out of reach):
- level ``clevel`` (9 for clevel < 1): 1 and 2 are the two-table matcher
  ``LZ4MID_compress``, 3..9 the hash chain ``LZ4HC_compress_hashChain``
  with at most ``2 ** (level - 1)`` candidates a search;
- a stream under 13 bytes is all literals; a match may start at p <= n - 12
  and extends up to n - 5;
- the sequence encoder gives up (the stream is stored) when the literals
  would leave fewer than 8 + litlen // 255 bytes after the token, the match
  fewer than 6 + (mlen - 4) // 255, or the last literals fewer than
  1 + (run + 240) // 255 after them.

The hash chain:
- the 4 bytes at p, a little-endian u32, hash to ``(u32 * 2654435761 mod
  2**32) >> 17``; entering p sets ``chain[p mod 65536]`` to the distance
  to the last position with that hash (65535 at most, and 65535 when there
  is none) and makes p that hash's last position; every search first
  enters each position below its start not yet entered;
- a search from p with a window [low, p] (``LZ4HC_InsertAndGetWiderMatch``)
  walks the chain from the last position of p's hash while the candidate
  is within 65535 bytes and attempts remain: a candidate whose 2 bytes at
  ``longest - 1`` past the window's start agree, and whose 4 bytes equal
  p's, gives a match counted forwards from p and backwards down to low;
  it replaces the best when longer. At level 9, when the next link is 1
  and p starts a run of one byte, the walk jumps along the run
  (liblz4's repeated-pattern shortcut);
- the main loop (``_Search2``, ``_Search3``) looks for a wider match
  ending past the current one, starting at its end - 2 and, for a third,
  at the second's end - 3, trims overlaps (to at most 18 bytes ahead) and
  emits one, two or three matches as liblz4 does.

The mid matcher: two 16384-entry tables of the last position of a hash,
one of the 8 bytes at p (``((u64 << 8) * 58295818150454627 mod 2**64) >>
50``) and one of the 4 bytes (``(u32 * 2654435761 mod 2**32) >> 18``);
the long table is tried first, then the short one, whose hit is replaced
by a longer long match at p + 1; a miss steps 1 + (p - anchor) // 512;
a match is extended backwards, and the tables take positions near its
start and end as liblz4 enters them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

_BASE = 65536
_MAXD = 65535
_MASK32 = 0xFFFFFFFF
_MASK64 = (1 << 64) - 1


class _Overflow(Exception):
    pass


def _count(a: bytes, i: int, j: int, limit: int) -> int:
    """How many bytes a[i:] and a[j:] agree on, i bounded by limit."""
    n = 0
    step = 16
    while i + n < limit:
        m = min(step, limit - i - n)
        if a[i + n:i + n + m] != a[j + n:j + n + m]:
            x = np.frombuffer(a, np.uint8, m, i + n)
            y = np.frombuffer(a, np.uint8, m, j + n)
            return n + int(np.flatnonzero(x != y)[0])
        n += m
        step = min(step * 4, 1 << 16)
    return n


def _put_length(out: bytearray, length: int) -> None:
    length -= 15
    while length >= 255:
        out.append(255)
        length -= 255
    out.append(length)


def _sequence(out: bytearray, src: bytes, anchor: int, ip: int, mlen: int,
              off: int, cap: int) -> int:
    """``LZ4HC_encodeSequence``: literals src[anchor:ip], then a match of
    mlen bytes off back; the new anchor."""
    lit = ip - anchor
    if len(out) + 1 + lit // 255 + lit + 8 > cap:
        raise _Overflow
    token = len(out)
    out.append(min(lit, 15) << 4)
    if lit >= 15:
        _put_length(out, lit)
    out += src[anchor:ip]
    out += bytes((off & 0xFF, off >> 8))
    m = mlen - 4
    if len(out) + m // 255 + 6 > cap:
        raise _Overflow
    out[token] |= min(m, 15)
    if m >= 15:
        _put_length(out, m)
    return ip + mlen


def _last_literals(out: bytearray, src: bytes, anchor: int, cap: int):
    run = len(src) - anchor
    if len(out) + 1 + (run + 240) // 255 + run > cap:
        raise _Overflow
    out.append(min(run, 15) << 4)
    if run >= 15:
        _put_length(out, run)
    out += src[anchor:]


def _words(src: bytes) -> list:
    """The little-endian u32 at every position that has one."""
    w = np.frombuffer(src, np.uint8).astype(np.uint32)
    return (w[:-3] | (w[1:-2] << 8) | (w[2:-1] << 16)
            | (w[3:] << 24)).tolist()


class _Chain:
    """liblz4's hash-chain state over one stream."""

    def __init__(self, src: bytes, attempts: int):
        self.src = src
        self.seq = _words(src)
        seq = np.asarray(self.seq, np.uint64)
        self.hashes = (((seq * 2654435761) & _MASK32) >> 17).tolist()
        self.head = [0] * (1 << 15)       # indices (position + 65536)
        self.chain = [0] * 65536
        self.next = 0
        self.attempts = attempts
        self.pattern = attempts > 128

    def insert(self, ip: int) -> None:
        head, chain, hashes = self.head, self.chain, self.hashes
        for p in range(self.next, ip):
            h = hashes[p]
            idx = p + _BASE
            chain[idx & 0xFFFF] = min(idx - head[h], _MAXD)
            head[h] = idx
        self.next = max(self.next, ip)

    def _run(self, i: int, end: int, byte: int) -> int:
        """How many bytes from i (before end) equal byte."""
        n = 0
        src = self.src
        while i + n < end and src[i + n] == byte:
            n += 1
        return n

    def _run_back(self, i: int, low: int, byte: int) -> int:
        n = 0
        src = self.src
        while i - n > low and src[i - n - 1] == byte:
            n += 1
        return n

    def wider(self, ip: int, low: int, high: int, longest: int):
        """``LZ4HC_InsertAndGetWiderMatch``: (length, offset, back) of the
        best match of more than ``longest`` bytes around ip, or
        (longest, 0, 0)."""
        src, seq, chain = self.src, self.seq, self.chain
        self.insert(ip)
        ip_idx = ip + _BASE
        lowest = _BASE if ip_idx < 2 * _BASE else ip_idx - _MAXD
        look_back = ip - low
        pattern = seq[ip]
        offset = back_best = 0
        nb = self.attempts
        repeat = None
        src_len = 0
        m_idx = self.head[self.hashes[ip]]
        while m_idx >= lowest and nb > 0:
            nb -= 1
            mp = m_idx - _BASE
            k = longest - 1
            if (src[low + k:low + k + 2] == src[mp - look_back + k:
                                                 mp - look_back + k + 2]
                    and seq[mp] == pattern):
                back = 0
                if look_back:
                    lim = max(low - ip, -mp)
                    while back > lim and src[ip + back - 1] == \
                            src[mp + back - 1]:
                        back -= 1
                mlen = 4 + _count(src, ip + 4, mp + 4, high) - back
                if mlen > longest:
                    longest, offset, back_best = mlen, ip_idx - m_idx, back
            dist = chain[m_idx & 0xFFFF]
            if self.pattern and dist == 1:
                cand = m_idx - 1
                if repeat is None:
                    repeat = (pattern & 0xFF) * 0x01010101 == pattern
                    if repeat:
                        src_len = self._run(ip + 4, high, pattern & 0xFF) + 4
                if repeat and cand >= lowest:
                    cp = cand - _BASE
                    if seq[cp] == pattern:
                        byte = pattern & 0xFF
                        fwd = self._run(cp + 4, high, byte) + 4
                        back_len = self._run_back(cp, 0, byte)
                        back_len = cand - max(cand - back_len, lowest)
                        seg = back_len + fwd
                        if seg >= src_len and fwd <= src_len:
                            m_idx = cand + fwd - src_len
                        else:
                            m_idx = cand - back_len
                            if look_back == 0:
                                max_ml = min(seg, src_len)
                                if longest < max_ml:
                                    if ip_idx - m_idx > _MAXD:
                                        break
                                    longest = max_ml
                                    offset = ip_idx - m_idx
                                d = chain[m_idx & 0xFFFF]
                                if d > m_idx:
                                    break
                                m_idx -= d
                        continue
            m_idx -= dist
        return longest, offset, back_best


def _hash_chain(src: bytes, attempts: int, cap: int) -> bytes:
    """``LZ4HC_compress_hashChain``."""
    n = len(src)
    out = bytearray()
    ip = anchor = 0
    if n >= 13:
        ch = _Chain(src, attempts)
        mflimit, matchlimit = n - 12, n - 5
        while ip <= mflimit:
            ml1, off1, _ = ch.wider(ip, ip, matchlimit, 3)
            if ml1 < 4:
                ip += 1
                continue
            start0, ml0, off0 = ip, ml1, off1
            state = 2
            while True:
                if state == 2:
                    if ip + ml1 <= mflimit:
                        s2 = ip + ml1 - 2
                        ml2, off2, back = ch.wider(s2, ip, matchlimit, ml1)
                        s2 += back
                    else:
                        ml2 = 0
                    if ml2 <= ml1:
                        anchor = ip = _sequence(out, src, anchor, ip, ml1,
                                                off1, cap)
                        break
                    if start0 < ip and s2 < ip + ml0:
                        ip, ml1, off1 = start0, ml0, off0
                    if s2 - ip < 3:
                        ip, ml1, off1 = s2, ml2, off2
                        continue
                    state = 3
                # _Search3
                if s2 - ip < 18:
                    new_ml = min(ml1, 18)
                    if ip + new_ml > s2 + ml2 - 4:
                        new_ml = s2 - ip + ml2 - 4
                    corr = new_ml - (s2 - ip)
                    if corr > 0:
                        s2 += corr
                        ml2 -= corr
                if s2 + ml2 <= mflimit:
                    s3 = s2 + ml2 - 3
                    ml3, off3, back = ch.wider(s3, s2, matchlimit, ml2)
                    s3 += back
                else:
                    ml3 = 0
                if ml3 <= ml2:
                    if s2 < ip + ml1:
                        ml1 = s2 - ip
                    anchor = ip = _sequence(out, src, anchor, ip, ml1, off1,
                                            cap)
                    ip = s2
                    anchor = ip = _sequence(out, src, anchor, ip, ml2, off2,
                                            cap)
                    break
                if s3 < ip + ml1 + 3:
                    if s3 >= ip + ml1:
                        if s2 < ip + ml1:
                            corr = ip + ml1 - s2
                            s2 += corr
                            ml2 -= corr
                            if ml2 < 4:
                                s2, ml2, off2 = s3, ml3, off3
                        anchor = ip = _sequence(out, src, anchor, ip, ml1,
                                                off1, cap)
                        ip, ml1, off1 = s3, ml3, off3
                        start0, ml0, off0 = s2, ml2, off2
                        state = 2
                        continue
                    s2, ml2, off2 = s3, ml3, off3
                    continue
                if s2 < ip + ml1:
                    if s2 - ip < 18:
                        ml1 = min(ml1, 18)
                        if ip + ml1 > s2 + ml2 - 4:
                            ml1 = s2 - ip + ml2 - 4
                        corr = ml1 - (s2 - ip)
                        if corr > 0:
                            s2 += corr
                            ml2 -= corr
                    else:
                        ml1 = s2 - ip
                anchor = ip = _sequence(out, src, anchor, ip, ml1, off1, cap)
                ip, ml1, off1 = s2, ml2, off2
                s2, ml2, off2 = s3, ml3, off3
    _last_literals(out, src, anchor, cap)
    return bytes(out)


def _mid(src: bytes, cap: int) -> bytes:
    """``LZ4MID_compress``."""
    n = len(src)
    out = bytearray()
    ip = anchor = 0
    if n >= 13:
        a = np.frombuffer(src, np.uint8)
        seq = _words(src)
        h4 = (((np.asarray(seq, np.uint64) * 2654435761) & _MASK32)
              >> 18).tolist()
        w = np.zeros(max(n - 7, 0), np.uint64)
        for k in range(7):
            w |= a[k:n - 7 + k].astype(np.uint64) << np.uint64(8 * k + 8)
        h8 = ((w * np.uint64(58295818150454627)) >> np.uint64(50)).tolist()
        t4 = [0] * (1 << 14)
        t8 = [0] * (1 << 14)
        mflimit, matchlimit = n - 12, n - 5
        ilimit_idx = n - 8 + _BASE
        while ip <= mflimit:
            ip_idx = ip + _BASE
            found = False
            h = h8[ip]
            pos = t8[h]
            t8[h] = ip_idx
            if ip_idx - pos <= _MAXD:
                mlen = _count(src, ip, pos - _BASE, matchlimit)
                if mlen >= 4:
                    dist = ip_idx - pos
                    found = True
            if not found:
                h = h4[ip]
                pos = t4[h]
                t4[h] = ip_idx
                if ip_idx - pos <= _MAXD:
                    mlen = _count(src, ip, pos - _BASE, matchlimit)
                    if mlen >= 4:
                        found = True
                        dist = ip_idx - pos
                        hh = h8[ip + 1]
                        pos8 = t8[hh]
                        d2 = (ip_idx + 1 - pos8) & _MASK32
                        if d2 <= _MAXD and ip < mflimit:
                            ml2 = _count(src, ip + 1, pos8 - _BASE,
                                         matchlimit)
                            if ml2 > mlen:
                                t8[hh] = ip_idx + 1
                                ip += 1
                                mlen, dist = ml2, d2
            if not found:
                ip += 1 + ((ip - anchor) >> 9)
                continue
            while ip > anchor and ip > dist and src[ip - 1] == \
                    src[ip - dist - 1]:
                ip -= 1
                mlen += 1
            t8[h8[ip + 1]] = ip_idx + 1
            t8[h8[ip + 2]] = ip_idx + 2
            t4[h4[ip + 1]] = ip_idx + 1
            anchor = ip = _sequence(out, src, anchor, ip, mlen, dist, cap)
            end = ip + _BASE
            if end - 2 < ilimit_idx:
                if ip > 5:
                    t8[h8[ip - 5]] = end - 5
                t8[h8[ip - 3]] = end - 3
                t8[h8[ip - 2]] = end - 2
                t4[h4[ip - 2]] = end - 2
                t4[h4[ip - 1]] = end - 1
    _last_literals(out, src, anchor, cap)
    return bytes(out)


def compress(src: bytes, clevel: int = 5, cap: Optional[int] = None) -> bytes:
    """One 'lz4hc' stream of ``src`` with the output bounded by ``cap``
    bytes (none by default); ``b''`` where liblz4 gives up on the bound."""
    cap = 2 * len(src) + 16 if cap is None else cap
    level = 9 if clevel < 1 else min(int(clevel), 9)
    try:
        if level <= 2:
            return _mid(bytes(src), cap)
        return _hash_chain(bytes(src), 1 << (level - 1), cap)
    except _Overflow:
        return b''
