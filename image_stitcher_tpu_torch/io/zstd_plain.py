"""The plain version of ``csrc/codec_zstd.h``: Zstandard frames (RFC 8878;
blosc compressor code 4) in Python.

:func:`decompress` reads any valid frame, as the C decoder does:
concatenated and skippable frames, a frame header with or without a
content size and with a window descriptor, raw, RLE and compressed
blocks, raw, RLE, Huffman and treeless literals in 1 or 4 streams with
weights FSE-coded or direct, sequences in predefined, RLE, FSE and
repeat modes, and repeat offsets carried across the blocks of a frame;
a content checksum is skipped, a dictionary refused.

:func:`compress` writes byte for byte the C encoder's frames. Its rules
(the format leaves them free):
- one single-segment frame: the magic, a descriptor with the content
  size in 1 (size < 256), 2 (size - 256, size < 65792) or 4 bytes, no
  checksum; blocks of 128 KiB, the last one shorter;
- a greedy matcher over the whole frame: the 4 bytes at p hash to
  ``(seq * 2654435761 mod 2**32) >> (32 - hlog)``, hlog =
  clamp(floor(log2(n - 1)), 10, 17); a table holds the last position with
  each hash and, for a search depth over 1, a chain the previous
  position with the same hash; before the search at p every position
  below p is entered; depth = 1, 1, 2, 4, ... 256 for clevel 0..9;
- at p (while p + 4 <= the block's end), after at least one literal, a
  match at the first repeat offset of 4 bytes or more is taken as it is;
  otherwise up to ``depth`` chain candidates are tried and the longest
  match kept (the newest among equals); matches end at the block's end;
- a match of 4 bytes or more becomes a sequence; after a miss p advances
  by 1 + (p - anchor) // 256;
- the offset value is a repeat code when the offset equals a repeat
  offset (RFC 8878 3.1.2.5), else offset + 3;
- a block whose bytes are all equal (2 or more) is an RLE block; else
  compressed when that is smaller than the block, raw otherwise, the
  repeat offsets of a block not stored compressed rolled back;
- literals: raw when there are under 64, RLE when all are the same byte,
  else Huffman (lengths as ``huf_lengths`` builds them, 1 stream under
  256 literals, else 4) when that is smaller than raw; the tree
  description FSE-coded (table log 6) when its weights take two values
  or more and that is shorter than the direct form, else direct (at most
  128 weights), else the literals are raw;
- each sequence field (literal length, offset, match length codes): RLE
  for one symbol, the predefined distribution under 64 sequences, else an
  FSE table of its own (``fse_normalize`` to the log ``fse_table_log``
  gives); every FSE state starts at its symbol's first state.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .blosc import CodecError, _common, _hashes, copy_match_plain

MAGIC = 0xFD2FB528
BLOCK_MAX = 128 * 1024
HUF_MAX_BITS = 11
HUF_WEIGHT_LOG = 6
LL_LOG, ML_LOG, OF_LOG = 9, 9, 8
MAX_LL, MAX_ML, MAX_OF = 35, 52, 31

LL_BASE = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 18, 20,
           22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192,
           16384, 32768, 65536)
LL_BITS = (0,) * 16 + (1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12,
                       13, 14, 15, 16)
ML_BASE = tuple(range(3, 35)) + (35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99,
                                 131, 259, 515, 1027, 2051, 4099, 8195,
                                 16387, 32771, 65539)
ML_BITS = (0,) * 32 + (1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12,
                       13, 14, 15, 16)
LL_DEFAULT = (4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2,
              2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1)
ML_DEFAULT = (1, 4, 3, 2, 2, 2, 2, 2, 2) + (1,) * 37 + (-1,) * 7
OF_DEFAULT = (1, 1, 1, 1, 1, 1, 2, 2, 2) + (1,) * 15 + (-1,) * 5
LL_DEFAULT_LOG, ML_DEFAULT_LOG, OF_DEFAULT_LOG = 6, 6, 5
_DEPTH = (1, 1, 2, 4, 8, 16, 32, 64, 128, 256)


def _corrupt(what: str = "corrupt zstd frame") -> CodecError:
    return CodecError(what)


# ----------------------------------------------------------------- bit I/O

class _BitIn:
    """A backward bit stream: read from its last bit towards its first;
    bits past the start read as zeros (``pos`` goes negative)."""

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            raise _corrupt()
        self.data = data
        self.pos = 8 * (len(data) - 1) + data[-1].bit_length() - 1

    def peek(self, nb: int) -> int:
        if nb == 0:
            return 0
        p = self.pos - nb
        if p >= 0:
            b = p >> 3
            v = int.from_bytes(self.data[b:b + 8], 'little')
            return (v >> (p & 7)) & ((1 << nb) - 1)
        if self.pos <= 0:
            return 0
        v = int.from_bytes(self.data[:8], 'little')
        return (v & ((1 << self.pos) - 1)) << -p

    def read(self, nb: int) -> int:
        v = self.peek(nb)
        self.pos -= nb
        return v


class _BitOut:
    """A forward bit stream, LSB first."""

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def add(self, v: int, nb: int) -> None:
        if nb == 0:
            return
        self.acc |= (v & ((1 << nb) - 1)) << self.n
        self.n += nb
        while self.n >= 8:
            self.out.append(self.acc & 255)
            self.acc >>= 8
            self.n -= 8

    def flush(self) -> bytes:
        if self.n > 0:
            self.out.append(self.acc & 255)
        self.acc = self.n = 0
        return bytes(self.out)


# --------------------------------------------------------------------- FSE

def _spread(norm, log: int) -> List[int]:
    """The symbol of each cell of a 2^log table, as FSE spreads them."""
    size = 1 << log
    at = [0] * size
    high = size - 1
    for s, c in enumerate(norm):
        if c == -1:
            at[high] = s
            high -= 1
    pos, step, mask = 0, (size >> 1) + (size >> 3) + 3, size - 1
    for s, c in enumerate(norm):
        for _ in range(max(c, 0)):
            at[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise _corrupt()
    return at


def _dtable(norm, log: int):
    """(log, [(symbol, nbits, baseline)] per cell)."""
    at = _spread(norm, log)
    nxt = [1 if c == -1 else c for c in norm]
    size = 1 << log
    cells = []
    for s in at:
        x = nxt[s]
        nxt[s] += 1
        nb = log - (x.bit_length() - 1)
        cells.append((s, nb, (x << nb) - size))
    return log, cells


def _read_ncount(data: bytes, maxsym: int, maxlog: int):
    """(normalized counts, log, bytes read) of an FSE table
    description."""
    n = len(data)
    bit = 0

    def peek(nb):
        b = bit >> 3
        return (int.from_bytes(data[b:b + 8], 'little') >> (bit & 7)) \
            & ((1 << nb) - 1)

    if n < 1:
        raise _corrupt()
    norm = [0] * (maxsym + 1)
    log = peek(4) + 5
    bit = 4
    if log > maxlog:
        raise _corrupt()
    remaining, threshold, nbits = (1 << log) + 1, 1 << log, log + 1
    s, prev0 = 0, False
    while remaining > 1 and s <= maxsym:
        if prev0:
            while True:
                if bit >> 3 >= n:
                    raise _corrupt()
                r = peek(2)
                bit += 2
                s += r
                if r != 3:
                    break
            if s > maxsym:
                raise _corrupt()
        if bit >> 3 >= n:
            raise _corrupt()
        mx = (2 * threshold - 1) - remaining
        count = peek(nbits)
        if (count & (threshold - 1)) < mx:
            count &= threshold - 1
            bit += nbits - 1
        else:
            if count >= threshold:
                count -= mx
            bit += nbits
        count -= 1
        remaining -= abs(count)
        norm[s] = count
        s += 1
        prev0 = count == 0
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1 or (bit + 7) >> 3 > n:
        raise _corrupt()
    return norm, log, (bit + 7) >> 3


def _trim(norm):
    top = len(norm) - 1
    while top > 0 and norm[top] == 0:
        top -= 1
    return norm[:top + 1]


# ----------------------------------------------------------------- Huffman

def _read_huffman(data: bytes, pos: int, end: int):
    """(maxbits, [symbol per index], [nbits per index], bytes read) of a
    Huffman tree description at data[pos:end]."""
    if pos >= end:
        raise _corrupt()
    hb = data[pos]
    if hb >= 128:
        nw = hb - 127
        used = 1 + (nw + 1) // 2
        if pos + used > end:
            raise _corrupt()
        w = [(data[pos + 1 + i // 2] & 15) if i & 1
             else data[pos + 1 + i // 2] >> 4 for i in range(nw)]
    else:
        used = 1 + hb
        if pos + used > end:
            raise _corrupt()
        blob = data[pos + 1:pos + 1 + hb]
        norm, log, hsize = _read_ncount(blob, 15, HUF_WEIGHT_LOG)
        _, cells = _dtable(_trim(norm), log)
        b = _BitIn(blob[hsize:])
        s1, s2 = b.read(log), b.read(log)
        w = []
        while True:
            if len(w) > 253:
                raise _corrupt()
            sym, nb, base = cells[s1]
            w.append(sym)
            s1 = base + b.read(nb)
            if b.pos < 0:
                w.append(cells[s2][0])
                break
            sym, nb, base = cells[s2]
            w.append(sym)
            s2 = base + b.read(nb)
            if b.pos < 0:
                w.append(cells[s1][0])
                break
    if any(x > HUF_MAX_BITS for x in w):
        raise _corrupt()
    total = sum(1 << (x - 1) for x in w if x)
    if total == 0 or len(w) > 255:
        raise _corrupt()
    maxbits = total.bit_length()
    rest = (1 << maxbits) - total
    if maxbits > HUF_MAX_BITS or rest & (rest - 1):
        raise _corrupt()
    w.append(rest.bit_length())
    count = [0] * (HUF_MAX_BITS + 2)
    for x in w:
        count[x] += 1
    start = [0] * (HUF_MAX_BITS + 2)
    nxt = 0
    for k in range(1, maxbits + 1):
        start[k] = nxt
        nxt += count[k] << (k - 1)
    symbols = [0] * (1 << maxbits)
    nbits = [0] * (1 << maxbits)
    for s, x in enumerate(w):
        if not x:
            continue
        length = 1 << (x - 1)
        for u in range(start[x], start[x] + length):
            symbols[u] = s
            nbits[u] = maxbits + 1 - x
        start[x] += length
    return maxbits, symbols, nbits, used


def _huf_stream(table, data: bytes, count: int) -> bytes:
    maxbits, symbols, nbits, _ = table
    b = _BitIn(data)
    out = bytearray(count)
    for i in range(count):
        v = b.peek(maxbits)
        out[i] = symbols[v]
        b.pos -= nbits[v]
        if b.pos < 0:
            raise _corrupt()
    if b.pos != 0:
        raise _corrupt()
    return bytes(out)


# ----------------------------------------------------------------- decoder

class _State:
    def __init__(self):
        self.rep = [1, 4, 8]
        self.huf = None
        self.tables = {}


def _literals(st: _State, data: bytes, pos: int, end: int):
    """(literals, position after the section)."""
    if pos >= end:
        raise _corrupt()
    b0 = data[pos]
    kind, sf = b0 & 3, (b0 >> 2) & 3
    if kind < 2:
        if sf in (0, 2):
            regen, hs = b0 >> 3, 1
        elif sf == 1:
            if end - pos < 2:
                raise _corrupt()
            regen, hs = (b0 >> 4) + (data[pos + 1] << 4), 2
        else:
            if end - pos < 3:
                raise _corrupt()
            regen = (b0 >> 4) + (data[pos + 1] << 4) + (data[pos + 2] << 12)
            hs = 3
        if regen > BLOCK_MAX:
            raise _corrupt()
        if kind == 0:
            if pos + hs + regen > end:
                raise _corrupt()
            return data[pos + hs:pos + hs + regen], pos + hs + regen
        if pos + hs + 1 > end:
            raise _corrupt()
        return bytes([data[pos + hs]]) * regen, pos + hs + 1
    hs = 3 if sf < 2 else 4 if sf == 2 else 5
    bits = 10 if sf < 2 else 14 if sf == 2 else 18
    if end - pos < hs:
        raise _corrupt()
    h = int.from_bytes(data[pos:pos + hs], 'little')
    regen = (h >> 4) & ((1 << bits) - 1)
    csize = (h >> (4 + bits)) & ((1 << bits) - 1)
    if regen > BLOCK_MAX or pos + hs + csize > end:
        raise _corrupt()
    p, stop = pos + hs, pos + hs + csize
    if kind == 2:
        st.huf = _read_huffman(data, p, stop)
        p += st.huf[3]
    elif st.huf is None:
        raise _corrupt()
    if sf == 0:
        lit = _huf_stream(st.huf, data[p:stop], regen)
    else:
        if stop - p < 6:
            raise _corrupt()
        sizes = [int.from_bytes(data[p + 2 * k:p + 2 * k + 2], 'little')
                 for k in range(3)]
        sizes.append(stop - p - 6 - sum(sizes))
        seg = (regen + 3) // 4
        if sizes[3] < 0 or 3 * seg > regen:
            raise _corrupt()
        p += 6
        parts = []
        for k in range(4):
            cnt = seg if k < 3 else regen - 3 * seg
            parts.append(_huf_stream(st.huf, data[p:p + sizes[k]], cnt))
            p += sizes[k]
        lit = b''.join(parts)
    return lit, stop


_FIELDS = (('ll', LL_DEFAULT, LL_DEFAULT_LOG, MAX_LL, LL_LOG),
           ('of', OF_DEFAULT, OF_DEFAULT_LOG, MAX_OF, OF_LOG),
           ('ml', ML_DEFAULT, ML_DEFAULT_LOG, MAX_ML, ML_LOG))


def _seq_table(st: _State, field, mode: int, data: bytes, pos: int,
               end: int) -> int:
    name, default, deflog, maxsym, maxlog = field
    if mode == 0:
        st.tables[name] = _dtable(default, deflog)
        return pos
    if mode == 1:
        if pos >= end or data[pos] > maxsym:
            raise _corrupt()
        st.tables[name] = (0, [(data[pos], 0, 0)])
        return pos + 1
    if mode == 3:
        if name not in st.tables:
            raise _corrupt()
        return pos
    norm, log, used = _read_ncount(data[pos:end], maxsym, maxlog)
    st.tables[name] = _dtable(_trim(norm), log)
    return pos + used


def _block(st: _State, data: bytes, pos: int, end: int, out: bytearray,
           base: int) -> None:
    start = len(out)
    lit, pos = _literals(st, data, pos, end)
    if pos >= end:
        raise _corrupt()
    nseq = data[pos]
    pos += 1
    if nseq >= 128:
        if nseq == 255:
            if end - pos < 2:
                raise _corrupt()
            nseq = data[pos] + (data[pos + 1] << 8) + 0x7F00
            pos += 2
        else:
            if end - pos < 1:
                raise _corrupt()
            nseq = ((nseq - 128) << 8) + data[pos]
            pos += 1
    lp = 0
    if nseq:
        if pos >= end:
            raise _corrupt()
        modes = data[pos]
        pos += 1
        if modes & 3:
            raise _corrupt()
        for field, shift in zip(_FIELDS, (6, 4, 2)):
            pos = _seq_table(st, field, (modes >> shift) & 3, data, pos, end)
        b = _BitIn(data[pos:end])
        (lll, llc), (ofl, ofc), (mll, mlc) = (st.tables[k]
                                              for k in ('ll', 'of', 'ml'))
        sll, sof, sml = b.read(lll), b.read(ofl), b.read(mll)
        rep = st.rep
        for i in range(nseq):
            llcode, ofcode, mlcode = llc[sll][0], ofc[sof][0], mlc[sml][0]
            if llcode > MAX_LL or mlcode > MAX_ML or ofcode > MAX_OF:
                raise _corrupt()
            ofv = (1 << ofcode) + b.read(ofcode)
            ml = ML_BASE[mlcode] + b.read(ML_BITS[mlcode])
            ll = LL_BASE[llcode] + b.read(LL_BITS[llcode])
            if ofv > 3:
                off = ofv - 3
                rep[2], rep[1], rep[0] = rep[1], rep[0], off
            else:
                idx = ofv - 1 + (ll == 0)
                if idx == 0:
                    off = rep[0]
                else:
                    off = rep[0] - 1 if idx == 3 else rep[idx]
                    if idx != 1:
                        rep[2] = rep[1]
                    rep[1] = rep[0]
                    rep[0] = off
            if lp + ll > len(lit):
                raise _corrupt()
            out += lit[lp:lp + ll]
            lp += ll
            if off == 0 or off > len(out) - base:
                raise _corrupt()
            copy_match_plain(out, off, ml)
            if i + 1 < nseq:
                _, nb, bs = llc[sll]
                sll = bs + b.read(nb)
                _, nb, bs = mlc[sml]
                sml = bs + b.read(nb)
                _, nb, bs = ofc[sof]
                sof = bs + b.read(nb)
            if b.pos < 0:
                raise _corrupt()
        if b.pos != 0:
            raise _corrupt()
    elif pos != end:
        raise _corrupt()
    out += lit[lp:]
    if len(out) - start > BLOCK_MAX:
        raise _corrupt()


def decompress(data: bytes, nbytes: Optional[int] = None) -> bytes:
    """Decode the zstd frames (skipping the skippable frames) of ``data``;
    with ``nbytes`` they must hold exactly that many bytes."""
    data = bytes(data)
    out = bytearray()
    pos, end = 0, len(data)
    if end < 4:
        raise _corrupt()
    while pos < end:
        if end - pos < 4:
            raise _corrupt()
        magic = int.from_bytes(data[pos:pos + 4], 'little')
        pos += 4
        if magic & 0xFFFFFFF0 == 0x184D2A50:
            if end - pos < 4:
                raise _corrupt()
            size = int.from_bytes(data[pos:pos + 4], 'little')
            if size > end - pos - 4:
                raise _corrupt()
            pos += 4 + size
            continue
        if magic != MAGIC or pos >= end:
            raise _corrupt()
        fhd = data[pos]
        pos += 1
        fcs_flag, single, dict_flag = fhd >> 6, (fhd >> 5) & 1, fhd & 3
        if fhd & 0x08:
            raise _corrupt()
        dn = 4 if dict_flag == 3 else dict_flag
        fn = single if fcs_flag == 0 else 1 << fcs_flag
        if end - pos < (0 if single else 1) + dn + fn:
            raise _corrupt()
        pos += 0 if single else 1
        if int.from_bytes(data[pos:pos + dn], 'little'):
            raise CodecError("zstd frame needs a dictionary")
        pos += dn
        fcs = -1
        if fn:
            fcs = int.from_bytes(data[pos:pos + fn], 'little')
            fcs += 256 if fn == 2 else 0
            pos += fn
        st = _State()
        base = len(out)
        while True:
            if end - pos < 3:
                raise _corrupt()
            bh = int.from_bytes(data[pos:pos + 3], 'little')
            pos += 3
            last, btype, bsize = bh & 1, (bh >> 1) & 3, bh >> 3
            if btype == 0:
                if bsize > end - pos:
                    raise _corrupt()
                out += data[pos:pos + bsize]
                pos += bsize
            elif btype == 1:
                if pos >= end:
                    raise _corrupt()
                out += bytes([data[pos]]) * bsize
                pos += 1
            elif btype == 2:
                if bsize > end - pos or bsize > BLOCK_MAX:
                    raise _corrupt()
                _block(st, data, pos, pos + bsize, out, base)
                pos += bsize
            else:
                raise _corrupt()
            if nbytes is not None and len(out) > nbytes:
                raise _corrupt()
            if last:
                break
        if fcs >= 0 and len(out) - base != fcs:
            raise _corrupt()
        if fhd & 0x04:
            if end - pos < 4:
                raise _corrupt()
            pos += 4
    if nbytes is not None and len(out) != nbytes:
        raise _corrupt()
    return bytes(out)


# ----------------------------------------------------------------- encoder

def fse_normalize(count, log: int) -> List[int]:
    """Normalized counts of ``count`` (two or more symbols present) to
    2^log, as the C encoder's ``fse_normalize``."""
    total = sum(count)
    norm = [0] * len(count)
    big = 0
    s_sum = 0
    for s, c in enumerate(count):
        if not c:
            continue
        v = ((c << log) + total // 2) // total
        norm[s] = max(v, 1)
        s_sum += norm[s]
        if c > count[big]:
            big = s
    size = 1 << log
    if s_sum < size:
        norm[big] += size - s_sum
    while s_sum > size:
        top = -1
        for s, c in enumerate(norm):
            if c > 1 and (top < 0 or c > norm[top]):
                top = s
        norm[top] -= 1
        s_sum -= 1
    return norm


def fse_table_log(nsymbols: int, distinct: int, maxlog: int) -> int:
    log = (nsymbols - 1).bit_length() - 1 - 1
    log = max(log, distinct.bit_length() - 1 + 2, 5)
    return min(log, maxlog)


def _write_ncount(w: _BitOut, norm, log: int) -> None:
    maxsym = len(norm) - 1
    w.add(log - 5, 4)
    remaining, threshold, nbits = (1 << log) + 1, 1 << log, log + 1
    s, prev0 = 0, False
    while s <= maxsym and remaining > 1:
        if prev0:
            start = s
            while s <= maxsym and not norm[s]:
                s += 1
            while s >= start + 3:
                w.add(3, 2)
                start += 3
            w.add(s - start, 2)
        count = norm[s]
        s += 1
        mx = (2 * threshold - 1) - remaining
        remaining -= abs(count)
        count += 1
        if count >= threshold:
            count += mx
        w.add(count, nbits - (count < mx))
        prev0 = count == 1
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1


class _CTable:
    """An FSE encoding table (``fse_build_ctable``)."""

    def __init__(self, norm, log: int):
        size = 1 << log
        at = _spread(norm, log)
        cumul = [0]
        for c in norm:
            cumul.append(cumul[-1] + (1 if c == -1 else c))
        self.state = [0] * size
        for u, s in enumerate(at):
            self.state[cumul[s]] = size + u
            cumul[s] += 1
        self.delta_nbits, self.delta_find = [], []
        total = 0
        for c in norm:
            if c == 0:
                self.delta_nbits.append(((log + 1) << 16) - size)
                self.delta_find.append(0)
            elif c in (-1, 1):
                self.delta_nbits.append((log << 16) - size)
                self.delta_find.append(total - 1)
                total += 1
            else:
                maxout = log - ((c - 1).bit_length() - 1)
                self.delta_nbits.append((maxout << 16) - (c << maxout))
                self.delta_find.append(total - c)
                total += c
        self.log = log

    def init(self, s: int) -> int:
        nb = (self.delta_nbits[s] + (1 << 15)) >> 16
        value = (nb << 16) - self.delta_nbits[s]
        return self.state[(value >> nb) + self.delta_find[s]]

    def encode(self, w: _BitOut, state: int, s: int) -> int:
        nb = (state + self.delta_nbits[s]) >> 16
        w.add(state, nb)
        return self.state[(state >> nb) + self.delta_find[s]]


def huf_lengths(count) -> Tuple[List[int], int]:
    """(code length per symbol, the longest) as the C ``huf_lengths``
    builds them."""
    count = list(count)
    while True:
        order = sorted((s for s in range(256) if count[s]),
                       key=lambda s: (count[s], s))
        n = len(order)
        weight = [count[s] for s in order] + [0] * (n - 1)
        parent = [0] * (2 * n - 1)
        leaf, node, made = 0, n, n
        while made < 2 * n - 1:
            pick = []
            for _ in range(2):
                if leaf < n and (node >= made or weight[leaf] <= weight[node]):
                    pick.append(leaf)
                    leaf += 1
                else:
                    pick.append(node)
                    node += 1
            weight[made] = weight[pick[0]] + weight[pick[1]]
            parent[pick[0]] = parent[pick[1]] = made
            made += 1
        depth = [0] * (2 * n - 1)
        for i in range(2 * n - 3, -1, -1):
            depth[i] = depth[parent[i]] + 1
        lengths = [0] * 256
        for i, s in enumerate(order):
            lengths[s] = depth[i]
        maxlen = max(depth[:n])
        if maxlen <= HUF_MAX_BITS:
            return lengths, maxlen
        count = [(c + 1) // 2 if c else 0 for c in count]


def _huf_codes(lengths, maxlen: int) -> List[int]:
    cnt = [0] * (HUF_MAX_BITS + 2)
    for x in lengths:
        if x:
            cnt[maxlen + 1 - x] += 1
    start = [0] * (HUF_MAX_BITS + 2)
    nxt = 0
    for w in range(1, maxlen + 1):
        start[w] = nxt
        nxt += cnt[w] << (w - 1)
    code = [0] * 256
    for s, x in enumerate(lengths):
        if x:
            w = maxlen + 1 - x
            code[s] = start[w] >> (w - 1)
            start[w] += 1 << (w - 1)
    return code


def _huf_table(lengths, maxlen: int, last: int) -> bytes:
    """The tree description, or b'' when neither form describes it."""
    w = [maxlen + 1 - x if x else 0 for x in lengths[:last]]
    nw = len(w)
    direct = 1 + (nw + 1) // 2 if nw <= 128 else 0
    hist = [0] * 16
    for x in w:
        hist[x] += 1
    present = [k for k in range(16) if hist[k]]
    fse = b''
    if len(present) >= 2:
        norm = fse_normalize(hist[:present[-1] + 1], HUF_WEIGHT_LOG)
        bw = _BitOut()
        _write_ncount(bw, norm, HUF_WEIGHT_LOG)
        bw.flush()
        t = _CTable(norm, HUF_WEIGHT_LOG)
        st = [0, 0]
        st[(nw - 1) & 1] = t.init(w[nw - 1])
        st[(nw - 2) & 1] = t.init(w[nw - 2])
        for i in range(nw - 3, -1, -1):
            st[i & 1] = t.encode(bw, st[i & 1], w[i])
        bw.add(st[1], HUF_WEIGHT_LOG)
        bw.add(st[0], HUF_WEIGHT_LOG)
        bw.add(1, 1)
        fse = bw.flush()
        if len(fse) >= 128 or len(fse) > 159:
            fse = b''
    if fse and (not direct or len(fse) + 1 < direct):
        return bytes([len(fse)]) + fse
    if not direct:
        return b''
    packed = bytearray(direct - 1)
    for i, x in enumerate(w):
        packed[i // 2] |= x if i & 1 else x << 4
    return bytes([127 + nw]) + bytes(packed)


def _huf_stream_write(lit: bytes, lengths, code) -> bytes:
    bw = _BitOut()
    for s in reversed(lit):
        bw.add(code[s], lengths[s])
    bw.add(1, 1)
    return bw.flush()


def _literal_header(kind: int, n: int) -> bytes:
    if n < 32:
        return bytes([kind | (n << 3)])
    if n < 4096:
        return bytes([kind | (1 << 2) | ((n & 15) << 4), n >> 4])
    return bytes([kind | (3 << 2) | ((n & 15) << 4), (n >> 4) & 255,
                  n >> 12])


def _write_literals(lit: bytes) -> bytes:
    n = len(lit)
    raw = _literal_header(0, n) + lit
    count = np.bincount(np.frombuffer(lit, np.uint8),
                        minlength=256).tolist() if n else [0] * 256
    present = [s for s in range(256) if count[s]]
    if n and len(present) == 1:
        return _literal_header(1, n) + lit[:1]
    if n >= 64:
        lengths, maxlen = huf_lengths(count)
        code = _huf_codes(lengths, maxlen)
        table = _huf_table(lengths, maxlen, present[-1])
        if table:
            four = n >= 256
            body = bytearray(table)
            if four:
                seg = (n + 3) // 4
                streams = [_huf_stream_write(lit[k * seg:(k + 1) * seg
                                                 if k < 3 else n],
                                             lengths, code)
                           for k in range(4)]
                if all(len(s) <= 65535 for s in streams[:3]):
                    for s in streams[:3]:
                        body += len(s).to_bytes(2, 'little')
                    for s in streams:
                        body += s
                else:
                    body = None
            else:
                body += _huf_stream_write(lit, lengths, code)
            if body is not None:
                csize = len(body)
                big = max(n, csize)
                sf = 0 if not four else 1 if big < 1024 else 2 \
                    if big < 16384 else 3
                hs = 3 if sf < 2 else 4 if sf == 2 else 5
                bits = 10 if sf < 2 else 14 if sf == 2 else 18
                if hs + csize < len(raw):
                    h = 2 | (sf << 2) | (n << 4) | (csize << (4 + bits))
                    return h.to_bytes(hs, 'little') + bytes(body)
    return raw


def _code_of(base, v: int) -> int:
    c = len(base) - 1
    while base[c] > v:
        c -= 1
    return c


def _field_table(codes, maxsym: int, maxlog: int, default, deflog: int):
    """(mode, table bytes, ctable or None for RLE)."""
    count = [0] * (maxsym + 1)
    for c in codes:
        count[c] += 1
    present = [s for s in range(maxsym + 1) if count[s]]
    if len(present) == 1:
        return 1, bytes([present[0]]), None
    if len(codes) < 64:
        return 0, b'', _CTable(default, deflog)
    log = fse_table_log(len(codes), len(present), maxlog)
    norm = fse_normalize(count[:present[-1] + 1], log)
    bw = _BitOut()
    _write_ncount(bw, norm, log)
    return 2, bw.flush(), _CTable(norm, log)


def _write_sequences(seqs) -> bytes:
    nseq = len(seqs)
    if nseq < 128:
        out = bytearray([nseq])
    elif nseq < 0x7F00:
        out = bytearray([(nseq >> 8) + 128, nseq & 255])
    else:
        out = bytearray([255]) + (nseq - 0x7F00).to_bytes(2, 'little')
    if not nseq:
        return bytes(out)
    llc = [_code_of(LL_BASE, ll) for ll, _, _ in seqs]
    mlc = [_code_of(ML_BASE, ml) for _, ml, _ in seqs]
    ofc = [ofv.bit_length() - 1 for _, _, ofv in seqs]
    fields = [_field_table(llc, MAX_LL, LL_LOG, LL_DEFAULT, LL_DEFAULT_LOG),
              _field_table(ofc, MAX_OF, OF_LOG, OF_DEFAULT, OF_DEFAULT_LOG),
              _field_table(mlc, MAX_ML, ML_LOG, ML_DEFAULT, ML_DEFAULT_LOG)]
    out.append((fields[0][0] << 6) | (fields[1][0] << 4)
               | (fields[2][0] << 2))
    for _, blob, _ in fields:
        out += blob
    tll, tof, tml = (f[2] for f in fields)
    bw = _BitOut()
    k = nseq - 1
    sll = tll.init(llc[k]) if tll else 0
    sof = tof.init(ofc[k]) if tof else 0
    sml = tml.init(mlc[k]) if tml else 0
    while True:
        ll, ml, ofv = seqs[k]
        bw.add(ll - LL_BASE[llc[k]], LL_BITS[llc[k]])
        bw.add(ml - ML_BASE[mlc[k]], ML_BITS[mlc[k]])
        bw.add(ofv, ofc[k])
        if k == 0:
            break
        k -= 1
        if tof:
            sof = tof.encode(bw, sof, ofc[k])
        if tml:
            sml = tml.encode(bw, sml, mlc[k])
        if tll:
            sll = tll.encode(bw, sll, llc[k])
    bw.add(sml, tml.log if tml else 0)
    bw.add(sof, tof.log if tof else 0)
    bw.add(sll, tll.log if tll else 0)
    bw.add(1, 1)
    return bytes(out) + bw.flush()


def _offset_value(rep: List[int], off: int, ll: int) -> int:
    if ll > 0:
        v = 1 if off == rep[0] else 2 if off == rep[1] else \
            3 if off == rep[2] else 0
    else:
        v = 1 if off == rep[1] else 2 if off == rep[2] else \
            3 if off == rep[0] - 1 else 0
    if v == 0:
        rep[2], rep[1], rep[0] = rep[1], rep[0], off
        return off + 3
    idx = v - 1 + (ll == 0)
    if idx:
        if idx != 1:
            rep[2] = rep[1]
        rep[1] = rep[0]
        rep[0] = off
    return v


def compress(src: bytes, clevel: int = 5) -> bytes:
    """One zstd frame of ``src``: the C encoder's, byte for byte."""
    src = bytes(src)
    n = len(src)
    out = bytearray(MAGIC.to_bytes(4, 'little'))
    if n < 256:
        out += bytes([0x20, n])
    elif n < 65536 + 256:
        out += bytes([0x60]) + (n - 256).to_bytes(2, 'little')
    else:
        out += bytes([0xA0]) + n.to_bytes(4, 'little')
    depth = _DEPTH[min(max(int(clevel), 0), 9)]
    hlog = min(max((n - 1).bit_length() - 1 if n > 1 else 10, 10), 17)
    a = np.frombuffer(src, np.uint8)
    if n >= 4:
        seqv, hashes = _hashes(src, hlog)
    head = [-1] * (1 << hlog)
    chain = [-1] * n if depth > 1 else None
    nxt = 0
    rep = [1, 4, 8]
    bstart = 0
    while True:
        bend = min(n, bstart + BLOCK_MAX)
        bn = bend - bstart
        last = bend == n
        saved = list(rep)
        seqs = []
        lit = bytearray()
        ip = anchor = bstart
        while ip + 4 <= bend:
            while nxt < ip:
                h = hashes[nxt]
                if chain is not None:
                    chain[nxt] = head[h]
                head[h] = nxt
                nxt += 1
            s = seqv[ip]
            best = best_off = 0
            r0 = rep[0]
            if ip > anchor and r0 <= ip and seqv[ip - r0] == s:
                best = 4 + _common(a, ip + 4, ip - r0 + 4, bend)
                best_off = r0
            else:
                cand = head[hashes[ip]]
                for _ in range(depth):
                    if cand < 0:
                        break
                    if seqv[cand] == s:
                        length = 4 + _common(a, ip + 4, cand + 4, bend)
                        if length > best:
                            best, best_off = length, ip - cand
                    if chain is None:
                        break
                    cand = chain[cand]
            if best >= 4:
                ll = ip - anchor
                lit += src[anchor:ip]
                seqs.append((ll, best, _offset_value(rep, best_off, ll)))
                ip += best
                anchor = ip
            else:
                ip += 1 + ((ip - anchor) >> 8)
        lit += src[anchor:bend]
        block = src[bstart:bend]
        btype, body = 0, block
        if bn > 1 and block.count(block[:1]) == bn:
            btype, body = 1, block[:1]
        elif bn > 0:
            comp = _write_literals(bytes(lit)) + _write_sequences(seqs)
            if len(comp) < bn:
                btype, body = 2, comp
        if btype != 2:
            rep[:] = saved
        size = len(body) if btype == 2 else bn
        out += (last | (btype << 1) | (size << 3)).to_bytes(3, 'little')
        out += body
        bstart = bend
        if bstart >= n:
            break
    return bytes(out)
