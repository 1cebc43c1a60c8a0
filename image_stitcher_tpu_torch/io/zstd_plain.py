"""The plain version of ``csrc/codec_zstd.h``: Zstandard frames (RFC 8878;
blosc compressor code 4) in Python.

:func:`decompress` reads any valid frame, as the C decoder does:
concatenated and skippable frames, a frame header with or without a
content size and with a window descriptor, raw, RLE and compressed
blocks, raw, RLE, Huffman and treeless literals in 1 or 4 streams with
weights FSE-coded or direct, sequences in predefined, RLE, FSE and
repeat modes, and repeat offsets carried across the blocks of a frame;
a content checksum is skipped, a dictionary refused.

:func:`compress` writes byte for byte the C encoder's frames, within an
output capacity as c-blosc gives it:
- at clevel 1 to 5 and inputs of at most 128 KiB (clevel 1 and 2) or 256
  KiB (clevel 3 to 5; every blosc block at those clevels), libzstd
  1.5.7's ``ZSTD_compressCCtx`` frame at level ``2 * clevel - 1`` (c-blosc's
  map: 1, 3, 5, 7, 9): its parameters for the source size
  (``lib_params``), its matchers (:func:`_fast`, :func:`_dfast`, and
  :class:`_Lazy`: the greedy, lazy and lazy2 parsers over the row hash,
  the hash chain of windows up to 16 KiB, and btlazy2's binary tree at
  level 9 up to 16 KiB), its blocks (128 KiB, a full second block cut by
  its pre-splitter, :func:`_split_block`), its entropy stage (Huffman
  literals with ``HUF_buildCTable``'s sort, tree and height limit, an
  earlier block's table repeated where it serves, raw or RLE literals;
  ``ZSTD_selectEncodingType``'s shortcuts below strategy lazy and its
  cost comparisons from lazy up, and ``FSE_normalizeCount`` for the
  sequences), its block choice (``ZSTD_minGain``; a raw block otherwise,
  an RLE block for a later block of one byte value), and its room checks,
  each failure giving ``b''``, where c-blosc stores the block;
- at every other clevel, and for longer inputs, the port's own matcher
  (:func:`_own_block`: a greedy hash chain over the whole frame, search
  depth 1, 1, 2, 4, ... 256 for clevel 0..9, repeat offsets, blocks of
  128 KiB) with the same entropy stage and block choice.
"""

from __future__ import annotations

from typing import List, Optional

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
#
# A literal port of the C encoder: functions write into a bytearray ``dst``
# at offset ``o`` within ``cap`` bytes and return a size or an error code.

_SMALL, _GENERIC = -100, -101        # libzstd's dstSize_tooSmall, any other
LIB_MAXSRC = 2 * BLOCK_MAX
_DEF_NORM = (LL_DEFAULT, OF_DEFAULT, ML_DEFAULT)
_DEF_LOG = (LL_DEFAULT_LOG, OF_DEFAULT_LOG, ML_DEFAULT_LOG)
_DEF_MAX = (MAX_LL, 28, MAX_ML)
_FIELD_MAX = (MAX_LL, MAX_OF, MAX_ML)
_FIELD_LOG = (LL_LOG, OF_LOG, ML_LOG)
_RTB = (0, 473195, 504333, 520860, 550000, 700000, 750000, 830000)
_M64 = (1 << 64) - 1


def _hb(v: int) -> int:
    return v.bit_length() - 1


def _stream_fits(bits: int, cap: int) -> bool:
    """A stream of ``bits`` bits fits ``cap`` bytes as libzstd's bit
    writers see it (8 bytes of slack)."""
    return cap > 8 and (bits >> 3) < cap - 8


def fse_optimal_log(maxlog: int, n: int, maxsym: int, minus: int) -> int:
    """FSE_optimalTableLog_internal, in libzstd's unsigned arithmetic."""
    maxbits_src = (_hb(n - 1) - minus) & 0xFFFFFFFF
    minbits = min(_hb(n) + 1, _hb(maxsym | 1) + 2)
    log = maxlog
    if maxbits_src < log:
        log = maxbits_src
    if minbits > log:
        log = minbits
    return min(max(log, 5), 12)


def _normalize_m2(norm, log, count, total, maxsym, low_prob):
    unset = -2
    distributed = 0
    low_threshold = total >> log
    low_one = (total * 3) >> (log + 1)
    for s in range(maxsym + 1):
        c = count[s]
        if c == 0:
            norm[s] = 0
        elif c <= low_threshold:
            norm[s] = low_prob
            distributed += 1
            total -= c
        elif c <= low_one:
            norm[s] = 1
            distributed += 1
            total -= c
        else:
            norm[s] = unset
    todo = (1 << log) - distributed
    if todo == 0:
        return 0
    if total // todo > low_one:
        low_one = (total * 3) // (todo * 2)
        for s in range(maxsym + 1):
            if norm[s] == unset and count[s] <= low_one:
                norm[s] = 1
                distributed += 1
                total -= count[s]
        todo = (1 << log) - distributed
    if distributed == maxsym + 1:
        maxv = maxc = 0
        for s in range(maxsym + 1):
            if count[s] > maxc:
                maxv, maxc = s, count[s]
        norm[maxv] += todo
        return 0
    if total == 0:
        s = 0
        while todo > 0:
            if norm[s] > 0:
                todo -= 1
                norm[s] += 1
            s = (s + 1) % (maxsym + 1)
        return 0
    vlog = 62 - log
    mid = (1 << (vlog - 1)) - 1
    rstep = (((1 << vlog) * todo) + mid) // total
    tmp = mid
    for s in range(maxsym + 1):
        if norm[s] != unset:
            continue
        end = tmp + count[s] * rstep
        weight = (end >> vlog) - (tmp >> vlog)
        if weight < 1:
            return _GENERIC
        norm[s] = weight
        tmp = end
    return 0


def fse_normalize(count, log: int, total: int, maxsym: int,
                  low_prob: bool):
    """FSE_normalizeCount of ``count[:maxsym + 1]`` (two or more symbols
    present) to 2^log: the counts, or ``_GENERIC``."""
    lowc = -1 if low_prob else 1
    scale = 62 - log
    step = (1 << 62) // total
    vstep = 1 << (scale - 20)
    still = 1 << log
    largest = largest_p = 0
    low_threshold = total >> log
    norm = [0] * (maxsym + 1)
    for s in range(maxsym + 1):
        c = count[s]
        if c == 0:
            continue
        if c <= low_threshold:
            norm[s] = lowc
            still -= 1
        else:
            p = (c * step) >> scale
            if p < 8:
                p += (c * step) - (p << scale) > vstep * _RTB[p]
            if p > largest_p:
                largest_p, largest = p, s
            norm[s] = p
            still -= p
    if -still >= (norm[largest] >> 1):
        rc = _normalize_m2(norm, log, count, total, maxsym, lowc)
        return rc if rc < 0 else norm
    norm[largest] += still
    return norm


def write_ncount(dst: bytearray, o: int, cap: int, norm, maxsym: int,
                 log: int) -> int:
    """FSE_writeNCount into ``cap`` bytes at ``dst[o:]``: its size, or
    ``_SMALL`` where libzstd's bounded writer runs out of room."""
    safe = cap >= ((maxsym + 1) * log + 6) // 8 + 3
    out = 0
    nbits, remaining, threshold = log + 1, (1 << log) + 1, 1 << log
    bits, nb, s, prev0 = log - 5, 4, 0, False

    def flush():
        nonlocal bits, out
        if not safe and out > cap - 2:
            return False
        dst[o + out] = bits & 255
        dst[o + out + 1] = (bits >> 8) & 255
        out += 2
        bits >>= 16
        return True

    while s <= maxsym and remaining > 1:
        if prev0:
            start = s
            while s <= maxsym and not norm[s]:
                s += 1
            if s > maxsym:
                break
            while s >= start + 24:
                start += 24
                bits += 0xFFFF << nb
                if not flush():
                    return _SMALL
            while s >= start + 3:
                start += 3
                bits += 3 << nb
                nb += 2
            bits += (s - start) << nb
            nb += 2
            if nb > 16:
                if not flush():
                    return _SMALL
                nb -= 16
        count = norm[s]
        s += 1
        mx = (2 * threshold - 1) - remaining
        remaining -= abs(count)
        count += 1
        if count >= threshold:
            count += mx
        bits += count << nb
        nb += nbits - (count < mx)
        prev0 = count == 1
        if remaining < 1:
            return _GENERIC
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
        if nb > 16:
            if not flush():
                return _SMALL
            nb -= 16
    if remaining != 1:
        return _GENERIC
    if not safe and out > cap - 2:
        return _SMALL
    dst[o + out] = bits & 255
    dst[o + out + 1] = (bits >> 8) & 255
    return out + (nb + 7) // 8


class _CTable:
    """An FSE encoding table (``fse_build_ctable``) of symbols
    0..maxsym."""

    def __init__(self, norm, log: int):
        self.maxsym = len(norm) - 1
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


class _Bits(_BitOut):
    """A forward bit stream that counts its bits."""

    def __init__(self):
        super().__init__()
        self.bits = 0

    def add(self, v: int, nb: int) -> None:
        self.bits += nb
        super().add(v, nb)


# ------------------------------------------------------------- Huffman

def _rank_index(c: int) -> int:
    return c if c < 165 else _hb(c) + 158


def _insertion_sort(a, low: int, high: int) -> None:
    for i in range(low + 1, high + 1):
        key = a[i]
        j = i - 1
        while j >= low and a[j][0] < key[0]:
            a[j + 1] = a[j]
            j -= 1
        a[j + 1] = key


def _quick_sort(a, low: int, high: int) -> None:
    """HUF_simpleQuickSort on (count, symbol) pairs: libzstd's order among
    equal counts."""
    if high - low < 8:
        _insertion_sort(a, low, high)
        return
    while low < high:
        pivot = a[high][0]
        i = low - 1
        for j in range(low, high):
            if a[j][0] > pivot:
                i += 1
                a[i], a[j] = a[j], a[i]
        a[i + 1], a[high] = a[high], a[i + 1]
        idx = i + 1
        if idx - low < high - idx:
            _quick_sort(a, low, idx - 1)
            low = idx + 1
        else:
            _quick_sort(a, idx + 1, high)
            high = idx - 1


def _huf_sort(count, maxsym: int):
    """HUF_sort: (count, symbol) of 0..maxsym by descending count."""
    base = [0] * 192
    for n in range(maxsym + 1):
        base[_rank_index(count[n])] += 1
    curr = [0] * 192
    for n in range(191, 0, -1):
        base[n - 1] += base[n]
        curr[n - 1] = base[n - 1]
    node = [None] * (maxsym + 1)
    for n in range(maxsym + 1):
        r = _rank_index(count[n]) + 1
        node[curr[r]] = (count[n], n)
        curr[r] += 1
    for n in range(165, 191):    # also the symbols of count 164
        if curr[n] - base[n] > 1:
            sub = node[base[n]:curr[n]]
            _quick_sort(sub, 0, len(sub) - 1)
            node[base[n]:curr[n]] = sub
    return node


def _set_max_height(cnt, nbits, last: int, target: int) -> int:
    """HUF_setMaxHeight on the sorted leaves' counts and lengths."""
    largest = nbits[last]
    if largest <= target:
        return largest
    cost = 0
    base_cost = 1 << (largest - target)
    n = last
    while nbits[n] > target:
        cost += base_cost - (1 << (largest - nbits[n]))
        nbits[n] = target
        n -= 1
    while nbits[n] == target:
        n -= 1
    cost >>= largest - target
    none = -1
    rank_last = [none] * 14
    cur = target
    for pos in range(n, -1, -1):
        if nbits[pos] >= cur:
            continue
        cur = nbits[pos]
        rank_last[target - cur] = pos
    while cost > 0:
        dec = _hb(cost) + 1
        while dec > 1:
            high, low = rank_last[dec], rank_last[dec - 1]
            if high == none:
                dec -= 1
                continue
            if low == none or cnt[high] <= 2 * cnt[low]:
                break
            dec -= 1
        while dec <= 12 and rank_last[dec] == none:
            dec += 1
        cost -= 1 << (dec - 1)
        nbits[rank_last[dec]] += 1
        if rank_last[dec - 1] == none:
            rank_last[dec - 1] = rank_last[dec]
        if rank_last[dec] == 0:
            rank_last[dec] = none
        else:
            rank_last[dec] -= 1
            if nbits[rank_last[dec]] != target - dec:
                rank_last[dec] = none
    while cost < 0:
        if rank_last[1] == none:
            while nbits[n] == target:
                n -= 1
            nbits[n + 1] -= 1
            rank_last[1] = n + 1
            cost += 1
            continue
        nbits[rank_last[1] + 1] -= 1
        rank_last[1] += 1
        cost += 1
    return target


def huf_build(count, maxsym: int, maxbits: int):
    """HUF_buildCTable_wksp: (lengths, codes, longest) of ``count``
    (two or more symbols present), none longer than ``maxbits``."""
    leaves = _huf_sort(count, maxsym)
    nonnull = maxsym
    while leaves[nonnull][0] == 0:
        nonnull -= 1
    # HUF_buildTree over cells -1 (a barrier), 0..255 (leaves), 256.. (nodes)
    cnt = {-1: 1 << 31}
    for i, (c, _) in enumerate(leaves):
        cnt[i] = c
    parent = {}
    low_s, nb, low_n = nonnull, 256, 256
    root = nb + low_s - 1
    cnt[nb] = cnt[low_s] + cnt[low_s - 1]
    parent[low_s] = parent[low_s - 1] = nb
    nb += 1
    low_s -= 2
    for k in range(nb, root + 1):
        cnt[k] = 1 << 30
    while nb <= root:
        pick = []
        for _ in range(2):
            if cnt[low_s] < cnt[low_n]:
                pick.append(low_s)
                low_s -= 1
            else:
                pick.append(low_n)
                low_n += 1
        cnt[nb] = cnt[pick[0]] + cnt[pick[1]]
        parent[pick[0]] = parent[pick[1]] = nb
        nb += 1
    depth = {root: 0}
    for k in range(root - 1, 255, -1):
        depth[k] = depth[parent[k]] + 1
    nbits = [depth[parent[k]] + 1 if k <= nonnull else 0
             for k in range(maxsym + 1)]
    longest = _set_max_height([c for c, _ in leaves], nbits, nonnull,
                              maxbits)
    per_rank = [0] * 16
    for k in range(nonnull + 1):
        per_rank[nbits[k]] += 1
    val = [0] * 16
    lo = 0
    for k in range(longest, 0, -1):
        val[k] = lo
        lo = (lo + per_rank[k]) >> 1
    lengths = [0] * 256
    for k, (_, sym) in enumerate(leaves):
        lengths[sym] = nbits[k]
    code = [0] * 256
    for sym in range(maxsym + 1):
        if lengths[sym]:
            code[sym] = val[lengths[sym]]
            val[lengths[sym]] += 1
    return lengths, code, longest


def _compress_weights(dst, o, cap, w) -> int:
    """HUF_compressWeights: 0 for no FSE form, 1 for a single weight."""
    n = len(w)
    if n <= 1:
        return 0
    count = [0] * 12
    for x in w:
        count[x] += 1
    maxw = max(k for k in range(12) if count[k])
    most = max(count)
    if most == n:
        return 1
    if most == 1:
        return 0
    log = fse_optimal_log(HUF_WEIGHT_LOG, n, maxw, 2)
    norm = fse_normalize(count, log, n, maxw, False)
    if isinstance(norm, int):
        return norm
    h = write_ncount(dst, o, cap, norm, maxw, log)
    if h < 0:
        return h
    # FSE_compress_usingCTable: two interleaved states
    if n <= 2 or cap - h <= 8:
        return 0
    t = _CTable(norm, log)
    bw = _Bits()
    st = [0, 0]
    st[(n - 1) & 1] = t.init(w[n - 1])
    st[(n - 2) & 1] = t.init(w[n - 2])
    for i in range(n - 3, -1, -1):
        st[i & 1] = t.encode(bw, st[i & 1], w[i])
    bw.add(st[1], log)
    bw.add(st[0], log)
    bw.add(1, 1)
    if not _stream_fits(bw.bits, cap - h):
        return 0
    body = bw.flush()
    dst[o + h:o + h + len(body)] = body
    return h + len(body)


def _write_table(dst, o, cap, lengths, maxsym: int, longest: int) -> int:
    """HUF_writeCTable_wksp: the tree description."""
    w = [longest + 1 - x if x else 0 for x in lengths[:maxsym]]
    if cap < 1:
        return _SMALL
    h = _compress_weights(dst, o + 1, cap - 1, w)
    if h < 0:
        return h
    if h > 1 and h < maxsym // 2:
        dst[o] = h
        return h + 1
    if maxsym > 128:
        return _GENERIC
    if (maxsym + 1) // 2 + 1 > cap:
        return _SMALL
    dst[o] = 128 + maxsym - 1
    w.append(0)
    for s in range(0, maxsym, 2):
        dst[o + s // 2 + 1] = (w[s] << 4) + w[s + 1]
    return (maxsym + 1) // 2 + 1


def _huf_stream_write(dst, o, cap, lit, lengths, code) -> int:
    """One Huffman stream, or 0 where it does not fit ``cap``."""
    if cap <= 8:
        return 0
    total = 1 + sum(lengths[s] for s in lit)
    if (total >> 3) >= cap - 8:
        return 0
    acc = 0
    pos = 0
    for s in reversed(lit):
        acc |= code[s] << pos
        pos += lengths[s]
    acc |= 1 << pos
    body = acc.to_bytes((pos + 8) // 8, 'little')
    dst[o:o + len(body)] = body
    return len(body)


class _HufTable:
    """A Huffman encoding table of symbols 0..maxsym: code lengths (0 for
    a symbol absent from it), codes, the longest length."""

    def __init__(self, lengths, code, maxsym: int, log: int):
        self.lengths, self.code, self.maxsym, self.log = \
            lengths, code, maxsym, log


# the repeat mode of an earlier block's table (libzstd's HUF_repeat and
# FSE_repeat): not usable, or usable after a check of the counts (its
# "valid", usable unchecked, comes only from a dictionary, which c-blosc
# never gives)
_R_NONE, _R_CHECK = 0, 1


class _Entropy:
    """What a block leaves to the next (``ZSTD_entropyCTables_t``): the
    literals' Huffman table and the three sequence fields' tables, each
    with its repeat mode."""

    def __init__(self):
        self.huf_mode, self.huf = _R_NONE, None
        self.fse_mode, self.fse = [_R_NONE] * 3, [None] * 3


def _huf_streams(dst, o, op, cap, lit: bytes, single: bool,
                 t: _HufTable) -> int:
    """HUF_compressCTable_internal: 1 or 4 streams with table ``t`` at
    ``dst[o + op:]``; the size from ``o``, 0 for not compressible."""
    n = len(lit)
    if single:
        c = _huf_stream_write(dst, o + op, cap - op, lit, t.lengths, t.code)
        if c == 0:
            return 0
        op += c
    else:
        seg = (n + 3) // 4
        if cap - op < 17 or n < 12:
            return 0
        jump = op
        op += 6
        for k in range(4):
            c = _huf_stream_write(dst, o + op, cap - op,
                                  lit[k * seg:(k + 1) * seg if k < 3 else n],
                                  t.lengths, t.code)
            if c == 0 or c > 65535:
                return 0
            if k < 3:
                dst[o + jump + 2 * k:o + jump + 2 * k + 2] = \
                    c.to_bytes(2, 'little')
            op += c
    if op >= n - 1:
        return 0
    return op


def _huf_compress(dst, o, cap, lit: bytes, single: bool, suspect: bool,
                  prefer: bool, repeat: int, old):
    """HUF_compress1X/4X_repeat: (size, repeat mode, table) with the
    earlier table ``old`` of mode ``repeat``, or a new table (described
    first; then the mode is ``_R_NONE`` and the table the new one); size 0
    for not compressible, 1 for a single symbol (at ``dst[o]``)."""
    n = len(lit)
    if n == 0 or cap == 0:
        return 0, repeat, old
    a = np.frombuffer(lit, np.uint8)
    if suspect and n >= 4096 * 10:
        largest_total = (int(np.bincount(a[:4096]).max())
                         + int(np.bincount(a[n - 4096:]).max()))
        if largest_total <= (2 * 4096 >> 7) + 4:
            return 0, repeat, old
    count = np.bincount(a, minlength=256).tolist()
    maxsym = max(s for s in range(256) if count[s])
    largest = max(count)
    if largest == n:
        dst[o] = lit[0]
        return 1, repeat, old
    if largest <= (n >> 7) + 4:
        return 0, repeat, old
    if repeat == _R_CHECK and (old.maxsym < maxsym or any(
            count[s] and not old.lengths[s] for s in range(maxsym + 1))):
        repeat = _R_NONE       # HUF_validateCTable
    if prefer and repeat != _R_NONE:
        return _huf_streams(dst, o, 0, cap, lit, single, old), repeat, old
    log = fse_optimal_log(HUF_MAX_BITS, n, maxsym, 1)
    lengths, code, longest = huf_build(count, maxsym, log)
    t = _HufTable(lengths, code, maxsym, longest)
    h = _write_table(dst, o, cap, lengths, maxsym, longest)
    if h < 0:
        return h, repeat, old
    if repeat != _R_NONE:      # HUF_estimateCompressedSize of both
        old_bits = sum(old.lengths[s] * count[s] for s in range(maxsym + 1))
        new_bits = sum(lengths[s] * count[s] for s in range(maxsym + 1))
        if (old_bits >> 3) <= h + (new_bits >> 3) or h + 12 >= n:
            return (_huf_streams(dst, o, 0, cap, lit, single, old), repeat,
                    old)
    if h + 12 >= n:
        return 0, repeat, old
    return _huf_streams(dst, o, h, cap, lit, single, t), _R_NONE, t


def _literal_header(kind: int, n: int) -> bytes:
    if n < 32:
        return bytes([kind | (n << 3)])
    if n < 4096:
        return bytes([kind | (1 << 2) | ((n & 15) << 4), n >> 4])
    return bytes([kind | (3 << 2) | ((n & 15) << 4), (n >> 4) & 255,
                  n >> 12])


def _raw_literals(dst, o, cap, lit: bytes) -> int:
    body = _literal_header(0, len(lit)) + lit
    if len(body) > cap:
        return _SMALL
    dst[o:o + len(body)] = body
    return len(body)


def _min_gain(n: int) -> int:
    return (n >> 6) + 2


def _write_literals(dst, o, cap, lit: bytes, strat: int, suspect: bool,
                    prev: _Entropy, nxt: _Entropy) -> int:
    """ZSTD_compressLiterals: with the earlier block's Huffman table where
    it serves (a treeless section); ``nxt`` gets the table a later block
    may repeat."""
    n = len(lit)
    lh = 3 + (n >= 1024) + (n >= 16384)
    single = n < 256
    repeat = prev.huf_mode
    nxt.huf_mode, nxt.huf = prev.huf_mode, prev.huf
    if n < 8 << min(9 - strat, 3):      # ZSTD_minLiteralsToCompress
        return _raw_literals(dst, o, cap, lit)
    if cap < lh + 1:
        return _SMALL
    c, repeat, table = _huf_compress(dst, o + lh, cap - lh, lit, single,
                                     suspect, strat < 4 and n <= 1024,
                                     repeat, prev.huf)
    kind = 3 if repeat != _R_NONE else 2
    if c <= 0 or c >= n - _min_gain(n):
        return _raw_literals(dst, o, cap, lit)
    if c == 1:
        body = _literal_header(1, n) + lit[:1]
        dst[o:o + len(body)] = body
        return len(body)
    if kind == 2:
        nxt.huf_mode, nxt.huf = _R_CHECK, table
    if lh == 3:
        h = kind | ((not single) << 2) | (n << 4) | (c << 14)
    elif lh == 4:
        h = kind | (2 << 2) | (n << 4) | (c << 18)
    else:
        h = kind | (3 << 2) | (n << 4) | (c << 22)
    dst[o:o + lh] = h.to_bytes(lh, 'little')
    return lh + c


# ------------------------------------------------------------- sequences

def _code_of(base, v: int) -> int:
    c = len(base) - 1
    while base[c] > v:
        c -= 1
    return c


#: kInverseProbabilityLog256: -log2(i / 256) in 1/256 bits, rounded down
_INV_PROB_LOG256 = (0,) + tuple(
    int(-np.log2(i / 256) * 256 + 1e-9) for i in range(1, 256))
_NO_COST = 1 << 64          # libzstd's ERROR(GENERIC) as a cost


def _cross_entropy_cost(norm, log: int, count, mx: int) -> int:
    """ZSTD_crossEntropyCost: the bits of the counts in a default table."""
    return sum(count[s] * _INV_PROB_LOG256[(1 if norm[s] == -1 else norm[s])
                                           << (8 - log)]
               for s in range(mx + 1)) >> 8


def _fse_bit_cost(t: _CTable, count, mx: int) -> int:
    """ZSTD_fseBitCost: the bits of the counts in an earlier table, or
    ``_NO_COST`` where it cannot code them."""
    if t.maxsym < mx:
        return _NO_COST
    log, size = t.log, 1 << t.log
    cost = 0
    for s in range(mx + 1):
        dn = t.delta_nbits[s] & 0xFFFFFFFF
        min_nb = dn >> 16
        delta = (((min_nb + 1) << 16) - (dn + size)) & 0xFFFFFFFF
        bits = (min_nb + 1) * 256 - (((delta << 8) & 0xFFFFFFFF) >> log)
        if count[s] == 0:
            continue
        if bits >= (log + 1) << 8:
            return _NO_COST
        cost += count[s] * bits
    return cost >> 8


def _ncount_cost(count, mx: int, nseq: int, fselog: int) -> int:
    """ZSTD_NCountCost: the bytes of a new table's description."""
    log = fse_optimal_log(fselog, nseq, mx, 2)
    norm = fse_normalize(count, log, nseq, mx, nseq >= 2048)
    if isinstance(norm, int):
        return _NO_COST
    h = write_ncount(bytearray(512), 0, 512, norm, mx, log)
    return _NO_COST if h < 0 else h


def _entropy_cost(count, mx: int, total: int) -> int:
    """ZSTD_entropyCost: the bits of the counts in a table of their own."""
    cost = 0
    for s in range(mx + 1):
        p = 256 * count[s] // total
        if count[s] and not p:
            p = 1
        cost += count[s] * _INV_PROB_LOG256[p]
    return (cost & 0xFFFFFFFF) >> 8


def _seq_field(f: int, codes, strat: int, prevt, prevmode: int, dst, o,
               cap):
    """(type, table, mode for the next block, size of the description at
    dst[o:] or an error) of sequence field f (literal lengths, offsets,
    match lengths): ZSTD_selectEncodingType and ZSTD_buildCTable from the
    earlier block's table ``prevt`` of mode ``prevmode``; types 0
    predefined, 1 RLE, 2 a new table, 3 repeat."""
    nseq = len(codes)
    count = [0] * (_FIELD_MAX[f] + 1)
    for c in codes:
        count[c] += 1
    mx = max(s for s in range(len(count)) if count[s])
    most = max(count)
    deflog = _DEF_LOG[f]
    def_ok = mx <= _DEF_MAX[f]
    mode = prevmode
    if most == nseq:
        mode = _R_NONE
        kind = 0 if def_ok and nseq <= 2 else 1
    elif strat < 4:
        if def_ok and (nseq < ((1 << deflog) * (10 - strat)) >> 3
                       or most < nseq >> (deflog - 1)):
            mode, kind = _R_NONE, 0
        else:
            kind = 2
    else:
        basic = _cross_entropy_cost(_DEF_NORM[f], deflog, count, mx) \
            if def_ok else _NO_COST
        rep = _fse_bit_cost(prevt, count, mx) if mode != _R_NONE \
            else _NO_COST
        nc = _ncount_cost(count, mx, nseq, _FIELD_LOG[f])
        comp = _NO_COST if nc == _NO_COST else \
            (nc << 3) + _entropy_cost(count, mx, nseq)
        if basic <= rep and basic <= comp:
            mode, kind = _R_NONE, 0
        else:
            kind = 3 if rep <= comp else 2
    if kind == 2:
        mode = _R_CHECK
    if kind == 0:
        return 0, _CTable(_DEF_NORM[f], deflog), mode, 0
    if kind == 1:
        if cap == 0:
            return 1, None, mode, _SMALL
        dst[o] = codes[0]
        return 1, None, mode, 1
    if kind == 3:
        return 3, prevt, mode, 0
    log = fse_optimal_log(_FIELD_LOG[f], nseq, mx, 2)
    total = nseq
    if count[codes[-1]] > 1:
        count[codes[-1]] -= 1
        total -= 1
    norm = fse_normalize(count, log, total, mx, total >= 2048)
    if isinstance(norm, int):
        return 2, None, mode, norm
    h = write_ncount(dst, o, cap, norm, mx, log)
    return 2, (_CTable(norm, log) if h >= 0 else None), mode, h


def _write_block_body(dst, o, cap, lit: bytes, seqs, strat: int,
                      prev: _Entropy, nxt: _Entropy) -> int:
    """ZSTD_entropyCompressSeqStore_internal into ``cap`` bytes, from the
    tables ``prev`` left; ``nxt`` gets what this block leaves."""
    nseq = len(seqs)
    suspect = nseq == 0 or len(lit) // nseq >= 20
    op = _write_literals(dst, o, cap, lit, strat, suspect, prev, nxt)
    if op < 0:
        return op
    if cap - op < 4:
        return _SMALL
    if nseq < 128:
        head = bytes([nseq])
    elif nseq < 0x7F00:
        head = bytes([(nseq >> 8) + 128, nseq & 255])
    else:
        head = bytes([255]) + (nseq - 0x7F00).to_bytes(2, 'little')
    dst[o + op:o + op + len(head)] = head
    op += len(head)
    if nseq == 0:         # the tables carry over as if repeated
        nxt.fse_mode, nxt.fse = list(prev.fse_mode), list(prev.fse)
        return op
    codes = ([_code_of(LL_BASE, ll) for ll, _, _ in seqs],
             [ofv.bit_length() - 1 for _, _, ofv in seqs],
             [_code_of(ML_BASE, ml) for _, ml, _ in seqs])
    mode_at = op
    op += 1
    kinds, tables, last_count = [], [], 0
    for f in range(3):
        kind, t, mode, r = _seq_field(f, codes[f], strat, prev.fse[f],
                                      prev.fse_mode[f], dst, o + op, cap - op)
        if r < 0:
            return r
        if kind == 2:
            last_count = r
        kinds.append(kind)
        tables.append(t)
        nxt.fse_mode[f], nxt.fse[f] = mode, t
        op += r
    dst[o + mode_at] = (kinds[0] << 6) | (kinds[1] << 4) | (kinds[2] << 2)
    if cap - op <= 8:
        return _SMALL
    llc, ofc, mlc = codes
    tll, tof, tml = tables
    bw = _Bits()
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
    if not _stream_fits(bw.bits, cap - op):
        return _SMALL
    body = bw.flush()
    dst[o + op:o + op + len(body)] = body
    if last_count and last_count + len(body) < 4:
        return 0       # libzstd's guard for decoders up to 1.3.4
    return op + len(body)


def _block_body(dst, o, cap, lit: bytes, seqs, strat: int, prev: _Entropy,
                nxt: _Entropy, n: int) -> int:
    """ZSTD_entropyCompressSeqStore: the compressed block's body, or 0 for
    a block to store raw."""
    c = _write_block_body(dst, o, cap, lit, seqs, strat, prev, nxt)
    if c == _SMALL and n <= cap:
        return 0
    if c < 0:
        return c
    return 0 if c >= n - _min_gain(n) else c


# -------------------------------------------------------------- matchers

_PRIMES = {5: (24, 889523592379), 6: (16, 227718039650203),
           7: (8, 58295818150454627), 8: (0, 0xCF1BBCDCB7A56463)}


def _words(src: bytes, width: int) -> np.ndarray:
    """The little-endian ``width``-byte word at every position that has
    one, as uint64."""
    a = np.frombuffer(src, np.uint8)
    m = len(src) - width + 1
    w = np.zeros(max(m, 0), np.uint64)
    for k in range(width):
        w |= a[k:k + m].astype(np.uint64) << np.uint64(8 * k)
    return w


def _hash_list(src: bytes, hlog: int, mls: int) -> list:
    """ZSTD_hashPtr at every position with 8 bytes from it."""
    if mls not in _PRIMES:
        w = _words(src, 4)[:max(len(src) - 7, 0)]
        return (((w * np.uint64(2654435761)) & np.uint64(0xFFFFFFFF))
                >> np.uint64(32 - hlog)).tolist()
    shift, prime = _PRIMES[mls]
    w = _words(src, 8)
    return (((w << np.uint64(shift)) * np.uint64(prime))
            >> np.uint64(64 - hlog)).tolist()


def _fast(src: bytes, hlog: int, mls: int):
    """ZSTD_compressBlock_fast on a fresh frame's one block: (sequences,
    literals)."""
    n = len(src)
    a = np.frombuffer(src, np.uint8)
    ilimit = n - 8
    w4 = _words(src, 4).tolist()
    hsh = _hash_list(src, hlog, mls)
    ht = [0] * (1 << hlog)
    seqs, lit = [], bytearray()
    anchor, ip0 = 0, 1
    rep1, rep2 = 1, 0
    while True:
        step, next_step = 2, ip0 + 128
        ip1, ip2 = ip0 + 1, ip0 + 2
        ip3 = ip2 + 1
        if ip3 >= ilimit:
            break
        hash0, hash1 = hsh[ip0], hsh[ip1]
        midx = ht[hash0]
        found = 0
        while True:
            rval = w4[ip2 - rep1]
            cur0 = ip0
            ht[hash0] = ip0 + 2
            if w4[ip2] == rval and rep1 > 0:
                ip0 = ip2
                match0 = ip0 - rep1
                mlen = int(src[ip0 - 1] == src[match0 - 1])
                ip0 -= mlen
                match0 -= mlen
                ofv = 1
                mlen += 4
                ht[hash1] = ip1 + 2
                found = 1
                break
            if midx >= 2 and w4[ip0] == w4[midx - 2]:
                ht[hash1] = ip1 + 2
                found = 2
                break
            midx = ht[hash1]
            hash0, hash1 = hash1, hsh[ip2]
            ip0, ip1, ip2 = ip1, ip2, ip3
            cur0 = ip0
            ht[hash0] = ip0 + 2
            if midx >= 2 and w4[ip0] == w4[midx - 2]:
                if step <= 4:
                    ht[hash1] = ip1 + 2
                found = 2
                break
            midx = ht[hash1]
            hash0, hash1 = hash1, hsh[ip2]
            ip0, ip1 = ip1, ip2
            ip2, ip3 = ip0 + step, ip1 + step
            if ip2 >= next_step:
                step += 1
                next_step += 128
            if ip3 >= ilimit:
                break
        if not found:
            break
        if found == 2:
            match0 = midx - 2
            rep2, rep1 = rep1, ip0 - match0
            ofv = rep1 + 3
            mlen = 4
            while ip0 > anchor and match0 > 0 and \
                    src[ip0 - 1] == src[match0 - 1]:
                ip0 -= 1
                match0 -= 1
                mlen += 1
        mlen += _common(a, ip0 + mlen, match0 + mlen, n)
        seqs.append((ip0 - anchor, mlen, ofv))
        lit += src[anchor:ip0]
        ip0 += mlen
        anchor = ip0
        if ip0 <= ilimit:
            ht[hsh[cur0 + 2]] = cur0 + 4
            ht[hsh[ip0 - 2]] = ip0
            if rep2 > 0:
                while ip0 <= ilimit and w4[ip0] == w4[ip0 - rep2]:
                    rl = _common(a, ip0 + 4, ip0 + 4 - rep2, n) + 4
                    rep1, rep2 = rep2, rep1
                    ht[hsh[ip0]] = ip0 + 2
                    ip0 += rl
                    seqs.append((0, rl, 1))
                    anchor = ip0
    lit += src[anchor:]
    return seqs, bytes(lit)


def _dfast(src: bytes, hlog: int, slog: int, mls: int):
    """ZSTD_compressBlock_doubleFast on a fresh frame's one block:
    (sequences, literals)."""
    n = len(src)
    a = np.frombuffer(src, np.uint8)
    ilimit = n - 8
    w4 = _words(src, 4).tolist()
    w8 = _words(src, 8).tolist()
    hl_of = _hash_list(src, hlog, 8)
    hs_of = _hash_list(src, slog, mls)
    hl = [0] * (1 << hlog)
    hs = [0] * (1 << slog)
    seqs, lit = [], bytearray()
    anchor, ip = 0, 1
    rep1, rep2 = 1, 0
    while True:
        step, next_step = 1, ip + 256
        ip1 = ip + step
        if ip1 > ilimit:
            break
        hl0 = hl_of[ip]
        idxl0 = hl[hl0]
        found = 0
        while True:
            hs0 = hs_of[ip]
            idxs0 = hs[hs0]
            cur = ip
            hl[hl0] = hs[hs0] = ip + 2
            if rep1 > 0 and w4[ip + 1 - rep1] == w4[ip + 1]:
                mlen = _common(a, ip + 5, ip + 5 - rep1, n) + 4
                ip += 1
                seqs.append((ip - anchor, mlen, 1))
                lit += src[anchor:ip]
                found = 1
                break
            hl1 = hl_of[ip1]
            if idxl0 >= 2 and w8[idxl0 - 2] == w8[ip]:
                m0 = idxl0 - 2
                mlen = _common(a, ip + 8, m0 + 8, n) + 8
                offset = ip - m0
                while ip > anchor and m0 > 0 and src[ip - 1] == src[m0 - 1]:
                    ip -= 1
                    m0 -= 1
                    mlen += 1
                found = 2
                break
            idxl1 = hl[hl1]
            if idxs0 >= 2 and w4[idxs0 - 2] == w4[ip]:
                found = 3
                break
            if ip1 >= next_step:
                step += 1
                next_step += 256
            ip = ip1
            ip1 += step
            hl0, idxl0 = hl1, idxl1
            if ip1 > ilimit:
                break
        if not found:
            break
        if found == 3:
            matchs0 = idxs0 - 2
            mlen = _common(a, ip + 4, matchs0 + 4, n) + 4
            offset = ip - matchs0
            if idxl1 > 2 and w8[idxl1 - 2] == w8[ip1]:
                l1 = _common(a, ip1 + 8, idxl1 - 2 + 8, n) + 8
                if l1 > mlen:
                    ip, mlen, matchs0 = ip1, l1, idxl1 - 2
                    offset = ip - matchs0
            while ip > anchor and matchs0 > 0 and \
                    src[ip - 1] == src[matchs0 - 1]:
                ip -= 1
                matchs0 -= 1
                mlen += 1
        if found >= 2:
            rep2, rep1 = rep1, offset
            if step < 4:
                hl[hl1] = ip1 + 2
            seqs.append((ip - anchor, mlen, offset + 3))
            lit += src[anchor:ip]
        ip += mlen
        anchor = ip
        if ip <= ilimit:
            ins = cur + 2
            hl[hl_of[ins]] = ins + 2
            hl[hl_of[ip - 2]] = ip
            hs[hs_of[ins]] = ins + 2
            hs[hs_of[ip - 1]] = ip + 1
            while ip <= ilimit and rep2 > 0 and w4[ip] == w4[ip - rep2]:
                rl = _common(a, ip + 4, ip + 4 - rep2, n) + 4
                rep1, rep2 = rep2, rep1
                hs[hs_of[ip]] = ip + 2
                hl[hl_of[ip]] = ip + 2
                seqs.append((0, rl, 1))
                ip += rl
                anchor = ip
    lit += src[anchor:]
    return seqs, bytes(lit)


#: libzstd 1.5.7's table rows (window, chain, hash and search logs, min
#: match, strategy) of levels 1, 3, 5, 7 and 9 for sources of up to 16
#: KiB, 128 KiB and 256 KiB
_ROWS = (((14, 14, 15, 1, 5, 1), (14, 14, 15, 2, 4, 2), (14, 14, 14, 3, 4, 4),
          (14, 14, 14, 6, 4, 5), (14, 15, 14, 5, 4, 6)),
         ((17, 12, 13, 1, 6, 1), (17, 15, 16, 2, 5, 2), (17, 16, 17, 3, 4, 3),
          (17, 16, 17, 3, 4, 5), (17, 16, 17, 5, 4, 5)),
         ((18, 13, 14, 1, 6, 1), (18, 16, 16, 1, 4, 2), (18, 17, 18, 5, 5, 3),
          (18, 18, 19, 4, 4, 4), (18, 18, 19, 5, 4, 5)))
#: strategies: fast, dfast, greedy, lazy, lazy2, btlazy2
_FAST, _DFAST, _GREEDY, _LAZY, _LAZY2, _BTLAZY2 = 1, 2, 3, 4, 5, 6


def lib_params(level: int, n: int):
    """libzstd 1.5.7's (window log, chain log, hash log, search log, min
    match, strategy) at level 1, 3, 5, 7 or 9 for a known source of n <=
    256 KiB bytes: the row of its table for the size, then
    ``ZSTD_adjustCParams_internal`` (window, hash and chain logs cut to
    the source)."""
    wlog, clog, hlog, slog, mls, strat = \
        _ROWS[0 if n <= 16384 else 1 if n <= 131072 else 2][(level - 1) // 2]
    srclog = 6 if n < 64 else _hb(n - 1) + 1
    wlog = min(wlog, srclog)
    hlog = min(hlog, wlog + 1)
    cycle = clog - (strat >= _BTLAZY2)
    if cycle > wlog:
        clog -= cycle - wlog
    return max(wlog, 10), clog, hlog, slog, mls, strat


def _cnt(src: bytes, a, i: int, j: int, limit: int) -> int:
    """ZSTD_count: how many bytes src[i:] and src[j:] agree on, i bounded
    by limit."""
    m = min(limit - i, 16)
    k = 0
    while k < m and src[i + k] == src[j + k]:
        k += 1
    if k < m or i + k >= limit:
        return k
    return k + _common(a, i + k, j + k, limit)


class _Lazy:
    """libzstd's match state for the lazy parsers on one frame (its
    indices: the frame's byte p at index p + 2), with the hash chain
    (``ZSTD_HcFindBestMatch``), the row hash (``ZSTD_RowFindBestMatch``)
    or the binary tree (``ZSTD_BtFindBestMatch``)."""

    HC, ROW, BT = 0, 1, 2

    def __init__(self, src: bytes, wlog, clog, hlog, slog, mls, strat):
        self.src, self.a = src, np.frombuffer(src, np.uint8)
        self.w4 = _words(src, 4).tolist()
        self.depth = {_GREEDY: 0, _LAZY: 1}.get(strat, 2)
        self.search = self.BT if strat == _BTLAZY2 else \
            self.ROW if wlog > 14 else self.HC
        self.wlog, self.clog, self.hlog, self.slog = wlog, clog, hlog, slog
        self.mls = min(max(mls, 4), 6)
        self.rowlog = min(max(slog, 4), 6)
        self.ht = [0] * (1 << hlog)
        if self.search == self.ROW:
            self.tags = [0] * (1 << hlog)
            hbits = hlog - self.rowlog + 8
        else:
            self.chain = [0] * (1 << clog)
            hbits = hlog
        self.hashes = _hash_list(src, hbits, self.mls)
        self.next = 2
        self.skipping = False

    def low(self, curr: int) -> int:
        """ZSTD_getLowestMatchIndex (no dictionary)."""
        maxd = 1 << self.wlog
        return curr - maxd if curr - 2 > maxd else 2

    def find(self, ip: int, iend: int):
        """(length, offset value) of the best match at ip; the value 999999999
        (libzstd's start, whose high bit the gains read) where none."""
        if self.search == self.ROW:
            return self._row_find(ip, iend)
        if self.search == self.BT:
            return self._bt_find(ip, iend)
        return self._hc_find(ip, iend)

    def _best(self, ip: int, iend: int, curr: int, cands, ml: int, ofb: int):
        src, w4 = self.src, self.w4
        for m in cands:
            mp = m - 2
            if w4[mp + ml - 3] == w4[ip + ml - 3]:
                n = _cnt(src, self.a, ip, mp, iend)
                if n > ml:
                    ml, ofb = n, curr - m + 3
                    if ip + n == iend:
                        break
        return ml, ofb

    def _hc_find(self, ip: int, iend: int):
        curr = ip + 2
        csize = 1 << self.clog
        mask, low = csize - 1, self.low(curr)
        minchain = curr - csize if curr > csize else 0
        ht, chain, hashes = self.ht, self.chain, self.hashes
        idx = self.next
        while idx < curr:
            h = hashes[idx - 2]
            chain[idx & mask] = ht[h]
            ht[h] = idx
            idx += 1
            if self.skipping:
                break
        self.next = curr
        m = ht[hashes[ip]]
        src, w4, ml, ofb = self.src, self.w4, 3, 999999999
        attempts = 1 << self.slog
        while m >= low and attempts > 0:
            mp = m - 2
            if w4[mp + ml - 3] == w4[ip + ml - 3]:
                n = _cnt(src, self.a, ip, mp, iend)
                if n > ml:
                    ml, ofb = n, curr - m + 3
                    if ip + n == iend:
                        break
            if m <= minchain:
                break
            m = chain[m & mask]
            attempts -= 1
        return ml, ofb

    def _row_insert(self, idx: int) -> None:
        h = self.hashes[idx - 2]
        rel = (h >> 8) << self.rowlog
        mask = (1 << self.rowlog) - 1
        slot = (self.tags[rel] - 1) & mask or mask      # ZSTD_row_nextIndex
        self.tags[rel] = slot
        self.tags[rel + slot] = h & 255
        self.ht[rel + slot] = idx

    def _row_find(self, ip: int, iend: int):
        curr = ip + 2
        low = self.low(curr)
        entries = 1 << self.rowlog
        mask = entries - 1
        attempts = 1 << min(self.slog, self.rowlog)
        if not self.skipping:
            # ZSTD_row_update_internal: past a long match only its first
            # 96 and last 32 positions
            idx = self.next
            if curr - idx > 384:
                for i in range(idx, idx + 96):
                    self._row_insert(i)
                idx = curr - 32
            for i in range(idx, curr):
                self._row_insert(i)
        self.next = curr
        h = self.hashes[ip]
        rel = (h >> 8) << self.rowlog
        tag = h & 255
        tags, ht = self.tags, self.ht
        head = tags[rel] & mask
        cands = []
        for j in range(entries):
            if attempts == 0:
                break
            slot = (head + j) & mask
            if tags[rel + slot] != tag or slot == 0:
                continue
            if ht[rel + slot] < low:
                break
            cands.append(ht[rel + slot])
            attempts -= 1
        slot = (tags[rel] - 1) & mask or mask
        tags[rel] = slot
        tags[rel + slot] = tag
        ht[rel + slot] = self.next
        self.next += 1
        return self._best(ip, iend, curr, cands, 3, 999999999)

    def _bt_insert1(self, curr: int, iend: int, nbcmp: int,
                    btlow: int) -> None:
        """ZSTD_insertDUBT1: sort index curr into the tree."""
        bt, src = self.chain, self.src
        btmask = (1 << (self.clog - 1)) - 1
        ip = curr - 2
        smaller, larger = 2 * (curr & btmask), 2 * (curr & btmask) + 1
        m = bt[smaller]
        wlow = self.low(curr)
        cs = cl = 0
        while nbcmp and m > wlow:
            nxt = 2 * (m & btmask)
            mp = m - 2
            ml = min(cs, cl)
            ml += _cnt(src, self.a, ip + ml, mp + ml, iend)
            if ip + ml == iend:
                break
            if src[mp + ml] < src[ip + ml]:
                bt[smaller] = m
                cs = ml
                if m <= btlow:
                    smaller = -1
                    break
                smaller, m = nxt + 1, bt[nxt + 1]
            else:
                bt[larger] = m
                cl = ml
                if m <= btlow:
                    larger = -1
                    break
                larger, m = nxt, bt[nxt]
            nbcmp -= 1
        if smaller >= 0:
            bt[smaller] = 0
        if larger >= 0:
            bt[larger] = 0

    def _bt_find(self, ip: int, iend: int):
        bt, ht, hashes, src = self.chain, self.ht, self.hashes, self.src
        btmask = (1 << (self.clog - 1)) - 1
        curr = ip + 2
        if curr < self.next:
            return 0, 999999999
        for idx in range(self.next, curr):       # ZSTD_updateDUBT
            h = hashes[idx - 2]
            bt[2 * (idx & btmask)] = ht[h]
            bt[2 * (idx & btmask) + 1] = 1       # unsorted
            ht[h] = idx
        self.next = curr
        h = hashes[ip]
        wlow = self.low(curr)
        btlow = 0 if btmask >= curr else curr - btmask
        unsort_limit = max(btlow, wlow)
        nbcmp = nbcand = 1 << self.slog
        prev = 0
        m = ht[h]
        while m > unsort_limit and bt[2 * (m & btmask) + 1] == 1 \
                and nbcand > 1:
            bt[2 * (m & btmask) + 1] = prev      # a chain back up
            prev = m
            m = bt[2 * (m & btmask)]
            nbcand -= 1
        if m > unsort_limit and bt[2 * (m & btmask) + 1] == 1:
            bt[2 * (m & btmask)] = bt[2 * (m & btmask) + 1] = 0
        m = prev
        while m:
            up = bt[2 * (m & btmask) + 1]
            self._bt_insert1(m, iend, nbcand, unsort_limit)
            m = up
            nbcand += 1
        smaller, larger = 2 * (curr & btmask), 2 * (curr & btmask) + 1
        match_end = curr + 9
        cs = cl = best = 0
        ofb = 999999999
        m = ht[h]
        ht[h] = curr
        while nbcmp and m > wlow:
            nxt = 2 * (m & btmask)
            mp = m - 2
            ml = min(cs, cl)
            ml += _cnt(src, self.a, ip + ml, mp + ml, iend)
            if ml > best:
                if ml > match_end - m:
                    match_end = m + ml
                if 4 * (ml - best) > _hb(curr - m + 1) - _hb(ofb):
                    best, ofb = ml, curr - m + 3
                if ip + ml == iend:
                    break
            if src[mp + ml] < src[ip + ml]:
                bt[smaller] = m
                cs = ml
                if m <= btlow:
                    smaller = -1
                    break
                smaller, m = nxt + 1, bt[nxt + 1]
            else:
                bt[larger] = m
                cl = ml
                if m <= btlow:
                    larger = -1
                    break
                larger, m = nxt, bt[nxt]
            nbcmp -= 1
        if smaller >= 0:
            bt[smaller] = 0
        if larger >= 0:
            bt[larger] = 0
        self.next = match_end - 8        # skip repetitive patterns
        return best, ofb

    def block(self, istart: int, iend: int, rep):
        """ZSTD_compressBlock_lazy_generic (no dictionary) at depth 0, 1 or
        2 on block [istart, iend) of the frame: (sequences, literals),
        rep[0] and rep[1] carried."""
        src, a, w4, depth = self.src, self.a, self.w4, self.depth
        ilimit = iend - 8 - (8 if self.search == self.ROW else 0)
        ip = istart + (istart == 0)
        anchor = istart
        off1, off2 = rep[0], rep[1]
        saved1 = saved2 = 0
        maxrep = ip + 2 - self.low(ip + 2)
        if off2 > maxrep:
            saved2, off2 = off2, 0
        if off1 > maxrep:
            saved1, off1 = off1, 0
        self.skipping = False
        seqs, lit = [], bytearray()
        while ip < ilimit:
            ml, start, ofb = 0, ip + 1, 1
            if off1 > 0 and w4[ip + 1 - off1] == w4[ip + 1]:
                ml = _cnt(src, a, ip + 5, ip + 5 - off1, iend) + 4
            if not (ml and depth == 0):
                ml2, found = self.find(ip, iend)
                if ml2 > ml:
                    ml, start, ofb = ml2, ip, found
                if ml < 4:
                    step = ((ip - anchor) >> 8) + 1
                    ip += step
                    self.skipping = step > 8
                    continue
                # a better match one or two positions on?
                while depth >= 1 and ip < ilimit:
                    ip += 1
                    if off1 > 0 and w4[ip] == w4[ip - off1]:
                        mlrep = _cnt(src, a, ip + 4, ip + 4 - off1, iend) + 4
                        if mlrep * 3 > ml * 3 - _hb(ofb) + 1:
                            ml, ofb, start = mlrep, 1, ip
                    ml2, found = self.find(ip, iend)
                    if ml2 >= 4 and ml2 * 4 - _hb(found) > \
                            ml * 4 - _hb(ofb) + 4:
                        ml, ofb, start = ml2, found, ip
                        continue
                    if depth == 2 and ip < ilimit:
                        ip += 1
                        if off1 > 0 and w4[ip] == w4[ip - off1]:
                            mlrep = _cnt(src, a, ip + 4, ip + 4 - off1,
                                         iend) + 4
                            if mlrep * 4 > ml * 4 - _hb(ofb) + 1:
                                ml, ofb, start = mlrep, 1, ip
                        ml2, found = self.find(ip, iend)
                        if ml2 >= 4 and ml2 * 4 - _hb(found) > \
                                ml * 4 - _hb(ofb) + 7:
                            ml, ofb, start = ml2, found, ip
                            continue
                    break
                if ofb > 3:      # a new offset: catch up backwards
                    off = ofb - 3
                    while start > anchor and start - off > 0 and \
                            src[start - 1] == src[start - off - 1]:
                        start -= 1
                        ml += 1
                    off1, off2 = off, off1
            seqs.append((start - anchor, ml, ofb))
            lit += src[anchor:start]
            anchor = ip = start + ml
            self.skipping = False
            # the second repeat offset, at once
            while ip <= ilimit and off2 > 0 and w4[ip] == w4[ip - off2]:
                ml = _cnt(src, a, ip + 4, ip + 4 - off2, iend) + 4
                off1, off2 = off2, off1
                seqs.append((0, ml, 1))
                ip += ml
                anchor = ip
        if saved1 and off1:
            saved2 = saved1
        rep[0] = off1 or saved1
        rep[1] = off2 or saved2
        lit += src[anchor:iend]
        return seqs, bytes(lit)


# ------------------------------------------------------ the block splitter

def _fingerprint(p: bytes, rate: int, hlog: int):
    """(events, count): byte pairs of an 8 KiB step
    (lib/compress/zstd_preSplit.c)."""
    a = np.frombuffer(p, np.uint8)[:8192].astype(np.uint32)
    limit = 8192 - 2 + 1
    sel = np.arange(0, limit, rate)
    if hlog == 8:
        h = a[sel]
    else:
        pair = a[sel] | (a[sel + 1] << np.uint32(8))
        h = (pair * np.uint32(0x9E3779B9)) >> np.uint32(32 - hlog)
    return np.bincount(h, minlength=1024).astype(np.int64), limit // rate


def _split_block(p: bytes, level: int) -> int:
    """ZSTD_splitBlock_byChunks at level 1-4: the first 8 KiB step of a
    full block whose fingerprint differs from the steps before it, or the
    whole block."""
    rate, hlog = ((43, 8), (11, 9), (5, 10), (1, 10))[level - 1]
    past, past_n = _fingerprint(p, rate, hlog)
    penalty = 3
    for pos in range(8192, BLOCK_MAX - 8192 + 1, 8192):
        new, new_n = _fingerprint(p[pos:], rate, hlog)
        dist = int(np.abs(past * new_n - new * past_n).sum())
        if dist >= past_n * new_n * (14 + penalty) // 16:
            return pos
        past, past_n = past + new, past_n + new_n
        penalty = max(penalty - 1, 0)
    return BLOCK_MAX


def _block_size(src: bytes, start: int, strat: int, savings: int) -> int:
    """ZSTD_optimalBlockSize: a full block is split only after the frame
    has saved 3 bytes or more (so never the first block); fast (split from
    the borders) never reaches it, its frames here holding one block."""
    remaining = len(src) - start
    if remaining < BLOCK_MAX:
        return remaining
    level = (0, 0, 1, 2, 2, 3, 3)[strat]
    if savings < 3 or level == 0:
        return BLOCK_MAX
    return _split_block(src[start:start + BLOCK_MAX], level)


def _own_block(src: bytes, a, seqv, hashes, head, chain, nxt, bstart: int,
               bend: int, rep, depth: int):
    """The port's own matcher on block [bstart, bend): (sequences,
    literals, next position to enter)."""
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
    return seqs, bytes(lit), nxt


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


# ----------------------------------------------------------------- frame

def compress(src: bytes, clevel: int = 5, cap: Optional[int] = None) -> bytes:
    """One zstd frame of ``src`` within ``cap`` bytes (none by default):
    the C encoder's, byte for byte; ``b''`` where libzstd would fail for
    want of room."""
    src = bytes(src)
    n = len(src)
    cap = 2 * n + 1024 if cap is None else cap
    if cap < 18:
        return b''
    lib = (clevel in (1, 2) and n <= BLOCK_MAX) or \
        (clevel in (3, 4, 5) and n <= LIB_MAXSRC)
    out = bytearray(MAGIC.to_bytes(4, 'little'))
    if n < 256:
        out += bytes([0x20, n])
    elif n < 65536 + 256:
        out += bytes([0x60]) + (n - 256).to_bytes(2, 'little')
    else:
        out += bytes([0xA0]) + n.to_bytes(4, 'little')
    if n == 0:
        return bytes(out) + b'\x01\x00\x00'
    strat = _DFAST
    if lib:
        wlog, clog, hlog, slog, mls, strat = lib_params(2 * clevel - 1, n)
        if strat >= _GREEDY:
            lazy = _Lazy(src, wlog, clog, hlog, slog, mls, strat)
    else:
        depth = _DEPTH[min(max(int(clevel), 0), 9)]
        olog = min(max((n - 1).bit_length() - 1 if n > 1 else 10, 10), 17)
        a = np.frombuffer(src, np.uint8)
        seqv, hashes = _hashes(src, olog) if n >= 4 else ([], [])
        head = [-1] * (1 << olog)
        chain = [-1] * n if depth > 1 else None
        nxt = 0
    # the tables of the last compressed block
    prev = _Entropy()
    rep = [1, 4, 8]
    bstart = savings = 0
    while True:
        bn = _block_size(src, bstart, strat, savings) if lib else \
            min(n - bstart, BLOCK_MAX)
        bend = bstart + bn
        block = src[bstart:bend]
        room = cap - len(out)
        if room < 3 + 2 + 1:
            return b''
        saved = list(rep)
        c, rle = 0, False
        body = bytearray(max(room - 3, 0))
        if bn >= 7:         # ZSTD_buildSeqStore: no attempt under 7 bytes
            if not lib:
                seqs, lit, nxt = _own_block(src, a, seqv, hashes, head, chain,
                                            nxt, bstart, bend, rep, depth)
            elif strat == _FAST:
                seqs, lit = _fast(src, hlog, mls)
            elif strat == _DFAST:
                seqs, lit = _dfast(src, hlog, clog, mls)
            else:
                # a limited update after a very long match
                curr = bstart + 2
                if curr > lazy.next + 384:
                    lazy.next = curr - min(192, curr - lazy.next - 384)
                seqs, lit = lazy.block(bstart, bend, rep)
            # a later block of one byte value is an RLE block (libzstd's
            # first block never is): at once where its sequences are few,
            # else where it codes to under 25 bytes
            same = bstart > 0 and block.count(block[:1]) == bn
            if same and len(seqs) < 4 and len(lit) < 10:
                rle = True
            else:
                nxt_ent = _Entropy()
                c = _block_body(body, 0, room - 3, lit, seqs, strat, prev,
                                nxt_ent, bn)
                if c < 0:
                    return b''
                rle = same and c < 25
        if rle:
            btype, size, payload = 1, bn, block[:1]
        elif c == 0:
            if bn + 3 > room:
                return b''
            btype, size, payload = 0, bn, block
        else:
            btype, size, payload = 2, c, bytes(body[:c])
            prev = nxt_ent      # ZSTD_blockState_confirmRepcodesAnd...
        if btype != 2:
            rep[:] = saved
        out += ((bend == n) | (btype << 1) | (size << 3)).to_bytes(3, 'little')
        out += payload
        savings += bn - 3 - len(payload)
        bstart = bend
        if bstart >= n:
            break
    return bytes(out)
