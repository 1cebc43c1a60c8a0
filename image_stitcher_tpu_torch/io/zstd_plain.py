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
- at clevel 1 to 9 and inputs up to the clevel's blosc block (128 KiB at
  clevel 1 and 2, 256 KiB at 3 to 5, 512 KiB at 6 to 8, 1 MiB at 9),
  libzstd 1.5.7's ``ZSTD_compressCCtx`` frame at the level c-blosc asks
  for (:func:`lib_level`: ``2 * clevel - 1``, and 22 at clevel 9): its
  parameters for the source size (``lib_params``), its matchers
  (:func:`_fast`, :func:`_dfast`, :class:`_Lazy`: the greedy, lazy and
  lazy2 parsers over the row hash, the hash chain of windows up to 16 KiB
  and btlazy2's binary tree; and :class:`_Opt`: the optimal parser of
  btopt, btultra and btultra2 over the binary tree and the hash3 table,
  btultra2 parsing its first block once to seed the prices), its blocks
  (128 KiB, a full block after the first cut by its pre-splitter,
  :func:`_split_block`, and from btopt up over windows of 128 KiB or
  more a block's sequences split where ``ZSTD_deriveBlockSplits``
  estimates a gain, :func:`_split_blocks`), its entropy stage (Huffman
  literals with ``HUF_buildCTable``'s sort, tree and height limit, the
  depth search from btultra up, an earlier block's table repeated where
  it serves, raw or RLE literals; ``ZSTD_selectEncodingType``'s
  shortcuts below strategy lazy and its cost comparisons from lazy up,
  and ``FSE_normalizeCount`` for the sequences), its block choice
  (``ZSTD_minGain`` by strategy; a raw block otherwise, an RLE block for
  a later block of one byte value), and its room checks, each failure
  giving ``b''``, where c-blosc stores the block;
- for inputs longer than any blosc block hands a clevel, and clevel 0,
  the port's own matcher (:func:`_own_block`: a greedy hash chain over
  the whole frame, search depth 1, 1, 2, 4, ... 256 for clevel 0..9,
  repeat offsets, blocks of 128 KiB) with the same entropy stage and
  block choice.
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
#: strategies: fast, dfast, greedy, lazy, lazy2, btlazy2, btopt, btultra,
#: btultra2
(_FAST, _DFAST, _GREEDY, _LAZY, _LAZY2, _BTLAZY2, _BTOPT, _BTULTRA,
 _BTULTRA2) = range(1, 10)
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


def _huf_estimate(lengths, count, maxsym: int) -> int:
    """HUF_estimateCompressedSize: the bytes of the counts in a table."""
    return sum(lengths[s] * count[s] for s in range(maxsym + 1)) >> 3


def _huf_optimal_log(count, maxsym: int, n: int, depth: bool) -> int:
    """HUF_optimalTableLog: FSE_optimalTableLog's guess, or with ``depth``
    (strategy btultra up) the depth whose table and codes are the
    smallest, searched up from the least the symbols need until the size
    grows."""
    if not depth:
        return fse_optimal_log(HUF_MAX_BITS, n, maxsym, 1)
    minlog = _hb(sum(1 for s in range(maxsym + 1) if count[s])) + 1
    best, log = _M64 - 1, HUF_MAX_BITS
    buf = bytearray(1024)
    for guess in range(minlog, HUF_MAX_BITS + 1):
        lengths, _, maxbits = huf_build(count, maxsym, guess)
        if maxbits < guess and guess > minlog:
            break
        h = _write_table(buf, 0, len(buf), lengths, maxsym, maxbits)
        if h < 0:
            continue
        size = _huf_estimate(lengths, count, maxsym) + h
        if size > best + 1:
            break
        if size < best:
            best, log = size, guess
    return log


def _huf_compress(dst, o, cap, lit: bytes, single: bool, suspect: bool,
                  prefer: bool, depth: bool, repeat: int, old):
    """HUF_compress1X/4X_repeat: (size, repeat mode, table) with the
    earlier table ``old`` of mode ``repeat``, or a new table (described
    first, its depth searched where ``depth`` is set; then the mode is
    ``_R_NONE`` and the table the new one); size 0 for not compressible,
    1 for a single symbol (at ``dst[o]``)."""
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
    log = _huf_optimal_log(count, maxsym, n, depth)
    lengths, code, longest = huf_build(count, maxsym, log)
    t = _HufTable(lengths, code, maxsym, longest)
    h = _write_table(dst, o, cap, lengths, maxsym, longest)
    if h < 0:
        return h, repeat, old
    if repeat != _R_NONE:      # HUF_estimateCompressedSize of both
        if _huf_estimate(old.lengths, count, maxsym) <= \
                h + _huf_estimate(lengths, count, maxsym) or h + 12 >= n:
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


def _min_gain(n: int, strat: int) -> int:
    """ZSTD_minGain: n / 64 + 2 below strategy btultra, n >> (strategy -
    1) + 2 from it up."""
    return (n >> (strat - 1 if strat >= _BTULTRA else 6)) + 2


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
                                     suspect, strat < _LAZY and n <= 1024,
                                     strat >= _BTULTRA, repeat, prev.huf)
    kind = 3 if repeat != _R_NONE else 2
    if c <= 0 or c >= n - _min_gain(n, strat):
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
    return 0 if c >= n - _min_gain(n, strat) else c


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
#: match, target length, strategy) of levels 1, 3, 5, 7, 9, 11, 13, 15 and
#: 22 (blosc clevel 1 to 9) for sources of up to 16 KiB, 128 KiB, 256 KiB
#: and longer
_ROWS = (((14, 14, 15, 1, 5, 0, 1), (14, 14, 15, 2, 4, 0, 2),
          (14, 14, 14, 3, 4, 4, 4), (14, 14, 14, 6, 4, 8, 5),
          (14, 15, 14, 5, 4, 8, 6), (14, 15, 14, 3, 4, 12, 7),
          (14, 15, 14, 5, 3, 32, 8), (14, 15, 15, 7, 3, 256, 8),
          (14, 15, 15, 10, 3, 999, 9)),
         ((17, 12, 13, 1, 6, 0, 1), (17, 15, 16, 2, 5, 0, 2),
          (17, 16, 17, 3, 4, 2, 3), (17, 16, 17, 3, 4, 8, 5),
          (17, 16, 17, 5, 4, 8, 5), (17, 17, 17, 5, 4, 8, 6),
          (17, 18, 17, 3, 4, 12, 7), (17, 18, 17, 6, 3, 256, 7),
          (17, 18, 17, 11, 3, 999, 9)),
         ((18, 13, 14, 1, 6, 0, 1), (18, 16, 16, 1, 4, 0, 2),
          (18, 17, 18, 5, 5, 2, 3), (18, 18, 19, 4, 4, 4, 4),
          (18, 18, 19, 5, 4, 8, 5), (18, 18, 19, 5, 4, 12, 6),
          (18, 18, 19, 4, 4, 16, 7), (18, 18, 19, 6, 3, 128, 7),
          (18, 19, 19, 13, 3, 999, 9)),
         ((19, 13, 14, 1, 7, 0, 1), (21, 16, 17, 1, 5, 0, 2),
          (21, 18, 19, 3, 5, 2, 3), (21, 19, 20, 4, 5, 8, 4),
          (22, 20, 21, 4, 5, 16, 5), (22, 21, 22, 6, 5, 16, 5),
          (22, 22, 22, 4, 5, 32, 6), (22, 23, 23, 6, 5, 32, 6),
          (27, 27, 25, 9, 3, 999, 9)))


def lib_level(clevel: int) -> int:
    """The libzstd level c-blosc asks for: 2 * clevel - 1, and its
    maximum, 22, at clevel 9."""
    return 22 if clevel == 9 else 2 * clevel - 1


def lib_maxsrc(clevel: int) -> int:
    """The longest input a clevel follows libzstd on: its blosc block."""
    return BLOCK_MAX << (0 if clevel <= 2 else 1 if clevel <= 5 else
                         2 if clevel <= 8 else 3)


def lib_params(level: int, n: int):
    """libzstd 1.5.7's (window log, chain log, hash log, search log, min
    match, target length, strategy) at level 1, 3, 5, ..., 15 or 22 for a
    known source of n bytes: the row of its table for the size, then
    ``ZSTD_adjustCParams_internal`` (window, hash and chain logs cut to
    the source)."""
    wlog, clog, hlog, slog, mls, tlen, strat = \
        _ROWS[0 if n <= 16384 else 1 if n <= 131072 else 2 if n <= 262144
              else 3][8 if level == 22 else (level - 1) // 2]
    srclog = 6 if n < 64 else _hb(n - 1) + 1
    wlog = min(wlog, srclog)
    hlog = min(hlog, wlog + 1)
    cycle = clog - (strat >= _BTLAZY2)
    if cycle > wlog:
        clog -= cycle - wlog
    return max(wlog, 10), clog, hlog, slog, mls, tlen, strat


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


# ------------------------------------------------ libzstd's optimal parser

_OPT_NUM = 1 << 12                  # ZSTD_OPT_NUM
_MAX_PRICE = 1 << 30
_BIT = 256                          # BITCOST_MULTIPLIER
_PREDEF = 8                         # ZSTD_PREDEF_THRESHOLD
_LL_CODE = ((0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 16, 17,
             17, 18, 18, 19, 19, 20, 20, 20, 20, 21, 21, 21, 21)
            + (22,) * 8 + (23,) * 8 + (24,) * 16)
_ML_CODE = (tuple(range(32)) + (32, 32, 33, 33, 34, 34, 35, 35) + (36,) * 4
            + (37,) * 4 + (38,) * 8 + (39,) * 8 + (40,) * 16 + (41,) * 16
            + (42,) * 32)


def _ll_code(ll: int) -> int:
    return ll.bit_length() + 18 if ll > 63 else _LL_CODE[ll]


def _ml_code(mlb: int) -> int:
    """The code of a match length less 3."""
    return mlb.bit_length() + 35 if mlb > 127 else _ML_CODE[mlb]


def _count(src: bytes, i: int, j: int, limit: int) -> int:
    """ZSTD_count: how many bytes src[i:] and src[j:] agree on, i bounded
    by limit (slices compared in doubling steps, then halved)."""
    m = limit - i
    e = 8 if m > 8 else m
    k = 0
    while k < e and src[i + k] == src[j + k]:
        k += 1
    if k < e or k == m:
        return k
    step = 16
    while True:
        e = step if step < m - k else m - k
        if src[i + k:i + k + e] == src[j + k:j + k + e]:
            k += e
            if k == m:
                return k
            step <<= 1
            continue
        while e > 8:
            h = e >> 1
            if src[i + k:i + k + h] == src[j + k:j + k + h]:
                k += h
                e -= h
            else:
                e = h
        while src[i + k] == src[j + k]:
            k += 1
        return k


def _update_rep(rep, offb: int, ll0: int) -> None:
    """ZSTD_updateRep: the repeat offsets after a match of offset value
    ``offb`` (``ll0``: after no literals), in place."""
    if offb > 3:
        rep[2], rep[1], rep[0] = rep[1], rep[0], offb - 3
        return
    r = offb - 1 + ll0
    if r:
        cur = (rep[0] - 1) & 0xFFFFFFFF if r == 3 else rep[r]
        if r >= 2:
            rep[2] = rep[1]
        rep[1] = rep[0]
        rep[0] = cur


class _Opt:
    """libzstd's match state and ``optState_t`` for the optimal parser on
    one frame (btopt, btultra, btultra2): the binary tree
    (``ZSTD_insertBt1``, ``ZSTD_insertBtAndGetAllMatches``), the hash3
    table where minMatch is 3, the statistics and prices carried from
    block to block. The frame's byte p is at index p + base: base 2, or
    past btultra2's first pass. A cell of the forward pass is a list
    [price, offset value, match length, literal length, repeat offsets],
    copied where libzstd copies its struct."""

    def __init__(self, src: bytes, wlog, clog, hlog, slog, mls, tlen,
                 strat):
        self.src = src
        pad = src + bytes(8)        # a word at every position
        self.w4, self.w8 = _words(pad, 4).tolist(), _words(pad, 8).tolist()
        self.base = self.low = self.next = 2
        self.wlog, self.clog, self.hlog, self.slog = wlog, clog, hlog, slog
        self.mls = min(max(mls, 3), 6)
        self.mm = 3 if mls == 3 else 4
        self.tlen = tlen
        self.optlevel = 0 if strat == _BTOPT else 2
        self.ht = [0] * (1 << hlog)
        self.bt = [0] * (1 << clog)
        self.hashes = _hash_list(src, hlog, self.mls)
        self.h3log = min(wlog, 17) if mls == 3 else 0
        if self.h3log:
            w = _words(src, 4)
            m32 = np.uint64(0xFFFFFFFF)
            self.hashes3 = (((((w << np.uint64(8)) & m32)
                              * np.uint64(506832829)) & m32)
                            >> np.uint64(32 - self.h3log)).tolist()
            self.ht3 = [0] * (1 << self.h3log)
        self.lit_freq = [0] * 256
        self.ll_freq, self.ml_freq, self.of_freq = [0] * 36, [0] * 53, \
            [0] * 32
        self.ll_sum = 0
        self.predef = False
        # the cells a pass can reach: ZSTD_OPT_NUM + 3, or n + 3 for less
        self.opt = [[0, 0, 0, 0, [0, 0, 0]]
                    for _ in range(min(_OPT_NUM, len(src)) + 3)]

    # ------------------------------------------------------------ prices

    def _weight(self, stat: int) -> int:
        """ZSTD_bitWeight (btopt) or ZSTD_fracWeight, in 1/256 bits."""
        s = stat + 1
        hb = s.bit_length() - 1
        return hb * _BIT + ((s << 8) >> hb if self.optlevel else 0)

    def _set_prices(self) -> None:
        """ZSTD_setBasePrices; and each match length code's price less
        the base, each offset code's with it (the weights of the counts
        are kept as the counts change)."""
        w = self._weight
        self.lit_base = w(self.lit_sum)
        self.ll_base = w(self.ll_sum)
        self.ml_base = w(self.ml_sum)
        self.of_base = w(self.of_sum)
        self.ll_small = [w(ll) if self.predef else
                         LL_BITS[c] * _BIT + self.ll_base - self.wll[c]
                         for ll, c in enumerate(_LL_CODE)]
        wml, wof = self.wml, self.wof
        self.ml_part = [ML_BITS[c] * _BIT - wml[c] for c in range(53)]
        handicap = self.optlevel < 2
        self.of_part = [ofc * _BIT + self.of_base - wof[ofc]
                        + ((ofc - 19) * 2 * _BIT if handicap and ofc >= 20
                           else 0) + self.ml_base + _BIT // 5
                        for ofc in range(32)]

    def _rescale(self, block: bytes) -> None:
        """ZSTD_rescaleFreqs: a frame's first block from its own bytes'
        counts and fixed length and offset counts (fixed prices under 9
        bytes), a later one from the counts carried, scaled down."""
        self.predef = False
        if self.ll_sum == 0:
            self.predef = len(block) <= _PREDEF
            cnt = np.bincount(np.frombuffer(block, np.uint8), minlength=256)
            self.lit_freq = [int(c > 0) + (int(c) >> 8) for c in cnt]
            self.ll_freq = [4, 2] + [1] * 34
            self.ml_freq = [1] * 53
            self.of_freq = [6, 2, 1, 1, 2, 3, 4, 4, 4, 3, 2, 1] + [1] * 20
        else:                               # ZSTD_scaleStats
            for t, logt in ((self.lit_freq, 12), (self.ll_freq, 11),
                            (self.ml_freq, 11), (self.of_freq, 11)):
                factor = sum(t) >> logt
                if factor > 1:
                    sh = factor.bit_length() - 1
                    t[:] = [1 + (x >> sh) for x in t]
        w = self._weight
        self.lit_sum, self.ll_sum = sum(self.lit_freq), sum(self.ll_freq)
        self.ml_sum, self.of_sum = sum(self.ml_freq), sum(self.of_freq)
        self.wlit = [w(x) for x in self.lit_freq]
        self.wll = [w(x) for x in self.ll_freq]
        self.wml = [w(x) for x in self.ml_freq]
        self.wof = [w(x) for x in self.of_freq]
        self._set_prices()

    def _lit_price(self, c: int) -> int:
        """ZSTD_rawLiteralsCost of one literal."""
        if self.predef:
            return 6 * _BIT
        p = self.wlit[c]
        mx = self.lit_base - _BIT
        return self.lit_base - (mx if p > mx else p)

    def _ll_price(self, ll: int) -> int:
        """ZSTD_litLengthPrice."""
        if ll < 64:
            return self.ll_small[ll]
        if self.predef:
            return self._weight(ll)
        if ll == BLOCK_MAX:
            return _BIT + self._ll_price(BLOCK_MAX - 1)
        c = _ll_code(ll)
        return LL_BITS[c] * _BIT + self.ll_base - self.wll[c]

    def _match_price(self, offb: int, ml: int) -> int:
        """ZSTD_getMatchPrice."""
        ofc = offb.bit_length() - 1
        mlb = ml - 3
        if self.predef:
            return self._weight(mlb) + (16 + ofc) * _BIT
        # far offsets cost more at btopt (in of_part)
        return self.of_part[ofc] + self.ml_part[
            _ML_CODE[mlb] if mlb < 128 else mlb.bit_length() + 35]

    def _update_stats(self, ll: int, start: int, offb: int, ml: int) -> None:
        """ZSTD_updateStats after a sequence."""
        lf, wlit, w = self.lit_freq, self.wlit, self._weight
        for b in set(self.src[start:start + ll]):
            lf[b] += 2 * self.src.count(b, start, start + ll)
            wlit[b] = w(lf[b])
        self.lit_sum += 2 * ll
        for freq, wt, c in ((self.ll_freq, self.wll, _ll_code(ll)),
                            (self.of_freq, self.wof, offb.bit_length() - 1),
                            (self.ml_freq, self.wml, _ml_code(ml - 3))):
            freq[c] += 1
            wt[c] = w(freq[c])
        self.ll_sum += 1
        self.of_sum += 1
        self.ml_sum += 1

    # ------------------------------------------------------- the tree

    def _low(self, curr: int) -> int:
        """ZSTD_getLowestMatchIndex (no dictionary)."""
        maxd = 1 << self.wlog
        return curr - maxd if curr - self.low > maxd else self.low

    def _insert_bt1(self, curr: int, iend: int, target: int) -> int:
        """ZSTD_insertBt1: sort index curr into the tree; how far on the
        next insertion may start."""
        src, bt, base, w8 = self.src, self.bt, self.base, self.w8
        btmask = (1 << (self.clog - 1)) - 1
        ip = curr - base
        h = self.hashes[ip]
        m = self.ht[h]
        self.ht[h] = curr
        smaller, larger = 2 * (curr & btmask), 2 * (curr & btmask) + 1
        btlow = 0 if btmask >= curr else curr - btmask
        wlow = self._low(target)
        match_end, best = curr + 9, 8
        cs = cl = 0
        nbcmp = 1 << self.slog
        while nbcmp and m >= wlow:
            nxt = 2 * (m & btmask)
            ml = cs if cs < cl else cl
            mp = m - base
            if ip + ml + 8 <= iend:     # the first 8 bytes as words
                x = w8[ip + ml] ^ w8[mp + ml]
                ml += (((x & -x).bit_length() - 1) >> 3 if x else
                       8 + _count(src, ip + ml + 8, mp + ml + 8, iend))
            else:
                ml += _count(src, ip + ml, mp + ml, iend)
            if ml > best:
                best = ml
                if ml > match_end - m:
                    match_end = m + ml
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
        skip = min(192, best - 384) if best > 384 else 0
        return max(skip, match_end - (curr + 8))

    def _matches(self, ip: int, iend: int, rep, ll0: int, next3: int):
        """ZSTD_btGetAllMatches: ([(offset value, length)], each longer
        than the last: the repeat offsets, the hash3 table's candidate
        where minMatch is 3, the tree), and the hash3 table's next index
        (ZSTD_updateTree enters the positions before ip first)."""
        base = self.base
        curr = ip + base
        if curr < self.next:
            return [], next3                # a skipped area
        idx = self.next
        while idx < curr:
            idx += self._insert_bt1(idx, iend, curr)
        self.next = curr
        src, bt, mm, w4, w8 = self.src, self.bt, self.mm, self.w4, self.w8
        sufficient = min(self.tlen, _OPT_NUM - 1)
        btmask = (1 << (self.clog - 1)) - 1
        btlow = 0 if btmask >= curr else curr - btmask
        wlow = self._low(curr)
        mlow = wlow or 1
        head = 0xFFFFFF if mm == 3 else 0xFFFFFFFF
        out = []
        best = mm - 1
        for r in range(ll0, 3 + ll0):
            roff = (rep[0] - 1) & 0xFFFFFFFF if r == 3 else rep[r]
            length = 0
            if ((roff - 1) & 0xFFFFFFFF) < curr - self.low \
                    and curr - roff >= wlow \
                    and not (w4[ip] ^ w4[ip - roff]) & head:
                length = _count(src, ip + mm, ip + mm - roff, iend) + mm
            if length > best:
                best = length
                out.append((r - ll0 + 1, length))
                if length > sufficient or ip + length == iend:
                    return out, next3
        if self.mls == 3 and best < 3:
            ht3, h3 = self.ht3, self.hashes3
            for i in range(next3, curr):    # ZSTD_insertAndFindFirstIndexHash3
                ht3[h3[i - base]] = i
            next3 = curr
            m3 = ht3[h3[ip]]
            if m3 >= mlow and curr - m3 < (1 << 18):
                length = _count(src, ip, m3 - base, iend)
                if length >= 3:
                    best = length
                    out = [(curr - m3 + 3, length)]
                    if length > sufficient or ip + length == iend:
                        self.next = curr + 1    # not entered in the tree
                        return out, next3
        h = self.hashes[ip]
        m = self.ht[h]
        self.ht[h] = curr
        smaller, larger = 2 * (curr & btmask), 2 * (curr & btmask) + 1
        match_end = curr + 9
        cs = cl = 0
        nbcmp = 1 << self.slog
        while nbcmp and m >= mlow:
            nxt = 2 * (m & btmask)
            ml = cs if cs < cl else cl
            mp = m - base
            if ip + ml + 8 <= iend:     # the first 8 bytes as words
                x = w8[ip + ml] ^ w8[mp + ml]
                ml += (((x & -x).bit_length() - 1) >> 3 if x else
                       8 + _count(src, ip + ml + 8, mp + ml + 8, iend))
            else:
                ml += _count(src, ip + ml, mp + ml, iend)
            if ml > best:
                if ml > match_end - m:
                    match_end = m + ml
                best = ml
                out.append((curr - m + 3, ml))
                if ml > _OPT_NUM or ip + ml == iend:
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
        self.next = match_end - 8           # skip repetitive patterns
        return out, next3

    # ----------------------------------------------------------- parser

    def block(self, istart: int, iend: int, rep):
        """ZSTD_compressBlock_opt_generic (no dictionary) on block
        [istart, iend) of the frame: (sequences, literals), rep carried.
        A forward pass prices every position up to ZSTD_OPT_NUM on (a
        match longer than the target length taken at once), a backward
        walk emits the cheapest path."""
        src = self.src
        ilimit = iend - 8
        sufficient = min(self.tlen, _OPT_NUM - 1)
        mm, optlevel = self.mm, self.optlevel
        next3 = self.next
        self._rescale(src[istart:iend])
        litp, llp, mp = self._lit_price, self._ll_price, self._match_price
        opt = self.opt
        last = [0, 0, 0, 0, [0, 0, 0]]
        seqs, lit = [], bytearray()
        ip = anchor = istart
        if ip + self.base == self.low:
            ip += 1
        while ip < ilimit:
            litlen = ip - anchor
            matches, next3 = self._matches(ip, iend, rep, int(not litlen),
                                           next3)
            if not matches:
                ip += 1
                continue
            o0 = opt[0]
            o0[2], o0[3], o0[0], o0[4] = 0, litlen, llp(litlen), list(rep)
            if matches[-1][1] > sufficient:     # at once
                last[3], last[2], last[1] = 0, matches[-1][1], matches[-1][0]
                cur, last_pos = 0, last[2]
            else:
                for pos in range(1, mm):
                    c = opt[pos]
                    c[0], c[2], c[3] = _MAX_PRICE, 0, litlen + pos
                pos = mm
                for offb, end in matches:
                    while pos <= end:
                        c = opt[pos]
                        c[2], c[1], c[3] = pos, offb, 0
                        c[0] = o0[0] + mp(offb, pos) + llp(0)
                        pos += 1
                last_pos = pos - 1
                opt[pos][0] = _MAX_PRICE
                cur = 1
                at_once = False
                # the prices of this pass (the counts change only where a
                # pass stores its sequences)
                ll_small, wlit = self.ll_small, self.wlit
                lit_base, lit_max = self.lit_base, self.lit_base - _BIT
                predef = self.predef
                while cur <= last_pos:
                    inr = ip + cur
                    prev = opt[cur - 1]
                    ll = prev[3] + 1
                    if predef or ll > 63:
                        price = prev[0] + litp(src[inr - 1]) + llp(ll) \
                            - llp(ll - 1)
                    else:
                        w = wlit[src[inr - 1]]
                        price = prev[0] + lit_base - (lit_max if w > lit_max
                                                      else w) \
                            + ll_small[ll] - ll_small[ll - 1]
                    if price <= opt[cur][0]:    # one literal on, cheaper
                        prevm = opt[cur]
                        opt[cur] = [price, prev[1], prev[2], ll, prev[4]]
                        if optlevel >= 1 and prevm[3] == 0 and \
                                llp(1) - llp(0) < 0 and inr < iend:
                            # the replaced match and one literal at the
                            # next position, if cheaper there
                            lp = litp(src[inr])
                            with1 = prevm[0] + lp + llp(1) - llp(0)
                            withmore = price + lp + llp(ll + 1) - llp(ll)
                            if with1 < withmore and with1 < opt[cur + 1][0]:
                                p = opt[cur - prevm[2]]
                                r = list(p[4])
                                _update_rep(r, prevm[1], int(p[3] == 0))
                                opt[cur + 1] = [with1, prevm[1], prevm[2], 1,
                                                r]
                                if last_pos < cur + 1:
                                    last_pos = cur + 1
                    c = opt[cur]
                    if c[3] == 0:               # a match ends here
                        p = opt[cur - c[2]]
                        r = list(p[4])
                        _update_rep(r, c[1], int(p[3] == 0))
                        c[4] = r
                    if inr > ilimit:
                        cur += 1
                        continue
                    if cur == last_pos:
                        break
                    if optlevel == 0 and opt[cur + 1][0] <= c[0] + _BIT // 2:
                        cur += 1
                        continue
                    base_price = c[0] + llp(0)
                    matches, next3 = self._matches(inr, iend, c[4],
                                                   int(c[3] == 0), next3)
                    if not matches:
                        cur += 1
                        continue
                    longest = matches[-1][1]
                    if longest > sufficient or cur + longest >= _OPT_NUM \
                            or inr + longest >= iend:
                        last[2], last[1], last[3] = longest, matches[-1][0], 0
                        last_pos = cur + longest
                        at_once = True
                        break
                    start = mm
                    ml_part = self.ml_part
                    for offb, mlen in matches:
                        ofp = base_price + self.of_part[offb.bit_length() - 1]
                        for ml in range(mlen, start - 1, -1):
                            pos = cur + ml
                            mlb = ml - 3
                            p = base_price + mp(offb, ml) if self.predef \
                                else ofp + ml_part[_ML_CODE[mlb] if mlb < 128
                                                   else mlb.bit_length() + 35]
                            if pos > last_pos or p < opt[pos][0]:
                                while last_pos < pos:
                                    last_pos += 1
                                    f = opt[last_pos]
                                    f[0], f[3] = _MAX_PRICE, 1
                                f = opt[pos]
                                f[2], f[1], f[3], f[0] = ml, offb, 0, p
                            elif optlevel == 0:
                                break
                        start = mlen + 1
                    opt[last_pos + 1][0] = _MAX_PRICE
                    cur += 1
                if not at_once:
                    last = list(opt[last_pos])
                    cur = last_pos - last[2]
            if last[2] == 0:                    # literals only
                ip += last_pos
                continue
            if last[3] == 0:
                r = list(opt[cur][4])
                _update_rep(r, last[1], int(opt[cur][3] == 0))
                rep[:] = r
            else:
                rep[:] = last[4]
                cur -= last[3]
            # the backward walk, stored from cur + 2 down; libzstd 1.5.7
            # writes a last stretch's literals and then, not instead, the
            # stretch itself: its literals are not taken, and the next
            # pass starts where its match ends
            store_end = cur + 2
            if last[3] > 0:
                e = opt[store_end]
                e[3], e[2] = last[3], 0
                opt[store_end - 1] = list(last)
            opt[store_end] = list(last)
            store_start, pos = store_end, cur
            while True:
                s = list(opt[pos])
                opt[store_start][3] = s[3]
                if s[2] == 0:
                    break
                store_start -= 1
                opt[store_start] = s
                pos -= s[3] + s[2]
            for sp in range(store_start, store_end + 1):
                ll, offb, ml = opt[sp][3], opt[sp][1], opt[sp][2]
                if ml == 0:
                    ip = anchor + ll
                    continue
                self._update_stats(ll, anchor, offb, ml)
                seqs.append((ll, ml, offb))
                lit += src[anchor:anchor + ll]
                anchor += ll + ml
                ip = anchor
            self._set_prices()
        lit += src[anchor:iend]
        return seqs, bytes(lit)

    def first_pass(self, n: int, rep) -> None:
        """ZSTD_initStats_ultra (btultra2): the first block parsed once to
        seed the statistics; its sequences go, and the window moves past
        it."""
        self.block(0, n, list(rep))
        self.base += n
        self.low = self.next = self.base


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
    level = (0, 0, 1, 2, 2, 3, 3, 4, 4, 4)[strat]
    if savings < 3 or level == 0:
        return BLOCK_MAX
    return _split_block(src[start:start + BLOCK_MAX], level)


# -------------------------------------------------- the post-block splitter

def _field_bytes(f: int, kind: int, codes, table) -> int:
    """ZSTD_estimateBlockSize_symbolType: a sequence field's bytes in a
    table of type 0 (predefined), 1 (RLE), 2 or 3 (new, repeated), its
    extra bits included (an offset code is its own count of them)."""
    count = [0] * (_FIELD_MAX[f] + 1)
    for c in codes:
        count[c] += 1
    mx = max(s for s in range(len(count)) if count[s])
    if kind == 0:
        bits = _cross_entropy_cost(_DEF_NORM[f], _DEF_LOG[f], count, mx)
    elif kind == 1:
        bits = 0
    else:
        bits = _fse_bit_cost(table, count, mx)
        if bits == _NO_COST:
            return len(codes) * 10
    extra = (LL_BITS, None, ML_BITS)[f]
    bits += sum(codes) if extra is None else sum(extra[c] for c in codes)
    return bits >> 3


def _estimate(lit: bytes, codes, strat: int, prev: _Entropy) -> int:
    """ZSTD_estimateSubBlockSize_seqStore of one run of sequences (their
    codes) and literals: ZSTD_buildBlockEntropyStats from the last
    compressed block's tables, then ZSTD_estimateBlockSize; an error
    where libzstd's is."""
    nlit, nseq = len(lit), len(codes[0])
    lit_bytes = nlit                                # raw
    if nlit > 63:
        count = np.bincount(np.frombuffer(lit, np.uint8),
                            minlength=256).tolist()
        maxsym = max(s for s in range(256) if count[s])
        largest = max(count)
        if largest == nlit:
            lit_bytes = 1
        elif largest > (nlit >> 7) + 4:
            repeat = prev.huf_mode
            if repeat == _R_CHECK and (prev.huf.maxsym < maxsym or any(
                    count[s] and not prev.huf.lengths[s]
                    for s in range(maxsym + 1))):
                repeat = _R_NONE            # HUF_validateCTable
            log = _huf_optimal_log(count, maxsym, nlit, strat >= _BTULTRA)
            lengths, _, longest = huf_build(count, maxsym, log)
            newc = _huf_estimate(lengths, count, maxsym)
            h = _write_table(bytearray(128), 0, 128, lengths, maxsym, longest)
            # libzstd compares an error's size_t as it is
            hs = h if h >= 0 else (_M64 + 1 - (70 if h == _SMALL else 1))
            table, desc = None, 0
            if repeat != _R_NONE:
                oldc = _huf_estimate(prev.huf.lengths, count, maxsym)
                if oldc < nlit and (oldc <= (hs + newc) & _M64
                                    or (hs + 12) & _M64 >= nlit):
                    table = prev.huf.lengths
            if table is None and (newc + hs) & _M64 < nlit:
                if h < 0:
                    return _GENERIC
                table, desc = lengths, h
            if table is not None:
                lit_bytes = _huf_estimate(table, count, maxsym) + desc \
                    + (6 if nlit >= 256 else 0) + 3 + (nlit >= 1024) \
                    + (nlit >= 16384)
    buf = bytearray(133)        # ZSTD_MAX_FSE_HEADERS_SIZE
    op = seq_bytes = 0
    for f in range(3):
        kind, table, _, r = _seq_field(f, codes[f], strat, prev.fse[f],
                                       prev.fse_mode[f], buf, op, 133 - op)
        if r < 0:
            return r
        op += r
        seq_bytes += _field_bytes(f, kind, codes[f], table)
    return seq_bytes + op + 2 + (nseq >= 128) + (nseq >= 0x7F00) \
        + lit_bytes + 3


def _derive_splits(est, s0: int, s1: int, parts) -> None:
    """ZSTD_deriveBlockSplitsHelper: split [s0, s1) in half where both
    halves' estimates undercut the whole's, and each half again (no part
    under 300 sequences, at most 196 splits)."""
    if s1 - s0 < 300 or len(parts) >= 196:
        return
    mid = (s0 + s1) // 2
    whole, first, second = est(s0, s1), est(s0, mid), est(mid, s1)
    if whole < 0 or first < 0 or second < 0:
        return
    if first + second < whole:
        _derive_splits(est, s0, mid, parts)
        parts.append(mid)
        _derive_splits(est, mid, s1, parts)


def _resolve(drep, crep, seqs) -> list:
    """ZSTD_seqStore_resolveOffCodes: a repeat offset that means another
    offset to the decoder (drep: its history, which raw and RLE blocks
    reset; crep: the matcher's) becomes the offset it meant."""
    out = []
    for ll, ml, offb in seqs:
        ll0 = int(ll == 0)
        ofv = offb
        if offb <= 3:
            r = offb - 1 + ll0
            d = (drep[0] - 1) & 0xFFFFFFFF if r == 3 else drep[r]
            c = (crep[0] - 1) & 0xFFFFFFFF if r == 3 else crep[r]
            if d != c:
                ofv = c + 3
        _update_rep(drep, ofv, ll0)
        _update_rep(crep, offb, ll0)
        out.append((ll, ml, ofv))
    return out


def _seq_block(block: bytes, lit: bytes, seqs, strat: int, prev: _Entropy,
               drep, crep, first: bool, last: bool, cap: int):
    """ZSTD_compressSeqStore_singleBlock: (the block with its header, or
    an error; its type; the tables the next block starts from) of
    ``block`` from sequences and literals (raw where it does not
    compress, RLE for a later block of one byte value); a partition's
    repeat offsets resolved first (``crep`` given)."""
    saved = list(drep)
    if crep is not None:
        seqs = _resolve(drep, crep, seqs)
    if cap < 3:
        return _SMALL, 0, prev
    n = len(block)
    body = bytearray(cap - 3)
    nxt = _Entropy()
    c = _block_body(body, 0, cap - 3, lit, seqs, strat, prev, nxt, n)
    if c < 0:
        return c, 0, prev
    if not first and c < 25 and block.count(block[:1]) == n:
        c = 1
    if c == 0:
        if n + 3 > cap:
            return _SMALL, 0, prev
        btype, size, payload = 0, n, block
    elif c == 1:
        if cap < 4:
            return _SMALL, 0, prev
        btype, size, payload = 1, n, block[:1]
    else:
        btype, size, payload = 2, c, bytes(body[:c])
        prev = nxt       # ZSTD_blockState_confirmRepcodesAndEntropyTables
    if btype != 2:
        drep[:] = saved
    head = (int(last) | (btype << 1) | (size << 3)).to_bytes(3, 'little')
    return head + payload, btype, prev


def _split_blocks(block: bytes, seqs, lit: bytes, strat: int,
                  prev: _Entropy, rep, saved, split: bool, first: bool,
                  last: bool, cap: int):
    """ZSTD_compressBlock_internal (one block) or, with ``split``,
    ZSTD_compressBlock_splitBlock_internal (in the partitions
    ZSTD_deriveBlockSplits finds): (bytes or an error, the tables after)
    of a block from its sequences (rep: the matcher's repeat offsets
    after it, as the next block sees them after the call; saved: those
    before)."""
    nseq = len(seqs)
    drep, crep = list(saved), list(saved)
    parts = []
    if split and nseq > 4:
        codes = ([_ll_code(ll) for ll, _, _ in seqs],
                 [offb.bit_length() - 1 for _, _, offb in seqs],
                 [_ml_code(ml - 3) for _, ml, _ in seqs])
        litpos = [0]
        for ll, _, _ in seqs:
            litpos.append(litpos[-1] + ll)
        litpos[-1] = len(lit)

        def est(s0, s1):
            return _estimate(lit[litpos[s0]:litpos[s1]],
                             tuple(c[s0:s1] for c in codes), strat, prev)
        _derive_splits(est, 0, nseq, parts)
    if not parts:
        out, btype, prev = _seq_block(block, lit, seqs, strat, prev, drep,
                                      None, first, last, cap)
        if not isinstance(out, int) and btype != 2:
            rep[:] = saved
        return out, prev
    out = bytearray()
    bounds = [0] + parts + [nseq]
    done = 0
    for i in range(len(bounds) - 1):
        s0, s1 = bounds[i], bounds[i + 1]
        part = seqs[s0:s1]
        nbytes = len(block) - done if s1 == nseq else \
            sum(ll + ml for ll, ml, _ in part)
        chunk, _, prev = _seq_block(
            block[done:done + nbytes], lit[litpos[s0]:litpos[s1]], part,
            strat, prev, drep, crep, first, last and s1 == nseq,
            cap - len(out))
        if isinstance(chunk, int):
            return chunk, prev
        out += chunk
        done += nbytes
    rep[:] = drep
    return bytes(out), prev


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
    lib = 1 <= clevel <= 9 and n <= lib_maxsrc(clevel)
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
        wlog, clog, hlog, slog, mls, tlen, strat = \
            lib_params(lib_level(clevel), n)
        if strat >= _BTOPT:
            opt = _Opt(src, wlog, clog, hlog, slog, mls, tlen, strat)
        elif strat >= _GREEDY:
            lazy = _Lazy(src, wlog, clog, hlog, slog, mls, strat)
    else:
        depth = _DEPTH[min(max(int(clevel), 0), 9)]
        olog = min(max((n - 1).bit_length() - 1 if n > 1 else 10, 10), 17)
        a = np.frombuffer(src, np.uint8)
        seqv, hashes = _hashes(src, olog) if n >= 4 else ([], [])
        head = [-1] * (1 << olog)
        chain = [-1] * n if depth > 1 else None
        nxt = 0
    # the post-block splitter from btopt up over windows of 128 KiB or more
    split = lib and strat >= _BTOPT and wlog >= 17
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
        if bn < 7:          # ZSTD_buildSeqStore: no attempt under 7 bytes
            if bn + 3 > room:
                return b''
            blocks = (int(bend == n) | (bn << 3)).to_bytes(3, 'little') \
                + block
        else:
            if lib and strat >= _GREEDY:
                # a limited update after a very long match
                m = opt if strat >= _BTOPT else lazy
                curr = bstart + (m.base if strat >= _BTOPT else 2)
                if curr > m.next + 384:
                    m.next = curr - min(192, curr - m.next - 384)
            if not lib:
                seqs, lit, nxt = _own_block(src, a, seqv, hashes, head, chain,
                                            nxt, bstart, bend, rep, depth)
            elif strat == _FAST:
                seqs, lit = _fast(src, hlog, mls)
            elif strat == _DFAST:
                seqs, lit = _dfast(src, hlog, clog, mls)
            elif strat >= _BTOPT:
                if strat == _BTULTRA2 and bstart == 0 and bn > _PREDEF:
                    opt.first_pass(bn, rep)
                seqs, lit = opt.block(bstart, bend, rep)
            else:
                seqs, lit = lazy.block(bstart, bend, rep)
            blocks, prev = _split_blocks(block, seqs, lit, strat, prev, rep,
                                         saved, split, bstart == 0, bend == n,
                                         room)
            if isinstance(blocks, int):
                return b''
        out += blocks
        savings += bn - len(blocks)
        bstart = bend
        if bstart >= n:
            break
    return bytes(out)
