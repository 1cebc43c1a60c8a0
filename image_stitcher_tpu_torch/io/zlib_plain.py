"""The plain version of ``csrc/codec_zlib.h``: zlib streams (blosc
compressor code 3) in Python, byte for byte the C encoder's, which runs
deflate as the zlib that tensorstore's c-blosc links (Chromium's fork of
zlib 1.3.1) runs it in ``compress2`` at the blosc clevel. The stream's
layout and the encoder's rules are in the C file's header; the names
here are zlib's (``deflate.c``, ``trees.c``). Decoding is the stdlib's
:func:`zlib.decompress`, which reads any valid stream."""

from __future__ import annotations

from typing import List, Optional

import numpy as np

WSIZE = 32768
_WMASK = WSIZE - 1
_WINDOW = 2 * WSIZE
_HASH_MASK = (1 << 15) - 1
MIN_MATCH, MAX_MATCH = 3, 258
_MIN_LOOKAHEAD = MAX_MATCH + MIN_MATCH + 1
MAX_DIST = WSIZE - _MIN_LOOKAHEAD
LIT_BUFSIZE = 16384
_TOO_FAR = 4096
_MAX_STORED = 65535
_LITERALS, _END_BLOCK, _LENGTH_CODES = 256, 256, 29
_L_CODES = _LITERALS + 1 + _LENGTH_CODES
_D_CODES, _BL_CODES = 30, 19
_HEAP_SIZE = 2 * _L_CODES + 1
_MAX_BITS, _MAX_BL_BITS = 15, 7
_REP_3_6, _REPZ_3_10, _REPZ_11_138 = 16, 17, 18

EXTRA_LBITS = (0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
               4, 4, 4, 4, 5, 5, 5, 5, 0)
EXTRA_DBITS = (0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8,
               9, 9, 10, 10, 11, 11, 12, 12, 13, 13)
_EXTRA_BLBITS = (0,) * 16 + (2, 3, 7)
_BL_ORDER = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1,
             15)
#: (good, lazy, nice, chain) of levels 0-9: zlib's configuration_table
CONFIG = ((0, 0, 0, 0), (4, 4, 8, 4), (4, 5, 16, 8), (4, 6, 32, 32),
          (4, 4, 16, 16), (8, 16, 32, 32), (8, 16, 128, 128),
          (8, 32, 128, 256), (32, 128, 258, 1024), (32, 258, 258, 4096))


def _bi_reverse(code: int, length: int) -> int:
    res = 0
    for _ in range(length):
        res = (res << 1) | (code & 1)
        code >>= 1
    return res


def _gen_codes(lens: List[int], codes: List[int], max_code: int,
               bl_count: List[int]) -> None:
    next_code = [0] * (_MAX_BITS + 1)
    code = 0
    for bits in range(1, _MAX_BITS + 1):
        code = (code + bl_count[bits - 1]) << 1
        next_code[bits] = code & 0xFFFF
    for n in range(max_code + 1):
        length = lens[n]
        if length:
            codes[n] = _bi_reverse(next_code[length], length)
            next_code[length] += 1


def _static_tables():
    length_code = [0] * 256
    base_length = [0] * _LENGTH_CODES
    length = 0
    for code in range(_LENGTH_CODES - 1):
        base_length[code] = length
        for _ in range(1 << EXTRA_LBITS[code]):
            length_code[length] = code
            length += 1
    length_code[length - 1] = _LENGTH_CODES - 1
    dist_code = [0] * 512
    base_dist = [0] * _D_CODES
    dist = 0
    for code in range(16):
        base_dist[code] = dist
        for _ in range(1 << EXTRA_DBITS[code]):
            dist_code[dist] = code
            dist += 1
    dist >>= 7
    for code in range(16, _D_CODES):
        base_dist[code] = dist << 7
        for _ in range(1 << (EXTRA_DBITS[code] - 7)):
            dist_code[256 + dist] = code
            dist += 1
    slen = [8 if n <= 143 else 9 if n <= 255 else 7 if n <= 279 else 8
            for n in range(288)]
    bl_count = [0] * (_MAX_BITS + 1)
    for v in slen:
        bl_count[v] += 1
    scode = [0] * 288
    _gen_codes(slen, scode, _L_CODES + 1, bl_count)
    dlen = [5] * _D_CODES
    dcode = [_bi_reverse(n, 5) for n in range(_D_CODES)]
    return (length_code, base_length, dist_code, base_dist, slen, scode,
            dlen, dcode)


(LENGTH_CODE, BASE_LENGTH, DIST_CODE, BASE_DIST, _SLTREE_LEN, _SLTREE_CODE,
 _SDTREE_LEN, _SDTREE_CODE) = _static_tables()


def d_code(dist: int) -> int:
    return DIST_CODE[dist] if dist < 256 else DIST_CODE[256 + (dist >> 7)]


class _Bits:
    """zlib's bit layer: LSB first, whole bytes appended."""

    def __init__(self):
        self.out = bytearray()
        self.buf = 0
        self.valid = 0

    def send(self, value: int, length: int) -> None:
        self.buf |= value << self.valid
        self.valid += length
        if self.valid >= 32:
            self.out += (self.buf & 0xFFFFFFFF).to_bytes(4, 'little')
            self.buf >>= 32
            self.valid -= 32

    def windup(self) -> None:
        nbytes = (self.valid + 7) >> 3
        self.out += self.buf.to_bytes(8, 'little')[:nbytes]
        self.buf = self.valid = 0


class _Tree:
    """A tree_desc and its ct_data: ``fc`` is Freq then Code, ``dl`` Dad
    then Len, sharing their storage as zlib's unions do."""

    def __init__(self, size: int, elems: int, extra, base: int,
                 max_length: int, static_len: Optional[List[int]]):
        self.fc = [0] * size
        self.dl = [0] * size
        self.elems = elems
        self.extra = extra
        self.base = base
        self.max_length = max_length
        self.static_len = static_len
        self.max_code = 0


class _Trees:
    """trees.c: the symbol buffer and the block encoder."""

    def __init__(self, bits: _Bits):
        self.bits = bits
        self.ltree = _Tree(_HEAP_SIZE, _L_CODES, EXTRA_LBITS, _LITERALS + 1,
                           _MAX_BITS, _SLTREE_LEN)
        self.dtree = _Tree(2 * _D_CODES + 1, _D_CODES, EXTRA_DBITS, 0,
                           _MAX_BITS, _SDTREE_LEN)
        self.bltree = _Tree(2 * _BL_CODES + 1, _BL_CODES, _EXTRA_BLBITS, 0,
                            _MAX_BL_BITS, None)
        self.heap = [0] * (2 * _L_CODES + 1)
        self.depth = [0] * (2 * _L_CODES + 1)
        self.bl_count = [0] * (_MAX_BITS + 1)
        self.heap_len = self.heap_max = 0
        self.opt_len = self.static_len = 0
        self.sym_dist: List[int] = []
        self.sym_lc: List[int] = []
        self.init_block()

    def init_block(self) -> None:
        for tree, n in ((self.ltree, _L_CODES), (self.dtree, _D_CODES),
                        (self.bltree, _BL_CODES)):
            tree.fc[:n] = [0] * n
        self.ltree.fc[_END_BLOCK] = 1
        self.opt_len = self.static_len = 0
        self.sym_dist = []
        self.sym_lc = []

    def tally_lit(self, c: int) -> bool:
        self.sym_dist.append(0)
        self.sym_lc.append(c)
        self.ltree.fc[c] += 1
        return len(self.sym_lc) == LIT_BUFSIZE - 1

    def tally_dist(self, dist: int, lc: int) -> bool:
        self.sym_dist.append(dist)
        self.sym_lc.append(lc)
        self.ltree.fc[LENGTH_CODE[lc] + _LITERALS + 1] += 1
        self.dtree.fc[d_code(dist - 1)] += 1
        return len(self.sym_lc) == LIT_BUFSIZE - 1

    def _smaller(self, fc, n: int, m: int) -> bool:
        return fc[n] < fc[m] or (fc[n] == fc[m]
                                 and self.depth[n] <= self.depth[m])

    def _pqdownheap(self, fc, k: int) -> None:
        heap = self.heap
        v = heap[k]
        j = k << 1
        while j <= self.heap_len:
            if j < self.heap_len and self._smaller(fc, heap[j + 1], heap[j]):
                j += 1
            if self._smaller(fc, v, heap[j]):
                break
            heap[k] = heap[j]
            k = j
            j <<= 1
        heap[k] = v

    def _gen_bitlen(self, tree: _Tree) -> None:
        fc, dl, heap = tree.fc, tree.dl, self.heap
        bl_count = self.bl_count
        max_code, max_length = tree.max_code, tree.max_length
        for b in range(_MAX_BITS + 1):
            bl_count[b] = 0
        dl[heap[self.heap_max]] = 0
        overflow = 0
        h = self.heap_max + 1
        while h < _HEAP_SIZE:
            n = heap[h]
            h += 1
            bits = dl[dl[n]] + 1
            if bits > max_length:
                bits = max_length
                overflow += 1
            dl[n] = bits
            if n > max_code:
                continue
            bl_count[bits] += 1
            xbits = tree.extra[n - tree.base] if n >= tree.base else 0
            f = fc[n]
            self.opt_len += f * (bits + xbits)
            if tree.static_len is not None:
                self.static_len += f * (tree.static_len[n] + xbits)
        if overflow == 0:
            return
        while overflow > 0:
            bits = max_length - 1
            while bl_count[bits] == 0:
                bits -= 1
            bl_count[bits] -= 1
            bl_count[bits + 1] += 2
            bl_count[max_length] -= 1
            overflow -= 2
        h = _HEAP_SIZE
        for bits in range(max_length, 0, -1):
            n = bl_count[bits]
            while n != 0:
                h -= 1
                m = heap[h]
                if m > max_code:
                    continue
                if dl[m] != bits:
                    self.opt_len += (bits - dl[m]) * fc[m]
                    dl[m] = bits
                n -= 1

    def _build_tree(self, tree: _Tree) -> None:
        fc, dl, heap, depth = tree.fc, tree.dl, self.heap, self.depth
        max_code = -1
        self.heap_len, self.heap_max = 0, _HEAP_SIZE
        for n in range(tree.elems):
            if fc[n]:
                self.heap_len += 1
                heap[self.heap_len] = max_code = n
                depth[n] = 0
            else:
                dl[n] = 0
        while self.heap_len < 2:
            if max_code < 2:
                max_code += 1
                node = max_code
            else:
                node = 0
            self.heap_len += 1
            heap[self.heap_len] = node
            fc[node] = 1
            depth[node] = 0
            self.opt_len -= 1
            if tree.static_len is not None:
                self.static_len -= tree.static_len[node]
        tree.max_code = max_code
        for n in range(self.heap_len // 2, 0, -1):
            self._pqdownheap(fc, n)
        node = tree.elems
        while True:
            n = heap[1]
            heap[1] = heap[self.heap_len]
            self.heap_len -= 1
            self._pqdownheap(fc, 1)
            m = heap[1]
            self.heap_max -= 1
            heap[self.heap_max] = n
            self.heap_max -= 1
            heap[self.heap_max] = m
            fc[node] = (fc[n] + fc[m]) & 0xFFFF
            depth[node] = max(depth[n], depth[m]) + 1
            dl[n] = dl[m] = node
            heap[1] = node
            node += 1
            self._pqdownheap(fc, 1)
            if self.heap_len < 2:
                break
        self.heap_max -= 1
        heap[self.heap_max] = heap[1]
        self._gen_bitlen(tree)
        _gen_codes(dl, fc, max_code, self.bl_count)

    @staticmethod
    def _runs(dl, max_code: int):
        """scan_tree's and send_tree's walk: (kind, curlen, count) where
        kind is 'lens' (count codes of curlen), 'rep', 'repz'."""
        prevlen, nextlen, count = -1, dl[0], 0
        max_count, min_count = (138, 3) if nextlen == 0 else (7, 4)
        for n in range(max_code + 1):
            curlen, nextlen = nextlen, dl[n + 1]
            count += 1
            if count < max_count and curlen == nextlen:
                continue
            if count < min_count:
                yield 'lens', curlen, count, prevlen
            elif curlen != 0:
                yield 'rep', curlen, count, prevlen
            else:
                yield 'repz', curlen, count, prevlen
            count, prevlen = 0, curlen
            if nextlen == 0:
                max_count, min_count = 138, 3
            elif curlen == nextlen:
                max_count, min_count = 6, 3
            else:
                max_count, min_count = 7, 4

    def _scan_tree(self, tree: _Tree) -> None:
        tree.dl[tree.max_code + 1] = 0xFFFF        # guard
        blf = self.bltree.fc
        for kind, curlen, count, prevlen in self._runs(tree.dl,
                                                       tree.max_code):
            if kind == 'lens':
                blf[curlen] += count
            elif kind == 'rep':
                if curlen != prevlen:
                    blf[curlen] += 1
                blf[_REP_3_6] += 1
            elif count <= 10:
                blf[_REPZ_3_10] += 1
            else:
                blf[_REPZ_11_138] += 1

    def _send_tree(self, tree: _Tree, max_code: int) -> None:
        code, length, send = self.bltree.fc, self.bltree.dl, self.bits.send
        for kind, curlen, count, prevlen in self._runs(tree.dl, max_code):
            if kind == 'lens':
                for _ in range(count):
                    send(code[curlen], length[curlen])
            elif kind == 'rep':
                if curlen != prevlen:
                    send(code[curlen], length[curlen])
                    count -= 1
                send(code[_REP_3_6], length[_REP_3_6])
                send(count - 3, 2)
            elif count <= 10:
                send(code[_REPZ_3_10], length[_REPZ_3_10])
                send(count - 3, 3)
            else:
                send(code[_REPZ_11_138], length[_REPZ_11_138])
                send(count - 11, 7)

    def _build_bl_tree(self) -> int:
        self._scan_tree(self.ltree)
        self._scan_tree(self.dtree)
        self._build_tree(self.bltree)
        max_blindex = _BL_CODES - 1
        while max_blindex >= 3:
            if self.bltree.dl[_BL_ORDER[max_blindex]] != 0:
                break
            max_blindex -= 1
        self.opt_len += 3 * (max_blindex + 1) + 5 + 5 + 4
        return max_blindex

    def _compress_block(self, lcode, llen, dcode, dlen) -> None:
        send = self.bits.send
        for dist, lc in zip(self.sym_dist, self.sym_lc):
            if dist == 0:
                send(lcode[lc], llen[lc])
                continue
            code = LENGTH_CODE[lc]
            send(lcode[code + _LITERALS + 1], llen[code + _LITERALS + 1])
            extra = EXTRA_LBITS[code]
            if extra:
                send(lc - BASE_LENGTH[code], extra)
            dist -= 1
            code = d_code(dist)
            send(dcode[code], dlen[code])
            extra = EXTRA_DBITS[code]
            if extra:
                send(dist - BASE_DIST[code], extra)
        send(lcode[_END_BLOCK], llen[_END_BLOCK])

    def stored_block(self, buf, last: bool) -> None:
        self.bits.send(int(last), 3)
        self.bits.windup()
        n = len(buf)
        self.bits.out += bytes((n & 255, n >> 8, ~n & 255, (~n >> 8) & 255))
        self.bits.out += buf

    def flush_block(self, buf, stored_len: int, last: bool) -> None:
        """_tr_flush_block: stored (while ``buf``, the block's bytes, is
        still in the window), fixed or dynamic, the shortest."""
        self._build_tree(self.ltree)
        self._build_tree(self.dtree)
        max_blindex = self._build_bl_tree()
        opt_lenb = (self.opt_len + 3 + 7) >> 3
        static_lenb = (self.static_len + 3 + 7) >> 3
        if static_lenb <= opt_lenb:
            opt_lenb = static_lenb
        if stored_len + 4 <= opt_lenb and buf is not None:
            self.stored_block(buf, last)
        elif static_lenb == opt_lenb:
            self.bits.send(2 + int(last), 3)
            self._compress_block(_SLTREE_CODE, _SLTREE_LEN, _SDTREE_CODE,
                                 _SDTREE_LEN)
        else:
            send = self.bits.send
            send(4 + int(last), 3)
            lcodes, dcodes = self.ltree.max_code + 1, self.dtree.max_code + 1
            send(lcodes - 257, 5)
            send(dcodes - 1, 5)
            send(max_blindex + 1 - 4, 4)
            for rank in range(max_blindex + 1):
                send(self.bltree.dl[_BL_ORDER[rank]], 3)
            self._send_tree(self.ltree, lcodes - 1)
            self._send_tree(self.dtree, dcodes - 1)
            self._compress_block(self.ltree.fc, self.ltree.dl, self.dtree.fc,
                                 self.dtree.dl)
        self.init_block()
        if last:
            self.bits.windup()


class _Deflate:
    """deflate.c's matcher state over a 64 KiB window."""

    def __init__(self, src: bytes, level: int, trees: _Trees):
        self.src = src
        self.n = len(src)
        self.in_pos = 0
        self.trees = trees
        (self.good_match, self.max_lazy, self.nice_match,
         self.max_chain) = CONFIG[level]
        self.window = bytearray(_WINDOW + 8)
        self.head = [0] * (_HASH_MASK + 1)
        self.prev = [0] * WSIZE
        self.strstart = self.lookahead = self.match_start = 0
        self.match_length = self.prev_length = MIN_MATCH - 1
        self.prev_match = 0
        self.match_available = False
        self.block_start = 0
        self.slid = 0          # input position of window[0]
        # each input position's hash, where its 4 bytes are all input
        a = np.frombuffer(src, np.uint8).astype(np.uint32)
        v = a[:-3] | (a[1:-2] << 8) | (a[2:-1] << 16) | (a[3:] << 24)
        self.hashes = ((((v.astype(np.uint64) * 66521 + 66521)
                         & 0xFFFFFFFF) >> 16) & _HASH_MASK).tolist()

    def insert(self, s: int) -> int:
        """insert_string with Chromium's hash of the 4 window bytes at s."""
        p = s + self.slid
        if p + 3 < self.n:
            h = self.hashes[p]
        else:
            w = self.window
            v = w[s] | (w[s + 1] << 8) | (w[s + 2] << 16) | (w[s + 3] << 24)
            h = (((v * 66521 + 66521) & 0xFFFFFFFF) >> 16) & _HASH_MASK
        ret = self.head[h]
        self.prev[s & _WMASK] = ret
        self.head[h] = s
        return ret

    def fill_window(self) -> None:
        while True:
            more = _WINDOW - self.lookahead - self.strstart
            if self.strstart >= WSIZE + MAX_DIST:
                w = self.window
                w[:WSIZE - more] = w[WSIZE:2 * WSIZE - more]
                self.match_start -= WSIZE
                self.strstart -= WSIZE
                self.block_start -= WSIZE
                self.slid += WSIZE
                self.head = [m - WSIZE if m >= WSIZE else 0
                             for m in self.head]
                self.prev = [m - WSIZE if m >= WSIZE else 0
                             for m in self.prev]
                more += WSIZE
            if self.in_pos == self.n:
                break
            k = min(self.n - self.in_pos, more)
            at = self.strstart + self.lookahead
            self.window[at:at + k] = self.src[self.in_pos:self.in_pos + k]
            self.in_pos += k
            self.lookahead += k
            if not (self.lookahead < _MIN_LOOKAHEAD and self.in_pos < self.n):
                break

    def longest_match(self, cur_match: int) -> int:
        w, prev = self.window, self.prev
        s = self.strstart
        chain_length = self.max_chain
        best_len = self.prev_length
        nice_match = min(self.nice_match, self.lookahead)
        limit = s - MAX_DIST if s > MAX_DIST else 0
        scan_end1, scan_end = w[s + best_len - 1], w[s + best_len]
        if self.prev_length >= self.good_match:
            chain_length >>= 2
        while True:
            m = cur_match
            if (w[m + best_len] == scan_end and w[m + best_len - 1] ==
                    scan_end1 and w[m] == w[s] and w[m + 1] == w[s + 1]):
                # bytes 3 on (zlib skips byte 2), to at most 258
                length = 3
                while length < MAX_MATCH:
                    step = min(8, MAX_MATCH - length)
                    if w[s + length:s + length + step] != \
                            w[m + length:m + length + step]:
                        while w[s + length] == w[m + length]:
                            length += 1
                        break
                    length += step
                if length > best_len:
                    self.match_start = cur_match
                    best_len = length
                    if length >= nice_match:
                        break
                    scan_end1, scan_end = w[s + best_len - 1], w[s + best_len]
            cur_match = prev[cur_match & _WMASK]
            if cur_match <= limit:
                break
            chain_length -= 1
            if chain_length == 0:
                break
        return min(best_len, self.lookahead)

    def flush(self, last: bool) -> None:
        bs = self.block_start
        buf = (bytes(self.window[bs:self.strstart]) if bs >= 0 else None)
        self.trees.flush_block(buf, self.strstart - bs, last)
        self.block_start = self.strstart

    def deflate_fast(self) -> None:
        trees, w = self.trees, self.window
        while True:
            if self.lookahead < _MIN_LOOKAHEAD:
                self.fill_window()
                if self.lookahead == 0:
                    break
            hash_head = 0
            if self.lookahead >= MIN_MATCH:
                hash_head = self.insert(self.strstart)
            if hash_head and self.strstart - hash_head <= MAX_DIST:
                self.match_length = self.longest_match(hash_head)
            if self.match_length >= MIN_MATCH:
                bflush = trees.tally_dist(self.strstart - self.match_start,
                                          self.match_length - MIN_MATCH)
                self.lookahead -= self.match_length
                if (self.match_length <= self.max_lazy
                        and self.lookahead >= MIN_MATCH):
                    for _ in range(self.match_length - 1):
                        self.strstart += 1
                        self.insert(self.strstart)
                    self.strstart += 1
                else:
                    self.strstart += self.match_length
                self.match_length = 0
            else:
                bflush = trees.tally_lit(w[self.strstart])
                self.lookahead -= 1
                self.strstart += 1
            if bflush:
                self.flush(False)
        self.flush(True)

    def deflate_slow(self) -> None:
        trees, w = self.trees, self.window
        while True:
            if self.lookahead < _MIN_LOOKAHEAD:
                self.fill_window()
                if self.lookahead == 0:
                    break
            hash_head = 0
            if self.lookahead >= MIN_MATCH:
                hash_head = self.insert(self.strstart)
            self.prev_length = self.match_length
            self.prev_match = self.match_start
            self.match_length = MIN_MATCH - 1
            if (hash_head and self.prev_length < self.max_lazy
                    and self.strstart - hash_head <= MAX_DIST):
                self.match_length = self.longest_match(hash_head)
                if (self.match_length == MIN_MATCH and
                        self.strstart - self.match_start > _TOO_FAR):
                    self.match_length = MIN_MATCH - 1
            if (self.prev_length >= MIN_MATCH
                    and self.match_length <= self.prev_length):
                max_insert = self.strstart + self.lookahead - MIN_MATCH
                bflush = trees.tally_dist(self.strstart - 1 - self.prev_match,
                                          self.prev_length - MIN_MATCH)
                self.lookahead -= self.prev_length - 1
                for _ in range(self.prev_length - 2):
                    self.strstart += 1
                    if self.strstart <= max_insert:
                        self.insert(self.strstart)
                self.prev_length = 0
                self.match_available = False
                self.match_length = MIN_MATCH - 1
                self.strstart += 1
                if bflush:
                    self.flush(False)
            elif self.match_available:
                if trees.tally_lit(w[self.strstart - 1]):
                    self.flush(False)
                self.strstart += 1
                self.lookahead -= 1
            else:
                self.match_available = True
                self.strstart += 1
                self.lookahead -= 1
        if self.match_available:
            trees.tally_lit(w[self.strstart - 1])
            self.match_available = False
        self.flush(True)


def adler32(src: bytes) -> int:
    """The adler32 of ``src`` (RFC 1950)."""
    a = np.frombuffer(src, np.uint8).astype(np.int64)
    n = a.size
    s1 = (1 + int(a.sum())) % 65521
    s2 = (n + int((a * np.arange(n, 0, -1, dtype=np.int64)).sum())) % 65521
    return (s2 << 16) | s1


def compress(src: bytes, clevel: int = 5, cap: Optional[int] = None) -> bytes:
    """One zlib stream of ``src`` at level ``clevel`` (0-9), or ``b''``
    when it is longer than ``cap`` bytes (``compress2`` then fails, and
    c-blosc stores the stream)."""
    if not 0 <= clevel <= 9:
        raise ValueError(f"zlib level {clevel} is not in 0..9")
    src = bytes(src)
    bits = _Bits()
    flevel = 0 if clevel < 2 else 1 if clevel < 6 else 2 if clevel == 6 else 3
    header = (0x78 << 8) | (flevel << 6)
    header += 31 - header % 31
    bits.out += header.to_bytes(2, 'big')
    trees = _Trees(bits)
    if clevel == 0:
        pos = 0
        while True:
            k = min(len(src) - pos, _MAX_STORED)
            trees.stored_block(src[pos:pos + k], pos + k == len(src))
            pos += k
            if pos >= len(src):
                break
    else:
        state = _Deflate(src, clevel, trees)
        if clevel <= 3:
            state.deflate_fast()
        else:
            state.deflate_slow()
    bits.out += adler32(src).to_bytes(4, 'big')
    if cap is not None and len(bits.out) > cap:
        return b''
    return bytes(bits.out)
