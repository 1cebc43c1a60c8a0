"""Blosc1 frames with every codec tensorstore writes: the port's chunk
codec.

The counterpart of the c-blosc 1.x that tensorstore links for the JAX
package's compressed chunks (zarr v2 ``{"id": "blosc", "cname": ...}``
and the zarr v3 ``blosc`` codec), for the cnames ``blosclz``, ``lz4``,
``lz4hc``, ``snappy``, ``zlib`` and ``zstd``, byte shuffle, bit shuffle
or none. The frame layer and every codec but zlib are C, written by hand
(``csrc/blosc.c`` and the ``csrc/codec_*.h`` it includes), built at
first use with the system C compiler (:func:`image_stitcher_tpu_torch.
native.load`) and called through :mod:`ctypes`, which releases the
interpreter lock, so the zarr writers encode one chunk per thread. zlib
streams go through the stdlib's :mod:`zlib` (which releases it too),
the C frame layer shuffling their blocks. This module holds the
bindings and the plain version of the same frames in NumPy and Python
(``*_plain``; the codecs' own in ``blosclz_plain``, ``snappy_plain`` and
``zstd_plain``, LZ4 and LZ4HC here), which the tests hold the C codecs
to, byte for byte; the writers never run a plain version, and a codec
that cannot be built raises.

The frame (c-blosc 1.x, as tensorstore writes it):
- a 16-byte header: format version 2, the codec's format version 1,
  flags (0x01 byte shuffle, 0x02 memcpyed, 0x04 bit shuffle, 0x10
  blocks not split, the compressor code in bits 5-7: 0 blosclz, 1 LZ4
  (lz4 and lz4hc), 2 snappy, 3 zlib, 4 zstd), the type size, then the
  uncompressed size, the block size and the frame's size as u32 LE;
- the input cut into blocks of ``blosc_blocksize(clevel, typesize,
  nbytes, cname)`` bytes (c-blosc's rule: 32 KiB scaled by clevel,
  doubled for lz4hc, zlib and zstd and again at their clevel 9; a split
  block times the type size within [64 KiB, 1 MiB]), the last one
  shorter when the size is not a multiple; an i32 offset of each block's
  data from the frame's start;
- each block byte-shuffled (byte j of element i goes to j * n + i; a
  tail that is not a whole element stays as it is) or bit-shuffled
  (with n elements a multiple of 8, bit b of byte j of element i goes to
  bit i % 8 of byte (8 j + b) n / 8 + i / 8 and a tail that is not a
  whole element stays; with n not a multiple of 8 the block stays as it
  is), shuffle -1 meaning bit shuffle for 1-byte types and byte shuffle
  otherwise; then cut into ``typesize`` streams of equal length (one
  stream when the block is the short last one, or when c-blosc's split
  rule says no: zstd, typesize > 16 or block / typesize < 128); each
  stream is an i32 size and the codec's stream, or the stream's bytes as
  they are when the codec does not make it shorter (size equal to the
  stream's length); a codec's stream may take at most the stream's
  length, snappy's at most 32 + n + n / 6;
- a frame that would be longer than the input plus its header, an input
  under 128 bytes, or clevel 0 is ``memcpyed``: flag 0x02 and the input
  after the header.

The codecs' streams: LZ4 blocks for code 1 (the two matchers below),
blosclz (``blosclz_plain``), raw snappy (``snappy_plain``), zlib
(``zlib.compress(stream, clevel)``) and one zstd frame
(``zstd_plain``). The decoders read any valid frame of these settings,
whoever wrote it; a compressor code 5-7 raises :class:`CodecError`
naming it.

The LZ4 matchers (the same in C and here; the format leaves them free, so
these rules are what makes the two byte-equal):
- positions p <= n - 12 may start a match (a block under 13 bytes is
  all literals), which extends while the bytes agree, up to n - 5 (the
  last 5 bytes are always literals); a candidate is taken when its 4
  bytes equal p's and p - candidate <= 65535; no backward extension;
- 'lz4': the 4 bytes at p, read as a little-endian u32 ``seq``, hash to
  ``(seq * 2654435761 mod 2**32) >> 20``: a 4096-entry table holds the
  last position seen with each hash, empty (-1) at each block start; the
  table entry is read, then set to p; after a miss p advances by
  ``search >> 6``, then ``search += 1``; ``search`` starts at ``accel <<
  6`` and is reset after each match, with ``accel = max(1, 10 -
  clevel)`` (c-blosc's LZ4 acceleration); after a match ending at e,
  position e - 2 is entered in the table and the search goes on at e;
- 'lz4hc': the hash is ``>> 17`` (32768 entries); each position also
  records its distance to the previous position with its hash (0 when
  none within 65535 bytes); before the search at p every position below
  p is entered; the search walks at most ``2 ** (clevel - 1)``
  candidates from the newest and keeps the longest match (the nearest of
  equal length); p advances by one after a miss.
Sequences are encoded as the LZ4 block format says (token nibbles,
255-continued lengths, u16 LE offsets); the decoders read any valid LZ4
block, including overlapping matches and the block-splitting choices of
other encoders.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Callable, Optional

import numpy as np

OVERHEAD = 16
_MIN_BUFFERSIZE = 128
_FLAG_SHUFFLE, _FLAG_MEMCPYED, _FLAG_BITSHUFFLE = 0x01, 0x02, 0x04
_FLAG_DONT_SPLIT = 0x10
_HASH_LOG = 12
_HC_HASH_LOG = 15

#: the cnames tensorstore accepts, in the C library's codec-id order
CNAMES = ('blosclz', 'lz4', 'lz4hc', 'snappy', 'zlib', 'zstd')
_CODE = {'blosclz': 0, 'lz4': 1, 'lz4hc': 1, 'snappy': 2, 'zlib': 3,
         'zstd': 4}
_CODE_NAME = {0: 'blosclz', 1: 'lz4', 2: 'snappy', 3: 'zlib', 4: 'zstd'}
#: codecs with c-blosc's larger blocks
_HCR = ('lz4hc', 'zlib', 'zstd')
_SHUFFLES = (-1, 0, 1, 2)

_LIB: Optional[ctypes.CDLL] = None


def lib() -> ctypes.CDLL:
    """The C codecs, built and bound on first use (raises when no C
    compiler can build them)."""
    global _LIB
    if _LIB is None:
        from ..native import load
        so = load('blosc')
        i64, vp, ci = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
        so.blosc_compress.argtypes = [ci, ci, ci, i64, vp, i64, vp, i64]
        so.blosc_decompress.argtypes = [vp, i64, vp, i64]
        so.blosc_shuffle_blocks.argtypes = [ci, ci, ci, i64, vp, i64, vp, vp]
        so.blosc_unshuffle_blocks.argtypes = [ci, i64, i64, vp, i64, vp]
        so.all_zero.argtypes = [vp, i64]
        so.all_zero.restype = ci
        funcs = [so.blosc_compress, so.blosc_decompress,
                 so.blosc_shuffle_blocks, so.blosc_unshuffle_blocks]
        for name in _STREAM_ENC.values():
            getattr(so, name).argtypes = [vp, i64, vp, i64, ci]
            funcs.append(getattr(so, name))
        for name in _STREAM_DEC.values():
            getattr(so, name).argtypes = [vp, i64, vp, i64]
            funcs.append(getattr(so, name))
        for f in funcs:
            f.restype = i64
        _LIB = so
    return _LIB


class CodecError(ValueError):
    """A frame or stream the codec cannot decode (corrupt, or of a
    compressor this codec does not know)."""


_ERRORS = {-1: "bad arguments", -2: "corrupt frame", -3:
           "unsupported frame", -4: "out of memory"}

_STREAM_ENC = {'blosclz': 'blosclz_compress', 'lz4': 'lz4_compress_block',
               'lz4hc': 'lz4hc_compress_block', 'snappy': 'snappy_compress',
               'zstd': 'zstd_compress'}
_STREAM_DEC = {'blosclz': 'blosclz_decompress',
               'lz4': 'lz4_decompress_block', 'snappy': 'snappy_decompress',
               'zstd': 'zstd_decompress'}


def check_settings(cname: str, clevel: int, shuffle: int) -> None:
    """Raise ValueError for a cname, clevel or shuffle blosc refuses."""
    if cname not in CNAMES:
        raise ValueError(f"blosc cname {cname!r} is not one of {CNAMES}")
    if not 0 <= int(clevel) <= 9:
        raise ValueError(f"blosc clevel {clevel} is not in 0..9")
    if int(shuffle) not in _SHUFFLES:
        raise ValueError(f"blosc shuffle {shuffle} is not -1, 0, 1 or 2")


def _as_bytes(data) -> np.ndarray:
    """A C-contiguous uint8 view of ``data`` (bytes-like or an array)."""
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data).reshape(-1).view(np.uint8)
    return np.frombuffer(data, np.uint8)


def compress(data, typesize: int, clevel: int = 5, shuffle: int = 1,
             cname: str = 'lz4') -> memoryview:
    """One blosc frame of ``data`` (its bytes, C order): in C, zlib's
    streams through the stdlib. The result is a view of a fresh
    buffer."""
    check_settings(cname, clevel, shuffle)
    src = _as_bytes(data)
    if cname == 'zlib':
        return memoryview(_zlib_compress(src, int(typesize), int(clevel),
                                         int(shuffle)))
    dest = np.empty(src.size + OVERHEAD, np.uint8)
    n = lib().blosc_compress(CNAMES.index(cname), int(clevel), int(shuffle),
                             int(typesize), src.ctypes.data, src.size,
                             dest.ctypes.data, dest.size)
    if n < 0:
        raise CodecError(f"blosc-{cname} compress: {_ERRORS.get(n, n)}")
    return memoryview(dest)[:n]


def _header(src: np.ndarray):
    if src.size < OVERHEAD:
        raise CodecError("blosc frame shorter than its header")
    return struct.unpack_from('<BBBBiii', src)


def _check_code(flags: int) -> int:
    code = flags >> 5
    if code not in _CODE_NAME:
        raise CodecError(f"unsupported frame: blosc compressor code {code} "
                         "names no codec (0 blosclz, 1 lz4, 2 snappy, "
                         "3 zlib, 4 zstd)")
    return code


def decompress(frame, out: Optional[np.ndarray] = None) -> np.ndarray:
    """Decode one frame of any codec, in C (zlib's streams through the
    stdlib), into ``out`` (a C-contiguous array of the frame's size in
    bytes) or a new uint8 array."""
    src = _as_bytes(frame)
    _, _, flags, _, nbytes, _, _ = _header(src)
    if out is None:
        out = np.empty(max(nbytes, 0), np.uint8)
    if not out.flags.c_contiguous or out.nbytes != nbytes:
        raise CodecError(f"blosc frame holds {nbytes} bytes, the "
                         f"destination {out.nbytes}")
    code = 1 if flags & _FLAG_MEMCPYED else _check_code(flags)
    if code == 3:
        _zlib_decompress(src, out.reshape(-1).view(np.uint8))
        return out
    n = lib().blosc_decompress(src.ctypes.data, src.size,
                               out.ctypes.data, out.nbytes)
    if n != nbytes:
        raise CodecError(f"blosc-{_CODE_NAME.get(flags >> 5, flags >> 5)} "
                         "decompress: "
                         f"{_ERRORS.get(n, n)}")
    return out


def all_zero(data: np.ndarray) -> bool:
    """True when every byte of the C-contiguous ``data`` is zero."""
    return bool(lib().all_zero(data.ctypes.data, data.nbytes))


def stream_compress(cname: str, data, clevel: int = 5) -> bytes:
    """One stream of ``data`` as the cname's codec writes it inside a
    frame (an LZ4 block, a blosclz or snappy stream, a zstd frame), in
    C; raises when it does not fit in its worst case."""
    src = _as_bytes(data)
    cap = 2 * src.size + 1024
    dest = np.empty(cap, np.uint8)
    n = getattr(lib(), _STREAM_ENC[cname])(src.ctypes.data, src.size,
                                          dest.ctypes.data, cap, int(clevel))
    if n <= 0 and src.size:
        raise CodecError(f"{cname} compress: {_ERRORS.get(n, n)}")
    return dest[:max(n, 0)].tobytes()


def stream_decompress(cname: str, stream, nbytes: int) -> bytes:
    """Decode one stream of the cname's codec holding exactly ``nbytes``
    bytes, in C."""
    src = _as_bytes(stream)
    dest = np.empty(max(nbytes, 1), np.uint8)
    n = getattr(lib(), _STREAM_DEC['lz4' if cname == 'lz4hc' else cname])(
        src.ctypes.data, src.size, dest.ctypes.data, nbytes)
    if n != nbytes:
        raise CodecError(f"corrupt {cname} stream")
    return dest[:nbytes].tobytes()


def lz4_compress_block(data, clevel: int = 5) -> bytes:
    """One LZ4 block of ``data`` in C (the fast matcher)."""
    return stream_compress('lz4', data, clevel)


def lz4_decompress_block(block, nbytes: int) -> bytes:
    """Decode one LZ4 block of exactly ``nbytes`` bytes, in C."""
    try:
        return stream_decompress('lz4', block, nbytes)
    except CodecError:
        raise CodecError("corrupt LZ4 block") from None


# ------------------------------------------------------------------- zlib

def _zlib_compress(src: np.ndarray, typesize: int, clevel: int,
                   shuffle: int) -> bytes:
    """A zlib frame: blocks shuffled by the C frame layer, streams
    through :func:`zlib.compress`."""
    if typesize < 1 or typesize > 255:
        raise CodecError("blosc-zlib compress: bad arguments")
    blocks = np.empty(src.size, np.uint8)
    params = np.zeros(3, np.int64)
    rc = lib().blosc_shuffle_blocks(CNAMES.index('zlib'), clevel, shuffle,
                                    typesize, src.ctypes.data, src.size,
                                    blocks.ctypes.data, params.ctypes.data)
    if rc < 0:
        raise CodecError(f"blosc-zlib compress: {_ERRORS.get(rc, rc)}")
    flags, bs, split = (int(v) for v in params)
    return _assemble(src.tobytes(), blocks.tobytes(), typesize, clevel,
                     'zlib', flags, bs, bool(split))


def _zlib_decompress(src: np.ndarray, out: np.ndarray) -> None:
    """Decode a zlib frame into the uint8 array ``out``: streams through
    :func:`zlib.decompress`, blocks unshuffled by the C frame layer."""
    _, _, flags, ts, nbytes, bs, _ = _header(src)
    shuffled = flags & (_FLAG_SHUFFLE | _FLAG_BITSHUFFLE)
    tmp = np.empty(nbytes, np.uint8) if shuffled else out
    _decode_blocks(src.tobytes(), memoryview(tmp), _zlib_stream)
    if shuffled:
        rc = lib().blosc_unshuffle_blocks(flags, ts, bs, tmp.ctypes.data,
                                          nbytes, out.ctypes.data)
        if rc < 0:
            raise CodecError("corrupt frame")


def _zlib_stream(stream: bytes, nbytes: int) -> bytes:
    try:
        got = zlib.decompress(stream, bufsize=max(nbytes, 1))
    except zlib.error:
        raise CodecError("corrupt zlib stream") from None
    if len(got) != nbytes:
        raise CodecError("corrupt zlib stream")
    return got


# ------------------------------------------------------------- plain version

def _accel(clevel: int) -> int:
    return max(1, 10 - int(clevel))


def blosc_blocksize(clevel: int, typesize: int, nbytes: int,
                    cname: str = 'lz4') -> int:
    """c-blosc 1.x's block size with no forced size."""
    if nbytes < typesize:
        return 1
    hcr = cname in _HCR
    cl = min(max(clevel, 0), 9)
    bs = nbytes
    if nbytes >= 32 * 1024:
        factor_x4 = (1, 2, 4, 8, 16, 16, 32, 32, 32, 32)
        bs = 32 * 1024 * (2 if hcr else 1) * factor_x4[cl] // 4
        if cl == 9 and hcr:
            bs *= 2
    if clevel > 0 and _split(typesize, bs, cname):
        bs = min(bs, 1 << 18) * typesize
        bs = min(max(bs, 1 << 16), 1 << 20)
    bs = min(bs, nbytes)
    if bs > typesize:
        bs = bs // typesize * typesize
    return bs


def _split(typesize: int, blocksize: int, cname: str = 'lz4') -> bool:
    return (cname != 'zstd' and typesize <= 16
            and blocksize // typesize >= _MIN_BUFFERSIZE)


def _resolve_shuffle(shuffle: int, typesize: int) -> int:
    return (2 if typesize == 1 else 1) if shuffle < 0 else shuffle


def shuffle_plain(block: bytes, typesize: int) -> bytes:
    a = np.frombuffer(block, np.uint8)
    ne = a.size // typesize
    head = a[:ne * typesize].reshape(ne, typesize).T.reshape(-1)
    return head.tobytes() + a[ne * typesize:].tobytes()


def unshuffle_plain(block: bytes, typesize: int) -> bytes:
    a = np.frombuffer(block, np.uint8)
    ne = a.size // typesize
    head = a[:ne * typesize].reshape(typesize, ne).T.reshape(-1)
    return head.tobytes() + a[ne * typesize:].tobytes()


def bitshuffle_plain(block: bytes, typesize: int) -> bytes:
    """c-blosc 1.x's bit shuffle of one block (see the module
    docstring)."""
    a = np.frombuffer(block, np.uint8)
    ne = a.size // typesize
    if ne % 8:
        return bytes(block)
    bits = np.unpackbits(a[:ne * typesize].reshape(ne, typesize), axis=1,
                         bitorder='little').reshape(ne, typesize * 8)
    rows = np.packbits(bits.T, axis=1, bitorder='little').reshape(-1)
    return rows.tobytes() + a[ne * typesize:].tobytes()


def bitunshuffle_plain(block: bytes, typesize: int) -> bytes:
    a = np.frombuffer(block, np.uint8)
    ne = a.size // typesize
    if ne % 8:
        return bytes(block)
    rows = a[:ne * typesize].reshape(typesize * 8, ne // 8)
    bits = np.unpackbits(rows, axis=1, bitorder='little')
    elems = np.packbits(bits.T.reshape(ne, typesize, 8), axis=2,
                        bitorder='little').reshape(-1)
    return elems.tobytes() + a[ne * typesize:].tobytes()


def _common(a: np.ndarray, i: int, j: int, limit: int) -> int:
    """How many bytes a[i:] and a[j:] agree on, i bounded by limit."""
    n, step = 0, 16
    while i + n < limit:
        m = min(step, limit - i - n)
        neq = np.flatnonzero(a[i + n:i + n + m] != a[j + n:j + n + m])
        if neq.size:
            return n + int(neq[0])
        n += m
        step = min(step * 8, 1 << 20)
    return n


def _hashes(src: bytes, log: int, mult: int = 2654435761):
    """(seq, hash) lists of the 4 bytes at every position of ``src``."""
    w = np.frombuffer(src, np.uint8).astype(np.uint32)
    seq = w[:-3] | (w[1:-2] << 8) | (w[2:-1] << 16) | (w[3:] << 24)
    hashes = (((seq.astype(np.uint64) * mult) & 0xFFFFFFFF) >> (32 - log))
    return seq.tolist(), hashes.tolist()


def _put_length(out: bytearray, length: int) -> None:
    length -= 15
    while length >= 255:
        out.append(255)
        length -= 255
    out.append(length)


def _emit(out: bytearray, src: bytes, anchor: int, litlen: int,
          offset: int, mlen: int) -> None:
    m = mlen - 4
    out.append((min(litlen, 15) << 4) | (min(m, 15) if mlen else 0))
    if litlen >= 15:
        _put_length(out, litlen)
    out += src[anchor:anchor + litlen]
    if mlen:
        out += struct.pack('<H', offset)
        if m >= 15:
            _put_length(out, m)


def lz4_compress_block_plain(src: bytes, clevel: int = 5) -> bytes:
    """One LZ4 block of ``src``: the fast matcher of the module
    docstring."""
    n = len(src)
    out = bytearray()
    anchor = ip = 0
    if n >= 13:
        a = np.frombuffer(src, np.uint8)
        seq, hashes = _hashes(src, _HASH_LOG)
        table = [-1] * (1 << _HASH_LOG)
        mflimit, matchlimit = n - 12, n - 5
        start = _accel(clevel) << 6
        search = start
        while ip <= mflimit:
            h = hashes[ip]
            ref = table[h]
            table[h] = ip
            if ref >= 0 and ip - ref <= 65535 and seq[ref] == seq[ip]:
                length = 4 + _common(a, ip + 4, ref + 4, matchlimit)
                _emit(out, src, anchor, ip - anchor, ip - ref, length)
                ip += length
                anchor = ip
                table[hashes[ip - 2]] = ip - 2
                search = start
            else:
                ip += search >> 6
                search += 1
    _emit(out, src, anchor, n - anchor, 0, 0)
    return bytes(out)


def lz4hc_compress_block_plain(src: bytes, clevel: int = 5) -> bytes:
    """One LZ4 block of ``src``: the hash-chain matcher of the module
    docstring."""
    n = len(src)
    out = bytearray()
    anchor = ip = 0
    if n >= 13:
        a = np.frombuffer(src, np.uint8)
        seq, hashes = _hashes(src, _HC_HASH_LOG)
        head = [-1] * (1 << _HC_HASH_LOG)
        chain = [0] * 65536
        depth = 1 << (min(max(int(clevel), 1), 9) - 1)
        mflimit, matchlimit = n - 12, n - 5
        nxt = 0
        while ip <= mflimit:
            while nxt < ip:
                h = hashes[nxt]
                prev = head[h]
                chain[nxt & 0xFFFF] = (nxt - prev if prev >= 0
                                       and nxt - prev <= 65535 else 0)
                head[h] = nxt
                nxt += 1
            s = seq[ip]
            cand = head[hashes[ip]]
            best = best_ref = 0
            for _ in range(depth):
                if cand < 0 or ip - cand > 65535:
                    break
                if seq[cand] == s:
                    length = 4 + _common(a, ip + 4, cand + 4, matchlimit)
                    if length > best:
                        best, best_ref = length, cand
                delta = chain[cand & 0xFFFF]
                if delta == 0:
                    break
                cand -= delta
            if best >= 4:
                _emit(out, src, anchor, ip - anchor, ip - best_ref, best)
                ip += best
                anchor = ip
            else:
                ip += 1
    _emit(out, src, anchor, n - anchor, 0, 0)
    return bytes(out)


def lz4_decompress_block_plain(block: bytes, nbytes: int) -> bytes:
    """Decode one LZ4 block of exactly ``nbytes`` bytes."""
    out = bytearray()
    ip, iend = 0, len(block)

    def length(ip, base):
        if base != 15:
            return ip, base
        while True:
            if ip >= iend:
                raise CodecError("corrupt LZ4 block")
            b = block[ip]
            ip += 1
            base += b
            if b != 255:
                return ip, base

    while True:
        if ip >= iend:
            raise CodecError("corrupt LZ4 block")
        token = block[ip]
        ip, lit = length(ip + 1, token >> 4)
        if ip + lit > iend or len(out) + lit > nbytes:
            raise CodecError("corrupt LZ4 block")
        out += block[ip:ip + lit]
        ip += lit
        if ip == iend:
            break
        if iend - ip < 2:
            raise CodecError("corrupt LZ4 block")
        off = block[ip] | (block[ip + 1] << 8)
        ip, mlen = length(ip + 2, token & 15)
        mlen += 4
        if off == 0 or off > len(out) or len(out) + mlen > nbytes:
            raise CodecError("corrupt LZ4 block")
        copy_match_plain(out, off, mlen)
    if len(out) != nbytes:
        raise CodecError("corrupt LZ4 block")
    return bytes(out)


def copy_match_plain(out: bytearray, off: int, mlen: int) -> None:
    """Append the ``mlen`` bytes starting ``off`` bytes back (they may
    overlap what is appended)."""
    if off >= mlen:
        out += out[len(out) - off:len(out) - off + mlen]
    else:
        pattern = bytes(out[len(out) - off:])
        out += (pattern * (mlen // off + 1))[:mlen]


def _stream_plain(cname: str) -> Callable[[bytes, int], bytes]:
    """The plain stream encoder of a cname: (stream, clevel) -> bytes."""
    if cname == 'lz4':
        return lz4_compress_block_plain
    if cname == 'lz4hc':
        return lz4hc_compress_block_plain
    if cname == 'zlib':
        return zlib.compress
    if cname == 'blosclz':
        from .blosclz_plain import compress
    elif cname == 'snappy':
        from .snappy_plain import compress
    else:
        from .zstd_plain import compress
    return compress


def _stream_dec_plain(code: int) -> Callable[[bytes, int], bytes]:
    """The plain stream decoder of a compressor code: (stream, nbytes) ->
    bytes, raising CodecError."""
    if code == 1:
        return lz4_decompress_block_plain
    if code == 3:
        return _zlib_stream
    if code == 0:
        from .blosclz_plain import decompress
    elif code == 2:
        from .snappy_plain import decompress
    else:
        from .zstd_plain import decompress
    return decompress


def _frame_params(cname: str, clevel: int, shuffle: int, typesize: int,
                  nbytes: int):
    """(flags, block size, split) of a frame."""
    mode = _resolve_shuffle(shuffle, typesize)
    flags = _CODE[cname] << 5 | {0: 0, 1: _FLAG_SHUFFLE,
                                 2: _FLAG_BITSHUFFLE}[mode]
    bs = blosc_blocksize(clevel, typesize, nbytes, cname)
    split = _split(typesize, bs, cname)
    if not split:
        flags |= _FLAG_DONT_SPLIT
    return flags, bs, split


def _prepare_plain(flags: int, typesize: int, block: bytes) -> bytes:
    if flags & _FLAG_SHUFFLE and typesize > 1:
        return shuffle_plain(block, typesize)
    if flags & _FLAG_BITSHUFFLE and len(block) >= typesize:
        return bitshuffle_plain(block, typesize)
    return block


def _finish_plain(flags: int, typesize: int, block: bytes) -> bytes:
    if flags & _FLAG_SHUFFLE and typesize > 1:
        return unshuffle_plain(block, typesize)
    if flags & _FLAG_BITSHUFFLE and len(block) >= typesize:
        return bitunshuffle_plain(block, typesize)
    return block


def _assemble(src: bytes, blocks: bytes, typesize: int, clevel: int,
              cname: str, flags: int, bs: int, split: bool,
              encode: Optional[Callable] = None) -> bytes:
    """The frame of ``src`` from its blocks as the codec sees them
    (``blocks``: block j shuffled at j * bs) and the stream encoder
    ``encode(stream, clevel)`` (the cname's plain one by default)."""
    encode = encode or _stream_plain(cname)
    nbytes = len(src)
    nblocks, leftover = (divmod(nbytes, bs) if bs > 0 else (0, 0))
    nblocks += bool(leftover)
    maxbytes = nbytes + OVERHEAD
    body = bytearray()
    pos = OVERHEAD + 4 * nblocks
    starts = []
    ok = nbytes >= _MIN_BUFFERSIZE and clevel > 0 and pos <= maxbytes
    for j in range(nblocks if ok else 0):
        last = j == nblocks - 1 and leftover > 0
        block = blocks[j * bs:j * bs + (leftover if last else bs)]
        starts.append(pos)
        nsplits = typesize if split and not last else 1
        neblock = len(block) // nsplits
        for s in range(nsplits):
            pos += 4
            maxout = (32 + neblock + neblock // 6 if cname == 'snappy'
                      else neblock)
            maxout = min(maxout, maxbytes - pos)
            if maxout <= 0:
                ok = False
                break
            stream = block[s * neblock:(s + 1) * neblock]
            c = encode(stream, clevel)
            if len(c) > maxout or len(c) == neblock:
                if pos + neblock > maxbytes:
                    ok = False
                    break
                c = stream
            body += struct.pack('<i', len(c)) + c
            pos += len(c)
        if not ok:
            break
    if not ok:
        flags |= _FLAG_MEMCPYED
        return (struct.pack('<BBBBiii', 2, 1, flags, typesize, nbytes, bs,
                            maxbytes) + src)
    return (struct.pack('<BBBBiii', 2, 1, flags, typesize, nbytes, bs, pos)
            + struct.pack(f'<{nblocks}i', *starts) + bytes(body))


def compress_plain(data, typesize: int, clevel: int = 5, shuffle: int = 1,
                   cname: str = 'lz4') -> bytes:
    """The plain version of :func:`compress`: the same frame, byte for
    byte."""
    check_settings(cname, clevel, shuffle)
    src = _as_bytes(data).tobytes()
    flags, bs, split = _frame_params(cname, clevel, shuffle, typesize,
                                     len(src))
    blocks = b''.join(_prepare_plain(flags, typesize, src[j:j + bs])
                      for j in range(0, len(src), max(bs, 1)))
    return _assemble(src, blocks, typesize, clevel, cname, flags, bs, split)


def _decode_blocks(frame: bytes, out: memoryview,
                   decode: Callable[[bytes, int], bytes]) -> None:
    """The blocks of a frame (not memcpyed) as its codec sees them (still
    shuffled), decoded into ``out`` (block j at j * blocksize)."""
    _, _, flags, ts, nbytes, bs, cbytes = struct.unpack_from('<BBBBiii',
                                                             frame)
    if nbytes == 0:
        return
    if bs <= 0 or ts < 1 or cbytes > len(frame) or cbytes < OVERHEAD:
        raise CodecError("corrupt frame")
    nblocks, leftover = divmod(nbytes, bs)
    nblocks += bool(leftover)
    if OVERHEAD + 4 * nblocks > cbytes:
        raise CodecError("corrupt frame")
    for j in range(nblocks):
        last = j == nblocks - 1 and leftover > 0
        bsize = leftover if last else bs
        pos = struct.unpack_from('<i', frame, OVERHEAD + 4 * j)[0]
        nsplits = ts if not flags & _FLAG_DONT_SPLIT and not last else 1
        neblock = bsize // nsplits
        if neblock * nsplits != bsize:
            raise CodecError("corrupt frame")
        for s in range(nsplits):
            if pos < 0 or pos + 4 > cbytes:
                raise CodecError("corrupt frame")
            csize = struct.unpack_from('<i', frame, pos)[0]
            pos += 4
            if csize <= 0 or pos + csize > cbytes:
                raise CodecError("corrupt frame")
            stream = frame[pos:pos + csize]
            o = j * bs + s * neblock
            out[o:o + neblock] = (stream if csize == neblock
                                  else decode(stream, neblock))
            pos += csize


def decompress_plain(frame) -> bytes:
    """The plain version of :func:`decompress`."""
    frame = bytes(_as_bytes(frame))
    if len(frame) < OVERHEAD:
        raise CodecError("blosc frame shorter than its header")
    _, _, flags, ts, nbytes, bs, cbytes = struct.unpack_from('<BBBBiii',
                                                             frame)
    if cbytes > len(frame) or nbytes < 0 or cbytes < OVERHEAD:
        raise CodecError("corrupt frame")
    if flags & _FLAG_MEMCPYED:
        if cbytes < nbytes + OVERHEAD:
            raise CodecError("corrupt frame")
        return frame[OVERHEAD:OVERHEAD + nbytes]
    code = _check_code(flags)
    blocks = bytearray(nbytes)
    _decode_blocks(frame, memoryview(blocks), _stream_dec_plain(code))
    return b''.join(_finish_plain(flags, ts, bytes(blocks[j:j + bs]))
                    for j in range(0, nbytes, max(bs, 1)))
