"""Blosc1 frames with LZ4 blocks: the port's chunk codec.

The counterpart of the c-blosc that tensorstore links for the JAX
package's compressed chunks (zarr v2 ``{"id": "blosc", "cname": "lz4"}``
and the zarr v3 ``blosc`` codec). The codec is C, written by hand
(``csrc/blosc_lz4.c``), built at first use with the system C compiler
(:func:`image_stitcher_tpu_torch.native.load`) and called through
:mod:`ctypes`, which releases the interpreter lock, so the zarr writers
encode one chunk per thread. This module holds the bindings and the
plain version of the same codec in NumPy and Python (``*_plain``), which
the tests hold the C codec to, byte for byte; the writers never run the
plain version, and a codec that cannot be built raises.

The frame (c-blosc 1.x, as tensorstore writes it):
- a 16-byte header: format version 2, LZ4 format version 1, flags
  (0x01 byte shuffle, 0x02 memcpyed, 0x10 blocks not split, the
  compressor code 1 (LZ4) in bits 5-7), the type size, then the
  uncompressed size, the block size and the frame's size as u32 LE;
- the input cut into blocks of ``blosc_blocksize(clevel, typesize,
  nbytes)`` bytes (c-blosc's rule), the last one shorter when the size is
  not a multiple; an i32 offset of each block's data from the frame's
  start;
- each block byte-shuffled (byte j of element i goes to j * n + i; a
  tail that is not a whole element stays as it is) and cut into
  ``typesize`` streams of equal length (one stream when the block is the
  short last one, or when c-blosc's split rule says no:
  typesize > 16 or block / typesize < 128); each stream is an i32 size
  and an LZ4 block, or the stream's bytes as they are when LZ4 does not
  make it shorter (size equal to the stream's length);
- a frame that would be longer than the input plus its header, an input
  under 128 bytes, or clevel 0 is ``memcpyed``: flag 0x02 and the input
  after the header.

The LZ4 matcher (the same in C and here; the format leaves it free, so
these rules are what makes the two byte-equal):
- the 4 bytes at position p, read as a little-endian u32 ``seq``, hash
  to ``(seq * 2654435761 mod 2**32) >> 20``: a 4096-entry table holds
  the last position seen with each hash, empty (-1) at each block start;
- positions p <= n - 12 may start a match (a block under 13 bytes is all
  literals); the table entry is read, then set to p; the candidate is
  taken when its 4 bytes equal p's and p - candidate <= 65535; the match
  extends while the bytes agree, up to n - 5 (the last 5 bytes are
  always literals); there is no backward extension;
- after a miss p advances by ``search >> 6``, then ``search += 1``;
  ``search`` starts at ``accel << 6`` and is reset after each match,
  with ``accel = max(1, 10 - clevel)`` (c-blosc's LZ4 acceleration);
- after a match ending at e, position e - 2 is entered in the table and
  the search goes on at e.
Sequences are encoded as the LZ4 block format says (token nibbles,
255-continued lengths, u16 LE offsets); the decoders read any valid LZ4
block, including overlapping matches and the block-splitting choices of
other encoders, so frames tensorstore wrote decode here too.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Optional

import numpy as np

OVERHEAD = 16
_MIN_BUFFERSIZE = 128
_FLAG_SHUFFLE, _FLAG_MEMCPYED, _FLAG_BITSHUFFLE = 0x01, 0x02, 0x04
_FLAG_DONT_SPLIT = 0x10
_HASH_LOG = 12

_LIB: Optional[ctypes.CDLL] = None


def lib() -> ctypes.CDLL:
    """The C codec, built and bound on first use (raises when no C
    compiler can build it)."""
    global _LIB
    if _LIB is None:
        from ..native import load
        so = load('blosc_lz4')
        i64, vp, ci = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
        so.blosc_lz4_compress.argtypes = [ci, ci, i64, vp, i64, vp, i64]
        so.blosc_lz4_decompress.argtypes = [vp, i64, vp, i64]
        so.lz4_compress_block.argtypes = [vp, i64, vp, i64, ci]
        so.lz4_decompress_block.argtypes = [vp, i64, vp, i64]
        so.all_zero.argtypes = [vp, i64]
        for f in (so.blosc_lz4_compress, so.blosc_lz4_decompress,
                  so.lz4_compress_block, so.lz4_decompress_block):
            f.restype = i64
        so.all_zero.restype = ci
        _LIB = so
    return _LIB


class CodecError(ValueError):
    """A frame the codec cannot decode (corrupt, or not blosc-lz4)."""


_ERRORS = {-1: "bad arguments", -2: "corrupt frame", -3:
           "unsupported frame (not LZ4, or bit-shuffled)",
           -4: "out of memory"}


def _as_bytes(data) -> np.ndarray:
    """A C-contiguous uint8 view of ``data`` (bytes-like or an array)."""
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data).reshape(-1).view(np.uint8)
    return np.frombuffer(data, np.uint8)


def compress(data, typesize: int, clevel: int = 5,
             shuffle: int = 1) -> memoryview:
    """One blosc-lz4 frame of ``data`` (its bytes, C order), in C. The
    result is a view of a fresh buffer."""
    src = _as_bytes(data)
    dest = np.empty(src.size + OVERHEAD, np.uint8)
    n = lib().blosc_lz4_compress(int(clevel), int(bool(shuffle)),
                                 int(typesize), src.ctypes.data, src.size,
                                 dest.ctypes.data, dest.size)
    if n < 0:
        raise CodecError(f"blosc-lz4 compress: {_ERRORS.get(n, n)}")
    return memoryview(dest)[:n]


def decompress(frame, out: Optional[np.ndarray] = None) -> np.ndarray:
    """Decode one frame, in C, into ``out`` (a C-contiguous array of the
    frame's size in bytes) or a new uint8 array."""
    src = _as_bytes(frame)
    if src.size < OVERHEAD:
        raise CodecError("blosc frame shorter than its header")
    nbytes = struct.unpack_from('<i', src, 4)[0]
    if out is None:
        out = np.empty(nbytes, np.uint8)
    if not out.flags.c_contiguous or out.nbytes != nbytes:
        raise CodecError(f"blosc frame holds {nbytes} bytes, the "
                         f"destination {out.nbytes}")
    n = lib().blosc_lz4_decompress(src.ctypes.data, src.size,
                                   out.ctypes.data, out.nbytes)
    if n != nbytes:
        raise CodecError(f"blosc-lz4 decompress: {_ERRORS.get(n, n)}")
    return out


def all_zero(data: np.ndarray) -> bool:
    """True when every byte of the C-contiguous ``data`` is zero."""
    return bool(lib().all_zero(data.ctypes.data, data.nbytes))


def lz4_compress_block(data, clevel: int = 5) -> bytes:
    """One LZ4 block of ``data`` in C (the matcher above)."""
    src = _as_bytes(data)
    cap = src.size + src.size // 255 + 16
    dest = np.empty(cap, np.uint8)
    n = lib().lz4_compress_block(src.ctypes.data, src.size, dest.ctypes.data,
                                 cap, _accel(clevel))
    return dest[:n].tobytes()


def lz4_decompress_block(block, nbytes: int) -> bytes:
    """Decode one LZ4 block of exactly ``nbytes`` bytes, in C."""
    src = _as_bytes(block)
    dest = np.empty(nbytes, np.uint8)
    if lib().lz4_decompress_block(src.ctypes.data, src.size,
                                  dest.ctypes.data, nbytes) != nbytes:
        raise CodecError("corrupt LZ4 block")
    return dest.tobytes()


# ------------------------------------------------------------- plain version

def _accel(clevel: int) -> int:
    return max(1, 10 - int(clevel))


def blosc_blocksize(clevel: int, typesize: int, nbytes: int) -> int:
    """c-blosc 1.x's block size for LZ4 with no forced size."""
    if nbytes < typesize:
        return 1
    bs = nbytes
    if nbytes >= 32 * 1024:
        factor_x4 = (1, 2, 4, 8, 16, 16, 32, 32, 32, 32)
        bs = 32 * 1024 * factor_x4[min(max(clevel, 0), 9)] // 4
    if clevel > 0 and _split(typesize, bs):
        bs = min(bs, 1 << 18) * typesize
        bs = min(max(bs, 1 << 16), 1 << 20)
    bs = min(bs, nbytes)
    if bs > typesize:
        bs = bs // typesize * typesize
    return bs


def _split(typesize: int, blocksize: int) -> bool:
    return typesize <= 16 and blocksize // typesize >= _MIN_BUFFERSIZE


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
    """One LZ4 block of ``src``: the matcher of the module docstring."""
    n = len(src)
    out = bytearray()
    anchor = ip = 0
    if n >= 13:
        a = np.frombuffer(src, np.uint8)
        w = a.astype(np.uint32)
        seq = w[:-3] | (w[1:-2] << 8) | (w[2:-1] << 16) | (w[3:] << 24)
        hashes = (((seq.astype(np.uint64) * 2654435761) & 0xFFFFFFFF)
                  >> (32 - _HASH_LOG)).tolist()
        seq = seq.tolist()
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
        if off >= mlen:
            out += out[len(out) - off:len(out) - off + mlen]
        else:
            pattern = bytes(out[len(out) - off:])
            out += (pattern * (mlen // off + 1))[:mlen]
    if len(out) != nbytes:
        raise CodecError("corrupt LZ4 block")
    return bytes(out)


def compress_plain(data, typesize: int, clevel: int = 5,
                   shuffle: int = 1) -> bytes:
    """The plain version of :func:`compress`: the same frame, byte for
    byte."""
    src = _as_bytes(data).tobytes()
    nbytes = len(src)
    flags = 1 << 5 | (_FLAG_SHUFFLE if shuffle else 0)
    bs = blosc_blocksize(clevel, typesize, nbytes)
    split = _split(typesize, bs)
    if not split:
        flags |= _FLAG_DONT_SPLIT
    nblocks, leftover = (divmod(nbytes, bs) if bs > 0 else (0, 0))
    nblocks += bool(leftover)
    maxbytes = nbytes + OVERHEAD
    body = bytearray()
    pos = OVERHEAD + 4 * nblocks
    starts = []
    ok = nbytes >= _MIN_BUFFERSIZE and clevel > 0 and pos <= maxbytes
    for j in range(nblocks if ok else 0):
        last = j == nblocks - 1 and leftover > 0
        block = src[j * bs:j * bs + (leftover if last else bs)]
        starts.append(pos)
        if shuffle and typesize > 1:
            block = shuffle_plain(block, typesize)
        nsplits = typesize if split and not last else 1
        neblock = len(block) // nsplits
        for s in range(nsplits):
            pos += 4
            maxout = min(neblock, maxbytes - pos)
            if maxout <= 0:
                ok = False
                break
            stream = block[s * neblock:(s + 1) * neblock]
            c = lz4_compress_block_plain(stream, clevel)
            if len(c) > maxout or len(c) >= neblock:
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


def decompress_plain(frame) -> bytes:
    """The plain version of :func:`decompress`."""
    frame = bytes(_as_bytes(frame))
    if len(frame) < OVERHEAD:
        raise CodecError("blosc frame shorter than its header")
    _, _, flags, ts, nbytes, bs, cbytes = struct.unpack_from('<BBBBiii',
                                                             frame)
    if cbytes > len(frame) or nbytes < 0:
        raise CodecError("corrupt frame")
    if flags & _FLAG_MEMCPYED:
        if cbytes < nbytes + OVERHEAD:
            raise CodecError("corrupt frame")
        return frame[OVERHEAD:OVERHEAD + nbytes]
    if flags & _FLAG_BITSHUFFLE or flags >> 5 != 1:
        raise CodecError("unsupported frame (not LZ4, or bit-shuffled)")
    if nbytes == 0:
        return b''
    nblocks, leftover = divmod(nbytes, bs)
    nblocks += bool(leftover)
    out = bytearray()
    for j in range(nblocks):
        last = j == nblocks - 1 and leftover > 0
        bsize = leftover if last else bs
        pos = struct.unpack_from('<i', frame, OVERHEAD + 4 * j)[0]
        nsplits = ts if not flags & _FLAG_DONT_SPLIT and not last else 1
        neblock = bsize // nsplits
        block = bytearray()
        for _ in range(nsplits):
            csize = struct.unpack_from('<i', frame, pos)[0]
            pos += 4
            if csize <= 0 or pos + csize > cbytes:
                raise CodecError("corrupt frame")
            stream = frame[pos:pos + csize]
            block += (stream if csize == neblock
                      else lz4_decompress_block_plain(stream, neblock))
            pos += csize
        if flags & _FLAG_SHUFFLE and ts > 1:
            block = unshuffle_plain(bytes(block), ts)
        out += block
    return bytes(out)
