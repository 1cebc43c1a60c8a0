"""The plain version of ``csrc/codec_snappy.h``: raw snappy streams
(blosc compressor code 2) in Python, byte for byte the C encoder's, and
a decoder that reads any valid stream. The format and the encoder's
rules are in the C file's header."""

from __future__ import annotations

import numpy as np

from .blosc import CodecError, _common, _hashes, copy_match_plain

_HASH_LOG = 14
_MULT = 0x1e35a7bd


def _literal(out: bytearray, lit: bytes) -> None:
    if not lit:
        return
    m = len(lit) - 1
    if m < 60:
        out.append(m << 2)
    else:
        extra = 1 if m < 256 else 2 if m < 65536 else 3 if m < 1 << 24 else 4
        out.append((59 + extra) << 2)
        out += m.to_bytes(extra, 'little')
    out += lit


def _copy(out: bytearray, length: int, offset: int) -> None:
    while length > 0:
        part = 64 if length >= 68 else 60 if length > 64 else length
        if part <= 11 and offset < 2048:
            out += bytes((1 | ((part - 4) << 2) | ((offset >> 8) << 5),
                          offset & 255))
        else:
            out += bytes((2 | ((part - 1) << 2), offset & 255, offset >> 8))
        length -= part


def compress(src: bytes, clevel: int = 5) -> bytes:
    """One snappy stream of ``src`` (snappy has no levels)."""
    n = len(src)
    out = bytearray()
    v = n
    while True:
        out.append((v & 127) | (128 if v >= 128 else 0))
        v >>= 7
        if not v:
            break
    anchor = ip = 0
    if n >= 4:
        a = np.frombuffer(src, np.uint8)
        seq, hashes = _hashes(src, _HASH_LOG, _MULT)
        table = [-1] * (1 << _HASH_LOG)
        search = 32
        while ip <= n - 4:
            h = hashes[ip]
            ref = table[h]
            table[h] = ip
            if ref >= 0 and ip - ref <= 65535 and seq[ref] == seq[ip]:
                length = 4 + _common(a, ip + 4, ref + 4, n)
                _literal(out, src[anchor:ip])
                _copy(out, length, ip - ref)
                ip += length
                anchor = ip
                if ip <= n - 4:
                    table[hashes[ip - 1]] = ip - 1
                search = 32
            else:
                ip += search >> 5
                search += 1
    _literal(out, src[anchor:])
    return bytes(out)


def decompress(stream: bytes, nbytes: int) -> bytes:
    """Decode one snappy stream that must hold exactly ``nbytes``
    bytes."""
    ip, iend = 0, len(stream)
    length = shift = 0
    while True:
        if ip >= iend or shift > 28:
            raise CodecError("corrupt snappy stream")
        b = stream[ip]
        ip += 1
        length |= (b & 127) << shift
        shift += 7
        if not b & 128:
            break
    if length != nbytes:
        raise CodecError("corrupt snappy stream")
    out = bytearray()
    while ip < iend:
        tag = stream[ip]
        ip += 1
        kind = tag & 3
        if kind == 0:
            n = tag >> 2
            if n >= 60:
                extra = n - 59
                if iend - ip < extra:
                    raise CodecError("corrupt snappy stream")
                n = int.from_bytes(stream[ip:ip + extra], 'little')
                ip += extra
            n += 1
            if ip + n > iend or len(out) + n > nbytes:
                raise CodecError("corrupt snappy stream")
            out += stream[ip:ip + n]
            ip += n
            continue
        size = (1, 2, 4)[kind - 1]
        if iend - ip < size:
            raise CodecError("corrupt snappy stream")
        if kind == 1:
            n = ((tag >> 2) & 7) + 4
            off = ((tag >> 5) << 8) | stream[ip]
        else:
            n = (tag >> 2) + 1
            off = int.from_bytes(stream[ip:ip + size], 'little')
        ip += size
        if off == 0 or off > len(out) or len(out) + n > nbytes:
            raise CodecError("corrupt snappy stream")
        copy_match_plain(out, off, n)
    if len(out) != nbytes:
        raise CodecError("corrupt snappy stream")
    return bytes(out)
