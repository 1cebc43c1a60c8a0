"""The plain version of ``csrc/codec_snappy.h``: raw snappy streams
(blosc compressor code 2) in Python, byte for byte the C encoder's
(Google snappy 1.2's compressor, as c-blosc calls it), and a decoder
that reads any valid stream. The format and the encoder's rules are in
the C file's header."""

from __future__ import annotations

from typing import Optional

import numpy as np

from .blosc import CodecError, _common, _hashes, copy_match_plain

_BLOCK = 65536
_MAX_TABLE = 1 << 15
_MARGIN = 15
_MULT = 0x1e35a7bd


def _literal(out: bytearray, lit: bytes) -> None:
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


def _fragment(out: bytearray, frag: bytes) -> None:
    """snappy's CompressFragment of one fragment of at most 64 KiB."""
    n = len(frag)
    size = 256
    while size < n and size < _MAX_TABLE:
        size <<= 1
    ip = 0
    if n >= _MARGIN:
        a = np.frombuffer(frag, np.uint8)
        seq, hashes = _hashes(frag, 15, _MULT)
        hashes = [h & (size - 1) for h in hashes]
        table = [0] * size
        limit = n - _MARGIN
        while True:
            next_emit = ip
            ip += 1
            skip = 32
            cand = -1
            if limit - ip >= 16:
                for i in range(16):
                    h = hashes[ip + i]
                    c = table[h]
                    table[h] = ip + i
                    if seq[c] == seq[ip + i]:
                        ip += i
                        cand = c
                        break
                else:
                    ip += 16
                    skip += 16
            while cand < 0:
                h = hashes[ip]
                step = skip >> 5
                skip += step
                if ip + step > limit:
                    ip = next_emit
                    break
                c = table[h]
                table[h] = ip
                if seq[c] == seq[ip]:
                    cand = c
                else:
                    ip += step
            if cand < 0:
                break
            _literal(out, frag[next_emit:ip])
            while True:
                length = 4 + _common(a, ip + 4, cand + 4, n)
                _copy(out, length, ip - cand)
                ip += length
                if ip >= limit:
                    break
                table[hashes[ip - 1]] = ip - 1
                h = hashes[ip]
                cand = table[h]
                table[h] = ip
                if seq[cand] != seq[ip]:
                    cand = -1
                    break
            if cand >= 0:
                break
    if ip < n:
        _literal(out, frag[ip:])


def compress(src: bytes, clevel: int = 5, cap: Optional[int] = None) -> bytes:
    """One snappy stream of ``src`` (c-blosc runs snappy at its level 1),
    or ``b''`` when ``cap`` is under snappy's worst case."""
    n = len(src)
    if cap is not None and cap < 32 + n + n // 6:     # snappy's worst case
        return b''
    out = bytearray()
    v = n
    while True:
        out.append((v & 127) | (128 if v >= 128 else 0))
        v >>= 7
        if not v:
            break
    for pos in range(0, n, _BLOCK):
        _fragment(out, src[pos:pos + _BLOCK])
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
