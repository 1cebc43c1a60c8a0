"""The plain version of ``csrc/codec_blosclz.h``: blosclz streams (blosc
compressor code 0) in Python, byte for byte the C encoder's, and a
decoder that reads any stream c-blosc's decoder reads. The format and
the encoder's rules are in the C file's header."""

from __future__ import annotations

import numpy as np

from .blosc import CodecError, _accel, _common, _hashes, copy_match_plain

_HASH_LOG = 14
_MAX_COPY = 32
_MAX_DISTANCE = 8191
_MAX_FARDISTANCE = 65535 + _MAX_DISTANCE - 1


def _literals(out: bytearray, lit: bytes) -> None:
    for k in range(0, len(lit), _MAX_COPY):
        run = lit[k:k + _MAX_COPY]
        out.append(len(run) - 1)
        out += run


def _match(out: bytearray, mlen: int, distance: int) -> None:
    length, dist = mlen - 2, distance - 1
    far = dist >= _MAX_DISTANCE
    if far:
        dist -= _MAX_DISTANCE
    hi = 31 if far else dist >> 8
    if length < 7:
        out.append((length << 5) + hi)
    else:
        out.append((7 << 5) + hi)
        length -= 7
        while length >= 255:
            out.append(255)
            length -= 255
        out.append(length)
    if far:
        out += bytes((255, dist >> 8, dist & 255))
    else:
        out.append(dist & 255)


def compress(src: bytes, clevel: int = 5) -> bytes:
    """One blosclz stream of ``src``."""
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
            if (ref >= 0 and ip - ref <= _MAX_FARDISTANCE
                    and seq[ref] == seq[ip]):
                length = 4 + _common(a, ip + 4, ref + 4, matchlimit)
                _literals(out, src[anchor:ip])
                _match(out, length, ip - ref)
                ip += length
                anchor = ip
                table[hashes[ip - 2]] = ip - 2
                search = start
            else:
                ip += search >> 6
                search += 1
    _literals(out, src[anchor:])
    return bytes(out)


def decompress(stream: bytes, nbytes: int) -> bytes:
    """Decode one blosclz stream that must hold exactly ``nbytes`` bytes,
    as c-blosc's decoder reads it (a match that ends the stream is
    dropped)."""
    out = bytearray()
    ip, iend = 0, len(stream)
    if iend == 0:
        raise CodecError("corrupt blosclz stream")
    ctrl = stream[0] & 31
    ip = 1
    while True:
        if ctrl >= 32:
            length = (ctrl >> 5) - 1
            ofs = (ctrl & 31) << 8
            if length == 6:
                while True:
                    if ip + 1 >= iend:
                        raise CodecError("corrupt blosclz stream")
                    code = stream[ip]
                    ip += 1
                    length += code
                    if code != 255:
                        break
            elif ip + 1 >= iend:
                raise CodecError("corrupt blosclz stream")
            code = stream[ip]
            ip += 1
            length += 3
            distance = ofs + code + 1
            if code == 255 and ofs == 31 << 8:
                if ip + 1 >= iend:
                    raise CodecError("corrupt blosclz stream")
                distance = (stream[ip] << 8) + stream[ip + 1] \
                    + _MAX_DISTANCE + 1
                ip += 2
            if len(out) + length > nbytes or distance > len(out):
                raise CodecError("corrupt blosclz stream")
            if ip >= iend:
                break
            ctrl = stream[ip]
            ip += 1
            copy_match_plain(out, distance, length)
        else:
            run = ctrl + 1
            if len(out) + run > nbytes or ip + run > iend:
                raise CodecError("corrupt blosclz stream")
            out += stream[ip:ip + run]
            ip += run
            if ip >= iend:
                break
            ctrl = stream[ip]
            ip += 1
    if len(out) != nbytes:
        raise CodecError("corrupt blosclz stream")
    return bytes(out)
