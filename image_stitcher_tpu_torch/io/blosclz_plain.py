"""The plain version of ``csrc/codec_blosclz.h``: blosclz streams (blosc
compressor code 0) in Python, byte for byte the C encoder's (c-blosc
1.x's entropy-probed encoder), and a decoder that reads any stream
c-blosc's decoder reads. The format and the encoder's rules are in the C
file's header."""

from __future__ import annotations

from typing import Optional

import numpy as np

from .blosc import CodecError, _common, _hashes, copy_match_plain

_MULT = 2654435761
_MAX_COPY = 32
_MAX_DISTANCE = 8191
_MAX_FARDISTANCE = 65535 + _MAX_DISTANCE - 1
#: the probe's ratio under which clevel c + 1 stores the stream
RATIO_FLOOR = (2.0, 1.5, 1.2, 1.2, 1.2, 1.2, 1.15, 1.1, 1.0)
#: the probe's window: at most this many bytes of the last quarter
_PROBE_MAX = 4096
_PROBE_LOG = 12


class _Full(Exception):
    """A write would pass the stream's room: c-blosc gives up."""


def _extend(src: bytes, a: np.ndarray, ip: int, ref: int,
            bound: int) -> int:
    """One past the first byte at or after ip that differs from its
    counterpart at ref, at most ``bound`` (c-blosc's match scan; its run
    scan stops at the same place)."""
    end = min(ip + 8, bound)
    while ip < end:
        if src[ip] != src[ref]:
            return ip + 1
        ip += 1
        ref += 1
    if ip >= bound:
        return bound
    return min(ip + _common(a, ip, ref, bound) + 1, bound)


def entropy_probe(src: bytes) -> float:
    """The ratio c-blosc's dry run estimates for ``src``: its bytes over
    the bytes a quick parse (hash log 12, matches of at least 3 bytes,
    the same scans) would write for the first 4096 at most of the last
    quarter; 0 when that window is 12 bytes or fewer."""
    n = len(src)
    maxlen = n // 4
    limit = min(maxlen, _PROBE_MAX)
    if limit <= 12:
        return 0.0
    win = src[n - maxlen:n - maxlen + limit]
    a = np.frombuffer(win, np.uint8)
    seq, hashes = _hashes(win, _PROBE_LOG)
    table = [0] * (1 << _PROBE_LOG)
    bound, ilimit = limit - 1, limit - 12
    copy, oc, ip = 4, 5, 0
    while ip < ilimit:
        anchor = ip
        h = hashes[anchor]
        ref = table[h]
        distance = anchor - ref
        table[h] = anchor
        length = 0
        if 0 < distance < _MAX_FARDISTANCE and seq[ref] == seq[anchor]:
            ip = _extend(win, a, anchor + 4, ref + 4, bound) - 3
            length = ip - anchor
        if length < 3:
            oc += 1
            ip = anchor + 1
            copy += 1
            if copy == _MAX_COPY:
                copy = 0
                oc += 1
            continue
        if not copy:
            oc -= 1
        copy = 0
        if length >= 7:
            oc += (length - 7) // 255 + 1
        oc += 2 if distance - 1 < _MAX_DISTANCE else 4
        table[hashes[ip]] = ip
        ip += 2
        oc += 1
    return ip / oc


def compress(src: bytes, clevel: int = 5, maxout: Optional[int] = None,
             split: bool = True) -> bytes:
    """One blosclz stream of ``src`` as c-blosc writes it in a frame
    whose blocks are ``split`` (or not), in at most ``maxout`` bytes
    (when None, the C stream's room: 2 n + 1024); b'' where c-blosc
    declines (the frame then stores the stream as it is)."""
    n = len(src)
    clevel = min(max(int(clevel), 1), 9)
    if n < 16 or (maxout is not None and maxout < 66):
        return b''
    ratio = entropy_probe(src)
    if ratio < RATIO_FLOOR[clevel - 1]:
        return b''
    shift = 4 if split and ratio >= 4.0 else 3
    log = 12 if clevel == 1 else 13 if clevel == 2 else 14
    room = 2 * n + 1024 if maxout is None else maxout
    a = np.frombuffer(src, np.uint8)
    seq, hashes = _hashes(src, log)
    table = [0] * (1 << log)
    out = bytearray((31,)) + src[:4]
    copy, ip = 4, 4
    bound, ilimit = n - 1, n - 12

    def need(k: int) -> None:
        if len(out) + k > room:
            raise _Full

    try:
        while ip < ilimit:
            anchor = ip
            h = hashes[anchor]
            ref = table[h]
            distance = anchor - ref
            table[h] = anchor
            length = -1
            if 0 < distance < _MAX_FARDISTANCE and seq[ref] == seq[anchor]:
                distance -= 1
                ip = _extend(src, a, anchor + 4, ref + 4, bound) - shift
                length = ip - anchor
                if length <= 5 and distance >= _MAX_DISTANCE:
                    length = -1
            if length < shift:
                need(2)
                out.append(src[anchor])
                ip = anchor + 1
                copy += 1
                if copy == _MAX_COPY:
                    copy = 0
                    out.append(31)
                continue
            if copy:
                out[-copy - 1] = copy - 1
            else:
                del out[-1]
            copy = 0
            far = distance >= _MAX_DISTANCE
            if far:
                distance -= _MAX_DISTANCE
            hi = 31 if far else distance >> 8
            tail = (255, distance >> 8, distance & 255) if far \
                else (distance & 255,)
            if length < 7:
                need(1 + len(tail))
                out.append((length << 5) + hi)
            else:
                need(1)
                out.append((7 << 5) + hi)
                length -= 7
                while length >= 255:
                    need(1)
                    out.append(255)
                    length -= 255
                need(1 + len(tail))
                out.append(length)
            out += bytes(tail)
            table[hashes[ip]] = ip
            ip += 1
            if clevel == 9:
                table[(((seq[ip - 1] >> 8) * _MULT) & 0xFFFFFFFF)
                      >> (32 - log)] = ip
            ip += 1
            need(1)
            out.append(31)
        while ip < n:
            need(2)
            out.append(src[ip])
            ip += 1
            copy += 1
            if copy == _MAX_COPY:
                copy = 0
                out.append(31)
    except _Full:
        return b''
    if copy:
        out[-copy - 1] = copy - 1
    else:
        del out[-1]
    out[0] |= 0x20
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
