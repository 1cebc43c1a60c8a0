"""Test-side JPEG encoders for the streams no writer on these hosts makes:
lossless (SOF3) Huffman frames, arithmetic-coded (SOF9, SOF10) frames
and progressive scan scripts that stop before the last refinement.

NumPy only (no OpenCV or PIL), so ``chip_smoke.py`` can write its
lossless 2048^2 tiles on the card's host. The tests hold each encoder
to libjpeg-turbo through ``cv2.imdecode`` on the CPU test host.

What OpenCV 5.0 (libjpeg-turbo 3.1.2) does with these streams, probed
with the encoders here, and what the JAX ``read_image`` therefore gives
(``cv2.imread(IMREAD_UNCHANGED)``, then imageio/Pillow when OpenCV gives
None):
- lossless, 2..8-bit precision: uint8 samples, the undifferenced values
  shifted left by the point transform Pt and not scaled to 8 bits (a
  2-bit frame gives 0..3); predictors 1-7 as T.81 H.1.2.1, the first row
  of the image and of each restart interval 1-D from 2^(P - Pt - 1), the
  first column from the sample above; box upsampling of subsampled
  components (libjpeg-turbo upsamples "fancy" only when its IDCT blocks
  are larger than one sample); 3 components are converted from YCbCr
  under a JFIF marker or an Adobe transform 1, and taken as RGB under
  Adobe transform 0 and with no marker whatever the component ids
  (``jdapimin.c``: a lossless frame with no marker is assumed RGB);
  4 components as in DCT frames (CMYK, YCCK under Adobe);
- lossless at 9..16 bits, 12-bit DCT frames and 2-component frames:
  None, and Pillow refuses them too ("cannot handle 12-bit layers",
  "cannot handle 2-layer images"): the JAX package has no pixels;
- arithmetic-coded sequential and progressive 8-bit frames: the same
  pixels as the Huffman stream of the same coefficients (smoothing
  included), so OpenCV's libjpeg-turbo decodes them;
- hierarchical frames (SOF5-7, SOF13-15) and lossless arithmetic frames
  (SOF11): None, and Pillow raises;
- JPEG-in-TIFF (Compression 7, :func:`jpeg_tiff`): OpenCV's libtiff
  decodes each segment with JPEGTables spliced in, in the colour space
  libtiff forces whatever the markers say: YCbCr (Photometric 6) to RGB
  by libjpeg (fancy upsampling), grey (1), RGB (2) and CMYK (5) as the
  components are (CMYK then through libtiff's RGBA conversion), and
  MinIsWhite (0) inverted; a JPEG whose sampling is not what the TIFF's
  YCbCrSubSampling (or 1x1) says gives None, and so does old-style JPEG
  (Compression 6, :func:`ojpeg_tiff`) and JPEG at 12 bits; for those
  the JAX package's imageio reaches tifffile, which cannot decompress
  them (Pillow would decode an old-style JPEG, but ``read_image`` hands
  a ``.tif``/``.tiff`` file to tifffile).
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from image_stitcher_tpu_torch.io import jpeg_plain as jp


def segment(marker: int, body: bytes) -> bytes:
    return struct.pack('>BBH', 0xFF, marker, len(body) + 2) + body


JFIF = segment(0xE0, b'JFIF\0\x01\x01\x00\x00\x01\x00\x01\x00\x00')


def adobe(transform: int) -> bytes:
    return segment(0xEE, b'Adobe\x00\x64\x00\x00\x00\x00' + bytes([transform]))


# ---------------------------------------------------------------- bit packing

def pack_segments(values: np.ndarray, lengths: np.ndarray,
                  starts: Sequence[int]) -> bytes:
    """Bit fields (MSB first) cut into entropy-coded segments at the field
    indices ``starts`` (the first 0): each padded with 1 bits and
    0xFF-stuffed, RSTn markers between them."""
    bounds = list(starts) + [len(values)]
    out = b''
    for k in range(len(bounds) - 1):
        a, b = bounds[k], bounds[k + 1]
        if k:
            out += bytes([0xFF, 0xD0 + (k - 1) % 8])
        out += jp._pack(values[a:b], lengths[a:b])
    return out


def huffman_table(counts: np.ndarray, nsym: int = 17):
    """(BITS, HUFFVAL) of a prefix code for the symbols 0..nsym - 1, the
    most frequent first: 2 codes of length 3, the rest of length 5."""
    order = np.argsort(-np.asarray(counts[:nsym]), kind='stable')
    bits = [0] * 16
    bits[2] = 2
    bits[4] = nsym - 2
    return bytes(bits), bytes(int(s) for s in order)


def _category(diff: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(SSSS, extra bits) of lossless differences in -32767..32768."""
    s = jp._nbits(diff)
    s = np.where(diff == 32768, 16, s)
    extra = np.where(diff >= 0, diff, diff - 1) & ((1 << s) - 1)
    extra = np.where(s == 16, 0, extra)
    return s, extra


# ------------------------------------------------------------------ lossless

def _predict(x: np.ndarray, psv: int, first_rows: np.ndarray,
             initial: int) -> np.ndarray:
    """Predictions of the (h, w) plane ``x`` (T.81 H.1.2.1): rows in
    ``first_rows`` 1-D from ``initial``, other rows' first column from
    the sample above."""
    x = x.astype(np.int64)
    ra = np.zeros_like(x)
    ra[:, 1:] = x[:, :-1]
    rb = np.zeros_like(x)
    rb[1:] = x[:-1]
    rc = np.zeros_like(x)
    rc[1:, 1:] = x[:-1, :-1]
    pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
            6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[psv].copy()
    pred[:, 0] = rb[:, 0]
    pred[first_rows] = ra[first_rows]
    pred[first_rows, 0] = initial
    return pred


def lossless(planes: List[np.ndarray], precision: int = 8, psv: int = 1,
             pt: int = 0, restart: int = 0,
             sampling: Optional[List[Tuple[int, int]]] = None,
             interleaved: bool = True, ids: Optional[bytes] = None,
             marker: bytes = b'') -> bytes:
    """A lossless (SOF3) Huffman JPEG of component planes (the samples
    at each component's resolution, values below 2^precision, the low
    ``pt`` bits dropped), predictor ``psv`` 1..7, a restart interval in
    MCUs (a multiple of the MCUs in a row, libjpeg-turbo's rule), one
    interleaved scan or a scan per component; ``marker`` (e.g.
    :data:`JFIF`, :func:`adobe`) after SOI."""
    nc = len(planes)
    sampling = sampling or [(1, 1)] * nc
    ids = ids or bytes(range(1, nc + 1))
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    H = max(-(-p.shape[0] * vmax // v) for p, (_, v) in zip(planes, sampling))
    W = max(-(-p.shape[1] * hmax // h) for p, (h, _) in zip(planes, sampling))
    if not interleaved or nc == 1:
        groups = [[ci] for ci in range(nc)]
    else:
        groups = [list(range(nc))]
    out = b'\xff\xd8' + marker
    sof = struct.pack('>BHHB', precision, H, W, nc)
    for ci, (h, v) in enumerate(sampling):
        sof += bytes([ids[ci], (h << 4) | v, 0])
    out += segment(0xC3, sof)
    if restart:
        out += segment(0xDD, struct.pack('>H', restart))
    mcux, mcuy = -(-W // hmax), -(-H // vmax)
    for group in groups:
        one = len(group) == 1
        syms, extras, comps = [], [], []
        for ci in group:
            h, v = sampling[ci]
            x = planes[ci].astype(np.int64) >> pt
            ch, cw = x.shape
            if one:
                mpr, rows_per_mcu_row = cw, 1
            else:
                mpr, rows_per_mcu_row = mcux, v
            first = np.zeros(ch, bool)
            first[0] = True
            if restart:
                every = restart // mpr
                mcu_rows = np.arange(ch) // rows_per_mcu_row
                starts = (mcu_rows % every == 0) & (
                    np.arange(ch) % rows_per_mcu_row == 0)
                # libjpeg-turbo resets the predictor for the first row of
                # the iMCU row (v sample rows) in which a restart falls
                imcu = np.arange(ch) // v
                reset = np.unique(imcu[starts])
                first[(reset * v)[reset * v < ch]] = True
            pred = _predict(x, psv, first, 1 << (precision - pt - 1))
            diff = (x - pred) & 0xFFFF
            diff = np.where(diff >= 32768, diff - 65536, diff)
            if one:
                grid = diff
            else:
                grid = np.zeros((mcuy * v, mcux * h), np.int64)
                grid[:ch, :cw] = diff
            s, e = _category(grid)
            syms.append(s)
            extras.append(e)
            comps.append((ci, h, v))
        if one:
            order_s, order_e = syms[0].ravel(), extras[0].ravel()
            n_mcu, per_mcu = order_s.size, 1
        else:
            parts_s, parts_e = [], []
            for s, e, (ci, h, v) in zip(syms, extras, comps):
                parts_s.append(s.reshape(mcuy, v, mcux, h).transpose(
                    0, 2, 1, 3).reshape(mcuy * mcux, v * h))
                parts_e.append(e.reshape(mcuy, v, mcux, h).transpose(
                    0, 2, 1, 3).reshape(mcuy * mcux, v * h))
            order_s = np.concatenate(parts_s, axis=1).ravel()
            order_e = np.concatenate(parts_e, axis=1).ravel()
            n_mcu = mcuy * mcux
            per_mcu = order_s.size // n_mcu
        table = huffman_table(np.bincount(order_s, minlength=17))
        code, length = jp._code_arrays(table)
        for k, ci in enumerate(group):
            out += segment(0xC4, bytes([k]) + table[0] + table[1])
        # per sample one field: the code, then the extra bits
        extra_len = np.where(order_s == 16, 0, order_s)
        values = (code[order_s] << extra_len) | order_e
        lengths = length[order_s] + extra_len
        starts = [0]
        if restart:
            starts = [m * per_mcu for m in range(0, n_mcu, restart)]
        sos = bytes([len(group)])
        for k, ci in enumerate(group):
            sos += bytes([ids[ci], k << 4])
        out += segment(0xDA, sos + bytes([psv, 0, pt]))
        out += pack_segments(values, lengths, starts)
    return out + b'\xff\xd9'


# ---------------------------------------------------------------- arithmetic

class QMEncoder:
    """T.81 Annex D's QM encoder as libjpeg-turbo's ``jcarith.c`` runs it
    (byte stacking of 0xFF runs and carries, 0x00 stuffing, the flush of
    D.1.8 dropping final zero bytes)."""

    def __init__(self):
        self.out = bytearray()
        self.c, self.a, self.ct = 0, 0x10000, 11
        self.sc = self.zc = 0
        self.buffer = -1

    def _emit_pending(self):
        self.out += bytes(self.zc)
        self.zc = 0

    def encode(self, st: bytearray, i: int, val: int) -> None:
        sv = st[i]
        qe = jp.ARITAB[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        self.a -= qe
        if val != sv >> 7:
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                self._byte_out()
            if self.a >= 0x8000:
                break

    def _byte_out(self):
        temp = self.c >> 19
        if temp > 0xFF:
            if self.buffer >= 0:
                self._emit_pending()
                self.out.append(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self.out.append(0)
            self.zc += self.sc
            self.sc = 0
            self.buffer = temp & 0xFF
        elif temp == 0xFF:
            self.sc += 1
        else:
            self._flush_stack()
            self.buffer = temp & 0xFF
        self.c &= 0x7FFFF
        self.ct += 8

    def _flush_stack(self):
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self._emit_pending()
            self.out.append(self.buffer)
        if self.sc:
            self._emit_pending()
            self.out += b'\xff\x00' * self.sc
            self.sc = 0

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._emit_pending()
                self.out.append(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self.out.append(0)
            self.zc += self.sc
            self.sc = 0
        else:
            self._flush_stack()
        if self.c & 0x7FFF800:
            self._emit_pending()
            b = (self.c >> 19) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)
            if self.c & 0x7F800:
                b = (self.c >> 11) & 0xFF
                self.out.append(b)
                if b == 0xFF:
                    self.out.append(0)
        return bytes(self.out)


def _enc_magnitude(e: QMEncoder, st: bytearray, i: int, v: int,
                   xbase: Optional[int]) -> None:
    """|v| - 1 = v (F.1.4.1.3, F.1.4.2.2): the category from bin i (an AC
    repeats it once, then X bins from ``xbase``; a DC from 20), then the
    bits below the top one from the M bins (X + 14)."""
    m = 0
    if v:
        e.encode(st, i, 1)
        m = 1
        v2 = v
        if xbase is None:
            i = 20
            while v2 >> 1:
                v2 >>= 1
                e.encode(st, i, 1)
                m <<= 1
                i += 1
        elif v2 >> 1:
            v2 >>= 1
            e.encode(st, i, 1)
            m <<= 1
            i = xbase
            while v2 >> 1:
                v2 >>= 1
                e.encode(st, i, 1)
                m <<= 1
                i += 1
    e.encode(st, i, 0)
    i += 14
    while m > 1:
        m >>= 1
        e.encode(st, i, 1 if m & v else 0)


def _enc_dc(e: QMEncoder, st: bytearray, state: dict, diff: int, lo: int,
            hi: int) -> None:
    s0 = state['ctx']
    if diff == 0:
        e.encode(st, s0, 0)
        state['ctx'] = 0
        return
    e.encode(st, s0, 1)
    sign = diff < 0
    e.encode(st, s0 + 1, int(sign))
    v = abs(diff) - 1
    m = 0 if v == 0 else 1 << (v.bit_length() - 1)
    state['ctx'] = 8 if sign else 4
    _enc_magnitude(e, st, s0 + 2 + sign, v, None)
    if m < (1 << lo) >> 1:
        state['ctx'] = 0
    elif m > (1 << hi) >> 1:
        state['ctx'] += 8


def _enc_ac(e: QMEncoder, st: bytearray, fixed: bytearray, zz: List[int],
            ss: int, se: int, al: int, kx: int) -> None:
    """Coefficients ss..se of a block (zigzag list), each taken as
    sign(v) (|v| >> al): Figure F.5, ``jcarith.c::encode_mcu_AC_first``."""
    vals = [(abs(x) >> al) * (1 if x >= 0 else -1) for x in zz]
    ke = se
    while ke > 0 and vals[ke] == 0:
        ke -= 1
    k = ss - 1
    while k < ke:
        i = 3 * k
        e.encode(st, i, 0)
        while True:
            k += 1
            v = vals[k]
            if v:
                e.encode(st, i + 1, 1)
                e.encode(fixed, 0, int(v < 0))
                break
            e.encode(st, i + 1, 0)
            i += 3
        _enc_magnitude(e, st, i + 2, abs(v) - 1, 189 if k <= kx else 217)
    if k < se:
        e.encode(st, 3 * k, 1)


def _enc_ac_refine(e: QMEncoder, st: bytearray, fixed: bytearray,
                   zz: List[int], ss: int, se: int, al: int) -> None:
    """``jcarith.c::encode_mcu_AC_refine``."""
    ke = se
    while ke > 0 and abs(zz[ke]) >> al == 0:
        ke -= 1
    kex = ke
    while kex > 0 and abs(zz[kex]) >> (al + 1) == 0:
        kex -= 1
    k = ss - 1
    while k < ke:
        i = 3 * k
        if k >= kex:
            e.encode(st, i, 0)
        while True:
            k += 1
            v = abs(zz[k]) >> al
            if v:
                if v >> 1:
                    e.encode(st, i + 2, v & 1)
                else:
                    e.encode(st, i + 1, 1)
                    e.encode(fixed, 0, int(zz[k] < 0))
                break
            e.encode(st, i + 1, 0)
            i += 3
    if k < se:
        e.encode(st, 3 * k, 1)


def scan_script(data: bytes) -> List[Tuple[bytes, int, int, int, int]]:
    """The scans of a JPEG stream: (component ids, Ss, Se, Ah, Al)."""
    out, pos = [], 2
    while pos < len(data):
        marker = data[pos + 1]
        if marker == 0xD9:
            break
        length = struct.unpack_from('>H', data, pos + 2)[0]
        body = data[pos + 4:pos + 2 + length]
        pos += 2 + length
        if marker == 0xDA:
            ns = body[0]
            ids = bytes(body[1 + 2 * k] for k in range(ns))
            ss, se, ahal = body[1 + 2 * ns:4 + 2 * ns]
            out.append((ids, ss, se, ahal >> 4, ahal & 15))
            pos = jp._entropy_end(data, pos)
    return out


def arithmetic(data: bytes, scans: Optional[list] = None,
               restart: Optional[int] = None, dac: bytes = b'') -> bytes:
    """The quantised coefficients of the Huffman stream ``data`` (as the
    port's plain decoder reads them) written as an arithmetic-coded
    frame: SOF9 for a sequential stream, SOF10 for a progressive one,
    with ``data``'s scan script (or ``scans``), markers and quantisation
    tables, the restart interval ``restart`` (``data``'s by default) and
    the DAC body ``dac`` (conditioning L, U per DC table, Kx per AC
    table) after the tables."""
    f = jp.read(data)
    scans = scans or scan_script(data)
    restart = f.restart if restart is None else restart
    hmax, vmax, mcux, mcuy = jp._sampling(f)
    dac_l, dac_u, dac_k = [0] * 16, [1] * 16, [5] * 16
    for k in range(0, len(dac), 2):
        idx, val = dac[k], dac[k + 1]
        if idx >= 16:
            dac_k[idx - 16] = val
        else:
            dac_l[idx], dac_u[idx] = val & 15, val >> 4
    # header: everything before the first SOF but DHT, then SOF9/10
    head, pos = b'\xff\xd8', 2
    while True:
        marker = data[pos + 1]
        length = struct.unpack_from('>H', data, pos + 2)[0]
        seg = data[pos:pos + 2 + length]
        pos += 2 + length
        if marker in (0xC0, 0xC1, 0xC2):
            head += bytes([0xFF, 0xCA if f.progressive else 0xC9]) + seg[2:]
            break
        if marker not in (0xC4, 0xDD):
            head += seg
    if dac:
        head += segment(0xCC, dac)
    if restart:
        head += segment(0xDD, struct.pack('>H', restart))
    ids = [c['id'] for c in f.comps]
    coefs = [np.array(f.coef[ci], np.int64).reshape(r, c, 64)[:, :, jp.ZIGZAG]
             for ci, (r, c) in enumerate(f.grid)]
    body = b''
    for sids, ss, se, ah, al in scans:
        cis = [ids.index(c) for c in sids]
        sos = bytes([len(cis)])
        for k, ci in enumerate(cis):
            t = min(k, 1) if not f.progressive else min(ci, 1)
            sos += bytes([ids[ci], (t << 4) | t])
        body += segment(0xDA, sos + bytes([ss, se, (ah << 4) | al]))
        tables = {ci: (sos[2 + 2 * k] >> 4, sos[2 + 2 * k] & 15)
                  for k, ci in enumerate(cis)}
        if len(cis) == 1:
            c = f.comps[cis[0]]
            nx = -(-f.width * c['h'] // (hmax * 8))
            ny = -(-f.height * c['v'] // (vmax * 8))
            blocks = [[(cis[0], by, bx)] for by in range(ny)
                      for bx in range(nx)]
        else:
            blocks = [[(ci, my * f.comps[ci]['v'] + y,
                        mx * f.comps[ci]['h'] + x)
                       for ci in cis for y in range(f.comps[ci]['v'])
                       for x in range(f.comps[ci]['h'])]
                      for my in range(mcuy) for mx in range(mcux)]
        per = restart or len(blocks)
        out = []
        for start in range(0, len(blocks), per):
            e = QMEncoder()
            fixed = bytearray([jp.FIXED_BIN])
            dc_st = {t: bytearray(64) for t, _ in tables.values()}
            ac_st = {t: bytearray(256) for _, t in tables.values()}
            state = {ci: {'ctx': 0, 'last': 0} for ci in cis}
            for mcu in blocks[start:start + per]:
                for ci, by, bx in mcu:
                    zz = coefs[ci][by, bx].tolist()
                    td, ta = tables[ci]
                    if not f.progressive or (ss == 0 and ah == 0):
                        dc = zz[0] >> al if f.progressive else zz[0]
                        _enc_dc(e, dc_st[td], state[ci],
                                dc - state[ci]['last'], dac_l[td],
                                dac_u[td])
                        state[ci]['last'] = dc
                    elif ss == 0:
                        e.encode(fixed, 0, (zz[0] >> al) & 1)
                    if not f.progressive:
                        _enc_ac(e, ac_st[ta], fixed, zz, 1, 63, 0, dac_k[ta])
                    elif ss and ah == 0:
                        _enc_ac(e, ac_st[ta], fixed, zz, ss, se, al,
                                dac_k[ta])
                    elif ss:
                        _enc_ac_refine(e, ac_st[ta], fixed, zz, ss, se, al)
            out.append(e.finish())
        for k, seg in enumerate(out):
            if k:
                body += bytes([0xFF, 0xD0 + (k - 1) % 8])
            body += seg
    return head + body + b'\xff\xd9'


# -------------------------------------------------------------- JPEG-in-TIFF

def split_tables(stream: bytes) -> Tuple[bytes, bytes]:
    """(tables, abbreviated stream) of a JPEG stream: its DQT and DHT
    segments as a tables-only stream (SOI, tables, EOI: a TIFF's
    JPEGTables), and the stream without them or its APP0."""
    tables, rest, pos = b'', b'\xff\xd8', 2
    while True:
        marker = stream[pos + 1]
        length = struct.unpack_from('>H', stream, pos + 2)[0]
        seg = stream[pos:pos + 2 + length]
        if marker in (0xDB, 0xC4):
            tables += seg
        elif marker != 0xE0:
            rest += seg
        pos += 2 + length
        if marker == 0xDA:
            return b'\xff\xd8' + tables + b'\xff\xd9', rest + stream[pos:]


def jpeg_tiff(img: np.ndarray, photometric: int, quality: int = 85,
              subsampling: Tuple[int, int] = (2, 2), tile=None,
              rows_per_strip: Optional[int] = None, tables: bool = True,
              encode=None) -> bytes:
    """A JPEG-in-TIFF file (Compression 7) of a (H, W) grey or (H, W, 3)
    uint8 image: Photometric 1 (grey), 2 (the JPEG's components taken as
    RGB: 4:4:4 YCbCr data, so a reader that converted it would differ)
    or 6 (YCbCr at ``subsampling``, YCbCrSubSampling saying the same), in
    (tile_w, tile_h) tiles (edge tiles padded by edge replication) or
    strips of ``rows_per_strip`` rows (the last one shorter). Each segment
    is the port's encoder's stream (``encode(pixels, quality,
    sampling)``, the plain version unless given), whole, or with
    ``tables`` without its APP0 and with its DQT and DHT moved to
    JPEGTables."""
    encode = encode or jp.encode
    h, w = img.shape[:2]
    samp = subsampling if photometric == 6 else (1, 1)
    if tile is not None:
        tw, tl = tile
        pad = np.pad(img, ((0, -h % tl), (0, -w % tw))
                     + ((0, 0),) * (img.ndim - 2), mode='edge')
        parts = [pad[y:y + tl, x:x + tw] for y in range(0, h, tl)
                 for x in range(0, w, tw)]
    else:
        rps = rows_per_strip or h
        parts = [img[y:y + rps] for y in range(0, h, rps)]
    segs, shared = [], None
    for part in parts:
        stream = encode(np.ascontiguousarray(part), quality, samp)
        if tables:
            shared, stream = split_tables(stream)
        segs.append(stream)
    spp = 1 if img.ndim == 2 else 3
    return jpeg_tiff_file(h, w, spp, photometric, segs, samp, shared, tile,
                          rows_per_strip or h)


def jpeg_tiff_file(h: int, w: int, spp: int, photometric: int,
                   segs: List[bytes], subsampling=(1, 1), tables=None,
                   tile=None, rows_per_strip: Optional[int] = None) -> bytes:
    """A Compression 7 TIFF of the given JPEG segments (strips of
    ``rows_per_strip`` rows, one strip by default, or tiles), with
    JPEGTables when ``tables`` is given."""
    samp, rps = subsampling, rows_per_strip or h
    offsets, pos = [], 8
    for s in segs:
        offsets.append(pos)
        pos += len(s)
    body = b''.join(segs)
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [8] * spp),
               (259, 3, [7]), (262, 3, [photometric]), (277, 3, [spp]),
               (284, 3, [1])]
    if photometric == 6:
        entries.append((530, 3, list(samp)))
    if tables:
        entries.append((347, 7, list(tables)))
    if tile is None:
        entries += [(273, 4, offsets), (278, 4, [rps]),
                    (279, 4, [len(s) for s in segs])]
    else:
        entries += [(322, 4, [tile[0]]), (323, 4, [tile[1]]),
                    (324, 4, offsets), (325, 4, [len(s) for s in segs])]
    entries.sort()
    ifd_off = pos + (pos & 1)
    fmt = {3: 'H', 4: 'I', 7: 'B'}
    ifd = bytearray(struct.pack('<H', len(entries)))
    extra_at = ifd_off + 2 + 12 * len(entries) + 4
    extra = bytearray()
    for tag, ty, vals in entries:
        payload = struct.pack('<' + fmt[ty] * len(vals), *vals)
        if len(payload) <= 4:
            field = payload.ljust(4, b'\0')
        else:
            field = struct.pack('<I', extra_at + len(extra))
            extra += payload + b'\0' * (len(payload) & 1)
        ifd += struct.pack('<HHI', tag, ty, len(vals)) + field
    ifd += struct.pack('<I', 0)
    return (b'II' + struct.pack('<HI', 42, ifd_off) + body
            + b'\0' * (ifd_off - pos) + bytes(ifd) + bytes(extra))


def ojpeg_tiff(stream: bytes, h: int, w: int, photometric: int = 6,
               subsampling: Tuple[int, int] = (2, 2)) -> bytes:
    """A minimal old-style JPEG TIFF (Compression 6) of one strip whose
    JPEGInterchangeFormat (and StripOffsets) point at the whole JPEG
    ``stream`` of an (h, w) image."""
    spp = 1 if photometric == 1 else 3
    ifd_off = 8 + len(stream) + (len(stream) & 1)
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [8] * spp),
               (259, 3, [6]), (262, 3, [photometric]), (273, 4, [8]),
               (277, 3, [spp]), (278, 4, [h]), (279, 4, [len(stream)]),
               (513, 4, [8]), (514, 4, [len(stream)])]
    if photometric == 6:
        entries.append((530, 3, list(subsampling)))
    entries.sort()
    ifd = bytearray(struct.pack('<H', len(entries)))
    extra_at = ifd_off + 2 + 12 * len(entries) + 4
    extra = bytearray()
    for tag, ty, vals in entries:
        payload = struct.pack('<' + {3: 'H', 4: 'I'}[ty] * len(vals), *vals)
        if len(payload) <= 4:
            field = payload.ljust(4, b'\0')
        else:
            field = struct.pack('<I', extra_at + len(extra))
            extra += payload
        ifd += struct.pack('<HHI', tag, ty, len(vals)) + field
    ifd += struct.pack('<I', 0)
    return (b'II' + struct.pack('<HI', 42, ifd_off) + stream
            + b'\0' * (ifd_off - 8 - len(stream)) + bytes(ifd) + bytes(extra))
