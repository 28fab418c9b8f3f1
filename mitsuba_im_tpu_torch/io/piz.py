"""PIZ decompression for OpenEXR (wavelet + Huffman), pure numpy/python
(``mitsuba_im_tpu/io/piz.py``, copied).

Implements the documented PIZ scheme (OpenEXR file format, PIZ chunks of 32
scanlines): presence-bitmap value LUT, canonical Huffman coding with
zero-run table packing and an RLE escape symbol, and the 2-D integer
wavelet transform (14-bit and mod-2^16 variants).  Decoder only — the
framework writes ZIP.
"""
from __future__ import annotations

import struct

import numpy as np

USHORT_RANGE = 1 << 16
BITMAP_SIZE = USHORT_RANGE >> 3
HUF_ENCBITS = 16
HUF_ENCSIZE = (1 << HUF_ENCBITS) + 1
SHORT_ZEROCODE_RUN = 59
LONG_ZEROCODE_RUN = 63
SHORTEST_LONG_RUN = 2 + LONG_ZEROCODE_RUN - SHORT_ZEROCODE_RUN  # 6
A_OFFSET = 1 << 15
MOD_MASK = (1 << 16) - 1
NBITS14 = 1 << 14


class _BitReader:
    __slots__ = ("data", "pos", "acc", "nbits")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.acc = 0
        self.nbits = 0

    def get(self, n: int) -> int:
        while self.nbits < n:
            self.acc = (self.acc << 8) | self.data[self.pos]
            self.pos += 1
            self.nbits += 8
        self.nbits -= n
        out = (self.acc >> self.nbits) & ((1 << n) - 1)
        self.acc &= (1 << self.nbits) - 1
        return out


def _reverse_lut_from_bitmap(bitmap: np.ndarray):
    """lut[k] = k-th present 16-bit value (value 0 always present)."""
    bits = np.unpackbits(bitmap, bitorder="little")
    bits[0] = 1  # zero is always representable
    values = np.nonzero(bits)[0].astype(np.uint16)
    return values


def _huf_decode(data: bytes, n_out: int) -> np.ndarray:
    im, iM, _table_len, n_bits, _room = struct.unpack_from("<IIIII", data, 0)
    br = _BitReader(data[20:])

    # unpack the code-length table (6-bit entries with zero-run escapes)
    lengths = np.zeros(HUF_ENCSIZE, np.int32)
    i = im
    while i <= iM:
        l = br.get(6)
        if l == LONG_ZEROCODE_RUN:
            run = br.get(8) + SHORTEST_LONG_RUN
            i += run
        elif l >= SHORT_ZEROCODE_RUN:
            i += l - SHORT_ZEROCODE_RUN + 2
        else:
            lengths[i] = l
            i += 1

    # canonical code assignment (longest codes numerically smallest)
    counts = np.bincount(lengths[lengths > 0], minlength=59).astype(np.int64)
    base = np.zeros(59, np.int64)
    c = 0
    for l in range(58, 0, -1):
        nc = (c + counts[l]) >> 1
        base[l] = c
        c = nc
    next_code = base.copy()
    table: dict[tuple[int, int], int] = {}
    sym_idx = np.nonzero(lengths)[0]
    for s in sym_idx:
        l = int(lengths[s])
        table[(l, int(next_code[l]))] = int(s)
        next_code[l] += 1

    # the payload restarts at the next byte boundary (leftover table bits
    # in the current byte are discarded, as in the reference decoder)
    br2 = _BitReader(br.data[br.pos:])
    out = np.empty(n_out, np.uint16)
    rlc = iM
    n = 0
    code = 0
    length = 0
    get = br2.get
    while n < n_out:
        code = (code << 1) | get(1)
        length += 1
        s = table.get((length, code))
        if s is None:
            if length > 58:
                raise ValueError("PIZ: invalid Huffman stream")
            continue
        code = 0
        length = 0
        if s == rlc:
            run = get(8)
            if n == 0:
                raise ValueError("PIZ: RLE with no previous symbol")
            out[n : n + run] = out[n - 1]
            n += run
        else:
            out[n] = s
            n += 1
    return out


def _wdec14(l, h):
    ls = np.int16(l).astype(np.int32)
    hs = np.int16(h).astype(np.int32)
    ai = ls + (hs & 1) + (hs >> 1)
    a = ai.astype(np.int16)
    b = (ai - hs).astype(np.int16)
    return a.astype(np.uint16), b.astype(np.uint16)


def _wdec16(l, h):
    m = l.astype(np.int64)
    d = h.astype(np.int64)
    bb = (m - (d >> 1)) & MOD_MASK
    aa = (d + bb - A_OFFSET) & MOD_MASK
    return aa.astype(np.uint16), bb.astype(np.uint16)


def _wav2_decode(buf: np.ndarray, nx: int, ox: int, ny: int, oy: int, mx: int):
    """In-place inverse 2-D wavelet over a strided plane (ImfWav scheme)."""
    wdec = _wdec14 if mx < NBITS14 else _wdec16
    n = min(nx, ny)
    p = 1
    while p <= n:
        p <<= 1
    p >>= 1
    p2 = p
    p >>= 1

    while p >= 1:
        oy1, oy2 = oy * p, oy * p2
        ox1, ox2 = ox * p, ox * p2
        ys = np.arange(0, oy * (ny - p2) + 1, oy2) if ny >= p2 else np.empty(0, np.int64)
        xs = np.arange(0, ox * (nx - p2) + 1, ox2) if nx >= p2 else np.empty(0, np.int64)
        if len(ys) and len(xs):
            # vectorized over the full grid of 2x2 blocks at this level
            idx00 = ys[:, None] + xs[None, :]
            i00, i10 = wdec(buf[idx00], buf[idx00 + oy1])
            i01, i11 = wdec(buf[idx00 + ox1], buf[idx00 + ox1 + oy1])
            a00, a01 = wdec(i00, i01)
            a10, a11 = wdec(i10, i11)
            buf[idx00] = a00
            buf[idx00 + ox1] = a01
            buf[idx00 + oy1] = a10
            buf[idx00 + ox1 + oy1] = a11
        if (nx & p) and len(ys):  # odd rightmost column: vertical pairs
            px = (xs[-1] + ox2) if len(xs) else 0
            col = ys + px
            a, b = wdec(buf[col], buf[col + oy1])
            buf[col] = a
            buf[col + oy1] = b
        if (ny & p) and len(xs):  # odd bottom row: horizontal pairs
            py = (ys[-1] + oy2) if len(ys) else 0
            row = py + xs
            a, b = wdec(buf[row], buf[row + ox1])
            buf[row] = a
            buf[row + ox1] = b
        p2 = p
        p >>= 1


def piz_uncompress(data: bytes, channels, width: int, n_lines: int) -> bytes:
    """Decompress one PIZ chunk.

    channels: list of (name, pixel_type) sorted as stored; pixel sizes in
    shorts: HALF=1, FLOAT/UINT=2.  Returns raw scanline-interleaved bytes
    (per line, per channel, width * size shorts).
    """
    min_nz, max_nz = struct.unpack_from("<HH", data, 0)
    off = 4
    bitmap = np.zeros(BITMAP_SIZE, np.uint8)
    if min_nz <= max_nz:
        count = max_nz - min_nz + 1
        bitmap[min_nz : max_nz + 1] = np.frombuffer(data, np.uint8, count, off)
        off += count
    (huf_len,) = struct.unpack_from("<I", data, off)
    off += 4

    lut = _reverse_lut_from_bitmap(bitmap)
    max_value = len(lut) - 1

    sizes = [1 if pt == 1 else 2 for _n, pt in channels]  # shorts per pixel
    total = sum(width * n_lines * s for s in sizes)
    tmp = _huf_decode(data[off : off + huf_len], total)

    # per-channel wavelet + LUT
    pos = 0
    planes = []
    for (_nm, _pt), size in zip(channels, sizes):
        n = width * n_lines * size
        plane = tmp[pos : pos + n].copy()
        for j in range(size):
            _wav2_decode(plane[j:], width, size, n_lines, width * size, max_value)
        plane = lut[np.minimum(plane, max_value)]
        planes.append(plane)
        pos += n

    # interleave to scanlines
    out = bytearray()
    for y in range(n_lines):
        for plane, size in zip(planes, sizes):
            row = plane[y * width * size : (y + 1) * width * size]
            out += row.astype("<u2").tobytes()
    return bytes(out)
