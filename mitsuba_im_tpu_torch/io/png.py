"""PNG codec, stdlib zlib only (``mitsuba_im_tpu/io/png.py``, copied).

Read: 8/16-bit gray/RGB/RGBA, non-interlaced, all five scanline filters.
Write: 8/16-bit RGB(A), byte for byte the JAX package's files.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"


def read_png(path: str) -> np.ndarray:
    """Returns (H, W, C) float32 in [0, 1] (no gamma conversion applied)."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG")
    off = 8
    idat = bytearray()
    w = h = depth = color = None
    palette = None
    trns = None
    while off < len(raw):
        (ln,) = struct.unpack_from(">I", raw, off)
        ctype = raw[off + 4 : off + 8]
        data = raw[off + 8 : off + 8 + ln]
        off += 12 + ln
        if ctype == b"IHDR":
            w, h, depth, color, _comp, _filt, interlace = struct.unpack(">IIBBBBB", data)
            if interlace:
                raise NotImplementedError("interlaced PNG")
        elif ctype == b"PLTE":
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = np.frombuffer(data, np.uint8)
        elif ctype == b"IDAT":
            idat += data
        elif ctype == b"IEND":
            break
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    bytes_per_sample = 2 if depth == 16 else 1
    if depth < 8:
        if color != 3 and color != 0:
            raise NotImplementedError(f"depth {depth} color {color}")
    bpp = max(1, channels * bytes_per_sample * depth // 8) if depth >= 8 else 1
    stride = (w * channels * depth + 7) // 8

    dec = zlib.decompress(bytes(idat))
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    p = 0
    for y in range(h):
        ft = dec[p]
        p += 1
        line = np.frombuffer(dec, np.uint8, stride, p).astype(np.int32)
        p += stride
        if ft == 0:
            cur = line
        elif ft == 1:
            cur = line.copy()
            for i in range(bpp, stride):
                cur[i] = (cur[i] + cur[i - bpp]) & 0xFF
        elif ft == 2:
            cur = (line + prev) & 0xFF
        elif ft == 3:
            cur = line.copy()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                cur[i] = (cur[i] + ((a + prev[i]) >> 1)) & 0xFF
        elif ft == 4:
            cur = line.copy()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
        else:
            raise ValueError(f"bad filter {ft}")
        out[y] = cur.astype(np.uint8)
        prev = cur

    if depth == 16:
        arr = out.view(">u2").reshape(h, w, channels).astype(np.float32) / 65535.0
    elif depth == 8:
        arr = out.reshape(h, w, channels).astype(np.float32) / 255.0
    else:  # sub-byte depths: unpack bits
        bits = np.unpackbits(out, axis=1)[:, : w * depth].reshape(h, w, depth)
        vals = bits.dot(1 << np.arange(depth)[::-1]).astype(np.float32)
        arr = (vals / ((1 << depth) - 1))[..., None]
    if color == 3:
        idx = (arr[..., 0] * 255).astype(int) if depth == 8 else (
            out.reshape(h, w)).astype(int)
        idx = np.clip(idx, 0, len(palette) - 1)
        arr = palette[idx].astype(np.float32) / 255.0
    return arr


def _filter_none(img_bytes: np.ndarray) -> bytes:
    h = img_bytes.shape[0]
    return b"".join(b"\x00" + img_bytes[y].tobytes() for y in range(h))


def write_png(path: str, img: np.ndarray, depth: int = 8) -> None:
    """img: (H, W, 1|3|4) float in [0,1] or uint8."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if img.dtype != np.uint8 and depth == 8:
        img = (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    if depth == 16:
        data = (np.clip(img.astype(np.float64), 0, 1) * 65535 + 0.5).astype(">u2")
        rows = data.reshape(h, -1).view(np.uint8)
    else:
        rows = img.reshape(h, -1)
    payload = zlib.compress(_filter_none(rows), 6)

    def chunk(tag, data):
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(_SIG)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)))
        f.write(chunk(b"IDAT", payload))
        f.write(chunk(b"IEND", b""))
