"""Minimal OpenEXR codec: scanline images, RGB(A)/Y or named channels
(``mitsuba_im_tpu/io/exr.py``, copied).

Reads NONE/RLE/ZIPS/ZIP and PIZ (``piz.py``) compression, half, float and
uint channels; writes ZIP half or float, byte for byte the JAX package's
files.  PXR24, B44, DWA and tiled files raise.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

MAGIC = 20000630
C_NONE, C_RLE, C_ZIPS, C_ZIP, C_PIZ, C_PXR24 = 0, 1, 2, 3, 4, 5
_LINES_PER_BLOCK = {C_NONE: 1, C_RLE: 1, C_ZIPS: 1, C_ZIP: 16, C_PIZ: 32}
_PT_UINT, _PT_HALF, _PT_FLOAT = 0, 1, 2
_PT_DTYPE = {_PT_UINT: "<u4", _PT_HALF: "<f2", _PT_FLOAT: "<f4"}


def _unpredict_and_interleave(b: bytes) -> np.ndarray:
    raw8 = np.frombuffer(b, np.uint8).astype(np.int64)
    # delta decode: out[i] = (out[i-1] + in[i] - 128) mod 256, out[0] = in[0]
    raw8[1:] -= 128
    d = (np.cumsum(raw8) % 256).astype(np.uint8)
    n = len(d)
    out = np.empty(n, np.uint8)
    half = (n + 1) // 2
    out[0::2] = d[:half]
    out[1::2] = d[half:]
    return out


def _interleave_and_predict(data: np.ndarray) -> bytes:
    n = len(data)
    half = (n + 1) // 2
    t = np.empty(n, np.uint8)
    t[:half] = data[0::2]
    t[half:] = data[1::2]
    d = t.astype(np.int16)
    delta = np.empty(n, np.int16)
    delta[0] = d[0]
    delta[1:] = d[1:] - d[:-1] + 128
    return (delta % 256).astype(np.uint8).tobytes()


def _rle_decode(b: bytes, expect: int) -> bytes:
    out = bytearray()
    i = 0
    n = len(b)
    while i < n and len(out) < expect:
        count = struct.unpack_from("b", b, i)[0]
        i += 1
        if count < 0:
            out += b[i : i - count]
            i += -count
        else:
            out += b[i : i + 1] * (count + 1)
            i += 1
    return bytes(out)


def read_exr(path: str, all_channels: bool = False) -> tuple[np.ndarray, dict]:
    """Returns ((H, W, C) float32 array, metadata dict).  Channels ordered
    RGB(A) when present, else alphabetical."""
    with open(path, "rb") as f:
        raw = f.read()
    magic, version = struct.unpack_from("<iI", raw, 0)
    if magic != MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200:
        raise NotImplementedError("tiled EXR not supported yet")

    off = 8
    attrs = {}
    while True:
        end = raw.index(b"\0", off)
        name = raw[off:end].decode()
        off = end + 1
        if not name:
            break
        end = raw.index(b"\0", off)
        typ = raw[off:end].decode()
        off = end + 1
        (size,) = struct.unpack_from("<I", raw, off)
        off += 4
        attrs[name] = (typ, raw[off : off + size])
        off += size

    # channels
    chb = attrs["channels"][1]
    channels = []
    p = 0
    while chb[p] != 0:
        e = chb.index(b"\0", p)
        cname = chb[p:e].decode()
        p = e + 1
        ptype, _plin, _r, _r2, _r3, xs, ys = struct.unpack_from("<iBBBBii", chb, p)
        p += 16
        channels.append((cname, ptype))
    channels.sort(key=lambda c: c[0])

    comp = attrs["compression"][1][0]
    if comp not in _LINES_PER_BLOCK:
        raise NotImplementedError(
            f"EXR compression {comp} (PXR24/B44/DWA) not supported yet"
        )
    xmin, ymin, xmax, ymax = struct.unpack("<4i", attrs["dataWindow"][1])
    W, H = xmax - xmin + 1, ymax - ymin + 1
    line_order = attrs.get("lineOrder", ("", b"\0"))[1][0]
    lpb = _LINES_PER_BLOCK[comp]
    n_blocks = (H + lpb - 1) // lpb

    offsets = struct.unpack_from(f"<{n_blocks}Q", raw, off)
    bytes_per_px = sum(np.dtype(_PT_DTYPE[pt]).itemsize for _c, pt in channels)

    out = {c: np.zeros((H, W), np.float32) for c, _pt in channels}
    for bi in range(n_blocks):
        boff = offsets[bi]
        y, dsize = struct.unpack_from("<ii", raw, boff)
        data = raw[boff + 8 : boff + 8 + dsize]
        y0 = y - ymin
        n_lines = min(lpb, H - y0)
        expect = n_lines * W * bytes_per_px
        if comp in (C_ZIP, C_ZIPS):
            if dsize < expect:
                data = _unpredict_and_interleave(zlib.decompress(data)).tobytes()
        elif comp == C_RLE:
            if dsize < expect:
                data = _unpredict_and_interleave(
                    np.frombuffer(_rle_decode(data, expect), np.uint8)
                ).tobytes()
        elif comp == C_PIZ:
            if dsize < expect:
                from .piz import piz_uncompress

                data = piz_uncompress(data, channels, W, n_lines)
        p = 0
        for li in range(n_lines):
            for cname, pt in channels:
                dt = np.dtype(_PT_DTYPE[pt])
                row = np.frombuffer(data, dt, W, p)
                p += W * dt.itemsize
                out[cname][y0 + li] = row.astype(np.float32)

    if line_order == 1:  # decreasing Y
        for c in out:
            out[c] = out[c][::-1]

    names = [c for c, _ in channels]
    meta = {k: v for k, (t, v) in attrs.items() if t == "string"}
    meta = {k: v.decode("utf-8", "replace") for k, v in meta.items()}
    if all_channels:
        meta["channels"] = ",".join(names)
        return np.stack([out[c] for c in names], axis=-1), meta
    if set("RGB").issubset(names):
        stack = [out["R"], out["G"], out["B"]] + ([out["A"]] if "A" in names else [])
    elif "Y" in names:
        stack = [out["Y"]] * 3
    else:
        stack = [out[c] for c in names]
    return np.stack(stack, axis=-1), meta


def write_exr(path: str, img: np.ndarray, half: bool = True,
              metadata: dict | None = None,
              channel_names: list | None = None) -> None:
    """Write (H, W, C) float array as a ZIP-compressed scanline EXR.

    ``channel_names`` overrides the default R/G/B naming — used by the
    multichannel integrator for named AOV layers (``"normal.R"`` etc.,
    multichannel.cpp / hdrfilm multi-layer capability)."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    return write_exr_stream(
        path, lambda y0, n: img[y0:y0 + n], H, W, C, half=half,
        metadata=metadata, channel_names=channel_names)


def write_exr_stream(path: str, row_fn, H: int, W: int, C: int = 3,
                     half: bool = True, metadata: dict | None = None,
                     channel_names: list | None = None) -> None:
    """Streaming writer: ``row_fn(y0, n) -> (n, W, C)`` supplies scanlines
    on demand, so peak memory is one compression block — the out-of-core
    path behind ``tiledhdrfilm`` (``tiledhdrfilm.cpp:101``)."""
    img = None  # rows come from row_fn
    if channel_names is not None:
        assert len(channel_names) == C
        names = [str(n) for n in channel_names]
    elif C == 1:
        names = ["Y"]
    elif C == 3:
        names = ["R", "G", "B"]
    else:
        names = [f"C{i}" for i in range(C)]
    order = np.argsort(names)
    names_sorted = [names[i] for i in order]

    dt = np.dtype("<f2" if half else "<f4")
    ptype = _PT_HALF if half else _PT_FLOAT

    hdr = bytearray()

    def attr(name, typ, data):
        hdr.extend(name.encode() + b"\0" + typ.encode() + b"\0")
        hdr.extend(struct.pack("<I", len(data)))
        hdr.extend(data)

    chb = bytearray()
    for n in names_sorted:
        chb.extend(n.encode() + b"\0")
        chb.extend(struct.pack("<iBBBBii", ptype, 0, 0, 0, 0, 1, 1))
    chb.append(0)
    attr("channels", "chlist", bytes(chb))
    attr("compression", "compression", bytes([C_ZIP]))
    box = struct.pack("<4i", 0, 0, W - 1, H - 1)
    attr("dataWindow", "box2i", box)
    attr("displayWindow", "box2i", box)
    attr("lineOrder", "lineOrder", b"\0")
    attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
    attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    for k, v in (metadata or {}).items():
        attr(str(k), "string", str(v).encode())
    hdr.append(0)

    lpb = _LINES_PER_BLOCK[C_ZIP]
    n_blocks = (H + lpb - 1) // lpb
    chunks = []
    for bi in range(n_blocks):
        y0 = bi * lpb
        n_lines = min(lpb, H - y0)
        rows = np.asarray(row_fn(y0, n_lines), np.float32)
        rows_sorted = rows[..., order]
        parts = []
        for li in range(n_lines):
            for ci in range(len(names_sorted)):
                parts.append(rows_sorted[li, :, ci].astype(dt).tobytes())
        rawb = b"".join(parts)
        comp = zlib.compress(_interleave_and_predict(np.frombuffer(rawb, np.uint8)))
        if len(comp) >= len(rawb):
            comp = rawb
        chunks.append((y0, comp))

    base = 8 + len(hdr) + 8 * n_blocks
    offsets = []
    pos = base
    for y0, comp in chunks:
        offsets.append(pos)
        pos += 8 + len(comp)

    with open(path, "wb") as f:
        f.write(struct.pack("<iI", MAGIC, 2))
        f.write(bytes(hdr))
        f.write(struct.pack(f"<{n_blocks}Q", *offsets))
        for y0, comp in chunks:
            f.write(struct.pack("<ii", y0, len(comp)))
            f.write(comp)
