"""Bitmap load/save dispatch over EXR/PNG/JPEG/RGBE/PFM/PPM/TGA/BMP/NPY —
the capability surface of the reference Bitmap class (``bitmap.h:182-261``;
``mitsuba_im_tpu/io/bitmap.py``, copied).

EXR/PNG/RGBE/PFM/PPM/TGA/BMP codecs are written from scratch (the reference
vendors libpng/openexr/libjpeg-turbo); JPEG is delegated to Pillow when
present (pure-python baseline JPEG is not worth the LoC) and raises a clear
error otherwise."""
from __future__ import annotations

import os
import struct

import numpy as np

from .exr import read_exr, write_exr
from .png import read_png, write_png


def load(path: str, gamma_correct: bool = True) -> np.ndarray:
    """Load an image as (H, W, C) float32 *linear* RGB (LDR formats are
    sRGB-delinearized when gamma_correct)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".exr":
        return read_exr(path)[0]
    if ext == ".png":
        img = read_png(path)
        return _delinearize(img, gamma_correct)
    if ext in (".jpg", ".jpeg"):
        img = _read_jpeg(path)
        return _delinearize(img, gamma_correct)
    if ext == ".hdr" or ext == ".rgbe":
        return read_rgbe(path)
    if ext == ".pfm":
        return read_pfm(path)
    if ext in (".ppm", ".pgm"):
        return _delinearize(read_ppm(path), gamma_correct)
    if ext == ".npy":
        return np.load(path).astype(np.float32)
    if ext == ".tga":
        return _delinearize(read_tga(path), gamma_correct)
    if ext == ".bmp":
        return _delinearize(read_bmp(path), gamma_correct)
    raise ValueError(f"unsupported image format: {path}")


def save(path: str, img: np.ndarray, metadata: dict | None = None) -> None:
    ext = os.path.splitext(path)[1].lower()
    img = np.asarray(img, np.float32)
    if ext == ".exr":
        write_exr(path, img, metadata=metadata)
    elif ext == ".png":
        write_png(path, img)
    elif ext in (".hdr", ".rgbe"):
        write_rgbe(path, img)
    elif ext == ".pfm":
        write_pfm(path, img)
    elif ext == ".ppm":
        write_ppm(path, img)
    elif ext == ".npy":
        np.save(path, img)
    elif ext == ".tga":
        write_tga(path, _to_u8(img))
    elif ext == ".bmp":
        write_bmp(path, _to_u8(img))
    elif ext in (".jpg", ".jpeg"):
        _write_jpeg(path, _to_u8(img))
    else:
        raise ValueError(f"unsupported output format: {path}")


def _to_u8(img: np.ndarray) -> np.ndarray:
    """Linear float -> sRGB-encoded uint8 (LDR container path)."""
    c = np.clip(np.asarray(img, np.float32)[..., :3], 0.0, 1.0)
    srgb = np.where(c <= 0.0031308, c * 12.92, 1.055 * c ** (1 / 2.4) - 0.055)
    return (srgb * 255 + 0.5).astype(np.uint8)


def _delinearize(img, gamma_correct):
    if not gamma_correct:
        return img.astype(np.float32)
    out = img.astype(np.float32).copy()
    c = out[..., :3]
    out[..., :3] = np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)
    return out


# -- RGBE (.hdr) ------------------------------------------------------------

def read_rgbe(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        raw = f.read()
    if not (raw.startswith(b"#?RADIANCE") or raw.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not an RGBE file")
    pos = raw.index(b"\n\n") + 2
    eol = raw.index(b"\n", pos)
    dims = raw[pos:eol].split()
    if dims[0] == b"-Y":
        h, w = int(dims[1]), int(dims[3])
    else:
        raise NotImplementedError("unusual RGBE orientation")
    pos = eol + 1
    data = np.zeros((h, w, 4), np.uint8)
    for y in range(h):
        if raw[pos : pos + 2] == b"\x02\x02":  # RLE scanline
            pos += 4
            for c in range(4):
                x = 0
                while x < w:
                    n = raw[pos]
                    pos += 1
                    if n > 128:
                        data[y, x : x + n - 128, c] = raw[pos]
                        pos += 1
                        x += n - 128
                    else:
                        data[y, x : x + n, c] = np.frombuffer(raw, np.uint8, n, pos)
                        pos += n
                        x += n
        else:  # flat
            row = np.frombuffer(raw, np.uint8, w * 4, pos).reshape(w, 4)
            data[y] = row
            pos += w * 4
    mant = data[..., :3].astype(np.float32)
    exp = data[..., 3].astype(np.int32) - 128
    scale = np.ldexp(1.0, exp - 8).astype(np.float32)
    return mant * scale[..., None]


def write_rgbe(path: str, img: np.ndarray) -> None:
    img = np.maximum(np.asarray(img, np.float32)[..., :3], 0)
    h, w = img.shape[:2]
    maxc = img.max(axis=-1)
    exp = np.zeros((h, w), np.int32)
    nz = maxc > 1e-32
    exp[nz] = np.frexp(maxc[nz])[1]
    scale = np.zeros((h, w), np.float32)
    scale[nz] = np.ldexp(1.0, 8 - exp[nz])
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None] + 0.5, 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(nz, exp + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


# -- PFM --------------------------------------------------------------------

def read_pfm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        header = f.readline().strip()
        color = header == b"PF"
        w, h = map(int, f.readline().split())
        scale = float(f.readline())
        count = w * h * (3 if color else 1)
        data = np.frombuffer(f.read(), "<f4" if scale < 0 else ">f4", count)
    img = data.reshape(h, w, 3 if color else 1)[::-1]  # PFM is bottom-up
    if not color:
        img = np.repeat(img, 3, axis=-1)
    return np.ascontiguousarray(img, np.float32)


def write_pfm(path: str, img: np.ndarray) -> None:
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    color = img.shape[-1] >= 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{img.shape[1]} {img.shape[0]}\n".encode())
        f.write(b"-1.0\n")
        f.write(np.ascontiguousarray(img[::-1, :, :3] if color else img[::-1, :, :1], "<f4").tobytes())


# -- PPM --------------------------------------------------------------------

def read_ppm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        raw = f.read()
    toks = []
    pos = 0
    while len(toks) < 4:
        while pos < len(raw) and raw[pos : pos + 1].isspace():
            pos += 1
        if raw[pos : pos + 1] == b"#":
            pos = raw.index(b"\n", pos) + 1
            continue
        e = pos
        while e < len(raw) and not raw[e : e + 1].isspace():
            e += 1
        toks.append(raw[pos:e])
        pos = e
    pos += 1
    fmt, w, h, maxv = toks[0], int(toks[1]), int(toks[2]), int(toks[3])
    ch = 3 if fmt == b"P6" else 1
    dt = np.uint8 if maxv < 256 else np.dtype(">u2")
    img = np.frombuffer(raw, dt, w * h * ch, pos).reshape(h, w, ch)
    img = img.astype(np.float32) / maxv
    if ch == 1:
        img = np.repeat(img, 3, axis=-1)
    return img


def write_ppm(path: str, img: np.ndarray) -> None:
    img = (np.clip(np.asarray(img, np.float32)[..., :3], 0, 1) * 255 + 0.5).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(f"P6\n{img.shape[1]} {img.shape[0]}\n255\n".encode())
        f.write(img.tobytes())


# -- TGA (bitmap.h: ETGA; read supports types 1/2/3/9/10/11, write type 2) --

def read_tga(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        raw = f.read()
    (idlen, cmap_type, img_type) = struct.unpack_from("<BBB", raw, 0)
    cmap_first, cmap_len, cmap_bits = struct.unpack_from("<HHB", raw, 3)
    w, h = struct.unpack_from("<HH", raw, 12)
    bpp, desc = struct.unpack_from("<BB", raw, 16)
    pos = 18 + idlen
    # color map (types 1/9)
    cmap = None
    if cmap_type:
        cbytes = (cmap_bits + 7) // 8
        cmap = np.frombuffer(raw, np.uint8, cmap_len * cbytes, pos)
        cmap = cmap.reshape(cmap_len, cbytes)
        pos += cmap_len * cbytes
    nch = bpp // 8
    npix = w * h
    if img_type in (9, 10, 11):  # RLE
        out = np.empty((npix, nch), np.uint8)
        i = 0
        while i < npix:
            hdr = raw[pos]
            pos += 1
            count = (hdr & 0x7F) + 1
            if hdr & 0x80:  # run packet
                out[i : i + count] = np.frombuffer(raw, np.uint8, nch, pos)
                pos += nch
            else:  # raw packet
                out[i : i + count] = np.frombuffer(
                    raw, np.uint8, count * nch, pos
                ).reshape(count, nch)
                pos += count * nch
            i += count
        data = out.reshape(h, w, nch)
    else:  # uncompressed (1/2/3)
        data = np.frombuffer(raw, np.uint8, npix * nch, pos).reshape(h, w, nch)
    if img_type in (1, 9) and cmap is not None:  # palette lookup
        data = cmap[data[..., 0].astype(np.int64) - cmap_first]
        nch = data.shape[-1]
    if nch == 1:
        img = np.repeat(data[..., :1], 3, axis=-1)
    elif nch == 2:  # 16-bit 5551 BGR
        v = data[..., 0].astype(np.uint16) | (data[..., 1].astype(np.uint16) << 8)
        img = np.stack(
            [(v >> 10) & 31, (v >> 5) & 31, v & 31], axis=-1
        ).astype(np.uint8) * 8
    else:  # BGR(A) -> RGB
        img = data[..., [2, 1, 0]]
    if not (desc & 0x20):  # origin bottom-left unless bit 5 set
        img = img[::-1]
    return img.astype(np.float32) / 255.0


def write_tga(path: str, u8: np.ndarray) -> None:
    h, w = u8.shape[:2]
    hdr = struct.pack("<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, w, h, 24, 0x20)
    with open(path, "wb") as f:
        f.write(hdr)
        f.write(np.ascontiguousarray(u8[..., [2, 1, 0]]).tobytes())


# -- BMP (bitmap.h: EBMP; 24-bit uncompressed BI_RGB) ------------------------

def read_bmp(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:2] != b"BM":
        raise ValueError(f"{path}: not a BMP file")
    data_off = struct.unpack_from("<I", raw, 10)[0]
    hdr_size, w, h = struct.unpack_from("<Iii", raw, 14)
    planes, bpp, compression = struct.unpack_from("<HHI", raw, 26)
    flip = h > 0
    h = abs(h)
    if compression != 0 or bpp not in (8, 24, 32):
        raise NotImplementedError(f"BMP bpp={bpp} compression={compression}")
    nch = bpp // 8
    stride = (w * nch + 3) & ~3
    rows = np.frombuffer(raw, np.uint8, stride * h, data_off).reshape(h, stride)
    data = rows[:, : w * nch].reshape(h, w, nch)
    if nch == 1:
        # 8-bit palettized: palette lives right after the info header (BGRX)
        pal = np.frombuffer(raw, np.uint8, 256 * 4, 14 + hdr_size).reshape(256, 4)
        data = pal[data[..., 0].astype(np.int64)][..., :3]
    img = data[..., [2, 1, 0]]  # BGR(A) -> RGB
    if flip:
        img = img[::-1]
    return np.ascontiguousarray(img).astype(np.float32) / 255.0


def write_bmp(path: str, u8: np.ndarray) -> None:
    h, w = u8.shape[:2]
    stride = (w * 3 + 3) & ~3
    img_size = stride * h
    with open(path, "wb") as f:
        f.write(struct.pack("<2sIHHI", b"BM", 54 + img_size, 0, 0, 54))
        f.write(struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, img_size,
                            2835, 2835, 0, 0))
        rows = np.zeros((h, stride), np.uint8)
        rows[:, : w * 3] = u8[::-1, :, [2, 1, 0]].reshape(h, w * 3)
        f.write(rows.tobytes())


# -- JPEG (delegated to Pillow when available) -------------------------------

def _read_jpeg(path: str) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError as e:
        raise NotImplementedError(
            "JPEG decoding requires Pillow (use PNG/EXR/PFM/HDR)"
        ) from e
    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"), np.uint8)
    return arr.astype(np.float32) / 255.0


def _write_jpeg(path: str, u8: np.ndarray, quality: int = 95) -> None:
    try:
        from PIL import Image
    except ImportError as e:
        raise NotImplementedError("JPEG encoding requires Pillow") from e
    Image.fromarray(u8, "RGB").save(path, quality=quality)
