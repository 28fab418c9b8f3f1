"""Volume data sources: Mitsuba ``.vol`` grids + constant volumes
(``mitsuba_im_tpu/media/volume.py``, host numpy, copied so that the port
imports nothing of the JAX package; ``tests/test_torch_media.py`` holds it
to the original).

Implements the binary layout of the reference's
``src/volume/gridvolume.cpp:56-84``: bytes 0-2 ``VOL``,
byte 3 version (3), int32 encoding (1=float32, 2=float16, 3=uint8),
int32 xres/yres/zres, int32 channels (1 or 3), 6x float32 data AABB,
then row-major samples indexed ``((z*yres+y)*xres+x)*channels+chan``.
Little-endian throughout.

World->grid mapping follows ``gridvolume.cpp:189-195``: the data AABB is
mapped onto voxel coordinates ``[0, res-1]`` per axis and values are
trilinearly interpolated; lookups outside the AABB return zero.
"""
from __future__ import annotations

import struct

import numpy as np

ENC_FLOAT32 = 1
ENC_FLOAT16 = 2
ENC_UINT8 = 3
ENC_QUANT8 = 4  # quantized directions; not supported


def read_vol(path: str) -> dict:
    """Parse a ``.vol`` file -> dict(data (Z,Y,X,C) f32, bmin, bmax)."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:3] != b"VOL":
        raise ValueError(f"{path}: not a .vol file")
    version = raw[3]
    if version != 3:
        raise ValueError(f"{path}: unsupported .vol version {version}")
    enc, xres, yres, zres, channels = struct.unpack_from("<5i", raw, 4)
    bbox = struct.unpack_from("<6f", raw, 24)
    n = xres * yres * zres * channels
    if enc == ENC_FLOAT32:
        data = np.frombuffer(raw, dtype="<f4", count=n, offset=48)
    elif enc == ENC_FLOAT16:
        data = np.frombuffer(raw, dtype="<f2", count=n, offset=48).astype(np.float32)
    elif enc == ENC_UINT8:
        data = np.frombuffer(raw, dtype=np.uint8, count=n, offset=48).astype(np.float32) / 255.0
    else:
        raise ValueError(f"{path}: unsupported .vol encoding {enc}")
    data = np.ascontiguousarray(data, np.float32).reshape(zres, yres, xres, channels)
    return dict(
        data=data,
        bmin=np.asarray(bbox[:3], np.float64),
        bmax=np.asarray(bbox[3:], np.float64),
    )


def read_hgrid(path: str, prefix: str, postfix: str) -> dict:
    """Load a hierarchical grid dictionary + its cell blocks into one dense
    grid.

    Dictionary layout (the reference's ``src/volume/hgridvolume.cpp:70-99``):
    6x float32 AABB, 3x int32 cell resolution, then repeated 3x int32 block
    coordinates until EOF; each block ``{prefix}{x:03d}_{y:03d}_{z:03d}
    {postfix}`` is a regular ``.vol`` grid.  Blocks are composited at the
    finest block resolution; absent cells are zero.
    """
    import os

    with open(path, "rb") as f:
        raw = f.read()
    xmin, ymin, zmin, xmax, ymax, zmax = struct.unpack_from("<6f", raw, 0)
    rx, ry, rz = struct.unpack_from("<3i", raw, 24)
    blocks = []
    off = 36
    while off + 12 <= len(raw):
        blocks.append(struct.unpack_from("<3i", raw, off))
        off += 12
    base = os.path.dirname(path)
    cells = {}
    bres = np.ones(3, np.int64)
    channels = 1
    for bx, by, bz in blocks:
        bp = os.path.join(base, f"{prefix}{bx:03d}_{by:03d}_{bz:03d}{postfix}")
        if not os.path.exists(bp):
            bp2 = f"{prefix}{bx:03d}_{by:03d}_{bz:03d}{postfix}"
            if os.path.exists(bp2):
                bp = bp2
            else:
                continue
        cell = read_vol(bp)
        d = cell["data"]
        cells[(bx, by, bz)] = d
        bres = np.maximum(bres, [d.shape[2], d.shape[1], d.shape[0]])
        channels = max(channels, d.shape[-1])
    nx, ny, nz = int(bres[0]), int(bres[1]), int(bres[2])
    dense = np.zeros((rz * nz, ry * ny, rx * nx, channels), np.float32)
    for (bx, by, bz), d in cells.items():
        if d.shape[:3] != (nz, ny, nx):  # nearest-resample coarser blocks
            zi = (np.arange(nz) * d.shape[0]) // nz
            yi = (np.arange(ny) * d.shape[1]) // ny
            xi = (np.arange(nx) * d.shape[2]) // nx
            d = d[zi][:, yi][:, :, xi]
        if d.shape[-1] != channels:
            d = np.repeat(d[..., :1], channels, axis=-1)
        dense[bz * nz:(bz + 1) * nz, by * ny:(by + 1) * ny,
              bx * nx:(bx + 1) * nx] = d
    return dict(
        data=dense,
        bmin=np.asarray([xmin, ymin, zmin], np.float64),
        bmax=np.asarray([xmax, ymax, zmax], np.float64),
    )


def write_vol(path: str, data: np.ndarray, bmin, bmax) -> None:
    """Write (Z,Y,X) or (Z,Y,X,C) float32 data as a version-3 ``.vol``."""
    d = np.asarray(data, np.float32)
    if d.ndim == 3:
        d = d[..., None]
    zres, yres, xres, channels = d.shape
    with open(path, "wb") as f:
        f.write(b"VOL" + bytes([3]))
        f.write(struct.pack("<5i", ENC_FLOAT32, xres, yres, zres, channels))
        f.write(struct.pack("<6f", *np.asarray(bmin, np.float64),
                            *np.asarray(bmax, np.float64)))
        f.write(np.ascontiguousarray(d, "<f4").tobytes())


def const_grid(value) -> dict:
    """A 1x1x1 grid spanning an unbounded-ish AABB (constvolume analog)."""
    v = np.atleast_1d(np.asarray(value, np.float32))
    return dict(
        data=v.reshape(1, 1, 1, v.size).astype(np.float32),
        bmin=np.full(3, -1e30),
        bmax=np.full(3, 1e30),
        const=True,
    )


def grid_world_to_voxel(rec: dict) -> np.ndarray:
    """4x4 affine mapping world points to voxel coords [0, res-1]^3.

    Composition per gridvolume.cpp:189-195: worldToVolume (inverse of the
    record's ``to_world``), translate(-bmin), scale((res-1)/extent).
    """
    data = rec["data"]
    zres, yres, xres, _ = data.shape
    bmin = np.asarray(rec["bmin"], np.float64)
    bmax = np.asarray(rec["bmax"], np.float64)
    extent = np.maximum(bmax - bmin, 1e-30)
    res = np.asarray([xres, yres, zres], np.float64)
    scale = np.where(res > 1, (res - 1) / extent, 0.0)
    m = np.eye(4)
    m[:3, :3] = np.diag(scale)
    m[:3, 3] = -bmin * scale
    w2v = rec.get("world_to_volume")
    if w2v is not None:
        m = m @ np.asarray(w2v, np.float64)
    return m
