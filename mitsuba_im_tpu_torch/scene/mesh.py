"""Host-side indexed triangle meshes and their file formats
(``mitsuba_im_tpu/scene/mesh.py``): the ``TriMesh`` container and the
OBJ, PLY (ASCII and binary) and Mitsuba ``.serialized`` loaders, with the
``.serialized`` writer.

OBJ files are tokenized by ``csrc/obj_load.cpp`` (the JAX package's native
tokenizer, copied), built with g++ at first use into
``build/mitsuba_im_tpu_torch/``; a failed build raises, there is no
fallback.  A binary PLY whose faces are all triangles is read in one
vectorised step; its indices are the ones the reference's per-face loop
reads.  Loading is numpy in float64; ``scene/build.py`` casts once.
"""
from __future__ import annotations

import ctypes
import os
import struct
import zlib
from dataclasses import dataclass

import numpy as np

from ..accel.shared_lib import SharedLibrary, cxx


@dataclass
class TriMesh:
    positions: np.ndarray  # (V, 3)
    indices: np.ndarray  # (F, 3)
    normals: np.ndarray | None = None  # (V, 3)
    uvs: np.ndarray | None = None  # (V, 2)
    colors: np.ndarray | None = None  # (V, 3) linear rgb
    name: str = ""

    @property
    def n_vertices(self):
        return len(self.positions)

    @property
    def n_triangles(self):
        return len(self.indices)

    def compute_normals(self) -> "TriMesh":
        """Area-weighted smooth vertex normals (TriMesh::computeNormals),
        accumulated in the reference's order."""
        p = self.positions
        i = self.indices
        fn = np.cross(p[i[:, 1]] - p[i[:, 0]], p[i[:, 2]] - p[i[:, 0]])
        n = np.zeros_like(p)
        for k in range(3):
            np.add.at(n, i[:, k], fn)
        ln = np.linalg.norm(n, axis=1, keepdims=True)
        self.normals = np.divide(n, ln, out=np.zeros_like(n), where=ln > 0)
        return self

    def transformed(self, xf) -> "TriMesh":
        pos = xf.apply_point(self.positions)
        nrm = None
        if self.normals is not None:
            nrm = xf.apply_normal(self.normals)
            ln = np.linalg.norm(nrm, axis=1, keepdims=True)
            nrm = np.divide(nrm, ln, out=np.zeros_like(nrm), where=ln > 0)
        return TriMesh(pos, self.indices, nrm, self.uvs, self.colors,
                       self.name)

    def surface_areas(self) -> np.ndarray:
        p = self.positions
        i = self.indices
        return 0.5 * np.linalg.norm(
            np.cross(p[i[:, 1]] - p[i[:, 0]], p[i[:, 2]] - p[i[:, 0]]),
            axis=1)


def _bind_obj(lib):
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.mitpu_parse_obj.argtypes = [ctypes.c_char_p, ctypes.POINTER(p),
                                    ctypes.POINTER(i64), ctypes.POINTER(i64),
                                    ctypes.POINTER(i32), ctypes.POINTER(i32)]
    lib.mitpu_parse_obj.restype = i32
    for fn, t in (("positions", ctypes.c_float), ("normals", ctypes.c_float),
                  ("uvs", ctypes.c_float), ("indices", ctypes.c_int32)):
        f = getattr(lib, f"mitpu_obj_{fn}")
        f.argtypes = [p]
        f.restype = ctypes.POINTER(t)
    lib.mitpu_obj_free.argtypes = [p]
    lib.mitpu_obj_free.restype = None


# the reference Makefile's flags, as accel/bvh.py builds bvh_build.cpp
OBJ_LIBRARY = SharedLibrary("obj_load.cpp", cxx,
                            ("-O3", "-march=native", "-fPIC", "-std=c++17"),
                            _bind_obj, ("-shared", "-lpthread"))


def parse_obj_native(path: str) -> dict:
    """The native tokenizer's arrays of an OBJ file (float32 positions,
    normals and uvs, int32 indices; normals/uvs None unless every vertex
    has one)."""
    lib = OBJ_LIBRARY.load()
    handle = ctypes.c_void_p()
    n_verts, n_tris = ctypes.c_int64(), ctypes.c_int64()
    has_n, has_uv = ctypes.c_int32(), ctypes.c_int32()
    rc = lib.mitpu_parse_obj(
        os.fsencode(path), ctypes.byref(handle), ctypes.byref(n_verts),
        ctypes.byref(n_tris), ctypes.byref(has_n), ctypes.byref(has_uv))
    if rc != 0 or not handle.value:
        raise OSError(f"{path}: cannot read the OBJ file (code {rc})")
    try:
        V, T = n_verts.value, n_tris.value

        def take(fn, shape):
            if 0 in shape:
                return np.zeros(shape, np.int32 if fn == "indices"
                                else np.float32)
            return np.ctypeslib.as_array(
                getattr(lib, f"mitpu_obj_{fn}")(handle), shape=shape).copy()

        return dict(positions=take("positions", (V, 3)),
                    indices=take("indices", (T, 3)),
                    normals=take("normals", (V, 3)) if has_n.value else None,
                    uvs=take("uvs", (V, 2)) if has_uv.value else None)
    finally:
        lib.mitpu_obj_free(handle)


# ---------------------------------------------------------------------------
# OBJ
# ---------------------------------------------------------------------------

def load_obj(path: str, flip_tex_coords: bool = True) -> TriMesh:
    """Wavefront OBJ (v/vn/vt, polygon fan triangulation, negative
    indices), through the native tokenizer."""
    nat = parse_obj_native(os.path.abspath(path))
    mesh = TriMesh(
        positions=np.asarray(nat["positions"], np.float64),
        indices=np.asarray(nat["indices"], np.int64),
        normals=(np.asarray(nat["normals"], np.float64)
                 if nat["normals"] is not None else None),
        uvs=(np.asarray(nat["uvs"], np.float64)
             if nat["uvs"] is not None else None),
        name=os.path.basename(path),
    )
    if mesh.uvs is not None and flip_tex_coords:
        mesh.uvs = mesh.uvs.copy()
        mesh.uvs[:, 1] = 1.0 - mesh.uvs[:, 1]
    return mesh


# ---------------------------------------------------------------------------
# PLY
# ---------------------------------------------------------------------------

_PLY_TYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def load_ply(path: str) -> TriMesh:
    """PLY loader: ascii and binary little/big endian (reference
    ``src/shapes/ply/``)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype, is_list, count_dtype)])
        while True:
            line = f.readline().decode("ascii", "replace").strip()
            if line.startswith("comment") or line.startswith("obj_info"):
                continue
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, count = line.split()
                elements.append((name, int(count), []))
            elif line.startswith("property"):
                parts = line.split()
                if parts[1] == "list":
                    elements[-1][2].append((parts[4], _PLY_TYPES[parts[3]], True, _PLY_TYPES[parts[2]]))
                else:
                    elements[-1][2].append((parts[2], _PLY_TYPES[parts[1]], False, None))
            elif line == "end_header":
                break
        data = f.read()

    endian = {"binary_little_endian": "<", "binary_big_endian": ">", "ascii": None}[fmt]
    verts: dict[str, np.ndarray] = {}
    face_idx = None
    offset = 0

    if endian is None:  # ascii
        tokens = data.split()
        ti = 0
        for name, count, props in elements:
            if name == "vertex" and all(not p[2] for p in props):
                arr = np.array(
                    tokens[ti : ti + count * len(props)], dtype=np.float64
                ).reshape(count, len(props))
                ti += count * len(props)
                for j, (pn, *_rest) in enumerate(props):
                    verts[pn] = arr[:, j]
            elif name == "face":
                rows = []
                for _ in range(count):
                    n = int(tokens[ti]); ti += 1
                    poly = [int(tokens[ti + j]) for j in range(n)]; ti += n
                    for j in range(1, n - 1):
                        rows.append([poly[0], poly[j], poly[j + 1]])
                face_idx = np.asarray(rows, np.int64)
            else:
                for _ in range(count):
                    for pn, dt, is_list, cdt in props:
                        if is_list:
                            n = int(tokens[ti]); ti += 1 + n
                        else:
                            ti += 1
    else:
        for name, count, props in elements:
            if name == "vertex" and all(not p[2] for p in props):
                dt = np.dtype([(pn, endian + t) for pn, t, _l, _c in props])
                arr = np.frombuffer(data, dt, count, offset)
                offset += dt.itemsize * count
                for pn, *_rest in props:
                    verts[pn] = arr[pn].astype(np.float64)
            elif name == "face" and _all_triangles(data, offset, count,
                                                   endian, props):
                cdt = np.dtype(endian + props[0][3])
                idt = np.dtype(endian + props[0][1])
                dt = np.dtype([("n", cdt), ("i", idt, 3)])
                face_idx = np.frombuffer(data, dt, count,
                                         offset)["i"].astype(np.int64)
                offset += dt.itemsize * count
            elif name == "face":
                rows = []
                for _ in range(count):
                    cdt = np.dtype(endian + props[0][3])
                    n = int(np.frombuffer(data, cdt, 1, offset)[0])
                    offset += cdt.itemsize
                    idt = np.dtype(endian + props[0][1])
                    poly = np.frombuffer(data, idt, n, offset)
                    offset += idt.itemsize * n
                    for j in range(1, n - 1):
                        rows.append([poly[0], poly[j], poly[j + 1]])
                face_idx = np.asarray(rows, np.int64)
            else:  # skip unknown fixed-size elements
                dt = np.dtype([(pn, endian + t) for pn, t, _l, _c in props if not _l])
                offset += dt.itemsize * count

    pos = np.stack([verts["x"], verts["y"], verts["z"]], axis=1)
    normals = None
    if "nx" in verts:
        normals = np.stack([verts["nx"], verts["ny"], verts["nz"]], axis=1)
    uvs = None
    for ua, va in (("u", "v"), ("s", "t"), ("texture_u", "texture_v")):
        if ua in verts:
            uvs = np.stack([verts[ua], verts[va]], axis=1)
            break
    colors = None
    if "red" in verts:
        colors = np.stack([verts["red"], verts["green"], verts["blue"]], axis=1)
        if colors.max() > 1.0:
            colors = colors / 255.0
    return TriMesh(pos, face_idx if face_idx is not None else np.zeros((0, 3), np.int64),
                   normals, uvs, colors, os.path.basename(path))


def _all_triangles(data: bytes, offset: int, count: int, endian: str,
                   props) -> bool:
    """Whether the binary face element at ``offset`` is ``count``
    triangles: one list property whose every count is 3."""
    if count == 0 or len(props) != 1 or not props[0][2]:
        return False
    cdt = np.dtype(endian + props[0][3])
    dt = np.dtype([("n", cdt), ("i", np.dtype(endian + props[0][1]), 3)])
    if offset + dt.itemsize * count > len(data):
        return False
    return bool((np.frombuffer(data, dt, count, offset)["n"] == 3).all())


# ---------------------------------------------------------------------------
# Mitsuba .serialized (format 0x041C)
# ---------------------------------------------------------------------------

MTS_FILEFORMAT_HEADER = 0x041C

# Flags, per reference include/mitsuba/render/trimesh.h
F_HAS_NORMALS = 0x0001
F_HAS_TEXCOORDS = 0x0002
F_HAS_COLORS = 0x0008
F_FACE_NORMALS = 0x0010
F_SINGLE_PRECISION = 0x1000
F_DOUBLE_PRECISION = 0x2000


def serialized_shape_count(path: str) -> int:
    """Number of meshes embedded in a ``.serialized`` container (animation
    frames for the deformable shape, sub-meshes otherwise)."""
    with open(path, "rb") as f:
        f.seek(-4, 2)
        (count,) = struct.unpack("<I", f.read(4))
    return count


def load_serialized(path: str, shape_index: int = 0) -> TriMesh:
    """Mitsuba compressed ``.serialized`` mesh (``src/shapes/serialized.cpp``)."""
    with open(path, "rb") as f:
        raw = f.read()
    magic, version = struct.unpack_from("<HH", raw, 0)
    if magic != MTS_FILEFORMAT_HEADER:
        raise ValueError(f"{path}: bad header {magic:#x}")

    # Mesh offset dictionary lives at the end of file.
    (count,) = struct.unpack_from("<I", raw, len(raw) - 4)
    if shape_index >= count:
        raise IndexError(f"{path}: shape {shape_index} of {count}")
    if version >= 4:
        table = struct.unpack_from(f"<{count}Q", raw, len(raw) - 4 - 8 * count)
    else:
        table = struct.unpack_from(f"<{count}I", raw, len(raw) - 4 - 4 * count)
    start = table[shape_index]

    comp = zlib.decompressobj()
    payload = comp.decompress(raw[start + 4 :])

    off = 0
    (flags,) = struct.unpack_from("<I", payload, off)
    off += 4
    name = ""
    if version >= 4:
        end = payload.index(b"\0", off)
        name = payload[off:end].decode("utf-8", "replace")
        off = end + 1
    n_vert, n_tri = struct.unpack_from("<QQ", payload, off)
    off += 16

    ft = np.dtype("<f8" if flags & F_DOUBLE_PRECISION else "<f4")

    def take(n, dt):
        nonlocal off
        a = np.frombuffer(payload, dt, n, off)
        off += dt.itemsize * n
        return a

    pos = take(3 * n_vert, ft).reshape(n_vert, 3).astype(np.float64)
    normals = uvs = colors = None
    if flags & F_HAS_NORMALS:
        normals = take(3 * n_vert, ft).reshape(n_vert, 3).astype(np.float64)
    if flags & F_HAS_TEXCOORDS:
        uvs = take(2 * n_vert, ft).reshape(n_vert, 2).astype(np.float64)
    if flags & F_HAS_COLORS:
        colors = take(3 * n_vert, ft).reshape(n_vert, 3).astype(np.float64)
    it = np.dtype("<u4") if n_vert <= 0xFFFFFFFF else np.dtype("<u8")
    idx = take(3 * n_tri, it).reshape(n_tri, 3).astype(np.int64)
    if flags & F_FACE_NORMALS:
        normals = None
    return TriMesh(pos, idx, normals, uvs, colors, name or os.path.basename(path))


def save_serialized(path: str, mesh) -> None:
    """Write a v4 ``.serialized`` file (round-trip capability).  ``mesh``
    may be a single TriMesh or a list (multi-shape files, as produced by
    the reference ``mtsimport`` converter — addressed by ``shapeIndex``).
    """
    meshes = mesh if isinstance(mesh, (list, tuple)) else [mesh]
    offsets = []
    with open(path, "wb") as f:
        for m in meshes:
            offsets.append(f.tell())
            flags = F_SINGLE_PRECISION
            if m.normals is not None:
                flags |= F_HAS_NORMALS
            if m.uvs is not None:
                flags |= F_HAS_TEXCOORDS
            if m.colors is not None:
                flags |= F_HAS_COLORS
            payload = struct.pack("<I", flags)
            payload += m.name.encode("utf-8") + b"\0"
            payload += struct.pack("<QQ", m.n_vertices, m.n_triangles)
            payload += m.positions.astype("<f4").tobytes()
            if m.normals is not None:
                payload += m.normals.astype("<f4").tobytes()
            if m.uvs is not None:
                payload += m.uvs.astype("<f4").tobytes()
            if m.colors is not None:
                payload += m.colors.astype("<f4").tobytes()
            payload += m.indices.astype("<u4").tobytes()
            f.write(struct.pack("<HH", MTS_FILEFORMAT_HEADER, 4))
            f.write(zlib.compress(payload))
        for off in offsets:
            f.write(struct.pack("<Q", off))
        f.write(struct.pack("<I", len(meshes)))


def load_mesh(path: str, **kw) -> TriMesh:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        return load_obj(path, **kw)
    if ext == ".ply":
        return load_ply(path)
    if ext == ".serialized":
        return load_serialized(path, **kw)
    raise ValueError(f"Unsupported mesh format: {path}")
