"""Shape plugins (``mitsuba_im_tpu/scene/shapes.py``): the keyword
``sphere``, ``disk`` and area-emitter attachment, and the registered
plugins that read a ``Properties`` bag: the meshes from files (``obj``,
``ply``, ``serialized``), ``sphere``, ``disk``, ``rectangle``, ``cube``,
the tessellated ``cylinder``, ``heightfield`` and ``hair``.

The keyword functions work on any builder with the ``SceneBuilder``
interface (``new_shape``, ``add_sphere``, ``add_disk``, ``add_emitter``,
``shape_emitter``), the JAX package's included, so one description of a
scene fills both.  The host arithmetic is the reference's, in float64.
``shapegroup``, ``instance`` and ``deformable`` raise (shared-BLAS
instancing and deformable motion are not ported).
"""
from __future__ import annotations

import numpy as np

from ..core.properties import Properties
from ..core.registry import register, register_unported
from ..core.transform import Transform
from ..emitter.table import AK_DISK, AK_SPHERE, AK_TRIMESH
from . import mesh as mesh_mod
from .mesh import TriMesh


def attach_area_emitter(b, record: dict, shape_id: int, kind=AK_TRIMESH,
                        prim: int = 0, surface_area: float = 1.0) -> int:
    """Add the ``area`` emitter ``record`` to the shape ``shape_id`` of
    kind ``kind`` (its sphere or disk row ``prim``, its ``surface_area``);
    returns the emitter id."""
    rec = dict(record, shape=shape_id, area_kind=kind, prim=prim,
               surface_area=surface_area)
    eid = b.add_emitter(rec)
    b.shape_emitter[shape_id] = eid
    return eid


def sphere(b, bsdf_id: int, center=(0.0, 0.0, 0.0), radius: float = 1.0,
           to_world: Transform | None = None,
           emitter: dict | None = None) -> int:
    """A sphere (``to_world`` moves its centre and scales its radius by the
    mean axis scale); with an ``area`` record ``emitter`` it emits.
    Returns the shape id."""
    xf = to_world if to_world is not None else Transform()
    center = xf.apply_point(center)
    radius = float(radius * np.linalg.norm(xf.m[:3, :3], axis=0).mean())
    sid = b.new_shape(bsdf_id)
    prim = b.add_sphere(center, radius, sid)
    if emitter is not None:
        attach_area_emitter(b, emitter, sid, AK_SPHERE, prim,
                            4.0 * np.pi * radius * radius)
    return sid


def disk(b, bsdf_id: int, to_world: Transform | None = None,
         flip_normals: bool = False, emitter: dict | None = None) -> int:
    """The unit disk in the xy plane facing +z, placed by ``to_world`` (its
    radius is the length of the transformed x axis); ``flip_normals`` turns
    it to face -z.  With an ``area`` record ``emitter`` it emits from its
    front.  Returns the shape id."""
    xf = to_world if to_world is not None else Transform()
    c = xf.apply_point([0, 0, 0])
    s_axis = xf.apply_vector([1, 0, 0])
    t_axis = xf.apply_vector([0, 1, 0])
    radius = float(np.linalg.norm(s_axis))
    n = np.cross(s_axis, t_axis)
    n /= max(np.linalg.norm(n), 1e-12)
    if flip_normals:
        n = -n
    s_u = s_axis / max(np.linalg.norm(s_axis), 1e-12)
    t_u = np.cross(n, s_u)
    sid = b.new_shape(bsdf_id)
    prim = b.add_disk(c, n, s_u, t_u, radius, sid)
    if emitter is not None:
        attach_area_emitter(b, emitter, sid, AK_DISK, prim,
                            np.pi * radius * radius)
    return sid


# -- the registered plugins ------------------------------------------------

def _shape_bsdf(props: Properties, ctx) -> int:
    """The shape's BSDF row: its nested record, a referenced id, or a new
    default row.  Media and subsurface children are not ported."""
    for key in ("interior", "exterior", "subsurface"):
        if key in props.children:
            raise NotImplementedError(
                f"shape {key} children are not ported yet (ROADMAP queue A "
                f"item {'7.7' if key == 'subsurface' else '7.2'})")
    b = props.children.get("bsdf")
    if isinstance(b, dict):
        return ctx.add_bsdf(b)
    if isinstance(b, (int, np.integer)):
        return int(b)
    return ctx.default_bsdf()


def _finish_mesh(props: Properties, ctx, mesh: TriMesh) -> int:
    """Place ``mesh`` by ``toWorld`` (flipped by ``flipNormals`` and by a
    mirroring transform), add it to the builder with its BSDF and, with an
    ``area`` child, its emitter."""
    to_world = props.get_transform("toWorld", Transform())
    flip = props.get_bool("flipNormals", False)
    face_normals = props.get_bool("faceNormals", False)
    mesh = mesh.transformed(to_world)
    if to_world.det3() < 0:
        flip = not flip
    if flip:
        mesh.indices = mesh.indices[:, [0, 2, 1]]
        if mesh.normals is not None:
            mesh.normals = -mesh.normals
    sid = ctx.new_shape(_shape_bsdf(props, ctx))
    ctx.add_trimesh(mesh, sid, face_normals=face_normals)
    em_rec = props.children.get("emitter")
    if em_rec is not None:
        attach_area_emitter(ctx, em_rec, sid, AK_TRIMESH,
                            surface_area=float(mesh.surface_areas().sum()))
    return sid


def _file_mesh(props: Properties, mesh: TriMesh) -> TriMesh:
    if mesh.normals is None and not props.get_bool("faceNormals", False):
        mesh.compute_normals()
    return mesh


@register("shape", "obj")
def _obj(props: Properties, ctx=None):
    path = ctx.resolve_path(props.get_string("filename"))
    mesh = mesh_mod.load_obj(
        path, flip_tex_coords=props.get_bool("flipTexCoords", True))
    return _finish_mesh(props, ctx, _file_mesh(props, mesh))


@register("shape", "ply")
def _ply(props: Properties, ctx=None):
    path = ctx.resolve_path(props.get_string("filename"))
    mesh = _file_mesh(props, mesh_mod.load_ply(path))
    props.get_bool("srgb", True)
    return _finish_mesh(props, ctx, mesh)


@register("shape", "serialized")
def _serialized(props: Properties, ctx=None):
    path = ctx.resolve_path(props.get_string("filename"))
    mesh = mesh_mod.load_serialized(
        path, shape_index=props.get_int("shapeIndex", 0))
    return _finish_mesh(props, ctx, _file_mesh(props, mesh))


def _emitter_child(props: Properties):
    rec = props.children.get("emitter")
    return None if rec is None else dict(rec)


@register("shape", "sphere")
def _sphere(props: Properties, ctx=None):
    xf = props.get_transform("toWorld", Transform())
    center = props.get_point("center", np.zeros(3))
    radius = props.get_float("radius", 1.0)
    return sphere(ctx, _shape_bsdf(props, ctx), center, radius, xf,
                  _emitter_child(props))


@register("shape", "disk")
def _disk(props: Properties, ctx=None):
    xf = props.get_transform("toWorld", Transform())
    flip = props.get_bool("flipNormals", False)
    return disk(ctx, _shape_bsdf(props, ctx), xf, flip,
                _emitter_child(props))


def _quad_mesh() -> TriMesh:
    p = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                 np.float64)
    idx = np.array([[0, 1, 2], [2, 3, 0]], np.int64)
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float64)
    n = np.tile([[0.0, 0.0, 1.0]], (4, 1))
    return TriMesh(p, idx, n, uv)


@register("shape", "rectangle")
def _rectangle(props: Properties, ctx=None):
    return _finish_mesh(props, ctx, _quad_mesh())


@register("shape", "cube")
def _cube(props: Properties, ctx=None):
    base = _quad_mesh()
    face = Transform.translate([0, 0, 1])
    xf = [face,
          Transform.rotate([0, 1, 0], 180) @ face,
          Transform.rotate([0, 1, 0], 90) @ face,
          Transform.rotate([0, 1, 0], -90) @ face,
          Transform.rotate([1, 0, 0], -90) @ face,
          Transform.rotate([1, 0, 0], 90) @ face]
    parts = [base.transformed(t) for t in xf]
    mesh = TriMesh(np.concatenate([m.positions for m in parts]),
                   np.concatenate([m.indices + 4 * k
                                   for k, m in enumerate(parts)]),
                   np.concatenate([m.normals for m in parts]),
                   np.concatenate([m.uvs for m in parts]))
    return _finish_mesh(props, ctx, mesh)


@register("shape", "cylinder")
def _cylinder(props: Properties, ctx=None):
    """The open cylinder from ``p0`` to ``p1`` as 64 segments of two
    triangles with smooth radial normals (the reference's tessellation)."""
    p0 = props.get_point("p0", np.array([0, 0, 0.0]))
    p1 = props.get_point("p1", np.array([0, 0, 1.0]))
    radius = props.get_float("radius", 1.0)
    n_seg = 64
    axis = np.asarray(p1) - np.asarray(p0)
    h = np.linalg.norm(axis)
    az = axis / max(h, 1e-12)
    ax = np.cross(az, [0, 0, 1.0])
    if np.linalg.norm(ax) < 1e-6:
        ax = np.cross(az, [0, 1.0, 0])
    ax /= np.linalg.norm(ax)
    ay = np.cross(az, ax)
    ang = np.linspace(0, 2 * np.pi, n_seg, endpoint=False)
    ring = np.outer(np.cos(ang), ax) + np.outer(np.sin(ang), ay)
    bot = p0 + radius * ring
    top = bot + axis
    i = np.arange(n_seg)
    j = (i + 1) % n_seg
    idx = np.stack([np.stack([i, j, n_seg + i], 1),
                    np.stack([j, n_seg + j, n_seg + i], 1)], 1).reshape(-1, 3)
    uv = np.concatenate([
        np.stack([ang / (2 * np.pi), np.zeros(n_seg)], 1),
        np.stack([ang / (2 * np.pi), np.ones(n_seg)], 1),
    ])
    mesh = TriMesh(np.concatenate([bot, top]), idx.astype(np.int64),
                   np.concatenate([ring, ring]), uv)
    return _finish_mesh(props, ctx, mesh)


@register("shape", "heightfield")
def _heightfield(props: Properties, ctx=None):
    """A grid over [-1, 1]^2 lifted by the mean of a bitmap's channels
    (read without sRGB decoding) times ``scale``."""
    from ..io import bitmap as bmp

    path = ctx.resolve_path(props.get_string("filename"))
    img = bmp.load(path, gamma_correct=False)
    hmap = img[..., :3].mean(-1) * props.get_float("scale", 1.0)
    H, W = hmap.shape
    ys, xs = np.meshgrid(np.linspace(-1, 1, H), np.linspace(-1, 1, W),
                         indexing="ij")
    pos = np.stack([xs, ys, hmap], axis=-1).reshape(-1, 3)
    uv = np.stack([(xs + 1) / 2, (ys + 1) / 2], axis=-1).reshape(-1, 2)
    r0 = (np.arange(H - 1) * W)[:, None] + np.arange(W - 1)[None]
    r1 = r0 + W
    idx = np.stack([np.stack([r0, r0 + 1, r1 + 1], -1),
                    np.stack([r1 + 1, r1, r0], -1)], 2).reshape(-1, 3)
    mesh = TriMesh(pos, idx.astype(np.int64), None, uv).compute_normals()
    return _finish_mesh(props, ctx, mesh)


def load_hair(path: str) -> list[np.ndarray]:
    """A Mitsuba hair file as a list of per-strand (n, 3) arrays: the
    binary layout (``BINARY_HAIR``, a uint32 vertex count, float32 xyz
    triples, an infinite x starting a new strand) or text (one ``x y z``
    per line, a blank line between strands)."""
    with open(path, "rb") as f:
        raw = f.read()
    strands: list[np.ndarray] = []
    cur: list[np.ndarray] = []

    def flush():
        nonlocal cur
        if len(cur) >= 2:
            strands.append(np.asarray(cur, np.float64))
        cur = []

    if raw[:11] == b"BINARY_HAIR":
        n_verts = int(np.frombuffer(raw, "<u4", count=1, offset=11)[0])
        data = np.frombuffer(raw, "<f4", offset=15)
        i = 0
        read = 0
        while read < n_verts and i + 3 <= len(data):
            if np.isinf(data[i]):  # strand break sentinel
                flush()
                i += 1
                continue
            cur.append(np.asarray(data[i: i + 3], np.float64))
            i += 3
            read += 1
        flush()
    else:
        for line in raw.decode("utf-8", "replace").splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                flush()
                continue
            parts = line.split()
            if len(parts) >= 3:
                cur.append(np.asarray([float(x) for x in parts[:3]]))
        flush()
    return strands


def tessellate_hair(strands: list[np.ndarray], radius: float,
                    sides: int = 4) -> TriMesh:
    """Each strand as a tube: a ring of ``sides`` vertices per control
    point, its frame parallel-transported along the strand, adjacent rings
    stitched by two triangles per side, radial smooth normals."""
    pos, nrm, idx = [], [], []
    off = 0
    ang = np.arange(sides) * (2.0 * np.pi / sides)
    ca, sa = np.cos(ang), np.sin(ang)
    for strand in strands:
        n = len(strand)
        tang = np.empty_like(strand)
        tang[1:-1] = strand[2:] - strand[:-2]
        tang[0] = strand[1] - strand[0]
        tang[-1] = strand[-1] - strand[-2]
        tang /= np.maximum(np.linalg.norm(tang, axis=-1, keepdims=True),
                           1e-12)
        u = np.cross(tang[0], [0.0, 0.0, 1.0])
        if np.linalg.norm(u) < 1e-6:
            u = np.cross(tang[0], [0.0, 1.0, 0.0])
        u /= np.linalg.norm(u)
        for k in range(n):
            if k > 0:
                # turn u from tang[k-1] to tang[k] (Rodrigues)
                axis = np.cross(tang[k - 1], tang[k])
                s = np.linalg.norm(axis)
                c = float(np.dot(tang[k - 1], tang[k]))
                if s > 1e-9:
                    axis = axis / s
                    u = (u * c + np.cross(axis, u) * s
                         + axis * np.dot(axis, u) * (1.0 - c))
            u -= tang[k] * np.dot(u, tang[k])
            u /= max(np.linalg.norm(u), 1e-12)
            w = np.cross(tang[k], u)
            ring_n = np.outer(ca, u) + np.outer(sa, w)  # (sides, 3)
            pos.append(strand[k] + radius * ring_n)
            nrm.append(ring_n)
        for k in range(n - 1):
            a = off + k * sides
            b = a + sides
            for j in range(sides):
                j2 = (j + 1) % sides
                idx.append([a + j, a + j2, b + j2])
                idx.append([b + j2, b + j, a + j])
        off += n * sides
    if not pos:
        raise ValueError("hair file contains no strands")
    return TriMesh(np.concatenate(pos), np.asarray(idx, np.int64),
                   np.concatenate(nrm), None)


@register("shape", "hair")
def _hair(props: Properties, ctx=None):
    path = ctx.resolve_path(props.get_string("filename"))
    radius = props.get_float("radius", 0.025)
    reduction = props.get_float("reduction", 0.0)
    strands = load_hair(path)
    if reduction > 0.0 and strands:
        keep = max(1, int(round(len(strands) * (1.0 - reduction))))
        sel = np.random.default_rng(0).permutation(len(strands))[:keep]
        strands = [strands[i] for i in sorted(sel)]
    return _finish_mesh(props, ctx, tessellate_hair(strands, radius))


register_unported("shape", ("shapegroup", "instance", "deformable"),
                  "queue A item 6")
