"""Host-side scene assembly (``mitsuba_im_tpu/scene/build.py``), numpy to
torch on a given device.

What the plugins of the ported path give it: BSDF and texture records
(the vertexcolors bake included), shapes, triangle meshes (smooth or face
normals), two-keyframe deformable meshes (:meth:`add_trimesh_motion`: frame
0 in the tables, frame 1 in the motion mirror that ``Scene.with_time``
lerps toward), shared-BLAS groups and their instances (``begin_group``,
``end_group``, ``add_instance``: a group's triangles are stored once in
local space and traversed through the instanced hierarchy; its analytic
spheres and disks are copied per instance, transformed), analytic spheres
and disks, emitter records of every type, a sensor and the render
settings, and the two-level cluster hierarchy of scenes above
``BRUTE_FORCE_MAX`` triangles (the motion hierarchy for a deformable one),
and the participating media: the medium records of the ``media``
factories, each shape's interior and exterior medium and the camera's
(``camera_medium``), and the subsurface records (``add_subsurface``) with
each shape's record, whose table (``subsurface/build_subsurface``: the
surface points, their irradiance through the scene's own intersection
kernels, the hash grid) is built on the scene's device once the scene
exists, as the reference builds it.  Instancing and
deformable motion together raise, as in the reference.  The scene loader
(``scene/xml.py``) drives it through the registered plugins and sets
``resolve_path`` to its search path.  The host arithmetic (float64 numpy, then one cast to float32) is
the reference's, so a scene built here has the same tables bit for bit as
the same scene built by the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.types import INVALID, entry_device, host_tensor
from ..core.transform import Transform
from ..accel.hierarchy import (build_hierarchy, build_hierarchy_instanced,
                               build_hierarchy_motion)
from ..core.registry import warn_substitution
from ..accel.intersect import BRUTE_FORCE_MAX
from ..bsdf import common as bc
from ..emitter import table as em
from ..media.medium import build_media
from ..render.job import RenderSettings
from ..sensor.table import SENSOR_LEAVES, Sensor, make_sensor, S_PERSPECTIVE
from ..texture import bake_vertex_colors
from ..texture.texture import TextureBuilder
from .geometry import make_geometry
from .scene import Scene

_TRI_KEYS = ("p0", "e1", "e2", "n0", "n1", "n2", "uv0", "uv1", "uv2", "shape")
MOTION_KEYS = ("p0", "e1", "e2", "n0", "n1", "n2")
_SPH_KEYS = ("center", "radius", "shape")
_DISK_KEYS = ("center", "n", "s", "t", "radius", "shape")


class SceneBuilder:
    def __init__(self):
        self.bsdf_records: list[dict] = []
        self.textures = TextureBuilder()
        self.pending_vertexcolors: list[int] = []  # awaiting a mesh's bake
        self.emitter_records: list[dict] = []
        self._tri: dict[str, list] = {k: [] for k in _TRI_KEYS}
        self._sph: dict[str, list] = {k: [] for k in _SPH_KEYS}
        self._disk: dict[str, list] = {k: [] for k in _DISK_KEYS}
        self.shape_bsdf: list[int] = []
        self.shape_emitter: list[int] = []
        self.media_records: list[dict] = []
        self.shape_interior: list[int] = []
        self.shape_exterior: list[int] = []
        self.camera_medium: int = INVALID
        self.subsurface_records: list[dict] = []
        self.shape_subsurface: list[int] = []
        self.sensor: Sensor | None = None
        self.settings = RenderSettings()
        # the frame-1 mirror of the triangle tables (deformable shapes)
        self.has_motion = False
        self._tri1: dict[str, list] = {k: [] for k in MOTION_KEYS}
        # shared-BLAS instancing: groups captured once in local space,
        # instances recording their transforms only
        self.blas_groups: dict = {}  # key -> dict(tri_range, shapes, ...)
        self.instances: list = []  # (key, (3, 4) to_world)
        self._capture = None

    def begin_group(self, key):
        """Capture the shapes added until :meth:`end_group` as the group
        ``key``."""
        if self._capture is not None:
            raise ValueError("nested shapegroups are not permitted")
        self._capture = dict(
            tri0=sum(len(a) for a in self._tri["p0"]),
            sph0=len(self._sph["center"]), disk0=len(self._disk["center"]),
            shape0=len(self.shape_bsdf))

    def end_group(self, key):
        cap, self._capture = self._capture, None
        tri1 = sum(len(a) for a in self._tri["p0"])
        shapes = list(range(cap["shape0"], len(self.shape_bsdf)))
        if any(self.shape_emitter[s] != INVALID for s in shapes):
            warn_substitution(
                "instance", "area emitters inside shapegroups are sampled "
                "in BLAS-local space (un-instanced); move emitters out of "
                "the group")
        # analytic prims of the group leave the world tables; each instance
        # adds transformed copies
        sph = [self._sph[k][cap["sph0"]:] for k in _SPH_KEYS]
        for k in _SPH_KEYS:
            del self._sph[k][cap["sph0"]:]
        disk = [self._disk[k][cap["disk0"]:] for k in _DISK_KEYS]
        for k in _DISK_KEYS:
            del self._disk[k][cap["disk0"]:]
        self.blas_groups[key] = dict(tri_range=(cap["tri0"], tri1),
                                     shapes=shapes, sph=sph, disk=disk)

    def add_instance(self, key, to_world):
        """An instance of the group ``key`` under ``to_world`` (3, 4)."""
        g = self.blas_groups[key]
        M = np.asarray(to_world, np.float64).reshape(3, 4)
        self.instances.append((key, M.astype(np.float32)))
        R, tvec = M[:, :3], M[:, 3]
        scales = np.linalg.norm(R, axis=0)
        uniform = np.allclose(scales, scales[0], rtol=1e-4)
        if (g["sph"][0] or g["disk"][0]) and not uniform:
            warn_substitution(
                "instance", "non-uniform scale on analytic primitives in a "
                "shapegroup (sphere stays spherical)")
        sc = float(scales.mean())
        Rn = R / np.maximum(scales[None, :], 1e-20)
        for c, r, sid in zip(*g["sph"]):
            self._sph["center"].append(c @ R.T + tvec)
            self._sph["radius"].append(r * sc)
            self._sph["shape"].append(sid)
        for c, n, s_, t_, r, sid in zip(*g["disk"]):
            self._disk["center"].append(c @ R.T + tvec)
            self._disk["n"].append(n @ Rn.T)
            self._disk["s"].append(s_ @ Rn.T)
            self._disk["t"].append(t_ @ Rn.T)
            self._disk["radius"].append(r * sc)
            self._disk["shape"].append(sid)

    @staticmethod
    def resolve_path(path: str) -> str:
        """A file a plugin names, as given (``SceneLoader`` replaces this
        with its search over the scene's directory)."""
        return path

    def add_bsdf(self, record: dict) -> int:
        self.bsdf_records.append(record)
        return len(self.bsdf_records) - 1

    def default_bsdf(self) -> int:
        """A row for a shape without a BSDF (diffuse 0.5, as in the
        reference)."""
        return self.add_bsdf(bc.default_record())

    def new_shape(self, bsdf_id: int, emitter_id: int = INVALID,
                  interior: int = INVALID, exterior: int = INVALID,
                  subsurface: int = INVALID) -> int:
        """A shape of BSDF row ``bsdf_id``, its emitter, the medium rows
        inside and outside it and its subsurface record; returns the shape
        id."""
        self.shape_bsdf.append(bsdf_id)
        self.shape_emitter.append(emitter_id)
        self.shape_interior.append(interior)
        self.shape_exterior.append(exterior)
        self.shape_subsurface.append(subsurface)
        return len(self.shape_bsdf) - 1

    def add_subsurface(self, record: dict) -> int:
        """A subsurface record (the ``subsurface`` factories' form); returns
        its id."""
        self.subsurface_records.append(record)
        return len(self.subsurface_records) - 1

    def add_medium(self, record: dict) -> int:
        """A medium record (the ``media`` factories' form); its row is also
        stored in the record (``id``), by which shapes and the sensor name
        it."""
        self.media_records.append(record)
        record["id"] = len(self.media_records) - 1
        return record["id"]

    def add_trimesh(self, mesh, shape_id: int, face_normals: bool = False,
                    corner_uvs=None):
        """mesh: anything with positions, indices, normals and uvs (and
        colors, for a pending vertexcolors texture, which this mesh bakes).
        ``face_normals`` shades with the geometric normal; ``corner_uvs``
        (T, 3, 2) replaces the mesh's per-vertex uvs."""
        p = np.asarray(mesh.positions, np.float64)
        idx = np.asarray(mesh.indices, np.int64)
        if self.pending_vertexcolors:
            pend, self.pending_vertexcolors = self.pending_vertexcolors, []
            baked = bake_vertex_colors(self.textures, mesh, pend)
            corner_uvs = baked if baked is not None else corner_uvs
        if len(idx) == 0:
            return
        p0 = p[idx[:, 0]]
        e1 = p[idx[:, 1]] - p0
        e2 = p[idx[:, 2]] - p0
        gn = np.cross(e1, e2)
        ln = np.linalg.norm(gn, axis=1, keepdims=True)
        gn = np.divide(gn, ln, out=np.zeros_like(gn), where=ln > 0)
        if mesh.normals is not None and not face_normals:
            n0, n1, n2 = (mesh.normals[idx[:, k]] for k in range(3))
        else:
            n0 = n1 = n2 = gn
        if corner_uvs is not None:
            uv0, uv1, uv2 = (corner_uvs[:, k] for k in range(3))
        elif mesh.uvs is not None:
            uv0, uv1, uv2 = (mesh.uvs[idx[:, k]] for k in range(3))
        else:
            uv0 = uv1 = uv2 = np.zeros((len(idx), 2))
        for k, a in zip(_TRI_KEYS, (p0, e1, e2, n0, n1, n2, uv0, uv1, uv2,
                                    np.full(len(idx), shape_id, np.int32))):
            self._tri[k].append(a)
        for k, a in zip(MOTION_KEYS, (p0, e1, e2, n0, n1, n2)):
            self._tri1[k].append(a)

    def add_trimesh_motion(self, mesh0, mesh1, shape_id: int):
        """A two-keyframe deformable mesh: frame 0 enters the tables,
        frame 1 (same topology) the motion mirror."""
        if len(mesh0.indices) != len(mesh1.indices):
            raise ValueError("deformable keyframes must share topology")
        n_before = len(self._tri1["p0"])
        self.add_trimesh(mesh0, shape_id)
        p = np.asarray(mesh1.positions, np.float64)
        idx = np.asarray(mesh1.indices, np.int64)
        p0 = p[idx[:, 0]]
        e1 = p[idx[:, 1]] - p0
        e2 = p[idx[:, 2]] - p0
        if mesh1.normals is not None:
            n0, n1, n2 = (mesh1.normals[idx[:, k]] for k in range(3))
        else:
            gn = np.cross(e1, e2)
            ln = np.linalg.norm(gn, axis=1, keepdims=True)
            gn = np.divide(gn, ln, out=np.zeros_like(gn), where=ln > 0)
            n0 = n1 = n2 = gn
        for k, a in zip(MOTION_KEYS, (p0, e1, e2, n0, n1, n2)):
            self._tri1[k][n_before] = a
        self.has_motion = True

    def add_sphere(self, center, radius: float, shape_id: int) -> int:
        """An analytic sphere; returns its row."""
        s = self._sph
        s["center"].append(np.asarray(center, np.float64).reshape(3))
        s["radius"].append(np.float64(radius))
        s["shape"].append(np.int32(shape_id))
        return len(s["radius"]) - 1

    def add_disk(self, center, n, s_axis, t_axis, radius: float,
                 shape_id: int) -> int:
        """An analytic disk of normal ``n`` and in-plane frame (``s_axis``,
        ``t_axis``); returns its row."""
        d = self._disk
        for k, a in zip(("center", "n", "s", "t"),
                        (center, n, s_axis, t_axis)):
            d[k].append(np.asarray(a, np.float64).reshape(3))
        d["radius"].append(np.float64(radius))
        d["shape"].append(np.int32(shape_id))
        return len(d["radius"]) - 1

    def add_emitter(self, record: dict) -> int:
        self.emitter_records.append(record)
        return len(self.emitter_records) - 1

    def build(self, device="cuda") -> tuple[Scene, RenderSettings]:
        """The Scene on ``device`` (the card unless the CPU is asked for)."""
        device = entry_device(device)
        tri = None
        if self._tri["p0"]:
            tri = {k: np.concatenate(a, axis=0) for k, a in self._tri.items()}
        sph = ({k: np.stack(a) for k, a in self._sph.items()}
               if self._sph["center"] else None)
        disk = ({k: np.stack(a) for k, a in self._disk.items()}
                if self._disk["center"] else None)
        clusters, inst_rot, inst_pts = None, None, []
        if self.instances and tri is not None:
            if self.has_motion:
                raise ValueError(
                    "instancing cannot combine with deformable motion yet")
            clusters, inst_pts = self._instanced_hierarchy(tri, device)
            fwd = clusters.inst_fwd.cpu().numpy()
            inst_rot = np.linalg.inv(
                fwd[:, :, :3]).transpose(0, 2, 1).astype(np.float32)
        geom = make_geometry(tri, sph, disk, device=device,
                             inst_rot=inst_rot)
        n_tris = geom.n_tris
        soup = (None if tri is None else
                [np.asarray(tri[k], np.float32) for k in ("p0", "e1", "e2")])
        motion = None
        if self.has_motion and tri is not None:
            # the frame-1 mirror, row for row with the triangle tables
            m1 = {k: np.concatenate(a, axis=0).astype(np.float32)
                  for k, a in self._tri1.items()}
            motion = {k: np.concatenate(
                [m1[k], tri[k][len(m1[k]):].astype(np.float32)], axis=0)
                for k in m1}
            if n_tris > BRUTE_FORCE_MAX:
                clusters = build_hierarchy_motion(
                    *soup, *(motion[k] for k in ("p0", "e1", "e2")),
                    device=device)
            motion = {k: host_tensor(a, np.float32, device)
                      for k, a in motion.items()}
        elif n_tris > BRUTE_FORCE_MAX and clusters is None:
            clusters = build_hierarchy(*soup, device=device)
        emitters = em.build_emitters(self.emitter_records,
                                     tri if tri is not None else {},
                                     bounding_sphere(tri, sph, disk,
                                                     inst_pts),
                                     device=device)
        sensor = self.sensor or make_sensor(
            S_PERSPECTIVE, Transform.look_at([0, 0, -5], [0, 0, 0], [0, 1, 0]),
            aspect=self.settings.width / max(self.settings.height, 1),
            device=device)
        sensor = dataclasses.replace(
            sensor, **{k: getattr(sensor, k).to(device) for k in SENSOR_LEAVES})
        shutter = tuple(float(np.float32(getattr(sensor, k).item()))
                        for k in ("shutter_open", "shutter_time"))

        scene = Scene(
            geom=geom,
            bsdfs=bc.build_table(self.bsdf_records, device,
                                 self.textures.type_arrays()),
            textures=self.textures.build(device),
            emitters=emitters,
            sensor=sensor,
            shape_bsdf=torch.tensor(self.shape_bsdf or [0], dtype=torch.int32,
                                    device=device),
            shape_emitter=torch.tensor(self.shape_emitter or [INVALID],
                                       dtype=torch.int32, device=device),
            media=build_media(self.media_records, device),
            shape_interior=torch.tensor(self.shape_interior or [INVALID],
                                        dtype=torch.int32, device=device),
            shape_exterior=torch.tensor(self.shape_exterior or [INVALID],
                                        dtype=torch.int32, device=device),
            shape_subsurface=torch.tensor(self.shape_subsurface or [INVALID],
                                          dtype=torch.int32, device=device),
            camera_medium=self.camera_medium,
            clusters=clusters,
            motion=motion,
            shutter=shutter,
        )
        if self.subsurface_records:
            from ..subsurface import build_subsurface

            scene = dataclasses.replace(scene, subsurface=build_subsurface(
                self.subsurface_records, self, scene))
        return scene, self.settings

    def _instanced_hierarchy(self, tri: dict, device):
        """The instanced hierarchy over one BLAS per shapegroup and one of
        the shapes outside groups (the identity instance), and the world
        corners of each instance's local bounds (for the bounding
        sphere)."""
        p0a, e1a, e2a = (tri[k].astype(np.float32) for k in ("p0", "e1",
                                                             "e2"))
        in_group = np.zeros(len(p0a), bool)
        for g in self.blas_groups.values():
            a, b = g["tri_range"]
            in_group[a:b] = True
        blas_list, inst_list, inst_pts = [], [], []
        reg_idx = np.nonzero(~in_group)[0]
        if len(reg_idx):
            blas_list.append((p0a[reg_idx], e1a[reg_idx], e2a[reg_idx],
                              reg_idx))
            inst_list.append((0, np.concatenate(
                [np.eye(3, dtype=np.float32), np.zeros((3, 1), np.float32)],
                axis=1)))
        key_to_blas = {}
        for key, g in self.blas_groups.items():
            a, b = g["tri_range"]
            if b == a:
                continue
            key_to_blas[key] = len(blas_list)
            blas_list.append((p0a[a:b], e1a[a:b], e2a[a:b], np.arange(a, b)))
        for key, M in self.instances:
            if key not in key_to_blas:
                continue
            inst_list.append((key_to_blas[key], M))
            a, b = self.blas_groups[key]["tri_range"]
            v0 = p0a[a:b]
            pts_l = np.concatenate([v0, v0 + e1a[a:b], v0 + e2a[a:b]], axis=0)
            lo_l, hi_l = pts_l.min(0), pts_l.max(0)
            corners = np.array([[x, y, z] for x in (lo_l[0], hi_l[0])
                                for y in (lo_l[1], hi_l[1])
                                for z in (lo_l[2], hi_l[2])], np.float32)
            inst_pts.append(corners @ M[:, :3].T + M[:, 3])
        return build_hierarchy_instanced(blas_list, inst_list,
                                         device), inst_pts


def bounding_sphere(tri: dict | None, sph: dict | None = None,
                    disk: dict | None = None, inst_pts=()):
    """(center, radius) of the scene's bounding sphere, for environment and
    directional emitters: the reference's host arithmetic
    (``scene/build.py:384-399``) over the instances' world corners
    ``inst_pts``, the triangle corners and the spheres' and disks' centres
    plus and minus their radii."""
    pts = list(inst_pts)
    if tri is not None:
        pts += [tri["p0"], tri["p0"] + tri["e1"], tri["p0"] + tri["e2"]]
    for prims in (sph, disk):
        if prims is not None:
            pts += [prims["center"] - prims["radius"][:, None],
                    prims["center"] + prims["radius"][:, None]]
    if not pts:
        return np.zeros(3), 1.0
    allp = np.concatenate(pts, axis=0)
    c = 0.5 * (allp.min(0) + allp.max(0))
    r = float(np.linalg.norm(allp - c, axis=1).max()) + 1e-3
    return c, r
