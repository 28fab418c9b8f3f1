"""Host-side scene assembly (``mitsuba_im_tpu/scene/build.py``), numpy to
torch on a given device.

What the plugins of the ported path give it: BSDF and texture records
(the vertexcolors bake included), shapes, triangle meshes (smooth or face
normals), analytic spheres and disks, emitter records of every type, a
sensor and the render settings, and the two-level cluster hierarchy of
scenes above ``BRUTE_FORCE_MAX`` triangles (media, subsurface, motion and
instancing are not ported).  The scene loader (``scene/xml.py``) drives it
through the registered plugins and sets ``resolve_path`` to its search
path.  The host arithmetic (float64 numpy, then one cast to float32) is
the reference's, so a scene built here has the same tables bit for bit as
the same scene built by the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.types import INVALID, entry_device
from ..core.transform import Transform
from ..accel.hierarchy import build_hierarchy
from ..accel.intersect import BRUTE_FORCE_MAX
from ..bsdf import common as bc
from ..emitter import table as em
from ..render.job import RenderSettings
from ..sensor.table import SENSOR_LEAVES, Sensor, make_sensor, S_PERSPECTIVE
from ..texture import bake_vertex_colors
from ..texture.texture import TextureBuilder
from .geometry import make_geometry
from .scene import Scene

_TRI_KEYS = ("p0", "e1", "e2", "n0", "n1", "n2", "uv0", "uv1", "uv2", "shape")
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
        self.sensor: Sensor | None = None
        self.settings = RenderSettings()

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

    def new_shape(self, bsdf_id: int, emitter_id: int = INVALID) -> int:
        self.shape_bsdf.append(bsdf_id)
        self.shape_emitter.append(emitter_id)
        return len(self.shape_bsdf) - 1

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
        geom = make_geometry(tri, sph, disk, device=device)
        clusters = None
        if geom.n_tris > BRUTE_FORCE_MAX:
            clusters = build_hierarchy(
                *(np.asarray(tri[k], np.float32) for k in ("p0", "e1", "e2")),
                device=device)
        emitters = em.build_emitters(self.emitter_records,
                                     tri if tri is not None else {},
                                     bounding_sphere(tri, sph, disk),
                                     device=device)
        sensor = self.sensor or make_sensor(
            S_PERSPECTIVE, Transform.look_at([0, 0, -5], [0, 0, 0], [0, 1, 0]),
            aspect=self.settings.width / max(self.settings.height, 1),
            device=device)
        sensor = dataclasses.replace(
            sensor, **{k: getattr(sensor, k).to(device) for k in SENSOR_LEAVES})

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
            clusters=clusters,
        )
        return scene, self.settings


def bounding_sphere(tri: dict | None, sph: dict | None = None,
                    disk: dict | None = None):
    """(center, radius) of the scene's bounding sphere, for environment and
    directional emitters: the reference's host arithmetic
    (``scene/build.py:384-399``) over the triangle corners and the spheres'
    and disks' centres plus and minus their radii."""
    pts = []
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
