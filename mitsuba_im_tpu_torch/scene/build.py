"""Host-side scene assembly (``mitsuba_im_tpu/scene/build.py``), numpy to
torch on a given device.

The subset the ported path needs: BSDF records, shapes, triangle meshes,
area, constant and environment-map emitters, a sensor, and the two-level
cluster hierarchy of scenes above ``BRUTE_FORCE_MAX`` triangles (analytic
shapes, media, subsurface, motion and instancing are not ported).  The host arithmetic
(float64 numpy, then one cast to float32) is the reference's, so a scene
built here has the same tables bit for bit as the same scene built by the
JAX package.
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
from .geometry import make_geometry
from .scene import Scene

_TRI_KEYS = ("p0", "e1", "e2", "n0", "n1", "n2", "uv0", "uv1", "uv2", "shape")


class SceneBuilder:
    def __init__(self):
        self.bsdf_records: list[dict] = []
        self.emitter_records: list[dict] = []
        self._tri: dict[str, list] = {k: [] for k in _TRI_KEYS}
        self.shape_bsdf: list[int] = []
        self.shape_emitter: list[int] = []
        self.sensor: Sensor | None = None
        self.settings = RenderSettings()

    def add_bsdf(self, record: dict) -> int:
        self.bsdf_records.append(record)
        return len(self.bsdf_records) - 1

    def new_shape(self, bsdf_id: int, emitter_id: int = INVALID) -> int:
        self.shape_bsdf.append(bsdf_id)
        self.shape_emitter.append(emitter_id)
        return len(self.shape_bsdf) - 1

    def add_trimesh(self, mesh, shape_id: int):
        """mesh: anything with positions, indices, normals and uvs."""
        p = np.asarray(mesh.positions, np.float64)
        idx = np.asarray(mesh.indices, np.int64)
        if len(idx) == 0:
            return
        p0 = p[idx[:, 0]]
        e1 = p[idx[:, 1]] - p0
        e2 = p[idx[:, 2]] - p0
        gn = np.cross(e1, e2)
        ln = np.linalg.norm(gn, axis=1, keepdims=True)
        gn = np.divide(gn, ln, out=np.zeros_like(gn), where=ln > 0)
        if mesh.normals is not None:
            n0, n1, n2 = (mesh.normals[idx[:, k]] for k in range(3))
        else:
            n0 = n1 = n2 = gn
        if mesh.uvs is not None:
            uv0, uv1, uv2 = (mesh.uvs[idx[:, k]] for k in range(3))
        else:
            uv0 = uv1 = uv2 = np.zeros((len(idx), 2))
        for k, a in zip(_TRI_KEYS, (p0, e1, e2, n0, n1, n2, uv0, uv1, uv2,
                                    np.full(len(idx), shape_id, np.int32))):
            self._tri[k].append(a)

    def add_emitter(self, record: dict) -> int:
        self.emitter_records.append(record)
        return len(self.emitter_records) - 1

    def build(self, device="cuda") -> tuple[Scene, RenderSettings]:
        """The Scene on ``device`` (the card unless the CPU is asked for)."""
        device = entry_device(device)
        tri = None
        if self._tri["p0"]:
            tri = {k: np.concatenate(a, axis=0) for k, a in self._tri.items()}
        geom = make_geometry(tri, device=device)
        clusters = None
        if geom.n_tris > BRUTE_FORCE_MAX:
            clusters = build_hierarchy(
                *(np.asarray(tri[k], np.float32) for k in ("p0", "e1", "e2")),
                device=device)
        emitters = em.build_emitters(self.emitter_records,
                                     tri if tri is not None else {},
                                     bounding_sphere(tri), device=device)
        sensor = self.sensor or make_sensor(
            S_PERSPECTIVE, Transform.look_at([0, 0, -5], [0, 0, 0], [0, 1, 0]),
            aspect=self.settings.width / max(self.settings.height, 1),
            device=device)
        sensor = dataclasses.replace(
            sensor, **{k: getattr(sensor, k).to(device) for k in SENSOR_LEAVES})

        scene = Scene(
            geom=geom,
            bsdfs=bc.build_table(self.bsdf_records, device=device),
            emitters=emitters,
            sensor=sensor,
            shape_bsdf=torch.tensor(self.shape_bsdf or [0], dtype=torch.int32,
                                    device=device),
            shape_emitter=torch.tensor(self.shape_emitter or [INVALID],
                                       dtype=torch.int32, device=device),
            clusters=clusters,
        )
        return scene, self.settings


def bounding_sphere(tri: dict | None):
    """(center, radius) of the scene's bounding sphere, for environment
    emitters: the reference's host arithmetic (``scene/build.py:384-399``)
    over the triangle corners (the port's builder adds no other shapes)."""
    if tri is None:
        return np.zeros(3), 1.0
    allp = np.concatenate([tri["p0"], tri["p0"] + tri["e1"],
                           tri["p0"] + tri["e2"]], axis=0)
    c = 0.5 * (allp.min(0) + allp.max(0))
    r = float(np.linalg.norm(allp - c, axis=1).max()) + 1e-3
    return c, r
