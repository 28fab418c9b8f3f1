"""Built-in scenes of the port."""
from __future__ import annotations

import numpy as np

from .bsdf import common as bc
from .core.transform import Transform
from .core.types import entry_device
from .emitter import table as et
from .film.film import F_BOX
from .scene.build import SceneBuilder
from .scene.mesh import TriMesh
from .sensor.table import make_sensor, S_PERSPECTIVE


def tiny_cornell(device="cuda"):
    """The 12-triangle Cornell box of the JAX package's
    ``__graft_entry__._tiny_cornell`` (the bench's main-path scene):
    white floor, ceiling and back wall, red left and green right wall, a
    small warm area light under the ceiling.  Returns (Scene, settings) on
    ``device``, the card unless the CPU is asked for."""
    device = entry_device(device)
    b = SceneBuilder()

    def quad(pts, normal):
        m = TriMesh(np.asarray(pts, float), np.array([[0, 1, 2], [2, 3, 0]]))
        m.normals = np.tile(np.asarray(normal, float)[None], (4, 1))
        m.uvs = np.zeros((4, 2))
        return m

    white = bc.default_record(); white["refl"] = np.full(3, 0.72)
    red = bc.default_record(); red["refl"] = np.array([0.63, 0.065, 0.05])
    green = bc.default_record(); green["refl"] = np.array([0.14, 0.45, 0.09])
    wid, rid, gid = b.add_bsdf(white), b.add_bsdf(red), b.add_bsdf(green)

    walls = [
        ([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]], [0, 1, 0], wid),   # floor
        ([[-1, 2, -1], [-1, 2, 1], [1, 2, 1], [1, 2, -1]], [0, -1, 0], wid),  # ceiling
        ([[-1, 0, -1], [-1, 2, -1], [1, 2, -1], [1, 0, -1]], [0, 0, 1], wid), # back
        ([[-1, 0, -1], [-1, 0, 1], [-1, 2, 1], [-1, 2, -1]], [1, 0, 0], rid), # left
        ([[1, 0, -1], [1, 2, -1], [1, 2, 1], [1, 0, 1]], [-1, 0, 0], gid),    # right
    ]
    for pts, n, bid in walls:
        b.add_trimesh(quad(pts, n), b.new_shape(bid))

    lsid = b.new_shape(b.add_bsdf(bc.default_record()))
    b.add_trimesh(
        quad([[-0.25, 1.99, -0.25], [0.25, 1.99, -0.25],
              [0.25, 1.99, 0.25], [-0.25, 1.99, 0.25]], [0, -1, 0]),
        lsid,
    )
    b.add_emitter(dict(type=et.EM_AREA, radiance=np.array([17.0, 12.0, 4.0]),
                       shape=lsid))
    b.shape_emitter[lsid] = 0

    b.sensor = make_sensor(  # a host copy; build() moves it to device
        S_PERSPECTIVE, Transform.look_at([0, 1, 3.9], [0, 1, 0], [0, 1, 0]),
        fov_deg=39.3, device="cpu",
    )
    b.settings.width = b.settings.height = 32
    b.settings.spp = 1
    b.settings.rfilter = F_BOX
    b.settings.integrator = "path"
    b.settings.integrator_props = dict(max_depth=4)
    return b.build(device)


def displaced_sphere(n_tris_target: int):
    """(positions, indices) of the large scene's procedural mesh: a UV
    sphere of radius 0.08 with radial noise, 2 (n - 1) n triangles for
    n = int(sqrt(n_tris_target / 2)) + 1 (``bench_scenes._displaced_sphere``,
    its loop vectorised; the same indices in the same order)."""
    n = int(np.sqrt(n_tris_target / 2)) + 1
    th = np.linspace(1e-3, np.pi - 1e-3, n)
    ph = np.linspace(0, 2 * np.pi, n, endpoint=False)
    T, P = np.meshgrid(th, ph, indexing="ij")
    r = 1.0 + 0.05 * np.sin(7 * T) * np.cos(9 * P)
    pos = np.stack([r * np.sin(T) * np.cos(P), r * np.cos(T),
                    r * np.sin(T) * np.sin(P)], -1).reshape(-1, 3) * 0.08
    i, j = np.meshgrid(np.arange(n - 1), np.arange(n), indexing="ij")
    j2 = (j + 1) % n
    a, b, c, d = i * n + j, i * n + j2, (i + 1) * n + j, (i + 1) * n + j2
    idx = np.stack([np.stack([a, b, d], -1), np.stack([d, c, a], -1)], 2)
    return pos, idx.reshape(-1, 3).astype(np.int64)


def large_scene(device="cuda", res: int = 768,
                n_tris_target: int = 1_120_000):
    """The large-scene configuration of ``bench.py``'s third metric
    (``bench_scenes.build_large_scene`` without the reference's bunny and
    envmap files): the displaced sphere (1,120,504 triangles at the
    default target) with smooth vertex normals, a GGX rough copper
    conductor of alpha 0.2, a unit constant environment, a 40-degree
    pinhole at (0, 0.05, 0.3) looking at the origin, the box filter, 1 spp
    and path depth 3.  Returns (Scene, settings) on ``device``, the card
    unless the CPU is asked for; the scene carries its cluster
    hierarchy."""
    device = entry_device(device)
    b = SceneBuilder()
    pos, idx = displaced_sphere(n_tris_target)
    mesh = TriMesh(pos, idx).compute_normals()
    bid = b.add_bsdf(bc.conductor_record(rough=True, alpha=0.2,
                                         distribution="ggx"))
    b.add_trimesh(mesh, b.new_shape(bid))
    b.add_emitter(dict(type=et.EM_CONSTANT, radiance=np.ones(3), weight=1.0))
    b.sensor = make_sensor(  # a host copy; build() moves it to device
        S_PERSPECTIVE,
        Transform.look_at([0.0, 0.05, 0.3], [0, 0, 0], [0, 1, 0]),
        fov_deg=40.0, device="cpu")
    b.settings.width = b.settings.height = res
    b.settings.spp = 1
    b.settings.rfilter = F_BOX
    b.settings.integrator = "path"
    b.settings.integrator_props = dict(max_depth=3)
    return b.build(device)
