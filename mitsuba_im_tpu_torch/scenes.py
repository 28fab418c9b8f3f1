"""Built-in scenes of the port."""
from __future__ import annotations

import numpy as np

from .bsdf import common as bc
from .core.transform import Transform
from .emitter import table as et
from .film.film import F_BOX
from .scene.build import SceneBuilder
from .scene.mesh import TriMesh
from .sensor.table import make_sensor, S_PERSPECTIVE


def tiny_cornell(device="cpu"):
    """The 12-triangle Cornell box of the JAX package's
    ``__graft_entry__._tiny_cornell`` (the bench's main-path scene):
    white floor, ceiling and back wall, red left and green right wall, a
    small warm area light under the ceiling.  Returns (Scene, settings)."""
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

    b.sensor = make_sensor(
        S_PERSPECTIVE, Transform.look_at([0, 1, 3.9], [0, 1, 0], [0, 1, 0]),
        fov_deg=39.3,
    )
    b.settings.width = b.settings.height = 32
    b.settings.spp = 1
    b.settings.rfilter = F_BOX
    b.settings.integrator = "path"
    b.settings.integrator_props = dict(max_depth=4)
    return b.build(device)
