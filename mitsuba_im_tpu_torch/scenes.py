"""Built-in scenes of the port."""
from __future__ import annotations

import numpy as np

from .bsdf import common as bc
from .core.transform import Transform
from .core.types import entry_device
from .emitter import hosek
from .emitter import table as et
from .film.film import F_BOX
from .scene.build import SceneBuilder
from .scene.mesh import TriMesh
from .sensor.table import make_sensor, S_PERSPECTIVE


# the pinhole of the Cornell scenes (look_at origin, target, up; fov)
CORNELL_CAMERA = dict(origin=[0, 1, 3.9], target=[0, 1, 0], up=[0, 1, 0],
                      fov_deg=39.3)
# the sky's sun: 35 degrees above the horizon, 30 degrees off +z toward +x
# (behind the Cornell camera and the large scene's)
SUN_DIR = np.array([np.cos(np.radians(35)) * np.sin(np.radians(30)),
                    np.sin(np.radians(35)),
                    np.cos(np.radians(35)) * np.cos(np.radians(30))])


def _cornell_box(b):
    """The walls and the light of ``__graft_entry__._tiny_cornell`` into the
    builder ``b``: white floor, ceiling and back wall, red left and green
    right wall, a small warm area light (emitter 0) under the ceiling."""
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


def _cornell_sensor(b):
    """The Cornell pinhole as a host copy (``build()`` moves it to the
    scene's device)."""
    c = CORNELL_CAMERA
    b.sensor = make_sensor(
        S_PERSPECTIVE, Transform.look_at(c["origin"], c["target"], c["up"]),
        fov_deg=c["fov_deg"], device="cpu")


def tiny_cornell(device="cuda"):
    """The 12-triangle Cornell box of the JAX package's
    ``__graft_entry__._tiny_cornell`` (the bench's main-path scene).
    Returns (Scene, settings) on ``device``, the card unless the CPU is
    asked for."""
    device = entry_device(device)
    b = SceneBuilder()
    _cornell_box(b)
    _cornell_sensor(b)
    b.settings.width = b.settings.height = 32
    b.settings.spp = 1
    b.settings.rfilter = F_BOX
    b.settings.integrator = "path"
    b.settings.integrator_props = dict(max_depth=4)
    return b.build(device)


def icosahedron(center, radius: float, inward: bool = False) -> TriMesh:
    """A closed icosahedron of circumradius ``radius`` (12 vertices, 20
    faces), wound so that its face normals point out (in with
    ``inward``); no vertex normals, so a builder shades it with face
    normals."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    p = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                  [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                  [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], float)
    idx = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10],
                    [0, 10, 11], [1, 5, 9], [5, 11, 4], [11, 10, 2],
                    [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2], [3, 2, 6],
                    [3, 6, 8], [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10],
                    [8, 6, 7], [9, 8, 1]])
    n = np.cross(p[idx[:, 1]] - p[idx[:, 0]], p[idx[:, 2]] - p[idx[:, 0]])
    out = (n * p[idx].sum(1)).sum(1) > 0
    flip = out if inward else ~out
    idx[flip] = idx[flip][:, ::-1]
    p = p / np.linalg.norm(p[0]) * radius + np.asarray(center, float)
    return TriMesh(p, idx)


def _material_records():
    """One record of each of the thirteen untextured families after DIFFUSE
    and ROUGHCONDUCTOR: (record, inward) pairs; the twosided rough-diffuse
    one faces inward, so every hit on it is a back-face hit."""
    return [
        (bc.twosided(bc.diffuse_record([0.7, 0.5, 0.3], rough=True,
                                       alpha=0.5)), True),
        (bc.conductor_record("Au"), False),
        (bc.dielectric_record(), False),
        (bc.dielectric_record(kind=bc.THINDIELECTRIC,
                              transmittance=[0.9, 0.95, 0.8]), False),
        (bc.dielectric_record(kind=bc.ROUGHDIELECTRIC, alpha_u=0.08,
                              alpha_v=0.3, distribution="ggx"), False),
        (bc.plastic_record(diffuse=[0.1, 0.3, 0.6]), False),
        (bc.plastic_record(diffuse=[0.6, 0.2, 0.1], rough=True, alpha=0.2,
                           distribution="ggx"), False),
        (bc.phong_record(40.0, diffuse=[0.3, 0.5, 0.2], specular=0.3), False),
        (bc.ward_record(alpha_u=0.1, alpha_v=0.35, diffuse=[0.4, 0.4, 0.5],
                        specular=0.3), False),
        (bc.null_record(), False),
        (bc.difftrans_record([0.6, 0.7, 0.5]), False),
        (bc.coating_record(bc.diffuse_record([0.2, 0.6, 0.3]),
                           thickness=0.5, sigma_a=[0.2, 0.4, 0.8]), False),
        (bc.hk_record(sigma_s=[2.0, 1.5, 1.0], sigma_a=[0.05, 0.1, 0.2],
                      thickness=0.5, g=0.3), False),
    ]


def add_material_icosahedra(b):
    """The thirteen icosahedra of :func:`material_cornell` into the builder
    ``b`` (anything with the ``SceneBuilder`` interface), in three rows (5,
    4, 4) on and above the Cornell box's floor."""
    centres = ([(x, 0.17, 0.45) for x in (-0.72, -0.36, 0.0, 0.36, 0.72)]
               + [(x, 0.55, -0.1) for x in (-0.54, -0.18, 0.18, 0.54)]
               + [(x, 0.95, -0.55) for x in (-0.54, -0.18, 0.18, 0.54)])
    for (rec, inward), c in zip(_material_records(), centres):
        b.add_trimesh(icosahedron(c, 0.16, inward),
                      b.new_shape(b.add_bsdf(rec)))


def fill_material_cornell(b, sky_resolution: int = 256):
    """The scene content of :func:`material_cornell` into the builder ``b``:
    the Cornell box, the thirteen icosahedra and the sky (emitter 1).  The
    sensor and settings are left to the caller."""
    _cornell_box(b)
    add_material_icosahedra(b)
    b.add_emitter(hosek.sky_record(SUN_DIR, resolution=sky_resolution))


def material_cornell(device="cuda"):
    """The Cornell box with one closed 20-triangle icosahedron of each of
    the thirteen families after DIFFUSE and ROUGHCONDUCTOR (ROUGHDIFFUSE,
    twosided and facing inward; CONDUCTOR; DIELECTRIC; THINDIELECTRIC;
    ROUGHDIELECTRIC, anisotropic GGX; PLASTIC; ROUGHPLASTIC; PHONG; WARD;
    NULL; DIFFTRANS; COATING; HK), 272 triangles (brute force), lit by the
    area light and a Hosek sky (resolution 256, turbidity 3, albedo 0.15,
    the sun of ``SUN_DIR``) seen through the open front; face normals.
    ``bench.py``'s forward configuration: 1024^2, depth 5, 4 spp, box
    filter.  Returns (Scene, settings) on ``device``, the card unless the
    CPU is asked for."""
    device = entry_device(device)
    b = SceneBuilder()
    fill_material_cornell(b)
    _cornell_sensor(b)
    b.settings.width = b.settings.height = 1024
    b.settings.spp = 4
    b.settings.rfilter = F_BOX
    b.settings.integrator = "path"
    b.settings.integrator_props = dict(max_depth=5)
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
                n_tris_target: int = 1_120_000, env="constant"):
    """The large-scene configuration of ``bench.py``'s third metric
    (``bench_scenes.build_large_scene`` without the reference's bunny and
    envmap files): the displaced sphere (1,120,504 triangles at the
    default target) with smooth vertex normals, a GGX rough copper
    conductor of alpha 0.2, a 40-degree pinhole at (0, 0.05, 0.3) looking
    at the origin, the box filter, 1 spp and path depth 3.  The
    environment is ``env``: ``"constant"`` (unit radiance) or ``"sky"`` (a
    Hosek sky in place of the bench's envmap file: resolution 512,
    turbidity 3, albedo 0.15, the sun of ``SUN_DIR``).  Returns (Scene,
    settings) on ``device``, the card unless the CPU is asked for; the
    scene carries its cluster hierarchy."""
    device = entry_device(device)
    b = SceneBuilder()
    pos, idx = displaced_sphere(n_tris_target)
    mesh = TriMesh(pos, idx).compute_normals()
    bid = b.add_bsdf(bc.conductor_record(rough=True, alpha=0.2,
                                         distribution="ggx"))
    b.add_trimesh(mesh, b.new_shape(bid))
    if env == "constant":
        b.add_emitter(dict(type=et.EM_CONSTANT, radiance=np.ones(3),
                           weight=1.0))
    elif env == "sky":
        b.add_emitter(hosek.sky_record(SUN_DIR, resolution=512))
    else:
        raise ValueError(f"env {env!r}: 'constant' or 'sky'")
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
