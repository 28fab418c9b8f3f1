"""Built-in scenes of the port."""
from __future__ import annotations

import numpy as np

from .bsdf import common as bc
from .core.transform import Transform
from .core.types import entry_device
from . import emitter as emf
from . import film as filmf
from . import sampler as smp
from .emitter import hosek
from .emitter import table as et
from .film.film import F_BOX
from .media.medium import PH_HG, PH_KKAY, PH_MICROFLAKE, PH_MIX, PH_RAYLEIGH
from .scene import shapes
from .scene.build import SceneBuilder
from .scene.mesh import TriMesh
from .sensor.table import make_sensor, S_PERSPECTIVE, S_THINLENS
from . import texture as tex


# the pinhole of the Cornell scenes (look_at origin, target, up; fov)
CORNELL_CAMERA = dict(origin=[0, 1, 3.9], target=[0, 1, 0], up=[0, 1, 0],
                      fov_deg=39.3)
# the sky's sun: 35 degrees above the horizon, 30 degrees off +z toward +x
# (behind the Cornell camera and the large scene's)
SUN_DIR = np.array([np.cos(np.radians(35)) * np.sin(np.radians(30)),
                    np.sin(np.radians(35)),
                    np.cos(np.radians(35)) * np.cos(np.radians(30))])


# the Cornell box's quads: corners, wound so that the geometric normal
# faces out of the box, and the shading normal, which faces in; the floor,
# ceiling and back wall take white, the left wall red, the right green
_CORNELL_WALLS = (
    ([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]], [0, 1, 0]),    # floor
    ([[-1, 2, -1], [-1, 2, 1], [1, 2, 1], [1, 2, -1]], [0, -1, 0]),   # ceiling
    ([[-1, 0, -1], [-1, 2, -1], [1, 2, -1], [1, 0, -1]], [0, 0, 1]),  # back
    ([[-1, 0, -1], [-1, 0, 1], [-1, 2, 1], [-1, 2, -1]], [1, 0, 0]),  # left
    ([[1, 0, -1], [1, 2, -1], [1, 2, 1], [1, 0, 1]], [-1, 0, 0]),     # right
)
_CORNELL_LIGHT = [[-0.25, 1.99, -0.25], [0.25, 1.99, -0.25],
                  [0.25, 1.99, 0.25], [-0.25, 1.99, 0.25]]
_QUAD_UVS = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])


def _quad(pts, normal, uvs: bool = False, flip: bool = False) -> TriMesh:
    """Two triangles over four corners; per-corner uvs (0,0) (1,0) (1,1)
    (0,1) with ``uvs``, else zeros (``_tiny_cornell``'s).  ``flip`` winds
    them the other way, which turns their geometric normal around."""
    tris = [[0, 2, 1], [2, 0, 3]] if flip else [[0, 1, 2], [2, 3, 0]]
    m = TriMesh(np.asarray(pts, float), np.array(tris))
    m.normals = np.tile(np.asarray(normal, float)[None], (4, 1))
    m.uvs = _QUAD_UVS.copy() if uvs else np.zeros((4, 2))
    return m


def _cornell_light(b, uvs: bool = False, emit: bool = True):
    """The small warm area light under the ceiling (a quad that does not
    emit without ``emit``)."""
    lsid = b.new_shape(b.add_bsdf(bc.default_record()))
    b.add_trimesh(_quad(_CORNELL_LIGHT, [0, -1, 0], uvs), lsid)
    if emit:
        b.shape_emitter[lsid] = b.add_emitter(dict(
            type=et.EM_AREA, radiance=np.array([17.0, 12.0, 4.0]),
            shape=lsid))


def _cornell_box(b, light: bool = True):
    """The walls and the light of ``__graft_entry__._tiny_cornell`` into the
    builder ``b``: white floor, ceiling and back wall, red left and green
    right wall, a small warm area light (emitter 0; a quad that does not
    emit without ``light``) under the ceiling."""
    white = bc.default_record(); white["refl"] = np.full(3, 0.72)
    red = bc.default_record(); red["refl"] = np.array([0.63, 0.065, 0.05])
    green = bc.default_record(); green["refl"] = np.array([0.14, 0.45, 0.09])
    wid, rid, gid = b.add_bsdf(white), b.add_bsdf(red), b.add_bsdf(green)
    for (pts, n), bid in zip(_CORNELL_WALLS, (wid, wid, wid, rid, gid)):
        b.add_trimesh(_quad(pts, n), b.new_shape(bid))
    _cornell_light(b, emit=light)


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


def _noise_bitmap(gen, res: int, cells: int = 64) -> np.ndarray:
    """A (res, res, 3) float32 rgb image in [0.15, 0.85): seeded noise on a
    ``cells``^2 grid, interpolated bilinearly and periodically (so that
    it tiles).  Smooth between grid points: white noise at full resolution
    would make every unfiltered lookup at a secondary hit hang on the last
    bits of the hit point (a 1e-5 shift moves the value by ~1%)."""
    grid = gen.random((cells, cells, 3), np.float32)
    x = (np.arange(res) + 0.5) * (cells / res) - 0.5
    i0 = np.floor(x).astype(np.int64)
    f = (x - i0)[:, None, None]
    i0, i1 = i0 % cells, (i0 + 1) % cells
    rows = grid[i0] * (1 - f) + grid[i1] * f
    img = rows[:, i0] * (1 - f[:, 0][None]) + rows[:, i1] * f[:, 0][None]
    return (0.15 + 0.7 * img).astype(np.float32)


def _bump_maps(gen, res: int):
    """(height, normals) images of res^2: a height field of eight seeded
    sinusoids (1 to 4 cycles across) in [0, 1] and a tangent-space normal
    map ((n + 1) / 2) of eight more, both float32."""
    x = (np.arange(res) + 0.5) / res
    X, Y = np.meshgrid(x, x, indexing="xy")

    def waves():
        f = gen.integers(1, 5, (8, 2))
        ph = gen.random(8) * 2 * np.pi
        return sum(np.sin(2 * np.pi * (fx * X + fy * Y) + p)
                   for (fx, fy), p in zip(f, ph)) / 8.0

    h = 0.5 + 0.5 * waves()
    nt = np.stack([0.2 * waves(), 0.2 * waves(), np.ones_like(X)], -1)
    nt /= np.linalg.norm(nt, axis=-1, keepdims=True)
    return (np.repeat(h[..., None], 3, -1).astype(np.float32),
            (0.5 * (nt + 1.0)).astype(np.float32))


def _sphere_uvs(p: np.ndarray) -> np.ndarray:
    """(V, 2) spherical uvs of points about the origin: u the azimuth in
    [0, 1), v the polar angle from +y over pi."""
    r = np.linalg.norm(p, axis=1)
    u = np.arctan2(p[:, 2], p[:, 0]) / (2 * np.pi)
    v = np.arccos(np.clip(p[:, 1] / np.maximum(r, 1e-30), -1, 1)) / np.pi
    return np.stack([u % 1.0, v], -1)


def _white_maps(gen, bitmap_res: int, bump_res: int):
    """(bitmap, height, normals) of independent seeded texels: rgb in
    [0.15, 0.85), heights in [0, 1), tangent-space normals tilted up to
    ~0.2 in x and y, as ``_bump_maps`` encodes them."""
    bitmap = 0.15 + 0.7 * gen.random((bitmap_res, bitmap_res, 3),
                                     np.float32)
    height = np.repeat(gen.random((bump_res, bump_res, 1), np.float32), 3,
                       -1)
    nt = np.concatenate([gen.uniform(-0.2, 0.2, (bump_res, bump_res, 2)),
                         np.ones((bump_res, bump_res, 1))], -1)
    nt /= np.linalg.norm(nt, axis=-1, keepdims=True)
    return (bitmap.astype(np.float32), height,
            (0.5 * (nt + 1.0)).astype(np.float32))


def fill_textured_cornell(b, seed: int = 0, bitmap_res: int = 2048,
                          bump_res: int = 1024, white_noise: bool = False):
    """The content of :func:`textured_cornell` into the builder ``b``;
    returns the texture ids by name."""
    gen = np.random.default_rng(seed)
    tb = b.textures
    if white_noise:
        image, height, normals = _white_maps(gen, bitmap_res, bump_res)
    else:
        height, normals = _bump_maps(gen, bump_res)
        image = _noise_bitmap(gen, bitmap_res)
    t = dict(
        # tiled 4 x 2: the footprint's major axis stays clear of a tie on
        # the walls that show it (the filter picks its axis by lx2 >= ly2,
        # which rounding decides on a fronto-parallel wall of square texels)
        bitmap=tex.bitmap(tb, image, uscale=4.0, vscale=2.0),
        checker=tex.checkerboard(tb, 0.75, 0.2, uscale=4.0, vscale=4.0),
        grid=tex.gridtexture(tb, color0=0.1, color1=0.8, line_width=0.05,
                             uscale=3.0, vscale=3.0),
        opacity=tex.checkerboard(tb, 1.0, 0.15, uscale=2.0, vscale=2.0),
        height=tex.bitmap(tb, height, uscale=2.0, vscale=2.0),
        normals=tex.bitmap(tb, normals),
        alpha=tex.checkerboard(tb, 0.15, 0.4, uscale=3.0, vscale=3.0),
    )
    t["scaled"] = tex.scale(tb, t["bitmap"], scale=[0.9, 0.35, 0.25])

    def diffuse(rgb, refl_tex=None):
        rec = bc.diffuse_record(rgb)
        if refl_tex is not None:
            rec["refl_tex"] = refl_tex
        return rec

    floor = bc.bump(diffuse(0.72, t["checker"]), t["height"],
                    bc.BUMP_HEIGHT, scale=0.01)
    back = bc.bump(diffuse(0.72, t["bitmap"]), t["normals"], bc.BUMP_NORMAL)
    red = b.add_bsdf(diffuse([0.63, 0.065, 0.05]))
    scaled = b.add_bsdf(diffuse(0.5, t["scaled"]))
    green = b.add_bsdf(diffuse([0.14, 0.45, 0.09]))
    walls = (b.add_bsdf(floor), b.add_bsdf(diffuse(0.72, t["grid"])),
             b.add_bsdf(back), b.add_bsdf(bc.blend_record(red, scaled, 0.5)),
             b.add_bsdf(bc.mask_record(green, opacity_tex=t["opacity"])))
    # the walls wound to face into the box, as bump mapping keeps the
    # shading normal on the geometric normal's side
    for (pts, n), bid in zip(_CORNELL_WALLS, walls):
        b.add_trimesh(_quad(pts, n, uvs=True, flip=True), b.new_shape(bid))
    _cornell_light(b, uvs=True)
    metal = bc.conductor_record("Au", rough=True, distribution="ggx")
    metal["alpha_tex"] = t["alpha"]
    ball = icosahedron((-0.35, 0.3, -0.2), 0.28)
    ball.uvs = _sphere_uvs(ball.positions - np.array([-0.35, 0.3, -0.2]))
    b.add_trimesh(ball, b.new_shape(b.add_bsdf(metal)))
    return t


def textured_cornell(device="cuda", white_noise: bool = False):
    """The Cornell box with textured walls and every wrapper: 12 triangles of
    the walls and the light with uvs over each quad, and a 20-triangle GGX
    rough gold icosahedron with spherical uvs (32 triangles, brute force). The
    back wall shows a seeded 2048^2 rgb noise bitmap with its MIP pyramid,
    tiled 4 x 2 so that the pixel footprint spans levels (and its major axis is
    clear), under a normal map (1024^2); the floor a checkerboard under a
    height bump (1024^2, scale 0.01); the ceiling a grid; the left wall blends
    red diffuse with a diffuse of the bitmap scaled by (0.9, 0.35, 0.25)
    (weight 0.5); the right wall is green diffuse under a MASK whose opacity is
    a checkerboard of 1 and 0.15; the icosahedron's roughness is a checkerboard
    of 0.15 and 0.4 (``alpha_tex``). ``bench.py``'s forward configuration, as
    ``material_cornell``: 1024^2, depth 5, 4 spp, box filter. ``white_noise``
    fills the bitmap and both bump maps with independent texels instead
    (full-frequency content). Returns (Scene, settings) on ``device``, the card
    unless the CPU is asked for."""
    device = entry_device(device)
    b = SceneBuilder()
    fill_textured_cornell(b, white_noise=white_noise)
    _cornell_sensor(b)
    b.settings.width = b.settings.height = 1024
    b.settings.spp = 4
    b.settings.rfilter = F_BOX
    b.settings.integrator = "path"
    b.settings.integrator_props = dict(max_depth=5)
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


# the lights of lights_cornell, by name, in the order they are added
LIGHTS = ("triangle", "sphere", "disk", "point", "spot", "collimated")
# its thin lens: the Cornell pinhole's place and field of view, focused on
# the box's centre
LIGHTS_LENS = dict(aperture_radius=0.05,
                   focus_distance=float(np.linalg.norm(
                       np.subtract(CORNELL_CAMERA["origin"],
                                   CORNELL_CAMERA["target"]))))


def fill_lights_cornell(b, lights=LIGHTS):
    """The content of :func:`lights_cornell` into the builder ``b`` (the
    JAX package's too): the Cornell box with an analytic sphere and a disk
    in it; of ``lights``, only the named ones emit (the shapes stay)."""
    _cornell_box(b, light="triangle" in lights)
    white = b.add_bsdf(bc.diffuse_record(0.72))
    shapes.sphere(b, white, center=(-0.45, 0.3, 0.25), radius=0.18,
                  emitter=(emf.area([2.0, 4.0, 9.0]) if "sphere" in lights
                           else None))
    shapes.disk(b, white, to_world=(Transform.translate([0.45, 1.55, -0.35])
                                    @ Transform.rotate([1, 0, 0], 90.0)
                                    @ Transform.scale(0.16)),
                emitter=(emf.area([9.0, 6.0, 2.0]) if "disk" in lights
                         else None))
    if "point" in lights:
        b.add_emitter(emf.point([1.2, 1.2, 1.0], position=[0.55, 0.9, 0.5]))
    if "spot" in lights:
        b.add_emitter(emf.spot([6.0, 3.0, 3.0], cutoff_angle=25.0,
                               to_world=Transform.look_at(
                                   [-0.6, 1.8, -0.5], [-0.2, 0.0, 0.3],
                                   [0, 1, 0])))
    if "collimated" in lights:
        b.add_emitter(emf.collimated([5.0, 5.0, 5.0], to_world=(
            Transform.look_at([0.1, 1.8, 0.6], [0.1, 0.0, 0.4], [0, 0, 1]))))


def lights_cornell(device="cuda", lights=LIGHTS):
    """The Cornell box (``_tiny_cornell``'s 12 triangles and its triangle
    area light) with an analytic sphere area light (radius 0.18, bluish)
    on the floor and a disk area light (radius 0.16, warm) facing down
    under the ceiling, a point light, a spot light aimed at the floor
    (cutoff 25 degrees) and a collimated beam; of ``lights`` (names in
    ``LIGHTS``) only the named ones emit.  Seen through a thin lens at the
    Cornell pinhole's place (aperture radius 0.05, focused on the box's
    centre).  ``bench.py``'s forward configuration with hdrfilm's
    defaults: 1024^2, depth 5, 4 spp of ``ldsampler``, the Gaussian filter
    of radius 2.  12 triangles: the brute-force kernels.  Returns (Scene,
    settings) on ``device``, the card unless the CPU is asked for."""
    device = entry_device(device)
    b = SceneBuilder()
    fill_lights_cornell(b, lights)
    c = CORNELL_CAMERA
    b.sensor = make_sensor(
        S_THINLENS, Transform.look_at(c["origin"], c["target"], c["up"]),
        fov_deg=c["fov_deg"], **LIGHTS_LENS, device="cpu")
    filmf.hdrfilm(b.settings, 1024, 1024, rfilter=filmf.gaussian())
    smp.ldsampler(sample_count=4, settings=b.settings)
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


def _sphere_corner_uvs(idx: np.ndarray, n: int) -> np.ndarray:
    """(T, 3, 2) per-corner uvs of :func:`displaced_sphere`'s grid (vertex
    i n + j at u = j / n, v = i / (n - 1)); a triangle across the seam
    takes u = 1 where its corner wraps to j = 0."""
    i, j = idx // n, (idx % n).astype(np.float64)
    seam = (j.max(1, keepdims=True) == n - 1) & (j == 0)
    j = np.where(seam, float(n), j)
    return np.stack([j / n, i / (n - 1.0)], -1)


ENVS = ("constant", "sky", "sunsky")
SPHERE_RADIUS = 0.08  # displaced_sphere's
MOTION_SHIFT = SPHERE_RADIUS / 5.0  # the deformable large scene's frame 1


def fill_large_scene(b, n_tris_target: int = 1_120_000, env="constant",
                     texture: bool = False, motion: bool = False):
    """The content of :func:`large_scene` (mesh, material, emitters) into
    the builder ``b`` (the JAX package's too, without ``texture``); with
    ``motion`` the mesh is deformable, its frame 1 frame 0 moved by a fifth
    of its radius along x (``MOTION_SHIFT``)."""
    if env not in ENVS:
        raise ValueError(f"env {env!r}: one of {ENVS}")
    pos, idx = displaced_sphere(n_tris_target)
    mesh = TriMesh(pos, idx).compute_normals()
    rec = bc.conductor_record(rough=True, alpha=0.2, distribution="ggx")
    corner_uvs = None
    if texture:
        gen = np.random.default_rng(0)
        rec["spec_tex"] = tex.bitmap(b.textures, _noise_bitmap(gen, 2048),
                                     uscale=2.0)
        corner_uvs = _sphere_corner_uvs(idx, int(np.sqrt(n_tris_target / 2))
                                        + 1)
    bid = b.add_bsdf(rec)
    if motion:
        moved = TriMesh(pos + [MOTION_SHIFT, 0.0, 0.0], idx).compute_normals()
        b.add_trimesh_motion(mesh, moved, b.new_shape(bid))
    else:
        b.add_trimesh(mesh, b.new_shape(bid), corner_uvs=corner_uvs)
    if env == "constant":
        b.add_emitter(emf.constant(1.0))
    elif env == "sky":
        b.add_emitter(hosek.sky_record(SUN_DIR, resolution=512))
    else:
        for rec in emf.sunsky(sky_model="preetham", resolution=512,
                              turbidity=3.0):
            b.add_emitter(rec)


# the large scene's pinhole (look_at origin, target, up; fov)
LARGE_CAMERA = dict(origin=[0.0, 0.05, 0.3], target=[0, 0, 0], up=[0, 1, 0],
                    fov_deg=40.0)


def large_scene(device="cuda", res: int = 768,
                n_tris_target: int = 1_120_000, env="constant",
                texture: bool = False, motion: bool = False):
    """The large-scene configuration of ``bench.py``'s third metric
    (``bench_scenes.build_large_scene`` without the reference's bunny and
    envmap files): the displaced sphere (1,120,504 triangles at the
    default target) with smooth vertex normals, a GGX rough copper
    conductor of alpha 0.2, a 40-degree pinhole at (0, 0.05, 0.3) looking
    at the origin, the box filter, 1 spp and path depth 3.  The
    environment is ``env``: ``"constant"`` (unit radiance), ``"sky"`` (a
    Hosek sky in place of the bench's envmap file: resolution 512,
    turbidity 3, albedo 0.15, the sun of ``SUN_DIR``) or ``"sunsky"`` (a
    Preetham sky of resolution 512 and turbidity 3 and the sun, a
    directional delta light, both at the ephemeris's default date and
    place; 2 spp of the ``sobol`` sampler and the Mitchell filter).  With
    ``texture`` the mesh gets spherical per-corner uvs and a seeded 2048^2
    rgb noise bitmap with its MIP pyramid (tiled 2 x 1) on the conductor's
    specular reflectance (a conductor does not read ``refl``), so the
    hierarchy's path reads uvs from the packed shading rows and filters
    the bitmap.  Returns (Scene, settings) on ``device``, the card unless
    the CPU is asked for; the scene carries its cluster hierarchy.  With
    ``motion`` the mesh is a deformable whose frame 1 is frame 0 moved
    by ``MOTION_SHIFT`` along x, the shutter open from 0 to 1, and the
    hierarchy the motion hierarchy."""
    device = entry_device(device)
    b = SceneBuilder()
    fill_large_scene(b, n_tris_target, env, texture, motion)
    c = LARGE_CAMERA
    b.sensor = make_sensor(  # a host copy; build() moves it to device
        S_PERSPECTIVE, Transform.look_at(c["origin"], c["target"], c["up"]),
        fov_deg=c["fov_deg"], shutter_time=1.0 if motion else 0.0,
        device="cpu")
    b.settings.width = b.settings.height = res
    b.settings.spp = 1
    b.settings.rfilter = F_BOX
    if env == "sunsky":
        filmf.hdrfilm(b.settings, res, res, rfilter=filmf.mitchell())
        smp.sobol(sample_count=2, settings=b.settings)
    b.settings.integrator = "path"
    b.settings.integrator_props = dict(max_depth=3)
    return b.build(device)


# the deformable quad of motion_cornell: its corners at frame 0 (frame 1
# is this moved by 1.2 along x), facing the camera
_SLIDER = [[-0.85, 0.3, 0.2], [-0.35, 0.3, 0.2], [-0.35, 0.9, 0.2],
           [-0.85, 0.9, 0.2]]


def motion_cornell(device="cuda"):
    """:func:`tiny_cornell` with a two-triangle deformable quad (diffuse
    0.8) that slides 1.2 along x across the box while the shutter is open
    (0 to 1).  Returns (Scene, settings) on ``device``."""
    device = entry_device(device)
    b = SceneBuilder()
    _cornell_box(b)
    rec = bc.default_record()
    rec["refl"] = np.full(3, 0.8)
    sid = b.new_shape(b.add_bsdf(rec))
    b.add_trimesh_motion(_quad(_SLIDER, [0, 0, 1]),
                         _quad(np.asarray(_SLIDER) + [1.2, 0.0, 0.0],
                               [0, 0, 1]), sid)
    c = CORNELL_CAMERA
    b.sensor = make_sensor(
        S_PERSPECTIVE, Transform.look_at(c["origin"], c["target"], c["up"]),
        fov_deg=c["fov_deg"], shutter_time=1.0, device="cpu")
    b.settings.width = b.settings.height = 32
    b.settings.spp = 1
    b.settings.rfilter = F_BOX
    b.settings.integrator_props = dict(max_depth=4)
    return b.build(device)


def _instance_transforms(n_side: int, spacing: float):
    """(3, 4) transforms of an n_side x n_side grid in the xy plane: each
    rotated about y by its own angle and uniformly scaled by 0.7-1.0."""
    out = []
    for k in range(n_side * n_side):
        i, j = divmod(k, n_side)
        xf = (Transform.translate([(j - (n_side - 1) / 2) * spacing,
                                   (i - (n_side - 1) / 2) * spacing, 0.0])
              @ Transform.rotate([0, 1, 0], 23.0 * k)
              @ Transform.scale([0.7 + 0.3 * ((k * 7) % 5) / 4.0] * 3))
        out.append(np.asarray(xf.m)[:3, :4])
    return out


INSTANCED_CAMERA = dict(target=[0, 0, 0], up=[0, 1, 0], fov_deg=40.0)


def instanced_scene(device="cuda", res: int = 768, n_side: int = 4,
                    n_tris_target: int = 1_120_000, expanded: bool = False):
    """Shared-BLAS instancing: the large scene's displaced sphere (GGX
    rough copper of alpha 0.2) as one shapegroup, instanced n_side x
    n_side times in a grid (rotations about y, uniform scales 0.7-1.0),
    under the unit constant environment, box filter, path depth 3.  With
    ``expanded`` each instance is a world-space copy of the mesh instead
    (the same picture from n_side^2 times the triangles).  Returns (Scene,
    settings) on ``device``."""
    device = entry_device(device)
    b = SceneBuilder()
    pos, idx = displaced_sphere(n_tris_target)
    mesh = TriMesh(pos, idx).compute_normals()
    bid = b.add_bsdf(bc.conductor_record(rough=True, alpha=0.2,
                                         distribution="ggx"))
    xfs = _instance_transforms(n_side, spacing=2.4 * SPHERE_RADIUS)
    if expanded:
        for m in xfs:
            xf = Transform(np.concatenate([m, [[0, 0, 0, 1]]]))
            b.add_trimesh(mesh.transformed(xf), b.new_shape(bid))
    else:
        b.begin_group("mesh")
        b.add_trimesh(mesh, b.new_shape(bid))
        b.end_group("mesh")
        for m in xfs:
            b.add_instance("mesh", m)
    b.add_emitter(emf.constant(1.0))
    dist = 1.3 * n_side * 2.4 * SPHERE_RADIUS / (2 * np.tan(np.radians(20)))
    c = INSTANCED_CAMERA
    b.sensor = make_sensor(
        S_PERSPECTIVE, Transform.look_at([0.0, 0.05, dist], c["target"],
                                         c["up"]),
        fov_deg=c["fov_deg"], device="cpu")
    b.settings.width = b.settings.height = res
    b.settings.spp = 1
    b.settings.rfilter = F_BOX
    b.settings.integrator_props = dict(max_depth=3)
    return b.build(device)


# a 2/2 twill with a staple warp yarn (the twill of tests/test_irawan.py,
# its alpha given)
TWILL = """
weave {
  name = "twill",
  alpha = 0.25, beta = 4.0, ss = 0.5, hWidth = 0.5,
  warpArea = 3.0, weftArea = 1.0,
  tileWidth = 4, tileHeight = 4,
  fineness = 0.0, period = 0.0,
  pattern {
    1, 2, 2, 2,
    2, 1, 2, 2,
    2, 2, 1, 2,
    2, 2, 2, 1
  },
  yarn { type = warp, psi = 30, umax = 25, kappa = 1.0,
         width = 2.0, length = 4.0, centerU = 0.5, centerV = 0.5,
         kd = {0.2, 0.1, 0.05}, ks = {0.3, 0.3, 0.3} },
  yarn { type = weft, psi = 0, umax = 30, kappa = -0.5,
         width = 2.0, length = 4.0, centerU = 0.5, centerV = 0.5,
         kd = {0.1, 0.15, 0.2}, ks = {0.25, 0.3, 0.35} }
}
"""


def irawan_cornell(device="cuda"):
    """The Cornell box with woven cloth: the built-in plain weave on the
    floor (repeated 8 x 8) and :data:`TWILL` on the back wall (6 x 6), both
    with uvs over their quads.  Returns (Scene, settings) on ``device``."""
    from .bsdf import irawan as ir

    device = entry_device(device)
    b = SceneBuilder()
    white = bc.default_record(); white["refl"] = np.full(3, 0.72)
    red = bc.default_record(); red["refl"] = np.array([0.63, 0.065, 0.05])
    green = bc.default_record(); green["refl"] = np.array([0.14, 0.45, 0.09])
    cloth = []
    for text, rep in ((ir.PLAIN_WEAVE, 8.0), (TWILL, 6.0)):
        rec = bc.default_record()
        rec["type"] = bc.IRAWAN
        rec["weave"] = ir.compute_normalization(
            ir.parse_weave(text, repeatU=rep, repeatV=rep))
        cloth.append(b.add_bsdf(rec))
    wid, rid, gid = b.add_bsdf(white), b.add_bsdf(red), b.add_bsdf(green)
    for (pts, n), bid in zip(_CORNELL_WALLS,
                             (cloth[0], wid, cloth[1], rid, gid)):
        b.add_trimesh(_quad(pts, n, uvs=True), b.new_shape(bid))
    _cornell_light(b)
    _cornell_sensor(b)
    b.settings.width = b.settings.height = 32
    b.settings.spp = 1
    b.settings.rfilter = F_BOX
    b.settings.integrator_props = dict(max_depth=4)
    return b.build(device)


# ---------------------------------------------------------------------------
# participating media
# ---------------------------------------------------------------------------

# volume_cornell's three icosahedra: centres on the floor, circumradius
VOLUME_CENTRES = ((-0.5, 0.33, 0.2), (0.02, 0.33, -0.42), (0.52, 0.33, 0.25))
VOLUME_RADIUS = 0.32


def cloud_density(res: int, seed: int = 0) -> np.ndarray:
    """A (res, res, res) float32 smooth procedural cloud in [0, 1] over the
    grid's cube: a radial falloff times eight seeded low-frequency
    sinusoids, its maximum 1."""
    gen = np.random.default_rng(seed)
    g = np.linspace(-1.0, 1.0, res)
    Z, Y, X = np.meshgrid(g, g, g, indexing="ij")
    falloff = np.clip(1.0 - np.sqrt(X * X + Y * Y + Z * Z), 0.0, 1.0)
    noise = np.zeros_like(X)
    for _ in range(8):
        f = gen.uniform(1.0, 4.0, 3) * gen.choice([-1.0, 1.0], 3)
        noise += np.sin(np.pi * (f[0] * X + f[1] * Y + f[2] * Z)
                        + gen.uniform(0, 2 * np.pi))
    noise = 0.5 + noise / 16.0  # in [0, 1]
    d = falloff * (0.3 + 0.7 * noise)
    return (d / d.max()).astype(np.float32)


def swirl_orientation(res: int) -> np.ndarray:
    """A (res, res, res, 3) float32 fiber-axis field over the grid's cube:
    a swirl about +y, (-z, 0.5, x), not normalized (the medium normalizes
    it where it reads it)."""
    g = np.linspace(-1.0, 1.0, res)
    Z, Y, X = np.meshgrid(g, g, g, indexing="ij")
    return np.stack([-Z, np.full_like(X, 0.5), X], -1).astype(np.float32)


def volume_records(grid_res: int = 128, ori_res: int = 32) -> list[dict]:
    """The four media of :func:`volume_cornell`, as the ``media``
    factories record them: the camera's fog (sigmaS 0.04, sigmaA 0.01, a
    mixture of HG g 0.7 (0.6) and Rayleigh (0.4)); a homogeneous medium
    (sigmaS (2.0, 1.6, 1.2), sigmaA 0.1, HG g 0.6); a grid medium over the
    second icosahedron's box (a ``grid_res``^3 :func:`cloud_density`, scale
    6, constant albedo 0.9, microflake of stddev 0.3 along a ``ori_res``^3
    :func:`swirl_orientation`); a homogeneous medium of sigmaT 1.5, albedo
    0.8 and the Kajiya-Kay phase."""
    c = np.asarray(VOLUME_CENTRES[1], np.float64)
    box = dict(bmin=c - VOLUME_RADIUS, bmax=c + VOLUME_RADIUS)
    const_albedo = dict(data=np.full((1, 1, 1, 3), 0.9, np.float32),
                        bmin=np.full(3, -1e30), bmax=np.full(3, 1e30),
                        const=True)
    return [
        dict(kind="homogeneous", sigma_s=np.full(3, 0.04),
             sigma_a=np.full(3, 0.01), scale=1.0,
             phase=dict(type=PH_MIX, g=0.0, components=[
                 (0.6, dict(type=PH_HG, g=0.7)),
                 (0.4, dict(type=PH_RAYLEIGH, g=0.0))])),
        dict(kind="homogeneous", sigma_s=np.array([2.0, 1.6, 1.2]),
             sigma_a=np.full(3, 0.1), scale=1.0,
             phase=dict(type=PH_HG, g=0.6)),
        dict(kind="heterogeneous", scale=6.0,
             density=dict(box, data=cloud_density(grid_res)[..., None]),
             albedo=const_albedo,
             orientation=dict(box, data=swirl_orientation(ori_res)),
             phase=dict(type=PH_MICROFLAKE, g=0.0, stddev=0.3)),
        dict(kind="homogeneous", sigma_s=np.full(3, 1.5 * 0.8),
             sigma_a=np.full(3, 1.5 * (1 - 0.8)), scale=1.0,
             phase=dict(type=PH_KKAY, g=0.0, kd=0.2, ks=0.4,
                        exponent=4.0)),
    ]


def volume_cornell(device="cuda", grid_res: int = 128, ori_res: int = 32):
    """``_tiny_cornell``'s box and area light with three closed 20-triangle
    icosahedra on the floor (72 triangles, brute force): a ``null``
    boundary around a homogeneous HG medium, a ``null`` boundary around a
    grid medium (a ``grid_res``^3 float32 cloud, 8 MiB at 128, scale 6,
    albedo 0.9, microflake phase along a ``ori_res``^3 swirl), and a
    dielectric (intIOR 1.33) around a homogeneous Kajiya-Kay medium; the
    camera and the icosahedra's outsides in a thin fog with a mixture
    phase (:func:`volume_records`).  ``volpath`` at 1024^2, depth 5, 4
    spp, the box filter, the independent sampler.  Returns (Scene,
    settings) on ``device``, the card unless the CPU is asked for."""
    device = entry_device(device)
    b = SceneBuilder()
    _cornell_box(b)
    fog, homog, grid, kkay = (b.add_medium(r)
                              for r in volume_records(grid_res, ori_res))
    null = b.add_bsdf(bc.null_record())
    water = b.add_bsdf(bc.dielectric_record(int_ior=1.33))
    for c, bid, mid in zip(VOLUME_CENTRES, (null, null, water),
                           (homog, grid, kkay)):
        b.add_trimesh(icosahedron(c, VOLUME_RADIUS),
                      b.new_shape(bid, interior=mid, exterior=fog))
    b.camera_medium = fog
    _cornell_sensor(b)
    b.settings.width = b.settings.height = 1024
    b.settings.spp = 4
    b.settings.rfilter = F_BOX
    b.settings.integrator = "volpath"
    b.settings.integrator_props = dict(max_depth=5)
    return b.build(device)


def volume_large(device="cuda", res: int = 768,
                 n_tris_target: int = 1_120_000):
    """The large scene's displaced sphere (1,120,504 triangles at the
    default target, the hierarchy route) as a ``null`` boundary around a
    homogeneous medium (sigmaS 3, sigmaA 0.3, HG g 0.5) under the unit
    constant environment, through the large scene's pinhole; ``volpath``
    at ``res``^2, depth 3, 2 spp, the box filter.  Returns (Scene,
    settings) on ``device``; the scene carries its cluster hierarchy."""
    device = entry_device(device)
    b = SceneBuilder()
    pos, idx = displaced_sphere(n_tris_target)
    mid = b.add_medium(dict(kind="homogeneous", sigma_s=np.full(3, 3.0),
                            sigma_a=np.full(3, 0.3), scale=1.0,
                            phase=dict(type=PH_HG, g=0.5)))
    b.add_trimesh(TriMesh(pos, idx).compute_normals(),
                  b.new_shape(b.add_bsdf(bc.null_record()), interior=mid))
    b.add_emitter(emf.constant(1.0))
    c = LARGE_CAMERA
    b.sensor = make_sensor(  # a host copy; build() moves it to device
        S_PERSPECTIVE, Transform.look_at(c["origin"], c["target"], c["up"]),
        fov_deg=c["fov_deg"], device="cpu")
    b.settings.width = b.settings.height = res
    b.settings.spp = 2
    b.settings.rfilter = F_BOX
    b.settings.integrator = "volpath"
    b.settings.integrator_props = dict(max_depth=3)
    return b.build(device)


# ---------------------------------------------------------------------------
# subsurface scattering
# ---------------------------------------------------------------------------

# the Cornell blocks: (centre x, centre z, width, depth, height, turn about
# y in degrees); the tall and the short block, and a third, small one
SUBSURFACE_BLOCKS = ((-0.35, -0.3, 0.55, 0.55, 1.2, 20.0),
                     (0.4, 0.3, 0.55, 0.55, 0.6, -18.0),
                     (-0.1, 0.55, 0.35, 0.35, 0.35, 40.0))
# sigma_tr = sqrt(3 sigma_a (sigma_s + sigma_a)) of the dipole record below
# is (15.9, 23.0, 33.9) a unit: diffusion lengths 0.063, 0.043, 0.029,
# 0.05-0.11 of the blocks' 0.55 width; its cell 4 / 15.9 = 0.25
SUBSURFACE_DIPOLE = dict(sigma_s=np.full(3, 40.0),
                         sigma_a=np.array([2.0, 4.0, 8.0]))
# mean free paths 1 / sigma_t of 0.12, 0.11, 0.10: about a fifth of the
# short block's width
SUBSURFACE_SINGLE = dict(sigma_s=np.full(3, 8.0),
                         sigma_a=np.array([0.5, 1.0, 2.0]))


def subsurface_record(kind: str = "dipole", scale: float = 1.0,
                      tint=(1.0, 1.0, 1.0)) -> dict:
    """A ``dipole`` or ``singlescatter`` record as its factory records it
    (g 0, eta 1.33): :data:`SUBSURFACE_DIPOLE` or
    :data:`SUBSURFACE_SINGLE`, scaled by ``scale`` (lengths / ``scale``)
    and sigma_a by ``tint``."""
    if kind not in ("dipole", "singlescatter"):
        raise ValueError(f"subsurface kind {kind!r}")
    c = SUBSURFACE_DIPOLE if kind == "dipole" else SUBSURFACE_SINGLE
    return dict(sigma_s=c["sigma_s"] * scale,
                sigma_a=c["sigma_a"] * np.asarray(tint, np.float64) * scale,
                g=0.0, eta=1.33, single=kind == "singlescatter")


def block_mesh(cx, cz, w, d, h, turn_deg) -> TriMesh:
    """A closed box of 12 triangles on the floor (y 0 to ``h``), ``w`` x
    ``d`` turned about y, wound so that every geometric normal faces out
    (face normals: no vertex normals)."""
    a = np.radians(turn_deg)
    rot = np.array([[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0],
                    [-np.sin(a), 0.0, np.cos(a)]])
    corners = np.array([[x * w / 2, y * h, z * d / 2] for x in (-1, 1)
                        for y in (0, 1) for z in (-1, 1)])
    p = corners @ rot.T + [cx, 0.0, cz]
    quads = ((0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3))
    centre = p.mean(0)
    idx = []
    for q in quads:
        for tri in ((q[0], q[1], q[2]), (q[2], q[3], q[0])):
            n = np.cross(p[tri[1]] - p[tri[0]], p[tri[2]] - p[tri[0]])
            if np.dot(n, p[list(tri)].mean(0) - centre) < 0:
                tri = (tri[0], tri[2], tri[1])
            idx.append(tri)
    return TriMesh(p, np.array(idx, np.int64))


def fill_subsurface_cornell(b, grid: bool = False):
    """The content of :func:`subsurface_cornell` (or, with ``grid``, of
    :func:`subsurface_grid`) into the builder ``b`` (the JAX package's
    too): ``_tiny_cornell``'s box and light and the blocks of
    :data:`SUBSURFACE_BLOCKS` under a dim diffuse coat (reflectance 0.1),
    each with its subsurface record."""
    _cornell_box(b)
    coat = bc.default_record()
    coat["refl"] = np.full(3, 0.1)
    cid = b.add_bsdf(coat)
    if grid:
        recs = [subsurface_record("dipole", tint=t)
                for t in ((1.0, 1.0, 1.0), (4.0, 1.0, 0.5),
                          (0.5, 1.0, 4.0))]
    else:
        recs = [subsurface_record("dipole"),
                subsurface_record("singlescatter")]
    for blk, rec in zip(SUBSURFACE_BLOCKS, recs):
        b.add_trimesh(block_mesh(*blk),
                      b.new_shape(cid, subsurface=b.add_subsurface(rec)))


def _subsurface_settings(b, res: int, depth: int):
    b.settings.width = b.settings.height = res
    b.settings.spp = 1
    b.settings.rfilter = F_BOX
    b.settings.integrator = "path"
    b.settings.integrator_props = dict(max_depth=depth)


def subsurface_cornell(device="cuda", res: int = 1024):
    """The Cornell box with a tall 12-triangle block under ``dipole``
    (sigmaS 40, sigmaA (2, 4, 8): diffusion lengths 0.063, 0.043, 0.029,
    one record of 512 points, the dense branch) and a short block under
    ``singlescatter`` (sigmaS 8, sigmaA (0.5, 1, 2)), both eta 1.33 under a
    diffuse coat of reflectance 0.1; ``path`` at ``res``^2, depth 5, 1 spp,
    the box filter.  Returns (Scene, settings) on ``device``, the card
    unless the CPU is asked for."""
    device = entry_device(device)
    b = SceneBuilder()
    fill_subsurface_cornell(b)
    _cornell_sensor(b)
    _subsurface_settings(b, res, 5)
    return b.build(device)


def subsurface_grid(device="cuda", res: int = 256):
    """The box of :func:`subsurface_cornell` with three dipole blocks (the
    tall, the short and a small one; sigma_a tinted (1, 1, 1), (4, 1, 0.5)
    and (0.5, 1, 4)): three records of 512 points, 1,536 > 1,024, so
    shading takes the hash grid's 27-cell scan; ``path`` at ``res``^2,
    depth 5, 1 spp."""
    device = entry_device(device)
    b = SceneBuilder()
    fill_subsurface_cornell(b, grid=True)
    _cornell_sensor(b)
    _subsurface_settings(b, res, 5)
    return b.build(device)


def fill_subsurface_large(b, kind: str = "dipole",
                          n_tris_target: int = 1_120_000):
    """The content of :func:`subsurface_large` into the builder ``b``."""
    pos, idx = displaced_sphere(n_tris_target)
    coat = bc.default_record()
    coat["refl"] = np.full(3, 0.1)
    # lengths scaled to the 0.08 sphere: diffusion lengths 0.0105, 0.0072,
    # 0.0049 (dipole), mean free paths 0.020-0.017 (singlescatter)
    rec = subsurface_record(kind, scale=6.0)
    b.add_trimesh(TriMesh(pos, idx).compute_normals(),
                  b.new_shape(b.add_bsdf(coat),
                              subsurface=b.add_subsurface(rec)))
    b.add_emitter(emf.constant(1.0))


def subsurface_large(device="cuda", kind: str = "dipole", res: int = 768,
                     n_tris_target: int = 1_120_000):
    """The large scene's displaced sphere (1,120,504 triangles at the
    default target, the hierarchy route) under a diffuse coat of
    reflectance 0.1 and a ``kind`` record (``dipole``: 512 points, the
    dense branch; ``singlescatter``) with lengths scaled by 1/6 to the
    sphere, under the unit constant environment, through the large
    scene's pinhole; ``path`` at ``res``^2, depth 3, 1 spp.  Returns
    (Scene, settings) on ``device``."""
    device = entry_device(device)
    b = SceneBuilder()
    fill_subsurface_large(b, kind, n_tris_target)
    c = LARGE_CAMERA
    b.sensor = make_sensor(  # a host copy; build() moves it to device
        S_PERSPECTIVE, Transform.look_at(c["origin"], c["target"], c["up"]),
        fov_deg=c["fov_deg"], device="cpu")
    _subsurface_settings(b, res, 3)
    return b.build(device)


# the caustic Cornell box's glass sphere: on the floor, right of centre
CAUSTIC_SPHERE = ((0.35, 0.4, 0.1), 0.4)


def fill_caustic_cornell(b):
    """The content of :func:`caustic_cornell` into the builder ``b`` (the
    JAX package's too): ``_tiny_cornell``'s box and light with the back
    wall a smooth perfect mirror (conductor ``none``, its 2 triangles) and
    a smooth glass sphere (``dielectric``, bk7 in air, the port's analytic
    sphere) of :data:`CAUSTIC_SPHERE`."""
    white = bc.default_record(); white["refl"] = np.full(3, 0.72)
    red = bc.default_record(); red["refl"] = np.array([0.63, 0.065, 0.05])
    green = bc.default_record(); green["refl"] = np.array([0.14, 0.45, 0.09])
    wid, rid, gid = b.add_bsdf(white), b.add_bsdf(red), b.add_bsdf(green)
    mirror = b.add_bsdf(bc.conductor_record("none"))
    for (pts, n), bid in zip(_CORNELL_WALLS, (wid, wid, mirror, rid, gid)):
        b.add_trimesh(_quad(pts, n), b.new_shape(bid))
    _cornell_light(b)
    glass = b.add_bsdf(bc.dielectric_record())
    b.add_sphere(CAUSTIC_SPHERE[0], CAUSTIC_SPHERE[1], b.new_shape(glass))


def caustic_cornell(device="cuda", res: int = 1024):
    """The Cornell box with a mirror back wall and a glass sphere
    (:func:`fill_caustic_cornell`), the scene of the manifold
    perturbation: diffuse -> mirror -> diffuse eye paths (mlt's pattern (0,
    1)), diffuse -> glass -> glass -> diffuse ((0, 2)), and paths seen
    through the sphere or in the mirror first ((2, 1), (2, 2)): of 4,096
    random tables at depth 5 (a 64^2 image's worth), 6.7%, 3.4% and 0.44%
    match (0, 1), (0, 2) and (2, 1).  The walls,
    the mirror and the light are triangles (``tri_closest``/``tri_anyhit``);
    the sphere is analytic.  ``mlt`` (bidirectional) at ``res``^2, depth 5,
    1 mutation a pixel, the box filter.  Returns (Scene, settings) on
    ``device``, the card unless the CPU is asked for."""
    device = entry_device(device)
    b = SceneBuilder()
    fill_caustic_cornell(b)
    _cornell_sensor(b)
    b.settings.width = b.settings.height = res
    b.settings.spp = 1
    b.settings.rfilter = F_BOX
    b.settings.integrator = "mlt"
    b.settings.integrator_props = dict(max_depth=5)
    return b.build(device)
