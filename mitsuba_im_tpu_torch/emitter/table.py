"""Emitter tables and next-event-estimation sampling
(``mitsuba_im_tpu/emitter/table.py``): area emitters on triangle meshes,
analytic spheres and disks, point, spot, directional and collimated
emitters, the constant environment and the lat-long environment map.

Emitter selection follows the reference's Distribution1D (uniform weights
by default).  An area emitter samples a point uniformly by area (through
its triangle CDF on a mesh, the uniform sphere or the concentric disk on
an analytic shape) and converts to solid angle.  Point and spot lights are
delta positions (intensity / r^2); the spot's falloff is the reference's
linear ramp from ``cos_cutoff`` to ``cos_falloff``, not ``spot.cpp``'s
smooth one.  A directional light (the sun among them) and an environment
place their point ``2 r + 1`` away (r: the scene's bounding-sphere
radius).  A collimated beam is never hit by direct sampling and carries no
light along the path, as in the reference.  The constant environment
samples the uniform sphere; the map (``EM_ENVMAP``, +y up, u = atan2(x,
-z) / 2 pi, v = acos(y) / pi in its local frame) importance-samples its
luminance x sin(theta) through a :class:`Distribution2D` of alias tables,
and both packages bilinearly interpolate its texels (u wraps, v clamps).

The map's (u, v) of a direction go through ``atan2`` and ``acos``, whose
derivatives are 0/0 on the pole axis (and infinite at the poles); there the
direction enters detached (``v.where_live``), so a masked lane sends no NaN
backward.  The forward values are the reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ..core.types import Float, Int, INVALID, host_tensor
from ..core import v3 as v
from ..core.distribution import Distribution2D
from ..core.v3 import V3, PI
from ..scene.geometry import Geometry

EM_AREA = 0
EM_POINT = 1
EM_SPOT = 2
EM_DIRECTIONAL = 3
EM_CONSTANT = 4
EM_ENVMAP = 5
EM_COLLIMATED = 6

AK_TRIMESH = 0
AK_SPHERE = 1
AK_DISK = 2

INV_FOURPI = 1.0 / (4.0 * math.pi)
ENV_DIST_LEAVES = ("marg_pmf", "cond_pmf", "marg_aprob", "marg_alias",
                   "cond_aprob", "cond_alias")


@dataclasses.dataclass(frozen=True)
class EmitterTable:
    """The reference's emitter columns (its ``shape`` column aside: the
    scene's ``shape_emitter`` maps shapes to rows)."""

    type: torch.Tensor  # (E,) int32 EM_*
    radiance: torch.Tensor  # (E, 3) area / constant radiance, map scale
    intensity: torch.Tensor  # (E, 3) point/spot intensity, irradiance
    position: torch.Tensor  # (E, 3)
    direction: torch.Tensor  # (E, 3) unit
    cos_cutoff: torch.Tensor  # (E,) spot: cos of the total angle
    cos_falloff: torch.Tensor  # (E,) spot: cos where the falloff begins
    area_kind: torch.Tensor  # (E,) int32 AK_*
    prim: torch.Tensor  # (E,) int32 sphere/disk row of an analytic emitter
    total_area: torch.Tensor  # (E,)
    tri_cdf: torch.Tensor  # (E, Tm+1) per-emitter triangle area CDF
    tri_idx: torch.Tensor  # (E, Tm) global triangle ids
    select_pmf: torch.Tensor  # (E,) emitter selection (Distribution1D)
    select_cdf: torch.Tensor  # (E+1,)
    env_rows: torch.Tensor  # (H, W, 3) map texels ((1, 1, 3) without one)
    env_marg_pmf: torch.Tensor  # (H,) the map's Distribution2D ...
    env_cond_pmf: torch.Tensor  # (H, W)
    env_marg_aprob: torch.Tensor  # (H,)
    env_marg_alias: torch.Tensor  # (H,) int32
    env_cond_aprob: torch.Tensor  # (H, W)
    env_cond_alias: torch.Tensor  # (H, W) int32
    env_to_world: torch.Tensor  # (3, 3) map rotation
    env_to_local: torch.Tensor  # (3, 3)
    bsphere_center: torch.Tensor  # (3,) scene bounding sphere
    bsphere_radius: torch.Tensor  # ()
    env_index: int = -1  # the environment emitter's row, or -1
    env_is_map: bool = False  # that row is EM_ENVMAP (else EM_CONSTANT)
    n_emitters: int = 0
    used_types: tuple = ()
    used_area_kinds: tuple = ()

    @property
    def env_dist(self) -> Distribution2D:
        return Distribution2D(**{k: getattr(self, "env_" + k)
                                 for k in ENV_DIST_LEAVES})


EMITTER_LEAVES = ("type", "radiance", "intensity", "position", "direction",
                  "cos_cutoff", "cos_falloff", "area_kind", "prim",
                  "total_area", "tri_cdf", "tri_idx",
                  "select_pmf", "select_cdf", "env_rows",
                  *("env_" + k for k in ENV_DIST_LEAVES), "env_to_world",
                  "env_to_local", "bsphere_center", "bsphere_radius")
_INT_LEAVES = ("type", "area_kind", "prim", "tri_idx", "env_marg_alias",
               "env_cond_alias")
# the per-row columns from the records: (default, numpy dtype)
_RECORD_COLUMNS = {
    "type": (EM_POINT, np.int32), "radiance": (np.zeros(3), np.float32),
    "intensity": (np.zeros(3), np.float32),
    "position": (np.zeros(3), np.float32),
    "direction": (np.array([0, 0, 1.0]), np.float32),
    "cos_cutoff": (-1.0, np.float32), "cos_falloff": (-1.0, np.float32),
    "area_kind": (AK_TRIMESH, np.int32), "prim": (0, np.int32),
}


class DirectSample3(NamedTuple):
    d: V3  # unit direction ref -> emitter
    dist: torch.Tensor
    value: V3  # emitted radiance
    pdf: torch.Tensor  # solid-angle pdf incl. selection
    delta: torch.Tensor  # bool
    n: V3  # emitter surface normal at the sampled point
    emitter: torch.Tensor  # int32


def table_from_arrays(arrays: dict, n_emitters: int, used_types,
                      used_area_kinds, env_index: int,
                      device) -> EmitterTable:
    """An EmitterTable from numpy columns (used by ``scene/build.py`` and the
    bridge)."""
    cols = {k: host_tensor(arrays[k], np.int32 if k in _INT_LEAVES
                           else np.float32, device)
            for k in EMITTER_LEAVES}
    is_map = (env_index >= 0
              and int(np.asarray(arrays["type"])[env_index]) == EM_ENVMAP)
    return EmitterTable(**cols, env_index=int(env_index), env_is_map=is_map,
                        n_emitters=int(n_emitters),
                        used_types=tuple(used_types),
                        used_area_kinds=tuple(used_area_kinds))


def envmap_record(pixels, scale: float = 1.0, to_world_rot=None,
                  weight: float = 1.0) -> dict:
    """The ``envmap`` emitter from a lat-long pixel array (H, W, >= 3) of
    linear RGB radiance: ``scale`` is its radiance (the gradient slot
    ``emitter.radiance``), ``to_world_rot`` its 3x3 rotation."""
    return dict(type=EM_ENVMAP, radiance=np.full(3, float(scale)),
                pixels=np.asarray(pixels)[..., :3],
                to_world_rot=(np.eye(3) if to_world_rot is None
                              else np.asarray(to_world_rot, np.float64)),
                weight=weight)


def build_emitters(records: list[dict], geom_host: dict, bsphere,
                   device) -> EmitterTable:
    """records: per-emitter host dicts; geom_host holds the numpy triangle
    arrays (e1/e2/shape) for the area CDFs; bsphere is the scene's
    (center, radius).  Same arithmetic as the reference's
    ``build_emitters``, so the tables agree bit for bit."""
    E = max(len(records), 1)
    recs = records or [dict(type=EM_POINT, intensity=np.zeros(3),
                            position=np.zeros(3))]

    tri_shape = geom_host.get("shape", np.zeros(0, np.int32))
    tri_e1 = geom_host.get("e1", np.zeros((0, 3)))
    tri_e2 = geom_host.get("e2", np.zeros((0, 3)))
    areas_all = (0.5 * np.linalg.norm(np.cross(tri_e1, tri_e2), axis=-1)
                 if len(tri_e1) else np.zeros(0))

    tmax = 1
    per_em_tris = []
    for r in recs:
        if (r.get("type") == EM_AREA
                and r.get("area_kind", AK_TRIMESH) == AK_TRIMESH):
            ids = np.nonzero(tri_shape == r["shape"])[0]
            per_em_tris.append(ids)
            tmax = max(tmax, len(ids))
        else:
            per_em_tris.append(np.zeros(0, np.int64))

    tri_cdf = np.zeros((E, tmax + 1), np.float32)
    tri_idx = np.zeros((E, tmax), np.int32)
    total_area = np.zeros(E, np.float32)
    for i, (r, ids) in enumerate(zip(recs, per_em_tris)):
        if r.get("type") == EM_AREA:
            if r.get("area_kind", AK_TRIMESH) == AK_TRIMESH and len(ids):
                a = areas_all[ids]
                total_area[i] = a.sum()
                cdf = np.concatenate([[0.0],
                                      np.cumsum(a / max(a.sum(), 1e-30))])
                cdf[-1] = 1.0
                tri_cdf[i, : len(cdf)] = cdf
                tri_cdf[i, len(cdf):] = 1.0
                tri_idx[i, : len(ids)] = ids
            else:
                total_area[i] = r.get("surface_area", 1.0)

    env_index = -1
    env_pix = np.zeros((1, 1, 3), np.float32)
    env_rot = np.eye(3)
    for i, r in enumerate(recs):
        if r.get("type") == EM_ENVMAP:
            env_index = i
            env_pix = np.asarray(r["pixels"], np.float32)
            env_rot = np.asarray(r.get("to_world_rot", np.eye(3)), np.float64)
        elif r.get("type") == EM_CONSTANT and env_index < 0:
            env_index = i

    # the map's sampling weights: luminance x sin(theta), the reference's
    # host arithmetic (float32 luminance, float64 sines, one cast)
    H = env_pix.shape[0]
    lum = (env_pix[..., 0] * 0.212671 + env_pix[..., 1] * 0.715160
           + env_pix[..., 2] * 0.072169)
    sin_t = np.sin((np.arange(H) + 0.5) / H * np.pi)[:, None]
    env_dist = Distribution2D.arrays_from_weights(
        (lum * sin_t + 1e-12).astype(np.float32))

    # Distribution1D.from_weights, in float32 as the reference computes it
    w = torch.tensor([r.get("weight", 1.0) for r in recs], dtype=Float)
    total = w.sum()
    pmf = (w / total) if total > 0 else torch.ones_like(w) / w.shape[0]
    cdf = torch.cat([torch.zeros(1, dtype=Float), torch.cumsum(pmf, 0)])
    cdf[-1] = 1.0

    center, radius = bsphere
    arrays = dict(
        **{k: np.stack([np.asarray(r.get(k, dflt), np.float64)
                        for r in recs]).astype(dt)
           for k, (dflt, dt) in _RECORD_COLUMNS.items()},
        total_area=total_area, tri_cdf=tri_cdf, tri_idx=tri_idx,
        select_pmf=pmf.numpy(), select_cdf=cdf.numpy(), env_rows=env_pix,
        **{"env_" + k: a for k, a in env_dist.items()},
        env_to_world=env_rot, env_to_local=env_rot.T,
        bsphere_center=np.asarray(center), bsphere_radius=np.asarray(radius),
    )
    return table_from_arrays(
        arrays, len(records),
        sorted({int(r["type"]) for r in recs}),
        sorted({int(r.get("area_kind", AK_TRIMESH))
                for r in recs if r.get("type") == EM_AREA}),
        env_index, device)


# ---------------------------------------------------------------------------
# environment emitters
# ---------------------------------------------------------------------------

def _rot_v(mat: torch.Tensor, d: V3) -> V3:
    """A 3x3 rotation applied to a V3."""
    return V3(mat[0, 0] * d.x + mat[0, 1] * d.y + mat[0, 2] * d.z,
              mat[1, 0] * d.x + mat[1, 1] * d.y + mat[1, 2] * d.z,
              mat[2, 0] * d.x + mat[2, 1] * d.y + mat[2, 2] * d.z)


def _env_uv_from_dir_v(em: EmitterTable, d: V3):
    dl = _rot_v(em.env_to_local, d)
    ax = (dl.x != 0.0) | (dl.z != 0.0)  # off the pole axis
    u = v.where_live(torch.atan2, ax, (dl.x, -dl.z), (0.0, 1.0)) * (0.5 / PI)
    u = torch.where(u < 0, u + 1.0, u)
    y = torch.clamp(dl.y, -1.0, 1.0)
    vv = v.where_live(torch.arccos, torch.abs(y) < 1.0, (y,), (0.0,)) / PI
    return u, vv


def _env_dir_from_uv_v(em: EmitterTable, u, vv) -> V3:
    phi = u * 2.0 * PI
    theta = vv * PI
    st, ct = torch.sin(theta), torch.cos(theta)
    return _rot_v(em.env_to_world,
                  V3(st * torch.sin(phi), ct, -st * torch.cos(phi)))


def _env_lookup_v(em: EmitterTable, u, vv, scale: V3) -> V3:
    """Bilinear texel lookup at (u, v) times ``scale``."""
    H, W = em.env_rows.shape[:2]
    rows = em.env_rows.reshape(-1, 3)
    fx = u * W - 0.5
    fy = vv * H - 0.5
    x0 = torch.floor(fx).to(Int)
    y0 = torch.floor(fy).to(Int)
    dx = fx - x0
    dy = fy - y0

    def texel(x, y):
        return v.gather_v3(rows, torch.clamp(y, 0, H - 1) * W
                           + torch.remainder(x, W))

    return scale * (texel(x0, y0) * ((1 - dx) * (1 - dy))
                    + texel(x0 + 1, y0) * (dx * (1 - dy))
                    + texel(x0, y0 + 1) * ((1 - dx) * dy)
                    + texel(x0 + 1, y0 + 1) * (dx * dy))


def _env_pdf_sa(pdf_uv, vv):
    """Solid-angle density of a map sample from its unit-square density."""
    sin_t = torch.clamp_min(torch.sin(vv * PI), 1e-6)
    return pdf_uv / (2.0 * PI * PI * sin_t)


def eval_environment_v(em: EmitterTable, d_world: V3) -> V3:
    """Radiance of escaped rays (``scene.h`` evalEnvironment)."""
    shape, dev = d_world.x.shape, d_world.x.device
    if em.env_index < 0 or em.n_emitters == 0:
        return v.zeros(shape, dev)
    rad = V3(*em.radiance[em.env_index])
    if not em.env_is_map:
        return V3(*(c.expand(shape) for c in rad))
    u, vv = _env_uv_from_dir_v(em, d_world)
    return _env_lookup_v(em, u, vv, rad)


def env_pdf_sa_v(em: EmitterTable, d_world: V3) -> torch.Tensor:
    """Solid-angle pdf of sample_direct drawing d toward the environment."""
    if em.env_index < 0:
        return torch.zeros_like(d_world.x)
    if not em.env_is_map:
        return torch.full_like(d_world.x, INV_FOURPI)
    u, vv = _env_uv_from_dir_v(em, d_world)
    return _env_pdf_sa(em.env_dist.pdf_continuous(u, vv), vv)


def pdf_direct_env_v(em: EmitterTable, d_world: V3) -> torch.Tensor:
    """Selection-weighted solid-angle pdf of environment directions."""
    if em.env_index < 0:
        return torch.zeros_like(d_world.x)
    return env_pdf_sa_v(em, d_world) * em.select_pmf[em.env_index]


# ---------------------------------------------------------------------------
# area emitters
# ---------------------------------------------------------------------------

def pdf_direct_area_v(em: EmitterTable, emitter_id, ref_p: V3, p_emit: V3,
                      n_emit: V3) -> torch.Tensor:
    """Scene::pdfEmitterDirect for area emitters.  Differentiated on valid
    lanes only: another lane's row may have no area (1e12 / cos), and the
    overflow would meet its zero cotangent."""
    if em.n_emitters == 0:
        return torch.zeros_like(ref_p.x)
    eid = torch.where(emitter_id == INVALID, 0, emitter_id)
    dvec = p_emit - ref_p
    r2 = torch.clamp_min(dvec.dot(dvec), 1e-12)
    du = dvec * torch.rsqrt(r2)
    cos_e = n_emit.dot(-du)
    inv_area = 1.0 / torch.clamp_min(v.gather_row(em.total_area, eid), 1e-12)
    valid = ((emitter_id != INVALID)
             & (v.gather_row(em.type, eid) == EM_AREA) & (cos_e > 1e-6))
    pdf_sa = v.where_live(
        lambda r2, c: inv_area * r2 / torch.clamp_min(c, 1e-8), valid,
        (r2, cos_e), (1.0, 1.0))
    return torch.where(valid, pdf_sa * v.gather_row(em.select_pmf, eid), 0.0)


def emitted_radiance_v(em: EmitterTable, shape_emitter_id, n_surf: V3,
                       wo_world: V3) -> V3:
    """Le(x, wo) for area-emitter hits (front side only)."""
    if em.n_emitters == 0:
        return v.zeros(wo_world.x.shape, wo_world.x.device)
    eid = torch.where(shape_emitter_id == INVALID, 0, shape_emitter_id)
    rad = v.gather_v3(em.radiance, eid)
    front = n_surf.dot(wo_world) > 0
    valid = ((shape_emitter_id != INVALID)
             & (v.gather_row(em.type, eid) == EM_AREA) & front)
    return V3(torch.where(valid, rad.x, 0.0), torch.where(valid, rad.y, 0.0),
              torch.where(valid, rad.z, 0.0))


def _sample_tri_position_v(em: EmitterTable, geom: Geometry, eid, u2a,
                           u2b):
    """Uniform-by-area point on a triangle-mesh emitter -> (p, n)."""
    Tm = em.tri_idx.shape[1]
    u0 = u2a
    # index = #{k >= 1 : cdf[k] <= u0}, the reference's compare count:
    # cdf[0] = 0 <= u0, so it is the right-side insertion point minus one
    if em.tri_cdf.shape[0] == 1:
        cdf = em.tri_cdf[0]
        li = (torch.searchsorted(cdf, u0, right=True) - 1).clamp(0, Tm - 1)
        lo, hi = cdf[li], cdf[li + 1]
        tri = em.tri_idx[0][li]
    else:
        cdf = v.gather_row(em.tri_cdf, eid)
        li = torch.searchsorted(cdf, u0[:, None], right=True)[:, 0] - 1
        li = li.clamp(0, Tm - 1)
        lo = cdf.gather(1, li[:, None])[:, 0]
        hi = cdf.gather(1, (li + 1)[:, None])[:, 0]
        tri = em.tri_idx[eid, li]
    u0r = torch.clamp((u0 - lo) / torch.clamp_min(hi - lo, 1e-12), 0.0, 1.0)
    b0, b1 = v.square_to_uniform_triangle(u0r, u2b)
    p0 = v.gather_v3(geom.tri_p0, tri)
    e1 = v.gather_v3(geom.tri_e1, tri)
    e2 = v.gather_v3(geom.tri_e2, tri)
    return p0 + e1 * b0 + e2 * b1, e1.cross(e2).normalized()


def _sample_area_position_v(em: EmitterTable, geom: Geometry, eid, u2a, u2b,
                            total_area):
    """Uniform-by-area point on an area emitter of any kind the table uses
    -> (p, n, pdf_area)."""
    shape, dev = u2a.shape, u2a.device
    p, n = v.zeros(shape, dev), v.zeros(shape, dev)
    kinds = em.used_area_kinds or (AK_TRIMESH,)
    kind = v.gather_row(em.area_kind, eid) if len(kinds) > 1 else None
    prim = v.gather_row(em.prim, eid)

    def put(k, pk, nk):
        if kind is None:
            return pk, nk
        sel = kind == k
        return v.where(sel, pk, p), v.where(sel, nk, n)

    if AK_TRIMESH in kinds:
        p, n = put(AK_TRIMESH, *_sample_tri_position_v(em, geom, eid, u2a,
                                                       u2b))
    if AK_SPHERE in kinds:
        dir_s = v.square_to_uniform_sphere(u2a, u2b)
        p_sph = (v.gather_v3(geom.sph_center, prim)
                 + dir_s * v.gather_row(geom.sph_radius, prim))
        p, n = put(AK_SPHERE, p_sph, dir_s)
    if AK_DISK in kinds:
        px, py = v.square_to_uniform_disk_concentric(u2a, u2b)
        dr = v.gather_row(geom.disk_radius, prim)
        p_disk = (v.gather_v3(geom.disk_center, prim)
                  + v.gather_v3(geom.disk_s, prim) * (px * dr)
                  + v.gather_v3(geom.disk_t, prim) * (py * dr))
        p, n = put(AK_DISK, p_disk, v.gather_v3(geom.disk_n, prim))
    return p, n, 1.0 / torch.clamp_min(total_area, 1e-12)


def select_emitter_v(em: EmitterTable, u_sel):
    """(emitter row, selection pmf) of each lane: Distribution1D.sample,
    #{1 <= k < E : cdf[k] <= u}; row 0 with pmf 1 for one emitter."""
    E = em.select_pmf.shape[0]
    if E == 1:
        return (torch.zeros(u_sel.shape, dtype=Int, device=u_sel.device),
                torch.ones(u_sel.shape, dtype=Float, device=u_sel.device))
    eid = torch.searchsorted(em.select_cdf, u_sel, right=True) - 1
    eid = eid.clamp(0, E - 1).to(Int)
    return eid, v.gather_row(em.select_pmf, eid)


def sample_direct_v(em: EmitterTable, geom: Geometry, ref_p: V3, u_sel,
                    u2a, u2b) -> DirectSample3:
    """Scene::sampleEmitterDirect over SoA lanes."""
    shape, dev = ref_p.x.shape, ref_p.x.device
    z = torch.zeros(shape, dtype=Float, device=dev)
    no = torch.zeros(shape, dtype=torch.bool, device=dev)
    if em.n_emitters == 0:
        return DirectSample3(
            d=v.zeros(shape, dev), dist=z, value=v.zeros(shape, dev), pdf=z,
            delta=no, n=v.zeros(shape, dev),
            emitter=torch.full(shape, INVALID, dtype=Int, device=dev))

    eid, sel_pmf = select_emitter_v(em, u_sel)
    etype = v.gather_row(em.type, eid)
    radiance = v.gather_v3(em.radiance, eid)
    d, value, n_out = v.zeros(shape, dev), v.zeros(shape, dev), v.zeros(
        shape, dev)
    dist = torch.ones(shape, dtype=Float, device=dev)
    pdf, delta = z, no
    far = (2.0 * em.bsphere_radius + 1.0).expand(shape)
    ones = torch.ones(shape, dtype=Float, device=dev)
    for t in em.used_types:
        sel = etype == t
        is_delta = False
        if t == EM_AREA:
            p_s, n_s, pos_pdf_a = _sample_area_position_v(
                em, geom, eid, u2a, u2b, v.gather_row(em.total_area, eid))
            dvec = p_s - ref_p
            r2 = torch.clamp_min(dvec.dot(dvec), 1e-12)
            r = torch.sqrt(r2)
            du = dvec * (1.0 / r)
            cos_emit = n_s.dot(-du)
            front = cos_emit > 1e-6
            pdf_sa = pos_pdf_a * r2 / torch.clamp_min(cos_emit, 1e-8)
            val = v.where(front, radiance, v.zeros(shape, dev))
            pdf_t = torch.where(front, pdf_sa, 0.0)
            n_t = n_s
        elif t in (EM_POINT, EM_SPOT):
            dvec = v.gather_v3(em.position, eid) - ref_p
            r2 = torch.clamp_min(dvec.dot(dvec), 1e-12)
            r = torch.sqrt(r2)
            du = dvec * (1.0 / r)
            val = v.gather_v3(em.intensity, eid) * (1.0 / r2)
            if t == EM_SPOT:
                cd = (-du).dot(v.gather_v3(em.direction, eid))
                cc = v.gather_row(em.cos_cutoff, eid)
                cf = v.gather_row(em.cos_falloff, eid)
                fall = torch.clamp((cd - cc) / torch.clamp_min(cf - cc, 1e-6),
                                   0.0, 1.0)
                val = val * torch.where(cd > cc, fall, 0.0)
            pdf_t, n_t, is_delta = ones, -du, True
        elif t == EM_DIRECTIONAL:
            du = -v.gather_v3(em.direction, eid)
            val = v.gather_v3(em.intensity, eid)
            r, pdf_t, n_t, is_delta = far, ones, -du, True
        elif t in (EM_CONSTANT, EM_ENVMAP):
            if t == EM_CONSTANT:
                du = v.square_to_uniform_sphere(u2a, u2b)
                val = radiance
                pdf_t = torch.full(shape, INV_FOURPI, dtype=Float, device=dev)
            else:
                uu, vv, pdf_uv = em.env_dist.sample_continuous(u2a, u2b)
                du = _env_dir_from_uv_v(em, uu, vv)
                pdf_t = _env_pdf_sa(pdf_uv, vv)
                val = _env_lookup_v(em, uu, vv, radiance)
            r, n_t = far, -du
        else:  # EM_COLLIMATED: a measure-zero beam, never sampled
            continue
        d = v.where(sel, du, d)
        dist = torch.where(sel, r, dist)
        value = v.where(sel, val, value)
        pdf = torch.where(sel, pdf_t, pdf)
        if is_delta:
            delta = delta | sel
        n_out = v.where(sel, n_t, n_out)
    return DirectSample3(d=d, dist=dist, value=value, pdf=pdf * sel_pmf,
                         delta=delta, n=n_out, emitter=eid)
