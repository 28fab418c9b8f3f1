"""Emitter tables and next-event-estimation sampling
(``mitsuba_im_tpu/emitter/table.py``): area emitters on triangle meshes and
the constant environment emitter.

Emitter selection follows the reference's Distribution1D (uniform weights
by default); an area emitter samples a point uniformly by area through its
triangle CDF and converts to solid angle; the constant environment samples
the uniform sphere and places its point ``2 r + 1`` away (r: the scene's
bounding-sphere radius).  Point, spot, directional, collimated and envmap
emitters and analytic area emitters are not ported yet and raise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ..core.types import Float, Int, INVALID, host_tensor
from ..core import v3 as v
from ..core.v3 import V3
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
PORTED = (EM_AREA, EM_CONSTANT)


@dataclasses.dataclass(frozen=True)
class EmitterTable:
    """The columns that triangle-mesh area emitters and the constant
    environment read; the reference's point/spot/directional/envmap and
    analytic-shape columns join with those emitters."""

    type: torch.Tensor  # (E,) int32 EM_*
    radiance: torch.Tensor  # (E, 3) area / constant radiance
    total_area: torch.Tensor  # (E,)
    tri_cdf: torch.Tensor  # (E, Tm+1) per-emitter triangle area CDF
    tri_idx: torch.Tensor  # (E, Tm) global triangle ids
    select_pmf: torch.Tensor  # (E,) emitter selection (Distribution1D)
    select_cdf: torch.Tensor  # (E+1,)
    bsphere_center: torch.Tensor  # (3,) scene bounding sphere
    bsphere_radius: torch.Tensor  # ()
    env_index: int = -1  # the environment emitter's row, or -1
    n_emitters: int = 0
    used_types: tuple = ()


EMITTER_LEAVES = ("type", "radiance", "total_area", "tri_cdf", "tri_idx",
                  "select_pmf", "select_cdf", "bsphere_center",
                  "bsphere_radius")
_INT_LEAVES = ("type", "tri_idx")


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
    bridge).  Raises for what the port cannot evaluate yet."""
    if n_emitters and (not set(used_types) <= set(PORTED)
                       or not set(used_area_kinds) <= {AK_TRIMESH}):
        raise NotImplementedError(
            f"emitter types {tuple(used_types)}, area kinds "
            f"{tuple(used_area_kinds)}: only triangle-mesh area emitters "
            "and the constant environment are ported")
    cols = {k: host_tensor(arrays[k], np.int32 if k in _INT_LEAVES
                           else np.float32, device)
            for k in EMITTER_LEAVES}
    return EmitterTable(**cols, env_index=int(env_index),
                        n_emitters=int(n_emitters),
                        used_types=tuple(used_types))


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
    for i, r in enumerate(recs):
        if r.get("type") == EM_ENVMAP or (r.get("type") == EM_CONSTANT
                                           and env_index < 0):
            env_index = i

    # Distribution1D.from_weights, in float32 as the reference computes it
    w = torch.tensor([r.get("weight", 1.0) for r in recs], dtype=Float)
    total = w.sum()
    pmf = (w / total) if total > 0 else torch.ones_like(w) / w.shape[0]
    cdf = torch.cat([torch.zeros(1, dtype=Float), torch.cumsum(pmf, 0)])
    cdf[-1] = 1.0

    center, radius = bsphere
    arrays = dict(
        type=np.array([r.get("type", EM_POINT) for r in recs]),
        radiance=np.stack([np.asarray(r.get("radiance", np.zeros(3)),
                                      np.float64) for r in recs]),
        total_area=total_area, tri_cdf=tri_cdf, tri_idx=tri_idx,
        select_pmf=pmf.numpy(), select_cdf=cdf.numpy(),
        bsphere_center=np.asarray(center), bsphere_radius=np.asarray(radius),
    )
    return table_from_arrays(
        arrays, len(records),
        sorted({int(r["type"]) for r in recs}),
        sorted({int(r.get("area_kind", AK_TRIMESH))
                for r in recs if r.get("type") == EM_AREA}),
        env_index, device)


# ---------------------------------------------------------------------------
# environment (the constant emitter; envmaps are refused where a table is
# built)
# ---------------------------------------------------------------------------

def eval_environment_v(em: EmitterTable, d_world: V3) -> V3:
    """Radiance of escaped rays (``scene.h`` evalEnvironment)."""
    shape, dev = d_world.x.shape, d_world.x.device
    if em.env_index < 0 or em.n_emitters == 0:
        return v.zeros(shape, dev)
    rad = em.radiance[em.env_index]
    return V3(*(c.expand(shape) for c in rad))


def env_pdf_sa_v(em: EmitterTable, d_world: V3) -> torch.Tensor:
    """Solid-angle pdf of sample_direct drawing d toward the environment."""
    if em.env_index < 0:
        return torch.zeros_like(d_world.x)
    return torch.full_like(d_world.x, INV_FOURPI)


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
    """Scene::pdfEmitterDirect for area emitters."""
    if em.n_emitters == 0:
        return torch.zeros_like(ref_p.x)
    eid = torch.where(emitter_id == INVALID, 0, emitter_id)
    dvec = p_emit - ref_p
    r2 = torch.clamp_min(dvec.dot(dvec), 1e-12)
    du = dvec * torch.rsqrt(r2)
    cos_e = n_emit.dot(-du)
    pdf_sa = (1.0 / torch.clamp_min(em.total_area[eid], 1e-12)) * r2 \
        / torch.clamp_min(cos_e, 1e-8)
    valid = ((emitter_id != INVALID) & (em.type[eid] == EM_AREA)
             & (cos_e > 1e-6))
    return torch.where(valid, pdf_sa * em.select_pmf[eid], 0.0)


def emitted_radiance_v(em: EmitterTable, shape_emitter_id, n_surf: V3,
                       wo_world: V3) -> V3:
    """Le(x, wo) for area-emitter hits (front side only)."""
    if em.n_emitters == 0:
        return v.zeros(wo_world.x.shape, wo_world.x.device)
    eid = torch.where(shape_emitter_id == INVALID, 0, shape_emitter_id)
    rad = v.gather_v3(em.radiance, eid)
    front = n_surf.dot(wo_world) > 0
    valid = (shape_emitter_id != INVALID) & (em.type[eid] == EM_AREA) & front
    return V3(torch.where(valid, rad.x, 0.0), torch.where(valid, rad.y, 0.0),
              torch.where(valid, rad.z, 0.0))


def _sample_area_position_v(em: EmitterTable, geom: Geometry, eid, u2a, u2b,
                            total_area):
    """Uniform-by-area point on a triangle-mesh emitter -> (p, n, pdf_a)."""
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
        cdf = em.tri_cdf[eid]
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
    p = p0 + e1 * b0 + e2 * b1
    n = e1.cross(e2).normalized()
    return p, n, 1.0 / torch.clamp_min(total_area, 1e-12)


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

    E = em.select_pmf.shape[0]
    if E == 1:
        eid = torch.zeros(shape, dtype=Int, device=dev)
        sel_pmf = torch.ones(shape, dtype=Float, device=dev)
    else:
        # Distribution1D.sample: #{1 <= k < E : cdf[k] <= u}
        eid = torch.searchsorted(em.select_cdf, u_sel, right=True) - 1
        eid = eid.clamp(0, E - 1).to(Int)
        sel_pmf = em.select_pmf[eid]

    etype = em.type[eid]
    d, value, n_out = v.zeros(shape, dev), v.zeros(shape, dev), v.zeros(
        shape, dev)
    dist = torch.ones(shape, dtype=Float, device=dev)
    pdf = z
    for t in em.used_types:
        sel = etype == t
        if t == EM_AREA:
            p_s, n_s, pos_pdf_a = _sample_area_position_v(
                em, geom, eid, u2a, u2b, em.total_area[eid])
            dvec = p_s - ref_p
            r2 = torch.clamp_min(dvec.dot(dvec), 1e-12)
            r = torch.sqrt(r2)
            du = dvec * (1.0 / r)
            cos_emit = n_s.dot(-du)
            front = cos_emit > 1e-6
            pdf_sa = pos_pdf_a * r2 / torch.clamp_min(cos_emit, 1e-8)
            val = v.where(front, v.gather_v3(em.radiance, eid),
                          v.zeros(shape, dev))
            pdf_t = torch.where(front, pdf_sa, 0.0)
            n_t = n_s
        else:  # EM_CONSTANT
            du = v.square_to_uniform_sphere(u2a, u2b)
            r = (2.0 * em.bsphere_radius + 1.0).expand(shape)
            val = v.gather_v3(em.radiance, eid)
            pdf_t = torch.full(shape, INV_FOURPI, dtype=Float, device=dev)
            n_t = -du
        d = v.where(sel, du, d)
        dist = torch.where(sel, r, dist)
        value = v.where(sel, val, value)
        pdf = torch.where(sel, pdf_t, pdf)
        n_out = v.where(sel, n_t, n_out)
    return DirectSample3(d=d, dist=dist, value=value, pdf=pdf * sel_pmf,
                         delta=no, n=n_out, emitter=eid)
