"""Direct illumination, ambient occlusion, field and motion-vector
integrators (``mitsuba_im_tpu/integrators/simple.py``; the reference's
``direct.cpp``, ``ao.cpp``, ``field.cpp`` and ``motion``), on
component-SoA lanes.

Each traces one camera hit through the scene's intersection kernels (the
brute-force ones at up to ``BRUTE_FORCE_MAX`` triangles, the hierarchy's
above) and draws its blocks of four uniforms with ``next_block4_v``,
which gives the reference's ``next_block4`` words lane for lane, so the
port and the reference agree sample for sample.  ``direct`` and ``ao``
test their shadow rays with the any-hit kernels.

The motion integrator reprojects the hit point through the sensor's pose
at the previous frame, ``prev_to_world``; without one (and no scene file
sets one: the reference's factory records only ``timeDelta``) the previous
pose is the current one, so R and G are 0 and B holds the hit distance,
as in the reference (ROADMAP C13).
"""
from __future__ import annotations

import torch

from ..core.types import EPSILON, SHADOW_EPSILON, Float
from ..core import rng as mrng
from ..core import v3 as v
from ..core.v3 import V3, safe_div
from ..bsdf.eval import bsdf_eval_v, bsdf_pdf_v, bsdf_sample_v
from ..emitter import table as em
from ..scene.scene import Scene
from ..sensor.table import connect_v
from .path import mi_weight

FIELDS = ("position", "relPosition", "distance", "normal", "shNormal",
          "geoNormal", "uv", "albedo", "shapeIndex", "primIndex")


def direct_li_v(scene: Scene, sampler: mrng.Sampler3, o: V3, d: V3,
                emitter_samples: int = 1, bsdf_samples: int = 1,
                hide_emitters: bool = False):
    """MIS direct illumination with the heuristics weighted by the sample
    counts (direct.cpp:198-320): ``emitter_samples`` light samples and
    ``bsdf_samples`` BSDF samples at the camera hit.  Returns (radiance V3,
    sampler)."""
    n = o.x.shape[0]
    zeros = v.zeros((n,), o.x.device)
    hit = scene.ray_intersect_v(o, d)
    it = scene.interaction_v(o, d, hit)
    li = zeros
    if not hide_emitters:
        li = li + v.where(~it.valid, em.eval_environment_v(scene.emitters,
                                                           d), zeros)
        le = em.emitted_radiance_v(scene.emitters,
                                   scene.emitter_at_id(it.shape), it.ns, -d)
        li = li + v.where(it.valid, le, zeros)

    frame = (it.ss, it.ts_, it.ns)
    p = scene.bsdf_at_v(it)
    frac_lum = emitter_samples / max(emitter_samples + bsdf_samples, 1)
    frac_bsdf = 1.0 - frac_lum
    w_lum = 1.0 / max(emitter_samples, 1)
    w_bsdf = 1.0 / max(bsdf_samples, 1)

    s = sampler
    for _ in range(emitter_samples):
        s, blk = mrng.next_block4_v(s)
        ds = em.sample_direct_v(scene.emitters, scene.geom, it.p, blk[0],
                                blk[1], blk[2])
        wo_l = v.to_local(frame, ds.d)
        f = bsdf_eval_v(p, it.wi_local, wo_l)
        pdf_b = bsdf_pdf_v(p, it.wi_local, wo_l)
        occ = scene.occluded_v(it.p, ds.d, EPSILON,
                               ds.dist * (1 - SHADOW_EPSILON))
        mw = torch.where(ds.delta, 1.0,
                         mi_weight(ds.pdf * frac_lum, pdf_b * frac_bsdf))
        contrib = ds.value * f * safe_div(mw * w_lum, ds.pdf)
        li = li + v.where(it.valid & ~occ & (ds.pdf > 0), contrib, zeros)

    for _ in range(bsdf_samples):
        s, blk = mrng.next_block4_v(s)
        bs = bsdf_sample_v(p, it.wi_local, blk[0], blk[1], blk[2], blk[3])
        wo_w = v.to_world(frame, bs.wo)
        hit2 = scene.ray_intersect_v(it.p, wo_w)
        it2 = scene.interaction_v(it.p, wo_w, hit2)
        eid2 = scene.emitter_at_id(it2.shape)
        le2 = em.emitted_radiance_v(scene.emitters, eid2, it2.ns, -wo_w)
        lum_pdf = torch.where(
            bs.delta, 0.0,
            torch.where(it2.valid,
                        em.pdf_direct_area_v(scene.emitters, eid2, it.p,
                                             it2.p, it2.ns),
                        em.pdf_direct_env_v(scene.emitters, wo_w)))
        val = v.where(it2.valid, le2,
                      em.eval_environment_v(scene.emitters, wo_w))
        mw = mi_weight(bs.pdf * frac_bsdf, lum_pdf * frac_lum)
        li = li + v.where(it.valid, bs.weight * val * (mw * w_bsdf), zeros)
    return li, s


def ao_li_v(scene: Scene, sampler: mrng.Sampler3, o: V3, d: V3,
            shading_samples: int = 1, ray_length: float = -1.0):
    """Ambient occlusion (ao.cpp): the fraction of ``shading_samples``
    cosine-distributed rays from the camera hit that nothing blocks within
    ``ray_length`` (half the scene's bounding-sphere radius when
    negative), in all three channels."""
    hit = scene.ray_intersect_v(o, d)
    it = scene.interaction_v(o, d, hit)
    if ray_length < 0:
        ray_length = scene.emitters.bsphere_radius * 0.5
    frame = (it.ss, it.ts_, it.ns)
    s = sampler
    acc = torch.zeros(o.x.shape, dtype=Float, device=o.x.device)
    for _ in range(shading_samples):
        s, blk = mrng.next_block4_v(s)
        wo_w = v.to_world(frame, v.square_to_cosine_hemisphere(blk[0],
                                                                blk[1]))
        occ = scene.occluded_v(it.p, wo_w, EPSILON, ray_length)
        acc = acc + torch.where(it.valid & ~occ, 1.0, 0.0)
    acc = acc / max(shading_samples, 1)
    return V3(acc, acc, acc), s


def field_li_v(scene: Scene, sampler: mrng.Sampler3, o: V3, d: V3,
               field: str = "position"):
    """One surface quantity of the camera hit (field.cpp): ``position``
    (and ``relPosition``, which the reference also leaves in world space),
    ``distance``, ``normal``/``shNormal``, ``geoNormal``, ``uv`` (u, v,
    0), ``albedo`` (the BSDF's diffuse reflectance), ``shapeIndex`` or
    ``primIndex``; 0 where the ray escapes."""
    hit = scene.ray_intersect_v(o, d)
    it = scene.interaction_v(o, d, hit)
    if field in ("position", "relPosition"):
        out = it.p
    elif field == "distance":
        out = V3(hit.t, hit.t, hit.t)
    elif field in ("normal", "shNormal"):
        out = it.ns
    elif field == "geoNormal":
        out = it.ng
    elif field == "uv":
        out = V3(it.uv_u, it.uv_v, torch.zeros_like(it.uv_u))
    elif field == "albedo":
        out = scene.bsdf_at_v(it).refl
    elif field == "shapeIndex":
        c = it.shape.to(Float)
        out = V3(c, c, c)
    elif field == "primIndex":
        c = hit.prim.to(Float)
        out = V3(c, c, c)
    else:
        raise ValueError(f"unknown field '{field}'")
    return v.where(it.valid, out, v.zeros(hit.t.shape, hit.t.device)), \
        sampler


def motion_li_v(scene: Scene, sampler: mrng.Sampler3, o: V3, d: V3,
                prev_to_world=None, width: int = 1, height: int = 1):
    """Screen-space motion vectors (the reference's ``motion``): the hit
    point's film position now minus through the previous pose
    ``prev_to_world`` (a (4, 4) matrix, or None for the current pose), in
    pixels, in R and G; the hit distance in B; 0 off the film or where
    the ray escapes."""
    hit = scene.ray_intersect_v(o, d)
    it = scene.interaction_v(o, d, hit)
    u_now, v_now, _, _, _, ok_now = connect_v(scene.sensor, it.p)
    if prev_to_world is None:
        u_prev, v_prev, ok_prev = u_now, v_now, ok_now
    else:
        import dataclasses

        m_prev = torch.as_tensor(prev_to_world, dtype=Float,
                                 device=o.x.device)
        prev = dataclasses.replace(scene.sensor, to_world=m_prev,
                                   to_camera=torch.linalg.inv(m_prev))
        u_prev, v_prev, _, _, _, ok_prev = connect_v(prev, it.p)
    out = V3((u_now - u_prev) * float(width), (v_now - v_prev) * float(height),
             hit.t)
    ok = it.valid & ok_now & ok_prev
    return v.where(ok, out, v.zeros(hit.t.shape, hit.t.device)), sampler
