"""Adjoint particle tracer: light tracing into the sensor
(``mitsuba_im_tpu/integrators/ptracer.py``).

A flat SoA batch of light particles leaves the scene's emitters
(:func:`sample_emitter_ray_v`, ``Scene::sampleEmitterRay``) and bounces
through a Python loop over a static number of bounces with masked inactive
lanes, as the reference's unroll does, so both draw the same numbers per
lane: two blocks for the light sample, then per bounce a BSDF block and a
Russian-roulette block.  At every surface vertex the particle connects to
the camera (``sensor/table.py::connect_v``, the pinhole projection for
every sensor type, as the reference's ``connect`` is) through one any-hit
ray, and the connection becomes a splat at the film position it projects
to.  The render job sums the splats into a box film and normalizes by
W * H / particles (``render/job.py::render_ptracer``):

    I_px ~= (W * H / N) * sum thr * f(x -> cam) * G * W_e

with W_e the pinhole image-plane importance.  The emitter's own surface
seen by the camera (the depth-0 connection) is splatted only when the
scene has area emitters, as in the reference.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core.types import Float, EPSILON, SHADOW_EPSILON
from ..core import v3 as v
from ..core.v3 import V3, PI
from ..core import rng as mrng
from ..bsdf.eval import bsdf_eval_v, bsdf_sample_v
from ..emitter import table as em
from ..scene.scene import Scene
from ..sensor.table import connect_v
from .path import PathConfig, _fake_it_v


class LightSample3(NamedTuple):
    p: V3  # position on the emitter
    d: V3  # emitted direction
    n: V3  # emitter normal (delta types: the direction)
    weight: V3  # Le * cos / (pdf_pos * pdf_dir * sel_pmf)
    delta_pos: torch.Tensor  # point-like origin (no area connection)


class Splat(NamedTuple):
    u: torch.Tensor  # film position in [0, 1)
    v: torch.Tensor
    value: V3  # zero where the connection is not valid
    valid: torch.Tensor


def _bounding_disk(em_t: em.EmitterTable, normal: V3, ux, uy, shape):
    """The point ``bsphere_center - normal * 1.1 r`` plus the concentric
    disk offset (ux, uy) * r in ``normal``'s frame."""
    r = em_t.bsphere_radius
    fr = v.frame_from_normal(normal)
    zeros = torch.zeros(shape, dtype=Float, device=ux.device)
    off = v.to_world(fr, V3(ux * r, uy * r, zeros))
    c = V3(*(x.expand(shape) for x in em_t.bsphere_center))
    return c - normal * (1.1 * r) + off


def sample_emitter_ray_v(scene: Scene, u_sel, u_pos_a, u_pos_b, u_dir_a,
                         u_dir_b) -> LightSample3:
    """An emitted ray of every emitter type the scene uses
    (``sample_emitter_ray``): area lights a uniform point and a cosine
    direction; point and spot lights the uniform sphere (the spot's linear
    falloff); directional lights and the environments a point on the
    bounding disk facing their direction; collimated beams their one
    ray."""
    emt = scene.emitters
    shape, dev = u_sel.shape, u_sel.device
    eid, sel_pmf = em.select_emitter_v(emt, u_sel)
    etype = v.gather_row(emt.type, eid)

    p, d, n, w = (v.zeros(shape, dev) for _ in range(4))
    delta_pos = torch.zeros(shape, dtype=torch.bool, device=dev)

    for t in emt.used_types:
        sel = etype == t
        if t == em.EM_AREA:
            p_s, n_s, pdf_a = em._sample_area_position_v(
                emt, scene.geom, eid, u_pos_a, u_pos_b,
                v.gather_row(emt.total_area, eid))
            d_local = v.square_to_cosine_hemisphere(u_dir_a, u_dir_b)
            d_s = v.to_world(v.frame_from_normal(n_s), d_local)
            # Le cos / (pdf_a cos / pi) = Le pi / pdf_a
            w_s = v.gather_v3(emt.radiance, eid) * (
                PI / torch.clamp_min(pdf_a, 1e-20))
        elif t in (em.EM_POINT, em.EM_SPOT):
            d_s = v.square_to_uniform_sphere(u_dir_a, u_dir_b)
            w_s = v.gather_v3(emt.intensity, eid) * (4.0 * PI)
            if t == em.EM_SPOT:
                cd = d_s.dot(v.gather_v3(emt.direction, eid))
                cc = v.gather_row(emt.cos_cutoff, eid)
                cf = v.gather_row(emt.cos_falloff, eid)
                fall = torch.clamp(
                    (cd - cc) / torch.clamp_min(cf - cc, 1e-6), 0.0, 1.0)
                w_s = w_s * torch.where(cd > cc, fall, 0.0)
            p_s, n_s = v.gather_v3(emt.position, eid), d_s
        elif t == em.EM_DIRECTIONAL:
            d_s = v.gather_v3(emt.direction, eid)
            dx, dy = v.square_to_uniform_disk_concentric(u_pos_a, u_pos_b)
            p_s = _bounding_disk(emt, d_s, dx, dy, shape)
            r = emt.bsphere_radius
            w_s = v.gather_v3(emt.intensity, eid) * (PI * r * r)
            n_s = d_s
        elif t in (em.EM_CONSTANT, em.EM_ENVMAP):
            # an inward ray from the bounding sphere
            d_s = -v.square_to_uniform_sphere(u_pos_a, u_pos_b)
            dx, dy = v.square_to_uniform_disk_concentric(u_dir_a, u_dir_b)
            p_s = _bounding_disk(emt, d_s, dx, dy, shape)
            rad = v.gather_v3(emt.radiance, eid)
            if t == em.EM_CONSTANT:
                le = rad
            else:
                uu, vv = em._env_uv_from_dir_v(emt, -d_s)
                le = em._env_lookup_v(emt, uu, vv, rad)
            # pdf_dir 1 / (4 pi) over the sphere, pdf_pos 1 / (pi r^2)
            r = emt.bsphere_radius
            w_s = le * (4.0 * PI * PI * r * r)
            n_s = d_s
        else:  # EM_COLLIMATED
            d_s = v.gather_v3(emt.direction, eid)
            p_s, n_s = v.gather_v3(emt.position, eid), d_s
            w_s = v.gather_v3(emt.intensity, eid)
        p, d = v.where(sel, p_s, p), v.where(sel, d_s, d)
        n, w = v.where(sel, n_s, n), v.where(sel, w_s, w)
        if t != em.EM_AREA:
            delta_pos = delta_pos | sel
    return LightSample3(p=p, d=d, n=n, weight=w / sel_pmf,
                        delta_pos=delta_pos)


def _connect(scene: Scene, p: V3):
    """The camera connection of points p: film (u, v), unit direction to
    the camera, distance, importance, in-frame flag, and the any-hit test
    of the segment (one launch)."""
    u, w, cam, dist, imp, vis = connect_v(scene.sensor, p)
    d_cam = (cam - p) / torch.clamp_min(dist, 1e-12)
    occ = scene.occluded_v(p, d_cam, EPSILON, dist * (1.0 - SHADOW_EPSILON))
    return u, w, d_cam, dist, imp, vis & ~occ


def ptracer_splats_v(scene: Scene, sampler: mrng.Sampler3,
                     cfg: PathConfig) -> list[Splat]:
    """Trace one light particle per lane; returns the splat list, one
    :class:`Splat` per camera connection (the depth-0 one first where the
    scene has area emitters, then one per bounce)."""
    s, blk = mrng.next_block4_v(sampler)
    s, blk2 = mrng.next_block4_v(s)
    ls = sample_emitter_ray_v(scene, blk[0], blk[1], blk[2], blk2[0],
                              blk2[1])
    n_iters = (cfg.max_depth - 1) if cfg.max_depth > 0 else cfg.depth_budget
    zeros = v.zeros(ls.p.x.shape, ls.p.x.device)

    hit = scene.ray_intersect_v(ls.p, ls.d)
    it = scene.interaction_v(ls.p, ls.d, hit)
    splats = []

    if scene.emitters.n_emitters > 0 and em.EM_AREA in \
            scene.emitters.used_types:
        # the emitter's surface seen directly by the camera: Le / pdf_pos
        # (the weight's pi back out) times cos_e
        u0, w0, d0, dist0, imp0, ok0 = _connect(scene, ls.p)
        cos_e = ls.n.dot(d0)
        val0 = ls.weight * (torch.clamp_min(cos_e, 0.0) / math.pi * imp0
                            / torch.clamp_min(dist0 * dist0, 1e-12))
        ok0 = ok0 & ~ls.delta_pos & (cos_e > 0)
        splats.append(Splat(u0, w0, v.where(ok0, val0, zeros), ok0))

    st = dict(thr=ls.weight, active=it.valid, p=it.p, ns=it.ns, ng=it.ng,
              ss=it.ss, ts=it.ts_, uv_u=it.uv_u, uv_v=it.uv_v,
              shape=it.shape, wi_local=it.wi_local)
    for depth in range(1, n_iters + 1):
        fake = _fake_it_v(st)
        bparams = scene.bsdf_at_v(fake)
        frame = (st["ss"], st["ts"], st["ns"])

        u, w, d_cam, dist, imp, ok = _connect(scene, st["p"])
        f = bsdf_eval_v(bparams, st["wi_local"], v.to_local(frame, d_cam))
        val = st["thr"] * f * (
            imp * (1.0 / torch.clamp_min(dist * dist, 1e-12)))
        ok = st["active"] & ok
        splats.append(Splat(u, w, v.where(ok, val, zeros), ok))

        s, bsdf_blk = mrng.next_block4_v(s)
        bs = bsdf_sample_v(bparams, st["wi_local"], *bsdf_blk)
        wo_world = v.to_world(frame, bs.wo)
        thr = st["thr"] * bs.weight
        act = st["active"] & (thr.sum() > 0)

        s, rr_blk = mrng.next_block4_v(s)
        if depth >= cfg.rr_depth:
            q = torch.clamp_max(thr.max_c(), 0.95)
            kill = rr_blk[0] >= q
            thr = v.where(~kill, thr / torch.clamp_min(q, 1e-6), thr)
            act = act & ~kill

        hit2 = scene.ray_intersect_v(st["p"], wo_world)
        it2 = scene.interaction_v(st["p"], wo_world, hit2)
        st = dict(thr=thr, active=act & it2.valid, p=it2.p, ns=it2.ns,
                  ng=it2.ng, ss=it2.ss, ts=it2.ts_, uv_u=it2.uv_u,
                  uv_v=it2.uv_v, shape=it2.shape, wi_local=it2.wi_local)
    return splats
