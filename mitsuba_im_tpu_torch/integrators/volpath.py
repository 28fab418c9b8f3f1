"""Volumetric wavefront path tracer, forward
(``mitsuba_im_tpu/integrators/volpath.py``).

Estimator parity with the reference ``volpath`` plugin (volpath.cpp):
free-flight distance sampling raced against the surface hit,
phase-function scattering with NEE and MIS at medium vertices, surface
vertices as in the MIS path tracer, medium transitions across transmissive
boundaries, attenuated shadow rays through ``null`` and MASK boundaries
(``Scene::sampleAttenuatedEmitterDirect``), and Russian roulette.  A flat
SoA batch of lanes advances through a Python loop over bounces with masked
inactive lanes, as the reference's ``fori_loop`` does, so both draw the
same numbers per lane.

Every shadow ray of a scene with media is a march of up to
``MAX_NULL_SEGMENTS`` closest-hit calls (``tmin`` EPSILON, a per-ray
``tmax``), each segment attenuated by its medium: Beer-Lambert in a
homogeneous one, ratio tracking in a grid one; without media it is one
any-hit call.  The grid lanes' delta and ratio tracking iterate while any
lane of the batch is live (``media/medium.py``), so a grid-medium image
depends on the batch.  A ``null`` pass-through is not a scattering event:
the previous vertex's MIS pdf and its delta flag carry across it, or an
emitter seen through the boundary would be counted twice.  A shadow ray
starts in the path's current medium whatever side of the surface the
light lies on, as the reference's does (ROADMAP C14).

Phases take ``wi`` toward the previous vertex (``-d``), the BSDF
convention, for every phase type; of the reference's phases only
microflake was written for the other convention, and the port's is
mirrored back (``media/medium.py``, ROADMAP C4).  The
integrator calls the port's one form of each BSDF and emitter function
(``bsdf_eval_v``, ``em.sample_direct_v``, ...), the path tracer's
``mi_weight`` and ``_fake_it_v``.
"""
from __future__ import annotations

import torch

from ..core.types import Float, Int, INVALID, EPSILON, SHADOW_EPSILON
from ..core import v3 as v
from ..core.v3 import V3, safe_div
from ..core import rng as mrng
from ..bsdf.common import NULL_BSDF
from ..bsdf.eval import bsdf_eval_v, bsdf_pdf_v, bsdf_sample_v
from ..emitter import table as em
from ..media import medium as med
from ..scene.scene import Scene
from .path import PathConfig, mi_weight, _fake_it_v

MAX_NULL_SEGMENTS = 4  # shadow-ray march depth through null boundaries


def _medium_transition_v(scene: Scene, shape_id, d_world: V3, ng: V3,
                         cur_medium):
    """The medium id after crossing the surface ``shape_id`` along
    ``d_world``: its interior when entering against ``ng``, its exterior
    when leaving; unchanged where the shape names no medium."""
    sid = torch.where(shape_id == INVALID, 0, shape_id)
    interior = v.gather_row(scene.shape_interior, sid)
    exterior = v.gather_row(scene.shape_exterior, sid)
    entering = d_world.dot(ng) < 0
    new = torch.where(entering, interior, exterior)
    has_spec = (interior != INVALID) | (exterior != INVALID)
    return torch.where((shape_id != INVALID) & has_spec, new, cur_medium)


def attenuated_occlusion_v(scene: Scene, o: V3, d: V3, dist, medium0,
                           s: mrng.Sampler3):
    """Transmittance along shadow segments of length ``dist`` through up to
    MAX_NULL_SEGMENTS null or MASK boundaries; zero when an opaque surface
    blocks it, or when the march runs out.  Grid lanes estimate each
    segment by ratio tracking.  Returns (sampler, transmittance V3)."""
    has_het = scene.media.has_hetero
    n = o.x.shape[0]
    dev = o.x.device
    ones = v.ones((n,), dev)
    trans = ones
    seg_o = o
    remaining = dist
    mid = medium0
    alive = torch.ones((n,), dtype=torch.bool, device=dev)

    for _ in range(MAX_NULL_SEGMENTS):
        hit = scene.ray_intersect_v(seg_o, d, EPSILON,
                                    remaining * (1.0 - SHADOW_EPSILON))
        seg_len = torch.where(hit.valid, hit.t, remaining)
        _ss, st, _pt, _g = med.medium_params_v(scene.media, mid)
        seg_trans = med.transmittance_v(st, seg_len)
        if has_het:
            rows = med.hetero_rows_v(scene.media, mid)
            s, t_ratio = med.track_transmittance_v(
                scene.media, rows, seg_o, d, seg_len, s, alive)
            seg_trans = v.where(rows["is_het"],
                                V3(t_ratio, t_ratio, t_ratio), seg_trans)
        trans = trans * v.where(alive, seg_trans, ones)
        it = scene.interaction_v(seg_o, d, hit)
        p = scene.bsdf_at_v(it)
        pass_null = p.type == NULL_BSDF
        opacity = (torch.ones((n,), dtype=Float, device=dev)
                   if p.opacity is None else p.opacity)
        pass_mask = (~pass_null) & (opacity < 1.0)
        is_null = pass_null | pass_mask
        att = torch.where(alive & hit.valid & pass_mask, 1.0 - opacity, 1.0)
        trans = trans * att
        blocked = alive & hit.valid & ~is_null
        trans = v.where(blocked, v.zeros((n,), dev), trans)
        mid = torch.where(
            alive & hit.valid & is_null,
            _medium_transition_v(scene, it.shape, d, it.ng, mid), mid)
        seg_o = v.where(hit.valid, it.p, seg_o)
        remaining = torch.where(hit.valid, remaining - seg_len, 0.0)
        alive = alive & hit.valid & is_null & (remaining > EPSILON)

    trans = v.where(alive, v.zeros((n,), dev), trans)  # budget exceeded
    return s, trans


def volpath_li_v(scene: Scene, sampler: mrng.Sampler3, o: V3, d: V3,
                 cfg: PathConfig):
    """Volumetric Li over a batch of primary rays; returns (radiance V3,
    sampler).  Forward only: no bounce is checkpointed."""
    has_media = scene.media.any
    n = o.x.shape[0]
    dev = o.x.device
    max_depth_eff = cfg.max_depth if cfg.max_depth > 0 else 1 << 20
    n_iters = cfg.max_depth if cfg.max_depth > 0 else cfg.depth_budget + 1
    zeros = v.zeros((n,), dev)
    one = v.ones((n,), dev)

    st = dict(
        li=zeros, thr=one,
        eta=torch.ones((n,), dtype=Float, device=dev),
        active=torch.ones((n,), dtype=torch.bool, device=dev),
        scattered=torch.zeros((n,), dtype=torch.bool, device=dev),
        o=o, d=d,
        medium=torch.full((n,), scene.camera_medium, dtype=Int, device=dev),
        prev_pdf=torch.zeros((n,), dtype=Float, device=dev),
        # first segment: no MIS partner
        prev_delta=torch.ones((n,), dtype=torch.bool, device=dev),
        sampler=sampler,
    )

    for depth_idx in range(n_iters):
        s = st["sampler"]
        act = st["active"]
        o_c, d_c = st["o"], st["d"]

        hit = scene.ray_intersect_v(o_c, d_c)
        it = scene.interaction_v(o_c, d_c, hit)
        t_surf = torch.where(hit.valid, hit.t, 1e30)

        # --- free flight against the surface (volpath.cpp sampleDistance) -
        s, blk_m = mrng.next_block4_v(s)
        sigma_s, sigma_t, _ptype, _g = med.medium_params_v(scene.media,
                                                           st["medium"])
        in_medium = (st["medium"] != INVALID) & act
        if has_media:
            t_m, st_bar = med.sample_distance_v(sigma_t, blk_m[0])
            med_scatter = in_medium & (t_m < t_surf)
            pdf_t = st_bar * torch.exp(-st_bar * t_m)
            w_med = sigma_s * med.transmittance_v(sigma_t, t_m) * (
                1.0 / torch.clamp_min(pdf_t, 1e-30))
            p_surf = torch.exp(-st_bar * torch.minimum(
                t_surf, 80.0 / torch.clamp_min(st_bar, 1e-20)))
            w_srf = med.transmittance_v(sigma_t, t_surf) * (
                1.0 / torch.clamp_min(p_surf, 1e-30))
            w_seg = v.where(med_scatter, w_med,
                            v.where(in_medium, w_srf, one))
            if scene.media.has_hetero:
                # delta tracking replaces the closed-form race on grid lanes
                rows = med.hetero_rows_v(scene.media, st["medium"])
                is_het = rows["is_het"]
                s, t_het, het_sc = med.track_distance_v(
                    scene.media, rows, o_c, d_c, t_surf, s, in_medium)
                alb = med.albedo_at_v(scene.media, rows, o_c + d_c * t_het)
                med_scatter = torch.where(is_het, het_sc, med_scatter)
                t_m = torch.where(is_het, t_het, t_m)
                # exact weights: albedo(x) on a real collision, 1 on escape
                w_het = v.where(het_sc, alb, one)
                w_seg = v.where(is_het, v.where(in_medium, w_het, one),
                                w_seg)
        else:
            t_m = torch.zeros((n,), dtype=Float, device=dev)
            med_scatter = torch.zeros((n,), dtype=torch.bool, device=dev)
            w_seg = one
        thr = st["thr"] * v.where(act, w_seg, one)

        # --- emission at the segment's end (MIS against the previous NEE) -
        esc = act & ~med_scatter & ~hit.valid
        surf = act & ~med_scatter & hit.valid
        eid = scene.emitter_at_id(it.shape)
        le = em.emitted_radiance_v(scene.emitters, eid, it.ns, -d_c)
        lum_pdf = torch.where(
            surf,
            em.pdf_direct_area_v(scene.emitters, eid, o_c, it.p, it.ns),
            em.pdf_direct_env_v(scene.emitters, d_c))
        w_hit = torch.where(st["prev_delta"], 1.0,
                            mi_weight(st["prev_pdf"], lum_pdf))
        env_val = em.eval_environment_v(scene.emitters, d_c)
        hide = cfg.hide_emitters & ~st["scattered"]
        emit_val = v.where(esc, env_val, v.where(surf, le, zeros))
        li = st["li"] + v.where((esc | surf) & ~hide,
                                thr * emit_val * w_hit, zeros)

        # --- the scattering vertex -----------------------------------------
        depth = depth_idx + 1
        do_scatter = (depth < max_depth_eff) & (med_scatter | surf)
        p_vert = v.where(med_scatter, o_c + d_c * t_m, it.p)

        u_sel = None
        if scene.bsdfs.unwrap_depth > 0:
            s, sel_blk = mrng.next_block4_v(s)
            u_sel = sel_blk[0]
        bparams = scene.bsdf_at_v(_fake_it_v({
            "p": it.p, "ng": it.ng, "ns": it.ns, "ss": it.ss, "ts": it.ts_,
            "uv_u": it.uv_u, "uv_v": it.uv_v, "wi_local": it.wi_local,
            "shape": it.shape, "active": surf,
        }), u_sel=u_sel)
        frame = (it.ss, it.ts_, it.ns)

        # NEE (surface: BSDF eval; medium: phase eval), attenuated shadow ray
        s, nee_blk = mrng.next_block4_v(s)
        ds = em.sample_direct_v(scene.emitters, scene.geom, p_vert,
                                nee_blk[0], nee_blk[1], nee_blk[2])
        wo_nee_local = v.to_local(frame, ds.d)
        f_surf = bsdf_eval_v(bparams, it.wi_local, wo_nee_local)
        pdf_surf_nee = bsdf_pdf_v(bparams, it.wi_local, wo_nee_local)
        pctx = med.phase_ctx_v(scene.media, st["medium"], p_vert)
        wi_ph = -d_c  # toward the previous vertex (the BSDF convention)
        ph_nee = med.phase_eval_ctx_v(scene.media, pctx, wi_ph, ds.d)
        ph_nee_pdf = med.phase_pdf_ctx_v(scene.media, pctx, wi_ph, ds.d)
        f_nee = v.where(med_scatter, V3(ph_nee, ph_nee, ph_nee), f_surf)
        pdf_fwd_nee = torch.where(med_scatter, ph_nee_pdf, pdf_surf_nee)
        if has_media:
            s, trans_sh = attenuated_occlusion_v(scene, p_vert, ds.d,
                                                 ds.dist, st["medium"], s)
        else:
            occ = scene.occluded_v(p_vert, ds.d, EPSILON,
                                   ds.dist * (1.0 - SHADOW_EPSILON))
            trans_sh = v.where(occ, zeros, one)
        w_nee = torch.where(ds.delta, 1.0, mi_weight(ds.pdf, pdf_fwd_nee))
        contrib = thr * ds.value * f_nee * trans_sh * safe_div(w_nee, ds.pdf)
        li = li + v.where(do_scatter & (ds.pdf > 0), contrib, zeros)

        # --- direction sampling --------------------------------------------
        s, sc_blk = mrng.next_block4_v(s)
        bs = bsdf_sample_v(bparams, it.wi_local, sc_blk[0], sc_blk[1],
                           sc_blk[2], sc_blk[3])
        wo_surf = v.to_world(frame, bs.wo)
        wo_phase, pdf_phase, w_phase = med.phase_sample_ctx_v(
            scene.media, pctx, wi_ph, sc_blk[1], sc_blk[2], sc_blk[3])
        wo = v.where(med_scatter, wo_phase, wo_surf)
        # phase weight: 1 for the value-proportional families, eval/pdf for
        # the structured ones
        w_dir = v.where(med_scatter, V3(w_phase, w_phase, w_phase),
                        bs.weight)
        thr_new = thr * v.where(do_scatter, w_dir, one)
        # a null/mask pass-through keeps the previous vertex's MIS state
        prev_pdf = torch.where(
            med_scatter, pdf_phase,
            torch.where(bs.null_passthrough, st["prev_pdf"], bs.pdf))
        prev_delta = torch.where(
            med_scatter, torch.zeros_like(bs.delta),
            torch.where(bs.null_passthrough, st["prev_delta"], bs.delta))
        scattered = st["scattered"] | (
            do_scatter & (med_scatter | ~bs.null_passthrough))

        # medium transition across transmissive surfaces
        crossed = surf & (wo.dot(it.ng) * (-d_c).dot(it.ng) < 0)
        mid_new = torch.where(
            do_scatter & crossed,
            _medium_transition_v(scene, it.shape, wo, it.ng, st["medium"]),
            st["medium"])
        eta_new = st["eta"] * torch.where(do_scatter & surf, bs.eta, 1.0)

        dead = thr_new.sum() <= 0
        act2 = act & do_scatter & ~dead

        # --- Russian roulette -----------------------------------------------
        s, rr_blk = mrng.next_block4_v(s)
        if depth >= cfg.rr_depth:
            q = torch.clamp_max(thr_new.max_c() * eta_new * eta_new, 0.95)
            kill = rr_blk[0] >= q
            thr_new = v.where(~kill,
                              thr_new * (1.0 / torch.clamp_min(q, 1e-6)),
                              thr_new)
            act2 = act2 & ~kill

        st = dict(li=li, thr=thr_new, eta=eta_new, active=act2,
                  scattered=scattered, o=p_vert, d=wo, medium=mid_new,
                  prev_pdf=prev_pdf, prev_delta=prev_delta, sampler=s)
    return st["li"], st["sampler"]
